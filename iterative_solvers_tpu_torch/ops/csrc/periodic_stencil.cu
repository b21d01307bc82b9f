// Periodic stencils of the Swift-Hohenberg model, CUDA C++ for sm_90a.
//
// Replaces the two kernels of iterative_solvers_tpu/ops/pallas_stencil.py:
//
//   lap_periodic   <- lap_periodic_pallas (:427; pallas_call at :392 / :230)
//                     out = (u[i,j-1] + u[i,j+1] + u[i-1,j] + u[i+1,j] - 4u) / h^2
//   sh_operator    <- sh_operator_pallas  (:473; pallas_call at :392 / :230)
//                     out = -Lap(Lap u) - 2 Lap u + (r-1) u
//
// both axes periodic, on a row-major (ny, nx) field, in float and double
// (the TPU kernels take f32 only; the port also runs the f64 outer
// residuals of the SH Newton solve through sh_operator).
//
// What bounds them on an H100: each reads u once and writes out once, 2 x
// itemsize bytes per point (0.040 ms at 4096^2 f32 over 3.35 TB/s); ~6
// (Lap) and ~25 (SH) operations per point are far below the card's rate.
//
// Design.  lap_periodic: one thread per point, 2-D blocks, the four
// neighbours read through the read-only cache with wrapped indices, so any
// ny, nx >= 3 is taken.  sh_operator: one pass, with no Lap u staged in
// device memory.  A block of BY x BX outputs loads its u tile with a
// 2-deep wrapped halo into shared memory, computes Lap u on the tile minus
// one ring ((BY+2) x (BX+2) points, in shared memory too), and then
// Lap(Lap u) and the output from that.  Both Laplacians sum their taps in
// the order of the plain version (ops/stencils.py::lap_periodic), so the
// kernel rounds like Lap-of-Lap and not like a 13-point stencil, whose
// 1/h^4 weights cancel badly at small h.  The wrap is a modulo, so any
// ny, nx >= 4 is taken.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBX = 32;  // block columns (one warp along a row)
constexpr int kBY = 16;  // block rows
constexpr int kLapBY = 8;

__device__ __forceinline__ int wrap(int g, int n) {
  g %= n;
  return g < 0 ? g + n : g;
}

template <class T>
__global__ void lap_periodic_kernel(const T* __restrict__ u, T* __restrict__ out,
                                    int ny, int nx, T inv_h2) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const size_t row = static_cast<size_t>(i) * nx;
  const size_t up = static_cast<size_t>(i == 0 ? ny - 1 : i - 1) * nx;
  const size_t dn = static_cast<size_t>(i == ny - 1 ? 0 : i + 1) * nx;
  const int jl = j == 0 ? nx - 1 : j - 1;
  const int jr = j == nx - 1 ? 0 : j + 1;
  const T c = __ldg(u + row + j);
  out[row + j] = (__ldg(u + row + jl) + __ldg(u + row + jr) + __ldg(u + up + j)
                  + __ldg(u + dn + j) - T(4) * c) * inv_h2;
}

template <class T>
__global__ void __launch_bounds__(kBX * kBY)
sh_operator_kernel(const T* __restrict__ u, T* __restrict__ out, int ny, int nx,
                   T inv_h2, T rm1) {
  // s[a][b] = u[i0 - 2 + a, j0 - 2 + b];  L[a][b] = (Lap u)[i0 - 1 + a, j0 - 1 + b]
  __shared__ T s[kBY + 4][kBX + 4];
  __shared__ T L[kBY + 2][kBX + 2];
  const int i0 = blockIdx.y * kBY, j0 = blockIdx.x * kBX;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  constexpr int kThreads = kBX * kBY;

  for (int k = tid; k < (kBY + 4) * (kBX + 4); k += kThreads) {
    const int a = k / (kBX + 4), b = k % (kBX + 4);
    const int gi = wrap(i0 - 2 + a, ny), gj = wrap(j0 - 2 + b, nx);
    s[a][b] = __ldg(u + static_cast<size_t>(gi) * nx + gj);
  }
  __syncthreads();
  for (int k = tid; k < (kBY + 2) * (kBX + 2); k += kThreads) {
    const int a = k / (kBX + 2), b = k % (kBX + 2);
    L[a][b] = (s[a + 1][b] + s[a + 1][b + 2] + s[a][b + 1] + s[a + 2][b + 1]
               - T(4) * s[a + 1][b + 1]) * inv_h2;
  }
  __syncthreads();

  const int ty = threadIdx.y, tx = threadIdx.x;
  const int i = i0 + ty, j = j0 + tx;
  if (i >= ny || j >= nx) return;
  const T lap1 = L[ty + 1][tx + 1];
  const T lap2 = (L[ty + 1][tx] + L[ty + 1][tx + 2] + L[ty][tx + 1]
                  + L[ty + 2][tx + 1] - T(4) * lap1) * inv_h2;
  out[static_cast<size_t>(i) * nx + j] = -lap2 - T(2) * lap1 + rm1 * s[ty + 2][tx + 2];
}

template <class T>
int launch_lap(const T* u, T* out, int ny, int nx, double inv_h2, void* stream) {
  if (ny < 3 || nx < 3) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBX, kLapBY);
  const dim3 grid((nx + kBX - 1) / kBX, (ny + kLapBY - 1) / kLapBY);
  lap_periodic_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      u, out, ny, nx, static_cast<T>(inv_h2));
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_sh(const T* u, T* out, int ny, int nx, double inv_h2, double rm1,
              void* stream) {
  if (ny < 4 || nx < 4) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBX, kBY);
  const dim3 grid((nx + kBX - 1) / kBX, (ny + kBY - 1) / kBY);
  sh_operator_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      u, out, ny, nx, static_cast<T>(inv_h2), static_cast<T>(rm1));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u, out: (ny, nx) row-major, contiguous, on the current device, distinct.
// inv_h2 = 1/h^2, rm1 = r - 1.  Each launches on `stream`, does not
// synchronise, and returns the cudaError_t of the launch (0 on success).
extern "C" int lap_periodic_f32(const float* u, float* out, int ny, int nx,
                                double inv_h2, void* stream) {
  return launch_lap(u, out, ny, nx, inv_h2, stream);
}

extern "C" int lap_periodic_f64(const double* u, double* out, int ny, int nx,
                                double inv_h2, void* stream) {
  return launch_lap(u, out, ny, nx, inv_h2, stream);
}

extern "C" int sh_operator_f32(const float* u, float* out, int ny, int nx,
                               double inv_h2, double rm1, void* stream) {
  return launch_sh(u, out, ny, nx, inv_h2, rm1, stream);
}

extern "C" int sh_operator_f64(const double* u, double* out, int ny, int nx,
                               double inv_h2, double rm1, void* stream) {
  return launch_sh(u, out, ny, nx, inv_h2, rm1, stream);
}
