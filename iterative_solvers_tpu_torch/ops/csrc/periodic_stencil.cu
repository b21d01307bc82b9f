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
// ny, nx >= 3 is taken.
//
// sh_operator: one pass, with no Lap u in device memory, in two stages that
// sum their taps in the order of the plain version
// (ops/stencils.py::lap_periodic), so the kernel rounds like Lap-of-Lap and
// not like a 13-point stencil, whose 1/h^4 weights cancel badly at small h.
// Two kernels compute it, chosen by shape alone:
//
//   strip-marching (sh_strip_kernel; nx a multiple of the 16-byte vector,
//   4 floats or 2 doubles, and 16-byte aligned pointers).  A WARP owns a
//   strip of 32 vectors (128 f32 / 64 f64 columns) and a segment of rows,
//   and marches down the rows.  Each lane owns one vector of columns and
//   keeps, in registers, a rolling window of u rows and of Lap u rows for
//   its columns and one neighbour column each side: the vertical taps are
//   its own registers, the horizontal ones come from the neighbouring lanes
//   by warp shuffle, and only the first and last lane of a strip load the
//   two halo columns (wrapped only at the domain's left and right edge).
//   So there is no shared memory and no barrier, every u element is loaded
//   once per strip segment (plus 4 start-up rows) with 16-byte loads and
//   stores, several rows' loads are in flight per lane, and the wrapped row
//   index advances by compare-and-subtract: no modulo.  The segment height
//   is picked so that the warps fill the card.
//
//   tiled (sh_tile_kernel, the earlier design; any ny, nx >= 4).  A block
//   of BY x BX outputs loads its u tile with a 2-deep wrapped halo into
//   shared memory, computes Lap u on the tile minus one ring (in shared
//   memory too), and then Lap(Lap u) and the output from that.  The wrap is
//   a modulo.  It takes the shapes the strip kernel does not (24 x 23,
//   61 x 91) and is exported as sh_operator_v1_* so that one run can time
//   old against new on one card.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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
sh_tile_kernel(const T* __restrict__ u, T* __restrict__ out, int ny, int nx,
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
int launch_sh_tile(const T* u, T* out, int ny, int nx, double inv_h2, double rm1,
              void* stream) {
  if (ny < 4 || nx < 4) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBX, kBY);
  const dim3 grid((nx + kBX - 1) / kBX, (ny + kBY - 1) / kBY);
  sh_tile_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      u, out, ny, nx, static_cast<T>(inv_h2), static_cast<T>(rm1));
  return static_cast<int>(cudaGetLastError());
}


// ---- the strip-marching sh_operator ---------------------------------------------

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load16(const double* p, double (&x)[2]) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  x[0] = v.x; x[1] = v.y;
}
__device__ __forceinline__ void store16(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store16(double* p, const double (&x)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
}

// A product rounded on its own, never contracted into an FMA with the sum
// around it: the plain version rounds Lap u and Lap(Lap u) before it uses
// them, and so does the kernel, bit for bit.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// One row of u as its loads leave it in a lane: the lane's own vector and,
// in the strip's first and last lane, the two halo columns of that side.
template <class T, int N>
struct RawRow {
  T own[N], left[2], right[2];
};

// R rows' loads are started together before the first is used.
template <class T, int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sh_strip_kernel(const T* __restrict__ u, T* __restrict__ out, int ny, int nx,
                int seg, int nstrips, T inv_h2, T rm1) {
  constexpr int N = 16 / sizeof(T);  // columns a lane owns
  constexpr int W = N + 4;           // its window: own - 2 .. own + N + 1
  constexpr int SW = 32 * N;         // columns of a strip
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int i0 = (warp / nstrips) * seg;
  if (i0 >= ny) return;  // the whole warp leaves: nothing below waits on it
  const int i1 = min(i0 + seg, ny);
  const int j0 = (warp % nstrips) * SW;
  const int width = min(SW, nx - j0);  // a multiple of N
  const int last = width / N - 1;      // the last lane that owns columns
  const bool active = lane <= last;
  const int col = j0 + lane * N;
  // the two columns left and right of the strip; only the domain's edges wrap
  const int jl = j0 == 0 ? nx - 2 : j0 - 2;
  const int jr = j0 + width == nx ? 0 : j0 + width;

  int next = i0 - 2;  // the next row to load, wrapped by compare and add/subtract
  if (next < 0) next += ny;

  auto load = [&](RawRow<T, N>& x) {
    const T* row = u + static_cast<size_t>(next) * nx;
    if (++next == ny) next = 0;
    if (active) {
      load16(row + col, x.own);
    } else {
#pragma unroll
      for (int m = 0; m < N; ++m) x.own[m] = T(0);
    }
    if (lane == 0) {
      x.left[0] = __ldg(row + jl);
      x.left[1] = __ldg(row + jl + 1);
    }
    if (lane == last) {
      x.right[0] = __ldg(row + jr);
      x.right[1] = __ldg(row + jr + 1);
    }
  };
  // the lane's window of a row: the neighbours' columns by shuffle, the halo
  // columns in the strip's first and last lane
  auto expand = [&](const RawRow<T, N>& x, T (&w)[W]) {
    w[0] = __shfl_up_sync(kFullWarp, x.own[N - 2], 1);
    w[1] = __shfl_up_sync(kFullWarp, x.own[N - 1], 1);
    w[N + 2] = __shfl_down_sync(kFullWarp, x.own[0], 1);
    w[N + 3] = __shfl_down_sync(kFullWarp, x.own[1], 1);
    if (lane == 0) {
      w[0] = x.left[0];
      w[1] = x.left[1];
    }
    if (lane == last) {
      w[N + 2] = x.right[0];
      w[N + 3] = x.right[1];
    }
#pragma unroll
    for (int m = 0; m < N; ++m) w[m + 2] = x.own[m];
  };
  // Lap u of the middle row b on columns own - 1 .. own + N (window 1 .. N + 2)
  auto lap = [&](const T (&a)[W], const T (&b)[W], const T (&c)[W], T (&l)[N + 2]) {
#pragma unroll
    for (int m = 0; m < N + 2; ++m)
      l[m] = mul_rn(b[m] + b[m + 2] + a[m + 1] + c[m + 1] - T(4) * b[m + 1], inv_h2);
  };

  RawRow<T, N> raw[R];
  T ua[W], ub[W], uc[W], la[N + 2], lb[N + 2], lc[N + 2];
  {  // start-up: rows i0 - 2 .. i0 + 1 give Lap u on rows i0 - 1 and i0
    RawRow<T, N> first[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) load(first[k]);
    T w0[W];
    expand(first[0], w0);
    expand(first[1], uc);
    expand(first[2], ua);
    expand(first[3], ub);
    lap(w0, uc, ua, la);
    lap(uc, ua, ub, lb);
  }
  // ua, ub: u on rows t, t + 1;  la, lb: Lap u on rows t - 1, t
  for (int t = i0; t < i1; t += R) {
#pragma unroll
    for (int k = 0; k < R; ++k) load(raw[k]);  // rows t + 2 .. t + R + 1 (wrapped: always valid)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      expand(raw[k], uc);
      lap(ua, ub, uc, lc);
      if (active && t + k < i1) {
        T o[N];
#pragma unroll
        for (int m = 0; m < N; ++m) {
          const T lap1 = lb[m + 1];
          const T lap2 =
              mul_rn(lb[m] + lb[m + 2] + la[m + 1] + lc[m + 1] - T(4) * lap1, inv_h2);
          o[m] = (-lap2 - T(2) * lap1) + mul_rn(rm1, ua[m + 2]);
        }
        store16(out + static_cast<size_t>(t + k) * nx + col, o);
      }
#pragma unroll
      for (int m = 0; m < W; ++m) {
        ua[m] = ub[m];
        ub[m] = uc[m];
      }
#pragma unroll
      for (int m = 0; m < N + 2; ++m) {
        la[m] = lb[m];
        lb[m] = lc[m];
      }
    }
  }
}

// Whether the strip kernel takes the field: whole 16-byte vectors per row,
// aligned.  The wrapper decides the same from the shape and the pointer.
template <class T>
bool strip_takes(const T* u, const T* out, int nx) {
  return nx % (16 / static_cast<int>(sizeof(T))) == 0
         && reinterpret_cast<uintptr_t>(u) % 16 == 0
         && reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

// The tallest segment that still gives every SM of an H100 (132) 8 warps.
inline int pick_segment(int ny, int nstrips) {
  for (int seg = 64; seg > 8; seg /= 2)
    if (static_cast<long long>(nstrips) * ((ny + seg - 1) / seg) >= 132 * 8) return seg;
  return 8;
}

template <class T, int R>
int launch_sh_strip(const T* u, T* out, int ny, int nx, double inv_h2, double rm1,
                    void* stream, int seg) {
  if (ny < 4 || nx < 4 || !strip_takes(u, out, nx))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int SW = 32 * (16 / static_cast<int>(sizeof(T)));
  const int nstrips = (nx + SW - 1) / SW;
  if (seg <= 0) seg = pick_segment(ny, nstrips);
  const long long warps = static_cast<long long>(nstrips) * ((ny + seg - 1) / seg);
  const unsigned blocks = static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  sh_strip_kernel<T, R><<<blocks, 32 * kWarpsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      u, out, ny, nx, seg, nstrips, static_cast<T>(inv_h2), static_cast<T>(rm1));
  return static_cast<int>(cudaGetLastError());
}

constexpr int kRowsAhead = 4;

// The same kernel with the segment height and the rows in flight given, for
// the tuning script (tools/tune_port_kernels.py).
template <class T>
int launch_sh_strip_tuned(const T* u, T* out, int ny, int nx, double inv_h2, double rm1,
                          void* stream, int seg, int rows_ahead) {
  switch (rows_ahead) {
    case 2: return launch_sh_strip<T, 2>(u, out, ny, nx, inv_h2, rm1, stream, seg);
    case 4: return launch_sh_strip<T, 4>(u, out, ny, nx, inv_h2, rm1, stream, seg);
    case 8: return launch_sh_strip<T, 8>(u, out, ny, nx, inv_h2, rm1, stream, seg);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

// The strip-marching kernel: nx a multiple of 4 (f32) or 2 (f64), u and out
// 16-byte aligned; anything else returns cudaErrorInvalidValue.
extern "C" int sh_operator_f32(const float* u, float* out, int ny, int nx,
                               double inv_h2, double rm1, void* stream) {
  return launch_sh_strip<float, kRowsAhead>(u, out, ny, nx, inv_h2, rm1, stream, 0);
}

extern "C" int sh_operator_f64(const double* u, double* out, int ny, int nx,
                               double inv_h2, double rm1, void* stream) {
  return launch_sh_strip<double, kRowsAhead>(u, out, ny, nx, inv_h2, rm1, stream, 0);
}

// The tiled kernel: any ny, nx >= 4.
extern "C" int sh_operator_v1_f32(const float* u, float* out, int ny, int nx,
                                  double inv_h2, double rm1, void* stream) {
  return launch_sh_tile(u, out, ny, nx, inv_h2, rm1, stream);
}

extern "C" int sh_operator_v1_f64(const double* u, double* out, int ny, int nx,
                                  double inv_h2, double rm1, void* stream) {
  return launch_sh_tile(u, out, ny, nx, inv_h2, rm1, stream);
}

// What the compiler and the card give the strip kernel (f64 if is_f64):
// r[0] registers a thread, r[1] shared-memory bytes a block, r[2] local
// (spill) bytes a thread, r[3] resident blocks an SM, r[4] threads a block.
extern "C" int sh_operator_resources(int is_f64, int* r) {
  cudaFuncAttributes a;
  const int threads = 32 * kWarpsPerBlock;
  cudaError_t err = is_f64
      ? cudaFuncGetAttributes(&a, sh_strip_kernel<double, kRowsAhead>)
      : cudaFuncGetAttributes(&a, sh_strip_kernel<float, kRowsAhead>);
  if (err != cudaSuccess) return static_cast<int>(err);
  r[0] = a.numRegs;
  r[1] = static_cast<int>(a.sharedSizeBytes);
  r[2] = static_cast<int>(a.localSizeBytes);
  r[4] = threads;
  err = is_f64
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &r[3], sh_strip_kernel<double, kRowsAhead>, threads, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &r[3], sh_strip_kernel<float, kRowsAhead>, threads, 0);
  return static_cast<int>(err);
}

// For the tuning script only: seg rows a segment (0: by shape), rows_ahead
// in {2, 4, 8}.
extern "C" int sh_operator_strip_f32(const float* u, float* out, int ny, int nx,
                                     double inv_h2, double rm1, void* stream,
                                     int seg, int rows_ahead) {
  return launch_sh_strip_tuned(u, out, ny, nx, inv_h2, rm1, stream, seg, rows_ahead);
}

extern "C" int sh_operator_strip_f64(const double* u, double* out, int ny, int nx,
                                     double inv_h2, double rm1, void* stream,
                                     int seg, int rows_ahead) {
  return launch_sh_strip_tuned(u, out, ny, nx, inv_h2, rm1, stream, seg, rows_ahead);
}
