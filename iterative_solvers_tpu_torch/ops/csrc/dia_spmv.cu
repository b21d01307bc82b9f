// Diagonal-format sparse products, CUDA C++ for sm_90a.
//
// Replaces the four kernels of iterative_solvers_tpu/ops/pallas_spmv.py:
//
//   grid_dia_matvec             <- grid_dia_matvec_pallas (:152; pallas_call :130)
//       y[r,c] = sum_k d_k[r,c] * x[r+dy_k, c+dx_k]
//   dia_flat_matvec             <- dia_flat_matvec_pallas (:484; pallas_call :130)
//       y[i]   = sum_k d_k[i] * x[i+off_k]
//   grid_dia_matmat             <- grid_dia_matmat_pallas (:301; pallas_call :279)
//       the first for a stack x (nrhs, ny, nx)
//   grid_dia_matmat_interleaved <- grid_dia_matmat_interleaved_pallas (:335; :462)
//       the same on the row-interleaved layout x (ny, nrhs, nx)
//
// in float and double.  A term whose source lies outside the grid (outside
// [0, n) for the flat form) adds exactly nothing, whatever its coefficient:
// the kernels follow the containers' plain versions (GridDIA._apply,
// DIA.matvec), not the TPU kernels' reliance on zero coefficients in the
// halo.  With `cyclic` the source indices wrap modulo the grid.
//
// What bounds them on an H100: bytes.  Each of the nterms coefficient
// fields is read once, x once and y written once: (nterms + 2) fields for
// the SpMV (62.9 MB for 13 f32 fields at 1024^2, 0.019 ms over 3.35 TB/s),
// (nterms + 2 nrhs) for the SpMM; two operations per coefficient are far
// below the card's rate.
//
// Design: one thread per output point, neighbouring threads on
// neighbouring columns, so every coefficient load is coalesced and is the
// only read of its address; the shifted reads of x overlap between threads
// and are served by L1/L2 through the read-only path.  The terms come as a
// small int32 table in device memory — (k, dy, dx) or (k, off) per term,
// in the order the plain version sums them — so any number of terms and
// any shifts are taken with one compiled kernel; all threads of a warp
// read the same table entry (one broadcast load).  The table is prepared
// by the wrapper: cyclic shifts are reduced to [0, n) so that the wrap is
// one compare and subtract, and clamped terms that can reach no point are
// left out.  The SpMM kernels keep a register tile of 8 right-hand sides
// per thread and read each coefficient once per tile (once per point for
// nrhs <= 8); the two layouts differ only in the strides of x and y.
// Element offsets are 64-bit: nterms * ny * nx passes 2^31 at 13 fields x
// 16384^2.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBX = 32;          // block columns (one warp along a row)
constexpr int kBY = 8;           // block rows
constexpr int kFlatThreads = 256;
constexpr int kRhsTile = 8;      // right-hand sides held in registers
constexpr unsigned kMaxGridY = 65535;

// Source index i + d along an axis of length n.  Cyclic: d is in [0, n),
// the index wraps.  Clamped: false when the source is outside the axis.
template <bool CYCLIC>
__device__ __forceinline__ bool shifted(int i, int d, int n, int& src) {
  src = i + d;
  if constexpr (CYCLIC) {
    if (src >= n) src -= n;
    return true;
  } else {
    return src >= 0 && src < n;
  }
}

template <class T, bool CYCLIC>
__global__ void grid_dia_matvec_kernel(const T* __restrict__ data,
                                       const int* __restrict__ terms, int nterms,
                                       const T* __restrict__ x, T* __restrict__ y,
                                       int ny, int nx) {
  const int c = blockIdx.x * kBX + threadIdx.x;
  const int r = blockIdx.y * kBY + threadIdx.y;
  if (r >= ny || c >= nx) return;
  const size_t field = static_cast<size_t>(ny) * nx;
  const size_t here = static_cast<size_t>(r) * nx + c;
  T acc = T(0);
  for (int t = 0; t < nterms; ++t) {
    const int k = __ldg(terms + 3 * t);
    const int dy = __ldg(terms + 3 * t + 1);
    const int dx = __ldg(terms + 3 * t + 2);
    int rr, cc;
    if (shifted<CYCLIC>(r, dy, ny, rr) && shifted<CYCLIC>(c, dx, nx, cc)) {
      acc += __ldg(data + static_cast<size_t>(k) * field + here)
             * __ldg(x + static_cast<size_t>(rr) * nx + cc);
    }
  }
  y[here] = acc;
}

template <class T>
__global__ void dia_flat_matvec_kernel(const T* __restrict__ data,
                                       const int* __restrict__ terms, int nterms,
                                       const T* __restrict__ x, T* __restrict__ y,
                                       long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kFlatThreads + threadIdx.x;
  if (i >= n) return;
  T acc = T(0);
  for (int t = 0; t < nterms; ++t) {
    const long long k = __ldg(terms + 2 * t);
    const long long j = i + __ldg(terms + 2 * t + 1);
    if (j >= 0 && j < n) acc += __ldg(data + k * n + i) * __ldg(x + j);
  }
  y[i] = acc;
}

// One output point of the SpMM for every right-hand side.  Element
// (j, r, c) of x and y lies at j * rhs_stride + r * row_stride + c.
template <class T, bool CYCLIC>
__device__ __forceinline__ void grid_dia_matmat_point(
    const T* __restrict__ data, const int* __restrict__ terms, int nterms,
    const T* __restrict__ x, T* __restrict__ y, int nrhs, int ny, int nx,
    size_t rhs_stride, size_t row_stride) {
  const int c = blockIdx.x * kBX + threadIdx.x;
  const int r = blockIdx.y * kBY + threadIdx.y;
  if (r >= ny || c >= nx) return;
  const size_t field = static_cast<size_t>(ny) * nx;
  const size_t here = static_cast<size_t>(r) * nx + c;
  const size_t out = static_cast<size_t>(r) * row_stride + c;
  for (int j0 = 0; j0 < nrhs; j0 += kRhsTile) {
    const int nj = nrhs - j0 < kRhsTile ? nrhs - j0 : kRhsTile;
    T acc[kRhsTile];
#pragma unroll
    for (int j = 0; j < kRhsTile; ++j) acc[j] = T(0);
    for (int t = 0; t < nterms; ++t) {
      const int k = __ldg(terms + 3 * t);
      const int dy = __ldg(terms + 3 * t + 1);
      const int dx = __ldg(terms + 3 * t + 2);
      int rr, cc;
      if (!(shifted<CYCLIC>(r, dy, ny, rr) && shifted<CYCLIC>(c, dx, nx, cc))) continue;
      const T d = __ldg(data + static_cast<size_t>(k) * field + here);
      const T* src = x + static_cast<size_t>(j0) * rhs_stride
                     + static_cast<size_t>(rr) * row_stride + cc;
#pragma unroll
      for (int j = 0; j < kRhsTile; ++j) {
        if (j < nj) acc[j] += d * __ldg(src + static_cast<size_t>(j) * rhs_stride);
      }
    }
#pragma unroll
    for (int j = 0; j < kRhsTile; ++j) {
      if (j < nj) y[out + static_cast<size_t>(j0 + j) * rhs_stride] = acc[j];
    }
  }
}

// x, y: (nrhs, ny, nx)
template <class T, bool CYCLIC>
__global__ void grid_dia_matmat_kernel(const T* __restrict__ data,
                                       const int* __restrict__ terms, int nterms,
                                       const T* __restrict__ x, T* __restrict__ y,
                                       int nrhs, int ny, int nx) {
  grid_dia_matmat_point<T, CYCLIC>(data, terms, nterms, x, y, nrhs, ny, nx,
                                   static_cast<size_t>(ny) * nx,
                                   static_cast<size_t>(nx));
}

// x, y: (ny, nrhs, nx)
template <class T, bool CYCLIC>
__global__ void grid_dia_matmat_interleaved_kernel(
    const T* __restrict__ data, const int* __restrict__ terms, int nterms,
    const T* __restrict__ x, T* __restrict__ y, int nrhs, int ny, int nx) {
  grid_dia_matmat_point<T, CYCLIC>(data, terms, nterms, x, y, nrhs, ny, nx,
                                   static_cast<size_t>(nx),
                                   static_cast<size_t>(nrhs) * nx);
}

bool grid_launch_shape(int ny, int nx, dim3* grid) {
  if (ny < 1 || nx < 1) return false;
  *grid = dim3((nx + kBX - 1) / kBX, (ny + kBY - 1) / kBY);
  return grid->y <= kMaxGridY;
}

template <class T>
int launch_grid_matvec(const T* data, const int* terms, int nterms, int cyclic,
                       const T* x, T* y, int ny, int nx, void* stream) {
  dim3 grid;
  if (nterms < 0 || !grid_launch_shape(ny, nx, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kBX, kBY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cyclic) {
    grid_dia_matvec_kernel<T, true><<<grid, block, 0, s>>>(data, terms, nterms, x, y, ny, nx);
  } else {
    grid_dia_matvec_kernel<T, false><<<grid, block, 0, s>>>(data, terms, nterms, x, y, ny, nx);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_flat_matvec(const T* data, const int* terms, int nterms, const T* x,
                       T* y, long long n, void* stream) {
  const long long blocks = (n + kFlatThreads - 1) / kFlatThreads;
  if (nterms < 0 || n < 1 || blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dia_flat_matvec_kernel<T><<<static_cast<unsigned>(blocks), kFlatThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      data, terms, nterms, x, y, n);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_grid_matmat(const T* data, const int* terms, int nterms, int cyclic,
                       int interleaved, const T* x, T* y, int nrhs, int ny, int nx,
                       void* stream) {
  dim3 grid;
  if (nterms < 0 || nrhs < 1 || !grid_launch_shape(ny, nx, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kBX, kBY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (interleaved) {
    if (cyclic) {
      grid_dia_matmat_interleaved_kernel<T, true><<<grid, block, 0, s>>>(
          data, terms, nterms, x, y, nrhs, ny, nx);
    } else {
      grid_dia_matmat_interleaved_kernel<T, false><<<grid, block, 0, s>>>(
          data, terms, nterms, x, y, nrhs, ny, nx);
    }
  } else if (cyclic) {
    grid_dia_matmat_kernel<T, true><<<grid, block, 0, s>>>(
        data, terms, nterms, x, y, nrhs, ny, nx);
  } else {
    grid_dia_matmat_kernel<T, false><<<grid, block, 0, s>>>(
        data, terms, nterms, x, y, nrhs, ny, nx);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// data: (nfields, ny, nx) resp. (ndiags, n) row-major; terms: nterms rows of
// (k, dy, dx) resp. (k, off), int32, on the device; x and y contiguous,
// distinct, of the layout named above.  Cyclic shifts lie in [0, ny) x
// [0, nx).  Each launches on `stream`, does not synchronise, and returns
// the cudaError_t of the launch (0 on success).
#define DIA_SPMV_EXPORTS(T, tag)                                                        \
  extern "C" int grid_dia_matvec_##tag(const T* data, const int* terms, int nterms,     \
                                       const T* x, T* y, int ny, int nx, int cyclic,    \
                                       void* stream) {                                  \
    return launch_grid_matvec(data, terms, nterms, cyclic, x, y, ny, nx, stream);       \
  }                                                                                     \
  extern "C" int dia_flat_matvec_##tag(const T* data, const int* terms, int nterms,     \
                                       const T* x, T* y, long long n, void* stream) {   \
    return launch_flat_matvec(data, terms, nterms, x, y, n, stream);                    \
  }                                                                                     \
  extern "C" int grid_dia_matmat_##tag(const T* data, const int* terms, int nterms,     \
                                       const T* x, T* y, int nrhs, int ny, int nx,      \
                                       int cyclic, void* stream) {                      \
    return launch_grid_matmat(data, terms, nterms, cyclic, 0, x, y, nrhs, ny, nx,       \
                              stream);                                                  \
  }                                                                                     \
  extern "C" int grid_dia_matmat_interleaved_##tag(                                     \
      const T* data, const int* terms, int nterms, const T* x, T* y, int nrhs, int ny,  \
      int nx, int cyclic, void* stream) {                                               \
    return launch_grid_matmat(data, terms, nterms, cyclic, 1, x, y, nrhs, ny, nx,       \
                              stream);                                                  \
  }

DIA_SPMV_EXPORTS(float, f32)
DIA_SPMV_EXPORTS(double, f64)
