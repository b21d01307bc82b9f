// The curvilinear Laplacian's flux divergence (ops/stencils.flux_div_x and
// flux_div_y: the conservative 4th-order (a v')' along one axis) as one
// launch a call, CUDA C++ for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves the flux divergence to XLA,
// which fuses each call (shifted slices, four one-sided ring columns, a
// concatenation) into one pass.  Run eagerly, a call was ~156 ATen launches:
// ~42 for the interior's products and sums, 24-32 for each ring column,
// zeros_like and cat.  ops/curvilinear.laplace calls it twice (x, then y),
// so a MEMS residual evaluation made 624 launches of it and a droplet
// residual or coefficient stack 312.  Here a call is one launch.
//
// What it computes, along one axis "a" of length n >= 6 of a pair of
// strided fields a and v of one shape (the last axis for flux_div_x, the
// rows for flux_div_y; "b", of length m, is the other of the last two axes,
// and the leading axes are a batch): the body of csrc/flux.cuh at every
// point, written to a fresh output laid out contiguously in the fields'
// shape (x: out[batch][b][a], y: out[batch][a][b]).  Each input is read
// through its own strides (any, 0 included; the wrapper folds the leading
// axes into one batch axis); no transposed copy is made.
//
// Numerics: bit for bit with the plain body on the card (csrc/flux.cuh).
//
// What bounds it on an H100: a call reads a and v once and writes the
// result once (at 1024^2 f64 25.2 MB, ~7.5 us at 3.35 TB/s; ~60 flops a
// point, far below the card's rate); at 51^2 (42 KB a field) the launch
// itself.  Design, as csrc/fd_stencil.cu: one block a 32 (a) x 32 (b)
// output tile, 256 threads; the tile's reach along a in both fields (the
// tile grown by 3, or to the 6 points the rings read at either end of the
// axis) staged in shared memory by loads that run along each input's
// smaller stride, so a transposed view is read as coalesced as a contiguous
// field; then each warp computes 32 consecutive outputs along the output's
// unit stride (along a for x, along b for y) and writes them coalesced.
// The grid follows the shape: 4 blocks at 51^2, 1,024 at 1024^2.  The
// batch axis takes blockIdx.z.

#include <cuda_runtime.h>

#include "flux.cuh"

namespace {

constexpr int kTA = 32;                       // tile points along a
constexpr int kTB = 32;                       // tile points along b
constexpr int kThreads = 256;
constexpr int kReach = 3;                     // the interior reads 3 points each side
constexpr int kEdge = 6;                      // the rings read the 6 points at an end
constexpr int kPitch = kTA + 2 * kReach + 1;  // odd: transposed accesses hit distinct banks
constexpr long long kMaxGridYZ = 65535;

// One operand's strides (elements): batch z, along a, along b.
struct Strides {
  long long z, a, b;
};

// Copy the box [lo, lo + ta) x [b0, b0 + tb) of src into tile[b][a - lo],
// consecutive threads along src's smaller stride.
template <class T>
__device__ __forceinline__ void stage(T (*tile)[kPitch], const T* __restrict__ src, Strides s,
                                      int lo, int ta, int b0, int tb) {
  const bool along_a = s.a <= s.b;
  src += b0 * s.b + lo * s.a;
  for (int k = threadIdx.x; k < ta * tb; k += kThreads) {
    const int x = along_a ? k % ta : k / tb;
    const int y = along_a ? k / ta : k % tb;
    tile[y][x] = src[y * s.b + x * s.a];
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
flux_div(const T* __restrict__ a, const T* __restrict__ v, T* __restrict__ out, int n, int m,
         long long nbatch, bool out_along_a, Strides sa, Strides sv, T ih, T f288) {
  __shared__ T ta_[kTB][kPitch];
  __shared__ T tv_[kTB][kPitch];
  const int a0 = blockIdx.x * kTA, a1 = min(a0 + kTA, n);
  const int b0 = blockIdx.y * kTB, tb = min(kTB, m - b0);
  // the points along a this tile's outputs read: the tile grown by the
  // interior's reach and clamped to the axis; at an end, the rings' 6 points
  int lo = max(a0 - kReach, 0), hi = min(a1 + kReach, n);
  if (lo == 0) hi = max(hi, kEdge);
  if (hi == n) lo = min(lo, n - kEdge);
  const int width = hi - lo;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (long long z = blockIdx.z; z < nbatch; z += gridDim.z) {
    stage(ta_, a + z * sa.z, sa, lo, width, b0, tb);
    stage(tv_, v + z * sv.z, sv, lo, width, b0, tb);
    __syncthreads();
    auto point = [&](int y, int c) {
      const T* ra = ta_[y];
      const T* rv = tv_[y];
      return flux_rn::flux([ra, lo](int k) { return ra[k - lo]; },
                           [rv, lo](int k) { return rv[k - lo]; }, c, n, ih, f288);
    };
    if (out_along_a) {  // out[z][b][a]: a warp writes 32 points along a
      const int c = a0 + lane;
      T* dst = out + (z * m + b0) * n;
      if (c < a1)
        for (int y = warp; y < tb; y += kThreads / 32)
          dst[static_cast<long long>(y) * n + c] = point(y, c);
    } else {  // out[z][a][b]: a warp writes 32 points along b
      T* dst = out + z * n * m + b0;
      if (lane < tb)
        for (int c = a0 + warp; c < a1; c += kThreads / 32)
          dst[static_cast<long long>(c) * m + lane] = point(lane, c);
    }
    __syncthreads();  // the tiles are read before the next batch entry stages
  }
}

template <class T>
int launch(const T* a, const T* v, T* out, int n, int m, long long nbatch, int axis_last,
           long long sza, long long saa, long long sba, long long szv, long long sav,
           long long sbv, double inv_h2, double inv_h2_288, void* stream) {
  if (n < kEdge || m < 1 || nbatch < 1 || (m + kTB - 1) / kTB > kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n + kTA - 1) / kTA),
                  static_cast<unsigned>((m + kTB - 1) / kTB),
                  static_cast<unsigned>(nbatch < kMaxGridYZ ? nbatch : kMaxGridYZ));
  // ATen's x * python_scalar: the scalar converted to the field's type
  flux_div<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, v, out, n, m, nbatch, axis_last != 0, Strides{sza, saa, sba}, Strides{szv, sav, sbv},
      static_cast<T>(inv_h2), static_cast<T>(inv_h2_288));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out = (a v')' along a, scaled by inv_h2 (the rings) and inv_h2_288 =
// inv_h2 / 288 (the interior).  a, v: nbatch pairs of fields at batch
// strides sza, szv, each n points along a (strides saa, sav) and m along b
// (sba, sbv), in elements.  out: contiguous, (nbatch, m, n) if axis_last
// (flux_div_x), else (nbatch, n, m) (flux_div_y), distinct from a and v.
// Launches once on `stream`, returns its cudaError_t (0 on success), does
// not synchronise and allocates nothing.
extern "C" int flux_div_f32(const float* a, const float* v, float* out, int n, int m,
                            long long nbatch, int axis_last, long long sza, long long saa,
                            long long sba, long long szv, long long sav, long long sbv,
                            double inv_h2, double inv_h2_288, void* stream) {
  return launch(a, v, out, n, m, nbatch, axis_last, sza, saa, sba, szv, sav, sbv, inv_h2,
                inv_h2_288, stream);
}

extern "C" int flux_div_f64(const double* a, const double* v, double* out, int n, int m,
                            long long nbatch, int axis_last, long long sza, long long saa,
                            long long sba, long long szv, long long sav, long long sbv,
                            double inv_h2, double inv_h2_288, void* stream) {
  return launch(a, v, out, n, m, nbatch, axis_last, sza, saa, sba, szv, sav, sbv, inv_h2,
                inv_h2_288, stream);
}

// What the compiler and the card give the kernel (f64 if is_f64): r[0]
// registers a thread, r[1] shared-memory bytes a block, r[2] local (spill)
// bytes a thread, r[3] resident blocks an SM, r[4] threads a block.
extern "C" int flux_div_resources(int is_f64, int* r) {
  cudaFuncAttributes attr;
  const void* k = is_f64 ? reinterpret_cast<const void*>(flux_div<double>)
                         : reinterpret_cast<const void*>(flux_div<float>);
  cudaError_t err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  r[0] = attr.numRegs;
  r[1] = static_cast<int>(attr.sharedSizeBytes);
  r[2] = static_cast<int>(attr.localSizeBytes);
  r[4] = kThreads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r[3], k, kThreads, 0));
}
