// The card's own streaming ceiling: read, write and staged-copy kernels,
// CUDA C++ for sm_90a.
//
// Replaces the five pallas_calls of the JAX package's stream-measuring
// tools:
//
//   stream_read  <- tools/stream_ladder.py::read_kernel (:66; pallas_call :104)
//                   acc(8, n) = tok + sum_c u[c*bm : c*bm + 8, :]
//                   (every bm-row chunk of u streamed whole, 8 rows folded)
//   stream_write <- tools/stream_ladder.py::write_kernel (:124; pallas_call :157)
//                   out[c*bm : (c+1)*bm, :] = tok[0, :] * 0.5 + c
//   staged_copy  <- tools/stream_ladder.py::copy_kernel (:176; pallas_call :227),
//                   tools/pallas_pipeline_experiment.py::make_pipeline (:20; :85),
//                   tools/pallas_grid_experiment.py::grid_copy (:48; :52)
//                   out = u; with `halos` the 8 periodic rows above and below
//                   each tile are loaded too and discarded
//
// in float and double, on row-major (n_rows, n_cols) fields.
//
// What bounds them on an H100: bytes and nothing else.  stream_read reads
// n_rows x n_cols elements (all of u: the fold of 8 rows a chunk exists
// only so that the stream cannot be dropped), stream_write writes them,
// staged_copy reads and writes them (halo rows are extra reads the
// function does not need).  Their operations (an add or a multiply-add an
// element at most) are far below the card's rate.
//
// Design.  The TPU kernels run one core down the rows with whole-width
// (bm, n) slabs in VMEM; a whole 8192-wide f32 slab of 128 rows is 4 MB,
// far more than a block's shared memory.  So here a tile is bm rows (plus
// 2 x 8 halo rows) by a strip of `width` columns, the width chosen by the
// wrapper (ops/stream_ladder.py::stream_tiling) so that `slots` tiles fit a
// ring of at most kRingBytes (two blocks an SM).  Blocks are (strip, group
// of `per` consecutive chunks): many blocks stream at once, each marching
// down its own chunks through its ring:
//
//   loads   16-byte cp.async of every row segment of a tile into its slot,
//           one commit group a chunk, `depth` chunks in flight
//           (cp.async.wait_group depth);
//   stores  one TMA bulk copy (cp.async.bulk shared -> global) a row of the
//           tile, issued by the thread that owns the row, one bulk group a
//           chunk; a slot is refilled only after the bulk copies that read
//           it have read it (cp.async.bulk.wait_group.read), which is what
//           `slots` buys: the stores of up to slots - depth - 1 earlier
//           chunks stay in flight while the next loads are issued.
//
// The copies cannot be dropped by the compiler, so every byte of u moves.
// stream_read folds the first 8 rows of each chunk into 16 registers a
// thread (8 rows x at most 512 columns over 256 threads) in the chunk
// order, writes each block's (8, width) partial sum to a (groups, 8, n_cols)
// scratch, and a second small kernel adds tok and the groups' partials in
// group order: the result does not depend on the blocks' schedule, and the
// stream keeps all its blocks.  stream_write fills the slot with the row
// value (tok * 0.5 rounded, then + c rounded: no contraction into an FMA,
// so it equals the plain version bit for bit) and stores it like the copy.
// Data written by threads or by cp.async is made visible to the bulk
// copies' (async) proxy by fence.proxy.async before the barrier that
// precedes them.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kHalo = 8;           // rows folded by stream_read; halo rows each side
constexpr int kMaxWidth = 512;     // strip columns: 8 x 512 / 256 = 16 sums a thread
constexpr int kAcc = kHalo * kMaxWidth / kThreads;
constexpr int kMaxSlots = 8;
constexpr int kRingBytes = 115712;  // two blocks an SM: 2 x (113 + 1 reserved) KB of 228 KB

template <class T> struct Vec;
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<double> { using type = double2; };

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void load16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void load_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

#define STREAM_CASE(OP, N) \
  case N: asm volatile(OP " " #N ";\n" ::: "memory"); break;
#define STREAM_WAIT(OP)                                               \
  switch (n) {                                                        \
    STREAM_CASE(OP, 0) STREAM_CASE(OP, 1) STREAM_CASE(OP, 2)          \
    STREAM_CASE(OP, 3) STREAM_CASE(OP, 4) STREAM_CASE(OP, 5)          \
    STREAM_CASE(OP, 6) default: asm volatile(OP " 7;\n" ::: "memory"); \
  }

// At most n (0..7) of this thread's cp.async groups still pending.
__device__ __forceinline__ void load_wait(int n) { STREAM_WAIT("cp.async.wait_group") }

// At most n (0..7) of this thread's bulk groups still reading shared memory.
__device__ __forceinline__ void store_wait_read(int n) {
  STREAM_WAIT("cp.async.bulk.wait_group.read")
}

#undef STREAM_WAIT
#undef STREAM_CASE

__device__ __forceinline__ void store_bulk(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float half_plus(float t, float c) {
  return __fadd_rn(__fmul_rn(t, 0.5f), c);
}
__device__ __forceinline__ double half_plus(double t, double c) {
  return __dadd_rn(__dmul_rn(t, 0.5), c);
}

// A block's place: strip blockIdx.x of `width` columns (the last one
// ragged), chunks [c0, c0 + count) of bm rows.
struct Place {
  int j0, w, vecs, c0, count;
};

template <class T>
__device__ __forceinline__ Place place(int n_rows, int n_cols, int bm, int width, int per) {
  constexpr int kVec = 16 / sizeof(T);
  Place p;
  p.j0 = blockIdx.x * width;
  p.w = min(width, n_cols - p.j0);
  p.vecs = p.w / kVec;
  p.c0 = blockIdx.y * per;
  p.count = min(per, n_rows / bm - p.c0);
  return p;
}

// Issue the loads of the block's k-th chunk (rows c*bm - top .. c*bm + bm +
// top, wrapped) into its slot, if it has one, and commit a group either way.
template <class T>
__device__ __forceinline__ void issue(const T* __restrict__ u, T* ring, const Place& p, int k,
                                      int n_rows, int n_cols, int bm, int rows, int top,
                                      int slots, int width) {
  constexpr int kVec = 16 / sizeof(T);
  if (k < p.count) {
    T* slot = ring + static_cast<size_t>(k % slots) * rows * width;
    const int first = (p.c0 + k) * bm - top;
    for (int i = threadIdx.x; i < rows * p.vecs; i += kThreads) {
      const int r = i / p.vecs;
      const int v = i - r * p.vecs;
      int g = first + r;
      g = g < 0 ? g + n_rows : (g >= n_rows ? g - n_rows : g);
      load16(slot + r * width + v * kVec, u + static_cast<size_t>(g) * n_cols + p.j0 + v * kVec);
    }
  }
  load_commit();
}

// Bulk-store the bm core rows of the k-th chunk from its slot; one group.
template <class T>
__device__ __forceinline__ void store_rows(T* __restrict__ out, const T* slot, const Place& p,
                                           int k, int n_cols, int bm, int width) {
  const size_t row0 = static_cast<size_t>(p.c0 + k) * bm;
  for (int r = threadIdx.x; r < bm; r += kThreads) {
    store_bulk(out + (row0 + r) * n_cols + p.j0, slot + r * width,
               static_cast<unsigned>(p.w * sizeof(T)));
  }
  store_commit();
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    staged_copy_kernel(const T* __restrict__ u, T* __restrict__ out, int n_rows, int n_cols,
                       int bm, int slots, int depth, int halos, int width, int per) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const Place p = place<T>(n_rows, n_cols, bm, width, per);
  const int top = halos ? kHalo : 0;
  const int rows = bm + 2 * top;
  for (int k = 0; k < depth; ++k) issue(u, ring, p, k, n_rows, n_cols, bm, rows, top, slots, width);
  for (int k = 0; k < p.count; ++k) {
    if (k + depth < p.count) {
      // the slot to refill held chunk k + depth - slots, whose stores were
      // committed slots - depth - 1 groups ago
      store_wait_read(slots - depth - 1);
      __syncthreads();
    }
    issue(u, ring, p, k + depth, n_rows, n_cols, bm, rows, top, slots, width);
    load_wait(depth);
    fence_to_async();
    __syncthreads();
    const T* slot = ring + static_cast<size_t>(k % slots) * rows * width + top * width;
    store_rows(out, slot, p, k, n_cols, bm, width);
  }
  store_wait_all();
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    stream_write_kernel(const T* __restrict__ tok, T* __restrict__ out, int n_rows, int n_cols,
                        int bm, int slots, int width, int per) {
  using V = typename Vec<T>::type;
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const Place p = place<T>(n_rows, n_cols, bm, width, per);
  for (int k = 0; k < p.count; ++k) {
    // the slot held chunk k - slots, whose stores were committed slots - 1 groups ago
    store_wait_read(slots - 1);
    __syncthreads();
    T* slot = ring + static_cast<size_t>(k % slots) * bm * width;
    const T c = static_cast<T>(p.c0 + k);
    for (int i = threadIdx.x; i < bm * p.vecs; i += kThreads) {
      const int r = i / p.vecs;
      const int v = i - r * p.vecs;
      V t = *reinterpret_cast<const V*>(tok + p.j0 + v * kVec);
      T* e = reinterpret_cast<T*>(&t);
#pragma unroll
      for (int q = 0; q < kVec; ++q) e[q] = half_plus(e[q], c);
      *reinterpret_cast<V*>(slot + r * width + v * kVec) = t;
    }
    fence_to_async();
    __syncthreads();
    store_rows(out, slot, p, k, n_cols, bm, width);
  }
  store_wait_all();
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    stream_read_kernel(const T* __restrict__ u, T* __restrict__ partial, int n_rows, int n_cols,
                       int bm, int slots, int width, int per) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const Place p = place<T>(n_rows, n_cols, bm, width, per);
  const int depth = slots - 1;
  T acc[kAcc];
#pragma unroll
  for (int m = 0; m < kAcc; ++m) acc[m] = T(0);
  for (int k = 0; k < depth; ++k) issue(u, ring, p, k, n_rows, n_cols, bm, bm, 0, slots, width);
  for (int k = 0; k < p.count; ++k) {
    if (k + depth < p.count) __syncthreads();  // the slot to refill was folded at k - 1
    issue(u, ring, p, k + depth, n_rows, n_cols, bm, bm, 0, slots, width);
    load_wait(depth);
    __syncthreads();
    const T* slot = ring + static_cast<size_t>(k % slots) * bm * width;
#pragma unroll
    for (int m = 0; m < kAcc; ++m) {
      const int e = threadIdx.x + m * kThreads;
      if (e < kHalo * p.w) {
        const int r = e / p.w;
        acc[m] += slot[r * width + (e - r * p.w)];
      }
    }
  }
  T* mine = partial + static_cast<size_t>(blockIdx.y) * kHalo * n_cols + p.j0;
#pragma unroll
  for (int m = 0; m < kAcc; ++m) {
    const int e = threadIdx.x + m * kThreads;
    if (e < kHalo * p.w) {
      const int r = e / p.w;
      mine[static_cast<size_t>(r) * n_cols + (e - r * p.w)] = acc[m];
    }
  }
}

// out = tok + partial[0] + partial[1] + ..., in group order.
template <class T>
__global__ void stream_read_finish(const T* __restrict__ tok, const T* __restrict__ partial,
                                   T* __restrict__ out, int n_cols, int groups) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kHalo * n_cols) return;
  T s = tok[e];
  for (int g = 0; g < groups; ++g) s += partial[static_cast<size_t>(g) * kHalo * n_cols + e];
  out[e] = s;
}

bool tiling_ok(int n_rows, int n_cols, int bm, int rows, int slots, int width, int per,
               size_t itemsize) {
  const int vec = static_cast<int>(16 / itemsize);
  return n_rows > 0 && bm > 0 && n_rows % bm == 0 && n_cols > 0 && n_cols % vec == 0 &&
         slots >= 1 && slots <= kMaxSlots && width > 0 && width % vec == 0 &&
         width <= kMaxWidth && per > 0 &&
         static_cast<size_t>(slots) * rows * width * itemsize <= kRingBytes;
}

dim3 grid_of(int n_rows, int n_cols, int bm, int width, int per) {
  const int nchunks = n_rows / bm;
  return dim3((n_cols + width - 1) / width, (nchunks + per - 1) / per);
}

// Allow the ring's dynamic shared memory once per kernel and device.
template <class K>
cudaError_t allow_ring(K kernel, int& allowed_on) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device != allowed_on) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
    if (err == cudaSuccess) allowed_on = device;
  }
  return err;
}

template <class T>
int launch_copy(const T* u, T* out, int n_rows, int n_cols, int bm, int slots, int depth,
                int halos, int width, int per, void* stream) {
  const int rows = bm + (halos ? 2 * kHalo : 0);
  if (!tiling_ok(n_rows, n_cols, bm, rows, slots, width, per, sizeof(T)) || depth < 1 ||
      depth > slots - 1 || (halos && n_rows < kHalo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int allowed_on = -1;
  cudaError_t err = allow_ring(staged_copy_kernel<T>, allowed_on);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = static_cast<size_t>(slots) * rows * width * sizeof(T);
  staged_copy_kernel<T><<<grid_of(n_rows, n_cols, bm, width, per), kThreads, bytes,
                          static_cast<cudaStream_t>(stream)>>>(u, out, n_rows, n_cols, bm, slots,
                                                                depth, halos, width, per);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_write(const T* tok, T* out, int n_rows, int n_cols, int bm, int slots, int width,
                 int per, void* stream) {
  if (!tiling_ok(n_rows, n_cols, bm, bm, slots, width, per, sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int allowed_on = -1;
  cudaError_t err = allow_ring(stream_write_kernel<T>, allowed_on);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = static_cast<size_t>(slots) * bm * width * sizeof(T);
  stream_write_kernel<T><<<grid_of(n_rows, n_cols, bm, width, per), kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(tok, out, n_rows, n_cols, bm,
                                                                 slots, width, per);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_read(const T* u, const T* tok, T* partial, T* out, int n_rows, int n_cols, int bm,
                int slots, int width, int per, void* stream) {
  if (!tiling_ok(n_rows, n_cols, bm, bm, slots, width, per, sizeof(T)) || bm < kHalo) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int allowed_on = -1;
  cudaError_t err = allow_ring(stream_read_kernel<T>, allowed_on);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = grid_of(n_rows, n_cols, bm, width, per);
  const size_t bytes = static_cast<size_t>(slots) * bm * width * sizeof(T);
  auto s = static_cast<cudaStream_t>(stream);
  stream_read_kernel<T><<<grid, kThreads, bytes, s>>>(u, partial, n_rows, n_cols, bm, slots,
                                                      width, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = kHalo * n_cols;
  stream_read_finish<T><<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      tok, partial, out, n_cols, static_cast<int>(grid.y));
  return static_cast<int>(cudaGetLastError());
}

template <class K>
int resources_of(K kernel, int* r) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  r[0] = a.numRegs;
  r[1] = kRingBytes;
  r[2] = static_cast<int>(a.localSizeBytes);
  r[4] = kThreads;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r[3], kernel, kThreads, kRingBytes));
}

}  // namespace

extern "C" int stream_read_f32(const float* u, const float* tok, float* partial, float* out,
                               int n_rows, int n_cols, int bm, int slots, int width, int per,
                               void* stream) {
  return launch_read(u, tok, partial, out, n_rows, n_cols, bm, slots, width, per, stream);
}

extern "C" int stream_read_f64(const double* u, const double* tok, double* partial, double* out,
                               int n_rows, int n_cols, int bm, int slots, int width, int per,
                               void* stream) {
  return launch_read(u, tok, partial, out, n_rows, n_cols, bm, slots, width, per, stream);
}

extern "C" int stream_write_f32(const float* tok, float* out, int n_rows, int n_cols, int bm,
                                int slots, int width, int per, void* stream) {
  return launch_write(tok, out, n_rows, n_cols, bm, slots, width, per, stream);
}

extern "C" int stream_write_f64(const double* tok, double* out, int n_rows, int n_cols, int bm,
                                int slots, int width, int per, void* stream) {
  return launch_write(tok, out, n_rows, n_cols, bm, slots, width, per, stream);
}

extern "C" int staged_copy_f32(const float* u, float* out, int n_rows, int n_cols, int bm,
                               int slots, int depth, int halos, int width, int per,
                               void* stream) {
  return launch_copy(u, out, n_rows, n_cols, bm, slots, depth, halos, width, per, stream);
}

extern "C" int staged_copy_f64(const double* u, double* out, int n_rows, int n_cols, int bm,
                               int slots, int depth, int halos, int width, int per,
                               void* stream) {
  return launch_copy(u, out, n_rows, n_cols, bm, slots, depth, halos, width, per, stream);
}

// Registers, ring bytes, local (spill) bytes, resident blocks an SM and
// threads of kernel `which` (0 read, 1 write, 2 copy) in f32 or f64.
extern "C" int stream_ladder_resources(int which, int is_f64, int* r) {
  if (is_f64) {
    return which == 0 ? resources_of(stream_read_kernel<double>, r)
         : which == 1 ? resources_of(stream_write_kernel<double>, r)
                      : resources_of(staged_copy_kernel<double>, r);
  }
  return which == 0 ? resources_of(stream_read_kernel<float>, r)
       : which == 1 ? resources_of(stream_write_kernel<float>, r)
                    : resources_of(staged_copy_kernel<float>, r);
}
