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
// The terms come as a small int32 table in device memory — (k, dy, dx) or
// (k, off) per term, in the order the plain version sums them — so any
// number of terms and any shifts are taken with one compiled kernel.  The
// table is prepared by the wrapper: cyclic shifts are reduced to [0, n)
// so that the wrap is one compare and subtract, and clamped terms that can
// reach no point are left out.  Element offsets are 64-bit: nterms * ny *
// nx passes 2^31 at 13 fields x 16384^2.
//
// The SpMV grid_dia_matvec (the "tiled" kernel below) gives each block a
// tile of 8 rows x 128 columns and builds, at its start, the block's own
// list of live terms in shared memory, in table order, from the table: a
// term none of whose sources lies in the grid for the tile is dropped; a
// term all of whose sources lie in the grid (cyclic: none of which wraps
// within the tile) becomes one flat offset of x with no per-point test;
// the rest keep the per-point test.  Interior tiles of the far-shift
// containers (33 stored fields, |dy| up to ny - 1) so walk their 13 near
// terms with no test and skip the 20 far ones that the one-thread-a-point
// kernel of the earlier design tested at every point.  A thread computes 4
// neighbouring points of a row: one 16-byte vector of f32, two of f64
// (128 columns apart in both), where the rows are whole, aligned vectors;
// 4 scalar points 32 columns apart otherwise (odd widths: the "scalar"
// path, chosen by the wrapper from shape and address alone).  The loads of
// 4 terms are issued before their multiply-adds, so a thread has 4 terms x
// 4 points of coefficients and x in flight where the earlier kernel had one
// load behind a dependent chain of table loads and a branch.  Coefficients
// are read once, past L1; the shifted reads of x overlap between
// neighbouring threads and terms and are served by L1 through the
// read-only path.  Each point sums its live terms in table order, each
// product fused into one FMA; a dropped term or an untaken point adds
// d = 0 times x = 0, exactly nothing (the sum is never -0), so the kernel
// equals the earlier one-thread-a-point kernel bit for bit.  Lists longer
// than one chunk of 256 terms are built and walked a chunk at a time.
//
// The SpMM has two kernels, chosen by the wrapper from shape, term table
// and address alone (ops/spmv.py::spmm_path).  The "general" one takes any
// container and any shape (far shifts, odd widths, unaligned stacks,
// stages too large for shared memory); the row-slab kernel below
// (grid_dia_matmat_slab, the "slab" path) takes containers whose signed
// reach fits its halo (|dy| <= 8, |dx| <= one 16-byte vector; cyclic
// shifts taken in (-n/2, n/2]) on rows of whole, aligned 16-byte vectors,
// in both layouts.  Both replace grid_dia_matmat_pallas (:301,
// pallas_call :279) and grid_dia_matmat_interleaved_pallas (:335, :462);
// the two layouts differ only in the strides of x and y.
//
// The general SpMM (grid_dia_matmat_tiled) takes the tiled SpMV's
// per-block live-term list (one device function, build_live_list, builds
// it for both) to a stack.  A block owns a tile of 8 rows x 64 f32 / 32 f64
// columns, a thread 2 f32 or 1 f64 points of a row 32 columns apart for a
// register tile of up to 8 right-hand sides; each live term's coefficient
// is loaded once a point for all of them, the loads of 4 f32 / 8 f64 terms
// issued together before their multiply-adds.  x is staged once a register
// tile in a shared-memory window (the tile with 2 rows and one 16-byte
// vector of columns each side, for the 8 right-hand sides: 27 KB f32) by
// cp.async, as 16-byte vectors on the vector path (rows of whole, aligned
// vectors) and element by element on the scalar one (odd widths such as
// 999 f64, unaligned stacks), and every whole term within that reach reads
// it there, a warp 32 neighbouring words of a row: no bank conflict at any
// shift.  Far and partial terms read x through L1.  Each point sums its
// live terms in table order, one FMA a term a right-hand side, as a host
// loop with std::fma does (tools/emulate_dia_spmv.py): the two are equal
// bit for bit.  What held the one-thread-a-point kernel of the earlier
// design at a third of its bound on the far-shift container: every point
// walked all 33 terms and tested each source, 20 of them on average
// outside the grid.  Measured on the
// way and dropped, each slower on the far-shift container: 16-byte slots
// with x read through L1 as pairs of aligned vectors; the coefficients of
// the list staged in shared memory too; the next group's coefficient
// loads issued a group ahead; x through L1 with no window (still a
// variant of tools/tune_port_kernels.py general).

// What bounds the SpMM: bytes, (nterms + 2 nrhs) fields (486.5 MB at 2048^2
// x 8 f32 with 13 terms: 0.145 ms over 3.35 TB/s).  The slab kernel follows
// the TPU kernel's slab pipeline: a block owns a strip of W columns
// and marches down a segment of rows in slabs of B rows; per slab it copies
// the coefficient chunk (nterms x B x W) and the x slab with its halo
// (nrhs x (B + 2 HY) x (W + 2 vectors), HY = 2 or 8 staged halo rows) into
// a ring of S stages of shared memory with 16-byte cp.async, one commit
// group per slab, so S - 1 slabs of copies are in flight while one is
// computed; the top halo rows of a slab are copied in shared memory from
// the previous slab's stage, so each x row is read from global memory once
// a segment.  Halos come from the wrapped rows and columns (cyclic) or are
// zero-filled by the copy itself (clamped: a source outside the grid then
// adds d * 0, nothing, as in the plain version's zero padding).  A thread
// computes CPT x RPT points of the slab for a register tile of 8
// right-hand sides, reading each coefficient once per tile and x from
// shared memory at offsets that are constants but for the term's (a warp
// reads 32 neighbouring words of a row: no bank conflict at any shift);
// the terms are summed in the table's order, as in the general kernel.
// The segments are sized so that the grid is one wave of resident blocks.
// What remains between it and the bound is the card's streaming rate for
// this mix of 21 read and 8 written fields, not the arithmetic, which runs
// under the copies: on an H100 80GB HBM3 its copies and stores alone take
// 0.19 ms at 2048^2 x 8 f32, a plain copy of the same bytes 0.163 ms
// (tools/tune_port_kernels.py spmm).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

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

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

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

// ---- per-block live-term lists: the tiled SpMV and the tiled SpMM ----------------

constexpr int kTileThreads = 256;          // a block: 8 warps
constexpr int kTileChunk = kTileThreads;   // terms classified a pass, one a thread

// A term as one block sees it: its coefficient field, and either the flat
// offset of its sources (whole) or the shift each point tests (partial).
struct LiveTerm {
  long long coef;  // k * ny * nx: the field's first element
  long long xoff;  // whole: dy * (x's row stride) + dx, after the wrap of a cyclic axis
  int dy, dx;      // the shift: the table's (partial), the one that reaches the sources (whole)
  int whole;
};

// The tile's indices [lo, hi] along an axis of length n, shifted by d: 0 no
// source in the grid (clamped), 1 every source in it (clamped) or none of
// them wrapping (cyclic; *eff is then the shift that reaches them), 2 some
// of each.
template <bool CYCLIC>
__device__ __forceinline__ int axis_kind(int lo, int hi, int d, int n, int* eff) {
  *eff = d;
  if constexpr (CYCLIC) {
    if (hi + d < n) return 1;
    if (lo + d >= n) {
      *eff = d - n;
      return 1;
    }
    return 2;
  } else {
    if (hi + d < 0 || lo + d >= n) return 0;
    return lo + d >= 0 && hi + d < n ? 1 : 2;
  }
}

// The live list of the tile of rows [r0, r1) and columns [c0, c1) for the
// chunk of terms [t0, t0 + kTileChunk) of the table, in table order, in
// s_list; returns its length.  Each thread classifies one term; a warp's
// live terms are compacted by a ballot, the warps' by their counts in
// s_live.  xrow is x's row stride (nx for the SpMV and the stacked SpMM,
// nrhs * nx interleaved).  all_partial (a probe) keeps every term, each
// tested per point.  Two barriers: the list is complete for every thread
// on return, and a caller may build again with no barrier of its own: the
// new list is written only past the first barrier, which every thread
// reaches only once it is done with the last list (s_live is read only
// between the last build's two barriers).
template <bool CYCLIC>
__device__ __forceinline__ int build_live_list(const int* __restrict__ terms, int nterms,
                                               int t0, int r0, int r1, int c0, int c1,
                                               int ny, int nx, long long xrow, bool all_partial,
                                               LiveTerm* s_list, int* s_live) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = t0 + tid;
  int kind = 0;
  LiveTerm e{};
  if (t < nterms) {
    const int k = terms[3 * t], dy = terms[3 * t + 1], dx = terms[3 * t + 2];
    int ey, ex;
    const int ky = axis_kind<CYCLIC>(r0, r1 - 1, dy, ny, &ey);
    const int kx = axis_kind<CYCLIC>(c0, c1 - 1, dx, nx, &ex);
    kind = (ky == 0 || kx == 0) ? 0 : (ky == 1 && kx == 1 ? 1 : 2);
    if (all_partial) kind = 2;
    e.coef = k * (static_cast<long long>(ny) * nx);
    e.xoff = ey * xrow + ex;
    e.dy = kind == 1 ? ey : dy;
    e.dx = kind == 1 ? ex : dx;
    e.whole = kind == 1;
  }
  const unsigned live = __ballot_sync(0xffffffffu, kind != 0);
  if (lane == 0) s_live[warp] = __popc(live);
  __syncthreads();
  int at = 0, n = 0;
#pragma unroll
  for (int w = 0; w < kTileThreads / 32; ++w) {
    const int c = s_live[w];
    at += w < warp ? c : 0;
    n += c;
  }
  if (kind != 0) s_list[at + __popc(live & ((1u << lane) - 1u))] = e;
  __syncthreads();
  return n;
}

// One tiling of the tiled kernels: TX of the block's threads lie along a
// row; a thread takes NV slots along a row (TX * V columns apart) of RPT
// rows (kTileThreads / TX rows apart); a slot is one 16-byte vector (VEC:
// rows of whole, aligned vectors) or one point; the loads of U terms are
// issued before their multiply-adds; MINB resident blocks an SM cap the
// registers (1: no cap).
template <class T, bool VEC, int NV, int RPT, int U, int TX_ = 32, int MINB_ = 1>
struct MvTiling {
  using Type = T;
  static constexpr bool kVec = VEC;
  static constexpr int V = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;  // points a slot
  static constexpr int NS = NV, R = RPT, UN = U, TX = TX_, MINB = MINB_;
  static constexpr int P = NV * V;                 // points a thread along a row
  static constexpr int TY = kTileThreads / TX;
  static constexpr int W = TX * P, H = TY * RPT;   // the block's tile
  static_assert(kTileThreads % TX == 0 && TX % 32 == 0, "whole warps along a row");
};

__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load16(const double* p, double* v) {
  const double2 q = __ldcg(reinterpret_cast<const double2*>(p));
  v[0] = q.x;
  v[1] = q.y;
}
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// The tuning script's probes (PROBE): 1 every term tested at every point,
// none dropped (no list); 2 the loads without the multiply-adds (the
// loaded bits are xor-ed); 3 the coefficients alone (no x read, x = 1);
// 4 x alone (no coefficient read, d = 1).
enum MvProbe { kMvKernel = 0, kMvNoList = 1, kMvLoadsAlone = 2, kMvCoefAlone = 3, kMvXAlone = 4 };

__device__ __forceinline__ float mix_bits(float a, float d, float x) {
  return __uint_as_float(__float_as_uint(a) ^ __float_as_uint(d) ^ __float_as_uint(x));
}
__device__ __forceinline__ double mix_bits(double a, double d, double x) {
  return __longlong_as_double(__double_as_longlong(a) ^ __double_as_longlong(d)
                              ^ __double_as_longlong(x));
}

template <class G, bool CYCLIC, int PROBE>
__global__ void __launch_bounds__(kTileThreads, G::MINB)
grid_dia_matvec_tiled_kernel(const typename G::Type* __restrict__ data,
                             const int* __restrict__ terms, int nterms,
                             const typename G::Type* __restrict__ x,
                             typename G::Type* __restrict__ y, int ny, int nx) {
  using T = typename G::Type;
  constexpr int V = G::V, NS = G::NS, P = G::P, R = G::R, U = G::UN;
  __shared__ LiveTerm s_list[kTileChunk];
  __shared__ int s_live[kTileThreads / 32];
  const int tid = threadIdx.x;
  const int tx = tid % G::TX, ty = tid / G::TX;
  // the tile's grid points: rows [r0, r1), columns [c0, c1)
  const int r0 = blockIdx.y * G::H, c0 = blockIdx.x * G::W;
  const int r1 = min(r0 + G::H, ny), c1 = min(c0 + G::W, nx);

  // the thread's points: row[q] x (col[m] .. col[m] + V - 1), slot m at
  // flat index base[q] + m * TX * V; a slot lies in the grid whole or not
  // at all (VEC: nx is whole vectors)
  int row[R], col[NS];
  long long base[R];
  bool rok[R], cok[NS];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    row[q] = r0 + ty + q * G::TY;
    rok[q] = row[q] < ny;
    base[q] = static_cast<long long>(row[q]) * nx + c0 + tx * V;
  }
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    col[m] = c0 + (m * G::TX + tx) * V;
    cok[m] = col[m] < nx;
  }
  T acc[R][P];
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int p = 0; p < P; ++p) acc[q][p] = T(0);

  for (int t0 = 0; t0 < nterms; t0 += kTileChunk) {
    const int n = build_live_list<CYCLIC>(terms, nterms, t0, r0, r1, c0, c1, ny, nx, nx,
                                          PROBE == kMvNoList, s_list, s_live);
    for (int e0 = 0; e0 < n; e0 += U) {
      // the loads of U terms, then their multiply-adds in table order; a
      // term past the list or a point it does not reach keeps d = x = 0
      T d[U][R][P], xv[U][R][P];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int q = 0; q < R; ++q)
#pragma unroll
          for (int p = 0; p < P; ++p) d[u][q][p] = xv[u][q][p] = T(0);
        if (e0 + u >= n) continue;
        const LiveTerm lt = s_list[e0 + u];
        if (lt.whole) {
          // one coefficient and one source pointer a row; the slots lie at
          // constant offsets from them
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const T* dp = data + (lt.coef + base[q]);
            const T* xp = x + (base[q] + lt.xoff);
#pragma unroll
            for (int m = 0; m < NS; ++m) {
              if (!(rok[q] && cok[m])) continue;
              T* dd = &d[u][q][m * V];
              if constexpr (PROBE == kMvXAlone) {
#pragma unroll
                for (int i = 0; i < V; ++i) dd[i] = T(1);
              } else if constexpr (G::kVec) {
                load16(dp + m * G::TX * V, dd);
              } else {
                dd[0] = __ldcg(dp + m * G::TX);
              }
#pragma unroll
              for (int i = 0; i < V; ++i) {
                xv[u][q][m * V + i] =
                    PROBE == kMvCoefAlone ? T(1) : __ldg(xp + (m * G::TX * V + i));
              }
            }
          }
        } else {
#pragma unroll
          for (int q = 0; q < R; ++q)
#pragma unroll
            for (int m = 0; m < NS; ++m)
#pragma unroll
              for (int i = 0; i < V; ++i) {
                int rr, cc;
                if (!(rok[q] && cok[m]) || !shifted<CYCLIC>(row[q], lt.dy, ny, rr)
                    || !shifted<CYCLIC>(col[m] + i, lt.dx, nx, cc)) {
                  continue;
                }
                const long long here = base[q] + m * G::TX * V + i;
                d[u][q][m * V + i] =
                    PROBE == kMvXAlone ? T(1) : __ldcg(data + lt.coef + here);
                xv[u][q][m * V + i] =
                    PROBE == kMvCoefAlone ? T(1)
                                          : __ldg(x + (static_cast<long long>(rr) * nx + cc));
              }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int q = 0; q < R; ++q)
#pragma unroll
          for (int p = 0; p < P; ++p) {
            acc[q][p] = PROBE == kMvLoadsAlone ? mix_bits(acc[q][p], d[u][q][p], xv[u][q][p])
                                               : fma_rn(d[u][q][p], xv[u][q][p], acc[q][p]);
          }
    }
  }

#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      if (!(rok[q] && cok[m])) continue;
      T* out = y + (base[q] + m * G::TX * V);
      if constexpr (G::kVec) {
        store16(out, &acc[q][m * V]);
      } else {
        *out = acc[q][m];
      }
    }
}

// Launch the tiled SpMV of tiling G.  Returns cudaErrorInvalidValue for
// what it does not take: a vector tiling on rows that are not whole,
// aligned 16-byte vectors, or a grid past 65535 tiles of rows.
template <class G, bool CYCLIC, int PROBE = kMvKernel>
int launch_mv(const typename G::Type* data, const int* terms, int nterms,
              const typename G::Type* x, typename G::Type* y, int ny, int nx, cudaStream_t s) {
  const auto misaligned = (reinterpret_cast<uintptr_t>(data) | reinterpret_cast<uintptr_t>(x)
                           | reinterpret_cast<uintptr_t>(y)) % 16;
  const long long tiles_y = (static_cast<long long>(ny) + G::H - 1) / G::H;
  if (nterms < 0 || ny < 1 || nx < 1 || tiles_y > static_cast<long long>(kMaxGridY)
      || (G::kVec && (nx % G::V || misaligned))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  grid_dia_matvec_tiled_kernel<G, CYCLIC, PROBE>
      <<<dim3(static_cast<unsigned>((nx + G::W - 1) / G::W), static_cast<unsigned>(tiles_y)),
         kTileThreads, 0, s>>>(data, terms, nterms, x, y, ny, nx);
  return static_cast<int>(cudaGetLastError());
}

// The chosen tilings (tools/tune_port_kernels.py spmv): 4 points a thread
// along a row (one f32 vector, two f64 vectors or 4 scalar points), one
// row, 32 threads along it: tiles of 8 x 128; the loads of 4 terms at a
// time on the f32 vector path, of 2 elsewhere (4 f64 terms take 94-118
// registers and ran slower); registers capped for 4 blocks an SM, which
// the clamped kernels meet anyway and the cyclic ones (up to 86) meet with
// no spill.  Mirrored in ops/spmv.py (_MV_ROWS, _MV_TX, _MV_POINTS,
// _MV_CHUNK).
template <class T, bool VEC>
using MvOf = MvTiling<T, VEC, VEC ? static_cast<int>(sizeof(T)) / 4 : 4, 1,
                      VEC && sizeof(T) == 4 ? 4 : 2, 32, 4>;

template <class T>
int launch_grid_matvec(const T* data, const int* terms, int nterms, int cyclic, int vec,
                       const T* x, T* y, int ny, int nx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    using G = MvOf<T, true>;
    return cyclic ? launch_mv<G, true>(data, terms, nterms, x, y, ny, nx, s)
                  : launch_mv<G, false>(data, terms, nterms, x, y, ny, nx, s);
  }
  using G = MvOf<T, false>;
  return cyclic ? launch_mv<G, true>(data, terms, nterms, x, y, ny, nx, s)
                : launch_mv<G, false>(data, terms, nterms, x, y, ny, nx, s);
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

// ---- cp.async: copies from global to shared memory ------------------------------

// 16 bytes from global to shared memory, asynchronously, past L1; with fill
// false nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(fill ? 16 : 0) : "memory");
}

// One element (4 or 8 bytes) from global to shared memory, asynchronously.
template <int BYTES>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(d), "l"(src), "n"(BYTES) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---- the tiled SpMM: the general path ------------------------------------------

// One tiling of the tiled SpMM: 32 threads along a row, a thread NV points
// of one row 32 columns apart (tiles of 8 rows x 32 NV columns), a register
// tile of J right-hand sides (at most kRhsTile), the
// coefficient loads of U terms issued together, MINB resident blocks an SM
// capping the registers, and with HY > 0 a window of x in shared memory:
// the tile's rows with HY rows and its columns with one 16-byte vector (HX
// elements) each side, for the J right-hand sides, copied once a register
// tile with cp.async (as 16-byte vectors with CPV, where the rows are
// whole, aligned vectors; else element by element) and read there by
// every whole term whose shift lies within that reach; x of every other
// term (and, HY = 0, of all) is read through L1.
template <class T, int NV, int U, int J_, int MINB_, int HY_, bool CPV_ = false>
struct MmTiling : MvTiling<T, false, NV, 1, U, 32, MINB_> {
  using Base = MvTiling<T, false, NV, 1, U, 32, MINB_>;
  static constexpr int J = J_, HY = HY_;
  static constexpr bool kCopyVec = CPV_;
  static constexpr int VB = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte vector
  static constexpr int HX = HY_ > 0 ? VB : 0;
  static constexpr int WR = Base::H + 2 * HY, WP = Base::W + 2 * HX;  // window rows, pitch
  static constexpr size_t kWindowBytes = HY_ > 0 ? sizeof(T) * J * WR * WP : 0;
  static_assert(J >= 1 && J <= kRhsTile, "a register tile of at most kRhsTile right-hand sides");
};

// Issue the copies of the x window of the register tile at rhs j0 (nj
// right-hand sides) for the tile at (r0, c0): only elements inside the
// grid (a whole term reads no other).
template <class G>
__device__ __forceinline__ void copy_window(typename G::Type* win,
                                            const typename G::Type* __restrict__ x, int j0,
                                            int nj, int r0, int c0, int ny, int nx, long long rs,
                                            long long ws) {
  constexpr int VB = G::kCopyVec ? G::VB : 1;  // elements a copy
  constexpr int per_row = G::WP / VB;
  const int total = nj * G::WR * per_row;
  for (int e = threadIdx.x; e < total; e += kTileThreads) {
    const int v = e % per_row, wr = (e / per_row) % G::WR, j = e / (per_row * G::WR);
    const int gr = r0 - G::HY + wr, gc = c0 - G::HX + v * VB;
    if (gr < 0 || gr >= ny || gc < 0 || gc >= nx) continue;
    typename G::Type* dst = win + (j * G::WR + wr) * G::WP + v * VB;
    const typename G::Type* src = x + ((j0 + j) * rs + static_cast<long long>(gr) * ws + gc);
    if constexpr (G::kCopyVec) {
      cp_async16(dst, src, true);
    } else {
      cp_async_elem<sizeof(typename G::Type)>(dst, src);
    }
  }
  cp_async_commit();
}

// Element (j, r, c) of x and y lies at j * rs + r * ws + c: (nrhs, ny, nx)
// has rs = ny * nx, ws = nx; (ny, nrhs, nx) rs = nx, ws = nrhs * nx.
// Probes as the tiled SpMV's (MvProbe); coefficients alone copies no
// window.
template <class G, bool CYCLIC, int PROBE>
__global__ void __launch_bounds__(kTileThreads, G::MINB)
grid_dia_matmat_tiled_kernel(const typename G::Type* __restrict__ data,
                             const int* __restrict__ terms, int nterms,
                             const typename G::Type* __restrict__ x,
                             typename G::Type* __restrict__ y, int nrhs, int ny, int nx,
                             long long rs, long long ws) {
  using T = typename G::Type;
  constexpr int NS = G::NS, U = G::UN, J = G::J, TX = G::TX;
  __shared__ LiveTerm s_list[kTileChunk];
  __shared__ int s_live[kTileThreads / 32];
  extern __shared__ __align__(16) unsigned char mm_smem[];
  T* win = reinterpret_cast<T*>(mm_smem);  // the x window (G::HY > 0)
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  // the tile's grid points: rows [r0, r1), columns [c0, c1)
  const int r0 = blockIdx.y * G::H, c0 = blockIdx.x * G::W;
  const int r1 = min(r0 + G::H, ny), c1 = min(c0 + G::W, nx);

  // the thread's points: (row, col[m]); point m's coefficient lies at
  // cbase + m * TX of a field, its x and y at xbase + m * TX of rhs 0, its
  // window cell at wbase + m * TX
  const int row = r0 + ty;
  int col[NS];
  bool ok[NS];
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    col[m] = c0 + m * TX + tx;
    ok[m] = row < ny && col[m] < nx;
  }
  const long long cbase = static_cast<long long>(row) * nx + c0 + tx;
  const long long xbase = static_cast<long long>(row) * ws + c0 + tx;
  const int wbase = (ty + G::HY) * G::WP + G::HX + tx;

  int n = 0;  // the list's length (one chunk: built once, for the first rhs tile)
  for (int j0 = 0; j0 < nrhs; j0 += J) {
    const int nj = min(J, nrhs - j0);
    const T* xj = x + j0 * rs;
    // the rhs tile's window has landed for every thread: waited for before
    // the first group of live terms, in whichever chunk of the table that
    // falls (block-uniform: the list's length is)
    bool waited = G::HY == 0;
    if constexpr (G::HY > 0) {
      if (j0 > 0) __syncthreads();  // every thread is done with the last window
      if (PROBE != kMvCoefAlone) copy_window<G>(win, x, j0, nj, r0, c0, ny, nx, rs, ws);
    }
    T acc[J][NS];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int m = 0; m < NS; ++m) acc[j][m] = T(0);

    for (int t0 = 0; t0 < nterms; t0 += kTileChunk) {
      if (j0 == 0 || nterms > kTileChunk) {
        n = build_live_list<CYCLIC>(terms, nterms, t0, r0, r1, c0, c1, ny, nx, ws,
                                    PROBE == kMvNoList, s_list, s_live);
      }
      for (int e0 = 0; e0 < n; e0 += U) {
        // the coefficients of U terms, loaded together, each once for the J
        // right-hand sides; a term past the list or a point it does not
        // reach has d = 0 (and x = 0 below)
        T d[U][NS];
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int m = 0; m < NS; ++m) d[u][m] = T(0);
          if (e0 + u >= n) continue;
          const LiveTerm lt = s_list[e0 + u];
#pragma unroll
          for (int m = 0; m < NS; ++m) {
            int rr, cc;
            if (!ok[m] || (!lt.whole && (!shifted<CYCLIC>(row, lt.dy, ny, rr)
                                         || !shifted<CYCLIC>(col[m], lt.dx, nx, cc)))) {
              continue;
            }
            d[u][m] = PROBE == kMvXAlone ? T(1) : __ldcg(data + (lt.coef + cbase + m * TX));
          }
        }
        if constexpr (G::HY > 0) {
          if (!waited) {
            cp_async_wait<0>();
            __syncthreads();
            waited = true;
          }
        }
        // term by term in table order: x from the window or from global
        // memory into the multiply-adds
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (e0 + u >= n) break;
          const LiveTerm lt = s_list[e0 + u];
          T xv[J][NS];
          if (G::HY > 0 && lt.whole && abs(lt.dy) <= G::HY && abs(lt.dx) <= G::HX) {
            const T* w = win + (wbase + lt.dy * G::WP + lt.dx);
#pragma unroll
            for (int j = 0; j < J; ++j)
#pragma unroll
              for (int m = 0; m < NS; ++m) {
                xv[j][m] = PROBE == kMvCoefAlone ? T(1) : w[j * (G::WR * G::WP) + m * TX];
              }
          } else {
#pragma unroll
            for (int m = 0; m < NS; ++m) {
              int rr = row + lt.dy, cc = col[m] + lt.dx;  // whole: the shift that reaches them
              const bool in = ok[m] && (lt.whole || (shifted<CYCLIC>(row, lt.dy, ny, rr)
                                                     && shifted<CYCLIC>(col[m], lt.dx, nx, cc)));
              const T* xs = xj + (static_cast<long long>(rr) * ws + cc);
#pragma unroll
              for (int j = 0; j < J; ++j) {
                xv[j][m] = !in || j >= nj ? T(0)
                           : PROBE == kMvCoefAlone ? T(1) : __ldg(xs + j * rs);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < J; ++j)
#pragma unroll
            for (int m = 0; m < NS; ++m) {
              acc[j][m] = PROBE == kMvLoadsAlone ? mix_bits(acc[j][m], d[u][m], xv[j][m])
                                                 : fma_rn(d[u][m], xv[j][m], acc[j][m]);
            }
        }
      }
    }
    if constexpr (G::HY > 0) {
      // no live term: the copies land before the next rhs tile's overwrite them
      if (!waited) cp_async_wait<0>();
    }

    T* yj = y + j0 * rs;
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      if (!ok[m]) continue;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (j < nj) yj[xbase + j * rs + m * TX] = acc[j][m];
      }
    }
  }
}

// Launch the tiled SpMM of tiling G on either layout (interleaved 0:
// (nrhs, ny, nx), 1: (ny, nrhs, nx)).  Returns cudaErrorInvalidValue for
// what it does not take: a vector tiling (or vector copies of the window)
// on rows that are not whole, aligned 16-byte vectors, or a grid past
// 65535 tiles of rows.
template <class G, bool CYCLIC, int PROBE = kMvKernel>
int launch_mm(const typename G::Type* data, const int* terms, int nterms,
              const typename G::Type* x, typename G::Type* y, int nrhs, int ny, int nx,
              int interleaved, cudaStream_t s) {
  const auto misaligned = (reinterpret_cast<uintptr_t>(data) | reinterpret_cast<uintptr_t>(x)
                           | reinterpret_cast<uintptr_t>(y)) % 16;
  const long long tiles_y = (static_cast<long long>(ny) + G::H - 1) / G::H;
  if (nterms < 0 || nrhs < 1 || ny < 1 || nx < 1 || tiles_y > static_cast<long long>(kMaxGridY)
      || (G::kCopyVec && (nx % G::VB || misaligned))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = grid_dia_matmat_tiled_kernel<G, CYCLIC, PROBE>;
  // past 48 KB of shared memory a block (the tuning script's wider
  // tilings; the chosen ones take 36 KB) the kernel must be allowed, once
  constexpr size_t kStaticBytes =
      sizeof(LiveTerm) * kTileChunk + sizeof(int) * (kTileThreads / 32);
  if constexpr (G::kWindowBytes + kStaticBytes > 48 * 1024) {
    static int allowed_on = -1;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess && device != allowed_on) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(G::kWindowBytes));
      if (err == cudaSuccess) allowed_on = device;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long rs = interleaved ? nx : static_cast<long long>(ny) * nx;
  const long long ws = interleaved ? static_cast<long long>(nrhs) * nx : nx;
  kernel<<<dim3(static_cast<unsigned>((nx + G::W - 1) / G::W), static_cast<unsigned>(tiles_y)),
           kTileThreads, G::kWindowBytes, s>>>(data, terms, nterms, x, y, nrhs, ny, nx, rs, ws);
  return static_cast<int>(cudaGetLastError());
}

// The chosen tilings (tools/tune_port_kernels.py general): 32 threads
// along a row, a register tile of 8 right-hand sides, the x window with 2
// rows each side, registers capped for 4 blocks an SM (64, no spill); in
// f32 2 points a thread (tiles of 8 x 64), the coefficient loads of 4 terms
// issued together; in f64 1 point a thread (tiles of 8 x 32), the loads of
// 8 terms.  The vector path
// copies the window as 16-byte vectors, the scalar path element by
// element.  Mirrored in ops/spmv.py (_MM_ROWS, _MM_COLS, _MM_RHS_TILE).
template <class T, bool VEC>
using MmOf = MmTiling<T, sizeof(T) == 4 ? 2 : 1, sizeof(T) == 4 ? 4 : 8, kRhsTile, 4, 2, VEC>;

template <class T>
int launch_grid_matmat(const T* data, const int* terms, int nterms, int cyclic, int vec,
                       int interleaved, const T* x, T* y, int nrhs, int ny, int nx,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    using G = MmOf<T, true>;
    return cyclic ? launch_mm<G, true>(data, terms, nterms, x, y, nrhs, ny, nx, interleaved, s)
                  : launch_mm<G, false>(data, terms, nterms, x, y, nrhs, ny, nx, interleaved, s);
  }
  using G = MmOf<T, false>;
  return cyclic ? launch_mm<G, true>(data, terms, nterms, x, y, nrhs, ny, nx, interleaved, s)
                : launch_mm<G, false>(data, terms, nterms, x, y, nrhs, ny, nx, interleaved, s);
}

// ---- the row-slab SpMM kernel --------------------------------------------------

constexpr int kSmemPerBlock = 232448;  // 227 KB: what a block may use on sm_90

// The tiling of one slab kernel: a strip of W columns, slabs of B rows with
// HY staged halo rows each side, S stages, NT threads of which TX lie along
// a row; a thread computes CPT columns (TX apart) x RPT rows (TY apart) of
// each slab.  HSMEM: a slab's top 2 hy halo rows are copied in shared
// memory from the previous slab's stage instead of from global memory, so
// that each x row is read from global memory once a segment.
template <class T, int W_, int B_, int S_, int TX_, int NT_, int HY_, bool HSMEM_ = true>
struct SlabTiling {
  using Type = T;
  static constexpr int W = W_, B = B_, S = S_, TX = TX_, NT = NT_, HY = HY_;
  static constexpr bool HSMEM = HSMEM_;
  static constexpr int V = 16 / static_cast<int>(sizeof(T));  // elements a vector
  static constexpr int CV = W / V;   // vectors in a strip row
  static constexpr int XV = CV + 2;  // ... with one halo vector each side
  static constexpr int XP = XV * V;  // pitch of a staged x row, in elements
  static constexpr int XR = B + 2 * HY;  // staged x rows a right-hand side
  static constexpr int TY = NT / TX, CPT = W / TX, RPT = B / TY;
  static constexpr int kLaneVectors = (XV + 31) / 32;
  static_assert(W % V == 0 && W % TX == 0 && NT % TX == 0 && TX % 32 == 0,
                "a row of a strip is whole vectors and whole warps");
  static_assert(B % TY == 0, "the threads tile the slab");
  static_assert((CV & (CV - 1)) == 0, "vectors in a strip row: a power of two");
};

// Elements of one stage: the coefficient chunk and the x slab with halos.
template <class G>
size_t slab_stage_elems(int nterms, int nrhs) {
  return static_cast<size_t>(nterms) * G::B * G::W
         + static_cast<size_t>(nrhs) * G::XR * G::XP;
}

// Dynamic shared memory of a launch: S stages and the term table (2 ints a term).
template <class G>
size_t slab_smem_bytes(int nterms, int nrhs) {
  return G::S * slab_stage_elems<G>(nterms, nrhs) * sizeof(typename G::Type)
         + 2 * sizeof(int) * static_cast<size_t>(nterms);
}

// Block (strip blockIdx.x, segment blockIdx.y of seg_slabs slabs).  terms:
// nterms rows of (k, dy, dx) with |dy| <= hy <= HY, |dx| <= V, signed.
// PROBE 1 leaves out the copies (computes from whatever shared memory
// holds), PROBE 2 the arithmetic (copies, then stores zeros), PROBE 3 the
// arithmetic and the stores: the tuning script's probes.
template <class G, bool CYCLIC, int PROBE>
__global__ void __launch_bounds__(G::NT)
grid_dia_matmat_slab_kernel(const typename G::Type* __restrict__ data,
                            const int* __restrict__ terms, int nterms,
                            const typename G::Type* __restrict__ x,
                            typename G::Type* __restrict__ y, int nrhs, int ny, int nx,
                            int hy, size_t rhs_stride, size_t row_stride, int seg_slabs) {
  using T = typename G::Type;
  constexpr int W = G::W, B = G::B, S = G::S, V = G::V, XP = G::XP, XR = G::XR, HY = G::HY;
  constexpr int kWarps = G::NT / 32;
  constexpr size_t kXStride = static_cast<size_t>(XR) * XP;  // between staged rhs
  extern __shared__ __align__(16) unsigned char slab_smem[];
  T* smem = reinterpret_cast<T*>(slab_smem);
  const size_t coef_elems = static_cast<size_t>(nterms) * B * W;
  const size_t stage = coef_elems + static_cast<size_t>(nrhs) * kXStride;
  int* s_k = reinterpret_cast<int*>(smem + S * stage);
  int* s_off = s_k + nterms;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int t = tid; t < nterms; t += G::NT) {
    s_k[t] = terms[3 * t];
    s_off[t] = terms[3 * t + 1] * XP + terms[3 * t + 2];
  }

  const int c0 = blockIdx.x * W;
  const int w = min(W, nx - c0);
  const int wv = w / V;
  const int first = blockIdx.y * seg_slabs;  // the block's slabs: first, first + 1, ...
  const int nslab = min(seg_slabs, (ny + B - 1) / B - first);
  const size_t field = static_cast<size_t>(ny) * nx;

  // the global column of each staged vector this lane copies: one halo
  // vector each side of the strip, wrapped (cyclic) or zero-filled; a
  // ragged last strip puts its right halo right after its last column
  int gcol[G::kLaneVectors];
  bool cok[G::kLaneVectors];
#pragma unroll
  for (int m = 0; m < G::kLaneVectors; ++m) {
    int gc = c0 - V + (lane + 32 * m) * V;
    bool ok = true;
    if constexpr (CYCLIC) {
      if (gc < 0) gc += nx;
      else if (gc >= nx) gc -= nx;
    } else {
      ok = gc >= 0 && gc < nx;
      if (!ok) gc = 0;
    }
    gcol[m] = gc;
    cok[m] = ok;
  }
  __syncthreads();  // the term table

  // the copies of slab i into stage i % S, one commit group
  auto issue = [&](int i) {
    if (PROBE != 1 && i < nslab) {
      T* cs = smem + (i % S) * stage;
      T* xs = cs + coef_elems;
      const int r0 = (first + i) * B;
      const int b = min(B, ny - r0);
      // coefficients: element e is vector e % CV of row e / CV of the chunk
      for (int e = tid; e < nterms * B * G::CV; e += G::NT) {
        const int v = e % G::CV, ri = e / G::CV, row = ri % B, t = ri / B;
        if (row < b && v < wv) {
          cp_async16(cs + static_cast<size_t>(ri) * W + v * V,
                     data + static_cast<size_t>(s_k[t]) * field
                         + static_cast<size_t>(r0 + row) * nx + c0 + v * V,
                     true);
        }
      }
      // x: a warp a staged row (rhs j, row), lane v its vector v; staged
      // row HY + r holds slab row r, rows [HY - hy, HY + b + hy) are needed,
      // and with HSMEM the top 2 hy of them of all but the segment's first
      // slab come from the previous stage (copy_halo)
      const int lo = HY - hy + ((G::HSMEM && i > 0) ? 2 * hy : 0), hi = HY + b + hy;
      int j = warp / XR, row = warp % XR;
      for (int ri = warp; ri < nrhs * XR; ri += kWarps) {
        if (row >= lo && row < hi) {
          int gr = r0 - HY + row;
          bool rok = true;
          if constexpr (CYCLIC) {
            if (gr < 0) gr += ny;
            else if (gr >= ny) gr -= ny;
          } else {
            rok = gr >= 0 && gr < ny;
            if (!rok) gr = 0;
          }
          const T* src = x + static_cast<size_t>(j) * rhs_stride
                         + static_cast<size_t>(gr) * row_stride;
          T* dst = xs + static_cast<size_t>(ri) * XP;
#pragma unroll
          for (int m = 0; m < G::kLaneVectors; ++m) {
            const int v = lane + 32 * m;
            if (v <= wv + 1) cp_async16(dst + v * V, src + gcol[m], rok && cok[m]);
          }
        }
        row += kWarps;
        while (row >= XR) {
          row -= XR;
          ++j;
        }
      }
    }
    cp_async_commit();  // one group a slab, empty past the last
  };

  // HSMEM: the top 2 hy staged rows of slab i + 1 are the bottom ones of slab i
  auto copy_halo = [&](int i) {
    if (G::HSMEM && PROBE != 1 && i + 1 < nslab) {
      const T* from = smem + (i % S) * stage + coef_elems;
      T* to = smem + ((i + 1) % S) * stage + coef_elems;
      for (int e = tid; e < nrhs * 2 * hy * G::XV; e += G::NT) {
        const int v = e % G::XV, ri = e / G::XV, j = ri / (2 * hy), row = HY - hy + ri % (2 * hy);
        const size_t at = static_cast<size_t>(j) * kXStride + row * XP + v * V;
        *reinterpret_cast<uint4*>(to + at) =
            *reinterpret_cast<const uint4*>(from + at + B * XP);
      }
    }
  };

  const int tx = tid % G::TX, ty = tid / G::TX;
  auto compute = [&](int i) {
    const T* cs = smem + (i % S) * stage;
    const T* xs = cs + coef_elems;
    const int r0 = (first + i) * B;
    const int b = min(B, ny - r0);
    for (int j0 = 0; j0 < nrhs; j0 += kRhsTile) {
      const int nj = min(kRhsTile, nrhs - j0);
      T acc[G::RPT][G::CPT][kRhsTile];
#pragma unroll
      for (int q = 0; q < G::RPT; ++q)
#pragma unroll
        for (int m = 0; m < G::CPT; ++m)
#pragma unroll
          for (int jj = 0; jj < kRhsTile; ++jj) acc[q][m][jj] = T(0);
      if (PROBE == 0 || PROBE == 1) {
        // every shared-memory offset below but the term's is a constant
        const T* xj = xs + j0 * kXStride + HY * XP + V + ty * XP + tx;
        const T* cj = cs + ty * W + tx;
        for (int t = 0; t < nterms; ++t) {
          const T* xt = xj + s_off[t];
          const T* ct = cj + t * (B * W);
#pragma unroll
          for (int q = 0; q < G::RPT; ++q) {
#pragma unroll
            for (int m = 0; m < G::CPT; ++m) {
              const T d = ct[q * G::TY * W + m * G::TX];
#pragma unroll
              for (int jj = 0; jj < kRhsTile; ++jj) {
                if (jj < nj) {
                  acc[q][m][jj] = fma_rn(d, xt[jj * kXStride + q * G::TY * XP + m * G::TX],
                                         acc[q][m][jj]);
                }
              }
            }
          }
        }
      }
      if (PROBE == 3) continue;
#pragma unroll
      for (int q = 0; q < G::RPT; ++q) {
        const int row = ty + q * G::TY;
#pragma unroll
        for (int m = 0; m < G::CPT; ++m) {
          const int col = tx + m * G::TX;
          if (row < b && col < w) {
            T* out = y + static_cast<size_t>(r0 + row) * row_stride + c0 + col;
#pragma unroll
            for (int jj = 0; jj < kRhsTile; ++jj) {
              if (jj < nj) out[static_cast<size_t>(j0 + jj) * rhs_stride] = acc[q][m][jj];
            }
          }
        }
      }
    }
  };

  for (int i = 0; i < S - 1; ++i) issue(i);
  for (int i = 0; i < nslab; ++i) {
    cp_async_wait<S - 2>();  // this thread's copies of slab i have landed
    __syncthreads();         // everyone's; and stage (i - 1) % S is free
    issue(i + S - 1);
    copy_halo(i);
    compute(i);
  }
  cp_async_wait<0>();
}

// Launch the slab kernel of tiling G.  The segments are sized so that the
// grid is `waves` waves of resident blocks.  Returns cudaErrorInvalidValue
// for what the kernel does not take (the wrapper's spmm_path says "general"
// for those).
template <class G, bool CYCLIC, int PROBE = 0>
int launch_slab(const typename G::Type* data, const int* terms, int nterms,
                const typename G::Type* x, typename G::Type* y, int nrhs, int ny, int nx,
                int hy, int hx, size_t rhs_stride, size_t row_stride, cudaStream_t s,
                int waves = 1) {
  const auto misaligned = (reinterpret_cast<uintptr_t>(data) | reinterpret_cast<uintptr_t>(x)
                           | reinterpret_cast<uintptr_t>(y)) % 16;
  if (nterms < 0 || nrhs < 1 || ny < 1 || nx < 1 || nx % G::V || misaligned
      || hy < 0 || hy > G::HY || hx < 0 || hx > G::V || waves < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = slab_smem_bytes<G>(nterms, nrhs);
  if (bytes > kSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = grid_dia_matmat_slab_kernel<G, CYCLIC, PROBE>;
  // per device: allow the dynamic shared memory once, read the SM count;
  // per launch size: the resident blocks an SM (cached for the last size)
  static int allowed_on = -1, sms = 0, last_device = -1, last_blocks = 0;
  static size_t last_bytes = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device != allowed_on) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemPerBlock);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed_on = device;
  }
  if (device != last_device || bytes != last_bytes) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&last_blocks, kernel, G::NT, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    last_device = device;
    last_bytes = bytes;
  }
  if (last_blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long strips = (nx + G::W - 1) / G::W;
  const long long slabs = (ny + G::B - 1) / G::B;
  long long segments = static_cast<long long>(last_blocks) * sms * waves / strips;
  segments = segments < 1 ? 1 : (segments > slabs ? slabs : segments);
  long long seg_slabs = (slabs + segments - 1) / segments;
  if ((slabs + seg_slabs - 1) / seg_slabs > static_cast<long long>(kMaxGridY)) {
    seg_slabs = (slabs + kMaxGridY - 1) / kMaxGridY;
  }
  segments = (slabs + seg_slabs - 1) / seg_slabs;
  grid_dia_matmat_slab_kernel<G, CYCLIC, PROBE>
      <<<dim3(static_cast<unsigned>(strips), static_cast<unsigned>(segments)), G::NT, bytes,
          s>>>(data, terms, nterms, x, y, nrhs, ny, nx, hy, rhs_stride, row_stride,
               static_cast<int>(seg_slabs));
  return static_cast<int>(cudaGetLastError());
}

// The strides of the two layouts: (nrhs, ny, nx) or (ny, nrhs, nx).
void layout_strides(int interleaved, int nrhs, int ny, int nx, size_t* rs, size_t* ws) {
  *rs = interleaved ? static_cast<size_t>(nx) : static_cast<size_t>(ny) * nx;
  *ws = interleaved ? static_cast<size_t>(nrhs) * nx : static_cast<size_t>(nx);
}

// The tilings of grid_dia_matmat_slab_{f32,f64}: 256-byte strip rows (64
// f32 / 32 f64 columns), slabs of 8 rows, 2 stages (54 KB each for 13
// terms x 8 right-hand sides: two blocks an SM), 256 threads, halo rows
// from the previous stage; 2 staged halo rows, or 8 where the reach needs
// them.  Mirrored in ops/spmv.py (_SLAB_TILING) for spmm_path's
// shared-memory check.
template <class T, int HY>
using SlabOf = SlabTiling<T, 64 * 4 / static_cast<int>(sizeof(T)), 8, 2,
                          64 * 4 / static_cast<int>(sizeof(T)), 256, HY>;

template <class T>
int launch_slab_layout(const T* data, const int* terms, int nterms, const T* x, T* y,
                       int nrhs, int ny, int nx, int cyclic, int interleaved, int hy, int hx,
                       void* stream) {
  size_t rs, ws;
  layout_strides(interleaved, nrhs, ny, nx, &rs, &ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hy <= 2) {
    using G = SlabOf<T, 2>;
    return cyclic ? launch_slab<G, true>(data, terms, nterms, x, y, nrhs, ny, nx, hy, hx, rs, ws, s)
                  : launch_slab<G, false>(data, terms, nterms, x, y, nrhs, ny, nx, hy, hx, rs,
                                          ws, s);
  }
  using G = SlabOf<T, 8>;
  return cyclic ? launch_slab<G, true>(data, terms, nterms, x, y, nrhs, ny, nx, hy, hx, rs, ws, s)
                : launch_slab<G, false>(data, terms, nterms, x, y, nrhs, ny, nx, hy, hx, rs, ws,
                                        s);
}

template <class K>
int slab_resources(K kernel, int threads, size_t bytes, int* r) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  r[0] = a.numRegs;
  r[1] = static_cast<int>(a.sharedSizeBytes + bytes);
  r[2] = static_cast<int>(a.localSizeBytes);
  r[4] = threads;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemPerBlock);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &r[3], kernel, threads, bytes));
}

}  // namespace

// data: (nfields, ny, nx) resp. (ndiags, n) row-major; terms: nterms rows of
// (k, dy, dx) resp. (k, off), int32, on the device; x and y contiguous,
// distinct, of the layout named above.  Cyclic shifts lie in [0, ny) x
// [0, nx).  `vec` takes the tiled kernels' vector path (nx a multiple of a
// 16-byte vector, data, x and y 16-byte aligned: cudaErrorInvalidValue
// otherwise) or, 0, the scalar one.  Each launches on `stream`, does not synchronise, and returns the cudaError_t
// of the launch (0 on success).
#define DIA_SPMV_EXPORTS(T, tag)                                                        \
  extern "C" int grid_dia_matvec_##tag(const T* data, const int* terms, int nterms,     \
                                       const T* x, T* y, int ny, int nx, int cyclic,    \
                                       int vec, void* stream) {                         \
    return launch_grid_matvec(data, terms, nterms, cyclic, vec, x, y, ny, nx, stream);  \
  }                                                                                     \
  extern "C" int dia_flat_matvec_##tag(const T* data, const int* terms, int nterms,     \
                                       const T* x, T* y, long long n, void* stream) {   \
    return launch_flat_matvec(data, terms, nterms, x, y, n, stream);                    \
  }                                                                                     \
  extern "C" int grid_dia_matmat_##tag(const T* data, const int* terms, int nterms,     \
                                       const T* x, T* y, int nrhs, int ny, int nx,      \
                                       int cyclic, int vec, void* stream) {             \
    return launch_grid_matmat(data, terms, nterms, cyclic, vec, 0, x, y, nrhs, ny, nx,  \
                              stream);                                                  \
  }                                                                                     \
  extern "C" int grid_dia_matmat_interleaved_##tag(                                     \
      const T* data, const int* terms, int nterms, const T* x, T* y, int nrhs, int ny,  \
      int nx, int cyclic, int vec, void* stream) {                                      \
    return launch_grid_matmat(data, terms, nterms, cyclic, vec, 1, x, y, nrhs, ny, nx,  \
                              stream);                                                  \
  }

DIA_SPMV_EXPORTS(float, f32)
DIA_SPMV_EXPORTS(double, f64)

// The row-slab SpMM in either layout (interleaved 0: (nrhs, ny, nx), 1:
// (ny, nrhs, nx)).  terms: nterms rows of signed (k, dy, dx), |dy| <= hy <=
// 8, |dx| <= hx <= 16 bytes of elements; nx a multiple of a 16-byte vector,
// data, x and y 16-byte aligned.  Returns cudaErrorInvalidValue for
// anything else; launches on `stream`, does not synchronise.
extern "C" int grid_dia_matmat_slab_f32(const float* data, const int* terms, int nterms,
                                        const float* x, float* y, int nrhs, int ny, int nx,
                                        int cyclic, int interleaved, int hy, int hx,
                                        void* stream) {
  return launch_slab_layout(data, terms, nterms, x, y, nrhs, ny, nx, cyclic, interleaved, hy,
                            hx, stream);
}

extern "C" int grid_dia_matmat_slab_f64(const double* data, const int* terms, int nterms,
                                        const double* x, double* y, int nrhs, int ny, int nx,
                                        int cyclic, int interleaved, int hy, int hx,
                                        void* stream) {
  return launch_slab_layout(data, terms, nterms, x, y, nrhs, ny, nx, cyclic, interleaved, hy,
                            hx, stream);
}

// What the compiler and the card give the cyclic slab kernel (2 halo rows)
// of dtype (0 f32, 1 f64) at a launch of nterms terms and nrhs right-hand
// sides: r[0] registers a thread, r[1] shared-memory bytes a block, r[2]
// local (spill) bytes a thread, r[3] resident blocks an SM, r[4] threads a
// block.
extern "C" int grid_dia_matmat_resources(int dtype, int nterms, int nrhs, int* r) {
  if (dtype == 0) {
    using G = SlabOf<float, 2>;
    return slab_resources(grid_dia_matmat_slab_kernel<G, true, 0>, G::NT,
                          slab_smem_bytes<G>(nterms, nrhs), r);
  }
  using G = SlabOf<double, 2>;
  return slab_resources(grid_dia_matmat_slab_kernel<G, true, 0>, G::NT,
                        slab_smem_bytes<G>(nterms, nrhs), r);
}

namespace {

// the chosen tilings of the clamped tiled SpMV
using MvF32 = MvOf<float, true>;
using MvF32S = MvOf<float, false>;
using MvF64 = MvOf<double, false>;
using MvF64V = MvOf<double, true>;

// what the compiler and the card give one tiled kernel (as slab_resources)
// launched with `dyn` bytes of dynamic shared memory
template <class K>
int tile_resources(K kernel, int* r, size_t dyn = 0) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  r[0] = a.numRegs;
  r[1] = static_cast<int>(a.sharedSizeBytes + dyn);
  r[2] = static_cast<int>(a.localSizeBytes);
  r[4] = kTileThreads;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r[3], kernel, kTileThreads, dyn));
}

}  // namespace

// What the compiler and the card give the clamped tiled SpMV of dtype (0
// f32, 1 f64) on the vector (vec 1) or scalar path: r[0] registers a
// thread, r[1] shared-memory bytes a block, r[2] local (spill) bytes a
// thread, r[3] resident blocks an SM, r[4] threads a block.
extern "C" int grid_dia_matvec_resources(int dtype, int vec, int* r) {
  if (dtype == 0) {
    return vec ? tile_resources(grid_dia_matvec_tiled_kernel<MvF32, false, kMvKernel>, r)
               : tile_resources(grid_dia_matvec_tiled_kernel<MvF32S, false, kMvKernel>, r);
  }
  return vec ? tile_resources(grid_dia_matvec_tiled_kernel<MvF64V, false, kMvKernel>, r)
             : tile_resources(grid_dia_matvec_tiled_kernel<MvF64, false, kMvKernel>, r);
}

// The same for the clamped tiled SpMM (the general path).
extern "C" int grid_dia_matmat_general_resources(int dtype, int vec, int* r) {
  auto of = [r](auto g) {
    using G = decltype(g);
    return tile_resources(grid_dia_matmat_tiled_kernel<G, false, kMvKernel>, r,
                          G::kWindowBytes);
  };
  if (dtype == 0) return vec ? of(MmOf<float, true>{}) : of(MmOf<float, false>{});
  return vec ? of(MmOf<double, true>{}) : of(MmOf<double, false>{});
}
