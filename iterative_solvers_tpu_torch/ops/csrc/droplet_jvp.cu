// Droplet inner-Krylov JVP matvec, CUDA C++ for sm_90a.
//
// Replaces iterative_solvers_tpu/ops/pallas_droplet.py::jvp_matvec_pallas
// (the pallas_call at pallas_droplet.py:534).  It computes, in f32,
//
//     J v = v - dF2'[v]
//
// the linearised curvilinear Crank-Nicolson droplet residual, from v and the
// 8-field coefficient stack [1/J, Qxx, Qyy, Qxy, c0, c1, c2, c3] (dt/2 folded
// into c1..c3, see models/droplet.py::jvp_field_stack):
//
//   dp  = -(lap_c v) + c0 v          curvilinear Laplacian with the 3
//                                    one-sided flux rings and the zeroed
//                                    cross-term edges
//   dA  = dpx c1 + c2 v,             (dpx, dpy) = grad_xy(dp) with
//   dB  = dpy c1 + c3 v              dp/dn = 0 edges
//   out = v - (Qyy dA_k - Qxy dA_e - Qxy dB_k + Qxx dB_e) / J
//
// Edge formulas follow the reference discretisation exactly: one-sided
// 4th-order d1 rows/columns, the flux rings at indices 1, 2, n-3, n-2
// (taps up to index 5 from the edge), zero flux at 0 and n-1.  Any ny, nx
// >= 8 is taken.
//
// What bounds it on an H100: the function moves 10 fields x 4 B per point
// (9 inputs, 1 output), 12.5 us at 1024^2 over 3.35 TB/s; its ~185
// operations per point are far below the card's rate.
//
// Design (droplet_jvp_f32): ONE launch, one fused pass, every input read from
// device memory once per tile and every intermediate staged in shared
// memory.  The chain has depth 7: out needs dA, dB at +-2 along each axis,
// those need dp at +-2, dp needs v at +-3 along each axis (the conservative
// flux) and in the +-2 x +-2 box (the nested cross terms).  A block owns a
// TY x TX output tile and
//
//   in  starts asynchronous copies (cp.async, no registers in between) of v
//       on the tile grown by 7, of 1/J, Qxx, Qyy, Qxy on the tile grown by
//       6, of c0 on + 4 and of c1..c3 on + 2, in three groups, and waits for
//       each group only before the stage that reads it,
//   B   computes a11, a22 and the cross-term factors P = a12 v_eta,
//       Q = a12 v_ksi once per point, on the tile grown by 6 along the axis
//       the next stage differentiates and by 4 along the other,
//   C   computes dp on the tile grown by 4 (over c0),
//   D   computes dA, dB on the tile grown by 2 (over c2, c3),
//   E   computes out on the tile,
//
// with a block barrier between stages.  Thirteen planes of shared memory
// (106 KB at 16 x 64) leave room for two blocks an SM, so that one block's
// copies run under the other's arithmetic.  Measured on the way here: with
// the stack read through the read-only cache in every stage the kernel
// waited a device-memory round trip of about 1000 cycles in each iteration
// of each stage, whatever the tile, the occupancy or the instruction count;
// with the copies up front it is the stages' arithmetic that takes the
// time, and 256 threads with up to 128 registers beat 512 with 64.
//
// On a grid whose rows are whole 16-byte vectors a thread computes 4
// neighbouring points of a row from 16-byte loads (jvp_tile_vec).  In a tile
// one of whose regions touches the domain's edge only the groups whose taps
// are all interior ones go that way; the one-sided rows and columns and the
// zeroed edges are computed a thread a point by the reference formulas
// (Point), packed into a few warps.  Every other grid runs a thread a point
// throughout (jvp_tile).  All evaluate the same expressions, so neighbouring
// tiles agree bit for bit.  Every region is clamped to the domain and every
// staged array is indexed by GLOBAL index, so a halo point is computed by
// exactly the formula its owner tile uses (one-sided rows, zeroed edges).  A
// one-sided formula reads up to 5 (d1) or 6 (flux) points from the edge,
// more than the interior reach: a region that touches an edge is grown to
// hold them (grow()).  The redundant work is the halo ring: dp on
// (TY+8)(TX+8)/(TY TX) of the points.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

struct Consts {
  int ny, nx;
  float sdx, sdy;          // 1 / (12 h)
  float inv_dx2, inv_dy2;  // 1 / h^2 (flux rings)
  float fdx, fdy;          // 1 / (288 h^2) (flux interior)
  bool vectors;            // rows are whole, aligned 16-byte vectors
};

Consts make_consts(int ny, int nx, double dx, double dy) {
  Consts k;
  k.ny = ny;
  k.nx = nx;
  k.sdx = static_cast<float>(1.0 / (12.0 * dx));
  k.sdy = static_cast<float>(1.0 / (12.0 * dy));
  const double ix2 = 1.0 / (dx * dx), iy2 = 1.0 / (dy * dy);
  k.inv_dx2 = static_cast<float>(ix2);
  k.inv_dy2 = static_cast<float>(iy2);
  k.fdx = static_cast<float>(ix2 / 288.0);
  k.fdy = static_cast<float>(iy2 / 288.0);
  k.vectors = false;
  return k;
}

// 4th-order first derivative at index i of an axis of length n; f(k) reads
// the field at index k along that axis.  With EDGES = false the caller
// vouches that i is interior (2 <= i <= n - 3) and no test is compiled.
template <bool EDGES = true, class F>
__device__ __forceinline__ float d1(F f, int i, int n, float s) {
  if (!EDGES || (i >= 2 && i <= n - 3))
    return (f(i - 2) - 8.f * f(i - 1) + 8.f * f(i + 1) - f(i + 2)) * s;
  if (i == 0)
    return (-25.f * f(0) + 48.f * f(1) - 36.f * f(2) + 16.f * f(3) - 3.f * f(4)) * s;
  if (i == 1)
    return (-3.f * f(0) - 10.f * f(1) + 18.f * f(2) - 6.f * f(3) + f(4)) * s;
  if (i == n - 2)
    return (-f(n - 5) + 6.f * f(n - 4) - 18.f * f(n - 3) + 10.f * f(n - 2)
            + 3.f * f(n - 1)) * s;
  return (3.f * f(n - 5) - 16.f * f(n - 4) + 36.f * f(n - 3) - 48.f * f(n - 2)
          + 25.f * f(n - 1)) * s;
}

// Conservative 4th-order (a v')' at index c of an axis of length n.  With
// EDGES = false the caller vouches that 3 <= c <= n - 4.
template <bool EDGES = true, class FA, class FV>
__device__ __forceinline__ float flux(FA a, FV v, int c, int n, float inv_h2,
                                      float f288) {
  if (EDGES) {
    if (c == 0 || c == n - 1) return 0.f;
    if (c == 1)
      return (a(1) * (10.f * v(0) - 15.f * v(1) - 4.f * v(2) + 14.f * v(3)
                      - 6.f * v(4) + v(5)) / 12.f
              + (-3.f * v(0) - 10.f * v(1) + 18.f * v(2) - 6.f * v(3) + v(4))
                * (-3.f * a(0) - 10.f * a(1) + 18.f * a(2) - 6.f * a(3) + a(4))
                / 144.f) * inv_h2;
    if (c == 2)
      return (a(2) * (-v(0) + 16.f * v(1) - 30.f * v(2) + 16.f * v(3) - v(4)) / 12.f
              + (v(0) - 8.f * v(1) + 8.f * v(3) - v(4))
                * (a(0) - 8.f * a(1) + 8.f * a(3) - a(4)) / 144.f) * inv_h2;
    const int m = n;
    if (c == m - 2)
      return (a(m - 2) * (10.f * v(m - 1) - 15.f * v(m - 2) - 4.f * v(m - 3)
                          + 14.f * v(m - 4) - 6.f * v(m - 5) + v(m - 6)) / 12.f
              + (3.f * v(m - 1) + 10.f * v(m - 2) - 18.f * v(m - 3)
                 + 6.f * v(m - 4) - v(m - 5))
                * (3.f * a(m - 1) + 10.f * a(m - 2) - 18.f * a(m - 3)
                   + 6.f * a(m - 4) - a(m - 5)) / 144.f) * inv_h2;
    if (c == m - 3)
      return (a(m - 3) * (-v(m - 1) + 16.f * v(m - 2) - 30.f * v(m - 3)
                          + 16.f * v(m - 4) - v(m - 5)) / 12.f
              + (v(m - 5) - 8.f * v(m - 4) + 8.f * v(m - 2) - v(m - 1))
                * (a(m - 5) - 8.f * a(m - 4) + 8.f * a(m - 2) - a(m - 1)) / 144.f)
             * inv_h2;
  }
  return (4.f * a(c - 1) * (v(c - 3) - 8.f * v(c - 2) + 8.f * v(c) - v(c + 1))
          - (-a(c - 2) + 9.f * a(c - 1) + 9.f * a(c) - a(c + 1))
            * (v(c - 2) - 27.f * v(c - 1) + 27.f * v(c) - v(c + 1))
          + (-a(c - 1) + 9.f * a(c) + 9.f * a(c + 1) - a(c + 2))
            * (v(c - 1) - 27.f * v(c) + 27.f * v(c + 1) - v(c + 2))
          - 4.f * a(c + 1) * (v(c - 1) - 8.f * v(c) + 8.f * v(c + 2) - v(c + 3)))
         * f288;
}

// ---- the fused single-pass kernel ---------------------------------------------

// [lo, hi) along one axis, global indices.
struct Range {
  int lo, hi;
  __device__ __forceinline__ bool has(int g) const { return g >= lo && g < hi; }
};

// The points a stage reads along an axis of length n to produce the points
// of r: r grown by the interior reach k and clamped to the domain; where it
// then touches an edge, at least the e points from that edge that the
// one-sided formulas read (d1: k = 2, e = 5; flux: k = 3, e = 6).
__device__ __forceinline__ Range grow(Range r, int n, int k, int e) {
  Range g{max(r.lo - k, 0), min(r.hi + k, n)};
  if (g.lo == 0) g.hi = max(g.hi, e);
  if (g.hi == n) g.lo = min(g.lo, n - e);
  return g;
}

// Shared memory of a TY x TX tile: thirteen planes of one row stride, the
// tile's columns grown by 8, so that a group of 4 columns that starts at a
// multiple of 4 is one 16-byte vector.  A plane holds the rows of its
// region only (the tile grown by 7, 6, 4 or 2), and its pointer is set back
// by the rows it leaves out, so that one offset, counted from the first row
// of v's region, addresses a point in all of them and every stencil tap is
// that offset plus a constant.  Nine planes receive the inputs (v and the
// stack's eight fields); a11, P = a12 v_eta, a22 and Q = a12 v_ksi have their
// own; dp is written over c0, dA over c2 and dB over c3, each by the thread
// that has just read that point's coefficient.
template <int TY, int TX>
struct Tile {
  static_assert(TX % 4 == 0, "column groups of 4");
  static constexpr int kS = TX + 16;  // row stride
  // rows: v; 1/J, Qxx, Qyy, Qxy, a22, Q; c0, a11, P; c1, c2, c3
  static constexpr int kRows = (TY + 14) + 6 * (TY + 12) + 3 * (TY + 8) + 3 * (TY + 4);
  static constexpr int kFloats = kRows * kS;
};

// The planes of a tile whose regions' first rows are lo7 (v), lo6, lo4, lo2.
struct Planes {
  float *v, *ij, *xx, *yy, *xy, *a22, *q, *c0, *a11, *p, *c1, *c2, *c3, *dp, *da, *db;
  template <int TY, int TX>
  __device__ __forceinline__ Planes(Tile<TY, TX>, float* s, int lo7, int lo6, int lo4,
                                    int lo2) {
    constexpr int S = Tile<TY, TX>::kS;
    constexpr int n6 = (TY + 12) * S, n4 = (TY + 8) * S, n2 = (TY + 4) * S;
    v = s;
    float* at6 = s + (TY + 14) * S - (lo6 - lo7) * S;
    ij = at6, xx = at6 + n6, yy = at6 + 2 * n6, xy = at6 + 3 * n6, a22 = at6 + 4 * n6,
    q = at6 + 5 * n6;
    float* at4 = s + (TY + 14) * S + 6 * n6 - (lo4 - lo7) * S;
    c0 = at4, a11 = at4 + n4, p = at4 + 2 * n4;
    float* at2 = s + (TY + 14) * S + 6 * n6 + 3 * n4 - (lo2 - lo7) * S;
    c1 = at2, c2 = at2 + n2, c3 = at2 + 2 * n2;
    dp = c0, da = c2, db = c3;
  }
  // the plane of the stack's field f, of v for f < 0
  __device__ __forceinline__ float* field(int f) const {
    switch (f) {
      case 0: return ij;
      case 1: return xx;
      case 2: return yy;
      case 3: return xy;
      case 4: return c0;
      case 5: return c1;
      case 6: return c2;
      case 7: return c3;
      default: return v;
    }
  }
};

// f(i, j, o) for every point of rows x cols, o the point's offset in a plane
// whose first point is (r0, c0).  The block's threads stride over rows of the
// constant width W >= cols.hi - cols.lo (a division by a constant).
template <int W, int S, class F>
__device__ __forceinline__ void for_box(Range rows, Range cols, int r0, int c0, F f) {
  const int w = cols.hi - cols.lo, total = (rows.hi - rows.lo) * W;
  const int first = (rows.lo - r0) * S + (cols.lo - c0);
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    const int a = k / W, b = k - a * W;
    if (b < w) f(rows.lo + a, cols.lo + b, first + a * S + b);
  }
}

// A probe's result: one sum a point of the tile, so that no copy is dead.
template <int W, int S>
__device__ __forceinline__ void store_probe(const Planes& s, float* __restrict__ out,
                                            int nx, Range r0, Range c0, int ro, int co) {
  for_box<W, S>(r0, c0, ro, co, [&](int i, int j, int o) {
    out[static_cast<size_t>(i) * nx + j] = s.v[o] + s.xy[o] + s.c0[o] + s.c3[o];
  });
}

// One point of each stage, by the reference formulas with taps read from the
// staged planes by global index; o is the point's offset in the planes.
// EDGES = false: the caller vouches that every formula is the interior one,
// and no test is compiled.
template <int S, bool EDGES>
struct Point {
  const Planes& s;
  const Consts& k;
  // a plane along the row / the column of the point at offset o
  static __device__ __forceinline__ auto along_x(const float* f, int o, int j) {
    return [=](int c) { return f[o + (c - j)]; };
  }
  static __device__ __forceinline__ auto along_y(const float* f, int o, int i) {
    return [=](int r) { return f[o + (r - i) * S]; };
  }
  // B: the metric coefficients and the cross-term factors: a11 and
  // P = a12 v_eta (rows), a22 and Q = a12 v_ksi (cols)
  __device__ __forceinline__ void B(int i, int j, int o, bool rows, bool cols) const {
    const float ij = s.ij[o], xx = s.xx[o], yy = s.yy[o], xy = s.xy[o];
    const float a12 = -(xy * (xx + yy)) * ij;
    if (rows) {
      s.a11[o] = (xy * xy + yy * yy) * ij;
      s.p[o] = a12 * d1<EDGES>(along_y(s.v, o, i), i, k.ny, k.sdy);
    }
    if (cols) {
      s.a22[o] = (xy * xy + xx * xx) * ij;
      s.q[o] = a12 * d1<EDGES>(along_x(s.v, o, j), j, k.nx, k.sdx);
    }
  }
  // C: dp = -(v_xx + v_yy) + c0 v
  __device__ __forceinline__ void C(int i, int j, int o) const {
    const int ny = k.ny, nx = k.nx;
    const float fx = flux<EDGES>(along_x(s.a11, o, j), along_x(s.v, o, j), j, nx,
                                 k.inv_dx2, k.fdx);
    float tx = 0.f;  // d1_x(a12 v_eta), zero on the left/right columns
    if (!EDGES || (j != 0 && j != nx - 1))
      tx = d1<EDGES>(along_x(s.p, o, j), j, nx, k.sdx);
    const float fy = flux<EDGES>(along_y(s.a22, o, i), along_y(s.v, o, i), i, ny,
                                 k.inv_dy2, k.fdy);
    float ty = 0.f;  // d1_y(a12 v_ksi), zero on the bottom/top rows
    if (!EDGES || (i != 0 && i != ny - 1))
      ty = d1<EDGES>(along_y(s.q, o, i), i, ny, k.sdy);
    const float ij = s.ij[o];
    const float v_xx = (fx + tx) * ij;
    const float v_yy = (fy + ty) * ij;
    s.dp[o] = -(v_xx + v_yy) + s.c0[o] * s.v[o];
  }
  // D: dA, dB from grad_xy(dp) (dp/dn = 0 edges)
  __device__ __forceinline__ void D(int i, int j, int o) const {
    const int ny = k.ny, nx = k.nx;
    float dpk = 0.f, dpe = 0.f;
    if (!EDGES || (j != 0 && j != nx - 1))
      dpk = d1<EDGES>(along_x(s.dp, o, j), j, nx, k.sdx);
    if (!EDGES || (i != 0 && i != ny - 1))
      dpe = d1<EDGES>(along_y(s.dp, o, i), i, ny, k.sdy);
    const float ij = s.ij[o], xx = s.xx[o], yy = s.yy[o], xy = s.xy[o];
    const float dpx = (yy * dpk - xy * dpe) * ij;
    const float dpy = (-xy * dpk + xx * dpe) * ij;
    const float c1 = s.c1[o], vv = s.v[o];
    s.da[o] = dpx * c1 + s.c2[o] * vv;
    s.db[o] = dpy * c1 + s.c3[o] * vv;
  }
  // E: out = v - dF2
  __device__ __forceinline__ float E(int i, int j, int o) const {
    const int ny = k.ny, nx = k.nx;
    const float dak = d1<EDGES>(along_x(s.da, o, j), j, nx, k.sdx);
    const float dae = d1<EDGES>(along_y(s.da, o, i), i, ny, k.sdy);
    const float dbk = d1<EDGES>(along_x(s.db, o, j), j, nx, k.sdx);
    const float dbe = d1<EDGES>(along_y(s.db, o, i), i, ny, k.sdy);
    const float xx = s.xx[o], yy = s.yy[o], xy = s.xy[o];
    const float dF2 = (yy * dak - xy * dae - xy * dbk + xx * dbe) * s.ij[o];
    return s.v[o] - dF2;
  }
};

// The stages of one tile, a thread a point: any tile of any grid, taken
// where the grid's rows are not whole 16-byte vectors.  PROBE, for the tuning
// script (the card's profilers are out of reach): 1 runs the stages without
// the copies, on whatever shared memory holds; 2 the copies without the
// stages.
template <int TY, int TX, bool EDGES, int PROBE>
__device__ __forceinline__ void jvp_tile(
    const float* __restrict__ vp, const float* __restrict__ st, float* __restrict__ out,
    const Consts& k, float* smem, int co, Range r0, Range c0, Range r2, Range c2,
    Range r4, Range c4, Range r6, Range c6, Range r7, Range c7) {
  using T = Tile<TY, TX>;
  constexpr int S = T::kS;
  const int nx = k.nx;
  const size_t P = static_cast<size_t>(k.ny) * nx;
  const Planes s(T{}, smem, r7.lo, r6.lo, r4.lo, r2.lo);
  const Point<S, EDGES> point{s, k};
  const int ro = r7.lo;  // offsets count from (ro, co)
  auto at = [nx](int i, int j) { return static_cast<size_t>(i) * nx + j; };

  // The inputs, each read from device memory once, by asynchronous copies in
  // three groups: v and the metric for B, c0 for C, c1..c3 for D.
  auto copy_in = [&](int first, int last, const float* src, Range rows, Range cols) {
    for_box<TX + 14, S>(rows, cols, ro, co, [&](int i, int j, int o) {
      for (int f = first; f <= last; ++f)
        __pipeline_memcpy_async(s.field(f) + o, src + max(f, 0) * P + at(i, j), 4);
    });
  };
  if (PROBE != 1) {
    copy_in(-1, -1, vp, r7, c7);
    copy_in(0, 3, st, r6, c6);
    __pipeline_commit();
    copy_in(4, 4, st, r4, c4);
    __pipeline_commit();
    copy_in(5, 7, st, r2, c2);
    __pipeline_commit();
  }
  if (PROBE == 2) {
    __pipeline_wait_prior(0);
    __syncthreads();
    return store_probe<TX, S>(s, out, nx, r0, c0, ro, co);
  }
  __pipeline_wait_prior(2);
  __syncthreads();

  // B on dp's rows (a11, P) and dp's columns (a22, Q)
  for_box<TX + 12, S>(r6, c6, ro, co, [&](int i, int j, int o) {
    const bool rows = r4.has(i), cols = c4.has(j);
    if (rows || cols) point.B(i, j, o, rows, cols);
  });
  __pipeline_wait_prior(1);
  __syncthreads();
  // C on the tile + 4, D on the tile + 2, E on the tile
  for_box<TX + 8, S>(r4, c4, ro, co, [&](int i, int j, int o) { point.C(i, j, o); });
  __pipeline_wait_prior(0);
  __syncthreads();
  for_box<TX + 4, S>(r2, c2, ro, co, [&](int i, int j, int o) { point.D(i, j, o); });
  __syncthreads();
  for_box<TX, S>(r0, c0, ro, co,
                 [&](int i, int j, int o) { out[at(i, j)] = point.E(i, j, o); });
}

// ---- the same stages, a thread a group of 4 columns ------------------------------

struct V4 {
  float v[4];
};
__device__ __forceinline__ V4 load4(const float* p) {  // p 16-byte aligned
  const float4 t = *reinterpret_cast<const float4*>(p);
  return {{t.x, t.y, t.z, t.w}};
}
__device__ __forceinline__ void store4(float* p, const V4& a) {
  *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
}

// A plane's columns jg - 4 .. jg + 7 of one row: every x-tap of the group's
// 4 points (the point m of the group is w.v[4 + m]).
struct Window {
  float v[12];
};
__device__ __forceinline__ Window window(const float* plane, int o) {
  const V4 a = load4(plane + o - 4), b = load4(plane + o), c = load4(plane + o + 4);
  return {{a.v[0], a.v[1], a.v[2], a.v[3], b.v[0], b.v[1], b.v[2], b.v[3],
           c.v[0], c.v[1], c.v[2], c.v[3]}};
}

// The rows i - 2, i - 1, i + 1, i + 2 of a group: its y-taps of a d1.
struct Rows4 {
  V4 up2, up1, dn1, dn2;
  __device__ __forceinline__ float d1(int m, float s) const {
    return (up2.v[m] - 8.f * up1.v[m] + 8.f * dn1.v[m] - dn2.v[m]) * s;
  }
};
template <int S>
__device__ __forceinline__ Rows4 rows4(const float* plane, int o) {
  return {load4(plane + o - 2 * S), load4(plane + o - S), load4(plane + o + S),
          load4(plane + o + 2 * S)};
}

// f(i, jg, o) for every group of 4 columns jg = jg0, jg0 + 4, .. (G groups a
// row) of every row of rows; o is the group's offset in a plane whose first
// point is (r0, c0).  CLIP leaves out the groups outside a grid nx wide.
template <int G, int S, bool CLIP, class F>
__device__ __forceinline__ void for_groups(Range rows, int jg0, int nx, int r0, int c0,
                                           F f) {
  const int total = (rows.hi - rows.lo) * G;
  const int first = (rows.lo - r0) * S + (jg0 - c0);
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    const int a = k / G, b = k - a * G, jg = jg0 + 4 * b;
    if (!CLIP || (jg >= 0 && jg < nx)) f(rows.lo + a, jg, first + a * S + 4 * b);
  }
}

// f(i, j, o) for the points of rows x cols that lie in the grid's first or
// last group of 4 columns (if x_edges) or within y_reach rows of its top or
// bottom edge, each once, packed into as few threads' turns as they are
// points; o as in for_box.
template <int S, class F>
__device__ __forceinline__ void for_edge_strips(Range rows, Range cols, int ny, int nx,
                                                int y_reach, bool x_edges, int r0, int c0,
                                                F f) {
  // columns: [cols.lo, xl) and [xr, cols.hi) are the edge groups' share
  const int xl = x_edges ? min(max(cols.lo, 4), cols.hi) : cols.lo;
  const int xr = x_edges ? max(min(cols.hi, nx - 4), xl) : cols.hi;
  const int wl = xl - cols.lo, wx = wl + (cols.hi - xr), wm = xr - xl;
  // rows: [rows.lo, yt) and [yb, rows.hi) are within y_reach of an edge
  const int yt = min(max(rows.lo, y_reach), rows.hi);
  const int yb = max(min(rows.hi, ny - y_reach), yt);
  const int nt = yt - rows.lo, ny_edge = nt + (rows.hi - yb);
  const int n_x = (rows.hi - rows.lo) * wx, total = n_x + ny_edge * wm;
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    int i, j;
    if (k < n_x) {
      const int a = k / wx, b = k - a * wx;
      i = rows.lo + a;
      j = b < wl ? cols.lo + b : xr + (b - wl);
    } else {
      const int a = (k - n_x) / wm, b = (k - n_x) - a * wm;
      i = a < nt ? rows.lo + a : yb + (a - nt);
      j = xl + b;
    }
    f(i, j, (i - r0) * S + (j - c0));
  }
}

// The stages of one tile of a grid whose rows are whole 16-byte vectors:
// 16-byte copies, and a thread computes 4 neighbouring points of a row from
// 16-byte loads, with each point's arithmetic exactly that of Point<S, false>.
// The column ranges grow to multiples of 4 (the tile + 8 for v, the metric,
// a11, P; + 4 for the rest); the two outermost dA, dB columns each side are
// computed from columns of dp that no stage wrote, and are read by no stage.
// EDGES = true (a tile one of whose regions touches the domain's edge): a
// group takes that path only where all its taps are interior ones, and every
// other point of the stage's region is then computed by Point<S, true>, a
// thread a point: the one-sided rows and columns and the zeroed edges.
template <int TY, int TX, bool EDGES, int PROBE>
__device__ __forceinline__ void jvp_tile_vec(
    const float* __restrict__ vp, const float* __restrict__ st, float* __restrict__ out,
    const Consts& k, float* smem, int co, Range r0, Range c0, Range r2, Range c2,
    Range r4, Range c4, Range r6, Range c6, Range r7) {
  using T = Tile<TY, TX>;
  constexpr int S = T::kS;
  constexpr int kWide = (TX + 16) / 4, kMid = (TX + 8) / 4;  // groups a row
  const int ny = k.ny, nx = k.nx, j0 = co + 8;
  const size_t P = static_cast<size_t>(ny) * nx;
  const Planes s(T{}, smem, r7.lo, r6.lo, r4.lo, r2.lo);
  const Point<S, true> edge_point{s, k};
  const int ro = r7.lo;
  auto at = [nx](int i, int j) { return static_cast<size_t>(i) * nx + j; };
  // the x-taps of the point m of a window, relative to the point
  auto in_x = [](const Window& w, int m) {
    return [&w, m](int c) { return w.v[4 + m + c]; };
  };
  // whether every tap of a group's points is an interior one: along x for the
  // group at jg (d1 and flux alike: jg is a multiple of 4), along y for a d1
  // and for a flux at row i
  auto x_in = [nx](int jg) { return !EDGES || (jg >= 4 && jg <= nx - 8); };
  auto y_in = [ny](int i, int reach) { return !EDGES || (i >= reach && i < ny - reach); };

  if (PROBE != 1) {
    for_groups<kWide, S, EDGES>(r7, j0 - 8, nx, ro, co, [&](int i, int jg, int o) {
      __pipeline_memcpy_async(s.v + o, vp + at(i, jg), 16);
    });
    for_groups<kWide, S, EDGES>(r6, j0 - 8, nx, ro, co, [&](int i, int jg, int o) {
      const float* src = st + at(i, jg);
#pragma unroll
      for (int f = 0; f < 4; ++f) __pipeline_memcpy_async(s.field(f) + o, src + f * P, 16);
    });
    __pipeline_commit();
    for_groups<kMid, S, EDGES>(r4, j0 - 4, nx, ro, co, [&](int i, int jg, int o) {
      __pipeline_memcpy_async(s.c0 + o, st + 4 * P + at(i, jg), 16);
    });
    __pipeline_commit();
    for_groups<kMid, S, EDGES>(r2, j0 - 4, nx, ro, co, [&](int i, int jg, int o) {
      const float* src = st + at(i, jg);
#pragma unroll
      for (int f = 5; f < 8; ++f) __pipeline_memcpy_async(s.field(f) + o, src + f * P, 16);
    });
    __pipeline_commit();
  }
  if (PROBE == 2) {
    __pipeline_wait_prior(0);
    __syncthreads();
    return store_probe<TX, S>(s, out, nx, r0, c0, ro, co);
  }
  __pipeline_wait_prior(2);
  __syncthreads();

  // B: a11 and P on dp's rows (columns + 8), a22 and Q on dp's columns (rows + 6)
  for_groups<kWide, S, EDGES>(r6, j0 - 8, nx, ro, co, [&](int i, int jg, int o) {
    const bool rows = r4.has(i) && y_in(i, 2);
    const bool cols = jg >= j0 - 4 && jg < j0 + TX + 4 && x_in(jg);
    if (!rows && !cols) return;
    const V4 ij = load4(s.ij + o), xx = load4(s.xx + o), yy = load4(s.yy + o),
             xy = load4(s.xy + o);
    V4 a12;
#pragma unroll
    for (int m = 0; m < 4; ++m) a12.v[m] = -(xy.v[m] * (xx.v[m] + yy.v[m])) * ij.v[m];
    if (rows) {
      const Rows4 v = rows4<S>(s.v, o);
      V4 a11, p;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        a11.v[m] = (xy.v[m] * xy.v[m] + yy.v[m] * yy.v[m]) * ij.v[m];
        p.v[m] = a12.v[m] * v.d1(m, k.sdy);
      }
      store4(s.a11 + o, a11);
      store4(s.p + o, p);
    }
    if (cols) {
      const Window w = window(s.v, o);
      V4 a22, q;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        a22.v[m] = (xy.v[m] * xy.v[m] + xx.v[m] * xx.v[m]) * ij.v[m];
        q.v[m] = a12.v[m] * d1<false>(in_x(w, m), 0, nx, k.sdx);
      }
      store4(s.a22 + o, a22);
      store4(s.q + o, q);
    }
  });
  if (EDGES) {
    for_edge_strips<S>(r4, c6, ny, nx, 2, false, ro, co,
                       [&](int i, int j, int o) { edge_point.B(i, j, o, true, false); });
    for_edge_strips<S>(r6, c4, ny, nx, 0, true, ro, co,
                       [&](int i, int j, int o) { edge_point.B(i, j, o, false, true); });
  }
  __pipeline_wait_prior(1);
  __syncthreads();

  // C: dp on rows + 4, columns + 4
  for_groups<kMid, S, EDGES>(r4, j0 - 4, nx, ro, co, [&](int i, int jg, int o) {
    if (!(x_in(jg) && y_in(i, 3))) return;
    V4 fxt;  // the x half: flux_x + d1_x(a12 v_eta)
    {
      const Window wa = window(s.a11, o), wv = window(s.v, o), wp = window(s.p, o);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        fxt.v[m] = flux<false>(in_x(wa, m), in_x(wv, m), 0, nx, k.inv_dx2, k.fdx)
                   + d1<false>(in_x(wp, m), 0, nx, k.sdx);
    }
    V4 a22[5], vy[7];
#pragma unroll
    for (int r = -2; r <= 2; ++r) a22[r + 2] = load4(s.a22 + o + r * S);
#pragma unroll
    for (int r = -3; r <= 3; ++r) vy[r + 3] = load4(s.v + o + r * S);
    const Rows4 q = rows4<S>(s.q, o);
    const V4 ij = load4(s.ij + o), c0v = load4(s.c0 + o);
    V4 dp;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float fy = flux<false>([&](int r) { return a22[r + 2].v[m]; },
                                   [&](int r) { return vy[r + 3].v[m]; }, 0, ny,
                                   k.inv_dy2, k.fdy);
      const float v_xx = fxt.v[m] * ij.v[m];
      const float v_yy = (fy + q.d1(m, k.sdy)) * ij.v[m];
      dp.v[m] = -(v_xx + v_yy) + c0v.v[m] * vy[3].v[m];
    }
    store4(s.dp + o, dp);
  });
  if (EDGES)
    for_edge_strips<S>(r4, c4, ny, nx, 3, true, ro, co,
                       [&](int i, int j, int o) { edge_point.C(i, j, o); });
  __pipeline_wait_prior(0);
  __syncthreads();

  // D: dA, dB on rows + 2, columns + 4
  for_groups<kMid, S, EDGES>(r2, j0 - 4, nx, ro, co, [&](int i, int jg, int o) {
    if (!(x_in(jg) && y_in(i, 2))) return;
    const Window w = window(s.dp, o);
    const Rows4 dp = rows4<S>(s.dp, o);
    const V4 ij = load4(s.ij + o), xx = load4(s.xx + o), yy = load4(s.yy + o),
             xy = load4(s.xy + o), c1 = load4(s.c1 + o), c2v = load4(s.c2 + o),
             c3 = load4(s.c3 + o), vv = load4(s.v + o);
    V4 da, db;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float dpk = d1<false>(in_x(w, m), 0, nx, k.sdx);
      const float dpe = dp.d1(m, k.sdy);
      const float dpx = (yy.v[m] * dpk - xy.v[m] * dpe) * ij.v[m];
      const float dpy = (-xy.v[m] * dpk + xx.v[m] * dpe) * ij.v[m];
      da.v[m] = dpx * c1.v[m] + c2v.v[m] * vv.v[m];
      db.v[m] = dpy * c1.v[m] + c3.v[m] * vv.v[m];
    }
    store4(s.da + o, da);
    store4(s.db + o, db);
  });
  if (EDGES)
    for_edge_strips<S>(r2, c2, ny, nx, 2, true, ro, co,
                       [&](int i, int j, int o) { edge_point.D(i, j, o); });
  __syncthreads();

  // E: out on the tile
  for_groups<TX / 4, S, EDGES>(r0, j0, nx, ro, co, [&](int i, int jg, int o) {
    if (!(x_in(jg) && y_in(i, 2))) return;
    const Window wa = window(s.da, o), wb = window(s.db, o);
    const Rows4 da = rows4<S>(s.da, o), db = rows4<S>(s.db, o);
    const V4 ij = load4(s.ij + o), xx = load4(s.xx + o), yy = load4(s.yy + o),
             xy = load4(s.xy + o), vv = load4(s.v + o);
    V4 r;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float dak = d1<false>(in_x(wa, m), 0, nx, k.sdx);
      const float dae = da.d1(m, k.sdy);
      const float dbk = d1<false>(in_x(wb, m), 0, nx, k.sdx);
      const float dbe = db.d1(m, k.sdy);
      const float dF2 =
          (yy.v[m] * dak - xy.v[m] * dae - xy.v[m] * dbk + xx.v[m] * dbe) * ij.v[m];
      r.v[m] = vv.v[m] - dF2;
    }
    store4(out + at(i, jg), r);
  });
  if (EDGES)
    for_edge_strips<S>(r0, c0, ny, nx, 2, true, ro, co,
                       [&](int i, int j, int o) { out[at(i, j)] = edge_point.E(i, j, o); });
}

template <int TY, int TX, int NT, int MINB, int PROBE = 0>
__global__ void __launch_bounds__(NT, MINB)
jvp_fused(const float* __restrict__ vp, const float* __restrict__ st,
          float* __restrict__ out, Consts k) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* const smem = reinterpret_cast<float*>(smem4);
  const int ny = k.ny, nx = k.nx;
  const int i0 = blockIdx.y * TY, j0 = blockIdx.x * TX;
  const Range r0{i0, min(i0 + TY, ny)}, c0{j0, min(j0 + TX, nx)};
  const Range r2 = grow(r0, ny, 2, 5), c2 = grow(c0, nx, 2, 5);
  const Range r4 = grow(r2, ny, 2, 5), c4 = grow(c2, nx, 2, 5);
  const Range r6 = grow(r4, ny, 2, 5), c6 = grow(c4, nx, 2, 5);
  const Range r7 = grow(r4, ny, 3, 6), c7 = grow(c4, nx, 3, 6);
  const int co = j0 - 8;  // the planes' first column: a multiple of 4, <= c7.lo
  // v's region off every edge puts dp's points at least 4 and the cross-term
  // factors' at least 2 from it: every formula is the interior one
  const bool interior = r7.lo > 0 && r7.hi < ny && c7.lo > 0 && c7.hi < nx;
  if (k.vectors) {
    if (interior)
      jvp_tile_vec<TY, TX, false, PROBE>(vp, st, out, k, smem, co, r0, c0, r2, c2, r4, c4,
                                         r6, c6, r7);
    else
      jvp_tile_vec<TY, TX, true, PROBE>(vp, st, out, k, smem, co, r0, c0, r2, c2, r4, c4,
                                        r6, c6, r7);
  } else if (interior) {
    jvp_tile<TY, TX, false, PROBE>(vp, st, out, k, smem, co, r0, c0, r2, c2, r4, c4, r6,
                                   c6, r7, c7);
  } else {
    jvp_tile<TY, TX, true, PROBE>(vp, st, out, k, smem, co, r0, c0, r2, c2, r4, c4, r6,
                                  c6, r7, c7);
  }
}

// Launch the fused kernel with a TY x TX tile, NT threads a block and
// registers capped for MINB blocks an SM.  Above 48 KB the shared memory is
// dynamic and has to be allowed once per device.  Rows of whole, aligned
// 16-byte vectors take the 4-column path.
template <int TY, int TX, int NT, int MINB, int PROBE = 0>
int launch_fused(const float* v, const float* stack, float* out, Consts k,
                 cudaStream_t s) {
  constexpr size_t bytes = sizeof(float) * Tile<TY, TX>::kFloats;
  static int allowed_on = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device != allowed_on) {
    err = cudaFuncSetAttribute(jvp_fused<TY, TX, NT, MINB, PROBE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed_on = device;
  }
  k.vectors = k.nx % 4 == 0
              && (reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(stack)
                  | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const dim3 grid((k.nx + TX - 1) / TX, (k.ny + TY - 1) / TY);
  jvp_fused<TY, TX, NT, MINB, PROBE><<<grid, NT, bytes, s>>>(v, stack, out, k);
  return static_cast<int>(cudaGetLastError());
}

// The tile and block of droplet_jvp_f32.
constexpr int kTY = 16, kTX = 64, kNT = 256, kMinBlocks = 2;

template <class K>
int kernel_resources(K kernel, int threads, size_t dynamic_bytes, int* r) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  r[0] = a.numRegs;
  r[1] = static_cast<int>(a.sharedSizeBytes + dynamic_bytes);
  r[2] = static_cast<int>(a.localSizeBytes);
  r[4] = threads;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dynamic_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &r[3], kernel, threads, dynamic_bytes));
}

}  // namespace

// v, out: (ny, nx) f32; stack: (8, ny, nx) f32.  All contiguous, on the
// current device, out distinct from the inputs.  One launch on `stream`;
// returns its cudaError_t (0 on success); does not synchronise.
extern "C" int droplet_jvp_f32(const float* v, const float* stack, float* out,
                               int ny, int nx, double dx, double dy,
                               void* stream) {
  if (ny < 8 || nx < 8) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fused<kTY, kTX, kNT, kMinBlocks>(v, stack, out, make_consts(ny, nx, dx, dy),
                                     static_cast<cudaStream_t>(stream));
}

// What the compiler and the card give the kernel of droplet_jvp_f32:
// r[0] registers a thread, r[1] shared-memory bytes a block, r[2] local
// (spill) bytes a thread, r[3] resident blocks an SM, r[4] threads a block.
extern "C" int droplet_jvp_resources(int* r) {
  return kernel_resources(jvp_fused<kTY, kTX, kNT, kMinBlocks>, kNT,
                          sizeof(float) * Tile<kTY, kTX>::kFloats, r);
}

// The same kernel at other tiles and block sizes (variants 0-2) and its two
// probes (3: the stages alone, 4: the copies alone), for the tuning script
// (tools/tune_port_kernels.py); nothing of the package calls it.
extern "C" int droplet_jvp_tile_f32(const float* v, const float* stack, float* out,
                                    int ny, int nx, double dx, double dy,
                                    void* stream, int variant) {
  if (ny < 8 || nx < 8) return static_cast<int>(cudaErrorInvalidValue);
  const Consts k = make_consts(ny, nx, dx, dy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch_fused<16, 64, 256, 2>(v, stack, out, k, s);
    case 1: return launch_fused<16, 64, 512, 2>(v, stack, out, k, s);
    case 2: return launch_fused<32, 32, 512, 2>(v, stack, out, k, s);
    case 3: return launch_fused<kTY, kTX, kNT, kMinBlocks, 1>(v, stack, out, k, s);
    case 4: return launch_fused<kTY, kTX, kNT, kMinBlocks, 2>(v, stack, out, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
