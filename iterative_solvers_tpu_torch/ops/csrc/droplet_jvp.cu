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
//   stage 1   dp = -(lap_c v) + c0 v          curvilinear Laplacian with the
//                                             3 one-sided flux rings and the
//                                             zeroed cross-term edges
//   stage 2   dA = dpx c1 + c2 v,             (dpx, dpy) = grad_xy(dp) with
//             dB = dpy c1 + c3 v              dp/dn = 0 edges
//   stage 3   out = v - (Qyy dA_k - Qxy dA_e - Qxy dB_k + Qxx dB_e) / J
//
// Edge formulas follow the reference discretisation exactly: one-sided
// 4th-order d1 rows/columns, the flux rings at indices 1, 2, n-3, n-2
// (taps up to index 5 from the edge), zero flux at 0 and n-1.  Any ny, nx
// >= 8 is taken.
//
// Design: three launches, one thread per grid point, every operand read
// through the read-only cache (a stencil tap of a neighbour is an L1/L2
// hit, not an HBM read).  The nested cross terms of stage 1 evaluate the
// inner derivative at each of the outer stencil's taps.  What bounds it on
// an H100: a fused single pass moves 10 fields x 4 B per point (9 inputs, 1
// output) — 12.5 us at 1024^2 over 3.35 TB/s.  This design also writes and
// re-reads its intermediates dp, dA, dB and re-reads the stack in each
// stage: 26 fields x 4 B per point, ~32.6 us of HBM traffic at 1024^2
// unless L2 (50 MB) holds the working set.  Fusing the stages through
// shared-memory tiles with a 7-point halo is the next step.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

struct Consts {
  int ny, nx;
  float sdx, sdy;          // 1 / (12 h)
  float inv_dx2, inv_dy2;  // 1 / h^2 (flux rings)
  float fdx, fdy;          // 1 / (288 h^2) (flux interior)
};

// 4th-order first derivative at index i of an axis of length n; f(k) reads
// the field at index k along that axis.
template <class F>
__device__ __forceinline__ float d1(F f, int i, int n, float s) {
  if (i >= 2 && i <= n - 3)
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

// Conservative 4th-order (a v')' at index c of an axis of length n.
template <class FA, class FV>
__device__ __forceinline__ float flux(FA a, FV v, int c, int n, float inv_h2,
                                      float f288) {
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
  return (4.f * a(c - 1) * (v(c - 3) - 8.f * v(c - 2) + 8.f * v(c) - v(c + 1))
          - (-a(c - 2) + 9.f * a(c - 1) + 9.f * a(c) - a(c + 1))
            * (v(c - 2) - 27.f * v(c - 1) + 27.f * v(c) - v(c + 1))
          + (-a(c - 1) + 9.f * a(c) + 9.f * a(c + 1) - a(c + 2))
            * (v(c - 1) - 27.f * v(c) + 27.f * v(c + 1) - v(c + 2))
          - 4.f * a(c + 1) * (v(c - 1) - 8.f * v(c) + 8.f * v(c + 2) - v(c + 3)))
         * f288;
}

// Field accessor: f[r, c] of an (ny, nx) row-major plane.
struct Plane {
  const float* p;
  int nx;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return __ldg(p + static_cast<size_t>(r) * nx + c);
  }
};

struct Stack {
  Plane inv_j, xx, yy, xy, c0, c1, c2, c3;
  __device__ Stack(const float* st, int ny, int nx) {
    const size_t P = static_cast<size_t>(ny) * nx;
    inv_j = {st, nx};
    xx = {st + P, nx};
    yy = {st + 2 * P, nx};
    xy = {st + 3 * P, nx};
    c0 = {st + 4 * P, nx};
    c1 = {st + 5 * P, nx};
    c2 = {st + 6 * P, nx};
    c3 = {st + 7 * P, nx};
  }
  __device__ __forceinline__ float a11(int r, int c) const {
    const float q = xy(r, c), y = yy(r, c);
    return (q * q + y * y) * inv_j(r, c);
  }
  __device__ __forceinline__ float a22(int r, int c) const {
    const float q = xy(r, c), x = xx(r, c);
    return (q * q + x * x) * inv_j(r, c);
  }
  __device__ __forceinline__ float a12(int r, int c) const {
    return -(xy(r, c) * (xx(r, c) + yy(r, c))) * inv_j(r, c);
  }
};

// stage 1: dp = -(v_xx + v_yy) + c0 v
__global__ void jvp_stage_dp(const float* __restrict__ vp,
                             const float* __restrict__ st,
                             float* __restrict__ dp, Consts k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= k.ny || j >= k.nx) return;
  const Stack S(st, k.ny, k.nx);
  const Plane v{vp, k.nx};

  const float fx = flux([&](int c) { return S.a11(i, c); },
                        [&](int c) { return v(i, c); }, j, k.nx, k.inv_dx2, k.fdx);
  float tx = 0.f;  // d1_x(a12 * v_eta), zero on the left/right columns
  if (j != 0 && j != k.nx - 1)
    tx = d1([&](int c) {
              return S.a12(i, c) * d1([&](int r) { return v(r, c); }, i, k.ny, k.sdy);
            }, j, k.nx, k.sdx);
  const float fy = flux([&](int r) { return S.a22(r, j); },
                        [&](int r) { return v(r, j); }, i, k.ny, k.inv_dy2, k.fdy);
  float ty = 0.f;  // d1_y(a12 * v_ksi), zero on the bottom/top rows
  if (i != 0 && i != k.ny - 1)
    ty = d1([&](int r) {
              return S.a12(r, j) * d1([&](int c) { return v(r, c); }, j, k.nx, k.sdx);
            }, i, k.ny, k.sdy);
  const float ij = S.inv_j(i, j);
  const float v_xx = (fx + tx) * ij;
  const float v_yy = (fy + ty) * ij;
  dp[static_cast<size_t>(i) * k.nx + j] = -(v_xx + v_yy) + S.c0(i, j) * v(i, j);
}

// stage 2: the flux components dA, dB from grad_xy(dp) (dp/dn = 0 edges)
__global__ void jvp_stage_flux(const float* __restrict__ vp,
                               const float* __restrict__ st,
                               const float* __restrict__ dpp,
                               float* __restrict__ dA, float* __restrict__ dB,
                               Consts k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= k.ny || j >= k.nx) return;
  const Stack S(st, k.ny, k.nx);
  const Plane v{vp, k.nx}, dp{dpp, k.nx};

  const float dpk = (j == 0 || j == k.nx - 1)
      ? 0.f : d1([&](int c) { return dp(i, c); }, j, k.nx, k.sdx);
  const float dpe = (i == 0 || i == k.ny - 1)
      ? 0.f : d1([&](int r) { return dp(r, j); }, i, k.ny, k.sdy);
  const float ij = S.inv_j(i, j), xx = S.xx(i, j), yy = S.yy(i, j), xy = S.xy(i, j);
  const float dpx = (yy * dpk - xy * dpe) * ij;
  const float dpy = (-xy * dpk + xx * dpe) * ij;
  const float c1 = S.c1(i, j), vv = v(i, j);
  const size_t o = static_cast<size_t>(i) * k.nx + j;
  dA[o] = dpx * c1 + S.c2(i, j) * vv;
  dB[o] = dpy * c1 + S.c3(i, j) * vv;
}

// stage 3: out = v - dF2
__global__ void jvp_stage_out(const float* __restrict__ vp,
                              const float* __restrict__ st,
                              const float* __restrict__ dAp,
                              const float* __restrict__ dBp,
                              float* __restrict__ out, Consts k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= k.ny || j >= k.nx) return;
  const Stack S(st, k.ny, k.nx);
  const Plane v{vp, k.nx}, dA{dAp, k.nx}, dB{dBp, k.nx};

  const float dak = d1([&](int c) { return dA(i, c); }, j, k.nx, k.sdx);
  const float dae = d1([&](int r) { return dA(r, j); }, i, k.ny, k.sdy);
  const float dbk = d1([&](int c) { return dB(i, c); }, j, k.nx, k.sdx);
  const float dbe = d1([&](int r) { return dB(r, j); }, i, k.ny, k.sdy);
  const float xx = S.xx(i, j), yy = S.yy(i, j), xy = S.xy(i, j);
  const float dF2 = (yy * dak - xy * dae - xy * dbk + xx * dbe) * S.inv_j(i, j);
  out[static_cast<size_t>(i) * k.nx + j] = v(i, j) - dF2;
}

}  // namespace

// v, out: (ny, nx) f32; stack: (8, ny, nx) f32; scratch: (3, ny, nx) f32.
// All contiguous, on the current device.  Launches on `stream` and returns
// the cudaError_t of the launches (0 on success); does not synchronise.
extern "C" int droplet_jvp_f32(const float* v, const float* stack, float* out,
                               float* scratch, int ny, int nx, double dx,
                               double dy, void* stream) {
  if (ny < 8 || nx < 8) return static_cast<int>(cudaErrorInvalidValue);
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

  const size_t P = static_cast<size_t>(ny) * nx;
  float* dp = scratch;
  float* dA = scratch + P;
  float* dB = scratch + 2 * P;
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  jvp_stage_dp<<<grid, block, 0, s>>>(v, stack, dp, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  jvp_stage_flux<<<grid, block, 0, s>>>(v, stack, dp, dA, dB, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  jvp_stage_out<<<grid, block, 0, s>>>(v, stack, dA, dB, out, k);
  return static_cast<int>(cudaGetLastError());
}
