// The conservative 4th-order flux divergence (a v')' of
// ops/stencils.flux_div_x_plain at one point, for float and double: the one
// body that csrc/flux_div.cu (a call of ops/stencils.flux_div_x or _y) and
// csrc/pma_substep.cu (the monitor's Laplacian inside pma_source) compute.
//
// Numerics: every operation rounds as the eager PyTorch op it stands for
// rounds on the card, so the result equals the plain body's bit for bit:
// each is an intrinsic the compiler cannot contract into an FMA
// (__fadd_rn, __dmul_rn, ...), in the plain code's order; a division by a
// Python scalar (/ 12.0, / 144.0) is a multiplication by its reciprocal in
// the field's type, as ATen computes it; the scales ih = 1 / h^2 and
// f288 = ih / 288 come from the host, computed in double and converted to
// the field's type, as ATen converts a Python scalar.

#pragma once

#include <cuda_runtime.h>

namespace flux_rn {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

// (a v')' at index c of an axis of length n >= 6; a(k) and v(k) read index k.
// Columns 3..n-4 take the 4th-order conservative form, 1, 2, n-3 and n-2
// the one-sided product rules (the rings), 0 and n-1 are zero.
template <class T, class FA, class FV>
__device__ __forceinline__ T flux(FA a, FV v, int c, int n, T ih, T f288) {
  constexpr T kInv12 = T(1) / T(12), kInv144 = T(1) / T(144);
  if (c == 0 || c == n - 1) return T(0);
  if (c >= 3 && c <= n - 4) {
    const T t1 = mul(mul(T(4), a(c - 1)),
                     sub(add(sub(v(c - 3), mul(T(8), v(c - 2))), mul(T(8), v(c))), v(c + 1)));
    const T t2 = mul(sub(add(add(-a(c - 2), mul(T(9), a(c - 1))), mul(T(9), a(c))), a(c + 1)),
                     sub(add(sub(v(c - 2), mul(T(27), v(c - 1))), mul(T(27), v(c))), v(c + 1)));
    const T t3 = mul(sub(add(add(-a(c - 1), mul(T(9), a(c))), mul(T(9), a(c + 1))), a(c + 2)),
                     sub(add(sub(v(c - 1), mul(T(27), v(c))), mul(T(27), v(c + 1))), v(c + 2)));
    const T t4 = mul(mul(T(4), a(c + 1)),
                     sub(add(sub(v(c - 1), mul(T(8), v(c))), mul(T(8), v(c + 2))), v(c + 3)));
    return mul(sub(add(sub(t1, t2), t3), t4), f288);
  }
  // the rings: (a_c P / 12 + Q R / 144) / h^2, each sum in the plain code's order
  T p, q, r, ac;
  if (c == 1) {
    // P = 10 v0 - 15 v1 - 4 v2 + 14 v3 - 6 v4 + v5, Q = -3 v0 - 10 v1 + 18 v2 - 6 v3 + v4,
    // R = Q's weights on a
    p = add(sub(add(sub(sub(mul(T(10), v(0)), mul(T(15), v(1))), mul(T(4), v(2))),
                    mul(T(14), v(3))),
                mul(T(6), v(4))),
            v(5));
    q = add(sub(add(sub(mul(T(-3), v(0)), mul(T(10), v(1))), mul(T(18), v(2))), mul(T(6), v(3))),
            v(4));
    r = add(sub(add(sub(mul(T(-3), a(0)), mul(T(10), a(1))), mul(T(18), a(2))), mul(T(6), a(3))),
            a(4));
    ac = a(1);
  } else if (c == 2) {
    // P = -v0 + 16 v1 - 30 v2 + 16 v3 - v4, Q = v0 - 8 v1 + 8 v3 - v4, R = Q's weights on a
    p = sub(add(sub(add(-v(0), mul(T(16), v(1))), mul(T(30), v(2))), mul(T(16), v(3))), v(4));
    q = sub(add(sub(v(0), mul(T(8), v(1))), mul(T(8), v(3))), v(4));
    r = sub(add(sub(a(0), mul(T(8), a(1))), mul(T(8), a(3))), a(4));
    ac = a(2);
  } else if (c == n - 3) {
    // P = -v[-1] + 16 v[-2] - 30 v[-3] + 16 v[-4] - v[-5],
    // Q = v[-5] - 8 v[-4] + 8 v[-2] - v[-1], R = Q's weights on a
    p = sub(add(sub(add(-v(n - 1), mul(T(16), v(n - 2))), mul(T(30), v(n - 3))),
                mul(T(16), v(n - 4))),
            v(n - 5));
    q = sub(add(sub(v(n - 5), mul(T(8), v(n - 4))), mul(T(8), v(n - 2))), v(n - 1));
    r = sub(add(sub(a(n - 5), mul(T(8), a(n - 4))), mul(T(8), a(n - 2))), a(n - 1));
    ac = a(n - 3);
  } else {  // c == n - 2
    // P = 10 v[-1] - 15 v[-2] - 4 v[-3] + 14 v[-4] - 6 v[-5] + v[-6],
    // Q = 3 v[-1] + 10 v[-2] - 18 v[-3] + 6 v[-4] - v[-5], R = Q's weights on a
    p = add(sub(add(sub(sub(mul(T(10), v(n - 1)), mul(T(15), v(n - 2))), mul(T(4), v(n - 3))),
                    mul(T(14), v(n - 4))),
                mul(T(6), v(n - 5))),
            v(n - 6));
    q = sub(add(sub(add(mul(T(3), v(n - 1)), mul(T(10), v(n - 2))), mul(T(18), v(n - 3))),
                mul(T(6), v(n - 4))),
            v(n - 5));
    r = sub(add(sub(add(mul(T(3), a(n - 1)), mul(T(10), a(n - 2))), mul(T(18), a(n - 3))),
                mul(T(6), a(n - 4))),
            a(n - 5));
    ac = a(n - 2);
  }
  return mul(add(mul(mul(ac, p), kInv12), mul(mul(q, r), kInv144)), ih);
}

}  // namespace flux_rn
