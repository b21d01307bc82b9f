"""Double-float (two-f32) compensated arithmetic
(port of ``iterative_solvers_tpu/ops/df64.py``).

A df64 value is a ``(hi, lo)`` pair of equal-shape f32 tensors whose sum
``hi + lo`` is the represented value, ``|lo| <= ulp(hi)/2``.  Error-free
transforms (Knuth TwoSum, Dekker/Veltkamp TwoProd without FMA) carry
~2^-48 relative accuracy through linear chains such as the droplet
residual's stencils (``models.droplet.make_cn_residual_df``).

Plain PyTorch, run eagerly: Dekker's split and TwoProd need every f32
product and sum rounded on its own, which holds because each operation is
its own launch.  Never run these functions through ``torch.compile``: a
fused kernel may contract ``a*b - p`` into one FMA and lose the error term.
Scalars enter as Python floats that hold f32 values, so that each
operation is exact in the f32 tensor's own dtype.  f64 data, a 0-dim f64
tensor included, enters through :func:`from64` only: PyTorch computes an
f32 tensor times a 0-dim f64 tensor in f32 and rounds the scalar silently.
"""
from __future__ import annotations

import numpy as np
import torch

from .stencils import _EDGE_ROWS

_SPLIT = 4097.0  # 2^12 + 1 (f32 has a 24-bit mantissa)
_EXACT = (1.0, -1.0, 2.0, -2.0, 4.0, -4.0, 8.0, -8.0, 16.0, -16.0, 32.0,
          -32.0)


def _f32(c: float) -> float:
    """``c`` rounded to f32, as a Python float (exact in any later cast)."""
    return float(np.float32(c))


# -- error-free transforms -----------------------------------------------------

def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fast_two_sum(a, b):
    """Requires |a| >= |b| (use after a renormalising _two_sum)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def _split_scalar(b: float):
    """:func:`_split` of a Python float holding an f32 value, in numpy f32
    on the host."""
    b = np.float32(b)
    c = np.float32(_SPLIT) * b
    hi = c - (c - b)
    return float(hi), float(b - hi)


def _two_prod(a, b):
    """Exact product a*b = p + err without FMA (Veltkamp/Dekker); ``b`` a
    tensor or a Python float holding an f32 value."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split_scalar(b) if isinstance(b, float) else _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


# -- conversions ---------------------------------------------------------------

def from64(x):
    """Split an f64 tensor into a df64 pair (f32 hi + f32 lo carry 49 of
    the 53 mantissa bits)."""
    hi = x.to(torch.float32)
    return hi, (x - hi.to(torch.float64)).to(torch.float32)


def to64(x):
    return x[0].to(torch.float64) + x[1].to(torch.float64)


def from32(h):
    return h, torch.zeros_like(h)


def const(c: float):
    """A Python/f64 scalar as an (hi, lo) pair of f32 values (Python floats)."""
    hi = np.float32(c)
    return float(hi), _f32(np.float64(c) - np.float64(hi))


# -- arithmetic ----------------------------------------------------------------

def add(x, y):
    sh, sl = _two_sum(x[0], y[0])
    sl = sl + (x[1] + y[1])
    return _fast_two_sum(sh, sl)


def sub(x, y):
    return add(x, neg(y))


def neg(x):
    return -x[0], -x[1]


def add_f(x, b):
    """df64 + plain f32 tensor or scalar."""
    sh, sl = _two_sum(x[0], b)
    return _fast_two_sum(sh, sl + x[1])


def mul(x, y):
    ph, pl = _two_prod(x[0], y[0])
    pl = pl + (x[0] * y[1] + x[1] * y[0])
    return _fast_two_sum(ph, pl)


def mul_f(x, b):
    """df64 x plain f32 tensor or scalar (a float holding an f32 value)."""
    ph, pl = _two_prod(x[0], b)
    return _fast_two_sum(ph, pl + x[1] * b)


def mul_pow2(x, c: float):
    """Exact scaling by a (possibly negative) power of two."""
    c = _f32(c)
    return x[0] * c, x[1] * c


def scale(x, c: float):
    """df64 x Python float (carried to df64 precision)."""
    ch, cl = const(c)
    ph, pl = _two_prod(x[0], ch)
    pl = pl + (x[0] * cl + x[1] * ch)
    return _fast_two_sum(ph, pl)


def recip(x):
    """1/x by one df64 Newton step from the f32 seed: rel err ~ eps32^2."""
    r0 = 1.0 / x[0]
    # r1 = r0 * (2 - x r0): the correction term is computed in df64
    e = sub(from32(torch.full_like(r0, 2.0)), mul_f(x, r0))
    return mul_f(e, r0)


def div(x, y):
    return mul(x, recip(y))


def sq(x):
    return mul(x, x)


# -- linear stencils (mirrors of ops.stencils, pairs in/out) -------------------

def _edge_rows_df(u, strip_w: int, coefs, side: str):
    """One-sided boundary entries along the last axis with compensated
    accumulation (mirror of ``stencils._edge_rows``; the coefficient tables
    hold small integers, exact in f32)."""
    uh, ul = u
    sh_str = uh[..., :strip_w] if side == "lo" else uh[..., -strip_w:]
    sl_str = ul[..., :strip_w] if side == "lo" else ul[..., -strip_w:]
    rows = []
    for row in coefs:
        acc = None
        for i in range(strip_w):
            c = _f32(row[i])
            if c == 0.0:
                continue
            t = mul_f((sh_str[..., i], sl_str[..., i]), c)
            acc = t if acc is None else add(acc, t)
        rows.append(acc)
    h = torch.stack([r[0] for r in rows], dim=-1)
    l = torch.stack([r[1] for r in rows], dim=-1)
    return h, l


def _lc(*terms):
    """Compensated linear combination of (coefficient, pair) terms;
    integer coefficients are exact in f32."""
    acc = None
    for c, t in terms:
        c = _f32(c)
        tt = (t[0] * c, t[1] * c) if c in _EXACT else mul_f(t, c)
        acc = tt if acc is None else add(acc, tt)
    return acc


def _sl(u, sl_):
    """Slice both components along the last axis."""
    return u[0][..., sl_], u[1][..., sl_]


def _slc(u, j):
    """Single column j of both components."""
    return u[0][..., j], u[1][..., j]


def d1_x_df(u, dx: float):
    """4th-order first derivative along the last axis (stencils.d1_x)."""
    interior = _lc((1.0, _sl(u, np.s_[:-4])), (-8.0, _sl(u, np.s_[1:-3])),
                   (8.0, _sl(u, np.s_[3:-1])), (-1.0, _sl(u, np.s_[4:])))
    lo = _edge_rows_df(u, 5, _EDGE_ROWS["d1_lo"], "lo")
    hi = _edge_rows_df(u, 5, _EDGE_ROWS["d1_hi"], "hi")
    h = torch.cat([lo[0], interior[0], hi[0]], dim=-1)
    l = torch.cat([lo[1], interior[1], hi[1]], dim=-1)
    return scale((h, l), 1.0 / (12.0 * dx))


def tT(u):
    """Swap the last two axes of both components (views)."""
    return u[0].transpose(-1, -2), u[1].transpose(-1, -2)


def d1_y_df(u, dy: float):
    return tT(d1_x_df(tT(u), dy))


def flux_div_x_df(a, v, inv_h2: float):
    """Conservative 4th-order ``(a v_ksi)_ksi`` along the last axis —
    compensated mirror of ``ops.stencils.flux_div_x_plain``."""
    A = lambda s: _sl(a, s)  # noqa: E731
    V = lambda s: _sl(v, s)  # noqa: E731
    t1 = mul(_lc((4.0, A(np.s_[2:-4]))),
             _lc((1.0, V(np.s_[:-6])), (-8.0, V(np.s_[1:-5])),
                 (8.0, V(np.s_[3:-3])), (-1.0, V(np.s_[4:-2]))))
    t2 = mul(_lc((-1.0, A(np.s_[1:-5])), (9.0, A(np.s_[2:-4])),
                 (9.0, A(np.s_[3:-3])), (-1.0, A(np.s_[4:-2]))),
             _lc((1.0, V(np.s_[1:-5])), (-27.0, V(np.s_[2:-4])),
                 (27.0, V(np.s_[3:-3])), (-1.0, V(np.s_[4:-2]))))
    t3 = mul(_lc((-1.0, A(np.s_[2:-4])), (9.0, A(np.s_[3:-3])),
                 (9.0, A(np.s_[4:-2])), (-1.0, A(np.s_[5:-1]))),
             _lc((1.0, V(np.s_[2:-4])), (-27.0, V(np.s_[3:-3])),
                 (27.0, V(np.s_[4:-2])), (-1.0, V(np.s_[5:-1]))))
    t4 = mul(_lc((4.0, A(np.s_[4:-2]))),
             _lc((1.0, V(np.s_[2:-4])), (-8.0, V(np.s_[3:-3])),
                 (8.0, V(np.s_[5:-1])), (-1.0, V(np.s_[6:]))))
    interior = scale(add(sub(t1, t2), sub(t3, t4)), inv_h2 / 288.0)

    Ac = lambda j: _slc(a, j)  # noqa: E731
    Vc = lambda j: _slc(v, j)  # noqa: E731
    c1 = add(
        scale(mul(Ac(1), _lc((10.0, Vc(0)), (-15.0, Vc(1)), (-4.0, Vc(2)),
                             (14.0, Vc(3)), (-6.0, Vc(4)), (1.0, Vc(5)))),
              1.0 / 12.0),
        scale(mul(_lc((-3.0, Vc(0)), (-10.0, Vc(1)), (18.0, Vc(2)),
                      (-6.0, Vc(3)), (1.0, Vc(4))),
                  _lc((-3.0, Ac(0)), (-10.0, Ac(1)), (18.0, Ac(2)),
                      (-6.0, Ac(3)), (1.0, Ac(4)))),
              1.0 / 144.0))
    c1 = scale(c1, inv_h2)
    cm2 = add(
        scale(mul(Ac(-2), _lc((10.0, Vc(-1)), (-15.0, Vc(-2)), (-4.0, Vc(-3)),
                              (14.0, Vc(-4)), (-6.0, Vc(-5)), (1.0, Vc(-6)))),
              1.0 / 12.0),
        scale(mul(_lc((3.0, Vc(-1)), (10.0, Vc(-2)), (-18.0, Vc(-3)),
                      (6.0, Vc(-4)), (-1.0, Vc(-5))),
                  _lc((3.0, Ac(-1)), (10.0, Ac(-2)), (-18.0, Ac(-3)),
                      (6.0, Ac(-4)), (-1.0, Ac(-5)))),
              1.0 / 144.0))
    cm2 = scale(cm2, inv_h2)
    c2 = add(
        scale(mul(Ac(2), _lc((-1.0, Vc(0)), (16.0, Vc(1)), (-30.0, Vc(2)),
                             (16.0, Vc(3)), (-1.0, Vc(4)))),
              1.0 / 12.0),
        scale(mul(_lc((1.0, Vc(0)), (-8.0, Vc(1)), (8.0, Vc(3)),
                      (-1.0, Vc(4))),
                  _lc((1.0, Ac(0)), (-8.0, Ac(1)), (8.0, Ac(3)),
                      (-1.0, Ac(4)))),
              1.0 / 144.0))
    c2 = scale(c2, inv_h2)
    cm3 = add(
        scale(mul(Ac(-3), _lc((-1.0, Vc(-1)), (16.0, Vc(-2)), (-30.0, Vc(-3)),
                              (16.0, Vc(-4)), (-1.0, Vc(-5)))),
              1.0 / 12.0),
        scale(mul(_lc((1.0, Vc(-5)), (-8.0, Vc(-4)), (8.0, Vc(-2)),
                      (-1.0, Vc(-1))),
                  _lc((1.0, Ac(-5)), (-8.0, Ac(-4)), (8.0, Ac(-2)),
                      (-1.0, Ac(-1)))),
              1.0 / 144.0))
    cm3 = scale(cm3, inv_h2)

    zero = torch.zeros_like(c1[0])

    def cat(parts):
        return torch.cat([p[..., None] if p.dim() == interior[0].dim() - 1
                          else p for p in parts], dim=-1)

    h = cat([zero, c1[0], c2[0], interior[0], cm3[0], cm2[0], zero])
    l = cat([zero, c1[1], c2[1], interior[1], cm3[1], cm2[1], zero])
    return h, l


def set_col(u, j, val: float = 0.0):
    """Column ``j`` set to the f32 value ``val`` (hi ``val``, lo 0), written
    in place: ``u`` must be a pair the caller owns (a stencil's fresh
    result).  The JAX package writes ``val`` into both components, which
    represents ``2 val``; its callers, like these, pass 0 only."""
    u[0][:, j] = val
    u[1][:, j] = 0.0
    return u


def set_row(u, i, val: float = 0.0):
    """Row ``i`` set to ``val``, in place (see :func:`set_col`)."""
    u[0][i, :] = val
    u[1][i, :] = 0.0
    return u
