"""Matrix-free 4th-order finite-difference stencils
(port of ``iterative_solvers_tpu/ops/stencils.py``).

All operators act on ``(..., ny, nx)`` fields; ``*_x`` differentiates along
the last axis (ksi), ``*_y`` along the second-to-last (eta).  Coefficients
are the reference's:

- interior d1 (4th order centred):  ``[1, -8, 0, 8, -1] / 12h``
- interior d2 (4th order centred):  ``[-1, 16, -30, 16, -1] / 12h^2``
- one-sided edge rows as below.

Every function returns a fresh tensor and never writes into its input.

:func:`d1_x`, :func:`d1_y`, :func:`d2_x` and :func:`d2_y` take one rule: on
a CPU tensor they run their plain bodies (:func:`d1_x_plain`, ...), whose
edge rows are a ``(rows, 5 or 6) x (5 or 6, 2)`` product; on a CUDA float32
or float64 tensor each call is one launch of the hand-written kernel of
``csrc/fd_stencil.cu`` (:func:`fd_stencil_kernel`), which reads any strides
and leading axes and returns the plain body's layout, its interior and
scale bit for bit and each edge point summed as one FMA chain from the
first term; any other CUDA tensor raises.  With the tracing of
``utils.trace`` on, ``stencil.calls`` counts every call of the four and
``stencil.kernel`` those during which the kernel's count in
``ops._build.LAUNCHES`` rose.
:data:`PLAIN` holds the four plain bodies.  ``ops.curvilinear``'s geometry,
gradient and Laplacian and ``models.droplet.monitor_source`` take the set of
stencils they call (``fd``); the plain versions that kernels are held to
pass :data:`PLAIN`, so they run the plain bodies on the card too.  The
upwind and periodic operators below stay plain.

:func:`flux_div_x` and :func:`flux_div_y`, the conservative 4th-order flux
divergence ``(a v')'`` of ``ops.curvilinear.laplace``, take the same rule:
on a CPU tensor the plain bodies (:func:`flux_div_x_plain`, ...); on a CUDA
float32 or float64 tensor one launch of ``csrc/flux_div.cu``
(:func:`flux_div_kernel`), bit for bit with the plain body, which reads any
strides and returns a fresh contiguous tensor of the operands' shape.  With
the tracing on, ``flux.calls`` counts every call of the two and
``flux.kernel`` those during which the kernel's count rose.  :data:`PLAIN`
holds their plain bodies too.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from types import SimpleNamespace

import torch
from torch.autograd import forward_ad

from ..utils.trace import count
from ._build import DTYPES, LAUNCHES, check, launch

# One-sided edge rows, applied to the first/last 5 (d1) or 6 (d2) entries.
# d1: /(12h).  d2: /(12h^2); rows 0/-1 assume a known Neumann value at the
# wall (the 25/(6h) g correction is the caller's — see
# ops.curvilinear.mesh_geometry).
_EDGE_ROWS = {
    "d1_lo": [[-25.0, 48.0, -36.0, 16.0, -3.0],
              [-3.0, -10.0, 18.0, -6.0, 1.0]],
    "d1_hi": [[-1.0, 6.0, -18.0, 10.0, 3.0],
              [3.0, -16.0, 36.0, -48.0, 25.0]],
    "d2_lo": [[-415.0 / 6.0, 96.0, -36.0, 32.0 / 3.0, -1.5, 0.0],
              [10.0, -15.0, -4.0, 14.0, -6.0, 1.0]],
    "d2_hi": [[1.0, -6.0, 14.0, -4.0, -15.0, 10.0],
              [0.0, -1.5, 32.0 / 3.0, -36.0, 96.0, -415.0 / 6.0]],
    # 2nd-order upwind differences, /(2h): the last two forward rows and
    # the first two backward rows
    "d1f_hi": [[0.0, -2.0, 2.0],
               [1.0, -4.0, 3.0]],
    "d1b_lo": [[-3.0, 4.0, -1.0],
               [-2.0, 2.0, 0.0]],
}


@lru_cache(maxsize=64)
def _edge_coefs(name: str, dtype: torch.dtype, device: torch.device):
    """An edge-row table on ``device``, copied there once (a copy per call
    would put a host-to-device transfer in every stencil)."""
    return torch.tensor(_EDGE_ROWS[name], dtype=dtype, device=device)


def _edge_rows(u, name: str):
    """The one-sided edge entries ``name`` (e.g. ``"d1_lo"``) along the last
    axis: each a fixed linear combination of the edge strip's values."""
    c = _edge_coefs(name, u.dtype, u.device)
    w = c.shape[1]
    strip = u[..., :w] if name.endswith("_lo") else u[..., -w:]
    return strip @ c.T


def d1_x_plain(u, dx: float):
    """4th-order first derivative along the last axis, the plain body."""
    s = 1.0 / (12.0 * dx)
    interior = u[..., :-4] - 8.0 * u[..., 1:-3] + 8.0 * u[..., 3:-1] - u[..., 4:]
    lo = _edge_rows(u, "d1_lo")
    hi = _edge_rows(u, "d1_hi")
    return torch.cat([lo, interior, hi], dim=-1) * s


def d1_y_plain(u, dy: float):
    """4th-order first derivative along the rows, the plain body."""
    return d1_x_plain(u.transpose(-1, -2), dy).transpose(-1, -2)


def d2_x_plain(u, dx: float):
    """4th-order second derivative along the last axis, the plain body."""
    s = 1.0 / (12.0 * dx * dx)
    interior = (-u[..., :-4] + 16.0 * u[..., 1:-3] - 30.0 * u[..., 2:-2]
                + 16.0 * u[..., 3:-1] - u[..., 4:])
    lo = _edge_rows(u, "d2_lo")
    hi = _edge_rows(u, "d2_hi")
    return torch.cat([lo, interior, hi], dim=-1) * s


def d2_y_plain(u, dy: float):
    """4th-order second derivative along the rows, the plain body."""
    return d2_x_plain(u.transpose(-1, -2), dy).transpose(-1, -2)


def flux_div_x_plain(a, v, inv_h2: float):
    """Conservative 4th-order ``(a v_ksi)_ksi`` along the last axis, the
    plain body (``inv_h2`` = 1 / h^2): columns 3..n-4 take the 4th-order
    conservative form, columns 1, 2, n-3, n-2 one-sided product rules,
    columns 0 and n-1 are zero.  Needs n >= 6."""
    interior = (
        4.0 * a[..., 2:-4] * (v[..., :-6] - 8.0 * v[..., 1:-5] + 8.0 * v[..., 3:-3] - v[..., 4:-2])
        - (-a[..., 1:-5] + 9.0 * a[..., 2:-4] + 9.0 * a[..., 3:-3] - a[..., 4:-2])
        * (v[..., 1:-5] - 27.0 * v[..., 2:-4] + 27.0 * v[..., 3:-3] - v[..., 4:-2])
        + (-a[..., 2:-4] + 9.0 * a[..., 3:-3] + 9.0 * a[..., 4:-2] - a[..., 5:-1])
        * (v[..., 2:-4] - 27.0 * v[..., 3:-3] + 27.0 * v[..., 4:-2] - v[..., 5:-1])
        - 4.0 * a[..., 4:-2] * (v[..., 2:-4] - 8.0 * v[..., 3:-3] + 8.0 * v[..., 5:-1] - v[..., 6:])
    ) * (inv_h2 / 288.0)

    # next-to-boundary columns (product rule with one-sided stencils)
    c1 = (
        a[..., 1]
        * (10.0 * v[..., 0] - 15.0 * v[..., 1] - 4.0 * v[..., 2] + 14.0 * v[..., 3]
           - 6.0 * v[..., 4] + v[..., 5])
        / 12.0
        + (-3.0 * v[..., 0] - 10.0 * v[..., 1] + 18.0 * v[..., 2] - 6.0 * v[..., 3] + v[..., 4])
        * (-3.0 * a[..., 0] - 10.0 * a[..., 1] + 18.0 * a[..., 2] - 6.0 * a[..., 3] + a[..., 4])
        / 144.0
    ) * inv_h2
    cm2 = (
        a[..., -2]
        * (10.0 * v[..., -1] - 15.0 * v[..., -2] - 4.0 * v[..., -3] + 14.0 * v[..., -4]
           - 6.0 * v[..., -5] + v[..., -6])
        / 12.0
        + (3.0 * v[..., -1] + 10.0 * v[..., -2] - 18.0 * v[..., -3] + 6.0 * v[..., -4] - v[..., -5])
        * (3.0 * a[..., -1] + 10.0 * a[..., -2] - 18.0 * a[..., -3] + 6.0 * a[..., -4] - a[..., -5])
        / 144.0
    ) * inv_h2

    # next-to-next-to-boundary columns (centred 2nd derivative + product term)
    c2 = (
        a[..., 2] * (-v[..., 0] + 16.0 * v[..., 1] - 30.0 * v[..., 2] + 16.0 * v[..., 3]
                     - v[..., 4])
        / 12.0
        + (v[..., 0] - 8.0 * v[..., 1] + 8.0 * v[..., 3] - v[..., 4])
        * (a[..., 0] - 8.0 * a[..., 1] + 8.0 * a[..., 3] - a[..., 4])
        / 144.0
    ) * inv_h2
    cm3 = (
        a[..., -3] * (-v[..., -1] + 16.0 * v[..., -2] - 30.0 * v[..., -3] + 16.0 * v[..., -4]
                      - v[..., -5])
        / 12.0
        + (v[..., -5] - 8.0 * v[..., -4] + 8.0 * v[..., -2] - v[..., -1])
        * (a[..., -5] - 8.0 * a[..., -4] + 8.0 * a[..., -2] - a[..., -1])
        / 144.0
    ) * inv_h2

    zero = torch.zeros_like(c1)
    return torch.cat([zero[..., None], c1[..., None], c2[..., None], interior,
                      cm3[..., None], cm2[..., None], zero[..., None]], dim=-1)


def flux_div_y_plain(a, v, inv_h2: float):
    """``(a v_eta)_eta`` along the rows, the plain body."""
    return flux_div_x_plain(a.transpose(-1, -2), v.transpose(-1, -2), inv_h2).transpose(-1, -2)


PLAIN = SimpleNamespace(d1_x=d1_x_plain, d1_y=d1_y_plain, d2_x=d2_x_plain, d2_y=d2_y_plain,
                        flux_div_x=flux_div_x_plain, flux_div_y=flux_div_y_plain)


def _dispatch(prefix: str, kernel: str, u, plain, run):
    """A wrapper's call on ``u``, counted under ``{prefix}.calls``: on a CPU
    tensor ``plain()``, else ``run()``, counted under ``{prefix}.kernel``
    if ``kernel``'s launch count rose in it."""
    count(f"{prefix}.calls")
    if u.device.type == "cpu":
        return plain()
    key = (kernel, DTYPES.get(u.dtype), None)
    before = LAUNCHES[key]
    out = run()
    count(f"{prefix}.kernel", int(LAUNCHES[key] > before))
    return out


def _stencil(u, order: int, axis: int, h: float, plain):
    return _dispatch("stencil", "fd_stencil", u, lambda: plain(u, h),
                     lambda: fd_stencil_kernel(u, order, axis, h))


def d1_x(u, dx: float):
    """4th-order first derivative along the last axis (ksi direction)."""
    return _stencil(u, 1, -1, dx, d1_x_plain)


def d1_y(u, dy: float):
    """4th-order first derivative along the eta (row) axis."""
    return _stencil(u, 1, -2, dy, d1_y_plain)


def d2_x(u, dx: float):
    """4th-order second derivative along the last axis (ksi direction)."""
    return _stencil(u, 2, -1, dx, d2_x_plain)


def d2_y(u, dy: float):
    """4th-order second derivative along the eta (row) axis."""
    return _stencil(u, 2, -2, dy, d2_y_plain)


# -- the kernel --------------------------------------------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_D = ctypes.c_double
_ARGS = {"fd_stencil": [_P, _P, _I, _I, _I, _LL, _LL, _LL, _LL, _D, _P],
         "flux_div": [_P, _P, _P, _I, _I, _LL, _I, _LL, _LL, _LL, _LL, _LL, _LL, _D, _D, _P]}


def _launch(u, order: int, axis: int, h: float):
    """One launch of the kernel on the CUDA field ``u``; raises on anything
    it does not take."""
    name = f"d{order}_{'x' if axis == -1 else 'y'}"
    if u.dim() < -axis:
        raise ValueError(f"the {name} kernel takes no {u.dim()}-D tensor")
    v = u if u.dim() >= 2 else u.unsqueeze(0)
    other = -2 if axis == -1 else -1
    n, m = v.shape[axis], v.shape[other]
    if n < 4 + order:
        raise ValueError(f"the {name} kernel needs {4 + order} points along its axis, got {n}")
    tag = check(name, u, strided=True)
    out = torch.empty(v.shape[:-2] + (m, n), dtype=u.dtype, device=u.device)
    if out.numel():
        # the leading axes as one batch axis (a copy only where no stride walks them)
        w = v.reshape(-1, *v.shape[-2:])
        s = 1.0 / (12.0 * h) if order == 1 else 1.0 / (12.0 * h * h)
        launch(("fd_stencil", tag, None), "fd_stencil", _ARGS, u.device, w.data_ptr(),
               out.data_ptr(), order, n, m, w.stride(axis), w.stride(other), w.shape[0],
               w.stride(0), float(s))
    if axis == -2:
        out = out.transpose(-1, -2)
    return out if u.dim() >= 2 else out.squeeze(0)


class _FdStencil(torch.autograd.Function):
    """The launch with a forward-mode rule, for ``torch.func.jvp`` through a
    residual on the card: the operator is linear, so the tangent's image is
    the same launch on the tangent.  It has no reverse-mode rule (autograd
    raises if a backward pass reaches it)."""

    @staticmethod
    def forward(u, order, axis, h):
        return _launch(u.detach(), order, axis, h)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def jvp(ctx, tangent, *_):
        # the tangent comes wrapped at the transform's level: the wrapper
        # unwraps it on its way to the launch
        return None if tangent is None else fd_stencil_kernel(tangent, *ctx.args)


_wrapped = torch._C._functorch.is_functorch_wrapped_tensor


def fd_stencil_kernel(u, order: int, axis: int, h: float):
    """``d{order}_x`` (``axis`` -1) or ``d{order}_y`` (``axis`` -2) of the
    CUDA float32 or float64 tensor ``u`` with spacing ``h``: one launch of
    ``csrc/fd_stencil.cu`` into a fresh tensor laid out as the plain body
    lays it out (``*_x`` contiguous, ``*_y`` the transpose of a contiguous
    ``(..., nx, ny)`` field).  Under autodiff the launch goes through
    :class:`_FdStencil`."""
    if u.requires_grad or _wrapped(u) or forward_ad._current_level >= 0:
        return _FdStencil.apply(u, order, axis, h)
    return _launch(u, order, axis, h)


def _flux(a, v, axis: int, inv_h2: float, plain):
    return _dispatch("flux", "flux_div", v, lambda: plain(a, v, inv_h2),
                     lambda: flux_div_kernel(a, v, axis, inv_h2))


def flux_div_x(a, v, inv_h2: float):
    """Conservative 4th-order ``(a v_ksi)_ksi`` along the last axis."""
    return _flux(a, v, -1, inv_h2, flux_div_x_plain)


def flux_div_y(a, v, inv_h2: float):
    """Conservative 4th-order ``(a v_eta)_eta`` along the rows."""
    return _flux(a, v, -2, inv_h2, flux_div_y_plain)


def _launch_flux(a, v, axis: int, inv_h2: float):
    """One launch of the flux kernel on the CUDA fields ``a`` and ``v``;
    raises on anything it does not take."""
    name = f"flux_div_{'x' if axis == -1 else 'y'}"
    if a.shape != v.shape or v.dim() < 2:
        raise ValueError(f"the {name} kernel takes two fields of one shape, "
                         f"got {tuple(a.shape)} and {tuple(v.shape)}")
    other = -2 if axis == -1 else -1
    n, m = v.shape[axis], v.shape[other]
    if n < 6:
        raise ValueError(f"the {name} kernel needs 6 points along its axis, got {n}")
    if a.dtype != v.dtype:
        raise TypeError(f"the {name} kernel takes two fields of one dtype, "
                        f"got {a.dtype} and {v.dtype}")
    tag = check(name, a, v, strided=True)
    out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if out.numel():
        # the leading axes as one batch axis (a copy only where no stride walks them)
        wa, wv = (t.reshape(-1, *t.shape[-2:]) for t in (a, v))
        launch(("flux_div", tag, None), "flux_div", _ARGS, v.device, wa.data_ptr(),
               wv.data_ptr(), out.data_ptr(), n, m, wv.shape[0], int(axis == -1),
               wa.stride(0), wa.stride(axis), wa.stride(other),
               wv.stride(0), wv.stride(axis), wv.stride(other), inv_h2, inv_h2 / 288.0)
    return out


class _FluxDiv(torch.autograd.Function):
    """The launch with a forward-mode rule: the flux is bilinear in
    ``(a, v)``, so the tangent's image is the launch on ``a``'s tangent and
    ``v`` plus the launch on ``a`` and ``v``'s tangent, each only where that
    operand carries a tangent.  It has no reverse-mode rule (autograd raises
    if a backward pass reaches it)."""

    @staticmethod
    def forward(a, v, axis, inv_h2):
        return _launch_flux(a.detach(), v.detach(), axis, inv_h2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, v, ctx.axis, ctx.inv_h2 = inputs
        ctx.save_for_forward(a, v)
        # an operand without a tangent gets None, not zeros: no launch for it
        ctx.set_materialize_grads(False)

    @staticmethod
    def jvp(ctx, a_tangent, v_tangent, *_):
        # the tangents come wrapped at the transform's level: the wrapper
        # unwraps them on their way to the launch
        a, v = ctx.saved_tensors
        out = None
        for x, y in ((a_tangent, v), (a, v_tangent)):
            if x is not None and y is not None:
                part = flux_div_kernel(x, y, ctx.axis, ctx.inv_h2)
                out = part if out is None else out + part
        return out


def flux_div_kernel(a, v, axis: int, inv_h2: float):
    """``flux_div_x`` (``axis`` -1) or ``flux_div_y`` (``axis`` -2) of the
    CUDA float32 or float64 fields ``a`` and ``v`` of one shape and dtype:
    one launch of ``csrc/flux_div.cu`` into a fresh contiguous tensor of
    that shape.  Under autodiff the launch goes through :class:`_FluxDiv`."""
    if (a.requires_grad or v.requires_grad or _wrapped(a) or _wrapped(v)
            or forward_ad._current_level >= 0):
        return _FluxDiv.apply(a, v, axis, inv_h2)
    return _launch_flux(a, v, axis, inv_h2)


def dxy(u, dx: float, dy: float):
    """Mixed derivative d^2 u / (dksi deta): d1 along x, then along y."""
    return d1_y(d1_x(u, dx), dy)


def d1_x_forward(u, dx: float):
    """2nd-order forward difference along x: [-3,4,-1]/2h at j..j+2."""
    s = 1.0 / (2.0 * dx)
    interior = -3.0 * u[..., :-2] + 4.0 * u[..., 1:-1] - u[..., 2:]
    return torch.cat([interior, _edge_rows(u, "d1f_hi")], dim=-1) * s


def d1_x_backward(u, dx: float):
    """2nd-order backward difference along x: [1,-4,3]/2h at j-2..j."""
    s = 1.0 / (2.0 * dx)
    interior = u[..., :-2] - 4.0 * u[..., 1:-1] + 3.0 * u[..., 2:]
    return torch.cat([_edge_rows(u, "d1b_lo"), interior], dim=-1) * s


def d1_y_forward(u, dy: float):
    return d1_x_forward(u.transpose(-1, -2), dy).transpose(-1, -2)


def d1_y_backward(u, dy: float):
    return d1_x_backward(u.transpose(-1, -2), dy).transpose(-1, -2)


# -- periodic operators ------------------------------------------------------

def lap_periodic(u, h: float):
    """5-point Laplacian with both axes periodic (plain version of the
    ``lap_periodic`` kernel, ``ops/periodic_stencil.py``)."""
    inv_h2 = 1.0 / (h * h)
    return (torch.roll(u, 1, dims=-1) + torch.roll(u, -1, dims=-1)
            + torch.roll(u, 1, dims=-2) + torch.roll(u, -1, dims=-2)
            - 4.0 * u) * inv_h2


def lap_dirichlet_5pt(u, h: float):
    """5-point Laplacian with homogeneous Dirichlet values outside the grid
    (``u`` holds the interior unknowns only)."""
    inv_h2 = 1.0 / (h * h)
    up = torch.nn.functional.pad(u, (1, 1, 1, 1))
    return (up[..., :-2, 1:-1] + up[..., 2:, 1:-1] + up[..., 1:-1, :-2]
            + up[..., 1:-1, 2:] - 4.0 * u) * inv_h2


def sh_linear_operator(u, h: float, r: float):
    """Swift–Hohenberg linear operator ``L = -Lap^2 - 2 Lap + (r-1) I``,
    periodic (plain version of the ``sh_operator`` kernel)."""
    lap_u = lap_periodic(u, h)
    return -lap_periodic(lap_u, h) - 2.0 * lap_u + (r - 1.0) * u
