"""Plain thin-film droplet and moving-mesh (PMA) formulas, the yardstick
of the ``droplet1024`` cells, and the benchmark's own state preparation.

A frozen copy of the plain formulas of the reference's ``droplet.py``
(``residual``, ``pde_rhs``, ``pressure``, ``Laplace_operator``,
``compute_Q_spatial_ders``, ``compute_and_smooth_monitor``, ``solve_PMA``,
``loop_pma``) in the deviation form the fine-grid runs use
(``Q = (x^2 + y^2)/2 + phi``), and of the large-grid preparation
(upsample the 91x61 coalescence state, seed two drops, relax the mesh).
Plain PyTorch on whatever device the tensors are on; it imports nothing of
the program.  Every matmul is written out (``_mm``) so that the control can
round its operands to TF32 on any device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import pathlib

import numpy as np
import torch

DATA = pathlib.Path(__file__).resolve().parents[1] / "data" / "coalescence_91x61.npz"


@dataclasses.dataclass(frozen=True)
class Params:
    """The droplet configuration: grid, physics and mesh adaptivity."""

    nx: int
    ny: int
    xl: float
    xr: float
    yb: float
    yt: float
    R: float
    a: float
    epsilon: float
    n_exp: int
    m_exp: int
    Bo: float
    incline: float
    alpha: float
    gamma: float
    mackenzie_c: float
    smoothing_iters: int

    @classmethod
    def of(cls, cfg: dict):
        """The parameters a configuration file holds."""
        return cls(**{f.name: cfg[f.name] for f in dataclasses.fields(cls)})

    @property
    def dx(self) -> float:
        return (self.xr - self.xl) / (self.nx - 1)

    @property
    def dy(self) -> float:
        return (self.yt - self.yb) / (self.ny - 1)

    def coords(self, dtype, device):
        x = torch.as_tensor(np.linspace(self.xl, self.xr, self.nx), device=device).to(dtype)
        y = torch.as_tensor(np.linspace(self.yb, self.yt, self.ny), device=device).to(dtype)
        return x[None, :].expand(self.ny, self.nx), y[:, None].expand(self.ny, self.nx)


# -- TF32 rounding (the control) ---------------------------------------------

def tf32(a):
    """``a`` (float32) rounded to TF32's 10-bit mantissa, to nearest even."""
    bits = a.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _mm(a, b, tf32_operands: bool = False):
    if tf32_operands:
        a, b = tf32(a), tf32(b)
    return a @ b


# -- 4th-order stencils with the reference's one-sided edge rows -------------

def _comb(u, cols, coefs):
    out = coefs[0] * u[..., cols[0]]
    for c, w in zip(cols[1:], coefs[1:]):
        if w != 0.0:
            out = out + w * u[..., c]
    return out[..., None]


def d1_x(u, h: float):
    interior = u[..., :-4] - 8.0 * u[..., 1:-3] + 8.0 * u[..., 3:-1] - u[..., 4:]
    lo = torch.cat([_comb(u, range(5), [-25.0, 48.0, -36.0, 16.0, -3.0]),
                    _comb(u, range(5), [-3.0, -10.0, 18.0, -6.0, 1.0])], dim=-1)
    hi = torch.cat([_comb(u, range(-5, 0), [-1.0, 6.0, -18.0, 10.0, 3.0]),
                    _comb(u, range(-5, 0), [3.0, -16.0, 36.0, -48.0, 25.0])], dim=-1)
    return torch.cat([lo, interior, hi], dim=-1) / (12.0 * h)


def d2_x(u, h: float):
    interior = (-u[..., :-4] + 16.0 * u[..., 1:-3] - 30.0 * u[..., 2:-2]
                + 16.0 * u[..., 3:-1] - u[..., 4:])
    lo = torch.cat([_comb(u, range(6), [-415.0 / 6.0, 96.0, -36.0, 32.0 / 3.0, -1.5, 0.0]),
                    _comb(u, range(6), [10.0, -15.0, -4.0, 14.0, -6.0, 1.0])], dim=-1)
    hi = torch.cat([_comb(u, range(-6, 0), [1.0, -6.0, 14.0, -4.0, -15.0, 10.0]),
                    _comb(u, range(-6, 0), [0.0, -1.5, 32.0 / 3.0, -36.0, 96.0, -415.0 / 6.0])],
                   dim=-1)
    return torch.cat([lo, interior, hi], dim=-1) / (12.0 * h * h)


def d1_y(u, h: float):
    return d1_x(u.transpose(-1, -2), h).transpose(-1, -2)


def d2_y(u, h: float):
    return d2_x(u.transpose(-1, -2), h).transpose(-1, -2)


def _zero_edges(f, cols: bool = True, rows: bool = True):
    f = f.clone()
    if cols:
        f[:, 0] = 0.0
        f[:, -1] = 0.0
    if rows:
        f[0, :] = 0.0
        f[-1, :] = 0.0
    return f


# -- mesh geometry (deviation form) -------------------------------------------

def geometry(phi, p: Params):
    """``(x, y, Q_xx, Q_yy, Q_xy, J)`` of ``Q = (x^2+y^2)/2 + phi`` with the
    PMA Neumann edges (``phi``'s one-sided corrections vanish)."""
    px = d1_x(phi, p.dx)
    px[:, 0] = 0.0
    px[:, -1] = 0.0
    py = d1_y(phi, p.dy)
    py[0, :] = 0.0
    py[-1, :] = 0.0
    qxx = 1.0 + d2_x(phi, p.dx)
    qyy = 1.0 + d2_y(phi, p.dy)
    qxy = _zero_edges(d1_y(d1_x(phi, p.dx), p.dy))
    xx, yy = p.coords(phi.dtype, phi.device)
    return xx + px, yy + py, qxx, qyy, qxy, qxx * qyy - qxy * qxy


def _flux_div_x(a, v, inv_h2):
    """Conservative 4th-order ``(a v_ksi)_ksi`` with the reference's
    one-sided rings; zero on the edge columns."""
    interior = (
        4.0 * a[:, 2:-4] * (v[:, :-6] - 8.0 * v[:, 1:-5] + 8.0 * v[:, 3:-3] - v[:, 4:-2])
        - (-a[:, 1:-5] + 9.0 * a[:, 2:-4] + 9.0 * a[:, 3:-3] - a[:, 4:-2])
        * (v[:, 1:-5] - 27.0 * v[:, 2:-4] + 27.0 * v[:, 3:-3] - v[:, 4:-2])
        + (-a[:, 2:-4] + 9.0 * a[:, 3:-3] + 9.0 * a[:, 4:-2] - a[:, 5:-1])
        * (v[:, 2:-4] - 27.0 * v[:, 3:-3] + 27.0 * v[:, 4:-2] - v[:, 5:-1])
        - 4.0 * a[:, 4:-2] * (v[:, 2:-4] - 8.0 * v[:, 3:-3] + 8.0 * v[:, 5:-1] - v[:, 6:])
    ) * (inv_h2 / 288.0)
    c1 = (a[:, 1] * (10.0 * v[:, 0] - 15.0 * v[:, 1] - 4.0 * v[:, 2] + 14.0 * v[:, 3]
                     - 6.0 * v[:, 4] + v[:, 5]) / 12.0
          + (-3.0 * v[:, 0] - 10.0 * v[:, 1] + 18.0 * v[:, 2] - 6.0 * v[:, 3] + v[:, 4])
          * (-3.0 * a[:, 0] - 10.0 * a[:, 1] + 18.0 * a[:, 2] - 6.0 * a[:, 3] + a[:, 4])
          / 144.0) * inv_h2
    cm2 = (a[:, -2] * (10.0 * v[:, -1] - 15.0 * v[:, -2] - 4.0 * v[:, -3] + 14.0 * v[:, -4]
                       - 6.0 * v[:, -5] + v[:, -6]) / 12.0
           + (3.0 * v[:, -1] + 10.0 * v[:, -2] - 18.0 * v[:, -3] + 6.0 * v[:, -4] - v[:, -5])
           * (3.0 * a[:, -1] + 10.0 * a[:, -2] - 18.0 * a[:, -3] + 6.0 * a[:, -4] - a[:, -5])
           / 144.0) * inv_h2
    c2 = (a[:, 2] * (-v[:, 0] + 16.0 * v[:, 1] - 30.0 * v[:, 2] + 16.0 * v[:, 3] - v[:, 4])
          / 12.0
          + (v[:, 0] - 8.0 * v[:, 1] + 8.0 * v[:, 3] - v[:, 4])
          * (a[:, 0] - 8.0 * a[:, 1] + 8.0 * a[:, 3] - a[:, 4]) / 144.0) * inv_h2
    cm3 = (a[:, -3] * (-v[:, -1] + 16.0 * v[:, -2] - 30.0 * v[:, -3] + 16.0 * v[:, -4]
                       - v[:, -5]) / 12.0
           + (v[:, -5] - 8.0 * v[:, -4] + 8.0 * v[:, -2] - v[:, -1])
           * (a[:, -5] - 8.0 * a[:, -4] + 8.0 * a[:, -2] - a[:, -1]) / 144.0) * inv_h2
    zero = torch.zeros_like(c1)
    return torch.cat([zero[:, None], c1[:, None], c2[:, None], interior,
                      cm3[:, None], cm2[:, None], zero[:, None]], dim=1)


def laplace(v, v_ksi, v_eta, geom, p: Params):
    """Curvilinear ``(v_xx, v_yy)`` on the moving mesh."""
    _, _, qxx, qyy, qxy, j = geom
    a11 = (qxy * qxy + qyy * qyy) / j
    a22 = (qxy * qxy + qxx * qxx) / j
    a12 = -(qxy * (qxx + qyy)) / j
    v_xx = _flux_div_x(a11, v, 1.0 / (p.dx * p.dx))
    v_yy = _flux_div_x(a22.T, v.T, 1.0 / (p.dy * p.dy)).T
    tx = _zero_edges(d1_x(a12 * v_eta, p.dx), rows=False)
    ty = _zero_edges(d1_y(a12 * v_ksi, p.dy), cols=False)
    return (v_xx + tx) / j, (v_yy + ty) / j


def grad_ksi_quirk(v, p: Params):
    """Computational gradient with the reference's edge slip: ``v_ksi``
    zeroed on the left, right and bottom edges, ``v_eta`` on the top row."""
    vx = d1_x(v, p.dx)
    vy = d1_y(v, p.dy)
    vx[:, 0] = 0.0
    vx[:, -1] = 0.0
    vx[0, :] = 0.0
    vy[-1, :] = 0.0
    return vx, vy


# -- thin-film physics ----------------------------------------------------------

def pressure(h, hxx, hyy, p: Params):
    n, m, eps = p.n_exp, p.m_exp, p.epsilon
    r = eps / h
    pi = (n - 1) * (m - 1) * (r ** m - r ** n) / (2.0 * eps * (n - m))
    return -(hxx + hyy) + pi + float(p.Bo * np.cos(p.incline)) * h


def _flux_divergence(p_dx, p_dy, h, geom, p: Params):
    _, _, qxx, qyy, qxy, j = geom
    drive = float(p.Bo * np.sin(p.incline) * (p.yt - p.yb))
    h3 = h ** 3 / 3.0
    A = (p_dx - drive) * h3
    B = p_dy * h3
    return (qyy * d1_x(A, p.dx) - qxy * d1_y(A, p.dy)
            - qxy * d1_x(B, p.dx) + qxx * d1_y(B, p.dy)) / j


def _pressure_grad(pr, geom, p: Params):
    _, _, qxx, qyy, qxy, j = geom
    p_ksi = _zero_edges(d1_x(pr, p.dx), rows=False)
    p_eta = _zero_edges(d1_y(pr, p.dy), cols=False)
    return (qyy * p_ksi - qxy * p_eta) / j, (-qxy * p_ksi + qxx * p_eta) / j


def pde_rhs(h, geom, p: Params):
    """Explicit ``dh/dt`` with the pressure from the quirk-BC'd derivatives."""
    h_ksi, h_eta = grad_ksi_quirk(h, p)
    hxx, hyy = laplace(h, h_ksi, h_eta, geom, p)
    p_dx, p_dy = _pressure_grad(pressure(h, hxx, hyy, p), geom, p)
    return _flux_divergence(p_dx, p_dy, h, geom, p)


def cn_residual(u, u_old, F, dt: float, geom, p: Params):
    """``(u - u_old) - dt (F2(u) + F)/2`` (the reference's residual, not
    divided by dt)."""
    u_xx, u_yy = laplace(u, d1_x(u, p.dx), d1_y(u, p.dy), geom, p)
    p_dx, p_dy = _pressure_grad(pressure(u, u_xx, u_yy, p), geom, p)
    F2 = _flux_divergence(p_dx, p_dy, u, geom, p)
    return (u - u_old) - dt * (F2 + F) / 2.0


def step_residual_max(u_new, u_old, phi_old, dt: float, p: Params) -> float:
    """Max-norm of the CN residual of a step from ``(u_old, phi_old)`` at
    ``u_new``, in float64 on ``phi_old``'s frozen mesh: what the step's
    Newton ``f_tol`` bounds."""
    u_new, u_old, phi_old = u_new.double(), u_old.double(), phi_old.double()
    geom = geometry(phi_old, p)
    F = pde_rhs(u_old, geom, p)
    return float(torch.max(torch.abs(cn_residual(u_new, u_old, F, dt, geom, p))))


# -- PMA ---------------------------------------------------------------------------

def monitor_source(u, geom, p: Params):
    u_ksi, u_eta = grad_ksi_quirk(u, p)
    uxx, uyy = laplace(u, u_ksi, u_eta, geom, p)
    return torch.abs(uxx + uyy) ** 2


def smooth_pass(t):
    mon = torch.empty_like(t)
    mon[1:-1, 1:-1] = (t[1:-1, 1:-1]
                       + (t[:-2, 1:-1] + t[2:, 1:-1] + t[1:-1, :-2] + t[1:-1, 2:]) / 8.0
                       + (t[:-2, :-2] + t[:-2, 2:] + t[2:, :-2] + t[2:, 2:]) / 16.0)
    mon[1:-1, -1] = (4 * t[1:-1, -1] + 2 * t[:-2, -1] + 2 * t[2:, -1]
                     + 2 * t[1:-1, -2] + t[2:, -2] + t[:-2, -2]) / 12.0
    mon[1:-1, 0] = (4 * t[1:-1, 0] + 2 * t[:-2, 0] + 2 * t[2:, 0]
                    + 2 * t[1:-1, 1] + t[2:, 1] + t[:-2, 1]) / 12.0
    mon[-1, 1:-1] = (4 * t[-1, 1:-1] + 2 * t[-1, :-2] + 2 * t[-1, 2:]
                     + 2 * t[-2, 1:-1] + t[-2, 2:] + t[-2, :-2]) / 12.0
    mon[0, 1:-1] = (4 * t[0, 1:-1] + 2 * t[0, :-2] + 2 * t[0, 2:]
                    + 2 * t[1, 1:-1] + t[1, 2:] + t[1, :-2]) / 12.0
    mon[0, 0] = (4 * t[0, 0] + 2 * t[0, 1] + 2 * t[1, 0] + t[1, 1]) / 9.0
    mon[0, -1] = (4 * t[0, -1] + 2 * t[0, -2] + 2 * t[1, -1] + t[1, -2]) / 9.0
    mon[-1, 0] = (4 * t[-1, 0] + 2 * t[-1, 1] + 2 * t[-2, 0] + t[-2, 1]) / 9.0
    mon[-1, -1] = (4 * t[-1, -1] + 2 * t[-1, -2] + 2 * t[-2, -1] + t[-2, -2]) / 9.0
    return mon


def _dct_basis(n: int, dtype, device):
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    c = np.cos(np.pi * (2 * m + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    c[0] *= np.sqrt(0.5)
    return torch.as_tensor(c, device=device).to(dtype)


@contextlib.contextmanager
def full_float32():
    """Float32 products in full float32 inside; the process's own TF32
    settings are restored on the way out."""
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


class PMA:
    """The PMA sub-step ``dQ/dt = [alpha (I - gamma lap)]^-1 sqrt(mon |J|)``
    with its DCT bases and eigenvalues made once for a grid and dtype; its
    float32 products are full float32 unless ``tf32_operands`` asks."""

    def __init__(self, p: Params, dtype, device, tf32_operands: bool = False):
        self.p, self.dtype, self.tf32 = p, dtype, tf32_operands
        self.cy = _dct_basis(p.ny, dtype, device)
        self.cx = _dct_basis(p.nx, dtype, device)
        ey = 2.0 * np.cos(np.pi * np.arange(p.ny) / (p.ny - 1)) - 2.0
        ex = 2.0 * np.cos(np.pi * np.arange(p.nx) / (p.nx - 1)) - 2.0
        leig = (ey[:, None] + ex[None, :]) / (p.dx * p.dy)
        self.denom = torch.as_tensor(1.0 - p.gamma * leig, device=device).to(dtype)

    def dqdt(self, phi, u):
        p = self.p
        geom = geometry(phi, p)
        mon = monitor_source(u, geom, p)
        for _ in range(p.smoothing_iters):
            mon = smooth_pass(mon)
        jac = geom[5]
        mon = mon + p.mackenzie_c * (torch.sum(mon * torch.abs(jac)) * p.dx * p.dy)
        rhs = torch.sqrt(mon * torch.abs(jac)) / p.alpha
        t = self.tf32
        spec = _mm(_mm(self.cy, rhs, t), self.cx.T, t) / self.denom
        return _mm(_mm(self.cy.T, spec, t), self.cx, t)

    def loop(self, phi, u, dt: float, loops: int):
        """``loops`` explicit sub-steps in this object's dtype, the
        increment carried apart from ``phi`` and added to it in ``phi``'s
        dtype at the end."""
        q0 = phi.to(self.dtype)
        um = u.to(self.dtype)
        acc = torch.zeros_like(q0)
        with full_float32():
            for _ in range(loops):
                acc = acc + dt * self.dqdt(q0 + acc, um)
        return phi + acc.to(phi.dtype)


def pma_increment_error(phi_new, phi_old, u_old, dt: float, loops: int, pma: PMA) -> float:
    """``max|(phi_new - phi_old) - (phi_ref - phi_old)| / max|phi_ref - phi_old|``
    with ``phi_ref`` the sub-loop ``pma`` runs from ``(phi_old, u_old)``:
    in the configuration's mesh dtype (float32), whose rounding of the
    potential before its second differences sets the sub-loop's distance
    from a float64 one at fine grids (about 2e-3 at 1024^2)."""
    phi_old = phi_old.double()
    inc_ref = pma.loop(phi_old, u_old.double(), dt, loops) - phi_old
    inc = phi_new.double() - phi_old
    return float(torch.max(torch.abs(inc - inc_ref)) / torch.max(torch.abs(inc_ref)))


def min_jacobian(phi, p: Params) -> float:
    return float(torch.min(geometry(phi.double(), p)[5]))


# -- the benchmark's state preparation --------------------------------------------

def _softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def seeded_solution(geom, p: Params, drops):
    """The film ``epsilon + (1 - epsilon) sum H(G(r))`` of the drops
    ``(x, y, R, V)`` on the current mesh."""
    x, y = geom[0], geom[1]
    u = torch.full(x.shape, p.epsilon, dtype=x.dtype, device=x.device)
    for (x0, y0, R, V) in drops:
        r = torch.sqrt((x - x0) ** 2 + (y - y0) ** 2)
        g = R + (_softplus(-2.0 * p.a * (r + R)) - _softplus(-2.0 * p.a * (r - R))) / (2.0 * p.a)
        u = u + (1.0 - p.epsilon) * 4.0 * V * (1.0 - g * g / (R * R)) / (R * R)
    return u


def upsampled_deviation(p: Params) -> np.ndarray:
    """The 91x61 coalescence state's mesh potential, bicubic-interpolated
    onto ``p``'s grid, as its deviation from the identity blended to zero
    over a smooth frame of ``max(16, min(nx, ny)/16)`` cells."""
    from scipy.interpolate import RectBivariateSpline

    with np.load(DATA) as d:
        q = d["q"]
    ys = np.linspace(0.0, 1.0, q.shape[0])
    xs = np.linspace(0.0, 1.0, q.shape[1])
    q_up = RectBivariateSpline(ys, xs, q, kx=3, ky=3)(np.linspace(0.0, 1.0, p.ny),
                                                      np.linspace(0.0, 1.0, p.nx))
    xx = np.broadcast_to(np.linspace(p.xl, p.xr, p.nx)[None, :], (p.ny, p.nx))
    yy = np.broadcast_to(np.linspace(p.yb, p.yt, p.ny)[:, None], (p.ny, p.nx))
    dev = q_up - 0.5 * (xx ** 2 + yy ** 2)
    frame = np.concatenate([dev[0, :], dev[-1, :], dev[:, 0], dev[:, -1]])
    dev = dev - np.mean(frame)
    iy = np.arange(p.ny)[:, None].astype(np.float64)
    ix = np.arange(p.nx)[None, :].astype(np.float64)
    taper = max(16.0, min(p.nx, p.ny) / 16.0)

    def edge_w(d):
        w = np.clip(d / taper, 0.0, 1.0)
        return w * w * (3.0 - 2.0 * w)

    w = edge_w(iy) * edge_w(p.ny - 1 - iy) * edge_w(ix) * edge_w(p.nx - 1 - ix)
    return w * dev


def prepare(p: Params, drops, dtmesh: float, sweeps: int, sweep_loops: int, device):
    """The prepared ``(u, phi)`` in float64: the upsampled mesh, then
    ``sweeps`` rounds of seeding the drops on the current mesh and
    ``sweep_loops`` float32 PMA sub-steps, and the drops seeded once more."""
    phi = torch.as_tensor(upsampled_deviation(p), device=device)
    pma = PMA(p, torch.float32, device)
    for _ in range(sweeps):
        u = seeded_solution(geometry(phi, p), p, drops)
        phi = pma.loop(phi, u, dtmesh, sweep_loops)
    geom = geometry(phi, p)
    if not float(torch.min(geom[5])) > 0:
        raise RuntimeError("mesh tangled during preparation")
    return seeded_solution(geom, p, drops), phi
