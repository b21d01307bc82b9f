"""Adaptive variable-order BDF integrator (orders 1-3) with Newton–Krylov
stages (port of ``iterative_solvers_tpu/solvers/bdf.py``).

The replacement for the reference's ``solve_ivp(..., method="BDF")``
(PMA.py:68): a stiff implicit multistep method whose stage equations are
solved Jacobian-free.

- variable-step BDF of order 1-3 in Lagrange form: the interpolant through
  (t_new, y_new) and the last k history points has derivative
  f(t_new, y_new) at t_new, with the derivative weights computed for the
  actual step ratios;
- local error of the order-k corrector from the degree-k predictor
  difference, in the WRMS (rtol/atol) norm; accept/reject and the dt factor
  ``err^(-1/(k+1))``;
- order control: after an accepted step the next order is the one whose
  error allows the largest step, considered only after order+1
  consecutive accepted steps at the current order (scipy's equilibration
  rule);
- stage solves by :class:`.newton.NewtonKrylov` on the whole state (any
  shape: the LGMRES basis, norms and dots treat it as one vector).

The JAX ``lax.while_loop`` is one host loop here.  Its scalars (t, dt, the
step history and the Lagrange weights) are Python floats, so the step
control is the JAX f64 arithmetic; the fields stay on the device.  One
host read per step fetches the error norms of the live orders, besides
the Newton solver's own reads.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import resolve_device
from .newton import NewtonKrylov


class BDFResult(NamedTuple):
    y: torch.Tensor
    t: float
    steps: int               # accepted steps
    rejected: int            # rejected step attempts
    newton_failures: int
    dt_final: float
    success: bool


def _lagrange_weights_at(x0, xs):
    """Weights w_j with P(x0) = sum_j w_j y_j for the nodes ``xs``."""
    ws = []
    for j, xj in enumerate(xs):
        num = 1.0
        den = 1.0
        for m, xm in enumerate(xs):
            if m == j:
                continue
            num = num * (x0 - xm)
            den = den * (xj - xm)
        ws.append(num / den)
    return ws


def _lagrange_dweights_at_node(xs):
    """Weights g_j with P'(xs[0]) = sum_j g_j y_j (the derivative at the
    FIRST node, the BDF formula's new-time node)."""
    x0 = xs[0]
    gs = []
    # g_0 = sum_{m != 0} 1/(x0 - x_m)
    g0 = 0.0
    for m, xm in enumerate(xs):
        if m:
            g0 = g0 + 1.0 / (x0 - xm)
    gs.append(g0)
    for j in range(1, len(xs)):
        num = 1.0
        den = 1.0
        for m, xm in enumerate(xs):
            if m == j:
                continue
            if m:
                num = num * (x0 - xm)
            den = den * (xs[j] - xm)
        gs.append(num / den)
    return gs


def _floor_pow(err, k: int) -> float:
    """``max(err, 1e-16) ** (-1/(k+1))``, NaN propagating as in
    ``jnp.maximum``."""
    return float(np.maximum(np.float64(err), 1e-16) ** (-1.0 / (k + 1.0)))


@dataclasses.dataclass(frozen=True)
class BDF:
    rtol: float = 1e-3        # scipy solve_ivp defaults
    atol: float = 1e-6
    dt0: float = 1e-4
    dt_min: float = 1e-14
    dt_max: float = np.inf
    safety: float = 0.9
    max_order: int = 3
    max_steps: int = 100_000
    newton: NewtonKrylov = dataclasses.field(
        default_factory=lambda: NewtonKrylov(f_tol=1e-10, maxiter=12,
                                             inner_m=20, outer_k=5)
    )

    def _wrms(self, err, y):
        sc = self.atol + self.rtol * torch.abs(y)
        return torch.sqrt(torch.mean((err / sc) ** 2))

    def solve(self, f: Callable, y0, t0: float, t1: float,
              device="cuda") -> BDFResult:
        """Integrate ``dy/dt = f(t, y)`` from t0 to t1 on ``device``
        (default CUDA; raises if CUDA is absent and ``device="cpu"`` was not
        passed)."""
        y0 = torch.as_tensor(y0, device=resolve_device(device))
        t0, t1 = float(t0), float(t1)
        kmax = int(self.max_order)
        assert 1 <= kmax <= 3

        def stage_residual(k, y_new, hist, t_new, dt, dts):
            """Order-k BDF residual in y-scaled form; node offsets measured
            from t_new (x0 = 0)."""
            xs = [0.0, -dt]
            acc = dt
            for i in range(k - 1):
                acc = acc + dts[i]
                xs.append(-acc)
            gs = _lagrange_dweights_at_node(xs)
            r = y_new + sum((g / gs[0]) * h for g, h in zip(gs[1:], hist[:k]))
            return r - f(t_new, y_new) / gs[0]

        def predictor(k, hist, dt, dts):
            """Degree-k extrapolation to t_new through hist[0..k] (history
            node offsets from t_n: 0, -dt1, -(dt1+dt2), ...)."""
            offs = [0.0]
            acc = 0.0
            for i in range(k):
                acc = acc + dts[i]
                offs.append(-acc)
            ws = _lagrange_weights_at(dt, offs)
            return sum(w * h for w, h in zip(ws, hist[:k + 1]))

        t, dt = t0, float(self.dt0)
        hist = [y0] * (kmax + 1)
        dts = [dt] * kmax
        nhist, order, since = 1, 1, 0
        steps = rejected = nfail = 0
        done = False
        while not done and steps + rejected < self.max_steps:
            dt_eff = min(dt, t1 - t)
            t_new = t + dt_eff

            # predictors at every degree whose history is live; a degree
            # without one falls back to the degree below (the JAX where)
            preds = [hist[0]]
            for k in range(1, kmax + 1):
                preds.append(predictor(k, hist, dt_eff, dts)
                             if nhist >= k + 1 else preds[-1])

            res = self.newton.solve(
                partial(stage_residual, order, hist=hist, t_new=t_new,
                        dt=dt_eff, dts=dts), preds[order])
            y_new = res.x
            newton_ok = bool(res.converged)

            # same-order predictor differences ~ h^(k+1), usable only with
            # the full history for that degree
            live = [k for k in range(1, kmax + 1) if nhist >= k + 1]
            errs = [np.inf] + [0.5] * kmax
            if live:
                vals = torch.stack([self._wrms(y_new - preds[k], y_new)
                                    for k in live]).tolist()
                for k, e in zip(live, vals):
                    errs[k] = e
            err = errs[order]
            accept = newton_ok and err <= 1.0

            # per-order permissible dt factors; the next order maximises
            # the step.  The current order is always a candidate.
            factor_cur = self.safety * _floor_pow(err, order)
            may_switch = since + 1 >= order + 1
            best, bestf = order, factor_cur
            for k in range(1, kmax + 1):
                fk = self.safety * _floor_pow(errs[k], k)
                if nhist >= k + 1 and fk > bestf and may_switch:
                    best, bestf = k, fk
            order_out = best if accept else order
            since = since + 1 if accept and order_out == order else 0
            factor = float(np.clip(bestf if accept else factor_cur, 0.2, 5.0))
            dt_next = float(np.clip(dt_eff * factor if newton_ok
                                    else dt_eff * 0.25,
                                    self.dt_min, self.dt_max))

            if accept:
                hist = [y_new] + hist[:-1]
                dts = [dt_eff] + dts[:-1]
                nhist = min(nhist + 1, kmax + 2)
                t = t_new
            order = order_out
            dt = dt_next
            done = t >= t1 - 1e-300 or dt_next <= self.dt_min
            steps += int(accept)
            rejected += 1 - int(accept)
            nfail += 1 - int(newton_ok)

        return BDFResult(y=hist[0], t=t, steps=steps, rejected=rejected,
                         newton_failures=nfail, dt_final=dt,
                         success=t >= t1 - 1e-300)
