"""Solver-level failure detection and recovery
(port of ``iterative_solvers_tpu/solvers/adaptive.py``).

- :func:`step_with_backoff` — run an implicit step; on Newton divergence or
  a non-finite state, halve dt and retry (bounded), else accept and let dt
  grow.  The retry loop is a host loop with the JAX ``while_loop``'s
  condition and order of decisions: one host read of ``converged`` and of
  the finiteness check per attempt.
- :func:`check_finite` — NaN/Inf detection on a state.

``dt`` is carried as a numpy scalar of the state's dtype, as the JAX loop
carries it as an array of that dtype, so an f32 state backs off in f32.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import resolve_device
from .gmres import _np_dtype


class AdaptiveStepResult(NamedTuple):
    u: torch.Tensor
    dt_used: np.floating
    dt_next: np.floating
    attempts: int
    ok: bool


def check_finite(u) -> torch.Tensor:
    """``all(isfinite(u))`` as a 0-d bool tensor on ``u``'s device."""
    return torch.all(torch.isfinite(u))


def step_with_backoff(step_fn: Callable, u, dt, *, max_retries: int = 6,
                      backoff: float = 0.5, growth: float = 1.5,
                      dt_min: float = 0.0, device="cuda") -> AdaptiveStepResult:
    """``step_fn(u, dt) -> (u_new, converged)``; retry with a smaller dt on
    failure.  Returns the accepted state and the dt to try next step; if
    every attempt fails (or none is allowed) the state is ``u`` unchanged.
    ``u`` is moved to ``device`` (default CUDA; raises if CUDA is absent and
    ``device="cpu"`` was not passed)."""
    u = torch.as_tensor(u, device=resolve_device(device))
    ndt = _np_dtype(u.dtype)
    u_new = torch.full_like(u, float("nan"))
    dt_try, attempts, ok = ndt.type(dt), 0, False
    while not ok and attempts < max_retries and dt_try > dt_min:
        dt_try = dt_try * ndt.type(backoff if attempts > 0 else 1.0)
        u_new, converged = step_fn(u, dt_try)
        ok = bool(converged) and bool(check_finite(u_new))
        attempts += 1
    dt_next = dt_try * ndt.type(growth) if ok else dt_try
    return AdaptiveStepResult(u=u_new if ok else u, dt_used=dt_try,
                              dt_next=dt_next, attempts=attempts, ok=ok)


def evolve_with_backoff(step_fn: Callable, u0, dt0, nsteps: int,
                        device="cuda", **kw):
    """Drive ``nsteps`` accepted or rejected steps of the backoff stepper;
    returns the final state, the next dt and the per-step ``(dt_used,
    attempts, ok)`` as numpy arrays."""
    dev = resolve_device(device)
    u = torch.as_tensor(u0, device=dev)
    dt = _np_dtype(u.dtype).type(dt0)
    dts, attempts, oks = [], [], []
    for _ in range(nsteps):
        out = step_with_backoff(step_fn, u, dt, device=dev, **kw)
        u, dt = out.u, out.dt_next
        dts.append(out.dt_used)
        attempts.append(out.attempts)
        oks.append(out.ok)
    return u, dt, (np.asarray(dts, dtype=_np_dtype(u.dtype)),
                   np.asarray(attempts, dtype=np.int32), np.asarray(oks))
