"""The MEMS touchdown configuration under test: the program's operator-split
step (``models.mems.make_step``: the mesh geometry, the adaptive
``dt = k min (1+u)^3`` read on the host, the monitor and the spectral PMA
solve, then the CN residual solved by the default float64 JFNK, Newton with
finite-difference matvecs inside LGMRES, and the explicit mesh update) from
the published run's state near touchdown, ``data/mems51_touchdown.npz``
(made once by ``tools/make_mems51_state.py``).  Every segment restarts
from that state; the state carries ``(u, q, dt)``, ``dt`` that of the step
that made it.  The seed adds a perturbation of ``seed_amplitude`` to ``u``
(:func:`seeded_perturbation`).  The checks hold each sampled step's CN
residual, its dt, its mesh increment and its new mesh to the plain
reference in float64."""
from __future__ import annotations

import dataclasses
import importlib
import math
import pathlib

import numpy as np
import torch

from ..reference import mems as ref

DATA = pathlib.Path(__file__).resolve().parents[1] / "data" / "mems51_touchdown.npz"
MODES = 4


def seeded_perturbation(n: int, amplitude: float, seed: int, dtype, dev):
    """``amplitude * sum_jk sigma_kj sin(j pi (xi+1)/2) sin(k pi (eta+1)/2) / 16``
    over j, k <= 4 on the n x n grid of ``[-1, 1]^2``, each sign
    ``sigma_kj = +-1`` drawn on the device from the seed; zero on the
    boundary, ``|.| <= amplitude``.  Every seed is a problem of its own, and
    at the configured amplitude each does the same solver work (``PERF.md``
    gives the seeds that were checked)."""
    gen = torch.Generator(device=dev).manual_seed(seed % 2 ** 63)
    sign = 2.0 * torch.randint(0, 2, (MODES, MODES), generator=gen, device=dev).to(dtype) - 1.0
    j = torch.arange(1, MODES + 1, device=dev).to(dtype)
    xi = torch.as_tensor(np.linspace(-1.0, 1.0, n), device=dev).to(dtype)
    modes = torch.sin(math.pi * j[:, None] * (xi[None, :] + 1.0) / 2.0)
    s = amplitude * (modes.T @ sign @ modes) / MODES ** 2
    s[0, :] = s[-1, :] = s[:, 0] = s[:, -1] = 0.0
    return s


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, dev):
        mems = importlib.import_module("iterative_solvers_tpu_torch.models.mems")
        newton = importlib.import_module("iterative_solvers_tpu_torch.solvers.newton")
        if traffic["stepper"] != "touchdown":
            raise ValueError(f"unknown MEMS stepper {traffic['stepper']!r}")
        c = config
        self.config, self.p = c, ref.Params.of(c)
        dtype = getattr(torch, c["state_dtype"])
        with np.load(DATA) as d:
            u, q = (torch.as_tensor(d[k], device=dev).to(dtype) for k in ("u", "q"))
            self.meta = {"state_step": int(d["step"]), "state_t": float(d["t"])}
        u = u + seeded_perturbation(c["n"], c["seed_amplitude"], seed, dtype, dev)
        self.meta["u_min"] = float(u.min())
        self.initial = (u, q, None)
        cfg = mems.MEMSConfig(**dataclasses.asdict(self.p))
        self._step = mems.make_step(cfg, newton.NewtonKrylov(**c["solver"]), device=dev)
        self.spans, self.own, self.own_s = {}, {}, 0.0

    def step(self, state):
        u, q, _ = state
        out = self._step(u, q)
        return (out.u, out.q, out.dt), {"converged": bool(out.converged),
                                        "newton_iters": int(out.newton_iters),
                                        "dt": out.dt}

    def readings(self, sample) -> dict:
        """The numbers compared for one step ``(before, after)``."""
        (u, q, _), (u_new, q_new, dt) = sample
        p = self.p
        self.meta["min_spacing"] = ref.min_spacing(q_new, p)
        return {"step_residual_max": ref.step_residual_max(u_new, u, q, dt, p),
                "dt_rel_error": ref.dt_rel_error(dt, u, p),
                "mesh_update_error": ref.mesh_update_error(q_new, q, u, dt, p),
                "min_jacobian": ref.min_jacobian(q_new, p)}

    def limits(self) -> dict:
        """``{name: (limit, rule)}``: a reading passes when ``reading rule limit``."""
        lim = self.config["limits"]
        return {"step_residual_max": (self.config["solver"]["f_tol"], "<="),
                "dt_rel_error": (lim["dt_rel_error"], "<="),
                "mesh_update_error": (lim["mesh_update_error"], "<="),
                "min_jacobian": (0.0, ">")}

    def controls(self) -> dict:
        """``{name: (step, readings)}``: the nearest precision below the
        configuration's float64, a float32 state: the program's own step from
        ``u`` and ``q`` rounded to float32; ``readings`` None: it stands for
        every number.  (The step computed in float32 does not run here: its
        finite-difference products round to zero, and LGMRES stops on a
        singular Hessenberg matrix at its first column.)"""
        def float32(state):
            u, q, _ = state
            return self.step((u.float().to(u.dtype), q.float().to(q.dtype), None))[0]
        return {"float32": (float32, None)}

    def free(self):
        self._step = self.initial = None


def build(config: dict, traffic: dict, seed: int, dev) -> Cell:
    return Cell(config, traffic, seed, dev)
