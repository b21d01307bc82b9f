"""The published droplet coalescence step under test: the program's
moving-mesh JFNK step (``models.droplet.make_step`` in the full form, the
mesh potential Q itself: a CN/JFNK solve on the frozen mesh, float32
LGMRES over float64 finite-difference matvecs of the CN residual, then
``pma_loops`` explicit PMA sub-steps of the eager chain in float32) from
the reference's own 91x61 coalescence state, ``data/coalescence_91x61.npz``.
Every segment restarts from that state; the state carries ``(u, q)``.
The seed scales the film by ``1 + seed_amplitude * s``
(:func:`seeded_factor`).  The checks hold each sampled step's CN residual
to the plain reference in float64, its PMA increment to the plain
sub-loop in the configuration's mesh dtype and its new mesh's Jacobian."""
from __future__ import annotations

import importlib
import math
import pathlib

import numpy as np
import torch

from ..reference import droplet as plain
from ..reference import droplet_full as ref

DATA = pathlib.Path(__file__).resolve().parents[1] / "data" / "coalescence_91x61.npz"
MODES = 4
KEYS = ("R", "a", "epsilon", "n_exp", "m_exp", "Bo", "incline", "nx", "ny", "xl", "xr", "yb",
        "yt", "alpha", "gamma", "mackenzie_c", "smoothing_iters", "spectral_dtype",
        "mesh_dtype")


def seeded_factor(ny: int, nx: int, amplitude: float, seed: int, dtype, dev):
    """``1 + amplitude * s``, ``s = sum_jk sigma_kj sin(j pi i/(nx-1))
    sin(k pi l/(ny-1)) / 16`` over j, k <= 4 on the ny x nx grid, each sign
    ``sigma_kj = +-1`` drawn on the device from the seed: 1 on the boundary,
    ``|s| <= 1``.  Every seed is a problem of its own, and at the configured
    amplitude each does the same solver work (``PERF.md`` gives the seeds
    that were checked)."""
    gen = torch.Generator(device=dev).manual_seed(seed % 2 ** 63)
    sign = 2.0 * torch.randint(0, 2, (MODES, MODES), generator=gen, device=dev).to(dtype) - 1.0
    j = torch.arange(1, MODES + 1, device=dev).to(dtype)

    def modes(n):
        t = torch.as_tensor(np.linspace(0.0, 1.0, n), device=dev).to(dtype)
        return torch.sin(math.pi * j[:, None] * t[None, :])

    s = (modes(ny).T @ sign @ modes(nx)) / MODES ** 2
    s[0, :] = s[-1, :] = s[:, 0] = s[:, -1] = 0.0
    return 1.0 + amplitude * s


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, dev):
        dp = importlib.import_module("iterative_solvers_tpu_torch.models.droplet")
        newton = importlib.import_module("iterative_solvers_tpu_torch.solvers.newton")
        if traffic["stepper"] != "step":
            raise ValueError(f"unknown droplet stepper {traffic['stepper']!r}")
        c = config
        self.config, self.dt = c, float(traffic["dt"])
        self.p = plain.Params.of(c)
        dtype = getattr(torch, c["state_dtype"])
        with np.load(DATA) as d:
            u, q = (torch.as_tensor(d[k], device=dev).to(dtype) for k in ("u", "q"))
        u = u * seeded_factor(c["ny"], c["nx"], c["seed_amplitude"], seed, dtype, dev)
        self.initial = (u, q)
        cfg = dp.DropletConfig(**{k: c[k] for k in KEYS})
        self._step = dp.make_step(cfg, dt=self.dt, dtmesh=c["dtmesh"], pma_loops=c["pma_loops"],
                                  solver=newton.NewtonKrylov(**c["solver"]),
                                  deviation_form=c["deviation_form"], device=dev)
        self.spans, self.own, self.own_s = {}, {"step_residual_max": "f_norm"}, 0.0
        self.meta = {"points": c["nx"] * c["ny"]}
        self._ref_pma = None

    def step(self, state):
        u, q = state
        out = self._step(u, q, self.dt)
        return (out.u, out.q), {"converged": bool(out.converged),
                                "newton_iters": int(out.newton_iters),
                                "f_norm": float(out.f_norm)}

    def readings(self, sample) -> dict:
        """The numbers compared for one step ``(before, after)``."""
        (u, q), (u_new, q_new) = sample
        c = self.config
        if self._ref_pma is None:
            self._ref_pma = ref.PMA(self.p, getattr(torch, c["mesh_dtype"]), q.device)
        return {"step_residual_max": ref.step_residual_max(u_new, u, q, self.dt, self.p),
                "pma_increment_error": plain.pma_increment_error(
                    q_new, q, u, c["dtmesh"], c["pma_loops"], self._ref_pma),
                "min_jacobian": ref.min_jacobian(q_new, self.p)}

    def limits(self) -> dict:
        """``{name: (limit, rule)}``: a reading passes when ``reading rule limit``."""
        return {"step_residual_max": (self.config["solver"]["f_tol"], "<="),
                "pma_increment_error": (self.config["limits"]["pma_increment_error"], "<="),
                "min_jacobian": (0.0, ">")}

    def controls(self) -> dict:
        """``{name: (step, readings)}``: the nearest precisions below the
        configuration's.  ``float32``: the program's own step on a float32
        state (float32 outer residuals and mesh potential; every number).
        ``tf32_pma``: the reference's float32 PMA sub-loop, with the DCT
        matmuls' operands rounded to TF32, in the place of the program's
        (the configuration keeps TF32 off; the PMA number only)."""
        c = self.config

        def float32(state):
            u, q = state
            return self.step((u.float(), q.float()))[0]

        def tf32_pma(state):
            u, q = state
            pma = ref.PMA(self.p, torch.float32, q.device, tf32_operands=True)
            return u, pma.loop(q, u, c["dtmesh"], c["pma_loops"])

        return {"float32": (float32, None), "tf32_pma": (tf32_pma, ["pma_increment_error"])}

    def free(self):
        self._step = self.initial = None


def build(config: dict, traffic: dict, seed: int, dev) -> Cell:
    return Cell(config, traffic, seed, dev)
