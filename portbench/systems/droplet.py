"""The thin-film droplet configuration under test: the program's
moving-mesh JFNK step (``models.droplet.make_step``: a CN/JFNK solve on the
frozen mesh with the ``droplet_jvp`` kernel in the inner Krylov, then
``pma_loops`` PMA sub-steps) from a state that the benchmark prepares in
its own plain code (``reference.droplet.prepare``) and hands to the
program.  The seed scales each drop's centre and radius by
``1 + seed_drop_jitter * U(-1, 1)``: every seed a problem of its own, each
with the same Newton iterations a step (``PERF.md`` gives the band that
was checked).  The checks recompute each sampled step's CN residual with
the plain reference in float64 and its PMA increment with the plain
reference's sub-loop in the configuration's mesh dtype."""
from __future__ import annotations

import importlib
import random
import time

import torch

from ..reference import droplet as ref


def jittered_drops(drops, amplitude: float, seed: int):
    """The drops ``(x, y, R, V)`` with each ``x`` and ``R`` scaled by
    ``1 + amplitude * U(-1, 1)`` drawn from the seed: radii and the
    centres' separation change by at most ``amplitude``."""
    rng = random.Random(seed)
    return [[x * (1.0 + amplitude * rng.uniform(-1.0, 1.0)), y,
             r * (1.0 + amplitude * rng.uniform(-1.0, 1.0)), v] for x, y, r, v in drops]


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, dev):
        self.dp = importlib.import_module("iterative_solvers_tpu_torch.models.droplet")
        newton = importlib.import_module("iterative_solvers_tpu_torch.solvers.newton")
        c = config
        self.config, self.dev, self.dt = c, dev, float(traffic["dt"])
        self.p = ref.Params.of(c)
        prep = c["preparation"]
        t0 = time.perf_counter()
        self.drops = jittered_drops(c["drops"], c["seed_drop_jitter"], seed)
        self.initial = ref.prepare(self.p, self.drops, c["dtmesh"], prep["sweeps"],
                                   prep["sweep_loops"], dev)
        self.own_s = time.perf_counter() - t0   # prepare ends on a host read
        keys = ("R", "a", "epsilon", "n_exp", "m_exp", "Bo", "incline", "nx", "ny", "xl",
                "xr", "yb", "yt", "alpha", "gamma", "mackenzie_c", "smoothing_iters",
                "spectral_dtype", "mesh_dtype")
        self.cfg = self.dp.DropletConfig(**{k: c[k] for k in keys})
        solver = newton.NewtonKrylov(**c["solver"])
        self._step = self.dp.make_step(self.cfg, dt=self.dt, dtmesh=c["dtmesh"],
                                       pma_loops=c["pma_loops"], solver=solver,
                                       deviation_form=c["deviation_form"],
                                       jvp_dtype=c["jvp_dtype"], jvp_kernel=c["jvp_kernel"],
                                       device=dev)
        self.spans = {"krylov": (newton, "_lgmres_cycle"), "pma": (self.dp, "loop_pma")}
        self.own = {"step_residual_max": "f_norm"}
        self.meta = {"points": c["nx"] * c["ny"]}
        self._ref_pma = None

    def step(self, state):
        u, phi = state
        out = self._step(u, phi, self.dt)
        return (out.u, out.q), {"converged": bool(out.converged),
                                "newton_iters": int(out.newton_iters),
                                "f_norm": float(out.f_norm)}

    def readings(self, sample) -> dict:
        """The numbers compared for one step ``(before, after)``."""
        (u, phi), (u_new, phi_new) = sample
        c = self.config
        if self._ref_pma is None:
            self._ref_pma = ref.PMA(self.p, getattr(torch, c["mesh_dtype"]), phi.device)
        return {"step_residual_max": ref.step_residual_max(u_new, u, phi, self.dt, self.p),
                "pma_increment_error": ref.pma_increment_error(
                    phi_new, phi, u, c["dtmesh"], c["pma_loops"], self._ref_pma),
                "min_jacobian": ref.min_jacobian(phi_new, self.p)}

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
            u, phi = state
            return self.step((u.float(), phi.float()))[0]

        def tf32_pma(state):
            u, phi = state
            pma = ref.PMA(self.p, torch.float32, phi.device, tf32_operands=True)
            return u, pma.loop(phi, u, c["dtmesh"], c["pma_loops"])

        return {"float32": (float32, None), "tf32_pma": (tf32_pma, ["pma_increment_error"])}

    def free(self):
        self._step = self.initial = None


def build(config: dict, traffic: dict, seed: int, dev) -> Cell:
    return Cell(config, traffic, seed, dev)
