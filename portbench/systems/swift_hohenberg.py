"""The Swift–Hohenberg configurations under test: the program's CN/JFNK
step (``make_cn_step`` with ``fast_solver``) and its linearised step
(``semi_implicit_step``, u_old lagging one step as ``evolve_semi_implicit``
does), each from a field drawn on the device from the seed.  A linearised
segment starts from (seeded field, seeded field): GMRES converges from the
seeded noise, so no CN steps are made first.  The checks
hold each sampled step to the configuration's stopping rule, recomputed by
the plain reference."""
from __future__ import annotations

import importlib

import torch

from ..reference import sh as ref


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, dev):
        self.sh = importlib.import_module("iterative_solvers_tpu_torch.models.swift_hohenberg")
        newton = importlib.import_module("iterative_solvers_tpu_torch.solvers.newton")
        c = config
        n = c["n"]
        self.cfg = self.sh.SHConfig(n=n, d=c["d"], k=c["k"], r=c["r"], g=c["g"])
        self.params = {"h": c["d"] / n, "k": c["k"], "r": c["r"], "g": c["g"]}
        self.config, self.stepper, self.dev = c, traffic["stepper"], dev
        gen = torch.Generator(device=dev).manual_seed(seed % 2 ** 63)
        u0 = torch.randn((n, n), generator=gen, dtype=getattr(torch, c["state_dtype"]),
                         device=dev)
        self.meta = {"points": n * n}
        self.own_s, self.own = 0.0, {}
        if self.stepper == "cn":
            s = c["cn_solver"]
            solver = self.sh.fast_solver(self.cfg, f_tol=s["f_tol"], inner_m=s["inner_m"],
                                         outer_k=s["outer_k"])
            self._cn = self.sh.make_cn_step(self.cfg, solver, device=dev)
            self.initial = u0
            self.spans = {"krylov": (newton, "_lgmres_cycle")}
            self.own = {"cn_residual_max": "f_norm"}
        elif self.stepper == "semi":
            self.initial = (u0, u0)
            self.spans = {"krylov": (self.sh, "gmres")}
        else:
            raise ValueError(f"unknown Swift-Hohenberg stepper {self.stepper!r}")

    def step(self, state):
        if self.stepper == "cn":
            u, res = self._cn(state)
            return u, {"converged": bool(res.converged), "newton_iters": int(res.iters),
                       "f_norm": float(res.f_norm)}
        u, u_old = state
        s = self.config["semi_solver"]
        u_new, res = self.sh.semi_implicit_step(u, u_old, self.cfg, tol=s["tol"],
                                                restart=s["restart"], maxiter=s["maxiter"],
                                                device=self.dev)
        return (u_new, u), {"converged": bool(res.converged), "krylov_iters": int(res.iters)}

    def readings(self, sample) -> dict:
        """The numbers compared for one step ``(before, after)``."""
        before, after = sample
        if self.stepper == "cn":
            return {"cn_residual_max": ref.cn_residual_max(after, before, self.params)}
        (u, u_old), (u_new, _) = before, after
        return {"semi_residual_rel": ref.semi_residual_rel(u_new, u, u_old, self.params)}

    def limits(self) -> dict:
        """``{name: (limit, rule)}``: a reading passes when ``reading rule limit``."""
        if self.stepper == "cn":
            return {"cn_residual_max": (self.config["cn_solver"]["f_tol"], "<=")}
        return {"semi_residual_rel": (self.config["semi_solver"]["tol"], "<=")}

    def controls(self) -> dict:
        """``{name: (step, readings)}``: the nearest precision below the
        configuration's, the program's own step on a float32 state
        (float32 outer residuals for CN, float32 GMRES for the linearised
        step); ``readings`` None: it stands for every number."""
        def float32(state):
            if self.stepper == "cn":
                return self.step(state.float())[0]
            u, u_old = state
            return self.step((u.float(), u_old.float()))[0]
        return {"float32": (float32, None)}

    def free(self):
        self._cn = self.initial = None


def build(config: dict, traffic: dict, seed: int, dev) -> Cell:
    return Cell(config, traffic, seed, dev)
