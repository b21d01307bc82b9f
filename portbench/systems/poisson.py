"""The Poisson duct-flow configuration under test: the program's
unpreconditioned CG (``solvers.cg.cg``) on the assembled 5-point Dirichlet
Laplacian (``ops.sparse.laplacian_5pt_dirichlet`` as a ``GridDIA``), its
matvec ``ops.spmv.grid_dia_matvec``.  A step is one whole solve from
x0 = 0 of ``lap u = b``; the state carries ``(b, x)``.  The forcing is
drawn on the device from the seed (:func:`seeded_forcing`).  The checks
hold each sampled solve's residual to the configuration's tolerance and
its field to the exact discrete solution, both by the plain reference."""
from __future__ import annotations

import importlib
import math

import torch

from ..reference import poisson as ref

MODES = 4


def seeded_forcing(n: int, amplitude: float, seed: int, dtype, dev):
    """``-(1 + amplitude s)`` on the (n - 1)^2 interior nodes, with
    ``s = sum_jk sigma_jk sin(j pi x) sin(k pi y) / 12`` over the 12 modes
    j, k <= 4 in which j or k is even, each sign ``sigma_jk = +-1`` drawn
    on the device from the seed, so ``|s| <= 1``.  Every seed is a problem
    of its own with the same work: the constant forcing holds only modes
    with j and k odd, so the squared weight of every eigenmode in ``b``,
    and with it CG's iteration count, is the same for every seed (weights
    drawn N(0, 1) moved the count by 4.6% from seed to seed)."""
    gen = torch.Generator(device=dev).manual_seed(seed % 2 ** 63)
    sign = 2.0 * torch.randint(0, 2, (MODES, MODES), generator=gen, device=dev).to(dtype) - 1.0
    j = torch.arange(1, MODES + 1, device=dev)
    even = (j[:, None] % 2 == 0) | (j[None, :] % 2 == 0)
    x = torch.arange(1, n, dtype=dtype, device=dev) / n
    modes = torch.sin(math.pi * j[:, None].to(dtype) * x[None, :])
    s = modes.T @ (sign * even) @ modes / int(even.sum())
    return -(1.0 + amplitude * s)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, dev):
        sparse = importlib.import_module("iterative_solvers_tpu_torch.ops.sparse")
        self.spmv = importlib.import_module("iterative_solvers_tpu_torch.ops.spmv")
        self.cg = importlib.import_module("iterative_solvers_tpu_torch.solvers.cg")
        c = config
        if traffic["stepper"] != "cg_dia":
            raise ValueError(f"unknown Poisson stepper {traffic['stepper']!r}")
        n, m = c["n"], c["n"] - 1
        self.config, self.n, self.h = c, n, 1.0 / n
        dtype = getattr(torch, c["state_dtype"])
        self.a = sparse.GridDIA.from_scipy(sparse.laplacian_5pt_dirichlet(n, self.h),
                                           grid=(m, m), device=dev)
        b = seeded_forcing(n, c["forcing_amplitude"], seed, dtype, dev)
        self.bnorm = float(torch.linalg.vector_norm(b))
        self.initial = (b, torch.zeros_like(b))
        self.spans, self.own_s = {}, 0.0
        self.own = {"cg_residual_rel": "resnorm_rel"}
        self.meta = {"grid": [m, m], "shifts": [list(s) for s in self.a.shifts],
                     "itemsize": b.element_size()}

    def solve(self, a, b):
        s = self.config["solver"]
        return self.cg.cg(lambda v: self.spmv.grid_dia_matvec(a, v), b, tol=s["tol"],
                          maxiter=s["maxiter_per_interval"] * self.n)

    def step(self, state):
        b, _ = state
        res = self.solve(self.a, b)
        return (b, res.x), {"converged": bool(res.converged), "krylov_iters": int(res.iters),
                            "resnorm_rel": res.resnorm / self.bnorm}

    def readings(self, sample) -> dict:
        """The numbers compared for one solve ``(before, after)``."""
        (b, _), (_, x) = sample
        exact = ref.solve_exact(b, self.n)
        self.meta.update(flow_rate=ref.flow_rate(x, self.h),
                         flow_rate_exact=ref.flow_rate(exact, self.h))
        return {"cg_residual_rel": ref.residual_rel(x, b, self.h),
                "field_error_rel": ref.field_error_rel(x, exact)}

    def limits(self) -> dict:
        """``{name: (limit, rule)}``: a reading passes when ``reading rule limit``."""
        return {"cg_residual_rel": (self.config["solver"]["tol"], "<="),
                "field_error_rel": (self.config["limits"]["field_error_rel"], "<=")}

    def controls(self) -> dict:
        """``{name: (step, readings)}``: the nearest precision below the
        configuration's float64, the program's own solve on a float32
        operator and forcing; ``readings`` None: it stands for every
        number."""
        def float32(state):
            b, _ = state
            a32 = self.a._replace(data=self.a.data.float())
            return b, self.solve(a32, b.float()).x
        return {"float32": (float32, None)}

    def free(self):
        self.a = self.initial = None


def build(config: dict, traffic: dict, seed: int, dev) -> Cell:
    return Cell(config, traffic, seed, dev)
