"""Distributed solver drivers: the sharded Swift–Hohenberg Newton–Krylov
step (port of ``iterative_solvers_tpu/dist/solvers.py``).

The JAX package runs its shape-agnostic solvers on block-sharded global
arrays and leaves the all-reduces and collective-permutes to GSPMD.  Here a
rank holds only its block, so the solver is given the mesh's reduction
group (``NewtonKrylov.group``: every norm, inner product and max-norm
summed over the ranks) and the residual's operator is one of:

- ``explicit_halos=True``: :func:`..dist.halo.sharded_sh_operator`, one
  width-2 halo exchange an application;
- ``explicit_halos=False``: GSPMD's implicit path written out — all-gather
  the field, apply the single-device ``apply_L``, keep the block.

Both give the same step; the tests hold them against each other.
"""
from __future__ import annotations

import dataclasses
from functools import partial

from ..models import swift_hohenberg as sh
from ..models.swift_hohenberg import SHConfig
from ..solvers.newton import NewtonKrylov
from .halo import gather_field, grid_sharding, sharded_sh_operator
from .mesh import mesh_group


def make_sharded_sh_step(cfg: SHConfig, mesh,
                         axis_names: tuple[str, str] = ("y", "x"),
                         solver: NewtonKrylov | None = None,
                         explicit_halos: bool = True):
    """Distributed SH Crank–Nicolson JFNK step on the rank's block:
    ``step(u_old_block) -> (u_block, NewtonResult)``.

    The analytic Jacobian of :func:`..models.swift_hohenberg.fast_solver`
    is rebound to the sharded operator; another ``matvec_factory`` cannot
    know the sharding and raises.
    """
    if solver is None:
        solver = NewtonKrylov()
    sharding = grid_sharding(mesh, axis_names)

    if explicit_halos:
        def apply_L(v):
            return sharded_sh_operator(v, cfg.h, cfg.r, mesh, axis_names)
    else:
        def apply_L(v):
            full = gather_field(v, mesh, axis_names)
            return sh.apply_L(full, cfg)[sharding.index(full.shape)]

    factory = solver.matvec_factory
    if isinstance(factory, sh.JacobianMatvec):
        factory = dataclasses.replace(factory, apply=apply_L)
    elif factory is not None:
        raise ValueError("make_sharded_sh_step: a matvec_factory other than "
                         "the SH JacobianMatvec does not know the sharded operator")
    solver = dataclasses.replace(solver, matvec_factory=factory,
                                 group=mesh_group(mesh, axis_names))

    def residual(u, u_old, l_uold, uo2, uo3):
        uu = u * u
        return (u - u_old) / cfg.k - (
            apply_L(u) + cfg.g * uu - u * uu + l_uold + cfg.g * uo2 - uo3
        ) / 2.0

    def step(u_old):
        l_uold = apply_L(u_old)
        uo2 = u_old * u_old
        uo3 = u_old * uo2
        res = solver.solve(
            partial(residual, u_old=u_old, l_uold=l_uold, uo2=uo2, uo3=uo3),
            u_old,
        )
        return res.x, res

    return step
