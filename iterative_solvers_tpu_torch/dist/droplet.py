"""Explicit-halo distributed droplet step (port of
``iterative_solvers_tpu/dist/droplet.py``).

Shards the droplet workload — the curvilinear CN residual, the
monitor/smoothing chain and the PMA mesh solve — over the ranks of a
device mesh, rows only or in 2-D blocks:

- every operator chain is the single-device body lifted with
  :func:`.halo.sharded_y_chain` / :func:`.halo.sharded_xy_chain`: one halo
  exchange per input field per evaluation, and the one-sided boundary
  rows re-evaluated exactly on the global edge ranks;
- Newton and Krylov reduce over the mesh's group (``NewtonKrylov.group``),
  the Mackenzie integral with one all-reduce;
- the PMA mesh solve is ``"spectral"`` (all-gather the monitor and the
  Jacobian, run ``solve_pma`` on the whole grid, keep the block: what GSPMD
  does with the JAX package's DCT matmuls) or ``"chebyshev"`` / ``"cg"``
  (``meshmove.pma.solve_shifted_neumann`` on the width-1 halo-lifted
  Laplacian, CG's dots reduced over the group).

State is carried as the *deviation* potential phi (Q = identity + phi,
``ops.curvilinear.mesh_geometry_dev``), the f32-robust large-grid form.

``jvp_dtype="float32"``: the JAX package differentiates ``jax.jvp``
straight through its halo exchanges.  ``torch.func.jvp`` does not go
through a collective, so the JVP is lifted instead: the halo exchange and
the edge-strip patching are linear, so the JVP of the lifted residual is
the lifted JVP of the local chain — the tangent's halo is exchanged like
any other input and ``torch.func.jvp`` runs on the unmodified chain over
the extended primal and tangent blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..meshmove import pma
from ..meshmove.monitor import smooth_pass
from ..models import droplet as dp
from ..ops import curvilinear, stencils
from ..solvers.newton import NewtonKrylov
from .comm import all_reduce
from .halo import (GridSharding, gather_field, sharded_xy_chain,
                   sharded_y_chain)
from .mesh import axis_size, mesh_group

# Influence depth of the deepest chain (residual/pde_rhs): phi reaches the
# output through geometry (radius 2) -> laplace metric terms (radius 3) ->
# pressure gradient (radius 2) -> flux divergence (radius 2) = 9; one-sided
# edge formulas at rows <= 2 spread the same way.  12 adds a margin — the
# sharded == single-device tests would catch an underestimate.
DEPTH_RESIDUAL = 12
DEPTH_MONITOR = 12   # monitor_source (<= 8) + 4 smoothing passes
DEPTH_GEOM = 4       # geometry derivatives (radius 2, specials depth 2)


class ShardedDropletOps(NamedTuple):
    """Distributed operators on the rank's blocks of the global fields."""

    residual: Callable        # (u, u_old, F, phi, dt) -> r
    pde_rhs: Callable         # (u, phi) -> F
    monitor: Callable         # (u, phi) -> (smoothed mon, jac)
    pma_dqdt: Callable        # (phi, u) -> dphi/dt
    loop_pma: Callable        # (phi, u, dtmesh, loops) -> phi
    step: Callable            # (u, phi, dt, dtmesh, pma_loops) -> result
    sharding: GridSharding


def make_sharded_ops(cfg: "dp.DropletConfig", mesh,
                     axis_name: str = "y",
                     pma_solver: str = "spectral",
                     solver: NewtonKrylov | None = None,
                     x_axis_name: str | None = None,
                     jvp_dtype: str | None = None) -> ShardedDropletOps:
    """Build the explicit-halo distributed droplet operators.

    ``pma_solver``: "spectral" or "chebyshev" / "cg" (see the module
    docstring).  ``x_axis_name``: a second (column) mesh axis for 2-D block
    decomposition; rows-only when omitted or when the mesh's axis has one
    rank.  ``jvp_dtype="float32"``: the Newton matvec is the exact JVP of
    the f32-cast sharded residual and the LGMRES cycle runs in f32, while
    outer residuals, line search and convergence checks stay at the state
    dtype (``models.droplet.make_step``'s fast path, distributed).
    """
    if pma_solver not in ("spectral", "chebyshev", "cg"):
        raise ValueError(f"pma_solver must be 'spectral', 'chebyshev' or 'cg', "
                         f"got {pma_solver!r}")
    grid = cfg.grid
    two_d = (x_axis_name is not None
             and x_axis_name in mesh.mesh_dim_names
             and axis_size(mesh, x_axis_name) > 1)
    spec = (axis_name, x_axis_name) if two_d else (axis_name, None)
    sharding = GridSharding(mesh, spec)
    group = mesh_group(mesh, spec[:2] if two_d else (axis_name,))

    def _lift(chain, depth):
        if two_d:
            return sharded_xy_chain(chain, depth, mesh, (axis_name, x_axis_name))
        return sharded_y_chain(chain, depth, mesh, axis_name)

    def _coords(ref):
        # the rank's blocks of the coordinate fields, exchanged with the
        # other inputs as the JAX package's chains take them
        idx = sharding.index(grid.shape)
        return (grid.xx_op(ref.dtype, ref.device)[idx],
                grid.yy_op(ref.dtype, ref.device)[idx])

    def _geom(phi, xxb, yyb):
        return curvilinear.mesh_geometry_dev(phi, grid, coords=(xxb, yyb))

    # -- residual / rhs chains (single-device bodies, reused verbatim) ------
    def _residual_chain(dt, u, u_old, F, phi, xxb, yyb):
        geom = _geom(phi, xxb, yyb)
        u_ksi = stencils.d1_x(u, grid.dx)
        u_eta = stencils.d1_y(u, grid.dy)
        u_xx, u_yy = curvilinear.laplace(u, u_ksi, u_eta, geom, grid)
        p = dp.pressure(u, u_xx, u_yy, cfg)
        p_dx, p_dy = dp.pressure_grad_xy(p, geom, grid)
        F2 = dp._flux_divergence(p_dx, p_dy, u, geom, grid, cfg)
        return (u - u_old) - dt * (F2 + F) / 2.0

    def residual(u, u_old, F, phi, dt):
        body = _lift(lambda *b: _residual_chain(dt, *b), DEPTH_RESIDUAL)
        return body(u, u_old, F, phi, *_coords(phi))

    def residual_jvp(u, v, u_old, F, phi, dt):
        """``d residual(u) [v]`` on the blocks, by the lifted JVP."""
        def chain(ue, ve, *rest):
            return torch.func.jvp(lambda w: _residual_chain(dt, w, *rest),
                                  (ue,), (ve,))[1]
        return _lift(chain, DEPTH_RESIDUAL)(u, v, u_old, F, phi, *_coords(phi))

    def _pde_rhs_chain(u, phi, xxb, yyb):
        geom = _geom(phi, xxb, yyb)
        u_ksi, u_eta = curvilinear.grad_ksi_neumann(u, grid, quirk=True)
        u_xx, u_yy = curvilinear.laplace(u, u_ksi, u_eta, geom, grid)
        p = dp.pressure(u, u_xx, u_yy, cfg)
        p_dx, p_dy = dp.pressure_grad_xy(p, geom, grid)
        return dp._flux_divergence(p_dx, p_dy, u, geom, grid, cfg)

    def pde_rhs(u, phi):
        return _lift(_pde_rhs_chain, DEPTH_RESIDUAL)(u, phi, *_coords(phi))

    # -- monitor chain + Mackenzie (one all-reduce) ---------------------------
    def _monitor_chain(u, phi, xxb, yyb):
        geom = _geom(phi, xxb, yyb)
        mon = dp.monitor_source(u, geom, grid)
        for _ in range(cfg.pma.smoothing_iters):
            mon = smooth_pass(mon)
        return mon

    def _jac_chain(phi, xxb, yyb):
        return _geom(phi, xxb, yyb).jac

    def monitor(u, phi):
        xx, yy = _coords(phi)
        mon = _lift(_monitor_chain, DEPTH_MONITOR)(u, phi, xx, yy)
        jac = _lift(_jac_chain, DEPTH_GEOM)(phi, xx, yy)
        integral = all_reduce(torch.sum(mon * torch.abs(jac)), group) * grid.dx * grid.dy
        floor = cfg.pma.mackenzie_c * integral
        if cfg.pma.monitor_cap is not None:
            mon = torch.minimum(mon, cfg.pma.monitor_cap * floor)
        return mon + floor, jac

    # -- PMA mesh solve ------------------------------------------------------
    sharded_lap = _lift(lambda v: pma.neumann_laplacian(v, grid), 1)
    gather_axes = spec if two_d else (axis_name,)

    def pma_dqdt(phi, u):
        mon, jac = monitor(u, phi)
        if pma_solver == "spectral":
            mon_g = gather_field(mon, mesh, gather_axes)
            jac_g = gather_field(jac, mesh, gather_axes)
            return pma.solve_pma(mon_g, jac_g, grid, cfg.pma)[sharding.index(grid.shape)]
        rhs = torch.sqrt(mon * torch.abs(jac)) / cfg.pma.alpha
        return pma.solve_shifted_neumann(
            rhs, grid, cfg.pma, method=pma_solver, lap=sharded_lap,
            group=group).to(rhs.dtype)

    def loop_pma(phi, u, dtmesh, loops: int):
        for _ in range(loops):
            phi = phi + dtmesh * pma_dqdt(phi, u)
        return phi

    # -- full step (mirrors models.droplet.make_step) ------------------------
    nk = dataclasses.replace(solver or dp.fast_solver(), group=group)

    def step(u, phi, dt, dtmesh, pma_loops: int):
        F = pde_rhs(u, phi)
        slv = nk
        if jvp_dtype is not None:
            jd = getattr(torch, jvp_dtype)
            u_j, f_j, phi_j = u.to(jd), F.to(jd), phi.to(jd)
            dt_j = torch.tensor(dt, dtype=jd, device=u.device)

            def factory(x, fxv):
                x_j = x.to(jd)
                return lambda v: residual_jvp(x_j, v, u_j, f_j, phi_j, dt_j)

            slv = dataclasses.replace(nk, matvec_factory=factory,
                                      inner_dtype=jvp_dtype)
        res = slv.solve(lambda v: residual(v, u, F, phi, dt), u)
        phi_new = loop_pma(phi, u, dtmesh, pma_loops)
        return dp.DropletStepResult(u=res.x, q=phi_new,
                                    newton_iters=res.iters,
                                    f_norm=res.f_norm,
                                    converged=res.converged)

    return ShardedDropletOps(
        residual=residual, pde_rhs=pde_rhs, monitor=monitor,
        pma_dqdt=pma_dqdt, loop_pma=loop_pma, step=step, sharding=sharding,
    )
