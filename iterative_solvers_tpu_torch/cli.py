"""Command-line driver for the workloads
(port of ``iterative_solvers_tpu/cli.py``).

Every workload is a subcommand with typed config overrides, optional
checkpoint/restart, metrics JSONL and offline rendering; each prints one
JSON line.  The subcommands, flags and printed keys are the JAX CLI's,
plus ``--device`` (default ``cuda``; without a GPU it raises unless
``--device cpu`` is given).

    python -m iterative_solvers_tpu_torch.cli sh --n 64 --steps 100 --render out.png
    python -m iterative_solvers_tpu_torch.cli droplet --fixture <initdrop.txt> --steps 10
    python -m iterative_solvers_tpu_torch.cli mems --steps 50
    python -m iterative_solvers_tpu_torch.cli poisson --n 1000
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from . import resolve_device

_ARG_TYPES = {"int": int, "float": float, int: int, float: float}


def _add_config_args(p: argparse.ArgumentParser, cfg, skip=()) -> None:
    for f in dataclasses.fields(cfg):
        if f.name in skip:
            continue
        # under `from __future__ import annotations` f.type is the string
        # name; map it explicitly (no eval) and skip non-scalar fields
        arg_type = _ARG_TYPES.get(f.type)
        if arg_type is not None:
            p.add_argument(f"--{f.name.replace('_', '-')}", type=arg_type,
                           default=None, dest=f"cfg_{f.name}")


def _apply_overrides(cfg, args):
    changes = {
        f.name: getattr(args, f"cfg_{f.name}")
        for f in dataclasses.fields(cfg)
        if getattr(args, f"cfg_{f.name}", None) is not None
    }
    return dataclasses.replace(cfg, **changes) if changes else cfg


def cmd_sh(args) -> int:
    import torch

    from .models.swift_hohenberg import SHConfig, evolve_cn, fast_solver
    from .solvers.newton import NewtonKrylov
    from .utils.metrics import MetricsLogger

    dev = resolve_device(args.device)
    cfg = _apply_overrides(SHConfig(), args)
    solver = (fast_solver(cfg, f_tol=args.f_tol) if args.fast
              else NewtonKrylov(f_tol=args.f_tol))
    dtype = torch.float64 if args.x64 else torch.float32
    u0 = torch.tensor(np.random.default_rng(args.seed).standard_normal(
        (cfg.n, cfg.n)), dtype=dtype, device=dev)
    u, iters, f_norms = evolve_cn(u0, args.steps, cfg, solver, device=dev)
    log = MetricsLogger(path=args.metrics)
    log.log_scan_outputs({"newton_iters": iters, "f_norm": f_norms})
    print(json.dumps({"steps": args.steps,
                      "final_fnorm": float(f_norms[-1]),
                      "mean_newton_iters": float(np.mean(iters))}))
    if args.checkpoint:
        from .io import checkpoint as ck

        ck.save(args.checkpoint, {"u": u}, config=cfg, step=args.steps)
    if args.render:
        from .utils.render import save_field_image

        save_field_image(u, args.render, title=f"SH t={args.steps * cfg.k:.1f}")
    return 0


def cmd_droplet(args) -> int:
    from .io import checkpoint as ck
    from .io import fixtures as fx
    from .models import droplet as dp
    from .ops import curvilinear

    dev = resolve_device(args.device)
    if args.fixture:
        fixture = fx.load(args.fixture)
        cfg = fx.config_for(fixture)
        u, q = fixture.u, fixture.q
    elif args.restart:
        arrays, meta = ck.load(args.restart)
        cfg = dp.DropletConfig(**meta["config"])
        u, q = arrays["u"], arrays["q"]
    else:
        cfg = _apply_overrides(dp.DropletConfig(), args)
        q, u = dp.inflate(cfg, [[0.0, 0.0, cfg.R, 1.0]], args.inflate_steps,
                          5e-9, 20, device=dev)
    step_kw = {}
    if args.fast:
        # the fast path: f32 spectral / mesh PMA and the droplet_jvp kernel
        # in the inner Krylov
        cfg = dataclasses.replace(cfg, spectral_dtype="float32",
                                  mesh_dtype="float32")
        step_kw = {"solver": dp.fast_solver(), "jvp_dtype": "float32",
                   "jvp_kernel": True}
    u, q, t, (iters, f_norms, dts) = dp.evolve(
        cfg, u, q, args.dt, args.steps, dtmesh=3e-9,
        pma_loops=args.pma_loops, device=dev, **step_kw,
    )
    geom = curvilinear.mesh_geometry(q, cfg.grid)
    print(json.dumps({
        "steps": args.steps, "t": float(t),
        "min_spacing": float(dp.min_spacing(geom)),
        "final_fnorm": float(f_norms[-1]),
    }))
    if args.checkpoint:
        ck.save(args.checkpoint, {"u": u, "q": q}, config=cfg,
                step=args.steps, time=float(t))
    if args.render:
        from .utils.render import save_surface

        save_surface(u, geom.x, geom.y, args.render, title=f"t={float(t):.4f}")
    return 0


def cmd_mems(args) -> int:
    import torch

    from .models import mems

    dev = resolve_device(args.device)
    cfg = _apply_overrides(mems.MEMSConfig(), args)
    if args.coupled:
        u, q, res = mems.evolve_coupled(cfg, args.tf, device=dev)
        print(json.dumps({"t": float(res.t), "steps": int(res.steps),
                          "u_min": float(torch.min(u)),
                          "success": bool(res.success)}))
    else:
        u, q, t, dts, iters = mems.evolve(cfg, args.steps, device=dev)
        print(json.dumps({"t": float(t), "steps": args.steps,
                          "u_min": float(torch.min(u)),
                          "dt_final": float(dts[-1])}))
    if args.render:
        from .ops import curvilinear
        from .utils.render import save_surface

        geom = curvilinear.mesh_geometry(q, cfg.grid)
        save_surface(u, geom.x, geom.y, args.render, zlim=(-1, 0.2))
    return 0


def cmd_poisson(args) -> int:
    from .models import poisson

    dev = resolve_device(args.device)
    u = poisson.solve_direct(args.n, device=dev)
    q = float(poisson.flow_rate(u, 1.0 / args.n))
    q_exact = poisson.flow_rate_exact()
    print(json.dumps({"n": args.n, "flow_rate": q, "exact": q_exact,
                      "rel_err": abs(q - q_exact) / q_exact}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="iterative_solvers_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    from .models.droplet import DropletConfig
    from .models.mems import MEMSConfig
    from .models.swift_hohenberg import SHConfig

    def parser(name, help):
        p = sub.add_parser(name, help=help)
        p.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu must be asked for)")
        return p

    p = parser("sh", "Swift-Hohenberg CN/JFNK")
    _add_config_args(p, SHConfig())
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--f-tol", type=float, default=6e-6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fast", action="store_true",
                   help="analytic f32 Jacobian and f32 inner Krylov")
    p.add_argument("--x64", action="store_true",
                   help="f64 state (default f32)")
    p.add_argument("--metrics", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--render", default=None)
    p.set_defaults(fn=cmd_sh)

    p = parser("droplet", "thin-film droplet JFNK + moving mesh")
    _add_config_args(p, DropletConfig())
    p.add_argument("--fixture", default=None)
    p.add_argument("--restart", default=None)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--dt", type=float, default=1e-5)
    p.add_argument("--pma-loops", type=int, default=400)
    p.add_argument("--inflate-steps", type=int, default=1000)
    p.add_argument("--fast", action="store_true",
                   help="f32 PMA + the droplet_jvp kernel in the inner Krylov")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--render", default=None)
    p.set_defaults(fn=cmd_droplet)

    p = parser("mems", "MEMS touchdown on adaptive mesh")
    _add_config_args(p, MEMSConfig(), skip=("tf",))
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--tf", type=float, default=0.01)
    p.add_argument("--coupled", action="store_true",
                   help="coupled (u,Q) BDF integration (PMA.py mode)")
    p.add_argument("--render", default=None)
    p.set_defaults(fn=cmd_mems)

    p = parser("poisson", "duct-flow Poisson benchmark")
    p.add_argument("--n", type=int, default=1000)
    p.set_defaults(fn=cmd_poisson)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
