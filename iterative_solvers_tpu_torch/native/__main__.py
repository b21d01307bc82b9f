"""Standalone Swift–Hohenberg driver (counterpart of the native library's
``sh_driver`` executable): run the Crank–Nicolson Newton–Krylov time loop
and write the final state, one ``%.17g`` value a line.

Usage:  python -m iterative_solvers_tpu_torch.native
        [N] [d] [k] [Tf] [r] [g] [out.txt] [device=cpu]
(defaults 64 40 0.2 10 0.01 1 runs/sh_out.txt, the GPU); ``ceil(Tf / k)``
steps.  Deviations from the executable: u0 comes from
``numpy.random.default_rng(0)`` (``std::normal_distribution`` draws are
not reproducible outside libstdc++), and the default output goes under
``runs/`` rather than the working directory.
"""
from __future__ import annotations

import math
import pathlib
import sys

import numpy as np

from ..examples import OUT_DIR, split_args
from . import _sh_steps


def main(argv=None) -> int:
    pos, opts = split_args(sys.argv[1:] if argv is None else argv)
    n = int(pos[0]) if len(pos) > 0 else 64
    d = float(pos[1]) if len(pos) > 1 else 40.0
    k = float(pos[2]) if len(pos) > 2 else 0.2
    tf = float(pos[3]) if len(pos) > 3 else 10.0
    r = float(pos[4]) if len(pos) > 4 else 0.01
    g = float(pos[5]) if len(pos) > 5 else 1.0
    out = pathlib.Path(pos[6]) if len(pos) > 6 else OUT_DIR / "sh_out.txt"

    nsteps = math.ceil(tf / k)
    u0 = np.random.default_rng(0).standard_normal(n * n)
    u, stats = _sh_steps(u0, nsteps, n=n, d=d, k=k, r=r, g=g,
                         device=opts.get("device", "cuda"))
    converged = sum(s.converged for s in stats)
    fev = sum(s.func_evals for s in stats)
    print(f"steps={nsteps} converged={converged} func_evals={fev} "
          f"final_fnorm={stats[-1].f_norm if stats else 0.0:.3e}", flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        f.writelines(f"{v:.17g}\n" for v in u)
    return 0


if __name__ == "__main__":
    sys.exit(main())
