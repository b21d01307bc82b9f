"""Drivers of the port (counterparts of the JAX package's ``examples/``):
``python -m iterative_solvers_tpu_torch.examples.<name>``.  They write
their records under ``runs/`` (git-ignored) unless given ``out_dir=``."""
from __future__ import annotations

import pathlib

OUT_DIR = pathlib.Path(__file__).resolve().parents[2] / "runs"


def split_args(argv) -> tuple[list[str], dict[str, str]]:
    """A command line's positional arguments and its ``key=val`` options."""
    pos = [a for a in argv if "=" not in a]
    return pos, dict(a.split("=", 1) for a in argv if "=" in a)
