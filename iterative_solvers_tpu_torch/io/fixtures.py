"""Droplet fixture state (port of ``iterative_solvers_tpu/io/fixtures.py``).

The reference serialises ``(u, q)`` line-per-node with its configuration
in the file name (``initdrop_{kind}_{R}_{Nx}-{Ny}_{a}_{eps}_{alpha}_{gamma}_{C}.txt``):
:func:`parse_name` reads the name, :func:`load` a file.  Without the text
files, the state comes from ``tests/fixtures/golden_droplet_step.npz``: its
``u_old``/``q_old`` are the reference's 91x61 coalescence state
``initdrop_coal_1_91-61_100_0.005_0.01_0.1_0.15.txt`` (R=1, a=100,
eps=0.005, alpha=0.01, gamma=0.1, C=0.15), and ``u_new``/``q_new`` the
scipy-driven CN step from it at dt=1e-5 (5 PMA sub-steps at dtmesh=3e-9).
"""
from __future__ import annotations

import dataclasses
import pathlib
import re
from collections.abc import Mapping

import numpy as np

FIXTURES = pathlib.Path(__file__).resolve().parents[2] / "tests" / "fixtures"
GOLDEN_STEP = FIXTURES / "golden_droplet_step.npz"

_NAME_RE = re.compile(
    r"initdrop_(?P<kind>[a-z]+)_(?P<R>[\d.]+)_(?P<nx>\d+)-(?P<ny>\d+)"
    r"_(?P<a>[\d.]+)_(?P<eps>[\d.]+)_(?P<alpha>[\d.]+)_(?P<gamma>[\d.]+)"
    r"_(?P<C>[\d.]+)\.txt"
)


@dataclasses.dataclass(frozen=True)
class DropletFixture:
    kind: str          # "rect" (single drop) or "coal" (coalescence pair)
    R: float
    nx: int
    ny: int
    a: float
    epsilon: float
    alpha: float
    gamma: float
    mackenzie_c: float
    u: np.ndarray      # (ny, nx) solution
    q: np.ndarray      # (ny, nx) mesh potential


def parse_name(name: str) -> dict:
    """The configuration a fixture's file name encodes: ``kind``, ``R``,
    ``nx``, ``ny``, ``a``, ``epsilon``, ``alpha``, ``gamma`` and
    ``mackenzie_c``."""
    m = _NAME_RE.match(pathlib.Path(name).name)
    if not m:
        raise ValueError(f"not an initdrop fixture name: {name}")
    d = m.groupdict()
    return {
        "kind": d["kind"], "R": float(d["R"]), "nx": int(d["nx"]),
        "ny": int(d["ny"]), "a": float(d["a"]), "epsilon": float(d["eps"]),
        "alpha": float(d["alpha"]), "gamma": float(d["gamma"]),
        "mackenzie_c": float(d["C"]),
    }


def load(path: str | pathlib.Path) -> DropletFixture:
    """A reference ``initdrop_*.txt`` state: one ``u q`` line per node."""
    path = pathlib.Path(path)
    meta = parse_name(path.name)
    data = np.loadtxt(path)
    n = meta["nx"] * meta["ny"]
    if data.shape != (n, 2):
        raise ValueError(
            f"{path.name}: expected {n} lines of (u, q), got {data.shape}")
    shape = (meta["ny"], meta["nx"])
    return DropletFixture(u=data[:, 0].reshape(shape),
                          q=data[:, 1].reshape(shape), **meta)


def load_golden_step(path=GOLDEN_STEP) -> tuple[DropletFixture, dict]:
    """The 91x61 coalescence fixture and the golden step taken from it
    (keys ``u_new``, ``q_new``, ``F``, ``dt``, ``min_spacing`` as
    ``(ny, nx)`` arrays or scalars)."""
    with np.load(path) as d:
        g = {k: d[k] for k in d.files}
    shape = (int(g["ny"]), int(g["nx"]))
    fix = DropletFixture(kind="coal", R=1.0, nx=shape[1], ny=shape[0],
                         a=100.0, epsilon=0.005, alpha=0.01, gamma=0.1,
                         mackenzie_c=0.15, u=g["u_old"].reshape(shape),
                         q=g["q_old"].reshape(shape))
    golden = {k: (v.reshape(shape) if v.size == shape[0] * shape[1] else v)
              for k, v in g.items()}
    return fix, golden


def upsample(fix: DropletFixture, nx: int, ny: int) -> DropletFixture:
    """Bicubic-interpolate a fixture state onto a finer grid, blending the
    mesh potential's deviation from the identity into zero over a smooth
    ~16-cell frame so the fine grid's one-sided Neumann formulas see an
    exactly consistent boundary."""
    from scipy.interpolate import RectBivariateSpline

    ys = np.linspace(0.0, 1.0, fix.ny)
    xs = np.linspace(0.0, 1.0, fix.nx)
    yt = np.linspace(0.0, 1.0, ny)
    xt = np.linspace(0.0, 1.0, nx)

    def interp(f):
        return RectBivariateSpline(ys, xs, f, kx=3, ky=3)(yt, xt)

    q_up = interp(fix.q)
    grid = config_for(dataclasses.replace(fix, nx=nx, ny=ny)).grid
    q_id = 0.5 * (grid.xx ** 2 + grid.yy ** 2)
    dev = q_up - q_id
    # Q is a potential (only derivatives matter): drop the large constant
    # offset before tapering, or the blend injects spurious curvature
    frame = np.concatenate([dev[0, :], dev[-1, :], dev[:, 0], dev[:, -1]])
    dev = dev - np.mean(frame)
    iy = np.arange(ny)[:, None].astype(np.float64)
    ix = np.arange(nx)[None, :].astype(np.float64)
    taper = max(16.0, min(nx, ny) / 16.0)

    # product of per-edge smoothsteps (C^1, h-independent curvature); a
    # min() of distances kinks along the corner diagonals
    def edge_w(d):
        w = np.clip(d / taper, 0.0, 1.0)
        return w * w * (3.0 - 2.0 * w)

    w = edge_w(iy) * edge_w(ny - 1 - iy) * edge_w(ix) * edge_w(nx - 1 - ix)
    return dataclasses.replace(fix, nx=nx, ny=ny, u=interp(fix.u),
                               q=q_id + w * dev)


def config_for(fix: DropletFixture | Mapping):
    """DropletConfig matching a fixture's parameters; ``fix`` is a
    :class:`DropletFixture` or the dict :func:`parse_name` returns."""
    from ..models.droplet import DropletConfig

    p = fix if isinstance(fix, Mapping) else vars(fix)
    return DropletConfig(
        R=p["R"], a=p["a"], epsilon=p["epsilon"], nx=p["nx"], ny=p["ny"],
        alpha=p["alpha"], gamma=p["gamma"], mackenzie_c=p["mackenzie_c"],
    )
