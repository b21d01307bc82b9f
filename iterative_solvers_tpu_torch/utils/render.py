"""Post-hoc rendering: plots and animations from saved solver states
(port of ``iterative_solvers_tpu/utils/render.py``).

Rendering is strictly offline: steppers save states and these helpers turn
them into figures afterwards.  matplotlib is imported lazily with the Agg
backend, only when a figure is asked for; without matplotlib that call
raises its ``ImportError``.  Fields may be tensors on any device.
"""
from __future__ import annotations

import pathlib
from typing import Sequence

from .. import to_numpy


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_field_image(u, path, *, title: str = "", extent=None, cmap="viridis"):
    """2-D heatmap of a field (the sh_scipy_nk.py:42-44 view, offline)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 6))
    im = ax.imshow(to_numpy(u), origin="lower", extent=extent, cmap=cmap,
                   interpolation="nearest")
    fig.colorbar(im, ax=ax, shrink=0.8)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def save_surface(u, x, y, path, *, title: str = "", zlim=None):
    """3-D surface of a (possibly moving-mesh) solution, the droplet.py
    plot rendered offline from (u, mesh coordinates)."""
    plt = _plt()
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot_surface(to_numpy(x), to_numpy(y), to_numpy(u),
                    cmap="coolwarm", linewidth=0, antialiased=False)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("u")
    if zlim:
        ax.set_zlim3d(*zlim)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def save_animation(frames: Sequence, path, *, fps: int = 10, extent=None,
                   cmap="viridis"):
    """mp4/gif of a field trajectory (sh_vscode_nk.py's export, offline).

    Writes a directory of pngs instead when no movie writer is available.
    """
    plt = _plt()
    from matplotlib import animation

    frames = [to_numpy(f) for f in frames]
    fig, ax = plt.subplots(figsize=(6, 6))
    im = ax.imshow(frames[0], origin="lower", extent=extent, cmap=cmap)

    def update(i):
        im.set_data(frames[i])
        im.set_clim(frames[i].min(), frames[i].max())
        ax.set_title(f"frame {i}")
        return (im,)

    anim = animation.FuncAnimation(fig, update, frames=len(frames))
    path = pathlib.Path(path)
    try:
        if path.suffix == ".gif":
            anim.save(path, writer="pillow", fps=fps)
        else:
            anim.save(path, writer=animation.FFMpegWriter(fps=fps))
    except (RuntimeError, FileNotFoundError):
        outdir = path.with_suffix("")
        outdir.mkdir(exist_ok=True)
        for i, f in enumerate(frames):
            save_field_image(f, outdir / f"frame_{i:05d}.png", extent=extent,
                             cmap=cmap)
    finally:
        plt.close(fig)
