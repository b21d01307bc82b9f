"""Krylov helpers shared by the LGMRES cycle
(port of the helpers of ``iterative_solvers_tpu/solvers/gmres.py``).

Vectors are fields of any shape on the device.  Orthogonalisation is
classical Gram–Schmidt with one re-orthogonalisation (CGS2) against the
live basis rows, as two matrix-vector products per round.  The small
Hessenberg/Givens recurrence lives on the host (numpy, in the Krylov
dtype): its inputs come back with the one host sync per Arnoldi step that
the convergence decision needs anyway.
"""
from __future__ import annotations

import numpy as np
import torch


def _norm(a):
    """Euclidean norm of a field, as a 0-d device tensor."""
    a = a.reshape(-1)
    return torch.sqrt(torch.dot(a, a))


def _cgs2(V, w):
    """CGS2 of ``w`` against the rows of ``V`` (``V`` holds exactly the live
    basis rows).  Returns ``(h, w_deflated)`` with ``h`` of length
    ``V.shape[0]`` on the device."""
    Vf = V.reshape(V.shape[0], -1)
    wf = w.reshape(-1)
    h = Vf @ wf
    wf = wf - h @ Vf
    h2 = Vf @ wf
    wf = wf - h2 @ Vf
    return h + h2, wf.reshape(w.shape)


def _apply_givens(h: np.ndarray, cs: np.ndarray, sn: np.ndarray, j: int):
    """Apply the first ``j`` stored rotations to the new column ``h``
    (host numpy, in place)."""
    for i in range(j):
        hi, hi1 = h[i], h[i + 1]
        h[i] = cs[i] * hi + sn[i] * hi1
        h[i + 1] = -sn[i] * hi + cs[i] * hi1
    return h
