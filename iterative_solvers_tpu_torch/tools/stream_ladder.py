"""The stream ladder on the card (counterpart of the JAX package's
``tools/stream_ladder.py``): the read, write and copy streams through the
tile structure of the stencil kernels, by tile height ``bm`` and ring
depth ``slots``.

- ``read_kernel`` — ``(u, tok8) -> acc8``, streaming ``u`` once
  (``ops/stream_ladder.stream_read``);
- ``write_kernel`` — ``tok8 -> out(n, n)``, a pure write stream
  (``stream_write``);
- ``copy_kernel`` — ``(u, tok8) -> u``, load and store through the ring
  (``staged_copy`` with ``slots - 1`` tiles in flight).  The TPU kernel
  folds ``tok * 0`` into each chunk so that its timing chain depends on
  the data; launches on one CUDA stream are ordered anyway, so the copy
  does not read ``tok``.  (The TPU kernel at ``slots = 2`` refills a slot
  whose out-copy is still in flight and returns a wrong field; this one
  computes ``out = u`` at every ``slots``.)

Each factory takes the JAX arguments (``dtype`` a torch dtype) and
returns a callable that launches the kernel on CUDA tensors and runs its
plain version on CPU tensors.

    python -m iterative_solvers_tpu_torch.tools.stream_ladder [n] [reps]

runs on the card: it prints the card's ``nvidia-smi`` name and power
limit, the PyTorch triad reference (``utils/roofline.measured_stream_gbps``),
then one JSON line per (kernel, bm, slots) at ``n``^2 f32 (default 8192):
``ms`` and ``gbps`` by the JAX script's marginal cost between token chains
of 4 and 16 calls (host clock), ``device_ms`` and ``device_gbps`` from a
CUDA-graph replay of 10 calls, and ``share``, ``device_gbps`` over
``roofline_denominator_gbps()``.  Bytes: ``n^2 x 4`` for read and write,
twice that for copy, as the JAX script counts them.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..ops import stream_ladder as sl
from ..utils.roofline import measured_stream_gbps, roofline_denominator_gbps
from ..utils.timing import graph_ms, nvidia_smi

_HALO = sl.HALO


def read_kernel(n_rows, n_cols, bm, slots, dtype=torch.float32):
    """(u, tok8) -> acc8: streams u once; only an (8, n) accumulator is
    written back."""
    sl.check_knobs(n_rows, n_cols, bm, slots, dtype=dtype)

    def call(u, tok):
        sl.check_field("read_kernel u", u, (n_rows, n_cols), dtype)
        return sl.stream_read(u, tok, bm, slots)

    return call


def write_kernel(n_rows, n_cols, bm, slots, dtype=torch.float32):
    """tok8 -> out(n, n): streams out once from tiles filled on the chip."""
    sl.check_knobs(n_rows, n_cols, bm, slots, dtype=dtype)

    def call(tok):
        sl.check_field("write_kernel tok", tok, (_HALO, n_cols), dtype)
        return sl.stream_write(tok, n_rows, bm, slots)

    return call


def copy_kernel(n_rows, n_cols, bm, slots, dtype=torch.float32):
    """(u, tok8) -> out(n, n) = u: load + store through the ring — the
    stencil pipeline's stream structure minus halos and compute."""
    sl.check_knobs(n_rows, n_cols, bm, slots, slots - 1, dtype=dtype)

    def call(u, tok):
        sl.check_field("copy_kernel u", u, (n_rows, n_cols), dtype)
        sl.check_field("copy_kernel tok", tok, (_HALO, n_cols), dtype)
        return sl.staged_copy(u, bm, slots, slots - 1)

    return call


def time_chain(fn_tok, tok0, ks=(4, 16), reps=5):
    """Marginal ms/call between chain lengths; fn_tok: tok -> tok.  Each
    chain ends in a host read of the token's sum (a synchronise); the
    median of ``reps`` runs is taken at each length."""
    def chain(k):
        t = tok0
        for _ in range(k):
            t = fn_tok(t)
        return float(t.sum())

    def run(k):
        chain(k)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            chain(k)
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    return 1000.0 * (run(ks[1]) - run(ks[0])) / (ks[1] - ks[0])


def ladder(n=8192, reps=5, device="cuda"):
    """The JAX ``main``'s rows at ``n``^2 f32, returned and each printed as
    a JSON line: the triad reference, then every (kernel, bm, slots) for
    bm in 128, 256, 512 and slots in 2, 4, 8 with ``slots * bm <= 2048``.
    On a CPU device (a rehearsal of the control flow at a small ``n``) the
    rows carry host times only."""
    dev = resolve_device(device)
    card = dev.type == "cuda"
    u = torch.ones((n, n), dtype=torch.float32, device=dev)
    tok0 = torch.zeros((_HALO, n), dtype=torch.float32, device=dev)
    nbytes = n * n * 4
    rows = [{"kernel": "torch_triad_reference",
             "gbps": measured_stream_gbps(n=min(n, 8192), device=dev)}]
    print(json.dumps(rows[0]), flush=True)
    denom = roofline_denominator_gbps(dev) if card else None
    for bm in (128, 256, 512):
        for slots in (2, 4, 8):
            if slots * bm > 2048:
                continue
            rk = read_kernel(n, n, bm, slots)
            wk = write_kernel(n, n, bm, slots)
            ck = copy_kernel(n, n, bm, slots)
            for name, fn_tok, call, moved in (
                    ("read", lambda t: rk(u, t), lambda: rk(u, tok0), nbytes),
                    ("write", lambda t: wk(t)[:_HALO, :], lambda: wk(tok0), nbytes),
                    ("copy", lambda t: ck(u, t)[:_HALO, :], lambda: ck(u, tok0), 2 * nbytes)):
                ms = time_chain(fn_tok, tok0, reps=reps)
                row = {"kernel": name, "bm": bm, "slots": slots, "ms": ms,
                       "gbps": moved / ms / 1e6}
                if card:
                    dms = graph_ms(call)
                    row.update(device_ms=dms, device_gbps=moved / dms / 1e6,
                               share=moved / dms / 1e6 / denom)
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    resolve_device("cuda")
    print(json.dumps({"nvidia_smi": nvidia_smi(),
                      "roofline_denominator_gbps": roofline_denominator_gbps()}), flush=True)
    ladder(n, reps)


if __name__ == "__main__":
    main()
