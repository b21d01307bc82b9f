"""A world of gloo ranks for the port's distribution tests.

:class:`World` spawns ``n`` CPU processes (start method ``spawn``), each a
rank of one gloo process group started through a ``file://`` store in a
temporary directory (safe beside other test workers), and runs tasks on
all ranks together: ``world.run(fn, *args)`` calls the module-level
function ``fn(*args)`` on every rank and returns the results in rank
order.  Deadlines keep a collective that never completes from hanging the
suite: every collective times out after ``COLLECTIVE_TIMEOUT_S`` in the
ranks, a task's results are awaited ``TASK_TIMEOUT_S``, and a world whose
task timed out is terminated and fails every later task at once.

The ranks never import JAX: a task's module must not import it at top
level.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback

COLLECTIVE_TIMEOUT_S = 60
TASK_TIMEOUT_S = 110
JOIN_TIMEOUT_S = 20


def _serve(rank: int, n: int, init_url: str, tasks, results):
    import torch
    import torch.distributed as dist

    from iterative_solvers_tpu_torch.dist.mesh import initialize_multihost

    torch.set_num_threads(1)
    initialize_multihost(init_url, n, rank, device="cpu",
                         timeout=COLLECTIVE_TIMEOUT_S)
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                results.put((rank, True, fn(*args)))
            except Exception:  # reported to the test, which fails
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    def __init__(self, n: int, tmp_dir):
        ctx = mp.get_context("spawn")
        self.n = n
        self.tasks = [ctx.Queue() for _ in range(n)]
        self.results = ctx.Queue()
        url = f"file://{tmp_dir}/store"
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, n, url, self.tasks[r], self.results))
                      for r in range(n)]
        for p in self.procs:
            p.start()
        self.broken = False

    def run(self, fn, *args):
        """``fn(*args)`` on every rank; the results in rank order.  Raises
        if a rank raised, died, or the task outlived its deadline."""
        if self.broken:
            raise RuntimeError("this world was terminated by an earlier task")
        for q in self.tasks:
            q.put((fn, args))
        out, errors = {}, []
        deadline = time.monotonic() + TASK_TIMEOUT_S
        while len(out) + len(errors) < self.n:
            try:
                rank, ok, value = self.results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in self.procs if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    self.close()
                    self.broken = True
                    raise RuntimeError(
                        f"{fn.__name__}: ranks exited {dead}" if dead else
                        f"{fn.__name__}: no result within {TASK_TIMEOUT_S} s")
                continue
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError(f"{fn.__name__} failed\n" + "\n".join(errors))
        return [out[r] for r in range(self.n)]

    def close(self):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(JOIN_TIMEOUT_S)
            if p.is_alive():
                p.terminate()
                p.join(JOIN_TIMEOUT_S)
        assert not any(p.is_alive() for p in self.procs)
