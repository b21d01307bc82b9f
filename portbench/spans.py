"""Spans around functions of the program, wrapped from outside.

A frozen copy of the smoke script's ``Spans``: while active, each call of
``module.<attr>`` records the stream time between its start and its end
(CUDA events on a card; the host clock on the CPU, where the tests run).
``take()`` returns ``{name: [calls, ms]}`` and resets."""
from __future__ import annotations

import time


class Spans:
    def __init__(self, targets: dict, cuda: bool):
        """``targets`` maps a span's name to ``(module, attribute)``."""
        self.targets = targets
        self.cuda = cuda
        self.orig = {name: getattr(mod, attr) for name, (mod, attr) in targets.items()}
        self.records = {name: [] for name in targets}

    def _wrap(self, name, fn):
        import torch

        records = self.records[name]
        if self.cuda:
            def timed(*args, **kw):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(*args, **kw)
                b.record()
                records.append((a, b))
                return out
        else:
            def timed(*args, **kw):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                records.append((t0, time.perf_counter()))
                return out
        return timed

    def __enter__(self):
        for name, (mod, attr) in self.targets.items():
            setattr(mod, attr, self._wrap(name, self.orig[name]))
        return self

    def __exit__(self, *exc):
        for name, (mod, attr) in self.targets.items():
            setattr(mod, attr, self.orig[name])

    def take(self) -> dict:
        out = {}
        for name, recs in self.records.items():
            if self.cuda:
                ms = sum(a.elapsed_time(b) for a, b in recs)
            else:
                ms = sum(t1 - t0 for t0, t1 in recs) * 1e3
            out[name] = [len(recs), ms]
            recs.clear()
        return out
