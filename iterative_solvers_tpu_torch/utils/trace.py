"""The program's own tracing: named spans and per-step counters of its
host loops (Newton, the Krylov cycles, the PMA sub-loop).

Tracing is off by default and has one switch: :func:`enable` /
:func:`disable`, or :func:`tracing` for a block.  While it is off,
:func:`span` returns one shared no-op context, :func:`count` returns at
once and :func:`to_host` only reads, so the host loops pay a flag test a
call.  While it is on:

- ``with span(name):`` records ``Span(name, step, parent, t0_ns, t1_ns)``
  on ``time.perf_counter_ns()``.  ``parent`` is the index of the enclosing
  span in the list :func:`take` returns (None at the root); ``step`` is
  the id of the enclosing ``step`` span, and each ``step`` span takes the
  next id of a count kept for the process.  Under a running
  ``torch.profiler`` the span also enters
  :func:`.timing.trace_annotation`, so its interval lies in the profiler's
  trace on the clock of the device intervals, and an idle gap of the card
  can be put down to the layer the host was in.
- ``count(name, n)`` adds ``n`` to the counter ``name`` of the current
  step (``None`` outside any step).
- ``to_host(t, form)`` is the host loops' one way to read a device value.
  It performs the read the loop needs (``t.item()``, ``t.tolist()`` or
  ``t.cpu().numpy()``) and counts it under ``host.syncs``, with the
  host-clock nanoseconds spent inside it under ``host.wait_ns``.

:func:`take` returns what was recorded since it was last called and
clears it: spans and counters stay in memory until then.  Spans nest on
the calling thread, so trace one host loop at a time.
"""
from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

from .timing import trace_annotation


class Span(NamedTuple):
    name: str
    step: int | None      # id of the enclosing ``step`` span
    parent: int | None    # index of the enclosing span in the same list
    t0_ns: int
    t1_ns: int


class Trace(NamedTuple):
    spans: list           # Span, in the order they were entered
    counters: dict        # {step id: {counter name: value}}


class _State:
    def __init__(self):
        self.on = False
        self.spans = []       # [name, step, parent, t0_ns, t1_ns] as entered
        self.open = []        # indices of the spans entered and not yet left
        self.step = None
        self.next_step = 0
        self.counters = {}


_state = _State()
_OFF = contextlib.nullcontext()
_READS = {"item": lambda t: t.item(),
          "list": lambda t: t.tolist(),
          "numpy": lambda t: t.cpu().numpy()}


def enable() -> None:
    """Turn tracing on."""
    _state.on = True


def disable() -> None:
    """Turn tracing off; what was recorded stays until :func:`take`."""
    _state.on = False


@contextlib.contextmanager
def tracing():
    """Tracing on for the block, as it was after."""
    was = _state.on
    _state.on = True
    try:
        yield
    finally:
        _state.on = was


class _Span:
    __slots__ = ("name", "record", "outer_step", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        s = _state
        if self.name == "step":
            self.outer_step = s.step
            s.step = s.next_step
            s.next_step += 1
        self.record = [self.name, s.step, s.open[-1] if s.open else None, 0, None]
        s.open.append(len(s.spans))
        s.spans.append(self.record)
        self.annotation = None
        if torch._C._autograd._profiler_enabled():
            self.annotation = trace_annotation(self.name)
            self.annotation.__enter__()
        self.record[3] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.record[4] = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        s = _state
        s.open.pop()
        if self.name == "step":
            s.step = self.outer_step
        return False


def span(name: str):
    """A named span of the program (a no-op context while tracing is off)."""
    return _Span(name) if _state.on else _OFF


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` of the current step (tracing on)."""
    if _state.on:
        c = _state.counters.setdefault(_state.step, {})
        c[name] = c.get(name, 0) + n


def to_host(t: torch.Tensor, form: str = "item"):
    """``t.item()`` (``form="item"``), ``t.tolist()`` (``"list"``) or
    ``t.cpu().numpy()`` (``"numpy"``): a blocking read of the device,
    counted while tracing is on."""
    read = _READS[form]
    if not _state.on:
        return read(t)
    t0 = time.perf_counter_ns()
    out = read(t)
    wait = time.perf_counter_ns() - t0
    c = _state.counters.setdefault(_state.step, {})
    c["host.syncs"] = c.get("host.syncs", 0) + 1
    c["host.wait_ns"] = c.get("host.wait_ns", 0) + wait
    return out


def take() -> Trace:
    """The spans and counters recorded since the last call, which are
    cleared.  Call it between spans: it raises while a span is open."""
    s = _state
    if s.open:
        raise RuntimeError(f"take() inside the open span {s.spans[s.open[-1]][0]!r}")
    out = Trace([Span(*r) for r in s.spans], s.counters)
    s.spans, s.counters = [], {}
    return out


def self_ns(spans: list, name: str, less) -> int:
    """The summed duration of the spans called ``name``, less the part of
    each that its direct children named in ``less`` cover."""
    total = 0
    for sp in spans:
        if sp.name == name:
            total += sp.t1_ns - sp.t0_ns
        elif sp.name in less and sp.parent is not None and spans[sp.parent].name == name:
            total -= sp.t1_ns - sp.t0_ns
    return total
