"""The port's one kernel-call seam, ``ops/_build.py``, with no card.

A fake C function stands for the kernel library (``c_function`` patched)
and a fake stream for the card's: the registry counts each launch under
``(kernel, dtype, path)``, ``launch_count`` sums the matching entries,
``reset_launch_counts`` clears them, a failed launch raises and counts
nothing, and a function is bound once until ``clear``.  ``check`` refuses
each operand the kernels do not take with the words the wrappers' tests
match; the device test comes last, so a CPU tensor reaches every other
one here.
"""
import collections
import types

import pytest
import torch
from torch.autograd import forward_ad

from iterative_solvers_tpu_torch.ops import _build
from iterative_solvers_tpu_torch.ops._build import (F32, LAUNCHES, check, launch,
                                                    launch_count, reset_launch_counts)

TABLE = {"sh_operator": ["argtypes"], "fd_stencil": ["argtypes"]}


@pytest.fixture
def card(monkeypatch):
    """A fake library whose functions return ``card.err`` and record their
    arguments, a fake current stream, and an empty registry (restored
    after the test)."""
    state = types.SimpleNamespace(err=0, calls=[], bound=[])

    def c_function(name, argtypes):
        state.bound.append(name)
        return lambda *args: state.calls.append((name, args)) or state.err

    monkeypatch.setattr(_build, "c_function", c_function)
    monkeypatch.setattr(_build, "_BOUND", {})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=77))
    saved = collections.Counter(LAUNCHES)
    LAUNCHES.clear()
    yield state
    LAUNCHES.clear()
    LAUNCHES.update(saved)


def _launch_some():
    for key in [("sh_operator", "f64", "strip")] * 2 + [("sh_operator", "f32", "tile"),
                                                         ("fd_stencil", "f64", None)]:
        launch(key, key[0], TABLE, "cuda", 1, 2.5)


def test_the_registry_counts_by_kernel_dtype_and_path(card):
    _launch_some()
    assert LAUNCHES == {("sh_operator", "f64", "strip"): 2, ("sh_operator", "f32", "tile"): 1,
                        ("fd_stencil", "f64", None): 1}
    # the C function of the dtype, its arguments and the stream; bound once each
    assert card.calls[0] == ("sh_operator_f64", (1, 2.5, 77))
    assert [name for name, _ in card.calls] == ["sh_operator_f64", "sh_operator_f64",
                                                "sh_operator_f32", "fd_stencil_f64"]
    assert card.bound == ["sh_operator_f64", "sh_operator_f32", "fd_stencil_f64"]


@pytest.mark.parametrize("query,want", [
    ({}, 4),
    ({"kernel": "sh_operator"}, 3),
    ({"kernel": "sh_operator", "dtype": "f64"}, 2),
    ({"dtype": "f64"}, 3),
    ({"kernel": "sh_operator", "path": "tile"}, 1),
    ({"path": "strip"}, 2),
    ({"kernel": "fd_stencil", "dtype": "f32"}, 0),
    ({"kernel": "droplet_jvp"}, 0),
])
def test_launch_count_sums_the_matching_entries(card, query, want):
    _launch_some()
    assert launch_count(**query) == want


def test_launch_count_since_a_copy_counts_what_came_after(card):
    launch(("fd_stencil", "f64", None), "fd_stencil", TABLE, "cuda")
    mark = collections.Counter(LAUNCHES)
    _launch_some()
    assert launch_count(since=mark) == 4
    assert launch_count("fd_stencil", since=mark) == 1
    assert launch_count("fd_stencil") == 2


def test_reset_launch_counts_clears_them(card):
    _launch_some()
    reset_launch_counts()
    assert launch_count() == 0 and not LAUNCHES


def test_a_failed_launch_raises_and_counts_nothing(card):
    card.err = 700
    with pytest.raises(RuntimeError, match="sh_operator kernel launch failed: CUDA error 700"):
        launch(("sh_operator", "f32", "strip"), "sh_operator", TABLE, "cuda", 1)
    assert launch_count() == 0


def test_call_raises_on_an_error_and_counts_nothing(card):
    table = {"pma_source_resources": ["argtypes"]}
    _build.call("pma_source_resources", table, 5)
    card.err = 1
    with pytest.raises(RuntimeError, match="pma_source_resources failed: CUDA error 1"):
        _build.call("pma_source_resources", table, 5)
    assert card.bound == ["pma_source_resources"] and launch_count() == 0


def test_clear_drops_the_library_and_the_bindings(card):
    launch(("fd_stencil", "f32", None), "fd_stencil", TABLE, "cuda")
    assert _build._BOUND
    _build.clear()
    assert not _build._BOUND and _build.load_library.cache_info().currsize == 0
    launch(("fd_stencil", "f32", None), "fd_stencil", TABLE, "cuda")
    assert card.bound == ["fd_stencil_f32", "fd_stencil_f32"]


def _dual(x):
    with forward_ad.dual_level():
        check("sh_operator", forward_ad.make_dual(x, torch.ones_like(x)))


@pytest.mark.parametrize("case,error,words", [
    ("cpu", ValueError, "CUDA device"),
    ("float16", TypeError, "float32 or float64"),
    ("float64 where float32", TypeError, "float32, got torch.float64"),
    ("not contiguous", ValueError, "contiguous"),
    ("two devices", ValueError, "same device"),
    ("requires_grad", RuntimeError, "no derivative rule"),
    ("torch.func.jvp", RuntimeError, "no derivative rule"),
    ("forward-mode dual", RuntimeError, "no derivative rule"),
])
def test_check_refuses_what_no_kernel_takes(case, error, words):
    x = torch.zeros(4, 6)
    call = {
        "cpu": lambda: check("sh_operator", x),
        "float16": lambda: check("sh_operator", x.half()),
        "float64 where float32": lambda: check("droplet_jvp", x, x.double(), dtypes=F32),
        "not contiguous": lambda: check("grid_dia_matvec", x, x.t()),
        "two devices": lambda: check("pma_source", x, torch.zeros(4, 6, device="meta")),
        "requires_grad": lambda: check("pma_smooth", x, x.clone().requires_grad_()),
        "torch.func.jvp": lambda: torch.func.jvp(lambda v: check("lap_periodic", v) or v,
                                                 (x,), (x,)),
        "forward-mode dual": lambda: _dual(x),
    }[case]
    with pytest.raises(error, match=words):
        call()


def test_a_strided_kernel_takes_any_layout():
    """Past the layout test, a CPU tensor meets the device test."""
    with pytest.raises(ValueError, match="CUDA device"):
        check("d1_y", torch.zeros(4, 6).t(), strided=True)
