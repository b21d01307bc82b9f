"""The port's public API against the JAX package's, on the CPU.

Code written against the JAX package's public names must run against the
port unchanged apart from ``device=``.  The per-module parity tests pass
keywords, so they cannot see a field or a parameter out of order; this
file walks the whole surface:

- (a) every public property and cached field of ``core.grid.Grid2D`` on
  four grids, equal in both packages;
- (b) every name each JAX subpackage ``__init__`` binds, importable from
  the port's subpackage of the same name (a module as the port module of
  the same name, a class or function as the port's of the same name), and
  ``chip_smoke.SURFACE``, the smoke run's copy of those names, equal to
  the bindings; importing the subpackages loads neither JAX nor the JAX
  package, builds no kernel and leaves CUDA untouched;
- (c) every module of the JAX package, and every driver of its
  ``examples/``: each public function, class and method exists in the
  port's module, each JAX parameter is in the port's signature with an
  equal default, the JAX positional parameters come first and in the JAX
  order, a parameter only the port has carries a default, and NamedTuple
  and dataclass fields are in the JAX order; the CLI's subcommands take
  every JAX flag with its default; the JAX ``tools/`` stream kernels
  (``TOOLS``, read with ``ast``) against the port's ``tools`` subpackage
  the same way.  ``DEVIATIONS`` holds what the walk lets differ, each
  entry a deviation that ``ROADMAP.md`` states;
- (d) behaviour: ``PMAParams`` built positionally, ``lgmres``'s result
  and recycle buffer unpacked positionally, ``init_recycle`` unpacked.
"""
import argparse
import ast
import dataclasses
import importlib
import importlib.util
import inspect
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = "iterative_solvers_tpu"
PORT_PKG = "iterative_solvers_tpu_torch"
SUBPACKAGES = ("core", "ops", "solvers", "models", "meshmove", "dist")

# JAX module -> the port module that holds its counterpart, where the names differ
PORT_MODULE = {
    "ops.pallas_droplet": "ops.droplet_jvp",
    "ops.pallas_stencil": "ops.periodic_stencil",
    "ops.pallas_spmv": "ops.spmv",
}

# What the walk lets differ, by JAX name (module.name[.member]); each entry
# is one of ROADMAP.md's "Stated deviations of the public API".  Keys:
# ``port`` the port's name for it (its signature is not compared),
# ``absent`` not carried, ``signature`` not compared, ``extra`` parameters
# or fields only the port has, ``rename`` JAX -> port parameter names,
# ``required`` JAX parameters with a default that the port requires,
# ``dropped`` JAX parameters the port does not take.
DEVIATIONS = {
    # The Pallas wrappers are named after their CUDA kernels; their TPU DMA
    # knobs (block_rows, slots, streams, mode, inplace) have no counterpart.
    "ops.pallas_droplet.jvp_matvec_pallas": {"port": "jvp_matvec"},
    "ops.pallas_stencil.lap_periodic_pallas": {"port": "lap_periodic_kernel"},
    "ops.pallas_stencil.sh_operator_pallas": {"port": "sh_operator_kernel"},
    "ops.pallas_spmv.grid_dia_matvec_pallas": {"port": "grid_dia_matvec"},
    "ops.pallas_spmv.dia_flat_matvec_pallas": {"port": "dia_flat_matvec"},
    "ops.pallas_spmv.grid_dia_matmat_pallas": {"port": "grid_dia_matmat"},
    "ops.pallas_spmv.grid_dia_matmat_interleaved_pallas":
        {"port": "grid_dia_matmat_interleaved"},
    # The CPU rehearsal of the TPU kernel's DMA chain blocks; the CUDA
    # kernel's tiling is rehearsed by its own simulation.
    "ops.pallas_droplet.chain_block_reference_sim": {"port": "jvp_apply_tiled_sim"},
    # reads an XLA program's text; dist/comm.py counts the same calls
    "utils.roofline.comm_stats_from_compiled": {"absent": True},
    # counts the port kernels' needed coefficients, not the TPU slab
    # pipeline's block_rows / halo
    "utils.roofline.spmv_kernel_cost": {"signature": True},
    # the halo models take the card's link rate (ici_gbps -> link_gbps) and
    # both rates required, with no TPU table to default to
    "utils.roofline.halo_step_model": {"rename": {"ici_gbps": "link_gbps"},
                                       "required": ("hbm_gbps", "ici_gbps")},
    "utils.roofline.halo_step_model_2d": {"rename": {"ici_gbps": "link_gbps"},
                                          "required": ("hbm_gbps", "ici_gbps")},
    # torch.distributed has no ambient shard_map axis: the halo functions
    # take the device mesh
    "dist.halo.halo_exchange_1d": {"extra": ("mesh",)},
    "dist.halo.with_halo": {"extra": ("mesh",)},
    "dist.halo.pdot": {"extra": ("mesh",)},
    "dist.halo.sharded_y_chain": {"extra": ("mesh",)},
    "dist.halo.sharded_xy_chain": {"extra": ("mesh",)},
    # the process group that sums the solver's reductions over a sharded
    # field: a trailing field with a default
    "solvers.newton.NewtonKrylov": {"extra": ("group",)},
    # the long-run driver's option parser is examples.split_args, shared by
    # the port's six drivers
    "examples.droplet_longrun.parse_opts": {"absent": True},
    # the TPU kernel's scoped VMEM limit: the card's ring is sized to a
    # block's shared memory
    "tools.pallas_pipeline_experiment.make_pipeline": {"dropped": ("vmem_mb",)},
}


# -- (a) Grid2D --------------------------------------------------------------

GRIDS = {
    "square24": ("square", (24,)),
    "rect91x61": ("Grid2D", (91, 61, 0, 3, 0, 2)),
    "offset17x13": ("Grid2D", (17, 13, -0.7, 2.3, 0.25, 1.9)),
    "strip1024x8": ("Grid2D", (1024, 8)),
}
GRID_FIELDS = ("lx", "ly", "dx", "dy", "n", "shape", "x", "y", "xx", "yy",
               "mask_left", "mask_right", "mask_bottom", "mask_top",
               "mask_boundary", "mask_interior")


@pytest.mark.parametrize("label", list(GRIDS))
def test_grid_properties_match_jax(label):
    from iterative_solvers_tpu.core import grid as jgrid
    from iterative_solvers_tpu_torch.core import grid as tgrid

    fn, args = GRIDS[label]
    jg, tg = getattr(jgrid, fn)(*args), getattr(tgrid, fn)(*args)
    for name in GRID_FIELDS:
        want, got = getattr(jg, name), getattr(tg, name)
        assert type(got) is type(want), name
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), name
        else:
            assert got == want, name
    # dx and dy over lx and ly are the expression they replaced, bit for bit
    assert tg.dx == (tg.xr - tg.xl) / (tg.nx - 1)
    assert tg.dy == (tg.yt - tg.yb) / (tg.ny - 1)


# -- (b) re-exports ----------------------------------------------------------

def _bindings(subpackage: str) -> tuple:
    """The names the JAX subpackage's ``__init__`` binds by its imports."""
    path = ROOT / JAX_PKG / subpackage / "__init__.py"
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return tuple(names)


REEXPORTS = [(pkg, name) for pkg in SUBPACKAGES for name in _bindings(pkg)]


@pytest.mark.parametrize("pkg,name", REEXPORTS, ids=[f"{p}.{n}" for p, n in REEXPORTS])
def test_subpackage_reexports_match_jax(pkg, name):
    want = getattr(importlib.import_module(f"{JAX_PKG}.{pkg}"), name)
    got = getattr(importlib.import_module(f"{PORT_PKG}.{pkg}"), name)
    if inspect.ismodule(want):
        assert inspect.ismodule(got)
        assert got.__name__ == want.__name__.replace(JAX_PKG, PORT_PKG, 1)
    else:
        assert inspect.isclass(got) == inspect.isclass(want)
        assert callable(got) and got.__name__ == want.__name__
        assert got.__module__ == want.__module__.replace(JAX_PKG, PORT_PKG, 1)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("_chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("pkg", SUBPACKAGES)
def test_smoke_surface_list_matches_jax_bindings(pkg):
    """The smoke run (no JAX on the card's machine) keeps its own copy."""
    assert tuple(_chip_smoke().SURFACE[pkg]) == _bindings(pkg)


def test_subpackage_imports_load_no_jax_and_build_nothing():
    code = (
        "import sys\n"
        "from iterative_solvers_tpu_torch.solvers import NewtonKrylov, lgmres, "
        "LgmresRecycle, BDF, step_with_backoff\n"
        "from iterative_solvers_tpu_torch.core import Grid2D, square\n"
        "import iterative_solvers_tpu_torch.models as m\n"
        "import iterative_solvers_tpu_torch.ops, iterative_solvers_tpu_torch.meshmove\n"
        "import iterative_solvers_tpu_torch.dist\n"
        "import iterative_solvers_tpu_torch.tools.stream_ladder\n"
        "import iterative_solvers_tpu_torch.tools.pipeline_experiment\n"
        "import iterative_solvers_tpu_torch.tools.grid_experiment\n"
        "m.droplet, m.mems\n"
        "import torch\n"
        "from iterative_solvers_tpu_torch.ops import _build\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'iterative_solvers_tpu' or k.startswith('iterative_solvers_tpu.'))\n"
        "assert not bad, bad\n"
        "assert _build.load_library.cache_info().currsize == 0\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# -- (c) the API walk --------------------------------------------------------

def _package_modules() -> list:
    base = ROOT / JAX_PKG
    return sorted(".".join(p.relative_to(base).with_suffix("").parts)
                  for p in base.rglob("*.py") if "__pycache__" not in p.parts)


def _example_modules() -> list:
    return sorted(f"examples.{p.stem}" for p in (ROOT / "examples").glob("*.py"))


def _norm_default(v):
    """A default in a comparable form: a dtype by its name, a dataclass
    instance by its fields."""
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    if isinstance(v, type):
        try:
            return np.dtype(v).name
        except TypeError:
            return v.__name__
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__, dataclasses.astuple(v))
    return v


_EMPTY = inspect.Parameter.empty
_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _compare_params(where: str, jparams: list, tsig: inspect.Signature, dev: dict) -> list:
    """``jparams``: the JAX side's ``(name, kind, default)`` list.  Returns
    the problems found, each naming ``where``."""
    rename = dev.get("rename", {})
    extra = set(dev.get("extra", ()))
    required = set(dev.get("required", ()))
    dropped = set(dev.get("dropped", ()))
    tparams = {p.name: p for p in tsig.parameters.values()}
    problems = [f"{where}: {name!r} is listed as dropped, but the port takes it"
                for name in dropped & set(tparams)]
    jparams = [p for p in jparams if p[0] not in dropped]
    jnames = []
    for name, kind, default in jparams:
        tname = rename.get(name, name)
        jnames.append(tname)
        if tname not in tparams:
            problems.append(f"{where}: no parameter {tname!r}")
            continue
        tp = tparams[tname]
        if kind in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD):
            if tp.kind != kind:
                problems.append(f"{where}: {tname!r} is {tp.kind}, JAX {kind}")
            continue
        if default is _EMPTY or name in required:
            continue
        if tp.default is _EMPTY:
            problems.append(f"{where}: {tname!r} has no default (JAX {default!r})")
        elif _norm_default(tp.default) != _norm_default(default):
            problems.append(f"{where}: {tname!r} defaults to {tp.default!r}, JAX {default!r}")
    jpos = [rename.get(n, n) for n, k, _ in jparams if k in _POSITIONAL]
    tpos = [p.name for p in tsig.parameters.values() if p.kind in _POSITIONAL
            and p.name not in extra]
    if tpos[:len(jpos)] != jpos:
        problems.append(f"{where}: positional {tpos}, JAX {jpos}")
    for p in tsig.parameters.values():
        if (p.name not in jnames and p.name not in extra and p.default is _EMPTY
                and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)):
            problems.append(f"{where}: port-only parameter {p.name!r} has no default")
    return problems


def _sig_params(fn) -> list:
    return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]


def _fields(cls):
    if hasattr(cls, "_fields"):
        return tuple(cls._fields)
    if dataclasses.is_dataclass(cls):
        return tuple(f.name for f in dataclasses.fields(cls))
    return None


def _compare_class(where: str, jcls, tcls, dev: dict) -> list:
    problems = []
    jf, tf = _fields(jcls), _fields(tcls)
    if jf is not None:
        extra = dev.get("extra", ())
        if tf is None or tuple(f for f in tf if f not in extra) != jf:
            problems.append(f"{where}: fields {tf}, JAX {jf}")
        defaults = {f.name: f.default for f in dataclasses.fields(jcls)} \
            if dataclasses.is_dataclass(jcls) else getattr(jcls, "_field_defaults", {})
        for name, default in defaults.items():
            got = inspect.signature(tcls).parameters.get(name)
            if default is not dataclasses.MISSING and got is not None and \
                    _norm_default(got.default) != _norm_default(default):
                problems.append(f"{where}: field {name!r} defaults to {got.default!r}, "
                                f"JAX {default!r}")
    elif "__init__" in vars(jcls):
        problems += _compare_params(f"{where}.__init__", _sig_params(jcls),
                                    inspect.signature(tcls), dev)
    for mname, jm in vars(jcls).items():
        if mname.startswith("_"):
            continue
        if not hasattr(tcls, mname):
            problems.append(f"{where}.{mname}: missing")
            continue
        tm = inspect.getattr_static(tcls, mname)
        jfn = jm.__func__ if isinstance(jm, (staticmethod, classmethod)) else jm
        tfn = tm.__func__ if isinstance(tm, (staticmethod, classmethod)) else tm
        if inspect.isfunction(jfn):
            if not inspect.isfunction(tfn):
                problems.append(f"{where}.{mname}: not a function in the port")
                continue
            problems += _compare_params(f"{where}.{mname}", _sig_params(jfn),
                                        inspect.signature(tfn), {})
    return problems


def _walk_module(mod: str) -> list:
    jm = importlib.import_module(f"{JAX_PKG}.{mod}")
    tm = importlib.import_module(f"{PORT_PKG}.{PORT_MODULE.get(mod, mod)}")
    problems = []
    for name, obj in vars(jm).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != jm.__name__:
            continue
        if not (inspect.isfunction(obj) or inspect.isclass(obj)):
            continue
        where = f"{mod}.{name}"
        dev = DEVIATIONS.get(where, {})
        if dev.get("absent"):
            if hasattr(tm, name):
                problems.append(f"{where}: listed as not carried, but the port has it")
            continue
        tname = dev.get("port", name)
        if not hasattr(tm, tname):
            problems.append(f"{where}: missing from {tm.__name__}")
            continue
        tobj = getattr(tm, tname)
        if inspect.isclass(obj):
            if not inspect.isclass(tobj):
                problems.append(f"{where}: not a class in the port")
            else:
                problems += _compare_class(where, obj, tobj, dev)
        elif "port" in dev or dev.get("signature"):
            if not callable(tobj):
                problems.append(f"{where}: {tname} is not callable in the port")
        else:
            problems += _compare_params(where, _sig_params(obj), inspect.signature(tobj), dev)
    return problems


def _ast_params(fn: ast.FunctionDef) -> list:
    """A JAX driver function's ``(name, kind, default)`` list, read from its
    source: the drivers are scripts that set JAX options when imported."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = ([_EMPTY] * (len(pos) - len(a.defaults))
                + [ast.literal_eval(d) for d in a.defaults])
    out = [(p.arg, inspect.Parameter.POSITIONAL_OR_KEYWORD, d) for p, d in zip(pos, defaults)]
    if a.vararg:
        out.append((a.vararg.arg, inspect.Parameter.VAR_POSITIONAL, _EMPTY))
    out += [(p.arg, inspect.Parameter.KEYWORD_ONLY,
             _EMPTY if d is None else ast.literal_eval(d))
            for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    if a.kwarg:
        out.append((a.kwarg.arg, inspect.Parameter.VAR_KEYWORD, _EMPTY))
    return out


def _walk_example(mod: str) -> list:
    tree = ast.parse((ROOT / "examples" / f"{mod.split('.')[1]}.py").read_text())
    tm = importlib.import_module(f"{PORT_PKG}.{mod}")
    problems = []
    for node in tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) or node.name.startswith("_"):
            continue
        where = f"{mod}.{node.name}"
        dev = DEVIATIONS.get(where, {})
        if dev.get("absent"):
            if hasattr(tm, node.name):
                problems.append(f"{where}: listed as not carried, but the port has it")
            continue
        if not hasattr(tm, node.name):
            problems.append(f"{where}: missing from {tm.__name__}")
        elif isinstance(node, ast.FunctionDef):
            problems += _compare_params(where, _ast_params(node),
                                        inspect.signature(getattr(tm, node.name)), dev)
    return problems


WALKED = _package_modules() + _example_modules()

# JAX tools/ script -> (the port's tools module, the functions it carries):
# the stream kernels' factories (T1-T5) and the ladder's chain timer
TOOLS = {
    "stream_ladder": ("stream_ladder",
                      ("read_kernel", "write_kernel", "copy_kernel", "time_chain")),
    "pallas_pipeline_experiment": ("pipeline_experiment", ("make_pipeline",)),
    "pallas_grid_experiment": ("grid_experiment", ("grid_copy",)),
}


def _ast_default(node):
    """A default read from source: a literal, or a ``jnp`` / ``np`` dtype
    by its name (the port's torch dtype normalises to the same)."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id in ("jnp", "np"):
        return node.attr
    return ast.literal_eval(node)


def _walk_tool(script: str) -> list:
    """The JAX tool's functions against the port's, read with ``ast``:
    the scripts set JAX options when imported."""
    port, names = TOOLS[script]
    tree = ast.parse((ROOT / "tools" / f"{script}.py").read_text())
    tm = importlib.import_module(f"{PORT_PKG}.tools.{port}")
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    problems = []
    for name in names:
        a = fns[name].args
        defaults = [_EMPTY] * (len(a.args) - len(a.defaults)) + [_ast_default(d)
                                                               for d in a.defaults]
        jparams = [(p.arg, inspect.Parameter.POSITIONAL_OR_KEYWORD, d)
                   for p, d in zip(a.args, defaults)]
        if not hasattr(tm, name):
            problems.append(f"tools.{script}.{name}: missing from {tm.__name__}")
        else:
            where = f"tools.{script}.{name}"
            problems += _compare_params(where, jparams, inspect.signature(getattr(tm, name)),
                                        DEVIATIONS.get(where, {}))
    return problems


@pytest.mark.parametrize("mod", WALKED)
def test_api_walk_matches_jax(mod):
    problems = _walk_example(mod) if mod.startswith("examples.") else _walk_module(mod)
    assert not problems, "\n".join(problems)


@pytest.mark.parametrize("script", list(TOOLS))
def test_tools_walk_matches_jax(script):
    problems = _walk_tool(script)
    assert not problems, "\n".join(problems)


def test_deviations_name_jax_objects():
    """Every entry of ``DEVIATIONS`` names something the JAX package has."""
    for key in DEVIATIONS:
        mod, _, name = key.rpartition(".")
        if mod.startswith(("examples.", "tools.")):
            top, script = mod.split(".")
            tree = ast.parse((ROOT / top / f"{script}.py").read_text())
            assert name in {n.name for n in tree.body if hasattr(n, "name")}, key
        else:
            assert hasattr(importlib.import_module(f"{JAX_PKG}.{mod}"), name), key


class _Parsed(Exception):
    pass


def _cli_subparsers(main) -> dict:
    """``{subcommand: parser}`` of a CLI ``main``, read by stopping it at
    its ``parse_args``."""
    def stop(self, *args, **kwargs):
        raise _Parsed(self)

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = stop
    try:
        main(["sh"])
    except _Parsed as caught:
        parser = caught.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return sub.choices


def _flags(parser) -> dict:
    return {s: a.default for a in parser._actions for s in a.option_strings
            if s.startswith("--") and s != "--help"}


@pytest.mark.parametrize("cmd", ["sh", "droplet", "mems", "poisson"])
def test_cli_flags_match_jax(cmd):
    from iterative_solvers_tpu import cli as jcli
    from iterative_solvers_tpu_torch import cli as tcli

    want = _flags(_cli_subparsers(jcli.main)[cmd])
    got = _flags(_cli_subparsers(tcli.main)[cmd])
    assert {k: got.get(k, "<missing>") for k in want} == want
    # the one flag only the port has: the device (default the GPU)
    assert set(got) - set(want) == {"--device"} and got["--device"] == "cuda"


# -- (d) behaviour -----------------------------------------------------------

def test_pma_params_positional_order_matches_jax():
    from iterative_solvers_tpu.meshmove.pma import PMAParams as JP
    from iterative_solvers_tpu_torch.meshmove.pma import PMAParams as TP

    values = (0.02, 0.2, 0.15, 3, "float32", "high", 2.5, "float32")
    jp, tp = JP(*values), TP(*values)
    assert dataclasses.astuple(tp) == dataclasses.astuple(jp) == values
    assert tp.spectral_precision == "high" and tp.monitor_cap == 2.5
    assert dataclasses.astuple(TP()) == dataclasses.astuple(JP())


def _spd_system():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((20, 20))
    return q @ q.T / 20 + np.eye(20), rng.standard_normal(20)


def test_lgmres_result_and_recycle_unpack_as_jax():
    import jax.numpy as jnp
    from iterative_solvers_tpu.solvers import lgmres as jlgmres
    from iterative_solvers_tpu_torch.solvers import lgmres as tlgmres

    a, b = _spd_system()
    aj, at = jnp.asarray(a), torch.tensor(a)
    kw = dict(tol=1e-12, inner_m=5, outer_k=2)
    jres, jrec = jlgmres(lambda v: aj @ v, jnp.asarray(b), **kw)
    tres, trec = tlgmres(lambda v: at @ v, torch.tensor(b), **kw)
    xj, iters_j, res_j, ok_j = jres
    xt, iters_t, res_t, ok_t = tres
    assert int(iters_t) == int(iters_j) and bool(ok_t) == bool(ok_j) is True
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-10)
    assert abs(float(res_t) - float(res_j)) <= 1e-10
    # the buffers' last direction is the final cycle's roundoff-sized
    # correction normalised, so the two packages' agree in order, not in
    # digits: each az[i] is A z[i]
    zj, azj, count_j = jrec
    zt, azt, count_t = trec
    assert count_t == int(count_j) == 2 and zt.shape == zj.shape == azt.shape
    for z, az in ((np.asarray(zj), np.asarray(azj)), (zt.numpy(), azt.numpy())):
        np.testing.assert_allclose(az, z @ a.T, rtol=0, atol=1e-12)


def test_init_recycle_unpacks_as_jax():
    import jax.numpy as jnp
    from iterative_solvers_tpu.solvers import init_recycle as jinit
    from iterative_solvers_tpu_torch.solvers import init_recycle as tinit

    zj, azj, count_j = jinit((4, 5), 3, jnp.float64)
    zt, azt, count_t = tinit((4, 5), 3, torch.float64, device="cpu", store_av=True)
    assert zt.shape == zj.shape and azt.shape == azj.shape
    assert not zt.any() and not azt.any() and count_t == int(count_j) == 0
    # without store_av the port keeps no A z cache (the Newton solver's buffer)
    z, az, count = tinit((4, 5), 3, torch.float64, device="cpu")
    assert az is None and count == 0 and z.shape == (3, 4, 5)
