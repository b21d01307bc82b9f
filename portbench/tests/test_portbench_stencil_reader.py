"""The reader of ``stencil.kernel_share`` on synthetic program counters."""
from portbench.run import Run, load_reader
from portbench.tests.helpers import ROOT


def reader(name):
    return load_reader(ROOT, name).read


def test_stencil_kernel_share_reads_the_programs_counters():
    run = Run()
    run.program_reading = {"counters": {"stencil.calls": 398.0, "stencil.kernel": 398.0}}
    assert reader("stencil.kernel_share")(run) == 1.0
    run.program_reading = {"counters": {"stencil.calls": 400.0, "stencil.kernel": 100.0}}
    assert reader("stencil.kernel_share")(run) == 0.25
    run.program_reading = {"counters": {"stencil.calls": 12.0}}     # on the CPU
    assert reader("stencil.kernel_share")(run) == 0.0
    run.program_reading = {"counters": {"mems.residual_evals": 48.0}}   # no such counter
    assert reader("stencil.kernel_share")(run) is None
    assert reader("stencil.kernel_share")(Run()) is None           # not inside run_cell
