"""The reader of ``flux.kernel_share`` on synthetic program counters."""
from portbench.run import Run, load_reader
from portbench.tests.helpers import ROOT


def reader(name):
    return load_reader(ROOT, name).read


def test_flux_kernel_share_reads_the_programs_counters():
    run = Run()
    run.program_reading = {"counters": {"flux.calls": 196.0, "flux.kernel": 196.0}}
    assert reader("flux.kernel_share")(run) == 1.0
    run.program_reading = {"counters": {"flux.calls": 40.0, "flux.kernel": 10.0}}
    assert reader("flux.kernel_share")(run) == 0.25
    run.program_reading = {"counters": {"flux.calls": 12.0}}     # on the CPU
    assert reader("flux.kernel_share")(run) == 0.0
    run.program_reading = {"counters": {"stencil.calls": 398.0}}   # a program without them
    assert reader("flux.kernel_share")(run) is None
    assert reader("flux.kernel_share")(Run()) is None           # not inside run_cell
