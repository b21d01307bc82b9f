"""setup_s: seconds from process start to the first timed step (imports,
the kernel library loaded or built, the state made from the seed, the
warm-up steps), less the seconds the benchmark spends in its own plain
code making the state (``bench_own`` in the set-up split: the droplet's
prepared state), which no change to the program moves; host clock."""


def read(run):
    return run.setup_s
