"""The benchmark of the PyTorch and CUDA port (``iterative_solvers_tpu_torch``).

``python -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once (see ``portbench/run.py``).  The
package imports nothing of JAX or of the JAX package, and reads nothing of
the repository outside this folder but ``BENCHMARK.json`` and the program
it measures.
"""
