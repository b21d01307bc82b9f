"""Drivers of the port (counterparts of the JAX package's ``examples/``):
``python -m iterative_solvers_tpu_torch.examples.<name>``."""
