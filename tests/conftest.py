"""Test configuration: run the whole suite on CPU with x64 and 8 virtual devices.

Numerical-parity gates (SURVEY.md §4) need f64 against scipy oracles, and the
distribution tests need a multi-device mesh; both are provided by the JAX CPU
backend with ``xla_force_host_platform_device_count=8``.  TPU fast-path is
exercised by ``bench.py`` on the real chip, not by the unit suite.
"""
import os

# must be set before the first JAX backend initialisation
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")
