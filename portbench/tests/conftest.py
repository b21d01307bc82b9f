"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
repository root (CPU, a few minutes); the ``gpu`` ones need a card."""
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")
    torch.set_num_threads(2)
