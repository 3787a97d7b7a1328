"""Test settings of the benchmark's own tests (no JAX here)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")
