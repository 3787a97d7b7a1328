"""Shared test fixtures.

NOTE: XLA_FLAGS / device-count overrides are deliberately NOT set here — smoke
tests and benchmarks must see the real single-device CPU. Only
``repro/launch/dryrun.py`` (a separate process) forces 512 host devices.
Multi-device CPU tests (shard_map / pipeline) spawn subprocesses instead.

``hypothesis`` is optional: several modules import it at top level for
property-based sweeps, but offline environments can't install it. When the
real package is missing we register a minimal stub in ``sys.modules`` BEFORE
test modules are collected — strategy constructors become inert placeholders
and ``@given`` turns the test into a skip — so the suite still collects and
every non-property test runs.
"""

import os
import sys

import jax
import pytest

# Determinism for hypothesis + jax.random interplay.
os.environ.setdefault("JAX_PLATFORMS", "")


def _install_hypothesis_stub() -> None:
    import types

    def _strategy(*args, **kwargs):
        return None  # inert placeholder — never drawn (given() skips first)

    def given(*_args, **_kwargs):
        def deco(fn):
            def wrapper():  # no params: given-supplied args must not look like fixtures
                pytest.skip("hypothesis not installed — property test skipped")

            # NOT functools.wraps: __wrapped__ would re-expose the original
            # signature and pytest would hunt fixtures for the given-params.
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            return wrapper

        return deco

    def settings(*_args, **_kwargs):
        return lambda fn: fn

    def _permissive(_name):
        return _strategy

    root = types.ModuleType("hypothesis")
    root.given = given
    root.settings = settings
    root.assume = lambda *a, **k: True
    root.__getattr__ = _permissive

    st = types.ModuleType("hypothesis.strategies")
    st.__getattr__ = _permissive
    extra = types.ModuleType("hypothesis.extra")
    extra.__getattr__ = _permissive
    hnp = types.ModuleType("hypothesis.extra.numpy")
    hnp.__getattr__ = _permissive

    root.strategies = st
    root.extra = extra
    extra.numpy = hnp
    sys.modules["hypothesis"] = root
    sys.modules["hypothesis.strategies"] = st
    sys.modules["hypothesis.extra"] = extra
    sys.modules["hypothesis.extra.numpy"] = hnp


try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    _install_hypothesis_stub()


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(20260714)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (repro_torch kernels); skips without a card",
    )
