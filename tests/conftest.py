"""Test-session hygiene.

The full suite compiles many hundreds of XLA:CPU executables in one
process; the CPU JIT's dylib cache eventually fails with
"Failed to materialize symbols" once too many live executables
accumulate.  Dropping JAX's compilation caches between test modules keeps
the live-executable set bounded (each module re-compiles what it needs).

NOTE: deliberately no XLA_FLAGS here — tests must see 1 device; the
dry-run module and the multi-device subprocess tests set their own.
"""
import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc; skips where there is none"
    )
