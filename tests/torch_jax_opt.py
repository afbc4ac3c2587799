"""A fixture for the port's test files: the JAX references they compile
while their tests run are built with most of XLA's optimizations off
(``jax_disable_most_optimizations``: backend optimization level 0, LLVM's
expensive passes skipped), which takes much less compile time on the CPU.
The comparisons and their tolerances are unchanged; the flag is restored
when the file's tests end, so no other file's programs see it.

Use: ``from torch_jax_opt import jax_opt0  # noqa: F401`` in a test file."""

import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def jax_opt0():
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
