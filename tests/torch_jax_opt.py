"""A fixture for the port's test files: the JAX references they compile
while their tests run are built with most of XLA's optimizations off
(``jax_disable_most_optimizations``: backend optimization level 0, LLVM's
expensive passes skipped), which takes much less compile time on the CPU,
and none of them is written to the persistent compile cache
(``tests/conftest.py`` keeps one under ``~/.cache``): a parity test compiles
each reference once, so the write (about a second for a large program)
buys nothing.
The comparisons and their tolerances are unchanged; the flag is restored
when the file's tests end, so no other file's programs see it.

Use: ``from torch_jax_opt import jax_opt0  # noqa: F401`` in a test file.
A test whose check is bit for bit (or within an ULP) against a JAX program
takes :func:`full_jax_opt` as well: XLA's default level for its run, so
the reference keeps the fusions (and roundings) it is pinned to.
:func:`seeded_init` gives a flax ``init``'s tree with seeded values at its
shapes, traced and not compiled, where a reference needs no particular
init."""

import jax
import numpy as np
import pytest


@pytest.fixture(scope="module", autouse=True)
def jax_opt0():
    prev = jax.config.read("jax_disable_most_optimizations")
    prev_min = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_disable_most_optimizations", True)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", float("inf"))
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", prev_min)


@pytest.fixture
def full_jax_opt():
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", False)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


def filled_fan_in(shapes, seed):
    """``test_torch_lumina2.filled`` with each kernel (dense or conv) at normal / sqrt of
    its whole fan-in (every axis but the last), the scale of JAX's
    ``lecun_normal``, and norm scales 1 + 0.1 normal: deep conv stacks (the
    VAEs) stay near unit scale."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            v = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name.endswith(("['scale']", "['gamma']")):
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            v = 0.1 * rng.standard_normal(s.shape)
        return v.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def seeded_init(init, key, *args):
    """``init(key, *args)`` (a flax ``init``) as :func:`filled_fan_in` values
    at its shapes, traced and not compiled; equal keys give equal values."""
    seed = int(np.asarray(jax.random.key_data(key)).astype(np.uint64).sum()) % (2 ** 31)
    return filled_fan_in(jax.eval_shape(init, key, *args), seed)
