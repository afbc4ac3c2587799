"""Checkpoint loading of the SDXL arch, the port against the JAX package
(``test_torch_checkpoint_load.py`` holds the check and the other archs), in
a file of its own so its JAX compiles run on another worker. The seeded
source is the port's tiny init as the JAX tree (``test_torch_sd15.port_init_as_jax``),
which also serves as the JAX loader's template: no JAX init to compile."""

import pytest

from test_torch_checkpoint_load import _INITS, check_checkpoint_loads
from test_torch_sd15 import port_init_as_jax
from torch_jax_opt import jax_opt0  # noqa: F401


@pytest.mark.parametrize("arch", ["sdxl"])
def test_checkpoint_loads_into_jax_and_the_port_alike(arch, tmp_path, monkeypatch):
    tree = port_init_as_jax(arch, seed=11)
    monkeypatch.setitem(_INITS, arch, lambda key: tree)
    check_checkpoint_loads(arch, tmp_path)
