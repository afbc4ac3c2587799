"""Checkpoint loading of the SDXL arch, the port against the JAX package
(``test_torch_checkpoint_load.py`` holds the check and the other archs), in
a file of its own so its JAX compiles run on another worker."""

import pytest

from test_torch_checkpoint_load import check_checkpoint_loads


@pytest.mark.parametrize("arch", ["sdxl"])
def test_checkpoint_loads_into_jax_and_the_port_alike(arch, tmp_path):
    check_checkpoint_loads(arch, tmp_path)
