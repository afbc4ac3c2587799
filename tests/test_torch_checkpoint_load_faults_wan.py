"""The JAX Wan loader's fault against the port: an i2v checkpoint's vision
tower is never loaded (``test_torch_checkpoint_load.py`` holds the check)."""

import pytest

from test_torch_checkpoint_load import check_jax_loader_fault
from torch_jax_opt import jax_opt0  # noqa: F401


@pytest.mark.parametrize("fault", ["wan_no_vision_tower"])
def test_jax_loader_faults(fault, tmp_path, capsys):
    check_jax_loader_fault(fault, tmp_path, capsys)
