"""Checkpoint loading for the Wan archs, the port against the JAX package on
the CPU at tiny f32 sizes (``test_torch_checkpoint_load.py`` holds the check):
Wan 2.1, the Wan 2.2 14B pair (``transformer_2/``) and the TI2V-5B, whose
``vae/config.json`` rebuilds the VAE."""

import pytest
import torch

from test_torch_checkpoint_load import check_checkpoint_loads
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["wan21", "wan22_14b", "wan22_5b"])
def test_checkpoint_loads_into_jax_and_the_port_alike(arch, tmp_path):
    check_checkpoint_loads(arch, tmp_path)
