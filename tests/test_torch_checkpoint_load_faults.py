"""The JAX loaders' faults against the port (``test_torch_checkpoint_load.py``
holds the check, ``check_jax_loader_fault``; the Wan case is in
``test_torch_checkpoint_load_faults_wan.py``), in files of their own so
their JAX compiles run on other workers."""

import pytest

from test_torch_checkpoint_load import check_jax_loader_fault


@pytest.mark.parametrize("fault", ["hidream_transformer_only", "flux_diffusers_transformer", "clip_text_projection"])
def test_jax_loader_faults(fault, tmp_path, capsys):
    check_jax_loader_fault(fault, tmp_path, capsys)
