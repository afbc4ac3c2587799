"""Sampling during training in the SDXL train job, the port against the JAX
job (``test_torch_job_sampling.py`` holds the check and the flux job)."""

import pytest

from test_torch_job_features import TINY_SDXL
from test_torch_job_sampling import check_sampling_matches_jax
from torch_jax_opt import jax_opt0  # noqa: F401


@pytest.mark.parametrize("model", [TINY_SDXL], ids=["sdxl"])
def test_sampling_during_training_writes_the_jax_sample_files(tmp_path, monkeypatch, model):
    check_sampling_matches_jax(tmp_path, monkeypatch, model)
