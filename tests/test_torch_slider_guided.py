"""The five paired-image guidance kinds of the port (``targeted``,
``targeted_polarity``, ``direct``, ``tnt``, ``targeted_flow``:
``train/slider.guided_loss``) against JAX ``make_guided_train_step``'s loss
on the tiny flux cut to one double and one single block: the loss and
every LoRA gradient, t and the noise injected, at ``network_weight`` 0.8.
Tolerance as in ``test_torch_slider.py`` (1e-4 of the largest reference
value: flux's ``time_in``)."""

import pytest
import torch
from test_torch_slider import _flux_side, check_objective

from ai_toolkit_tpu_torch.train.slider import GUIDED_KINDS
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def flux_side():
    return _flux_side()


@pytest.mark.parametrize("kind", GUIDED_KINDS)
def test_flux_guided_kinds_match_jax(flux_side, kind, monkeypatch):
    check_objective(flux_side, kind, monkeypatch)
