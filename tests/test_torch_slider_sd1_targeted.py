"""The three ``targeted`` guidance kinds of the port (``targeted``,
``targeted_polarity``, ``targeted_flow``) on SD 1.x's UNet against JAX
``make_guided_train_step``'s loss: the loss and every LoRA gradient, DDPM
integer timesteps and the noise injected, on the cut tiny sd1 UNet of
``test_torch_slider_sd1.py`` (its fixture) at the same tolerance."""

import pytest
import torch
from test_torch_slider_sd1 import check_sd1, sd1_side  # noqa: F401 (the fixture)
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["targeted", "targeted_polarity", "targeted_flow"])
def test_sd1_targeted_kinds_match_jax(sd1_side, kind, monkeypatch):  # noqa: F811
    check_sd1(sd1_side, kind, monkeypatch)
