"""The DFE v7 / v8 aux losses in one LoRA step of the port against JAX
``train/step.make_train_step`` on the CPU, in f32 at tiny sizes: the
prediction stepped to x0 (v8: a partial step of 0.035), decoded by the tiny
flux VAE inside the differentiated graph and read by the tiny TIPSv2 DPT
(``test_torch_dfe.py`` holds the fixtures, the module tests and v1 / v2).

Tolerance: f32, ``rtol`` 1e-4 on the loss and the aux loss, an ``atol`` of
1e-4 of the largest LoRA gradient on each gradient (flux's ``time_in``, as
in the flux-family tests)."""

import pytest
from test_torch_dfe import _hold, _step_pair, flux, tips  # noqa: F401 (fixtures)

from ai_toolkit_tpu.models import dfe as jdfe
from ai_toolkit_tpu.models import tipsv2 as jtips
from ai_toolkit_tpu.samplers.flowmatch import FlowMatchSchedule as JSchedule
from ai_toolkit_tpu_torch.models import dfe as tdfe
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule


@pytest.mark.parametrize("version", ["v7", "v8"])
def test_dfe7_step_matches_jax(flux, tips, version, monkeypatch):
    """The pixel-space loss: the prediction stepped to x0 (v8: a partial
    step of 0.035 against the target noised to it), decoded through the tiny
    VAE and the TIPSv2 DPT, the target side under no_grad, weighted by
    1 / max(t, 0.1)^2; its gradient reaches the LoRA through the decoder."""
    _, _, module, params = tips
    partial = version == "v8"
    vae, jvae = {"vae": flux.vae}, {"vae": flux.jvae}
    aux = tdfe.make_dfe7_loss(module, FlowMatchSchedule(), 0.5, lambda lat: flux.model.decode_latents(vae, lat),
                              partial_step=partial)
    jaux = jdfe.make_dfe7_loss(jtips.TIPSv2DPT(jtips.TIPSConfig.tiny()), params, JSchedule(), 0.5,
                               lambda lat: flux.jmodel.decode_latents(jvae, lat), partial_step=partial)
    _hold(*_step_pair(flux, aux, jaux, monkeypatch))
