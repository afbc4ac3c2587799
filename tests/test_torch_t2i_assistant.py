"""The T2I assistant (``adapter_assist_name_or_path``) in the port against
the JAX package on the CPU: read from a file JAX ``save_custom_adapter``
wrote, frozen through a tiny LoRA job, its residuals against JAX's apply
(1e-5 of max|ref|), left out of the adapter-off prior, the printed lines
of what JAX does not read, and the ``[jax_fault]`` / ``[port]`` pair of
ROADMAP Queue 3 (JAX skips the assistant silently without a UNet). Helpers:
``test_torch_t2i_adapter.py``."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ip_adapter import _close, run_job
from test_torch_t2i_adapter import assist_job, jax_net

from ai_toolkit_tpu.adapters import custom_adapter as jca
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.jobs import get_job
from ai_toolkit_tpu_torch.samplers.ddpm import DDPMSchedule
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, train_loss
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)


def test_assistant_reads_a_file_jax_wrote(tmp_path):
    """A T2I file written by JAX ``save_custom_adapter`` (seeded params at the
    tiny UNet's levels) is the assistant of a LoRA job: its weights, its
    residuals of a control image against JAX's apply (1e-5), and the same
    weights after the job trained (frozen)."""
    jm, params, _ = jax_net()
    path = str(tmp_path / "assist.safetensors")
    jca.save_custom_adapter(params, "t2i", path, metadata={"step": 0})
    proc, res, printed = run_job(assist_job(tmp_path, path))
    assert f"assistant adapter active: {path}" in printed and res["losses"]
    want = from_jax.t2i_state_dict(params)
    for k, v in proc.assistant.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    assert not any(p.requires_grad for p in proc.assistant.parameters())
    assert all(k.startswith("lora_") or "." in k for k in proc.state.trainable)
    x = np.random.default_rng(2).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    ref = jax.jit(lambda v: jm.apply({"params": params}, v))(jnp.asarray(x))
    with torch.no_grad():
        for o, r in zip(proc.assistant(torch.from_numpy(x)), ref):
            _close(o.numpy(), r)


def test_assistant_leaves_the_prior():
    """The adapter-off prior (here ``diff_output_preservation``) runs without
    the assistant's residuals (JAX's ``match_adapter_chance`` at 0 zeroes
    them), the prediction with them."""
    seen = []

    def predict(x, t, cond):
        seen.append(float(sum(r.abs().sum() for r in cond["adapter_residuals"])))
        return x * 0.5

    batch = {"latents": torch.ones(1, 2, 2, 4), "cond": {"adapter_residuals": (torch.ones(1, 2, 2, 4),)}}
    train_loss(predict, DDPMSchedule(), TrainStepConfig(do_prior_pred=True, diff_output_preservation=True), batch,
               torch.zeros(1, 2, 2, 4), torch.tensor([10]))
    assert seen == [16.0, 0.0]


def test_jax_fault_assistant_skipped_without_a_unet():
    """[jax_fault] JAX ``run`` builds the assistant only when the model has a
    ``unet_config``: on flux the path is read and nothing happens."""
    from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
    from ai_toolkit_tpu.jobs.train_process import SDTrainProcess as JSDTrainProcess
    from ai_toolkit_tpu.models.flux_model import FluxModel as JFluxModel

    src = inspect.getsource(JSDTrainProcess.run)
    assert 'if assist and hasattr(model, "unet_config"):' in src
    assert not hasattr(JFluxModel(JModelConfig.from_dict({"name_or_path": "", "arch": "flux",
                                                          "model_kwargs": {"size": "tiny"}})), "unet_config")


def test_port_refuses_the_assistant_without_a_unet(tmp_path):
    """[port] The port raises, naming the fault."""
    raw = assist_job(tmp_path, "/x", model={"arch": "flux"}, train={"noise_scheduler": "flowmatch"})
    (proc,) = get_job(raw, device="cpu").processes
    with pytest.raises(NotImplementedError, match="skips it silently"):
        proc._refuse_unported()


def test_unread_assist_type_and_missing_file_print(tmp_path):
    """``adapter_assist_type`` (read by no JAX module) prints a line; a path
    that is no file gives the seeded assistant, as the JAX job."""
    raw = assist_job(tmp_path, str(tmp_path / "none.safetensors"), train={"adapter_assist_type": "control_net"})
    _, res, printed = run_job(raw)
    assert "adapter_assist_type 'control_net' is not read" in printed and "is no file: seeded init" in printed
    assert res["losses"]
