"""The JAX faults of IP-Adapter that need no job, each as a ``[jax_fault]``
/ ``[port]`` pair (ROADMAP Queue 3): JAX ``generate_sd`` never reads the
adapter image (the port refuses a ``ctrl_img`` in an SD IP job's sample),
and ``build_flux_ip_collection(init="random")`` reads the kernel a quantized
base has emptied (the port's random K/V need none). Helpers:
``test_torch_ip_adapter.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flux_family import ONE_EACH, Pair
from test_torch_ip_adapter import tiny_ip_job

from ai_toolkit_tpu.adapters import ip_adapter as jip
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.models.sd_model import SDModel as JSDModel
from ai_toolkit_tpu_torch.adapters import ip_adapter as tip
from ai_toolkit_tpu_torch.jobs import get_job
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)


def test_jax_fault_generate_sd_drops_the_adapter_image(monkeypatch):
    """[jax_fault] JAX ``generate_sd`` never reads ``gen.ip_embeds``: the
    UNet's conditioning carries no image tokens, so a JAX SD IP sample
    ignores the adapter image the trainer encoded."""
    from ai_toolkit_tpu.config.modules import GenerateImageConfig as JGen
    from ai_toolkit_tpu.generation import generate_sd as jgenerate_sd

    jmodel = JSDModel(JModelConfig.from_dict({"name_or_path": "", "arch": "sd1", "model_kwargs": {"size": "tiny"}}))
    seen = []
    monkeypatch.setattr(jmodel, "encode_prompt", lambda v, prompts: {"context": jnp.zeros((len(prompts), 3, 64))})
    monkeypatch.setattr(jmodel, "predict", lambda v, x, t, cond: seen.append(sorted(cond)) or x * 0)
    monkeypatch.setattr(jmodel, "decode_latents", lambda v, lat: jnp.zeros((1, 16, 16, 3)))
    gen = JGen(prompt="p", width=16, height=16, sample_steps=1, guidance_scale=1.0)
    gen.ip_embeds = np.ones((1, 64), np.float32)
    jgenerate_sd(jmodel, {"ip": {}, "ip_proj": {}}, gen)
    assert seen and all(keys == ["context"] for keys in seen)


def test_port_refuses_the_sd_ip_sample_image(tmp_path):
    """[port] An SD IP job whose sample has a ``ctrl_img`` raises, naming the
    fault; without one it samples as JAX does (no image tokens)."""
    raw = tiny_ip_job(tmp_path, "sd1", "ip_adapter", train={"disable_sampling": False},
                      sample={"prompts": [{"prompt": "p", "ctrl_img": "/x.png"}]})
    (proc,) = get_job(raw, device="cpu").processes
    with pytest.raises(NotImplementedError, match="generate_sd never reads"):
        proc._refuse_unported()


def test_jax_fault_random_flux_ip_needs_the_emptied_kernel():
    """[jax_fault] ``build_flux_ip_collection(init="random")`` still reads
    ``img_qkv.kernel`` for its shape, which a quantized base has emptied."""
    from ai_toolkit_tpu.adapters import quantize as jquant

    p = Pair("flux", depths=ONE_EACH, seed=2)
    qtree, _ = jquant.quantize_params(p.tree, min_size=0, qtype="qfloat8")
    with pytest.raises(KeyError):
        jip.build_flux_ip_collection(qtree, 8, jax.random.key(0), init="random")


def test_port_builds_random_flux_ip_on_a_quantized_base():
    """[port] The port's ``random`` K/V need no base weight: they build on a
    quantized tiny flux, one per block, uniform in +-1/sqrt(mid)."""
    from ai_toolkit_tpu_torch.adapters import quantize as tquant

    p = Pair("flux", depths=ONE_EACH, seed=2)
    tquant.quantize_params(p.dit, min_size=0, qtype="qfloat8")
    ip = tip.build_flux_ip_collection(p.dit, 8, torch.Generator().manual_seed(0), init="random")
    assert sorted(ip) == ["double_blocks.0", "single_blocks.0"]
    for m in ip.values():
        assert m.to_k.shape == (p.model.dit_config.hidden_size, 8) and float(m.to_k.abs().max()) <= 8 ** -0.5
    tip.detach_ip(p.dit)
