"""The slider objectives of the port on SD 1.x's UNet against the JAX package
on the CPU: ``concept_slider_loss`` at multiplier 0.6, the polarity step's
loss and the guided kinds ``direct`` and ``tnt`` at ``network_weight`` 0.8
(the three ``targeted`` kinds: ``test_torch_slider_sd1_targeted.py``, which
takes this file's fixture; two files keep each within half a minute): the
loss and every LoRA gradient against JAX ``value_and_grad``, DDPM integer
timesteps and the noise injected (the epsilon targets of
``get_schedule('ddpm', 'sd1')``).
The UNet is the tiny sd1's cut to its first level (one resnet and one
spatial transformer a block, the mid block, widths unchanged), the JAX
compile of the full tiny UNet being twice as long; its weights are seeded
with numpy into the JAX tree and carried to the port by ``io/from_jax``.
Tolerance: f32, ``rtol`` 1e-5, ``atol`` 1e-5 of the largest reference value
(a gradient: of the largest gradient)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slider import KINDS, Side, check_objective

from ai_toolkit_tpu.adapters import lora as jlora
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.models.sd_model import SDModel as JSDModel
from ai_toolkit_tpu.models.unet import UNet2DCondition as JUNet
from ai_toolkit_tpu.samplers.factory import get_schedule as jget_schedule
from ai_toolkit_tpu_torch.adapters import lora as tlora
from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.models.sd_model import SDModel
from ai_toolkit_tpu_torch.models.unet import UNet2DCondition
from ai_toolkit_tpu_torch.samplers.factory import get_schedule
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)
CUT = dict(block_out_channels=(32,), transformer_layers=(1,))
CFG = {"name_or_path": "", "arch": "sd1", "model_kwargs": {"size": "tiny"}}


def _seeded(shapes, rng):
    """Numpy-seeded JAX params: kernels at 1/sqrt(fan_in), norm scales near 1."""
    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(s.shape).astype(np.float32)
        if name == "bias":
            return 0.1 * rng.standard_normal(s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def sd1_side():
    jm = JSDModel(JModelConfig.from_dict(CFG))
    jm.unet_config = dataclasses.replace(jm.unet_config, **CUT)
    jm.unet = JUNet(jm.unet_config)
    ctx_dim = jm.unet_config.cross_attention_dim
    shapes = jax.eval_shape(lambda k: jm.unet.init(k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                                                   jnp.zeros((1, 7, ctx_dim))), jax.random.key(0))["params"]
    rng = np.random.default_rng(0)
    tree = _seeded(shapes, rng)
    model = SDModel(ModelConfig.from_dict(CFG), device="cpu")
    model.unet_config = dataclasses.replace(model.unet_config, **CUT)
    unet = UNet2DCondition(model.unet_config).requires_grad_(False)
    unet.load_state_dict(from_jax.unet_state_dict(tree), strict=True)
    lora = tlora.build_lora(unet, tlora.LoRASpec(rank=4, alpha=8.0, target_patterns=model.lora_targets()),
                            torch.Generator().manual_seed(3))
    with torch.no_grad():  # b non-zero, else a's gradient is zero
        for m in lora.values():
            m.b.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(4))
    jtree = jax.tree.map(np.asarray, jax.eval_shape(lambda: jlora.build_lora(
        tree, jlora.LoRASpec(rank=4, alpha=8.0, target_patterns=jm.lora_targets()), jax.random.key(0))))
    paths = {from_jax._unet_module("/".join(p), 1): "/".join(p) for p in jlora.lora_paths(jtree)}
    assert sorted(paths) == sorted(lora)

    def fill(node, prefix=""):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if "a" in v:
                node[k] = {leaf: np.array(getattr(lora[from_jax._unet_module(path, 1)], leaf).detach().numpy())
                           for leaf in ("a", "b", "scale")}
            else:
                fill(v, path)

    jtree = jax.tree.map(lambda x: x, jtree)
    fill(jtree)
    pos, neg, noise = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(3))
    ctx = rng.standard_normal((2, 7, ctx_dim)).astype(np.float32)
    t = np.asarray([37, 811], np.int32)
    noisy = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    ctxs = [rng.standard_normal((1, 7, ctx_dim)).astype(np.float32) for _ in range(3)]
    jschedule = jget_schedule("ddpm", "sd1")
    return Side(
        predict=lambda x, tt, c: model.predict({"unet": unet}, x, tt, c), lora=lora, jpredict=jm.predict,
        mv={"unet": tree}, jtree=jtree, paths=paths, schedule=get_schedule("ddpm", "sd1"), jschedule=jschedule,
        batch={"latents": torch.from_numpy(pos), "unconditional_latents": torch.from_numpy(neg),
               "cond": {"context": torch.from_numpy(ctx)}},
        jbatch={"latents": jnp.asarray(pos), "unconditional_latents": jnp.asarray(neg),
                "cond": {"context": jnp.asarray(ctx)}},
        noise=noise, t=t,
        concept=((torch.from_numpy(noisy), torch.tensor([500]), [{"context": torch.from_numpy(c)} for c in ctxs]),
                 (jnp.asarray(noisy), jnp.asarray([500]), [{"context": jnp.asarray(c)} for c in ctxs])),
        rel=1e-5)


def check_sd1(side: Side, kind: str, monkeypatch) -> None:
    monkeypatch.setattr(type(side.jschedule), "sample_timesteps",
                        lambda self, rng, b, *args, **kwargs: jnp.asarray(side.t))
    check_objective(side, kind, monkeypatch)


@pytest.mark.parametrize("kind", [k for k in KINDS if not k.startswith("targeted")])
def test_sd1_objectives_match_jax(sd1_side, kind, monkeypatch):
    check_sd1(sd1_side, kind, monkeypatch)
