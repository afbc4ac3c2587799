"""Conv LoRA (LoCon: ``network.conv``, ``type: locon``) in the port against
the JAX package on the CPU, in f32 at tiny sizes: the ``Conv`` overlay
(forward and every gradient) against the JAX ``Conv`` with a ``lora``
collection at the UNet's three conv shapes, the modules LoCon adapts on the
tiny SD 1.x UNet against JAX ``build_lora`` (the ``[jax_fault]`` / ``[port]``
pair: the UNet's targets name no conv, so ``locon`` trains what ``lora``
trains unless ``only_if_contains`` reaches the resnets), and one step of the
port's locon job with its kohya save against JAX ``flatten_lora`` of the
same factors under the JAX job's key map, read back onto a fresh UNet.

Tolerance: f32, ``rtol`` 1e-5 and ``atol`` 1e-5 of the reference's largest
value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flux_family import fast_jit
from test_torch_lycoris import _port_model, _sd_proc, _unet_tree
from test_torch_train_job import _job
from torch_jax_opt import jax_opt0  # noqa: F401

from ai_toolkit_tpu.adapters import lora as jlora
from ai_toolkit_tpu.config.modules import NetworkConfig as JNetworkConfig
from ai_toolkit_tpu.io import lora_file as jlora_file
from ai_toolkit_tpu.jobs.train_process import SDTrainProcess as JSDTrainProcess
from ai_toolkit_tpu.models.unet import unet_lora_targets as jtargets
from ai_toolkit_tpu.ops import layers as jlayers
from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, attach_lora, build_lora, conv_count
from ai_toolkit_tpu_torch.config.modules import NetworkConfig
from ai_toolkit_tpu_torch.io.lora_file import load_lora_file
from ai_toolkit_tpu_torch.jobs import get_job
from ai_toolkit_tpu_torch.ops.layers import Conv, ConvLoRA

torch.set_num_threads(1)
REACH = ["down_", "up_", "mid"]  # only_if_contains that reaches the resnets (JAX paths and the port's names)


def _close(ours, ref, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()), err_msg=what)


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1)], ids=["3x3", "3x3_stride2", "1x1"])
def test_conv_overlay_matches_jax(k, stride):
    """A ``Conv`` with a ``ConvLoRA``: ``a`` a k x k conv at the layer's
    stride and padding, ``b`` a 1x1 conv, times the scale, then the bias;
    the output and the gradients of the input, ``a``, ``b`` and the scale."""
    rng = np.random.default_rng(k + stride)
    cin, cout, r = 6, 8, 3
    kernel, a = (rng.standard_normal(s).astype(np.float32) * 0.3 for s in ((k, k, cin, cout), (k, k, cin, r)))
    b, bias = rng.standard_normal((1, 1, r, cout)).astype(np.float32) * 0.3, rng.standard_normal(cout).astype(np.float32)
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    pad = k // 2
    jmod = jlayers.Conv(cout, (k, k), strides=(stride, stride), padding=((pad, pad), (pad, pad)),
                        dtype=jnp.float32, param_dtype=jnp.float32)
    w = rng.standard_normal((2, 8 // stride, 8 // stride, cout)).astype(np.float32)

    def f(col, xx):
        y = jmod.apply({"params": {"kernel": kernel, "bias": bias}, "lora": col}, xx)
        return jnp.sum(y * w), y

    (_, ref), (gcol, gx) = fast_jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True),
                                    {"a": a, "b": b, "scale": np.float32(0.6)}, x)
    conv = Conv(cin, cout, k, stride=stride, padding=pad)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
        conv.bias.copy_(torch.from_numpy(bias))
    conv.lora = ConvLoRA(cin, r, cout, k, 0.6)
    with torch.no_grad():
        conv.lora.a.copy_(torch.from_numpy(a.transpose(3, 2, 0, 1).copy()))
        conv.lora.b.copy_(torch.from_numpy(b.transpose(3, 2, 0, 1).copy()))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = conv(xt)
    gxt, ga, gb, gs = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                                          [xt, conv.lora.a, conv.lora.b, conv.lora.scale])
    _close(y.detach(), ref, "y")
    _close(gxt, gx, "dx")
    _close(ga.numpy().transpose(2, 3, 1, 0), gcol["a"], "da")
    _close(gb.numpy().transpose(2, 3, 1, 0), gcol["b"], "db")
    _close(gs, gcol["scale"], "dscale")


@pytest.fixture(scope="module")
def unet_tree():
    return _unet_tree()


def _net(cls, only):
    return cls.from_dict({"type": "locon", "linear": 4, "linear_alpha": 4, "conv_alpha": 2,
                          **({"network_kwargs": {"only_if_contains": only}} if only else {})})


@pytest.mark.parametrize("only", [None, REACH], ids=["default_targets", "only_if_contains"])
def test_jax_fault_locon_trains_what_lora_trains(unet_tree, only):
    """[jax_fault] ``type: locon`` is LoRA with ``conv`` set; the UNet's
    targets (``unet_lora_targets``) name no conv, so JAX adapts 84 modules and
    no conv, unless ``only_if_contains`` (which bypasses the patterns) reaches
    the resnets: 115 modules, 23 of them convs."""
    net = _net(JNetworkConfig, only)
    assert (net.type, net.conv) == ("lora", 4)
    spec = jlora.LoRASpec.from_network_config(net, target_patterns=jtargets())
    tree = jax.eval_shape(lambda: jlora.build_lora(unet_tree, spec, jax.random.key(0)))
    mods = [v for v in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, dict) and "a" in x)]
    n_conv = sum(len(m["a"].shape) == 4 for m in mods)
    assert (len(mods), n_conv) == ((84, 0) if only is None else (115, 23))


@pytest.mark.parametrize("only", [None, REACH], ids=["default_targets", "only_if_contains"])
def test_port_adapts_the_same_modules(only):
    """[port] The port adapts the same 84 / 115 modules and 0 / 23 convs
    (``only_if_contains`` meets the diffusers names here, JAX's paths there),
    at scale conv_alpha / conv_rank."""
    from ai_toolkit_tpu_torch.models import unet as tunet

    unet = tunet.UNet2DCondition(tunet.UNetConfig.tiny())
    spec = LoRASpec.from_network_config(_net(NetworkConfig, only), target_patterns=tunet.unet_lora_targets())
    lora = build_lora(unet, spec, torch.Generator().manual_seed(0))
    assert (len(lora), conv_count(lora)) == ((84, 0) if only is None else (115, 23))
    convs = [m for m in lora.values() if isinstance(m, ConvLoRA)]
    assert all(float(m.scale.detach()) == 0.5 and not m.b.any() for m in convs)


def test_locon_job_saves_the_jax_kohya_file(tmp_path, capsys):
    """One step of the tiny sd1 locon job with ``only_if_contains`` reaching
    the resnets: 23 conv modules trained; its kohya save (the EMA copy)
    equals JAX ``flatten_lora`` of the same factors under the JAX job's key
    map (conv ``lora_down`` ``[r, in, kh, kw]``, ``lora_up`` ``[out, r, 1,
    1]``, ``alpha`` = scale * rank), and reads back onto a fresh UNet."""
    proc = _sd_proc(tmp_path, "locon")
    proc["network"]["network_kwargs"] = {"only_if_contains": REACH}
    proc["train"]["steps"] = 1
    proc["datasets"][0]["resolution"] = [32]
    (jp,) = get_job(_job("locon", proc), device="cpu").processes
    res = jp.run()
    assert "LoCon: 23 conv modules at rank 4" in capsys.readouterr().out
    ema = jp.state.ema
    assert all(jp.state.trainable[f"{n}.b"].abs().max() > 0 for n, m in jp.lora.items() if isinstance(m, ConvLoRA))
    jtree = {}
    for name, m in jp.lora.items():
        conv = isinstance(m, ConvLoRA)
        a, b = ema[f"{name}.a"].numpy(), ema[f"{name}.b"].numpy()
        node = jtree
        *parents, last = jp.model.jax_module_path(name).split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = {"a": a.transpose(2, 3, 1, 0) if conv else a, "b": b.transpose(2, 3, 1, 0) if conv else b,
                      "scale": ema[f"{name}.scale"].numpy()}
    from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
    from ai_toolkit_tpu.models.sd_model import SDModel as JSDModel

    jmodel = JSDModel(JModelConfig.from_dict(proc["model"]))
    ref = jlora_file.flatten_lora(jtree, key_map=JSDTrainProcess._key_map(jmodel, jtree), fmt="kohya",
                                  prefix="lora_unet")
    from safetensors import safe_open

    with safe_open(res["save_path"], "np") as f:
        ours = {k: f.get_tensor(k) for k in f.keys()}
    assert sorted(ours) == sorted(ref) and len(ref) == 3 * 115
    assert ours["lora_unet_down_blocks_0_resnets_0_conv1.lora_down.weight"].shape == (4, 32, 3, 3)
    assert ours["lora_unet_down_blocks_0_resnets_0_conv1.lora_up.weight"].shape == (32, 4, 1, 1)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    model, variables = _port_model(jp)
    tree, _ = load_lora_file(res["save_path"], module_names=[n for n, _ in variables["unet"].named_modules()])
    attached = attach_lora(variables["unet"], tree)
    assert conv_count(attached) == 23 and sorted(attached) == sorted(jp.lora)
    for name, m in attached.items():
        np.testing.assert_array_equal(m.b.detach().numpy(), ema[f"{name}.b"].numpy().astype(np.float16)
                                      .astype(np.float32), err_msg=name)
