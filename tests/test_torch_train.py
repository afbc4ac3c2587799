"""The port's training modules against the JAX package at tiny f32 sizes on the
CPU: the LoRA overlay on Linear, build_lora's targets and parameter count,
the LoRA tree converter and file layout, the VAE encoder, the flux_shift
timesteps, AdamW8bit + clipping + EMA, one training step's loss and LoRA
gradients, and the dots_flash checkpoint policy. Inputs, noise and timesteps
are made with numpy and handed to both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_toolkit_tpu.adapters import lora as jlora
from ai_toolkit_tpu.io import lora_file as jlora_file
from ai_toolkit_tpu.io.flux_import import flux_dit_rules
from ai_toolkit_tpu.io.sd_import import vae_rules
from ai_toolkit_tpu.io.torch_import import torch_to_tree
from ai_toolkit_tpu.models import flux_dit as jdit
from ai_toolkit_tpu.models import vae as jvae
from ai_toolkit_tpu.ops.layers import Linear as JLinear
from ai_toolkit_tpu.ops.rope import image_position_ids, multi_axis_rope
from ai_toolkit_tpu.samplers.flowmatch import FlowMatchSchedule as JSchedule
from ai_toolkit_tpu.train.losses import compute_loss as jcompute_loss
from ai_toolkit_tpu.train.optimizers import get_optimizer as jget_optimizer
from ai_toolkit_tpu.train.state import TrainState as JTrainState
from ai_toolkit_tpu_torch.adapters import lora as tlora
from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.io import lora_file as tlora_file
from ai_toolkit_tpu_torch.models import flux_dit as tdit
from ai_toolkit_tpu_torch.models import vae as tvae
from ai_toolkit_tpu_torch.models.flux_model import FluxModel
from ai_toolkit_tpu_torch.ops import layers as tlayers
from ai_toolkit_tpu_torch.ops.kernels import flash_attention as tfa
from ai_toolkit_tpu_torch.ops.layers import init_parameters
from ai_toolkit_tpu_torch.ops.rope import multi_axis_rope as t_multi_axis_rope
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.optimizers import get_optimizer
from ai_toolkit_tpu_torch.train.state import TrainState
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, train_loss
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)
# one block of each kind keeps the JAX compiles small
TINY_1_1 = dict(depth_double=1, depth_single=1)


def _port_dit(seed=0, **over):
    cfg = dataclasses.replace(tdit.FluxConfig.tiny(), **{**TINY_1_1, **over})
    return init_parameters(tdit.FluxDiT(cfg), torch.Generator().manual_seed(seed)).eval()


def _jax_params(module, scan_blocks=False):
    flat = {k: v.numpy() for k, v in module.state_dict().items() if ".lora." not in k}
    tree, unmatched = torch_to_tree(flat, flux_dit_rules(scan_blocks=scan_blocks))
    assert not unmatched, unmatched[:8]
    return tree


def test_lora_linear_matches_jax():
    """y = x W + b + ((x a) b) scale, f32: summation order only."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 24), dtype=np.float32)
    w = rng.standard_normal((24, 40), dtype=np.float32) * 0.2
    bias = rng.standard_normal((40,), dtype=np.float32)
    a = rng.standard_normal((24, 4), dtype=np.float32)
    b = rng.standard_normal((4, 40), dtype=np.float32)
    ref = JLinear(40, dtype=jnp.float32, param_dtype=jnp.float32).apply(
        {"params": {"kernel": w, "bias": bias}, "lora": {"a": a, "b": b, "scale": np.float32(0.5)}}, x)
    lin = tlayers.Linear(24, 40)
    tlora.attach_lora(lin, {"": {"a": torch.from_numpy(a), "b": torch.from_numpy(b),
                                 "scale": torch.tensor(0.5)}})
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(bias))
        out = lin(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    tlora.merge_lora(lin)
    assert lin.lora is None
    with torch.no_grad():
        np.testing.assert_allclose(lin(torch.from_numpy(x)).numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("scan_blocks", [False, True])
def test_build_lora_targets_count_and_tree_converter_match_jax(scan_blocks):
    """The adapted modules, their factor shapes and the parameter count equal
    the JAX package's under the name map of io/from_jax.flux_lora_tree, for
    the unrolled and the scanned JAX layouts."""
    module = _port_dit()
    params = _jax_params(module, scan_blocks)
    spec_j = jlora.LoRASpec(rank=4, alpha=8.0, target_patterns=jdit.flux_lora_targets())
    jtree = jlora.build_lora(params, spec_j, jax.random.key(0))
    ported = tlora.build_lora(module, tlora.LoRASpec(rank=4, alpha=8.0,
                                                     target_patterns=tdit.flux_lora_targets()),
                              torch.Generator().manual_seed(0))
    converted = from_jax.flux_lora_tree(jax.tree.map(np.asarray, jtree))
    assert sorted(converted) == sorted(ported)
    assert len(ported) == 13  # 10 Linears of the double block, 3 of the single
    for name, m in ported.items():
        assert converted[name]["a"].shape == m.a.shape and converted[name]["b"].shape == m.b.shape
        assert float(converted[name]["scale"]) == float(m.scale.detach()) == 2.0
        assert float(m.b.detach().abs().max()) == 0.0 and 0.005 < float(m.a.detach().std()) < 0.015
    if not scan_blocks:  # JAX's count includes the per-layer [L] scales of a scanned tree
        assert tlora.count_lora_params(ported) == jlora.count_lora_params(jtree)


def test_lora_file_round_trip_and_keys_match_jax(tmp_path):
    module = _port_dit()
    params = _jax_params(module)
    jtree = jax.tree.map(np.asarray, jlora.build_lora(
        params, jlora.LoRASpec(rank=4, alpha=4.0, target_patterns=jdit.flux_lora_targets()),
        jax.random.key(1)))
    jtree = jax.tree.map(lambda x: x + 0.01 if x.ndim == 2 else x, jtree)  # b non-zero
    jpath, tpath = str(tmp_path / "jax.safetensors"), str(tmp_path / "port.safetensors")
    jlora_file.save_lora_file(jtree, jpath, key_map=jdit.flux_lora_key_map(jtree), fmt="peft",
                              prefix="transformer")
    tree = from_jax.flux_lora_tree(jtree)
    tlora_file.save_lora_file(tree, tpath, metadata={"step": 3})
    from safetensors.numpy import load_file

    ref, ours = load_file(jpath), load_file(tpath)
    assert sorted(ours) == sorted(ref)
    assert all(k.startswith("transformer.") for k in ours)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    back, meta = tlora_file.load_lora_file(tpath)
    assert meta["step"] == "3" and sorted(back) == sorted(tree)
    for name, leaf in tree.items():  # fp16 storage; PEFT carries no alpha: scale 1
        np.testing.assert_allclose(back[name]["b"].numpy(), leaf["b"].numpy(), atol=1e-3)
        assert float(back[name]["scale"]) == 1.0
    lora_j, _ = jlora_file.load_lora_file(tpath)
    assert len(jlora.lora_paths(lora_j)) == len(tree)


def test_vae_encode_matches_jax():
    cfg = tvae.VAEConfig.tiny()
    module = init_parameters(tvae.AutoencoderKL(cfg), torch.Generator().manual_seed(5)).eval()
    flat = {k: v.numpy() for k, v in module.state_dict().items()}
    tree, unmatched = torch_to_tree(flat, vae_rules(len(cfg.channel_multipliers), cfg.layers_per_block))
    assert not unmatched and "encoder" in tree
    module.load_state_dict(from_jax.vae_state_dict(tree))
    x = np.random.default_rng(5).uniform(-1, 1, (2, 16, 12, 3)).astype(np.float32)
    jcfg = jvae.VAEConfig.tiny(scaling_factor=cfg.scaling_factor, shift_factor=cfg.shift_factor)
    ref = jax.jit(lambda p, xx: jvae.AutoencoderKL(jcfg).apply(
        {"params": p}, xx, method=jvae.AutoencoderKL.encode))(tree, jnp.asarray(x))
    with torch.inference_mode():
        out = module.encode(torch.from_numpy(x))
    assert out.shape == (2, 8, 6, cfg.latent_channels)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("kind,seq", [("flux_shift", 4096), ("flux_shift", 256), ("shift", None),
                                      ("linear", None)])
def test_timesteps_from_uniform_match_jax(kind, seq):
    key = jax.random.key(3)
    ref = JSchedule().sample_timesteps(key, 6, timestep_type=kind, image_seq_len=seq)
    u = jax.random.uniform(key, (6,), minval=1e-4, maxval=1.0 - 1e-4)
    ours = FlowMatchSchedule().timesteps_from_uniform(torch.from_numpy(np.asarray(u)), kind, seq)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)
    t = FlowMatchSchedule().sample_timesteps(torch.Generator().manual_seed(0), 1000, kind, seq)
    assert float(t.min()) >= 1e-5 and float(t.max()) <= 1.0


def test_adamw8bit_clip_ema_match_jax():
    """Five steps fed the same gradients (two above the clip norm): the int8
    moments equal bit for bit, parameters and EMA within 1e-6."""
    rng = np.random.default_rng(7)
    shapes = {"a": (300, 4), "b": (4, 70), "scale": ()}  # sizes not multiples of the 256 block
    init = {k: np.asarray(rng.standard_normal(s) * 0.1, np.float32) for k, s in shapes.items()}
    jstate = JTrainState.create({}, {"lora": {"m": dict(init)}},
                                jget_optimizer("adamw8bit", 1e-2, max_grad_norm=1.0), use_ema=True)
    trainable = {k: torch.tensor(v) for k, v in init.items()}
    state = TrainState(trainable, get_optimizer("adamw8bit", list(trainable.values()), 1e-2,
                                                max_grad_norm=1.0), use_ema=True)
    apply = jax.jit(lambda st, g: st.apply_gradients(g, ema_decay=0.9))
    for step in range(5):
        scale = 0.3 if step % 2 else 0.01  # global norm above / below 1
        grads = {k: np.asarray(rng.standard_normal(s) * scale, np.float32) for k, s in shapes.items()}
        jstate = apply(jstate, {"lora": {"m": grads}})
        state.apply_gradients([torch.from_numpy(grads[k]) for k in trainable], ema_decay=0.9)
    adam = jstate.opt_state[1][0]
    assert int(adam.count) == state.optimizer.count == 5
    for i, k in enumerate(trainable):
        for ours, ref in ((state.optimizer.mu[i], adam.mu["lora"]["m"][k]),
                          (state.optimizer.nu[i], adam.nu["lora"]["m"][k])):
            np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref.q), err_msg=k)
            np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref.scale), rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(trainable[k].numpy(), np.asarray(jstate.trainable["lora"]["m"][k]),
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(state.ema[k].numpy(), np.asarray(jstate.ema["lora"]["m"][k]),
                                   atol=1e-6, err_msg=k)


def _step_inputs(cfg, b=2, hh=8, ww=8, n_txt=5, seed=11):
    rng = np.random.default_rng(seed)
    c = cfg.in_channels // 4
    return {
        "x0": rng.standard_normal((b, hh, ww, c), dtype=np.float32),
        "noise": rng.standard_normal((b, hh, ww, c), dtype=np.float32),
        "t": np.asarray([0.3, 0.85], np.float32)[:b],
        "txt": rng.standard_normal((b, n_txt, cfg.context_dim), dtype=np.float32),
        "y": rng.standard_normal((b, cfg.vec_dim), dtype=np.float32),
        "ids": image_position_ids(hh // 2, ww // 2, text_len=n_txt),
    }


def test_train_step_loss_and_lora_grads_match_jax():
    """One step's loss and the gradients of every LoRA a, b and scale against
    jax.value_and_grad of FluxDiT.apply with the lora collection, add_noise,
    target and compute_loss; b is non-zero, else the gradient of a is zero."""
    module = _port_dit(seed=2)
    params = _jax_params(module)
    lora = tlora.build_lora(module, tlora.LoRASpec(rank=4, alpha=4.0,
                                                   target_patterns=tdit.flux_lora_targets()),
                            torch.Generator().manual_seed(3))
    gb = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in lora.values():
            m.b.normal_(0.0, 0.05, generator=gb)
    cfg = module.cfg
    inp = _step_inputs(cfg)

    # JAX: the package's own functions, noise and t injected
    jcfg = dataclasses.replace(jdit.FluxConfig.tiny(), **TINY_1_1)
    jlora_tree = jlora.build_lora(params, jlora.LoRASpec(rank=4, alpha=4.0,
                                                         target_patterns=jdit.flux_lora_targets()),
                                  jax.random.key(0))
    key_map = jdit.flux_lora_key_map(jlora_tree)
    jlora_tree = {path.split("/")[0]: {} for path in key_map}
    for path, name in key_map.items():
        node = jlora_tree
        for part in path.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[path.split("/")[-1]] = {k: jnp.asarray(getattr(lora[name], k).detach().numpy())
                                     for k in ("a", "b", "scale")}
    sched = JSchedule()
    pe = multi_axis_rope(jnp.asarray(inp["ids"])[None], list(cfg.axes_dim), cfg.theta)
    x0, noise, t = (jnp.asarray(inp[k]) for k in ("x0", "noise", "t"))

    def jloss(lora_tree):
        noisy = sched.add_noise(x0, noise, t)
        out = jdit.FluxDiT(jcfg).apply(
            {"params": params, "lora": lora_tree}, jdit.pack_latents_cmajor(noisy),
            jnp.asarray(inp["txt"]), t, jnp.asarray(inp["y"]), pe, jnp.ones((2,)))
        pred = jdit.unpack_latents_cmajor(out, x0.shape[1], x0.shape[2])
        return jcompute_loss(pred, sched.target(x0, noise, t))[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(jlora_tree)

    # the port: FluxModel.predict through train_loss
    model = FluxModel(ModelConfig.from_dict({"name_or_path": "", "arch": "flux",
                                             "model_kwargs": {"size": "tiny"}}), device="cpu")
    variables = {"dit": module}
    batch = {"latents": torch.from_numpy(inp["x0"]), "cond": {
        "txt": torch.from_numpy(inp["txt"]), "y": torch.from_numpy(inp["y"]),
        "pe": t_multi_axis_rope(torch.from_numpy(inp["ids"])[None], list(cfg.axes_dim), cfg.theta),
        "guidance": torch.ones(2)}}
    loss, _ = train_loss(lambda noisy, tt, cond: model.predict(variables, noisy, tt, cond),
                         FlowMatchSchedule(), TrainStepConfig(), batch,
                         torch.from_numpy(inp["noise"]), torch.from_numpy(inp["t"]))
    names = [(path, name, k) for path, name in key_map.items() for k in ("a", "b", "scale")]
    grads = torch.autograd.grad(loss, [getattr(lora[name], k) for _, name, k in names])

    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for (path, name, k), g in zip(names, grads):
        node = ref_grads
        for part in path.split("/"):
            node = node[part]
        ref = np.asarray(node[k])
        assert np.abs(ref).max() > 0, f"{name}.{k}: zero reference gradient"
        # f32 through two blocks and the loss: summation order only
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-5 * max(1.0, np.abs(ref).max()),
                                   err_msg=f"{name}.{k}")


def test_dots_flash_checkpointing_grads_equal_and_forward_runs_once(monkeypatch):
    """head_dim 64 routes attention through the flash custom op. Under the
    dots_flash policy its forward runs once per block per step and the LoRA
    gradients equal the un-checkpointed ones."""
    module = _port_dit(seed=6, hidden_size=128, num_heads=2, head_dim=64, axes_dim=(16, 24, 24))
    lora = tlora.build_lora(module, tlora.LoRASpec(rank=4, alpha=4.0,
                                                   target_patterns=tdit.flux_lora_targets()),
                            torch.Generator().manual_seed(7))
    with torch.no_grad():
        for m in lora.values():
            m.b.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(8))
    cfg = module.cfg
    inp = _step_inputs(cfg, seed=12)
    args = [tdit.pack_latents_cmajor(torch.from_numpy(inp["x0"])), torch.from_numpy(inp["txt"]),
            torch.from_numpy(inp["t"]), torch.from_numpy(inp["y"]),
            t_multi_axis_rope(torch.from_numpy(inp["ids"])[None], list(cfg.axes_dim), cfg.theta),
            torch.ones(2)]
    params = [p for m in lora.values() for p in m.parameters()]
    calls = []
    plain = tfa.flash_attention_fwd_plain
    monkeypatch.setattr(tfa, "flash_attention_fwd_plain", lambda *a: calls.append(1) or plain(*a))

    def grads(checkpointing):
        module.gradient_checkpointing = checkpointing
        calls.clear()
        loss = module(*args).square().mean()
        out = torch.autograd.grad(loss, params)
        return out, len(calls)

    ref, n_ref = grads(False)
    ours, n = grads(True)
    assert n_ref == n == 2  # one double + one single block
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-9)
