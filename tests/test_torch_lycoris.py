"""Trainable LoKr, LoHa and DoRA in the port against the JAX package on the
CPU, in f32 at tiny sizes unless a test says otherwise:

- each overlay on one ``Linear`` (forward and every gradient) against the
  JAX ``Linear`` reading its ``lokr`` / ``loha`` / ``dora`` collection, the
  same factors carried across; the LoKr kernel in bf16 bit for bit (an
  identity input: no reduction intervenes), and one bf16 adamw update of each
  overlay's leaves against JAX ``get_optimizer`` bit for bit;
- ``build_lokr`` / ``build_loha`` / ``build_dora`` on the tiny flux DiT: the
  modules, shapes and inits against JAX's build functions (DoRA's magnitude the
  base's column norms);
- one step of the port's job for each type (``lokr``, ``lycoris_loha``,
  ``dora``) and its final save against JAX ``_save`` of the same tensors
  under the keys JAX ``_build_trainable`` gives; the LoHa file read back
  into JAX's leaf layout gives JAX ``loha_delta``;
- the ``[jax_fault]`` / ``[port]`` pairs of ROADMAP Queue 3: LyCORIS skips
  scanned stacks (fault 1), the empty LoHa save (2), the networks built after
  ``quantize_params`` (3), the LoKr / LoHa keys' JAX module paths on a UNet
  (5) and the network fields no JAX module reads (6); LoCon's targets (4) are
  in ``test_torch_locon.py``; resume: JAX cannot resume these networks, the
  port refuses.

Tolerance: f32, ``rtol`` 1e-5 and ``atol`` 1e-5 of the reference's largest
value (of a gradient: of that gradient)."""

import ast
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from test_torch_flux_family import Pair, _jax_tree, fast_jit
from test_torch_train_job import _job, _train_proc
from torch_jax_opt import jax_opt0  # noqa: F401

from ai_toolkit_tpu.adapters import lora as jlora
from ai_toolkit_tpu.adapters import lycoris as jlyco
from ai_toolkit_tpu.adapters import quantize as jquant
from ai_toolkit_tpu.config.modules import ProcessConfig as JProcessConfig
from ai_toolkit_tpu.io.checkpoint import CheckpointManager as JCheckpointManager
from ai_toolkit_tpu.io.flux_import import flux_dit_rules
from ai_toolkit_tpu.jobs.train_process import SDTrainProcess as JSDTrainProcess
from ai_toolkit_tpu.ops import layers as jlayers
from ai_toolkit_tpu.train.optimizers import get_optimizer as jget_optimizer
from ai_toolkit_tpu.utils.timer import Timer as JTimer
from ai_toolkit_tpu_torch.adapters import lycoris as tlyco
from ai_toolkit_tpu_torch.adapters import quantize as tquant
from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.io.lora_file import load_loha_file
from ai_toolkit_tpu_torch.jobs import get_job
from ai_toolkit_tpu_torch.ops.layers import DoRA, Linear, LoHa, LoKr
from ai_toolkit_tpu_torch.train.optimizers import get_optimizer

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("lokr", "loha", "dora")
TINY_DEPTHS = dict(depth_double=2, depth_single=2)  # FluxConfig.tiny's own


def _close(ours, ref, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()), err_msg=what)


def _jax_leaves(kind, rng, cin=12, cout=10, r=3):
    """Seeded non-zero leaves of one module in JAX's layout."""
    def n(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)

    if kind == "lokr":
        (a, c), (b, d) = tlyco.factorize(cin), tlyco.factorize(cout)
        return {"w1": n(a, b), "w2": n(c, d), "scale": np.float32(0.7)}
    if kind == "loha":
        return {"w1a": n(cin, r), "w1b": n(r, cout), "w2a": n(cin, r), "w2b": n(r, cout), "scale": np.float32(0.7)}
    return {"a": n(cin, r), "b": n(r, cout), "scale": np.float32(0.7),
            "magnitude": np.abs(n(cout)) + 0.5}


def _port_overlay(kind, leaves):
    """The port's overlay holding JAX's leaves (LoKr in the torch layout)."""
    if kind == "lokr":
        return LoKr(torch.from_numpy(leaves["w1"].T.copy()), torch.from_numpy(leaves["w2"].T.copy()),
                    float(leaves["scale"]))
    cin, cout = leaves["w1a" if kind == "loha" else "a"].shape[0], leaves["w1b" if kind == "loha" else "b"].shape[1]
    r = leaves["w1a" if kind == "loha" else "a"].shape[1]
    m = (LoHa if kind == "loha" else DoRA)(cin, r, cout, float(leaves["scale"]))
    with torch.no_grad():
        for k, v in leaves.items():
            getattr(m, k).copy_(torch.as_tensor(v))
    return m


def _port_grad(kind, leaf, g):
    """A port parameter's gradient in JAX's layout."""
    return g.T if kind == "lokr" and leaf in ("w1", "w2") else g


def _linear_pair(kind, rng, dtype=torch.float32, cin=12, cout=10):
    kernel = (rng.standard_normal((cin, cout)) * 0.4).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    leaves = _jax_leaves(kind, rng, cin, cout)
    lin = Linear(cin, cout, dtype=dtype)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(kernel.T.copy()))
        lin.bias.copy_(torch.from_numpy(bias))
    setattr(lin, kind, _port_overlay(kind, leaves))
    return lin, kernel, bias, leaves


@pytest.mark.parametrize("kind", KINDS)
def test_overlay_forward_and_gradients_match_jax(kind):
    """One ``Linear`` with the overlay: the output, and the gradients of a
    weighted sum of it with respect to the input and every overlay leaf
    (the scale too: JAX trains the whole leaf), against the JAX ``Linear``
    reading the same leaves from its collection."""
    rng = np.random.default_rng(0)
    lin, kernel, bias, leaves = _linear_pair(kind, rng)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    w = rng.standard_normal((2, 5, 10)).astype(np.float32)
    jmod = jlayers.Linear(10, dtype=jnp.float32, param_dtype=jnp.float32)

    def f(col, xx):
        y = jmod.apply({"params": {"kernel": kernel, "bias": bias}, kind: col}, xx)
        return jnp.sum(y * w), y

    (_, ref), (gcol, gx) = fast_jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True),
                                    {k: jnp.asarray(v) for k, v in leaves.items()}, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = lin(xt)
    params = dict(getattr(lin, kind).named_parameters())
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(), [xt, *params.values()])
    _close(y.detach(), ref, "y")
    _close(grads[0], gx, "dx")
    for (leaf, _), g in zip(params.items(), grads[1:]):
        assert float(np.abs(np.asarray(gcol[leaf])).max()) > 0, leaf
        _close(_port_grad(kind, leaf, g.numpy()), gcol[leaf], f"d{leaf}")


def test_lokr_kernel_in_bf16_is_jax_bit_for_bit():
    """bf16: the kernel plus ``kron(w1, w2) * scale`` is elementwise (each
    factor and the scale cast first), so the port's kernel equals JAX's bit
    for bit; read through an identity input, whose product is exact."""
    rng = np.random.default_rng(1)
    lin, kernel, bias, leaves = _linear_pair("lokr", rng, torch.bfloat16)
    with torch.no_grad():
        lin.bias.zero_()
        ours = lin(torch.eye(12, dtype=torch.bfloat16))
    jmod = jlayers.Linear(10, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    ref = fast_jit(lambda col: jmod.apply({"params": {"kernel": jnp.asarray(kernel, jnp.bfloat16),
                                                      "bias": jnp.zeros(10, jnp.bfloat16)}, "lokr": col},
                                          jnp.eye(12, dtype=jnp.bfloat16)), leaves)
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref, np.float32))


def test_bf16_adamw_update_of_each_overlay_is_jax_bit_for_bit():
    """One adamw step on every leaf of the three overlays held in bf16, from
    the same gradients: the update is elementwise, and the port's equals JAX
    ``get_optimizer("adamw")``'s bit for bit."""
    rng = np.random.default_rng(2)
    tree = {k: {leaf: np.asarray(v, np.float32) for leaf, v in _jax_leaves(k, rng).items()} for k in KINDS}
    grads = jax.tree.map(lambda v: (rng.standard_normal(np.shape(v)) * 0.01).astype(np.float32), tree)
    bf = jax.tree.map(lambda v: jnp.asarray(v, jnp.bfloat16), tree)
    tx = jget_optimizer("adamw", 1e-3)
    upd, _ = fast_jit(tx.update, jax.tree.map(lambda v: jnp.asarray(v, jnp.bfloat16), grads), tx.init(bf), bf)
    ref = jax.tree.map(lambda p, u: np.asarray((p + u).astype(jnp.float32)), bf, upd)
    names = [(k, leaf) for k in KINDS for leaf in tree[k]]
    params = [torch.tensor(tree[k][leaf]).to(torch.bfloat16) for k, leaf in names]
    opt = get_optimizer("adamw", params, 1e-3)
    opt.step([torch.tensor(grads[k][leaf]).to(torch.bfloat16) for k, leaf in names])
    for (k, leaf), p in zip(names, params):
        np.testing.assert_array_equal(p.float().numpy(), ref[k][leaf], err_msg=f"{k}.{leaf}")


@pytest.fixture(scope="module")
def flux():
    return Pair("flux", depths=TINY_DEPTHS, seed=4)


def _spec(p, **over):
    return dict(rank=4, alpha=8.0, **over)


def _jax_paths(tree):
    """{port module name: JAX leaf} of a JAX collection over the flux DiT."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict) and any(isinstance(x, dict) for x in v.values()):
                walk(v, path)
            elif isinstance(v, dict):
                out[from_jax._flux_module(path)] = v
    walk(tree, "")
    return out


@pytest.mark.parametrize("kind,factor", [("lokr", -1), ("lokr", 4), ("loha", -1), ("dora", -1)])
def test_build_functions_match_jax(flux, kind, factor):
    """``build_<kind>`` on the tiny flux DiT (2 + 2 blocks) adapts JAX's
    modules (26) at JAX's shapes (LoKr's factors transposed, ``lokr_factor``
    honoured); the zero-initialised factor is zero, the drawn ones have
    ``init_std``; DoRA's magnitude is JAX's, the base's column norms."""
    dit = Pair("flux", depths=TINY_DEPTHS, seed=4).dit
    jspec = jlora.LoRASpec(target_patterns=flux.jmodel.lora_targets(), **_spec(flux))
    spec = LoRASpec(target_patterns=flux.model.lora_targets(), **_spec(flux))
    g = torch.Generator().manual_seed(0)
    if kind == "lokr":
        ours = tlyco.build_lokr(dit, spec, g, factor=factor)
        ref = jax.eval_shape(lambda: jlyco.build_lokr(flux.tree, jspec, jax.random.key(0), factor=factor))
    elif kind == "loha":
        ours, ref = tlyco.build_loha(dit, spec, g), jax.eval_shape(
            lambda: jlyco.build_loha(flux.tree, jspec, jax.random.key(0)))
    else:
        ours, ref = tlyco.build_dora(dit, spec, g), fast_jit(lambda: jlyco.build_dora(flux.tree, jspec,
                                                                                      jax.random.key(0)))
    ref = _jax_paths(ref)
    assert len(ours) == len(ref) == 26 and sorted(ours) == sorted(ref)
    for name, m in ours.items():
        for leaf, p in m.named_parameters():
            assert tuple(p.shape) == tuple(np.shape(_port_grad(kind, leaf, np.zeros(ref[name][leaf].shape)))), \
                (name, leaf)
        zero = {"lokr": "w2", "loha": "w2b", "dora": "b"}[kind]
        assert not getattr(m, zero).any()
        drawn = {"lokr": ["w1"], "loha": ["w1a", "w1b", "w2a"], "dora": ["a"]}[kind]
        assert all(0.002 < float(getattr(m, d).detach().std()) < 0.05 for d in drawn if getattr(m, d).numel() > 8)
        if kind == "dora":
            _close(m.magnitude.detach(), ref[name]["magnitude"], name)
            assert float(m.scale.detach()) == float(ref[name]["scale"]) == 2.0


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """One step of the port's tiny flux job for each network type (EMA on,
    so the saves hold the EMA copy)."""
    out = {}
    for kind, ntype in (("lokr", "lokr"), ("loha", "lycoris_loha"), ("dora", "dora")):
        tmp = tmp_path_factory.mktemp(kind)
        proc = _train_proc(tmp)
        proc["network"] = {"type": ntype, "linear": 4, "linear_alpha": 8}
        proc["train"]["steps"] = 1
        proc["datasets"][0]["resolution"] = [32]
        (jp,) = get_job(_job("net", proc), device="cpu").processes
        res = jp.run()
        out[kind] = (jp, res, proc)
    return out


def _jax_tree_of(kind, jp, src):
    """The port network's tensors (``src``: trainable or EMA) as JAX's leaves,
    keyed by JAX path."""
    out = {}
    for name, m in jp.net_modules.items():
        node = out
        *parents, last = from_jax.flux_jax_path(name).split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = {leaf: _port_grad(kind, leaf, src[f"{name}.{leaf}"].detach().numpy())
                      for leaf, _ in m.named_parameters()}
    return out


def _jax_build(proc, jmodel, variables):
    """JAX ``_build_trainable`` for ``proc`` (its draws made zeros: only the
    structure, the key map and the layout are read)."""
    jp = JSDTrainProcess("job", JProcessConfig.from_dict(proc))
    real = jax.random.normal
    jax.random.normal = lambda key, shape, dtype=jnp.float32: np.zeros(shape, dtype)
    try:
        return jp, jp._build_trainable(jmodel, variables, jax.random.key(0))
    finally:
        jax.random.normal = real


def _jax_save(kind, proc, tree, tmp_path, jmodel, jtree):
    """JAX ``_save`` of ``tree`` under the key map and prefix JAX
    ``_build_trainable`` gives for ``proc``; returns the file's tensors."""
    jp, (_, key_map, fmt, prefix) = _jax_build(proc, jmodel, {"dit": jtree})
    jp.timer, jp.save_root, jp.job_name = JTimer("t"), str(tmp_path), "job"
    jp.ckpt = JCheckpointManager(str(tmp_path), "job", fmt=fmt, prefix=prefix, key_map=key_map)
    jp._save(types.SimpleNamespace(trainable={kind: tree}, ema=None, opt_state={}), 1, final=True)
    with safe_open(jp.ckpt.final_path(), "np") as f:
        return {k: f.get_tensor(k) for k in f.keys()}, f.metadata()


def _file(path):
    with safe_open(path, "np") as f:
        return {k: f.get_tensor(k) for k in f.keys()}, f.metadata()


@pytest.mark.parametrize("kind", ["lokr", "dora"])
def test_saved_file_is_the_jax_jobs(jobs, flux, kind, tmp_path):
    """The job's final save (the EMA copy) against JAX ``_save`` of the same
    tensors: the same keys (LoKr: ``lora_transformer_`` and the JAX module
    path; DoRA: ``lora_transformer_`` and the BFL name), values in fp16,
    LoKr's ``alpha`` the scale, DoRA's ``dora_scale`` ``[1, out]``."""
    jp, res, proc = jobs[kind]
    assert res["lora_modules"] == 26 and res["steps"] == 1
    tr, ema = jp.state.trainable, jp.state.ema
    assert any(not torch.equal(tr[k], ema[k]) for k in tr)
    moved = {"lokr": "w2", "dora": "b"}[kind]
    assert all(tr[k].abs().max() > 0 for k in tr if k.endswith("." + moved))
    ours, meta = _file(res["save_path"])
    ref, ref_meta = _jax_save(kind, proc, _jax_tree_of(kind, jp, ema), tmp_path, flux.jmodel, flux.tree)
    assert sorted(ours) == sorted(ref) and len(ref) == 26 * (3 if kind == "lokr" else 4)
    assert meta == ref_meta == {"step": "1", "software": "ai_toolkit_tpu"}
    for k in ref:
        assert ours[k].dtype == ref[k].dtype == np.float16 and ours[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    if kind == "dora":
        assert all(ref[k].shape[0] == 1 for k in ref if k.endswith(".dora_scale"))
        assert "lora_transformer_double_blocks_0_img_attn_qkv.lora_down.weight" in ours
    else:
        assert "lora_transformer_double_0_img_qkv.lokr_w1" in ours


def test_jax_fault_loha_save_is_empty(jobs, flux, tmp_path):
    """[jax_fault] JAX ``save_adapter_file``'s keysets do not match a LoHa leaf
    and no branch writes ``loha``: the JAX job's LoHa file holds no tensor."""
    jp, _, proc = jobs["loha"]
    ref, _ = _jax_save("loha", proc, _jax_tree_of("loha", jp, jp.state.ema), tmp_path, flux.jmodel, flux.tree)
    assert ref == {}


def test_port_writes_the_lycoris_loha_file(jobs):
    """[port] The port writes LyCORIS's ``hada_w1_a`` / ``hada_w1_b`` /
    ``hada_w2_a`` / ``hada_w2_b`` / ``alpha`` in the torch orientation under
    JAX's keys (``lora_transformer_`` and the module path); read back into
    JAX's leaf layout it gives JAX ``loha_delta`` of the saved (EMA) leaves."""
    jp, res, _ = jobs["loha"]
    back = load_loha_file(res["save_path"])
    assert len(back) == 26 and "lora_transformer_double_0_img_qkv" in back
    ema = jp.state.ema
    for name in jp.net_modules:
        got = back["lora_transformer_" + from_jax.flux_jax_path(name).replace(".", "_")]
        saved = {leaf: ema[f"{name}.{leaf}"].numpy().astype(np.float16).astype(np.float32)
                 for leaf in ("w1a", "w1b", "w2a", "w2b", "scale")}
        for leaf in ("w1a", "w1b", "w2a", "w2b"):
            np.testing.assert_array_equal(got[leaf], saved[leaf], err_msg=f"{name}.{leaf}")
        rank = saved["w1a"].shape[1]
        assert abs(float(got["scale"]) - float(np.float16(saved["scale"] * rank)) / rank) < 1e-7
        _close(np.asarray(jlyco.loha_delta({k: jnp.asarray(v) for k, v in got.items()})),
               np.asarray(jlyco.loha_delta({k: jnp.asarray(v) for k, v in saved.items()})), name)


def test_jax_fault_lycoris_skips_scanned_stacks(flux):
    """[jax_fault] JAX's LyCORIS build functions take 2-D kernels only: on the tiny
    flux DiT in the scanned layout (every full size's) they adapt no module,
    where LoRA adapts the 13 stacks (unrolled: 26 each)."""
    scanned = _jax_tree(flux.dit, flux_dit_rules(scan_blocks=True))
    jspec = jlora.LoRASpec(target_patterns=flux.jmodel.lora_targets(), rank=4, alpha=4.0)

    def count(tree, kind):
        fn = {"lora": jlora.build_lora, "lokr": jlyco.build_lokr, "loha": jlyco.build_loha,
              "dora": jlyco.build_dora}[kind]
        shapes = jax.eval_shape(lambda: fn(tree, jspec, jax.random.key(0)))
        return len(jax.tree.leaves(shapes)) // {"lora": 3, "lokr": 3, "loha": 5, "dora": 4}[kind]

    assert {k: count(scanned, k) for k in ("lora", *KINDS)} == {"lora": 13, "lokr": 0, "loha": 0, "dora": 0}
    assert {k: count(flux.tree, k) for k in ("lora", *KINDS)} == {k: 26 for k in ("lora", *KINDS)}


def test_port_adapts_every_block_of_a_scanned_model(tmp_path, capsys):
    """[port] Where JAX's config scans the blocks the port still adapts every
    targeted block Linear (what JAX computes unrolled) and says so."""
    proc = _train_proc(tmp_path)
    proc["network"] = {"type": "lokr", "linear": 4}
    (jp,) = get_job(_job("scan", proc), device="cpu").processes
    model, variables = _port_model(jp)
    model.jax_scans_blocks = True
    trainable, lora = jp._build_network(model, variables["dit"], [variables["dit"]], 0)
    assert lora is None and len(jp.net_modules) == 26 and len(trainable) == 3 * 26
    assert "JAX fault not mirrored: JAX build_lokr takes 2-D kernels only" in capsys.readouterr().out


def _port_model(jp):
    """The job's model and its seeded variables, as ``run`` builds them."""
    from ai_toolkit_tpu_torch.models.registry import get_model_class

    model = get_model_class(jp.cfg.model.arch)(jp.cfg.model, "cpu")
    return model, model.init_variables(torch.Generator().manual_seed(0))


def test_jax_fault_networks_built_after_quantize_params(flux):
    """[jax_fault] JAX builds the network after ``quantize_params``, which moves
    the kernels into ``quant``: on the tiny flux DiT quantized at ``min_size``
    16, LoRA adapts 6 modules of 26 (and DoRA's magnitude would come from no
    kernel)."""
    rest, _ = jax.eval_shape(lambda: jquant.quantize_params(flux.tree, min_size=16, qtype="qint8"))
    spec = jlora.LoRASpec(target_patterns=flux.jmodel.lora_targets(), rank=4, alpha=4.0)
    n = len(jax.tree.leaves(jax.eval_shape(lambda: jlora.build_lora(rest, spec, jax.random.key(0))))) // 3
    assert n == 6


def test_port_adapts_the_dequantized_linears():
    """[port] The port keeps its behaviour on a quantized base: every targeted
    Linear is adapted (26), and DoRA's magnitude is the dequantized kernel's
    column norms."""
    p = Pair("flux", depths=TINY_DEPTHS, seed=4)
    tquant.quantize_params(p.dit, min_size=16, qtype="qint8")
    spec = LoRASpec(target_patterns=p.model.lora_targets(), rank=4, alpha=4.0)
    assert len(build_lora(Pair("flux", depths=TINY_DEPTHS, seed=4).dit, spec, torch.Generator())) == 26
    dora = tlyco.build_dora(p.dit, spec, torch.Generator())
    mods = dict(p.dit.named_modules())
    # the 20 weights quantized here are those JAX moves into ``quant`` (its LoRA keeps the other 6)
    assert len(dora) == 26 and sum(mods[n].qvalue is not None for n in dora) == 20
    for name, m in dora.items():
        _close(m.magnitude.detach(), torch.linalg.vector_norm(mods[name].dequantized(), dim=1), name)


def test_jax_fault_lycoris_keys_are_jax_module_paths_on_a_unet(tmp_path):
    """[jax_fault] JAX ``_build_trainable`` gives LoKr and LoHa no key map and
    the prefix ``lora_transformer`` on every arch, the UNets too; DoRA goes
    through the UNet's key map under ``lora_unet``."""
    from ai_toolkit_tpu.models.sd_model import SDModel as JSDModel

    proc = _sd_proc(tmp_path, "lokr")
    jmodel = JSDModel(JProcessConfig.from_dict(proc).model)
    tree = _unet_tree()
    for ntype, want in (("lokr", (None, "lora_transformer")), ("lycoris_loha", (None, "lora_transformer"))):
        proc["network"]["type"] = ntype
        _, (_, key_map, _, prefix) = _jax_build(proc, jmodel, {"unet": tree})
        assert (key_map, prefix) == want
    proc["network"]["type"] = "dora"
    _, (_, key_map, _, prefix) = _jax_build(proc, jmodel, {"unet": tree})
    assert prefix == "lora_unet" and key_map["down_1_attn_0/block_0/attn1_q"] == \
        "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q"


def _sd_proc(tmp_path, ntype):
    proc = _train_proc(tmp_path)
    proc["model"] = {"name_or_path": "", "arch": "sd1", "model_kwargs": {"size": "tiny"}}
    proc["train"]["noise_scheduler"] = "ddpm"
    proc["network"] = {"type": ntype, "linear": 4, "linear_alpha": 4}
    return proc


def _unet_tree():
    """The tiny sd1 UNet's JAX tree from the port's seeded init (JAX's import rules)."""
    from ai_toolkit_tpu.io.sd_import import unet_rules
    from ai_toolkit_tpu.io.torch_import import torch_to_tree
    from ai_toolkit_tpu_torch.models import unet as tunet

    unet = tunet.UNet2DCondition(tunet.UNetConfig.tiny())
    from ai_toolkit_tpu_torch.ops.layers import init_parameters

    init_parameters(unet, torch.Generator().manual_seed(0))
    tree, unmatched = torch_to_tree({k: v.numpy() for k, v in unet.state_dict().items()},
                                    unet_rules(len(tunet.UNetConfig.tiny().block_out_channels)))
    assert not unmatched, unmatched[:3]
    return tree


@pytest.mark.parametrize("ntype,key", [
    ("lokr", "lora_transformer_down_1_attn_0_block_0_attn1_q.lokr_w1"),
    ("loha", "lora_transformer_down_1_attn_0_block_0_attn1_q.hada_w1_a"),
    ("dora", "lora_unet_down_blocks_1_attentions_0_transformer_blocks_0_attn1_to_q.dora_scale")])
def test_port_mirrors_the_unet_lycoris_keys(tmp_path, ntype, key):
    """[port] The port's SD 1.x save carries the same keys: the JAX module
    paths under ``lora_transformer_`` for LoKr and LoHa, the diffusers names
    under ``lora_unet_`` for DoRA."""
    from ai_toolkit_tpu_torch.io.checkpoint import CheckpointManager
    from ai_toolkit_tpu_torch.train.state import TrainState

    (jp,) = get_job(_job("sd", _sd_proc(tmp_path, ntype)), device="cpu").processes
    model, variables = _port_model(jp)
    trainable, _ = jp._build_network(model, variables["unet"], [variables["unet"]], 0)
    state = TrainState(trainable, get_optimizer("adamw", list(trainable.values()), 1e-3))
    path = jp._save(CheckpointManager(str(tmp_path), "sd"), state, None, torch.Generator(), 1, final=True)
    keys = set(_file(path)[0])
    assert key in keys and len(keys) == len(jp.net_modules) * {"lokr": 3, "loha": 5, "dora": 4}[ntype]


def _net_reads(path: str, names=("net", "cfg")) -> set[str]:
    from ai_toolkit_tpu.config.modules import NetworkConfig as JNetworkConfig

    fields = {f.name for f in dataclasses.fields(JNetworkConfig)}
    out = set()
    for node in ast.walk(ast.parse(open(os.path.join(ROOT, path)).read())):
        if isinstance(node, ast.Attribute) and node.attr in fields and (
                isinstance(node.value, ast.Name) and node.value.id in names
                or isinstance(node.value, ast.Attribute) and node.value.attr == "network"):
            out.add(node.attr)
    return out


def test_jax_fault_network_fields_no_module_reads():
    """[jax_fault] No module of the JAX package reads ``network.dropout``,
    ``transformer_only`` or ``lokr_full_rank`` (an AST walk of every file
    for ``<network>.<field>``)."""
    reads = set()
    for dirpath, _, files in os.walk(os.path.join(ROOT, "ai_toolkit_tpu")):
        for f in files:
            if f.endswith(".py"):
                reads |= _net_reads(os.path.relpath(os.path.join(dirpath, f), ROOT), names=("net", "cfg", "ncfg"))
    assert {"rank", "lokr_factor", "only_if_contains"} & reads or "linear" in reads
    assert not {"dropout", "transformer_only", "lokr_full_rank"} & reads


@pytest.mark.parametrize("field,value", [("dropout", 0.1), ("transformer_only", True), ("lokr_full_rank", True)])
def test_port_mirrors_the_unread_network_fields(tmp_path, capsys, field, value):
    """[port] The port reads none of them either, and prints a line for each one set."""
    proc = _train_proc(tmp_path)
    proc["network"] = {"type": "lokr", "linear": 4, field: value}
    (jp,) = get_job(_job("unread", proc), device="cpu").processes
    model, variables = _port_model(jp)
    jp._build_network(model, variables["dit"], [variables["dit"]], 0)
    assert f"JAX fault mirrored: network.{field} {value!r} is not read" in capsys.readouterr().out


@pytest.mark.parametrize("ntype", ["lokr", "loha", "dora"])
def test_a_rerun_of_these_networks_is_refused(jobs, ntype):
    """JAX resumes a LoRA or LoRM alone (its resume reads LoRA keys into the
    'lora' tree): a rerun of a LoKr / LoHa / DoRA job over its saves raises,
    naming it, where JAX would start the network afresh."""
    jp, _, proc = jobs[ntype]
    (again,) = get_job(_job("net", proc), device="cpu").processes
    with pytest.raises(NotImplementedError, match="cannot"):
        again.run()


@pytest.mark.parametrize("over,match", [
    ({"train": {"diff_output_preservation": True}}, "adapter-off prediction"),
    ({"train": {"guidance_loss": "polarity"}}, "guidance_loss 'polarity' on network 'lokr'"),
    ({"network": {"type": "ia3"}}, "only LoRA, LoCon, LoKr"),
])
def test_what_stays_refused(tmp_path, over, match):
    """A prior knob or a guidance loss on a LoKr network (both need the
    network off or scaled, which JAX does to the 'lora' tree alone), and a
    network type JAX does not build, raise naming their cause."""
    proc = _train_proc(tmp_path)
    proc["network"] = {"type": "lokr", "linear": 4}
    for key, val in over.items():
        proc[key] = {**proc[key], **val}
    (jp,) = get_job(_job("refused", proc), device="cpu").processes
    with pytest.raises(NotImplementedError, match=match):
        jp._refuse_unported()
