"""LoRM (low-rank module replacement) in the port against the JAX package on
the CPU, in f32 at tiny sizes: ``build_lorm``'s ranks and ``a @ b`` in every
extract mode, ``parameter_threshold`` and the scanned layout's rule (each
block at the largest rank of its stack) against JAX ``build_lorm`` (SVD
signs differ between LAPACK builds, so the factors themselves are not
compared), the ``Linear`` that reads the factors in place of its freed
kernel against the JAX ``Linear`` with a ``lorm`` collection, and the job:
one step, its PEFT save against JAX ``_save`` of the same factors, and the
resume, which restores the run exactly.

Tolerance: f32, ``rtol`` 1e-5 and ``atol`` 1e-5 of the reference's largest
value."""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from threadpoolctl import threadpool_limits
from test_torch_flux_family import Pair, _jax_tree, fast_jit
from test_torch_train_job import _job, _train_proc
from torch_jax_opt import jax_opt0  # noqa: F401

from ai_toolkit_tpu.adapters import lorm as jlorm
from ai_toolkit_tpu.config.modules import ProcessConfig as JProcessConfig
from ai_toolkit_tpu.io.checkpoint import CheckpointManager as JCheckpointManager
from ai_toolkit_tpu.io.flux_import import flux_dit_rules
from ai_toolkit_tpu.jobs.train_process import SDTrainProcess as JSDTrainProcess
from ai_toolkit_tpu.ops import layers as jlayers
from ai_toolkit_tpu.utils.timer import Timer as JTimer
from ai_toolkit_tpu_torch.adapters import lorm as tlorm
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.jobs import get_job
from ai_toolkit_tpu_torch.ops.layers import Linear, LoRM

torch.set_num_threads(1)
TINY_DEPTHS = dict(depth_double=2, depth_single=2)
MODES = [("fixed", 8.0), ("threshold", 1.0), ("ratio", 0.25), ("quantile", 0.5), ("percentile", 0.3),
         ("percentage", 0.5)]


def _close(ours, ref, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()), err_msg=what)


@pytest.fixture(scope="module")
def flux():
    return Pair("flux", depths=TINY_DEPTHS, seed=6)


def _jax_lorm(tree, mode, param, targets, threshold=0):
    spec = jlorm.LoRMSpec(extract_mode=mode, extract_mode_param=param, parameter_threshold=threshold,
                          target_patterns=targets)
    with threadpool_limits(1):  # numpy's SVDs of small kernels: BLAS threads only contend with other workers
        return jlorm.build_lorm(tree, spec)


def _port_lorm(flux, mode, param, scanned=False, threshold=0):
    dit = copy.deepcopy(flux.dit)  # build_lorm frees the weights it factors
    spec = tlorm.LoRMSpec(extract_mode=mode, extract_mode_param=param, parameter_threshold=threshold,
                          target_patterns=flux.model.lora_targets())
    return dit, *tlorm.build_lorm(dit, spec, scanned=scanned)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) and "a" in v:
            out[path] = v
        elif isinstance(v, dict):
            out.update(_leaves(v, path))
    return out


@pytest.mark.parametrize("mode,param", MODES)
def test_ranks_and_products_match_jax(flux, mode, param):
    """Each extract mode on the tiny flux DiT: the modules replaced, each
    rank, ``a @ b`` (the best rank-r approximation) and the stats equal
    JAX's; the factored weights are freed where JAX deletes the kernels."""
    ref, slim, jstats = _jax_lorm(flux.tree, mode, param, flux.jmodel.lora_targets())
    dit, ours, stats = _port_lorm(flux, mode, param)
    ref = {from_jax._flux_module(p): v for p, v in _leaves(ref).items()}
    assert sorted(ours) == sorted(ref) and len(ours) == 26
    assert {k: stats[k] for k in ("modules", "params_before", "params_after")} == \
        {k: jstats[k] for k in ("modules", "params_before", "params_after")}
    mods = dict(dit.named_modules())
    for name, m in ours.items():
        assert m.a.shape == ref[name]["a"].shape and m.b.shape == ref[name]["b"].shape, name
        _close((m.a @ m.b).detach(), ref[name]["a"] @ ref[name]["b"], name)
        assert mods[name].weight is None and mods[name].qvalue is None
    assert "kernel" not in slim["double_0"]["img_qkv"] and "kernel" in slim["img_in"]
    assert sorted(stats["ranks"]) == sorted(jstats["ranks"])


def test_parameter_threshold_matches_jax(flux):
    """Kernels with no more elements than ``parameter_threshold`` are kept,
    as in JAX (the tiny DiT's 64 x 64 and 64 x 192 ones here)."""
    ref, _, jstats = _jax_lorm(flux.tree, "ratio", 0.25, flux.jmodel.lora_targets(), threshold=64 * 192)
    _, ours, stats = _port_lorm(flux, "ratio", 0.25, threshold=64 * 192)
    assert sorted(ours) == sorted(from_jax._flux_module(p) for p in _leaves(ref)) and 0 < len(ours) < 26
    assert stats["modules"] == jstats["modules"]


def test_scanned_layout_factors_each_block_at_its_stacks_largest_rank(flux):
    """Where JAX's config scans the blocks (every full size), JAX factors a
    ``[L, in, out]`` stack per layer at the largest rank any layer selects;
    the port does the same over the same-named Linear of each block."""
    scanned = _jax_tree(flux.dit, flux_dit_rules(scan_blocks=True))
    ref, _, jstats = _jax_lorm(scanned, "quantile", 0.5, flux.jmodel.lora_targets())
    _, ours, stats = _port_lorm(flux, "quantile", 0.5, scanned=True)
    assert stats["modules"] == jstats["modules"] == 13 and sorted(stats["ranks"]) == sorted(jstats["ranks"])
    n = 0
    for path, leaf in _leaves(ref).items():
        stack, _, mod = path.split("/", 2)  # double_blocks/block/<mod>
        for i in range(leaf["a"].shape[0]):
            name = from_jax._flux_module(f"{stack.split('_')[0]}_{i}/{mod}")
            assert ours[name].a.shape == leaf["a"][i].shape, name
            _close((ours[name].a @ ours[name].b).detach(), leaf["a"][i] @ leaf["b"][i], name)
            n += 1
    assert n == len(ours) == 26


def test_lorm_linear_matches_jax():
    """A ``Linear`` whose kernel LoRM replaced: output and the gradients of
    the input, ``a`` and ``b`` against the JAX ``Linear`` with the ``lorm``
    collection and no kernel."""
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal(s).astype(np.float32) * 0.3 for s in ((12, 4), (4, 10)))
    bias = rng.standard_normal(10).astype(np.float32)
    x, w = rng.standard_normal((3, 12)).astype(np.float32), rng.standard_normal((3, 10)).astype(np.float32)
    lin = Linear(12, 10)
    with torch.no_grad():
        lin.bias.copy_(torch.from_numpy(bias))
    lin.replace_by_lorm(LoRM(torch.from_numpy(a), torch.from_numpy(b)))
    assert lin.weight is None and lin.compute_dtype == torch.float32
    jmod = jlayers.Linear(10, dtype=jnp.float32, param_dtype=jnp.float32)

    def f(col, xx):
        y = jmod.apply({"params": {"bias": bias}, "lorm": col}, xx)
        return jnp.sum(y * w), y

    (_, ref), (gcol, gx) = fast_jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True),
                                    {"a": a, "b": b, "scale": np.float32(1.0)}, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = lin(xt)
    gxt, ga, gb = torch.autograd.grad((y * torch.from_numpy(w)).sum(), [xt, lin.lorm.a, lin.lorm.b])
    for ours, want, what in ((y.detach(), ref, "y"), (gxt, gx, "dx"), (ga, gcol["a"], "da"), (gb, gcol["b"], "db")):
        _close(ours, want, what)


def _lorm_proc(tmp_path, steps):
    proc = _train_proc(tmp_path)
    proc["network"] = {"type": "lorm", "network_kwargs": {"extract_mode": "ratio", "extract_mode_param": 0.25}}
    proc["train"]["steps"] = steps
    proc["datasets"][0]["resolution"] = [32]
    return proc


def test_lorm_job_saves_the_jax_jobs_file(flux, tmp_path):
    """One step of the tiny flux LoRM job: its final save (the EMA copy)
    against JAX ``_save`` of the same factors: PEFT keys under the JAX module
    paths (``transformer.double_0.img_qkv.lora_A.weight``), fp16 values,
    ``network_type: lorm``."""
    proc = _lorm_proc(tmp_path / "port", 1)
    (jp,) = get_job(_job("lorm", proc), device="cpu").processes
    res = jp.run()
    ema = jp.state.ema
    tree = {}
    for name in jp.net_modules:
        node = tree
        *parents, last = from_jax.flux_jax_path(name).split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = {"a": ema[f"{name}.a"].numpy(), "b": ema[f"{name}.b"].numpy(), "scale": np.float32(1.0)}
    j = JSDTrainProcess("job", JProcessConfig.from_dict(proc))
    j.timer, j.save_root, j.job_name = JTimer("t"), str(tmp_path), "job"
    j.ckpt = JCheckpointManager(str(tmp_path), "job", fmt="peft", prefix="transformer")
    j._save(types.SimpleNamespace(trainable={"lorm": tree}, ema=None, opt_state={}), 1, final=True)
    files = []
    for path in (res["save_path"], j.ckpt.final_path()):
        with safe_open(path, "np") as f:
            files.append(({k: f.get_tensor(k) for k in f.keys()}, f.metadata()))
    (ours, meta), (ref, ref_meta) = files
    assert sorted(ours) == sorted(ref) and len(ref) == 52 and "transformer.double_0.img_qkv.lora_A.weight" in ref
    assert meta == ref_meta == {"step": "1", "network_type": "lorm", "software": "ai_toolkit_tpu"}
    for k in ref:
        assert ours[k].dtype == ref[k].dtype == np.float16
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert any(not torch.equal(ema[k], p) for k, p in jp.state.trainable.items())


def test_lorm_job_resumes_exactly(tmp_path):
    """A rerun to more steps goes on from the save and its training state:
    the factors after 1 + 1 steps equal those of 2 uninterrupted steps, bit
    for bit (the SVD of the base is deterministic, so the rebuilt factors
    match the saved state's shapes)."""
    def run(folder, steps):
        (jp,) = get_job(_job("lorm", _lorm_proc(tmp_path / folder, steps)), device="cpu").processes
        return jp, jp.run()

    run("split", 1)
    resumed, res = run("split", 2)
    whole, _ = run("whole", 2)
    assert res["start_step"] == 1 and len(res["losses"]) == 1
    for k, p in whole.state.trainable.items():
        assert torch.equal(resumed.state.trainable[k], p), k
