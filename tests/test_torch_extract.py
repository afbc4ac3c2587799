"""LoRA extraction of the port (``adapters/extract.py``,
``jobs/extract_process.py``) against the JAX package on the CPU: the
products ``a @ b * scale`` of ``svd_extract`` and ``extract_lora_from_diff``
(2-D and stacked ``[L, in, out]`` kernels, the ``min_diff`` skip, the
shape and conv skips) against JAX's, and both modes of the job against the
JAX job's file: flat ``base_weights`` / ``tuned_weights`` files (PEFT and
kohya, and the shipped ``extract_lora.yaml`` as written at rank 32), and
two tiny sd1 LDM checkpoints written by JAX ``export_ldm_checkpoint``
through both packages' loaders (kohya ``lora_unet_...`` under the JAX key
map's names). Singular vectors are defined up to sign, so products are
compared, never factors: in f32 to ``rtol`` 1e-5 and 1e-5 of max|ref|; read
back from the fp16 files to 2e-3 of max|ref| (each side rounds its own
factors)."""

import os

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from ai_toolkit_tpu.adapters.extract import extract_lora_from_diff as jextract
from ai_toolkit_tpu.adapters.extract import svd_extract as jsvd
from ai_toolkit_tpu.config.modules import JobConfig as JJobConfig
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.io.ldm_single_file import export_ldm_checkpoint
from ai_toolkit_tpu.jobs.extract_process import ExtractLoraProcess as JExtractLoraProcess
from ai_toolkit_tpu.models.sd_model import SDModel as JSDModel
from ai_toolkit_tpu_torch.adapters.extract import extract_lora_from_diff, svd_extract
from ai_toolkit_tpu_torch.config import get_config
from ai_toolkit_tpu_torch.jobs import get_job, run_job
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _product(a, b, scale):
    a, b, scale = (np.asarray(x, np.float64) for x in (a, b, scale))
    if a.ndim == 3:
        return np.einsum("lir,lro->lio", a, b) * scale.reshape(-1, 1, 1)
    return a @ b * float(scale)


def _close(ours, ref, tol=1e-5, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=tol, atol=tol * float(np.abs(ref).max()), err_msg=what)


def _low_rank(rng, shape, rank, noise=0.0):
    d = rng.standard_normal(shape[:-1] + (rank,)) @ rng.standard_normal((rank, shape[-1])) * 0.05
    return (d + noise * rng.standard_normal(shape)).astype(np.float32)


def _kernel_trees(seed=0):
    """(base, tuned) flat ``{module: kernel}``: a rank-3 change with a little
    noise (q), a full-rank one (k), a stacked rank-2 one per layer (stack), an
    unchanged kernel (same), a change under ``min_diff`` (tiny), another shape
    (shape) and a changed conv kernel (conv): the last four are skipped."""
    rng = np.random.default_rng(seed)
    shapes = {"blk.q": (16, 24), "blk.k": (24, 8), "blk.same": (8, 8), "blk.tiny": (8, 8), "blk.shape": (8, 8),
              "stack": (3, 12, 20), "conv": (3, 3, 4, 8)}
    base = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tuned = {k: v.copy() for k, v in base.items()}
    tuned["blk.q"] += _low_rank(rng, (16, 24), 3, noise=1e-3)
    tuned["blk.k"] += 0.05 * rng.standard_normal((24, 8)).astype(np.float32)
    tuned["stack"] += np.stack([_low_rank(rng, (12, 20), 2) for _ in range(3)])
    tuned["blk.tiny"] += 1e-7
    tuned["blk.shape"] = rng.standard_normal((8, 9)).astype(np.float32)
    tuned["conv"] += 0.1
    return base, tuned


def _nested(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node.setdefault(parts[-1], {})["kernel"] = v
    return tree


def _flatten_lora(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict) and "a" in v:
            out[name] = v
        elif isinstance(v, dict):
            out.update(_flatten_lora(v, name))
    return out


@pytest.mark.parametrize("rank", [2, 4])
def test_svd_extract_products_match_jax(rank):
    """``svd_extract``'s ``a @ b`` (float64 SVD, ``sqrt(s)`` on each factor)
    against JAX's on a rank-3 difference with noise, truncated below and above
    its rank; the factors' shapes and f32."""
    rng = np.random.default_rng(1)
    diff = _low_rank(rng, (16, 24), 3, noise=1e-3)
    a, b = svd_extract(torch.from_numpy(diff), rank)
    ja, jb = jsvd(diff, rank)
    assert a.dtype == b.dtype == torch.float32 and tuple(a.shape) == ja.shape and tuple(b.shape) == jb.shape
    _close(a.numpy() @ b.numpy(), ja @ jb)


@pytest.mark.parametrize("alpha", [None, 2.0])
def test_extract_lora_from_diff_matches_jax(alpha):
    """``extract_lora_from_diff`` at rank 4 against JAX's: the same modules
    (the unchanged, sub-``min_diff``, reshaped and conv kernels skipped), the
    same scales (alpha / rank), each product ``a @ b * scale`` to f32
    rounding; a stacked kernel as one leaf per layer (``stack.<l>``) against
    the layers of JAX's stacked leaf and its ``[L]`` scale."""
    base, tuned = _kernel_trees()
    ref = _flatten_lora(jextract(_nested(base), _nested(tuned), rank=4, alpha=alpha))
    ours = extract_lora_from_diff({k: torch.from_numpy(v) for k, v in base.items()},
                                  {k: torch.from_numpy(v) for k, v in tuned.items()}, rank=4, alpha=alpha)
    assert sorted(ref) == ["blk.k", "blk.q", "stack"]
    stack = ref.pop("stack")
    ref.update({f"stack.{i}": {k: v[i] for k, v in stack.items()} for i in range(3)})
    assert sorted(ours) == sorted(ref) == ["blk.k", "blk.q", "stack.0", "stack.1", "stack.2"]
    for name, leaf in ours.items():
        np.testing.assert_array_equal(leaf["scale"].numpy(), np.asarray(ref[name]["scale"], np.float32))
        _close(_product(leaf["a"], leaf["b"], leaf["scale"]), _product(**ref[name]), what=name)
    want = tuned["blk.q"] - base["blk.q"]  # rank 4 >= its rank 3: the change, up to the noise
    np.testing.assert_allclose(_product(**{k: v.numpy() for k, v in ours["blk.q"].items()}), want,
                               atol=2e-2 * np.abs(want).max())


def _job(tmp_path, name, **extras):
    return {"job": "extract", "config": {"name": name, "process": [{
        "type": "extract_lora", "training_folder": str(tmp_path / "out"), **extras}]}}


def _jax_run(raw):
    return JExtractLoraProcess(raw["config"]["name"], JJobConfig.from_raw(raw).processes[0]).run()


def _read(path):
    from safetensors import safe_open

    with safe_open(path, framework="np") as f:
        return {k: f.get_tensor(k) for k in f.keys()}, dict(f.metadata())


def _file_products(flat):
    """{module: a @ b * alpha/rank} of a PEFT (alpha = rank) or kohya file."""
    out = {}
    for k, down in flat.items():
        for d, u in ((".lora_A.weight", ".lora_B.weight"), (".lora_down.weight", ".lora_up.weight")):
            if k.endswith(d):
                mod = k[: -len(d)]
                rank = down.shape[0]
                alpha = float(flat.get(mod + ".alpha", rank))
                out[mod] = down.T.astype(np.float64) @ flat[mod + u].T.astype(np.float64) * alpha / rank
    return out


def _same_files(ours_path, ref_path):
    ours, meta = _read(ours_path)
    ref, jmeta = _read(ref_path)
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in ref.items()}
    assert all(v.dtype == np.float16 for v in ours.values())
    assert meta == jmeta == {"extracted": "true", "rank": meta["rank"]}
    refp = _file_products(ref)
    for mod, p in _file_products(ours).items():
        _close(p, refp[mod], tol=2e-3, what=mod)
    return ours


@pytest.mark.parametrize("fmt", ["peft", "kohya"])
def test_flat_weights_mode_matches_the_jax_job(fmt, tmp_path):
    """Mode 1: ``base_weights`` / ``tuned_weights`` (flat ``<module>.kernel``
    files, beside a bias the walk ignores): the file's keys (a stack's per
    layer, ``stack.0`` ...), shapes, fp16, metadata and products against the
    JAX job's, in PEFT and in kohya (the JAX default prefix,
    ``lora_transformer``, with each module's alpha)."""
    base, tuned = _kernel_trees()
    paths = {}
    for side, flat in (("base", base), ("tuned", tuned)):
        paths[side] = str(tmp_path / f"{side}.safetensors")
        save_file({**{f"{k}.kernel": v for k, v in flat.items()}, "blk.q.bias": np.zeros(24, np.float32)},
                  paths[side])
    kw = dict(base_weights=paths["base"], tuned_weights=paths["tuned"], rank=4, alpha=2.0, format=fmt)
    ref = _jax_run(_job(tmp_path, "jx", output_path=str(tmp_path / "jax.safetensors"), **kw))
    (result,) = run_job(_job(tmp_path, "pt", **kw), device="cpu")
    assert result["output"] == str(tmp_path / "out" / "pt_extracted.safetensors")
    assert ref["modules"] == 3  # JAX counts the stack once; its file, like ours, holds each layer
    ours = _same_files(result["output"], ref["output"])
    assert result["modules"] == len(_file_products(_read(ref["output"])[0])) == 5
    want = {"peft": "transformer.stack.2.lora_A.weight", "kohya": "lora_transformer_stack_2.alpha"}[fmt]
    assert want in ours


def test_shipped_file_as_written(tmp_path):
    """configs/examples/extract_lora.yaml as written (rank 32, PEFT) but for
    its two paths: the modules, shapes and products of the JAX job's file;
    at rank 32 every change is recovered to f32 rounding in memory."""
    base, tuned = _kernel_trees(seed=2)
    for side, flat in (("base", base), ("tuned", tuned)):
        save_file({f"{k}.kernel": v for k, v in flat.items()}, str(tmp_path / f"{side}.safetensors"))
    raw = get_config(os.path.join(ROOT, "configs", "examples", "extract_lora.yaml"))
    proc = raw["config"]["process"][0]
    proc.update(base_weights=str(tmp_path / "base.safetensors"), tuned_weights=str(tmp_path / "tuned.safetensors"),
                training_folder=str(tmp_path / "out"))
    assert proc["rank"] == 32 and proc["format"] == "peft"
    job = get_job(raw, device="cpu")
    (result,) = job.run()
    ref = _jax_run(raw | {"config": {**raw["config"], "name": "jax_extracted"}})
    _same_files(result["output"], ref["output"])
    for name, leaf in job.processes[0].lora.items():
        module, _, layer = name.partition(".") if name.startswith("stack.") else (name, "", "")
        want = tuned[module] - base[module]
        want = want[int(layer)] if layer else want
        got = _product(leaf["a"], leaf["b"], leaf["scale"])
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), err_msg=name)


def _seeded(shapes, rng):
    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_checkpoint_mode_matches_the_jax_job(tmp_path, monkeypatch):
    """Mode 2: ``base_model`` / ``extract_model``, two tiny sd1 LDM files
    written by JAX ``export_ldm_checkpoint`` (the tuned one with rank-2
    changes to an attention projection, a feed-forward input, a
    ``proj_in``, a resnet's ``time_emb_proj`` and ``time_embedding.linear_1``),
    loaded by both packages (the JAX init is the seeded tree, not a compile):
    the kohya ``lora_unet_...`` file of the JAX job (its key map's names,
    each module's alpha), the same products, and nothing for the UNet's
    unchanged modules."""
    jm = JSDModel(JModelConfig.from_dict({"name_or_path": "", "arch": "sd1", "model_kwargs": {"size": "tiny"}}))
    rng = np.random.default_rng(0)
    base = _seeded(jax.eval_shape(jm.init_variables, jax.random.key(0)), rng)
    tuned = jax.tree.map(np.copy, base)
    changed = [("down_1_attn_0", "block_0", "attn1_q"), ("up_0_attn_1", "block_0", "ff_in"),
               ("mid_attn", "proj_in"), ("down_0_res_0", "time_emb_proj"), ("time_fc1",)]
    for path in changed:
        node = tuned["unet"]
        for p in path:
            node = node[p]
        node["kernel"] = node["kernel"] + _low_rank(rng, node["kernel"].shape, 2)
    files = {}
    for side, variables in (("base", base), ("tuned", tuned)):
        files[side] = str(tmp_path / f"{side}.safetensors")
        export_ldm_checkpoint(jm, variables, files[side], dtype=np.float32)
    monkeypatch.setattr(JSDModel, "init_variables", lambda self, rng: jax.tree.map(np.copy, base))
    kw = dict(base_model=files["base"], extract_model=files["tuned"], arch="sd1", model_kwargs={"size": "tiny"},
              rank=4)
    ref = _jax_run(_job(tmp_path, "jx", output_path=str(tmp_path / "jax.safetensors"), **kw))
    (result,) = run_job(_job(tmp_path, "pt", **kw), device="cpu")
    assert result["modules"] == ref["modules"] == len(changed)
    ours = _same_files(result["output"], ref["output"])
    assert sorted(k[: -len(".alpha")] for k in ours if k.endswith(".alpha")) == sorted([
        "lora_unet_down_blocks_1_attentions_0_transformer_blocks_0_attn1_to_q",
        "lora_unet_up_blocks_1_attentions_1_transformer_blocks_0_ff_net_0_proj",
        "lora_unet_mid_block_attentions_0_proj_in", "lora_unet_down_blocks_0_resnets_0_time_emb_proj",
        "lora_unet_time_embedding_linear_1"])
