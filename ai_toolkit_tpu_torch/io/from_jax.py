"""JAX parameter trees -> the port's state dicts.

Inverse of the JAX package's importer rules (``io/flux_import.flux_dit_rules``,
``io/sd_import.{clip,t5,vae}_rules``), written without jax: a tree is a nested
dict of numpy arrays in the JAX layout, and the result is keyed by the
checkpoint names the port's modules carry (BFL for the DiT, transformers for
CLIP and T5, diffusers for the VAE).

- Linear kernels ``[in, out]`` -> weights ``[out, in]``.
- MoE expert banks ``[E, in, out]`` keep the JAX layout (``flux_dit.Bank``).
- Conv kernels HWIO -> OIHW.
- Scanned ``[L, ...]`` stacks (``double_blocks/block/...``) split per block.
- Norm scales and embeddings keep their values and dtypes.
- A flux ``lora`` collection maps onto the port's module names
  (:func:`flux_lora_tree`).
- A partial DiT tree (a full fine-tune's filtered trainable tree) converts
  like a whole one; the JAX full fine-tune's flat file, keyed by
  ``_flatten_params`` (``double_0.img_mlp_moe.experts.w1.kernel``), through
  :func:`flux_dit_flat_state_dict`.
- bf16 arrays (numpy's ``ml_dtypes.bfloat16``) become bf16 tensors.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _tensor(v: np.ndarray) -> torch.Tensor:
    v = np.ascontiguousarray(v)
    if v.dtype.name == "bfloat16":  # ml_dtypes, which torch.from_numpy does not take
        return torch.from_numpy(v.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(v)


def _leaf(v: np.ndarray, leaf: str, norm_name: str) -> tuple[str, np.ndarray]:
    """(torch leaf name, array in torch layout) of one JAX leaf."""
    if leaf == "kernel":
        if v.ndim == 2:
            return "weight", v.T
        if v.ndim == 3:  # an expert bank
            return "weight", v
        if v.ndim == 4:
            return "weight", v.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {v.ndim}")
    if leaf == "scale":
        return norm_name, v
    if leaf == "bias":
        return "bias", v
    raise KeyError(leaf)


def _convert(tree: dict, module_map, norm_name: str = "weight",
             extra: dict[str, list[str]] | None = None) -> dict[str, torch.Tensor]:
    """``module_map(path) -> torch module name`` for each JAX module path;
    ``extra`` maps whole JAX leaf paths (embeddings) to torch keys."""
    sd: dict[str, torch.Tensor] = {}
    for path, v in _flatten(tree).items():
        if extra and path in extra:
            for key in extra[path]:
                sd[key] = _tensor(v)
            continue
        mod, leaf = path.rsplit("/", 1)
        name, arr = _leaf(v, leaf, norm_name)
        sd[f"{module_map(mod)}.{name}"] = _tensor(arr)
    return sd


def _lookup(table: list[tuple[str, str]], path: str, family: str) -> str:
    for pat, tmpl in table:
        m = re.fullmatch(pat, path)
        if m:
            return tmpl.format(*m.groups())
    raise KeyError(f"{family}: no port module for JAX path '{path}'")


# ---- flux DiT (BFL names; the hidream MoE modules under the same blocks) ----

_MOE = [
    ("gate", "gate"), ("experts/(w1|w3|w2)", "experts.{0}"), ("shared/(w1|w3|w2)", "shared.{0}"),
]
_DOUBLE = [
    ("img_qkv", "img_attn.qkv"), ("txt_qkv", "txt_attn.qkv"),
    ("img_proj", "img_attn.proj"), ("txt_proj", "txt_attn.proj"),
    ("img_qknorm/(query_norm|key_norm)", "img_attn.norm.{0}"),
    ("txt_qknorm/(query_norm|key_norm)", "txt_attn.norm.{0}"),
    ("img_mlp_in", "img_mlp.0"), ("img_mlp_out", "img_mlp.2"),
    ("txt_mlp_in", "txt_mlp.0"), ("txt_mlp_out", "txt_mlp.2"),
    ("img_mod/mod", "img_mod.lin"), ("txt_mod/mod", "txt_mod.lin"),
    *((f"img_mlp_moe/{pat}", f"img_mlp.{tmpl}") for pat, tmpl in _MOE),
    ("txt_mlp_swiglu/(w1|w3|w2)", "txt_mlp.{0}"),
]
_SINGLE = [
    ("linear1", "linear1"), ("linear2", "linear2"), ("mod/mod", "modulation.lin"),
    ("qknorm/(query_norm|key_norm)", "norm.{0}"),
    ("qkv", "qkv"), ("proj", "proj"),  # the MoE single block
    *((f"mlp_moe/{pat}", f"mlp.{tmpl}") for pat, tmpl in _MOE),
]
_FLUX_TOP = [
    ("img_in", "img_in"), ("txt_in", "txt_in"),
    ("(time_in|vector_in|guidance_in)/(in_layer|out_layer)", "{0}.{1}"),
    ("final_proj", "final_layer.linear"), ("final_mod", "final_layer.adaLN_modulation.1"),
]


def _flux_module(path: str) -> str:
    m = re.fullmatch(r"(double|single)_(\d+)/(.+)", path)
    if m:
        kind, i, rest = m.groups()
        table = _DOUBLE if kind == "double" else _SINGLE
        return f"{kind}_blocks.{i}." + _lookup(table, rest, "flux dit")
    return _lookup(_FLUX_TOP, path, "flux dit")


def _unscan(tree: dict) -> dict:
    """Scanned layout ``{double,single}_blocks/block/<mod>/<leaf>`` with a
    leading layer axis -> unrolled ``{double,single}_<i>/<mod>/<leaf>``."""
    out = {k: v for k, v in tree.items() if k not in ("double_blocks", "single_blocks")}
    for kind in ("double", "single"):
        stacked = tree.get(f"{kind}_blocks")
        if stacked is None:
            continue
        for path, v in _flatten(stacked["block"]).items():
            for i in range(v.shape[0]):
                node = out.setdefault(f"{kind}_{i}", {})
                *mods, leaf = path.split("/")
                for mname in mods:
                    node = node.setdefault(mname, {})
                node[leaf] = v[i]
    return out


def flux_dit_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """JAX ``FluxDiT`` params (unrolled or scanned, whole or a subtree of
    leaves) -> ``FluxDiT`` state dict entries."""
    return _convert(_unscan(tree), _flux_module, norm_name="scale")


def flux_dit_flat_state_dict(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The JAX full fine-tune's save, ``{'.'-joined param path: array}``
    (``_flatten_params``), -> ``FluxDiT`` state dict entries."""
    tree: dict = {}
    for key, v in flat.items():
        *mods, leaf = key.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return flux_dit_state_dict(tree)


# ---- CLIP (transformers names) ----

_CLIP = [
    (r"layer_(\d+)/(q|k|v)", "text_model.encoder.layers.{0}.self_attn.{1}_proj"),
    (r"layer_(\d+)/out", "text_model.encoder.layers.{0}.self_attn.out_proj"),
    (r"layer_(\d+)/ln(1|2)", "text_model.encoder.layers.{0}.layer_norm{1}"),
    (r"layer_(\d+)/(fc1|fc2)", "text_model.encoder.layers.{0}.mlp.{1}"),
    (r"final_ln", "text_model.final_layer_norm"),
    (r"text_projection", "text_projection"),
]


def clip_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    return _convert(tree, lambda p: _lookup(_CLIP, p, "clip"), extra={
        "token_embedding": ["text_model.embeddings.token_embedding.weight"],
        "position_embedding": ["text_model.embeddings.position_embedding.weight"],
    })


# ---- Llama (transformers names) ----

_LLM = [
    (r"layer_(\d+)/(q|k|v|o)", "layers.{0}.self_attn.{1}_proj"),
    (r"layer_(\d+)/input_norm", "layers.{0}.input_layernorm"),
    (r"layer_(\d+)/pre_mlp_norm", "layers.{0}.post_attention_layernorm"),
    (r"layer_(\d+)/(gate|up|down)", "layers.{0}.mlp.{1}_proj"),
    (r"final_norm", "norm"),
]


def llm_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    return _convert(tree, lambda p: _lookup(_LLM, p, "llm"),
                    extra={"token_embedding": ["embed_tokens.weight"]})


# ---- T5 (transformers names) ----

_T5 = [
    (r"layer_(\d+)/(q|k|v|o)", "encoder.block.{0}.layer.0.SelfAttention.{1}"),
    (r"layer_(\d+)/ln1", "encoder.block.{0}.layer.0.layer_norm"),
    (r"layer_(\d+)/(wi_0|wi_1|wo)", "encoder.block.{0}.layer.1.DenseReluDense.{1}"),
    (r"layer_(\d+)/ln2", "encoder.block.{0}.layer.1.layer_norm"),
    (r"final_ln", "encoder.final_layer_norm"),
]


def t5_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    return _convert(tree, lambda p: _lookup(_T5, p, "t5"), extra={
        "token_embedding": ["shared.weight", "encoder.embed_tokens.weight"],
        "relative_attention_bias": ["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"],
    })


# ---- VAE (diffusers names) ----

_VAE_MID = [
    (r"mid_attn/norm", "mid_block.attentions.0.group_norm"),
    (r"mid_attn/(q|k|v)", "mid_block.attentions.0.to_{0}"),
    (r"mid_attn/proj_out", "mid_block.attentions.0.to_out.0"),
    (r"norm_out", "conv_norm_out"),
    (r"(conv_in|conv_out)", "{0}"),
]


def vae_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """JAX ``AutoencoderKL`` params -> diffusers-named state dict. The JAX
    decoder level ``up_{u}`` is diffusers ``up_blocks.{n-1-u}``."""
    levels = {int(m.group(1)) for side in ("encoder", "decoder")
              for k in tree.get(side, {}) for m in [re.match(r"(?:up|down)_(\d+)_", k)] if m}
    n = max(levels) + 1 if levels else 0

    def module(path: str) -> str:
        if path in ("quant_conv", "post_quant_conv"):
            return path
        side, rest = path.split("/", 1)
        m = re.fullmatch(r"mid_block_(1|2)/(.+)", rest)
        if m:
            return f"{side}.mid_block.resnets.{int(m.group(1)) - 1}.{m.group(2)}"
        m = re.fullmatch(r"up_(\d+)_block_(\d+)/(.+)", rest)
        if m:
            return f"{side}.up_blocks.{n - 1 - int(m.group(1))}.resnets.{m.group(2)}.{m.group(3)}"
        m = re.fullmatch(r"up_(\d+)_upsample", rest)
        if m:
            return f"{side}.up_blocks.{n - 1 - int(m.group(1))}.upsamplers.0.conv"
        m = re.fullmatch(r"down_(\d+)_block_(\d+)/(.+)", rest)
        if m:
            return f"{side}.down_blocks.{m.group(1)}.resnets.{m.group(2)}.{m.group(3)}"
        m = re.fullmatch(r"down_(\d+)_downsample", rest)
        if m:
            return f"{side}.down_blocks.{m.group(1)}.downsamplers.0.conv"
        return f"{side}." + _lookup(_VAE_MID, rest, "vae")

    return _convert(tree, module)


def flux_lora_tree(tree: dict) -> dict[str, dict[str, torch.Tensor]]:
    """JAX flux ``lora`` collection ``{path: {a [in,r], b [r,out], scale}}``,
    unrolled (``double_0/img_qkv``) or scanned (``double_blocks/block/img_qkv``
    with ``[L, in, r]`` / ``[L, r, out]`` / ``[L]``) -> ``{port module name:
    {a, b, scale}}`` for ``adapters.lora.attach_lora``. Factors keep the JAX
    ``[in, r]`` / ``[r, out]`` layout, as the port's ``LoRA`` does."""
    groups: dict[str, dict[str, np.ndarray]] = {}
    for path, v in _flatten(tree).items():
        mod, leaf = path.rsplit("/", 1)
        groups.setdefault(mod, {})[leaf] = v

    def entry(a, b, scale):
        return {"a": torch.from_numpy(np.array(a, np.float32)),
                "b": torch.from_numpy(np.array(b, np.float32)),
                "scale": torch.tensor(float(scale), dtype=torch.float32)}

    out: dict[str, dict[str, torch.Tensor]] = {}
    for mod, leaf in groups.items():
        m = re.fullmatch(r"(double|single)_blocks/block/(.+)", mod)
        if m:
            kind, rest = m.groups()
            scales = np.reshape(leaf["scale"], -1)
            for i in range(leaf["a"].shape[0]):
                out[_flux_module(f"{kind}_{i}/{rest}")] = entry(
                    leaf["a"][i], leaf["b"][i], scales[i if scales.size > 1 else 0])
        else:
            out[_flux_module(mod)] = entry(leaf["a"], leaf["b"], np.reshape(leaf["scale"], -1)[0])
    return out


def hidream_model_state(variables: dict) -> dict[str, dict[str, torch.Tensor]]:
    """JAX ``HiDreamModel`` variables ``{dit, vae, clip, clip2, t5, llm}`` ->
    per-component state dicts for ``HiDreamModel.load_state_dicts``."""
    return {
        "dit": flux_dit_state_dict(variables["dit"]),
        "vae": vae_state_dict(variables["vae"]),
        "clip": clip_state_dict(variables["clip"]),
        "clip2": clip_state_dict(variables["clip2"]),
        "t5": t5_state_dict(variables["t5"]),
        "llm": llm_state_dict(variables["llm"]),
    }


def flux_model_state(variables: dict) -> dict[str, dict[str, torch.Tensor]]:
    """JAX ``FluxModel`` variables ``{dit, vae, clip, t5}`` -> per-component
    state dicts for ``FluxModel.load_state_dicts``."""
    return {
        "dit": flux_dit_state_dict(variables["dit"]),
        "vae": vae_state_dict(variables["vae"]),
        "clip": clip_state_dict(variables["clip"]),
        "t5": t5_state_dict(variables["t5"]),
    }
