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
- SD3's ``dual_blocks`` (with ``img2_*``), ``final_block`` (its ``txt_mod`` a
  plain Linear) and ``pos_embed`` table keep their JAX names in the port.
- Norm scales and embeddings keep their values and dtypes.
- Chroma's ``distilled_guidance/{in_proj, layer_{i}, norm_{i}, out_proj}``
  maps onto BFL ``distilled_guidance_layer.*``; the control archs' wider
  ``img_in`` and ``final_proj`` convert like flux's.
- A flux ``lora`` collection maps onto the port's module names
  (:func:`flux_lora_tree`), and so does a UNet's (:func:`unet_lora_tree`).
- The UNet (``down_1_attn_0/block_0/attn1_q``, ``up_2_res_0``, ``mid_attn``)
  maps onto diffusers names (``down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q``,
  ``up_blocks.0.resnets.0``, ``mid_block.attentions.0``): the JAX up level
  ``i`` is diffusers ``up_blocks.{n-1-i}``.
- The Wan DiT (``block_{i}/self_q``, or scanned ``blocks/block/...``) maps onto
  diffusers ``WanTransformer3DModel`` names (``blocks.{i}.attn1.to_q``, the
  i2v ``attn2.add_k_proj`` and ``condition_embedder.image_embedder``), its
  modulation tables onto ``scale_shift_table`` ``[1, n, dim]``; the CLIP
  vision tower onto transformers' ``vision_model.*`` names; the Wan VAE
  (``encoder/down_blocks_3/resample_conv``) onto diffusers
  ``AutoencoderKLWan`` names (``encoder.down_blocks.3.resample.1``), its 3-D
  kernels ``(kt, kh, kw, in, out)`` -> ``[out, in, kt, kh, kw]``; UMT5's
  per-layer bias tables onto each block's ``relative_attention_bias``.
- A partial DiT tree (a full fine-tune's filtered trainable tree) converts
  like a whole one; the JAX full fine-tune's flat file, keyed by
  ``_flatten_params`` (``double_0.img_mlp_moe.experts.w1.kernel``), through
  :func:`flux_dit_flat_state_dict`.
- The audio archs: ACE-Step's waveform VAE and LTX-2's joint DiT keep the
  JAX names (``enc_blocks_1_0.conv1``, ``blocks.3.a2v_q``, the modulation
  tables as parameters); LTX-2's video VAE, mel VAE and vocoder take the
  checkpoint's (``encoder.down_blocks.0.resnets.1.conv1.conv``,
  ``encoder.down.0.block.1.conv1``, ``upsamplers.0``), 1-D kernels
  ``(k, in, out)`` -> ``[out, in, k]`` and the vocoder's transposed ones ->
  ``[in, out, k]``.
- The adapters: an IP-Adapter's ``ip_proj`` params (``ImageProjModel`` /
  ``Resampler``, whose port parameters keep the JAX module names) through
  :func:`ip_proj_state_dict`; its UNet ``ip`` collection (``{ip_k [cross,
  dim], ip_v, scale}`` under ``down_1_attn_0/block_0``) onto the port's
  transformer blocks (:func:`unet_ip_state`, ``ip_k`` ``[dim, cross]``), the
  flux one (``double_{i}`` / ``single_{i}``: ``to_k [mid, hidden]``) onto
  ``double_blocks.{i}`` / ``single_blocks.{i}`` (:func:`flux_ip_state`); a
  T2I adapter's params (:func:`t2i_state_dict`, the JAX module names).
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


def _unflatten(flat: dict[str, np.ndarray], sep: str = "/") -> dict:
    """Inverse of :func:`_flatten` over ``sep``-joined paths."""
    tree: dict = {}
    for key, v in flat.items():
        *mods, leaf = key.split(sep)
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


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
        if v.ndim == 5:
            return "weight", v.transpose(4, 3, 0, 1, 2)
        raise ValueError(f"kernel of rank {v.ndim}")
    if leaf == "scale":
        return norm_name, v
    if leaf == "gamma":
        return "gamma", v
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
    # sd3.5-medium's image-only attention (dual blocks)
    ("img2_qkv", "img2_attn.qkv"), ("img2_proj", "img2_attn.proj"),
    ("img2_qknorm/(query_norm|key_norm)", "img2_attn.norm.{0}"),
]
_FINAL = [("txt_mod", "txt_mod"), *_DOUBLE]  # sd3's context_pre_only block: txt_mod is a plain Linear
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
    # chroma's Approximator (JAX io/flux_import.chroma_approximator_rules)
    ("distilled_guidance/(in_proj|out_proj)", "distilled_guidance_layer.{0}"),
    (r"distilled_guidance/layer_(\d+)/(in_layer|out_layer)", "distilled_guidance_layer.layers.{0}.{1}"),
    (r"distilled_guidance/norm_(\d+)", "distilled_guidance_layer.norms.{0}"),
]


def _flux_module(path: str) -> str:
    m = re.fullmatch(r"(double|single|dual)_(\d+)/(.+)", path)
    if m:
        kind, i, rest = m.groups()
        table = _SINGLE if kind == "single" else _DOUBLE
        return f"{kind}_blocks.{i}." + _lookup(table, rest, "flux dit")
    if path.startswith("final_block/"):
        return "final_block." + _lookup(_FINAL, path[len("final_block/"):], "flux dit")
    return _lookup(_FLUX_TOP, path, "flux dit")


_FLUX_STACKS = (("double_blocks", "double_"), ("single_blocks", "single_"), ("dual_blocks", "dual_"))


def _inverted(table: list[tuple[str, str]]) -> list[tuple[str, str]]:
    """``[(port-name regex, JAX path template)]`` for a ``(JAX regex, port
    template)`` table: each group of the JAX regex becomes a slot, each slot
    of the port template a group."""
    out = []
    for pat, tmpl in table:
        groups = re.findall(r"\([^()]*\)", pat)
        slots = iter(range(len(groups)))
        jax_tmpl = re.sub(r"\([^()]*\)", lambda _: "{%d}" % next(slots), pat)
        port_re = re.sub(r"\\\{(\d+)\\\}", lambda m: groups[int(m.group(1))], re.escape(tmpl))
        out.append((port_re, jax_tmpl))
    return out


def flux_jax_path(name: str, scanned: bool = False) -> str:
    """The JAX module path of the flux DiT's port module ``name``, dot-joined
    as the JAX package's network files carry it (the inverse of
    :func:`_flux_module`): ``double_3.img_qkv`` unrolled,
    ``double_blocks.block.img_qkv.3`` in a scanned stack (one entry per
    layer)."""
    m = re.fullmatch(r"(double|single|dual)_blocks\.(\d+)\.(.+)", name)
    if m:
        kind, i, rest = m.groups()
        sub = _lookup(_inverted(_SINGLE if kind == "single" else _DOUBLE), rest, "flux dit")
        path = f"{kind}_blocks/block/{sub}" if scanned else f"{kind}_{i}/{sub}"
        return path.replace("/", ".") + (f".{i}" if scanned else "")
    if name.startswith("final_block."):
        return "final_block." + _lookup(_inverted(_FINAL), name[len("final_block."):], "flux dit").replace("/", ".")
    return _lookup(_inverted(_FLUX_TOP), name, "flux dit").replace("/", ".")


def _unscan(tree: dict, stacks=_FLUX_STACKS) -> dict:
    """Scanned layout ``<stack>/block/<mod>/<leaf>`` with a leading layer axis
    -> unrolled ``<prefix><i>/<mod>/<leaf>``, for each ``(stack, prefix)``."""
    out = {k: v for k, v in tree.items() if k not in dict(stacks)}
    for stack, prefix in stacks:
        if stack not in tree:
            continue
        for path, v in _flatten(tree[stack]["block"]).items():
            for i in range(v.shape[0]):
                node = out.setdefault(f"{prefix}{i}", {})
                *mods, leaf = path.split("/")
                for mname in mods:
                    node = node.setdefault(mname, {})
                node[leaf] = v[i]
    return out


def flux_dit_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """JAX ``FluxDiT`` params (unrolled or scanned, whole or a subtree of
    leaves) -> ``FluxDiT`` state dict entries; sd3's learned table
    ``pos_embed`` -> ``pos_embed.pos_embed``."""
    return _convert(_unscan(tree), _flux_module, norm_name="scale", extra={"pos_embed": ["pos_embed.pos_embed"]})


def flux_dit_flat_state_dict(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The JAX full fine-tune's save, ``{'.'-joined param path: array}``
    (``_flatten_params``), -> ``FluxDiT`` state dict entries."""
    return flux_dit_state_dict(_unflatten(flat, "."))


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


# ---- the CLIP vision tower (transformers names) ----

_CLIP_VISION = [
    (r"layer_(\d+)/(q|k|v)", "vision_model.encoder.layers.{0}.self_attn.{1}_proj"),
    (r"layer_(\d+)/out", "vision_model.encoder.layers.{0}.self_attn.out_proj"),
    (r"layer_(\d+)/ln(1|2)", "vision_model.encoder.layers.{0}.layer_norm{1}"),
    (r"layer_(\d+)/(fc1|fc2)", "vision_model.encoder.layers.{0}.mlp.{1}"),
    (r"patch_embedding", "vision_model.embeddings.patch_embedding"),
    (r"pre_ln", "vision_model.pre_layrnorm"), (r"post_ln", "vision_model.post_layernorm"),
    (r"visual_projection", "visual_projection"),
]


def clip_vision_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """JAX ``CLIPVisionModel`` params -> transformers
    ``CLIPVisionModelWithProjection`` names (JAX ``clip_vision_rules``)."""
    return _convert(tree, lambda p: _lookup(_CLIP_VISION, p, "clip vision"), extra={
        "class_embedding": ["vision_model.embeddings.class_embedding"],
        "position_embedding": ["vision_model.embeddings.position_embedding.weight"],
    })


# ---- Llama (transformers names) ----

_LLM = [
    (r"layer_(\d+)/(q|k|v|o)", "layers.{0}.self_attn.{1}_proj"),
    (r"layer_(\d+)/input_norm", "layers.{0}.input_layernorm"),
    (r"layer_(\d+)/pre_mlp_norm", "layers.{0}.post_attention_layernorm"),
    (r"layer_(\d+)/(gate|up|down)", "layers.{0}.mlp.{1}_proj"),
    (r"final_norm", "norm"),
]


# Gemma2: post_attention_layernorm is the norm after attention (JAX llm_rules(gemma=True))
_GEMMA = [
    (r"layer_(\d+)/(q|k|v|o)", "layers.{0}.self_attn.{1}_proj"),
    (r"layer_(\d+)/input_norm", "layers.{0}.input_layernorm"),
    (r"layer_(\d+)/post_attn_norm", "layers.{0}.post_attention_layernorm"),
    (r"layer_(\d+)/pre_mlp_norm", "layers.{0}.pre_feedforward_layernorm"),
    (r"layer_(\d+)/post_mlp_norm", "layers.{0}.post_feedforward_layernorm"),
    (r"layer_(\d+)/(gate|up|down)", "layers.{0}.mlp.{1}_proj"),
    (r"final_norm", "norm"),
]


def llm_state_dict(tree: dict, gemma: bool = False) -> dict[str, torch.Tensor]:
    """JAX ``LLMEncoder`` params -> transformers names. ``gemma``: Gemma2's
    names, and each norm's f32 scale ``1 + w`` back to the stored ``w``
    (``models/text_encoders/llm.GemmaRMSNorm``)."""
    sd = _convert(tree, lambda p: _lookup(_GEMMA if gemma else _LLM, p, "llm"),
                  extra={"token_embedding": ["embed_tokens.weight"]})
    if gemma:
        sd = {k: v - 1.0 if k.endswith("norm.weight") else v for k, v in sd.items()}
    return sd


# ---- T5 (transformers names) ----

_T5 = [
    (r"layer_(\d+)/(q|k|v|o)", "encoder.block.{0}.layer.0.SelfAttention.{1}"),
    (r"layer_(\d+)/ln1", "encoder.block.{0}.layer.0.layer_norm"),
    (r"layer_(\d+)/(wi_0|wi_1|wo)", "encoder.block.{0}.layer.1.DenseReluDense.{1}"),
    (r"layer_(\d+)/ln2", "encoder.block.{0}.layer.1.layer_norm"),
    (r"final_ln", "encoder.final_layer_norm"),
]


def t5_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """T5, or UMT5 with a ``relative_attention_bias`` table in every layer."""
    extra = {
        "token_embedding": ["shared.weight", "encoder.embed_tokens.weight"],
        "relative_attention_bias": ["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"],
    }
    for path in _flatten(tree):
        m = re.fullmatch(r"layer_(\d+)/relative_attention_bias", path)
        if m:
            extra[path] = [f"encoder.block.{m.group(1)}.layer.0.SelfAttention.relative_attention_bias.weight"]
    return _convert(tree, lambda p: _lookup(_T5, p, "t5"), extra=extra)


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


# ---- UNet (diffusers names) ----

_UNET_LEAF = {
    "attn1_q": "attn1.to_q", "attn1_k": "attn1.to_k", "attn1_v": "attn1.to_v", "attn1_out": "attn1.to_out.0",
    "attn2_q": "attn2.to_q", "attn2_k": "attn2.to_k", "attn2_v": "attn2.to_v", "attn2_out": "attn2.to_out.0",
    "ff_in": "ff.net.0.proj", "ff_out": "ff.net.2",
}
_UNET_TOP = {
    "conv_in": "conv_in", "conv_out": "conv_out", "norm_out": "conv_norm_out",
    "time_fc1": "time_embedding.linear_1", "time_fc2": "time_embedding.linear_2",
    "add_fc1": "add_embedding.linear_1", "add_fc2": "add_embedding.linear_2",
}


def _unet_module(path: str, n: int) -> str:
    """A JAX UNet module path -> its diffusers module name (``n`` levels)."""
    m = re.fullmatch(r"(down|up)_(\d+)_res_(\d+)/(\w+)", path)
    if m:
        kind, i, j, leaf = m.groups()
        idx = int(i) if kind == "down" else n - 1 - int(i)
        return f"{kind}_blocks.{idx}.resnets.{j}.{leaf}"
    m = re.fullmatch(r"(?:(down|up)_(\d+)_attn_(\d+)|mid_attn)/(?:block_(\d+)/)?(\w+)", path)
    if m:
        kind, i, j, k, leaf = m.groups()
        if kind is None:
            base = "mid_block.attentions.0"
        else:
            base = f"{kind}_blocks.{int(i) if kind == 'down' else n - 1 - int(i)}.attentions.{j}"
        return f"{base}.{leaf}" if k is None else f"{base}.transformer_blocks.{k}.{_UNET_LEAF.get(leaf, leaf)}"
    m = re.fullmatch(r"mid_res_(\d+)/(\w+)", path)
    if m:
        return f"mid_block.resnets.{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"down_(\d+)_downsample", path)
    if m:
        return f"down_blocks.{m.group(1)}.downsamplers.0.conv"
    m = re.fullmatch(r"up_(\d+)_upsample", path)
    if m:
        return f"up_blocks.{n - 1 - int(m.group(1))}.upsamplers.0.conv"
    if path in _UNET_TOP:
        return _UNET_TOP[path]
    raise KeyError(f"unet: no port module for JAX path '{path}'")


def unet_jax_path(name: str, n: int) -> str:
    """The JAX module path of the UNet's port (diffusers) module ``name`` at
    ``n`` levels, dot-joined (the inverse of :func:`_unet_module`)."""
    leaves = {v: k for k, v in _UNET_LEAF.items()}
    top = {v: k for k, v in _UNET_TOP.items()}
    if name in top:
        return top[name]
    m = re.fullmatch(r"(down|up)_blocks\.(\d+)\.(resnets|attentions|downsamplers|upsamplers)\.(\d+)(?:\.(.+))?", name)
    mid = re.fullmatch(r"mid_block\.(resnets|attentions)\.(\d+)(?:\.(.+))?", name)
    if m:
        kind, idx, part, j, rest = m.groups()
        i = int(idx) if kind == "down" else n - 1 - int(idx)
        if part in ("downsamplers", "upsamplers"):
            return f"{kind}_{i}_{part[:-2]}"
        head = f"{kind}_{i}_{'res' if part == 'resnets' else 'attn'}_{j}"
    elif mid:
        part, j, rest = mid.groups()
        head = f"mid_res_{j}" if part == "resnets" else "mid_attn"
    else:
        raise KeyError(f"unet: no JAX path for port module '{name}'")
    t = re.fullmatch(r"transformer_blocks\.(\d+)\.(.+)", rest or "")
    if t:
        return f"{head}.block_{t.group(1)}.{leaves.get(t.group(2), t.group(2))}"
    return f"{head}.{rest}"


def _unet_levels(paths) -> int:
    return 1 + max(int(m.group(1)) for p in paths for m in [re.match(r"down_(\d+)_", p)] if m)


def unet_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """JAX ``UNet2DCondition`` params -> the port's (diffusers-named) state dict."""
    n = _unet_levels(tree)
    return _convert(tree, lambda p: _unet_module(p, n))


def unet_lora_tree(tree: dict, num_levels: int) -> dict[str, dict[str, torch.Tensor]]:
    """JAX UNet ``lora`` collection ``{path: {a, b, scale}}`` -> ``{port
    module name: {a, b, scale}}`` for ``adapters.lora.attach_lora``."""
    groups: dict[str, dict[str, np.ndarray]] = {}
    for path, v in _flatten(tree).items():
        mod, leaf = path.rsplit("/", 1)
        groups.setdefault(mod, {})[leaf] = v
    return {_unet_module(mod, num_levels): _lora_entry(leaf["a"], leaf["b"], np.reshape(leaf["scale"], -1)[0])
            for mod, leaf in groups.items()}


def _lora_entry(a, b, scale) -> dict[str, torch.Tensor]:
    return {"a": torch.from_numpy(np.array(a, np.float32)),
            "b": torch.from_numpy(np.array(b, np.float32)),
            "scale": torch.tensor(float(scale), dtype=torch.float32)}


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
    out: dict[str, dict[str, torch.Tensor]] = {}
    for mod, leaf in groups.items():
        m = re.fullmatch(r"(double|single|dual)_blocks/block/(.+)", mod)
        if m:
            kind, rest = m.groups()
            scales = np.reshape(leaf["scale"], -1)
            for i in range(leaf["a"].shape[0]):
                out[_flux_module(f"{kind}_{i}/{rest}")] = _lora_entry(
                    leaf["a"][i], leaf["b"][i], scales[i if scales.size > 1 else 0])
        else:
            out[_flux_module(mod)] = _lora_entry(leaf["a"], leaf["b"], np.reshape(leaf["scale"], -1)[0])
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


def sd3_model_state(variables: dict) -> dict[str, dict[str, torch.Tensor]]:
    """JAX ``SD3Model`` variables ``{dit, vae, clip, clip2, t5}`` -> per-component
    state dicts for ``SD3Model.load_state_dicts``."""
    return {
        "dit": flux_dit_state_dict(variables["dit"]),
        "vae": vae_state_dict(variables["vae"]),
        "clip": clip_state_dict(variables["clip"]),
        "clip2": clip_state_dict(variables["clip2"]),
        "t5": t5_state_dict(variables["t5"]),
    }


def qwen_model_state(variables: dict) -> dict[str, dict[str, torch.Tensor]]:
    """JAX ``QwenImageModel`` variables ``{dit, vae, te}`` at ``size: tiny``
    (the KL VAE) -> per-component state dicts."""
    return {
        "dit": flux_dit_state_dict(variables["dit"]),
        "vae": vae_state_dict(variables["vae"]),
        "te": llm_state_dict(variables["te"]),
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


# ---- Wan (diffusers WanTransformer3DModel and AutoencoderKLWan names) ----

_WAN_BLOCK = [
    (r"self_(q|k|v)", "attn1.to_{0}"), ("self_o", "attn1.to_out.0"),
    (r"cross_(q|k|v)", "attn2.to_{0}"), ("cross_o", "attn2.to_out.0"),
    (r"self_(q|k)_norm", "attn1.norm_{0}"), (r"cross_(q|k)_norm", "attn2.norm_{0}"),
    ("norm2", "norm2"), ("ffn_in", "ffn.net.0.proj"), ("ffn_out", "ffn.net.2"),
    ("cross_k_img", "attn2.add_k_proj"), ("cross_v_img", "attn2.add_v_proj"),
    ("cross_k_img_norm", "attn2.norm_added_k"),
]
_WAN_TOP = [
    ("patch_embedding", "patch_embedding"), ("head_out", "proj_out"),
    ("text_embedding_in", "condition_embedder.text_embedder.linear_1"),
    ("text_embedding_out", "condition_embedder.text_embedder.linear_2"),
    ("time_fc1", "condition_embedder.time_embedder.linear_1"),
    ("time_fc2", "condition_embedder.time_embedder.linear_2"),
    ("time_projection", "condition_embedder.time_proj"),
    (r"img_emb_norm(1|2)", "condition_embedder.image_embedder.norm{0}"),
    ("img_emb_in", "condition_embedder.image_embedder.ff.net.0.proj"),
    ("img_emb_out", "condition_embedder.image_embedder.ff.net.2"),
]


def _wan_module(path: str) -> str:
    m = re.fullmatch(r"block_(\d+)/(.+)", path)
    if m:
        return f"blocks.{m.group(1)}." + _lookup(_WAN_BLOCK, m.group(2), "wan dit")
    return _lookup(_WAN_TOP, path, "wan dit")


def wan_dit_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """JAX ``WanDiT`` params (unrolled or scanned) -> ``WanDiT`` state dict."""
    tree = _unscan(tree, (("blocks", "block_"),))
    tables, rest = {}, {}
    for path, v in _flatten(tree).items():
        m = re.fullmatch(r"block_(\d+)/modulation", path)
        if m:  # the modulation tables [n, dim] -> scale_shift_table [1, n, dim]
            tables[f"blocks.{m.group(1)}.scale_shift_table"] = _tensor(v[None])
        elif path == "head_modulation":
            tables["scale_shift_table"] = _tensor(v[None])
        else:
            rest[path] = v
    return {**_convert(_unflatten(rest), _wan_module), **tables}


def wan_vae_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """JAX ``WanVAE`` params -> the port's (diffusers-named) state dict."""
    def module(path: str) -> str:
        path = path.replace("resample_conv", "resample/1")
        return re.sub(r"_(\d+)(?=/|$)", r".\1", path).replace("/", ".")

    return _convert(tree, module)


def wan_model_state(variables: dict) -> dict[str, dict[str, torch.Tensor]]:
    """JAX ``WanModel`` variables ``{dit, vae, t5}``, with ``dit_low`` (a
    multistage pair) and ``clip_vision`` (an i2v arch) where present ->
    per-component state dicts for ``WanModel.load_state_dicts``."""
    out = {
        "dit": wan_dit_state_dict(variables["dit"]),
        "vae": wan_vae_state_dict(variables["vae"]),
        "t5": t5_state_dict(variables["t5"]),
    }
    if "dit_low" in variables:
        out["dit_low"] = wan_dit_state_dict(variables["dit_low"])
    if "clip_vision" in variables:
        out["clip_vision"] = clip_vision_state_dict(variables["clip_vision"])
    return out


def wan_lora_tree(tree: dict) -> dict[str, dict[str, torch.Tensor]]:
    """JAX Wan ``lora`` collection, unrolled (``block_3/self_q``) or scanned
    (``blocks/block/self_q`` with ``[L, in, r]`` / ``[L, r, out]``) -> ``{port
    module name: {a, b, scale}}``; the i2v image K/V (``cross_k_img``,
    ``cross_v_img``) map onto ``attn2.add_k_proj`` / ``add_v_proj``."""
    groups: dict[str, dict[str, np.ndarray]] = {}
    for path, v in _flatten(tree).items():
        mod, leaf = path.rsplit("/", 1)
        groups.setdefault(mod, {})[leaf] = v
    out: dict[str, dict[str, torch.Tensor]] = {}
    for mod, leaf in groups.items():
        m = re.fullmatch(r"blocks/block/(.+)", mod)
        if m:
            scales = np.reshape(leaf["scale"], -1)
            for i in range(leaf["a"].shape[0]):
                out[_wan_module(f"block_{i}/{m.group(1)}")] = _lora_entry(
                    leaf["a"][i], leaf["b"][i], scales[i if scales.size > 1 else 0])
        else:
            out[_wan_module(mod)] = _lora_entry(leaf["a"], leaf["b"], np.reshape(leaf["scale"], -1)[0])
    return out


# ---- Lumina2 / OmniGen2 NextDiT (diffusers names) ----

_NEXTDIT_BLOCK = [
    ("norm1_lin", "norm1.linear"), (r"attn/to_(q|k|v)", "attn.to_{0}"), ("attn/to_out", "attn.to_out.0"),
    (r"attn/(q|k)_norm", "attn.norm_{0}"), (r"ffn_w(1|2|3)", "feed_forward.linear_{0}"),
    (r"(norm2|ffn_norm1|ffn_norm2)", "{0}"),
]
_NEXTDIT_TOP = [
    ("x_embedder", "x_embedder"), ("ref_embedder", "ref_image_patch_embedder"),
    ("time_in/in_layer", "time_caption_embed.timestep_embedder.linear_1"),
    ("time_in/out_layer", "time_caption_embed.timestep_embedder.linear_2"),
    ("cap_norm", "time_caption_embed.caption_embedder.0"), ("cap_proj", "time_caption_embed.caption_embedder.1"),
    ("final_mod", "norm_out.linear_1"), ("final_proj", "norm_out.linear_2"),
]
_NEXTDIT_STACKS = {"layer_": "layers", "noise_refiner_": "noise_refiner", "context_refiner_": "context_refiner",
                   "ref_refiner_": "ref_image_refiner"}


def _nextdit_module(path: str) -> str:
    m = re.fullmatch(r"(layer_|noise_refiner_|context_refiner_|ref_refiner_)(\d+)/(.+)", path)
    if not m:
        return _lookup(_NEXTDIT_TOP, path, "nextdit")
    prefix, i, rest = m.groups()
    stack = _NEXTDIT_STACKS[prefix]
    if rest == "norm1_norm":  # the caption refiner's norm1 is the plain RMSNorm
        return f"{stack}.{i}.norm1" + ("" if stack == "context_refiner" else ".norm")
    return f"{stack}.{i}." + _lookup(_NEXTDIT_BLOCK, rest, "nextdit")


def nextdit_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """JAX ``Lumina2DiT`` / ``OmniGen2DiT`` params (the joint stack unrolled,
    ``layer_{i}``, or scanned, ``layers/block``) -> the port's diffusers-named
    state dict; ``image_index_emb`` -> ``image_index_embedding``."""
    tree = _unscan(tree, (("layers", "layer_"),))
    return _convert(tree, _nextdit_module, extra={"image_index_emb": ["image_index_embedding"]})


def nextdit_model_state(variables: dict) -> dict[str, dict[str, torch.Tensor]]:
    """JAX ``Lumina2Model`` / ``OmniGen2Model`` variables ``{dit, vae, te}`` at
    ``size: tiny`` (the Llama text tower) -> per-component state dicts."""
    return {"dit": nextdit_state_dict(variables["dit"]), "vae": vae_state_dict(variables["vae"]),
            "te": llm_state_dict(variables["te"])}


def nextdit_lora_tree(tree: dict) -> dict[str, dict[str, torch.Tensor]]:
    """JAX NextDiT ``lora`` collection, the joint stack unrolled or scanned
    (``layers/block/attn/to_q`` with ``[L, in, r]`` / ``[L, r, out]``) ->
    ``{port module name: {a, b, scale}}``."""
    groups: dict[str, dict[str, np.ndarray]] = {}
    for path, v in _flatten(tree).items():
        mod, leaf = path.rsplit("/", 1)
        groups.setdefault(mod, {})[leaf] = v
    out: dict[str, dict[str, torch.Tensor]] = {}
    for mod, leaf in groups.items():
        if mod.startswith("layers/block/"):
            scales = np.reshape(leaf["scale"], -1)
            for i in range(leaf["a"].shape[0]):
                out[_nextdit_module(f"layer_{i}/{mod[len('layers/block/'):]}")] = _lora_entry(
                    leaf["a"][i], leaf["b"][i], scales[i if scales.size > 1 else 0])
        else:
            out[_nextdit_module(mod)] = _lora_entry(leaf["a"], leaf["b"], np.reshape(leaf["scale"], -1)[0])
    return out


def sdxl_model_state(variables: dict) -> dict[str, dict[str, torch.Tensor]]:
    """JAX ``SDXLModel`` variables ``{unet, vae, clip, clip2}`` -> per-component
    state dicts for ``SDXLModel.load_state_dicts``."""
    return {
        "unet": unet_state_dict(variables["unet"]),
        "vae": vae_state_dict(variables["vae"]),
        "clip": clip_state_dict(variables["clip"]),
        "clip2": clip_state_dict(variables["clip2"]),
    }


# ---- the audio archs: ACE-Step's waveform VAE, LTX-2's VAEs, vocoder and joint DiT ----

def audio_vae_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """JAX ``AudioAutoencoderKL`` params (``enc_blocks_1_0/conv1``) -> the
    port's, which keeps the JAX names; conv kernels ``(k, in, out)`` ->
    ``[out, in, k]``, in their own dtype."""
    return {f"{path.rsplit('/', 1)[0].replace('/', '.')}.{'weight' if path.endswith('kernel') else 'bias'}":
            _tensor(v.transpose(2, 1, 0) if path.endswith("kernel") else v) for path, v in _flatten(tree).items()}


_LTX_VIDEO_VAE = [
    (r"(encoder|decoder)/(conv_in|conv_out)", "{0}.{1}.conv"),
    (r"(encoder|decoder)/mid_block_resnets_(\d+)/(conv1|conv2|conv_shortcut)", "{0}.mid_block.resnets.{1}.{2}.conv"),
    (r"(encoder/down|decoder/up)_blocks_(\d+)_resnets_(\d+)/(conv1|conv2|conv_shortcut)",
     "{0}_blocks.{1}.resnets.{2}.{3}.conv"),
    (r"encoder/down_blocks_(\d+)_downsamplers_0/conv", "encoder.down_blocks.{0}.downsamplers.0.conv.conv"),
    (r"decoder/up_blocks_(\d+)_upsamplers_0/conv", "decoder.up_blocks.{0}.upsamplers.0.conv.conv"),
]


def ltx_video_vae_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """JAX ``LTXVideoVAE`` params -> the diffusers ``AutoencoderKLLTX2Video``
    names the port carries; 3-D kernels ``(kt, kh, kw, in, out)`` ->
    ``[out, in, kt, kh, kw]``."""
    return _convert(tree, lambda p: _lookup(_LTX_VIDEO_VAE, p, "ltx video vae").replace("/", "."))


_LTX_AUDIO_VAE = [
    (r"(encoder|decoder)/(conv_in|conv_out)/conv", "{0}.{1}"),
    (r"(encoder|decoder)/mid_block_(1|2)/(conv1|conv2)/conv", "{0}.mid.block_{1}.{2}"),
    (r"(encoder/down|decoder/up)_(\d+)_block_(\d+)/(conv1|conv2)/conv", "{0}.{1}.block.{2}.{3}"),
    (r"(encoder/down|decoder/up)_(\d+)_block_(\d+)/nin_shortcut", "{0}.{1}.block.{2}.nin_shortcut"),
    (r"encoder/down_(\d+)_downsample", "encoder.down.{0}.downsample.conv"),
    (r"decoder/up_(\d+)_upsample/conv", "decoder.up.{0}.upsample.conv"),
    (r"(quant_conv|post_quant_conv)", "{0}"),
]


def ltx_audio_vae_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """JAX ``LTXAudioVAE`` params -> the checkpoint's taming-style names
    (``encoder.down.0.block.1.conv1``) the port carries; HWIO -> OIHW."""
    return _convert(tree, lambda p: _lookup(_LTX_AUDIO_VAE, p, "ltx audio vae").replace("/", "."))


def vocoder_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """JAX ``LTX2Vocoder`` params -> the checkpoint's names; conv kernels
    ``(k, in, out)`` -> ``[out, in, k]``, the transposed convolutions'
    ``(k, in, out)`` -> torch's ``[in, out, k]`` (no flip: JAX's
    ``transpose_kernel`` does it)."""
    sd = {}
    for path, v in _flatten(tree).items():
        mod, leaf = path.rsplit("/", 1)
        name = re.sub(r"_(\d+)(?=/|$)", r".\1", mod.removesuffix("/conv")).replace("/", ".")
        if leaf == "kernel":
            v = v.transpose(1, 2, 0) if mod.startswith("upsamplers_") else v.transpose(2, 1, 0)
        sd[f"{name}.{'weight' if leaf == 'kernel' else 'bias'}"] = _tensor(v)
    return sd


def ltx2_av_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """JAX ``LTX2AVDiT`` params (unrolled ``block_3/a2v_q`` or scanned) ->
    the port's, which keeps the JAX names under ``blocks.{i}``; the
    modulation tables stay f32 parameters of their own names."""
    sd = {}
    for path, v in _flatten(_unscan(tree, (("blocks", "block_"),))).items():
        mod, leaf = path.rsplit("/", 1) if "/" in path else ("", path)
        mod = re.sub(r"^block_(\d+)", r"blocks.\1", mod).replace("/", ".")
        if leaf in ("kernel", "scale", "bias"):
            name, arr = _leaf(v, leaf, "weight")
            sd[f"{mod}.{name}"] = _tensor(arr)
        else:  # a modulation table
            sd[f"{mod}.{leaf}" if mod else leaf] = _tensor(v)
    return sd


def ltx2_av_lora_tree(tree: dict) -> dict[str, dict[str, torch.Tensor]]:
    """JAX ``lora`` collection of the joint DiT (unrolled or scanned) ->
    ``{blocks.{i}.<JAX name>: {a, b, scale}}``."""
    flat = _flatten(tree)
    groups: dict[str, dict[str, np.ndarray]] = {}
    for path, v in flat.items():
        mod, leaf = path.rsplit("/", 1)
        groups.setdefault(mod, {})[leaf] = v
    out: dict[str, dict[str, torch.Tensor]] = {}
    for mod, leaf in groups.items():
        m = re.fullmatch(r"blocks/block/(.+)", mod)
        if m:
            scales = np.reshape(leaf["scale"], -1)
            for i in range(leaf["a"].shape[0]):
                out[f"blocks.{i}.{m.group(1)}"] = _lora_entry(leaf["a"][i], leaf["b"][i],
                                                             scales[i if scales.size > 1 else 0])
        else:
            i, name = re.fullmatch(r"block_(\d+)/(.+)", mod).groups()
            out[f"blocks.{i}.{name}"] = _lora_entry(leaf["a"], leaf["b"], np.reshape(leaf["scale"], -1)[0])
    return out


def ace_model_state(variables: dict) -> dict[str, dict[str, torch.Tensor]]:
    """JAX ``AudioModel`` variables ``{dit, vae, t5}`` (the stand-in path)."""
    return {"dit": wan_dit_state_dict(variables["dit"]), "vae": audio_vae_state_dict(variables["vae"]),
            "t5": t5_state_dict(variables["t5"])}


def ltx2_model_state(variables: dict, gemma: bool, joint: bool, mel: bool) -> dict[str, dict[str, torch.Tensor]]:
    """JAX ``LTX2Model`` variables ``{dit, vae, te}`` (and ``audio_vae``,
    ``vocoder`` of a joint model) -> per-component state dicts; ``gemma``:
    the caption tower's Gemma norms."""
    out = {"dit": ltx2_av_state_dict(variables["dit"]) if joint else wan_dit_state_dict(variables["dit"]),
           "vae": ltx_video_vae_state_dict(variables["vae"]), "te": llm_state_dict(variables["te"], gemma=gemma)}
    if joint:
        out["audio_vae"] = (ltx_audio_vae_state_dict if mel else audio_vae_state_dict)(variables["audio_vae"])
        if mel:
            out["vocoder"] = vocoder_state_dict(variables["vocoder"])
    return out


def ip_proj_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """An IP-Adapter's ``ip_proj`` params -> the port module's state dict
    (``latents`` as they are)."""
    sd = _convert({k: v for k, v in params.items() if k != "latents"}, lambda m: m.replace("/", "."))
    if "latents" in params:
        sd["latents"] = _tensor(np.asarray(params["latents"]))
    return sd


def unet_ip_state(ip: dict, n: int) -> dict[str, dict[str, torch.Tensor]]:
    """A UNet ``ip`` collection at ``n`` levels -> ``{port block name: {ip_k,
    ip_v, scale}}``, K / V in the torch layout ``[dim, cross]``."""
    out = {}
    for path, v in _flatten(ip).items():
        mod, leaf = path.rsplit("/", 1)
        name = _unet_module(f"{mod}/attn2_k", n).rsplit(".attn2.", 1)[0]
        out.setdefault(name, {})[leaf] = _tensor(v.T if v.ndim == 2 else v).reshape(v.shape[::-1])
    return out


def flux_ip_state(ip: dict) -> dict[str, dict[str, torch.Tensor]]:
    """An unrolled flux ``ip`` collection -> ``{double_blocks.{i} /
    single_blocks.{i}: {to_k, to_v, scale}}``, K / V ``[hidden, mid]``."""
    return {f"{kind}_blocks.{i}": {leaf: _tensor(np.asarray(v).T).reshape(np.shape(v)[::-1])
                                   for leaf, v in node.items()}
            for name, node in ip.items() for kind, i in [name.split("_")]}


def t2i_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """A T2I adapter's params -> the port's ``T2IAdapterNet`` state dict."""
    return _convert(params, lambda m: m.replace("/", "."))
