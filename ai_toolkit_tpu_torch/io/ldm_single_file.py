"""Loading an LDM / SGM single-file checkpoint (``v1-5-pruned.safetensors``,
``sd_xl_base_1.0.safetensors``, a ``.ckpt``) into the SD and SDXL models: the
port's copy of the key maps of ``ai_toolkit_tpu/io/ldm_single_file.py`` (the
UNet, the VAE, OpenCLIP to HF CLIP and the split by prefix), loading only.

One file holds every component under its prefix: ``model.diffusion_model.``
(the UNet), ``first_stage_model.`` (the VAE), ``cond_stage_model.transformer.``
(SD 1.x's CLIP-L, already in the HF layout), ``cond_stage_model.model.`` (SD
2.x's OpenCLIP tower, whose last block is dropped: SD 2.x reads the
penultimate layer), ``conditioner.embedders.0.transformer.`` and
``conditioner.embedders.1.model.`` (SDXL's CLIP-L and OpenCLIP-G). Each
component's tensors are read one at a time under the module's names
(diffusers and transformers), through :func:`io.safetensors_dir.load_module`:
the load is strict, every weight of a component the file holds must be there.
What a real file carries beside the weights is skipped by name (the EMA
copy ``model_ema.*``, ``position_ids``, OpenCLIP's ``logit_scale``, the LDM
schedule buffers ``betas``, ``alphas_cumprod``, ...); any other tensor the
maps do not place raises. 1x1 convs (SD 1.x's ``proj_in`` / ``proj_out``,
the VAE's attention) are read into the Linears by ``squeeze_to``; OpenCLIP's
fused ``in_proj`` is split into q, k and v and its ``text_projection``
transposed. A ``.ckpt`` is read with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import re
import time
from typing import Callable

import torch
from torch import nn

from ai_toolkit_tpu_torch.io.safetensors_dir import load_module, squeeze_adapt

UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."
# the text encoders: SD 1.x's CLIP-L, SD 2.x's OpenCLIP tower, SDXL's CLIP-L and OpenCLIP-G
_TEXT_PREFIXES = {
    "cond_stage_model.transformer.": ("clip", "hf"),
    "cond_stage_model.model.": ("clip", "sd2"),
    "conditioner.embedders.0.transformer.": ("clip", "hf"),
    "conditioner.embedders.1.model.": ("clip2", "openclip"),
}
# the LDM training buffers and bookkeeping a real file holds beside the weights
_SCHEDULE_BUFFERS = frozenset((
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
    "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
))
_SKIP_PREFIXES = ("model_ema.", "denoiser.")

# (file key, transform of the tensor read) for each name of a component
Entry = tuple[str, Callable[[torch.Tensor], torch.Tensor] | None]

# ---- the UNet: model.diffusion_model.* -> diffusers UNet2DConditionModel ----

_RES_PARTS = [
    ("in_layers.0.", "norm1."),
    ("in_layers.2.", "conv1."),
    ("emb_layers.1.", "time_emb_proj."),
    ("out_layers.0.", "norm2."),
    ("out_layers.3.", "conv2."),
    ("skip_connection.", "conv_shortcut."),
]
_TOP_LEVEL = [
    ("time_embed.0.", "time_embedding.linear_1."),
    ("time_embed.2.", "time_embedding.linear_2."),
    ("label_emb.0.0.", "add_embedding.linear_1."),
    ("label_emb.0.2.", "add_embedding.linear_2."),
    ("input_blocks.0.0.", "conv_in."),
    ("out.0.", "conv_norm_out."),
    ("out.2.", "conv_out."),
]


def _res_to_diffusers(rest: str) -> str | None:
    for ldm, dif in _RES_PARTS:
        if rest.startswith(ldm):
            return dif + rest[len(ldm):]
    return None


def unet_ldm_to_diffusers_key(key: str, layers_per_block: int = 2) -> str | None:
    """One UNet key (prefix stripped), LDM -> diffusers; None for a key no
    diffusers UNet has."""
    n = layers_per_block + 1
    for ldm, dif in _TOP_LEVEL:
        if key.startswith(ldm):
            return dif + key[len(ldm):]
    m = re.match(r"input_blocks\.(\d+)\.(\d+)\.(.+)", key)
    if m:
        i, mod, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        blk, layer = (i - 1) // n, (i - 1) % n
        if mod == 0:
            if rest.startswith("op."):  # Downsample2D
                return f"down_blocks.{blk}.downsamplers.0.conv.{rest[3:]}"
            res = _res_to_diffusers(rest)
            return res and f"down_blocks.{blk}.resnets.{layer}.{res}"
        return f"down_blocks.{blk}.attentions.{layer}.{rest}"
    m = re.match(r"middle_block\.(\d+)\.(.+)", key)
    if m:
        mod, rest = int(m.group(1)), m.group(2)
        if mod == 1:
            return f"mid_block.attentions.0.{rest}"
        res = _res_to_diffusers(rest)
        return res and f"mid_block.resnets.{0 if mod == 0 else 1}.{res}"
    m = re.match(r"output_blocks\.(\d+)\.(\d+)\.(.+)", key)
    if m:
        i, mod, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        blk, layer = i // n, i % n
        if mod == 0:
            res = _res_to_diffusers(rest)
            return res and f"up_blocks.{blk}.resnets.{layer}.{res}"
        if rest.startswith("conv."):  # Upsample2D (module 1 or 2)
            return f"up_blocks.{blk}.upsamplers.0.{rest}"
        return f"up_blocks.{blk}.attentions.{layer}.{rest}"
    return None


# ---- the VAE: first_stage_model.* -> diffusers AutoencoderKL ----

_VAE_ATTN = {"q": "to_q", "k": "to_k", "v": "to_v", "proj_out": "to_out.0", "norm": "group_norm"}


def vae_ldm_to_diffusers_key(key: str, n_up: int) -> str | None:
    """One VAE key (prefix stripped), LDM -> diffusers; ``n_up`` is the
    decoder's level count (LDM numbers ``decoder.up`` by resolution,
    diffusers the other way round). None for a key no diffusers VAE has."""
    if key.startswith(("quant_conv.", "post_quant_conv.")):
        return key
    m = re.match(r"(encoder|decoder)\.(.+)", key)
    if not m:
        return None
    side, rest = m.groups()
    rest = rest.replace("nin_shortcut.", "conv_shortcut.")
    if rest.startswith("norm_out."):
        return f"{side}.conv_norm_out.{rest[9:]}"
    m = re.match(r"mid\.attn_1\.(\w+)\.(weight|bias)$", rest)
    if m:
        attn = _VAE_ATTN.get(m.group(1))
        return f"{side}.mid_block.attentions.0.{attn}.{m.group(2)}" if attn else None
    patterns = (
        (r"mid\.block_(\d)\.(.+)", lambda g: f"mid_block.resnets.{int(g[0]) - 1}.{g[1]}"),
        (r"down\.(\d+)\.block\.(\d+)\.(.+)", lambda g: f"down_blocks.{g[0]}.resnets.{g[1]}.{g[2]}"),
        (r"down\.(\d+)\.downsample\.conv\.(.+)", lambda g: f"down_blocks.{g[0]}.downsamplers.0.conv.{g[1]}"),
        (r"up\.(\d+)\.block\.(\d+)\.(.+)", lambda g: f"up_blocks.{n_up - 1 - int(g[0])}.resnets.{g[1]}.{g[2]}"),
        (r"up\.(\d+)\.upsample\.conv\.(.+)", lambda g: f"up_blocks.{n_up - 1 - int(g[0])}.upsamplers.0.conv.{g[1]}"),
    )
    for pattern, name in patterns:
        m = re.match(pattern, rest)
        if m:
            return f"{side}.{name(m.groups())}"
    return f"{side}.{rest}"  # conv_in / conv_out


# ---- the text encoders: OpenCLIP -> HF CLIPTextModel(WithProjection) ----

_OC_PARTS = [
    (".ln_1.", ".layer_norm1."), (".ln_2.", ".layer_norm2."),
    (".mlp.c_fc.", ".mlp.fc1."), (".mlp.c_proj.", ".mlp.fc2."),
    (".attn.out_proj.", ".self_attn.out_proj."),
]


def _third(i: int) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda t: t.chunk(3, dim=0)[i]


def openclip_to_hf(key: str, drop_layers_from: int | None = None) -> list[tuple[str, Callable | None]] | None:
    """One OpenCLIP text-tower key (prefix stripped) -> the HF names it fills,
    each with the transform of the tensor: the fused ``in_proj`` gives q, k
    and v, ``text_projection`` (``pooled @ W``) the transposed Linear weight.
    [] for what is skipped by name (``logit_scale``, ``position_ids``, the
    blocks from ``drop_layers_from`` on); None for a key no tower has."""
    if key == "positional_embedding":
        return [("text_model.embeddings.position_embedding.weight", None)]
    if key == "token_embedding.weight":
        return [("text_model.embeddings.token_embedding.weight", None)]
    if key.startswith("ln_final."):
        return [("text_model.final_layer_norm." + key[9:], None)]
    if key == "text_projection":
        return [("text_projection.weight", lambda t: t.T.contiguous())]
    if key == "logit_scale" or key.endswith("position_ids"):
        return []
    m = re.match(r"transformer\.resblocks\.(\d+)\.(.+)", key)
    if not m:
        return None
    i, rest = int(m.group(1)), m.group(2)
    if drop_layers_from is not None and i >= drop_layers_from:
        return []
    base = f"text_model.encoder.layers.{i}"
    if rest.startswith("attn.in_proj_"):
        wb = rest[len("attn.in_proj_"):]
        return [(f"{base}.self_attn.{name}_proj.{wb}", _third(j)) for j, name in enumerate("qkv")]
    mapped = "." + rest
    for oc, hf in _OC_PARTS:
        if mapped.startswith(oc):
            return [(base + hf + mapped[len(oc):], None)]
    return None


# ---- the whole file ----

def is_ldm_checkpoint(keys) -> bool:
    return any(str(k).startswith(UNET_PREFIX) for k in keys)


def _skipped(key: str) -> bool:
    return key in _SCHEDULE_BUFFERS or key.startswith(_SKIP_PREFIXES) or key.endswith("position_ids")


def split_ldm_checkpoint(keys, layers_per_block: int = 2, sd2_clip_layers: int = 23
                         ) -> tuple[dict[str, dict[str, Entry]], list[str]]:
    """The file's keys -> ({component: {module name: (file key, transform)}},
    the keys no map places and no name skips). Components: ``unet``,
    ``vae``, ``clip`` (SD 1.x / 2.x's text encoder, SDXL's CLIP-L) and
    ``clip2`` (SDXL's OpenCLIP-G); SD 2.x's tower keeps its first
    ``sd2_clip_layers`` blocks."""
    keys = list(keys)
    n_up = 1 + max((int(m.group(1)) for k in keys
                    if (m := re.match(rf"{re.escape(VAE_PREFIX)}decoder\.up\.(\d+)\.", k))), default=-1)
    comps: dict[str, dict[str, Entry]] = {}
    unknown: list[str] = []

    def put(comp: str, name: str | None, key: str, fn=None) -> None:
        if name is None:
            unknown.append(key)
        else:
            comps.setdefault(comp, {})[name] = (key, fn)

    for key in keys:
        if key.startswith(UNET_PREFIX):
            put("unet", unet_ldm_to_diffusers_key(key[len(UNET_PREFIX):], layers_per_block), key)
            continue
        if key.startswith(VAE_PREFIX):
            put("vae", vae_ldm_to_diffusers_key(key[len(VAE_PREFIX):], n_up), key)
            continue
        prefix = next((p for p in _TEXT_PREFIXES if key.startswith(p)), None)
        if prefix is None:
            if not _skipped(key):
                unknown.append(key)
            continue
        comp, layout = _TEXT_PREFIXES[prefix]
        rest = key[len(prefix):]
        if layout == "hf":
            if not rest.endswith("position_ids"):
                put(comp, rest, key)
            continue
        targets = openclip_to_hf(rest, sd2_clip_layers if layout == "sd2" else None)
        if targets is None:
            unknown.append(key)
        for name, fn in targets or ():
            put(comp, name, key, fn)
    return comps, unknown


class _FileReader:
    """The tensors of one ``.safetensors`` (kept open, read one at a time) or
    ``.ckpt`` (``torch.load(weights_only=True)``) file."""

    def __init__(self, path: str):
        self.path = path
        if path.endswith((".safetensors", ".sft")):
            from safetensors import safe_open

            self._file = safe_open(path, framework="pt")
            self._file.__enter__()
            self._tensors = None
        else:
            sd = torch.load(path, map_location="cpu", weights_only=True)
            sd = sd.get("state_dict", sd)
            self._file = None
            self._tensors = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}

    def keys(self) -> list[str]:
        return list(self._file.keys()) if self._file is not None else list(self._tensors)

    def get(self, key: str) -> torch.Tensor:
        return self._file.get_tensor(key) if self._file is not None else self._tensors[key]

    def close(self) -> None:
        if self._file is not None:
            self._file.__exit__(None, None, None)
        self._tensors = None


class ComponentIndex:
    """One component of an LDM file under the module's names, in the
    interface ``load_module`` reads (``in``, ``get``, ``path``)."""

    def __init__(self, reader: _FileReader, entries: dict[str, Entry], what: str):
        self.reader = reader
        self.entries = entries
        self.path = f"{reader.path} ({what})"
        self.used: set[str] = set()

    def __contains__(self, name: str) -> bool:
        return name in self.entries

    def get(self, name: str) -> torch.Tensor:
        key, fn = self.entries[name]
        self.used.add(name)
        t = self.reader.get(key)
        return fn(t) if fn is not None else t

    def unmatched(self) -> list[str]:
        return sorted(set(self.entries) - self.used)


def load_ldm_checkpoint(path: str, variables: dict[str, nn.Module], layers_per_block: int,
                        sd2_clip_layers: int = 23,
                        prepare: dict[str, Callable] | None = None) -> int:
    """Fill ``variables`` (``unet``, ``vae``, ``clip`` [, ``clip2``]) from the
    LDM single file at ``path``, strictly per component; a component the
    file does not hold keeps its seeded init, and one line says so.
    ``prepare[name](module, index, what)`` may fit a module to what the file
    holds first (a CLIP-L without ``text_projection``). Returns the number
    of tensors loaded. Raises ``ValueError`` for a file that is no LDM
    checkpoint, or holds a tensor or a component the model has no place
    for."""
    t0 = time.perf_counter()
    reader = _FileReader(path)
    try:
        keys = reader.keys()
        if not is_ldm_checkpoint(keys):
            raise ValueError(f"'{path}' is not an LDM single-file checkpoint (no {UNET_PREFIX}* keys); "
                             f"give an HF-layout directory instead")
        comps, unknown = split_ldm_checkpoint(keys, layers_per_block, sd2_clip_layers)
        if unknown:
            raise ValueError(f"'{path}': {len(unknown)} tensors are no weight of an SD / SDXL component, "
                             f"e.g. {unknown[:3]}")
        extra = sorted(set(comps) - set(variables))
        if extra:
            raise ValueError(f"'{path}' holds {extra}, which this model has not (another arch's file?)")
        loaded = 0
        for name, module in variables.items():
            if name not in comps:
                print(f"ldm single file {path}: no {name}; '{name}' keeps its seeded init")
                continue
            what = f"ldm {name}"
            index = ComponentIndex(reader, comps[name], what)
            if prepare and name in prepare:
                prepare[name](module, index, what)
            loaded += load_module(module, index, what, adapt=squeeze_adapt)
            if index.unmatched():
                raise ValueError(f"{what}: {len(index.unmatched())} tensors of '{path}' have no place in the "
                                 f"module, e.g. {index.unmatched()[:3]}")
    finally:
        reader.close()
    print(f"loaded ldm single file {path}: {loaded} tensors in {time.perf_counter() - t0:.2f} s")
    return loaded
