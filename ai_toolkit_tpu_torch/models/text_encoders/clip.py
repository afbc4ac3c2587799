"""CLIP text encoder (``ai_toolkit_tpu/models/text_encoders/clip.py`` in PyTorch).

Module names follow transformers' ``CLIPTextModelWithProjection``
(``text_model.encoder.layers.{i}.self_attn.q_proj``, ``text_projection``), so
its state dict loads as it is. Causal self-attention goes to the plain
attention path, as the JAX package sends it to XLA. ``clip_skip`` n > 0
returns the n-th-from-last layer's states, un-normalized (SDXL takes the
penultimate, ``clip_skip=1``); the pooled output always comes from the final
states. A textual-inversion ``bank`` ``[n_vectors, hidden]`` gives the
embeddings of the virtual ids at or above ``vocab_size``
(``adapters/embedding.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ai_toolkit_tpu_torch.ops.attention import dot_product_attention, reference_attention
from ai_toolkit_tpu_torch.ops.layers import Embedding, LayerNorm, Linear


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    projection_dim: int | None = None
    eos_token_id: int = 49407
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def clip_l(cls) -> "CLIPTextConfig":
        return cls(projection_dim=768)

    @classmethod
    def open_clip_g(cls) -> "CLIPTextConfig":
        return cls(hidden_size=1280, num_layers=32, num_heads=20, intermediate_size=5120,
                   hidden_act="gelu", projection_dim=1280)

    @classmethod
    def tiny(cls) -> "CLIPTextConfig":
        return cls(
            vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, projection_dim=64, eos_token_id=999, dtype=torch.float32,
        )


def _act(name: str):
    """``gelu`` is the tanh approximation, as ``jax.nn.gelu``'s default in the
    JAX package (OpenCLIP-G)."""
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    return lambda x: torch.nn.functional.gelu(x, approximate="tanh")


class CLIPAttention(nn.Module):
    """Causal self-attention (the text model), or full self-attention over
    every token (``causal=False``, the vision tower: the JAX package passes an
    all-ones mask, which takes its XLA path, so this one stays plain torch)."""

    def __init__(self, cfg: CLIPTextConfig, *, causal: bool = True, device=None):
        super().__init__()
        d, dt = cfg.hidden_size, cfg.dtype
        self.num_heads = cfg.num_heads
        self.causal = causal
        self.q_proj = Linear(d, d, device=device, dtype=dt)
        self.k_proj = Linear(d, d, device=device, dtype=dt)
        self.v_proj = Linear(d, d, device=device, dtype=dt)
        self.out_proj = Linear(d, d, device=device, dtype=dt)

    def forward(self, x):
        heads = (self.num_heads, -1)
        q = self.q_proj(x).unflatten(-1, heads)
        k = self.k_proj(x).unflatten(-1, heads)
        v = self.v_proj(x).unflatten(-1, heads)
        attn = dot_product_attention(q, k, v, is_causal=True) if self.causal else reference_attention(q, k, v)
        return self.out_proj(attn.flatten(2))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, device=None):
        super().__init__()
        self.act = _act(cfg.hidden_act)
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size, device=device, dtype=cfg.dtype)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size, device=device, dtype=cfg.dtype)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, causal: bool = True, device=None):
        super().__init__()
        self.self_attn = CLIPAttention(cfg, causal=causal, device=device)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, eps=1e-5, device=device)
        self.mlp = CLIPMLP(cfg, device=device)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, eps=1e-5, device=device)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, device=None):
        super().__init__()
        self.token_embedding = Embedding(cfg.vocab_size, cfg.hidden_size, 0.02, device=device)
        self.position_embedding = Embedding(cfg.max_position_embeddings, cfg.hidden_size, 0.01,
                                            device=device)


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, device=None):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(cfg, device=device)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(CLIPEncoderLayer(cfg, device=device)
                                            for _ in range(cfg.num_layers))
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=1e-5, device=device)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg, device=device)
        self.text_projection = (
            Linear(cfg.hidden_size, cfg.projection_dim, bias=False, device=device, dtype=cfg.dtype)
            if cfg.projection_dim else None)

    def embed(self, input_ids: torch.Tensor, bank: torch.Tensor | None = None) -> torch.Tensor:
        """The first layer's input: token plus position embeddings in the
        model's dtype. With ``bank``, ids at or above ``vocab_size`` take
        their row of the bank (JAX ``jnp.where``): the f32 table and the bank
        meet in their promoted dtype (f32 for the f32 bank the train job
        makes), and the sum with the f32 positions is rounded once, to the
        model's dtype."""
        cfg = self.cfg
        tm = self.text_model
        emb = tm.embeddings.token_embedding(input_ids.clamp(0, cfg.vocab_size - 1))
        if bank is not None:
            virt = (input_ids - cfg.vocab_size).clamp(0, bank.shape[0] - 1)
            emb = torch.where((input_ids >= cfg.vocab_size)[..., None], bank[virt], emb)
        return (emb + tm.embeddings.position_embedding.weight[None, :input_ids.shape[1]]).to(cfg.dtype)

    def forward(self, input_ids: torch.Tensor, clip_skip: int = 0,
                bank: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """input_ids ``[B, S]`` -> last_hidden_state and pooled_output (the
        first EOS token of the final states, projected). last_hidden_state is
        the final layer norm's output for ``clip_skip`` 0, else the output of
        the layer ``clip_skip`` places before the last (1: the penultimate),
        un-normalized. ``bank``: the textual-inversion vectors (:meth:`embed`)."""
        cfg = self.cfg
        tm = self.text_model
        x = self.embed(input_ids, bank)
        hidden_states = []
        for layer in tm.encoder.layers:
            x = layer(x)
            hidden_states.append(x)
        final = tm.final_layer_norm(x)
        eos_pos = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
        pooled = final[torch.arange(final.shape[0], device=final.device), eos_pos]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        out = final if clip_skip == 0 else hidden_states[-1 - clip_skip]
        return {"last_hidden_state": out, "pooled_output": pooled}


def drop_absent_projection(clip: CLIPTextModel, checkpoint, what: str) -> None:
    """Before loading ``clip`` from ``checkpoint`` (a container of tensor
    names): a CLIP text checkpoint without ``text_projection.weight`` is
    transformers' ``CLIPTextModel`` (flux's and SDXL's ``text_encoder/``), whose
    pooled output is not projected, so the module's projection goes. The JAX
    package keeps its random projection there."""
    if clip.text_projection is not None and "text_projection.weight" not in checkpoint:
        clip.text_projection = None
        print(f"{what}: no text_projection.weight (a CLIPTextModel): the pooled output is not projected")
