"""CLIP vision tower (``ai_toolkit_tpu/models/text_encoders/clip_vision.py``
in PyTorch), the image conditioning of Wan's i2v archs.

A ViT on the port's CLIP layers (``clip.CLIPEncoderLayer``, ``quick_gelu``):
the patch conv without bias, a CLS token and learned positions, ``pre_ln``,
pre-LN layers with full (non-causal) self-attention, and the post layer norm
on the CLS token only, projected (transformers semantics). Module names
follow transformers' ``CLIPVisionModelWithProjection``
(``vision_model.embeddings.patch_embedding``, ``vision_model.pre_layrnorm``,
``vision_model.encoder.layers.{i}.self_attn.q_proj``, ``visual_projection``),
the names ``io/sd_import.clip_vision_rules`` of the JAX package maps. The
attention is plain torch: the JAX package passes an all-ones mask, which
takes its XLA path, and ViT-H's head_dim 80 is no flash width.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ai_toolkit_tpu_torch.models.text_encoders.clip import CLIPEncoderLayer, CLIPTextConfig
from ai_toolkit_tpu_torch.ops.layers import Conv, Embedding, LayerNorm, Linear


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: int = 768
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def vit_l(cls) -> "CLIPVisionConfig":
        return cls()

    @classmethod
    def vit_h(cls) -> "CLIPVisionConfig":
        return cls(hidden_size=1280, num_layers=32, num_heads=16, intermediate_size=5120, projection_dim=1024)

    @classmethod
    def tiny(cls) -> "CLIPVisionConfig":
        return cls(image_size=32, patch_size=8, hidden_size=64, num_layers=2, num_heads=4,
                   intermediate_size=128, projection_dim=64, dtype=torch.float32)

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, *, device=None):
        super().__init__()
        p = cfg.patch_size
        self.patch_embedding = Conv(3, cfg.hidden_size, p, stride=p, padding=0, bias=False, device=device,
                                    dtype=cfg.dtype)
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size, device=device, dtype=torch.float32))
        self.position_embedding = Embedding(cfg.num_positions, cfg.hidden_size, 0.02, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        self.class_embedding.normal_(0.0, 0.02, generator=generator)


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, *, device=None):
        super().__init__()
        layer_cfg = CLIPTextConfig(hidden_size=cfg.hidden_size, num_heads=cfg.num_heads,
                                   intermediate_size=cfg.intermediate_size, hidden_act="quick_gelu",
                                   dtype=cfg.dtype)
        self.embeddings = CLIPVisionEmbeddings(cfg, device=device)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, eps=1e-5, device=device)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(CLIPEncoderLayer(layer_cfg, causal=False, device=device)
                                            for _ in range(cfg.num_layers))
        self.post_layernorm = LayerNorm(cfg.hidden_size, eps=1e-5, device=device)


class CLIPVisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.vision_model = CLIPVisionTransformer(cfg, device=device)
        self.visual_projection = Linear(cfg.hidden_size, cfg.projection_dim, bias=False, device=device,
                                        dtype=cfg.dtype)

    def forward(self, pixels: torch.Tensor) -> dict[str, torch.Tensor]:
        """pixels ``[B, H, W, 3]`` (H = W = ``image_size``) -> ``pooled_output``
        (the CLS token after the post layer norm, projected),
        ``last_hidden_state`` (the last layer's raw output) and
        ``penultimate_hidden_state`` (the layer before it)."""
        cfg, vm = self.cfg, self.vision_model
        dt = cfg.dtype
        x = vm.embeddings.patch_embedding(pixels.to(dt))
        x = x.reshape(x.shape[0], -1, cfg.hidden_size)
        cls = vm.embeddings.class_embedding.to(dt)[None, None].expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + vm.embeddings.position_embedding.weight.to(dt)[None]
        x = vm.pre_layrnorm(x)
        hidden = []
        for layer in vm.encoder.layers:
            x = layer(x)
            hidden.append(x)
        pooled = self.visual_projection(vm.post_layernorm(x[:, 0]))
        return {"pooled_output": pooled, "last_hidden_state": x,
                "penultimate_hidden_state": hidden[-2] if cfg.num_layers > 1 else x}
