"""The diffusers MMDiT transformer layouts of SD3 / SD3.5
(``SD3Transformer2DModel``) and Qwen-Image (``QwenImageTransformer2DModel``)
against the port's ``FluxDiT`` names (``ai_toolkit_tpu/io/sd3_import.py``
``sd3_dit_tree`` and ``io/qwen_import.py`` ``qwen_transformer_to_tree``).

Each port tensor comes from checkpoint tensors by one of five rules:

- ``same``: the tensor as it is;
- ``cat``: q, k and v (weights or biases) concatenated into the fused ``qkv``
  Linear, the JAX importers' ``_fuse``;
- ``swap``: ``norm_out.linear``'s (scale, shift) halves swapped into the
  final layer's (shift, scale);
- ``conv``: SD3's conv patch embed ``pos_embed.proj.weight`` ``[d, c, 2, 2]``
  read as ``img_in`` over the patch-major ``(kh kw c)`` token features;
- ``crop``: SD3's ``pos_embed.pos_embed`` ``[1, M*M, d]`` centre-cropped to
  the model's ``pos_embed_max_size`` when the file's grid is larger (a
  smaller one raises, as in JAX).

SD3's blocks ``transformer_blocks.{i}`` are the port's ``dual_blocks``, then
``double_blocks``, then the context_pre_only ``final_block``, each stack
indexed from 0. Qwen-Image's 60 blocks are ``double_blocks``; its
``txt_norm`` (an RMSNorm before ``txt_in``) has no slot and is left unread,
and ``vector_in`` has no source and keeps its seeded init (:data:`QWEN_KEEP`),
as the JAX importer leaves them (ROADMAP Queue 3). :func:`reference_state`
inverts a layout, to write a port state in the diffusers names.
"""

from __future__ import annotations

import torch

QWEN_KEEP = ("vector_in.",)  # port tensors the Qwen-Image layout does not hold


def _lin(rules, port: str, ref: str, bias: bool = True) -> None:
    for leaf in ("weight", "bias") if bias else ("weight",):
        rules.append((f"{port}.{leaf}", "same", [f"{ref}.{leaf}"]))


def _qkv(rules, port: str, refs: list[str]) -> None:
    for leaf in ("weight", "bias"):
        rules.append((f"{port}.{leaf}", "cat", [f"{r}.{leaf}" for r in refs]))


def _attention(rules, port: str, r: str, cfg, sfx: str = "", added: bool = False, proj: bool = True) -> None:
    """One stream's q/k/v, QK norms and out projection: the image stream
    (``attn.to_q``; ``sfx`` "2": ``attn2.to_q``) or the text stream
    (``added``: ``attn.add_q_proj``, ``norm_added_q``, ``to_add_out``)."""
    a = f"{r}attn{sfx}."
    _qkv(rules, f"{port}qkv", [f"{a}add_{n}_proj" if added else f"{a}to_{n}" for n in "qkv"])
    if cfg.qk_norm:
        for n, norm in (("q", "query_norm"), ("k", "key_norm")):
            rules.append((f"{port}norm.{norm}.scale", "same",
                          [f"{a}norm_added_{n}.weight" if added else f"{a}norm_{n}.weight"]))
    if proj:
        _lin(rules, f"{port}proj", f"{a}to_add_out" if added else f"{a}to_out.0")


def sd3_layout(cfg) -> list[tuple[str, str, list[str]]]:
    """``(port key, rule, checkpoint keys)`` for every tensor of a SD3
    ``FluxDiT`` config ``cfg``."""
    rules: list[tuple[str, str, list[str]]] = [
        ("img_in.weight", "conv", ["pos_embed.proj.weight"]), ("img_in.bias", "same", ["pos_embed.proj.bias"]),
        ("pos_embed.pos_embed", "crop", ["pos_embed.pos_embed"]),
    ]
    for port, ref in (("txt_in", "context_embedder"),
                      ("time_in.in_layer", "time_text_embed.timestep_embedder.linear_1"),
                      ("time_in.out_layer", "time_text_embed.timestep_embedder.linear_2"),
                      ("vector_in.in_layer", "time_text_embed.text_embedder.linear_1"),
                      ("vector_in.out_layer", "time_text_embed.text_embedder.linear_2"),
                      ("final_layer.linear", "proj_out")):
        _lin(rules, port, ref)
    for leaf in ("weight", "bias"):
        rules.append((f"final_layer.adaLN_modulation.1.{leaf}", "swap", [f"norm_out.linear.{leaf}"]))
    n_dual, n_final = cfg.dual_attention_layers, int(cfg.final_context_pre_only)
    stacks = ([("dual_blocks", j) for j in range(n_dual)]
              + [("double_blocks", j) for j in range(cfg.depth_double - n_dual - n_final)]
              + [("final_block", None)] * n_final)
    for i, (stack, j) in enumerate(stacks):
        p, r = (f"{stack}.{j}." if j is not None else f"{stack}."), f"transformer_blocks.{i}."
        final = stack == "final_block"
        _lin(rules, f"{p}img_mod.lin", f"{r}norm1.linear")
        _lin(rules, f"{p}txt_mod" if final else f"{p}txt_mod.lin", f"{r}norm1_context.linear")
        _attention(rules, f"{p}img_attn.", r, cfg)
        _attention(rules, f"{p}txt_attn.", r, cfg, added=True, proj=not final)
        _lin(rules, f"{p}img_mlp.0", f"{r}ff.net.0.proj")
        _lin(rules, f"{p}img_mlp.2", f"{r}ff.net.2")
        if not final:
            _lin(rules, f"{p}txt_mlp.0", f"{r}ff_context.net.0.proj")
            _lin(rules, f"{p}txt_mlp.2", f"{r}ff_context.net.2")
        if stack == "dual_blocks":
            _attention(rules, f"{p}img2_attn.", r, cfg, sfx="2")
    return rules


def qwen_layout(cfg) -> list[tuple[str, str, list[str]]]:
    """``(port key, rule, checkpoint keys)`` for every tensor of Qwen-Image's
    ``FluxDiT`` but ``vector_in`` (:data:`QWEN_KEEP`)."""
    rules: list[tuple[str, str, list[str]]] = []
    for port, ref in (("img_in", "img_in"), ("txt_in", "txt_in"),
                      ("time_in.in_layer", "time_text_embed.timestep_embedder.linear_1"),
                      ("time_in.out_layer", "time_text_embed.timestep_embedder.linear_2"),
                      ("final_layer.linear", "proj_out")):
        _lin(rules, port, ref)
    for leaf in ("weight", "bias"):
        rules.append((f"final_layer.adaLN_modulation.1.{leaf}", "swap", [f"norm_out.linear.{leaf}"]))
    for i in range(cfg.depth_double):
        p, r = f"double_blocks.{i}.", f"transformer_blocks.{i}."
        _attention(rules, f"{p}img_attn.", r, cfg)
        _attention(rules, f"{p}txt_attn.", r, cfg, added=True)
        for port, ref in (("img_mlp.0", "img_mlp.net.0.proj"), ("img_mlp.2", "img_mlp.net.2"),
                          ("txt_mlp.0", "txt_mlp.net.0.proj"), ("txt_mlp.2", "txt_mlp.net.2"),
                          ("img_mod.lin", "img_mod.1"), ("txt_mod.lin", "txt_mod.1")):
            _lin(rules, p + port, r + ref)
    return rules


def _conv_to_linear(w: torch.Tensor) -> torch.Tensor:
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)  # [d, c, kh, kw] -> [d, (kh kw c)]


def _halves_swapped(t: torch.Tensor) -> torch.Tensor:
    a, b = t.chunk(2, dim=0)
    return torch.cat([b, a], dim=0)


def _crop(m: int):
    def crop(tab: torch.Tensor) -> torch.Tensor:
        m_ck = round(tab.shape[1] ** 0.5)
        if m_ck == m:
            return tab
        if m_ck < m:
            raise ValueError(f"sd3 pos_embed table in the checkpoint is {m_ck}x{m_ck} but the model wants "
                             f"{m}x{m}: set model_kwargs.size to the right variant")
        o = (m_ck - m) // 2
        g = tab.reshape(m_ck, m_ck, -1)[o:o + m, o:o + m]
        print(f"sd3 pos_embed: the checkpoint's {m_ck}x{m_ck} table centre-cropped to {m}x{m}")
        return g.reshape(1, m * m, -1)
    return crop


def sources(layout: list[tuple[str, str, list[str]]], cfg) -> dict:
    """``io/safetensors_dir.load_module`` sources: port key -> (function,
    checkpoint keys)."""
    forward = {"same": lambda t: t, "cat": lambda *ts: torch.cat(ts, dim=0), "swap": _halves_swapped,
               "conv": _conv_to_linear, "crop": _crop(getattr(cfg, "pos_embed_max_size", 0))}
    return {port: (forward[rule], refs) for port, rule, refs in layout}


def reference_state(state: dict[str, torch.Tensor], layout: list[tuple[str, str, list[str]]]
                    ) -> dict[str, torch.Tensor]:
    """A port ``FluxDiT`` state dict in the diffusers names of ``layout``
    (the inverse of :func:`sources`; a table keeps its size)."""
    out: dict[str, torch.Tensor] = {}
    for port, rule, refs in layout:
        t = state[port]
        if rule in ("same", "crop"):
            out[refs[0]] = t
        elif rule == "cat":
            out.update(zip(refs, (c.contiguous() for c in t.chunk(len(refs), dim=0))))
        elif rule == "swap":
            out[refs[0]] = _halves_swapped(t)
        else:  # conv: [d, (kh kw c)] -> [d, c, 2, 2]
            out[refs[0]] = t.reshape(t.shape[0], 2, 2, -1).permute(0, 3, 1, 2).contiguous()
    return out
