"""The reference HiDream-I1 transformer's checkpoint layout against the port's
``FluxDiT`` names (``ai_toolkit_tpu/io/dit_importers.py`` ``hidream_dit_tree``
with ``_swiglu_tree`` / ``_moe_tree`` in the port).

Each port tensor comes from reference tensors by one of five rules:

- ``same``: the tensor as it is (embedders, norms, projections, gates);
- ``cat``: q, k and v concatenated into the fused ``qkv`` Linear;
- ``half0`` / ``half1``: a double block's 12d adaLN modulation split into the
  image stream's first 6d rows and the text stream's last 6d;
- ``bank``: the routed experts' ``[out, in]`` weights transposed and stacked
  into an ``[E, in, out]`` bank (``flux_dit.Bank``).

The reference projects the text per block (``caption_projection.*``); the
port, as the JAX package, projects it once through ``txt_in``, which no
reference tensor fills: it keeps its seeded init, and the per-block
projections are left unread (``KEEP``). :func:`hidream_reference_state`
inverts the map, to write a port state in the reference layout.
"""

from __future__ import annotations

import torch

KEEP = ("txt_in.",)  # port tensors the reference layout does not hold

_TOP = [("time_in.in_layer", "t_embedder.timestep_embedder.linear_1"),
        ("time_in.out_layer", "t_embedder.timestep_embedder.linear_2"),
        ("vector_in.in_layer", "p_embedder.pooled_embedder.linear_1"),
        ("vector_in.out_layer", "p_embedder.pooled_embedder.linear_2"),
        ("img_in", "x_embedder.proj"), ("final_layer.linear", "final_layer.linear"),
        ("final_layer.adaLN_modulation.1", "final_layer.adaLN_modulation.1")]


def _attention(rules, port: str, ref: str, sfx: str) -> None:
    """q/k/v/out and the q/k RMS norms of one stream (``sfx`` "_t": the text stream)."""
    for leaf in ("weight", "bias"):
        rules.append((f"{port}qkv.{leaf}", "cat", [f"{ref}attn1.to_{n}{sfx}.{leaf}" for n in "qkv"]))
        rules.append((f"{port}proj.{leaf}", "same", [f"{ref}attn1.to_out{sfx}.{leaf}"]))
    for n, norm in (("q", "query_norm"), ("k", "key_norm")):
        rules.append((f"{port}norm.{norm}.scale", "same", [f"{ref}attn1.{n}_rms_norm{sfx}.weight"]))


def _swiglu(rules, port: str, ref: str) -> None:
    for w in ("w1", "w2", "w3"):
        rules.append((f"{port}{w}.weight", "same", [f"{ref}.{w}.weight"]))


def _moe(rules, port: str, ref: str, n_experts: int) -> None:
    rules.append((f"{port}gate.weight", "same", [f"{ref}.gate.weight"]))
    for w in ("w1", "w2", "w3"):
        rules.append((f"{port}experts.{w}.weight", "bank",
                      [f"{ref}.experts.{e}.{w}.weight" for e in range(n_experts)]))
    _swiglu(rules, f"{port}shared.", f"{ref}.shared_experts")


def hidream_layout(cfg) -> list[tuple[str, str, list[str]]]:
    """``(port key, rule, reference keys)`` for every port tensor the
    reference layout holds, for a ``FluxDiT`` config ``cfg``."""
    rules: list[tuple[str, str, list[str]]] = []
    for port, ref in _TOP:
        for leaf in ("weight", "bias"):
            rules.append((f"{port}.{leaf}", "same", [f"{ref}.{leaf}"]))
    for i in range(cfg.depth_double):
        p, r = f"double_blocks.{i}.", f"double_stream_blocks.{i}.block."
        for leaf in ("weight", "bias"):
            rules.append((f"{p}img_mod.lin.{leaf}", "half0", [f"{r}adaLN_modulation.1.{leaf}"]))
            rules.append((f"{p}txt_mod.lin.{leaf}", "half1", [f"{r}adaLN_modulation.1.{leaf}"]))
        _attention(rules, f"{p}img_attn.", r, "")
        _attention(rules, f"{p}txt_attn.", r, "_t")
        _moe(rules, f"{p}img_mlp.", f"{r}ff_i", cfg.moe_experts)
        _swiglu(rules, f"{p}txt_mlp.", f"{r}ff_t")
    for i in range(cfg.depth_single):
        p, r = f"single_blocks.{i}.", f"single_stream_blocks.{i}.block."
        for leaf in ("weight", "bias"):
            rules.append((f"{p}modulation.lin.{leaf}", "same", [f"{r}adaLN_modulation.1.{leaf}"]))
        _attention(rules, p, r, "")
        _moe(rules, f"{p}mlp.", f"{r}ff_i", cfg.moe_experts)
    return rules


_FORWARD = {
    "same": lambda t: t,
    "cat": lambda *ts: torch.cat(ts, dim=0),
    "half0": lambda t: t.chunk(2, dim=0)[0],
    "half1": lambda t: t.chunk(2, dim=0)[1],
    "bank": lambda *ts: torch.stack([t.t() for t in ts]),
}


def hidream_sources(cfg) -> dict:
    """``io/safetensors_dir.load_module`` sources: port key -> (function,
    reference keys)."""
    return {port: (_FORWARD[rule], refs) for port, rule, refs in hidream_layout(cfg)}


def hidream_reference_state(state: dict[str, torch.Tensor], cfg) -> dict[str, torch.Tensor]:
    """A port ``FluxDiT`` state dict in the reference layout (the inverse of
    :func:`hidream_sources`; ``txt_in`` has no place there)."""
    out: dict[str, torch.Tensor] = {}
    halves: dict[str, list] = {}
    for port, rule, refs in hidream_layout(cfg):
        t = state[port]
        if rule == "same":
            out[refs[0]] = t
        elif rule == "cat":
            out.update(zip(refs, (c.contiguous() for c in t.chunk(len(refs), dim=0))))
        elif rule == "bank":
            out.update(zip(refs, (e.t().contiguous() for e in t)))
        else:
            halves.setdefault(refs[0], [None, None])[int(rule[-1])] = t
    out.update({k: torch.cat(v, dim=0) for k, v in halves.items()})
    return out
