"""Textual inversion (the port's copy of ``ai_toolkit_tpu/adapters/embedding.py``,
numpy only): a trigger word expands to ``n_vectors`` virtual token ids,
``vocab_size`` .. ``vocab_size + n_vectors - 1``, whose embeddings, a
``[n_vectors, hidden]`` bank beside CLIP's frozen token table, are all that
trains (``models/text_encoders/clip.py`` looks the virtual ids up in the
bank). The bank is saved in the a1111 / kohya layout, ``{"emb_params": [n,
hidden]}`` in f32.
"""

from __future__ import annotations

import numpy as np

# the keys of a process's ``embedding:`` the JAX job reads
EMBEDDING_KEYS = ("trigger", "vectors", "init_words")


class TriggerTokenizer:
    """Wraps a tokenizer, mapping the trigger word to the virtual token ids
    (vocab_size .. vocab_size + n_vectors - 1)."""

    def __init__(self, base_tokenizer, trigger: str, vocab_size: int, n_vectors: int):
        self.base = base_tokenizer
        self.trigger = trigger
        self.vocab_size = vocab_size
        self.n_vectors = n_vectors
        self.max_len = base_tokenizer.max_len
        self.eos_id = base_tokenizer.eos_id

    def encode(self, text: str) -> np.ndarray:
        if self.trigger not in text:
            return self.base.encode(text)
        # split on the trigger, encode the pieces, splice the virtual ids in
        parts = text.split(self.trigger)
        virt = list(range(self.vocab_size, self.vocab_size + self.n_vectors))
        ids: list[int] = []
        for i, part in enumerate(parts):
            if part.strip():
                piece = self.base.encode(part.strip())
                ids.extend(int(x) for x in piece if int(x) != self.eos_id)
            if i < len(parts) - 1:
                ids.extend(virt)
        ids = ids[: self.max_len - 1] + [self.eos_id]
        out = np.full((self.max_len,), self.eos_id, np.int32)
        out[: len(ids)] = ids
        return out


def init_embedding_bank(n_vectors: int, hidden: int, init_from: np.ndarray | None = None, std: float = 0.02,
                        seed: int = 0) -> np.ndarray:
    """The f32 ``[n_vectors, hidden]`` bank: the rows of ``init_from`` (the
    token embeddings of ``init_words``) repeated to ``n_vectors``, else
    normal(0, std) from ``seed``."""
    rng = np.random.default_rng(seed)
    if init_from is not None:
        base = np.asarray(init_from, np.float32)
        if base.ndim == 1:
            base = base[None]
        reps = int(np.ceil(n_vectors / base.shape[0]))
        return np.tile(base, (reps, 1))[:n_vectors].copy()
    return (rng.standard_normal((n_vectors, hidden)) * std).astype(np.float32)


def save_embedding(bank: np.ndarray, path: str, name: str = "emb", step: int = 0) -> None:
    """The a1111 / kohya textual-inversion file ``{"emb_params": [n, hidden]}``,
    f32 whatever the job's save dtype, with the trigger and step in its
    metadata."""
    from safetensors.numpy import save_file

    save_file({"emb_params": np.ascontiguousarray(np.asarray(bank, np.float32))}, path,
              metadata={"name": name, "step": str(step), "software": "ai_toolkit_tpu"})


def load_embedding(path: str) -> np.ndarray:
    """The bank of a textual-inversion file (``emb_params``, or the other
    names the JAX package reads)."""
    from safetensors.numpy import load_file

    flat = load_file(path)
    if "emb_params" in flat:
        return flat["emb_params"]
    for k in ("clip_l", "string_to_param.*", "emb"):
        if k in flat:
            return flat[k]
    raise KeyError(f"no embedding tensor found in {path}: keys={list(flat)}")
