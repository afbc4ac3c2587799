"""Tokenizer loading with a deterministic offline fallback (the port's copy of
``ai_toolkit_tpu/utils/tokenizer.py``).

If ``<model_dir>/<subdir>/tokenizer.json`` exists (HF layout), use the
``tokenizers`` library. Otherwise (tests, random-init bench runs in this
zero-egress environment) fall back to a stable hash tokenizer so prompt
pipelines remain exercisable end-to-end.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np


class HashTokenizer:
    """Deterministic word-hash tokenizer (offline fallback)."""

    def __init__(self, vocab_size: int, eos_id: int, max_len: int, bos_id: int | None = None):
        self.vocab_size = vocab_size
        self.eos_id = eos_id
        self.bos_id = bos_id
        self.max_len = max_len

    def encode(self, text: str) -> np.ndarray:
        words = text.lower().split()
        ids = []
        if self.bos_id is not None:
            ids.append(self.bos_id)
        for w in words:
            h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
            ids.append(h % max(2, self.vocab_size - 2) + 1)
        ids = ids[: self.max_len - 1] + [self.eos_id]
        out = np.full((self.max_len,), self.eos_id, np.int32)
        out[: len(ids)] = ids
        return out

    def decode(self, ids) -> str:
        """Hash ids aren't invertible — emit deterministic word tokens
        (the tiny-VLM captioner test path)."""
        words = []
        for i in ids:
            i = int(i)
            if i == self.eos_id:
                break
            if self.bos_id is not None and i == self.bos_id:
                continue
            words.append(f"tok{i}")
        return " ".join(words)


class HFTokenizer:
    def __init__(self, path: str, max_len: int, eos_id: int):
        from tokenizers import Tokenizer

        self.tok = Tokenizer.from_file(path)
        self.max_len = max_len
        self.eos_id = eos_id
        self.tok.enable_truncation(max_len)

    def encode(self, text: str) -> np.ndarray:
        ids = self.tok.encode(text).ids[: self.max_len]
        out = np.full((self.max_len,), self.eos_id, np.int32)
        out[: len(ids)] = ids
        return out

    def decode(self, ids) -> str:
        ids = [int(i) for i in ids]
        if self.eos_id in ids:
            ids = ids[: ids.index(self.eos_id)]
        return self.tok.decode(ids)


def load_tokenizer(
    model_dir: str | None,
    subdir: str,
    vocab_size: int,
    eos_id: int,
    max_len: int,
    bos_id: int | None = None,
):
    if model_dir:
        p = os.path.join(model_dir, subdir, "tokenizer.json")
        if os.path.isfile(p):
            return HFTokenizer(p, max_len, eos_id)
    return HashTokenizer(vocab_size, eos_id, max_len, bos_id)
