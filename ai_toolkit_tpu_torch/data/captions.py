"""Caption processing (``ai_toolkit_tpu/data/captions.py`` in the port):
caption files, ``[trigger]`` replacement and trigger injection, comma-token
shuffle / dropout with ``keep_tokens`` pinned, and full-caption dropout."""

from __future__ import annotations

import json
import os
import random


def load_caption_pair(path: str, caption_ext: str = "txt", default: str = "") -> tuple[str, str]:
    """(caption, caption_short) for an image path; a json caption file may
    carry ``caption`` / ``text`` and ``caption_short``."""
    base, _ = os.path.splitext(path)
    cap_path = f"{base}.{caption_ext}"
    if not os.path.isfile(cap_path):
        return default, default
    with open(cap_path, encoding="utf-8") as f:
        text = f.read().strip()
    short = default
    if caption_ext == "json":
        try:
            data = json.loads(text)
        except json.JSONDecodeError:
            return text, short
        text = data.get("caption", data.get("text", ""))
        short = data.get("caption_short", default)
    return text, short


def process_caption(
    caption: str,
    *,
    trigger_word: str | None = None,
    caption_dropout_rate: float = 0.0,
    token_dropout_rate: float = 0.0,
    shuffle_tokens: bool = False,
    keep_tokens: int = 0,
    rng: random.Random | None = None,
) -> str:
    rng = rng or random.Random()
    if trigger_word:
        if "[trigger]" in caption:
            caption = caption.replace("[trigger]", trigger_word)
        elif trigger_word not in caption:
            caption = f"{trigger_word}, {caption}" if caption else trigger_word
    if caption_dropout_rate > 0 and rng.random() < caption_dropout_rate:
        return ""
    if shuffle_tokens or token_dropout_rate > 0:
        tokens = [t.strip() for t in caption.split(",") if t.strip()]
        head, tail = tokens[:keep_tokens], tokens[keep_tokens:]
        if token_dropout_rate > 0:
            tail = [t for t in tail if rng.random() >= token_dropout_rate]
        if shuffle_tokens:
            tail = list(tail)
            rng.shuffle(tail)
        caption = ", ".join(head + tail)
    return caption
