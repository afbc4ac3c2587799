"""Job-config loading (the port's copy of ``ai_toolkit_tpu/config/loader.py``).

Behavior parity with the reference loader (``toolkit/config.py``):
YAML/JSON/JSONC configs, ``${ENV_VAR}`` substitution, ``[name]`` tag replacement
through the whole tree, and name-based lookup under a ``configs/`` directory.
The implementation is new and host-side only (no framework imports here).
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any

import yaml

_ENV_VAR_RE = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)\}")
_CONFIG_EXTS = (".yaml", ".yml", ".json", ".jsonc")


class _ExponentSafeLoader(yaml.SafeLoader):
    """YAML loader that parses ``1e-4``-style floats (YAML 1.1 misses them)."""


_ExponentSafeLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:
         [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9][0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def replace_env_vars(value: str, env: dict[str, str] | None = None) -> str:
    """Substitute ``${VAR}`` occurrences from the environment.

    Raises KeyError for undefined variables so config typos fail loudly.
    """
    env = os.environ if env is None else env

    def _sub(match: re.Match[str]) -> str:
        var = match.group(1)
        if var not in env:
            raise KeyError(f"config references undefined environment variable ${{{var}}}")
        return env[var]

    return _ENV_VAR_RE.sub(_sub, value)


def _strip_jsonc_comments(text: str) -> str:
    # Remove // line comments and /* */ block comments outside of strings.
    out: list[str] = []
    i, n = 0, len(text)
    in_str = False
    while i < n:
        c = text[i]
        if in_str:
            out.append(c)
            if c == "\\" and i + 1 < n:
                out.append(text[i + 1])
                i += 2
                continue
            if c == '"':
                in_str = False
            i += 1
            continue
        if c == '"':
            in_str = True
            out.append(c)
            i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "*":
            i += 2
            while i + 1 < n and not (text[i] == "*" and text[i + 1] == "/"):
                i += 1
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _resolve_config_path(name_or_path: str | os.PathLike[str]) -> Path:
    p = Path(name_or_path)
    if p.suffix in _CONFIG_EXTS and p.exists():
        return p
    if p.exists() and p.is_file():
        return p
    # Name-based lookup: configs/<name>.<ext> relative to cwd.
    for root in (Path("configs"), Path("config"), Path(".")):
        for ext in _CONFIG_EXTS:
            cand = root / f"{name_or_path}{ext}"
            if cand.exists():
                return cand
    raise FileNotFoundError(f"could not resolve config '{name_or_path}'")


def _replace_tags(tree: Any, tags: dict[str, str]) -> Any:
    """Recursively replace ``[tag]`` markers in every string of the tree."""
    if isinstance(tree, str):
        for tag, val in tags.items():
            tree = tree.replace(f"[{tag}]", val)
        return tree
    if isinstance(tree, dict):
        return {k: _replace_tags(v, tags) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_replace_tags(v, tags) for v in tree]
    return tree


def preprocess_config(raw: dict[str, Any], name_override: str | None = None) -> dict[str, Any]:
    """Validate top-level shape and apply ``[name]`` / env substitution.

    Top-level schema matches the reference: ``{job: <kind>, config: {name,
    process: [...]}, meta: {...}}``.
    """
    if "job" not in raw:
        raise ValueError("config must define a top-level 'job' key")
    if "config" not in raw or not isinstance(raw["config"], dict):
        raise ValueError("config must define a top-level 'config' mapping")
    cfg = raw["config"]
    if name_override is not None:
        cfg["name"] = name_override
    if "name" not in cfg:
        raise ValueError("config.config must define 'name'")
    name = str(cfg["name"])
    if "[time]" in name:
        import time

        name = name.replace("[time]", time.strftime("%Y%m%d_%H%M%S"))
        cfg["name"] = name
    return _replace_tags(raw, {"name": name})


def get_config(
    name_or_path: str | os.PathLike[str],
    name_override: str | None = None,
) -> dict[str, Any]:
    """Load, substitute, and preprocess a job config."""
    path = _resolve_config_path(name_or_path)
    text = path.read_text()
    text = replace_env_vars(text)
    if path.suffix in (".json", ".jsonc"):
        raw = json.loads(_strip_jsonc_comments(text))
    else:
        raw = yaml.load(text, Loader=_ExponentSafeLoader)
    if not isinstance(raw, dict):
        raise ValueError(f"config {path} did not parse to a mapping")
    return preprocess_config(raw, name_override=name_override)
