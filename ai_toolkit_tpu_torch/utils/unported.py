"""Refusing configuration the port does not take yet, instead of ignoring it."""

from __future__ import annotations


def refuse_unported(obj, names, defaults, what: str) -> None:
    """Raise ``NotImplementedError`` naming every attribute of ``obj`` in
    ``names`` that differs from the same attribute of ``defaults``."""
    changed = [n for n in names
               if hasattr(defaults, n) and getattr(obj, n) != getattr(defaults, n)]
    if changed:
        raise NotImplementedError(f"{what}: {changed} are not ported yet (later slice)")
