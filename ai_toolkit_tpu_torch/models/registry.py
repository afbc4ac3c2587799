"""Model registry: arch id -> model class (``ai_toolkit_tpu/models/registry.py``).

Only the archs of the ported slices are registered; any other arch id of the
JAX package raises ``NotImplementedError`` instead of being guessed at.
"""

from __future__ import annotations

MODEL_REGISTRY: dict[str, type] = {}


def register_model(cls):
    for arch in getattr(cls, "archs", [getattr(cls, "arch", None)]):
        if arch:
            MODEL_REGISTRY[arch] = cls
    return cls


def get_model_class(arch: str):
    import ai_toolkit_tpu_torch.models.flux_model  # noqa: F401  (registers flux, flux_schnell)
    import ai_toolkit_tpu_torch.models.hidream_model  # noqa: F401  (registers hidream)

    if arch not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"arch '{arch}' is not ported to ai_toolkit_tpu_torch yet; ported: "
            f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[arch]
