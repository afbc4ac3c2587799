"""Model registry: arch id -> model class (``ai_toolkit_tpu/models/registry.py``).

Only the archs of the ported slices are registered; any other arch id of the
JAX package raises ``NotImplementedError`` instead of being guessed at.
"""

from __future__ import annotations

MODEL_REGISTRY: dict[str, type] = {}
# archs of a ported family that still wait for their slice
_LATER = {"chroma_radiance": "chroma_radiance (pixel-space chroma with the NeRF head, JAX ChromaRadianceModel) "
                             "comes with a later slice (ROADMAP Queue 1 item 6)",
          "qwen_image_edit_plus": "qwen_image_edit_plus (several reference images a batch: img_mask, ctrl_counts, "
                                  "a frame index each) comes with a later slice (ROADMAP Queue 1 item 6)",
          "mageflow": "mageflow (MageVAE, the Qwen3-VL text tower, one token per latent pixel) comes with a later "
                      "slice (ROADMAP Queue 1 item 6)",
          "mageflow_edit": "mageflow_edit (MageVAE, the Qwen3-VL text tower, one token per latent pixel) comes with "
                           "a later slice (ROADMAP Queue 1 item 6)"}


def register_model(cls):
    for arch in getattr(cls, "archs", [getattr(cls, "arch", None)]):
        if arch:
            MODEL_REGISTRY[arch] = cls
    return cls


def get_model_class(arch: str):
    import ai_toolkit_tpu_torch.models.audio_model  # noqa: F401  (registers ace_step_15, ace_step_15_xl, ace_step)
    import ai_toolkit_tpu_torch.models.flux_model  # noqa: F401  (registers flux, flux_schnell, flex*, kontext, chroma)
    import ai_toolkit_tpu_torch.models.hidream_model  # noqa: F401  (registers hidream)
    import ai_toolkit_tpu_torch.models.ltx2_model  # noqa: F401  (registers ltx2, ltx2_3, ltx2.3, ltxv, minimax_h3)
    import ai_toolkit_tpu_torch.models.lumina2_model  # noqa: F401  (registers lumina2)
    import ai_toolkit_tpu_torch.models.omnigen2_model  # noqa: F401  (registers omnigen2)
    import ai_toolkit_tpu_torch.models.qwen_model  # noqa: F401  (registers qwen_image, qwen_image_edit)
    import ai_toolkit_tpu_torch.models.sd3_model  # noqa: F401  (registers sd3, sd35, sd35_large)
    import ai_toolkit_tpu_torch.models.sd_model  # noqa: F401  (registers sd1, sd15, sd2, ssd, vega, sdxl)
    import ai_toolkit_tpu_torch.models.wan_model  # noqa: F401  (registers wan21, wan21_i2v, wan22_5b, wan22_14b*)

    if arch in _LATER:
        raise NotImplementedError(_LATER[arch])
    if arch not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"arch '{arch}' is not ported to ai_toolkit_tpu_torch yet; ported: "
            f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[arch]
