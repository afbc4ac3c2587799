"""Schedule factory (``ai_toolkit_tpu/samplers/factory.py`` ``get_schedule`` in
PyTorch): a noise scheduler name and the model's arch -> the schedule, with
the JAX package's per-arch defaults under the caller's overrides (the train
job's ``train.scheduler_params``). A ``weighting_table`` may be given as a
list, an ``.npy`` file or a JSON file of floats; an override that is no
field of the schedule raises, naming it."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np

from ai_toolkit_tpu_torch.samplers.ddpm import DDPMSchedule
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule

_FLOW = ("flowmatch", "flowmatch_euler", "mean_flow")
DDPM_NAMES = ("ddpm", "ddim", "euler", "euler_a", "dpm", "dpm++", "dpmpp_2m", "dpm++ 2m", "pndm", "lms",
              "heun", "lcm", "custom_lcm")


def get_schedule(name: str | None, arch: str | None = None, **overrides: Any):
    """name: a flow-matching name (``flowmatch``) or a DDPM-family one
    (``ddpm``, ``ddim``, ...); the DDPM family shares one schedule, its
    sampler is chosen at generation time."""
    overrides = dict(overrides)
    wt = overrides.get("weighting_table")
    if isinstance(wt, str):
        if wt.endswith(".npy"):
            overrides["weighting_table"] = tuple(np.load(wt).tolist())
        elif os.path.isfile(wt):
            with open(wt) as f:
                overrides["weighting_table"] = tuple(json.load(f))
    elif isinstance(wt, list):
        overrides["weighting_table"] = tuple(wt)
    name = (name or "flowmatch").lower()
    if name in _FLOW:
        defaults: dict[str, Any] = {}
        if arch in ("sd3", "prx_pixel", "prx", "zimage", "zimage_l2p", "zeta_chroma"):
            defaults = {"shift": 3.0, "use_dynamic_shifting": False}
        elif arch in ("lumina2",):
            defaults = {"shift": 6.0, "use_dynamic_shifting": False}
        elif arch in ("ideogram4",):
            defaults = {"shift": 1.0, "use_dynamic_shifting": False}
        elif arch in ("flux", "flex1", "flex2", "flux_kontext", "chroma"):
            defaults = {"use_dynamic_shifting": True}
        elif arch in ("cogview4",):
            defaults = {"use_dynamic_shifting": True, "base_shift": 0.25, "max_shift": 0.75,
                        "time_shift_type": "linear"}
        return _build(FlowMatchSchedule, {**defaults, **overrides})
    if name in DDPM_NAMES:
        defaults = {"prediction_type": "v_prediction"} if arch in ("sd2", "sd2_v") else {}
        return _build(DDPMSchedule, {**defaults, **overrides})
    raise ValueError(f"unknown noise scheduler '{name}'")


def _build(cls, fields: dict[str, Any]):
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"scheduler_params {unknown} are no fields of {cls.__name__} (its fields: {sorted(known)})")
    return cls(**fields)
