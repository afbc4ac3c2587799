"""Sampling during training, the port's train job against the JAX job on
the CPU at tiny sizes: the same sample files at the same steps (a first
sample, every ``sample_every`` steps, a final one). The flux job is here,
the SDXL job in ``test_torch_job_sampling_sdxl.py``: each runs the JAX job,
whose compiles take tens of seconds, so the two files run on two workers."""

import functools
import glob
import os

import jax
import numpy as np
import pytest
from PIL import Image

from ai_toolkit_tpu.jobs import run_job as jrun_job
from ai_toolkit_tpu.models.registry import get_model_class as jget_model_class
from ai_toolkit_tpu_torch.jobs import run_job
from test_torch_flux_family import OPT0
from test_torch_job_features import TINY_FLUX, _images, _proc


def _sample_names(root: str) -> list[str]:
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(root, "samples", "*")))


def _job(tmp_path, out: str, model: dict) -> dict:
    """3 steps with ``sample_every: 2`` over two square images at one
    resolution (one bucket, so each side compiles one step shape): samples
    at steps 0 (first), 2 (every) and 3 (final), one prompt, one denoise step."""
    over = {"train": {"disable_sampling": False, "lr_scheduler": "constant"},
            "sample": {"sampler": "flowmatch" if model["arch"] == "flux" else "ddim", "sample_every": 2,
                       "width": 32, "height": 32, "sample_steps": 1, "guidance_scale": 4.0,
                       "prompts": ["sks photo"]}}
    raw = _proc(tmp_path, out, 3, model, **over)
    raw["config"]["process"][0]["datasets"][0]["resolution"] = [32]
    return raw


def check_sampling_matches_jax(tmp_path, monkeypatch, model: dict) -> None:
    """The port's job and the JAX job write the same sample files; the
    port's are images of the sample size and not constant. The JAX model's
    seeded init runs under one ``jax.jit`` (eager, it takes half a minute),
    and the JAX job's jits compile at XLA's optimization level 0 (``OPT0``):
    the weights' and the samples' values do not enter what is compared."""
    real_jit = jax.jit
    monkeypatch.setattr(jax, "jit", lambda *a, **k: real_jit(*a, **{"compiler_options": OPT0, **k}))
    jcls = jget_model_class(model["arch"])
    real_init = jcls.init_variables
    monkeypatch.setattr(jcls, "init_variables", lambda self, key: jax.jit(functools.partial(real_init, self))(key))
    _images(str(tmp_path / "imgs"), ((32, 32), (32, 32)))
    (result,) = run_job(_job(tmp_path, "port", model), device="cpu")
    jrun_job(_job(tmp_path, "jax", model))
    ours = _sample_names(str(tmp_path / "port" / "feat"))
    assert ours == _sample_names(str(tmp_path / "jax" / "feat"))
    assert ours == [f"feat_{s:09d}_0.png" for s in (0, 2, 3)]
    assert [(r["step"], r["index"]) for r in result["samples"]] == [(0, 0), (2, 0), (3, 0)]
    for r in result["samples"]:
        px = np.asarray(Image.open(r["path"]))
        assert px.shape == (32, 32, 3) and px.std() > 0


@pytest.mark.parametrize("model", [TINY_FLUX], ids=["flux"])  # SDXL: test_torch_job_sampling_sdxl.py
def test_sampling_during_training_writes_the_jax_sample_files(tmp_path, monkeypatch, model):
    check_sampling_matches_jax(tmp_path, monkeypatch, model)
