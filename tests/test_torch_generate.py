"""The port's flux generate slice as a whole: the tiny model through the JAX
generate_flux and the port's, same weights and injected noise; the job entry
point on the CPU; the port importing neither jax nor the JAX package;
chip_smoke.py refusing to run without a card."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ai_toolkit_tpu.config.modules import GenerateImageConfig, ModelConfig
from ai_toolkit_tpu.generation import generate_flux as jax_generate_flux
from ai_toolkit_tpu.io.flux_import import flux_dit_rules
from ai_toolkit_tpu.io.sd_import import clip_rules, t5_rules, vae_rules
from ai_toolkit_tpu.io.torch_import import torch_to_tree
from ai_toolkit_tpu.models.flux_model import FluxModel as JaxFluxModel
from ai_toolkit_tpu_torch.generation import generate_flux
from ai_toolkit_tpu_torch.io.from_jax import flux_model_state
from ai_toolkit_tpu_torch.jobs import run_job
from ai_toolkit_tpu_torch.models.flux_model import FluxModel

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"name_or_path": "", "arch": "flux", "model_kwargs": {"size": "tiny"}}


def test_generate_flux_matches_jax():
    """uint8 images differ by at most 1 (f32 on both sides; the rounding to
    uint8 can flip on summation-order differences)."""
    model = FluxModel(ModelConfig.from_dict(dict(TINY)), device="cpu")
    variables = model.init_variables(torch.Generator().manual_seed(0))
    flat = {name: {k: v.numpy() for k, v in m.state_dict().items()} for name, m in variables.items()}
    vc = model.vae_config
    rules = {"dit": flux_dit_rules(scan_blocks=False), "clip": clip_rules(), "t5": t5_rules(),
             "vae": vae_rules(len(vc.channel_multipliers), vc.layers_per_block)}
    jax_vars = {}
    for name, r in rules.items():
        jax_vars[name], unmatched = torch_to_tree(flat[name], r)
        assert not unmatched, unmatched[:5]
    # the weights also survive the JAX tree -> port state dict direction
    model.load_state_dicts(variables, flux_model_state(jax_vars))

    gen = GenerateImageConfig(prompt="a watercolor fox in a misty forest", width=32, height=32,
                              seed=7, guidance_scale=4.0, sample_steps=2, sampler="flowmatch")
    jax_model = JaxFluxModel(ModelConfig.from_dict(dict(TINY)))
    ref = jax_generate_flux(jax_model, jax_vars, gen)
    h, w, c = model.latent_shape(gen.height, gen.width)
    noise = np.asarray(jax.random.normal(jax.random.key(gen.seed), (1, h, w, c), jnp.float32))
    ours = generate_flux(model, variables, gen, noise=noise)
    assert ours.shape == ref.shape == (32, 32, 3) and ours.dtype == np.uint8
    diff = np.abs(ours.astype(np.int16) - np.asarray(ref).astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert len(np.unique(ours)) > 8  # not a flat image


def test_run_job_writes_one_png_per_prompt(tmp_path):
    from PIL import Image

    raw = {"job": "generate", "config": {"name": "gen_tiny", "process": [{
        "type": "generate", "training_folder": str(tmp_path), "model": dict(TINY),
        "sample": {"sampler": "flowmatch", "width": 32, "height": 32, "guidance_scale": 4,
                   "sample_steps": 2, "seed": 42, "walk_seed": True,
                   "prompts": ["a watercolor fox", "macro photo of a dew drop"]}}]}}
    (result,) = run_job(raw, device="cpu")
    assert len(result["images"]) == 2
    for path in result["images"]:
        im = np.asarray(Image.open(path))
        assert im.shape == (32, 32, 3)


def test_unported_branches_raise(tmp_path):
    import pytest

    base = {"type": "generate", "training_folder": str(tmp_path), "model": dict(TINY),
            "sample": {"width": 32, "height": 32, "sample_steps": 1, "prompts": ["x"]}}
    for proc in ({**base, "model": {**TINY, "lora_path": "/nowhere/lora.safetensors"}},
                 {**base, "type": "sd_trainer"},  # no network: full fine-tune
                 {**base, "model": {**TINY, "arch": "sdxl"}},
                 {**base, "model": {**TINY, "name_or_path": "/nowhere/flux"}},
                 {**base, "sample": {**base["sample"], "sampler": "ddim"}}):
        with pytest.raises(NotImplementedError):
            run_job({"job": "generate", "config": {"name": "x", "process": [proc]}}, device="cpu")


_BANNED = ("jax", "jaxlib", "flax", "optax", "ai_toolkit_tpu")
_BLOCK_JAX = r"""
import importlib, importlib.abc, pkgutil, sys
BANNED = %r
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
for m in [m for m in sys.modules if m.split(".")[0] in BANNED]:
    del sys.modules[m]
import ai_toolkit_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert not [m for m in sys.modules if m.split(".")[0] in BANNED], "a banned module was imported"
print(" ".join(names))
print("imported", len(names))
""" % (_BANNED,)
# the modules of the hidream slice, named so that a rename cannot drop them from the check
_HIDREAM_MODULES = ("ai_toolkit_tpu_torch.ops.kernels.moe_gmm", "ai_toolkit_tpu_torch.models.hidream_model",
                    "ai_toolkit_tpu_torch.models.text_encoders.llm", "ai_toolkit_tpu_torch.adapters.quantize")


def test_port_imports_without_jax():
    """Every module of the port imports in a fresh process where jax and the
    JAX package ``ai_toolkit_tpu`` cannot be imported, and none of them is
    left in ``sys.modules``."""
    proc = subprocess.run([sys.executable, "-c", _BLOCK_JAX], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.split()[-1]) >= 39
    imported = set(proc.stdout.splitlines()[-2].split())
    assert imported.issuperset(_HIDREAM_MODULES), sorted(set(_HIDREAM_MODULES) - imported)


def test_chip_smoke_fails_without_cuda():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
