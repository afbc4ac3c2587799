"""The LDM / SGM single-file loader (``io/ldm_single_file.py``) against the
JAX package on the CPU at the tiny f32 size: JAX ``export_ldm_checkpoint``
writes sd1, sd2 and sdxl files from a seeded JAX init, and both packages load
them (the port through ``name_or_path``, as a job does) to equal tensors and
equal predictions; a ``.ckpt`` of the same tensors loads alike. The port is
strict: a file without one UNet tensor raises naming it, a tensor no map
places raises, what real files carry beside the weights (``model_ema.*``,
``position_ids``, the schedule buffers) is skipped by name, and a file that
is no LDM checkpoint is refused."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file
from test_torch_flux_family import fast_jit

from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.io.ldm_single_file import export_ldm_checkpoint, load_ldm_checkpoint
from ai_toolkit_tpu.models.sd_model import SDModel as JSDModel
from ai_toolkit_tpu.models.sd_model import SDXLModel as JSDXLModel
from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.io.ldm_single_file import split_ldm_checkpoint
from ai_toolkit_tpu_torch.models.registry import get_model_class
from test_torch_sd15 import port_init_as_jax
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)


def _cfg(arch, path=""):
    return {"name_or_path": path, "arch": arch, "model_kwargs": {"size": "tiny"}}


def _jax_model(arch, path=""):
    return (JSDXLModel if arch == "sdxl" else JSDModel)(JModelConfig.from_dict(_cfg(arch, path)))


@pytest.fixture(scope="module", params=["sd1", "sd2", "sdxl"])
def exported(request, tmp_path_factory):
    """(arch, the JAX-written file, the JAX package's load of it)."""
    arch = request.param
    jmodel = _jax_model(arch)
    # the port's seeded init as the JAX tree (no JAX init to compile), also the JAX loader's template
    variables = port_init_as_jax(arch, seed=3)
    path = str(tmp_path_factory.mktemp(arch) / f"{arch}.safetensors")
    export_ldm_checkpoint(jmodel, variables, path, dtype=np.float32)
    loader = _jax_model(arch, path)
    loader.init_variables = lambda key: variables
    loaded = jax.tree.map(np.asarray, load_ldm_checkpoint(path, loader))
    return arch, path, loaded


def _port_load(arch, path):
    model = get_model_class(arch)(ModelConfig.from_dict(_cfg(arch, path)), device="cpu")
    return model, model.load_variables(torch.Generator().manual_seed(0))


def _state(arch, loaded):
    states = {"unet": from_jax.unet_state_dict(loaded["unet"]), "vae": from_jax.vae_state_dict(loaded["vae"]),
              "clip": from_jax.clip_state_dict(loaded["clip"])}
    if arch == "sdxl":
        states["clip2"] = from_jax.clip_state_dict(loaded["clip2"])
    return states


def _predict_both(arch, path, loaded, variables, model):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    t = np.asarray([20, 700], np.int64)
    prompts = ["a watercolor fox", "a lighthouse"]
    jmodel = _jax_model(arch, path)
    jcond = jmodel.encode_prompt(loaded, prompts)
    with torch.inference_mode():
        cond = model.encode_prompt(variables, prompts)
    if arch == "sdxl":
        jcond = {"context": jcond["context"], "added_cond": jmodel.added_cond(jcond["pooled"], 64, 64)}
        cond = {"context": cond["context"], "added_cond": model.added_cond(cond["pooled"], 64, 64)}
    ref = fast_jit(jmodel.predict, loaded, jnp.asarray(x), jnp.asarray(t, jnp.int32), jcond)
    with torch.inference_mode():
        out = model.predict(variables, torch.from_numpy(x), torch.from_numpy(t), cond)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_both_packages_load_the_jax_export_alike(exported):
    """Every tensor the port loads equals the JAX loader's (f32, bit for
    bit), and the two models' predictions agree (1e-4: f32 through the UNet
    and the text encoders)."""
    arch, path, loaded = exported
    model, variables = _port_load(arch, path)
    for name, ref in _state(arch, loaded).items():
        ours = variables[name].state_dict()
        assert sorted(ours) == sorted(ref), name
        for k in ref:
            assert torch.equal(ours[k], ref[k].to(ours[k].dtype)), f"{name} {k}"
    _predict_both(arch, path, loaded, variables, model)


def test_a_ckpt_and_the_real_files_extras_load(exported, tmp_path):
    """The same tensors as a ``.ckpt`` (``state_dict`` of torch tensors), with
    what real files carry beside the weights: an EMA copy, ``position_ids``,
    the schedule buffers; SD 1.x's ``proj_in`` / ``proj_out`` as 1x1 convs.
    The load equals the safetensors one."""
    arch, path, _ = exported
    flat = {k: torch.from_numpy(v) for k, v in load_file(path).items()}
    proj = [k for k in flat if k.endswith(("proj_in.weight", "proj_out.weight")) and "diffusion_model" in k]
    assert proj
    for k in proj:
        flat[k] = flat[k][:, :, None, None]
    extras = {"betas": torch.linspace(1e-4, 2e-2, 1000), "alphas_cumprod": torch.ones(1000),
              "model_ema.decay": torch.tensor(0.9999), "model_ema.num_updates": torch.tensor(7),
              "model_ema.diffusion_modelconv_inweight": torch.zeros(3)}
    text = "cond_stage_model.transformer." if arch == "sd1" else "conditioner.embedders.0.transformer."
    if arch != "sd2":
        extras[text + "text_model.embeddings.position_ids"] = torch.arange(77)[None]
    ckpt = str(tmp_path / f"{arch}.ckpt")
    torch.save({"state_dict": {**flat, **extras}, "global_step": 10}, ckpt)
    _, want = _port_load(arch, path)
    _, got = _port_load(arch, ckpt)
    for name in want:
        a, b = want[name].state_dict(), got[name].state_dict()
        assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a), name


def test_the_loader_is_strict(exported, tmp_path):
    """A file without one UNet tensor raises naming it (the JAX loader keeps
    the init there); a tensor no map places raises; a component the model has
    not (SDXL's second text encoder for sd1) raises; a file with no
    ``model.diffusion_model.*`` is refused."""
    arch, path, _ = exported
    flat = load_file(path)
    key = next(k for k in flat if k.endswith("input_blocks.1.0.in_layers.2.weight"))
    missing = str(tmp_path / "missing.safetensors")
    save_file({k: v for k, v in flat.items() if k != key}, missing)
    with pytest.raises(KeyError, match="down_blocks.0.resnets.0.conv1.weight"):
        _port_load(arch, missing)
    stray = str(tmp_path / "stray.safetensors")
    save_file({**flat, "model.diffusion_model.input_blocks.1.0.extra.weight": np.zeros(2, np.float32)}, stray)
    with pytest.raises(ValueError, match="extra.weight"):
        _port_load(arch, stray)
    if arch == "sdxl":
        with pytest.raises(ValueError, match="clip2"):
            _port_load("sd1", path)
    other = str(tmp_path / "other.safetensors")
    save_file({"x": np.zeros(1, np.float32)}, other)
    with pytest.raises(ValueError, match="not an LDM single-file checkpoint"):
        _port_load(arch, other)


def test_split_places_every_key_of_each_layout(exported):
    """The split of each JAX-written file: the components the arch has, no
    key left over, SD 2.x's OpenCLIP tower cut to the model's layers (the
    exporter's extra last block skipped) with its fused ``in_proj`` as q, k
    and v."""
    arch, path, _ = exported
    keys = list(load_file(path))
    comps, unknown = split_ldm_checkpoint(keys, layers_per_block=1, sd2_clip_layers=2)
    assert not unknown
    assert sorted(comps) == sorted(["unet", "vae", "clip"] + (["clip2"] if arch == "sdxl" else []))
    if arch == "sd2":
        assert any(k.endswith("resblocks.2.ln_1.weight") for k in keys)
        assert not any(n.startswith("text_model.encoder.layers.2.") for n in comps["clip"])
        q_key, fn = comps["clip"]["text_model.encoder.layers.0.self_attn.q_proj.weight"]
        assert q_key.endswith("resblocks.0.attn.in_proj_weight") and fn is not None
