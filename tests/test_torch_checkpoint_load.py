"""Checkpoint loading, the port against the JAX package on the CPU at tiny f32
sizes. For each arch a checkpoint directory in the published layout is
written from a seeded JAX init (seed 7): through ``io/from_jax`` state dicts,
whose names are the checkpoint names (flux's BFL DiT, the diffusers UNet, VAEs
and Wan modules, the transformers text encoders), and for hidream through the
inverse of ``io/hidream_layout``. The JAX package's own loader must give back
the seeded source bit for bit (its loaders init from ``jax.random.key(0)``,
so a tensor its rules missed would differ), the port's loaded state must
equal ``from_jax`` of the JAX-loaded tree bit for bit, and one ``predict``
must agree at 1e-4. FLUX.1-dev's own layout (a diffusers ``transformer/``
beside ``flux1-dev.safetensors``) loads the single file in both. Then the
refusals: a diffusers-layout flux transformer with no BFL source, a path
that is no local checkpoint, a single file that is no LDM checkpoint and a
missing key (the LDM single file itself: ``test_torch_ldm_single_file.py``).
The Wan archs' loads are in ``test_torch_checkpoint_load_wan.py``, SDXL's in
``test_torch_checkpoint_load_sdxl.py`` and the JAX loaders' faults in
``test_torch_checkpoint_load_faults{,_wan}.py``, so the files' JAX compiles
run on several workers. Each arch's JAX init compiles once per file, at
XLA's optimization level 0 (``_jit_init``)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.models.flux_model import FluxModel as JFluxModel
from ai_toolkit_tpu.models.hidream_model import HiDreamModel as JHiDreamModel
from ai_toolkit_tpu.models.sd_model import SDXLModel as JSDXLModel
from ai_toolkit_tpu.models.wan_model import WanModel as JWanModel
from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.io.hidream_layout import KEEP, hidream_reference_state
from ai_toolkit_tpu_torch.models.registry import get_model_class
from test_torch_flux_family import OPT0, fast_jit

torch.set_num_threads(1)
SEED = 7
PROMPTS = ["a photo of a red fox"]
JAX_CLASSES = {"flux": JFluxModel, "hidream": JHiDreamModel, "sdxl": JSDXLModel, "wan21": JWanModel,
               "wan22_14b": JWanModel, "wan22_5b": JWanModel}


_INITS: dict = {}


def _jit_init(jmodel, arch: str):
    """``jmodel.init_variables`` compiled once per arch for the file, at XLA's
    optimization level 0 (the tests' models of an arch differ only in their
    path, which the init does not read); the JAX loaders call it too."""
    if arch not in _INITS:
        _INITS[arch] = jax.jit(jmodel.init_variables, compiler_options=OPT0)
    return _INITS[arch]


def _cfg(arch: str, path: str) -> dict:
    return {"name_or_path": path, "arch": arch, "model_kwargs": {"size": "tiny"}}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _write(root: str, sub: str, state: dict[str, torch.Tensor], name: str = "model.safetensors") -> None:
    os.makedirs(os.path.join(root, sub), exist_ok=True)
    save_file({k: v.contiguous() for k, v in state.items()}, os.path.join(root, sub, name))


def _text_files(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A transformers checkpoint holds a tied tensor once (T5's ``shared``)."""
    return {k: v for k, v in state.items() if k != "encoder.embed_tokens.weight"}


def _wan_dit_files(state: dict[str, torch.Tensor], patch) -> dict[str, torch.Tensor]:
    """The port's Wan DiT state in diffusers' layout: the patch Linear as
    the conv3d ``[out, in, kt, kh, kw]``."""
    out = dict(state)
    w = state["patch_embedding.weight"]
    kt, kh, kw = patch
    out["patch_embedding.weight"] = w.reshape(w.shape[0], kt, kh, kw, -1).permute(0, 4, 1, 2, 3)
    return out


def _wan_vae_files(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The port's Wan VAE state in diffusers' layout: RMS gammas ``[C, 1, 1, 1]``
    (``[C, 1, 1]`` in the attention blocks), the attention's 1x1 convs."""
    out = {}
    for k, v in state.items():
        if k.endswith(".gamma"):
            v = v.reshape(-1, 1, 1) if ".attentions." in k else v.reshape(-1, 1, 1, 1)
        elif k.endswith(("to_qkv.weight", "proj.weight")) and v.dim() == 2:
            v = v[:, :, None, None]
        out[k] = v
    return out


def _checkpoint(arch: str, root: str, jvars: dict, jmodel) -> None:
    """Write ``jvars`` as the arch's published checkpoint directory."""
    if arch == "flux":
        st = from_jax.flux_model_state(jvars)
        _write(root, "transformer", st["dit"])
        _write(root, "vae", st["vae"], "diffusion_pytorch_model.safetensors")
        _write(root, "text_encoder", st["clip"])
        _write(root, "text_encoder_2", _text_files(st["t5"]))
    elif arch == "sdxl":
        st = from_jax.sdxl_model_state(jvars)
        _write(root, "unet", st["unet"], "diffusion_pytorch_model.safetensors")
        _write(root, "vae", st["vae"], "diffusion_pytorch_model.safetensors")
        _write(root, "text_encoder", st["clip"])
        _write(root, "text_encoder_2", st["clip2"])
    elif arch == "hidream":
        st = from_jax.flux_dit_state_dict(jvars["dit"])
        _write(root, "transformer", hidream_reference_state(st, jmodel.dit_config),
               "diffusion_pytorch_model.safetensors")
    else:
        st = from_jax.wan_model_state(jvars)
        patch = jmodel.dit_config.patch_size
        _write(root, "transformer", _wan_dit_files(st["dit"], patch), "diffusion_pytorch_model.safetensors")
        if "dit_low" in st:
            _write(root, "transformer_2", _wan_dit_files(st["dit_low"], patch), "diffusion_pytorch_model.safetensors")
        _write(root, "text_encoder", _text_files(st["t5"]))
        _write(root, "vae", _wan_vae_files(st["vae"]), "diffusion_pytorch_model.safetensors")
        v = jmodel.vae_config
        with open(os.path.join(root, "vae", "config.json"), "w") as f:
            json.dump({"base_dim": v.base_dim, "z_dim": v.z_dim, "dim_mult": list(v.dim_mult),
                       "num_res_blocks": v.num_res_blocks, "attn_scales": list(v.attn_scales),
                       "temperal_downsample": list(v.temperal_downsample), "latents_mean": list(v.latents_mean),
                       "latents_std": list(v.latents_std), "in_channels": v.in_channels * v.patch_size ** 2,
                       "patch_size": v.patch_size, "is_residual": v.is_residual,
                       "decoder_base_dim": v.decoder_base_dim, "clip_output": v.clip_output}, f)


def _port_state(arch: str, jvars: dict) -> dict[str, dict[str, torch.Tensor]]:
    if arch == "flux":
        return from_jax.flux_model_state(jvars)
    if arch == "sdxl":
        return from_jax.sdxl_model_state(jvars)
    if arch == "hidream":
        return from_jax.hidream_model_state(jvars)
    return from_jax.wan_model_state(jvars)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: np.asarray(v)})
    return out


def _predict(arch, jmodel, jvars, model, variables):
    """One predict of each side on its own conditioning of PROMPTS."""
    rng = np.random.default_rng(3)
    jcond, tcond = dict(jmodel.encode_prompt(jvars, PROMPTS)), model.encode_prompt(variables, PROMPTS)
    if arch.startswith("wan"):
        _, h, w, c = model.latent_shape(32, 32, 5)
        x = rng.standard_normal((1, 2, h, w, c), dtype=np.float32)
        t = np.asarray([0.9 if arch == "wan22_14b" else 0.4], np.float32)
        jcond["pe"], tcond["pe"] = jmodel.rope_table(2, h, w), model.rope_table(2, h, w)
    else:
        h, w, c = model.latent_shape(32, 32)
        x = rng.standard_normal((1, h, w, c), dtype=np.float32)
        t = np.asarray([0.4], np.float32)
        if arch == "sdxl":
            t = np.asarray([400], np.int32)
            jcond["added_cond"] = jmodel.added_cond(jcond.pop("pooled"), 32, 32)
            tcond["added_cond"] = model.added_cond(tcond.pop("pooled"), 32, 32)
        else:
            n = int(tcond["txt"].shape[1])
            jcond["pe"], tcond["pe"] = jmodel.rope_table(h, w, n), model.rope_table(h, w, n)
            if arch == "flux":
                jcond["guidance"], tcond["guidance"] = jnp.ones((1,)), torch.ones(1)
    ref = np.asarray(fast_jit(jmodel.predict, jvars, jnp.asarray(x), jnp.asarray(t), jcond))
    with torch.inference_mode():
        out = model.predict(variables, torch.from_numpy(x), torch.from_numpy(t), tcond).float().numpy()
    return out, ref


def check_checkpoint_loads(arch: str, tmp_path) -> None:
    """The arch's tiny checkpoint loads into JAX as the seeded source and into
    the port as ``from_jax`` of what JAX loaded, and one predict agrees."""
    root = str(tmp_path / "ckpt")
    jmodel = JAX_CLASSES[arch](JModelConfig.from_dict(_cfg(arch, root)))
    jmodel.init_variables = _jit_init(jmodel, arch)  # one compile for the source and the loader's init
    src = _np(jmodel.init_variables(jax.random.key(SEED)))
    _checkpoint(arch, root, src, jmodel)

    # the JAX loader gives back the seeded source: its rules matched every tensor
    jloaded = _np(jmodel.load_variables(jax.random.key(1)))
    init0 = _np(jmodel.init_variables(jax.random.key(0)))
    loaded_comps = ["dit"] if arch == "hidream" else sorted(src)
    for comp in loaded_comps:
        s, j = _flat(src[comp]), _flat(jloaded[comp])
        assert sorted(s) == sorted(j), comp
        for k in s:
            if arch == "hidream" and k.startswith(tuple(p.rstrip(".") for p in KEEP)):
                np.testing.assert_array_equal(j[k], _flat(init0[comp])[k], err_msg=f"{comp}/{k}")
            else:
                np.testing.assert_array_equal(j[k], s[k], err_msg=f"{comp}/{k}")

    # the port loads the same tensors
    model = get_model_class(arch)(ModelConfig.from_dict(_cfg(arch, root)), device="cpu")
    variables = model.load_variables(torch.Generator().manual_seed(5))
    want = _port_state(arch, jloaded)
    for comp in loaded_comps:
        got = variables[comp].state_dict()
        assert sorted(got) == sorted(want[comp]), comp
        for k, v in want[comp].items():
            if arch == "hidream" and k.startswith(KEEP):
                continue
            assert torch.equal(got[k], v), f"{comp}.{k}"
    if arch == "hidream":  # the rest keeps the port's seeded init: give it JAX's, then compare predict
        model.load_state_dicts(variables, {k: v for k, v in want.items() if k != "dit"})
        variables["dit"].load_state_dict({k: v for k, v in want["dit"].items() if k.startswith(KEEP)},
                                         strict=False)
    out, ref = _predict(arch, jmodel, jloaded, model, variables)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4 * max(1.0, float(np.abs(ref).max())), rtol=1e-4)


# SDXL's: test_torch_checkpoint_load_sdxl.py; Wan's: test_torch_checkpoint_load_wan.py
@pytest.mark.parametrize("arch", ["flux", "hidream"])
def test_checkpoint_loads_into_jax_and_the_port_alike(arch, tmp_path):
    check_checkpoint_loads(arch, tmp_path)


def test_flux_single_file_beside_a_diffusers_transformer_loads(tmp_path):
    """FLUX.1-dev's own layout: a diffusers-layout ``transformer/`` beside the
    BFL ``flux1-dev.safetensors``. Both loaders pass over the diffusers
    directory and load the single file: JAX gives back the seeded source,
    the port ``from_jax`` of what JAX loaded, bit for bit."""
    root = str(tmp_path / "ckpt")
    jmodel = JFluxModel(JModelConfig.from_dict(_cfg("flux", root)))
    jmodel.init_variables = _jit_init(jmodel, "flux")
    src = _np(jmodel.init_variables(jax.random.key(SEED)))
    _checkpoint("flux", root, src, jmodel)
    os.rename(os.path.join(root, "transformer", "model.safetensors"), os.path.join(root, "flux1-dev.safetensors"))
    _write(root, "transformer", {"transformer_blocks.0.attn.to_q.weight": torch.zeros(4, 4)},
           "diffusion_pytorch_model.safetensors")
    jloaded = _np(jmodel.load_variables(jax.random.key(1)))
    for comp in sorted(src):
        s, j = _flat(src[comp]), _flat(jloaded[comp])
        assert sorted(s) == sorted(j), comp
        for k in s:
            np.testing.assert_array_equal(j[k], s[k], err_msg=f"{comp}/{k}")
    variables, want = _load("flux", root), from_jax.flux_model_state(jloaded)
    for comp, sd in want.items():
        got = variables[comp].state_dict()
        assert sorted(got) == sorted(sd), comp
        assert all(torch.equal(got[k], v) for k, v in sd.items()), comp


def _flux_dir(tmp_path, with_dit=True):
    root = str(tmp_path / "flux")
    model = get_model_class("flux")(ModelConfig.from_dict(_cfg("flux", "")), device="cpu")
    variables = model.init_variables(torch.Generator().manual_seed(2))
    if with_dit:
        _write(root, "transformer", variables["dit"].state_dict())
    _write(root, "vae", variables["vae"].state_dict())
    _write(root, "text_encoder", variables["clip"].state_dict())
    _write(root, "text_encoder_2", _text_files(variables["t5"].state_dict()))
    return root, variables


def _load(arch, path):
    model = get_model_class(arch)(ModelConfig.from_dict(_cfg(arch, path)), device="cpu")
    return model.load_variables(torch.Generator().manual_seed(0))


def test_refusals_name_what_they_found(tmp_path, capsys):
    root, variables = _flux_dir(tmp_path)
    # a diffusers-layout flux transformer with no BFL source beside it raises
    # (JAX skips it and trains a random DiT)
    diffusers = str(tmp_path / "diffusers")
    _write(diffusers, "transformer", {"transformer_blocks.0.attn.to_q.weight": torch.zeros(4, 4)})
    with pytest.raises(NotImplementedError, match="diffusers-layout flux transformer"):
        _load("flux", diffusers)
    # a path that is no local checkpoint: a repo id, an empty directory
    for arch in ("flux", "sdxl", "hidream", "wan21"):
        with pytest.raises(FileNotFoundError, match="not an importable local layout"):
            _load(arch, "black-forest-labs/FLUX.1-dev")
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="not an importable local layout"):
        _load("flux", str(tmp_path / "empty"))
    # a single file that is no LDM / SGM checkpoint
    single = str(tmp_path / "sd_xl_base_1.0.safetensors")
    save_file({"x": torch.zeros(1)}, single)
    with pytest.raises(ValueError, match="not an LDM single-file checkpoint"):
        _load("sdxl", single)
    # a present component with a missing key, named
    sd = variables["vae"].state_dict()
    _write(root, "vae", {k: v for k, v in sd.items() if k != "decoder.conv_out.weight"})
    with pytest.raises(KeyError, match="decoder.conv_out.weight"):
        _load("flux", root)
    # a tensor of another shape, named
    _write(root, "vae", {**sd, "decoder.conv_out.bias": torch.zeros(7)})
    with pytest.raises(ValueError, match="decoder.conv_out.bias"):
        _load("flux", root)


def test_absent_components_keep_their_init_and_say_so(tmp_path, capsys):
    """A checkpoint without transformer/ loads its companions; the DiT keeps
    the seeded init, and one line names what was looked for. A CLIP file
    without ``text_projection`` (transformers' CLIPTextModel) loads with the
    pooled output unprojected."""
    root, variables = _flux_dir(tmp_path, with_dit=False)
    clip = {k: v for k, v in variables["clip"].state_dict().items() if k != "text_projection.weight"}
    _write(root, "text_encoder", clip)
    loaded = _load("flux", root)
    fresh = _load("flux", "")
    out = capsys.readouterr().out
    assert "no BFL transformer" in out and "keeps its seeded init" in out and "not projected" in out
    assert all(torch.equal(a, b) for a, b in zip(loaded["dit"].state_dict().values(),
                                                 fresh["dit"].state_dict().values()))
    assert loaded["clip"].text_projection is None
    for comp in ("vae", "t5"):
        assert all(torch.equal(loaded[comp].state_dict()[k], v) for k, v in variables[comp].state_dict().items())


def check_jax_loader_fault(fault, tmp_path, capsys):
    """[jax_fault] What the JAX loaders leave at their key(0) init though the
    checkpoint holds it, and what the port does: hidream's VAE (every
    component but the transformer) and an i2v arch's vision tower stay at
    their init in both, with a line from the port; a diffusers-layout flux
    transformer is skipped by JAX (a random DiT trains) and refused by the
    port; a CLIPTextModel file (no ``text_projection``) keeps JAX's random
    projection, where the port drops it."""
    arch = {"hidream_transformer_only": "hidream", "wan_no_vision_tower": "wan21_i2v"}.get(fault, "flux")
    root = str(tmp_path / "ckpt")
    jmodel = (JWanModel if arch.startswith("wan") else JAX_CLASSES[arch])(JModelConfig.from_dict(_cfg(arch, root)))
    jmodel.init_variables = _jit_init(jmodel, arch)
    src, init0 = _np(jmodel.init_variables(jax.random.key(SEED))), _np(jmodel.init_variables(jax.random.key(0)))
    if fault == "hidream_transformer_only":
        _checkpoint(arch, root, src, jmodel)
        _write(root, "vae", from_jax.vae_state_dict(src["vae"]), "diffusion_pytorch_model.safetensors")
        comp, sub = "vae", "vae/"
    elif fault == "wan_no_vision_tower":
        _checkpoint(arch, root, src, jmodel)
        _write(root, "image_encoder", from_jax.clip_vision_state_dict(src["clip_vision"]))
        comp, sub = "clip_vision", "image_encoder/"
    elif fault == "flux_diffusers_transformer":
        _write(root, "transformer", {"transformer_blocks.0.attn.to_q.weight": torch.zeros(4, 4)})
        st = from_jax.flux_model_state(src)
        _write(root, "vae", st["vae"])
        comp = "dit"
    else:
        st = from_jax.flux_model_state(src)
        _write(root, "transformer", st["dit"])
        _write(root, "text_encoder", {k: v for k, v in st["clip"].items() if k != "text_projection.weight"})
        comp = "clip"
    jloaded = _np(jmodel.load_variables(jax.random.key(1)))
    if fault == "clip_text_projection":
        np.testing.assert_array_equal(jloaded["clip"]["text_projection"]["kernel"],
                                      init0["clip"]["text_projection"]["kernel"])
        np.testing.assert_array_equal(jloaded["clip"]["final_ln"]["scale"], src["clip"]["final_ln"]["scale"])
        assert _load(arch, root)["clip"].text_projection is None
        return
    for k, v in _flat(jloaded[comp]).items():  # the JAX loader left it at its init
        np.testing.assert_array_equal(v, _flat(init0[comp])[k], err_msg=k)
    if fault == "flux_diffusers_transformer":
        with pytest.raises(NotImplementedError, match="diffusers-layout"):
            _load(arch, root)
        return
    capsys.readouterr()
    loaded, fresh = _load(arch, root), _load(arch, "")
    assert sub in capsys.readouterr().out
    assert all(torch.equal(v, fresh[comp].state_dict()[k]) for k, v in loaded[comp].state_dict().items())
