"""The control side of the flux family in the port against the JAX package on
the CPU: flex2's host-side control assembly bit for bit over the seven
``model_kwargs`` knobs with equal numpy generators, ``control_path`` /
``inpaint_path`` loading and the loader's blank fills bit for bit on seeded
PNGs (flipped and not), ``sampling_control_latents`` (flex2 with a plain
image and an ``.inpaint.`` RGBA, kontext without a ``ctrl_img``), the four
shipped train files run as jobs at ``size: tiny`` (their resolutions cut
for the CPU; their LoRA files hold the JAX job's keys and shapes; flex2's
control tensor has its ``[inpaint, mask, control]`` layout), a flex2 resume
that draws what the whole run drew, the generate job with a ``ctrl_img``,
and what stays refused."""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from safetensors import safe_open

from ai_toolkit_tpu.adapters import lora as jlora
from ai_toolkit_tpu.config.modules import DatasetConfig as JDatasetConfig
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.data.dataset import FolderDataset as JFolderDataset
from ai_toolkit_tpu.data.loader import DataLoader as JDataLoader
from ai_toolkit_tpu.io import lora_file as jlora_file
from ai_toolkit_tpu.io.flux_import import chroma_approximator_rules, flux_dit_rules
from ai_toolkit_tpu.io.sd_import import vae_rules
from ai_toolkit_tpu.io.torch_import import torch_to_tree
from ai_toolkit_tpu.jobs.train_process import SDTrainProcess as JSDTrainProcess
from ai_toolkit_tpu.models.flux_model import FluxModel as JFluxModel
from ai_toolkit_tpu_torch.config import get_config
from ai_toolkit_tpu_torch.config.modules import DatasetConfig, ModelConfig
from ai_toolkit_tpu_torch.data.dataset import FolderDataset, load_control, load_inpaint_keep
from ai_toolkit_tpu_torch.data.loader import DataLoader
from ai_toolkit_tpu_torch.jobs import get_job, run_job
from ai_toolkit_tpu_torch.models.flux_model import FLEX2_KNOBS, FluxModel
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = {"chroma": "train_lora_chroma_tpu", "flex1": "train_lora_flex_tpu", "flex2": "train_lora_flex2_tpu",
           "flux_kontext": "train_lora_flux_kontext_tpu"}


def _model_cfg(arch, **kwargs):
    return {"name_or_path": "", "arch": arch, "model_kwargs": {"size": "tiny", **kwargs}}


def _png(path, w, h, seed, mode="RGB"):
    rng = np.random.default_rng(seed)
    ch = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
    arr = rng.integers(0, 255, (h, w, ch), dtype=np.uint8)
    Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(path)
    return path


def _data(root, sizes=((64, 48), (48, 64), (64, 64)), controls=True, inpaint=()):
    """Seeded images with captions, a control image of another size for each
    (``control``), and inpaint images for the indices in ``inpaint`` (RGBA
    for even ones, greyscale for odd)."""
    imgs, ctrl, inp = (os.path.join(root, d) for d in ("imgs", "control", "inpaint"))
    for d in (imgs, ctrl, inp):
        os.makedirs(d, exist_ok=True)
    for i, (w, h) in enumerate(sizes):
        _png(os.path.join(imgs, f"im_{i}.png"), w, h, i)
        with open(os.path.join(imgs, f"im_{i}.txt"), "w") as f:
            f.write(f"photo of thing {i}")
        if controls:
            _png(os.path.join(ctrl, f"im_{i}.png"), w + 16, h + 8, 10 + i)
    for i in inpaint:
        _png(os.path.join(inp, f"im_{i}.png"), *sizes[i], 20 + i, "RGBA" if i % 2 == 0 else "L")
    return imgs, ctrl, inp


# ---- flex2's control assembly ----

SWEEP = [
    {},
    {"inpaint_random_chance": 0.5},
    {"inpaint_dropout": 0.5},
    {"do_random_inpainting": True},
    {"random_blur_mask": True},
    {"invert_inpaint_mask_chance": 0.5},
    {"random_dialate_mask": True},
    {"control_dropout": 0.5},
    {"do_random_inpainting": True, "random_blur_mask": True, "random_dialate_mask": True,
     "invert_inpaint_mask_chance": 0.3, "inpaint_random_chance": 0.3, "inpaint_dropout": 0.2,
     "control_dropout": 0.2},
]


@pytest.mark.parametrize("inputs", ["keep_and_control", "control_only", "neither"])
@pytest.mark.parametrize("knobs", SWEEP, ids=lambda k: "-".join(sorted(k)) or "defaults")
def test_assemble_flex2_control_matches_jax(knobs, inputs):
    """Six calls in a row on one generator each side, from
    ``np.random.default_rng(1234)`` as the jobs make it: every tensor equal
    bit for bit, and the generators end in the same state (the same draws)."""
    ours = FluxModel(ModelConfig.from_dict(_model_cfg("flex2", **knobs)), device="cpu")
    ref = JFluxModel(JModelConfig.from_dict(_model_cfg("flex2", **knobs)))
    data = np.random.default_rng(5)
    rng_t, rng_j = np.random.default_rng(1234), np.random.default_rng(1234)
    for _ in range(6):
        lat = data.standard_normal((2, 8, 12, 4), dtype=np.float32)
        keep = data.uniform(0, 1, (2, 16, 24, 1)).astype(np.float32) if inputs == "keep_and_control" else None
        ctrl = data.standard_normal((2, 8, 12, 4), dtype=np.float32) if inputs != "neither" else None
        out = ours.assemble_flex2_control(lat, keep, ctrl, rng_t)
        want = ref.assemble_flex2_control(lat, keep, ctrl, rng_j)
        assert out.shape == (2, 8, 12, 9) and out.dtype == np.float32
        np.testing.assert_array_equal(out, want)
    assert rng_t.bit_generator.state == rng_j.bit_generator.state
    assert set(knobs) <= set(FLEX2_KNOBS)


# ---- control_path, inpaint_path and the loader ----

@pytest.mark.parametrize("flip", [False, True])
def test_control_and_inpaint_loading_match_jax(tmp_path, flip):
    """Control images of another size, cover-resized with bicubic to each
    item's bucket and cropped, and the inpaint keep masks (an RGBA's alpha,
    a greyscale's inverse), flipped with the item or not: the port's
    ``load_control`` / ``load_inpaint_keep`` and JAX ``FileItem.load_control``
    / ``load_inpaint_mask`` bit for bit; a list of control folders matches
    by file name; the loader's batch fills an item without a control with
    zeros and one without an inpaint image with ones, as JAX's."""
    imgs, ctrl, inp = _data(str(tmp_path), inpaint=(0, 1))
    other = os.path.join(str(tmp_path), "control2")
    os.makedirs(other)
    _png(os.path.join(other, "im_2.png"), 30, 40, 31)
    os.remove(os.path.join(ctrl, "im_2.png"))  # im_2's control is in the second folder only
    os.remove(os.path.join(ctrl, "im_1.png"))  # im_1 has none
    kw = dict(folder_path=imgs, caption_ext="txt", resolution=[32, 48], control_path=[ctrl, other],
              inpaint_path=inp, flip_x=flip, flip_y=flip, cache_latents_to_disk=False)
    ds, jds = FolderDataset(DatasetConfig(**kw), 16), JFolderDataset(JDatasetConfig(**kw), 16)
    assert [(it.path, it.bucket, it.flip, it.flip_y) for it in ds.items] == \
        [(it.path, it.bucket, it.flip, it.flip_y) for it in jds.items]
    for it, jit in zip(ds.items, jds.items):
        assert list(it.control_paths) == list(jit.control_paths)
        for ours, ref in ((load_control(it), jit.load_control()), (load_inpaint_keep(it), jit.load_inpaint_mask())):
            assert (ours is None) == (ref is None)
            if ours is not None:
                assert ours.dtype == np.float32
                np.testing.assert_array_equal(ours, ref)
    assert any(it.flip for it in ds.items) == flip
    encode = lambda px: np.zeros((px.shape[0], px.shape[1] // 2, px.shape[2] // 2, 4), np.float32)  # noqa: E731
    for bucket in sorted({it.bucket for it in ds.items}):
        batch = [it for it in ds.items if it.bucket == bucket]
        jbatch = [it for it in jds.items if it.bucket == bucket]
        out = DataLoader([ds], len(batch), encode_fn=encode)._load_batch(ds, batch)
        ref = JDataLoader([jds], len(jbatch), encode_fn=encode)._load_batch(jds, jbatch)
        for key in ("control_pixels", "inpaint_keep"):
            assert (key in out) == (key in ref), key
            if key in out:
                np.testing.assert_array_equal(out[key], ref[key], err_msg=key)


# ---- sampling ----

@pytest.fixture(scope="module")
def tiny_vae():
    """The tiny VAE as both packages hold it (the port's seeded init, given
    to JAX through its importer rules)."""
    model = FluxModel(ModelConfig.from_dict(_model_cfg("flex2")), device="cpu")
    vae = model.init_variables(torch.Generator().manual_seed(3))["vae"]
    cfg = model.vae_config
    tree, unmatched = torch_to_tree({k: v.numpy() for k, v in vae.state_dict().items()},
                                    vae_rules(len(cfg.channel_multipliers), cfg.layers_per_block))
    assert not unmatched
    return vae, tree


@pytest.mark.parametrize("arch,image", [("flex2", "plain"), ("flex2", "inpaint"), ("flux_kontext", "none"),
                                        ("flux_kontext", "plain")])
def test_sampling_control_latents_match_jax(tiny_vae, tmp_path, arch, image):
    """flex2's ``[inpaint, mask = 1, control]``: a plain image in the control
    slot, a ``.inpaint.`` RGBA in the inpaint slot with its alpha the keep
    mask; kontext's encoded image, or zeros without one (f32, the VAE's
    encode: summation order only, 1e-5)."""
    vae, tree = tiny_vae
    ctrl = None
    if image == "plain":
        ctrl = _png(str(tmp_path / "ctrl.png"), 40, 24, 1)
    elif image == "inpaint":
        ctrl = _png(str(tmp_path / "ctrl.inpaint.png"), 40, 24, 2, "RGBA")
    model = FluxModel(ModelConfig.from_dict(_model_cfg(arch)), device="cpu")
    jmodel = JFluxModel(JModelConfig.from_dict(_model_cfg(arch)))
    jmodel.encode_images = jax.jit(jmodel.encode_images)
    out = model.sampling_control_latents({"vae": vae}, 8, 12, ctrl, 24, 16)
    ref = np.asarray(jmodel.sampling_control_latents({"vae": tree}, 8, 12, ctrl, 24, 16))
    assert out.shape == ref.shape == (1, 8, 12, 9 if arch == "flex2" else 4) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    if arch == "flex2":
        mask = out[..., 4].numpy()
        assert (mask == 1).all() if image == "plain" else (0 < mask.mean() < 1)
        assert (out[..., 5:] != 0).any() == (image == "plain")
    else:
        assert (out != 0).any() == (image == "plain")


# ---- the shipped files as jobs ----

def _shipped(arch, root, steps=2):
    """configs/examples' file for ``arch`` as written but for its paths, its
    steps and, for the CPU, ``size: tiny`` with its resolutions and sample
    size cut to 32 / 48 / 64 (the tiny VAE downscales by 2: the file's 512²
    would be 16,384 tokens, whose plain attention the CPU cannot hold)."""
    raw = get_config(os.path.join(ROOT, "configs", "examples", f"{SHIPPED[arch]}.yaml"))
    proc = raw["config"]["process"][0]
    imgs, ctrl, inp = _data(root, controls=arch in ("flex2", "flux_kontext"), inpaint=(0,) if arch == "flex2" else ())
    proc["training_folder"] = os.path.join(root, "out")
    ds = proc["datasets"][0]
    ds["folder_path"] = imgs
    if "control_path" in ds:
        ds["control_path"] = ctrl
    if arch == "flex2":  # the shipped file takes an inpaint folder too (JAX DatasetConfig.inpaint_path)
        ds["inpaint_path"] = inp
    ds["resolution"] = [32, 48, 64]
    proc["train"]["steps"] = steps
    proc["model"]["name_or_path"] = ""
    proc["model"]["model_kwargs"] = {"size": "tiny"}
    proc["sample"].update(width=64, height=64)
    return raw


def _jax_job_keys(arch, dit, rank):
    """The keys and shapes of the LoRA file the JAX job writes for this DiT
    (JAX ``build_lora`` on its tree, the job's key map, PEFT)."""
    jmodel = JFluxModel(JModelConfig.from_dict(_model_cfg(arch)))
    tree, unmatched = torch_to_tree({k: v.float().numpy() for k, v in dit.state_dict().items() if ".lora." not in k},
                                    chroma_approximator_rules() + flux_dit_rules(scan_blocks=False))
    assert not unmatched
    shapes = jax.eval_shape(lambda: jlora.build_lora(
        tree, jlora.LoRASpec(rank=rank, alpha=float(rank), target_patterns=jmodel.lora_targets()), jax.random.key(0)))
    jtree = jax.tree.map(lambda s: np.ones(s.shape, s.dtype), shapes)
    flat = jlora_file.flatten_lora(jtree, key_map=JSDTrainProcess._key_map(jmodel, jtree), fmt="peft")
    return {k: v.shape for k, v in flat.items()}


@pytest.mark.parametrize("arch", list(SHIPPED))
def test_shipped_file_runs_and_saves_the_jax_keys(tmp_path, arch, monkeypatch):
    """Each of the four files (quantize: true, adamw8bit, EMA, flux_shift,
    bf16, checkpointing, the disk cache, three resolutions, a first and a
    final sample at 20 steps) runs to its end: finite losses, every item's
    latents in the disk cache, both samples, and a LoRA file with the JAX
    job's keys and shapes. flex2's control tensor is ``[inpaint(4) |
    mask(1) | control(4)]``: the mask all ones and the inpaint slot zeros
    for a batch with no inpaint image, the control slot the VAE encode of
    the batch's control images (the file sets no control_dropout)."""
    from ai_toolkit_tpu_torch.jobs.train_process import SDTrainProcess

    seen = []
    real = SDTrainProcess._prepare_batch

    def record(self, model, variables, raw, text_cache):
        batch = real(self, model, variables, raw, text_cache)
        seen.append((model, variables, raw, batch))
        return batch

    monkeypatch.setattr(SDTrainProcess, "_prepare_batch", record)
    job = get_job(_shipped(arch, str(tmp_path)), device="cpu")
    (result,) = job.run()
    proc = job.processes[0]
    assert proc.cfg.model.quantize and proc.cfg.model.arch == arch
    assert len(result["losses"]) == 2 and all(np.isfinite(result["losses"]))
    assert result["latent_cache"]["items"] == 9 and result["latent_cache"]["encoded"] == 9
    assert [(s["step"], s["index"]) for s in result["samples"]] == [(0, 0), (2, 0)]
    for s in result["samples"]:
        assert np.asarray(Image.open(s["path"])).shape == (64, 64, 3)
    with safe_open(result["save_path"], framework="numpy") as f:
        saved = {k: f.get_tensor(k).shape for k in f.keys()}
    assert saved == _jax_job_keys(arch, proc.variables["dit"], 16)
    assert len(seen) == 2
    for model, variables, raw, batch in seen:
        ctrl = batch["cond"].get("control_latents")
        assert (ctrl is not None) == (arch in ("flex2", "flux_kontext"))
        if ctrl is None:
            continue
        with torch.no_grad():
            enc = model.encode_images(variables, torch.from_numpy(raw["control_pixels"])).float()
        if arch == "flux_kontext":
            np.testing.assert_array_equal(ctrl.float().numpy(), enc.numpy())
            continue
        assert ctrl.shape[-1] == 9
        np.testing.assert_array_equal(ctrl[..., 5:].numpy(), enc.numpy())
        if "inpaint_keep" not in raw:
            assert (ctrl[..., 4] == 1).all() and (ctrl[..., :4] == 0).all()


def test_flex2_resume_draws_what_the_whole_run_draws(tmp_path, monkeypatch):
    """flex2 to 3 steps against the same job cut after its step-2 save and
    run again: the job's control generator rides in the training state, so
    the resumed step assembles the control tensor the whole run did and
    gives its loss bit for bit."""
    from ai_toolkit_tpu_torch.jobs.train_process import SDTrainProcess

    def raw(out):
        r = _shipped("flex2", str(tmp_path), steps=3)
        proc = r["config"]["process"][0]
        proc["training_folder"] = str(tmp_path / out)
        proc["save"]["save_every"] = 2
        proc["sample"]["sample_every"] = 0
        proc["train"]["disable_sampling"] = True
        proc["model"]["model_kwargs"] = {"size": "tiny", "do_random_inpainting": True, "control_dropout": 0.5}
        return r

    (whole,) = run_job(raw("whole"), device="cpu")
    prepare, calls = SDTrainProcess._prepare_batch, []

    def cut_after_two(self, *args):
        calls.append(1)
        if len(calls) > 2:
            raise KeyboardInterrupt  # killed after the step-2 save
        return prepare(self, *args)

    with monkeypatch.context() as m:
        m.setattr(SDTrainProcess, "_prepare_batch", cut_after_two)
        with pytest.raises(KeyboardInterrupt):
            run_job(raw("cut"), device="cpu")
    (resumed,) = run_job(raw("cut"), device="cpu")
    assert resumed["start_step"] == 2 and resumed["losses"] == whole["losses"][2:]


def test_generate_job_with_a_ctrl_img(tmp_path):
    """The flex2 generate job with a seeded ``ctrl_img`` (and one with an
    ``.inpaint.`` RGBA) and the kontext one without: one image each, the
    control changes the flex2 sample."""
    ctrl = _png(str(tmp_path / "ctrl.png"), 48, 40, 4)
    inp = _png(str(tmp_path / "ctrl.inpaint.png"), 48, 40, 5, "RGBA")
    outs = {}
    for arch, prompts in (("flex2", [{"prompt": "x", "ctrl_img": ctrl}, {"prompt": "x", "ctrl_img": inp}, "x"]),
                          ("flux_kontext", ["x"])):
        gen = {"job": "generate", "config": {"name": f"gen_{arch}", "process": [{
            "type": "generate", "training_folder": str(tmp_path), "model": _model_cfg(arch),
            "sample": {"sampler": "flowmatch", "width": 32, "height": 32, "guidance_scale": 4, "sample_steps": 2,
                       "seed": 42, "walk_seed": False, "prompts": prompts}}]}}
        (result,) = run_job(gen, device="cpu")
        outs[arch] = [np.asarray(Image.open(p)) for p in result["images"]]
        assert all(o.shape == (32, 32, 3) for o in outs[arch]) and len(outs[arch]) == len(prompts)
    plain, inpainted, blank = outs["flex2"]
    assert not np.array_equal(plain, blank) and not np.array_equal(inpainted, blank)


@pytest.mark.parametrize("what,match", [
    ("control_path on flux", "takes no control latents"),
    ("inpaint_path on kontext", "inpaint_path"),
    ("augmentations", "augmentations"),  # mask_path is ported; JAX never reads alpha_mask
    ("controls", "controls"),
    ("kontext without a control", "no item of this"),
    ("unknown model_kwargs", "model_kwargs"),
    ("chroma_radiance", "later slice"),
    ("ctrl_img on flux", "takes no control latents"),
    ("ctrl_img_2", "ctrl_img_2"),
])
def test_what_stays_refused(tmp_path, what, match):
    imgs, ctrl, inp = _data(str(tmp_path))
    dataset = {"folder_path": imgs, "caption_ext": "txt", "cache_latents_to_disk": False, "resolution": [32]}
    model = _model_cfg("flux_kontext" if "kontext" in what else "flux")
    sample = {"width": 32, "height": 32, "sample_steps": 1, "prompts": ["x"]}
    kind = "sd_trainer"
    if what == "control_path on flux":
        dataset["control_path"] = ctrl
    elif what == "inpaint_path on kontext":
        dataset.update(control_path=ctrl, inpaint_path=inp)
    elif what in ("augmentations", "controls"):
        dataset[what] = [{"method": "HorizontalFlip"}] if what == "augmentations" else ["depth"]
    elif what == "unknown model_kwargs":
        model["model_kwargs"]["do_random_inpainting"] = True  # a flex2 knob on flux
    elif what == "chroma_radiance":
        model["arch"] = what
    elif what.startswith("ctrl_img"):
        kind = "generate"
        sample["prompts"] = [{"prompt": "x", what.split(" ")[0]: ctrl + "/im_0.png"}]
        if what == "ctrl_img_2":
            model = _model_cfg("flex2")
    proc = {"type": kind, "training_folder": str(tmp_path / "out"), "model": model, "sample": sample,
            "network": {"type": "lora", "linear": 4, "linear_alpha": 4}, "datasets": [dataset],
            "train": {"steps": 1, "dtype": "float32", "disable_sampling": True}}
    with pytest.raises((NotImplementedError, ValueError), match=match):
        run_job({"job": "extension", "config": {"name": "x", "process": [proc]}}, device="cpu")
