"""The train-step knobs at job level (``ai_toolkit_tpu_torch/jobs/train_process.py``,
``data/{dataset,loader}.py``) against the JAX package on the CPU: a tiny flux
job with a knob mix held against JAX ``make_train_step`` on its first batch,
``mask_path``, the learnable SNR's ``learnable_snr.json`` save and resume,
the "refuse, do not ignore" guards over the JAX job's ``TrainConfig`` and
``DatasetConfig`` reads, and the ``[jax_fault]`` / ``[port]`` pairs of this
slice."""

import ast
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import ai_toolkit_tpu.train.step as jstep
import ai_toolkit_tpu_torch.jobs.train_process as tp
import ai_toolkit_tpu_torch.train.step as tstep
from ai_toolkit_tpu.adapters import lora as jlora
from ai_toolkit_tpu.config.modules import DatasetConfig as JDatasetConfig
from ai_toolkit_tpu.data.dataset import FolderDataset as JFolderDataset
from ai_toolkit_tpu.models import flux_dit as jdit
from ai_toolkit_tpu.samplers.flowmatch import FlowMatchSchedule as JFlow
from ai_toolkit_tpu.train.state import TrainState as JTrainState
from ai_toolkit_tpu_torch.config.modules import DatasetConfig
from ai_toolkit_tpu_torch.data.dataset import FolderDataset, load_mask
from ai_toolkit_tpu_torch.jobs import get_job
from ai_toolkit_tpu_torch.models import flux_dit as tdit

from test_torch_flux_family import OPT0
from test_torch_train import TINY_1_1, _jax_params
from test_torch_train_job import _dataset, _job, _train_proc
from test_torch_train_knobs import Recording, _inject
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _masks(folder, n=3, size=64):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(1)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size // 2 + 8 * i), dtype=np.uint8)).save(
            os.path.join(folder, f"im_{i}.png"))
    return folder


def test_mask_path_loads_like_jax(tmp_path):
    """Each item's mask, resized and cropped with its image and flipped with
    it, bit for bit as JAX ``FileItem.load_mask`` reads it."""
    imgs = _dataset(str(tmp_path / "imgs"), n=3, size=64)
    masks = _masks(str(tmp_path / "masks"))
    kw = dict(folder_path=imgs, caption_ext="txt", mask_path=masks, resolution=[48, 64], flip_x=True)
    ours = FolderDataset(DatasetConfig(**kw), 16, seed=4).items
    ref = JFolderDataset(JDatasetConfig(**kw), 16, seed=4).items
    assert len(ours) == len(ref) == 6
    for a, b in zip(ours, ref):
        assert (a.bucket, a.flip, a.mask_path) == (b.bucket, b.flip, b.mask_path)
        np.testing.assert_array_equal(load_mask(a), b.load_mask())


class _FirstStep:
    """The first train step of a job run: its batch, t, the draws the knobs
    made, the LoRA before the update and the gradients the optimizer got."""

    def __init__(self, monkeypatch):
        self.rec = None
        real_make, real_t = tp.make_train_step, tstep.sample_t

        def draws(generator, device):
            r = Recording(generator, device)
            self.rec = self.rec or r
            return r

        def sample_t(*a, **k):
            t = real_t(*a, **k)
            self.t = getattr(self, "t", t)
            return t

        def make(*a, **k):
            step = real_make(*a, **k)

            def first(state, batches, generator):
                if not hasattr(self, "batch"):
                    self.batch, self.lora = batches[0], {n: p.detach().clone() for n, p in state.trainable.items()}
                    real = state.optimizer.step

                    def keep(grads):
                        self.grads = [g.clone() for g in grads]
                        state.optimizer.step = real
                        return real(grads)
                    state.optimizer.step = keep
                return step(state, batches, generator)
            return first

        monkeypatch.setattr(tstep, "Draws", draws)
        monkeypatch.setattr(tstep, "sample_t", sample_t)
        monkeypatch.setattr(tp, "make_train_step", make)


def _np_tree(d):
    return {k: _np_tree(v) if isinstance(v, dict) else jnp.asarray(v.detach().cpu().numpy()) for k, v in d.items()}


KNOB_MIX = dict(diff_output_preservation=True, do_cfg=True, cfg_scale=2.0, cfg_rescale=0.5, loss_type="mae",
                noise_offset=0.1, timestep_type="weighted", prompt_dropout_prob=0.5, optimizer="prodigy", lr=1.0,
                gradient_checkpointing=False)


def test_flux_knob_job_first_step_matches_jax(tmp_path, monkeypatch):
    """A tiny flux job (1 + 1 blocks) with DOP, CFG with its rescale, a
    ``mask_path`` dataset, mae, noise offset, weighted timesteps, prompt
    dropout and prodigy: its first step's loss and LoRA gradients against
    JAX ``make_train_step`` on the same batch, weights, t and draws."""
    tiny = tdit.FluxConfig.__dict__["tiny"]
    monkeypatch.setattr(tdit.FluxConfig, "tiny", classmethod(
        lambda cls: dataclasses.replace(tiny.__func__(cls), **TINY_1_1)))
    proc = _train_proc(tmp_path)
    proc["train"].update(KNOB_MIX, steps=2)
    proc["datasets"][0]["mask_path"] = _masks(str(tmp_path / "masks"))
    first = _FirstStep(monkeypatch)
    job = get_job(_job("knobs", proc), device="cpu")
    (result,) = job.run()
    p = job.processes[0]
    assert len(result["losses"]) == 2 and all(np.isfinite(result["losses"]))
    assert "mask" in first.batch and "neg_cond" in first.batch and first.batch["mask"].shape[-1] == 1
    names = list(first.lora)

    # JAX: the same DiT, LoRA, batch, t and draws
    jcfg = dataclasses.replace(jdit.FluxConfig.tiny(), **TINY_1_1)
    params = _jax_params(p.variables["dit"])
    key_map = jdit.flux_lora_key_map(jlora.build_lora(params, jlora.LoRASpec(
        rank=4, alpha=4.0, target_patterns=jdit.flux_lora_targets()), jax.random.key(0)))
    jtree = {}
    for path, name in key_map.items():
        node = jtree
        for part in path.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[path.split("/")[-1]] = {leaf: jnp.asarray(first.lora[f"{name}.{leaf}"].numpy()) for leaf in
                                     ("a", "b", "scale")}

    def jpredict(variables, x, t, cond):
        v = {k: variables[k] for k in ("params", "lora") if k in variables}
        out = jdit.FluxDiT(jcfg).apply(v, jdit.pack_latents_cmajor(x), cond["txt"], t, cond["y"], cond["pe"],
                                       cond["guidance"])
        return jdit.unpack_latents_cmajor(out, x.shape[1], x.shape[2])

    t_np = first.t.numpy()

    class Injected(JFlow):
        def sample_timesteps(self, rng, b, *args, **kwargs):
            return jnp.asarray(t_np)

    jcfg_step = jstep.TrainStepConfig.from_train_config(p.cfg.train)
    train = jstep.make_train_step(jpredict, Injected(), jcfg_step)
    b = first.batch
    jbatch = {"latents": jnp.asarray(b["latents"].numpy()), "loss_multiplier": jnp.asarray(b["loss_multiplier"]),
              "mask": jnp.asarray(b["mask"].numpy()), "cond": _np_tree(b["cond"]), "neg_cond": _np_tree(b["neg_cond"])}
    state = JTrainState.create({"params": params}, {"lora": jtree}, optax.sgd(0.0))
    queue = _inject(monkeypatch, first.rec.log)
    real_apply = JTrainState.apply_gradients

    def run(s, bt):
        seen = []
        monkeypatch.setattr(JTrainState, "apply_gradients", lambda self, g, **k: seen.append(g) or real_apply(
            self, g, **k))
        _, metrics = train(s, bt, jax.random.key(0))
        return metrics, seen[0]

    metrics, jgrads = jax.jit(run, compiler_options=OPT0)(state, jbatch)
    monkeypatch.setattr(JTrainState, "apply_gradients", real_apply)
    assert not queue
    np.testing.assert_allclose(result["losses"][0], float(metrics["loss"]), rtol=1e-5)
    inv = {name: path for path, name in key_map.items()}
    ref = {}
    for n in names:
        name, leaf = n.rsplit(".", 1)
        node = jgrads["lora"]
        for part in inv[name].split("/"):
            node = node[part]
        ref[n] = np.asarray(node[leaf])
    gmax = max(float(np.abs(r).max()) for r in ref.values())
    assert gmax > 0
    for n, g in zip(names, first.grads):
        np.testing.assert_allclose(g.numpy(), ref[n], rtol=1e-5, atol=1e-4 * gmax, err_msg=n)
    assert os.path.isfile(result["save_path"])


TINY_SD = {"name_or_path": "", "arch": "sd15", "model_kwargs": {"size": "tiny"}}


def test_learnable_snr_json_is_saved_and_resumed(tmp_path, capsys):
    """A DDPM job with ``learnable_snr_gos`` writes ``learnable_snr.json``
    (JAX's four scalars) beside its saves; a rerun that finds no matching
    training state reads it back, as JAX's resume does."""
    proc = _train_proc(tmp_path)
    proc.update(model=dict(TINY_SD))
    proc["train"].update(noise_scheduler="ddpm", timestep_type="sigmoid", learnable_snr_gos=True, steps=2,
                         optimizer="lion", lr=1e-4)
    job = get_job(_job("lsnr", proc), device="cpu")
    (result,) = job.run()
    path = os.path.join(proc["training_folder"], "lsnr", "learnable_snr.json")
    with open(path) as f:
        saved = json.load(f)
    assert sorted(saved) == sorted(jstep._LSNR_KEYS) and saved != {"offset_1": 0.0, "offset_2": 0.777,
                                                                    "scale": 4.14, "gamma": 2.03}
    assert saved == job.processes[0].state.lsnr.to_json()
    os.remove(os.path.join(proc["training_folder"], "lsnr", "training_state.safetensors"))
    proc["train"]["steps"] = 3
    job2 = get_job(_job("lsnr", proc), device="cpu")
    job2.processes[0]._save = lambda *a, **k: "skipped"
    job2.run()
    assert "resumed learnable_snr.json" in capsys.readouterr().out


def _tc_reads(path: str) -> set[str]:
    """The TrainConfig fields a module reads: ``tc.<f>``, ``cfg.train.<f>``,
    ``self.cfg.train.<f>``, ``getattr(tc, "<f>", ...)``."""
    out = set()
    for node in ast.walk(ast.parse(open(os.path.join(ROOT, path)).read())):
        if isinstance(node, ast.Attribute):
            chain, v = [], node.value
            while isinstance(v, ast.Attribute):
                chain.append(v.attr)
                v = v.value
            if isinstance(v, ast.Name) and (v.id, *reversed(chain)) in (("tc",), ("cfg", "train"),
                                                                        ("self", "cfg", "train")):
                out.add(node.attr)
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "getattr" and len(node.args) >= 2:
            a0, a1 = node.args[:2]
            if isinstance(a1, ast.Constant) and (getattr(a0, "id", None) == "tc" or getattr(a0, "attr", None)
                                                 == "train"):
                out.add(a1.value)
    return out


# TrainConfig fields JAX reads only under a knob the port refuses
GATED = {"merge_network_on_save_strength": "merge_network_on_save", "train_refiner": "the SDXL refiner"}


def test_every_train_field_jax_reads_is_read_or_refused():
    """The "refuse, do not ignore" guard: every field JAX
    ``jobs/train_process.py`` and ``train/step.py`` read is read by the port's
    job or step, or is in its refusal table, or is gated behind a refused knob."""
    jax_reads = _tc_reads("ai_toolkit_tpu/jobs/train_process.py") | _tc_reads("ai_toolkit_tpu/train/step.py")
    port = _tc_reads("ai_toolkit_tpu_torch/jobs/train_process.py") | _tc_reads("ai_toolkit_tpu_torch/train/step.py")
    missing = sorted(jax_reads - port - set(tp._UNPORTED_TRAIN) - set(GATED))
    assert not missing, f"read by JAX, neither read nor refused by the port: {missing}"
    assert {"diff_output_preservation_class"} & jax_reads == set()


@pytest.mark.parametrize("name", sorted(tp._UNPORTED_TRAIN))
def test_each_refused_train_field_names_its_roadmap_item(name, tmp_path):
    proc = _train_proc(tmp_path)
    default = getattr(tp.TrainConfig(), name)
    proc["train"][name] = "x" if isinstance(default, str) or default is None else (not default if isinstance(
        default, bool) else 1e-4)
    with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item \d"):
        get_job(_job("refused", proc), device="cpu").run()


# the JAX modules that read a dataset's options (the config's aliases, the loader, the job,
# the step and its losses), and the port's counterparts
JAX_DATA = ["ai_toolkit_tpu/config/modules.py", "ai_toolkit_tpu/data/dataset.py", "ai_toolkit_tpu/data/loader.py",
            "ai_toolkit_tpu/data/caching.py", "ai_toolkit_tpu/jobs/train_process.py", "ai_toolkit_tpu/train/step.py",
            "ai_toolkit_tpu/train/losses.py"]
PORT_DATA = [p.replace("ai_toolkit_tpu/", "ai_toolkit_tpu_torch/") for p in JAX_DATA]
# DatasetConfig fields JAX reads only under an option the port refuses
GATED_DATASET = {"shuffle_augmentations": "augmentations", "replay_transforms": "augmentations",
                 "clip_image_shuffle_augmentations": "clip_image_augmentations"}


def _dataset_reads(paths: list[str]) -> set[str]:
    """The DatasetConfig fields some modules read, by attribute name
    (``<x>.<field>`` or ``getattr(<x>, "<field>", ...)``)."""
    fields = {f.name for f in dataclasses.fields(JDatasetConfig)}
    out = set()
    for path in paths:
        if not os.path.isfile(os.path.join(ROOT, path)):
            continue
        for node in ast.walk(ast.parse(open(os.path.join(ROOT, path)).read())):
            if isinstance(node, ast.Attribute) and node.attr in fields:
                out.add(node.attr)
            if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "getattr" and len(node.args) >= 2
                    and isinstance(node.args[1], ast.Constant) and node.args[1].value in fields):
                out.add(node.args[1].value)
    return out


def test_every_dataset_field_jax_reads_is_read_or_refused():
    """The same guard over the dataset's options: every DatasetConfig field
    JAX's loader, job, step or losses read is read by the port's, or is in
    the port dataset's refusal table, or is gated behind a refused option."""
    from ai_toolkit_tpu_torch.data.dataset import _UNPORTED_OPTIONS

    jax_reads = _dataset_reads(JAX_DATA)
    assert {"mask_path", "control_path", "is_reg", "loss_multiplier"} <= jax_reads
    missing = sorted(jax_reads - _dataset_reads(PORT_DATA) - set(_UNPORTED_OPTIONS) - set(GATED_DATASET))
    assert not missing, f"read by JAX, neither read nor refused by the port: {missing}"
    assert set(GATED_DATASET.values()) <= set(_UNPORTED_OPTIONS)


def test_jax_fault_mask_min_value_is_not_read():
    """[jax_fault] no JAX module but the config's and ``compute_loss``'s own
    names ``mask_min_value``: no code reads the dataset's field, and no caller
    passes ``compute_loss`` its argument, so the loss mask is clipped to
    [0, 1] whatever the dataset says."""
    import glob

    named = {}
    for path in glob.glob(os.path.join(ROOT, "ai_toolkit_tpu", "**", "*.py"), recursive=True):
        n = open(path).read().count("mask_min_value")
        if n:
            named[os.path.relpath(path, ROOT)] = n
    # the field, and compute_loss's parameter and its one use
    assert named == {"ai_toolkit_tpu/config/modules.py": 1, "ai_toolkit_tpu/train/losses.py": 2}


def test_jax_fault_dataset_options_no_module_reads():
    """[jax_fault] seven DatasetConfig fields are read by no module of the
    JAX config, loader, job, step or losses: ``random_crop``,
    ``random_scale`` and ``alpha_mask`` change nothing, nor do
    ``mask_min_value``, ``num_workers``, ``shrink_video_to_frames`` and a
    dataset's ``cache_clip_vision_to_disk``."""
    from ai_toolkit_tpu_torch.data.dataset import _JAX_UNREAD_OPTIONS

    fields = {f.name for f in dataclasses.fields(JDatasetConfig)}
    assert fields - _dataset_reads(JAX_DATA) == set(_JAX_UNREAD_OPTIONS)


@pytest.mark.parametrize("name,value", [("random_crop", True), ("random_scale", True), ("alpha_mask", True),
                                        ("mask_min_value", 0.2), ("num_workers", 0),
                                        ("shrink_video_to_frames", False), ("cache_clip_vision_to_disk", True)])
def test_port_mirrors_the_dataset_options_jax_never_reads(name, value, tmp_path, capsys):
    """[port] the port reads none of them either: each prints its line, and
    the dataset's items are those of the default config."""
    imgs = _dataset(str(tmp_path / "imgs"), n=2, size=48)
    kw = dict(folder_path=imgs, caption_ext="txt", resolution=[32, 48], flip_x=True)
    items = [FolderDataset(DatasetConfig(**kw, **extra), 16, seed=1).items for extra in ({name: value}, {})]
    assert f"{name} {value!r} is not read" in capsys.readouterr().out
    assert [(a.path, a.bucket, a.flip, a.caption) for a in items[0]] == [
        (b.path, b.bucket, b.flip, b.caption) for b in items[1]]


def test_port_mirrors_the_unread_mask_min_value(tmp_path, capsys):
    """[port] the same, with a printed line: the dataset's masks are those of
    ``mask_min_value: 0``, and the port's masked loss (no ``mask_min_value``
    argument) equals JAX ``compute_loss`` at its default clip."""
    import inspect

    from ai_toolkit_tpu.train.losses import compute_loss as jloss
    from ai_toolkit_tpu_torch.train.losses import compute_loss

    imgs = _dataset(str(tmp_path / "imgs"), n=2, size=32)
    kw = dict(folder_path=imgs, caption_ext="txt", mask_path=_masks(str(tmp_path / "masks"), n=2, size=32),
              resolution=[32])
    items = [FolderDataset(DatasetConfig(**kw, mask_min_value=v), 16, seed=1).items for v in (0.2, 0.0)]
    assert "mask_min_value 0.2 is not read" in capsys.readouterr().out
    for a, b in zip(*items):
        np.testing.assert_array_equal(load_mask(a), load_mask(b))
    assert "mask_min_value" not in inspect.signature(compute_loss).parameters
    rng = np.random.default_rng(0)
    pred, target = rng.standard_normal((2, 4, 4, 3), dtype=np.float32), rng.standard_normal((2, 4, 4, 3),
                                                                                            dtype=np.float32)
    mask = (rng.uniform(size=(2, 4, 4, 1)) > 0.5).astype(np.float32)
    got = compute_loss(*(torch.from_numpy(x) for x in (pred, target)), mask=torch.from_numpy(mask))[0]
    ref = jloss(*(jnp.asarray(x) for x in (pred, target)), mask=jnp.asarray(mask))[0]
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_jax_fault_dop_class_prompt_is_not_read():
    """[jax_fault] the JAX job and step never read
    ``diff_output_preservation_class``: the prior regresses on the batch's
    own caption."""
    jax_reads = _tc_reads("ai_toolkit_tpu/jobs/train_process.py") | _tc_reads("ai_toolkit_tpu/train/step.py")
    assert "diff_output_preservation" in jax_reads and "diff_output_preservation_class" not in jax_reads


def test_port_mirrors_the_unread_dop_class_prompt(capsys):
    """[port] the same, with a printed line; no class prompt is encoded."""
    cfg = tstep.TrainStepConfig.from_train_config(tp.TrainConfig(diff_output_preservation=True,
                                                                 diff_output_preservation_class="person"))
    assert cfg.diff_output_preservation and cfg.do_prior_pred
    assert "diff_output_preservation_class 'person' is not read" in capsys.readouterr().out


def test_jax_fault_max_loss_batch_still_moves_the_weights():
    """[jax_fault] ``max_loss`` zeroes an outlier batch's loss, but the JAX
    step still applies the optimizer: adamw's moment and weight decay move
    the weights on the skipped step."""
    def predict(v, x, t, c):
        return x * v["lora"]["w"]
    state = JTrainState.create({}, {"lora": {"w": jnp.ones((4,))}}, optax.adamw(0.1))
    batch = {"latents": jnp.ones((1, 2, 2, 4)), "cond": {}}
    for max_loss in (1e9, 1e-9):
        step = jax.jit(jstep.make_train_step(predict, JFlow(), jstep.TrainStepConfig(max_loss=max_loss)),
                       compiler_options=OPT0)
        before = np.asarray(state.trainable["lora"]["w"])
        state, metrics = step(state, batch, jax.random.key(1))
    assert float(metrics["max_loss_skipped"]) == 1.0 and float(metrics["loss"]) == 0.0
    assert not np.array_equal(np.asarray(state.trainable["lora"]["w"]), before)


def test_port_mirrors_the_moving_skipped_step():
    """[port] the same: the skipped step's gradient is zero and AdamW still
    moves the weights."""
    from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
    from ai_toolkit_tpu_torch.train.optimizers import get_optimizer
    from ai_toolkit_tpu_torch.train.state import TrainState

    w = torch.ones(4, requires_grad=True)
    state = TrainState({"w": w}, get_optimizer("adamw", [w], 0.1))
    batch = {"latents": torch.ones(1, 2, 2, 4), "cond": {}}
    gen = torch.Generator().manual_seed(0)
    for max_loss in (1e9, 1e-9):
        step = tstep.make_train_step(lambda x, t, c: x * w, FlowMatchSchedule(), tstep.TrainStepConfig(
            max_loss=max_loss))
        before = w.detach().clone()
        metrics = step(state, [batch], gen)
    assert float(metrics["max_loss_skipped"]) == 1.0 and float(metrics["loss"]) == 0.0
    assert float(metrics["grad_norm"]) == 0.0 and not torch.equal(w.detach(), before)


def test_jax_fault_prompt_dropout_draws_from_an_unseeded_generator():
    """[jax_fault] JAX ``_prepare_batch`` drops captions with
    ``np.random.default_rng(None)``: two runs of one file differ."""
    src = open(os.path.join(ROOT, "ai_toolkit_tpu/jobs/train_process.py")).read()
    block = src[src.index("p_drop = self.cfg.train.prompt_dropout_prob"):][:600]
    assert "np.random.default_rng(None)" in block


def test_port_seeds_the_prompt_dropout(tmp_path):
    """[port] the port draws the dropout from a host generator seeded by the
    job's seed (and saved in the training state): two runs drop alike."""
    states = []
    for run in range(2):
        proc = _train_proc(tmp_path)
        proc["training_folder"] = str(tmp_path / f"out{run}")
        proc["train"].update(prompt_dropout_prob=0.5, steps=1)
        job = get_job(_job("drop", proc), device="cpu")
        job.run()
        states.append(job.processes[0]._dropout_rng.bit_generator.state)
    assert states[0] == states[1]


def _net_reads(files: dict[str, tuple[str, ...]]) -> set[str]:
    """The NetworkConfig fields some modules read: ``<name>.<f>`` for the
    names each file binds the network to, and ``<x>.network.<f>``."""
    from ai_toolkit_tpu.config.modules import NetworkConfig as JNetworkConfig

    fields = {f.name for f in dataclasses.fields(JNetworkConfig)} | {"rank", "alpha"}
    out = set()
    for path, names in files.items():
        for node in ast.walk(ast.parse(open(os.path.join(ROOT, path)).read())):
            if isinstance(node, ast.Attribute) and node.attr in fields and (
                    isinstance(node.value, ast.Name) and node.value.id in names
                    or isinstance(node.value, ast.Attribute) and node.value.attr == "network"):
                out.add(node.attr)
    return out


def test_every_network_field_jax_reads_is_read_or_refused():
    """The guard over the network section: every field JAX
    ``jobs/train_process.py`` (``net.<f>``, ``cfg.network.<f>``) and
    ``adapters/lora.LoRASpec.from_network_config`` read is read by the port's
    job, LoRA or LoRM spec; the fields no JAX module reads are mirrored with
    a printed line (``config/modules.JAX_UNREAD_NETWORK``)."""
    from ai_toolkit_tpu_torch.config.modules import JAX_UNREAD_NETWORK

    jax_reads = _net_reads({"ai_toolkit_tpu/jobs/train_process.py": ("net",),
                            "ai_toolkit_tpu/adapters/lora.py": ("cfg",)})
    port = _net_reads({"ai_toolkit_tpu_torch/jobs/train_process.py": ("net", "ncfg"),
                       "ai_toolkit_tpu_torch/adapters/lora.py": ("cfg",),
                       "ai_toolkit_tpu_torch/adapters/lorm.py": ("net",)})
    assert {"type", "rank", "conv", "lokr_factor", "network_kwargs", "only_if_contains"} <= jax_reads
    missing = sorted(jax_reads - port)
    assert not missing, f"read by JAX, not read by the port: {missing}"
    assert not set(JAX_UNREAD_NETWORK) & jax_reads
