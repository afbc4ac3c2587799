"""The tiny IP-Adapter jobs in the port against the JAX package on the CPU:
sd1 ``ip_adapter`` (with a LoRA and ``scale`` beside it), sdxl
``ip_adapter_plus`` and flux ``ip_adapter`` at ``size: tiny``, their files
against JAX ``save_ip_adapter`` and ``flux_ip_flat(fmt="ip")`` (values and
dtypes bit for bit), an exact resume, a dataset's ``clip_image_path``
against JAX ``_load_paired_image``, and the ``[jax_fault]`` / ``[port]``
pairs of ROADMAP Queue 3 that read the jobs (the flux file's K/V, the
dropped network, the unread UNet ``scale``). Helpers:
``test_torch_ip_adapter.py``."""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_flux_family import ONE_EACH, Pair
from test_torch_ip_adapter import _np, _read, run_job, sd_pair, tiny_ip_job

from ai_toolkit_tpu.adapters import ip_adapter as jip
from ai_toolkit_tpu_torch.adapters import ip_adapter as tip
from ai_toolkit_tpu_torch.jobs import get_job
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The tiny jobs: sd1 ``ip_adapter`` (with a LoRA, which is not
    trained, and ``scale: 0.5``, which is not read), sdxl
    ``ip_adapter_plus``, flux ``ip_adapter``."""
    out = {}
    for arch, atype, over in (("sd1", "ip_adapter", {"network": {"type": "lora", "linear": 4},
                                                     "adapter": {"type": "ip_adapter", "scale": 0.5}}),
                              ("sdxl", "ip_adapter_plus", {}), ("flux", "ip_adapter", {})):
        out[arch] = run_job(tiny_ip_job(tmp_path_factory.mktemp(arch), arch, atype, **over))
    return out


def _proj_tree(proj) -> dict:
    """The port projection as JAX params (kernels ``[in, out]``, norm scales)."""
    tree = {}
    for k, v in proj.state_dict().items():
        if k == "latents":
            tree[k] = v.numpy()
            continue
        mod, leaf = k.rsplit(".", 1)
        name = "kernel" if leaf == "weight" and v.dim() == 2 else "scale" if leaf == "weight" else leaf
        tree.setdefault(mod, {})[name] = v.numpy().T if name == "kernel" else v.numpy()
    return tree


def _unet_ip_tree(ip: dict, n: int) -> dict:
    """The port's UNet sites as the JAX ``ip`` collection."""
    from ai_toolkit_tpu_torch.io.from_jax import unet_jax_path

    tree = {}
    for name, m in ip.items():
        node = tree
        for part in unet_jax_path(name + ".attn2.to_k", n).split(".")[:-1]:
            node = node.setdefault(part, {})
        node.update(ip_k=m.ip_k.detach().numpy().T, ip_v=m.ip_v.detach().numpy().T, scale=m.scale.detach().numpy())
    return tree


@pytest.mark.parametrize("arch", ["sd1", "sdxl"])
def test_unet_file_is_jax_save_ip_adapter(jobs, arch, tmp_path):
    """The UNet job's save against JAX ``save_ip_adapter`` of the same
    trained tensors: the same keys (``image_proj.*``, the 7 / 4 sites'
    ``ip_adapter.{i}.to_k_ip.weight`` in JAX's walk order), values, dtypes
    and ``step``; the network beside the adapter is not trained."""
    proc, res, printed = jobs[arch]
    n = len(proc.model.unet_config.block_out_channels)
    jip.save_ip_adapter(_unet_ip_tree(proc.ip, n), _proj_tree(proc.ip_proj), str(tmp_path / "ref.safetensors"),
                        metadata={"step": 1})
    ref, ref_meta = _read(str(tmp_path / "ref.safetensors"))
    ours, meta = _read(res["save_path"])
    assert sorted(ours) == sorted(ref) and meta == ref_meta == {"step": "1"}
    assert sum(k.startswith("ip_adapter.") for k in ref) == 2 * res["ip_sites"] == 2 * (7 if arch == "sd1" else 4)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype == np.float32, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert proc.lora is None and all(k.startswith(("ip.", "ip_proj.")) for k in proc.state.trainable)
    if arch == "sd1":
        assert "network 'lora' beside adapter 'ip_adapter' is not trained" in printed


def test_flux_file_and_read_back_match_jax(jobs):
    """The flux job's save: ``image_proj.*`` as JAX writes the Resampler, and
    the K/V of every double and single block through JAX
    ``flux_ip_flat(fmt="ip")``; ``load_flux_ip_flat`` reads them back as
    JAX's does."""
    proc, res, _ = jobs["flux"]
    ours, _ = _read(res["save_path"])
    jtree = {k.replace("_blocks.", "_"): {"to_k": m.to_k.detach().numpy().T, "to_v": m.to_v.detach().numpy().T,
                                          "scale": m.scale.detach().numpy()} for k, m in proc.ip.items()}
    want = jip.flux_ip_flat(jtree, fmt="ip")
    assert sorted(k for k in ours if k.startswith("ip_adapter.")) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    assert any(k.startswith("image_proj.layer_0_") for k in ours)
    back = jip.load_flux_ip_flat(ours, jtree, fmt="ip")
    scales = {k: float(m.scale.detach()) for k, m in proc.ip.items()}
    with torch.no_grad():
        for m in proc.ip.values():
            m.to_k.zero_()
    tip.load_flux_ip_flat(ours, proc.ip, fmt="ip")
    for k, m in proc.ip.items():
        np.testing.assert_array_equal(m.to_k.detach().numpy().T, np.asarray(back[k.replace("_blocks.", "_")]["to_k"]))
        assert float(m.scale.detach()) == scales[k]


def test_ip_job_resumes_exactly(tmp_path):
    """A 1-step sd1 IP run rerun to 2 steps resumes from the training state
    and saves what a straight 2-step run saves, bit for bit."""
    _, straight, _ = run_job(tiny_ip_job(tmp_path / "a", "sd1", "ip_adapter", steps=2))
    run_job(tiny_ip_job(tmp_path / "b", "sd1", "ip_adapter", steps=1))
    _, res, printed = run_job(tiny_ip_job(tmp_path / "b", "sd1", "ip_adapter", steps=2))
    assert res["start_step"] == 1 and "optimizer state, EMA and generator restored" in printed
    a, _ = _read(straight["save_path"])
    b, _ = _read(res["save_path"])
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_clip_image_path_feeds_the_paired_images(tmp_path):
    """``clip_image_path``: the batch's ``clip_pixels`` are each item's paired
    image resized bicubic to the bucket (the item's own pixels where none),
    bit for bit with JAX ``_load_paired_image``, and they, not the pixels,
    go through the vision tower."""
    from ai_toolkit_tpu.data.dataset import FileItem as JFileItem
    from ai_toolkit_tpu.data.loader import _load_paired_image
    from ai_toolkit_tpu_torch.data.loader import load_paired_image

    pairs = tmp_path / "pairs"
    pairs.mkdir()
    Image.fromarray(np.random.default_rng(3).integers(0, 255, (20, 28, 3), dtype=np.uint8)).save(pairs / "0.jpg")
    raw = tiny_ip_job(tmp_path, "sd1", "ip_adapter")
    raw["config"]["process"][0]["datasets"][0]["clip_image_path"] = str(pairs)
    (proc,) = get_job(raw, device="cpu").processes
    proc.ip_mode, proc.adapter = True, None
    loader, _ = proc._build_data(types_model(), {})
    ds = loader.datasets[0]
    batch = loader._load_batch(ds, [it for it in ds.items])
    for i, it in enumerate(ds.items):
        want = _load_paired_image(JFileItem(path=it.path, caption=""), str(pairs), batch["pixels"][i])
        np.testing.assert_array_equal(batch["clip_pixels"][i], want)
        np.testing.assert_array_equal(load_paired_image(it, str(pairs), batch["pixels"][i]), want)
    assert not np.array_equal(batch["clip_pixels"][0], batch["pixels"][0])
    np.testing.assert_array_equal(batch["clip_pixels"][1], batch["pixels"][1])
    seen = []
    proc.ip_plus = False
    proc.vision_encode = lambda px: seen.append(px.numpy()) or (px, px.mean(dim=(1, 2)))
    proc._ip_embeds(batch.get("clip_pixels", batch["pixels"]))
    np.testing.assert_array_equal(seen[0], batch["clip_pixels"])


def types_model():
    """A stand-in model for ``_build_data`` without latents' encodes."""
    import types

    return types.SimpleNamespace(bucket_divisibility=8, encode_images=lambda v, px: px[:, ::8, ::8, :1] * 0)


# ---- refusals and the JAX faults ----

def test_jax_fault_flux_ip_save_writes_no_kv():
    """[jax_fault] JAX ``save_ip_adapter`` walks for ``ip_k`` leaves, but the
    flux collection's are ``to_k`` / ``to_v``: a flux IP file holds
    ``image_proj.*`` alone."""
    import tempfile

    p = Pair("flux", depths=ONE_EACH, seed=2)
    ip = _np(jip.build_flux_ip_collection(p.tree, 8, jax.random.key(0), init="random"))
    proj = {"proj": {"kernel": np.ones((4, 8), np.float32), "bias": np.zeros(8, np.float32)},
            "norm": {"scale": np.ones(8, np.float32), "bias": np.zeros(8, np.float32)}}
    with tempfile.TemporaryDirectory() as d:
        jip.save_ip_adapter(ip, proj, os.path.join(d, "f.safetensors"))
        keys, _ = _read(os.path.join(d, "f.safetensors"))
    assert sorted(keys) == ["image_proj.norm.bias", "image_proj.norm.weight", "image_proj.proj.bias",
                            "image_proj.proj.weight"]


def test_port_flux_ip_save_writes_the_kv(jobs):
    """[port] The port's flux IP file carries every block's K/V."""
    proc, res, _ = jobs["flux"]
    keys, _ = _read(res["save_path"])
    assert sum(k.startswith("ip_adapter.") for k in keys) == 2 * len(proc.ip) == 2 * res["ip_sites"] > 0


@pytest.fixture(scope="module")
def jax_ip_trainable(tmp_path_factory):
    """JAX ``_build_trainable`` on the tiny sd1 IP job with a LoRA beside it
    and ``scale: 0.5`` (the vision tower's init as seeded values: only the
    structure is read)."""
    from test_torch_checkpoint_load import compiled_init

    from ai_toolkit_tpu.config.modules import ProcessConfig as JProcessConfig
    from ai_toolkit_tpu.jobs.train_process import SDTrainProcess as JSDTrainProcess
    from ai_toolkit_tpu.models.text_encoders.clip_vision import CLIPVisionModel as JCLIPVisionModel

    raw = tiny_ip_job(tmp_path_factory.mktemp("jip"), "sd1", "ip_adapter", network={"type": "lora", "linear": 4},
                      adapter={"type": "ip_adapter", "scale": 0.5})
    jp = JSDTrainProcess("job", JProcessConfig.from_dict(raw["config"]["process"][0]))
    jmodel, tree, _, _ = sd_pair("sd1")
    with compiled_init(JCLIPVisionModel), compiled_init(jip.ImageProjModel):
        trainable, *_ = jp._build_trainable(jmodel, {"unet": tree}, jax.random.key(0))
    return jp, trainable


def test_jax_fault_ip_drops_the_network(jax_ip_trainable):
    """[jax_fault] A ``network`` beside ``ip_adapter`` is dropped: the IP
    branch returns before any network is built."""
    jp, trainable = jax_ip_trainable
    assert jp.cfg.network is not None and set(trainable) == {"ip", "ip_proj"}


def test_port_mirrors_the_dropped_ip_network(jobs):
    """[port] The port trains the IP-Adapter alone too, and says so."""
    proc, _, printed = jobs["sd1"]
    assert proc.cfg.network is not None and proc.lora is None and not proc.net_modules
    assert "JAX fault mirrored: network 'lora' beside adapter 'ip_adapter'" in printed


def test_jax_fault_unet_ip_scale_is_not_read(jax_ip_trainable):
    """[jax_fault] On a UNet ``adapter.scale`` is not read: JAX
    ``init_ip_adapter`` builds the sites without it, each at 1.0 (flux's
    ``build_flux_ip_collection`` gets it)."""
    jp, trainable = jax_ip_trainable
    scales = [float(leaf["scale"]) for leaf in jax.tree_util.tree_leaves(
        trainable["ip"], is_leaf=lambda n: isinstance(n, dict) and "scale" in n)]
    assert jp.cfg.adapter["scale"] == 0.5 and len(scales) == 7 and set(scales) == {1.0}


def test_port_mirrors_the_unread_unet_ip_scale(jobs):
    """[port] The port's UNet sites start at 1.0 too (one adamw step away
    from it), and it says so."""
    proc, _, printed = jobs["sd1"]
    assert "adapter.scale 0.5 is not read on a UNet arch" in printed
    assert all(abs(float(m.scale.detach()) - 1.0) < 0.01 for m in proc.ip.values())

