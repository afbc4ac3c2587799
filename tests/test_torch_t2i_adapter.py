"""The T2I adapter in the port against the JAX package on the CPU, in f32 at
tiny sizes: ``T2IAdapterNet`` (pixel-unshuffle, XLA's ``SAME`` padding at
stride 2 over an even and an odd size), the UNet's ``adapter_residuals``,
one ``t2i`` step on the tiny SD against JAX ``train/step.make_train_step``,
the job's file against JAX ``save_custom_adapter`` and read back by JAX
``load_custom_adapter``, the resume and the refusals. The assistant
(``adapter_assist_name_or_path``): ``test_torch_t2i_assistant.py`` (each
file holds 11 tests or fewer: xdist deals the files largest first, so these
run beside the suite's long tail).

Weights: seeded values at the JAX inits' shapes
(``torch_jax_opt.seeded_init``), carried into the port by
``io/from_jax.t2i_state_dict``; the UNet is the port's seeded init through
the JAX importer rules. Tolerance: ``rtol`` 1e-5 and an ``atol`` of 1e-5 of
the largest reference value for the forwards, a step's loss at ``rtol``
1e-5 and each gradient at 1e-4 of the largest gradient of the adapter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_ip_adapter import _close, _np, _read, _sd_inputs, check_step, one_step, run_job, sd_pair, tiny_ip_job

from ai_toolkit_tpu.adapters import custom_adapter as jca
from ai_toolkit_tpu.adapters import t2i_adapter as jt2i
from ai_toolkit_tpu.samplers.ddpm import DDPMSchedule as JDDPMSchedule
from ai_toolkit_tpu_torch.adapters import custom_adapter as tca
from ai_toolkit_tpu_torch.adapters import t2i_adapter as tt2i
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.jobs import get_job
from ai_toolkit_tpu_torch.samplers.ddpm import DDPMSchedule
from torch_jax_opt import jax_opt0, seeded_init  # noqa: F401

torch.set_num_threads(1)
CHANNELS = (32, 64)  # the tiny SD UNet's levels


def jax_net(channels=CHANNELS, downscale=2, seed=0):
    """(JAX net, its params as seeded values, the port net carrying them)."""
    jm = jt2i.T2IAdapterNet(channels=channels, downscale=downscale)
    params = _np(seeded_init(jm.init, jax.random.key(seed), jnp.zeros((1, 16, 16, 3)))["params"])
    ours = tt2i.T2IAdapterNet(channels, downscale)
    ours.load_state_dict(from_jax.t2i_state_dict(params))
    return jm, params, ours


@pytest.mark.parametrize("size", [16, 18])
def test_t2i_net_matches_jax(size):
    """Per level, the feature map of a control image whose latent grid is
    even (8: SAME pads none before, one after at stride 2) or odd (9: one
    each side); 1e-5 of max|ref|."""
    jm, params, ours = jax_net()
    x = np.random.default_rng(1).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    ref = jax.jit(lambda p, v: jm.apply({"params": p}, v))(params, jnp.asarray(x))
    with torch.no_grad():
        out = ours(torch.from_numpy(x))
    assert [tuple(o.shape) for o in out] == [r.shape for r in ref] == [(2, size // 2, size // 2, 32),
                                                                       (2, -(-size // 4), -(-size // 4), 64)]
    for o, r in zip(out, ref):
        _close(o.numpy(), r)


def test_unet_adapter_residuals_match_jax():
    """The tiny SD UNet with a residual at each down level (after its last
    attention, before its downsample, replacing its last skip); 1e-5 of
    max|ref|, and the residuals move the prediction."""
    jmodel, tree, model, variables = sd_pair("sd1")
    inp, jc, tc = _sd_inputs(jmodel, model, "sd1")
    rng = np.random.default_rng(3)
    res = [rng.standard_normal((2, 8, 8, 32)).astype(np.float32),
           rng.standard_normal((2, 4, 4, 64)).astype(np.float32)]
    t = jnp.asarray(inp["t"], jnp.int32)
    ref = jax.jit(lambda v, x, r: jmodel.predict(v, x, t, {**jc, "adapter_residuals": r}))(
        {"unet": tree}, jnp.asarray(inp["x"]), tuple(jnp.asarray(r) for r in res))
    with torch.no_grad():
        x, tt = torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"])
        out = model.predict(variables, x, tt, {**tc, "adapter_residuals": tuple(torch.from_numpy(r) for r in res)})
        plain = model.predict(variables, x, tt, tc)
    _close(out.numpy(), ref)
    assert float((out - plain).abs().max()) > 1e-2 * float(plain.abs().max())


def test_t2i_step_matches_jax(monkeypatch):
    """One ``t2i`` step (DDPM epsilon, adamw): the port's
    ``make_train_step`` over ``apply_cond`` + ``predict_train`` against JAX's
    over the JAX job's wrapped predict (``runtime.apply``); loss and every
    gradient of the net."""
    jmodel, tree, model, variables = sd_pair("sd1")
    _, params, net = jax_net()
    runtime = tca.CustomAdapterRuntime("t2i", net, "context")
    _, jruntime = jca.init_custom_adapter({"type": "t2i", "_unet_channels": list(CHANNELS), "downscale": 2},
                                          64, "context", 0, jax.random.key(0))
    inp, jc, tc = _sd_inputs(jmodel, model, "sd1")
    px = np.random.default_rng(4).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)

    def jpredict(vars_, noisy, t, cond):  # the JAX job's wrapper
        v2, c2 = jruntime.apply(vars_, cond)
        return jmodel.predict_train(v2, noisy, t, c2)

    trainable = {f"adapter.{k}": v for k, v in net.named_parameters()}
    got, want = one_step(
        monkeypatch, lambda x, t, c: model.predict_train(variables, x, t, runtime.apply_cond(c)), trainable,
        {"latents": torch.from_numpy(inp["x"]), "cond": {**tc, "control_pixels": torch.from_numpy(px)},
         "loss_multiplier": torch.ones(2)},
        jpredict, {"unet": tree}, {"adapter": params},
        {"latents": jnp.asarray(inp["x"]), "cond": {**jc, "control_pixels": jnp.asarray(px)},
         "loss_multiplier": jnp.ones(2)},
        DDPMSchedule(), JDDPMSchedule(),
        lambda g: {f"adapter.{k}": v.numpy() for k, v in from_jax.t2i_state_dict(_np(g["adapter"])).items()})
    check_step(got, want)


# ---- the jobs ----

def _with_controls(raw, tmp_path):
    ctrl = tmp_path / "ctrl"
    ctrl.mkdir(exist_ok=True)
    rng = np.random.default_rng(5)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(ctrl / f"{i}.png")
    raw["config"]["process"][0]["datasets"][0]["control_path"] = str(ctrl)
    return raw


def t2i_job(tmp_path, steps=1, **over):
    return _with_controls(tiny_ip_job(tmp_path, "sd1", "t2i", steps=steps, **over), tmp_path)


def assist_job(tmp_path, path, **over):
    over.setdefault("network", {"type": "lora", "linear": 4, "linear_alpha": 4})
    raw = _with_controls(tiny_ip_job(tmp_path, "sd1", None, steps=1, **over), tmp_path)
    raw["config"]["process"][0]["train"]["adapter_assist_name_or_path"] = path
    return raw


@pytest.fixture(scope="module")
def t2i_run(tmp_path_factory):
    return run_job(t2i_job(tmp_path_factory.mktemp("t2i"), steps=2))


def test_t2i_file_is_jax_save_custom_adapter(t2i_run, tmp_path):
    """The job's save against JAX ``save_custom_adapter`` of the same trained
    net (its EMA copy when EMA is on): the same keys (``t2i.conv_in.weight``
    HWIO, ...), values, dtypes and metadata; JAX ``load_custom_adapter``
    reads it back into the port's net."""
    proc, res, _ = t2i_run
    src = proc.state.ema if proc.state.ema is not None else proc.state.trainable
    tree = {}
    for k, v in tt2i.t2i_flat({k[len("adapter."):]: src[k] for k in src if k.startswith("adapter.")}).items():
        *mods, leaf = k.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node["kernel" if leaf == "weight" else leaf] = v
    jca.save_custom_adapter(tree, "t2i", str(tmp_path / "ref.safetensors"), metadata={"step": 2})
    ref, ref_meta = _read(str(tmp_path / "ref.safetensors"))
    ours, meta = _read(res["save_path"])
    assert sorted(ours) == sorted(ref) and meta == ref_meta == {"adapter_type": "t2i", "step": "2"}
    assert ours["t2i.conv_in.weight"].shape == (3, 3, 12, 32)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    jparams, atype = jca.load_custom_adapter(res["save_path"])
    net = tt2i.T2IAdapterNet(CHANNELS, 2)
    net.load_state_dict(from_jax.t2i_state_dict(jparams))
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), src[f"adapter.{k}"].detach().numpy(), err_msg=k)


def test_t2i_job_resumes_exactly(t2i_run, tmp_path):
    """A 1-step ``t2i`` run rerun to 2 steps saves what the straight 2-step
    run saved, bit for bit."""
    run_job(t2i_job(tmp_path))
    _, res, printed = run_job(t2i_job(tmp_path, steps=2))
    assert res["start_step"] == 1 and "optimizer state, EMA and generator restored" in printed
    a, _ = _read(t2i_run[1]["save_path"])
    b, _ = _read(res["save_path"])
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("over,match", [
    ({"train": {"match_adapter_chance": 0.5}}, "match_adapter_chance > 0"),
    ({"adapter": {"type": "t2i", "scale": 1.0}}, r"adapter keys \['scale'\]"),
])
def test_t2i_refusals(tmp_path, over, match):
    """``match_adapter_chance`` above 0 beside the assistant, and a t2i key
    JAX does not read, raise."""
    raw = assist_job(tmp_path, "/x", **over) if "train" in over else t2i_job(tmp_path, **over)
    (proc,) = get_job(raw, device="cpu").processes
    with pytest.raises(NotImplementedError, match=match):
        proc._refuse_unported()

