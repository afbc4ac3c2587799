"""The accuracy-recovery adapter (ARA) slice of the port against the JAX
package on the CPU, in f32 at tiny sizes: the ``qtype: "<q>|<path>"`` split
and its refusal beside an assistant LoRA, ``concat_loras`` (bit for bit),
the LoKr file's detection and loader against JAX ``load_lokr_file``, one
LoRA step on an int8 base carrying a LoRA or a LoKr ARA against JAX
``train/step.make_train_step`` (the ARA in the frozen variables, stacked
with the trainable LoRA by ``merge_variables``: loss and every LoRA
gradient), and the tiny ARA job end to end: the load order, the save
holding the trainable LoRA alone under the JAX job's keys, the ARA untouched.

The ARA files are written in the layouts the JAX job reads (PEFT LoRA,
LyCORIS LoKr), from seeded numpy, and each package loads them with its own
loader. The base is quantized with ``min_size`` 0 on both sides, so the
tiny DiT's kernels are int8 as a full-size one's are.

Tolerance: f32, ``rtol`` 1e-5 and an ``atol`` of 1e-4 of the largest
reference value (flux's ``time_in``, as in the flux-family tests), a
gradient against the largest gradient of the LoRA."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from safetensors import safe_open
from safetensors.numpy import save_file
from test_torch_flux_family import ONE_EACH, Pair, _leaf, _lora_pair, fast_jit

from ai_toolkit_tpu.adapters import lora as jlora
from ai_toolkit_tpu.adapters import quantize as jquant
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.io import lora_file as jlora_file
from ai_toolkit_tpu.jobs.train_process import SDTrainProcess as JSDTrainProcess
from ai_toolkit_tpu.samplers.flowmatch import FlowMatchSchedule as JSchedule
from ai_toolkit_tpu.train import step as jstep
from ai_toolkit_tpu.train.optimizers import get_optimizer as jget_optimizer
from ai_toolkit_tpu.train.state import TrainState as JTrainState
from ai_toolkit_tpu_torch.adapters import lora as tlora
from ai_toolkit_tpu_torch.adapters import quantize as tquant
from ai_toolkit_tpu_torch.adapters.lycoris import factorize
from ai_toolkit_tpu_torch.config.loader import get_config
from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.io import lora_file as tlora_file
from ai_toolkit_tpu_torch.jobs import run_job
from ai_toolkit_tpu_torch.ops.layers import Linear, LoRA
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.optimizers import get_optimizer
from ai_toolkit_tpu_torch.train.state import TrainState
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, make_train_step

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(ours, ref, what="", scale=None):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max()) if scale is None else scale
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-5, atol=1e-4 * scale, err_msg=what)


@pytest.mark.parametrize("cls", [ModelConfig, JModelConfig], ids=["port", "jax"])
def test_qtype_splits_off_the_ara(cls):
    cfg = cls.from_dict({"arch": "flux", "quantize": True, "qtype": "int8|/x/ara.safetensors"})
    assert (cfg.qtype, cfg.accuracy_recovery_adapter) == ("int8", "/x/ara.safetensors")
    with pytest.raises(ValueError, match="accuracy recovery adapter and assistant lora"):
        cls.from_dict({"arch": "flux", "qtype": "int8|/x/a.safetensors", "assistant_lora_path": "/x/b.safetensors"})


def test_concat_loras_is_jax_bit_for_bit():
    """Shared modules: a and the scale-folded b concatenated along the rank,
    scale 1; a module in one network only passes through as it is."""
    rng = np.random.default_rng(0)

    def net(names, r, scale):
        out = {}
        for n in names:
            m = LoRA(6, r, 5, scale)
            with torch.no_grad():
                m.a.copy_(torch.from_numpy(rng.standard_normal((6, r), dtype=np.float32)))
                m.b.copy_(torch.from_numpy(rng.standard_normal((r, 5), dtype=np.float32)))
            out[n] = m
        return out

    first, second = net(["x", "y"], 3, 0.7), net(["y", "z"], 2, 1.3)
    ours = tlora.concat_loras(first, second)

    def jtree(lora):
        return {n: {leaf: jnp.asarray(getattr(m, leaf).detach().numpy()) for leaf in ("a", "b", "scale")}
                for n, m in lora.items()}

    ref = jlora.concat_loras(jtree(first), jtree(second))
    assert sorted(ours) == sorted(ref)
    for n in ours:
        for leaf in ("a", "b", "scale"):
            np.testing.assert_array_equal(ours[n][leaf].detach().numpy(), np.asarray(ref[n][leaf]), err_msg=f"{n}.{leaf}")


@pytest.fixture
def flux():
    """A fresh pair per test: the step test quantizes the port's DiT in place."""
    return Pair("flux", depths=ONE_EACH, seed=9)


def _ara_file(path, dit, kind, seed=1, rank=4):
    """A seeded ARA over every block Linear of ``dit``: PEFT LoRA keys
    (``transformer.<module>.lora_A.weight``, no alpha: scale 1) or LyCORIS
    LoKr keys (``lycoris_<module with _>.lokr_w1`` / ``.lokr_w2``, alpha 1)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for n, m in dit.named_modules():
        if not isinstance(m, Linear) or not n.startswith(("double_blocks", "single_blocks")):
            continue
        if kind == "lora":
            flat[f"transformer.{n}.lora_A.weight"] = rng.normal(0, 0.2, (rank, m.in_features)).astype(np.float16)
            flat[f"transformer.{n}.lora_B.weight"] = rng.normal(0, 0.2, (m.out_features, rank)).astype(np.float16)
        else:
            (o1, o2), (i1, i2) = factorize(m.out_features), factorize(m.in_features)
            key = "lycoris_" + n.replace(".", "_")
            flat[key + ".lokr_w1"] = rng.normal(0, 0.3, (o1, i1)).astype(np.float32)
            flat[key + ".lokr_w2"] = rng.normal(0, 0.3, (o2, i2)).astype(np.float32)
            flat[key + ".alpha"] = np.asarray(1.0, np.float32)
    save_file(flat, str(path))
    return flat


def _jax_ara(p, path, kind):
    """The ARA tree as the JAX job loads it (its key map and inverse over the DiT)."""
    inv = JSDTrainProcess._inverse_key_map(p.jmodel, JSDTrainProcess._key_map(p.jmodel, p.tree))
    load = jlora_file.load_lokr_file if kind == "lokr" else jlora_file.load_lora_file
    return load(str(path), inv)[0]


def test_lokr_file_loads_as_in_jax(flux, tmp_path):
    """``is_lokr_file`` (the first key's ``lycoris`` prefix) on both layouts,
    and the LoKr factors: JAX keeps them transposed, ``[i, o]``."""
    lokr, lora = tmp_path / "lokr.safetensors", tmp_path / "lora.safetensors"
    _ara_file(lokr, flux.dit, "lokr")
    _ara_file(lora, flux.dit, "lora")
    assert tlora_file.is_lokr_file(str(lokr)) and not tlora_file.is_lokr_file(str(lora))
    ours = tlora_file.load_lokr_file(str(lokr), [n for n, _ in flux.dit.named_modules()])
    ref = _jax_ara(flux, lokr, "lokr")
    assert len(ours) == sum(isinstance(m, Linear) and n.startswith(("double", "single"))
                            for n, m in flux.dit.named_modules())
    from ai_toolkit_tpu_torch.io import from_jax

    for name, leaf in ours.items():
        path = next(p for p in _paths(ref) if from_jax._flux_module(p) == name)
        jleaf = _leaf(ref, path)
        np.testing.assert_array_equal(leaf["w1"].numpy().T, np.asarray(jleaf["w1"]))
        np.testing.assert_array_equal(leaf["w2"].numpy().T, np.asarray(jleaf["w2"]))
        assert float(leaf["scale"]) == float(jleaf["scale"]) == 1.0


def _paths(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) and not ({"a", "w1"} & set(v)):
            yield from _paths(v, path)
        else:
            yield path


@pytest.mark.parametrize("kind", ["lora", "lokr"])
def test_step_on_an_int8_base_with_the_ara_matches_jax(flux, kind, tmp_path, monkeypatch):
    """One LoRA step on the int8 base with the ARA frozen beside it: JAX
    keeps the ARA in the model variables (``lora``: rank-concatenated with
    the trainable LoRA by ``merge_variables``; ``lokr``: added to the
    dequantized kernel), the port in each Linear's ``ara`` slot."""
    p = flux
    path = tmp_path / "ara.safetensors"
    _ara_file(path, p.dit, kind)
    names = [n for n, _ in p.dit.named_modules()]
    tree = (tlora_file.load_lokr_file(str(path), names) if kind == "lokr"
            else tlora_file.load_lora_file(str(path), names)[0])
    tlora.attach_ara(p.dit, tree, kind)
    jara = _jax_ara(p, path, kind)
    rest, quant = jquant.quantize_params(p.tree, min_size=0, qtype="int8")
    lora, jtree, paths = _lora_pair(p)  # the trainable LoRA, built on the unquantized weights on both sides
    try:
        done = tquant.quantize_params(p.dit, min_size=0, qtype="int8")
        assert done and len(done) == len(jax.tree.leaves(quant)) // 2
        inp = p.inputs()
        jc, tc = p.conds(inp)
        keys = [f"{n}.{leaf}" for n in lora for leaf in ("a", "b", "scale")]
        trainable = {k: getattr(lora[k.rsplit(".", 1)[0]], k.rsplit(".", 1)[1]) for k in keys}
        state = TrainState(trainable, get_optimizer("adamw", list(trainable.values()), 1e-3))
        seen = {}
        real = state.optimizer.step
        state.optimizer.step = lambda grads: seen.update(zip(keys, (g.clone() for g in grads))) or real(grads)
        batch = {"latents": torch.from_numpy(inp["x"]), "cond": tc, "image_seq_len": 16,
                 "loss_multiplier": torch.ones(2)}
        metrics = make_train_step(lambda x, t, c: p.model.predict({"dit": p.dit}, x, t, c), FlowMatchSchedule(),
                                  TrainStepConfig(timestep_type="flux_shift"))(state, [batch],
                                                                              torch.Generator().manual_seed(7))
    finally:
        tlora.detach_lora(p.dit)
        for m in p.dit.modules():
            if isinstance(m, Linear):
                m.ara = None
    g = torch.Generator().manual_seed(7)
    t = FlowMatchSchedule().sample_timesteps(g, 2, "flux_shift", 16, 1.0)
    noise = torch.randn(inp["x"].shape, generator=g).numpy()

    class Injected(JSchedule):
        def sample_timesteps(self, rng, b, *args, **kwargs):
            return jnp.asarray(t.numpy())

    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
    frozen = {"dit": rest, "quant": quant, kind: jara}
    jstate = JTrainState.create(frozen, {"lora": jtree}, jget_optimizer("adamw", 1e-3))
    jtrain = jstep.make_train_step(p.jmodel.predict, Injected(), jstep.TrainStepConfig(timestep_type="flux_shift"))
    real_apply = JTrainState.apply_gradients

    def run(st, b):
        got = []
        monkeypatch.setattr(JTrainState, "apply_gradients", lambda self, gr, **kw: got.append(gr)
                            or real_apply(self, gr, **kw))
        _, m = jtrain(st, b, jax.random.key(0), image_seq_len=16)
        return m, got[0]

    jm, jgrads = fast_jit(run, jstate, {"latents": jnp.asarray(inp["x"]), "cond": jc, "loss_multiplier": jnp.ones(2)})
    monkeypatch.setattr(JTrainState, "apply_gradients", real_apply)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-5)
    ref = {k: np.asarray(_leaf(jgrads["lora"], paths[k.rsplit(".", 1)[0]])[k.rsplit(".", 1)[1]]) for k in keys}
    gmax = max(float(np.abs(v).max()) for v in ref.values())
    for k, v in ref.items():
        _close(seen[k].numpy(), v, k, scale=gmax)


def test_ara_job_saves_the_trainable_lora_alone(tmp_path, capsys):
    """The shipped ARA file at ``size: tiny`` (int8 base, a LoRA ARA beside
    the trainable LoRA): the ARA is read before the quantization (it fits
    the unquantized Linears) and rides every step frozen; the save holds the
    trainable LoRA alone, under the keys of the JAX job's PEFT file."""
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(imgs / f"{i}.png")
        (imgs / f"{i}.txt").write_text(f"photo {i}")
    raw = get_config(os.path.join(ROOT, "configs", "examples", "train_lora_flux_ara_tpu.yaml"))
    proc = raw["config"]["process"][0]
    from ai_toolkit_tpu_torch.models.flux_model import FluxModel

    model = FluxModel(ModelConfig.from_dict({"arch": "flux", "model_kwargs": {"size": "tiny"}}), "cpu")
    dit = model.init_variables(torch.Generator().manual_seed(0))["dit"]
    _ara_file(tmp_path / "ara.safetensors", dit, "lora")
    proc.update(training_folder=str(tmp_path / "out"))
    proc["model"].update(name_or_path="", model_kwargs={"size": "tiny"},
                         qtype=f"int8|{tmp_path / 'ara.safetensors'}")
    proc["datasets"][0].update(folder_path=str(imgs), resolution=[32])
    proc["train"].update(steps=2, dtype="float32", disable_sampling=True)
    from ai_toolkit_tpu_torch.jobs import get_job

    (job_proc,) = get_job(raw, device="cpu").processes
    out = job_proc.run()
    assert "accuracy recovery adapter active" in capsys.readouterr().out
    net = job_proc.variables["dit"]
    aras = {n: m.ara for n, m in net.named_modules() if isinstance(m, Linear) and m.ara is not None}
    assert aras and all(isinstance(a, LoRA) and not a.a.requires_grad for a in aras.values())
    flat = {}
    with safe_open(str(tmp_path / "ara.safetensors"), "np") as f:
        for k in f.keys():
            flat[k] = f.get_tensor(k)
    for n, a in aras.items():  # untouched by the steps
        np.testing.assert_array_equal(a.a.detach().numpy(), flat[f"transformer.{n}.lora_A.weight"].astype(np.float32).T)
    with safe_open(out["save_path"], "np") as f:
        keys = set(f.keys())
    # the JAX job's PEFT file: the trainable LoRA under BFL names, no ARA key
    assert keys == {f"transformer.{n}.lora_{ab}.weight" for n in job_proc.lora for ab in "AB"}


def test_lokr_ara_beside_a_lokr_network_is_refused(tmp_path):
    """As in JAX (``jobs/train_process.py:133-137``): one LoKr collection, so a
    LoKr ARA with a trainable ``lokr`` network raises a ValueError; a LoRA
    ARA beside it is refused as any unported network is."""
    from ai_toolkit_tpu_torch.jobs import get_job
    from ai_toolkit_tpu_torch.models.flux_dit import FluxConfig, FluxDiT

    net = FluxDiT(FluxConfig.tiny(), device="meta")
    raw = get_config(os.path.join(ROOT, "configs", "examples", "train_lora_flux_ara_tpu.yaml"))
    proc = raw["config"]["process"][0]
    proc["network"]["type"] = "lokr"
    for kind, err in (("lokr", ValueError), ("lora", NotImplementedError)):
        _ara_file(tmp_path / f"{kind}.safetensors", net, kind)
        proc["model"]["qtype"] = f"int8|{tmp_path / f'{kind}.safetensors'}"
        (job_proc,) = get_job(raw, device="cpu").processes
        with pytest.raises(err, match="one lokr collection" if kind == "lokr" else "network 'lokr'"):
            job_proc._refuse_unported()
