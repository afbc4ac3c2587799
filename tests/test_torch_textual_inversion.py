"""Textual inversion in the port against the JAX package on the CPU: the
trigger tokenizer, the ``init_words`` bank, CLIP with the bank (forward and
the bank's gradient against ``jax.grad`` in f32, and bit for bit at bf16
where the f32 bank meets the f32 token table and the sum is rounded to the
model's dtype), then the tiny ``sd1`` textual-inversion job: only the bank
trains, the a1111 file holds it in f32, the samples use it, and a resumed
run computes what the uninterrupted one does, bit for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from PIL import Image

from ai_toolkit_tpu.adapters import embedding as jemb
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.models.sd_model import SDModel as JSDModel
from ai_toolkit_tpu.models.text_encoders import clip as jclip
from ai_toolkit_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from ai_toolkit_tpu_torch.adapters import embedding as temb
from ai_toolkit_tpu_torch.config.modules import ModelConfig, ProcessConfig
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.jobs import get_job, run_job
from ai_toolkit_tpu_torch.models.sd_model import SDModel, SDXLModel
from ai_toolkit_tpu_torch.models.text_encoders import clip as tclip
from ai_toolkit_tpu_torch.utils.tokenizer import HashTokenizer
from test_torch_sd15 import port_init_as_jax
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)
TINY = {"name_or_path": "", "arch": "sd1", "model_kwargs": {"size": "tiny"}}
TRIGGER = "sks_concept"


def _tokenizers(n_vectors=4):
    cfg = tclip.CLIPTextConfig.tiny()
    base = (HashTokenizer(cfg.vocab_size, cfg.eos_token_id, 77), JHashTokenizer(cfg.vocab_size, cfg.eos_token_id, 77))
    return (temb.TriggerTokenizer(base[0], TRIGGER, cfg.vocab_size, n_vectors),
            jemb.TriggerTokenizer(base[1], TRIGGER, cfg.vocab_size, n_vectors))


def test_trigger_tokenizer_ids_match_jax():
    """The trigger's virtual ids spliced in (once, twice, alone, at either
    end, past the 77 tokens), and a caption without it, as JAX encodes them."""
    ours, ref = _tokenizers()
    texts = [f"a photo of {TRIGGER}", f"{TRIGGER} on a beach, {TRIGGER} again", TRIGGER, "no trigger here",
             f"{TRIGGER}, portrait", " ".join(["word"] * 80) + f" {TRIGGER}", ""]
    for text in texts:
        np.testing.assert_array_equal(ours.encode(text), ref.encode(text), err_msg=text)
    ids = ours.encode(f"a photo of {TRIGGER}")
    assert list(ids[3:7]) == [1000, 1001, 1002, 1003] and ids[7] == 999


@pytest.fixture(scope="module")
def jax_vars():
    return port_init_as_jax(TINY["arch"])  # the port's seeded init as the JAX tree


def test_init_words_bank_matches_jax(jax_vars, tmp_path):
    """The job's bank (``_build_embedding``) from ``init_words`` over the
    port's token table, bit for bit the JAX job's (its tokenizer's ids of the
    words, ``init_embedding_bank`` over its table), repeated to ``vectors``
    rows; without ``init_words``, normal(0, 0.02) as JAX draws it."""
    from ai_toolkit_tpu_torch.jobs.train_process import SDTrainProcess

    model = SDModel(ModelConfig.from_dict(dict(TINY)), device="cpu")
    variables = model.init_variables(torch.Generator().manual_seed(0))
    variables["clip"].load_state_dict(from_jax.clip_state_dict(jax_vars["clip"]))
    proc = SDTrainProcess("ti", ProcessConfig.from_dict({"embedding": {"trigger": TRIGGER, "vectors": 5,
                                                                       "init_words": "portrait person"}}), "cpu")
    bank = proc._build_embedding(model, variables)["emb"]
    jmodel = JSDModel(JModelConfig.from_dict(dict(TINY)))
    ids = [i for i in jmodel.tokenizer.encode("portrait person") if i != jmodel.tokenizer.eos_id]
    ref = jemb.init_embedding_bank(5, 64, init_from=np.asarray(jax_vars["clip"]["token_embedding"])[ids])
    assert bank.dtype == torch.float32 and bank.requires_grad and variables["emb"] is bank
    np.testing.assert_array_equal(bank.detach().numpy(), ref)
    np.testing.assert_array_equal(temb.init_embedding_bank(3, 64), jemb.init_embedding_bank(3, 64))
    assert isinstance(model.tokenizer, temb.TriggerTokenizer) and model.tokenizer.encode(TRIGGER)[0] == 1000


def _bank_inputs(seed=2, twice=True):
    ours, _ = _tokenizers(3)
    captions = [f"a photo of {TRIGGER} on a hill" + (f", {TRIGGER} again" if twice else ""), f"{TRIGGER} at night"]
    ids = np.stack([ours.encode(c) for c in captions])
    bank = np.random.default_rng(seed).normal(0, 0.5, (3, 64)).astype(np.float32)
    return ids, bank


def test_clip_with_the_bank_matches_jax_f32(jax_vars):
    """The tiny CLIP with a 3-vector bank (the trigger twice in one caption):
    the final states and the pooled output (1e-5), and the bank's gradient of
    a weighted sum of the states against ``jax.grad`` (1e-5 of its largest)."""
    ids, bank = _bank_inputs()
    jmod = jclip.CLIPTextModel(jclip.CLIPTextConfig.tiny())
    params = jax.tree.map(jnp.asarray, jax_vars["clip"])
    w = np.random.default_rng(3).standard_normal((2, 77, 64)).astype(np.float32)

    def jloss(b):
        out = jmod.apply({"params": params, "emb": {"bank": b}}, jnp.asarray(ids))
        return (out["last_hidden_state"] * w).sum(), out

    (_, ref), ref_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(bank))
    mod = tclip.CLIPTextModel(tclip.CLIPTextConfig.tiny())
    mod.load_state_dict(from_jax.clip_state_dict(jax_vars["clip"]))
    mod.requires_grad_(False)
    tb = torch.tensor(bank, requires_grad=True)
    out = mod(torch.from_numpy(ids).long(), bank=tb)
    (out["last_hidden_state"] * torch.from_numpy(w)).sum().backward()
    for key in ("last_hidden_state", "pooled_output"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(ref[key]), atol=1e-5, rtol=1e-5)
    g = np.asarray(ref_grad)
    assert np.abs(g).min() > 0  # every vector is used
    np.testing.assert_allclose(tb.grad.numpy(), g, atol=1e-5 * np.abs(g).max())
    # without the bank the virtual ids read the table's last row, as in JAX
    plain = jmod.apply({"params": params}, jnp.asarray(ids))["last_hidden_state"]
    np.testing.assert_allclose(mod(torch.from_numpy(ids).long())["last_hidden_state"].detach().numpy(),
                               np.asarray(plain), atol=1e-5, rtol=1e-5)


def test_clip_bank_bf16_bit_for_bit(jax_vars):
    """At bf16 the f32 bank meets the f32 token table (the result is f32, as
    ``jnp.where`` promotes it), the f32 positions are added and the sum is
    rounded once to bf16: the first layer's input equals the JAX model's bit
    for bit (its layers and final norm skipped through
    ``flax.linen.intercept_methods``), and so does the f32 gradient of the
    bank (each of its rows sums one contribution from each of the two
    captions)."""
    ids, bank = _bank_inputs(twice=False)
    jcfg = jclip.CLIPTextConfig(**{**jclip.CLIPTextConfig.tiny().__dict__, "dtype": jnp.bfloat16})
    jmod = jclip.CLIPTextModel(jcfg)
    params = jax_vars["clip"]
    w = np.random.default_rng(4).standard_normal((2, 77, 64)).astype(np.float32)

    def first_input_only(next_fun, args, kwargs, context):
        if isinstance(context.module, jclip.CLIPLayer) or context.module.name == "final_ln":
            return args[0]
        return next_fun(*args, **kwargs)

    def jembed(b):
        with fnn.intercept_methods(first_input_only):
            return jmod.apply({"params": params, "emb": {"bank": b}}, jnp.asarray(ids))["last_hidden_state"]

    ref = jembed(jnp.asarray(bank))
    ref_grad = jax.grad(lambda b: (jembed(b).astype(jnp.float32) * w).sum())(jnp.asarray(bank))
    mod = tclip.CLIPTextModel(tclip.CLIPTextConfig(**{**tclip.CLIPTextConfig.tiny().__dict__,
                                                      "dtype": torch.bfloat16}))
    mod.load_state_dict(from_jax.clip_state_dict(params))
    mod.requires_grad_(False)
    assert mod.text_model.embeddings.token_embedding.weight.dtype == torch.float32
    tb = torch.tensor(bank, requires_grad=True)
    x = mod.embed(torch.from_numpy(ids).long(), tb)
    (x.float() * torch.from_numpy(w)).sum().backward()
    assert x.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16 and tb.grad.dtype == torch.float32
    np.testing.assert_array_equal(x.view(torch.int16).numpy(), np.asarray(ref).view(np.int16))
    np.testing.assert_array_equal(tb.grad.numpy().view(np.int32), np.asarray(ref_grad).view(np.int32))


def _dataset(folder, n=3, size=64):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(f"{folder}/im_{i}.png")
        with open(f"{folder}/im_{i}.txt", "w") as f:
            f.write(f"a photo of {TRIGGER}, thing {i}")
    return folder


def _job(tmp_path, name, steps, **over):
    proc = {"type": "sd_trainer", "training_folder": str(tmp_path / "out"),
            "embedding": {"trigger": TRIGGER, "vectors": 3, "init_words": "person"},
            "save": {"dtype": "float16", "save_every": 2},
            "datasets": [{"folder_path": _dataset(str(tmp_path / "imgs")), "caption_ext": "txt",
                          "caption_dropout_rate": 0.3, "resolution": [64]}],
            "train": {"batch_size": 2, "steps": steps, "noise_scheduler": "ddpm", "optimizer": "adamw",
                      "lr": 5e-3, "dtype": "bf16", "seed": 7},
            "model": dict(TINY), "logging": {"log_every": 1}}
    for key, val in over.items():
        proc[key] = {**proc.get(key, {}), **val}
    return {"job": "extension", "config": {"name": name, "process": [proc]}}


def test_ti_job_trains_only_the_bank(tmp_path):
    """Three steps of the tiny sd1 job: the bank moves, the UNet, CLIP and
    VAE equal a fresh seeded init bit for bit, the step and final files are
    ``{"emb_params": [3, 64]}`` in f32 (the save dtype is fp16) naming the
    trigger, the final one the bank as trained, and a sample through the
    bank differs from one without it."""
    from safetensors import safe_open

    job = get_job(_job(tmp_path, "ti", 3, sample={"sample_every": 0, "width": 64, "height": 64,
                                                   "sample_steps": 2, "sampler": "ddpm",
                                                   "prompts": [f"a photo of {TRIGGER}"]}), device="cpu")
    (result,) = job.run()
    proc = job.processes[0]
    assert len(result["losses"]) == 3 and all(np.isfinite(result["losses"]))
    assert result["trainable_params"] == 3 * 64 and result["lora_modules"] == 0
    fresh = SDModel(ModelConfig.from_dict(dict(TINY)), device="cpu").init_variables(torch.Generator().manual_seed(7))
    for name in ("unet", "clip", "vae"):
        for k, v in fresh[name].state_dict().items():
            assert torch.equal(proc.variables[name].state_dict()[k], v), f"{name} {k}"
    bank = proc.variables["emb"].detach()
    table = fresh["clip"].text_model.embeddings.token_embedding.weight
    person = [i for i in proc.model.tokenizer.base.encode("person") if i != 999]
    assert not torch.equal(bank, table[person * 3])
    for path, step in ((tmp_path / "out" / "ti" / "ti_000000002.safetensors", 2), (result["save_path"], 3)):
        with safe_open(str(path), framework="numpy") as f:
            assert list(f.keys()) == ["emb_params"] and f.metadata()["step"] == str(step)
            assert f.metadata()["name"] == TRIGGER and f.get_tensor("emb_params").dtype == np.float32
    np.testing.assert_array_equal(temb.load_embedding(result["save_path"]), bank.numpy())
    with_bank = [np.asarray(Image.open(r["path"])) for r in result["samples"]]
    assert len(with_bank) == 2  # the first sample and the final one
    variables = dict(proc.variables)
    variables["emb"] = torch.zeros_like(bank)
    from ai_toolkit_tpu_torch.config.modules import GenerateImageConfig
    from ai_toolkit_tpu_torch.generation import generate

    gen = GenerateImageConfig.from_sample(proc.cfg.sample, proc.cfg.sample.prompts[0], proc.cfg.sample.seed)
    assert not np.array_equal(generate(proc.model, variables, gen), with_bank[-1])


def test_ti_resume_continues_bit_for_bit(tmp_path, monkeypatch):
    """4 steps (adamw, EMA, caption dropout) against the same job cut after
    its step-2 save and run again: the losses of steps 3 and 4, the bank,
    its EMA and the moments equal bit for bit; the final file holds the EMA
    copy."""
    from ai_toolkit_tpu_torch.jobs.train_process import SDTrainProcess

    ema = {"ema_config": {"use_ema": True, "ema_decay": 0.9}}
    job = get_job(_job(tmp_path, "whole", 4, train=ema), device="cpu")
    (whole,) = job.run()
    ref = job.processes[0].state
    prepare, calls = SDTrainProcess._prepare_batch, []

    def cut_after_two(self, *args):
        calls.append(1)
        if len(calls) > 2:
            raise KeyboardInterrupt
        return prepare(self, *args)

    with monkeypatch.context() as m:
        m.setattr(SDTrainProcess, "_prepare_batch", cut_after_two)
        with pytest.raises(KeyboardInterrupt):
            run_job(_job(tmp_path, "cut", 4, train=ema), device="cpu")
    job = get_job(_job(tmp_path, "cut", 4, train=ema), device="cpu")
    (resumed,) = job.run()
    state = job.processes[0].state
    assert resumed["start_step"] == 2 and resumed["losses"] == whole["losses"][2:]
    assert torch.equal(state.trainable["emb"], ref.trainable["emb"]) and torch.equal(state.ema["emb"], ref.ema["emb"])
    assert not torch.equal(state.ema["emb"], state.trainable["emb"])
    for mine, theirs in zip(state.optimizer.state_dict(["emb"]).values(), ref.optimizer.state_dict(["emb"]).values()):
        assert torch.equal(mine, theirs)
    np.testing.assert_array_equal(temb.load_embedding(resumed["save_path"]), state.ema["emb"].numpy())


@pytest.mark.parametrize("over,match", [
    ({"embedding": {"trigger": TRIGGER, "sigma": 2}}, "not read"),
    ({"network": {"type": "lora"}}, "together with a network"),
    ({"model": {"arch": "sdxl"}}, "textual inversion"),
    ({"model": {"arch": "flux"}}, "textual inversion"),
])
def test_ti_refusals(tmp_path, over, match):
    """Keys of ``embedding`` the JAX job does not read, a network beside it
    (the JAX job drops the network), and archs other than SD 1.x / 2.x raise
    before a model is built; SDXL's train forward refuses token ids."""
    raw = _job(tmp_path, "refused", 1)
    proc = raw["config"]["process"][0]
    for key, val in over.items():
        proc[key] = val if key != "model" else {**proc["model"], **val}
    with pytest.raises(NotImplementedError, match=match):
        get_job(raw, device="cpu").run()
    with pytest.raises(NotImplementedError, match="textual inversion"):
        SDXLModel(ModelConfig.from_dict({**TINY, "arch": "sdxl"}), device="cpu").predict_train(
            {}, torch.zeros(1, 8, 8, 4), torch.tensor([3]), {"input_ids": torch.zeros(1, 77, dtype=torch.long)})
