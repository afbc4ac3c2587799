"""The port's flux LoRA training job as a whole, on the CPU at the tiny size:
``run_job`` with an ``sd_trainer`` process trains a few steps from a seeded
folder of 64^2 images, saves the LoRA in the PEFT layout, and the generate job
loads that file through ``lora_path``. Branches the slice does not take raise."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from ai_toolkit_tpu_torch.io.lora_file import load_lora_file
from ai_toolkit_tpu_torch.jobs import get_job, run_job

torch.set_num_threads(1)
TINY = {"name_or_path": "", "arch": "flux", "model_kwargs": {"size": "tiny"}}


def _dataset(folder, n=3, size=64):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(
            os.path.join(folder, f"im_{i}.png"))
        with open(os.path.join(folder, f"im_{i}.txt"), "w") as f:
            f.write(f"[trigger] photo of thing {i}")
    return folder


def _train_proc(tmp_path):
    return {
        "type": "sd_trainer", "training_folder": str(tmp_path / "out"), "trigger_word": "sks",
        "network": {"type": "lora", "linear": 4, "linear_alpha": 4},
        "save": {"dtype": "float16", "save_every": 2, "max_step_saves_to_keep": 4},
        "datasets": [{"folder_path": _dataset(str(tmp_path / "imgs")), "caption_ext": "txt",
                      "cache_latents": True, "cache_latents_to_disk": False, "resolution": [64]}],
        "train": {"batch_size": 1, "steps": 3, "gradient_checkpointing": True,
                  "noise_scheduler": "flowmatch", "timestep_type": "flux_shift",
                  "optimizer": "adamw8bit", "lr": 1e-3, "max_grad_norm": 1.0,
                  "ema_config": {"use_ema": True, "ema_decay": 0.9}, "dtype": "float32", "seed": 3},
        "model": dict(TINY), "logging": {"log_every": 1},
    }


def _job(name, proc):
    return {"job": "extension", "config": {"name": name, "process": [proc]}}


def test_sd_trainer_job_trains_saves_and_generate_loads_the_lora(tmp_path):
    job = get_job(_job("tiny_lora", _train_proc(tmp_path)), device="cpu")
    (result,) = job.run()
    assert result["steps"] == 3 and len(result["losses"]) == 3
    assert all(np.isfinite(result["losses"]))
    state = job.processes[0].state
    assert all(float(p.abs().max()) > 0 for k, p in state.trainable.items() if k.endswith(".b"))
    assert any(not torch.equal(state.ema[k], p) for k, p in state.trainable.items())

    root = tmp_path / "out" / "tiny_lora"
    assert os.path.isfile(root / "tiny_lora_000000002.safetensors")  # save_every 2
    path = result["save_path"]
    assert path == str(root / "tiny_lora.safetensors")
    tree, meta = load_lora_file(path)
    assert meta["step"] == "3" and len(tree) == result["lora_modules"] > 0
    # the final save is the EMA copy of the factors, in fp16
    for name, leaf in tree.items():
        np.testing.assert_allclose(leaf["b"].numpy(), state.ema[f"{name}.b"].numpy(), atol=1e-3)

    # the generate job overlays it: the image differs from the one without it
    def generate(lora_path):
        proc = {"type": "generate", "training_folder": str(tmp_path / "gen"), "model": dict(TINY),
                "sample": {"width": 32, "height": 32, "sample_steps": 2, "seed": 1,
                           "prompts": ["sks photo of thing 0"]}}
        if lora_path:
            proc["lora_path"] = lora_path
        (res,) = run_job(_job("gen", proc), device="cpu")
        return np.asarray(Image.open(res["images"][0]))

    with_lora, without = generate(path), generate(None)
    assert with_lora.shape == without.shape == (32, 32, 3)
    assert not np.array_equal(with_lora, without)


@pytest.mark.parametrize("over,match", [
    ({"model": {"quantize_te": True}}, "quantize"),  # the DiT's quantize is ported; the TEs' is not
    ({"embedding": {"trigger": "sks"}}, "textual inversion"),  # on flux; SD 1.x / 2.x take it
    # the DFE loss is ported; beside a guidance loss (which the JAX job builds without it) it raises
    ({"train": {"diffusion_feature_extractor_path": "v7:/nowhere", "guidance_loss": "polarity"}},
     "diffusion_feature_extractor_path"),
    ({"train": {"lr_scheduler": "one_cycle"}}, "lr_scheduler"),
    ({"train": {"match_adapter_chance": 0.5}}, "train-step knobs"),  # the other knobs are ported
    ({"network": {"type": "ia3"}}, "only LoRA"),  # lokr / loha / dora / lorm / locon are ported
    ({"mesh": {"axes": {"fsdp": 4}}}, "multi-GPU"),
    ({"model": {"quantize": True, "qtype": "uint4"}}, "4-bit"),
])
def test_sd_trainer_refuses_what_the_slice_does_not_take(tmp_path, over, match):
    proc = _train_proc(tmp_path)
    for key, val in over.items():
        if key == "dataset":
            proc["datasets"] = [{**proc["datasets"][0], **val}]
        else:
            proc[key] = {**proc.get(key, {}), **val}
    with pytest.raises(NotImplementedError, match=match):
        run_job(_job("refused", proc), device="cpu")


def test_sd_trainer_refuses_to_resume(tmp_path):
    """A save in the output folder is resumed from, never passed over: one
    that cannot be read raises instead of a fresh start (resume itself:
    tests/test_torch_job_features.py)."""
    root = tmp_path / "out" / "again"
    os.makedirs(root)
    (root / "again_000000002.safetensors").write_bytes(b"")
    with pytest.raises(Exception, match="(?i)header|deserializ|safetensor"):
        run_job(_job("again", _train_proc(tmp_path)), device="cpu")
