"""The training job (``ai_toolkit_tpu/jobs/train_process.py``
``SDTrainProcess`` in PyTorch), on the paths of the LoRA job and of the full
fine-tune:

model (seeded random weights) -> optional weight-only quantization of the DiT
(``model.quantize``, fp8 or int8: ``adapters/quantize.py``) -> LoRA on the
DiT (the model's targets) -> AdamW(8bit)
-> folder dataset with in-memory latent and text-embedding caches -> train
loop (``train/step.py``) with the save cadence -> final save of the LoRA (the
EMA copy when EMA is on) in the PEFT layout.

A full fine-tune (``network`` absent or of type ``full`` / ``fine_tune``)
trains the DiT's own parameters in place, those its ``only_if_contains`` /
``ignore_if_contains`` patterns select (:func:`filter_param_names`, JAX
``_filter_param_tree``), and saves them as they are: the trained tensors
(not the EMA) in their own dtype, keyed by the port's parameter names, in
``<name>_<step:09d>.safetensors`` at the save cadence and a final
``<name>.safetensors``, with no rotation (JAX ``_save``'s full fine-tune
branch). The JAX job's HF-layout export of the final save
(``_export_interop``) is not ported (ROADMAP: ``io/full_export.py``).

Every branch of the JAX process that these paths do not take raises
``NotImplementedError`` naming its slice: resume, sampling during training,
validation, other networks and adapters, quantized text encoders
(``quantize_te``), text-encoder training, several resolutions, the disk
latent cache, lr schedules and the train-step knobs
(``TrainStepConfig.from_train_config``). With ``AIT_PROFILE_DIR`` set, the
last step runs under ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time

import numpy as np
import torch

from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora, count_lora_params
from ai_toolkit_tpu_torch.adapters.quantize import quantize_params, quantized_bytes
from ai_toolkit_tpu_torch.config.modules import ModelConfig, ProcessConfig, TrainConfig
from ai_toolkit_tpu_torch.data.caching import TextEmbedCache, cache_latents
from ai_toolkit_tpu_torch.data.loader import build_dataloader
from ai_toolkit_tpu_torch.io.checkpoint import CheckpointManager
from ai_toolkit_tpu_torch.models.registry import get_model_class
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.optimizers import get_optimizer
from ai_toolkit_tpu_torch.train.state import TrainState
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, make_train_step
from ai_toolkit_tpu_torch.utils.unported import refuse_unported

# TrainConfig knobs read by the JAX process (not its step) that this path does not take
_UNPORTED_TRAIN = (
    "train_text_encoder", "free_u", "refiner_lr", "adapter_lr", "embedding_lr", "unet_lr",
    "text_encoder_lr", "do_blank_stabilization", "prompt_saturation_chance",
    "short_and_long_captions", "short_and_long_captions_encoder_split", "prompt_dropout_prob",
    "reg_weight", "img_multiplier", "latent_multiplier", "standardize_images",
    "merge_network_on_save", "learnable_snr_gos",
)
_UNPORTED_MODEL = ("quantize_te", "lora_path", "assistant_lora_path",
                   "inference_lora_path", "unconditional_lora_path", "accuracy_recovery_adapter")


def _norm_pattern(p: str) -> str:
    p = p.strip().strip(".")
    if p.startswith("transformer."):
        p = p[len("transformer."):]
    return p.replace(".", "/")


def _pattern_variants(p: str) -> set[str]:
    """The reference's diffusers block-list names mapped onto the module names."""
    return {p, p.replace("single_transformer_blocks", "single_blocks"),
            p.replace("transformer_blocks", "double_blocks"), p.replace("transformer_blocks", "blocks")}


def filter_param_names(names, include: list[str] | None, exclude: list[str] | None) -> list[str]:
    """The parameter names that contain an ``include`` pattern (when any is
    given) and no ``exclude`` pattern, JAX ``_filter_param_tree`` over the
    port's names: patterns and names are compared '/'-joined, a leading
    ``transformer.`` is dropped, and reference configs' ``transformer_blocks``
    / ``single_transformer_blocks`` also match the block lists."""
    inc = [v for p in include or [] for v in _pattern_variants(_norm_pattern(p))]
    exc = [v for p in exclude or [] for v in _pattern_variants(_norm_pattern(p))]
    keep = []
    for name in names:
        path = name.replace(".", "/")
        if (not inc or any(p in path for p in inc)) and not any(p in path for p in exc):
            keep.append(name)
    return keep


def select_trainable(module: torch.nn.Module, include: list[str] | None,
                     exclude: list[str] | None) -> dict[str, torch.nn.Parameter]:
    """The full fine-tune's trainable parameters of ``module`` by name; they,
    and only they, get ``requires_grad``."""
    params = dict(module.named_parameters())
    names = set(filter_param_names(params, include, exclude))
    for name, p in params.items():
        p.requires_grad_(name in names)
    return {name: p for name, p in params.items() if name in names}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _profiler(out_dir: str | None, device: torch.device):
    """``torch.profiler`` over the block when ``out_dir`` is given (the last
    step of a run with ``AIT_PROFILE_DIR`` set, as the JAX process traces with
    it): writes ``train_step_profile.txt`` there, the ops by device time."""
    if out_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield
    os.makedirs(out_dir, exist_ok=True)
    sort = "device_time_total" if device.type == "cuda" else "cpu_time_total"
    with open(os.path.join(out_dir, "train_step_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=80))


class SDTrainProcess:
    """Process types ``sd_trainer`` / ``diffusion_trainer`` / ``ui_trainer``."""

    def __init__(self, job_name: str, cfg: ProcessConfig, device: torch.device | str):
        self.job_name = job_name
        self.cfg = cfg
        self.device = torch.device(device)
        self.save_root = os.path.join(cfg.training_folder, job_name)

    @property
    def full_finetune(self) -> bool:
        return self.cfg.network is None or self.cfg.network.type in ("full", "fine_tune")

    def _refuse_unported(self) -> None:
        cfg, tc = self.cfg, self.cfg.train
        if not self.full_finetune and cfg.network.type not in ("lora", "locon"):
            raise NotImplementedError(f"network '{cfg.network.type}': only LoRA and the full fine-tune "
                                      f"are ported (other networks: later slices)")
        if self.full_finetune and cfg.model.quantize:
            raise NotImplementedError(
                "model.quantize with a full fine-tune comes with slice G (the JAX job trains only the "
                "weights that quantization leaves unquantized)")
        if cfg.adapter or cfg.embedding or cfg.slider:
            raise NotImplementedError("adapters / embeddings / sliders come with later slices")
        refuse_unported(tc, _UNPORTED_TRAIN, TrainConfig(), "train")
        refuse_unported(cfg.model, _UNPORTED_MODEL, ModelConfig(), "model")
        if cfg.model.quantize_kwargs:
            raise NotImplementedError("model.quantize_kwargs come with slice G")
        if not tc.train_unet:
            raise NotImplementedError("train_unet: false trains nothing the port has")
        if (tc.noise_scheduler or "flowmatch").lower() not in ("flowmatch", "flowmatch_euler"):
            raise NotImplementedError(f"noise_scheduler '{tc.noise_scheduler}' (flowmatch only)")
        if tc.extras.get("scheduler_params"):
            raise NotImplementedError("train.scheduler_params overrides come with a later slice")
        if (tc.lr_scheduler or "constant").lower() != "constant":
            raise NotImplementedError(f"lr_scheduler '{tc.lr_scheduler}' comes with a later slice")
        if not tc.disable_sampling and cfg.sample.prompts:
            raise NotImplementedError("sampling during training comes with a later slice: set "
                                      "train.disable_sampling or give no sample prompts")
        if cfg.validation.validate_every > 0:
            raise NotImplementedError("validation comes with a later slice")
        if cfg.save.push_to_hub:
            raise NotImplementedError("push_to_hub is not ported")
        sizes = [n for n in cfg.mesh.axes.values() if n not in (1, -1)]
        if sizes:
            raise NotImplementedError(f"mesh {cfg.mesh.axes}: multi-GPU comes with a later slice")
        if not cfg.datasets:
            raise ValueError("no datasets configured")
        for d in cfg.datasets:
            if d.cache_latents_to_disk:
                raise NotImplementedError("cache_latents_to_disk comes with a later slice; set it "
                                          "false (cache_latents keeps latents in memory)")

    def run(self) -> dict:
        cfg, tc, dev = self.cfg, self.cfg.train, self.device
        self._refuse_unported()
        seed = tc.seed if tc.seed is not None else int(os.environ.get("SEED", 42))
        ckpt = CheckpointManager(self.save_root, self.job_name,
                                 max_step_saves_to_keep=cfg.save.max_step_saves_to_keep,
                                 dtype=np.float16 if cfg.save.dtype in ("float16", "fp16") else np.float32)
        if ckpt.latest_save_path() is not None:
            raise NotImplementedError(
                f"{self.save_root} holds a save to resume from: resume comes with a later slice "
                f"(use another training_folder or name)")

        # 1. model (1b. quantized DiT), 2. LoRA on the DiT or the full fine-tune's selection
        model = get_model_class(cfg.model.arch)(cfg.model, dev)
        variables = model.load_variables(torch.Generator(device=dev).manual_seed(seed))
        dit = variables["dit"]
        if cfg.model.quantize:
            names = quantize_params(dit, qtype=cfg.model.qtype)
            print(f"quantized base: {len(names)} weights, {quantized_bytes(dit) / 1e9:.2f} GB "
                  f"({cfg.model.qtype})")
        if self.full_finetune:
            net = cfg.network
            inc = cfg.model.only_if_contains or (net.only_if_contains if net else None)
            exc = cfg.model.ignore_if_contains or (net.ignore_if_contains if net else None)
            trainable, lora = select_trainable(dit, inc, exc), None
            n_params = sum(p.numel() for p in trainable.values())
            if inc or exc:
                print(f"full fine-tune (filtered to {n_params:,} params)")
        else:
            spec = LoRASpec.from_network_config(cfg.network, target_patterns=model.lora_targets())
            lora = build_lora(dit, spec, torch.Generator(device=dev).manual_seed(seed))
            n_params = count_lora_params(lora)
            print(f"LoRA: {len(lora)} modules, {n_params:,} trainable params (rank {spec.rank})")
            trainable = {f"{name}.{leaf}": p for name, m in lora.items() for leaf, p in m.named_parameters()}
        dit.gradient_checkpointing = tc.gradient_checkpointing

        # 3. optimizer + state
        tx = get_optimizer(tc.optimizer, list(trainable.values()), tc.lr, tc.optimizer_params,
                           tc.max_grad_norm)
        state = TrainState(trainable, tx, use_ema=tc.ema_config.use_ema)

        # 4. data, 5. step
        loader, text_cache = self._build_data(model, variables)
        step_cfg = TrainStepConfig.from_train_config(tc)
        train_step = make_train_step(lambda noisy, t, cond: model.predict(variables, noisy, t, cond),
                                     FlowMatchSchedule(), step_cfg)

        # 6. the loop
        generator = torch.Generator(device=dev).manual_seed(seed + 1)
        data_iter = iter(loader)
        losses: list[float] = []
        step_ms: list[float] = []
        profile_dir = os.environ.get("AIT_PROFILE_DIR")
        for step in range(tc.steps):
            batches = [self._prepare_batch(model, next(data_iter), text_cache)
                       for _ in range(step_cfg.grad_accum)]
            _sync(dev)
            profile = profile_dir is not None and step == tc.steps - 1
            t0 = time.perf_counter()
            with _profiler(profile_dir if profile else None, dev):
                metrics = train_step(state, batches, generator)
                loss = float(metrics["loss"])  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            if (step + 1) % cfg.logging.log_every == 0 or step == 0:
                print(f"step {step + 1}/{tc.steps} loss={loss:.4f} "
                      f"grad_norm={float(metrics['grad_norm']):.4f} ({step_ms[-1]:.1f} ms)")
            if cfg.save.save_every and (step + 1) % cfg.save.save_every == 0 and step + 1 < tc.steps:
                print(f"saved: {self._save(ckpt, state, lora, step + 1)}")
        path = self._save(ckpt, state, lora, tc.steps, final=True)
        print(f"saved: {path}")
        self.state, self.lora, self.variables = state, lora, variables  # introspection
        return {"final_loss": losses[-1] if losses else None, "steps": tc.steps,
                "losses": losses, "step_ms": step_ms,
                "median_step_ms": statistics.median(step_ms) if step_ms else None,
                "trainable_params": n_params, "lora_modules": len(lora) if lora is not None else 0,
                "save_path": path}

    @staticmethod
    def _save(ckpt: CheckpointManager, state: TrainState, lora: dict | None, step: int,
              final: bool = False) -> str:
        """A LoRA save: the EMA copy when EMA is on, in the PEFT layout, with
        rotation. A full fine-tune's: the trained tensors themselves in their
        own dtype, keyed by parameter name, no rotation (JAX ``_save``)."""
        if lora is not None:
            src = state.ema if state.ema is not None else state.trainable
            tree = {name: {leaf: src[f"{name}.{leaf}"] for leaf in ("a", "b", "scale")} for name in lora}
            return ckpt.save(tree, step, final=final)
        from safetensors.torch import save_file

        path = ckpt.final_path() if final else ckpt.path_for_step(step)
        save_file({k: t.detach().contiguous().cpu() for k, t in state.trainable.items()}, path,
                  metadata={"step": str(step), "software": "ai_toolkit_tpu"})
        return path

    def _build_data(self, model, variables):
        cfg = self.cfg
        loader = build_dataloader(cfg.datasets, cfg.train.batch_size, model.bucket_divisibility,
                                  trigger_word=cfg.trigger_word, encode_fn=None, latent_cache={})

        @torch.no_grad()
        def encode_fn(imgs: np.ndarray) -> np.ndarray:
            lat = model.encode_images(variables, torch.from_numpy(imgs))
            return lat.float().cpu().numpy()

        if all(d.cache_latents for d in cfg.datasets):
            t0 = time.perf_counter()
            items = [it for ds in loader.datasets for it in ds.items]
            loader.latent_cache = cache_latents(items, encode_fn, batch_size=cfg.train.batch_size)
            _sync(self.device)
            print(f"latent cache: {len(loader.latent_cache)} latents in "
                  f"{time.perf_counter() - t0:.2f} s (in memory)")
        else:
            loader.latent_cache, loader.encode_fn = None, encode_fn

        @torch.no_grad()
        def encode_prompt(prompts: list[str]) -> dict:
            return model.encode_prompt(variables, prompts)

        return loader, TextEmbedCache(encode_prompt)

    def _prepare_batch(self, model, raw: dict, text_cache: TextEmbedCache) -> dict:
        dev = self.device
        cond = dict(text_cache.get(raw["captions"]))
        latents = torch.from_numpy(raw["latents"]).to(dev)
        b, h, w, _ = latents.shape
        cond["pe"] = model.rope_table(h, w, int(cond["txt"].shape[1]))
        cond["guidance"] = torch.full((b,), 1.0, dtype=torch.float32, device=dev)
        return {"latents": latents, "cond": cond,
                "loss_multiplier": torch.from_numpy(raw["loss_multiplier"]).to(dev),
                "image_seq_len": (h // 2) * (w // 2)}
