"""The training job (``ai_toolkit_tpu/jobs/train_process.py``
``SDTrainProcess`` in PyTorch), on the paths of the LoRA job and of the full
fine-tune:

model (seeded random weights) -> optional weight-only quantization of the DiT
(``model.quantize``, fp8 or int8: ``adapters/quantize.py``; each expert of a
multistage pair from its own weights, as it is built) -> LoRA on the
model's main component, the DiT or the UNet (the model's targets), one
network shared by a multistage pair's two experts ->
AdamW(8bit) -> the schedule (``samplers/factory.get_schedule``: flow matching,
or DDPM for SDXL) -> folder dataset with in-memory latent and text-embedding
caches -> train loop (``train/step.py``) with the save cadence -> final save
of the LoRA (the EMA copy when EMA is on) in the PEFT layout for a
flow-matching DiT, under the module names the JAX job writes (the model's
``lora_key``, Wan's JAX paths), the kohya layout (``lora_unet_...``) for the
UNet. A video model (Wan) snaps each dataset's ``num_frames`` to its VAE's
frame grid and trains on 5-D latents ``[B, T, h, w, C]``; with a dataset's
``do_i2v`` the first frame of each clip goes through an i2v arch's vision
tower into ``img_cond``. A multistage pair with ``switch_boundary_every > 1``
alternates the trained expert every that many steps, high-noise first (the
sampled t squeezed into ``[boundary, 1]``, then ``[0, boundary]``), and each
step logs the expert that ran.

A full fine-tune (``network`` absent or of type ``full`` / ``fine_tune``,
flow-matching DiTs only) trains the DiT's own parameters in place, those its ``only_if_contains`` /
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
import dataclasses
import os
import statistics
import time

import numpy as np
import torch

from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora, count_lora_params, share_lora
from ai_toolkit_tpu_torch.adapters.quantize import quantized_bytes, quantized_count
from ai_toolkit_tpu_torch.config.modules import ModelConfig, ProcessConfig, TrainConfig
from ai_toolkit_tpu_torch.data.caching import TextEmbedCache, cache_latents
from ai_toolkit_tpu_torch.data.loader import build_dataloader
from ai_toolkit_tpu_torch.io.checkpoint import CheckpointManager
from ai_toolkit_tpu_torch.models.registry import get_model_class
from ai_toolkit_tpu_torch.samplers.factory import DDPM_NAMES, get_schedule
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
        flow = get_model_class(cfg.model.arch).is_flow_matching
        scheduler = (tc.noise_scheduler or "flowmatch").lower()
        if scheduler not in (("flowmatch", "flowmatch_euler") if flow else DDPM_NAMES):
            raise NotImplementedError(f"noise_scheduler '{tc.noise_scheduler}' for arch "
                                      f"'{cfg.model.arch}' (ported: flowmatch for the DiTs, ddpm for SDXL)")
        if not flow and (self.full_finetune or cfg.model.quantize):
            raise NotImplementedError("the UNet's full fine-tune and quantized base come with a later slice")
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
        if cfg.mesh.axes.get("sp", 1) not in (1, -1) and cfg.model.arch.startswith("wan"):
            from ai_toolkit_tpu_torch.models.wan_model import SEQUENCE_PARALLEL

            raise NotImplementedError(f"mesh {cfg.mesh.axes}: {SEQUENCE_PARALLEL}")
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
        # the JAX job's layouts: PEFT for flow-matching DiTs, kohya for the UNet
        flow = get_model_class(cfg.model.arch).is_flow_matching
        ckpt = CheckpointManager(self.save_root, self.job_name,
                                 max_step_saves_to_keep=cfg.save.max_step_saves_to_keep,
                                 dtype=np.float16 if cfg.save.dtype in ("float16", "fp16") else np.float32,
                                 fmt="peft" if flow else "kohya")
        if ckpt.latest_save_path() is not None:
            raise NotImplementedError(
                f"{self.save_root} holds a save to resume from: resume comes with a later slice "
                f"(use another training_folder or name)")

        # 1. model (1b. quantized DiT), 2. LoRA on the DiT / UNet or the full fine-tune's selection
        model = get_model_class(cfg.model.arch)(cfg.model, dev)
        if self.full_finetune and len(model.experts) > 1:
            raise NotImplementedError("the full fine-tune of a multistage pair comes with a later slice")
        ckpt.key_map = getattr(model, "lora_key", None)
        variables = model.load_variables(torch.Generator(device=dev).manual_seed(seed),
                                         qtype=cfg.model.qtype if cfg.model.quantize else None)
        net = variables[model.main_component]
        experts = [variables[name] for name in model.experts]
        if cfg.model.quantize:
            print(f"quantized base: {sum(quantized_count(m) for m in experts)} weights, "
                  f"{sum(quantized_bytes(m) for m in experts) / 1e9:.2f} GB ({cfg.model.qtype})")
        if self.full_finetune:
            ncfg = cfg.network
            inc = cfg.model.only_if_contains or (ncfg.only_if_contains if ncfg else None)
            exc = cfg.model.ignore_if_contains or (ncfg.ignore_if_contains if ncfg else None)
            trainable, lora = select_trainable(net, inc, exc), None
            n_params = sum(p.numel() for p in trainable.values())
            if inc or exc:
                print(f"full fine-tune (filtered to {n_params:,} params)")
        else:
            spec = LoRASpec.from_network_config(cfg.network, target_patterns=model.lora_targets())
            lora = build_lora(net, spec, torch.Generator(device=dev).manual_seed(seed))
            for other in experts[1:]:
                share_lora(other, lora)
            n_params = count_lora_params(lora)
            print(f"LoRA: {len(lora)} modules, {n_params:,} trainable params (rank {spec.rank})")
            trainable = {f"{name}.{leaf}": p for name, m in lora.items() for leaf, p in m.named_parameters()}
        for m in experts:
            if hasattr(m, "gradient_checkpointing"):  # the DiT; the UNet follows model.remat_policy
                m.gradient_checkpointing = tc.gradient_checkpointing

        # 3. optimizer + state
        tx = get_optimizer(tc.optimizer, list(trainable.values()), tc.lr, tc.optimizer_params,
                           tc.max_grad_norm)
        state = TrainState(trainable, tx, use_ema=tc.ema_config.use_ema)

        # 4. data, 5. step
        loader, text_cache = self._build_data(model, variables)
        step_cfg = TrainStepConfig.from_train_config(tc)
        if getattr(model, "multistage", False) and tc.switch_boundary_every > 1:
            step_cfg = dataclasses.replace(step_cfg, stage_boundary=model.stage_boundary,
                                           switch_every=tc.switch_boundary_every)
        predict = getattr(model, "predict_train", model.predict)  # as the JAX job picks it
        train_step = make_train_step(lambda noisy, t, cond: predict(variables, noisy, t, cond),
                                     self._schedule(), step_cfg)

        # 6. the loop
        generator = torch.Generator(device=dev).manual_seed(seed + 1)
        data_iter = iter(loader)
        losses: list[float] = []
        step_ms: list[float] = []
        experts_run: list[str] = []  # a multistage pair's expert at each step
        profile_dir = os.environ.get("AIT_PROFILE_DIR")
        for step in range(tc.steps):
            batches = [self._prepare_batch(model, variables, next(data_iter), text_cache)
                       for _ in range(step_cfg.grad_accum)]
            _sync(dev)
            profile = profile_dir is not None and step == tc.steps - 1
            t0 = time.perf_counter()
            with _profiler(profile_dir if profile else None, dev):
                metrics = train_step(state, batches, generator)
                loss = float(metrics["loss"])  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            if len(experts) > 1:
                experts_run.append(model.last_expert)
            if (step + 1) % cfg.logging.log_every == 0 or step == 0:
                expert = f" expert={model.last_expert}" if len(experts) > 1 else ""
                print(f"step {step + 1}/{tc.steps} loss={loss:.4f} "
                      f"grad_norm={float(metrics['grad_norm']):.4f}{expert} ({step_ms[-1]:.1f} ms)")
            if cfg.save.save_every and (step + 1) % cfg.save.save_every == 0 and step + 1 < tc.steps:
                print(f"saved: {self._save(ckpt, state, lora, step + 1)}")
        path = self._save(ckpt, state, lora, tc.steps, final=True)
        print(f"saved: {path}")
        self.state, self.lora, self.variables, self.model = state, lora, variables, model  # introspection
        return {"final_loss": losses[-1] if losses else None, "steps": tc.steps,
                "losses": losses, "step_ms": step_ms,
                "median_step_ms": statistics.median(step_ms) if step_ms else None,
                "trainable_params": n_params, "lora_modules": len(lora) if lora is not None else 0,
                "experts": experts_run, "save_path": path}

    def _schedule(self):
        """The schedule with the job's overrides (JAX ``run``, step 3)."""
        tc = self.cfg.train
        overrides = {}
        if tc.num_train_timesteps != 1000:
            overrides["num_train_timesteps"] = tc.num_train_timesteps
        if self.cfg.model.is_v_pred:
            overrides["prediction_type"] = "v_prediction"
        return get_schedule(tc.noise_scheduler, self.cfg.model.arch, **overrides)

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
        # a video model snaps each dataset's frame count onto its VAE's grid (wan: 4k+1)
        if hasattr(model, "frame_count_snapper"):
            for d in cfg.datasets:
                if d.num_frames > 1:
                    snapped = model.frame_count_snapper(d.num_frames)
                    if snapped != d.num_frames:
                        print(f"dataset {d.folder_path}: num_frames {d.num_frames} -> {snapped} "
                              f"(VAE temporal grid)")
                        d.num_frames = snapped
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

    def _prepare_batch(self, model, variables: dict, raw: dict, text_cache: TextEmbedCache) -> dict:
        dev = self.device
        cond = dict(text_cache.get(raw["captions"]))
        if raw.get("first_frame") is not None:  # i2v: the clip's first frame through the vision tower
            with torch.no_grad():
                cond["img_cond"] = model.encode_image_cond(variables, torch.from_numpy(raw["first_frame"]))
        latents = torch.from_numpy(raw["latents"]).to(dev)
        batch = {"latents": latents, "cond": cond,
                 "loss_multiplier": torch.from_numpy(raw["loss_multiplier"]).to(dev)}
        if latents.dim() == 5:  # video latents [B, T, h, w, C]: rope over (t, y, x)
            tt, h, w = latents.shape[1:4]
            cond["pe"] = model.rope_table(tt, h, w)
            pt, ph, pw = model.dit_config.patch_size
            batch["image_seq_len"] = (tt // pt) * (h // ph) * (w // pw)
            return batch
        b, h, w, _ = latents.shape
        if model.is_flow_matching:
            cond["pe"] = model.rope_table(h, w, int(cond["txt"].shape[1]))
            cond["guidance"] = torch.full((b,), 1.0, dtype=torch.float32, device=dev)
            batch["image_seq_len"] = (h // 2) * (w // 2)
        else:  # SDXL: the added condition from the bucket's pixel size
            d = model.vae_config.downscale
            cond["added_cond"] = model.added_cond(cond.pop("pooled"), h * d, w * d)
        return batch
