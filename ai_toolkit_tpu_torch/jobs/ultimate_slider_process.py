"""The ultimate slider job (``ai_toolkit_tpu/jobs/ultimate_slider_process.py``
``UltimateSliderProcess`` in PyTorch), process types ``ultimate_slider``,
``ultimate_slider_trainer`` and ``image_reference_slider_trainer``: one LoRA
trained on paired reference images and on prompt-pair targets at once.

The model, LoRA, optimizer and target conditions are the concept slider's
(``jobs/slider_process.SliderSetup``). The datasets pair each image of
``folder_path`` with the image of the same file name in
``unconditional_path``; every batch is encoded through the VAE as it comes,
both halves, as the JAX job encodes them (no latent cache), and its
captions through the text encoders. Each step is one backward of
``img_loss_weight * l_img + cfg_loss_weight * l_cfg``
(``train/slider.ultimate_slider_loss``):

- ``l_img``: the pair noised alike at t (``sigmoid`` on a flow model, the
  balanced DDPM draw otherwise), the adapter at ``[+w] * B + [-w] * B`` with
  ``w = network_weight`` plus a uniform draw in ``[-weight_jitter,
  weight_jitter)`` when ``weight_jitter`` > 0, one MSE over the ``2B``
  predictions;
- ``l_cfg``: the concept loss from pure noise at a sampled t, the target
  ``step % targets``, +weight on even steps and -weight (conditions swapped,
  trained at |w|) on odd ones.

``loss``, ``img_loss`` and ``cfg_loss`` are logged; the final save is the
concept slider's. The draws come from a ``torch.Generator`` seeded with 0.
"""

from __future__ import annotations

import os
import statistics
import time

import numpy as np
import torch

from ai_toolkit_tpu_torch.config.modules import ProcessConfig
from ai_toolkit_tpu_torch.data.loader import build_dataloader
from ai_toolkit_tpu_torch.jobs.slider_process import SliderSetup, refuse_slider_config
from ai_toolkit_tpu_torch.jobs.train_process import _sync
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.slider import ultimate_slider_loss

ULTIMATE_KEYS = ("targets", "resolutions", "guidance_strength", "img_loss_weight", "cfg_loss_weight",
                 "network_weight", "weight_jitter")
ULTIMATE_TRAIN_READ = ("steps", "batch_size", "optimizer", "lr", "optimizer_params", "max_grad_norm",
                       "noise_scheduler")


def _timesteps(schedule, generator: torch.Generator, b: int, device) -> torch.Tensor:
    if isinstance(schedule, FlowMatchSchedule):
        return schedule.sample_timesteps(generator, b, "sigmoid", device=device)
    return schedule.sample_timesteps(generator, b, device=device)


class UltimateSliderProcess:
    """Process types ``ultimate_slider`` / ``ultimate_slider_trainer`` /
    ``image_reference_slider_trainer``."""

    def __init__(self, job_name: str, cfg: ProcessConfig, device: torch.device | str):
        self.job_name = job_name
        self.cfg = cfg
        self.device = torch.device(device)
        self.save_root = os.path.join(cfg.training_folder, job_name)

    def _refuse_unported(self) -> dict:
        slider = refuse_slider_config(self.cfg, ULTIMATE_KEYS, ULTIMATE_TRAIN_READ, datasets=True)
        if not self.cfg.datasets:
            raise ValueError("ultimate_slider needs paired-image datasets (folder_path + unconditional_path)")
        for d in self.cfg.datasets:
            if not d.unconditional_path:
                raise ValueError(f"dataset {d.folder_path}: the ultimate slider needs its unconditional_path "
                                 f"(the paired negatives, with the images' file names)")
            if d.control_path or d.inpaint_path:
                raise NotImplementedError(f"dataset {d.folder_path}: control / inpaint images in an ultimate "
                                          f"slider job (the JAX job does not read them)")
        return slider

    def run(self) -> dict:
        cfg, tc, dev = self.cfg, self.cfg.train, self.device
        slider = self._refuse_unported()
        img_w = float(slider.get("img_loss_weight", 1.0))
        cfg_w = float(slider.get("cfg_loss_weight", 1.0))
        strength = float(slider.get("guidance_strength", 3.0))
        net_weight = float(slider.get("network_weight", 1.0))
        jitter = float(slider.get("weight_jitter", 0.0))
        res = (slider.get("resolutions") or [[512, 512]])[0]
        setup = self.setup = SliderSetup(cfg, dev, res)
        model, variables, schedule = setup.model, setup.variables, setup.schedule

        @torch.no_grad()
        def encode(imgs: np.ndarray) -> torch.Tensor:
            return model.encode_images(variables, torch.from_numpy(imgs))

        loader = build_dataloader(cfg.datasets, tc.batch_size, model.bucket_divisibility,
                                  trigger_word=cfg.trigger_word,
                                  encode_fn=lambda imgs: encode(imgs).float().cpu().numpy())
        data_iter = iter(loader)
        conds = setup.target_conds(slider["targets"])
        h, w, c = setup.latent_hw
        generator = torch.Generator(device=dev).manual_seed(0)
        losses, img_losses, cfg_losses, step_ms = [], [], [], []
        for step in range(tc.steps):
            raw = next(data_iter)
            _sync(dev)
            t0 = time.perf_counter()
            if "unconditional_pixels" not in raw:
                raise ValueError("ultimate_slider datasets need unconditional_path pair images (an image of this "
                                 f"{raw['bucket']} batch has none)")
            latents = torch.from_numpy(raw["latents"]).to(dev)
            bh, bw = latents.shape[1:3]
            batch = {"latents": latents, "unconditional_latents": encode(raw["unconditional_pixels"]),
                     "cond": setup.encode(raw["captions"], bh, bw)}
            cond_n, cond_p, cond_g, weight = conds[step % len(conds)]
            noisy = torch.randn((1, h, w, c), generator=generator, dtype=torch.float32, device=dev)
            t = _timesteps(schedule, generator, 1, dev)
            mult = weight if step % 2 == 0 else -weight
            if mult < 0:
                cond_p, cond_g = cond_g, cond_p
            wt = net_weight
            if jitter > 0.0:
                u = torch.rand((), generator=generator, dtype=torch.float32, device=dev)
                wt = net_weight + (u * 2.0 - 1.0) * jitter
            img_t = _timesteps(schedule, generator, latents.shape[0], dev)
            img_noise = torch.randn(latents.shape, generator=generator, dtype=latents.dtype, device=dev)
            total, l_img, l_cfg = ultimate_slider_loss(setup.predict_fn, schedule, batch, img_noise, img_t, wt,
                                                       noisy, t, cond_p, cond_n, cond_g, strength, abs(mult),
                                                       img_w, cfg_w)
            losses.append(setup.step(total))
            img_losses.append(float(l_img.detach()))
            cfg_losses.append(float(l_cfg.detach()))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if (step + 1) % cfg.logging.log_every == 0 or step == 0:
                print(f"ultimate_slider {step + 1}/{tc.steps} loss={losses[-1]:.5f} img={img_losses[-1]:.5f} "
                      f"cfg={cfg_losses[-1]:.5f} ({step_ms[-1]:.1f} ms)")
        path = setup.save(self.save_root, self.job_name, tc.steps)
        print(f"saved: {path}")
        return {"final_loss": losses[-1] if losses else None, "losses": losses, "img_losses": img_losses,
                "cfg_losses": cfg_losses, "step_ms": step_ms,
                "median_step_ms": statistics.median(step_ms) if step_ms else None, "steps": tc.steps,
                "save_path": path, "lora_modules": len(setup.lora), "load_s": setup.load_s}
