#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: ``python3 chip_smoke.py [--profile DIR]``.

Phases (any failure raises and the script exits non-zero):
  1. environment: versions, card name and power limit, TF32 off, the five
     kernel libraries built in parallel (one nvcc each), the registers and
     spills of the wgmma kernels (flash forward, dk/dv, dq; the MoE hidden
     and out passes of the forward and dx, the dw products) from ``-Xptxas -v``;
  2. the flash forward kernel against its plain version at the shapes the
     paths give it (ragged, S != T, smaller than a tile, D 64 and 128, the
     fused-projection views, a view TMA cannot read, which is copied), timed
     against it and against the library yardstick at the flux 1024^2, the
     ragged 1008^2 and the hidream 1024^2 shapes;
  3. the flash backward kernels (dq, dk/dv) the same way, with a case of
     strongly negative logits (an unmasked K/V tail would make dq NaN), their
     bits checked from run to run;
  4. the grouped SwiGLU MoE kernels (forward, dx and its hidden pass, the
     bank gradients dw) the same way, at the hidream shapes with a real top-2
     routing, y, dx, the hidden pass's dh and act and the dw gradients bits
     checked from run to run; the forward's two passes and the dw products
     timed alone, each against its bound;
  5. full-width, reduced-depth flux and hidream DiTs on the card against the
     same modules on the CPU: the forward, one LoRA training step's loss and
     gradients, and (hidream) one full fine-tune step of the first block's
     expert banks;
  6. the flux-dev LoRA ``sd_trainer`` job at 1024^2 through
     ``ai_toolkit_tpu_torch.jobs``, with the launches of every kernel per step
     checked, and no flash input copied for TMA, as in every job phase
     (``--profile DIR`` adds a ``torch.profiler`` split of its last step,
     written to DIR), and ``validate_every: 2``: each ``val_loss`` finite and
     equal to a second evaluation of the same state, one flash forward per
     block an evaluation;
  7. the flux-dev ``generate`` job at 1024x1024, 8 steps, 2 prompts, loading
     the LoRA the train job saved, launch count checked;
  8. a ragged resolution (1008x1008, 4481 tokens), 1 prompt, 2 steps;
  8b. configs/examples/train_lora_flux_tpu.yaml as written but for its
     paths, its steps (SHIPPED_STEPS, 6: one epoch) and seeded weights: the
     qfloat8 base, resolutions 512, 768 and 1024 over two seeded images (6
     items in three buckets), the disk latent cache, the file's two prompts
     at 20 steps first and final; each step's flash launches checked, the step time
     printed per bucket;
  8c. the flux family: full-width chroma (the 5120 x 5 Approximator, its
     344 rows at flux-dev's depth) and flex2 (the 196-input img_in) DiTs cut
     to 1 double + 1 single block, in f32, on the card against the CPU; then
     configs/examples/train_lora_{chroma,flex,flex2,flux_kontext}_tpu.yaml as
     written but for their paths and steps (6) on seeded weights, as 8b
     (the flex2 and kontext files over seeded control images beside the
     training images, flex2 with one seeded inpaint image), their DiT and
     the flex2 generate job's cut to FLUX_FAMILY_CUT (5 + 10) of flux-dev's
     19 + 38 blocks, widths unchanged: 15 launches of
     each flash kernel every step and denoise step, each batch's control
     latents against the VAE encode of its control images, flex2's
     [inpaint | mask | control] layout, a LoRA that moved and reloads, the
     samples; and the flex2 generate job at 1024^2, 8 steps, with a seeded
     ctrl_img and the LoRA it saved;
  8d. the MMDiT archs: a full-width SD3.5-Large joint block with the
     context_pre_only block (38 x 64 heads, the learned position table), a
     sd3.5-medium dual-attention block, a Qwen-Image joint block (a padded
     text mask, a control segment; its attention on the plain path) and a
     Qwen2.5-VL layer with its q/k/v biases, in f32, on the card against the
     CPU; the flash kernels against their plain versions and timed at SD3.5
     Large's shapes (1,255 / 2,535 / 4,327 tokens, ragged tails, a case of
     strongly negative logits); configs/examples/train_lora_{sd35_large,
     qwen_image,qwen_image_edit}_tpu.yaml as written but for their paths
     and steps (6) on seeded weights, as 8b (the edit file over the seeded
     control images), the SD3.5-Large file at SD35L_CUT_BLOCKS (19) of its
     38 blocks: 19 launches of each flash kernel every SD3.5-Large step and
     denoise step, 0 for Qwen-Image, each edit batch's control
     latents against the VAE encode of its control images; and the
     qwen_image_edit generate job at 1024^2, 8 steps, with a seeded ctrl_img
     and the LoRA it saved; the two Qwen files and that job run at
     QWEN_CUT_BLOCKS of the 60 joint blocks, widths unchanged (they launch no
     kernel; the cut keeps the script within its time limit);
  8e. the NextDiT archs: full-width Lumina-Image-2.0 and OmniGen2 (one
     reference image) DiTs cut to 1 joint layer and 1 refiner of each kind,
     20 of 32 caption tokens valid, and a Gemma2-2B layer (the softcap, the
     (1 + w) norms, eos mask 40 of 256), in f32, on the card against the
     CPU, 0 flash launches; their plain joint attention at 1024^2, (1, 4352,
     24, 96) and (1, 4352, 21, 120) bf16 with the caption mask, timed
     against SDPA; configs/examples/train_lora_{lumina2,omnigen2}_tpu.yaml
     as written but for their paths, steps (6) and OmniGen2's transformer
     config (model_kwargs.transformer_config, which a checkpoint's
     transformer/config.json would hold), on seeded weights (Lumina2's bf16
     base, OmniGen2's qfloat8): 0 flash launches every step and denoise step
     (head dims 96 / 120 and the caption mask take the plain attention, as
     in the JAX package); and the omnigen2 generate job at 1024^2, 8 steps,
     with the LoRA it saved;
  9. the hidream LoRA ``sd_trainer`` job at
     1024^2 on an fp8 base with the grouped MoE dispatch, launches per step
     checked (``--profile DIR`` profiles its last step too);
  10. the hidream ``generate`` job at 1024x1024, 8 steps, 2 prompts, with
     the LoRA it saved;
  11. the hidream full fine-tune ``sd_trainer`` job (bf16 base, grouped MoE,
     the expert banks of the first double and single block trained), launches
     per step checked, the untrained weights held against a fresh seeded init
     and the save reloaded;
  12. the flash kernels at the SDXL UNet's shapes (head_dim 64, cross-attention
     over 77 tokens; the cases of phases 2 and 3 include them, with strongly
     negative logits at T = 77), each timed against its plain version and the
     library call, forward and backward;
  13. a full-width SDXL UNet cut to one transformer layer per level, in f32,
     on the card against the same module on the CPU: the forward and one
     checkpointed LoRA training step's loss and gradients;
  14. a full-width SDXL checkpoint written in the HF layout from seeded
     modules (unet/, vae/, text_encoder/, text_encoder_2/), then
     configs/examples/train_lora_sdxl_tpu.yaml as written but for its paths,
     its steps (5) and that checkpoint (ddpm, min_snr_gamma, adamw8bit, EMA,
     no checkpointing, the disk latent cache, a first and a final sample of
     DDIM 25 steps): every loaded tensor's checksum against the written
     one, the cache's files, the samples, the launches of every step and of
     every denoise step (``--profile DIR`` profiles its last step too); then
     the same file to 7 steps, which resumes from step 5 (the optimizer
     state as saved, no latent encoded) and saves at step 7;
  15. the SDXL ``generate`` job at 1024x1024, DDIM 8 steps, guidance 7 as a
     batch of two, 2 prompts, with the kohya LoRA it saved;
  15b. a full-width SD 1.5 checkpoint written as one LDM single file in fp16
     (``v1-5-pruned.safetensors``'s layout), then
     configs/examples/train_textual_inversion_sd15.yaml as written but for its
     paths, its steps (5) and that file: the 4-vector bank trained through
     CLIP inside the step at 512^2, batch 2, the first and final DDIM-25
     samples with it; every loaded tensor against the written one after the
     run, the bank moved, the a1111 file reloaded as [4, 768], 0 flash
     launches every step and denoise step (SD 1.5's 40/80/160-wide heads take
     the plain attention, as in the JAX package);
  15c. the slider and extract jobs on that file: configs/examples/
     train_slider.yaml as written but for its paths and steps (5; rank 8,
     guidance 3, 512^2, ddpm: 0 flash launches), its LoRA moved and saved
     under the JAX job's kohya keys for SD 1.5's 192 modules; configs/
     examples/train_ultimate_slider.yaml over two seeded 512^2 folders whose
     negatives share the positives' file names (batch 2, both losses finite
     and each with a gradient on the LoRA); configs/examples/extract_lora.yaml
     (rank 32, PEFT) on the UNet's 2-D kernels written flat and the same with
     seeded rank-8 deltas on six modules: each delta recovered to 1e-4 of its
     max, no other module written, the float64 SVD's time; the slider block
     of train_slider.yaml on flux-dev cut to FLUX_FAMILY_CUT at 512^2
     (flowmatch, the partial denoise: 60 / 15 / 15 flash launches a train
     step, 15 forwards a denoise step); and a full-width flux-dev DiT cut to
     1 double + 1 single block, f32, batch 2, the LoRA at the per-sample
     multiplier [+1, -1] with recompute on, card vs CPU;
  15d. the four flux files behind a loss or an adapter
     (``refusal_files_phases``): the flash kernels against their plain
     versions and timed at TIPSv2's (1,371 tokens at 12 x 64, a 91-row
     tail; the f32 path too), vision_direct's cross-attention (4,608 queries
     to 1,024 keys) and Redux's joint sequence (4,865 tokens); the tiny
     flux with decoupled K/V and the DFE v7 loss through the tiny decode, and
     a full-width flux-dev 1 + 1 block DiT on an int8 base with a LyCORIS
     LoKr ARA and a trainable LoRA, card vs CPU; then, on flux-dev cut to
     FLUX_FAMILY_CUT and REFUSAL_STEPS (3) each, configs/examples/train_lora_flux_dfe7_tpu.yaml
     on a seeded TIPSv2 b14-DPT written in the reference's layout (39 / 27 /
     27 launches a step; the aux loss's own LoRA gradient norm),
     train_lora_flux_ara_tpu.yaml on a seeded LoRA ARA over the 80 targeted
     Linears (15 / 15 / 15; the int8 base, the deltas untouched, the save
     the trainable LoRA alone), train_redux_adapter_flux_tpu.yaml (the
     seeded ViT-H, its tokens appended; 15 / 15 / 15) and
     train_vision_direct_pixtral_flux_tpu.yaml (the seeded pixtral tower,
     24 forwards an encode; 20 / 19 / 19), each adapter file's keys checked;
  15e. the train-step knobs (``train_knobs_phases``): every optimizer the
     slice ports, 5 steps on flux-dev LoRA-shaped tensors in f32 and bf16,
     card vs CPU; four 3-step flux-dev LoRA jobs at FLUX_FAMILY_CUT and
     512^2 (``KNOB_JOBS``: DOP, blank-prompt preservation and CFG on prodigy,
     75 / 45 / 45 launches a step; a ``mask_path`` dataset with the wavelet
     loss, the inverted-mask prior and the noise knobs on adafactor, 30 / 15
     / 15; the t0 and FFT losses with target-side CFG on automagic, 30 / 15
     / 15; ``loss_target: source`` on muon, 15 / 15 / 15) and the SD 1.5
     ddpm job with ``train_turbo`` and the learnable SNR on the LDM file (0
     launches; ``learnable_snr.json``), each with its knobs on a tiny model
     card vs CPU;
  15f. the networks the JAX trainer builds besides LoRA (``network_phases``):
     LoKr, LoHa, DoRA and LoRM on the Linears of a full-width flux-dev DiT
     cut to 1 + 1 blocks and LoCon on a full-width SD 1.5 resnet +
     transformer, in f32, card vs CPU (forward, loss, gradients); four
     3-step flux-dev jobs at FLUX_FAMILY_CUT and 512^2 (``type: lokr`` with
     ``lokr_factor: -1``, ``loha``, ``dora``, ``lorm`` at ratio 0.25 on the
     double blocks' attention projections; 15 / 15 / 15 launches a step, the
     network moved, the file's keys the JAX job's, the LoHa file read back)
     and the SD 1.5 ``type: locon`` job on the LDM file with
     ``only_if_contains`` reaching the resnets (every conv of the down, mid
     and up blocks trained; 0 launches);
  15g. the input-expansion adapters (``expansion_phases``): the ``ctrl``
     overlay on a full-width flux-dev ``img_in`` (64 and 68 extra channels)
     and a Wan 2.1 ``patch_embedding`` (80, with its bias), in f32, card vs
     CPU; the control_lora job on flux-dev at FLUX_FAMILY_CUT and 512^2 (a
     control image an item, 3 steps, 15 / 15 / 15 launches a step, the
     expansion and the LoRA moved, no LoRA on ``img_in``,
     ``transformer.x_embedder.weight`` [3072, 64] in the file, a sample
     with a ``ctrl_img``), its rerun one step further (the resume restores
     the expansion exactly) and one step of the inpainting input ([3072,
     68]); the i2v adapter job on the Wan 2.1 1.3B t2v base at full width
     and depth (the seeded ViT-H, ``i2v_do_start_frame``, 33 frames at
     480^2, 3 steps, 180 / 90 / 90 launches a step, the graft and the frame
     embedder moved, the base frozen, the file's ``attn_hog.*`` /
     ``image_embedder.*`` / ``frame_embedder.*`` keys and shapes);
  15h. the UNet's two adapter inputs (``adapter_input_phases``): the flash
     forward, dq and dk/dv against their plain versions and timed at the
     IP-Adapter's short K/V (T = 4 and 16 image tokens at SDXL's levels 1
     and 2, T = 16 at flux-dev's 512^2 joint query); a full-width SDXL
     transformer block with its decoupled K/V, the T2I net at SDXL's
     channels and the Resampler at ViT-H width, in f32, card vs CPU; the
     SDXL ``ip_adapter_plus`` job on the SDXL checkpoint (1024^2, the
     seeded ViT-H, 3 steps, 210 / 208 / 208 launches a step, the base
     unchanged, the file's 70 sites; the sample with a ``ctrl_img``
     refused, as the JAX fault decides; a rerun one step further that
     resumes exactly); the SD 1.5 ``ip_adapter`` job on the LDM file; the
     flux-dev ``ip_adapter`` job at FLUX_FAMILY_CUT (16 tokens, 30 / 29 /
     29 a step, a final sample with a ``ctrl_img``); the SD 1.5 ``t2i`` job
     over a control folder and its save; the SD 1.5 LoRA job with that
     save as its assistant, which stays unchanged;
  16. the flash kernels at Wan 2.1's shapes (12 heads of 128, bf16): the
     forward, dq and dk/dv at the train clip's 8,100 tokens, self and across
     to the 512 text tokens (with a ragged tail tile whose lse is below -88),
     the forward at the 81-frame clip's 32,760 tokens, self and cross (its
     first and ragged last Q tiles against the plain version over every key),
     each timed against its plain version (where its f32 logits fit), the
     library call and its bound;
  17. a full-width Wan 2.1 1.3B DiT cut to one block, in f32, on the card
     against the same module on the CPU at a ragged token count: the forward
     and one checkpointed LoRA training step's loss and gradients;
  18. the main path of this slice: the Wan 2.1 1.3B LoRA ``sd_trainer`` job
     from a job file written from configs/examples/train_lora_wan21_tpu.yaml
     (rank 32, adamw, flowmatch with shift timesteps, bf16, 33 frames at 480^2
     = 8,100 tokens, per-block checkpointing) over four seeded MJPG clips
     written with OpenCV, launches per step checked (``--profile DIR``
     profiles its last step too);
  19. the Wan 2.1 1.3B ``generate`` job at 480x832, 81 frames (32,760
     tokens), 8 Euler steps, 1 prompt, with the LoRA it saved, all 81 frames
     decoded at once and written as an animated webp;
  20. the flash kernels against their plain versions at the Wan 2.2 shapes:
     the 14B pair's 40 heads (self at 8,100 tokens, cross to the 512 text
     tokens and to the 257 ViT-H tokens, whose last K/V tile holds one
     valid row) and the TI2V-5B's 24 heads (4,356, 11,440 and 27,280
     tokens), forward, dq and dk/dv where the path trains, with strongly
     negative logits in the tails (lse below -88);
  21. the same shapes timed against the plain version (where its f32 tensors
     fit), the library call and the bound;
  22. a full-width Wan 2.2 14B i2v DiT cut to one block (the image MLP and
     the image K/V), ViT-H cut to 2 layers, and the TI2V-5B VAE on a short
     clip (encode and decode), each in f32 on the card against the CPU;
  23. the main path of this slice: the Wan 2.2 14B i2v LoRA ``sd_trainer``
     job from a job file written from
     configs/examples/train_lora_wan22_14b_tpu.yaml (the expert pair on a
     qfloat8 base, each expert quantized from its own weights, one LoRA on
     both, rank 16, adamw8bit, EMA, flowmatch shift, bf16, 33 frames at
     480^2 with ``do_i2v`` and ``switch_boundary_every: 2``), launches per
     step and the expert of every step checked;
  24. its ``generate`` job at 480^2, 33 frames, 8 Euler steps, a seeded
     first frame (``ctrl_img``), the bf16 pair with the saved LoRA, both
     experts run;
  25. the TI2V-5B LoRA ``sd_trainer`` job from
     configs/examples/train_lora_wan21_tpu.yaml (``arch: wan22_5b``, 33
     frames at 704^2) and 26. its ``generate`` job at 1280x704, 49 frames,
     8 Euler steps, all frames decoded at once;
  27. the audio archs (``audio_phases``): the flash kernels against their
     plain versions and timed at ACE-Step's (12 x 128 over 1,722 tokens,
     self and to 256 text tokens) and LTX-2's shapes (32 x 128 over 1,792
     video tokens; 32 x 64 over 151 audio tokens, to text, and the a2v /
     v2a pairs across 1,792 and 151), with strongly negative logits in the
     151-key, 151-row and 58-row tails; the 1-D WanDiT and the LTX-2 AV
     block at full width cut to one block, in f32, card vs CPU; then
     configs/examples/train_lora_ace_step_audio.yaml as written but for its
     paths and steps over four seeded 10 s wavs written with scipy (one at
     48 kHz, one mono; [1722, 64] latents in the disk cache; 96 / 48 / 48
     launches a step) and configs/examples/train_lora_ltx2_av_tpu.yaml as
     written but for its paths and steps (LTX2_STEPS) at full width and depth (48 joint
     blocks on qfloat8, the bf16 Gemma tower, the mel chain) over four
     seeded 49-frame 512^2 clips with 48 kHz sidecar wavs (one without):
     576 / 288 / 288 launches a step and 288 a denoise step, 151 audio
     tokens, the first and final samples each an animated webp of 49 frames
     with a 48 kHz stereo wav of the length the mel chain gives.
The line before the last is the kernel table; the SDXL, Wan and audio
launches are printed on lines of their own before it; the last line is the result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")

# (B, S, T, H, D), dtype, out tolerance vs the f32 plain version, a fraction of
# max|ref| and never more than that absolute: at T ~ 4600 a typical |out| of
# random inputs is ~0.02 (sqrt(e/T)), so an absolute 2e-2 would pass a wrong
# P.V half; lse (QK^T and the softmax) is held to LSE_TOL absolute
FLASH_CASES = [
    ((1, 4608, 4608, 24, 128), torch.bfloat16, 2e-2),  # flux-dev 1024^2: 512 text + 4096 image
    ((1, 4481, 4481, 24, 128), torch.bfloat16, 2e-2),  # 1008^2: ragged tails
    ((1, 4352, 4352, 20, 128), torch.bfloat16, 2e-2),  # hidream 1024^2: 256 text + 4096 image
    ((2, 300, 190, 4, 64), torch.bfloat16, 2e-2),  # S != T, both ragged, D=64
    ((2, 190, 300, 4, 128), torch.bfloat16, 2e-2),  # S < T
    ((1, 16, 16, 2, 128), torch.bfloat16, 2e-2),  # smaller than one tile
    ((1, 16, 16, 2, 64), torch.bfloat16, 2e-2),
    ((2, 300, 190, 4, 64), torch.float32, 1e-4),  # rect, ragged, D=64
    ((1, 16, 16, 2, 128), torch.float32, 1e-4),  # smaller than one tile
]
# the SDXL UNet's attention at 1024^2 (head_dim 64): level-1 (4096 tokens, 10
# heads) and level-2 (1024 tokens, 20 heads) self-attention, their
# cross-attention over the 77 text tokens (fewer than one 128-column tile),
# and the level-1 cross-attention of the CFG batch of two
SDXL_SHAPES = [
    ((1, 4096, 4096, 10, 64), "level-1 self"),
    ((1, 4096, 77, 10, 64), "level-1 cross"),
    ((1, 1024, 1024, 20, 64), "level-2 self"),
    ((1, 1024, 77, 20, 64), "level-2 cross"),
    ((2, 4096, 77, 10, 64), "level-1 cross, CFG batch"),
]
FLASH_CASES += [(shape, torch.bfloat16, 2e-2) for shape, _ in SDXL_SHAPES]
# Wan 2.1 1.3B (12 heads of 128): 33 frames at 480^2 train on 9 x 30 x 30 = 8,100
# tokens (63 * 128 + 36); the 81-frame 480x832 clip samples 21 x 30 x 52 = 32,760
# (255 * 128 + 120); cross-attention over the 512 UMT5 tokens. (shape, label,
# backward and plain version timed: the plain version's f32 logits at 32,760 x
# 32,760 x 12 heads would take 51 GB)
WAN_SHAPES = [
    ((1, 8100, 8100, 12, 128), "train self", True),
    ((1, 8100, 512, 12, 128), "train cross", True),
    ((1, 32760, 32760, 12, 128), "generate self", False),
    ((1, 32760, 512, 12, 128), "generate cross", False),
]
WAN_BLOCKS = 30  # one self- and one cross-attention each
WAN_CLIPS, WAN_FRAMES, WAN_RES = 4, 33, 480
WAN_GEN = (832, 480, 81, 8)  # width, height, frames, Euler steps
# the rest of slice E: the Wan 2.2 14B i2v pair (40 heads of 128) trains 33 frames
# at 480^2, 9 x 30 x 30 = 8,100 tokens, with cross-attention to the 512 UMT5 tokens
# and to the 257 ViT-H tokens (2 * 128 + 1: a K/V tail tile of one valid row); the
# TI2V-5B (24 heads) trains 33 frames at 704^2, 9 x 22 x 22 = 4,356 (34 * 128 + 4),
# samples 49 frames at 1280x704, 13 x 22 x 40 = 11,440 (89 * 128 + 48), and its
# published 121-frame clip would be 31 x 22 x 40 = 27,280 (213 * 128 + 16).
# (shape, label, backward checked and timed)
WAN22_SHAPES = [
    ((1, 8100, 8100, 40, 128), "14B train self", True),
    ((1, 8100, 512, 40, 128), "14B train text cross", True),
    ((1, 8100, 257, 40, 128), "14B train image cross", True),
    ((1, 4356, 4356, 24, 128), "5B train self", True),
    ((1, 4356, 512, 24, 128), "5B train cross", True),
    ((1, 11440, 11440, 24, 128), "5B generate self", False),
    ((1, 11440, 512, 24, 128), "5B generate cross", False),
    ((1, 27280, 27280, 24, 128), "5B 121-frame self", False),
]
# q + shift, k - shift: every lse near -106, the ragged tails' too (the T = 257 one-row tile)
WAN22_NEGATIVE = [((1, 8100, 257, 40, 128), "14B image cross, negative logits"),
                  ((1, 4356, 4356, 24, 128), "5B self, negative logits")]
WAN14_BLOCKS, WAN5_BLOCKS = 40, 30  # three attentions each (self, text, image), two (self, text)
WAN5_RES = 704
WAN5_GEN = (1280, 704, 49, 8)  # width, height, frames, Euler steps
PLAIN_BUDGET = 48 * 2**30  # bytes of f32 [B, H, S, T] tensors a plain version may hold at once
HEAD_CHUNK = 8  # heads per plain-version call in the checks
LSE_TOL = 1e-3
MAIN_SHAPE = (1, 4608, 24, 128)
RAGGED_SHAPE = (1, 4481, 24, 128)  # flux-dev at 1008^2: 512 text + 3969 image tokens, masked tails
HIDREAM_SHAPE = (1, 4352, 20, 128)  # hidream at 1024^2: 256 text + 4096 image tokens
TIMED_SHAPES = [("main", MAIN_SHAPE), ("ragged", RAGGED_SHAPE), ("hidream", HIDREAM_SHAPE)]
# the kernels redesigned for Hopper (wgmma, TMA): their compiler reports are printed
# (the MoE passes' first template argument is the mode of csrc/moe_gmm_tile.cuh:
# 0 GATE_UP, 1 DOWN, 2 DX_HIDDEN, 3 DX_OUT, 4 DW_HIDDEN; the last, the tile width)
SM90_KERNELS = ("flash_fwd_sm90", "flash_bwd_dkv_sm90", "flash_bwd_dq_sm90", "moe_hidden_sm90",
                "moe_out_sm90", "moe_dw_sm90")
SM90_LIBRARIES = ("flash_attention_fwd", "flash_attention_bwd", "moe_gmm_fwd", "moe_gmm_bwd", "moe_gmm_dw")
BLOCKS_PER_FORWARD = 19 + 38  # flux-dev double + single blocks, one attention each
# backward: (B, S, T, H, D), dtype, tolerance on max|dX - ref| / max|ref| for dq, dk, dv:
# bf16 inputs with p and ds rounded to bf16 before the second products (f32
# accumulation) leave ~4e-3; f32 differs from the f32 plain version by summation order only
BWD_CASES = [
    ((1, 4608, 4608, 24, 128), torch.bfloat16, 2e-2),
    ((1, 4481, 4481, 24, 128), torch.bfloat16, 2e-2),
    ((1, 4352, 4352, 20, 128), torch.bfloat16, 2e-2),  # hidream
    ((2, 300, 190, 4, 64), torch.bfloat16, 2e-2),
    ((2, 190, 300, 4, 128), torch.bfloat16, 2e-2),
    ((1, 16, 16, 2, 128), torch.bfloat16, 2e-2),
    ((1, 16, 16, 2, 64), torch.bfloat16, 2e-2),
    ((2, 300, 190, 4, 64), torch.float32, 1e-4),
    ((1, 16, 16, 2, 128), torch.float32, 1e-4),
]
BWD_CASES += [(shape, torch.bfloat16, 2e-2) for shape, _ in SDXL_SHAPES]
# logits near -116 (q shifted by +SHIFT, k by -SHIFT: -SHIFT^2 * sqrt(D)), so lse
# ~ -106: dq's p of a zero-filled K row past T would be exp(-lse) = inf, a NaN
# unless masked (T = 190 ragged; T = 77, the SDXL cross-attention, inside one tile)
NEGATIVE_CASES = [((2, 300, 190, 4, 128), 3.2), ((2, 1024, 77, 20, 64), 3.8)]
# q, k, v as views of a fused projection [B, S, 3*H*D + extra] from element
# `start` on: ((B, S, H, D), extra, start, bf16 inputs TMA must copy)
FUSED_VIEWS = [
    ((2, 200, 4, 128), 0, 0, 0),  # the double blocks' fused qkv
    ((1, 1100, 24, 128), 4 * 3072, 0, 0),  # the single blocks' linear1 output
    ((2, 200, 4, 64), 1, 1, 3),  # no TMA view: q, k, v copied
]
# grouped SwiGLU: (tokens, d, h, experts), dtype, tolerance on max|out - ref| / max|ref|
# for the forward and dx against the f32 plain version, the expert that gets no
# token (or None); a real top-2 routing of random activations. bf16 rounds the
# SwiGLU activation (forward) and dh1/dh3 (dx) to bf16 between the two GEMMs
# (f32 accumulation); f32 differs from the plain version by summation order only
MOE_CASES = [
    ((4096, 2560, 6912, 4), torch.bfloat16, 2e-2, None),  # double block: 4096 image tokens x top-2
    ((4352, 2560, 6912, 4), torch.bfloat16, 2e-2, None),  # single block: 256 text + 4096 image
    ((1000, 2560, 6912, 4), torch.bfloat16, 2e-2, 3),  # ragged, expert 3 gets no token
    ((100, 64, 128, 3), torch.float32, 1e-4, None),
]
KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "moe_gmm_fwd", "moe_gmm_bwd", "moe_gmm_dw")
HIDREAM_BLOCKS = 16 + 32  # double + single blocks: one attention and one MoE FFN each
# the SDXL UNet's transformer blocks, two attentions each: down 2 x 2 + 2 x 10, mid 10, up 3 x 10 + 3 x 2
SDXL_ATTENTIONS = 2 * (2 * 2 + 2 * 10 + 10 + 3 * 10 + 3 * 2)
SDXL_CUT_BLOCKS = 1 + 1 + 1 + 2 + 2  # unet_reference's cut: one layer per level, one block per attention
# the full fine-tune's filter: the expert banks of the first double and single block
FT_BANKS = ["double_blocks.0.img_mlp.experts", "single_blocks.0.mlp.experts"]
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
TRAIN_WARMUP = 2
TRAIN_TIMED = 3


_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"\n== {name} [{time.perf_counter() - _T0:.1f} s into the script]", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def environment() -> str:
    phase("environment")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ai_toolkit_tpu_torch.ops.kernels import build

    cached = {name: build.library_path(name).is_file() for name in KERNELS}
    t0 = time.perf_counter()
    times = build.build_all(list(KERNELS), verbose=True)
    for name in KERNELS:
        print(f"kernel build: {name} {times[name]:.2f} s"
              f"{' (library already built from these sources)' if cached[name] else ''}")
    print(f"kernel builds in parallel: {time.perf_counter() - t0:.2f} s wall")
    for name in SM90_LIBRARIES:
        report = build.report(name)
        if report is None:
            print(f"ptxas -v: {name}: no report kept beside the library (built without one)")
        for line in _ptxas_summary(report or ""):
            print(f"ptxas -v: {line}")
    return smi.splitlines()[0]


def _ptxas_summary(report: str) -> list[str]:
    """Registers, shared memory and spills of the wgmma kernels (SM90_KERNELS)
    from a ``-Xptxas -v`` report, one line per instantiation."""
    out, kernel = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in SM90_KERNELS if k in line), None)
            if kernel is not None:  # the template arguments: D, or (mode, tile width)
                args = re.findall(r"Li(\d+)E", line.split(kernel, 1)[1])
                out.append(f"{kernel}<{', '.join(args) or '?'}>:")
        elif kernel is not None and ("registers" in line or "spill" in line):
            out[-1] += " " + line.split(":", 1)[-1].strip().rstrip(",") + ";"
    return out


def _rand(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def _time_ms(fn, reps: int, inner: int = 10) -> list[float]:
    """``reps`` samples of the device time of one call of ``fn``: CUDA events
    around ``inner`` calls back to back, divided by ``inner``, so that the
    host's time to launch a call hides behind the device's work on the
    previous one (a sub-millisecond kernel timed alone also times its launch)."""
    out = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) / inner)
    return out


def _device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` with the host out of the way: a sleep
    kernel holds the stream while the host enqueues ``reps`` calls, so the
    events around them time the calls back to back on the card, where a
    call's host work (the wrapper, the tensor maps) outlasts its kernels and
    :func:`_time_ms` times the host. Median of 5."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(5):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's clock: longer than enqueueing the calls
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) / reps)
    return statistics.median(out)


def _in_turns(kern, plain, reps: int = 10) -> tuple[float, float, int]:
    """Medians (kernel ms, plain ms) over plain, kernel, kernel, plain runs of
    ``reps`` samples each, after a warm-up of each; the plain versions (10 ms
    and more a call) are timed one call a sample."""
    for f in (kern, plain):
        _time_ms(f, 2, 1)
    p = _time_ms(plain, reps, 1)
    kt = _time_ms(kern, reps)
    kt += _time_ms(kern, reps)
    p += _time_ms(plain, reps, 1)
    return statistics.median(kt), statistics.median(p), len(kt)


def _bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time on the card: the larger of the bf16 tensor-core time and the
    HBM time; and which of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _sdpa_layout(*xs):
    """[B,S,H,D] -> contiguous [B,H,S,D] copies for scaled_dot_product_attention."""
    return [x.transpose(1, 2).contiguous() for x in xs]


def _sdpa_bwd_ms(q, k, v, g, device_only: bool = False) -> float:
    """The library yardstick of the backward kernels: one scaled_dot_product_attention
    backward, which gives dq, dk and dv (``device_only``: timed by :func:`_device_ms`)."""
    qt, kt, vt, gt = _sdpa_layout(q, k, v, g)
    qt, kt, vt = (x.requires_grad_() for x in (qt, kt, vt))
    ot = F.scaled_dot_product_attention(qt, kt, vt)
    call = lambda: torch.autograd.grad(ot, (qt, kt, vt), gt, retain_graph=True)  # noqa: E731
    if device_only:
        return _device_ms(call)
    return statistics.median(_time_ms(call, 20))


def _negative_qkv(shape, shift, gen):
    """bf16 q + shift, k - shift, v: logits near -shift^2 sqrt(D)."""
    b, s, t, h, d = shape
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda") for n in (s, t, t))
    return (q + shift).bfloat16(), (k - shift).bfloat16(), v.bfloat16()


def _check_negative(j: int, lse: torch.Tensor) -> None:
    """The ``j``-th of NEGATIVE_CASES (if ``j`` is one) really has strongly
    negative logits: most rows' lse below -88, where exp(-lse) overflows f32."""
    if 0 <= j < len(NEGATIVE_CASES):
        check(lse.median().item() < -88.0, f"negative case {NEGATIVE_CASES[j]}: median lse "
                                           f"{lse.median().item():.1f} is not below -88")


def _fused_qkv(b, s, h, d, extra, start, gen):
    """q, k, v as views of one fused bf16 projection ``[B, S, 3*H*D + extra]``."""
    fused = _rand((b, s, 3 * h * d + extra), torch.bfloat16, gen)
    return fused[..., start:start + 3 * h * d].unflatten(-1, (3, h, d)).unbind(2)


def kernel_vs_plain() -> dict:
    phase("flash_attention_fwd kernel vs plain version")
    from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(0)
    max_err = 0.0
    cases = [(shape, dt, tol, None, 0) for shape, dt, tol in FLASH_CASES]
    cases += [(shape, torch.bfloat16, 2e-2, _negative_qkv(shape, shift, gen), 0) for shape, shift in NEGATIVE_CASES]
    for (b, s, h, d), extra, start, copies in FUSED_VIEWS:
        cases.append(((b, s, s, h, d), torch.bfloat16, 2e-2, _fused_qkv(b, s, h, d, extra, start, gen), copies))
    for i, ((b, s, t, h, d), dt, tol, qkv, copies) in enumerate(cases):
        q, k, v = qkv if qkv is not None else (
            _rand((b, s, h, d), dt, gen), _rand((b, t, h, d), dt, gen), _rand((b, t, h, d), dt, gen))
        before = fa.tma_copies
        out, lse = fa.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float())
        err = (out.float() - ref_out).abs().max().item()
        ref_max = ref_out.abs().max().item()
        out_tol = tol * min(1.0, ref_max)
        lse_err = (lse - ref_lse).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        print(f"(B,S,T,H,D)=({b},{s},{t},{h},{d}) {str(dt)[6:]} v_stride={tuple(v.stride())} "
              f"out_err={err:.3e} (max|ref| {ref_max:.3e}, tol {out_tol:.3e}) lse_err={lse_err:.3e} "
              f"(tol {LSE_TOL:g}) min lse {ref_lse.min().item():.1f} TMA copies {fa.tma_copies - before}")
        check(finite and err <= out_tol and lse_err <= LSE_TOL, "kernel disagrees with its plain version")
        check(fa.tma_copies - before == copies, f"{fa.tma_copies - before} TMA copies, expected {copies}")
        _check_negative(i - len(FLASH_CASES), ref_lse)
        max_err = max(max_err, err)

    res = {}
    for label, shape in TIMED_SHAPES:
        q, k, v = (_rand(shape, torch.bfloat16, gen) for _ in range(3))
        ms, plain_ms, n = _in_turns(lambda: fa.flash_attention_fwd(q, k, v),
                                    lambda: fa.flash_attention_fwd_plain(q, k, v))
        qt, kt, vt = _sdpa_layout(q, k, v)
        library_ms = statistics.median(_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20))
        b, s, h, d = shape
        flops = 4 * b * s * s * h * d  # two products; q, k, v in and out out in bf16, lse in f32
        bound, by = _bound_ms(flops, 2 * 4 * b * s * h * d + 4 * b * h * s)
        print(f"{label} shape {shape} bf16: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
              f"plain {plain_ms:.4f} ms, median of {n}; library scaled_dot_product_attention "
              f"{library_ms:.4f} ms ({flops / library_ms / 1e9:.1f} TFLOP/s); kernel / library "
              f"{ms / library_ms:.2f}x; bound {bound:.4f} ms ({by})")
        res[label] = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound, "bound_by": by}
        del q, k, v, qt, kt, vt
    return res["main"]


def bwd_kernels_vs_plain() -> dict:
    phase("flash_attention_bwd dq and dk/dv kernels vs plain versions")
    from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(1)
    cases = [(shape, dt, tol, None, 0) for shape, dt, tol in BWD_CASES]
    cases += [(shape, torch.bfloat16, 2e-2, _negative_qkv(shape, shift, gen), 0) for shape, shift in NEGATIVE_CASES]
    for (b, s, h, d), extra, start, copies in FUSED_VIEWS:
        cases.append(((b, s, s, h, d), torch.bfloat16, 2e-2, _fused_qkv(b, s, h, d, extra, start, gen), copies))
    err = {"dq": 0.0, "dkv": 0.0}
    for i, ((b, s, t, h, d), dt, tol, qkv, copies) in enumerate(cases):
        q, k, v = qkv if qkv is not None else (
            _rand((b, s, h, d), dt, gen), _rand((b, t, h, d), dt, gen), _rand((b, t, h, d), dt, gen))
        g = _rand((b, s, h, d), dt, gen)
        out, lse = fa.flash_attention_fwd(q, k, v)
        before = fa.tma_copies
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, g)
        torch.cuda.synchronize()
        refs = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse, g.float())
        rel, absd = [], []
        for x, r in zip((dq, dk, dv), refs):
            a = (x.float() - r).abs().max().item()
            absd.append(a)
            rel.append(a / r.abs().max().item())
        finite = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
        print(f"(B,S,T,H,D)=({b},{s},{t},{h},{d}) {str(dt)[6:]} q_stride={tuple(q.stride())} "
              f"rel err dq/dk/dv = {rel[0]:.3e}/{rel[1]:.3e}/{rel[2]:.3e} (tol {tol:g}); "
              f"max abs {absd[0]:.3e}/{absd[1]:.3e}/{absd[2]:.3e}; min lse {lse.min().item():.1f}; "
              f"TMA copies {fa.tma_copies - before}")
        check(finite and max(rel) <= tol, "backward kernels disagree with their plain versions")
        _check_negative(i - len(BWD_CASES), lse)
        # dq and dk/dv each copy the q, k, v that TMA cannot read (dO is contiguous)
        check(fa.tma_copies - before == 2 * copies, f"{fa.tma_copies - before} TMA copies, expected {2 * copies}")
        err["dq"] = max(err["dq"], absd[0])
        err["dkv"] = max(err["dkv"], absd[1], absd[2])
        del refs
        torch.cuda.empty_cache()

    res = {}
    for label, shape in TIMED_SHAPES:
        b, s, h, d = shape
        q, k, v, g = (_rand(shape, torch.bfloat16, gen) for _ in range(4))
        scale = d ** -0.5
        out, lse = fa.flash_attention_fwd(q, k, v)
        delta = fa.flash_attention_bwd_delta(out, g)
        if label == "main":  # one owner per tile, no atomics: the same bits from run to run
            runs = [(fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, scale),
                     *fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale)) for _ in range(2)]
            check(all(torch.equal(x, y) for x, y in zip(*runs)), "dq or dk/dv differs from run to run")
            print("main shape: dq, dk and dv the same bits in two runs")
            del runs
        lib_bwd = _sdpa_bwd_ms(q, k, v, g)
        for name, kern, plain, ops, tensors in (  # operations per B*H*S*T*D; [B,S,H,D] tensors in and out
            ("dq", lambda: fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, scale),
             lambda: fa.flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, scale), 6, 5),  # q k v dO in, dq out
            ("dkv", lambda: fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale),
             lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta, scale), 8, 6),  # dk dv out
        ):
            ms, plain_ms, n = _in_turns(kern, plain)
            flops = ops * b * h * s * s * d
            bound, by = _bound_ms(flops, 2 * tensors * b * s * h * d + 8 * b * h * s)
            print(f"{label} shape {shape} bf16 {name}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                  f"{ops}*B*H*S*T*D = {flops:.4e} operations), plain {plain_ms:.4f} ms, median of {n}; "
                  f"kernel / library backward ({10 * b * h * s * s * d:.4e} operations) "
                  f"{ms / lib_bwd:.2f}x; bound {bound:.4f} ms ({by}; the kernel at {100 * bound / ms:.1f} % "
                  f"of its rate)")
            if label == "main":
                res[name] = {"max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                             "bound_by": by, "library_ms": lib_bwd}
        flops = 10 * b * h * s * s * d
        print(f"{label} shape: library scaled_dot_product_attention backward (dq, dk, dv) {lib_bwd:.4f} ms "
              f"({flops / lib_bwd / 1e9:.1f} TFLOP/s of 10*B*H*S*T*D = {flops:.4e} operations; bound "
              f"{flops / PEAK_BF16_FLOPS * 1e3:.4f} ms)")
        if label == "main":
            qt, kt, vt, gt = _sdpa_layout(q, k, v, g)
            qt, kt, vt = (x.requires_grad_() for x in (qt, kt, vt))
            lib_fb = statistics.median(_time_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(qt, kt, vt), (qt, kt, vt), gt), 20))
            print(f"main shape: library forward+backward {lib_fb:.4f} ms; kernels dq+dkv "
                  f"{res['dq']['ms'] + res['dkv']['ms']:.4f} ms")
            del qt, kt, vt, gt
        del q, k, v, g, out, lse, delta
        torch.cuda.empty_cache()
    return res


def _routed_rows(n_tok, d, e, dtype, gen, empty=None):
    """Expert-sorted rows of a top-2 routing of random activations, as the
    MoE FFN's dispatch builds them: (x_sorted, tile_group, routed row count)."""
    from ai_toolkit_tpu_torch.ops.kernels import moe_gmm

    x = _rand((n_tok, d), dtype, gen)
    logits = torch.randn((n_tok, e), generator=gen, device="cuda")
    if empty is not None:
        logits[:, empty] = -30.0
    _, topi = torch.topk(torch.softmax(logits, -1), 2)
    x_sorted, tile_group, _ = moe_gmm.dispatch_rows(x, topi, e)
    return x_sorted, tile_group, topi.numel()


def moe_kernels_vs_plain() -> dict:
    phase("moe_gmm forward, dx and dw kernels vs plain versions")
    from ai_toolkit_tpu_torch.ops.kernels import moe_gmm

    gen = torch.Generator("cuda").manual_seed(2)
    err = {"moe": 0.0, "moe_dx": 0.0, "moe_dw": 0.0}
    for (n_tok, d, h, e), dt, tol, empty in MOE_CASES:
        banks = [(torch.randn(s, generator=gen, device="cuda") * s[1] ** -0.5).to(dt)
                 for s in ((e, d, h), (e, d, h), (e, h, d))]
        xs, tg, n = _routed_rows(n_tok, d, e, dt, gen, empty)
        dy = _rand(xs.shape, dt, gen)
        y = moe_gmm.grouped_swiglu(xs, *banks, tg)
        dx = moe_gmm.grouped_swiglu_dx(xs, dy, *banks, tg, moe_gmm.BLOCK_M)
        torch.cuda.synchronize()
        rel, absd = [], []
        for name, out, ref in (
                ("moe", y, moe_gmm.grouped_swiglu_plain(xs.float(), *banks, tg, moe_gmm.BLOCK_M)),
                ("moe_dx", dx, moe_gmm.grouped_swiglu_dx_plain(xs.float(), dy.float(), *banks, tg,
                                                              moe_gmm.BLOCK_M))):
            check(out.dtype == dt and bool(torch.isfinite(out).all()), f"{name} output not finite")
            a = (out.float() - ref).abs().max().item()
            absd.append(a)
            rel.append(a / ref.abs().max().item())
            err[name] = max(err[name], a)
        groups = torch.bincount(tg.long(), minlength=e).tolist()
        print(f"(tokens,d,h,E)=({n_tok},{d},{h},{e}) {str(dt)[6:]} routed rows {n} -> {xs.shape[0]} "
              f"(tiles per expert {groups}) rel err fwd/dx = {rel[0]:.3e}/{rel[1]:.3e} (tol {tol:g}); "
              f"max abs {absd[0]:.3e}/{absd[1]:.3e}")
        check(max(rel) <= tol, "the MoE kernels disagree with their plain versions")
        # the hidden pass dw shares (DW_HIDDEN): dh = [dh1 | dh3] and act against the plain
        # intermediates; y, dx, dh and act the same bits from run to run (one owner per tile)
        dh, act = moe_gmm.grouped_swiglu_hidden(xs, dy, *banks, tg, moe_gmm.BLOCK_M)
        again = (moe_gmm.grouped_swiglu(xs, *banks, tg),
                 moe_gmm.grouped_swiglu_dx(xs, dy, *banks, tg, moe_gmm.BLOCK_M),
                 *moe_gmm.grouped_swiglu_hidden(xs, dy, *banks, tg, moe_gmm.BLOCK_M))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((y, dx, dh, act), again)), "MoE y, dx, dh or act differs "
                                                                               "from run to run")
        rel_h = []
        for name, got, ref in zip(("dh", "act"), (dh, act), moe_gmm.grouped_swiglu_hidden_plain(
                xs.float(), dy.float(), *banks, tg, moe_gmm.BLOCK_M)):
            check(got.dtype == dt and bool(torch.isfinite(got).all()), f"{name} not finite")
            rel_h.append((got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item())
        print(f"  hidden pass (DW_HIDDEN) rel err dh/act = {rel_h[0]:.3e}/{rel_h[1]:.3e} (tol {tol:g}); "
              f"y, dx, dh and act the same bits in two runs")
        check(max(rel_h) <= tol, "the hidden pass disagrees with its plain version")
        del y, dx, dh, act, again
        # the bank gradients, each against the f32 plain version (f32 banks: an f32 result)
        dws = moe_gmm.grouped_swiglu_dw(xs, dy, *banks, tg, moe_gmm.BLOCK_M)
        again = moe_gmm.grouped_swiglu_dw(xs, dy, *banks, tg, moe_gmm.BLOCK_M)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(dws, again)), "MoE dW differs from run to run")
        del again
        refs = moe_gmm.grouped_swiglu_dw_plain(xs.float(), dy.float(), *(b.float() for b in banks), tg,
                                               moe_gmm.BLOCK_M)
        rel_dw = []
        for name, got, ref in zip(("dw1", "dw3", "dw2"), dws, refs):
            check(got.dtype == dt and got.shape == ref.shape and bool(torch.isfinite(got).all()),
                  f"{name} not finite or of the wrong type")
            a = (got.float() - ref).abs().max().item()
            rel_dw.append(a / ref.abs().max().item())
            err["moe_dw"] = max(err["moe_dw"], a)
            check(empty is None or not got[empty].any(), f"{name} of the empty expert is not zero")
        print(f"  dw rel err dw1/dw3/dw2 = {rel_dw[0]:.3e}/{rel_dw[1]:.3e}/{rel_dw[2]:.3e} (tol {tol:g}), "
              f"the same bits in two runs{'; the empty expert gets zeros' if empty is not None else ''}")
        check(max(rel_dw) <= tol, "the dw kernel disagrees with its plain version")
        del banks, xs, dy, dws, refs
        torch.cuda.empty_cache()

    # timing at the double-block shape
    (n_tok, d, h, e), dt = MOE_CASES[0][:2]
    banks = [(torch.randn(s, generator=gen, device="cuda") * s[1] ** -0.5).to(dt)
             for s in ((e, d, h), (e, d, h), (e, h, d))]
    w1, w3, w2 = banks
    xs, tg, n = _routed_rows(n_tok, d, e, dt, gen)
    dy = _rand(xs.shape, dt, gen)
    # the library yardstick: one cuBLAS product sequence per expert over the
    # same sorted rows (its padding rows included), its autograd for dx
    runs = [(g, r0, r1) for g, r0, r1 in moe_gmm.expert_runs(tg, moe_gmm.BLOCK_M)]
    xr = xs.detach().requires_grad_()
    parts = [xr[r0:r1] for _, r0, r1 in runs]

    def library():
        return [(F.silu(xp @ w1[g]) * (xp @ w3[g])) @ w2[g] for xp, (g, _, _) in zip(parts, runs)]

    @torch.no_grad()
    def library_fwd():
        return library()

    lib_out = library()
    # the weight-gradient yardstick: the same product sequence's autograd for W1, W3 and W2
    wr = [w.detach().requires_grad_() for w in banks]
    lib_out_w = [(F.silu(xs[r0:r1] @ wr[0][g]) * (xs[r0:r1] @ wr[1][g])) @ wr[2][g] for g, r0, r1 in runs]
    res = {}
    for name, kern, plain, lib, flops, nbytes in (
        ("moe", lambda: moe_gmm.grouped_swiglu(xs, w1, w3, w2, tg),
         lambda: moe_gmm.grouped_swiglu_plain(xs, w1, w3, w2, tg, moe_gmm.BLOCK_M), library_fwd,
         6 * n * d * h, 2 * (3 * e * d * h + 2 * n * d)),  # banks, x in, y out
        ("moe_dx", lambda: moe_gmm.grouped_swiglu_dx(xs, dy, w1, w3, w2, tg, moe_gmm.BLOCK_M),
         lambda: moe_gmm.grouped_swiglu_dx_plain(xs, dy, w1, w3, w2, tg, moe_gmm.BLOCK_M),
         lambda: torch.autograd.grad(lib_out, xr, [dy[r0:r1] for _, r0, r1 in runs], retain_graph=True),
         10 * n * d * h, 2 * (3 * e * d * h + 3 * n * d)),  # banks, x and dy in, dx out
        # the hidden pass alone (DW_HIDDEN: h1, h3, dp, then dh and act), dw's share of dx's first pass
        ("moe_hidden", lambda: moe_gmm.grouped_swiglu_hidden(xs, dy, w1, w3, w2, tg, moe_gmm.BLOCK_M),
         lambda: moe_gmm.grouped_swiglu_hidden_plain(xs, dy, w1, w3, w2, tg, moe_gmm.BLOCK_M), None,
         6 * n * d * h, 2 * (3 * e * d * h + 2 * n * d + 3 * n * h)),  # banks, x, dy in; dh, act out
        # dw from x and dy: its first pass (h1, h3, dp) and the products, 12 N d h
        ("moe_dw", lambda: moe_gmm.grouped_swiglu_dw(xs, dy, w1, w3, w2, tg, moe_gmm.BLOCK_M),
         lambda: moe_gmm.grouped_swiglu_dw_plain(xs, dy, w1, w3, w2, tg, moe_gmm.BLOCK_M),
         lambda: torch.autograd.grad(lib_out_w, wr, [dy[r0:r1] for _, r0, r1 in runs], retain_graph=True),
         12 * n * d * h, 2 * (6 * e * d * h + 2 * n * d)),  # banks, x and dy in, dW1 dW3 dW2 out
    ):
        ms, plain_ms, reps = _in_turns(kern, plain)
        library_ms = statistics.median(_time_ms(lib, 20)) if lib else None
        bound, by = _bound_ms(flops, nbytes)
        res[name] = {"max_abs_err": err.get(name), "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound, "bound_by": by}
        # what the library call computes: the forward's 6 N d h; its autograd keeps h1 and h3
        # (no recompute): 6 N d h for x, 8 N d h for W1, W3 and W2
        lib_ops = {"moe": (6, ""), "moe_dx": (6, ", h1 and h3 saved"), "moe_dw": (8, ", h1 and h3 saved")}
        library = (f"library per-expert cuBLAS {library_ms:.4f} ms ({lib_ops[name][0]}*N*d*h = "
                   f"{lib_ops[name][0] * n * d * h:.4e} operations{lib_ops[name][1]})" if lib else
                   "no library call computes it alone")
        print(f"double-block shape ({n_tok} tokens x top-2 = {n} rows, d {d}, h {h}, E {e}) bf16 {name}: "
              f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of {flops:.4e} operations), plain "
              f"{plain_ms:.4f} ms, median of {reps}; {library}; bound {bound:.4f} ms ({by}; the kernel at "
              f"{100 * bound / ms:.1f} % of its rate)")
    # the forward's passes alone: GATE_UP (x -> act, 4 N d h) and DOWN (act -> y, 2 N d h)
    act, _ = moe_gmm._launch_fwd(xs, w1, w3, w2, tg, moe_gmm.BLOCK_M, down=False)
    for name, kern, flops, nbytes in (
        ("GATE_UP", lambda: moe_gmm._launch_fwd(xs, w1, w3, w2, tg, moe_gmm.BLOCK_M, down=False),
         4 * n * d * h, 2 * (2 * e * d * h + n * d + n * h)),  # W1, W3, x in; act out
        ("DOWN", lambda: moe_gmm._launch_fwd(xs, w1, w3, w2, tg, moe_gmm.BLOCK_M, act=act),
         2 * n * d * h, 2 * (e * d * h + n * h + n * d)),  # W2, act in; y out
    ):
        ms = statistics.median(_time_ms(kern, 20))
        bound, by = _bound_ms(flops, nbytes)
        print(f"forward pass {name} alone: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of {flops:.4e} "
              f"operations), bound {bound:.4f} ms ({by}; the pass at {100 * bound / ms:.1f} % of its rate)")
    # the dw products alone, as the backward runs them beside dx on the first pass's dh and act;
    # their library yardstick: per expert, x_g^T dh_g and act_g^T dy_g, two cuBLAS calls over the
    # same sorted rows
    dh = _rand((xs.shape[0], 2 * h), dt, gen)
    prod_ms = statistics.median(_time_ms(lambda: moe_gmm._launch_dw_products(xs, dy, dh, act, tg, e), 20))
    prod_lib_ms = statistics.median(_time_ms(
        lambda: [(xs[r0:r1].t() @ dh[r0:r1], act[r0:r1].t() @ dy[r0:r1]) for _, r0, r1 in runs], 20))
    prod_bound, prod_by = _bound_ms(6 * n * d * h, 2 * (2 * n * d + 3 * n * h + 3 * e * d * h))
    print(f"dw products alone ([dW1 | dW3] = x^T dh, dW2 = act^T dy on a given dh and act): "
          f"{prod_ms:.4f} ms ({6 * n * d * h / prod_ms / 1e9:.1f} TFLOP/s), bound {prod_bound:.4f} ms "
          f"({prod_by}; the products at {100 * prod_bound / prod_ms:.1f} % of their rate); library per-expert "
          f"cuBLAS x^T dh, act^T dy {prod_lib_ms:.4f} ms ({6 * n * d * h / prod_lib_ms / 1e9:.1f} TFLOP/s); "
          f"kernel / library {prod_ms / prod_lib_ms:.2f}x")
    del dh, act, wr, lib_out_w
    xt = _rand((n_tok, d), dt, gen)
    dense_ms = statistics.median(_time_ms(lambda: torch.einsum(
        "esh,ehd->esd", F.silu(torch.einsum("sd,edh->esh", xt, w1)) * torch.einsum("sd,edh->esh", xt, w3),
        w2), 10))
    print(f"for information: the dense dispatch (every expert on all {n_tok} tokens, cuBLAS) "
          f"{dense_ms:.4f} ms; the grouped forward kernel {res['moe']['ms']:.4f} ms "
          f"({res['moe']['ms'] / dense_ms:.2f}x the dense dispatch)")
    del banks, w1, w3, w2, xs, dy, xr, parts, lib_out
    torch.cuda.empty_cache()
    return res


def _reset_launches() -> None:
    from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa
    from ai_toolkit_tpu_torch.ops.kernels import moe_gmm

    fa.launches = fa.dq_launches = fa.dkv_launches = fa.tma_copies = 0
    moe_gmm.launches = moe_gmm.dx_launches = moe_gmm.dw_launches = 0


def _launches() -> dict[str, int]:
    from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa
    from ai_toolkit_tpu_torch.ops.kernels import moe_gmm

    return {"fwd": fa.launches, "dq": fa.dq_launches, "dkv": fa.dkv_launches,
            "moe": moe_gmm.launches, "moe_dx": moe_gmm.dx_launches, "moe_dw": moe_gmm.dw_launches}


def _check_no_tma_copies(what: str) -> None:
    """The job paths hand the flash kernels views TMA reads as they are."""
    from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa

    print(f"TMA copies in {what}: {fa.tma_copies}")
    check(fa.tma_copies == 0, f"{what} copied {fa.tma_copies} flash inputs for TMA")


def _counts(fwd=0, dq=0, dkv=0, moe=0, moe_dx=0, moe_dw=0) -> dict[str, int]:
    return {"fwd": fwd, "dq": dq, "dkv": dkv, "moe": moe, "moe_dx": moe_dx, "moe_dw": moe_dw}


def dit_reference(label: str, cfg, targets: list[str], fwd_launches: dict, step_launches: dict,
                  ft_launches: dict | None = None, cut: dict | None = None,
                  blocks: str = "1 double + 1 single block", txt_valid: int | None = None,
                  ctrl: bool = False) -> None:
    """A full-width DiT cut to ``cut`` (1 double + 1 single block) in f32, on
    the card against the same module on the CPU (which takes the kernels'
    plain versions): the forward, one LoRA training step's loss and
    gradients (the blocks checkpointed under the config's policy) and, with
    ``ft_launches``, one full fine-tune step of the double block's expert
    banks (the dw kernel). ``txt_valid``: a key-padding mask keeps that many
    of the 32 text tokens; ``ctrl``: a control segment as long as the image
    joins the image tokens on the rope grid's frame 1 (Qwen-Image-Edit)."""
    phase(f"full-width {label} DiT ({blocks}, f32): card vs CPU")
    import numpy as np

    from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora
    from ai_toolkit_tpu_torch.models.flux_dit import FluxDiT
    from ai_toolkit_tpu_torch.ops.layers import init_parameters
    from ai_toolkit_tpu_torch.ops.rope import image_position_ids, multi_axis_rope

    rows_cfg = dataclasses.replace(cfg, dtype=torch.float32)  # chroma: the Approximator's rows at full depth
    cfg = dataclasses.replace(cfg, **(cut or {"depth_double": 1, "depth_single": 1}), dtype=torch.float32)
    # a frozen base, as in LoRA training
    gpu = init_parameters(FluxDiT(cfg, device="cuda"), torch.Generator("cuda").manual_seed(0))
    gpu.eval().requires_grad_(False)
    cpu = FluxDiT(cfg, device="cpu").eval().requires_grad_(False)
    cpu.load_state_dict(gpu.state_dict())
    g = torch.Generator().manual_seed(1)
    n_txt, hh, ww = 32, 8, 12
    inputs = [torch.randn((1, hh * ww * (2 if ctrl else 1), cfg.in_channels), generator=g),
              torch.randn((1, n_txt, cfg.context_dim), generator=g),
              torch.tensor([0.7]), torch.randn((1, cfg.vec_dim), generator=g)]
    ids = [image_position_ids(hh, ww, text_len=n_txt)]
    if ctrl:
        ids.append(image_position_ids(hh, ww).copy())
        ids[-1][:, 0] = 1
    pe = multi_axis_rope(torch.from_numpy(np.concatenate(ids))[None], list(cfg.axes_dim), cfg.theta)
    guidance = torch.tensor([4.0])
    txt_mask = None if txt_valid is None else (torch.arange(n_txt) < txt_valid)[None]
    inputs_all = [*inputs, pe, guidance, txt_mask]
    gpu_in = [None if x is None else x.cuda() for x in inputs_all]
    _reset_launches()
    with torch.inference_mode():
        ref = cpu(*inputs_all)
        out = gpu(*gpu_in).cpu()
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    tol = 1e-3 * max(1.0, scale)  # f32 both sides, TF32 off; summation order only
    print(f"forward: out {tuple(out.shape)} max|ref|={scale:.3f} max_abs_err={err:.3e} "
          f"(tol {tol:.3e}) kernel launches={_launches()}")
    check(_launches() == fwd_launches and bool(torch.isfinite(out).all())
          and err <= tol, "DiT on the card disagrees with the CPU")
    if cfg.chroma_mod:
        from ai_toolkit_tpu_torch.models.flux_dit import chroma_approximator_input

        rows = chroma_approximator_input(rows_cfg, inputs[2], guidance)
        with torch.inference_mode():
            rows_ref = cpu.distilled_guidance_layer(rows)
            rows_out = gpu.distilled_guidance_layer(rows.cuda()).cpu()
        err, scale = (rows_out - rows_ref).abs().max().item(), rows_ref.abs().max().item()
        print(f"Approximator ({cfg.approximator_hidden} x {cfg.approximator_depth}): {tuple(rows_out.shape)} rows "
              f"of flux-dev's depth, max|ref|={scale:.3f} max_abs_err={err:.3e} (tol {1e-3 * max(1.0, scale):.3e})")
        check(rows_out.shape[1] == 344 and err <= 1e-3 * max(1.0, scale), "the Approximator on the card disagrees")

    # one LoRA training step's loss and gradients; b is made non-zero, else the
    # gradient of a is zero and the check proves nothing about it
    spec = LoRASpec(rank=16, alpha=16.0, target_patterns=targets)
    lg = build_lora(gpu, spec, torch.Generator("cuda").manual_seed(2))
    gb = torch.Generator("cuda").manual_seed(3)
    with torch.no_grad():
        for m in lg.values():
            m.b.normal_(0.0, 0.01, generator=gb)
    lc = build_lora(cpu, spec, torch.Generator().manual_seed(2))
    cpu.load_state_dict(gpu.state_dict())
    gpu.gradient_checkpointing = True  # the config's policy, as in training
    target = torch.randn(out.shape, generator=g)
    names = [f"{n}.{leaf}" for n in lg for leaf in ("a", "b", "scale")]

    def loss_and_grads(model, params, args, tgt):
        loss = (model(*args).float() - tgt).square().mean()
        return loss.item(), torch.autograd.grad(loss, params)

    def compare(what, gpu_params, cpu_params, expected):
        _reset_launches()
        ref_loss, ref_grads = loss_and_grads(cpu, cpu_params, inputs_all, target)
        loss, grads = loss_and_grads(gpu, gpu_params, gpu_in, target.cuda())
        launches = _launches()
        worst = max(((gd.cpu() - gr).abs().max() / gr.abs().max().clamp_min(1e-30)).item()
                    for gd, gr in zip(grads, ref_grads))
        # f32 both sides, TF32 off: summation order and the kernels' FMA order only
        print(f"{what}: loss card {loss:.6f} vs CPU {ref_loss:.6f}; {len(grads)} tensors, "
              f"worst max|dgrad|/max|grad| {worst:.3e} (tol 1e-3); kernel launches={launches}")
        check(abs(loss - ref_loss) <= 1e-4 * abs(ref_loss) and worst <= 1e-3
              and launches == expected, f"{what} on the card disagrees")

    def lora_params(lora):
        return [getattr(lora[n.rsplit(".", 1)[0]], n.rsplit(".", 1)[1]) for n in names]

    compare("LoRA train step", lora_params(lg), lora_params(lc), step_launches)
    if ft_launches is not None:
        from ai_toolkit_tpu_torch.jobs.train_process import select_trainable

        # the LoRA overlays stay (equal on both sides) and freeze with the rest
        banks = ["double_blocks.0.img_mlp.experts"]
        gpu_banks, cpu_banks = (list(select_trainable(m, banks, None).values()) for m in (gpu, cpu))
        compare("full fine-tune step of the double block's expert banks", gpu_banks, cpu_banks,
                ft_launches)


def _train_dataset(n: int = 4, size: int = 1024, name: str = "train_data",
                   caption: str = "[trigger] photo of {}", seed: int = 0) -> str:
    """A handful of seeded size^2 PNGs with captions (smooth colour fields plus
    noise), written once: the disk latent cache keys its files by mtime."""
    import numpy as np
    from PIL import Image

    folder = os.path.join(OUT_DIR, name)
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    subjects = ["a red fox", "a lighthouse", "a bowl of fruit", "a mountain lake"]
    if all(os.path.isfile(os.path.join(folder, f"img_{i}.txt")) for i in range(n)):
        return folder
    for i in range(n):
        f = rng.uniform(1, 6, 3)
        ph = rng.uniform(0, 6.3, 3)
        img = np.stack([np.sin(f[c] * 6.3 * (xx + yy * (c + 1) / 3) + ph[c]) for c in range(3)], -1)
        img = 127.5 * (img + 1) + rng.normal(0, 8, img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(os.path.join(folder, f"img_{i}.png"))
        with open(os.path.join(folder, f"img_{i}.txt"), "w") as fh:
            fh.write(caption.format(subjects[i % len(subjects)]))
    return folder


FLUX_MODEL = {"name_or_path": "", "arch": "flux", "model_kwargs": {"size": "dev"}}
SDXL_MODEL = {"name_or_path": "", "arch": "sdxl", "model_kwargs": {"size": "full"}, "remat_policy": "none"}
HIDREAM_MODEL = {"name_or_path": "", "arch": "hidream",
                 "model_kwargs": {"size": "full", "moe_dispatch": "grouped"}}


def _train_steps(profile_dir: str | None) -> int:
    return TRAIN_WARMUP + TRAIN_TIMED + (1 if profile_dir else 0)


def _run_train_job(name: str, model: dict, network: dict, per_step: dict[str, int],
                   profile_dir: str | None, validate: dict[str, int] | None = None):
    """An ``sd_trainer`` job on the card with seeded random weights, one 1024
    bucket, latents cached in memory, no sampling; ``per_step`` is the
    launches of each kernel one step must make; with ``validate`` (the
    launches of one evaluation) a ``val_loss`` every 2 steps. Returns
    (result, process, report)."""
    steps = _train_steps(profile_dir)
    raw = {"job": "extension", "config": {"name": name, "process": [{
        "type": "sd_trainer", "training_folder": os.path.join(OUT_DIR, "train"),
        "trigger_word": "p3r5on",
        "network": network,
        "save": {"dtype": "float16", "save_every": 250, "max_step_saves_to_keep": 4},
        "datasets": [{"folder_path": _train_dataset(), "caption_ext": "txt",
                      "caption_dropout_rate": 0.05, "shuffle_tokens": False, "cache_latents": True,
                      "cache_latents_to_disk": False, "resolution": [1024]}],
        "train": {"batch_size": 1, "steps": steps, "gradient_accumulation_steps": 1,
                  "train_unet": True, "gradient_checkpointing": True, "noise_scheduler": "flowmatch",
                  "timestep_type": "flux_shift", "optimizer": "adamw8bit", "lr": 1e-4,
                  "max_grad_norm": 1.0, "ema_config": {"use_ema": True, "ema_decay": 0.99},
                  "dtype": "bf16", "seed": 42},
        "model": model,
        "logging": {"log_every": 1}}]}}
    if validate:
        raw["config"]["process"][0]["validation"] = {"validate_every": 2}
    return _run_job(raw, per_step, profile_dir, validate=validate)


class _StepLaunches:
    """The kernel launches of each train step of a job run (the train job's
    ``make_train_step`` wrapped for the block): what is launched outside the
    steps (the samples) is the rest of the run's count."""

    def __enter__(self) -> list[dict[str, int]]:
        import ai_toolkit_tpu_torch.jobs.train_process as tp

        self.module, self.real, self.steps = tp, tp.make_train_step, []

        def counted(*args, **kwargs):
            train_step = self.real(*args, **kwargs)

            def step(*a, **k):
                before = _launches()
                out = train_step(*a, **k)
                after = _launches()
                self.steps.append({key: after[key] - before[key] for key in after})
                return out
            return step

        tp.make_train_step = counted
        return self.steps

    def __exit__(self, *exc) -> None:
        self.module.make_train_step = self.real


class _Validations:
    """Each validation of a train job's run (``train_process.eval_loss``
    wrapped for the block): its ``val_loss``, the same state evaluated again
    right after from the same seed, and the kernel launches of both."""

    def __enter__(self) -> list[dict]:
        import ai_toolkit_tpu_torch.jobs.train_process as tp

        self.module, self.real, self.checks = tp, tp.eval_loss, []

        def twice(predict_fn, schedule, cfg, batch, generator):
            seed = generator.initial_seed()
            before = _launches()
            first = self.real(predict_fn, schedule, cfg, batch, generator)
            again = self.real(predict_fn, schedule, cfg, batch, torch.Generator(generator.device).manual_seed(seed))
            after = _launches()
            self.checks.append({"val_loss": float(first), "again": float(again),
                                "launches": {k: after[k] - before[k] for k in after}})
            return first

        tp.eval_loss = twice
        return self.checks

    def __exit__(self, *exc) -> None:
        self.module.eval_loss = self.real


def _run_job(raw: dict, per_step: dict[str, int], profile_dir: str | None, denoise: dict[str, int] | None = None,
             fresh: bool = True, validate: dict[str, int] | None = None, outside: list[dict] | None = None):
    """Run the train job ``raw`` on the card (from an empty output folder
    unless ``fresh`` is false: a resume) and check its losses, the launches
    of every step (``per_step``), those of its samples (``denoise`` a denoise
    step), its validations (``validate`` an evaluation; each is evaluated
    twice, and the second must equal the first) and its TMA copies;
    ``outside``: records ``{"launches": ...}`` of other counted calls between
    the steps (the vision encodes), which the caller checks."""
    import shutil

    from ai_toolkit_tpu_torch.jobs import get_job

    name = raw["config"]["name"]
    proc_cfg = raw["config"]["process"][0]
    if fresh:
        shutil.rmtree(os.path.join(proc_cfg["training_folder"], name), ignore_errors=True)
    gc.collect()  # the previous job's model is unreachable; free it before the next
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if profile_dir:
        os.environ["AIT_PROFILE_DIR"] = os.path.join(profile_dir, name)
    t0 = time.perf_counter()
    job = get_job(raw, device="cuda")
    _reset_launches()  # count only the launches of this run of the path
    with _StepLaunches() as step_launches, _Validations() as validations:
        (result,) = job.run()
    launches = _launches()
    wall = time.perf_counter() - t0
    os.environ.pop("AIT_PROFILE_DIR", None)
    proc = job.processes[0]
    losses, step_ms = result["losses"], result["step_ms"]
    steps = len(losses)
    timed = step_ms[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_TIMED] or step_ms
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{result['trainable_params']:,} trainable params"
          f"{' in ' + str(result['lora_modules']) + ' LoRA modules' if result['lora_modules'] else ''}")
    print(f"losses per step: {', '.join(f'{x:.5f}' for x in losses)}")
    print(f"step ms: {', '.join(f'{x:.1f}' for x in step_ms)}; median of steps "
          f"{TRAIN_WARMUP + 1}-{TRAIN_WARMUP + TRAIN_TIMED}: {statistics.median(timed):.1f} ms"
          f"{' (the last step ran under the profiler)' if profile_dir else ''}")
    print(f"job wall {wall:.1f} s (model build or load, latent/text caching and samples included), "
          f"peak allocated {peak:.2f} GiB, launches {launches}")
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    check(len(step_launches) == steps and all(s == per_step for s in step_launches),
          f"launches per step {step_launches} != {per_step}")
    every = proc_cfg.get("validation", {}).get("validate_every", 0)
    n_val = sum(1 for at in range(result["start_step"] + 1, result["steps"] + 1) if every and at % every == 0)
    check(len(validations) == n_val == len(result["val_losses"]),
          f"{len(validations)} validations in {steps} steps, validate_every {every}")
    for (at, val), v in zip(result["val_losses"], validations):
        print(f"val_loss at step {at}: {val:.6f}, evaluated again {v['again']:.6f}, launches {v['launches']}")
        check(math.isfinite(val) and v["val_loss"] == v["again"] == val,
              f"val_loss {val} at step {at} is not finite or not repeatable ({v['again']})")
        check(v["launches"] == {k: 2 * (validate or {}).get(k, 0) for k in launches},
              f"launches of two evaluations {v['launches']} != 2 x {validate}")
    sampled = {k: launches[k] - sum(s[k] for s in step_launches) - sum(v["launches"][k] for v in validations)
               - sum(o["launches"][k] for o in outside or ()) for k in launches}
    n_denoise = len(result["samples"]) * proc.cfg.sample.sample_steps
    want = {k: n_denoise * (denoise or {}).get(k, 0) for k in launches}
    check(sampled == want, f"launches of {n_denoise} denoise steps in the samples {sampled} != {want}")
    _check_no_tma_copies(name)
    if result["experts"]:
        print(f"experts by step: {', '.join(result['experts'])}")
    return result, proc, {"launches": launches, "steps": steps, "median_step_ms": statistics.median(timed),
                          "peak_gib": peak, "wall_s": wall, "experts": result["experts"],
                          "per_step": per_step, "denoise_steps": n_denoise}


def train_job(name: str, model: dict, per_step: dict[str, int], profile_dir: str | None,
              raw: dict | None = None, validate: dict[str, int] | None = None) -> dict:
    """A LoRA ``sd_trainer`` job on the card (configs/examples/train_lora_flux_tpu.yaml,
    train_lora_hidream_tpu.yaml, or the job ``raw``), its LoRA checked
    (:func:`check_lora_job`); ``validate``: see :func:`_run_train_job`."""
    if raw is None:
        result, proc, report = _run_train_job(name, model, {"type": "lora", "linear": 16, "linear_alpha": 16},
                                              per_step, profile_dir, validate)
    else:
        result, proc, report = _run_job(raw, per_step, profile_dir)
    path = check_lora_job(result, proc)
    del proc
    return {**report, "lora_path": path, "val_losses": result["val_losses"]}


def check_lora_job(result: dict, proc) -> str:
    """A LoRA job's run really trained: no b factor is still zero, the EMA
    differs from the trained factors, and the final save (the EMA copy when
    EMA is on) reloads under the LoRA's module names with its step in the
    metadata and non-zero b factors. Returns the save's path."""
    from ai_toolkit_tpu_torch.io.lora_file import load_lora_file

    steps = result["steps"]  # the final save's step (a resume runs fewer)
    tr, ema = proc.state.trainable, proc.state.ema
    # a DiT that ends on a joint block (Qwen-Image) returns only its image
    # tokens: the last block's text-stream projections reach no loss, their
    # gradients are zero (in the JAX step too) and their b factors stay zero
    cfg = getattr(proc.model, "dit_config", None)
    dead = set()
    if cfg is not None and getattr(cfg, "depth_single", 1) == 0 and not getattr(cfg, "final_context_pre_only", 1):
        last = f"double_blocks.{len(proc.variables['dit'].double_blocks) - 1}."
        dead = {f"{last}{m}.b" for m in ("txt_attn.proj", "txt_mlp.0", "txt_mlp.2")}
    b_keys = [k for k in tr if k.endswith(".b")]
    check(all(bool(tr[k].abs().max() > 0) != (k in dead) for k in b_keys),
          f"a LoRA b factor is still zero, or one of {sorted(dead)} that no loss reaches moved")
    if dead:
        print(f"{len(dead)} b factors stay zero as they should (no loss reaches them): {sorted(dead)}")
    check(ema is None or any(not torch.equal(ema[k], tr[k]) for k in tr),
          "the EMA equals the trainable parameters")
    path = result["save_path"]
    check(os.path.isfile(path), f"no LoRA file at {path}")
    # the names resolve kohya keys, the model's inverse key map the JAX module paths (Wan, LTX-2)
    tree, meta = load_lora_file(path, module_names=list(proc.lora),
                                module_name=getattr(proc.model, "lora_module_name", None))
    check(sorted(tree) == sorted(proc.lora), "the LoRA file reloads under other module names")
    check(len(tree) == result["lora_modules"] and meta.get("step") == str(steps),
          f"LoRA file reloads with {len(tree)} modules, metadata {meta}")
    saved_b = max(float(v["b"].abs().max()) for v in tree.values())
    print(f"saved {path}: {len(tree)} modules, max|b| {saved_b:.3e} ({'EMA copy' if ema is not None else 'trained'}"
          f", fp16)")
    check(saved_b > 0, "the saved LoRA has zero b factors")
    return path


def fullft_job(name: str, model: dict, per_step: dict[str, int], profile_dir: str | None,
               seed: int = 42) -> dict:
    """The full fine-tune ``sd_trainer`` job on the card
    (configs/examples/train_full_finetune_flux_tpu.yaml's branch, ``network:
    {type: full}``) filtered by ``model.only_if_contains``: the trained
    tensors moved, every other DiT tensor equals a fresh init from the job's
    seed bit for bit, the EMA differs from the trained tensors, and the final
    save holds exactly the trained tensors (not the EMA) in their dtype."""
    from safetensors import safe_open

    from ai_toolkit_tpu_torch.models.flux_dit import FluxDiT
    from ai_toolkit_tpu_torch.models.hidream_model import hidream_dit_config
    from ai_toolkit_tpu_torch.ops.layers import init_parameters

    result, proc, report = _run_train_job(name, model, {"type": "full"}, per_step, profile_dir)
    tr, ema = proc.state.trainable, proc.state.ema
    dit = proc.variables["dit"]
    proc.variables = proc.state = None  # the text encoders and the VAE go
    check(all(not torch.equal(ema[k], tr[k]) for k in tr), "the EMA equals a trained tensor")
    with safe_open(result["save_path"], framework="pt", device="cpu") as f:
        keys = sorted(f.keys())
        check(keys == sorted(tr), f"the save holds {keys}, not the trained {sorted(tr)}")
        for k in keys:
            saved = f.get_tensor(k)
            check(saved.dtype == tr[k].dtype == torch.bfloat16 and torch.equal(saved, tr[k].detach().cpu()),
                  f"saved {k} is not the trained tensor in bf16")
    print(f"saved {result['save_path']}: {len(keys)} tensors in bf16, equal to the trained ones "
          f"(not the EMA)")
    del ema
    gc.collect()
    torch.cuda.empty_cache()
    # the job's DiT is the first component built from its seed: rebuild it
    fresh = init_parameters(FluxDiT(hidream_dit_config(model["model_kwargs"]["moe_dispatch"]), device="cuda"),
                            torch.Generator("cuda").manual_seed(seed)).state_dict()
    n_same = 0
    for k, p in dit.named_parameters():
        same = torch.equal(p, fresh[k])
        check(same != (k in tr), f"{k}: {'trained but unchanged' if same else 'changed but not trained'}")
        n_same += same
    print(f"{len(tr)} trained tensors moved; the other {n_same} DiT tensors equal a fresh seeded init")
    del fresh, dit, tr, proc
    return report


def generate_job(model: dict, width: int, height: int, steps: int, prompts: list,
                 per_step: dict[str, int], lora_path: str | None = None,
                 sampler: str = "flowmatch", guidance_scale: float = 4, num_frames: int = 1) -> dict[str, int]:
    """A ``generate`` job on the card; ``prompts``: strings, or items with a
    ``ctrl_img``; ``per_step`` is the launches of each kernel one denoise step
    must make; ``num_frames`` > 1: a video model's clips, each an animated
    webp of that many frames. A multistage pair must run both experts."""
    from PIL import Image

    from ai_toolkit_tpu_torch.jobs import run_job

    proc = {"type": "generate", "training_folder": OUT_DIR, "model": model,
            "sample": {"sampler": sampler, "width": width, "height": height, "guidance_scale": guidance_scale,
                       "sample_steps": steps, "seed": 42, "walk_seed": True, "prompts": prompts,
                       "num_frames": num_frames, "fps": 16}}
    if lora_path:
        proc["lora_path"] = lora_path
    raw = {"job": "generate", "config": {"name": f"smoke_{model['arch']}_{width}x{height}",
                                         "process": [proc]}}
    gc.collect()  # the previous job's model is unreachable; free it before the next
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _reset_launches()  # count only the launches of this run of the path
    (result,) = run_job(raw, device="cuda")
    launches = _launches()
    wall = time.perf_counter() - t0
    for path in result["images"]:
        check(os.path.isfile(path), f"no output at {path}")
        with Image.open(path) as im:
            check(im.size == (width, height) and getattr(im, "n_frames", 1) == num_frames,
                  f"bad output {path}: {im.size}, {getattr(im, 'n_frames', 1)} frames")
    recs = result["timings"]
    check(len(recs) == len(prompts) and all(r["latents_finite"] for r in recs),
          f"non-finite latents: {recs}")
    for r in recs:
        steps_ms = r["step_ms"]
        what = f"{num_frames} frames ({r['tokens']} tokens)" if num_frames > 1 else "image"
        pair = model["arch"].startswith("wan22_14b")
        print(f"{what} {r['width']}x{r['height']}: encode {r['encode_ms']:.1f} ms, denoise steps "
              f"{', '.join(f'{x:.1f}' for x in steps_ms)} ms (median {statistics.median(steps_ms):.1f}), "
              f"VAE decode {r['decode_ms']:.1f} ms, total {r['total_s']:.3f} s"
              f"{'; experts by step ' + ', '.join(r['experts']) if pair else ''}")
        if pair:
            check({"dit", "dit_low"} <= set(r["experts"]), f"a denoise run of the pair used only {set(r['experts'])}")
    print(f"job wall {wall:.1f} s (model build + seeded init included), "
          f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {launches}{' (LoRA ' + lora_path + ' overlaid)' if lora_path else ''}")
    expected = {k: v * len(prompts) * steps for k, v in per_step.items()}
    check(launches == expected, f"launches {launches} != {expected}")
    _check_no_tma_copies(raw["config"]["name"])
    return launches


def attention_times(title: str, prefix: str, cases, seed: int) -> dict:
    """The flash kernels at a model's shapes: the forward and, where ``full``,
    dq and dk/dv, each timed with events (back to back, the host's launch
    hidden behind the card's work) and with the card alone (:func:`_device_ms`),
    against its plain version (where its f32 [B, H, S, T] tensors fit in
    PLAIN_BUDGET), the forward against scaled_dot_product_attention, dq and
    dk/dv against its backward, each beside its bound. ``cases``:
    ``[(shape, label, full)]``. Returns ``{label: {fwd|dq|dkv: {...}}}``."""
    phase(title)
    from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(seed)
    res = {}
    for (b, s, t, h, d), label, full in cases:
        q, g = (_rand((b, s, h, d), torch.bfloat16, gen) for _ in range(2))
        k, v = (_rand((b, t, h, d), torch.bfloat16, gen) for _ in range(2))
        scale = d ** -0.5
        out, lse = fa.flash_attention_fwd(q, k, v)
        delta = fa.flash_attention_bwd_delta(out, g)
        qt, kt, vt = _sdpa_layout(q, k, v)
        lib_fwd = statistics.median(_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20))
        lib_dev = {"fwd": _device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))}
        if full:
            lib_bwd = _sdpa_bwd_ms(q, k, v, g)
            lib_dev["bwd"] = _sdpa_bwd_ms(q, k, v, g, device_only=True)
        sq, st = b * s * h * d, b * t * h * d  # elements of one [B,S,H,D] and one [B,T,H,D] tensor
        row = {}
        for name, kern, plain, ops, nbytes in (  # operations per B*H*S*T*D
            ("fwd", lambda: fa.flash_attention_fwd(q, k, v), lambda: fa.flash_attention_fwd_plain(q, k, v),
             4, 2 * (2 * sq + 2 * st) + 4 * b * h * s),  # q, k, v in, out out, lse out
            ("dq", lambda: fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, scale),
             lambda: fa.flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, scale),
             6, 2 * (3 * sq + 2 * st) + 8 * b * h * s),  # q, dO, k, v in, dq out; lse, delta
            ("dkv", lambda: fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale),
             lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta, scale),
             8, 2 * (2 * sq + 4 * st) + 8 * b * h * s),  # q, dO, k, v in, dk, dv out
        ):
            if name != "fwd" and not full:
                continue
            # the plain forward holds ~3 f32 [B, H, S, T] tensors at once, the backward ~4
            if b * h * s * t * 4 * (3 if name == "fwd" else 4) <= PLAIN_BUDGET:
                ms, plain_ms, n = _in_turns(kern, plain)
            else:
                ms, plain_ms, n = statistics.median(_time_ms(kern, 20)), None, 20
            dev_ms = _device_ms(kern)
            flops = ops * b * h * s * t * d
            bound, by = _bound_ms(flops, nbytes)
            what = "scaled_dot_product_attention" if name == "fwd" else "its backward (dq, dk, dv)"
            lib = lib_fwd if name == "fwd" else lib_bwd
            lib_d = lib_dev["fwd" if name == "fwd" else "bwd"]
            plain_txt = (f"plain {plain_ms:.4f} ms" if plain_ms is not None else
                         f"plain not measured (its f32 logits: {4 * b * h * s * t / 2**30:.1f} GiB)")
            print(f"{prefix} {label} (B,S,T,H,D)=({b},{s},{t},{h},{d}) {name}: kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s of {flops:.4e} operations; back to back on the device "
                  f"{dev_ms:.4f} ms), {plain_txt}, median of {n}; library {what} "
                  f"{lib:.4f} ms (back to back on the device {lib_d:.4f} ms); kernel / library {ms / lib:.2f}x, "
                  f"on the device {dev_ms / lib_d:.2f}x; bound {bound:.4f} ms ({by}; the kernel at "
                  f"{100 * bound / ms:.1f} % of its rate, {100 * bound / dev_ms:.1f} % on the device)")
            row[name] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": lib,
                         "library_device_ms": lib_d, "bound_ms": bound, "bound_by": by}
        res[label] = row
        del q, k, v, g, out, lse, delta, qt, kt, vt
        torch.cuda.empty_cache()
    return res


def flash_checks(title: str, cases, seed: int) -> dict[str, float]:
    """The flash kernels against their plain versions at a model's shapes,
    bf16: out within 2e-2 of max|ref| (capped at 2e-2), lse within LSE_TOL,
    dq, dk and dv within 2e-2 of max|ref|, the plain version run over
    HEAD_CHUNK heads at a time (heads are independent, so that is exact).
    ``cases``: ``[(shape, label, backward, qkv or None)]``; a case without
    its backward holds the rows of its first Q tile and of its ragged last
    one against the plain version over every key (rows are independent too).
    A case with q + 3.2 and k - 3.2 puts every lse, the ragged tail tile's
    too, near -106. Returns the largest absolute errors of the forward, dq
    and dk/dv."""
    phase(title)
    from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(seed)
    err = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for (b, s, t, h, d), label, full, qkv in cases:
        q, k, v = qkv if qkv is not None else (
            _rand((b, s, h, d), torch.bfloat16, gen), *(_rand((b, t, h, d), torch.bfloat16, gen) for _ in range(2)))
        out, lse = fa.flash_attention_fwd(q, k, v)
        if full:
            g = _rand((b, s, h, d), torch.bfloat16, gen)
            grads = fa.flash_attention_bwd(q, k, v, out, lse, g)
        torch.cuda.synchronize()
        tail = s - (s % 128 or 128)
        rows = slice(None) if full else torch.cat([torch.arange(128), torch.arange(tail, s)]).cuda()
        e = {"out": 0.0, "lse": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
        ref_max = {"out": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
        for h0 in range(0, h, HEAD_CHUNK):
            hs = slice(h0, h0 + HEAD_CHUNK)
            ref_out, ref_lse = fa.flash_attention_fwd_plain(q[:, rows, hs].float(), k[:, :, hs].float(),
                                                            v[:, :, hs].float())
            e["out"] = max(e["out"], (out[:, rows, hs].float() - ref_out).abs().max().item())
            e["lse"] = max(e["lse"], (lse[:, hs][:, :, rows] - ref_lse).abs().max().item())
            ref_max["out"] = max(ref_max["out"], ref_out.abs().max().item())
            del ref_out, ref_lse
            if full:
                refs = fa.flash_attention_bwd_plain(q[:, :, hs].float(), k[:, :, hs].float(), v[:, :, hs].float(),
                                                    out[:, :, hs].float(), lse[:, hs], g[:, :, hs].float())
                for name, x, r in zip(("dq", "dk", "dv"), grads, refs):
                    e[name] = max(e[name], (x[:, :, hs].float() - r).abs().max().item())
                    ref_max[name] = max(ref_max[name], r.abs().max().item())
                del refs
        out_tol = 2e-2 * min(1.0, ref_max["out"])
        tail_lse = lse[:, :, tail:].max().item()
        msg = (f"{label} (B,S,T,H,D)=({b},{s},{t},{h},{d}): {'all' if full else 'first and last tile'} rows; "
               f"out_err {e['out']:.3e} (tol {out_tol:.3e}), lse_err {e['lse']:.3e} (tol {LSE_TOL:g}); "
               f"largest lse of the ragged last tile ({s - tail} rows) {tail_lse:.1f}")
        check(bool(torch.isfinite(out).all()) and e["out"] <= out_tol and e["lse"] <= LSE_TOL,
              f"{msg}: the forward disagrees with its plain version")
        if qkv is not None:
            check(tail_lse < -88.0, f"{msg}: the negative case's tail lse is not below -88")
        err["fwd"] = max(err["fwd"], e["out"])
        if full:
            rel = [e[n] / ref_max[n] for n in ("dq", "dk", "dv")]
            check(all(bool(torch.isfinite(x).all()) for x in grads), f"{msg}: a gradient is not finite")
            msg += f"; rel err dq/dk/dv {rel[0]:.3e}/{rel[1]:.3e}/{rel[2]:.3e} (tol 2e-2)"
            check(max(rel) <= 2e-2, f"{msg}: the backward kernels disagree with their plain versions")
            err["dq"], err["dkv"] = max(err["dq"], e["dq"]), max(err["dkv"], e["dk"], e["dv"])
            del g, grads
        print(msg)
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    return err


def unet_reference(fwd_launches: dict, step_launches: dict) -> None:
    """A full-width SDXL UNet (320/640/1280 channels, 10 and 20 heads of 64,
    cross dim 2048, the added condition) cut to one layer per level and one
    transformer block per attention, in f32, on the card against the same
    module on the CPU (which takes the flash kernels' plain versions): the
    forward, and one LoRA training step's loss and gradients with per-block
    checkpointing."""
    phase("full-width SDXL UNet (one layer per level, one transformer block per attention, f32): card vs CPU")
    from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora
    from ai_toolkit_tpu_torch.models.unet import UNet2DCondition, UNetConfig, unet_lora_targets
    from ai_toolkit_tpu_torch.ops.layers import init_parameters

    cfg = dataclasses.replace(UNetConfig.sdxl(), transformer_layers=(0, 1, 1), layers_per_block=1,
                              dtype=torch.float32, remat=False)
    gpu = init_parameters(UNet2DCondition(cfg, device="cuda"), torch.Generator("cuda").manual_seed(0))
    gpu.eval().requires_grad_(False)
    cpu = UNet2DCondition(cfg, device="cpu").eval().requires_grad_(False)
    cpu.load_state_dict(gpu.state_dict())
    g = torch.Generator().manual_seed(1)
    b, hh, ww = 2, 32, 32  # level 1 at 16 x 16 = 256 tokens, level 2 at 64
    inputs = [torch.randn((b, hh, ww, cfg.in_channels), generator=g), torch.tensor([37, 811]),
              torch.randn((b, 77, cfg.cross_attention_dim), generator=g),
              {"time_ids": torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]]).repeat(b, 1),
               "text_embeds": torch.randn((b, 1280), generator=g)}]

    def to_gpu(x):
        return {k: to_gpu(v) for k, v in x.items()} if isinstance(x, dict) else x.cuda()

    gpu_in = [to_gpu(x) for x in inputs]
    _reset_launches()
    with torch.inference_mode():
        ref = cpu(*inputs)
        out = gpu(*gpu_in).cpu()
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    tol = 1e-3 * max(1.0, scale)  # f32 both sides, TF32 off; summation order only
    print(f"forward: out {tuple(out.shape)} max|ref|={scale:.3f} max_abs_err={err:.3e} "
          f"(tol {tol:.3e}) kernel launches={_launches()}")
    check(_launches() == fwd_launches and bool(torch.isfinite(out).all()) and err <= tol,
          "the UNet on the card disagrees with the CPU")

    spec = LoRASpec(rank=16, alpha=16.0, target_patterns=unet_lora_targets())
    lg = build_lora(gpu, spec, torch.Generator("cuda").manual_seed(2))
    gb = torch.Generator("cuda").manual_seed(3)
    with torch.no_grad():
        for m in lg.values():  # b non-zero, else the gradient of a is zero
            m.b.normal_(0.0, 0.01, generator=gb)
    lc = build_lora(cpu, spec, torch.Generator().manual_seed(2))
    cpu.load_state_dict(gpu.state_dict())
    for m in (gpu, cpu):  # per-block checkpointing, as the default remat policy
        m.cfg = dataclasses.replace(cfg, remat=True)
    target = torch.randn(out.shape, generator=g)
    names = [(n, leaf) for n in lg for leaf in ("a", "b", "scale")]

    def loss_and_grads(model, lora, args, tgt):
        loss = (model(*args).float() - tgt).square().mean()
        return loss.item(), torch.autograd.grad(loss, [getattr(lora[n], leaf) for n, leaf in names])

    _reset_launches()
    ref_loss, ref_grads = loss_and_grads(cpu, lc, inputs, target)
    loss, grads = loss_and_grads(gpu, lg, gpu_in, target.cuda())
    launches = _launches()
    # a and b: max|dgrad| / max|grad| per tensor. A scale's gradient is one sum
    # over its layer's whole output, which can cancel to ~1e-3 of its terms (6.6e-7
    # against ~1e-4 for a and b), so each is held to the largest scale gradient
    worst = 0.0
    for kind in ("a", "b", "scale"):
        pairs = [(f"{n}.{leaf}", gd.cpu(), gr) for gd, gr, (n, leaf) in zip(grads, ref_grads, names) if leaf == kind]
        kind_max = max(gr.abs().max().item() for _, _, gr in pairs)
        errs = sorted(((gd - gr).abs().max().item() / (kind_max if kind == "scale" else
                                                       max(gr.abs().max().item(), 1e-30)), name)
                      for name, gd, gr in pairs)
        worst = max(worst, errs[-1][0])
        print(f"  {kind}: worst max|dgrad| / max|grad|{' (of every scale)' if kind == 'scale' else ''} "
              f"{errs[-1][0]:.3e} ({errs[-1][1]}), median {errs[len(errs) // 2][0]:.3e}")
    print(f"LoRA train step ({len(lg)} modules, checkpointed blocks): loss card {loss:.6f} vs CPU "
          f"{ref_loss:.6f}; {len(grads)} tensors, worst {worst:.3e} (tol 1e-3); kernel launches={launches}")
    check(abs(loss - ref_loss) <= 1e-4 * abs(ref_loss) and worst <= 1e-3 and launches == step_launches,
          "the UNet's LoRA train step on the card disagrees")
    del gpu, cpu, lg, lc, grads, ref_grads
    gc.collect()
    torch.cuda.empty_cache()


def _shipped_job(example: str, name: str, steps: int, name_or_path: str, folder: str | None = None,
                 model_kwargs: dict | None = None, **paths) -> dict:
    """The shipped job file ``configs/examples/<example>`` as it is written,
    but for these cuts: the job's name, ``training_folder``, the dataset's
    ``folder_path`` (the seeded PNGs) and its other folders (``paths``:
    ``control_path``, ``inpaint_path``), ``train.steps`` and
    ``model.name_or_path`` (``folder``: another seeded folder), and
    ``model_kwargs`` added to the model's (OmniGen2's transformer config,
    which a checkpoint would hold); written to a job file and read back
    through the port's config loader."""
    from ai_toolkit_tpu_torch.config import get_config

    raw = get_config(os.path.join(ROOT, "configs", "examples", example))
    raw["config"]["name"] = name
    proc = raw["config"]["process"][0]
    proc["training_folder"] = os.path.join(OUT_DIR, "train")
    proc["datasets"][0]["folder_path"] = folder or _train_dataset()
    proc["datasets"][0].update(paths)
    proc["train"]["steps"] = steps
    proc["model"]["name_or_path"] = name_or_path
    if model_kwargs:
        proc["model"]["model_kwargs"] = {**proc["model"].get("model_kwargs", {}), **model_kwargs}
    job = _read_back(raw, os.path.join(OUT_DIR, f"{name}.yaml"), example)
    check(job["config"]["process"][0]["datasets"][0].get("cache_latents_to_disk", True)
          and job["config"]["process"][0].get("sample"), f"{example} lost its disk cache or its samples")
    return job


def _checksum(t: torch.Tensor) -> int:
    """A positional checksum of a tensor's bits (on its device): equal bits
    give equal sums, a moved or changed element another."""
    flat = t.detach().contiguous().view(-1)
    bits = flat.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[flat.element_size()]).to(torch.int64)
    return int((bits * (torch.arange(1, bits.numel() + 1, device=bits.device) % 1000003)).sum())


SDXL_PARTS = (("unet", "unet", "diffusion_pytorch_model.safetensors"),
              ("vae", "vae", "diffusion_pytorch_model.safetensors"),
              ("text_encoder", "clip", "model.safetensors"), ("text_encoder_2", "clip2", "model.safetensors"))


def write_sdxl_checkpoint(seed: int = 1234) -> tuple[str, dict]:
    """A full-width SDXL checkpoint in the HF layout (unet/, vae/,
    text_encoder/, text_encoder_2/) written from the port's own modules,
    seeded with another seed than the job's, so a load that did not happen
    shows; returns its directory and each tensor's checksum."""
    from safetensors.torch import save_file

    from ai_toolkit_tpu_torch.config.modules import ModelConfig
    from ai_toolkit_tpu_torch.models.sd_model import SDXLModel

    root = os.path.join(OUT_DIR, "sdxl_checkpoint")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = SDXLModel(ModelConfig.from_dict(dict(SDXL_MODEL)), device="cuda")
    variables = model.init_variables(torch.Generator("cuda").manual_seed(seed))
    torch.cuda.synchronize()
    init_s, t0 = time.perf_counter() - t0, time.perf_counter()
    sums, nbytes = {}, 0
    for sub, name, fname in SDXL_PARTS:
        sd = variables.pop(name).state_dict()
        sums[name] = {k: _checksum(v) for k, v in sd.items()}
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        host = {k: v.contiguous().cpu() for k, v in sd.items()}
        nbytes += sum(v.numel() * v.element_size() for v in host.values())
        save_file(host, os.path.join(root, sub, fname))
        del sd, host
    write_s = time.perf_counter() - t0
    print(f"SDXL checkpoint {root}: {sum(len(v) for v in sums.values())} tensors, {nbytes / 2**30:.2f} GiB, "
          f"seeded init {init_s:.2f} s, written in {write_s:.2f} s ({nbytes / 2**30 / write_s:.2f} GiB/s)")
    return root, {"sums": sums, "write_s": write_s, "gib": nbytes / 2**30}


def _check_loaded(variables: dict, sums: dict, label: str = "sdxl") -> None:
    for name, want in sums.items():
        sd = variables[name].state_dict()
        bad = [k for k, v in want.items() if k not in sd or _checksum(sd[k]) != v]
        check(not bad, f"{label} {name}: {len(bad)} loaded tensors differ from the written ones, e.g. {bad[:3]}")
    print(f"every loaded tensor equals the written one ({sum(len(v) for v in sums.values())} checksums)")


def _check_samples(result: dict, steps: list[int], n_prompts: int, size: int) -> None:
    import numpy as np
    from PIL import Image

    got = [(r["step"], r["index"]) for r in result["samples"]]
    check(got == [(s, i) for s in steps for i in range(n_prompts)], f"samples at {got}")
    for r in result["samples"]:
        check(os.path.isfile(r["path"]), f"no sample at {r['path']}")
        px = np.asarray(Image.open(r["path"]))
        check(px.shape == (size, size, 3) and px.std() > 0, f"sample {r['path']}: {px.shape}, std {px.std()}")
        print(f"sample {r['path']}: {r['seconds']:.2f} s")


def sdxl_shipped_phases(card: str, profile_dir: str | None) -> dict:
    """configs/examples/train_lora_sdxl_tpu.yaml as written on a full-width
    checkpoint it loads (its disk cache, its first and final samples), then
    the same job to 7 steps, which resumes from step 5. Returns the resumed
    run's report with the LoRA it saved."""
    import ai_toolkit_tpu_torch.jobs.train_process as tp

    phase("SDXL checkpoint in the HF layout, written from seeded full-width modules")
    root, written = write_sdxl_checkpoint()
    print(f"{card}: checkpoint written in {written['write_s']:.2f} s")

    phase("SDXL LoRA sd_trainer job, configs/examples/train_lora_sdxl_tpu.yaml as written on that checkpoint "
          "(1024x1024, ddpm, min_snr_gamma 5, adamw8bit, EMA, remat none, the disk latent cache, a first and a "
          "final sample: 1 prompt, DDIM 25 steps, guidance 7), 5 steps")
    name = "smoke_sdxl_shipped"
    sdxl_step = _counts(SDXL_ATTENTIONS, SDXL_ATTENTIONS, SDXL_ATTENTIONS)
    denoise = _counts(fwd=SDXL_ATTENTIONS)  # the CFG pair is one batch of two
    result, proc, report = _run_job(_shipped_job("train_lora_sdxl_tpu.yaml", name, 5, root), sdxl_step,
                                    profile_dir, denoise)
    check_lora_job(result, proc)
    _check_loaded(proc.variables, written["sums"])
    cache = result["latent_cache"]
    files = os.listdir(cache["dir"])
    check(cache["items"] == len(files) == 4 and cache["encoded"] == 4, f"latent cache {cache}, {len(files)} files")
    _check_samples(result, [0, 5], 1, 1024)
    saved = {k[4:]: v.detach().cpu().clone() for k, v in proc.state.state_dict().items() if k.startswith("opt.")}
    print(f"{card}: checkpoint load {result['load_s']:.2f} s ({written['gib']:.2f} GiB), disk cache "
          f"{cache['seconds']:.2f} s for {cache['items']} items ({cache['encoded']} encoded), samples "
          f"{', '.join('%.2f' % r['seconds'] for r in result['samples'])} s each, peak {report['peak_gib']:.2f} GiB")
    del proc

    phase("the same job to 7 steps: resumed from step 5 (its LoRA, optimizer state, EMA and generator), every "
          "latent from the disk cache, samples at steps 5 and 7")
    restored = {}
    real_resume = tp.SDTrainProcess._resume

    def resume(self, *args):
        step = real_resume(self, *args)
        restored.update({k[4:]: v.detach().cpu().clone() for k, v in self.state.state_dict().items()
                         if k.startswith("opt.")})
        return step

    tp.SDTrainProcess._resume = resume
    try:
        result2, proc2, report2 = _run_job(_shipped_job("train_lora_sdxl_tpu.yaml", name, 7, root), sdxl_step,
                                           profile_dir, denoise, fresh=False)
    finally:
        tp.SDTrainProcess._resume = real_resume
    check(result2["start_step"] == 5 and len(result2["losses"]) == 2, f"resumed at {result2['start_step']}")
    cache2 = result2["latent_cache"]
    check(cache2["encode_calls"] == 0 and cache2["hits"] == 4, f"the rerun encoded: {cache2}")
    check(sorted(restored) == sorted(saved) and all(torch.equal(restored[k], saved[k]) for k in saved),
          "the optimizer state after the load is not the one saved")
    check(result2["steps"] == 7, f"the resumed job's final step is {result2['steps']}")
    check_lora_job(result2, proc2)  # its final save's metadata says step 7
    _check_samples(result2, [5, 7], 1, 1024)
    print(f"resumed from step 5: {len(saved)} optimizer tensors equal those saved; disk cache {cache2['hits']} hits, "
          f"{cache2['encode_calls']} encode calls; final save at step 7")
    print(f"{card}: resumed job wall {report2['wall_s']:.1f} s, checkpoint load {result2['load_s']:.2f} s, peak "
          f"{report2['peak_gib']:.2f} GiB")
    del proc2
    return {**report, "resumed": report2, "lora_path": result2["save_path"], "write_s": written["write_s"],
            "load_s": result["load_s"]}


def flux_shipped_phase(card: str, profile_dir: str | None) -> dict:
    """configs/examples/train_lora_flux_tpu.yaml as written but with seeded
    weights (a flux-dev checkpoint with T5-XXL is ~34 GB of disk): the
    quantized base (``quantize: true`` at the default qtype, qfloat8, in
    both packages, though the file's comment says int8), resolutions 512,
    768 and 1024 over SHIPPED_IMAGES seeded 1024^2 images (SHIPPED_DATA),
    the disk latent cache and the file's two prompts at 20 steps, first and
    final; SHIPPED_STEPS steps, one epoch, so every bucket trains, each step
    checked for its 57 launches of each flash kernel."""
    phase("flux-dev LoRA sd_trainer job, configs/examples/train_lora_flux_tpu.yaml as written with seeded "
          f"weights: qfloat8 base, {SHIPPED_DATA}, the disk latent cache, "
          f"2 prompts at 1024x1024 and 20 steps first and final, {SHIPPED_STEPS} steps")
    return _shipped_flux_job(card, profile_dir, "train_lora_flux_tpu.yaml", "smoke_flux_shipped", 2)


# the shipped flux-class files (flux-dev, the flux family, the MMDiT and NextDiT files) train one
# epoch over this many seeded 1024^2 images at the files' three resolutions: every bucket
# trains twice, and the script stays within its time limit (the depths are the phases' own)
SHIPPED_IMAGES = 2
SHIPPED_STEPS = 3 * SHIPPED_IMAGES
SHIPPED_DATA = f"resolutions [512, 768, 1024] ({SHIPPED_STEPS} items, 3 buckets)"


def _shipped_flux_job(card: str, profile_dir: str | None, example: str, name: str, n_prompts: int,
                      watch=None, blocks: int = BLOCKS_PER_FORWARD, quantized: bool = True,
                      model_kwargs: dict | None = None, **paths) -> dict:
    """A shipped flux-family (MMDiT, NextDiT) file as written but for its
    paths (``paths``: the control folders), its dataset (SHIPPED_IMAGES
    seeded images), SHIPPED_STEPS steps (one epoch over their items, so every
    bucket trains) and ``model_kwargs``, on seeded weights:
    ``blocks`` launches of each flash kernel a step and a denoise step
    (flux: 57), the base quantized as the file says (``quantized``), the
    three buckets, the disk cache, the first and final samples, a LoRA that
    moved and reloads; ``watch``: a context manager over the run (the
    control batches' check). Prints the step ms per bucket, the peak and
    the sample s beside the card."""
    with (watch or contextlib.nullcontext()):
        job = _shipped_job(example, name, SHIPPED_STEPS, "", _train_dataset(n=SHIPPED_IMAGES, name="shipped_data"),
                           model_kwargs=model_kwargs, **paths)
        result, proc, report = _run_job(job, _counts(blocks, blocks, blocks), profile_dir, _counts(fwd=blocks))
    check(proc.cfg.model.quantize == quantized and proc.cfg.datasets[0].resolution == [512, 768, 1024],
          f"{example} lost its quantized base or its resolutions")
    cache = result["latent_cache"]
    check(cache["items"] == len(os.listdir(cache["dir"])) == cache["encoded"] == SHIPPED_STEPS,
          f"latent cache {cache}")
    by_bucket: dict[tuple, list[float]] = {}
    for bucket, ms in zip(result["buckets"], result["step_ms"]):
        by_bucket.setdefault(tuple(bucket), []).append(ms)
    check(sorted(by_bucket) == [(512, 512), (768, 768), (1024, 1024)], f"buckets trained {sorted(by_bucket)}")
    for bucket, ms in sorted(by_bucket.items()):  # each bucket's first step is its cold one
        print(f"{card}: bucket {bucket[0]}x{bucket[1]}: step ms {', '.join(f'{x:.1f}' for x in ms)} "
              f"(median of all but the first {statistics.median(ms[1:]):.1f}), {blocks} launches of "
              f"each flash kernel a step")
    _check_samples(result, [0, SHIPPED_STEPS], n_prompts, 1024)
    lora_path = check_lora_job(result, proc)
    print(f"{card}: disk cache {cache['seconds']:.2f} s for {cache['items']} items, samples "
          f"{', '.join('%.2f' % r['seconds'] for r in result['samples'])} s each (20 steps at 1024x1024), "
          f"job wall {report['wall_s']:.1f} s, peak {report['peak_gib']:.2f} GiB")
    del proc
    return {**report, "by_bucket_ms": {f"{b[0]}": statistics.median(v[1:]) for b, v in by_bucket.items()},
            "sample_s": [r["seconds"] for r in result["samples"]], "lora_path": lora_path}


class _ControlBatches:
    """Each control batch of a train job's run checked as the job prepares it
    (``SDTrainProcess._prepare_batch`` wrapped for the block): the control
    slot of ``control_latents`` against the VAE's encode of the batch's
    control images and, for flex2, the ``[inpaint | mask | control]`` layout:
    a batch with no inpaint image has an all-ones mask and a zero inpaint
    slot, one with an inpaint image a mask that is not."""

    def __init__(self, arch: str):
        self.arch = arch

    def __enter__(self) -> list[dict]:
        import ai_toolkit_tpu_torch.jobs.train_process as tp

        self.cls, self.real, self.seen = tp.SDTrainProcess, tp.SDTrainProcess._prepare_batch, []
        real, seen, arch = self.real, self.seen, self.arch

        def prepare(proc, model, variables, raw, text_cache):
            batch = real(proc, model, variables, raw, text_cache)
            ctrl = batch["cond"]["control_latents"].float()
            with torch.no_grad():
                enc = model.encode_images(variables, torch.from_numpy(raw["control_pixels"])).float()
            c = enc.shape[-1]
            slot = ctrl[..., c + 1:] if arch == "flex2" else ctrl
            rec = {"bucket": tuple(raw["bucket"]), "inpaint": "inpaint_keep" in raw,
                   "err": (slot - enc).abs().max().item(), "scale": enc.abs().max().item(),
                   "channels": ctrl.shape[-1]}
            if arch == "flex2":
                rec["mask_mean"] = ctrl[..., c].mean().item()
                rec["inpaint_zero"] = bool((ctrl[..., :c] == 0).all())
            seen.append(rec)
            return batch

        tp.SDTrainProcess._prepare_batch = prepare
        return self.seen

    def __exit__(self, *exc) -> None:
        self.cls._prepare_batch = self.real


def _check_control_batches(seen: list[dict], arch: str, latent_channels: int = 16) -> None:
    want_c = 2 * latent_channels + 1 if arch == "flex2" else latent_channels
    check(len(seen) == SHIPPED_STEPS, f"{len(seen)} control batches prepared, not {SHIPPED_STEPS}")
    for rec in seen:
        # the same encode of the same pixels: equal up to the VAE's own run-to-run order
        check(rec["channels"] == want_c and rec["err"] <= 1e-2 * max(1.0, rec["scale"]),
              f"{arch} control batch {rec}: the control slot is not the VAE encode of the control image")
        if arch == "flex2":
            check((rec["mask_mean"] == 1.0 and rec["inpaint_zero"]) != rec["inpaint"],
                  f"flex2 batch {rec}: the mask or the inpaint slot is not what its inpaint image asks")
    n_inp = sum(rec["inpaint"] for rec in seen)
    print(f"{arch}: {len(seen)} control batches, [{'inpaint | mask | ' if arch == 'flex2' else ''}control] "
          f"{want_c} channels; control slot vs the VAE encode max_abs_err "
          f"{max(r['err'] for r in seen):.3e}; {n_inp} batches with the inpaint image"
          + (f" (mask mean {', '.join('%.3f' % r['mask_mean'] for r in seen if r['inpaint'])})" if n_inp else ""))
    check(arch != "flex2" or n_inp == 3, f"flex2: {n_inp} batches with the inpaint image, not 3")


# diffusers -> LDM names, to write the SD 1.5 file in the layout real files have
_LDM_RES = (("norm1.", "in_layers.0."), ("conv1.", "in_layers.2."), ("time_emb_proj.", "emb_layers.1."),
            ("norm2.", "out_layers.0."), ("conv2.", "out_layers.3."), ("conv_shortcut.", "skip_connection."))
_LDM_TOP = (("time_embedding.linear_1.", "time_embed.0."), ("time_embedding.linear_2.", "time_embed.2."),
            ("conv_in.", "input_blocks.0.0."), ("conv_norm_out.", "out.0."), ("conv_out.", "out.2."))
_LDM_VAE_ATTN = {"to_q": "q", "to_k": "k", "to_v": "v", "to_out.0": "proj_out", "group_norm": "norm"}


def _ldm_unet_key(name: str, attn_levels: tuple[int, ...], layers_per_block: int = 2) -> str:
    """A diffusers UNet name -> its ``model.diffusion_model.`` key (``attn_levels``:
    the up blocks with attention, whose upsampler is module 2, not 1)."""
    n = layers_per_block + 1

    def res(rest):
        dif, ldm = next(p for p in _LDM_RES if rest.startswith(p[0]))
        return ldm + rest[len(dif):]

    for dif, ldm in _LDM_TOP:
        if name.startswith(dif):
            return ldm + name[len(dif):]
    m = re.match(r"(down|up)_blocks\.(\d+)\.(resnets|attentions|downsamplers|upsamplers)\.(\d+)\.(.+)", name)
    if m:
        side, blk, kind, layer, rest = m.group(1), int(m.group(2)), m.group(3), int(m.group(4)), m.group(5)
        if kind == "downsamplers":
            return f"input_blocks.{blk * n + n}.0.op.{rest[len('conv.'):]}"
        if kind == "upsamplers":
            return f"output_blocks.{blk * n + n - 1}.{2 if blk in attn_levels else 1}.{rest}"
        blocks, i = ("input_blocks", 1 + blk * n + layer) if side == "down" else ("output_blocks", blk * n + layer)
        return f"{blocks}.{i}.0.{res(rest)}" if kind == "resnets" else f"{blocks}.{i}.1.{rest}"
    kind, idx, rest = re.match(r"mid_block\.(resnets|attentions)\.(\d+)\.(.+)", name).groups()
    return f"middle_block.1.{rest}" if kind == "attentions" else f"middle_block.{2 * int(idx)}.{res(rest)}"


def _ldm_vae_key(name: str, n_up: int = 4) -> str:
    """A diffusers VAE name -> its ``first_stage_model.`` key."""
    if name.startswith(("quant_conv.", "post_quant_conv.")):
        return name
    side, rest = name.split(".", 1)
    rest = rest.replace("conv_shortcut.", "nin_shortcut.")
    for pattern, ldm in ((r"conv_norm_out\.(.+)", lambda g: f"norm_out.{g[0]}"),
                         (r"mid_block\.attentions\.0\.(to_q|to_k|to_v|to_out\.0|group_norm)\.(.+)",
                          lambda g: f"mid.attn_1.{_LDM_VAE_ATTN[g[0]]}.{g[1]}"),
                         (r"mid_block\.resnets\.(\d)\.(.+)", lambda g: f"mid.block_{int(g[0]) + 1}.{g[1]}"),
                         (r"down_blocks\.(\d+)\.resnets\.(\d+)\.(.+)", lambda g: f"down.{g[0]}.block.{g[1]}.{g[2]}"),
                         (r"down_blocks\.(\d+)\.downsamplers\.0\.(.+)", lambda g: f"down.{g[0]}.downsample.{g[1]}"),
                         (r"up_blocks\.(\d+)\.resnets\.(\d+)\.(.+)",
                          lambda g: f"up.{n_up - 1 - int(g[0])}.block.{g[1]}.{g[2]}"),
                         (r"up_blocks\.(\d+)\.upsamplers\.0\.(.+)", lambda g: f"up.{n_up - 1 - int(g[0])}.upsample.{g[1]}")):
        m = re.match(pattern, rest)
        if m:
            return f"{side}.{ldm(m.groups())}"
    return f"{side}.{rest}"


SD15_MODEL = {"name_or_path": "", "arch": "sd1", "model_kwargs": {"size": "full"}}
TI_TRIGGER = "sks_concept"  # configs/examples/train_textual_inversion_sd15.yaml's embedding.trigger


def write_sd15_checkpoint(seed: int = 1234) -> tuple[str, dict]:
    """A full-width SD 1.5 checkpoint as one LDM file in fp16, written from the
    port's own seeded modules (seeded with another seed than the job's, so a
    load that did not happen shows) in the layout real files have:
    ``model.diffusion_model.`` with 1x1-conv ``proj_in`` / ``proj_out``,
    ``first_stage_model.`` with 1x1-conv attention, ``cond_stage_model.transformer.``
    without ``text_projection``, and what real files carry beside the weights
    (``position_ids``, the schedule buffers, ``model_ema.decay``). Returns its
    path and each loaded tensor's checksum as the module will hold it (the
    fp16 value in the module's dtype)."""
    from safetensors.torch import save_file

    from ai_toolkit_tpu_torch.config.modules import ModelConfig
    from ai_toolkit_tpu_torch.models.sd_model import SDModel
    from ai_toolkit_tpu_torch.samplers.ddpm import DDPMSchedule

    root = os.path.join(OUT_DIR, "sd15_checkpoint")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "v1-5-pruned.safetensors")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = SDModel(ModelConfig.from_dict(dict(SD15_MODEL)), device="cuda")
    variables = model.init_variables(torch.Generator("cuda").manual_seed(seed))
    torch.cuda.synchronize()
    init_s, t0 = time.perf_counter() - t0, time.perf_counter()
    ucfg = model.unet_config
    levels = len(ucfg.block_out_channels)
    attn_levels = tuple(b for b in range(levels) if ucfg.transformer_layers[levels - 1 - b] > 0)
    n_up = len(model.vae_config.channel_multipliers)
    flat, sums = {}, {}
    for name, key_of, prefix in (("unet", lambda k: _ldm_unet_key(k, attn_levels, ucfg.layers_per_block),
                                  "model.diffusion_model."),
                                 ("vae", lambda k: _ldm_vae_key(k, n_up), "first_stage_model."),
                                 ("clip", lambda k: k, "cond_stage_model.transformer.")):
        sd = variables.pop(name).state_dict()
        sd.pop("text_projection.weight", None)  # SD 1.x's CLIPTextModel has none
        sums[name] = {k: _checksum(v.to(torch.float16).to(v.dtype)) for k, v in sd.items()}
        for k, v in sd.items():
            t = v.to(torch.float16)
            if re.search(r"(proj_in|proj_out|attentions\.0\.to_[qkv]|attentions\.0\.to_out\.0)\.weight$", k) \
                    and t.dim() == 2:
                t = t[:, :, None, None]  # a 1x1 conv, as LDM files hold them
            flat[prefix + key_of(k)] = t.contiguous().cpu()
        del sd
    sched = DDPMSchedule()
    flat["cond_stage_model.transformer.text_model.embeddings.position_ids"] = torch.arange(77)[None]
    flat["betas"] = torch.from_numpy(sched.betas.copy())
    flat["alphas_cumprod"] = torch.from_numpy(sched.alphas_cumprod.copy())
    flat["model_ema.decay"] = torch.tensor(0.9999)
    nbytes = sum(v.numel() * v.element_size() for v in flat.values())
    save_file(flat, path)
    write_s = time.perf_counter() - t0
    del flat, variables
    print(f"SD 1.5 LDM file {path}: {sum(len(v) for v in sums.values())} weights, {nbytes / 2**30:.2f} GiB, "
          f"seeded init {init_s:.2f} s, written in {write_s:.2f} s ({nbytes / 2**30 / write_s:.2f} GiB/s)")
    return path, {"sums": sums, "write_s": write_s, "gib": nbytes / 2**30}


SD15_ATTENTION = (2, 4096, 8, 40)  # the UNet's level 1 at 512^2, batch 2: 64 x 64 tokens, 8 heads of 40


def sd15_attention_times(card: str) -> dict:
    """The SD 1.5 path's largest attention (``SD15_ATTENTION``, bf16): the
    plain version it runs (f32 logits, ``ops.attention.reference_attention``)
    against ``scaled_dot_product_attention``, forward and forward with
    backward, CUDA events, in turns; the size of the lever a kernel at head
    dims 40 / 80 / 160 would pull."""
    from ai_toolkit_tpu_torch.ops.attention import reference_attention

    phase(f"SD 1.5's level-1 attention {SD15_ATTENTION} bf16: the plain version against SDPA")
    gen = torch.Generator("cuda").manual_seed(15)
    q, k, v, g = (_rand(SD15_ATTENTION, torch.bfloat16, gen) for _ in range(4))
    qt, kt, vt, gt = _sdpa_layout(q, k, v, g)

    def plain_fb():
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        torch.autograd.grad(reference_attention(qq, kk, vv), (qq, kk, vv), g)

    def sdpa_fb():
        qq, kk, vv = (x.detach().requires_grad_() for x in (qt, kt, vt))
        torch.autograd.grad(F.scaled_dot_product_attention(qq, kk, vv), (qq, kk, vv), gt)

    ref = reference_attention(q, k, v).float()
    err = (F.scaled_dot_product_attention(qt, kt, vt).transpose(1, 2).float() - ref).abs().max().item()
    out = {}
    for label, plain, lib in (("forward", lambda: reference_attention(q, k, v),
                               lambda: F.scaled_dot_product_attention(qt, kt, vt)),
                              ("forward and backward", plain_fb, sdpa_fb)):
        lib_ms, plain_ms, n = _in_turns(lib, plain)
        out[label] = {"plain_ms": plain_ms, "sdpa_ms": lib_ms}
        print(f"{card}: {label}: plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms ({plain_ms / lib_ms:.2f}x; medians "
              f"of {n})")
    b, s_, h, d = SD15_ATTENTION
    bound, by = _bound_ms(4 * b * h * s_ * s_ * d, 4 * b * s_ * h * d * 2)
    print(f"forward bound {bound:.4f} ms ({by}); SDPA max|out - plain| {err:.3e}")
    return {**out, "bound_ms": bound, "bound_by": by}


def sd15_ti_phase(card: str, profile_dir: str | None) -> dict:
    """configs/examples/train_textual_inversion_sd15.yaml as written on a
    full-width SD 1.5 LDM single file it loads: the 4-vector bank trains in
    CLIP inside each step (adamw at 5e-4, batch 2 at 512^2, ddpm), the first
    and final samples (DDIM 25, guidance 7.5) use it, and the a1111 file
    holds it. SD 1.5's global 8 heads are 40, 80 and 160 wide, so no flash
    kernel runs on this path, as the JAX package sends them to XLA."""
    import numpy as np

    from ai_toolkit_tpu_torch.adapters.embedding import load_embedding

    phase("SD 1.5 checkpoint as one LDM single file (fp16), written from seeded full-width modules")
    path, written = write_sd15_checkpoint()
    print(f"{card}: SD 1.5 LDM file written in {written['write_s']:.2f} s ({written['gib']:.2f} GiB)")

    phase("SD 1.5 textual inversion sd_trainer job, configs/examples/train_textual_inversion_sd15.yaml as written "
          "on that file (arch sd1, embedding 'sks_concept' x 4 vectors from 'person', ddpm, adamw 5e-4, bf16, "
          "batch 2 at 512x512, the disk latent cache, a first and a final sample: DDIM 25 steps, guidance 7.5), "
          f"{TRAIN_WARMUP + TRAIN_TIMED} steps")
    print("flash kernel launches a step and a denoise step: 0 (SD 1.5's 8 heads are 40, 80 and 160 wide: the plain "
          "attention, as the JAX package's XLA path; CLIP's causal attention and the VAE's are plain too)")
    folder = _train_dataset(n=4, size=512, name="ti_data", caption=f"a photo of {TI_TRIGGER}, {{}}")
    raw = _shipped_job("train_textual_inversion_sd15.yaml", "smoke_sd15_ti", TRAIN_WARMUP + TRAIN_TIMED, path,
                       folder=folder)
    result, proc, report = _run_job(raw, _counts(), profile_dir, _counts())
    _check_loaded(proc.variables, written["sums"], "sd15")  # after training: nothing but the bank moved
    check(sorted(proc.state.trainable) == ["emb"] and result["trainable_params"] == 4 * 768,
          f"trainable {sorted(proc.state.trainable)}, {result['trainable_params']} params")
    tok = proc.model.tokenizer
    person = [int(i) for i in tok.base.encode("person") if i != tok.eos_id]
    table = proc.variables["clip"].text_model.embeddings.token_embedding.weight
    init = table[person].repeat(4 // len(person) + 1, 1)[:4]
    bank = proc.variables["emb"].detach()
    moved = (bank - init).abs().max().item()
    check(moved > 0, "the bank did not move")
    saved = load_embedding(result["save_path"])
    check(saved.shape == (4, 768) and saved.dtype == np.float32 and np.array_equal(saved, bank.cpu().numpy()),
          f"the saved embedding {saved.shape} {saved.dtype} is not the bank")
    _check_samples(result, [0, TRAIN_WARMUP + TRAIN_TIMED], 1, 512)
    samples = [r["seconds"] for r in result["samples"]]
    print(f"bank moved by up to {moved:.3e} from the 'person' init; {result['save_path']}: emb_params "
          f"{tuple(saved.shape)} {saved.dtype}; every UNet, CLIP and VAE tensor equals the written one")
    print(f"{card}: SD 1.5 load {result['load_s']:.2f} s ({written['gib']:.2f} GiB), median step "
          f"{report['median_step_ms']:.1f} ms (steps {TRAIN_WARMUP + 1}-{TRAIN_WARMUP + TRAIN_TIMED}), peak "
          f"{report['peak_gib']:.2f} GiB, samples {', '.join('%.2f' % x for x in samples)} s each")
    del proc
    return {"checkpoint": path, "checkpoint_write_s": written["write_s"], "checkpoint_gib": written["gib"],
            "load_s": result["load_s"],
            "median_step_ms": report["median_step_ms"], "peak_gib": report["peak_gib"], "sample_s": samples,
            "flash_launches_per_step": 0, "attention": sd15_attention_times(card)}


# ---- the slider and extract jobs ----

SLIDER_STEPS = TRAIN_WARMUP + TRAIN_TIMED
# SD 1.5's LoRA targets: 16 spatial transformers, each with 8 attention and 2
# feed-forward projections in its one block, and its proj_in / proj_out
SD15_LORA_MODULES = 16 * (8 + 2) + 16 * 2
# the modules the extract phase changes by a seeded rank-8 delta (the rest stay)
EXTRACT_CHANGED = ("down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q",
                   "down_blocks.2.attentions.1.transformer_blocks.0.attn2.to_k",
                   "mid_block.attentions.0.transformer_blocks.0.ff.net.0.proj",
                   "up_blocks.3.attentions.2.proj_out", "up_blocks.1.resnets.0.time_emb_proj",
                   "time_embedding.linear_1")


class _SliderLaunches:
    """The kernel launches and device time of each slider train step (the
    loss ``loss_name`` of ``module`` with its backward and optimizer step,
    ``SliderSetup.step``) and of each partial denoise, per Euler step."""

    def __init__(self, module, loss_name: str, first=None):
        self.module, self.loss_name, self.first = module, loss_name, first

    def __enter__(self):
        import ai_toolkit_tpu_torch.jobs.slider_process as sp

        self.sp, self.steps, self.denoise = sp, [], []
        self.real = (getattr(self.module, self.loss_name), sp.partial_denoise, sp.SliderSetup.step)
        real_loss, real_pd, real_step = self.real
        mark = {}

        def loss(*a, **k):
            torch.cuda.synchronize()
            mark.update(launches=_launches(), t=time.perf_counter())
            out = real_loss(*a, **k)
            if self.first is not None and not self.steps:
                self.first(out)
            return out

        def step(setup, value):
            out = real_step(setup, value)
            torch.cuda.synchronize()
            after = _launches()
            self.steps.append({"ms": (time.perf_counter() - mark["t"]) * 1e3,
                               "launches": {k: after[k] - mark["launches"][k] for k in after}})
            return out

        def partial_denoise(predict_fn, sigmas, x, steps_to, *a, **k):
            torch.cuda.synchronize()
            before, t0 = _launches(), time.perf_counter()
            out = real_pd(predict_fn, sigmas, x, steps_to, *a, **k)
            torch.cuda.synchronize()
            after = _launches()
            self.denoise.append({"steps": steps_to, "ms": (time.perf_counter() - t0) * 1e3,
                                 "launches": {key: after[key] - before[key] for key in after}})
            return out

        setattr(self.module, self.loss_name, loss)
        sp.partial_denoise, sp.SliderSetup.step = partial_denoise, step
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.module, self.loss_name, self.real[0])
        self.sp.partial_denoise, self.sp.SliderSetup.step = self.real[1], self.real[2]


def _slider_file(example: str, name: str, name_or_path: str, **over) -> dict:
    """A shipped slider or extract file as it is written, but for its paths
    (``training_folder``, ``model.name_or_path``, the dataset folders in
    ``over["datasets"]``, the extract job's weights), its steps and, for the
    flux slider, its model; written to a job file and read back."""
    from ai_toolkit_tpu_torch.config import get_config

    raw = get_config(os.path.join(ROOT, "configs", "examples", example))
    raw["config"]["name"] = name
    proc = raw["config"]["process"][0]
    proc["training_folder"] = os.path.join(OUT_DIR, "train")
    if "model" in proc:
        proc["model"]["name_or_path"] = name_or_path
    for key, val in over.items():
        if key == "datasets":
            proc["datasets"][0].update(val)
        elif isinstance(val, dict):
            proc[key] = {**proc.get(key, {}), **val}
        else:
            proc[key] = val
    return _read_back(raw, os.path.join(OUT_DIR, f"{name}.yaml"), example)


def _run_slider(raw: dict, module, loss_name: str, first=None):
    """Run a slider job on the card from an empty output folder; the result,
    the process, the launches per step and denoise and the peak GiB.
    ``first(setup, loss)`` sees the first step's loss before its backward."""
    import shutil

    from ai_toolkit_tpu_torch.jobs import get_job

    name = raw["config"]["name"]
    shutil.rmtree(os.path.join(raw["config"]["process"][0]["training_folder"], name), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    job = get_job(raw, device="cuda")
    _reset_launches()
    hook = None if first is None else (lambda value: first(job.processes[0].setup, value))
    with _SliderLaunches(module, loss_name, hook) as seen:
        (result,) = job.run()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = result["losses"]
    check(len(losses) == len(seen.steps) == raw["config"]["process"][0]["train"]["steps"]
          and all(math.isfinite(x) for x in losses), f"slider losses {losses}")
    ms = [s["ms"] for s in seen.steps]
    print(f"losses per step: {', '.join(f'{x:.5f}' for x in losses)}")
    print(f"train step ms (loss, backward, adamw; the denoise apart): {', '.join(f'{x:.1f}' for x in ms)}; median "
          f"{statistics.median(ms):.1f}, min {min(ms):.1f}, max {max(ms):.1f}; job wall {wall:.1f} s, peak allocated "
          f"{peak:.2f} GiB")
    _check_no_tma_copies(name)
    return result, job.processes[0], seen, peak, wall


def _check_slider_lora(result: dict, proc, flow: bool) -> None:
    """Every b factor moved; the final save holds the JAX job's keys for the
    LoRA's modules (kohya ``lora_unet_`` with alpha for the UNet, PEFT
    ``transformer.`` for a flow DiT) with their shapes, in fp16."""
    from safetensors import safe_open

    lora = proc.setup.lora
    check(all(bool(m.b.abs().max() > 0) for m in lora.values()), "a LoRA b factor is still zero")
    want = {}
    for name, m in lora.items():
        (r_in, r), (_, out) = m.a.shape, m.b.shape
        if flow:
            want[f"transformer.{name}.lora_A.weight"] = (r, r_in)
            want[f"transformer.{name}.lora_B.weight"] = (out, r)
        else:
            key = "lora_unet_" + name.replace(".", "_")
            want.update({f"{key}.lora_down.weight": (r, r_in), f"{key}.lora_up.weight": (out, r), f"{key}.alpha": ()})
    with safe_open(result["save_path"], framework="pt") as f:
        got = {k: tuple(f.get_slice(k).get_shape()) for k in f.keys()}
        dtypes = {f.get_slice(k).get_dtype() for k in f.keys()}
        step = (f.metadata() or {}).get("step")
    check(got == want and dtypes == {"F16"} and step == str(result["steps"]),
          f"the slider file's keys, shapes, dtypes {dtypes} or step {step} are not the JAX job's")
    print(f"saved {result['save_path']}: {len(lora)} modules, {len(got)} tensors, the JAX job's "
          f"{'PEFT' if flow else 'kohya lora_unet_'} keys and shapes, fp16, every b factor moved")


def slider_block_reference() -> None:
    """A full-width flux-dev DiT cut to 1 double + 1 single block, in f32,
    batch 2, a LoRA (b non-zero) at the per-sample multiplier [+1, -1] with
    recompute on (the dots_flash policy): the forward and the LoRA gradients
    on the card against the same module on the CPU, each within 1e-3 of the
    largest reference value. The backward runs after the multiplier's block
    has exited: the recomputation must see it."""
    phase("full-width flux-dev DiT, 1 double + 1 single block, f32, batch 2, LoRA at multiplier [+1, -1], "
          "recompute on: card vs CPU")
    import numpy as np

    from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora
    from ai_toolkit_tpu_torch.models.flux_dit import FluxConfig, FluxDiT, flux_lora_targets
    from ai_toolkit_tpu_torch.ops.layers import init_parameters, lora_multiplier
    from ai_toolkit_tpu_torch.ops.rope import image_position_ids, multi_axis_rope

    cfg = dataclasses.replace(FluxConfig.dev(), depth_double=1, depth_single=1, dtype=torch.float32)
    gpu = init_parameters(FluxDiT(cfg, device="cuda"), torch.Generator("cuda").manual_seed(0))
    gpu.eval().requires_grad_(False)
    spec = LoRASpec(rank=16, alpha=16.0, target_patterns=flux_lora_targets())
    lg = build_lora(gpu, spec, torch.Generator("cuda").manual_seed(2))
    with torch.no_grad():
        for m in lg.values():
            m.b.normal_(0.0, 0.01, generator=torch.Generator("cuda").manual_seed(3))
    cpu = FluxDiT(cfg, device="cpu").eval().requires_grad_(False)
    lc = build_lora(cpu, spec, torch.Generator().manual_seed(2))
    cpu.load_state_dict(gpu.state_dict())
    g = torch.Generator().manual_seed(1)
    n_txt, hh, ww, b = 32, 8, 12, 2
    pe = multi_axis_rope(torch.from_numpy(image_position_ids(hh, ww, text_len=n_txt))[None], list(cfg.axes_dim),
                         cfg.theta)
    args = [torch.randn((b, hh * ww, cfg.in_channels), generator=g), torch.randn((b, n_txt, cfg.context_dim), generator=g),
            torch.tensor([0.3, 0.8]), torch.randn((b, cfg.vec_dim), generator=g), pe, torch.tensor([4.0, 4.0])]
    target = torch.randn((b, hh * ww, cfg.out_channels or cfg.in_channels), generator=g)
    mult = torch.tensor([1.0, -1.0])
    names = [f"{n}.{leaf}" for n in lg for leaf in ("a", "b", "scale")]

    def run(model, lora, device):
        model.gradient_checkpointing = True
        params = [getattr(lora[n.rsplit(".", 1)[0]], n.rsplit(".", 1)[1]) for n in names]
        with lora_multiplier(mult.to(device)):
            out = model(*[x.to(device) for x in args])
        loss = (out.float() - target.to(device)).square().mean()  # the backward: after the block has exited
        return out.detach().cpu(), loss.item(), [x.cpu() for x in torch.autograd.grad(loss, params)]

    ref, ref_loss, ref_grads = run(cpu, lc, "cpu")
    _reset_launches()
    out, loss, grads = run(gpu, lg, "cuda")
    launches = _launches()
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    gmax = max(gr.abs().max().item() for gr in ref_grads)
    gerr = max((gd - gr).abs().max().item() for gd, gr in zip(grads, ref_grads))
    print(f"forward: {tuple(out.shape)} max|ref|={scale:.3f} max_abs_err={err:.3e} (tol {1e-3 * scale:.3e}); loss "
          f"card {loss:.6f} vs CPU {ref_loss:.6f}; {len(grads)} LoRA gradients, max|ref|={gmax:.3e}, max_abs_err="
          f"{gerr:.3e} (tol {1e-3 * gmax:.3e}); kernel launches={launches}")
    check(bool(torch.isfinite(out).all()) and err <= 1e-3 * scale and gerr <= 1e-3 * gmax
          and launches == _counts(2, 2, 2), "the LoRA multiplier under recompute disagrees between card and CPU")
    del gpu, cpu, lg, lc
    gc.collect()
    torch.cuda.empty_cache()


def slider_phases(card: str, sd15_path: str) -> dict:
    """The slider and extract files (configs/examples/train_slider.yaml,
    train_ultimate_slider.yaml, extract_lora.yaml) as written but for their
    paths and steps, on the seeded full-width SD 1.5 LDM file; the flux
    slider (train_slider.yaml's slider block on flux-dev cut to
    FLUX_FAMILY_CUT); and the flux blocks with the per-sample multiplier card
    vs CPU. Returns each job's numbers."""
    import numpy as np
    from safetensors.torch import save_file

    import ai_toolkit_tpu_torch.jobs.slider_process as sp
    import ai_toolkit_tpu_torch.jobs.ultimate_slider_process as usp
    from ai_toolkit_tpu_torch.jobs.extract_process import model_kernels

    out: dict = {}
    phase(f"concept slider job, configs/examples/train_slider.yaml as written on the SD 1.5 LDM file (sd1, rank 8, "
          f"guidance 3.0, 512x512, ddpm, adamw 2e-4), {SLIDER_STEPS} steps")
    print("flash kernel launches a step: 0 (SD 1.5's heads are 40, 80 and 160 wide: the plain attention)")
    raw = _slider_file("train_slider.yaml", "smoke_slider_sd15", sd15_path, train={"steps": SLIDER_STEPS})
    result, proc, seen, peak, wall = _run_slider(raw, sp, "concept_slider_loss")
    check(all(s["launches"] == _counts() for s in seen.steps) and not seen.denoise, "the SD 1.5 slider launched a kernel")
    check(len(proc.setup.lora) == SD15_LORA_MODULES, f"{len(proc.setup.lora)} LoRA modules, not {SD15_LORA_MODULES}")
    _check_slider_lora(result, proc, flow=False)
    ms = [s["ms"] for s in seen.steps]
    print(f"{card}: SD 1.5 slider step median {statistics.median(ms[TRAIN_WARMUP:]):.1f} ms (min {min(ms):.1f}, "
          f"max {max(ms):.1f}), peak {peak:.2f} GiB")
    out["slider_sd15"] = {"step_ms": ms, "peak_gib": peak, "wall_s": wall, "load_s": result["load_s"]}

    # the extract phase's weights: the UNet's 2-D kernels as the JAX tree holds them, [in, out] f32
    base = {name: k.contiguous() for name, k in model_kernels(proc.setup.variables["unet"]).items()}
    del proc
    gen = torch.Generator("cuda").manual_seed(17)
    check(set(EXTRACT_CHANGED) <= set(base), f"{sorted(set(EXTRACT_CHANGED) - set(base))} are no UNet Linear")
    deltas = {}
    for name in EXTRACT_CHANGED:
        fin, fout = base[name].shape
        deltas[name] = (torch.randn((fin, 8), generator=gen, device="cuda")
                        @ torch.randn((8, fout), generator=gen, device="cuda")) * 0.01
    files = {side: os.path.join(OUT_DIR, f"unet_{side}_weights.safetensors") for side in ("base", "tuned")}
    t0 = time.perf_counter()
    save_file({f"{k}.kernel": v.cpu() for k, v in base.items()}, files["base"])
    save_file({f"{k}.kernel": (v + deltas[k] if k in deltas else v).cpu() for k, v in base.items()}, files["tuned"])
    gib = os.path.getsize(files["base"]) / 2**30
    print(f"flat UNet weights: {len(base)} kernels, {gib:.2f} GiB a file, both written in "
          f"{time.perf_counter() - t0:.2f} s; rank-8 deltas on {len(deltas)} modules")
    del base

    pos = _train_dataset(n=4, size=512, name="slider_pos", caption="a photo of a smiling person, {}")
    neg = _train_dataset(n=4, size=512, name="slider_neg", caption="a photo of a frowning person, {}", seed=1)
    phase(f"ultimate slider job, configs/examples/train_ultimate_slider.yaml as written on the SD 1.5 LDM file (batch "
          f"2 of 512x512 pairs from two seeded folders with the same file names, image and concept losses at weight "
          f"1.0, ddpm, adamw), {SLIDER_STEPS} steps")
    raw = _slider_file("train_ultimate_slider.yaml", "smoke_ultimate_sd15", sd15_path, train={"steps": SLIDER_STEPS},
                       datasets={"folder_path": pos, "unconditional_path": neg})
    both = {}

    def first_grads(setup, value):  # each loss's own gradient on the first step: both must reach the LoRA
        for what, part in zip(("img_loss", "cfg_loss"), value[1:]):
            grads = torch.autograd.grad(part, setup.params, retain_graph=True)
            both[what] = math.sqrt(sum(float(g.square().sum()) for g in grads))

    result, proc, seen, peak, wall = _run_slider(raw, usp, "ultimate_slider_loss", first_grads)
    print(f"img_loss per step: {', '.join(f'{x:.5f}' for x in result['img_losses'])}; cfg_loss per step: "
          f"{', '.join(f'{x:.5f}' for x in result['cfg_losses'])}; first step's gradient norms: img_loss "
          f"{both['img_loss']:.3e}, cfg_loss {both['cfg_loss']:.3e}")
    check(all(math.isfinite(x) for x in result["img_losses"] + result["cfg_losses"])
          and both["img_loss"] > 0 and both["cfg_loss"] > 0, "an ultimate slider loss is not finite or moves nothing")
    check(all(s["launches"] == _counts() for s in seen.steps), "the SD 1.5 ultimate slider launched a kernel")
    _check_slider_lora(result, proc, flow=False)
    ms = [s["ms"] for s in seen.steps]
    print(f"{card}: SD 1.5 ultimate slider step (batch 2 pairs, the negatives' VAE encode included) median "
          f"{statistics.median(ms[TRAIN_WARMUP:]):.1f} ms (min {min(ms):.1f}, max {max(ms):.1f}), peak {peak:.2f} GiB")
    out["ultimate_sd15"] = {"step_ms": ms, "peak_gib": peak, "wall_s": wall, "grad_norms": both}
    del proc

    phase("extract job, configs/examples/extract_lora.yaml as written (rank 32, PEFT) on the flat UNet weights and "
          "the same weights with seeded rank-8 deltas on six modules")
    from ai_toolkit_tpu_torch.jobs import get_job

    raw = _slider_file("extract_lora.yaml", "smoke_extract", "", base_weights=files["base"],
                       tuned_weights=files["tuned"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    job = get_job(raw, device="cuda")
    (result,) = job.run()
    lora = job.processes[0].lora
    check(sorted(lora) == sorted(EXTRACT_CHANGED), f"extracted {sorted(lora)}: an untouched module was written "
                                                   f"or a changed one was not")
    worst = 0.0
    for name, leaf in lora.items():
        prod = (leaf["a"].double() @ leaf["b"].double()) * leaf["scale"].double()
        err = ((prod - deltas[name].double()).abs().max() / deltas[name].abs().max()).item()
        worst = max(worst, err)
        print(f"  {name}: [{leaf['a'].shape[0]}, {leaf['b'].shape[1]}] rank {leaf['a'].shape[1]}, "
              f"max|a b s - delta| / max|delta| = {err:.3e}")
    check(worst <= 1e-4, f"a delta is recovered to {worst:.3e} of its max, not 1e-4")
    from safetensors import safe_open

    with safe_open(result["output"], framework="pt") as f:
        keys = set(f.keys())
    want = {f"transformer.{n}.lora_{ab}.weight" for n in EXTRACT_CHANGED for ab in "AB"}
    check(keys == want, f"the extracted file's keys {sorted(keys - want)[:3]} / {sorted(want - keys)[:3]}")
    print(f"{card}: SVD of {len(lora)} modules in float64 {result['svd_s']:.3f} s, weights read in "
          f"{result['load_s']:.2f} s; {result['output']}: {result['bytes'] / 2**20:.3f} MiB, the six modules' PEFT "
          f"keys only; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    out["extract"] = {"svd_s": result["svd_s"], "load_s": result["load_s"], "bytes": result["bytes"],
                      "worst_rel_err": worst}
    del job, lora, deltas
    for f in files.values():
        os.remove(f)

    blocks = sum(FLUX_FAMILY_CUT)
    step_want, denoise_want = _counts(4 * blocks, blocks, blocks), _counts(fwd=blocks)
    phase(f"flux slider: train_slider.yaml's slider block (guidance 3.0, rank 8, adamw, 512x512, max_denoising_steps "
          f"40) on seeded flux-dev cut to {FLUX_FAMILY_CUT[0]} + {FLUX_FAMILY_CUT[1]} blocks, flowmatch, "
          f"{SLIDER_STEPS} steps")
    print(f"expected flash launches: {step_want} a train step (three priors and the adapter's forward, one backward; "
          f"no recompute), {denoise_want} a denoise step")
    raw = _slider_file("train_slider.yaml", "smoke_slider_flux", "", train={"steps": SLIDER_STEPS,
                                                                            "noise_scheduler": "flowmatch"},
                       model={"arch": "flux", "model_kwargs": {"size": "dev"}})
    with flux_cut_depth():
        result, proc, seen, peak, wall = _run_slider(raw, sp, "concept_slider_loss")
    per_denoise = [{k: v // max(d["steps"], 1) for k, v in d["launches"].items()} for d in seen.denoise]
    print(f"denoise steps per train step: {[d['steps'] for d in seen.denoise]}; launches a train step "
          f"{seen.steps[0]['launches']}, a denoise step {per_denoise[0]}")
    check(all(s["launches"] == step_want for s in seen.steps), f"flux slider step launches {seen.steps}")
    check(len(seen.denoise) == SLIDER_STEPS and all(1 <= d["steps"] < 39 for d in seen.denoise)
          and all(d["launches"] == {k: v * d["steps"] for k, v in denoise_want.items()} for d in seen.denoise),
          f"flux slider denoise launches {seen.denoise}")
    _check_slider_lora(result, proc, flow=True)
    ms = [s["ms"] for s in seen.steps]
    dn = [d["ms"] / d["steps"] for d in seen.denoise]
    print(f"{card}: flux slider ({FLUX_FAMILY_CUT[0]} + {FLUX_FAMILY_CUT[1]} blocks) train step median "
          f"{statistics.median(ms[TRAIN_WARMUP:]):.1f} ms (min {min(ms):.1f}, max {max(ms):.1f}), denoise step median "
          f"{statistics.median(dn):.2f} ms, peak {peak:.2f} GiB, job wall {wall:.1f} s")
    out["slider_flux"] = {"step_ms": ms, "denoise_step_ms": dn, "denoise_steps": [d["steps"] for d in seen.denoise],
                          "per_step": seen.steps[0]["launches"], "per_denoise_step": per_denoise[0],
                          "peak_gib": peak, "wall_s": wall}
    del proc
    slider_block_reference()
    return out


def wan_reference(label: str, cfg, fwd_launches: dict, step_launches: dict, img_tokens: int = 0,
                  grid: tuple[int, int, int] = (3, 10, 14), text_tokens: int = 512) -> None:
    """A full-width Wan DiT (``cfg``) cut to one block, in f32, on the card
    against the same module on the CPU (which takes the flash kernels' plain
    versions), over a ragged latent grid (3 x 10 x 14, 105 tokens; the 1-D
    DiT of ACE-Step: 105 x 1 x 1), ``text_tokens`` text tokens and, for an
    i2v DiT, ``img_tokens`` CLIP-vision tokens through ``img_emb``: the
    forward, and one LoRA training step's loss and a / b gradients with the
    block checkpointed, as in training."""
    phase(f"full-width {label} DiT (one block, f32, 105 tokens): card vs CPU")
    from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora
    from ai_toolkit_tpu_torch.models.wan_dit import WanDiT, wan_lora_targets, wan_patchify, wan_position_ids
    from ai_toolkit_tpu_torch.ops.layers import init_parameters
    from ai_toolkit_tpu_torch.ops.rope import multi_axis_rope

    cfg = dataclasses.replace(cfg, num_layers=1, dtype=torch.float32, remat=False)
    gpu = init_parameters(WanDiT(cfg, device="cuda"), torch.Generator("cuda").manual_seed(0))
    gpu.eval().requires_grad_(False)
    cpu = WanDiT(cfg, device="cpu").eval().requires_grad_(False)
    cpu.load_state_dict(gpu.state_dict())
    g = torch.Generator().manual_seed(1)
    tt, hh, ww = grid
    pt, ph, pw = cfg.patch_size
    lat = torch.randn((1, tt, hh, ww, cfg.in_channels), generator=g)
    inputs = [wan_patchify(lat, cfg.patch_size), torch.randn((1, text_tokens, cfg.text_dim), generator=g),
              torch.tensor([0.7]),
              multi_axis_rope(torch.from_numpy(wan_position_ids(tt // pt, hh // ph, ww // pw)), list(cfg.axes_dim))]
    if img_tokens:
        inputs.append(torch.randn((1, img_tokens, cfg.img_cond_dim), generator=g))
    gpu_in = [x.cuda() for x in inputs]
    _reset_launches()
    with torch.inference_mode():
        ref = cpu(*inputs)
        out = gpu(*gpu_in).cpu()
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    tol = 1e-3 * max(1.0, scale)  # f32 both sides, TF32 off; summation order only
    print(f"forward: out {tuple(out.shape)} max|ref|={scale:.3f} max_abs_err={err:.3e} (tol {tol:.3e}) "
          f"kernel launches={_launches()}")
    check(_launches() == fwd_launches and bool(torch.isfinite(out).all()) and err <= tol,
          f"the {label} DiT on the card disagrees with the CPU")

    spec = LoRASpec(rank=32, alpha=32.0, target_patterns=wan_lora_targets())
    lg = build_lora(gpu, spec, torch.Generator("cuda").manual_seed(2))
    gb = torch.Generator("cuda").manual_seed(3)
    with torch.no_grad():
        for m in lg.values():  # b non-zero, else the gradient of a is zero
            m.b.normal_(0.0, 0.01, generator=gb)
    lc = build_lora(cpu, spec, torch.Generator().manual_seed(2))
    cpu.load_state_dict(gpu.state_dict())
    gpu.gradient_checkpointing = cpu.gradient_checkpointing = True
    target = torch.randn(out.shape, generator=g)
    names = [(n, leaf) for n in lg for leaf in ("a", "b")]

    def loss_and_grads(model, lora, args, tgt):
        loss = (model(*args).float() - tgt).square().mean()
        return loss.item(), torch.autograd.grad(loss, [getattr(lora[n], leaf) for n, leaf in names])

    _reset_launches()
    ref_loss, ref_grads = loss_and_grads(cpu, lc, inputs, target)
    loss, grads = loss_and_grads(gpu, lg, gpu_in, target.cuda())
    launches = _launches()
    worst = max(((gd.cpu() - gr).abs().max() / gr.abs().max().clamp_min(1e-30)).item()
                for gd, gr in zip(grads, ref_grads))
    print(f"LoRA train step ({len(lg)} modules, checkpointed block): loss card {loss:.6f} vs CPU {ref_loss:.6f}; "
          f"{len(grads)} a / b tensors, worst max|dgrad|/max|grad| {worst:.3e} (tol 1e-3); kernel launches={launches}")
    check(abs(loss - ref_loss) <= 1e-4 * abs(ref_loss) and worst <= 1e-3 and launches == step_launches,
          f"the {label} LoRA train step on the card disagrees")
    del gpu, cpu, lg, lc, grads, ref_grads
    gc.collect()
    torch.cuda.empty_cache()


def vit_reference(layers: int = 2) -> None:
    """ViT-H (1280 wide, 16 heads of 80, 257 tokens at 224^2) cut to
    ``layers`` layers, in f32, on the card against the same module on the
    CPU: pooled_output, last_hidden_state and penultimate_hidden_state. Its
    attention is plain torch (head_dim 80), so no kernel launches."""
    phase(f"ViT-H cut to {layers} layers (f32, 224^2, 257 tokens): card vs CPU")
    from ai_toolkit_tpu_torch.models.text_encoders.clip_vision import CLIPVisionConfig, CLIPVisionModel
    from ai_toolkit_tpu_torch.ops.layers import init_parameters

    cfg = dataclasses.replace(CLIPVisionConfig.vit_h(), num_layers=layers, dtype=torch.float32)
    gpu = init_parameters(CLIPVisionModel(cfg, device="cuda"), torch.Generator("cuda").manual_seed(0)).eval()
    cpu = CLIPVisionModel(cfg, device="cpu").eval()
    cpu.load_state_dict(gpu.state_dict())
    px = torch.rand((2, 224, 224, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
    _reset_launches()
    with torch.inference_mode():
        ref, out = cpu(px), gpu(px.cuda())
    for key in ("pooled_output", "last_hidden_state", "penultimate_hidden_state"):
        err, scale = (out[key].cpu() - ref[key]).abs().max().item(), ref[key].abs().max().item()
        print(f"{key} {tuple(out[key].shape)}: max|ref|={scale:.3f} max_abs_err={err:.3e} (tol {1e-3 * max(1.0, scale):.3e})")
        check(bool(torch.isfinite(out[key]).all()) and err <= 1e-3 * max(1.0, scale),
              f"ViT-H {key} on the card disagrees with the CPU")
    check(_launches() == _counts(), f"ViT-H launched flash kernels: {_launches()}")
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()


def vae22_reference(frames: int = 5, size: int = 64) -> None:
    """The TI2V-5B VAE (``WanVAEConfig.wan22_5b``: base 160, decoder base 256,
    48 latent channels, 2x2 patchify, residual blocks) at full width in f32,
    on the card against the same module on the CPU over a short seeded clip:
    the raw encoder moments and the decode of the latents."""
    phase(f"full-width TI2V-5B VAE (f32, {frames} frames at {size}^2): card vs CPU, encode and decode")
    from ai_toolkit_tpu_torch.models.wan_vae import WanVAE, WanVAEConfig
    from ai_toolkit_tpu_torch.ops.layers import init_parameters

    cfg = dataclasses.replace(WanVAEConfig.wan22_5b(), dtype=torch.float32)
    gpu = init_parameters(WanVAE(cfg, device="cuda"), torch.Generator("cuda").manual_seed(0)).eval()
    cpu = WanVAE(cfg, device="cpu").eval()
    cpu.load_state_dict(gpu.state_dict())
    vid = torch.rand((1, frames, size, size, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
    with torch.inference_mode():
        ref_mom, mom = cpu.raw_moments(vid), gpu.raw_moments(vid.cuda()).cpu()
        lat = ref_mom[..., :cfg.z_dim].contiguous()
        ref_img, img = cpu.decode(lat), gpu.decode(lat.cuda()).cpu()
    check(mom.shape == (1, (frames - 1) // 4 + 1, size // 16, size // 16, 2 * cfg.z_dim) and img.shape == vid.shape,
          f"TI2V-5B VAE shapes {tuple(mom.shape)}, {tuple(img.shape)}")
    for what, got, want in (("encoder moments", mom, ref_mom), ("decode", img, ref_img)):
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        print(f"{what} {tuple(got.shape)}: max|ref|={scale:.3f} max_abs_err={err:.3e} (tol {1e-3 * max(1.0, scale):.3e})")
        check(bool(torch.isfinite(got).all()) and err <= 1e-3 * max(1.0, scale),
              f"the TI2V-5B VAE's {what} on the card disagree with the CPU")
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()


def _wan_clips(n: int = WAN_RES) -> str:
    """WAN_CLIPS seeded WAN_FRAMES-frame clips at n^2 (moving colour fields
    plus noise), written with OpenCV as MJPG .avi, with captions; at the
    bucket's size, so the loader's cover-resize keeps their size."""
    import cv2
    import numpy as np

    folder = os.path.join(OUT_DIR, f"wan_clips_{n}")
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) / n
    subjects = ["a red fox running", "waves on a beach", "a candle flame", "clouds over a mountain lake"]
    for i in range(WAN_CLIPS):
        f, ph = rng.uniform(1, 6, 3), rng.uniform(0, 6.3, 3)
        wr = cv2.VideoWriter(os.path.join(folder, f"clip_{i}.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 16, (n, n))
        check(wr.isOpened(), "cv2.VideoWriter cannot write MJPG")
        for j in range(WAN_FRAMES):
            img = np.stack([np.sin(f[c] * 6.3 * (xx + yy * (c + 1) / 3 + 0.02 * j) + ph[c]) for c in range(3)], -1)
            img = 127.5 * (img + 1) + rng.normal(0, 8, img.shape)
            wr.write(np.clip(img, 0, 255).astype(np.uint8))
        wr.release()
        with open(os.path.join(folder, f"clip_{i}.txt"), "w") as fh:
            fh.write(f"a video of {subjects[i % len(subjects)]}")
    return folder


def _job_file(example: str, name: str, profile_dir: str | None, clips: str, **dataset) -> tuple[dict, str]:
    """An example job file cut to this run (seeded random weights, the seeded
    clips, latents cached in memory, no sample section, a few steps),
    returned with the path to write it to."""
    from ai_toolkit_tpu_torch.config import get_config

    raw = get_config(os.path.join(ROOT, "configs", "examples", example))
    raw["config"]["name"] = name
    proc = raw["config"]["process"][0]
    proc["training_folder"] = os.path.join(OUT_DIR, "train")
    proc["datasets"][0].update(folder_path=clips, cache_latents=True, cache_latents_to_disk=False, **dataset)
    proc["train"].update(steps=_train_steps(profile_dir), seed=42)
    proc["model"]["name_or_path"] = ""
    proc.pop("sample")
    proc["logging"] = {"log_every": 1}
    return raw, os.path.join(OUT_DIR, f"{name}.yaml")


def _read_back(raw: dict, path: str, example: str) -> dict:
    """Write the job file and read it back through the port's config loader."""
    import yaml

    from ai_toolkit_tpu_torch.config import get_config

    with open(path, "w") as f:
        yaml.safe_dump(raw, f, sort_keys=False)
    print(f"job file {path} (from configs/examples/{example})")
    return get_config(path)


def _wan_job(name: str, profile_dir: str | None, arch: str = "wan21", res: int = WAN_RES) -> dict:
    """A Wan LoRA job: configs/examples/train_lora_wan21_tpu.yaml cut to this
    run. It keeps rank 32 / alpha 32, adamw at lr 1e-4, flowmatch with shift
    timesteps, bf16, batch 1, 33 frames and the fp16 save; ``arch`` and
    ``res`` (the TI2V-5B: ``wan22_5b`` at 704) replace its own."""
    example = "train_lora_wan21_tpu.yaml"
    raw, path = _job_file(example, name, profile_dir, _wan_clips(res), resolution=[res])
    raw["config"]["process"][0]["model"]["arch"] = arch
    job = _read_back(raw, path, example)
    p = job["config"]["process"][0]
    t, d, net = p["train"], p["datasets"][0], p["network"]
    check(p["model"]["arch"] == arch and t["timestep_type"] == "shift" and t["optimizer"] == "adamw"
          and t["dtype"] == "bf16" and d["num_frames"] == WAN_FRAMES and d["resolution"] == [res]
          and net["linear"] == net["linear_alpha"] == 32 and p["save"]["dtype"] == "float16",
          f"{path} lost the job's settings")
    return job


def _wan14_job(name: str, profile_dir: str | None) -> dict:
    """The Wan 2.2 14B i2v LoRA job: configs/examples/train_lora_wan22_14b_tpu.yaml
    cut to this run, with ``arch: wan22_14b_i2v``, ``model_kwargs: {size: 14b}``
    (the file leaves size to its 1.3b default), ``do_i2v`` and
    ``switch_boundary_every: 2`` (steps high, high, low, low, high). It keeps
    the qfloat8 base, rank 16 / alpha 16, adamw8bit at lr 1e-4, EMA 0.99,
    flowmatch with shift timesteps, bf16, batch 1, 33 frames at 480,
    per-block recompute and the fp16 save."""
    example = "train_lora_wan22_14b_tpu.yaml"
    raw, path = _job_file(example, name, profile_dir, _wan_clips(WAN_RES), do_i2v=True)
    proc = raw["config"]["process"][0]
    proc["model"].update(arch="wan22_14b_i2v", model_kwargs={"size": "14b"})
    proc["train"]["switch_boundary_every"] = 2
    job = _read_back(raw, path, example)
    p = job["config"]["process"][0]
    t, d, net, m = p["train"], p["datasets"][0], p["network"], p["model"]
    check(m["quantize"] and m.get("qtype", "qfloat8") == "qfloat8" and t["optimizer"] == "adamw8bit"
          and t["ema_config"] == {"use_ema": True, "ema_decay": 0.99} and t["timestep_type"] == "shift"
          and t["dtype"] == "bf16" and t["gradient_checkpointing"] and d["num_frames"] == WAN_FRAMES
          and d["resolution"] == [WAN_RES] and d["do_i2v"] and net["linear"] == net["linear_alpha"] == 16
          and p["save"]["dtype"] == "float16", f"{path} lost the job's settings")
    return job


def _ctrl_image(width: int, height: int) -> str:
    """A seeded first frame for i2v generation (a smooth colour field plus noise)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32) / max(width, height)
    img = np.stack([np.sin(6.3 * (c + 1) * (xx + 0.5 * yy)) for c in range(3)], -1) * 127.5 + 127.5
    path = os.path.join(OUT_DIR, f"ctrl_{width}x{height}.png")
    os.makedirs(OUT_DIR, exist_ok=True)
    Image.fromarray(np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)).save(path)
    return path


def wan22_phases(profile_dir: str | None) -> tuple[dict, dict, dict]:
    """The phases of the rest of slice E (the Wan 2.2 14B i2v pair and the
    TI2V-5B): the flash kernels at their shapes, the full-width cuts, both
    train jobs and both generate jobs. Returns the flash errors, the flash
    times and the 14B train job's report."""
    from ai_toolkit_tpu_torch.models.wan_dit import WanConfig

    neg = torch.Generator("cuda").manual_seed(10)
    wan22_err = flash_checks(
        "flash kernels vs plain versions at the Wan 2.2 14B (40 heads) and TI2V-5B (24 heads) shapes, bf16",
        [(shape, label, full, None) for shape, label, full in WAN22_SHAPES]
        + [(shape, label, True, _negative_qkv(shape, 3.2, neg)) for shape, label in WAN22_NEGATIVE], 7)
    wan22_times = attention_times("flash kernels at the Wan 2.2 shapes (head_dim 128), bf16", "Wan 2.2",
                                  WAN22_SHAPES, 9)
    # one i2v block: self, text and image cross-attention; the checkpointed step runs all three again
    wan_reference("Wan 2.2 14B i2v (img_emb, the image K/V)", dataclasses.replace(WanConfig.wan21_14b(), i2v=True),
                  _counts(fwd=3), _counts(6, 3, 3), img_tokens=257)
    vit_reference()
    vae22_reference()

    phase("main path of this slice: Wan 2.2 14B i2v LoRA sd_trainer job (the expert pair, qfloat8), 33 frames at "
          "480x480 (8,100 tokens), do_i2v, switch_boundary_every 2, batch 1, rank 16, adamw8bit, EMA, flowmatch "
          "shift, bf16, per-block checkpointing")
    # per step: the three attentions of every block run their forward twice (the
    # recompute), dq and dk/dv once; the expert of the step's noise range runs
    wan14_step = _counts(6 * WAN14_BLOCKS, 3 * WAN14_BLOCKS, 3 * WAN14_BLOCKS)
    wan14 = train_job("smoke_wan22_14b_i2v_lora", {}, wan14_step, profile_dir,
                      raw=_wan14_job("smoke_wan22_14b_i2v_lora", profile_dir))
    want = ["dit" if (i // 2) % 2 == 0 else "dit_low" for i in range(wan14["steps"])]
    check(wan14["experts"] == want, f"experts by step {wan14['experts']} != {want}")

    phase(f"Wan 2.2 14B i2v generate job, 480x480, {WAN_FRAMES} frames (8,100 tokens), 8 Euler steps, 1 prompt "
          f"with a seeded first frame, bf16 pair, with the trained LoRA")
    wan14_gen = generate_job({"name_or_path": "", "arch": "wan22_14b_i2v", "model_kwargs": {"size": "14b"}},
                             WAN_RES, WAN_RES, 8, [{"prompt": "a video of a red fox running through tall grass",
                                                    "ctrl_img": _ctrl_image(WAN_RES, WAN_RES)}],
                             _counts(fwd=3 * WAN14_BLOCKS), lora_path=wan14["lora_path"], num_frames=WAN_FRAMES)

    phase(f"Wan 2.2 TI2V-5B LoRA sd_trainer job, 33 frames at {WAN5_RES}x{WAN5_RES} (4,356 tokens), batch 1, "
          f"rank 32, adamw, flowmatch shift, bf16, per-block checkpointing")
    wan5_step = _counts(4 * WAN5_BLOCKS, 2 * WAN5_BLOCKS, 2 * WAN5_BLOCKS)
    wan5 = train_job("smoke_wan22_5b_lora", {}, wan5_step, profile_dir,
                     raw=_wan_job("smoke_wan22_5b_lora", profile_dir, "wan22_5b", WAN5_RES))

    width, height, frames, steps5 = WAN5_GEN
    phase(f"Wan 2.2 TI2V-5B generate job, {width}x{height}, {frames} frames (11,440 tokens), {steps5} Euler steps, "
          f"1 prompt, with the trained LoRA, every frame decoded at once")
    wan5_gen = generate_job({"name_or_path": "", "arch": "wan22_5b"}, width, height, steps5,
                            ["a video of waves breaking on a beach at sunset"], _counts(fwd=2 * WAN5_BLOCKS),
                            lora_path=wan5["lora_path"], num_frames=frames)
    print(json.dumps({"wan22_launches": {
        "14b_train_per_step": {k: v / wan14["steps"] for k, v in wan14["launches"].items()},
        "14b_denoise_per_step": {k: v / 8 for k, v in wan14_gen.items()},
        "5b_train_per_step": {k: v / wan5["steps"] for k, v in wan5["launches"].items()},
        "5b_denoise_per_step": {k: v / steps5 for k, v in wan5_gen.items()},
        "ms": {label: {k: row[k]["ms"] for k in row} for label, row in wan22_times.items()}}}))
    return wan22_err, wan22_times, wan14


def _control_folders() -> tuple[str, str]:
    """Seeded control images for the four training images (same file names,
    1152x896, so each is cover-resized and cropped to every bucket), and one
    seeded inpaint image for img_0: an RGBA whose alpha keeps an ellipse and
    marks the rest for inpainting. Written once."""
    import numpy as np
    from PIL import Image

    ctrl, inp = os.path.join(OUT_DIR, "train_control"), os.path.join(OUT_DIR, "train_inpaint")
    if os.path.isfile(os.path.join(inp, "img_0.png")):
        return ctrl, inp
    os.makedirs(ctrl, exist_ok=True)
    os.makedirs(inp, exist_ok=True)
    rng = np.random.default_rng(11)
    w, h = 1152, 896
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(4):  # edge-map-like control: bright lines on dark, plus noise
        lines = (np.sin(xx / (9 + 3 * i)) * np.cos(yy / (13 + 2 * i)) > 0.8).astype(np.float32)
        img = np.repeat(lines[..., None] * 220.0, 3, axis=-1) + rng.normal(0, 6, (h, w, 3))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(os.path.join(ctrl, f"img_{i}.png"))
    keep = (((xx - w / 2) / (0.3 * w)) ** 2 + ((yy - h / 2) / (0.35 * h)) ** 2 <= 1.0).astype(np.uint8) * 255
    rgba = np.concatenate([rng.integers(0, 255, (h, w, 3), dtype=np.uint8), keep[..., None]], axis=-1)
    Image.fromarray(rgba, "RGBA").save(os.path.join(inp, "img_0.png"))
    return ctrl, inp


# the flux family's shipped files: (arch, file, the folders chip_smoke adds to its dataset)
FLUX_FAMILY = [("chroma", "train_lora_chroma_tpu.yaml", ()), ("flex1", "train_lora_flex_tpu.yaml", ()),
               ("flex2", "train_lora_flex2_tpu.yaml", ("control_path", "inpaint_path")),
               ("flux_kontext", "train_lora_flux_kontext_tpu.yaml", ("control_path",))]


# the four flux-family files and the flex2 generate job run at this many double + single
# blocks of flux-dev's 19 + 38, widths unchanged: each block still launches every flash
# kernel (15 launches a step instead of 57), and the cut makes room for the audio phases
FLUX_FAMILY_CUT = (5, 10)


@contextlib.contextmanager
def flux_cut_depth(double: int = FLUX_FAMILY_CUT[0], single: int = FLUX_FAMILY_CUT[1]):
    """flux-dev's DiT config at ``double`` + ``single`` blocks for the block
    (``FluxConfig.dev`` replaced; nothing in the package changes)."""
    from ai_toolkit_tpu_torch.models.flux_dit import FluxConfig

    full = FluxConfig.__dict__["dev"]
    FluxConfig.dev = classmethod(lambda cls: dataclasses.replace(full.__func__(cls), depth_double=double,
                                                                 depth_single=single))
    try:
        yield
    finally:
        FluxConfig.dev = full


def flux_family_phases(card: str, profile_dir: str | None) -> dict:
    """The flux family's phases: the chroma and flex2 DiTs card vs CPU at full
    width, the four shipped flux-family files as written (but for their
    paths and steps) on seeded weights, and the flex2 generate job with a
    ctrl_img. Returns each job's numbers."""
    from ai_toolkit_tpu_torch.config.modules import ModelConfig
    from ai_toolkit_tpu_torch.models.flux_dit import flux_lora_targets
    from ai_toolkit_tpu_torch.models.flux_model import FluxModel

    def dev_config(arch):
        return FluxModel(ModelConfig.from_dict({"name_or_path": "", "arch": arch}), device="meta").dit_config

    # the Approximator's rows run outside the blocks: the launches are flux-dev's
    dit_reference("chroma (the 5120 x 5 Approximator, no modulation projections)", dev_config("chroma"),
                  flux_lora_targets(), _counts(fwd=2), _counts(2, 2, 2))
    dit_reference("flex2 (the 196-input img_in, 64 outputs)", dev_config("flex2"), flux_lora_targets(),
                  _counts(fwd=2), _counts(2, 2, 2))
    ctrl, inp = _control_folders()
    folders = {"control_path": ctrl, "inpaint_path": inp}
    out = {}
    blocks = sum(FLUX_FAMILY_CUT)
    for arch, example, extra in FLUX_FAMILY:
        phase(f"{arch} LoRA sd_trainer job, configs/examples/{example} as written with seeded weights"
              + (f" and the seeded {' and '.join(extra)}" if extra else "")
              + f": qfloat8 base, {SHIPPED_DATA}, the disk latent cache, "
                f"its prompt at 1024x1024 and 20 steps first and final, {SHIPPED_STEPS} steps; the DiT cut to "
                f"{FLUX_FAMILY_CUT[0]} + {FLUX_FAMILY_CUT[1]} blocks")
        watch = _ControlBatches(arch) if extra else None
        with flux_cut_depth():
            out[arch] = _shipped_flux_job(card, profile_dir, example, f"smoke_{arch}_shipped", 1, watch, blocks,
                                          **{k: folders[k] for k in extra})
        if watch is not None:
            _check_control_batches(watch.seen, arch)
    phase("flex2 generate job, 1024x1024, 8 steps, 1 prompt with a seeded ctrl_img, bf16 base, with the LoRA "
          f"of the shipped flex2 job (the DiT cut to {FLUX_FAMILY_CUT[0]} + {FLUX_FAMILY_CUT[1]} blocks)")
    t0 = time.perf_counter()
    with flux_cut_depth():
        gen = generate_job({"name_or_path": "", "arch": "flex2"}, 1024, 1024, 8,
                           [{"prompt": "a photo of a lighthouse on a cliff",
                             "ctrl_img": os.path.join(ctrl, "img_1.png")}],
                           _counts(fwd=blocks), lora_path=out["flex2"]["lora_path"])
    print(f"{card}: flex2 generate job {time.perf_counter() - t0:.1f} s wall, launches {gen}")
    return {arch: {"median_step_ms_by_bucket": r["by_bucket_ms"], "peak_gib": r["peak_gib"],
                   "sample_s": r["sample_s"], "wall_s": r["wall_s"]} for arch, r in out.items()}


# SD3.5 Large (38 heads of 64) joins 231 text tokens (77 CLIP + 154 T5) to the image's:
# 1,255 / 2,535 / 4,327 tokens at 512^2 / 768^2 / 1024^2, each with a ragged tail tile
# (9 * 128 + 103, 19 * 128 + 103, 33 * 128 + 103)
SD35L_SHAPES = [((1, 4327, 4327, 38, 64), "1024^2 joint"), ((1, 2535, 2535, 38, 64), "768^2 joint"),
                ((1, 1255, 1255, 38, 64), "512^2 joint")]
SD35L_BLOCKS = 38  # 37 joint blocks and the context_pre_only one, one attention each
# the shipped SD3.5-Large file runs at this many of its 38 blocks (18 joint + the context_pre_only
# one), widths unchanged: the script's time limit (the flash kernels still run at its shapes)
SD35L_CUT_BLOCKS = 19
# the shipped MMDiT files: (arch, file, the folders chip_smoke adds, flash launches a step)
MMDIT_FILES = [("sd35_large", "train_lora_sd35_large_tpu.yaml", (), SD35L_CUT_BLOCKS),
               ("qwen_image", "train_lora_qwen_image_tpu.yaml", (), 0),
               ("qwen_image_edit", "train_lora_qwen_image_edit_tpu.yaml", ("control_path",), 0)]
# the Qwen-Image files and the edit generate job run at this many of the 60 joint blocks,
# widths unchanged: they launch no flash kernel (their masked attention is plain), so the
# cut drops no kernel check, and it keeps the script within its time limit
QWEN_CUT_BLOCKS = 3


@contextlib.contextmanager
def qwen_cut_depth(blocks: int = QWEN_CUT_BLOCKS):
    """Qwen-Image's DiT at ``blocks`` joint blocks for the block (the model
    module's ``QWEN_DIT`` replaced; nothing in the package changes)."""
    import ai_toolkit_tpu_torch.models.qwen_model as qm

    full = qm.QWEN_DIT
    qm.QWEN_DIT = dataclasses.replace(full, depth_double=blocks)
    try:
        yield
    finally:
        qm.QWEN_DIT = full


@contextlib.contextmanager
def sd35l_cut_depth(blocks: int = SD35L_CUT_BLOCKS):
    """SD3.5-Large's DiT at ``blocks`` blocks (the last the context_pre_only
    one) for the block (``sd3_model.sd3_dit_config`` wrapped; nothing in the
    package changes)."""
    import ai_toolkit_tpu_torch.models.sd3_model as sm

    full = sm.sd3_dit_config

    def cut(arch, size):
        cfg = full(arch, size)
        return dataclasses.replace(cfg, depth_double=blocks) if cfg.depth_double == SD35L_BLOCKS else cfg

    sm.sd3_dit_config = cut
    try:
        yield
    finally:
        sm.sd3_dit_config = full


def llm_reference() -> None:
    """Qwen2.5-VL-7B's text tower at full width cut to one layer, f32, q/k/v
    biases drawn non-zero, under the eos mask of 40 valid tokens of 256: the
    card against the CPU (causal, masked: the plain attention, no kernel)."""
    phase("full-width Qwen2.5-VL-7B text tower (1 layer, q/k/v biases, eos mask), f32: card vs CPU")
    from ai_toolkit_tpu_torch.models.text_encoders.llm import LLMConfig, LLMEncoder
    from ai_toolkit_tpu_torch.ops.layers import init_parameters

    cfg = dataclasses.replace(LLMConfig.qwen25_7b(), n_layers=1, dtype=torch.float32)
    gpu = init_parameters(LLMEncoder(cfg, device="cuda"), torch.Generator("cuda").manual_seed(0)).eval()
    attn = gpu.layers[0].self_attn
    with torch.no_grad():
        for lin in (attn.q_proj, attn.k_proj, attn.v_proj):
            lin.bias.normal_(0.0, 0.5, generator=torch.Generator("cuda").manual_seed(1))
    cpu = LLMEncoder(cfg, device="cpu").eval()
    cpu.load_state_dict(gpu.state_dict())
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(3, cfg.vocab_size, (1, 256), generator=g)
    mask = (torch.arange(256) < 40)[None]
    _reset_launches()
    with torch.inference_mode():
        ref = cpu(ids, mask)
        out = gpu(ids.cuda(), mask.cuda()).cpu()
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    tol = 1e-3 * max(1.0, scale)
    print(f"Qwen2.5 layer: out {tuple(out.shape)} max|ref|={scale:.3f} max_abs_err={err:.3e} (tol {tol:.3e}) "
          f"kernel launches={_launches()}")
    check(bool(torch.isfinite(out).all()) and err <= tol and _launches() == _counts(),
          "the Qwen2.5 layer on the card disagrees with the CPU")
    del gpu, cpu


QWEN_EDIT_ATTENTION = (1, 8448, 24, 128)  # 256 text + 4,096 image + 4,096 control tokens at 1024^2


def masked_attention_times(card: str, valid: int = 20, shape: tuple = QWEN_EDIT_ATTENTION,
                           label: str = "Qwen-Image-Edit's masked joint attention", n_txt: int = 256) -> dict:
    """A joint attention ``shape`` (default Qwen-Image-Edit's at 1024^2) in
    bf16 under a key-padding mask keeping ``valid`` of the ``n_txt`` text
    tokens: the plain version it runs (f32 logits,
    ``ops.attention.reference_attention``; 6.85 GB for Qwen-Image-Edit)
    against ``scaled_dot_product_attention`` with the same boolean mask,
    forward and forward with backward, CUDA events, in turns; the lever a
    key-padding flash kernel would pull (ROADMAP "Beside the queue")."""
    from ai_toolkit_tpu_torch.ops.attention import reference_attention

    phase(f"{label} {shape} bf16 ({valid} of {n_txt} text tokens valid): the plain version against SDPA")
    b, s_, h, d = shape
    gen = torch.Generator("cuda").manual_seed(16)
    q, k, v, g = (_rand(shape, torch.bfloat16, gen) for _ in range(4))
    key_ok = torch.ones((b, s_), dtype=torch.bool, device="cuda")
    key_ok[:, valid:n_txt] = False
    mask = key_ok[:, None, None, :]
    qt, kt, vt, gt = _sdpa_layout(q, k, v, g)

    def plain_fb():
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        torch.autograd.grad(reference_attention(qq, kk, vv, mask=mask), (qq, kk, vv), g)

    def sdpa_fb():
        qq, kk, vv = (x.detach().requires_grad_() for x in (qt, kt, vt))
        torch.autograd.grad(F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask), (qq, kk, vv), gt)

    ref = reference_attention(q, k, v, mask=mask).float()
    err = (F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask).transpose(1, 2).float() - ref).abs().max()
    del ref
    out = {}
    for label, plain, lib in (("forward", lambda: reference_attention(q, k, v, mask=mask),
                               lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)),
                              ("forward and backward", plain_fb, sdpa_fb)):
        lib_ms, plain_ms, n = _in_turns(lib, plain, reps=5)
        out[label] = {"plain_ms": plain_ms, "sdpa_ms": lib_ms}
        print(f"{card}: {label}: plain {plain_ms:.4f} ms, SDPA with the mask {lib_ms:.4f} ms "
              f"({plain_ms / lib_ms:.2f}x; medians of {n})")
    t = s_ - (n_txt - valid)  # the keys the mask keeps
    bound, by = _bound_ms(4 * b * h * s_ * t * d, 2 * (2 * b * s_ * h * d + 2 * b * t * h * d))
    print(f"forward bound over the {t} kept keys {bound:.4f} ms ({by}); SDPA max|out - plain| {err.item():.3e}")
    check(err.item() <= 2e-2, "SDPA with the mask disagrees with the plain masked attention")
    del q, k, v, g, qt, kt, vt, gt
    torch.cuda.empty_cache()
    return {**out, "bound_ms": bound, "bound_by": by}


def mmdit_phases(card: str, profile_dir: str | None) -> dict:
    """The MMDiT slice: SD3.5-Large, sd3.5-medium and Qwen-Image DiT blocks and
    a Qwen2.5 layer card vs CPU, the flash kernels at SD3.5 Large's shapes, the
    three shipped files as written (but for their paths and steps) on seeded
    weights, and the qwen_image_edit generate job with a ctrl_img and the
    LoRA it saved. Returns each job's numbers and the flash times."""
    from ai_toolkit_tpu_torch.models.flux_dit import flux_lora_targets
    from ai_toolkit_tpu_torch.models.qwen_model import QWEN_DIT
    from ai_toolkit_tpu_torch.models.sd3_model import sd3_dit_config

    dit_reference("SD3.5-Large (38 x 64 heads, the learned position table)", sd3_dit_config("sd35_large", "large"),
                  flux_lora_targets(), _counts(fwd=2), _counts(2, 2, 2),
                  cut={"depth_double": 2}, blocks="1 joint block + the context_pre_only block")
    dit_reference("sd3.5-medium (24 x 64 heads)", sd3_dit_config("sd35", "medium"), flux_lora_targets(),
                  _counts(fwd=2), _counts(2, 2, 2),
                  cut={"depth_double": 1, "dual_attention_layers": 1, "final_context_pre_only": False},
                  blocks="1 dual-attention block: the joint and the image-only attention")
    # the padded mask sends the joint attention to the plain path, as JAX sends it to XLA
    dit_reference("Qwen-Image (24 x 128 heads)", QWEN_DIT, flux_lora_targets(), _counts(), _counts(),
                  cut={"depth_double": 1}, blocks="1 joint block, 20 of 32 text tokens, a control segment",
                  txt_valid=20, ctrl=True)
    llm_reference()
    neg = torch.Generator("cuda").manual_seed(12)
    shape = (1, 1255, 1255, 38, 64)
    err = flash_checks("flash kernels vs plain versions at SD3.5 Large's shapes (38 x 64 heads), bf16",
                       [(s, label, True, None) for s, label in SD35L_SHAPES]
                       + [(shape, "512^2 joint, negative logits", True, _negative_qkv(shape, 3.8, neg))], 13)
    times = attention_times("flash kernels at SD3.5 Large's shapes (38 x 64 heads), bf16", "SD3.5-L",
                            [(s, label, True) for s, label in SD35L_SHAPES], 14)
    masked = masked_attention_times(card)
    ctrl, _ = _control_folders()
    out = {}
    for arch, example, extra, blocks in MMDIT_FILES:
        qwen = arch.startswith("qwen")
        phase(f"{arch} LoRA sd_trainer job, configs/examples/{example} as written with seeded weights"
              + (f" and the seeded {' and '.join(extra)}" if extra else "")
              + f": qfloat8 base, {SHIPPED_DATA}, the disk latent cache, "
                f"its prompt at 1024x1024 and 20 steps first and final, {SHIPPED_STEPS} steps, {blocks} flash "
                f"launches a step"
              + (f"; the DiT cut to {QWEN_CUT_BLOCKS} of its 60 joint blocks, widths unchanged" if qwen else
                 f"; the DiT cut to {SD35L_CUT_BLOCKS} of its {SD35L_BLOCKS} blocks, widths unchanged"))
        watch = _ControlBatches(arch) if extra else None
        with qwen_cut_depth() if qwen else sd35l_cut_depth():
            out[arch] = _shipped_flux_job(card, profile_dir, example, f"smoke_{arch}_shipped", 1, watch, blocks,
                                          **{k: ctrl for k in extra})
        if watch is not None:
            _check_control_batches(watch.seen, arch)
    phase(f"qwen_image_edit generate job, 1024x1024, 8 steps, 1 prompt with a seeded ctrl_img, bf16 base, with the "
          f"LoRA of the shipped qwen_image_edit job (8,448 tokens, the plain masked attention; {QWEN_CUT_BLOCKS} "
          f"joint blocks)")
    t0 = time.perf_counter()
    with qwen_cut_depth():
        gen = generate_job({"name_or_path": "", "arch": "qwen_image_edit"}, 1024, 1024, 8,
                           [{"prompt": "a photo of a lighthouse on a cliff",
                             "ctrl_img": os.path.join(ctrl, "img_1.png")}],
                           _counts(), lora_path=out["qwen_image_edit"]["lora_path"])
    print(f"{card}: qwen_image_edit generate job {time.perf_counter() - t0:.1f} s wall, launches {gen}")
    return {"jobs": {arch: {"median_step_ms_by_bucket": r["by_bucket_ms"], "peak_gib": r["peak_gib"],
                            "sample_s": r["sample_s"], "wall_s": r["wall_s"]} for arch, r in out.items()},
            "flash_max_abs_err": err, "qwen_edit_masked_attention": masked,
            "flash_ms": {label: {k: row[k]["ms"] for k in row} for label, row in times.items()},
            "flash_device_ms": {label: {k: row[k]["device_ms"] for k in row} for label, row in times.items()},
            "sdpa_ms": {label: {"fwd": row["fwd"]["library_ms"], "bwd": row["dq"]["library_ms"]}
                        for label, row in times.items()}}


def nextdit_reference(label: str, cfg, targets: list[str], refs: int = 0) -> None:
    """A full-width NextDiT (Lumina2, or OmniGen2 with ``refs`` reference
    images) cut to 1 joint layer and 1 refiner of each kind, in f32, its RMS
    scales drawn away from 1, on the card against the same module on the
    CPU: the forward and one checkpointed LoRA step's loss and gradients
    (``targets``), over 32 caption tokens of which 20 are valid and an
    8 x 12 patch grid (references 6 x 8). Every attention is masked or at
    head dim 96 / 120: the plain path, 0 flash launches."""
    phase(f"full-width {label} DiT (1 joint layer, 1 refiner of each kind, 20 of 32 caption tokens valid"
          + (f", {refs} reference image" if refs else "") + ", f32): card vs CPU")
    from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora
    from ai_toolkit_tpu_torch.models.lumina2_dit import Lumina2DiT, lumina2_pos_angles
    from ai_toolkit_tpu_torch.models.omnigen2_dit import OmniGen2DiT, omnigen2_pos_angles
    from ai_toolkit_tpu_torch.ops.layers import init_parameters

    cfg = dataclasses.replace(cfg, n_layers=1, n_refiner_layers=1, dtype=torch.float32)
    cls = OmniGen2DiT if refs else Lumina2DiT
    gpu = init_parameters(cls(cfg, device="cuda"), torch.Generator("cuda").manual_seed(0))
    gpu.eval().requires_grad_(False)
    with torch.no_grad():
        gn = torch.Generator("cuda").manual_seed(5)
        for name, prm in gpu.named_parameters():
            if prm.dim() == 1 and "norm" in name and name.endswith("weight"):
                prm.normal_(1.0, 0.2, generator=gn)
    cpu = cls(cfg, device="cpu").eval().requires_grad_(False)
    cpu.load_state_dict(gpu.state_dict())
    g = torch.Generator().manual_seed(1)
    n_txt, hp, wp, rh, rw = 32, 8, 12, 6, 8
    ppc = cfg.patch_size ** 2 * cfg.in_channels
    cap_lens = torch.tensor([20])
    mask = (torch.arange(n_txt) < 20)[None]
    if refs:
        ca, ia, ra = omnigen2_pos_angles(cfg, hp, wp, cap_lens, n_txt, ref_hw=(rh, rw), n_ref=refs)
        extra = [torch.randn((1, refs, rh * rw, ppc), generator=g), ra]
    else:
        ca, ia = lumina2_pos_angles(cfg, hp, wp, cap_lens, n_txt)
        extra = []
    inputs = [torch.randn((1, hp * wp, ppc), generator=g), torch.randn((1, n_txt, cfg.cap_feat_dim), generator=g),
              torch.tensor([0.3]), mask, ia, ca, *extra]
    gpu_in = [x.cuda() for x in inputs]
    _reset_launches()
    with torch.inference_mode():
        ref = cpu(*inputs)
        out = gpu(*gpu_in).cpu()
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    tol = 1e-3 * max(1.0, scale)  # f32 both sides, TF32 off; summation order only
    print(f"forward: out {tuple(out.shape)} max|ref|={scale:.3f} max_abs_err={err:.3e} (tol {tol:.3e}) "
          f"kernel launches={_launches()}")
    check(_launches() == _counts() and bool(torch.isfinite(out).all()) and err <= tol,
          f"the {label} DiT on the card disagrees with the CPU")
    spec = LoRASpec(rank=16, alpha=16.0, target_patterns=targets)
    lg = build_lora(gpu, spec, torch.Generator("cuda").manual_seed(2))
    gb = torch.Generator("cuda").manual_seed(3)
    with torch.no_grad():
        for m in lg.values():  # b non-zero, else a's gradient is zero and proves nothing
            m.b.normal_(0.0, 0.01, generator=gb)
    lc = build_lora(cpu, spec, torch.Generator().manual_seed(2))
    cpu.load_state_dict(gpu.state_dict())
    gpu.gradient_checkpointing = True  # the joint layer recomputed, as in training
    target = torch.randn(out.shape, generator=g)
    names = [f"{n}.{leaf}" for n in lg for leaf in ("a", "b", "scale")]

    def loss_and_grads(model, lora, args, tgt):
        params = [getattr(lora[n.rsplit(".", 1)[0]], n.rsplit(".", 1)[1]) for n in names]
        loss = (model(*args).float() - tgt).square().mean()
        return loss.item(), torch.autograd.grad(loss, params)

    _reset_launches()
    ref_loss, ref_grads = loss_and_grads(cpu, lc, inputs, target)
    loss, grads = loss_and_grads(gpu, lg, gpu_in, target.cuda())
    # against the largest gradient of every trained tensor, as the CPU tests hold it: a
    # LoRA scale's gradient is one sum, which can cancel to ~1e-10 on a seeded init
    # (Lumina2's joint FFN linear_3), where an error relative to itself means nothing
    gmax = max(gr.abs().max().item() for gr in ref_grads)
    errs = sorted(((gd.cpu() - gr).abs().max().item(), n, gr.abs().max().item())
                  for n, gd, gr in zip(names, grads, ref_grads))
    worst = errs[-1][0] / gmax
    stacks = sorted({n.split(".")[0] for n in lg})
    print(f"LoRA train step ({len(lg)} modules in {stacks}): loss card {loss:.6f} vs CPU {ref_loss:.6f}; "
          f"{len(grads)} tensors, max|dgrad| / max|grad| over all {worst:.3e} (tol 1e-3; max|grad| {gmax:.3e}; "
          f"the largest three max|dgrad| {[(n, f'{e:.2e}', f'of {m:.2e}') for e, n, m in errs[-3:]]}); "
          f"kernel launches={_launches()}")
    check(abs(loss - ref_loss) <= 1e-4 * abs(ref_loss) and worst <= 1e-3 and _launches() == _counts(),
          f"the {label} LoRA step on the card disagrees")
    del gpu, cpu


def gemma2_reference() -> None:
    """Gemma2-2B at full width cut to one layer, f32, under the eos mask of
    40 valid tokens of 256: the softcapped attention (the plain einsum),
    the four norms with their ``1 + w`` drawn away from 1, the tanh GELU and
    the scaled embeddings, the card against the CPU."""
    phase("full-width Gemma2-2B text tower (1 layer, the softcap at 50, the four (1 + w) norms away from 1, "
          "eos mask 40 of 256), f32: card vs CPU")
    from ai_toolkit_tpu_torch.models.text_encoders.llm import LLMConfig, LLMEncoder
    from ai_toolkit_tpu_torch.ops.layers import init_parameters

    cfg = dataclasses.replace(LLMConfig.gemma2_2b(), n_layers=1, dtype=torch.float32)
    gpu = init_parameters(LLMEncoder(cfg, device="cuda"), torch.Generator("cuda").manual_seed(0)).eval()
    with torch.no_grad():
        gn = torch.Generator("cuda").manual_seed(1)
        for name, prm in gpu.named_parameters():
            if "norm" in name:
                prm.normal_(0.0, 0.3, generator=gn)
    cpu = LLMEncoder(cfg, device="cpu").eval()
    cpu.load_state_dict(gpu.state_dict())
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(3, cfg.vocab_size, (1, 256), generator=g)
    mask = (torch.arange(256) < 40)[None]
    _reset_launches()
    with torch.inference_mode():
        ref = cpu(ids, mask)
        out = gpu(ids.cuda(), mask.cuda()).cpu()
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    tol = 1e-3 * max(1.0, scale)
    print(f"Gemma2 layer: out {tuple(out.shape)} max|ref|={scale:.3f} max_abs_err={err:.3e} (tol {tol:.3e}) "
          f"kernel launches={_launches()}")
    check(bool(torch.isfinite(out).all()) and err <= tol and _launches() == _counts(),
          "the Gemma2 layer on the card disagrees with the CPU")
    del gpu, cpu


# the NextDiT joint attentions at 1024^2: 256 caption + 4,096 image tokens
NEXTDIT_ATTENTION = [((1, 4352, 24, 96), "Lumina-Image-2.0's joint attention (head dim 96)"),
                     ((1, 4352, 21, 120), "OmniGen2's joint attention (head dim 120)")]
# OmniGen2Config's defaults under the diffusers config names OmniGen2Config.from_hf reads: the
# transformer config a checkpoint's transformer/config.json would hold
OMNIGEN2_TRANSFORMER = {"hidden_size": 2520, "num_layers": 32, "num_refiner_layers": 2, "num_attention_heads": 21,
                        "num_kv_heads": 7, "text_feat_dim": 2048, "multiple_of": 256, "ffn_dim_multiplier": None,
                        "axes_dim_rope": [40, 40, 40], "norm_eps": 1e-5, "timestep_scale": 1.0, "in_channels": 16,
                        "patch_size": 2}
# the shipped NextDiT files: (arch, file, quantized base, model_kwargs added)
NEXTDIT_FILES = [("lumina2", "train_lora_lumina2_tpu.yaml", False, None),
                 ("omnigen2", "train_lora_omnigen2_tpu.yaml", True, {"transformer_config": OMNIGEN2_TRANSFORMER})]


def nextdit_phases(card: str, profile_dir: str | None) -> dict:
    """The NextDiT slice: the Lumina2 and OmniGen2 (one reference) DiTs and a
    Gemma2 layer card vs CPU, the plain joint attention at head dims 96 and
    120 against SDPA, the two shipped files as written (but for their paths,
    steps and OmniGen2's transformer config) on seeded weights with 0 flash
    launches, and the OmniGen2 generate job with the LoRA it saved. Returns
    each job's numbers and the attention times."""
    from ai_toolkit_tpu_torch.models.lumina2_dit import Lumina2Config, lumina2_lora_targets
    from ai_toolkit_tpu_torch.models.omnigen2_dit import OmniGen2Config, omnigen2_lora_targets

    nextdit_reference("Lumina-Image-2.0 (24 x 96 heads, GQA 24 / 8)", Lumina2Config(), lumina2_lora_targets())
    nextdit_reference("OmniGen2 (21 x 120 heads, GQA 21 / 7)", OmniGen2Config.from_hf(OMNIGEN2_TRANSFORMER),
                      omnigen2_lora_targets(use_image_refiner=True), refs=1)
    gemma2_reference()
    attention = {label: masked_attention_times(card, 40, shape, label) for shape, label in NEXTDIT_ATTENTION}
    out = {}
    for arch, example, quantized, kwargs in NEXTDIT_FILES:
        phase(f"{arch} LoRA sd_trainer job, configs/examples/{example} as written with seeded weights"
              + (" and model_kwargs.transformer_config" if kwargs else "")
              + f": {'qfloat8' if quantized else 'bf16'} base, {SHIPPED_DATA}, "
                f"the disk latent cache, its prompt at 1024x1024 and 20 steps first and final, {SHIPPED_STEPS} "
                f"steps, 0 flash launches a step (head dims 96 / 120 and the caption mask: the plain attention)")
        out[arch] = _shipped_flux_job(card, profile_dir, example, f"smoke_{arch}_shipped", 1, None, 0,
                                      quantized=quantized, model_kwargs=kwargs)
    phase("omnigen2 generate job, 1024x1024, 8 steps, 1 prompt, bf16 base, with the LoRA of the shipped omnigen2 job "
          "(no references, as in JAX; 0 flash launches)")
    t0 = time.perf_counter()
    gen = generate_job({"name_or_path": "", "arch": "omnigen2",
                        "model_kwargs": {"transformer_config": OMNIGEN2_TRANSFORMER}}, 1024, 1024, 8,
                       ["a photo of a lighthouse on a cliff"], _counts(), lora_path=out["omnigen2"]["lora_path"])
    print(f"{card}: omnigen2 generate job {time.perf_counter() - t0:.1f} s wall, launches {gen}")
    return {"jobs": {arch: {"median_step_ms_by_bucket": r["by_bucket_ms"], "peak_gib": r["peak_gib"],
                            "sample_s": r["sample_s"], "wall_s": r["wall_s"]} for arch, r in out.items()},
            "masked_attention": attention, "omnigen2_generate_s": time.perf_counter() - t0}


# ---- the four flux files behind a loss or an adapter: DFE v7, ARA, Redux, vision_direct ----

# this slice's new flash shapes: TIPSv2 at the 512^2 decode (1 cls + 1 register + 37 x 37
# patches: a ragged 91-row tail), the vision_direct cross-attention (4,608 flux queries to
# 1,024 pixtral tokens) and Redux's joint sequence at 1024^2 (512 text + 257 ViT-H + 4,096)
REFUSAL_SHAPES = [((1, 1371, 1371, 12, 64), "TIPSv2 self at 512^2"),
                  ((1, 4608, 1024, 24, 128), "vision_direct cross"),
                  ((1, 4865, 4865, 24, 128), "Redux joint at 1024^2")]
TIPS_BLOCKS = 12
REFUSAL_STEPS = 3  # each of the four files' steps (the last one timed)
PIXTRAL_LAYERS = 24
FAMILY_BLOCKS = sum(FLUX_FAMILY_CUT)


def _f32_flash_check(shape, seed: int = 11) -> float:
    """The f32 path the TIPSv2 tower runs: forward, dq and dk/dv against the
    plain versions at ``shape``, each within 1e-4 of max|ref|. Returns the
    largest relative error."""
    from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa

    b, s, t, h, d = shape
    gen = torch.Generator("cuda").manual_seed(seed)
    q, g = (_rand((b, s, h, d), torch.float32, gen) for _ in range(2))
    k, v = (_rand((b, t, h, d), torch.float32, gen) for _ in range(2))
    out, lse = fa.flash_attention_fwd(q, k, v)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, g)
    ref_out, _ = fa.flash_attention_fwd_plain(q, k, v)
    refs = fa.flash_attention_bwd_plain(q, k, v, out, lse, g)
    rel = [((x - r).abs().max() / r.abs().max()).item() for x, r in zip((out, *grads), (ref_out, *refs))]
    print(f"f32 {shape}: out / dq / dk / dv rel err {' / '.join(f'{x:.3e}' for x in rel)} (tol 1e-4)")
    check(max(rel) <= 1e-4, f"the f32 flash kernels disagree with their plain versions at {shape}")
    return max(rel)


def dfe_ip_reference() -> None:
    """The new modules at a tiny size in f32, on the card against the CPU: the
    tiny flux DiT with a vision_direct decoupled K/V on every block, its
    prediction from seeded tokens, and the DFE v7 loss through the tiny VAE's
    decode and a tiny TIPSv2 DPT; the loss and the K/V gradients within 1e-4
    of their largest reference value."""
    phase("tiny flux DiT with decoupled K/V + the DFE v7 loss through the tiny VAE decode and TIPSv2 DPT, f32: "
          "card vs CPU")
    from ai_toolkit_tpu_torch.adapters.ip_adapter import build_flux_ip_collection
    from ai_toolkit_tpu_torch.config.modules import ModelConfig
    from ai_toolkit_tpu_torch.models.dfe import make_dfe7_loss
    from ai_toolkit_tpu_torch.models.flux_model import FluxModel
    from ai_toolkit_tpu_torch.models.tipsv2 import TIPSConfig, init_tipsv2_dpt
    from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule

    cfg = ModelConfig.from_dict({"name_or_path": "", "arch": "flux", "model_kwargs": {"size": "tiny"}})
    runs = {}
    state = None
    for label, dev in (("cpu", "cpu"), ("card", "cuda")):
        model = FluxModel(cfg, device=dev)
        variables = model.init_variables(torch.Generator(dev).manual_seed(0))
        tips = init_tipsv2_dpt(TIPSConfig.tiny(), torch.Generator(dev).manual_seed(1), dev)
        ip = build_flux_ip_collection(variables["dit"], 24, scale=0.7)
        if state is None:
            state = ({k: m.state_dict() for k, m in variables.items()}, tips.state_dict(),
                     {k: m.state_dict() for k, m in ip.items()})
        else:
            for k, m in variables.items():
                m.load_state_dict(state[0][k])
            tips.load_state_dict(state[1])
            for k, m in ip.items():
                m.load_state_dict(state[2][k])
        g = torch.Generator().manual_seed(2)
        x = torch.randn((2, 16, 20, model.vae_config.latent_channels), generator=g).to(dev)
        noise = torch.randn(x.shape, generator=g).to(dev)
        t = torch.tensor([0.25, 0.8], device=dev)
        tokens = torch.randn((2, 9, 24), generator=g).to(dev)
        txt = torch.randn((2, 7, model.dit_config.context_dim), generator=g).to(dev)
        cond = {"txt": txt, "y": torch.randn((2, model.dit_config.vec_dim), generator=g).to(dev),
                "pe": model.rope_table(16, 20, 7), "guidance": torch.full((2,), 3.5, device=dev),
                "ip_tokens": tokens}
        sched = FlowMatchSchedule()
        noisy = sched.add_noise(x, noise, t)
        pred = model.predict(variables, noisy, t, cond)
        aux = make_dfe7_loss(tips, sched, 1.0, lambda lat: model.decode_latents(variables, lat))
        loss = aux(pred, noisy, x, noise, t)
        params = [p for m in ip.values() for p in m.parameters()]
        grads = torch.autograd.grad(loss, params)
        runs[label] = (pred.detach().cpu(), loss.item(), [gr.cpu() for gr in grads])
    (p_ref, l_ref, g_ref), (p_gpu, l_gpu, g_gpu) = runs["cpu"], runs["card"]
    err = (p_gpu - p_ref).abs().max().item() / p_ref.abs().max().item()
    gmax = max(gr.abs().max().item() for gr in g_ref)
    gerr = max((a - b).abs().max().item() for a, b in zip(g_gpu, g_ref)) / gmax
    print(f"prediction rel err {err:.3e}; DFE loss card {l_gpu:.6f} vs CPU {l_ref:.6f}; {len(g_ref)} K/V gradients "
          f"(max|ref| {gmax:.3e}) rel err {gerr:.3e} (tol 1e-4 each)")
    check(err <= 1e-4 and abs(l_gpu - l_ref) <= 1e-4 * abs(l_ref) and gerr <= 1e-4 and gmax > 0,
          "the DFE loss or the decoupled K/V disagree between card and CPU")


def _block_linears(dit) -> list[tuple[str, object]]:
    """The DiT's Linears a flux LoRA targets (``flux_lora_targets``), in module order."""
    from ai_toolkit_tpu_torch.models.flux_dit import flux_lora_targets
    from ai_toolkit_tpu_torch.ops.layers import Linear

    pats = flux_lora_targets()
    return [(n, m) for n, m in dit.named_modules() if isinstance(m, Linear) and any(re.search(p, n) for p in pats)]


def write_ara_file(path: str, kind: str, depth: tuple[int, int], rank: int = 16, seed: int = 5) -> int:
    """A seeded accuracy-recovery adapter over every targeted Linear of
    flux-dev at ``depth`` blocks, in the layouts the JAX job reads: ``lora``
    (PEFT ``transformer.<module>.lora_A/B.weight``, fp16, no alpha) or
    ``lokr`` (LyCORIS ``lycoris_<module>.lokr_w1/w2`` + ``.alpha`` 1, the
    factors from ``adapters/lycoris.factorize``). Returns its module count."""
    from safetensors.torch import save_file

    from ai_toolkit_tpu_torch.adapters.lycoris import factorize
    from ai_toolkit_tpu_torch.models.flux_dit import FluxConfig, FluxDiT

    dit = FluxDiT(dataclasses.replace(FluxConfig.dev(), depth_double=depth[0], depth_single=depth[1]),
                  device="meta")
    g = torch.Generator().manual_seed(seed)
    flat = {}
    mods = _block_linears(dit)
    for n, m in mods:
        if kind == "lora":
            flat[f"transformer.{n}.lora_A.weight"] = (torch.randn((rank, m.in_features), generator=g)
                                                      * m.in_features ** -0.5).half()
            flat[f"transformer.{n}.lora_B.weight"] = (torch.randn((m.out_features, rank), generator=g) * 1e-3).half()
        else:
            (o1, o2), (i1, i2) = factorize(m.out_features), factorize(m.in_features)
            key = "lycoris_" + n.replace(".", "_")
            flat[key + ".lokr_w1"] = torch.randn((o1, i1), generator=g) * 0.05
            flat[key + ".lokr_w2"] = torch.randn((o2, i2), generator=g) * 0.05
            flat[key + ".alpha"] = torch.tensor(1.0)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_file(flat, path)
    print(f"ARA file {path} ({kind}): {len(mods)} modules, {os.path.getsize(path) / 2**20:.1f} MiB")
    return len(mods)


def lokr_ara_reference() -> None:
    """A full-width flux-dev DiT cut to 1 double + 1 single block, f32, on an
    int8 base with a LyCORIS LoKr ARA (the seeded file read through
    ``io/lora_file.load_lokr_file``) and a trainable LoRA: the forward and the
    LoRA gradients on the card against the CPU, within 1e-3 of the largest
    reference value (the int8 values are the same on both)."""
    phase("full-width flux-dev DiT, 1 double + 1 single block, f32, int8 base with a LoKr ARA and a trainable "
          "LoRA: card vs CPU")
    from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, attach_ara, build_lora
    from ai_toolkit_tpu_torch.adapters.quantize import quantize_params
    from ai_toolkit_tpu_torch.io.lora_file import is_lokr_file, load_lokr_file
    from ai_toolkit_tpu_torch.models.flux_dit import FluxConfig, FluxDiT, flux_lora_targets
    from ai_toolkit_tpu_torch.ops.layers import LoKr, init_parameters
    from ai_toolkit_tpu_torch.ops.rope import image_position_ids, multi_axis_rope

    path = os.path.join(OUT_DIR, "ara", "lokr_1_1.safetensors")
    n_mods = write_ara_file(path, "lokr", (1, 1))
    check(is_lokr_file(path), "the LoKr ARA file is not read as LoKr")
    cfg = dataclasses.replace(FluxConfig.dev(), depth_double=1, depth_single=1, dtype=torch.float32)
    gpu = init_parameters(FluxDiT(cfg, device="cuda"), torch.Generator("cuda").manual_seed(0))
    gpu.eval().requires_grad_(False)
    cpu = FluxDiT(cfg, device="cpu").eval().requires_grad_(False)
    cpu.load_state_dict(gpu.state_dict())
    spec = LoRASpec(rank=16, alpha=16.0, target_patterns=flux_lora_targets())
    loras, nets = {}, (("cpu", "cpu", cpu), ("card", "cuda", gpu))
    for label, dev, net in nets:
        tree = load_lokr_file(path, [n for n, _ in net.named_modules()])
        check(attach_ara(net, tree, "lokr") == n_mods, "the LoKr ARA does not cover every targeted Linear")
        quantize_params(net, qtype="int8")
        loras[label] = build_lora(net, spec, torch.Generator(dev).manual_seed(2))
    with torch.no_grad():
        for n, m in loras["card"].items():
            m.b.normal_(0.0, 0.01, generator=torch.Generator("cuda").manual_seed(3))
            loras["cpu"][n].a.copy_(m.a)
            loras["cpu"][n].b.copy_(m.b)
    check(all(isinstance(m.ara, LoKr) for _, m in _block_linears(gpu)), "a targeted Linear lost its LoKr ARA")
    g = torch.Generator().manual_seed(1)
    n_txt, hh, ww, b = 32, 8, 12, 1
    pe = multi_axis_rope(torch.from_numpy(image_position_ids(hh, ww, text_len=n_txt))[None], list(cfg.axes_dim),
                         cfg.theta)
    args = [torch.randn((b, hh * ww, cfg.in_channels), generator=g), torch.randn((b, n_txt, cfg.context_dim), generator=g),
            torch.tensor([0.6]), torch.randn((b, cfg.vec_dim), generator=g), pe, torch.tensor([4.0])]
    target = torch.randn((b, hh * ww, cfg.in_channels), generator=g)
    names = [f"{n}.{leaf}" for n in loras["cpu"] for leaf in ("a", "b")]
    runs = {}
    for label, dev, net in nets:
        params = [getattr(loras[label][n.rsplit(".", 1)[0]], n.rsplit(".", 1)[1]) for n in names]
        out = net(*[x.to(dev) for x in args])
        loss = (out.float() - target.to(dev)).square().mean()
        runs[label] = (out.detach().cpu(), [x.cpu() for x in torch.autograd.grad(loss, params)])
    (ref, ref_g), (out, grads) = runs["cpu"], runs["card"]
    scale, gmax = ref.abs().max().item(), max(x.abs().max().item() for x in ref_g)
    err = (out - ref).abs().max().item()
    gerr = max((a - r).abs().max().item() for a, r in zip(grads, ref_g))
    print(f"forward max|ref|={scale:.3f} max_abs_err={err:.3e} (tol {1e-3 * scale:.3e}); {len(grads)} LoRA gradients "
          f"max|ref|={gmax:.3e} max_abs_err={gerr:.3e} (tol {1e-3 * gmax:.3e})")
    check(err <= 1e-3 * scale and gerr <= 1e-3 * gmax, "the LoKr ARA on the int8 base disagrees between card and CPU")
    del gpu, cpu, loras
    gc.collect()
    torch.cuda.empty_cache()


def write_tipsv2_dpt(seed: int = 1234) -> str:
    """A seeded full-width TIPSv2 b14-DPT written as the reference's
    ``model.safetensors`` (its ``vision_encoder.*`` and ``*_head.*`` names);
    the DFE v7 file points ``v7:<dir>`` at it."""
    from safetensors.torch import save_file

    from ai_toolkit_tpu_torch.models.tipsv2 import TIPSConfig, init_tipsv2_dpt

    folder = os.path.join(OUT_DIR, "tipsv2-b14-dpt")
    os.makedirs(folder, exist_ok=True)
    t0 = time.perf_counter()
    model = init_tipsv2_dpt(TIPSConfig.b14_dpt(), torch.Generator("cuda").manual_seed(seed), "cuda")
    state = {k: v.detach().cpu().contiguous() for k, v in model.state_dict().items()}
    save_file(state, os.path.join(folder, "model.safetensors"))
    n = sum(v.numel() for v in state.values())
    print(f"TIPSv2 b14-dpt: {len(state)} tensors, {n / 1e6:.1f} M parameters (f32) written to {folder} in "
          f"{time.perf_counter() - t0:.2f} s")
    return folder


class _VisionEncodes:
    """The kernel launches of each vision encode of a job run
    (``SDTrainProcess._encode_vision_cached`` wrapped for the block): a call
    that encodes an image runs the tower once over the batch."""

    def __enter__(self) -> list[dict]:
        import ai_toolkit_tpu_torch.jobs.train_process as tp

        self.cls, self.real, self.calls = tp.SDTrainProcess, tp.SDTrainProcess._encode_vision_cached, []
        real, calls = self.real, self.calls

        def counted(proc, pixels):
            before, enc0 = _launches(), getattr(proc, "vision_cache_report", {}).get("encoded", 0)
            out = real(proc, pixels)
            after = _launches()
            calls.append({"launches": {k: after[k] - before[k] for k in after},
                          "encoded": proc.vision_cache_report["encoded"] - enc0})
            return out

        tp.SDTrainProcess._encode_vision_cached = counted
        return self.calls

    def __exit__(self, *exc) -> None:
        self.cls._encode_vision_cached = self.real


def _refusal_job(card: str, example: str, name: str, per_step: dict, size: int, *, train: dict | None = None,
                 model: dict | None = None, encode: dict | None = None) -> tuple[dict, object, dict]:
    """One of the four files as written but for its paths (``train`` /
    ``model``: the DFE directory, the ARA file), its steps (REFUSAL_STEPS) and its name,
    on seeded weights with the DiT at FLUX_FAMILY_CUT; every step's launches
    (``per_step``), 15 a denoise step, ``encode`` the launches of a vision
    encode that encodes (the rest: none), the first and final samples at
    ``size``. Prints the step ms, peak and samples beside the card."""
    raw = _shipped_job(example, name, REFUSAL_STEPS, "")
    proc_cfg = raw["config"]["process"][0]
    proc_cfg["train"].update(train or {})
    proc_cfg["model"].update(model or {})
    with flux_cut_depth(), _VisionEncodes() as encodes:
        result, proc, report = _run_job(raw, per_step, None, _counts(fwd=FAMILY_BLOCKS), outside=encodes)
    for c in encodes:
        want = encode if c["encoded"] else _counts()
        check(c["launches"] == want, f"a vision encode launched {c['launches']} (encoded {c['encoded']}) != {want}")
    _check_samples(result, [0, REFUSAL_STEPS], 1, size)
    ms = result["step_ms"]
    timed = ms[TRAIN_WARMUP:]
    print(f"{card}: {name}: step ms {', '.join(f'{x:.1f}' for x in ms)}; warm median {statistics.median(timed):.1f} "
          f"(min {min(timed):.1f}, max {max(timed):.1f}); peak {report['peak_gib']:.2f} GiB; launches a step "
          f"{per_step}; samples {', '.join('%.2f' % r['seconds'] for r in result['samples'])} s; job wall "
          f"{report['wall_s']:.1f} s")
    return result, proc, {**report, "step_ms": ms, "warm_min_ms": min(timed), "warm_max_ms": max(timed)}


def _aux_grad_norm(proc) -> dict:
    """The DFE term's own gradient on the LoRA, from the trained job: one
    cached batch at t = 0.5, the MSE and the aux loss each differentiated
    alone (the aux loss as the job built it, through the decode and TIPSv2;
    the DiT without its block checkpointing, so one forward serves both)."""
    from ai_toolkit_tpu_torch.models.dfe import make_aux_loss
    from ai_toolkit_tpu_torch.train.optimizers import global_norm

    model, variables = proc.model, proc.variables
    loader, text_cache = proc._build_data(model, variables)
    batch = proc._prepare_batch(model, variables, next(loader.iter_from(0)), text_cache)
    path, weight = proc.feature_loss_path
    aux_fn, _ = make_aux_loss(path, weight, model, variables, proc._schedule(), proc.device)
    lat = batch["latents"]
    g = torch.Generator("cuda").manual_seed(3)
    noise = torch.randn(lat.shape, generator=g, device="cuda", dtype=lat.dtype)
    t = torch.full((lat.shape[0],), 0.5, device="cuda")
    sched = proc._schedule()
    noisy = sched.add_noise(lat, noise, t)
    params = list(proc.state.trainable.values())
    net = variables[model.main_component]
    net.gradient_checkpointing = False  # two backwards through one forward: no recompute region
    try:
        pred = model.predict(variables, noisy, t, batch["cond"])
        mse = (pred.float() - sched.target(lat, noise, t).float()).square().mean()
        aux = aux_fn(pred, noisy, lat, noise, t)
        g_mse = torch.autograd.grad(mse, params, retain_graph=True)
        g_aux = torch.autograd.grad(aux, params)
    finally:
        net.gradient_checkpointing = proc.cfg.train.gradient_checkpointing
    return {"mse": mse.item(), "aux": aux.item(), "grad_norm_mse": float(global_norm(list(g_mse))),
            "grad_norm_aux": float(global_norm(list(g_aux)))}


def refusal_files_phases(card: str) -> dict:
    """The four flux files that once stopped at a refusal, as written but for
    their paths and steps (REFUSAL_STEPS), on seeded weights with flux-dev cut to
    FLUX_FAMILY_CUT and every new module at full width and depth: the flash
    kernels against their plain versions and timed at the slice's shapes
    (and the f32 path at TIPSv2's), the tiny DFE + decoupled K/V and the LoKr
    ARA on an int8 base card vs CPU, then
    configs/examples/train_lora_flux_dfe7_tpu.yaml (the DFE v7 loss on a
    seeded TIPSv2 b14-DPT written in the reference's layout, the decode at
    512^2 in the graph), train_lora_flux_ara_tpu.yaml (a seeded LoRA ARA on
    the int8 base), train_redux_adapter_flux_tpu.yaml (the seeded ViT-H, its
    257 tokens appended to the 512 text tokens) and
    train_vision_direct_pixtral_flux_tpu.yaml (the seeded 24-layer pixtral
    tower at 512^2, 1,024 tokens, the K/V on the 5 double blocks). Returns
    each phase's numbers."""
    t_start = time.perf_counter()
    err = flash_checks("flash kernels vs plain versions at the DFE / adapter shapes, bf16",
                       [(shape, label, True, None) for shape, label in REFUSAL_SHAPES], 21)
    phase("the f32 flash path at TIPSv2's shape (the DFE's tower runs in f32)")
    err_f32 = _f32_flash_check(REFUSAL_SHAPES[0][0])
    times = attention_times("flash kernels at the DFE / adapter shapes, bf16", "slice", [
        (shape, label, True) for shape, label in REFUSAL_SHAPES], 22)
    dfe_ip_reference()
    lokr_ara_reference()
    out = {"flash_err": {**err, "f32_rel": err_f32},
           "ms": {label: {k: {m: row[k][m] for m in ("ms", "plain_ms", "library_ms", "bound_ms")} for k in row}
                  for label, row in times.items()}}
    cut = f"the DiT cut to {FLUX_FAMILY_CUT[0]} + {FLUX_FAMILY_CUT[1]} blocks"

    phase("TIPSv2 b14-DPT written from seeded full-width modules in the reference's layout")
    tips_dir = write_tipsv2_dpt()
    phase(f"DFE v7 LoRA sd_trainer job, configs/examples/train_lora_flux_dfe7_tpu.yaml as written with seeded "
          f"weights and 'v7:{tips_dir}': 512^2, the VAE decode and TIPSv2 (1,371 tokens, f32) in the step, "
          f"{cut}")
    dfe_step = _counts(FAMILY_BLOCKS + 2 * TIPS_BLOCKS, FAMILY_BLOCKS + TIPS_BLOCKS, FAMILY_BLOCKS + TIPS_BLOCKS)
    result, proc, rep = _refusal_job(card, "train_lora_flux_dfe7_tpu.yaml", "smoke_dfe7", dfe_step, 512,
                                     train={"diffusion_feature_extractor_path": f"v7:{tips_dir}"})
    check(len(result["aux_losses"]) == len(result["losses"]) and all(x > 0 for x in result["aux_losses"]),
          f"aux losses {result['aux_losses']}")
    check_lora_job(result, proc)
    norms = _aux_grad_norm(proc)
    print(f"{card}: DFE: aux loss by step {', '.join(f'{x:.5f}' for x in result['aux_losses'])} beside the loss "
          f"{', '.join(f'{x:.5f}' for x in result['losses'])}; at t = 0.5 on one batch: mse {norms['mse']:.5f}, aux "
          f"{norms['aux']:.5f}, LoRA gradient norm of the mse {norms['grad_norm_mse']:.4e}, of the aux loss "
          f"{norms['grad_norm_aux']:.4e}")
    check(norms["grad_norm_aux"] > 0 and math.isfinite(norms["grad_norm_aux"]),
          "the DFE loss brings no gradient to the LoRA")
    out["dfe7"] = {**{k: rep[k] for k in ("median_step_ms", "warm_min_ms", "warm_max_ms", "peak_gib", "wall_s")},
                   "per_step": dfe_step, "aux_losses": result["aux_losses"], "losses": result["losses"], **norms}
    del proc
    gc.collect()

    ara_path = os.path.join(OUT_DIR, "ara", "ara_lora.safetensors")
    n_ara = write_ara_file(ara_path, "lora", FLUX_FAMILY_CUT)
    phase(f"ARA LoRA sd_trainer job, configs/examples/train_lora_flux_ara_tpu.yaml as written with seeded weights "
          f"and 'int8|{ara_path}' ({n_ara} modules, rank 16): 1024^2, the ARA read before the int8 quantization, "
          f"stacked with the trainable LoRA by rank-concat, {cut}")
    result, proc, rep = _refusal_job(card, "train_lora_flux_ara_tpu.yaml", "smoke_ara", _counts(*(FAMILY_BLOCKS,) * 3),
                                     1024, model={"qtype": f"int8|{ara_path}"})
    from safetensors.torch import load_file

    from ai_toolkit_tpu_torch.adapters.quantize import quantized_bytes, quantized_count
    from ai_toolkit_tpu_torch.ops.layers import LoRA

    net = proc.variables["dit"]
    written = load_file(ara_path)
    aras = {n: m.ara for n, m in _block_linears(net)}
    moved = [n for n, a in aras.items() if not isinstance(a, LoRA) or a.a.requires_grad
             or not torch.equal(a.a.detach().cpu(), written[f"transformer.{n}.lora_A.weight"].float().t())
             or not torch.equal(a.b.detach().cpu(), written[f"transformer.{n}.lora_B.weight"].float().t())]
    qgb = quantized_bytes(net) / 1e9
    print(f"{card}: ARA: int8 base {quantized_count(net)} weights, {qgb:.2f} GB; {len(aras)} frozen ARA deltas "
          f"present, {len(moved)} changed after {result['steps']} steps")
    check(proc.cfg.model.qtype == "int8" and quantized_count(net) > 0 and len(aras) == n_ara and not moved,
          f"the ARA is missing or moved ({moved[:3]}), or the base is not int8")
    from safetensors import safe_open

    with safe_open(check_lora_job(result, proc), framework="pt") as f:
        check(set(f.keys()) == {f"transformer.{n}.lora_{ab}.weight" for n in proc.lora for ab in "AB"},
              "the ARA job's save holds more than the trainable LoRA")
    out["ara"] = {**{k: rep[k] for k in ("median_step_ms", "warm_min_ms", "warm_max_ms", "peak_gib", "wall_s")},
                  "quantized_gb": qgb, "ara_modules": n_ara}
    del proc, net
    gc.collect()

    phase(f"Redux adapter sd_trainer job, configs/examples/train_redux_adapter_flux_tpu.yaml as written with seeded "
          f"weights: the seeded ViT-H (32 layers, plain attention at head dim 80), its 257 tokens appended to the "
          f"512 text tokens, the network beside it not trained (the JAX fault), EMA, [512, 768, 1024], {cut}")
    result, proc, rep = _refusal_job(card, "train_redux_adapter_flux_tpu.yaml", "smoke_redux",
                                     _counts(*(FAMILY_BLOCKS,) * 3), 1024, encode=_counts())
    out["redux"] = {**_check_adapter_job(card, result, proc, "redux", {
        "redux.redux_up.weight", "redux.redux_up.bias", "redux.redux_down.weight", "redux.redux_down.bias"}),
        **{k: rep[k] for k in ("median_step_ms", "warm_min_ms", "warm_max_ms", "peak_gib", "wall_s")}}
    del proc
    gc.collect()

    d = FLUX_FAMILY_CUT[0]
    vd_step = _counts(FAMILY_BLOCKS + d, FAMILY_BLOCKS + d - 1, FAMILY_BLOCKS + d - 1)
    phase(f"vision_direct adapter sd_trainer job, configs/examples/train_vision_direct_pixtral_flux_tpu.yaml as "
          f"written with seeded weights: the seeded pixtral tower (24 layers of 1024, 1,024 tokens at 512^2, f32), "
          f"the resampler to 3072, decoupled K/V on the {d} double blocks, 1024^2, {cut}")
    result, proc, rep = _refusal_job(card, "train_vision_direct_pixtral_flux_tpu.yaml", "smoke_vision_direct",
                                     vd_step, 1024, encode=_counts(fwd=PIXTRAL_LAYERS))
    keys = {f"vision_direct.{m}.{p}" for m in ("w_in", "w_out") for p in ("weight", "bias")}
    keys |= {f"vision_direct.adapter_modules.{i}.to_{kv}_adapter.weight" for i in range(d) for kv in "kv"}
    out["vision_direct"] = {**_check_adapter_job(card, result, proc, "vision_direct", keys),
                            **{k: rep[k] for k in ("median_step_ms", "warm_min_ms", "warm_max_ms", "peak_gib",
                                                   "wall_s")}, "per_step": vd_step}
    del proc
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_start
    print(f"{card}: the four files' phases {out['wall_s']:.1f} s")
    return out


# ---- the train-step knobs ----

KNOB_STEPS = 3
# flux-dev LoRA factor shapes (qkv a / b, the MLP's a / b) and a LoRA scale
KNOB_OPT_SHAPES = [(3072, 16), (16, 3072), (16, 12288), (12288, 16), ()]
KNOB_OPTIMIZERS = [("adam", {}), ("lion", {}), ("adagrad", {}), ("adafactor", {}), ("prodigy", {}),
                   ("dadapt_adamw", {}), ("ademamix", {}), ("muon", {}), ("sgd", {}), ("automagic", {}),
                   ("automagic", {"paramiter_swapping": 0.1})]


def knob_optimizers_reference(card: str) -> dict:
    """Each optimizer the knobs slice ports, 5 clipped steps on seeded
    flux-dev LoRA-shaped tensors, in f32 and bf16, on the card against the
    same on the CPU: the parameters' largest difference over their largest
    value (f32 within 1e-5, bf16 within one bf16 step, 2^-7; the reductions
    run in another order on the card), and the card's ms a step."""
    import numpy as np

    from ai_toolkit_tpu_torch.train.optimizers import get_optimizer

    phase("the optimizers of the knobs slice on flux-dev LoRA-shaped tensors: card vs CPU, f32 and bf16, 5 steps")
    rng = np.random.default_rng(9)
    init = [rng.standard_normal(s).astype(np.float32) * 0.05 for s in KNOB_OPT_SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) * 0.01 * (i + 1) for s in KNOB_OPT_SHAPES]
             for i in range(5)]
    out = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        for name, opts in KNOB_OPTIMIZERS:
            runs = {}
            for dev in ("cpu", "cuda"):
                params = [torch.tensor(x, device=dev).to(dtype) for x in init]
                opt = get_optimizer(name, params, 1e-3, dict(opts), max_grad_norm=1.0)
                _sync_dev(dev)
                t0 = time.perf_counter()
                for g in grads:
                    opt.step([torch.tensor(x, device=dev).to(dtype) for x in g])
                _sync_dev(dev)
                runs[dev] = (params, (time.perf_counter() - t0) * 1e3 / len(grads))
            ref, got = runs["cpu"][0], runs["cuda"][0]
            err = max(float((g.cpu().float() - r.float()).abs().max()) / max(float(r.float().abs().max()), 1e-30)
                      for g, r in zip(got, ref))
            moved = max(float((r.float() - torch.tensor(x)).abs().max()) for r, x in zip(ref, init))
            label = name + ("+swap" if opts else "")
            print(f"{card}: {label} {str(dtype)[6:]}: card vs CPU {err:.3e} of max|p| (tol {tol:.1e}); moved "
                  f"{moved:.3e}; card {runs['cuda'][1]:.2f} ms a step, CPU {runs['cpu'][1]:.2f}")
            check(err <= tol and moved > 0, f"{label} {dtype}: card vs CPU {err} (tol {tol}) or no update")
            out[f"{label}_{str(dtype)[6:]}"] = {"err": err, "ms": runs["cuda"][1]}
    return out


def _sync_dev(dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


class _Replay:
    """The step's draws handed back in the order they were recorded (the
    card's step gets the CPU step's noise and knob draws)."""

    def __init__(self, log: list, device):
        self.log, self.device = list(log), torch.device(device)

    def normal(self, shape, dtype=torch.float32):
        return self.log.pop(0).to(self.device, dtype)

    def uniform(self, shape, lo=0.0, hi=1.0):
        return self.log.pop(0).to(self.device)

    def randint(self, lo, hi):
        return int(self.log.pop(0))


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def knob_step_reference(label: str, train: dict, arch: str = "flux", mask: bool = False) -> float:
    """One micro-batch of the knobs ``train`` on a tiny ``arch`` (its LoRA's b
    non-zero, so an adapter-off forward differs) on the CPU and on the card
    with the same weights, batch, t and draws: the loss and every LoRA
    gradient held to 1e-4 / 1e-3 of their largest value."""
    import copy

    from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora
    from ai_toolkit_tpu_torch.config.modules import ModelConfig, TrainConfig
    from ai_toolkit_tpu_torch.models.registry import get_model_class
    from ai_toolkit_tpu_torch.samplers.ddpm import DDPMSchedule
    from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
    from ai_toolkit_tpu_torch.train import step as tstep

    cfg = tstep.TrainStepConfig.from_train_config(TrainConfig(**{k: v for k, v in train.items()
                                                                 if k not in ("optimizer", "lr")}))
    mcfg = ModelConfig.from_dict({"name_or_path": "", "arch": arch, "model_kwargs": {"size": "tiny"}})
    cls = get_model_class(arch)
    models = {"cpu": cls(mcfg, "cpu"), "cuda": cls(mcfg, "cuda")}
    vc = models["cpu"].load_variables(torch.Generator().manual_seed(0))
    main = models["cpu"].main_component
    lora = build_lora(vc[main], LoRASpec(rank=4, alpha=4.0, target_patterns=models["cpu"].lora_targets()),
                      torch.Generator().manual_seed(1))
    gb = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for m in lora.values():
            m.b.normal_(0.0, 0.05, generator=gb)
    variables = {"cpu": vc, "cuda": {k: copy.deepcopy(v).to("cuda") for k, v in vc.items()}}
    flow = cls.is_flow_matching
    g = torch.Generator().manual_seed(3)
    c = models["cpu"].vae_config.latent_channels
    batch = {"latents": torch.randn(2, 8, 8, c, generator=g), "loss_multiplier": torch.ones(2)}
    with torch.no_grad():
        for key, prompt in (("cond", "a photo of a fox"), ("neg_cond", ""), ("blank_cond", ""),
                            ("uncond_cond", "")):
            batch[key] = dict(models["cpu"].encode_prompt(vc, [prompt, prompt + " at dusk"]))
            if flow:
                batch[key]["pe"] = models["cpu"].rope_table(8, 8, int(batch[key]["txt"].shape[1]))
                batch[key]["guidance"] = torch.ones(2)
    if flow:
        batch["image_seq_len"] = 16
    if mask:
        batch["mask"] = torch.rand(2, 8, 8, 1, generator=g)
    if cfg.train_turbo:
        px = 8 * models["cpu"].vae_config.downscale
        batch["pixel_values"] = torch.rand(2, px, px, 3, generator=g) * 2 - 1
    t = torch.tensor([0.35, 0.8]) if flow else torch.tensor([150, 650])
    sched = FlowMatchSchedule() if flow else DDPMSchedule()
    out = {}
    log = []
    for dev in ("cpu", "cuda"):
        v, model = variables[dev], models[dev]
        params = [getattr(dict(v[main].named_modules())[n].lora, leaf) for n in lora for leaf in ("a", "b")]
        for p in params:
            p.requires_grad_(True)
        if dev == "cpu":
            draws = tstep.Draws(torch.Generator().manual_seed(4), "cpu")
            real_n, real_u, real_i = draws.normal, draws.uniform, draws.randint
            draws.normal = lambda *a, **k: log.append(real_n(*a, **k)) or log[-1]
            draws.uniform = lambda *a, **k: log.append(real_u(*a, **k)) or log[-1]
            draws.randint = lambda *a, **k: log.append(real_i(*a, **k)) or log[-1]
        else:
            draws = _Replay(log, "cuda")
        decode = (lambda lat, m=model, vv=v: m.decode_latents(vv, lat)) if cfg.train_turbo else None
        lsnr = tstep.LearnableSNR(dev) if cfg.learnable_snr else None
        loss, _ = tstep.microbatch_loss(lambda x, tt, cc, m=model, vv=v: m.predict(vv, x, tt, cc), sched, cfg,
                                        _to(batch, dev), t.to(dev), draws, decode_fn=decode, lsnr=lsnr)
        out[dev] = (float(loss), [x.cpu() for x in torch.autograd.grad(loss, params)])
    (l_ref, g_ref), (l_got, g_got) = out["cpu"], out["cuda"]
    gmax = max(float(x.abs().max()) for x in g_ref)
    gerr = max(float((a - b).abs().max()) for a, b in zip(g_got, g_ref)) / max(gmax, 1e-30)
    lerr = abs(l_got - l_ref) / max(abs(l_ref), 1e-30)
    print(f"tiny {arch} step of the {label} knobs, card vs CPU: loss {l_got:.6f} / {l_ref:.6f} (rel {lerr:.3e}, tol "
          f"1e-4), LoRA gradients {gerr:.3e} of max|grad| {gmax:.3e} (tol 1e-3)")
    check(lerr <= 1e-4 and gerr <= 1e-3 and gmax > 0, f"the tiny {label} step on the card disagrees")
    return gerr


def _knob_masks(folder: str, n: int = 4, size: int = 512) -> str:
    """A seeded grey mask for each image of ``folder`` (a soft disc), by file name."""
    import numpy as np
    from PIL import Image

    out = folder + "_masks"
    os.makedirs(out, exist_ok=True)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i in range(n):
        r = np.sqrt((xx - 0.3 - 0.1 * i) ** 2 + (yy - 0.5) ** 2)
        m = np.clip(1.5 - 4.0 * r, 0.0, 1.0) * 255
        Image.fromarray(m.astype(np.uint8)).save(os.path.join(out, f"img_{i}.png"))
    return out


def _knob_job(card: str, name: str, train: dict, per_step: dict, model: dict | None = None,
              dataset: dict | None = None) -> tuple[dict, object]:
    """A LoRA ``sd_trainer`` job of the knobs ``train`` on seeded weights:
    flux-dev at FLUX_FAMILY_CUT (or ``model``), rank 16, 512^2, batch 1,
    KNOB_STEPS steps, bf16, latents in memory, no sampling; every step's
    flash launches (``per_step``), the loss finite and the saved LoRA
    trained. Prints ms a step and the peak beside the card; returns the
    numbers and the process."""
    folder = _train_dataset(n=4, size=512, name="knob_data")
    raw = {"job": "extension", "config": {"name": name, "process": [{
        "type": "sd_trainer", "training_folder": os.path.join(OUT_DIR, "train"), "trigger_word": "p3r5on",
        "network": {"type": "lora", "linear": 16, "linear_alpha": 16},
        "save": {"dtype": "float16", "save_every": 250, "max_step_saves_to_keep": 4},
        "datasets": [{"folder_path": folder, "caption_ext": "txt", "cache_latents": True,
                      "cache_latents_to_disk": False, "resolution": [512], **(dataset or {})}],
        "train": {"batch_size": 1, "steps": KNOB_STEPS, "gradient_checkpointing": True,
                  "noise_scheduler": "flowmatch", "timestep_type": "flux_shift", "optimizer": "adamw8bit",
                  "lr": 1e-4, "max_grad_norm": 1.0, "dtype": "bf16", "seed": 42, **train},
        "model": model or {**FLUX_MODEL, "quantize": False},
        "logging": {"log_every": 1}}]}}
    with flux_cut_depth() if model is None else contextlib.nullcontext():
        result, proc, report = _run_job(raw, per_step, None)
    check_lora_job(result, proc)
    ms = result["step_ms"]
    print(f"{card}: {name}: step ms {', '.join(f'{x:.1f}' for x in ms)}; peak {report['peak_gib']:.2f} GiB; "
          f"launches a step {per_step}; job wall {report['wall_s']:.1f} s")
    rep = {"step_ms": ms, "peak_gib": report["peak_gib"], "wall_s": report["wall_s"], "per_step": per_step,
           "losses": result["losses"]}
    return rep, proc


KNOB_JOBS = {
    "prior": dict(diff_output_preservation=True, diff_output_preservation_class="person",
                  blank_prompt_preservation=True, do_cfg=True, cfg_scale=2.0, cfg_rescale=0.7, optimizer="prodigy",
                  lr=1.0, timestep_type="weighted", loss_type="mae"),
    "noise_mask": dict(loss_type="wavelet", inverted_mask_prior=True, noise_offset=0.1, blended_blur_noise=True,
                       optimal_noise_pairing_samples=4, random_noise_shift=0.1, timestep_type="lognorm_blend",
                       optimizer="adafactor", prompt_dropout_prob=0.5),
    "x0_t0": dict(t0_loss_target=True, do_fft_loss=True, max_loss=100.0, correct_pred_norm=True,
                  guidance_loss_target=3.0, do_guidance_loss_cfg_zero=True, optimizer="automagic",
                  do_paramiter_swapping=True),
    "x0_source": dict(loss_target="source", optimizer="muon", lr=1e-4),
    "sd15_turbo": dict(train_turbo=True, learnable_snr_gos=True, noise_scheduler="ddpm", timestep_type="sigmoid",
                       content_or_style="style", optimizer="lion", lr=1e-5),
}


def train_knobs_phases(card: str, sd15_path: str) -> dict:
    """The train-step knobs slice: its optimizers card vs CPU; four short
    flux-dev LoRA jobs at FLUX_FAMILY_CUT, 512^2, KNOB_STEPS steps, each a
    mix of knobs the JAX step takes together (``KNOB_JOBS``: the
    adapter-off prior, blank-prompt preservation and CFG on prodigy; a
    ``mask_path`` dataset with the wavelet loss, the inverted-mask prior and
    the noise knobs on adafactor; the t0 and FFT losses with target-side CFG
    on automagic with parameter swapping; ``loss_target: source`` on muon,
    which shadows the t0 losses in JAX, so it runs apart), each with its
    flash launches a step as PERF.md predicts and the same knobs on a tiny
    flux card vs CPU; then the SD 1.5 ddpm job with ``train_turbo`` (the VAE
    decode in the step) and the learnable SNR on the LDM file."""
    t_start = time.perf_counter()
    out = {"optimizers": knob_optimizers_reference(card)}
    fam = sum(FLUX_FAMILY_CUT)
    per_step = {"prior": _counts(5 * fam, 3 * fam, 3 * fam), "noise_mask": _counts(2 * fam, fam, fam),
                "x0_t0": _counts(2 * fam, fam, fam), "x0_source": _counts(fam, fam, fam)}
    cut = f"flux-dev cut to {FLUX_FAMILY_CUT[0]} + {FLUX_FAMILY_CUT[1]} blocks"
    for name, train in KNOB_JOBS.items():
        sd = name == "sd15_turbo"
        mask = name in ("noise_mask",)
        knob_step_reference(name, train, "sd15" if sd else "flux", mask=mask or sd)
        phase(f"knobs job '{name}': {', '.join(sorted(train))}; "
              + ("SD 1.5 LDM file, ddpm, 512^2, pixels in the batch (0 flash launches)" if sd else cut + ", 512^2"))
        if sd:
            rep, proc = _knob_job(card, f"smoke_knobs_{name}", train, _counts(),
                                  model={"name_or_path": sd15_path, "arch": "sd1"},
                                  dataset={"cache_latents": False, "mask_path": _knob_masks(
                                      _train_dataset(n=4, size=512, name="knob_data"))})
            path = os.path.join(proc.save_root, "learnable_snr.json")
            with open(path) as f:
                saved = json.load(f)
            check(saved == proc.state.lsnr.to_json() and saved["gamma"] != 2.03,
                  f"learnable_snr.json {saved} is not the trained state")
            print(f"{card}: learnable SNR after {KNOB_STEPS} steps: {saved}")
            rep["learnable_snr"] = saved
        else:
            ds = {"mask_path": _knob_masks(_train_dataset(n=4, size=512, name="knob_data"))} if mask else None
            rep, proc = _knob_job(card, f"smoke_knobs_{name}", train, per_step[name], dataset=ds)
        out[name] = rep
        del proc
        gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_start
    print(f"{card}: the knobs phases {out['wall_s']:.1f} s")
    return out


def _check_adapter_job(card: str, result: dict, proc, kind: str, keys: set[str]) -> dict:
    """An adapter run really trained its adapter and saved the JAX job's file:
    the adapter's tensors moved, no LoRA is attached, the vision cache hit
    after the first pass, and the final file holds ``keys`` (the names the
    JAX job writes, held to its ``_save`` on the CPU) with its step and type."""
    from safetensors import safe_open

    check(proc.lora is None and all(k.startswith(("adapter.", "ip.")) for k in proc.state.trainable),
          f"{kind}: the job trained more than its adapter")
    rep = proc.vision_cache_report
    cache_dir = getattr(proc, "_vision_cache_dir", None)
    check(rep["encoded"] > 0 and (cache_dir is None or len(os.listdir(cache_dir)) == rep["encoded"]),
          f"{kind}: vision cache {rep}")
    with safe_open(result["save_path"], framework="pt") as f:
        got, meta = set(f.keys()), f.metadata()
        nonzero = all(bool(f.get_tensor(k).abs().max() > 0) for k in got if "weight" in k)
    check(got == keys and meta.get("adapter_type") == kind and meta.get("step") == str(result["steps"]) and nonzero,
          f"{kind}: the adapter file holds {sorted(got)[:6]} ({meta}), want {sorted(keys)[:6]}")
    print(f"{card}: {kind}: {len(got)} tensors in {result['save_path']} (adapter_type {kind}); vision cache {rep}"
          + (f", {len(os.listdir(cache_dir))} files in {cache_dir}" if cache_dir else ""))
    return {"adapter_keys": sorted(got), "vision_cache": dict(rep)}


# ---- the networks the JAX trainer builds besides LoRA: LoKr, LoHa, DoRA, LoRM and LoCon ----

NETWORK_KINDS = ("lokr", "loha", "dora", "lorm")
NETWORK_STEPS = 3  # each flux-dev network job's steps
# LoRM keeps near-full rank on seeded weights (ratio 0.25), so its factors outweigh the base: on the
# attention projections of the double blocks alone, its saves and training state stay a few GiB
LORM_IGNORE = ["mod", "mlp", "linear"]
NETWORK_JOBS = {"lokr": {"type": "lokr", "linear": 16, "linear_alpha": 16, "lokr_factor": -1},
                "loha": {"type": "loha", "linear": 16, "linear_alpha": 16},
                "dora": {"type": "dora", "linear": 16, "linear_alpha": 16},
                "lorm": {"type": "lorm", "network_kwargs": {"extract_mode": "ratio", "extract_mode_param": 0.25,
                                                            "ignore_if_contains": LORM_IGNORE}}}
NETWORK_MODULES = {"lokr": 80, "loha": 80, "dora": 80, "lorm": 4 * FLUX_FAMILY_CUT[0]}
LOCON_REACH = ["down_", "up_", "mid"]  # only_if_contains that reaches the UNet's resnets and samplers
ZERO_FACTOR = {"lokr": "w2", "loha": "w2b", "dora": "b"}  # each LyCORIS network's factor that starts at 0
# the 1 + 1 block's 13 Linears shared out between the four networks, so one CPU run checks them all
BLOCK_TARGETS = {"lokr": [r"\.img_(attn|mlp)\."], "loha": [r"\.txt_(attn|mlp)\."], "dora": [r"mod\w*\.lin$"],
                 "lorm": [r"^single_blocks\.\d+\.linear"]}


def network_block_reference() -> dict:
    """A full-width flux-dev DiT cut to 1 double + 1 single block, in f32,
    batch 2, its 13 Linears shared out between the four networks built on
    the card (``BLOCK_TARGETS``: LoKr on the image stream, LoHa on the text
    stream, DoRA on the modulations, LoRM's SVD of the single block's
    linear1 / linear2 in the scanned layout's rule), each zero-initialised
    factor drawn non-zero so every gradient flows; the module copied to the
    CPU: the forward and the loss and every network gradient of one step on
    the card against the CPU, each within 1e-3 of the largest reference
    value (as the earlier block phases)."""
    import copy

    from ai_toolkit_tpu_torch.adapters.lora import LoRASpec
    from ai_toolkit_tpu_torch.adapters.lorm import LoRMSpec, build_lorm
    from ai_toolkit_tpu_torch.adapters.lycoris import BUILD_FNS
    from ai_toolkit_tpu_torch.models.flux_dit import FluxConfig, FluxDiT
    from ai_toolkit_tpu_torch.ops.layers import init_parameters
    from ai_toolkit_tpu_torch.ops.rope import image_position_ids, multi_axis_rope

    phase("full-width flux-dev DiT, 1 double + 1 single block, f32, batch 2, LoKr / LoHa / DoRA / LoRM on its "
          "Linears: card vs CPU")
    cfg = dataclasses.replace(FluxConfig.dev(), depth_double=1, depth_single=1, dtype=torch.float32)
    gpu = init_parameters(FluxDiT(cfg, device="cuda"), torch.Generator("cuda").manual_seed(0))
    gpu.eval().requires_grad_(False)
    gen = torch.Generator("cuda").manual_seed(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nets = {}
    for kind in NETWORK_KINDS:
        if kind == "lorm":
            nets[kind] = build_lorm(gpu, LoRMSpec(target_patterns=BLOCK_TARGETS[kind]), scanned=True)[0]
            continue
        nets[kind] = BUILD_FNS[kind](gpu, LoRASpec(rank=16, alpha=16.0, target_patterns=BLOCK_TARGETS[kind]), gen)
        with torch.no_grad():
            for m in nets[kind].values():
                getattr(m, ZERO_FACTOR[kind]).normal_(0.0, 0.01, generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(sorted(len(v) for v in nets.values()) == [2, 3, 4, 4], f"the block's networks: {nets}")
    cpu = copy.deepcopy(gpu).to("cpu")
    g = torch.Generator().manual_seed(1)
    n_txt, hh, ww, b = 16, 4, 8, 2
    pe = multi_axis_rope(torch.from_numpy(image_position_ids(hh, ww, text_len=n_txt))[None], list(cfg.axes_dim),
                         cfg.theta)
    args = [torch.randn((b, hh * ww, cfg.in_channels), generator=g),
            torch.randn((b, n_txt, cfg.context_dim), generator=g), torch.tensor([0.3, 0.8]),
            torch.randn((b, cfg.vec_dim), generator=g), pe, torch.tensor([4.0, 4.0])]
    target = torch.randn((b, hh * ww, cfg.out_channels or cfg.in_channels), generator=g)
    names = [(kind, n, leaf) for kind, mods in nets.items() for n, m in mods.items()
             for leaf, _ in m.named_parameters()]

    def run(model, device):  # no recompute: the CPU's forward is most of the phase
        model.gradient_checkpointing = False
        linears = dict(model.named_modules())
        params = [getattr(getattr(linears[n], kind), leaf) for kind, n, leaf in names]
        out = model(*[x.to(device) for x in args])
        loss = (out.float() - target.to(device)).square().mean()
        return out.detach().cpu(), loss.item(), [x.cpu() for x in torch.autograd.grad(loss, params)]

    ref, ref_loss, ref_grads = run(cpu, "cpu")
    _reset_launches()
    out, loss, grads = run(gpu, "cuda")
    launches = _launches()
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    res = {"build_s": build_s, "err": err / scale}
    for kind in NETWORK_KINDS:  # each network's gradients against its own largest one
        pairs = [(gd, gr) for (k, _, _), gd, gr in zip(names, grads, ref_grads) if k == kind]
        gmax = max(gr.abs().max().item() for _, gr in pairs)
        gerr = max((gd - gr).abs().max().item() for gd, gr in pairs)
        n_params = sum(p.numel() for m in nets[kind].values() for p in m.parameters())
        print(f"{kind}: {len(nets[kind])} Linears, {n_params:,} params, {len(pairs)} gradients, max|ref|={gmax:.3e}, "
              f"max_abs_err={gerr:.3e} (tol {1e-3 * gmax:.3e})")
        check(gmax > 0 and gerr <= 1e-3 * gmax, f"the {kind} gradients disagree between card and CPU")
        res[f"{kind}_grad_err"] = gerr / gmax
    print(f"networks built on the card in {build_s:.2f} s (LoRM's SVD included); forward max|ref|={scale:.3f} "
          f"max_abs_err={err:.3e} (tol {1e-3 * scale:.3e}); loss card {loss:.6f} vs CPU {ref_loss:.6f}; kernel "
          f"launches={launches}")
    check(bool(torch.isfinite(out).all()) and err <= 1e-3 * scale and abs(loss - ref_loss) <= 1e-4 * abs(ref_loss)
          and launches == _counts(2, 2, 2), "the networks' block disagrees between card and CPU")
    del gpu, cpu, nets
    gc.collect()
    torch.cuda.empty_cache()
    return res


def locon_block_reference() -> dict:
    """A full-width SD 1.5 resnet (320 -> 640: both convs and the 1x1
    shortcut) and spatial transformer (640 wide, 8 heads of 80, cross to 77
    tokens of 768), in f32, batch 2 at 32x32, with a LoRA on every Linear
    and a conv LoRA (LoCon, rank 16) on every Conv, its b drawn non-zero: the
    forward and the loss and every LoRA gradient on the card against the CPU,
    within 1e-3 of the largest reference value."""
    import copy

    from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora, conv_count
    from ai_toolkit_tpu_torch.models.unet import ResnetBlock, SpatialTransformer, UNetConfig
    from ai_toolkit_tpu_torch.ops.layers import init_parameters

    phase("full-width SD 1.5 resnet (320 -> 640) + transformer block (640), f32, LoRA and conv LoRA: card vs CPU")
    cfg = dataclasses.replace(UNetConfig.sd15(), dtype=torch.float32)

    class Pair(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.resnets = torch.nn.ModuleList([ResnetBlock(320, 640, cfg, device="cuda")])
            self.attentions = torch.nn.ModuleList([SpatialTransformer(640, 1, cfg, device="cuda")])

        def forward(self, x, temb, ctx):
            return self.attentions[0](self.resnets[0](x, temb), ctx)

    gen = torch.Generator("cuda").manual_seed(0)
    gpu = init_parameters(Pair(), gen).eval().requires_grad_(False)
    lora = build_lora(gpu, LoRASpec(rank=16, alpha=16.0, conv_rank=16, conv_alpha=8.0), gen)
    with torch.no_grad():
        for m in lora.values():
            m.b.normal_(0.0, 0.01, generator=gen)
    cpu = copy.deepcopy(gpu).to("cpu")
    g = torch.Generator().manual_seed(1)
    args = [torch.randn((2, 32, 32, 320), generator=g), torch.randn((2, cfg.time_embed_dim), generator=g),
            torch.randn((2, 77, 768), generator=g)]
    target = torch.randn((2, 32, 32, 640), generator=g)
    names = [(n, leaf) for n in lora for leaf in ("a", "b", "scale")]

    def run(model, device):
        mods = dict(model.named_modules())
        params = [getattr(mods[n].lora, leaf) for n, leaf in names]
        out = model(*[x.to(device) for x in args])
        loss = (out.float() - target.to(device)).square().mean()
        return out.detach().cpu(), loss.item(), [x.cpu() for x in torch.autograd.grad(loss, params)]

    ref, ref_loss, ref_grads = run(cpu, "cpu")
    out, loss, grads = run(gpu, "cuda")
    scale, err = ref.abs().max().item(), (out - ref).abs().max().item()
    gmax = max(gr.abs().max().item() for gr in ref_grads)
    gerr = max((gd - gr).abs().max().item() for gd, gr in zip(grads, ref_grads))
    print(f"locon: {len(lora)} modules, {conv_count(lora)} of them convs; forward max|ref|={scale:.3f} "
          f"max_abs_err={err:.3e} (tol {1e-3 * scale:.3e}); loss card {loss:.6f} vs CPU {ref_loss:.6f}; "
          f"{len(grads)} gradients, max|ref|={gmax:.3e}, max_abs_err={gerr:.3e} (tol {1e-3 * gmax:.3e})")
    check(conv_count(lora) == 3 and bool(torch.isfinite(out).all()) and err <= 1e-3 * scale
          and gerr <= 1e-3 * gmax and abs(loss - ref_loss) <= 1e-4 * abs(ref_loss),
          "the LoCon blocks disagree between card and CPU")
    del gpu, cpu, lora
    gc.collect()
    torch.cuda.empty_cache()
    return {"err": err / scale, "grad_err": gerr / gmax}


def _network_file_keys(kind: str, proc) -> set[str]:
    """The keys the JAX job's file carries for the job's network (the names
    held to JAX's ``_save`` on the CPU, tests/test_torch_lycoris.py and
    test_torch_lorm.py): LoKr / LoHa ``lora_transformer_`` and the unrolled
    JAX module path, DoRA ``lora_transformer_`` and the BFL name, LoRM PEFT
    keys under the scanned layout's paths (flux-dev's)."""
    from ai_toolkit_tpu_torch.io.from_jax import flux_jax_path

    parts = {"lokr": ("lokr_w1", "lokr_w2", "alpha"), "dora": ("lora_down.weight", "lora_up.weight", "alpha",
                                                               "dora_scale"),
             "loha": ("hada_w1_a", "hada_w1_b", "hada_w2_a", "hada_w2_b", "alpha")}
    if kind == "lorm":
        return {f"transformer.{flux_jax_path(n, scanned=True)}.lora_{ab}.weight" for n in proc.net_modules
                for ab in "AB"}
    ext = (lambda n: n) if kind == "dora" else flux_jax_path
    return {f"lora_transformer_{ext(n).replace('.', '_')}.{part}" for n in proc.net_modules for part in parts[kind]}


def _network_job(card: str, kind: str) -> dict:
    """A flux-dev ``sd_trainer`` job of ``kind``'s network (NETWORK_JOBS) at
    FLUX_FAMILY_CUT, 512^2, batch 1, NETWORK_STEPS steps, adamw8bit, bf16,
    EMA but for LoRM, through ``_run_job`` (15 / 15 / 15 flash launches every
    step): the targeted Linears adapted (the 80 block Linears; LoRM's 20:
    replaced, their weights freed), the network moved (every tensor of it
    against its value when built; the LyCORIS zero factors no longer zero),
    the save's keys those of the JAX job, the LoHa file's deltas read back."""
    from safetensors import safe_open

    from ai_toolkit_tpu_torch.jobs.train_process import SDTrainProcess

    folder = _train_dataset(n=4, size=512, name="knob_data")
    name = f"smoke_net_{kind}"
    train = {"batch_size": 1, "steps": NETWORK_STEPS, "gradient_checkpointing": True,
             "noise_scheduler": "flowmatch", "timestep_type": "flux_shift", "optimizer": "adamw8bit",
             "lr": 1e-4, "max_grad_norm": 1.0, "dtype": "bf16", "seed": 42}
    if kind != "lorm":
        train["ema_config"] = {"use_ema": True, "ema_decay": 0.9}
    raw = {"job": "extension", "config": {"name": name, "process": [{
        "type": "sd_trainer", "training_folder": os.path.join(OUT_DIR, "train"), "trigger_word": "p3r5on",
        "network": NETWORK_JOBS[kind],
        "save": {"dtype": "float16", "save_every": 250, "max_step_saves_to_keep": 4},
        "datasets": [{"folder_path": folder, "caption_ext": "txt", "cache_latents": True,
                      "cache_latents_to_disk": False, "resolution": [512]}],
        "train": train, "model": {**FLUX_MODEL, "quantize": False}, "logging": {"log_every": 1}}]}}
    per_step = _counts(FAMILY_BLOCKS, FAMILY_BLOCKS, FAMILY_BLOCKS)
    built = SDTrainProcess._build_network
    at_build = {}

    def spy(self, *args, **kwargs):  # each trainable tensor's value as built
        trainable, lora = built(self, *args, **kwargs)
        at_build.update({k: p.detach().clone() for k, p in trainable.items()})
        return trainable, lora

    SDTrainProcess._build_network = spy
    try:
        with flux_cut_depth():
            result, proc, report = _run_job(raw, per_step, None)
    finally:
        SDTrainProcess._build_network = built
    tr, ema = proc.state.trainable, proc.state.ema
    n = NETWORK_MODULES[kind]
    check(proc.network_kind == kind and proc.lora is None and len(proc.net_modules) == n == result["lora_modules"],
          f"{kind}: {len(proc.net_modules)} modules, not {n}")
    if kind == "lorm":
        linears = dict(proc.variables["dit"].named_modules())
        check(all(linears[m].weight is None and linears[m].lorm is o for m, o in proc.net_modules.items()),
              "lorm: a replaced Linear kept its weight")
    else:
        zero = ZERO_FACTOR[kind]
        check(all(bool(tr[f"{m}.{zero}"].abs().max() > 0) for m in proc.net_modules),
              f"{kind}: a {zero} factor is still zero after {result['steps']} steps")
        check(any(not torch.equal(ema[k], tr[k]) for k in tr), f"{kind}: the EMA equals the trained network")
    moved = sum(not torch.equal(at_build[k], p.detach()) for k, p in tr.items() if not k.endswith(".scale"))
    check(moved == sum(not k.endswith(".scale") for k in tr), f"{kind}: {moved} of the network's tensors moved")
    with safe_open(result["save_path"], framework="pt") as f:
        keys, meta = set(f.keys()), f.metadata()
    want = _network_file_keys(kind, proc)
    check(keys == want and meta.get("step") == str(result["steps"]),
          f"{kind}: the file holds {len(keys)} keys ({sorted(keys - want)[:3]} not the JAX job's), meta {meta}")
    rep = {"step_ms": result["step_ms"], "peak_gib": report["peak_gib"], "wall_s": report["wall_s"],
           "per_step": per_step, "losses": result["losses"], "keys": len(keys), "modules": n}
    if kind == "loha":  # the LyCORIS file read back into JAX's leaf layout: its deltas are the saved EMA's
        from ai_toolkit_tpu_torch.io.from_jax import flux_jax_path
        from ai_toolkit_tpu_torch.io.lora_file import load_loha_file

        back = load_loha_file(result["save_path"])
        worst = 0.0
        for m in proc.net_modules:
            got = {k: torch.as_tensor(v, device="cuda")
                   for k, v in back[f"lora_transformer_{flux_jax_path(m).replace('.', '_')}"].items()}
            leaf = {k: ema[f"{m}.{k}"].float() for k in ("w1a", "w1b", "w2a", "w2b", "scale")}
            ref = (leaf["w1a"] @ leaf["w1b"]) * (leaf["w2a"] @ leaf["w2b"]) * leaf["scale"]
            delta = (got["w1a"] @ got["w1b"]) * (got["w2a"] @ got["w2b"]) * got["scale"]
            worst = max(worst, float((delta - ref).abs().max()) / max(float(ref.abs().max()), 1e-30))
        print(f"loha: the file's {len(back)} deltas read back against the saved EMA's: worst {worst:.3e} of "
              f"max|delta| (fp16 factors, tol 1e-2)")
        check(len(back) == n and worst <= 1e-2, f"loha: the file's deltas differ from the trained ones by {worst}")
        rep["readback_err"] = worst
    ms = result["step_ms"]
    print(f"{card}: {name}: {n} modules; step ms {', '.join(f'{x:.1f}' for x in ms)}; peak {report['peak_gib']:.2f} "
          f"GiB; launches a step {per_step}; {len(keys)} keys in {result['save_path']}; job wall "
          f"{report['wall_s']:.1f} s")
    del proc
    gc.collect()
    return rep


def _locon_job(card: str, sd15_path: str) -> dict:
    """The SD 1.5 ``sd_trainer`` job on the LDM file with ``type: locon``
    (rank 16, conv rank 16) and ``only_if_contains`` reaching the resnets:
    every Conv of the down, mid and up blocks adapted and trained (their b
    factors moved), 0 flash launches a step (SD 1.5's heads take the plain
    attention), the kohya file's conv factors ``[r, in, kh, kw]`` / ``[out,
    r, 1, 1]``."""
    from safetensors import safe_open

    from ai_toolkit_tpu_torch.adapters.lora import conv_count
    from ai_toolkit_tpu_torch.ops.layers import Conv

    folder = _train_dataset(n=4, size=512, name="knob_data")
    name = "smoke_net_locon"
    raw = {"job": "extension", "config": {"name": name, "process": [{
        "type": "sd_trainer", "training_folder": os.path.join(OUT_DIR, "train"), "trigger_word": "p3r5on",
        "network": {"type": "locon", "linear": 16, "linear_alpha": 16, "network_kwargs": {"only_if_contains":
                                                                                          LOCON_REACH}},
        "save": {"dtype": "float16", "save_every": 250, "max_step_saves_to_keep": 4},
        "datasets": [{"folder_path": folder, "caption_ext": "txt", "cache_latents": True,
                      "cache_latents_to_disk": False, "resolution": [512]}],
        "train": {"batch_size": 1, "steps": NETWORK_STEPS, "noise_scheduler": "ddpm", "optimizer": "adamw8bit",
                  "lr": 1e-4, "max_grad_norm": 1.0, "dtype": "bf16", "seed": 42},
        "model": {"name_or_path": sd15_path, "arch": "sd1"}, "logging": {"log_every": 1}}]}}
    result, proc, report = _run_job(raw, _counts(), None)
    unet = proc.variables["unet"]
    want = [n for n, m in unet.named_modules() if isinstance(m, Conv) and any(s in n for s in LOCON_REACH)]
    n_conv = conv_count(proc.lora)
    tr = proc.state.trainable
    check(n_conv == len(want) > 0 and sorted(n for n in proc.lora if n in set(want)) == sorted(want),
          f"locon: {n_conv} conv modules adapted, the down / mid / up blocks hold {len(want)}")
    check(all(bool(tr[f"{n}.b"].abs().max() > 0) for n in proc.lora), "locon: a b factor is still zero")
    with safe_open(result["save_path"], framework="pt") as f:
        down = f.get_tensor("lora_unet_down_blocks_0_resnets_0_conv1.lora_down.weight")
        up = f.get_tensor("lora_unet_down_blocks_0_resnets_0_conv1.lora_up.weight")
        n_keys = len(list(f.keys()))
    check(tuple(down.shape) == (16, 320, 3, 3) and tuple(up.shape) == (320, 16, 1, 1) and n_keys == 3 * len(proc.lora),
          f"locon: the kohya conv factors are {tuple(down.shape)} / {tuple(up.shape)}, {n_keys} keys")
    ms = result["step_ms"]
    print(f"{card}: {name}: {len(proc.lora)} modules, {n_conv} convs; step ms {', '.join(f'{x:.1f}' for x in ms)}; "
          f"peak {report['peak_gib']:.2f} GiB; 0 flash launches a step; job wall {report['wall_s']:.1f} s")
    rep = {"step_ms": ms, "peak_gib": report["peak_gib"], "wall_s": report["wall_s"], "modules": len(proc.lora),
           "convs": n_conv}
    del proc
    gc.collect()
    return rep


def network_phases(card: str, sd15_path: str) -> dict:
    """The networks the JAX trainer builds besides LoRA: LoKr, LoHa, DoRA and
    LoRM on a full-width flux-dev 1 + 1 block and LoCon on a full-width SD
    1.5 resnet + transformer, card vs CPU; four flux-dev jobs
    at FLUX_FAMILY_CUT (``_network_job``) and the SD 1.5 locon job on the
    LDM file (``_locon_job``)."""
    t_start = time.perf_counter()
    out = {"blocks": network_block_reference(), "locon_block": locon_block_reference()}
    cut = f"flux-dev cut to {FLUX_FAMILY_CUT[0]} + {FLUX_FAMILY_CUT[1]} blocks, 512^2, {NETWORK_STEPS} steps"
    for kind in NETWORK_KINDS:
        phase(f"network job '{kind}': {NETWORK_JOBS[kind]}; {cut}")
        out[kind] = _network_job(card, kind)
    phase(f"network job 'locon' on the SD 1.5 LDM file: only_if_contains {LOCON_REACH}, ddpm, 512^2, "
          f"{NETWORK_STEPS} steps (0 flash launches)")
    out["locon"] = _locon_job(card, sd15_path)
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_start
    print(f"{card}: the network phases {out['wall_s']:.1f} s")
    return out


# ---- the input-expansion adapters: control_lora on flux-dev, the i2v adapter on a Wan 2.1 t2v base ----

EXPANSION_STEPS = 3  # the control_lora and i2v jobs' steps (the inpainting control_lora job: 1)
CONTROL_SAMPLE_STEPS = 4  # the control_lora job's one sample, with a ctrl_img


def expansion_reference() -> dict:
    """The ``ctrl`` overlay on ``Linear`` at full width, in f32, card vs CPU:
    flux-dev's ``img_in`` (64 -> 3072) with 64 extra packed channels and a
    rank-16 LoRA over the base features, and with the inpainting input's 68;
    Wan 2.1 1.3B's ``patch_embedding`` (64 -> 1536) with the frame embedder's
    80 and its bias. The forward and the gradients of the input, the
    expansion (and the LoRA) within 1e-3 of the largest reference value."""
    from ai_toolkit_tpu_torch.ops.layers import Ctrl, Linear, LoRA, init_parameters

    phase("the ctrl overlay on Linear at full width (f32): flux-dev img_in with 64 (+ a LoRA) and 68 extra channels, "
          "Wan 2.1 1.3B patch_embedding with the frame embedder's 80: card vs CPU")
    out = {}
    g = torch.Generator().manual_seed(3)
    for label, cin, cout, extra, tokens, lora, bias in (("flux img_in", 64, 3072, 64, 1024, True, False),
                                                        ("flux img_in, inpainting", 64, 3072, 68, 1024, False, False),
                                                        ("Wan patch_embedding", 64, 1536, 80, 8100, False, True)):
        mods = []
        for dev in ("cpu", "cuda"):
            lin = init_parameters(Linear(cin, cout, device=dev, dtype=torch.float32),
                                  torch.Generator(dev).manual_seed(0)).requires_grad_(False)
            mods.append(lin)
        w = torch.randn((extra, cout), generator=g) * 0.01
        b = torch.randn((cout,), generator=g) * 0.1 if bias else None
        a_b = (torch.randn((cin, 16), generator=g) * 0.05, torch.randn((16, cout), generator=g) * 0.05)
        for lin in mods:
            dev = lin.weight.device
            lin.weight.copy_(mods[0].weight.to(dev))
            lin.ctrl = Ctrl(w.to(dev), None if b is None else b.to(dev))
            if lora:
                lin.lora = LoRA(cin, 16, cout, 1.0, device=dev)
                with torch.no_grad():
                    lin.lora.a.copy_(a_b[0].to(dev))
                    lin.lora.b.copy_(a_b[1].to(dev))
        x = torch.randn((1, tokens, cin + extra), generator=g)
        target = torch.randn((1, tokens, cout), generator=g)
        res = []
        for lin in mods:
            dev = lin.weight.device
            xd = x.to(dev).requires_grad_(True)
            y = lin(xd)
            params = [xd, lin.ctrl.w] + ([lin.ctrl.b] if bias else []) + ([lin.lora.a, lin.lora.b] if lora else [])
            grads = torch.autograd.grad((y - target.to(dev)).square().mean(), params)
            res.append((y.detach().cpu(), [gr.cpu() for gr in grads]))
        (ref, ref_g), (got, got_g) = res
        scale, err = ref.abs().max().item(), (got - ref).abs().max().item()
        gmax = max(gr.abs().max().item() for gr in ref_g)
        gerr = max((a - r).abs().max().item() for a, r in zip(got_g, ref_g))
        print(f"{label} ({cin} + {extra} -> {cout}, {tokens} tokens{', LoRA rank 16' if lora else ''}"
              f"{', expansion bias' if bias else ''}): forward max|ref|={scale:.3e} max_abs_err={err:.3e} "
              f"(tol {1e-3 * scale:.3e}); {len(ref_g)} gradients max|ref|={gmax:.3e} max_abs_err={gerr:.3e} "
              f"(tol {1e-3 * gmax:.3e})")
        check(bool(torch.isfinite(got).all()) and err <= 1e-3 * scale and gmax > 0 and gerr <= 1e-3 * gmax,
              f"the ctrl overlay ({label}) disagrees between card and CPU")
        out[label] = {"err": err / scale, "grad_err": gerr / gmax}
    return out


def _spy_build(at_build: dict):
    """Record each trainable tensor of a job as the job builds it (its network
    and its expansion) in ``at_build``; returns the undo."""
    from ai_toolkit_tpu_torch.jobs.train_process import SDTrainProcess

    net, exp = SDTrainProcess._build_network, SDTrainProcess._build_expansion

    def spy_net(self, *args, **kwargs):
        trainable, lora = net(self, *args, **kwargs)
        at_build.update({k: p.detach().clone() for k, p in trainable.items()})
        return trainable, lora

    def spy_exp(self, model, variables, seed):
        out = exp(self, model, variables, seed)
        at_build.update({k: p.detach().clone() for k, p in out.items()})
        if self.expansion == "i2v":  # the base's own tensors, which must stay frozen
            grafted = {k[len("i2v."):] for k in out if k.startswith("i2v.")}
            at_build["__base__"] = {n: _checksum(p) for n, p in variables["dit"].named_parameters()
                                    if n not in grafted and not n.startswith("patch_embedding.ctrl")}
        return out

    SDTrainProcess._build_network, SDTrainProcess._build_expansion = spy_net, spy_exp

    def undo():
        SDTrainProcess._build_network, SDTrainProcess._build_expansion = net, exp

    return undo


def _control_lora_raw(name: str, steps: int, inpaint: bool = False, sample: bool = False) -> dict:
    """The control_lora job on flux-dev at 512^2: the four seeded images with a
    control image each (``_control_folders``), or with the inpainting input
    (the RGBA inpaint folder: one item's keep mask, random blobs for the
    others), the LoRA given as ``network``, rank 16, adamw8bit, EMA, bf16,
    the fp16 save; with ``sample``, one final sample of a prompt with a
    ``ctrl_img``."""
    ctrl, inp = _control_folders()
    dataset = {"folder_path": _train_dataset(n=4, size=512, name="knob_data"), "caption_ext": "txt",
               "cache_latents": True, "cache_latents_to_disk": False, "resolution": [512]}
    dataset["inpaint_path" if inpaint else "control_path"] = inp if inpaint else ctrl
    proc = {"type": "sd_trainer", "training_folder": os.path.join(OUT_DIR, "train"), "trigger_word": "p3r5on",
            "network": {"type": "lora", "linear": 16, "linear_alpha": 16},
            "adapter": {"type": "control_lora", "num_control_images": 1, "has_inpainting_input": inpaint,
                        "control_image_dropout": 0.1},
            "save": {"dtype": "float16", "save_every": 250, "max_step_saves_to_keep": 4},
            "datasets": [dataset],
            "train": {"batch_size": 1, "steps": steps, "gradient_checkpointing": True, "noise_scheduler": "flowmatch",
                      "timestep_type": "flux_shift", "optimizer": "adamw8bit", "lr": 1e-4, "max_grad_norm": 1.0,
                      "ema_config": {"use_ema": True, "ema_decay": 0.9}, "dtype": "bf16", "seed": 42,
                      "disable_sampling": not sample, "skip_first_sample": True},
            "model": {**FLUX_MODEL, "quantize": False}, "logging": {"log_every": 1}}
    if sample:
        proc["sample"] = {"sample_every": 0, "width": 512, "height": 512, "sample_steps": CONTROL_SAMPLE_STEPS,
                          "guidance_scale": 4, "seed": 42,
                          "prompts": [{"prompt": "p3r5on photo of a red fox", "ctrl_img": os.path.join(ctrl, "img_1.png")}]}
    return {"job": "extension", "config": {"name": name, "process": [proc]}}


def _expansion_file(path: str) -> dict:
    from safetensors import safe_open

    with safe_open(path, framework="pt") as f:
        return {k: tuple(f.get_slice(k).get_shape()) for k in f.keys()}, f.metadata()


def control_lora_phase(card: str) -> dict:
    """The control_lora job (EXPANSION_STEPS steps and a sample with a control
    image), its rerun one step further (the resume reads the expansion and
    the exact state back), and one step of the inpainting input: 15 / 15 / 15
    flash launches every step, 15 a denoise step."""
    from ai_toolkit_tpu_torch.jobs.train_process import SDTrainProcess
    from ai_toolkit_tpu_torch.models.flux_model import FluxModel

    per_step = _counts(FAMILY_BLOCKS, FAMILY_BLOCKS, FAMILY_BLOCKS)
    cut = f"flux-dev cut to {FLUX_FAMILY_CUT[0]} + {FLUX_FAMILY_CUT[1]} blocks, 512^2"
    phase(f"control_lora job: {cut}, one control image an item, rank 16, {EXPANSION_STEPS} steps, a final sample "
          f"with a ctrl_img ({CONTROL_SAMPLE_STEPS} steps)")
    name = "smoke_control_lora"
    at_build, samples = {}, []
    real_scl = FluxModel.sampling_control_latents

    def spy_scl(self, *args, **kwargs):
        out = real_scl(self, *args, **kwargs)
        samples.append(float(out.abs().max()))
        return out

    undo = _spy_build(at_build)
    FluxModel.sampling_control_latents = spy_scl
    try:
        with flux_cut_depth():
            result, proc, report = _run_job(_control_lora_raw(name, EXPANSION_STEPS, sample=True), per_step, None,
                                            denoise=_counts(fwd=FAMILY_BLOCKS))
    finally:
        undo()
        FluxModel.sampling_control_latents = real_scl
    tr, ema = proc.state.trainable, proc.state.ema
    hidden = proc.model.dit_config.hidden_size
    check(proc.expansion == "control_lora" and tuple(tr["ctrl.w"].shape) == (64, hidden)
          and proc.model.dit_config.control_channels == 64, f"control_lora: the expansion {tuple(tr['ctrl.w'].shape)}")
    moved = [k for k in tr if not k.endswith(".scale") and not torch.equal(at_build[k], tr[k].detach())]
    check("ctrl.w" in moved and len(moved) == sum(not k.endswith(".scale") for k in tr),
          f"control_lora: {len(moved)} of {len(tr)} trainable tensors moved ('ctrl.w' moved: {'ctrl.w' in moved})")
    check(not any(n.startswith("img_in") for n in proc.lora) and len(proc.lora) == 80,
          f"control_lora: the LoRA has {len(proc.lora)} modules, img_in among them: "
          f"{any(n.startswith('img_in') for n in proc.lora)}")
    path = check_lora_job(result, proc)
    keys, meta = _expansion_file(path)
    check(keys.get("transformer.x_embedder.weight") == (hidden, 64),
          f"control_lora: transformer.x_embedder.weight is {keys.get('transformer.x_embedder.weight')}")
    check(len(result["samples"]) == 1 and os.path.isfile(result["samples"][0]["path"]) and samples
          and samples[-1] > 0, f"control_lora: samples {result['samples']}, control latents max {samples}")
    trained = tr["ctrl.w"].detach().clone()
    rep = {"step_ms": result["step_ms"], "peak_gib": report["peak_gib"], "wall_s": report["wall_s"],
           "per_step": per_step, "losses": result["losses"], "lora_modules": len(proc.lora), "keys": len(keys),
           "sample_s": result["samples"][0]["seconds"]}
    print(f"{card}: {name}: {len(proc.lora)} LoRA modules + the 64 x {hidden} expansion; step ms "
          f"{', '.join(f'{x:.1f}' for x in result['step_ms'])}; peak {report['peak_gib']:.2f} GiB; launches a step "
          f"{per_step}; {len(keys)} keys in {path}; one sample with a ctrl_img in {rep['sample_s']:.2f} s; job wall "
          f"{report['wall_s']:.1f} s")
    del proc, tr, ema
    gc.collect()

    phase(f"control_lora job rerun to {EXPANSION_STEPS + 1} steps: the resume reads the saved expansion and state")
    resumed_w = {}
    real_resume = SDTrainProcess._resume

    def spy_resume(self, ckpt, model, state, lora, generator):
        step = real_resume(self, ckpt, model, state, lora, generator)
        resumed_w["w"] = state.trainable["ctrl.w"].detach().clone()
        resumed_w["file"] = self._expansion_from_file(ckpt.latest_save_path(), {
            "ctrl.w": tuple(state.trainable["ctrl.w"].shape)})["ctrl.w"]
        return step

    SDTrainProcess._resume = spy_resume
    try:
        with flux_cut_depth():
            result2, proc2, report2 = _run_job(_control_lora_raw(name, EXPANSION_STEPS + 1), per_step, None,
                                               fresh=False)
    finally:
        SDTrainProcess._resume = real_resume
    ema_w = resumed_w["file"].to(trained.device)
    check(result2["start_step"] == EXPANSION_STEPS and torch.equal(resumed_w["w"], trained)
          and tuple(ema_w.shape) == (64, hidden) and float(ema_w.abs().max()) > 0,
          f"control_lora: the rerun started at {result2['start_step']}, the expansion restored: "
          f"{torch.equal(resumed_w['w'], trained)}")
    print(f"{card}: {name} resumed at step {result2['start_step']}: the expansion restored exactly (the file's EMA "
          f"copy read back, max {float(ema_w.abs().max()):.3e}); step ms {result2['step_ms'][0]:.1f}")
    rep["resumed_step_ms"] = result2["step_ms"]
    del proc2
    gc.collect()

    phase(f"control_lora job with has_inpainting_input: {cut}, the RGBA inpaint folder, 1 step")
    result3, proc3, report3 = None, None, None
    with flux_cut_depth():
        result3, proc3, report3 = _run_job(_control_lora_raw("smoke_control_lora_inpaint", 1, inpaint=True),
                                           per_step, None)
    keys3, _ = _expansion_file(result3["save_path"])
    check(proc3.model.control_lora_inpaint and keys3.get("transformer.x_embedder.weight") == (hidden, 68),
          f"control_lora inpainting: transformer.x_embedder.weight is {keys3.get('transformer.x_embedder.weight')}")
    print(f"{card}: smoke_control_lora_inpaint: the 68 x {hidden} expansion; step ms {result3['step_ms'][0]:.1f}; "
          f"peak {report3['peak_gib']:.2f} GiB; launches a step {per_step}; job wall {report3['wall_s']:.1f} s")
    rep.update(inpaint_step_ms=result3["step_ms"], inpaint_peak_gib=report3["peak_gib"])
    del proc3
    gc.collect()
    return rep


def i2v_phase(card: str) -> dict:
    """The i2v adapter job on the Wan 2.1 1.3B t2v base at full width and depth
    (configs/examples/train_lora_wan21_tpu.yaml with its network given as
    ``adapter.lora_config``): the seeded ViT-H, ``i2v_do_start_frame``, 33
    frames at 480^2, EXPANSION_STEPS steps. Each block's three attentions
    (self, text, the image's 257 tokens) run twice a step (the recompute)
    and their backward once: 180 / 90 / 90 launches a step."""
    example = "train_lora_wan21_tpu.yaml"
    name = "smoke_i2v_adapter"
    phase(f"i2v adapter job on Wan 2.1 1.3B (t2v base, full width and depth), i2v_do_start_frame, {WAN_FRAMES} "
          f"frames at {WAN_RES}^2, the seeded ViT-H, {EXPANSION_STEPS} steps")
    raw, path = _job_file(example, name, None, _wan_clips(WAN_RES), do_i2v=True)
    proc_cfg = raw["config"]["process"][0]
    proc_cfg["adapter"] = {"type": "i2v", "i2v_do_start_frame": True, "lora_config": proc_cfg.pop("network")}
    proc_cfg["train"]["steps"] = EXPANSION_STEPS
    raw = _read_back(raw, path, example)
    per_step = _counts(6 * WAN_BLOCKS, 3 * WAN_BLOCKS, 3 * WAN_BLOCKS)
    at_build = {}
    undo = _spy_build(at_build)
    try:
        result, proc, report = _run_job(raw, per_step, None)
    finally:
        undo()
    tr = proc.state.trainable
    dit = proc.variables["dit"]
    grafted = [k for k in tr if k.startswith("i2v.")]
    moved = [k for k in grafted + ["ctrl.w", "ctrl.b"] if not torch.equal(at_build[k], tr[k].detach())]
    check(len(grafted) == 5 * WAN_BLOCKS + 8 and len(moved) == len(grafted) + 2,
          f"i2v: {len(moved)} of the {len(grafted)} grafted tensors and the frame embedder moved")
    base = {n: _checksum(p) for n, p in dit.named_parameters() if n in at_build["__base__"]}
    check(base == at_build["__base__"] and len(base) > 0, "i2v: the frozen base changed")
    check(proc.variables["clip_vision"].cfg.hidden_size == 1280 and tuple(tr["ctrl.w"].shape) == (80, 1536),
          f"i2v: the vision tower or the frame embedder {tuple(tr['ctrl.w'].shape)}")
    check(not any(("add_" in n) or n.startswith("patch_embedding") for n in proc.lora) and len(proc.lora) == 300,
          f"i2v: the LoRA has {len(proc.lora)} modules")
    path = check_lora_job(result, proc)
    keys, _ = _expansion_file(path)
    want = {f"attn_hog.{i}.{k}": s for i in range(WAN_BLOCKS)
            for k, s in (("add_k_proj.weight", (1536, 1536)), ("add_k_proj.bias", (1536,)),
                         ("add_v_proj.weight", (1536, 1536)), ("add_v_proj.bias", (1536,)),
                         ("norm_added_k.weight", (1536,)), ("norm_added_q.weight", (1536,)))}
    want.update({"image_embedder.norm1.weight": (1280,), "image_embedder.norm1.bias": (1280,),
                 "image_embedder.ff.net.0.proj.weight": (1280, 1280), "image_embedder.ff.net.0.proj.bias": (1280,),
                 "image_embedder.ff.net.2.weight": (1536, 1280), "image_embedder.ff.net.2.bias": (1536,),
                 "image_embedder.norm2.weight": (1536,), "image_embedder.norm2.bias": (1536,),
                 "frame_embedder.patch_embedding.weight": (1536, 20, 1, 2, 2),
                 "frame_embedder.patch_embedding.bias": (1536,)})
    extra = {k: v for k, v in keys.items() if ".lora_" not in k and not k.endswith(".alpha")}
    check(extra == want, f"i2v: the file's grafted keys {sorted(set(extra) ^ set(want))[:4]} differ from the JAX "
                         f"layout's")
    rep = {"step_ms": result["step_ms"], "peak_gib": report["peak_gib"], "wall_s": report["wall_s"],
           "per_step": per_step, "losses": result["losses"], "grafted_params": sum(tr[k].numel() for k in grafted),
           "keys": len(keys)}
    print(f"{card}: {name}: {len(grafted)} grafted tensors ({rep['grafted_params']:,} params) + the 80 x 1536 "
          f"frame embedder moved, the base frozen; step ms {', '.join(f'{x:.1f}' for x in result['step_ms'])}; peak "
          f"{report['peak_gib']:.2f} GiB; launches a step {per_step}; {len(keys)} keys in {path}; job wall "
          f"{report['wall_s']:.1f} s")
    del proc, tr, dit
    gc.collect()
    torch.cuda.empty_cache()
    return rep


def expansion_phases(card: str) -> dict:
    """The two input-expansion adapters: the ``ctrl`` overlay card vs CPU, the
    control_lora jobs on flux-dev at FLUX_FAMILY_CUT and the i2v adapter job
    on the Wan 2.1 1.3B t2v base."""
    t_start = time.perf_counter()
    out = {"overlay": expansion_reference(), "control_lora": control_lora_phase(card), "i2v": i2v_phase(card)}
    out["wall_s"] = time.perf_counter() - t_start
    print(f"{card}: the expansion adapter phases {out['wall_s']:.1f} s")
    return out


# ---- the UNet's adapter inputs: IP-Adapter and the T2I adapter ----

ADAPTER_STEPS = 3  # each adapter-input job's steps (the SDXL rerun: one more)
# the decoupled cross-attention's short K/V: (B, S, T, H, D)
IP_SHAPES = [((2, 4096, 4, 10, 64), "SDXL level-1, 4 image tokens"),
             ((2, 4096, 16, 10, 64), "SDXL level-1, 16 image tokens"),
             ((2, 1024, 16, 20, 64), "SDXL level-2, 16 image tokens"),
             ((1, 1536, 16, 24, 128), "flux-dev 512^2 joint query, 16 image tokens")]
SDXL_IP_SITES = SDXL_ATTENTIONS // 2  # every transformer block's attn2


def adapter_input_reference() -> dict:
    """Full width, f32, card vs CPU, within 1e-3 of the largest reference
    value: one SDXL transformer block at 1280 channels (level 2's 1024
    tokens, 77 text tokens) with its decoupled K/V over 16 image tokens, the
    forward and the gradients of ip_k, ip_v and scale; the T2I net at SDXL's
    channels on a 512^2 control image, its three levels' features; the
    Resampler at ViT-H width (257 patch tokens of 1280 -> 16 x 2048, dim
    768, depth 4, 12 heads)."""
    from ai_toolkit_tpu_torch.adapters.ip_adapter import Resampler, UNetIP
    from ai_toolkit_tpu_torch.adapters.t2i_adapter import T2IAdapterNet
    from ai_toolkit_tpu_torch.models.unet import TransformerBlock, UNetConfig
    from ai_toolkit_tpu_torch.ops.layers import init_parameters

    phase("the UNet's adapter inputs at full width (f32): an SDXL transformer block with its decoupled K/V, the "
          "T2I net at SDXL's channels, the Resampler at ViT-H width: card vs CPU")
    cfg = dataclasses.replace(UNetConfig.sdxl(), dtype=torch.float32)
    g = torch.Generator().manual_seed(5)
    out = {}

    def compare(label, build, inputs, grads_of=None):
        mods = []
        for dev in ("cpu", "cuda"):
            m = build(dev)
            if mods:
                m.load_state_dict(mods[0].state_dict())
            mods.append(m)
        res = []
        for m in mods:
            dev = "cuda" if next(m.parameters()).is_cuda else "cpu"
            y = m(*[x.to(dev) for x in inputs])
            ys = list(y) if isinstance(y, tuple) else [y]
            gr = []
            if grads_of:
                params = grads_of(m)
                gr = [x.cpu() for x in torch.autograd.grad(sum(v.square().mean() for v in ys), params)]
            res.append(([v.detach().cpu() for v in ys], gr))
        (ref, ref_g), (got, got_g) = res
        scale = max(r.abs().max().item() for r in ref)
        err = max((a - r).abs().max().item() for a, r in zip(got, ref))
        msg = f"{label}: forward max|ref|={scale:.3e} max_abs_err={err:.3e} (tol {1e-3 * scale:.3e})"
        ok = all(bool(torch.isfinite(a).all()) for a in got) and err <= 1e-3 * scale
        gerr = 0.0
        if ref_g:
            gmax = max(r.abs().max().item() for r in ref_g)
            gerr = max((a - r).abs().max().item() for a, r in zip(got_g, ref_g))
            msg += f"; {len(ref_g)} gradients max|ref|={gmax:.3e} max_abs_err={gerr:.3e} (tol {1e-3 * gmax:.3e})"
            ok = ok and gmax > 0 and gerr <= 1e-3 * gmax
            gerr /= gmax
        print(msg)
        check(ok, f"{label} disagrees between card and CPU")
        out[label] = {"err": err / scale, "grad_err": gerr}

    def block(dev):
        blk = init_parameters(TransformerBlock(1280, cfg, device=dev), torch.Generator(dev).manual_seed(0))
        blk.requires_grad_(False)
        blk.ip = UNetIP(torch.randn(1280, 2048, generator=torch.Generator(dev).manual_seed(1), device=dev) * 0.02,
                        torch.randn(1280, 2048, generator=torch.Generator(dev).manual_seed(2), device=dev) * 0.02,
                        0.8)
        return blk

    compare("SDXL transformer block, 1280 ch, 1024 tokens, decoupled K/V over 16 image tokens", block,
            [torch.randn(1, 1024, 1280, generator=g), torch.randn(1, 77, 2048, generator=g),
             torch.randn(1, 16, 2048, generator=g)], lambda m: [m.ip.ip_k, m.ip.ip_v, m.ip.scale])
    compare("T2I net at SDXL's channels (320, 640, 1280), 512^2 control",
            lambda dev: init_parameters(T2IAdapterNet(cfg.block_out_channels, 8, device=dev),
                                        torch.Generator(dev).manual_seed(3)).requires_grad_(False),
            [torch.rand(1, 512, 512, 3, generator=g) * 2 - 1])
    compare("Resampler at ViT-H width, 257 x 1280 -> 16 x 2048",
            lambda dev: init_parameters(Resampler(1280, 2048, 16, 768, 4, 12, device=dev),
                                        torch.Generator(dev).manual_seed(4)).requires_grad_(False),
            [torch.randn(1, 257, 1280, generator=g)])
    return out


def _footprint_gib(root: str = OUT_DIR) -> float:
    """The bytes of the files under ``root`` now, GiB (a file overwritten or
    deleted earlier is not counted, though the machine's disk counts its
    writes)."""
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs) / 2**30


def _adapter_raw(name: str, model: dict, folder: str, steps: int, adapter: dict | None = None, size: int = 512,
                 network: dict | None = None, train: dict | None = None, sample: list | None = None, **dataset) -> dict:
    """An adapter-input job over the seeded images at ``size``^2: batch 1,
    adamw8bit at 1e-4 (its 8-bit moments halve the training state these
    f32 adapters write: the machine's disk takes 45 GiB of writes in all;
    the t2i and assistant jobs take adamw: adamw8bit's 8-bit second moment,
    JAX's as the port's, lets a few elements jump by up to ~1000x the
    learning rate, and a t2i net so trained drowns the assistant job's
    LoRA gradients),
    bf16, the in-memory latent cache, the trainer's cadence off;
    ``sample``: prompts of one final sample (4 steps)."""
    flow = model["arch"].startswith("flux")
    proc = {"type": "sd_trainer", "training_folder": os.path.join(OUT_DIR, "train"), "trigger_word": "p3r5on",
            "save": {"dtype": "float16", "save_every": 250, "max_step_saves_to_keep": 4},
            "datasets": [{"folder_path": folder, "caption_ext": "txt", "cache_latents": True,
                          "cache_latents_to_disk": False, "resolution": [size], **dataset}],
            "train": {"batch_size": 1, "steps": steps, "noise_scheduler": "flowmatch" if flow else "ddpm",
                      "optimizer": "adamw8bit", "lr": 1e-4, "dtype": "bf16", "seed": 42, "gradient_checkpointing": True,
                      "disable_sampling": not sample, "skip_first_sample": True, **(train or {})},
            "model": model, "logging": {"log_every": 1}}
    if flow:
        proc["train"]["timestep_type"] = "flux_shift"
    if adapter:
        proc["adapter"] = adapter
    if network:
        proc["network"] = network
    if sample:
        proc["sample"] = {"sample_every": 0, "width": size, "height": size, "sample_steps": CONTROL_SAMPLE_STEPS,
                          "guidance_scale": 4, "seed": 42, "prompts": sample}
    return {"job": "extension", "config": {"name": name, "process": [proc]}}


def _spy_base(at_build: dict):
    """Record the checksums of the model's main component when the job builds
    its IP-Adapter (``at_build["__base__"]``) and the trainable tensors;
    returns the undo."""
    from ai_toolkit_tpu_torch.jobs.train_process import SDTrainProcess

    real = SDTrainProcess._build_ip

    def spy(self, model, variables, seed):
        out = real(self, model, variables, seed)
        at_build.update({k: p.detach().clone() for k, p in out.items()})
        at_build["__base__"] = {n: _checksum(p) for n, p in variables[model.main_component].named_parameters()
                                if ".ip." not in n}
        return out

    SDTrainProcess._build_ip = spy

    def undo():
        SDTrainProcess._build_ip = real

    return undo


def _ip_job(card: str, name: str, raw: dict, per_step: dict, sites: int, n_tokens: int,
            denoise: dict | None = None) -> tuple[dict, dict, object]:
    """Run an IP-Adapter job and check it: every trainable tensor moved (the
    scales too), the base unchanged, the sites and tokens, the file's keys
    and shapes (``image_proj.*`` and each site's ``ip_adapter.{i}.to_k_ip`` /
    ``to_v_ip``), the peak."""
    from safetensors import safe_open

    at_build = {}
    undo = _spy_base(at_build)
    try:
        result, proc, report = _run_job(raw, per_step, None, denoise=denoise)
    finally:
        undo()
    tr = proc.state.trainable
    main = proc.variables[proc.model.main_component]
    moved = [k for k in tr if not torch.equal(at_build[k], tr[k].detach())]
    check(len(moved) == len(tr) and len(proc.ip) == sites == result["ip_sites"],
          f"{name}: {len(moved)} of {len(tr)} trainable tensors moved, {len(proc.ip)} sites (want {sites})")
    base = {n: _checksum(p) for n, p in main.named_parameters() if ".ip." not in n}
    check(base == at_build["__base__"] and len(base) > 0, f"{name}: the frozen base changed")
    with safe_open(result["save_path"], framework="pt") as f:
        keys = {k: tuple(f.get_slice(k).get_shape()) for k in f.keys()}
        meta = f.metadata()
    kv = [k for k in keys if k.startswith("ip_adapter.")]
    shapes = [tuple(m.to_k.shape if hasattr(m, "to_k") else m.ip_k.shape) for m in proc.ip.values()]
    want_kv = {f"ip_adapter.{i}.to_{x}_ip.weight": s for i, s in enumerate(shapes) for x in "kv"}
    proj = {f"image_proj.{k}": tuple(v.shape) for k, v in proc.ip_proj.state_dict().items()}
    check({k: keys[k] for k in kv} == want_kv and {k: v for k, v in keys.items() if k not in want_kv} == proj
          and meta == {"step": str(result["steps"])}, f"{name}: the file's keys or shapes differ from JAX "
                                                     f"save_ip_adapter's layout")
    tokens = proc.ip_proj(torch.zeros((1, 257, proc.vision_tower.cfg.hidden_size) if proc.ip_plus else
                                      (1, proc.vision_tower.cfg.projection_dim), device="cuda"))
    check(tokens.shape[1] == n_tokens, f"{name}: {tokens.shape[1]} image tokens (want {n_tokens})")
    rep = {"step_ms": result["step_ms"], "peak_gib": report["peak_gib"], "wall_s": report["wall_s"],
           "per_step": per_step, "losses": result["losses"], "sites": sites, "tokens": n_tokens,
           "trainable_params": result["trainable_params"], "keys": len(keys)}
    print(f"{card}: {name}: {sites} sites, {n_tokens} image tokens, {result['trainable_params']:,} trainable params, "
          f"all moved, the base unchanged; step ms {', '.join(f'{x:.1f}' for x in result['step_ms'])}; peak "
          f"{report['peak_gib']:.2f} GiB; launches a step {per_step}; {len(keys)} keys in {result['save_path']}; "
          f"job wall {report['wall_s']:.1f} s")
    return rep, result, proc


def sdxl_ip_phase(card: str) -> dict:
    """SDXL ``ip_adapter_plus`` at full width and depth on the SDXL checkpoint
    (written by ``sdxl_shipped_phases``): 1024^2, the seeded ViT-H's
    penultimate states through the Resampler into 16 tokens, 3 steps. Each
    of the 70 blocks runs self-attention, the text cross-attention and the
    image cross-attention: 210 forward launches; the first block's two base
    attentions need no gradient (nothing upstream of its image K/V trains),
    so 208 dq and dk/dv. Then the sample with a ``ctrl_img`` (refused: JAX's
    ``generate_sd`` ignores the adapter image) and a rerun one step further."""
    from ai_toolkit_tpu_torch.jobs import get_job
    from ai_toolkit_tpu_torch.jobs.train_process import SDTrainProcess

    name = "smoke_sdxl_ip_plus"
    root = os.path.join(OUT_DIR, "sdxl_checkpoint")
    model = {**SDXL_MODEL, "name_or_path": root}
    per_step = _counts(3 * SDXL_IP_SITES, 3 * SDXL_IP_SITES - 2, 3 * SDXL_IP_SITES - 2)
    phase(f"SDXL ip_adapter_plus job: the SDXL checkpoint, 1024^2, batch 1, the seeded ViT-H, 16 tokens, "
          f"{ADAPTER_STEPS} steps")
    folder = _train_dataset()
    rep, result, proc = _ip_job(card, name, _adapter_raw(name, model, folder, ADAPTER_STEPS,
                                                         {"type": "ip_adapter_plus"}, size=1024),
                                per_step, SDXL_IP_SITES, 16)
    trained = {k: v.detach().clone() for k, v in proc.state.trainable.items()}
    del proc
    gc.collect()

    ctrl, _ = _control_folders()
    refused = _adapter_raw(name, model, folder, ADAPTER_STEPS, {"type": "ip_adapter_plus"}, size=1024,
                           sample=[{"prompt": "p3r5on photo", "ctrl_img": os.path.join(ctrl, "img_1.png")}])
    try:
        get_job(refused, device="cuda").processes[0]._refuse_unported()
        raised = ""
    except NotImplementedError as e:
        raised = str(e)
    check("generate_sd never reads" in raised, f"{name}: the sample with a ctrl_img was not refused ({raised!r})")
    print(f"{card}: {name}: a final sample with a ctrl_img refused: {raised[:120]}...")

    phase(f"SDXL ip_adapter_plus job rerun to {ADAPTER_STEPS + 1} steps: the resume restores the exact state")
    restored = {}
    real_resume = SDTrainProcess._resume

    def spy_resume(self, *args):
        step = real_resume(self, *args)
        restored.update({k: v.detach().clone() for k, v in self.state.trainable.items()})
        return step

    SDTrainProcess._resume = spy_resume
    try:
        result2, proc2, report2 = _run_job(_adapter_raw(name, model, folder, ADAPTER_STEPS + 1,
                                                        {"type": "ip_adapter_plus"}, size=1024),
                                           per_step, None, fresh=False)
    finally:
        SDTrainProcess._resume = real_resume
    exact = sorted(restored) == sorted(trained) and all(torch.equal(restored[k], trained[k]) for k in trained)
    check(result2["start_step"] == ADAPTER_STEPS and exact,
          f"{name}: the rerun started at {result2['start_step']}, the trained tensors restored exactly: {exact}")
    print(f"{card}: {name} resumed at step {result2['start_step']}: {len(trained)} trained tensors restored exactly; "
          f"step ms {result2['step_ms'][0]:.1f}")
    rep["resumed_step_ms"] = result2["step_ms"]
    del proc2
    gc.collect()
    torch.cuda.empty_cache()
    return rep


def adapter_input_phases(card: str, sd15_path: str) -> dict:
    """IP-Adapter and the T2I adapter: the flash kernels at the image
    tokens' short K/V, the modules card vs CPU, the SDXL, SD 1.5 and flux-dev
    IP jobs, the SD 1.5 t2i job and the LoRA job with its save as the
    assistant."""
    from ai_toolkit_tpu_torch.adapters.custom_adapter import load_custom_adapter
    from ai_toolkit_tpu_torch.adapters.t2i_adapter import t2i_state_from_flat

    t_start = time.perf_counter()
    out = {"err": flash_checks("flash kernels vs plain versions at the IP-Adapter's image tokens (T = 4, 16), bf16",
                               [(shape, label, True, None) for shape, label in IP_SHAPES], 12),
           "times": attention_times("flash kernels at the IP-Adapter's image tokens, bf16", "IP",
                                    [(shape, label, True) for shape, label in IP_SHAPES], 13),
           "reference": adapter_input_reference(), "sdxl": sdxl_ip_phase(card)}

    sd15 = {"name_or_path": sd15_path, "arch": "sd1"}
    data = _train_dataset(n=4, size=512, name="knob_data")
    phase(f"SD 1.5 ip_adapter job: the LDM file, 512^2, the seeded ViT-H's pooled embedding into 4 tokens, "
          f"{ADAPTER_STEPS} steps (the plain attention: 0 flash launches)")
    name = "smoke_sd15_ip"
    out["sd15"], _, proc = _ip_job(card, name, _adapter_raw(name, sd15, data, ADAPTER_STEPS, {"type": "ip_adapter"}),
                                   _counts(), 16, 4)
    del proc
    gc.collect()

    ctrl, _ = _control_folders()
    fam = sum(FLUX_FAMILY_CUT)
    phase(f"flux-dev ip_adapter job: flux-dev cut to {FLUX_FAMILY_CUT[0]} + {FLUX_FAMILY_CUT[1]} blocks, 512^2, "
          f"the Resampler into 16 tokens, {ADAPTER_STEPS} steps, a final sample with a ctrl_img "
          f"({CONTROL_SAMPLE_STEPS} steps)")
    name = "smoke_flux_ip"
    raw = _adapter_raw(name, {**FLUX_MODEL, "quantize": False}, data, ADAPTER_STEPS,
                       {"type": "ip_adapter", "num_tokens": 16},
                       sample=[{"prompt": "p3r5on photo of a red fox", "ctrl_img": os.path.join(ctrl, "img_1.png")}])
    with flux_cut_depth():
        out["flux"], result, proc = _ip_job(card, name, raw, _counts(2 * fam, 2 * fam - 1, 2 * fam - 1), fam, 16,
                                            denoise=_counts(fwd=2 * fam))
    check(len(result["samples"]) == 1 and os.path.isfile(result["samples"][0]["path"]),
          f"{name}: samples {result['samples']}")
    out["flux"]["sample_s"] = result["samples"][0]["seconds"]
    del proc
    gc.collect()

    phase(f"SD 1.5 t2i job: the LDM file, 512^2, a control image an item, {ADAPTER_STEPS} steps, its save")
    name = "smoke_sd15_t2i"
    result, proc, report = _run_job(_adapter_raw(name, sd15, data, ADAPTER_STEPS, {"type": "t2i"},
                                                 train={"optimizer": "adamw"}, control_path=ctrl), _counts(), None)
    t2i_path = result["save_path"]
    keys, meta = _expansion_file(t2i_path)
    check(meta.get("adapter_type") == "t2i" and keys.get("t2i.conv_in.weight") == (3, 3, 192, 320)
          and keys.get("t2i.down_3.weight") == (3, 3, 1280, 1280) and len(keys) == 4 + 4 * 4 * 2 + 3 * 2,
          f"{name}: the t2i file's keys {sorted(keys)[:4]}")
    out["t2i"] = {"step_ms": result["step_ms"], "peak_gib": report["peak_gib"], "wall_s": report["wall_s"],
                  "trainable_params": result["trainable_params"], "keys": len(keys)}
    print(f"{card}: {name}: {result['trainable_params']:,} trainable params; step ms "
          f"{', '.join(f'{x:.1f}' for x in result['step_ms'])}; peak {report['peak_gib']:.2f} GiB; {len(keys)} keys "
          f"in {t2i_path} (conv kernels HWIO); job wall {report['wall_s']:.1f} s")
    del proc
    gc.collect()

    phase(f"SD 1.5 LoRA job with adapter_assist_name_or_path = that t2i file: 512^2, rank 16, {ADAPTER_STEPS} steps")
    name = "smoke_sd15_assist"
    result, proc, report = _run_job(_adapter_raw(name, sd15, data, ADAPTER_STEPS, size=512, control_path=ctrl,
                                                 network={"type": "lora", "linear": 16, "linear_alpha": 16},
                                                 train={"adapter_assist_name_or_path": t2i_path, "optimizer": "adamw"}),
                                    _counts(), None)
    check_lora_job(result, proc)
    want = t2i_state_from_flat(load_custom_adapter(t2i_path)[0])
    got = proc.assistant.state_dict()
    check(sorted(got) == sorted(want) and all(_checksum(got[k].float().cpu()) == _checksum(want[k]) for k in want),
          f"{name}: the assistant is not the t2i file, or it changed")
    out["assist"] = {"step_ms": result["step_ms"], "peak_gib": report["peak_gib"], "wall_s": report["wall_s"],
                     "lora_modules": len(proc.lora)}
    print(f"{card}: {name}: {len(proc.lora)} LoRA modules trained beside the frozen assistant ({len(want)} tensors, "
          f"checksums unchanged); step ms {', '.join(f'{x:.1f}' for x in result['step_ms'])}; peak "
          f"{report['peak_gib']:.2f} GiB; job wall {report['wall_s']:.1f} s")
    del proc
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_start
    print(f"{card}: the adapter input phases {out['wall_s']:.1f} s")
    return out


# ---- the audio archs: ACE-Step's 1-D WanDiT and LTX-2's joint audio-video DiT ----

ACE_BLOCKS = 24  # the 1-D WanDiT: one self- and one cross-attention each
ACE_CLIPS = 4
LTX2_BLOCKS = 48  # six attentions each: video self, audio self, a2v, v2a, video and audio text
LTX2_CLIPS = 4  # 49 frames at 512^2 and 24 fps; all but the last with a 48 kHz sidecar .wav
LTX2_FRAMES = 49
# the LTX-2 file's steps: the first two warm the step, the third is timed (cut from 5 to make room for the
# input-expansion adapters' phases within the script's time limit; SHIPPED_STEPS is at its floor)
LTX2_STEPS = 3
# (B, S, T, H, D): ACE's 10 s clip is 1,722 latent tokens against itself and 256 T5 tokens; LTX-2's
# 49 frames at 512^2 are 7 x 16 x 16 = 1,792 video tokens, its 2.04 s of 48 kHz audio 151 tokens
AUDIO_SHAPES = [((1, 1722, 1722, 12, 128), "ACE self"), ((1, 1722, 256, 12, 128), "ACE to text"),
                ((1, 1792, 1792, 32, 128), "LTX-2 video self"), ((1, 1792, 256, 32, 128), "LTX-2 video to text"),
                ((1, 151, 151, 32, 64), "LTX-2 audio self"), ((1, 151, 256, 32, 64), "LTX-2 audio to text"),
                ((1, 1792, 151, 32, 64), "LTX-2 a2v"), ((1, 151, 1792, 32, 64), "LTX-2 v2a")]
# the ragged tails these shapes give the kernels, with every logit near -shift^2 sqrt(D) (the lse
# below -88: the zero fill is no mask): (shape, label, shift)
AUDIO_NEGATIVE = [((1, 1792, 151, 32, 64), "a2v: 1,792 queries over a 151-key tail, negative logits", 4.0),
                  ((1, 151, 1792, 32, 64), "v2a: a 151-row Q tail (dk/dv), negative logits", 4.0),
                  ((1, 1722, 256, 12, 128), "ACE to text: a 58-row Q tail, negative logits", 3.2)]


def _wav_folder(n: int = ACE_CLIPS) -> str:
    """``n`` seeded 10 s clips written with scipy and captioned: 16-bit stereo
    at 44.1 kHz, one at 48 kHz and one mono (both resampled or widened by the
    loader)."""
    import numpy as np
    from scipy.io import wavfile

    folder = os.path.join(OUT_DIR, "ace_wavs")
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(0)
    styles = ["upbeat electronic dance track", "slow piano ballad", "jazz trio with brushed drums", "ambient pads"]
    for i in range(n):
        rate = 48000 if i == 1 else 44100
        t = np.arange(int(10.0 * rate)) / rate
        tone = np.sin(2 * np.pi * (110 * (i + 1)) * t)[:, None] * np.array([[0.5, 0.3]]) + rng.normal(0, 0.05, (len(t), 2))
        pcm = (np.clip(tone, -1, 1) * 32767).astype(np.int16)
        wavfile.write(os.path.join(folder, f"clip_{i}.wav"), rate, pcm[:, 0] if i == 2 else pcm)
        with open(os.path.join(folder, f"clip_{i}.txt"), "w") as f:
            f.write(styles[i % len(styles)])
    return folder


def _av_clips(n: int = LTX2_CLIPS, size: int = 512) -> str:
    """``n`` seeded 49-frame clips at ``size``^2 and 24 fps (OpenCV MJPG), all
    but the last with a 48 kHz stereo sidecar .wav of 2.1 s."""
    import cv2
    import numpy as np
    from scipy.io import wavfile

    folder = os.path.join(OUT_DIR, f"ltx2_clips_{size}")
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    subjects = ["a dog barking in a yard", "rain on a window", "a guitar being played", "a crowd cheering"]
    for i in range(n):
        f, ph = rng.uniform(1, 6, 3), rng.uniform(0, 6.3, 3)
        wr = cv2.VideoWriter(os.path.join(folder, f"clip_{i}.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 24, (size, size))
        check(wr.isOpened(), "cv2.VideoWriter cannot write MJPG")
        for j in range(LTX2_FRAMES):
            img = np.stack([np.sin(f[c] * 6.3 * (xx + yy * (c + 1) / 3 + 0.02 * j) + ph[c]) for c in range(3)], -1)
            wr.write(np.clip(127.5 * (img + 1) + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8))
        wr.release()
        if i < n - 1:
            t = np.arange(int(2.1 * 48000)) / 48000
            wav = 0.4 * np.sin(2 * np.pi * 220 * (i + 1) * t)[:, None] + rng.normal(0, 0.05, (len(t), 2))
            wavfile.write(os.path.join(folder, f"clip_{i}.wav"), 48000, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
        with open(os.path.join(folder, f"clip_{i}.txt"), "w") as fh:
            fh.write(f"a video of {subjects[i % len(subjects)]}")
    return folder


def av_reference(grid: tuple[int, int, int] = (2, 4, 6), audio_tokens: int = 11, text_tokens: int = 64) -> None:
    """LTX-2's joint audio-video DiT at full width (4096 / 2048, 32 heads of
    128 and of 64, the 2048-wide AV attention) cut to one block, in f32, on
    the card against the same module on the CPU (the flash kernels' plain
    versions there) over a 2 x 4 x 6 video grid (48 tokens), 11 audio
    tokens and 64 caption tokens: both streams' forward, and one LoRA
    training step's loss and a / b gradients (the video and audio losses
    summed) with the block checkpointed, as in training."""
    phase("full-width LTX-2 joint audio-video DiT (one block, f32, 48 video + 11 audio tokens): card vs CPU")
    from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora
    from ai_toolkit_tpu_torch.models.ltx2_av import LTX2AVConfig, LTX2AVDiT
    from ai_toolkit_tpu_torch.models.ltx2_model import ltx2_dit_config
    from ai_toolkit_tpu_torch.models.wan_dit import wan_lora_targets, wan_patchify, wan_position_ids
    from ai_toolkit_tpu_torch.ops.layers import init_parameters
    from ai_toolkit_tpu_torch.ops.rope import multi_axis_rope

    video = dataclasses.replace(ltx2_dit_config(), num_layers=1, dtype=torch.float32, remat=False)
    cfg = LTX2AVConfig(video=video)
    gpu = init_parameters(LTX2AVDiT(cfg, device="cuda"), torch.Generator("cuda").manual_seed(0))
    gpu.eval().requires_grad_(False)
    cpu = LTX2AVDiT(cfg, device="cpu").eval().requires_grad_(False)
    cpu.load_state_dict(gpu.state_dict())
    g = torch.Generator().manual_seed(1)
    tt, hh, ww = grid
    lat = torch.randn((1, tt, hh, ww, video.in_channels), generator=g)
    inputs = [wan_patchify(lat, video.patch_size), torch.randn((1, audio_tokens, cfg.audio_in_channels), generator=g),
              torch.randn((1, text_tokens, video.text_dim), generator=g), torch.tensor([0.7]),
              multi_axis_rope(torch.from_numpy(wan_position_ids(tt, hh, ww)), list(video.axes_dim)),
              multi_axis_rope(torch.arange(audio_tokens)[None, :, None], [cfg.audio_head_dim])]
    gpu_in = [x.cuda() for x in inputs]
    _reset_launches()
    with torch.inference_mode():
        ref = cpu(*inputs)
        out = [o.cpu() for o in gpu(*gpu_in)]
    launches = _launches()
    for what, o, r in zip(("video", "audio"), out, ref):
        err, scale = (o - r).abs().max().item(), r.abs().max().item()
        tol = 1e-3 * max(1.0, scale)  # f32 both sides, TF32 off; summation order only
        print(f"forward {what}: out {tuple(o.shape)} max|ref|={scale:.3f} max_abs_err={err:.3e} (tol {tol:.3e})")
        check(bool(torch.isfinite(o).all()) and err <= tol, f"the LTX-2 AV block's {what} stream disagrees")
    print(f"forward kernel launches={launches}")
    check(launches == _counts(fwd=6), f"the AV block launched {launches}, not 6 flash forwards")

    spec = LoRASpec(rank=16, alpha=16.0, target_patterns=wan_lora_targets())
    lg = build_lora(gpu, spec, torch.Generator("cuda").manual_seed(2))
    gb = torch.Generator("cuda").manual_seed(3)
    with torch.no_grad():
        for m in lg.values():
            m.b.normal_(0.0, 0.01, generator=gb)
    lc = build_lora(cpu, spec, torch.Generator().manual_seed(2))
    cpu.load_state_dict(gpu.state_dict())
    gpu.gradient_checkpointing = cpu.gradient_checkpointing = True
    targets = [torch.randn(o.shape, generator=g) for o in out]
    names = [(n, leaf) for n in lg for leaf in ("a", "b")]

    def loss_and_grads(model, lora, args, tgts):
        pv, pa = model(*args)
        loss = (pv.float() - tgts[0]).square().mean() + (pa.float() - tgts[1]).square().mean()
        return loss.item(), torch.autograd.grad(loss, [getattr(lora[n], leaf) for n, leaf in names])

    _reset_launches()
    ref_loss, ref_grads = loss_and_grads(cpu, lc, inputs, targets)
    loss, grads = loss_and_grads(gpu, lg, gpu_in, [t.cuda() for t in targets])
    launches = _launches()
    worst = max(((gd.cpu() - gr).abs().max() / gr.abs().max().clamp_min(1e-30)).item()
                for gd, gr in zip(grads, ref_grads))
    print(f"LoRA train step ({len(lg)} modules, checkpointed block): loss card {loss:.6f} vs CPU {ref_loss:.6f}; "
          f"{len(grads)} a / b tensors, worst max|dgrad|/max|grad| {worst:.3e} (tol 1e-3); kernel launches={launches}")
    check(len(lg) == 28 and abs(loss - ref_loss) <= 1e-4 * abs(ref_loss) and worst <= 1e-3
          and launches == _counts(12, 6, 6), "the LTX-2 AV LoRA train step on the card disagrees")
    del gpu, cpu, lg, lc, grads, ref_grads
    gc.collect()
    torch.cuda.empty_cache()


def ace_phase(card: str, profile_dir: str | None) -> dict:
    """configs/examples/train_lora_ace_step_audio.yaml as written but for its
    paths and steps, on seeded weights: the 1-D WanDiT (1536 x 24, 12 heads
    of 128) over 1,722 latent tokens of each 10 s clip, T5-XXL at 256
    tokens, rank 16, adamw, bf16, the disk latent cache of [1722, 64]
    latents; 96 flash forwards, 48 dq and 48 dk/dv a step."""
    phase("ace_step_15 LoRA sd_trainer job, configs/examples/train_lora_ace_step_audio.yaml as written with seeded "
          f"weights: {ACE_CLIPS} seeded 10 s wavs (44.1 kHz stereo, one at 48 kHz, one mono), the disk latent "
          "cache, 1,722 latent tokens, rank 16, adamw, bf16, per-block checkpointing")
    from safetensors.numpy import load_file

    raw = _shipped_job("train_lora_ace_step_audio.yaml", "smoke_ace_step_shipped", _train_steps(profile_dir), "",
                       folder=_wav_folder())
    raw["config"]["process"][0]["logging"] = {"log_every": 1}
    step = _counts(4 * ACE_BLOCKS, 2 * ACE_BLOCKS, 2 * ACE_BLOCKS)  # self and text attention, forward twice
    result, proc, report = _run_job(raw, step, profile_dir)
    cache = result["latent_cache"]
    files = sorted(os.listdir(cache["dir"]))
    check(cache["items"] == len(files) == cache["encoded"] == ACE_CLIPS, f"latent cache {cache}")
    lat = load_file(os.path.join(cache["dir"], files[0]))["latent"]
    check(lat.shape == (1722, 64), f"a cached ACE latent is {lat.shape}, not [1722, 64]")
    check(set(map(tuple, result["buckets"])) == {(0, 0)}, f"audio buckets {set(map(tuple, result['buckets']))}")
    lora_path = check_lora_job(result, proc)
    print(f"{card}: ace_step_15 job: median step {report['median_step_ms']:.1f} ms, peak {report['peak_gib']:.2f} "
          f"GiB, job wall {report['wall_s']:.1f} s, 1,722 latent tokens a step, launches per step {step}")
    del proc
    return {**report, "lora_path": lora_path, "tokens": 1722}


def ltx2_phase(card: str, profile_dir: str | None) -> dict:
    """configs/examples/train_lora_ltx2_av_tpu.yaml as written but for its
    paths and steps (LTX2_STEPS), on seeded weights, at full width and depth: the joint
    DiT (48 blocks) on a qfloat8 base, the Gemma tower in bf16, the mel audio
    chain, rank 16, adamw8bit, EMA 0.99, per-block checkpointing, 49 frames
    at 512^2 (1,792 video tokens) with 48 kHz sidecar audio (151 tokens; one
    clip without a sidecar trains on silence), the disk latent cache, the
    first and final samples (20 steps, 49 frames, an animated webp and a wav
    each); 576 flash forwards, 288 dq and 288 dk/dv a step, 288 forwards a
    denoise step."""
    phase("ltx2 joint audio-video LoRA sd_trainer job, configs/examples/train_lora_ltx2_av_tpu.yaml as written with "
          f"seeded weights: {LTX2_CLIPS} seeded {LTX2_FRAMES}-frame 512^2 clips at 24 fps with 48 kHz sidecars (one "
          "without), qfloat8 DiT (48 blocks), bf16 Gemma tower, mel audio VAE and vocoder, adamw8bit, EMA, the disk "
          "latent cache, its prompt at 20 steps and 49 frames first and final")
    import numpy as np
    from PIL import Image
    from scipy.io import wavfile

    raw = _shipped_job("train_lora_ltx2_av_tpu.yaml", "smoke_ltx2_shipped", LTX2_STEPS + (1 if profile_dir else 0),
                       "", folder=_av_clips())
    raw["config"]["process"][0]["logging"] = {"log_every": 1}
    step = _counts(12 * LTX2_BLOCKS, 6 * LTX2_BLOCKS, 6 * LTX2_BLOCKS)  # six attentions, forward twice
    result, proc, report = _run_job(raw, step, profile_dir, _counts(fwd=6 * LTX2_BLOCKS))
    p = proc.cfg
    check(p.model.quantize and p.train.optimizer == "adamw8bit" and p.datasets[0].do_audio
          and p.model.model_kwargs.get("audio_vae") == "mel", "the LTX-2 file lost its settings")
    model, variables = proc.model, proc.variables
    with torch.inference_mode():
        n_audio = model.encode_audio(variables, torch.zeros(1, int(LTX2_FRAMES / 24 * 48000), 2)).shape[1]
    check(n_audio == 151, f"{n_audio} audio tokens for 49 frames at 24 fps, not 151")
    cache = result["latent_cache"]
    check(cache["items"] == len(os.listdir(cache["dir"])) == cache["encoded"] == LTX2_CLIPS, f"latent cache {cache}")
    got = [(r["step"], r["index"]) for r in result["samples"]]
    check(got == [(0, 0), (result["steps"], 0)], f"samples at {got}")
    n_gen = round(LTX2_FRAMES / 24 * 48000 / model.audio_vae_config.downscale)
    want_len = (4 * n_gen - 3) * model.vocoder_config.total_upsample  # two causal mel upsamples, then the vocoder
    for r in result["samples"]:
        with Image.open(r["path"]) as im:
            n_frames = getattr(im, "n_frames", 1)
            px = np.asarray(im.convert("RGB"))
        sr, wav = wavfile.read(r["wav"])
        check(n_frames == LTX2_FRAMES and px.shape == (512, 512, 3) and px.std() > 0,
              f"sample {r['path']}: {n_frames} frames of {px.shape}")
        check(sr == 48000 and wav.shape == (want_len, 2) and wav.std() > 0,
              f"sample {r['wav']}: {sr} Hz, {wav.shape} (want {want_len} x 2)")
        print(f"sample {r['path']} ({n_frames} frames) and {r['wav']} ({wav.shape[0]} samples at {sr} Hz): "
              f"{r['seconds']:.2f} s")
    lora_path = check_lora_job(result, proc)
    by_bucket = {"512x512": report["median_step_ms"]}  # one bucket: the warm median
    print(f"{card}: ltx2 joint AV job: step ms by bucket {by_bucket}, peak {report['peak_gib']:.2f} GiB, job wall "
          f"{report['wall_s']:.1f} s, samples {', '.join('%.2f' % r['seconds'] for r in result['samples'])} s, "
          f"1,792 video + {n_audio} audio tokens a step, launches per step {step}")
    del proc, model, variables
    return {**report, "lora_path": lora_path, "by_bucket_ms": by_bucket, "audio_tokens": n_audio,
            "sample_s": [r["seconds"] for r in result["samples"]]}


def audio_phases(card: str, profile_dir: str | None) -> dict:
    """The audio archs' phases: the flash kernels against their plain versions
    and timed at ACE-Step's and LTX-2's shapes, the 1-D WanDiT and the AV
    block card vs CPU, then the two shipped files. Returns the errors, the
    times and each job's numbers."""
    from ai_toolkit_tpu_torch.models.audio_model import ace_dit_config

    t0 = time.perf_counter()
    neg = torch.Generator("cuda").manual_seed(11)
    err = flash_checks("flash kernels vs plain versions at ACE-Step's and LTX-2's shapes (head dims 128 and 64), bf16",
                       [(shape, label, True, None) for shape, label in AUDIO_SHAPES]
                       + [(shape, label, True, _negative_qkv(shape, shift, neg))
                          for shape, label, shift in AUDIO_NEGATIVE],
                       12)
    times = attention_times("flash kernels at ACE-Step's and LTX-2's shapes, bf16", "audio",
                            [(shape, label, True) for shape, label in AUDIO_SHAPES], 13)
    wan_reference("ACE-Step 1.5 1-D WanDiT (1536 x 24, rope over time only)", ace_dit_config("ace_step_15", "full", 64),
                  _counts(fwd=2), _counts(4, 2, 2), grid=(105, 1, 1), text_tokens=256)
    av_reference()
    checks_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    ace = ace_phase(card, profile_dir)
    ace_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    ltx2 = ltx2_phase(card, profile_dir)
    ltx2_s = time.perf_counter() - t1
    print(f"{card}: audio phases: kernel checks and card-vs-CPU blocks {checks_s:.1f} s, ACE job {ace_s:.1f} s, "
          f"LTX-2 job {ltx2_s:.1f} s")
    return {"err": err, "times": times, "ace": ace, "ltx2": ltx2,
            "wall_s": {"checks": checks_s, "ace": ace_s, "ltx2": ltx2_s}}


def main(argv: list[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", default=None, help="write a torch.profiler split of one step of each "
                                                        "train job here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = environment()
    fwd = kernel_vs_plain()
    bwd = bwd_kernels_vs_plain()

    moe = moe_kernels_vs_plain()
    from ai_toolkit_tpu_torch.models.flux_dit import FluxConfig, flux_lora_targets
    from ai_toolkit_tpu_torch.models.hidream_model import hidream_dit_config, hidream_lora_targets

    dit_reference("flux-dev", FluxConfig.dev(), flux_lora_targets(), _counts(fwd=2), _counts(2, 2, 2))
    # grouped MoE in f32: the kernels' CUDA-core path inside the model; with
    # checkpointing the MoE forward runs twice per block
    # the full fine-tune step: the double block's attention and MoE input need no
    # gradient, so only the single block runs dq, dk/dv and MoE dx; dw runs once
    dit_reference("hidream (grouped MoE)", hidream_dit_config("grouped"), hidream_lora_targets(),
                  _counts(fwd=2, moe=2), _counts(2, 2, 2, moe=4, moe_dx=2),
                  _counts(2, 1, 1, moe=4, moe_dx=1, moe_dw=1))

    phase("flux-dev LoRA sd_trainer job, 1024x1024, batch 1, rank 16, adamw8bit, EMA, validate_every 2")
    flux_step = _counts(BLOCKS_PER_FORWARD, BLOCKS_PER_FORWARD, BLOCKS_PER_FORWARD)
    # a validation is one forward without gradients: one flash forward per block
    train = train_job("smoke_flux_lora", {**FLUX_MODEL, "quantize": False}, flux_step, args.profile,
                      validate=_counts(fwd=BLOCKS_PER_FORWARD))

    phase("flux-dev generate job, 1024x1024, 8 steps, 2 prompts, with the trained LoRA")
    prompts = ["p3r5on photo of a red fox", "macro photo of a dew drop on a leaf"]
    generate_job(FLUX_MODEL, 1024, 1024, 8, prompts, _counts(fwd=BLOCKS_PER_FORWARD),
                 lora_path=train["lora_path"])

    phase("ragged resolution: flux-dev 1008x1008 (4481 tokens), 2 steps, 1 prompt")
    generate_job(FLUX_MODEL, 1008, 1008, 2, prompts[:1], _counts(fwd=BLOCKS_PER_FORWARD))

    flux_shipped = flux_shipped_phase(card, args.profile)
    flux_family = flux_family_phases(card, args.profile)
    mmdit = mmdit_phases(card, args.profile)
    nextdit = nextdit_phases(card, args.profile)

    phase("hidream LoRA sd_trainer job, 1024x1024, fp8 base, grouped MoE, batch 1, rank 16, adamw8bit, EMA")
    # per step: the attention forward once per block (its outputs are kept by the
    # checkpoint policy), the grouped MoE forward twice (forward and recompute), one dq,
    # dk/dv and MoE dx per block
    hidream_step = _counts(HIDREAM_BLOCKS, HIDREAM_BLOCKS, HIDREAM_BLOCKS, 2 * HIDREAM_BLOCKS,
                           HIDREAM_BLOCKS)
    hidream = train_job("smoke_hidream_lora", {**HIDREAM_MODEL, "quantize": True, "qtype": "qfloat8"},
                        hidream_step, args.profile)

    phase("hidream generate job, 1024x1024, 8 steps, 2 prompts, bf16 base, with the trained LoRA")
    generate_job(HIDREAM_MODEL, 1024, 1024, 8, prompts, _counts(fwd=HIDREAM_BLOCKS, moe=HIDREAM_BLOCKS),
                 lora_path=hidream["lora_path"])

    phase("hidream full fine-tune sd_trainer job, 1024x1024, bf16 base, grouped MoE, the expert banks of "
          "double_blocks.0 and single_blocks.0, adamw8bit, EMA")
    # per step: nothing upstream of double_blocks.0's MoE needs a gradient, so that
    # block's attention and MoE run no backward kernel: dq, dk/dv and MoE dx in the
    # other 47 blocks; the two trained MoE layers each launch dw once
    ft_step = _counts(HIDREAM_BLOCKS, HIDREAM_BLOCKS - 1, HIDREAM_BLOCKS - 1, 2 * HIDREAM_BLOCKS,
                      HIDREAM_BLOCKS - 1, moe_dw=2)
    fullft = fullft_job("smoke_hidream_fullft", {**HIDREAM_MODEL, "quantize": False,
                                                 "only_if_contains": FT_BANKS}, ft_step, args.profile)

    sdxl_times = attention_times("flash kernels at the SDXL UNet's shapes (head_dim 64), bf16", "SDXL",
                                 [(shape, label, True) for shape, label in SDXL_SHAPES], 4)
    # the cut UNet: transformer blocks down 1 + 1, mid 1, up 2 + 2; two attentions each
    unet_reference(_counts(fwd=2 * SDXL_CUT_BLOCKS), _counts(4 * SDXL_CUT_BLOCKS, 2 * SDXL_CUT_BLOCKS,
                                                             2 * SDXL_CUT_BLOCKS))

    sdxl = sdxl_shipped_phases(card, args.profile)

    phase("SDXL generate job, 1024x1024, DDIM 8 steps, guidance 7 (CFG batch of two), 2 prompts, "
          "with the trained kohya LoRA")
    sdxl_gen = generate_job(SDXL_MODEL, 1024, 1024, 8, prompts, _counts(fwd=SDXL_ATTENTIONS),
                            lora_path=sdxl["lora_path"], sampler="ddim", guidance_scale=7.0)
    print(json.dumps({"sdxl_launches": {
        "train_per_step": sdxl["per_step"],
        "denoise_per_step": {k: v / (8 * len(prompts)) for k, v in sdxl_gen.items()},
        "ms": {label: {k: row[k]["ms"] for k in row} for label, row in sdxl_times.items()}}}))
    sd15 = sd15_ti_phase(card, args.profile)
    sliders = slider_phases(card, sd15["checkpoint"])
    print(json.dumps({"sliders": sliders}))
    refusal_files = refusal_files_phases(card)
    print(json.dumps({"dfe_ara_redux_vision_direct": refusal_files}))
    knobs = train_knobs_phases(card, sd15["checkpoint"])
    print(json.dumps({"train_knobs": knobs}))
    networks = network_phases(card, sd15["checkpoint"])
    print(json.dumps({"networks": networks}))
    expansions = expansion_phases(card)
    print(json.dumps({"expansion_adapters": expansions}))
    adapter_inputs = adapter_input_phases(card, sd15["checkpoint"])
    print(json.dumps({"adapter_inputs": adapter_inputs}))
    print(json.dumps({"shipped_files": {
        "sd15_textual_inversion": sd15,
        "flux_lora_val_losses": train["val_losses"],
        "sdxl": {"checkpoint_write_s": sdxl["write_s"], "checkpoint_load_s": sdxl["load_s"],
                 "median_step_ms": sdxl["median_step_ms"], "peak_gib": sdxl["peak_gib"],
                 "resumed_wall_s": sdxl["resumed"]["wall_s"]},
        "flux_qfloat8": {"median_step_ms_by_bucket": flux_shipped["by_bucket_ms"], "peak_gib": flux_shipped["peak_gib"],
                      "wall_s": flux_shipped["wall_s"]},
        "flux_family_qfloat8": flux_family,
        "mmdit_qfloat8": mmdit, "nextdit": nextdit}}))

    neg = torch.Generator("cuda").manual_seed(8)
    wan_err = flash_checks("flash kernels vs plain versions at Wan 2.1's shapes (head_dim 128), bf16",
                           [(shape, label, full, None) for shape, label, full in WAN_SHAPES]
                           + [((1, 8100, 512, 12, 128), "train cross, negative logits", True,
                               _negative_qkv((1, 8100, 512, 12, 128), 3.2, neg))], 5)
    wan_times = attention_times("flash kernels at Wan 2.1's shapes (head_dim 128), bf16", "Wan", WAN_SHAPES, 6)
    # one block: its self- and cross-attention; the checkpointed step runs both forwards again
    from ai_toolkit_tpu_torch.models.wan_dit import WanConfig

    wan_reference("Wan 2.1 1.3B", WanConfig.wan21_1_3b(), _counts(fwd=2), _counts(4, 2, 2))

    phase("main path of this slice: Wan 2.1 1.3B LoRA sd_trainer job, 33 frames at 480x480 (8,100 tokens), "
          "batch 1, rank 32, adamw, flowmatch shift, bf16, per-block checkpointing")
    # per step: both attentions of every block run their forward twice (the
    # block is recomputed in the backward, as WanConfig.remat does), dq and dk/dv once
    wan_step = _counts(4 * WAN_BLOCKS, 2 * WAN_BLOCKS, 2 * WAN_BLOCKS)
    wan = train_job("smoke_wan21_lora", {}, wan_step, args.profile, raw=_wan_job("smoke_wan21_lora", args.profile))

    width, height, frames, steps = WAN_GEN
    phase(f"Wan 2.1 1.3B generate job, {height}x{width}, {frames} frames (32,760 tokens), {steps} Euler steps, "
          f"1 prompt, with the trained LoRA, every frame decoded at once")
    wan_gen = generate_job({"name_or_path": "", "arch": "wan21", "model_kwargs": {"size": "1.3b"}}, width, height,
                           steps, ["a video of a red fox running through tall grass"],
                           _counts(fwd=2 * WAN_BLOCKS), lora_path=wan["lora_path"], num_frames=frames)
    print(json.dumps({"wan_launches": {
        "train_per_step": {k: v / wan["steps"] for k, v in wan["launches"].items()},
        "denoise_per_step": {k: v / steps for k, v in wan_gen.items()},
        "ms": {label: {k: row[k]["ms"] for k in row} for label, row in wan_times.items()}}}))

    wan22_err, wan22_times, wan14 = wan22_phases(args.profile)
    audio = audio_phases(card, args.profile)
    print(json.dumps({"audio": {
        "ace_step_15": {"median_step_ms": audio["ace"]["median_step_ms"], "peak_gib": audio["ace"]["peak_gib"],
                        "wall_s": audio["ace"]["wall_s"], "tokens": audio["ace"]["tokens"],
                        "train_per_step": audio["ace"]["per_step"]},
        "ltx2_av": {"median_step_ms_by_bucket": audio["ltx2"]["by_bucket_ms"], "peak_gib": audio["ltx2"]["peak_gib"],
                    "wall_s": audio["ltx2"]["wall_s"], "sample_s": audio["ltx2"]["sample_s"],
                    "audio_tokens": audio["ltx2"]["audio_tokens"], "train_per_step": audio["ltx2"]["per_step"]},
        "phase_wall_s": audio["wall_s"], "flash_err": audio["err"],
        "ms": {label: {k: {m: row[k][m] for m in ("ms", "library_ms", "bound_ms")} for k in row}
               for label, row in audio["times"].items()}}}))

    print(f"files under {OUT_DIR}: {_footprint_gib():.2f} GiB (the machine's disk takes 45 GiB of writes in all, "
          f"overwritten and deleted files included)")
    banned = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ai_toolkit_tpu")]
    check(not banned, f"the port imported {banned[:5]}")
    print(card)
    src = "ai_toolkit_tpu_torch/csrc/"
    pallas = "ai_toolkit_tpu/ops/pallas/flash_attention.py"
    gmm = "ai_toolkit_tpu/ops/pallas/moe_gmm.py"
    # launches: each kernel's count over its main path's run (flash: the flux
    # train job; MoE forward and dx: the hidream LoRA job; dw: the full fine-tune)
    rows = [("flash_attention_fwd", src + "flash_attention_fwd.cu", f"{pallas}:31", train, "fwd", fwd),
            ("flash_attention_bwd_dq", src + "flash_attention_bwd.cu", f"{pallas}:152", train, "dq",
             bwd["dq"]),
            ("flash_attention_bwd_dkv", src + "flash_attention_bwd.cu", f"{pallas}:174", train, "dkv",
             bwd["dkv"]),
            ("moe_gmm_fwd", src + "moe_gmm_fwd.cu", f"{gmm}:99", hidream, "moe", moe["moe"]),
            ("moe_gmm_dx", src + "moe_gmm_bwd.cu", f"{gmm}:121", hidream, "moe_dx", moe["moe_dx"]),
            ("moe_gmm_dw", src + "moe_gmm_dw.cu", f"{gmm}:149", fullft, "moe_dw", moe["moe_dw"])]
    # the streamed, tail-masked Pallas variants: the same kernels on the ragged
    # tails of this slice's main path, the 14B i2v job (8,100 tokens, T = 257 and
    # 512; launches from its train job, times at its self-attention), errors over
    # every Wan case
    wan_self = wan22_times["14B train self"]
    rows += [(f"{name}_streamed", src + f, f"{pallas}:{line}", wan14, key,
              {**wan_self[key], "max_abs_err": max(wan_err[key], wan22_err[key])})
             for name, f, line, key in (("flash_attention_fwd", "flash_attention_fwd.cu", 293, "fwd"),
                                        ("flash_attention_bwd_dq", "flash_attention_bwd.cu", 357, "dq"),
                                        ("flash_attention_bwd_dkv", "flash_attention_bwd.cu", 383, "dkv"))]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": run["launches"][key], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"]} for name, source, replaces, run, key, r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
