"""Per-arch model contract (``ai_toolkit_tpu/models/base.py`` ``BaseTpuModel``).

A model object holds configs, tokenizers and the device; its weights live in
a ``variables`` dict of ``nn.Module``s that ``init_variables`` /
``load_variables`` build on that device, mirroring the JAX package's
variable trees. The device is always given by the caller.

``load_variables``: an empty ``name_or_path`` is the seeded init; a local
path goes through the arch's :meth:`BaseModel.load_checkpoint`, which
builds the seeded init and loads each component whose file or
subdirectory is there, strictly (``io/safetensors_dir.load_module``); a
component whose subdirectory is absent keeps its seeded init, as in the JAX
loaders, and one line says so. A path that is no importable local layout
raises (:meth:`BaseModel.refuse_bad_layout`), never a silent random init.
"""

from __future__ import annotations

import os
import time
from typing import Callable

import torch
from torch import nn

from ai_toolkit_tpu_torch.adapters.quantize import quantize_params
from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.io.safetensors_dir import STRIP_PREFIXES, SafetensorsIndex, load_module, safetensors_files


class BaseModel:
    arch: str = "base"
    archs: list[str] = []
    is_flow_matching: bool = True
    bucket_divisibility: int = 16
    main_component: str = "dit"  # the variables entry that is trained and sampled
    quantize_exclude: list[str] | None = None  # module-name patterns a quantized base keeps (None: the default list)
    jax_scans_blocks: bool = False  # the JAX package's config of this model scans its blocks (nn.scan)
    takes_control: bool = False  # the denoiser reads control latents (cond["control_latents"]) beside the noisy ones
    control_optional: bool = False  # a batch without control images trains without them (OmniGen2's references)

    def __init__(self, config: ModelConfig, device: torch.device | str):
        self.config = config
        self.device = torch.device(device)

    @property
    def experts(self) -> tuple[str, ...]:
        """The denoiser entries of ``variables``: the main component, or a
        multistage model's experts, which share one adapter network."""
        return (self.main_component,)

    # ---- construction ----

    def init_variables(self, generator: torch.Generator) -> dict[str, nn.Module]:
        """Seeded random init of every component, on ``self.device``."""
        raise NotImplementedError

    def load_variables(self, generator: torch.Generator, qtype: str | None = None) -> dict[str, nn.Module]:
        """The seeded init (empty ``name_or_path``) or the checkpoint at
        ``name_or_path`` (:meth:`load_checkpoint`); with ``qtype`` the
        experts' weights are then quantized (``adapters/quantize.py``, the
        model's ``quantize_exclude``), as the train job's ``model.quantize``
        asks."""
        path = self.config.name_or_path
        variables = self.load_checkpoint(path, generator) if path else self.init_variables(generator)
        if qtype is not None:
            self.quantize(variables, qtype)
        return variables

    def quantize(self, variables: dict[str, nn.Module], qtype: str) -> None:
        """Weight-only quantization of the experts' selected weights, in place."""
        for name in self.experts:
            quantize_params(variables[name], exclude_patterns=self.quantize_exclude, qtype=qtype)

    def load_state_dicts(self, variables: dict[str, nn.Module], states: dict[str, dict]) -> None:
        """Load per-component state dicts (``io/from_jax.*_model_state``)."""
        for name, sd in states.items():
            variables[name].load_state_dict(sd, strict=True)

    def load_checkpoint(self, path: str, generator: torch.Generator) -> dict[str, nn.Module]:
        """The variables from the local checkpoint at ``path``."""
        raise NotImplementedError(f"arch '{self.config.arch}' has no checkpoint loader")

    def refuse_bad_layout(self, expected: str):
        """Raise for a ``name_or_path`` that is no importable local layout (a
        repo id, a missing path, a directory of another shape): never a
        silent random init (JAX ``refuse_bad_layout``)."""
        raise FileNotFoundError(
            f"arch '{self.config.arch}': name_or_path '{self.config.name_or_path}' is not an importable "
            f"local layout (expected {expected}). Set name_or_path: '' for seeded random weights.")

    def load_component(self, variables: dict[str, nn.Module], name: str, src: str, what: str,
                       strip: tuple[str, ...] = STRIP_PREFIXES,
                       prepare: Callable[[nn.Module, SafetensorsIndex, str], None] | None = None,
                       **kwargs) -> bool:
        """Load ``variables[name]`` from the file or directory ``src`` (the
        key prefixes ``strip`` dropped; ``prepare(module, index, what)`` may
        fit the module to what the checkpoint holds first; ``load_module``'s
        ``kwargs``); when ``src`` is absent the component keeps its seeded
        init and one line says so. A directory with no ``.safetensors`` file
        raises."""
        if not os.path.exists(src):
            print(f"{what}: no {src}; '{name}' keeps its seeded init")
            return False
        if not safetensors_files(src):
            raise FileNotFoundError(f"{what}: {src} holds no .safetensors file")
        t0 = time.perf_counter()
        with SafetensorsIndex(src, strip) as index:
            if prepare is not None:
                prepare(variables[name], index, what)
            n = load_module(variables[name], index, what, **kwargs)
            unmatched = index.unmatched()
        print(f"loaded {what}: {n} tensors from {src} in {time.perf_counter() - t0:.2f} s"
              + (f"; {len(unmatched)} not read (e.g. {unmatched[:3]})" if unmatched else ""))
        return True

    # ---- functions over variables ----

    def predict(self, variables, noisy_latents, t, cond):
        raise NotImplementedError

    def encode_prompt(self, variables, prompts: list[str]) -> dict:
        raise NotImplementedError

    def decode_latents(self, variables, latents):
        raise NotImplementedError

    def jax_module_path(self, name: str, scanned: bool = False) -> str:
        """The JAX package's module path of the main component's module
        ``name``, dot-joined as the JAX job's LoKr, LoHa and LoRM files carry
        it (JAX saves them with no key map); ``scanned``: the path in the
        scanned layout, one entry per layer."""
        raise NotImplementedError(f"arch '{self.config.arch}': the JAX module paths that a LoKr, LoHa or LoRM "
                                  f"file carries come with ROADMAP Queue 1 item 6e (ported: the flux archs, "
                                  f"the UNets, Wan, ACE-Step, LTX-2, SD3, Lumina2 and OmniGen2)")

    # ---- geometry ----

    def latent_shape(self, height: int, width: int) -> tuple[int, int, int]:
        raise NotImplementedError

    def image_seq_len(self, height: int, width: int) -> int:
        h, w, _ = self.latent_shape(height, width)
        return h * w

