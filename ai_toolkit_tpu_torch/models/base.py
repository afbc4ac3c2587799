"""Per-arch model contract (``ai_toolkit_tpu/models/base.py`` ``BaseTpuModel``).

A model object holds configs, tokenizers and the device; its weights live in
a ``variables`` dict of ``nn.Module``s that ``init_variables`` /
``load_variables`` build on that device, mirroring the JAX package's
variable trees. The device is always given by the caller.
"""

from __future__ import annotations

import torch
from torch import nn

from ai_toolkit_tpu_torch.adapters.quantize import quantize_params
from ai_toolkit_tpu_torch.config.modules import ModelConfig


class BaseModel:
    arch: str = "base"
    archs: list[str] = []
    is_flow_matching: bool = True
    bucket_divisibility: int = 16
    main_component: str = "dit"  # the variables entry that is trained and sampled
    quantize_exclude: list[str] | None = None  # module-name patterns a quantized base keeps (None: the default list)

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
        """The model's variables (:meth:`refuse_or_init`); with ``qtype`` the
        experts' weights are quantized (``adapters/quantize.py``, the
        model's ``quantize_exclude``), as the train job's ``model.quantize``
        asks."""
        variables = self.refuse_or_init(generator)
        if qtype is not None:
            for name in self.experts:
                quantize_params(variables[name], exclude_patterns=self.quantize_exclude, qtype=qtype)
        return variables

    def load_state_dicts(self, variables: dict[str, nn.Module], states: dict[str, dict]) -> None:
        """Load per-component state dicts (``io/from_jax.*_model_state``)."""
        for name, sd in states.items():
            variables[name].load_state_dict(sd, strict=True)

    def refuse_or_init(self, generator: torch.Generator) -> dict[str, nn.Module]:
        """Empty ``name_or_path`` = seeded random init; any other path raises
        until checkpoint loading is ported (never a silent random init)."""
        path = self.config.name_or_path
        if path:
            raise NotImplementedError(
                f"arch '{self.config.arch}': loading '{path}' is not ported yet — "
                f"checkpoint loading comes with a later slice. Set name_or_path: '' "
                f"for seeded random weights."
            )
        return self.init_variables(generator)

    # ---- functions over variables ----

    def predict(self, variables, noisy_latents, t, cond):
        raise NotImplementedError

    def encode_prompt(self, variables, prompts: list[str]) -> dict:
        raise NotImplementedError

    def decode_latents(self, variables, latents):
        raise NotImplementedError

    # ---- geometry ----

    def latent_shape(self, height: int, width: int) -> tuple[int, int, int]:
        raise NotImplementedError

    def image_seq_len(self, height: int, width: int) -> int:
        h, w, _ = self.latent_shape(height, width)
        return h * w
