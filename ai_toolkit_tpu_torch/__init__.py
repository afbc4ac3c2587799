"""ai_toolkit_tpu_torch — the PyTorch/CUDA port of ai_toolkit_tpu for NVIDIA Hopper.

The JAX package ``ai_toolkit_tpu`` stays the reference; every module here is
held against its counterpart there. This package imports ``torch`` and never
``jax``. Its framework-free pieces (``ai_toolkit_tpu.config``,
``ai_toolkit_tpu.utils.tokenizer``) are imported as they are.

Entry point: ``python -m ai_toolkit_tpu_torch.run job.yaml [--device cuda]``.
"""

__version__ = "0.1.0"
