"""ai_toolkit_tpu_torch — the PyTorch/CUDA port of ai_toolkit_tpu for NVIDIA Hopper.

The JAX package ``ai_toolkit_tpu`` stays the reference; every module here is
held against its counterpart there. This package imports ``torch`` and never
``jax`` nor any module of ``ai_toolkit_tpu``: the framework-free pieces it
needs (the job schema, the tokenizer) are its own copies in ``config/`` and
``utils/tokenizer.py``.

Entry point: ``python -m ai_toolkit_tpu_torch.run job.yaml [--device cuda]``.
"""

__version__ = "0.2.0"
