"""Flash-attention forward: the hand-written CUDA kernel and its plain version.

Replaces ``ai_toolkit_tpu/ops/pallas/flash_attention.py`` ``_fwd_kernel``
(``_flash_fwd``, the resident kernel) and ``_fwd_kernel_streamed`` (the
padded, KV-masked path of ``flash_attention_any``) with one kernel,
``csrc/flash_attention_fwd.cu``, that streams K/V tiles through shared memory
and masks ragged Q-row and KV-column tails itself.

What bounds it on the card: about 4*S*T*D*H FLOPs against 2*(S+2T)*H*D
bytes, so at the flux shape (S=T=4608, H=24, D=128) it is compute-bound. The
simple design runs both products on the tensor cores (WMMA bf16, f32
accumulation) and keeps the Q tile in registers; it does not yet overlap
loads with compute (see the source note).

``flash_attention_fwd(q, k, v, scale) -> (out, lse)`` takes q ``[B,S,H,D]``,
k/v ``[B,T,H,D]`` in bf16 or f32 with D in {64, 128}, through strides (only
the last must be 1). out is ``[B,S,H,D]`` in q's dtype, lse f32 ``[B,H,S]``.
CPU tensors go to :func:`flash_attention_fwd_plain`; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

# kernel launches by flash_attention_fwd in this process
launches = 0

HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def flash_attention_fwd_plain(q, k, v, scale: float | None = None):
    """f32 einsum / logsumexp / softmax / einsum: the kernel's plain version."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(logits, dim=-1), v.float())
    return out.to(q.dtype), lse


def _kernel():
    global _fn
    if _fn is None:
        from ai_toolkit_tpu_torch.ops.kernels.build import load

        lib = load("flash_attention_fwd")
        fn = lib.ait_flash_attention_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.ait_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ait_cuda_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.ait_cuda_error_string)
    return _fn


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash attention wants [B,S,H,D] tensors, got {q.shape} {k.shape} {v.shape}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v {tuple(v.shape)} do not match")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32 or bfloat16, got {q.dtype} {k.dtype} {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel has head_dim {HEAD_DIMS}, got {d}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash attention needs the last dim of q/k/v contiguous")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("flash attention needs S > 0 and T > 0")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel grid")


def _launch(q, k, v, scale: float):
    global launches
    fn, err_str = _kernel()
    b, s, h, d = q.shape
    t = k.shape[1]
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    es = q.element_size()
    vec = all(x.data_ptr() % 16 == 0 and all(st * es % 16 == 0 for st in x.stride()[:3])
              for x in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, s, t, h, d, _DTYPES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: {err_str(rc).decode()} ({rc})")
    launches += 1
    return out, lse


class _FlashFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        return _launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        raise NotImplementedError("backward kernels come with the training slice")


def flash_attention_fwd(q, k, v, scale: float | None = None):
    """(out [B,S,H,D], lse f32 [B,H,S]) of softmax(scale q k^T) v."""
    _check(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    devices = {q.device.type, k.device.type, v.device.type}
    if devices == {"cpu"}:
        return flash_attention_fwd_plain(q, k, v, scale)
    if devices == {"cuda"} and q.device == k.device == v.device:
        return _FlashFwd.apply(q, k, v, scale)
    raise ValueError(f"flash attention got tensors on {q.device}, {k.device}, {v.device}")
