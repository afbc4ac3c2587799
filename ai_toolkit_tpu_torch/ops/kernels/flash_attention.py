"""Flash attention: the hand-written CUDA kernels, forward and backward, and
their plain versions.

The forward replaces ``ai_toolkit_tpu/ops/pallas/flash_attention.py``
``_fwd_kernel`` (``_flash_fwd``, the resident kernel) and
``_fwd_kernel_streamed`` (the padded, KV-masked path of
``flash_attention_any``) with one kernel, ``csrc/flash_attention_fwd.cu``. The
backward replaces ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` and their streamed,
masked forms with two kernels, ``csrc/flash_attention_bwd.cu``: dq (one block
per 128-row Q tile) and dk/dv (one block per 128-row K/V tile). All of them
stream the other operand through shared memory and mask ragged tails
themselves.

What bounds them on the card: the forward does about 4*S*T*D*H FLOPs, the
backward 10*S*T*D*H (five products), against O((S+T)*H*D) bytes, so at the
flux shape (S=T=4608, H=24, D=128) both are compute-bound. In bf16 all
three kernels run wgmma on shared-memory tiles that TMA loads through a ring
of mbarrier-guarded stages, with the elementwise steps in registers (the
softmax and P; dk/dv: P^T and dS^T; dq: dS) and the output accumulators in
registers (``csrc/hopper.cuh``); the f32 paths keep the first CUDA-core
design for the exact checks (see the source notes).

``flash_attention_fwd(q, k, v, scale) -> (out, lse)`` takes q ``[B,S,H,D]``,
k/v ``[B,T,H,D]`` in bf16 or f32 with D in {64, 128}, through strides (only
the last must be 1). out is ``[B,S,H,D]`` in q's dtype, lse f32 ``[B,H,S]``.
It is the custom op ``ait::flash_attention_fwd``, so a selective-checkpoint
policy can keep its outputs (``models/flux_dit.py``); its autograd formula is
:func:`flash_attention_bwd`. lse is not differentiable. CPU tensors go to the
plain versions; CUDA tensors launch the kernels or raise.

TMA reads a bf16 tensor through a tensor map built from its strides
(:func:`_tma_plan`); a tensor TMA cannot address (a base not 16-byte aligned,
a batch, sequence or head stride that is not a multiple of 16 bytes) is
copied to a contiguous one first, and ``tma_copies`` counts those copies. The
kernel runs either way.
"""

from __future__ import annotations

import ctypes
import math

import torch

# kernel launches in this process, one count per kernel
launches = 0  # flash_attention_fwd
dq_launches = 0  # flash_attention_bwd_dq
dkv_launches = 0  # flash_attention_bwd_dkv
tma_copies = 0  # bf16 inputs copied because TMA could not address them as they were

HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fwd_fn = None
_bwd_fns = None


def flash_attention_fwd_plain(q, k, v, scale: float | None = None):
    """f32 einsum / logsumexp / softmax / einsum: the forward kernel's plain version."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(logits, dim=-1), v.float())
    return out.to(q.dtype), lse


def _bwd_probs(q, k, g, v, lse, delta, scale):
    """(p, ds) in f32 ``[B,H,S,T]``: p = exp(scale q k^T - lse), ds = p (dO v^T - delta)."""
    p = torch.exp(torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale - lse[..., None])
    ds = p * (torch.einsum("bshd,bthd->bhst", g.float(), v.float()) - delta[..., None])
    return p, ds


def flash_attention_bwd_delta(out, g):
    """delta = rowsum(dO o) in f32 ``[B,H,S]`` (the JAX wrapper's ``delta``)."""
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, scale: float):
    """dq = scale ds k in f32, cast to q's dtype: the dq kernel's plain version."""
    _, ds = _bwd_probs(q, k, g, v, lse, delta, scale)
    return (torch.einsum("bhst,bthd->bshd", ds, k.float()) * scale).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta, scale: float):
    """(dk = scale ds^T q, dv = p^T dO) in f32, cast to k's dtype: the dk/dv
    kernel's plain version."""
    p, ds = _bwd_probs(q, k, g, v, lse, delta, scale)
    dk = torch.einsum("bhst,bshd->bthd", ds, q.float()) * scale
    dv = torch.einsum("bhst,bshd->bthd", p, g.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, out, lse, g, scale: float | None = None):
    """(dq, dk, dv) by the explicit formula the backward kernels compute, in
    f32: delta = rowsum(dO o), p = exp(scale q k^T - lse),
    ds = p (dO v^T - delta), dq = scale ds k, dk = scale ds^T q, dv = p^T dO."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    delta = flash_attention_bwd_delta(out, g)
    dq = flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, scale)
    return (dq, *flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta, scale))


def _error_string(lib):
    lib.ait_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ait_cuda_error_string.restype = ctypes.c_char_p
    return lib.ait_cuda_error_string


def _fwd_kernel():
    global _fwd_fn
    if _fwd_fn is None:
        from ai_toolkit_tpu_torch.ops.kernels.build import load

        lib = load("flash_attention_fwd")
        fn = lib.ait_flash_attention_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fwd_fn = (fn, _error_string(lib))
    return _fwd_fn


def _bwd_kernels():
    global _bwd_fns
    if _bwd_fns is None:
        from ai_toolkit_tpu_torch.ops.kernels.build import load

        lib = load("flash_attention_bwd")
        tail = [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
        dq, dkv = lib.ait_flash_attention_bwd_dq, lib.ait_flash_attention_bwd_dkv
        dq.argtypes = [ctypes.c_void_p] * 7 + tail
        dkv.argtypes = [ctypes.c_void_p] * 8 + tail
        dq.restype = dkv.restype = ctypes.c_int
        _bwd_fns = (dq, dkv, _error_string(lib))
    return _bwd_fns


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


def _tma_plan(x: torch.Tensor) -> tuple[tuple[int, ...], tuple[int, ...], bool]:
    """How TMA reads ``x`` ``[B, S, H, D]``: the dims of its tensor map,
    innermost first ``(D, H, S, B)`` (the sequence a dimension of its own, so
    a box past its end reads zeros), the byte strides of H, S and B, and
    whether ``x`` must first be copied. TMA needs a 16-byte aligned base, D
    contiguous, and byte strides that are positive multiples of 16 below
    2**40. A dimension of extent 1 is never stepped over, so its stride is
    taken as the contiguous one."""
    b, s, h, d = x.shape
    es = x.element_size()
    contiguous = (s * h * d, h * d, d)
    sb, ss, sh = (st if n > 1 else c for st, n, c in zip(x.stride()[:3], (b, s, h), contiguous))
    byte_strides = (sh * es, ss * es, sb * es)
    needs_copy = (x.stride(-1) != 1 or x.data_ptr() % 16 != 0
                  or any(st <= 0 or st % 16 or st >= 2**40 for st in byte_strides))
    return (d, h, s, b), byte_strides, needs_copy


def _tma_inputs(tensors):
    """bf16 inputs as TMA reads them, and their (batch, sequence, head)
    element strides for the kernel: a tensor :func:`_tma_plan` cannot map is
    replaced by a contiguous copy, counted in ``tma_copies``."""
    global tma_copies
    ready, strides = [], []
    for x in tensors:
        _, byte_strides, needs_copy = _tma_plan(x)
        if needs_copy:
            tma_copies += 1
            x = x.clone(memory_format=torch.contiguous_format)
            byte_strides = _tma_plan(x)[1]
        sh, ss, sb = (st // x.element_size() for st in byte_strides)
        ready.append(x)
        strides.append((sb, ss, sh))
    return ready, strides


def _launch_fwd(q, k, v, scale: float):
    global launches
    fn, err_str = _fwd_kernel()
    b, s, h, d = q.shape
    t = k.shape[1]
    strides = [x.stride()[:3] for x in (q, k, v)]
    if q.dtype == torch.bfloat16:
        (q, k, v), strides = _tma_inputs((q, k, v))
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, s, t, h, d, _DTYPES[q.dtype], *strides[0], *strides[1], *strides[2],
            float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: {err_str(rc).decode()} ({rc})")
    launches += 1
    return out, lse


def _bwd_args(q, k, v, g, lse, delta, scale: float, strides=None):
    """The launch arguments both backward kernels share; ``strides``: the
    (batch, sequence, head) element strides of q, k, v, g where they are not
    the tensors' own (:func:`_tma_inputs`)."""
    if g.stride(-1) != 1:
        g = g.contiguous()
    lse, delta = lse.contiguous(), delta.contiguous()
    b, s, h, d = q.shape
    if strides is None:
        strides = [x.stride()[:3] for x in (q, k, v, g)]
    strides = (ctypes.c_longlong * 12)(*(st for xs in strides for st in xs))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr())
    tail = (b, s, k.shape[1], h, d, _DTYPES[q.dtype], strides, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    return ptrs, tail, (g, lse, delta, strides)  # the last: buffers kept alive over the call


def _launch_bwd_dq(q, k, v, g, lse, delta, scale: float):
    global dq_launches
    dq_fn, _, err_str = _bwd_kernels()
    strides = None
    if q.dtype == torch.bfloat16:
        (q, k, v, g), strides = _tma_inputs((q, k, v, g))
    ptrs, tail, _keep = _bwd_args(q, k, v, g, lse, delta, scale, strides)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    rc = dq_fn(*ptrs, dq.data_ptr(), *tail)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_dq launch failed: {err_str(rc).decode()} ({rc})")
    dq_launches += 1
    return dq


def _launch_bwd_dkv(q, k, v, g, lse, delta, scale: float):
    global dkv_launches
    _, dkv_fn, err_str = _bwd_kernels()
    strides = None
    if q.dtype == torch.bfloat16:
        (q, k, v, g), strides = _tma_inputs((q, k, v, g))
    ptrs, tail, _keep = _bwd_args(q, k, v, g, lse, delta, scale, strides)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    rc = dkv_fn(*ptrs, dk.data_ptr(), dv.data_ptr(), *tail)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv launch failed: {err_str(rc).decode()} ({rc})")
    dkv_launches += 1
    return dk, dv


def _devices(*tensors) -> str:
    devices = {x.device for x in tensors}
    if len(devices) == 1:
        (dev,) = devices
        if dev.type in ("cpu", "cuda"):
            return dev.type
    raise ValueError(f"flash attention got tensors on {sorted(str(d) for d in devices)}")


@torch.library.custom_op("ait::flash_attention_fwd", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the plain forward on CPU tensors, the kernel on CUDA tensors."""
    if _devices(q, k, v) == "cpu":
        return flash_attention_fwd_plain(q, k, v, scale)
    return _launch_fwd(q, k, v, scale)


@flash_attention_op.register_fake
def _(q, k, v, scale):
    b, s, h, d = q.shape
    return q.new_empty((b, s, h, d)), q.new_empty((b, h, s), dtype=torch.float32)


def flash_attention_bwd_dq(q, k, v, g, lse, delta, scale: float):
    """dq ``[B,S,H,D]`` from the forward's lse and delta = rowsum(dO o)
    (:func:`flash_attention_bwd_delta`): the plain version on CPU tensors, the
    dq kernel on CUDA tensors."""
    if _devices(q, k, v, g, lse, delta) == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, scale)
    return _launch_bwd_dq(q, k, v, g, lse, delta, scale)


def flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale: float):
    """(dk, dv) ``[B,T,H,D]``: the plain version on CPU tensors, the dk/dv
    kernel on CUDA tensors."""
    if _devices(q, k, v, g, lse, delta) == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta, scale)
    return _launch_bwd_dkv(q, k, v, g, lse, delta, scale)


def flash_attention_bwd(q, k, v, out, lse, g, scale: float | None = None):
    """(dq, dk, dv) of ``out`` for its cotangent ``g`` ``[B,S,H,D]``, from the
    forward's ``out`` and ``lse``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _devices(q, k, v, out, lse, g)
    delta = flash_attention_bwd_delta(out, g)
    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, scale)
    return (dq, *flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale))


def _setup_context(ctx, inputs, output):
    q, k, v, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.scale = scale
    ctx.mark_non_differentiable(lse)


def _backward(ctx, g_out, g_lse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g_out, ctx.scale)
    return dq, dk, dv, None


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention_fwd(q, k, v, scale: float | None = None):
    """(out [B,S,H,D], lse f32 [B,H,S]) of softmax(scale q k^T) v."""
    _check(q, k, v)
    _devices(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return flash_attention_op(q, k, v, float(scale))
