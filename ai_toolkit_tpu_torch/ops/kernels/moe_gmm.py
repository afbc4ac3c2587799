"""Grouped SwiGLU MoE dispatch: the hand-written CUDA kernels, forward, dx and
the bank gradients (dw), their plain versions, and the gather / combine
around them (``ai_toolkit_tpu/ops/pallas/moe_gmm.py`` in PyTorch).

The forward replaces the Pallas ``_fwd_kernel`` with ``csrc/moe_gmm_fwd.cu``,
the input gradient ``_dx_kernel`` with ``csrc/moe_gmm_bwd.cu``, the bank
gradients ``_dw_kernel`` with the first pass of ``moe_gmm_bwd.cu`` (which
then also writes the SwiGLU activation) and ``csrc/moe_gmm_dw.cu``. All are
grouped GEMMs over expert-sorted 128-row tiles in which every block reads
its expert itself and owns its output tile; dw's blocks own a tile of one
expert's gradient and reduce over that expert's run of row tiles. What
bounds them at the hidream shape (8192 routed rows, d 2560, h 6912, 4
experts, bf16): 6·N·d·h (forward), 10·N·d·h (dx) and 12·N·d·h (dw from x
and dy; 6·N·d·h beside a dx that shares its first pass) operations against
well under a GB of weights and activations, so all are compute-bound. In
bf16 every pass runs wgmma on shared-memory tiles that TMA loads through
mbarrier-guarded rings, with the SwiGLU (and its backward) in registers and
a grouped block order that the wrapper builds (``csrc/moe_gmm_sm90.cuh``;
:func:`fwd_plan`, :func:`dx_plan`, :func:`dw_plan`); f32 runs CUDA-core
tiles (``csrc/moe_gmm_tile.cuh``) for the exact checks. The SwiGLU
activation (forward, dw) and ``[dh1 | dh3]`` (dx, dw) go between their GEMMs
through device memory in the input type.

``grouped_swiglu(x, w1, w3, w2, tile_group, block_m)`` keeps the JAX layout:
x ``[N, d]`` expert-sorted with N a multiple of ``block_m``, w1/w3
``[E, d, h]``, w2 ``[E, h, d]``, tile_group int32 ``[N / block_m]``,
non-decreasing. It is the custom op ``ait::grouped_swiglu``, whose autograd
runs dx where x needs a gradient and dw where a bank does. CPU tensors go to
the plain versions; CUDA tensors launch the kernels or raise. The kernels
take ``block_m`` = :data:`BLOCK_M` = 128 (the TPU's VMEM budgeting,
``default_blocks`` and ``_dw_block_h``, has no counterpart here) and d, h
multiples of 64. In bf16 every kernel reads its inputs through TMA tensor
maps and refuses a tensor TMA cannot map (:func:`check_tma`).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

# kernel launches in this process, one count per kernel (a launch runs its two GEMM passes, or
# one of the forward's alone when it is timed)
launches = 0  # moe_gmm_fwd
dx_launches = 0  # moe_gmm_dx
dw_launches = 0  # moe_gmm_dw

BLOCK_M = 128  # rows per tile of the CUDA kernels (csrc/moe_gmm_tile.cuh BM)
_BN_DX_HIDDEN = 64  # hidden columns per tile of the bf16 dx's first pass (csrc/moe_gmm_sm90.cuh)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns: dict[str, tuple] = {}
_plans: dict[tuple, tuple] = {}


def expert_runs(tile_group: torch.Tensor, block_m: int):
    """(expert, first row, end row) of each run of consecutive tiles of one expert."""
    runs, start = [], 0
    groups = tile_group.tolist()
    for i in range(1, len(groups) + 1):
        if i == len(groups) or groups[i] != groups[start]:
            runs.append((groups[start], start * block_m, i * block_m))
            start = i
    return runs


def grouped_swiglu_plain(x, w1, w3, w2, tile_group, block_m: int):
    """``y = (silu(x W1[g]) * (x W3[g])) W2[g]`` per row tile in f32, cast to
    x's dtype: the forward kernel's plain version."""
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for g, r0, r1 in expert_runs(tile_group, block_m):
        xs = x[r0:r1].float()
        act = F.silu(xs @ w1[g].float()) * (xs @ w3[g].float())
        y[r0:r1] = act @ w2[g].float()
    return y.to(x.dtype)


def _hidden_plain(xs, dys, a1, a3, a2):
    """(dh1, dh3, act) of one expert's rows in f32, h1 and h3 recomputed (the
    Pallas ``_dx_kernel`` / ``_dw_kernel`` formula)."""
    h1, h3 = xs @ a1, xs @ a3
    sg = torch.sigmoid(h1)
    dp = dys @ a2.t()
    return dp * h3 * (sg * (1.0 + h1 * (1.0 - sg))), dp * (h1 * sg), h1 * sg * h3


def grouped_swiglu_dx_plain(x, dy, w1, w3, w2, tile_group, block_m: int):
    """dx per row tile in f32, cast to x's dtype: the dx kernel's plain version."""
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for g, r0, r1 in expert_runs(tile_group, block_m):
        a1, a3 = w1[g].float(), w3[g].float()
        dh1, dh3, _ = _hidden_plain(x[r0:r1].float(), dy[r0:r1].float(), a1, a3, w2[g].float())
        dx[r0:r1] = dh1 @ a1.t() + dh3 @ a3.t()
    return dx.to(x.dtype)


def grouped_swiglu_dw_plain(x, dy, w1, w3, w2, tile_group, block_m: int):
    """(dW1, dW3 ``[E, d, h]``, dW2 ``[E, h, d]``) summed over each expert's
    row tiles in f32 (the Pallas ``_dw_kernel`` formula), each cast to its
    bank's dtype; an expert that owns no tile gets zeros: the dw kernel's
    plain version."""
    dws = [torch.zeros(w.shape, dtype=torch.float32, device=x.device) for w in (w1, w3, w2)]
    for g, r0, r1 in expert_runs(tile_group, block_m):
        xs, dys = x[r0:r1].float(), dy[r0:r1].float()
        dh1, dh3, act = _hidden_plain(xs, dys, w1[g].float(), w3[g].float(), w2[g].float())
        dws[0][g] += xs.t() @ dh1
        dws[1][g] += xs.t() @ dh3
        dws[2][g] += act.t() @ dys
    return tuple(dw.to(w.dtype) for dw, w in zip(dws, (w1, w3, w2)))


def grouped_swiglu_hidden_plain(x, dy, w1, w3, w2, tile_group, block_m: int):
    """(dh ``[N, 2h]`` = ``[dh1 | dh3]``, act ``[N, h]``) per row tile in f32,
    cast to x's dtype: the plain version of the hidden pass that dx and dw
    share."""
    h = w1.shape[-1]
    dh = torch.empty((x.shape[0], 2 * h), dtype=torch.float32, device=x.device)
    act = torch.empty((x.shape[0], h), dtype=torch.float32, device=x.device)
    for g, r0, r1 in expert_runs(tile_group, block_m):
        dh1, dh3, act[r0:r1] = _hidden_plain(x[r0:r1].float(), dy[r0:r1].float(), w1[g].float(),
                                             w3[g].float(), w2[g].float())
        dh[r0:r1, :h], dh[r0:r1, h:] = dh1, dh3
    return dh.to(x.dtype), act.to(x.dtype)


# ---- the launch plans of the bf16 kernels (csrc/moe_gmm_sm90.cuh), on the host ----

def check_tma(t: torch.Tensor) -> None:
    """Raises ValueError for a tensor the bf16 kernels' TMA cannot map as it
    is (not a bf16 matrix ``[rows, cols]`` or bank ``[E, rows, cols]``, not
    contiguous, a base not 16-byte aligned, a row that is not a whole number
    of 64-column boxes, a byte stride past TMA's limit): the kernels take no
    fallback. The maps themselves are built in ``csrc/hopper.cuh``
    (``make_map_rows``, ``make_map_bank``)."""
    if t.dtype != torch.bfloat16 or t.dim() not in (2, 3):
        raise ValueError(f"the bf16 MoE kernels map bf16 matrices and banks, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16 or t.shape[-1] % 64:
        raise ValueError(f"TMA cannot map a tensor {tuple(t.shape)} with strides {t.stride()} at byte "
                         f"offset {t.data_ptr() % 16} from a 16-byte boundary: it needs it contiguous, "
                         f"16-byte aligned, with rows of whole 64-column boxes")
    if any(st * t.element_size() >= 2**40 for st in t.stride()[:-1]):
        raise ValueError(f"a byte stride of {tuple(t.shape)} is past TMA's 2**40")


def patch_rows(row_tiles: int, row_bytes: int, col_bytes: int, wave: int) -> int:
    """Row tiles in one patch of the grouped block order. A wave of ``wave``
    blocks (one per SM) covers ``p`` row tiles and ``wave / p`` column tiles
    and reads ``p * row_bytes + wave / p * col_bytes`` from device memory,
    least at ``p = sqrt(wave * col_bytes / row_bytes)``."""
    return max(1, min(row_tiles, round(math.sqrt(wave * col_bytes / row_bytes))))


def block_order(row_tiles: int, col_tiles: int, patch: int) -> torch.Tensor:
    """int32 ``[row_tiles * col_tiles]``: the tile index ``m * col_tiles +
    n`` that block i computes. Row tiles go in patches of ``patch`` (the last
    one shorter), and a patch is swept column tile by column tile, its row
    tiles fastest, so the blocks in flight share both row tiles and weight
    column tiles."""
    order = []
    for m0 in range(0, row_tiles, patch):
        rows = range(m0, min(m0 + patch, row_tiles))
        order += [m * col_tiles + n for n in range(col_tiles) for m in rows]
    return torch.tensor(order, dtype=torch.int32)


def fwd_plan(n: int, d: int, h: int, wave: int) -> dict:
    """The tile widths, patches and block orders of the two bf16 forward
    passes for ``n`` routed rows. GATE_UP takes 128 x 128 tiles of act (64
    wide where h % 128 != 0) and reads x (``2 BM d`` bytes a row tile) and
    columns of W1 and W3 (``4 BN d``); DOWN takes 128 x 128 tiles of y (64
    wide where d % 128 != 0) and reads act (``2 BM h``) and columns of W2
    (``2 BN h``)."""
    rows = n // BLOCK_M
    bn1 = 128 if h % 128 == 0 else 64
    bn2 = 128 if d % 128 == 0 else 64
    p1 = patch_rows(rows, 2 * BLOCK_M * d, 4 * bn1 * d, wave)
    p2 = patch_rows(rows, 2 * BLOCK_M * h, 2 * bn2 * h, wave)
    return {"bn_hidden": bn1, "bn_out": bn2, "patch_gate_up": p1, "patch_down": p2,
            "order_gate_up": block_order(rows, h // bn1, p1), "order_down": block_order(rows, d // bn2, p2)}


def dx_plan(n: int, d: int, h: int, wave: int) -> dict:
    """The dx tile width, patches and block orders of the two bf16 dx passes
    for ``n`` routed rows. Pass 1 takes 128 x :data:`_BN_DX_HIDDEN` tiles of
    the hidden axis and reads x and dy (``4 BM d`` bytes a row tile) and
    columns of W1, W3, W2 (``6 BN d``); pass 2 takes 128 x 128 tiles of dx
    (64 wide where d % 128 != 0) and reads dh (``4 BM h``) and rows of W1
    and W3 (``4 BN h``)."""
    rows = n // BLOCK_M
    bn2 = 128 if d % 128 == 0 else 64
    p1 = patch_rows(rows, 4 * BLOCK_M * d, 6 * _BN_DX_HIDDEN * d, wave)
    p2 = patch_rows(rows, 4 * BLOCK_M * h, 4 * bn2 * h, wave)
    return {"bn_out": bn2, "patch_hidden": p1, "patch_out": p2,
            "order_hidden": block_order(rows, h // _BN_DX_HIDDEN, p1), "order_out": block_order(rows, d // bn2, p2)}


def dw_plan(d: int, h: int, experts: int, wave: int) -> dict:
    """The tile width, patches and block order of the bf16 dw products, one
    launch over every expert's two gradients: ``[dW1 | dW3]`` in ceil(d /
    128) x 2h / bn tiles of 128 x bn, then dW2 in ceil(h / 128) x d / bn;
    bn = 128 where d and h both allow it (a column tile of ``[dW1 | dW3]``
    must not straddle the banks), else 64. Tile index ``t``: ``[dW1 | dW3]``
    tiles first, expert by expert, row-major within an expert, then dW2's
    (``csrc/moe_gmm_sm90.cuh`` ``DwParams``). Per reduction row a block
    reads ``2 BM`` bytes of x or act and ``2 bn`` of dh or dy, so each
    expert's tiles go in patches of ``patch_rows`` on those."""
    bn = 128 if d % 128 == 0 and h % 128 == 0 else 64
    order, patches, base = [], [], 0
    for rows, cols in ((-(-d // BLOCK_M), 2 * h // bn), (-(-h // BLOCK_M), d // bn)):
        patch = patch_rows(rows, 2 * BLOCK_M, 2 * bn, wave)
        tiles = block_order(rows, cols, patch)
        order += [tiles + base + g * rows * cols for g in range(experts)]
        patches.append(patch)
        base += experts * rows * cols
    return {"bn": bn, "patch_w13": patches[0], "patch_w2": patches[1], "order": torch.cat(order)}


_PLANS = {"fwd": fwd_plan, "dx": dx_plan, "dw": dw_plan}


def _plan(kind: str, device, *shape) -> tuple:
    """(plan, its block orders on the card) of ``_PLANS[kind]`` for these
    shapes on ``device``, built once per shape."""
    key = (kind, device, *shape)
    hit = _plans.get(key)
    if hit is None:
        plan = _PLANS[kind](*shape, torch.cuda.get_device_properties(device).multi_processor_count)
        hit = _plans[key] = (plan, *(v.to(device) for k, v in plan.items() if k.startswith("order")))
    return hit


# library -> (C entry, pointer arguments, int arguments); the stream comes last
_ENTRIES = {"moe_gmm_fwd": ("ait_moe_gmm_fwd", 9, 7), "moe_gmm_bwd": ("ait_moe_gmm_dx", 11, 6),
            "moe_gmm_dw": ("ait_moe_gmm_dw", 9, 6)}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from ai_toolkit_tpu_torch.ops.kernels.build import load

        lib = load(name)
        symbol, n_ptrs, n_ints = _ENTRIES[name]
        entry = getattr(lib, symbol)
        entry.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        entry.restype = ctypes.c_int
        lib.ait_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ait_cuda_error_string.restype = ctypes.c_char_p
        fn = _fns[name] = (entry, lib.ait_cuda_error_string)
    return fn


def _check_cuda(x, w1, w3, w2, tile_group, block_m: int, dy=None) -> None:
    n, d = x.shape
    e, _, h = w1.shape
    if block_m != BLOCK_M:
        raise ValueError(f"the CUDA kernels take block_m {BLOCK_M}, got {block_m}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (w1, w3, w2, *(() if dy is None else (dy,)))):
        raise TypeError(f"grouped_swiglu takes float32 or bfloat16 throughout, got x {x.dtype}, "
                        f"banks {w1.dtype}/{w3.dtype}/{w2.dtype}")
    if n % BLOCK_M or d % 64 or h % 64:
        raise ValueError(f"grouped_swiglu kernels need N % {BLOCK_M} == 0 and d, h multiples of 64, "
                         f"got N={n}, d={d}, h={h}")
    if tile_group.dtype != torch.int32 or tile_group.shape != (n // BLOCK_M,):
        raise ValueError(f"tile_group must be int32 [{n // BLOCK_M}], got {tile_group.dtype} "
                         f"{tuple(tile_group.shape)}")
    if not all(t.is_contiguous() for t in (x, w1, w3, w2, tile_group)):
        raise ValueError("grouped_swiglu kernels need contiguous tensors")


def _launch_fwd(x, w1, w3, w2, tile_group, block_m: int, act=None, down: bool = True):
    """(act, y) on CUDA tensors: GATE_UP writes ``act = silu(x W1) * (x W3)``
    ``[N, h]``, DOWN ``y = act W2``. Given ``act``, only DOWN runs, on it;
    with ``down=False`` only GATE_UP, and y is None (a pass alone, to time it)."""
    global launches
    _check_cuda(x, w1, w3, w2, tile_group, block_m)
    fn, err_str = _kernel("moe_gmm_fwd")
    n, d = x.shape
    e, _, h = w1.shape
    gate_up = act is None
    if gate_up:
        act = torch.empty((n, h), dtype=x.dtype, device=x.device)
    elif act.shape != (n, h) or act.dtype != x.dtype or not act.is_contiguous():
        raise ValueError(f"act {tuple(act.shape)} {act.dtype} is not the contiguous [{n}, {h}] {x.dtype} "
                         f"DOWN takes")
    y = torch.empty_like(x) if down else None
    orders, widths = (None, None), (0, 0)
    if x.dtype == torch.bfloat16:
        for t in (x, w1, w3, w2, act):
            check_tma(t)
        plan, *orders = _plan("fwd", x.device, n, d, h)
        widths = plan["bn_hidden"], plan["bn_out"]
    rc = fn(x.data_ptr() if gate_up else None, w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
            tile_group.data_ptr(), *(_ptr(o) for o in orders), act.data_ptr(), _ptr(y), n, d, h, e, *widths,
            _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm_fwd launch failed: {err_str(rc).decode()} ({rc})")
    launches += 1
    return act, y


def _launch_dx(x, dy, w1, w3, w2, tile_group, block_m: int, need_dx: bool, need_act: bool):
    """(dx or None, dh, act or None) on CUDA tensors: the first pass of
    ``moe_gmm_bwd`` builds ``[dh1 | dh3]`` (and the activation ``act`` with
    ``need_act``), the second dx from it (with ``need_dx``)."""
    global dx_launches
    dy = dy.contiguous()
    _check_cuda(x, w1, w3, w2, tile_group, block_m, dy)
    fn, err_str = _kernel("moe_gmm_bwd")
    n, d = x.shape
    e, _, h = w1.shape
    dh = torch.empty((n, 2 * h), dtype=x.dtype, device=x.device)
    act = torch.empty((n, h), dtype=x.dtype, device=x.device) if need_act else None
    dx = torch.empty_like(x) if need_dx else None
    orders, bn_out = (None, None), 0
    if x.dtype == torch.bfloat16:
        for t in (x, dy, w1, w3, w2):
            check_tma(t)
        plan, *orders = _plan("dx", x.device, n, d, h)
        bn_out = plan["bn_out"]
    rc = fn(x.data_ptr(), dy.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
            tile_group.data_ptr(), *(_ptr(o) for o in orders), dh.data_ptr(), _ptr(act), _ptr(dx),
            n, d, h, e, bn_out, _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm_bwd launch failed: {err_str(rc).decode()} ({rc})")
    if need_dx:
        dx_launches += 1
    return dx, dh, act


def _launch_bwd(x, dy, w1, w3, w2, tile_group, block_m: int, need_dx: bool, need_dw: bool):
    """(dx or None, (dW1, dW3, dW2) or None) on CUDA tensors: the first pass
    builds ``[dh1 | dh3]`` (and the activation when a bank needs its
    gradient) once for both, then dx's second pass and the dw products run
    as asked."""
    dx, dh, act = _launch_dx(x, dy, w1, w3, w2, tile_group, block_m, need_dx, need_dw)
    dws = _launch_dw_products(x, dy.contiguous(), dh, act, tile_group, w1.shape[0]) if need_dw else None
    return dx, dws


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _launch_dw_products(x, dy, dh, act, tile_group, experts: int):
    """``csrc/moe_gmm_dw.cu`` on the first pass's ``dh`` ``[N, 2h]`` and
    ``act`` ``[N, h]``: (dW1, dW3 ``[E, d, h]``, dW2 ``[E, h, d]``) in x's dtype."""
    global dw_launches
    n, d = x.shape
    h = act.shape[1]
    if (n % BLOCK_M or d % 64 or h % 64 or dh.shape != (n, 2 * h) or dy.shape != (n, d)
            or tile_group.dtype != torch.int32 or tile_group.shape != (n // BLOCK_M,)
            or x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dy, dh, act))
            or not all(t.is_contiguous() for t in (x, dy, dh, act, tile_group))):
        raise ValueError(f"moe_gmm_dw: x {tuple(x.shape)} {x.dtype}, dy {tuple(dy.shape)}, dh "
                         f"{tuple(dh.shape)}, act {tuple(act.shape)}, tile_group "
                         f"{tuple(tile_group.shape)} {tile_group.dtype} are not what the kernel takes")
    fn, err_str = _kernel("moe_gmm_dw")
    dw1, dw3 = (torch.empty((experts, d, h), dtype=x.dtype, device=x.device) for _ in range(2))
    dw2 = torch.empty((experts, h, d), dtype=x.dtype, device=x.device)
    order, bn = None, 0
    if x.dtype == torch.bfloat16:
        for t in (x, dy, dh, act):
            check_tma(t)
        plan, order = _plan("dw", x.device, d, h, experts)
        bn = plan["bn"]
    rc = fn(x.data_ptr(), dy.data_ptr(), dh.data_ptr(), act.data_ptr(), tile_group.data_ptr(), _ptr(order),
            dw1.data_ptr(), dw3.data_ptr(), dw2.data_ptr(), n, d, h, experts, bn, _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm_dw launch failed: {err_str(rc).decode()} ({rc})")
    dw_launches += 1
    return dw1, dw3, dw2


def _device(*tensors) -> str:
    devices = {t.device for t in tensors}
    if len(devices) == 1:
        (dev,) = devices
        if dev.type in ("cpu", "cuda"):
            return dev.type
    raise ValueError(f"grouped_swiglu got tensors on {sorted(str(d) for d in devices)}")


def _check_shapes(x, w1, w3, w2, tile_group, block_m: int) -> None:
    if x.dim() != 2 or w1.dim() != 3:
        raise ValueError(f"grouped_swiglu wants x [N, d] and banks [E, d, h], got {tuple(x.shape)}, "
                         f"{tuple(w1.shape)}")
    n, d = x.shape
    e, _, h = w1.shape
    if w1.shape != (e, d, h) or w3.shape != (e, d, h) or w2.shape != (e, h, d):
        raise ValueError(f"banks w1 {tuple(w1.shape)} w3 {tuple(w3.shape)} w2 {tuple(w2.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if block_m <= 0 or n % block_m or tile_group.shape != (n // block_m,):
        raise ValueError(f"N={n} is not tiled by block_m={block_m} with tile_group "
                         f"{tuple(tile_group.shape)}")


@torch.library.custom_op("ait::grouped_swiglu", mutates_args=())
def grouped_swiglu_op(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                      tile_group: torch.Tensor, block_m: int) -> torch.Tensor:
    """The plain forward on CPU tensors, the kernel on CUDA tensors."""
    if _device(x, w1, w3, w2, tile_group) == "cpu":
        return grouped_swiglu_plain(x, w1, w3, w2, tile_group, block_m)
    return _launch_fwd(x, w1, w3, w2, tile_group, block_m)[1]


@grouped_swiglu_op.register_fake
def _(x, w1, w3, w2, tile_group, block_m):
    return torch.empty_like(x)


def grouped_swiglu_bwd(x, dy, w1, w3, w2, tile_group, block_m: int, need_dx: bool = True,
                       need_dw: bool = True):
    """(dx ``[N, d]`` or None, (dW1, dW3, dW2) or None) of
    :func:`grouped_swiglu` for the cotangent ``dy``: the plain versions on CPU
    tensors, the kernels on CUDA tensors."""
    if _device(x, dy, w1, w3, w2, tile_group) == "cuda":
        return _launch_bwd(x, dy, w1, w3, w2, tile_group, block_m, need_dx, need_dw)
    dx = grouped_swiglu_dx_plain(x, dy, w1, w3, w2, tile_group, block_m) if need_dx else None
    dws = grouped_swiglu_dw_plain(x, dy, w1, w3, w2, tile_group, block_m) if need_dw else None
    return dx, dws


def grouped_swiglu_hidden(x, dy, w1, w3, w2, tile_group, block_m: int):
    """(dh ``[N, 2h]``, act ``[N, h]``): the hidden pass that dx and dw share
    (the DW_HIDDEN mode of the dx kernel) alone, or its plain version on CPU
    tensors."""
    if _device(x, dy, w1, w3, w2, tile_group) == "cpu":
        return grouped_swiglu_hidden_plain(x, dy, w1, w3, w2, tile_group, block_m)
    _, dh, act = _launch_dx(x, dy, w1, w3, w2, tile_group, block_m, need_dx=False, need_act=True)
    return dh, act


def grouped_swiglu_dx(x, dy, w1, w3, w2, tile_group, block_m: int):
    """dx ``[N, d]`` of :func:`grouped_swiglu`: the dx kernel or its plain version."""
    return grouped_swiglu_bwd(x, dy, w1, w3, w2, tile_group, block_m, need_dw=False)[0]


def grouped_swiglu_dw(x, dy, w1, w3, w2, tile_group, block_m: int):
    """(dW1, dW3, dW2) of :func:`grouped_swiglu`: the dw kernel (with the
    first pass it needs) or its plain version."""
    return grouped_swiglu_bwd(x, dy, w1, w3, w2, tile_group, block_m, need_dx=False)[1]


def _setup_context(ctx, inputs, output):
    x, w1, w3, w2, tile_group, block_m = inputs
    ctx.save_for_backward(x, w1, w3, w2, tile_group)
    ctx.block_m = block_m


def _backward(ctx, dy):
    x, w1, w3, w2, tile_group = ctx.saved_tensors
    needs = ctx.needs_input_grad
    dx, dws = grouped_swiglu_bwd(x, dy, w1, w3, w2, tile_group, ctx.block_m, need_dx=needs[0],
                                 need_dw=any(needs[1:4]))
    dw1, dw3, dw2 = (g if need else None for g, need in zip(dws or (None,) * 3, needs[1:4]))
    return dx, dw1, dw3, dw2, None, None


grouped_swiglu_op.register_autograd(_backward, setup_context=_setup_context)


def grouped_swiglu(x, w1, w3, w2, tile_group, block_m: int = BLOCK_M):
    """Row-grouped SwiGLU FFN: ``y[i*bm:(i+1)*bm] = swiglu(x_tile, W[g_i])``."""
    _check_shapes(x, w1, w3, w2, tile_group, block_m)
    return grouped_swiglu_op(x, w1, w3, w2, tile_group, int(block_m))


def dispatch_rows(xf, topi, num_experts: int, block_m: int = BLOCK_M):
    """The gather of :func:`moe_dispatch_swiglu`: token rows ``xf [T, d]`` and
    their experts ``topi [..., K]`` (T = numel / K) -> (``x_sorted [npad, d]``,
    expert-sorted in ``block_m``-row tiles with zero padding rows,
    ``tile_group`` int32 ``[npad / block_m]``, ``dst [T*K]``: the row of each
    (token, k) entry).

    No host sync and no data-dependent shape: ``npad`` is the static bound of
    the JAX code, counts come from ``index_add_`` (CUDA ``bincount`` reads its
    maximum back to the host)."""
    d = xf.shape[-1]
    e, k = num_experts, topi.shape[-1]
    n = topi.numel()
    dev = xf.device
    eid = topi.reshape(n).long()
    tok = torch.arange(n // k, device=dev).repeat_interleave(k)
    order = torch.argsort(eid, stable=True)
    sorted_eid = eid[order]
    counts = torch.zeros(e, dtype=torch.long, device=dev).index_add_(0, eid, torch.ones_like(eid))
    padded = (counts + block_m - 1) // block_m * block_m
    ends = torch.cumsum(padded, 0)
    starts = ends - padded
    group_start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - group_start[sorted_eid]
    dst_sorted = starts[sorted_eid] + rank  # row in the padded buffer
    npad = -(-(n + e * block_m) // block_m) * block_m  # static upper bound
    x_sorted = xf.new_zeros((npad, d)).index_copy(0, dst_sorted, xf[tok[order]])
    # expert id per row tile (tiles past the used region clamp to the last
    # expert; their rows are zero and their outputs are never gathered)
    tile_group = torch.searchsorted(ends, torch.arange(npad // block_m, device=dev) * block_m,
                                    right=True).clamp_max(e - 1).to(torch.int32)
    dst = torch.empty_like(order).scatter_(0, order, dst_sorted)
    return x_sorted, tile_group, dst


def moe_dispatch_swiglu(x, topv, topi, w1, w3, w2, block_m: int = BLOCK_M):
    """Gather-dispatch MoE SwiGLU: x ``[B, S, d]``, topv/topi ``[B, S, K]``,
    banks w1/w3 ``[E, d, h]``, w2 ``[E, h, d]`` -> ``[B, S, d]``, the
    gate-weighted combine in f32 (JAX ``moe_dispatch_swiglu`` line for line,
    the gather in :func:`dispatch_rows`)."""
    b, s, d = x.shape
    k = topi.shape[-1]
    x_sorted, tile_group, dst = dispatch_rows(x.reshape(b * s, d), topi, w1.shape[0], block_m)
    y_sorted = grouped_swiglu(x_sorted, w1, w3, w2, tile_group, block_m)
    y_entries = y_sorted[dst].reshape(b, s, k, d)
    return torch.einsum("bskd,bsk->bsd", y_entries.float(), topv.float()).to(x.dtype)
