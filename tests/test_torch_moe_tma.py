"""The launch plans of the bf16 MoE kernels (pure Python, no card).

``moe_gmm.check_tma`` refuses a tensor the kernels' TMA cannot map (the maps
themselves are built in ``csrc/hopper.cuh``), and ``block_order`` /
``patch_rows`` / ``fwd_plan`` / ``dx_plan`` / ``dw_plan`` give the order of
the blocks that the kernels walk (``csrc/moe_gmm_sm90.cuh``).
"""

import pytest
import torch

from ai_toolkit_tpu_torch.ops.kernels import moe_gmm as moe

N, D, H, E = 1024, 256, 512, 4


@pytest.mark.parametrize("shape", [
    (N, D),  # x, dy, dx
    (N, 2 * H),  # dh = [dh1 | dh3]
    (N, H),  # act: written by the forward's GATE_UP and dw's hidden pass, read by DOWN and dw
    (E, D, H),  # W1, W3
    (E, H, D),  # W2
])
def test_check_tma_accepts_what_the_kernel_maps(shape):
    moe.check_tma(torch.zeros(shape, dtype=torch.bfloat16))


@pytest.mark.parametrize("layout", ["float32", "transposed", "unaligned_base", "ragged_row", "vector",
                                    "stride_past_2_40"])
def test_check_tma_refuses_what_tma_cannot_map(layout):
    if layout == "float32":
        t = torch.zeros((N, D))
    elif layout == "transposed":
        t = torch.zeros((D, N), dtype=torch.bfloat16).t()
    elif layout == "unaligned_base":  # 2 bytes past a 16-byte boundary
        t = torch.zeros(N * D + 1, dtype=torch.bfloat16)[1:].view(N, D)
    elif layout == "ragged_row":  # rows not a whole number of 64-column boxes
        t = torch.zeros((N, 96), dtype=torch.bfloat16)
    elif layout == "vector":
        t = torch.zeros(N * D, dtype=torch.bfloat16)
    else:  # an expert stride of 2**40 bytes (no storage: a meta tensor)
        t = torch.empty((2, 2**33, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        moe.check_tma(t)


@pytest.mark.parametrize("rows,cols,patch", [
    (68, 108, 10),  # hidream double block, first pass
    (68, 20, 11),  # its second pass
    (20, 108, 10),  # 1000 tokens
    (7, 3, 3),  # a shorter last patch
    (1, 5, 4),  # fewer row tiles than a patch
    (9, 1, 9),
])
def test_block_order_visits_every_tile_once_inside_its_patch(rows, cols, patch):
    order = moe.block_order(rows, cols, patch)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(rows * cols))
    for i, t in enumerate(order.tolist()):
        m, n = divmod(t, cols)
        first = i // (patch * cols) * patch  # the patch block i belongs to
        in_patch = min(patch, rows - first)
        j = i - first * cols  # block i's place within its patch
        assert first <= m < first + in_patch
        assert (m, n) == (first + j % in_patch, j // in_patch)  # row tiles fastest, then column tiles


def test_dx_plan_at_the_hidream_shapes():
    """132 SMs: the first pass takes patches of 10 row tiles (a wave ~26 MB),
    the second of 11; d % 128 != 0 falls back to 64-wide dx tiles."""
    plan = moe.dx_plan(8704, 2560, 6912, 132)
    assert {k: v for k, v in plan.items() if "order" not in k} == {
        "bn_out": 128, "patch_hidden": 10, "patch_out": 11}
    assert plan["order_hidden"].shape == (68 * 108,) and plan["order_out"].shape == (68 * 20,)
    assert moe.dx_plan(896, 192, 320, 132)["bn_out"] == 64
    assert moe.patch_rows(3, 1, 10**6, 132) == 3 and moe.patch_rows(50, 10**6, 1, 132) == 1


def test_fwd_plan_at_the_hidream_shapes():
    """132 SMs: GATE_UP (128 x 128 tiles of act) takes patches of 16 row
    tiles, DOWN (128 x 128 tiles of y) of 11; h or d % 128 != 0 gives the
    64-wide variant of that pass."""
    plan = moe.fwd_plan(8704, 2560, 6912, 132)
    assert {k: v for k, v in plan.items() if "order" not in k} == {
        "bn_hidden": 128, "bn_out": 128, "patch_gate_up": 16, "patch_down": 11}
    assert plan["order_gate_up"].shape == (68 * 54,) and plan["order_down"].shape == (68 * 20,)
    for key, cols in (("order_gate_up", 54), ("order_down", 20)):
        assert sorted(plan[key].tolist()) == list(range(68 * cols))
    narrow = moe.fwd_plan(896, 192, 320, 132)
    assert (narrow["bn_hidden"], narrow["bn_out"]) == (64, 64)
    assert narrow["order_gate_up"].shape == (7 * 5,) and narrow["order_down"].shape == (7 * 3,)
    assert moe.fwd_plan(1024, 2560, 6848, 132)["bn_hidden"] == 64  # h = 107 x 64
    assert moe.fwd_plan(1024, 2496, 6912, 132)["bn_out"] == 64  # d = 39 x 64


def _dw_tile(t, d, h, e, bn):
    """(gradient, expert, row tile, column tile) of dw tile index t, decoded as
    csrc/moe_gmm_sm90.cuh moe_dw_sm90 does."""
    m13, n13, m2, n2 = -(-d // 128), 2 * h // bn, -(-h // 128), d // bn
    w13 = t < e * m13 * n13
    u = t if w13 else t - e * m13 * n13
    mt, nt = (m13, n13) if w13 else (m2, n2)
    return ("w13" if w13 else "w2", u // (mt * nt), u % (mt * nt) // nt, u % nt)


@pytest.mark.parametrize("d,h,e,bn,patches", [
    (2560, 6912, 4, 128, (11, 11)),  # hidream: 20 x 108 and 54 x 20 tiles per expert
    (192, 320, 2, 64, (2, 3)),  # ragged output rows, 64-wide tiles
    (64, 128, 4, 64, (1, 1)),  # d = 64: half an output row tile; h % 128 == 0 but d is not
    (256, 512, 3, 128, (2, 4)),
])
def test_dw_plan_visits_every_expert_tile_once(d, h, e, bn, patches):
    plan = moe.dw_plan(d, h, e, 132)
    assert (plan["bn"], plan["patch_w13"], plan["patch_w2"]) == (bn, *patches)
    order = plan["order"]
    assert order.dtype == torch.int32
    tiles = [_dw_tile(t, d, h, e, bn) for t in order.tolist()]
    expected = {("w13", g, m, n) for g in range(e) for m in range(-(-d // 128)) for n in range(2 * h // bn)}
    expected |= {("w2", g, m, n) for g in range(e) for m in range(-(-h // 128)) for n in range(d // bn)}
    assert len(tiles) == len(expected) and set(tiles) == expected
    # a column tile of [dW1 | dW3] lies in one bank
    assert all(n * bn // h == (n * bn + bn - 1) // h for kind, _, _, n in tiles if kind == "w13")
