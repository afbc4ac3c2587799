"""The launch plan of the bf16 MoE dx kernel (pure Python, no card).

``moe_gmm.check_tma`` refuses a tensor the kernel's TMA cannot map (the maps
themselves are built in ``csrc/hopper.cuh``), and ``block_order`` /
``patch_rows`` / ``dx_plan`` give the grouped order of the blocks that the
kernel walks (``csrc/moe_gmm_sm90.cuh``).
"""

import pytest
import torch

from ai_toolkit_tpu_torch.ops.kernels import moe_gmm as moe

N, D, H, E = 1024, 256, 512, 4


@pytest.mark.parametrize("shape", [
    (N, D),  # x, dy, dx
    (N, 2 * H),  # dh = [dh1 | dh3]
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
