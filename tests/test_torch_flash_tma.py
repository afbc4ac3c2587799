"""The TMA launch planning of the flash kernels' wrapper (pure Python, no card).

``_tma_plan`` decides how the bf16 forward and dk/dv kernels read q, k, v and
dO through a 4-D tensor map, and whether a tensor must first be copied.
"""

import pytest
import torch

from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa

B, S, H, D = 2, 300, 4, 128


def _fused(extra: int, start: int = 0):
    """q, k, v as views of one fused projection ``[B, S, 3*H*D + extra]``."""
    fused = torch.zeros((B, S, 3 * H * D + extra), dtype=torch.bfloat16)
    return fused[..., start:start + 3 * H * D].unflatten(-1, (3, H, D)).unbind(2)


@pytest.mark.parametrize("layout,byte_strides,needs_copy", [
    ("contiguous", (2 * D, 2 * H * D, 2 * S * H * D), False),
    ("qkv", (2 * D, 2 * 3 * H * D, 2 * S * 3 * H * D), False),  # the double blocks' fused qkv
    ("linear1", (2 * D, 2 * (3 * H * D + 4 * 3072), 2 * S * (3 * H * D + 4 * 3072)), False),
    ("unaligned_base", None, True),  # 2 bytes past a 16-byte boundary
    ("unaligned_stride", None, True),  # sequence stride of 3*H*D + 1 elements
    ("strided_d", None, True),  # D not contiguous
])
def test_tma_plan(layout, byte_strides, needs_copy):
    if layout == "contiguous":
        x = torch.zeros((B, S, H, D), dtype=torch.bfloat16)
    elif layout == "qkv":
        x = _fused(0)[1]
    elif layout == "linear1":
        x = _fused(4 * 3072)[2]
    elif layout == "unaligned_base":
        x = torch.zeros(B * S * H * D + 1, dtype=torch.bfloat16)[1:].view(B, S, H, D)
    elif layout == "unaligned_stride":
        x = _fused(1)[0]
    else:
        x = torch.zeros((B, S, H, 2 * D), dtype=torch.bfloat16)[..., ::2]
    dims, strides, copy = fa._tma_plan(x)
    assert dims == (D, H, S, B)  # innermost first: the sequence is a dimension of its own
    assert copy == needs_copy
    if byte_strides is not None:
        assert strides == byte_strides


def test_tma_plan_ignores_the_stride_of_an_extent_one_dim():
    """A batch of 1 sliced out of a larger tensor keeps that tensor's batch
    stride; TMA never steps over it, so the plan takes the contiguous one."""
    x = torch.zeros((3, S, H, D), dtype=torch.bfloat16)[1:2]
    x = x.as_strided(x.shape, (7, H * D, D, 1), x.storage_offset())  # a batch stride TMA would refuse
    dims, strides, copy = fa._tma_plan(x)
    assert (dims, strides, copy) == ((D, H, S, 1), (2 * D, 2 * H * D, 2 * S * H * D), False)


@pytest.mark.parametrize("layout,copies", [("qkv", 0), ("unaligned_stride", 3)])
def test_tma_inputs_copy_only_what_tma_cannot_read(layout, copies):
    q, k, v = _fused(0) if layout == "qkv" else _fused(1)
    for i, x in enumerate((q, k, v)):
        x.copy_(torch.full(x.shape, float(i + 1)))
    before = fa.tma_copies
    ready, strides = fa._tma_inputs((q, k, v))
    assert fa.tma_copies == before + copies
    for x, r, st in zip((q, k, v), ready, strides):
        assert torch.equal(x, r) and (r is x) == (copies == 0)
        assert st == (r.stride(0), r.stride(1), r.stride(2))
        assert not fa._tma_plan(r)[2]
