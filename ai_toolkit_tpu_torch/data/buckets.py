"""Aspect-ratio bucketing (the port's copy of ``ai_toolkit_tpu/data/buckets.py``).

Behavior-compatible with the reference's pixel-budget algorithm
(``toolkit/buckets.py:17-48``): scale the image so its pixel
count hits ``min(native, resolution^2)``, snap each side to the model's
divisibility grid, and pick the candidate whose pixel count is closest to the
target without exceeding the budget. A finite bucket grid = a finite set of
latent shapes.
"""

from __future__ import annotations

import math


def get_bucket_for_image_size(
    width: int, height: int, resolution: int = 512, divisibility: int = 8
) -> tuple[int, int]:
    """Returns (bucket_width, bucket_height).

    Both sides are scaled by sqrt(budget/native) so the aspect ratio is
    preserved, then each side snaps independently down or up to the grid;
    of the grid corners that stay within the pixel budget, the one closest
    to the target wins (ties by the candidate ordering: both-floored first).
    """
    budget = min(width * height, resolution * resolution)
    s = math.sqrt(budget / (width * height))

    def snapped(side: float) -> tuple[int, int]:
        cells = side * s / divisibility
        return math.floor(cells) * divisibility, math.ceil(cells) * divisibility

    w_lo, w_hi = snapped(width)
    h_lo, h_hi = snapped(height)
    corners = [(w_lo, h_lo), (w_lo, h_hi), (w_hi, h_lo), (w_hi, h_hi)]
    in_budget = [wh for wh in corners if wh[0] > 0 and wh[1] > 0
                 and wh[0] * wh[1] <= budget]
    if not in_budget:  # degenerate thin images: clamp to one grid cell
        in_budget = [(max(divisibility, w_lo), max(divisibility, h_lo))]
    return min(in_budget, key=lambda wh: budget - wh[0] * wh[1])


def resize_and_crop_size(
    src_w: int, src_h: int, bucket_w: int, bucket_h: int
) -> tuple[int, int, int, int]:
    """Cover-resize dims + centered crop offsets: (resize_w, resize_h, x0, y0)."""
    scale = max(bucket_w / src_w, bucket_h / src_h)
    rw, rh = max(bucket_w, math.ceil(src_w * scale)), max(bucket_h, math.ceil(src_h * scale))
    x0 = (rw - bucket_w) // 2
    y0 = (rh - bucket_h) // 2
    return rw, rh, x0, y0
