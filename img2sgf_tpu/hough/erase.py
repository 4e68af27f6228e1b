"""Circle erasure: blank each circle's bounding box, repaint a centre dot.

Reproduces img2sgf.py:188-198: for every detected circle, a filled black
rectangle over the bounding box grown by 2 px (inclusive corners, like
cv.rectangle), then a filled radius-1 circle (a 5-pixel diamond, verified
against cv.circle) in white at the rounded centre.

The reference paints rect-then-dot per circle IN ORDER, so a later
circle's black box overpaints earlier circles' white dots. That layering
matters: on dense scans dozens of dots land inside later boxes, and
keeping them white seeds junk Hough lines (ex17's grid rejection). Order
is restored without a sequential loop: a dot pixel stays white iff no
LATER valid circle's box covers it — a [C, 5, C] pairwise interval test
reduced over the later axis. Boxes are order-free (black on black) and
dots are order-free among themselves (white on white).

The union of all boxes is computed as an outer-product OR —
rows[H, C] @ cols[C, W] — and the surviving dots as a second rank-C
outer product. No scatter, no loops.
"""

from __future__ import annotations

import jax.numpy as jnp


def erase_circles(edges_u8, circles_xyr, valid, hw=None):
    """edges_u8: [H, W] uint8; circles_xyr: [C, 3] (cx, cy, r); valid: [C].

    Returns uint8 [H, W]. hw=(h, w): content dims inside a fixed canvas —
    painting is clipped to the content block like cv.rectangle/cv.circle
    clip to the image.
    """
    H, W = edges_u8.shape
    xc, yc, r = circles_xyr[:, 0], circles_xyr[:, 1], circles_xyr[:, 2]
    r = r + 2.0  # circle edges stick out past the bbox (img2sgf.py:193)
    x0 = jnp.round(xc - r)
    x1 = jnp.round(xc + r)
    y0 = jnp.round(yc - r)
    y1 = jnp.round(yc + r)

    ys = jnp.arange(H, dtype=jnp.float32)
    xs = jnp.arange(W, dtype=jnp.float32)
    rows = (
        (ys[None, :] >= y0[:, None]) & (ys[None, :] <= y1[:, None]) & valid[:, None]
    ).astype(jnp.float32)  # [C, H]
    cols = (
        (xs[None, :] >= x0[:, None]) & (xs[None, :] <= x1[:, None])
    ).astype(jnp.float32)  # [C, W]
    # 0/1 operands, integer sums <= C < 2^24: exact at any matmul
    # precision (TF32 included), so the default precision is kept
    boxed = (rows.T @ cols) > 0  # [H, W]

    # centre dots: 5-px diamond at (round(xc), round(yc)). A dot pixel
    # survives iff no LATER circle's box covers it (reference paints
    # rect-then-dot per circle in list order, img2sgf.py:191-198).
    cxi = jnp.round(xc)
    cyi = jnp.round(yc)
    offs = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))
    dy = jnp.asarray([o[0] for o in offs], jnp.float32)
    dx = jnp.asarray([o[1] for o in offs], jnp.float32)
    py = cyi[:, None] + dy[None, :]  # [C, 5]
    px = cxi[:, None] + dx[None, :]
    idx = jnp.arange(valid.shape[0])
    later = valid[None, None, :] & (idx[None, None, :] > idx[:, None, None])
    covered = jnp.any(
        later
        & (py[:, :, None] >= y0[None, None, :])
        & (py[:, :, None] <= y1[None, None, :])
        & (px[:, :, None] >= x0[None, None, :])
        & (px[:, :, None] <= x1[None, None, :]),
        axis=2,
    )  # [C, 5]
    dot_live = valid[:, None] & jnp.logical_not(covered)
    dot = jnp.zeros((H, W), jnp.bool_)
    for k, (oy, ox) in enumerate(offs):
        drow = ((ys[None, :] == (cyi[:, None] + oy)) & dot_live[:, k : k + 1]).astype(jnp.float32)
        dcol = (xs[None, :] == (cxi[:, None] + ox)).astype(jnp.float32)
        # 0/1 outer product: exact at default precision, as above
        dot = dot | ((drow.T @ dcol) > 0)

    out = jnp.where(boxed, jnp.uint8(0), edges_u8)
    out = jnp.where(dot, jnp.uint8(255), out)
    if hw is not None:
        from ..ops.common import region_mask

        out = out * region_mask((H, W), hw[0], hw[1], jnp.uint8)
    return out
