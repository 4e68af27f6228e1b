"""Stone snapping and colour classification — jittable, fixed capacity.

Reproduces closest_index/closest_grid_index (img2sgf.py:448-465),
average_intensity (:468-481) and identify_board (:497-543) with the 361
per-intersection windowed means computed as one vectorized integral-image
gather (SURVEY §2 C10).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.board import BoardStates


def closest_indices(a, x, n):
    """Vectorized closest_index (img2sgf.py:448-459): for each value in a,
    the index of the nearest element of x[:n] (ascending), ties to the left.
    x is +inf padded beyond n."""
    i = jnp.searchsorted(x, a, side="left")  # == bisect_left
    i = jnp.clip(i, 0, jnp.maximum(n - 1, 0))
    im1 = jnp.clip(i - 1, 0, x.shape[0] - 1)
    left_better = a - x[im1] <= x[i] - a
    out = jnp.where(i == 0, 0, jnp.where(left_better, i - 1, i))
    return jnp.clip(out, 0, jnp.maximum(n - 1, 0))


def integral_image(grey_u8):
    """2-D inclusive prefix sum with a zero row/col prepended, f32.

    Window sums of uint8 data up to 16M pixels stay exact in f32? No —
    prefix values can exceed 2^24. Use int32 accumulation (exact), convert
    the 4-corner difference (always < 2^24 for real windows) to f32."""
    g = grey_u8.astype(jnp.int32)
    s = jnp.cumsum(jnp.cumsum(g, axis=0), axis=1)
    H, W = g.shape
    out = jnp.zeros((H + 1, W + 1), jnp.int32)
    return out.at[1:, 1:].set(s)


def window_means(integral, y0, y1, x0, x1):
    """Mean over half-open [y0:y1, x0:x1] windows (arrays of indices)."""
    a = integral[y1, x1] - integral[y0, x1] - integral[y1, x0] + integral[y0, x0]
    area = jnp.maximum((y1 - y0) * (x1 - x0), 1)
    return a.astype(jnp.float32) / area.astype(jnp.float32)


def intersection_intensities(grey_u8, hc, vc, hsize, vsize, hspace, vspace,
                             board_size: int, hw=None):
    """average_intensity for every board point as one gather (:468-481).

    Returns [board_size, board_size] f32 indexed [i, j] = (column i of
    vcentres, row j of hcentres), like detected_board. hw=(h, w): content
    dims inside a fixed canvas — the window clamp uses them, matching
    native-size bounds (img2sgf.py:472-475).
    """
    H, W = grey_u8.shape
    if hw is not None:
        H, W = hw
    integral = integral_image(grey_u8)
    ii = jnp.arange(board_size)
    x = vc[jnp.clip(ii, 0, vc.shape[0] - 1)]
    y = hc[jnp.clip(ii, 0, hc.shape[0] - 1)]
    x = jnp.where(ii < hsize, x, 0.0)
    y = jnp.where(ii < vsize, y, 0.0)
    xmin = jnp.clip(jnp.round(x - hspace / 2).astype(jnp.int32), 0, W)
    xmax = jnp.clip(jnp.round(x + hspace / 2).astype(jnp.int32), 0, W)
    ymin = jnp.clip(jnp.round(y - vspace / 2).astype(jnp.int32), 0, H)
    ymax = jnp.clip(jnp.round(y + vspace / 2).astype(jnp.int32), 0, H)
    return window_means(
        integral,
        ymin[None, :], ymax[None, :],  # j indexes rows (y)
        xmin[:, None], xmax[:, None],  # i indexes cols (x)
    )


def identify_board(grey_u8, circles_xyr, circles_valid, grid, black_stone_threshold,
                   board_size: int, hw=None):
    """Snap circles to grid points and classify colours (:497-543).

    grid: output dict of validate_grid. Returns dict with detected_board
    ([board_size, board_size] int32 states in the top-left hsize x vsize
    block), intensities, stone mask and counts.
    """
    hc = grid["hcentres_complete"]
    vc = grid["vcentres_complete"]
    hsize, vsize = grid["hsize"], grid["vsize"]

    ci = closest_indices(circles_xyr[:, 0], vc, hsize)
    cj = closest_indices(circles_xyr[:, 1], hc, vsize)
    # stone[i, j] = any valid circle snaps there: one-hot outer-product OR
    # (0/1 operands, integer sums < 2^24: exact at default precision,
    # TF32 included)
    oi = (ci[:, None] == jnp.arange(board_size)[None, :]) & circles_valid[:, None]
    oj = cj[:, None] == jnp.arange(board_size)[None, :]
    stone = (oi.astype(jnp.float32).T @ oj.astype(jnp.float32)) > 0

    inten = intersection_intensities(
        grey_u8, hc, vc, hsize, vsize, grid["hspace"], grid["vspace"], board_size,
        hw=hw,
    )
    black = stone & (inten <= black_stone_threshold)
    white = stone & ~black
    num_black = jnp.sum(black.astype(jnp.int32))
    num_white = jnp.sum(white.astype(jnp.int32))
    detected = jnp.where(
        black, BoardStates.BLACK.value, jnp.where(white, BoardStates.WHITE.value, 0)
    ).astype(jnp.int32)
    # black to play iff #black <= #white (img2sgf.py:529-534)
    side = jnp.where(num_black <= num_white, 1, 2)
    return {
        "detected_board": detected,
        "intensities": inten,
        "stone_mask": stone,
        "num_black": num_black,
        "num_white": num_white,
        "side_to_move": side,
    }
