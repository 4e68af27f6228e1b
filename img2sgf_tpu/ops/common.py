"""Shared small helpers for image ops (shifts, padding, windows)."""

from __future__ import annotations

import jax.numpy as jnp


def shift2d(x, dy: int, dx: int, fill=0):
    """Shift a [..., H, W] array by (dy, dx), filling vacated cells.

    shift2d(x, 1, 0)[y] == x[y-1]: contents move DOWN/RIGHT for positive
    offsets, i.e. out[y, x] = in[y-dy, x-dx].
    """
    H, W = x.shape[-2], x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 2) + [
        (max(dy, 0), max(-dy, 0)),
        (max(dx, 0), max(-dx, 0)),
    ]
    xp = jnp.pad(x, pad, constant_values=fill)
    ys = slice(max(-dy, 0), max(-dy, 0) + H)
    xs = slice(max(-dx, 0), max(-dx, 0) + W)
    return xp[..., ys, xs]


def pad_replicate(x, n: int):
    """Replicate-pad the trailing two dims by n (OpenCV BORDER_REPLICATE)."""
    pad = [(0, 0)] * (x.ndim - 2) + [(n, n), (n, n)]
    return jnp.pad(x, pad, mode="edge")


def pad_reflect101(x, n: int):
    """Reflect-101 pad (OpenCV BORDER_REFLECT_101 / BORDER_DEFAULT)."""
    pad = [(0, 0)] * (x.ndim - 2) + [(n, n), (n, n)]
    return jnp.pad(x, pad, mode="reflect")


def border_remap(x, h, w, mode: str):
    """Emulate an op's virtual border inside a fixed-size canvas.

    x: [..., Hb, Wb] canvas whose top-left [h, w] block is real content
    (h, w may be traced scalars). Rewrites the padding band so that any
    local op reading <= (Hb - h) px past the content edge sees exactly what
    OpenCV's border mode would supply at native size: 'replicate'
    (BORDER_REPLICATE) or 'reflect101' (BORDER_REFLECT_101). Content cells
    are returned unchanged. Two 1-D gathers.
    """
    H, W = x.shape[-2], x.shape[-1]
    iy = jnp.arange(H)
    ix = jnp.arange(W)
    if mode == "replicate":
        ry = jnp.minimum(iy, h - 1)
        rx = jnp.minimum(ix, w - 1)
    elif mode == "reflect101":
        ry = jnp.clip(jnp.where(iy < h, iy, 2 * h - 2 - iy), 0, h - 1)
        rx = jnp.clip(jnp.where(ix < w, ix, 2 * w - 2 - ix), 0, w - 1)
    else:  # pragma: no cover
        raise ValueError(mode)
    return jnp.take(jnp.take(x, ry, axis=-2), rx, axis=-1)


def region_mask(shape2d, h, w, dtype=jnp.bool_):
    """[Hb, Wb] mask of the real-content block (h, w traced ok)."""
    import jax

    ys = jax.lax.broadcasted_iota(jnp.int32, shape2d, 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, shape2d, 1)
    return ((ys < h) & (xs < w)).astype(dtype)


def dilate8(x):
    """3x3 max-pool (8-neighbourhood dilation) on [..., H, W]."""
    out = x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            out = jnp.maximum(out, shift2d(x, dy, dx))
    return out
