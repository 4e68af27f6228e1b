"""Canny edge detection, OpenCV-parity.

Reproduces cv.Canny(img, low, high, apertureSize=3, L2gradient=...) as used
at img2sgf.py:162-165 (on the 3-channel enhanced image) and inside
HoughCircles (single-channel, thresholds (param1/2, param1)).

Design notes:
  - Sobel + magnitude + channel select + sector NMS are pure elementwise /
    shift ops: XLA fuses them into one pass.
  - Hysteresis (8-connected flood from strong seeds through weak candidates)
    is the only iterative part. We alternate segmented row/column fills
    (associative scans, which resolve arbitrarily long straight runs in one
    pass) with a 3x3 dilation step (handles diagonal hops). Grid diagrams
    are dominated by near-straight edges, so convergence is fast; the
    iteration count is bounded and static (cfg.hysteresis_iters).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .common import dilate8, shift2d
from .sobel import sobel3

_TG22 = 13573  # tan(22.5 deg) * 2^15, OpenCV's fixed-point constant


def _nms(mag, dx, dy, low):
    """OpenCV sector-based non-maximum suppression.

    Returns candidate mask: mag > low and local max along quantized gradient
    direction, with OpenCV's exact strict/non-strict neighbour comparisons.
    Out-of-bounds neighbours read as 0 (OpenCV zero-fills its border rows).
    """
    m = mag
    x = jnp.abs(dx)
    y = jnp.abs(dy) * (1 << 15)  # fits int32: |dy| <= 1020 -> 33.4M
    tg22x = x * _TG22
    tg67x = tg22x + ((x + x) * (1 << 15))

    left = shift2d(m, 0, 1)  # value at (y, x-1)
    right = shift2d(m, 0, -1)
    up = shift2d(m, 1, 0)  # value at (y-1, x)
    down = shift2d(m, -1, 0)
    up_left = shift2d(m, 1, 1)
    up_right = shift2d(m, 1, -1)
    down_left = shift2d(m, -1, 1)
    down_right = shift2d(m, -1, -1)

    horiz = y < tg22x
    vert = y > tg67x
    s_neg = (dx ^ dy) < 0  # gradient in the "anti-diagonal" quadrant

    pass_h = (m > left) & (m >= right)
    pass_v = (m > up) & (m >= down)
    # s = -1 when signs differ: neighbours (y-1,x+1) and (y+1,x-1); else
    # (y-1,x-1) and (y+1,x+1). Both comparisons strict (OpenCV canny.cpp).
    pass_d_neg = (m > up_right) & (m > down_left)
    pass_d_pos = (m > up_left) & (m > down_right)
    pass_d = jnp.where(s_neg, pass_d_neg, pass_d_pos)

    local_max = jnp.where(horiz, pass_h, jnp.where(vert, pass_v, pass_d))
    return (m > low) & local_max


def _seg_fill_axis(edge_u8, cand_u8, axis):
    """Propagate `edge` through contiguous `cand` runs along one axis.

    Segmented OR-scan: within a run of candidate pixels, if any pixel is an
    edge, the whole run becomes edge. Runs break wherever cand is 0. The
    (active, gate) pair is packed into one uint8 plane (bit0 = active,
    bit1 = gate) so each scan moves 8x less data than a 2-plane int32 scan.
    """

    def combine(l, r):
        act = (r & 1) | ((r >> 1) & l & 1)
        gate = (l >> 1) & (r >> 1) & 1
        return (act | (gate << 1)).astype(jnp.uint8)

    packed = (edge_u8 | (cand_u8 << 1)).astype(jnp.uint8)
    axis = axis % packed.ndim  # associative_scan requires a non-negative axis
    fwd = jax.lax.associative_scan(combine, packed, axis=axis)
    bwd = jax.lax.associative_scan(combine, packed, axis=axis, reverse=True)
    return (fwd | bwd) & 1


def hysteresis(strong, cand, iters: int):
    """8-connected propagation from strong seeds through candidates.

    Row/column segmented fills resolve arbitrarily long straight runs per
    sweep; the 3x3 dilation handles diagonal hops. Early-exits as soon as a
    sweep changes nothing (fixtures converge in 2-4 sweeps; `iters` bounds
    the pathological worst case).
    """
    cand_u8 = cand.astype(jnp.uint8)
    edge0 = (strong & cand).astype(jnp.uint8)

    def cond(state):
        i, _, changed = state
        return (i < iters) & changed

    def body(state):
        i, edge, _ = state
        new = _seg_fill_axis(edge, cand_u8, axis=-1)
        new = _seg_fill_axis(new, cand_u8, axis=-2)
        new = (dilate8(new) & cand_u8) | new
        changed = jnp.any(new != edge)
        return i + 1, new, changed

    _, edge, _ = jax.lax.while_loop(cond, body, (0, edge0, jnp.bool_(True)))
    return edge.astype(jnp.bool_)


def _seg_fill_axis_packed(act, gate, axis):
    """Bit-parallel segmented OR-fill: `act`/`gate` are uint32 planes whose
    32 bits carry 32 independent images (see hysteresis_pool). Identical
    propagation semantics to _seg_fill_axis, evaluated for all 32 bit-lanes
    at once by plain bitwise ops."""

    def combine(l, r):
        la, lg = l
        ra, rg = r
        return ra | (rg & la), lg & rg

    axis = axis % act.ndim
    fwd, _ = jax.lax.associative_scan(combine, (act, gate), axis=axis)
    bwd, _ = jax.lax.associative_scan(combine, (act, gate), axis=axis,
                                      reverse=True)
    return fwd | bwd


def _dilate8_or(x):
    """Bitwise 8-neighbourhood dilation on packed uint32 planes."""
    out = x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            out = out | shift2d(x, dy, dx)
    return out


def hysteresis_pool(strong, cand, iters: int):
    """hysteresis() over a POOL of [P, H, W] planes, 32 planes per uint32.

    The sweep's primitives (segmented OR-scan, 3x3 dilation, masking) are
    all boolean, so packing 32 planes into the 32 bits of one uint32 plane
    runs them bit-parallel: each scan/shift moves and combines 32 planes
    per vector op. This replaces P per-plane loops with one fixed-point
    loop over ceil(P/32) packed planes — the batch path for every canvas
    bucket. Convergence is the max over the pool
    (the while_loop early-exits when NO plane changes); fixtures converge
    in 2-5 sweeps.

    strong, cand: [P, H, W] bool. Returns [P, H, W] bool.
    """
    P, H, W = strong.shape
    G = -(-P // 32)
    padn = G * 32 - P

    def pack(x):
        if padn:
            x = jnp.concatenate(
                [x, jnp.zeros((padn, H, W), jnp.bool_)], axis=0)
        xs = x.reshape(G, 32, H, W).astype(jnp.uint32)
        out = jnp.zeros((G, H, W), jnp.uint32)
        for b in range(32):
            out = out | (xs[:, b] << jnp.uint32(b))
        return out

    gate = pack(cand)
    edge0 = pack(strong & cand)

    # Sweeps needed grow with the longest diagonal edge run, which
    # propagates about one dilation hop per sweep.
    def cond(state):
        i, _, changed = state
        return (i < iters) & changed

    def body(state):
        i, edge, _ = state
        new = _seg_fill_axis_packed(edge, gate, axis=-1)
        new = _seg_fill_axis_packed(new, gate, axis=-2)
        new = (_dilate8_or(new) & gate) | new
        changed = jnp.any(new != edge)
        return i + 1, new, changed

    _, edge, _ = jax.lax.while_loop(cond, body, (0, edge0, jnp.bool_(True)))
    bits = jnp.arange(32, dtype=jnp.uint32)
    un = (edge[:, None] >> bits[None, :, None, None]) & jnp.uint32(1)
    return un.reshape(G * 32, H, W)[:P].astype(jnp.bool_)


def canny_pool(planes_u8, low: float, high: float, iters: int = 256,
               hw_planes=None):
    """cv.Canny over a POOL of [P, H, W] single-channel planes, sharing one
    bit-packed hysteresis fixed-point loop (hysteresis_pool) instead of P
    per-plane sweeps. Bit-identical to canny() per plane (pinned test).

    This is the HoughCircles-internal Canny for the batched pipeline
    (thresholds (param1/2, param1), L1 gradient, img2sgf.py:180 semantics
    via cv2's HoughCircles). hw_planes: (hs, ws) per-plane content dims
    inside a fixed canvas. Returns [P, H, W] uint8 {0, 255}.
    """

    def pre(img_u8, hw):
        if hw is not None:
            from .common import border_remap, region_mask

            img_u8 = border_remap(img_u8, hw[0], hw[1], "replicate")
        img = img_u8.astype(jnp.int32)
        dx, dy = sobel3(img)
        mag = jnp.abs(dx) + jnp.abs(dy)
        if hw is not None:
            from .common import region_mask

            mag = mag * region_mask(mag.shape, hw[0], hw[1], jnp.int32)
        cand = _nms(mag, dx, dy, int(low))
        strong = cand & (mag > int(high))
        return strong, cand

    if hw_planes is None:
        strong, cand = jax.vmap(lambda p: pre(p, None))(planes_u8)
    else:
        strong, cand = jax.vmap(
            lambda p, h, w: pre(p, (h, w)))(planes_u8, *hw_planes)
    edges = hysteresis_pool(strong, cand, iters)
    return edges.astype(jnp.uint8) * jnp.uint8(255)


def _canny_pre(img_u8, low: float, high: float, l2gradient: bool, hw):
    """Everything before hysteresis: Sobel (per-channel max on colour),
    NMS, thresholds. Returns (strong, cand) bool planes. Shared by canny()
    and the batched canny_rgb_pool()."""
    if hw is not None:
        from .common import border_remap, region_mask

        img_u8 = border_remap(
            img_u8 if img_u8.ndim == 2 else jnp.moveaxis(img_u8, -1, 0),
            hw[0], hw[1], "replicate",
        )
        if img_u8.ndim == 3:
            img_u8 = jnp.moveaxis(img_u8, 0, -1)
    img = img_u8.astype(jnp.int32)
    if img.ndim == 3:
        # per-channel Sobel, then per-pixel pick the channel with max
        # magnitude (first channel wins ties, like OpenCV's strict >)
        chans = jnp.moveaxis(img, -1, 0)  # [C, H, W]
        dx, dy = sobel3(chans)
        if l2gradient:
            cmag = dx * dx + dy * dy
        else:
            cmag = jnp.abs(dx) + jnp.abs(dy)
        mag = cmag[0]
        dxs, dys = dx[0], dy[0]
        for c in range(1, cmag.shape[0]):
            better = cmag[c] > mag
            mag = jnp.where(better, cmag[c], mag)
            dxs = jnp.where(better, dx[c], dxs)
            dys = jnp.where(better, dy[c], dys)
        dx, dy = dxs, dys
    else:
        dx, dy = sobel3(img)
        mag = (dx * dx + dy * dy) if l2gradient else (jnp.abs(dx) + jnp.abs(dy))

    if l2gradient:
        low_t, high_t = int(low) * int(low), int(high) * int(high)
    else:
        low_t, high_t = int(low), int(high)

    if hw is not None:
        from .common import region_mask

        mag = mag * region_mask(mag.shape, hw[0], hw[1], jnp.int32)

    cand = _nms(mag, dx, dy, low_t)
    strong = cand & (mag > high_t)
    return strong, cand


def canny(img_u8, low: float, high: float, l2gradient: bool = False,
          iters: int = 256, hw=None):
    """cv.Canny parity on a [H, W] or [H, W, C] uint8 image. Returns uint8
    {0, 255} edge map.

    hw=(h, w): content dims inside a fixed canvas (shape-bucketed mode).
    The canvas border band is rewritten with replicate semantics so Sobel
    matches native-size results inside the content block, and magnitudes
    outside it are zeroed (OpenCV's zero border) before NMS/hysteresis, so
    no edges exist or propagate outside the content block.
    """
    strong, cand = _canny_pre(img_u8, low, high, l2gradient, hw)
    edges = hysteresis(strong, cand, iters)
    return (edges.astype(jnp.uint8)) * jnp.uint8(255)


def canny_rgb_pool(imgs_u8, low: float, high: float,
                   l2gradient: bool = False, iters: int = 256,
                   hw_batch=None):
    """cv.Canny over a BATCH of [B, H, W, 3] images, sharing one
    bit-packed hysteresis fixed-point loop (hysteresis_pool). This is the
    batched pipeline's outer Canny (img2sgf.py:162-165 semantics):
    per-image gradient/NMS work is vmapped, the iterative hysteresis runs
    once for the whole batch. Bit-identical to canny() per image.

    hw_batch: (hs, ws) per-image content dims. Returns [B, H, W] uint8.
    """
    if hw_batch is None:
        strong, cand = jax.vmap(
            lambda im: _canny_pre(im, low, high, l2gradient, None))(imgs_u8)
    else:
        strong, cand = jax.vmap(
            lambda im, h, w: _canny_pre(im, low, high, l2gradient, (h, w))
        )(imgs_u8, *hw_batch)
    edges = hysteresis_pool(strong, cand, iters)
    return edges.astype(jnp.uint8) * jnp.uint8(255)
