"""Hough line transform restricted to near-horizontal/vertical windows.

Reproduces cv.HoughLines(rho=1, theta=pi/180, threshold, min_theta,
max_theta) as called by the reference (img2sgf.py:230-255): the horizontal
window spans theta in [90-d, 90+d] degrees and the vertical window is the
union of [0, d] and [180-d, 180], after which the second window's rho is
negated and theta shifted by -pi (img2sgf.py:245-247).

Design (no scatter, no data-dependent shapes):
  The (rho, theta) vote accumulator has a STATIC structure: the bin index
  of pixel (x, y) at angle t is rint(x*cos t + y*sin t) + (numrho-1)//2,
  data-independent. For near-axis angles the bin splits as
  base[row] + k(row, col) with k in a tiny static range K (~W*sin(1 deg)).
  So per angle:
    1. K masked row-reductions give rowcount[row, k]  (fused)
    2. a prefix-sum over rows + static gathers at searchsorted(base)
       boundaries give counts2[rho_base, k]           (no scatter)
    3. K shifted adds fold k into the final acc[rho]
  Accumulator peaks then go through OpenCV's exact 4-neighbour NMS over
  (rho, theta) with its strict/non-strict comparison pattern.

cvRound (round-half-to-even) and OpenCV's float32 trig tables are
reproduced exactly in the static tables.
"""

from __future__ import annotations

import functools
import math

import jax.numpy as jnp
import numpy as np


def window_angles(min_theta: float, max_theta: float, step: float = math.pi / 180.0):
    """cv2 5.x computeNumangle: floor((max-min)/step) + 1 angles from min."""
    numangle = int(math.floor((max_theta - min_theta) / step + 1e-9)) + 1
    return [min_theta + n * step for n in range(numangle)]


@functools.lru_cache(maxsize=64)
def _angle_tables(H: int, W: int, angle: float):
    """Static vote-index decomposition for one angle on an HxW image.

    Returns (transpose, flip, base[T], kmat[T,U], K, lo[NR], hi[NR], numrho):
    vote bin of pixel (t, u) = base[t] + kmat[t, u], with `base` ascending
    (after optional axis flip) so bin boundaries are static searchsorted
    gathers. `transpose` means t runs over columns (near-vertical angles).
    """
    numrho = int(round((W + H) * 2 + 1))
    tab_cos = np.float32(math.cos(angle))
    tab_sin = np.float32(math.sin(angle))
    xs = np.arange(W, dtype=np.float32)
    ys = np.arange(H, dtype=np.float32)
    # OpenCV: cvRound(j*tabCos[n] + i*tabSin[n]) in float32 arithmetic
    B = np.rint(xs[None, :] * tab_cos + ys[:, None] * tab_sin).astype(np.int64)
    B += (numrho - 1) // 2
    transpose = abs(tab_cos) > abs(tab_sin)
    Bt = B.T if transpose else B
    base = Bt.min(axis=1)
    flip = bool(base[-1] < base[0])
    if flip:
        Bt = Bt[::-1]
        base = base[::-1]
    kmat = (Bt - base[:, None]).astype(np.int32)
    K = int(kmat.max()) + 1
    rhos = np.arange(numrho)
    lo = np.searchsorted(base, rhos, side="left").astype(np.int32)
    hi = np.searchsorted(base, rhos, side="right").astype(np.int32)
    return transpose, flip, kmat, K, lo, hi, numrho


def _accumulate_angle(edge_f32, H: int, W: int, angle: float):
    """Vote accumulator column for one angle: returns acc[numrho] f32."""
    transpose, flip, kmat, K, lo, hi, numrho = _angle_tables(H, W, angle)
    e = edge_f32.T if transpose else edge_f32
    if flip:
        e = e[::-1]
    kj = jnp.asarray(kmat)
    # rowcount[t, k]: edge pixels of row t whose bin offset is k
    rowcount = jnp.stack(
        [jnp.sum(e * (kj == kk), axis=1) for kk in range(K)], axis=1
    )
    S = jnp.concatenate(
        [jnp.zeros((1, K), rowcount.dtype), jnp.cumsum(rowcount, axis=0)], axis=0
    )
    counts2 = S[jnp.asarray(hi)] - S[jnp.asarray(lo)]  # [numrho, K]
    acc = jnp.zeros((numrho,), edge_f32.dtype)
    for kk in range(K):
        col = counts2[:, kk]
        if kk == 0:
            acc = acc + col
        else:
            # vote bin = base + kk: shift column down by kk
            acc = acc + jnp.concatenate([jnp.zeros((kk,), col.dtype), col[:-kk]])
    return acc


def hough_window_accumulator(edges_u8, angles):
    """Full [A, numrho] accumulator for a tuple of angles."""
    H, W = edges_u8.shape
    e = (edges_u8 > 0).astype(jnp.float32)
    cols = [_accumulate_angle(e, H, W, a) for a in angles]
    return jnp.stack(cols, axis=0)


def local_maxima(acc, threshold: float):
    """OpenCV findLocalMaximums: vote > threshold, > left-rho, >= right-rho,
    > prev-angle, >= next-angle (zero-padded borders)."""
    z = jnp.zeros((1, acc.shape[1]), acc.dtype)
    up = jnp.concatenate([z, acc[:-1]], axis=0)
    down = jnp.concatenate([acc[1:], z], axis=0)
    zc = jnp.zeros((acc.shape[0], 1), acc.dtype)
    left = jnp.concatenate([zc, acc[:, :-1]], axis=1)
    right = jnp.concatenate([acc[:, 1:], zc], axis=1)
    return (
        (acc > threshold)
        & (acc > left)
        & (acc >= right)
        & (acc > up)
        & (acc >= down)
    )


def _compact(values, mask, cap: int):
    """Select masked values into a fixed-capacity prefix, order-preserving."""
    flat_v = values.reshape(-1)
    flat_m = mask.reshape(-1)
    order = jnp.argsort(jnp.logical_not(flat_m), stable=True)
    take = order[:cap]
    return flat_v[take], flat_m[take], jnp.sum(flat_m.astype(jnp.int32))


def hough_lines_intercepts(edges_u8, threshold: float, horizontal: bool,
                           angle_delta: float, max_lines: int):
    """Line intercepts for one direction, matching find_lines
    (img2sgf.py:230-255).

    Returns (rho_values[max_lines] f32, valid[max_lines] bool, count i32).
    For the vertical direction the second window's rho is negated, matching
    the reference's transform; intercepts are x- (vertical) or y-
    (horizontal) axis crossings.
    """
    if horizontal:
        angles = window_angles(math.pi / 2 - angle_delta, math.pi / 2 + angle_delta)
        acc = hough_window_accumulator(edges_u8, angles)
        mask = local_maxima(acc, threshold)
        numrho = acc.shape[1]
        rho = (
            jnp.arange(numrho, dtype=jnp.float32) - (numrho - 1) * jnp.float32(0.5)
        )[None, :] * jnp.ones((len(angles), 1), jnp.float32)
        return _compact(rho, mask, max_lines)

    angles1 = window_angles(0.0, angle_delta)
    angles2 = window_angles(math.pi - angle_delta, math.pi)
    acc1 = hough_window_accumulator(edges_u8, angles1)
    acc2 = hough_window_accumulator(edges_u8, angles2)
    m1 = local_maxima(acc1, threshold)
    m2 = local_maxima(acc2, threshold)
    numrho = acc1.shape[1]
    rho_base = jnp.arange(numrho, dtype=jnp.float32) - (numrho - 1) * jnp.float32(0.5)
    rho1 = rho_base[None, :] * jnp.ones((len(angles1), 1), jnp.float32)
    rho2 = -rho_base[None, :] * jnp.ones((len(angles2), 1), jnp.float32)
    values = jnp.concatenate([rho1.reshape(-1), rho2.reshape(-1)])
    mask = jnp.concatenate([m1.reshape(-1), m2.reshape(-1)])
    return _compact(values, mask, max_lines)
