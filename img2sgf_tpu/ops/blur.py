"""Gaussian and median blurs matching cv.GaussianBlur / cv.medianBlur.

The reference builds a blur pyramid for circle detection: median and
Gaussian blur at k = 1, 3, 5, 7 with sigma = k (img2sgf.py:169-175).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from .common import border_remap, pad_reflect101, pad_replicate


def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """cv.getGaussianKernel(ksize, sigma) (double path)."""
    if ksize == 1:
        return np.array([1.0])
    half = (ksize - 1) * 0.5
    xs = np.arange(ksize) - half
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_kernel_fixed(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV's bit-exact Q8.8 kernel for 8U images.

    Coefficients are floor(k*256) with the remainder to 256 distributed by
    largest fractional part (verified bit-exact vs cv2 5.0 for k=3,5,7,
    sigma=k — the reference's pyramid, img2sgf.py:175).
    """
    kern = gaussian_kernel1d(ksize, sigma)
    scaled = kern * 256.0
    base = np.floor(scaled).astype(np.int64)
    frac = scaled - base
    rem = int(256 - base.sum())
    for i in np.argsort(-frac, kind="stable")[:rem]:
        base[i] += 1
    return base


def gaussian_blur(img_u8, ksize: int, sigma: float, hw=None):
    """Separable Gaussian on uint8 [..., H, W], BORDER_REFLECT_101,
    bit-exact vs cv.GaussianBlur on 8U (integer Q8.8 kernel, full-precision
    accumulation, final (x + 2^15) >> 16 rounding).

    hw=(h, w): content dims inside a fixed canvas (shape-bucketed mode);
    the border band is rewritten so content results equal native-size ones.
    """
    if ksize == 1:
        return img_u8
    if hw is not None:
        img_u8 = border_remap(img_u8, hw[0], hw[1], "reflect101")
    kq = gaussian_kernel_fixed(ksize, sigma)
    r = ksize // 2
    x = pad_reflect101(img_u8.astype(jnp.int32), r)
    H, W = img_u8.shape[-2], img_u8.shape[-1]
    # rows (keep the vertical padding for the column pass)
    acc = jnp.zeros_like(x[..., :, r : r + W])
    for i in range(ksize):
        acc = acc + int(kq[i]) * x[..., :, i : i + W]
    out = jnp.zeros_like(acc[..., r : r + H, :])
    for i in range(ksize):
        out = out + int(kq[i]) * acc[..., i : i + H, :]
    return ((out + (1 << 15)) >> 16).astype(jnp.uint8)


def _batcher_pairs(n: int):
    """Batcher odd-even mergesort comparator network for n elements."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            j = k % p
            while j <= n - 1 - k:
                for i in range(0, min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
                j += 2 * k
            k //= 2
        p *= 2
    return pairs


def _median_network(n: int):
    """Comparators of the Batcher network pruned to those the MEDIAN
    output depends on (backward dependency sweep): 24/113/319 comparators
    for n = 9/25/49, each verified exact against np.sort on random data."""
    pairs = _batcher_pairs(n)
    needed = {n // 2}
    keep = []
    for (a, b) in reversed(pairs):
        if a in needed or b in needed:
            keep.append((a, b))
            needed.add(a)
            needed.add(b)
    return list(reversed(keep))


def median_blur(img_u8, ksize: int, hw=None):
    """Exact median filter on uint8 [..., H, W], BORDER_REPLICATE.

    Implementation: a compile-time-unrolled min/max comparator network
    over the k*k shifted window planes — Batcher odd-even mergesort
    pruned to the median output (_median_network), pure fused
    elementwise ops (bit-identical to a sort — any correct comparator
    network yields the exact order statistic). Capacity: k in
    {1, 3, 5, 7} like the reference pyramid.
    """
    if ksize == 1:
        return img_u8
    if hw is not None:
        img_u8 = border_remap(img_u8, hw[0], hw[1], "replicate")
    r = ksize // 2
    x = pad_replicate(img_u8, r)
    H, W = img_u8.shape[-2], img_u8.shape[-1]
    planes = [
        x[..., dy : dy + H, dx : dx + W]
        for dy in range(ksize)
        for dx in range(ksize)
    ]
    n = ksize * ksize
    for (a, b) in _median_network(n):
        lo = jnp.minimum(planes[a], planes[b])
        hi = jnp.maximum(planes[a], planes[b])
        planes[a], planes[b] = lo, hi
    return planes[n // 2]


def blur_pyramid(grey_u8, edges_u8, maxblur: int = 3, hw=None):
    """The reference's 2 + 2*(maxblur+1) circle-detection variants
    (img2sgf.py:171-175): [grey, edges, median_1, gauss_1, median_3,
    gauss_3, ...]. Returns a [V, H, W] uint8 stack."""
    variants = [grey_u8, edges_u8]
    for i in range(maxblur + 1):
        b = 2 * i + 1
        variants.append(median_blur(grey_u8, b, hw=hw))
        variants.append(gaussian_blur(grey_u8, b, float(b), hw=hw))
    return jnp.stack(variants, axis=0)
