"""1-D single-linkage clustering of line intercepts.

Replaces sklearn AgglomerativeClustering(linkage='single',
distance_threshold=min_grid_spacing) as used at img2sgf.py:268-292.
Single linkage on 1-D points with a distance cutoff is exactly: sort, then
split wherever the gap between neighbours is >= threshold (sklearn stops
merging at distance >= threshold). Cluster centres are member means,
returned ascending (sklearn's sort at :291).

Jittable with fixed capacity: intercept list capped at max_lines, centres
at max_clusters. Matches the reference's failure mode: fewer than 2 points
-> no clusters (AgglomerativeClustering raises, caught at :273-278).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cluster_1d(values, valid, threshold: float, max_clusters: int):
    """values: [N] f32 (unsorted, padded), valid: [N] bool.

    Returns (centres[max_clusters] f32 ascending, ccount i32). Padded
    centre slots hold +inf.
    """
    n = jnp.sum(valid.astype(jnp.int32))
    big = jnp.float32(jnp.inf)
    v = jnp.where(valid, values, big)
    v = jnp.sort(v)

    idx = jnp.arange(v.shape[0])
    is_valid = idx < n
    prev = jnp.concatenate([v[:1], v[:-1]])
    gap = v - prev
    # new cluster where the gap to the previous valid point is >= threshold
    brk = (gap >= threshold) & is_valid & (idx > 0)
    seg = jnp.cumsum(brk.astype(jnp.int32))
    seg = jnp.where(is_valid, seg, max_clusters)  # park invalid entries

    one_hot = (seg[None, :] == jnp.arange(max_clusters)[:, None]).astype(jnp.float32)
    # HIGHEST: the intercepts are non-integer pixel coordinates up to the
    # image size; a default-precision f32 dot may run in TF32 (10-bit
    # mantissa) on GPUs and move centres by whole pixels
    hi = jax.lax.Precision.HIGHEST
    sums = jnp.matmul(one_hot, jnp.where(is_valid, v, 0.0), precision=hi)
    counts = jnp.matmul(one_hot, is_valid.astype(jnp.float32), precision=hi)
    centres = jnp.where(counts > 0, sums / jnp.maximum(counts, 1.0), big)
    ccount = jnp.sum((counts > 0).astype(jnp.int32))
    # reference behaviour: <2 samples -> clustering fails -> no centres
    ccount = jnp.where(n < 2, 0, ccount)
    centres = jnp.where(n < 2, big, centres)
    return centres, ccount
