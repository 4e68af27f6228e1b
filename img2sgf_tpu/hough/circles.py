"""Hough gradient circle detection (cv.HOUGH_GRADIENT semantics).

Reproduces cv.HoughCircles(img, HOUGH_GRADIENT, dp=1, minDist=10,
param1=100, param2=30, minRadius=1, maxRadius=30) as called at
img2sgf.py:180 for each of the 10 blur-pyramid variants.

OpenCV's algorithm (hough.cpp, HoughCirclesGradient):
  1. Sobel gradients + internal Canny(param1/2, param1) edge map.
  2. Every edge pixel votes along +/- its gradient direction at radii
     minR..maxR into a centre accumulator.
  3. Centre candidates: accumulator 4-neighbour local maxima > param2,
     considered in descending vote order.
  4. Modern (4.x/5.x) selection: a radius is estimated for EVERY centre
     candidate from a 10-bins-per-dr histogram of f32 edge-pixel distances
     (anchored run scan, most-supported run normalized by radius);
     candidates with run support > param2 are sorted by (support desc,
     radius desc, cx asc, cy asc) and accepted greedily with minDist
     spacing. (Empirically reverse-engineered — float-exact against cv2
     5.0 per-variant output on the fixtures; tools/cv_oracle.py.)

Design (static shapes, no scatter):
  - Gradient directions are quantized into D bins over [0, pi). Voting
    becomes, per bin, a sum of the bin's edge-pixel plane shifted along the
    bin direction for every radius — computed with a two-level shift
    cascade (5 + 6 shifted adds instead of 30 per side). All shift offsets
    are static; XLA sees pure pad/slice/add chains. Quantization spreads a
    vote by at most ~r*sin(pi/2D) ~ 1.5 px at D=64, comparable to the
    integer snapping of OpenCV's own fixed-point walk.
  - Candidate extraction is top_k over the masked accumulator (vote-order
    ties break by flat index, matching OpenCV's sort).
  - Radius estimation gathers a (2*maxR+1)^2 window per candidate; every
    pixel's distance bin is static, so the histogram is one matmul
    against a precomputed one-hot, and the anchored run scan is a fixed
    27-iteration masked reduction.
  - The greedy minDist pass is a tiny fori_loop over the support-sorted
    candidates.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.canny import canny
from ..ops.common import shift2d
from ..ops.sobel import sobel3


def _walk_offsets(ux: float, uy: float, min_r: int, max_r: int):
    """Exact OpenCV vote-walk offsets for direction (ux, uy), both ways.

    OpenCV steps x1 = x0*1024 + r*sx with sx = round(1024*ux) and lands on
    cell x1 >> 10 (arithmetic shift = floor). Offsets therefore are
    floor(r*sx/1024) for the + direction and floor(-r*sx/1024) for the -
    direction (not the negation!). Duplicate cells get multiple votes, so
    we return (dy, dx) -> weight.
    """
    sx = round(1024 * ux)
    sy = round(1024 * uy)
    weights: dict[tuple[int, int], int] = {}
    for sign in (1, -1):
        for r in range(min_r, max_r + 1):
            o = (math.floor(sign * r * sy / 1024), math.floor(sign * r * sx / 1024))
            weights[o] = weights.get(o, 0) + 1
    return weights


def _cascade_tables(num_bins: int, min_r: int, max_r: int, seg: int = 5):
    """Static offset tables for the two-level cascade accumulator.

    Radii [min_r, max_r] are split into segments of `seg` consecutive radii
    centred at t_m. Per bin, a partial plane P = sum_j shift(e_d, round(j*u))
    over the centred inner offsets j in [-seg//2, seg//2] is built once and
    reused by BOTH walk directions (inner offsets are odd-symmetric under
    banker's rounding), then sampled at +/-round(t_m*u) per segment.
    Approximation error vs the exact fixed-point walk cell is <= 1 px per
    coordinate — same class as the direction quantization itself.
    """
    n = max_r - min_r + 1
    assert n % seg == 0, "radius span must divide into whole segments"
    half = seg // 2
    inner, outer = [], []
    for d in range(num_bins):
        phi = d * math.pi / num_bins
        ux, uy = math.cos(phi), math.sin(phi)
        inner.append(
            [(int(np.round(j * uy)), int(np.round(j * ux)))
             for j in range(-half, half + 1)]
        )
        outs = []
        for m in range(n // seg):
            t = min_r + half + m * seg
            by, bx = int(np.round(t * uy)), int(np.round(t * ux))
            outs.append((by, bx))
            outs.append((-by, -bx))
        outer.append(outs)
    return inner, outer


def direction_bins(dx, dy, num_bins: int):
    """Gradient direction quantized to [0, num_bins) over [0, pi)."""
    ang = jnp.arctan2(dy.astype(jnp.float32), dx.astype(jnp.float32))
    step = math.pi / num_bins
    return jnp.round(ang / step).astype(jnp.int32) % num_bins


def direction_labels(emask, dx, dy, num_bins: int):
    """Per-pixel vote label: direction bin on edge pixels, the num_bins
    sentinel elsewhere. uint8 (the accumulators' byte packing and the
    fused compare chains both want the narrowest label plane)."""
    assert num_bins < 255
    return jnp.where(emask, direction_bins(dx, dy, num_bins),
                     num_bins).astype(jnp.uint8)


def vote_accumulator_cascade(edge_mask, dx, dy, num_bins: int, min_r: int,
                             max_r: int, group: int | None = None):
    """Approximate centre-vote accumulator via a two-level shift cascade.

    Same role as vote_accumulator stage 1 (candidate proposal; exact votes
    are restored by exact_rescore), at ~18 plane-ops per direction bin
    instead of ~55.
    """
    bins = direction_bins(dx, dy, num_bins)

    H, W = edge_mask.shape
    inner, outer = _cascade_tables(num_bins, min_r, max_r)
    B = max_r  # max |outer offset| coordinate
    pad = B + 3  # + max |inner offset| (<= seg//2 + rounding)
    # int8 labels (num_bins <= 127): the fused per-bin compare chains
    # re-read this plane constantly, so label width is pure HBM traffic
    pk_dtype = jnp.int8 if num_bins <= 127 else jnp.int32
    packed = jnp.where(edge_mask, bins, num_bins).astype(pk_dtype)
    packed = jnp.pad(packed, pad,
                     constant_values=np.asarray(num_bins, pk_dtype))

    # Exact-integer dtype ladder (the shift chains are memory-bound, so
    # narrower is cheaper):
    #   per-bin planes (P, contrib): int8 when contrib <= n_out*seg = 2*n_r
    #     fits (n_r <= 63); the default r in [1,30] span gives 60.
    #   gsum / acc: int16 when the TOTAL vote bound num_bins * 2 * n_r
    #     fits (64 * 60 = 3840 < 2^15 for the default) — then gsum can
    #     carry ANY group width and acc round-trips shrink 2x vs f32.
    #   f32 fallback for wider spans (still exact: votes are integers and
    #     the total stays far below 2^24).
    # GROUP = bins per optimization-barrier step. The barrier bounds
    # liveness (without it the scheduler hoists all num_bins bin planes
    # for ILP and OOMs HBM at batch scale); fewer barrier steps = fewer
    # acc materialisations (HBM round-trips).
    n_r = max_r - min_r + 1
    bin_dtype = jnp.int8 if 2 * n_r <= 127 else jnp.int32
    if num_bins * 2 * n_r <= 32767 and bin_dtype == jnp.int8:
        GROUP, acc_dtype = 8, jnp.int16
    else:
        GROUP, acc_dtype, bin_dtype = 4, jnp.float32, jnp.float32
    if group is not None:
        GROUP = group
    acc = jnp.zeros((H, W), acc_dtype)
    for g in range(0, num_bins, GROUP):
        gsum = None
        for d in range(g, min(g + GROUP, num_bins)):
            # narrow dtype shrinks the HBM traffic of the shift chains;
            # values stay exact per the ladder bounds above (P sums <=
            # seg <= 5 ones)
            e_d = (packed == d).astype(bin_dtype)
            # partial plane over the expanded domain [H+2B, W+2B]
            P = None
            for (jy, jx) in inner[d]:
                t = jax.lax.slice(
                    e_d, (pad - B - jy, pad - B - jx),
                    (pad - B - jy + H + 2 * B, pad - B - jx + W + 2 * B),
                )
                P = t if P is None else P + t
            contrib = None
            for (by, bx) in outer[d]:
                t = jax.lax.slice(P, (B - by, B - bx), (B - by + H, B - bx + W))
                contrib = t if contrib is None else contrib + t
            # per-bin planes stay in bin_dtype (contrib <= 2*n_r); gsum
            # widens to the acc dtype, whose ladder bound covers any GROUP
            contrib = contrib.astype(acc_dtype)
            gsum = contrib if gsum is None else gsum + contrib
        # serialise per-group schedules to bound liveness (see above)
        acc, packed = jax.lax.optimization_barrier((acc + gsum, packed))
    return acc.astype(jnp.float32)


def vote_accumulator_packed4(labels4, num_bins: int, min_r: int, max_r: int):
    """Cascade accumulator for FOUR planes at once, one byte each inside a
    uint32 element.

    All shift offsets are plane-independent, so packing 4 planes into the
    4 bytes of one uint32 moves 4 planes per vector op at identical
    memory bytes — ~4x fewer instructions than the per-plane cascade.
    Its cost on the current device is not yet measured against the
    per-plane form.

    Exactness (all integer byte fields, no cross-byte carries):
      * labels <= num_bins <= 0x7E, so no byte has bit 7 set and the
        per-byte equality test below is exact;
      * e4 bytes in {0, 1}; inner sums <= seg = 5; per-bin contrib
        <= 2 * n_r; 4-bin group sums <= 8 * n_r <= 255 (caller-checked).
    Bit-equality vs 4 single-plane cascades is pinned by
    tests/test_circles_exact.py::test_packed4_pool_accumulator_bit_exact.

    labels4: [4, H, W] uint8 from direction_labels. Returns [4, H, W] f32.
    """
    assert labels4.shape[0] == 4 and labels4.dtype == jnp.uint8
    n_r = max_r - min_r + 1
    assert n_r % 5 == 0 and num_bins <= 0x7E and 8 * n_r <= 255
    _, H, W = labels4.shape
    lbl4 = (
        labels4[0].astype(jnp.uint32)
        | (labels4[1].astype(jnp.uint32) << 8)
        | (labels4[2].astype(jnp.uint32) << 16)
        | (labels4[3].astype(jnp.uint32) << 24)
    )

    inner, outer = _cascade_tables(num_bins, min_r, max_r)
    B = max_r
    pad = B + 3
    lbl4 = jnp.pad(lbl4, pad,
                   constant_values=np.uint32(num_bins * 0x01010101))

    SEV = jnp.uint32(0x7F7F7F7F)
    ONES = jnp.uint32(0x01010101)
    acc = jnp.zeros((4, H, W), jnp.int16)
    GROUP = 4  # bins per barrier step; byte bound GROUP * 2 * n_r <= 255
    for g in range(0, num_bins, GROUP):
        gsum = None  # packed 4-bin partial, fields <= GROUP * 2 * n_r
        for d in range(g, min(g + GROUP, num_bins)):
            # per-byte equality, exact (no byte has bit 7 set):
            # byte == d  <=>  (lbl ^ d) == 0  <=>  bit7 of ((lbl^d)+0x7F)
            # is clear
            v = lbl4 ^ jnp.uint32(d * 0x01010101)
            e4 = (jnp.bitwise_not(v + SEV) >> 7) & ONES
            P = None
            for (jy, jx) in inner[d]:
                t = jax.lax.slice(
                    e4, (pad - B - jy, pad - B - jx),
                    (pad - B - jy + H + 2 * B, pad - B - jx + W + 2 * B),
                )
                P = t if P is None else P + t
            contrib = None
            for (by, bx) in outer[d]:
                t = jax.lax.slice(P, (B - by, B - bx), (B - by + H, B - bx + W))
                contrib = t if contrib is None else contrib + t
            gsum = contrib if gsum is None else gsum + contrib
        planes = [((gsum >> (8 * i)) & jnp.uint32(0xFF)).astype(jnp.int16)
                  for i in range(4)]
        acc, lbl4 = jax.lax.optimization_barrier(
            (acc + jnp.stack(planes), lbl4))
    return acc.astype(jnp.float32)


def vote_accumulator_pool(emask, dx, dy, num_bins: int, min_r: int,
                          max_r: int):
    """Accumulators for a POOL of [P, H, W] planes.

    Uses the byte-packed 4-planes-per-uint32 cascade when the exact byte
    bounds hold (the pipeline defaults), padding the pool to a multiple
    of 4 with dead planes; falls back to the per-plane accumulator
    otherwise. Bit-identical to vmapping vote_accumulator either way.
    """
    if not cascade_pool_eligible(num_bins, min_r, max_r):
        return jax.vmap(
            lambda e, a, b: vote_accumulator(e, a, b, num_bins, min_r, max_r)
        )(emask, dx, dy)
    lbl = direction_labels(emask, dx, dy, num_bins)
    return vote_accumulator_pool_labels(lbl, num_bins, min_r, max_r)


def vote_accumulator_pool_labels(lbl, num_bins: int, min_r: int, max_r: int):
    """Byte-packed pooled accumulator from [P, H, W] uint8 label planes
    (direction_labels). Caller must hold cascade_pool_eligible."""
    P, H, W = lbl.shape
    padn = (-P) % 4
    if padn:
        lbl = jnp.concatenate(
            [lbl, jnp.full((padn, H, W), num_bins, jnp.uint8)])
    G = (P + padn) // 4
    # outer chunks bound compile size, the inner map serialises the
    # packed kernels (bounds live intermediates)
    CG = 4 if G % 4 == 0 else (2 if G % 2 == 0 else 1)
    acc = jax.lax.map(
        lambda t: jax.lax.map(
            lambda q: vote_accumulator_packed4(q, num_bins, min_r, max_r), t
        ),
        lbl.reshape(G // CG, CG, 4, H, W),
    )
    return acc.reshape(-1, H, W)[:P]


def vote_accumulator(edge_mask, dx, dy, num_bins: int, min_r: int, max_r: int):
    """Centre-vote accumulator A[H, W] (f32).

    edge_mask: [H, W] bool (Canny edges with nonzero gradient).
    dx, dy: int32 Sobel gradients.
    """
    # the cascade only feeds the (already approximate) proposal stage; the
    # exact per-offset chain below remains for radius spans that don't
    # divide into segments.
    if (max_r - min_r + 1) % 5 == 0:
        return vote_accumulator_cascade(edge_mask, dx, dy, num_bins, min_r, max_r)

    bins = direction_bins(dx, dy, num_bins)
    step = math.pi / num_bins

    # Per bin: one fused kernel of static shifted adds (XLA fuses the
    # unrolled slice chain into a single pass over the bin's edge plane).
    # The optimization barrier each iteration re-issues ALL loop inputs, so
    # bin d+1's edge-plane extraction depends on bin d's accumulate — this
    # serialises the schedule and bounds liveness to ~1 plane. Without it
    # the scheduler hoists all 64 bin planes for ILP and OOMs HBM at batch
    # scale; a fori_loop instead would kill fusion (3840 unfused passes).
    H, W = edge_mask.shape
    pad = max_r
    # pad once; per-bin planes are then pure compare+slice+add chains
    packed = jnp.where(edge_mask, bins, num_bins).astype(jnp.int32)
    packed = jnp.pad(packed, pad, constant_values=num_bins)

    acc = jnp.zeros((H, W), jnp.float32)
    for d in range(num_bins):
        phi = d * step
        e_d = (packed == d).astype(jnp.float32)
        contrib = None
        for (oy, ox), w in _walk_offsets(math.cos(phi), math.sin(phi), min_r, max_r).items():
            t = jax.lax.slice(
                e_d, (pad - oy, pad - ox), (pad - oy + H, pad - ox + W)
            )
            t = t * float(w) if w != 1 else t
            contrib = t if contrib is None else contrib + t
        acc, packed = jax.lax.optimization_barrier((acc + contrib, packed))
    return acc


_TOPK_SORT_CUTOVER = 4096


def top_k_desc(score, k: int):
    """lax.top_k semantics (descending values, ties to the smaller index)
    with a compile-friendly path for big k.

    TopK lowerings can scale badly with k in compile time (the k=16384
    overflow budget); a full stable argsort + slice compiles quickly and
    its runtime is k-independent, which is fine on the overflow path
    where k is a capacity bound, not a hot-loop size. Small k (the
    base-budget path) keeps lax.top_k.
    """
    if k <= _TOPK_SORT_CUTOVER:
        return jax.lax.top_k(score, k)
    order = jnp.argsort(-score, stable=True)[:k]
    return score[order], order


def top_k_set_by_count(score, k: int, iters: int = 31, via: str = "count"):
    """The SET that lax.top_k(score, k) keeps — scores above a cutoff,
    ties resolved toward smaller index — selected by integer counting
    instead of a sort, and returned in STREAM order with a live prefix.

    Requirements: live scores are positive integers (exact in f32), dead
    rows are exactly -1, and no caller depends on the vote-descending
    ROW ORDER top_k produces — the selection pipeline doesn't
    (circle_finalize re-sorts with a total-order key; every intermediate
    stage is per-row or set-based), it only needs the valid-prefix
    property, which stream compaction provides.

    Cost: an adaptive integer binary search for the cutoff v* (one [N]
    count-reduce per step, while_loop until lo+1 == hi — safe for the
    full positive int32 vote range, unlike the old fixed 16 iterations
    that silently selected ZERO candidates at votes >= 2^16, and
    converging in ~log2(max_vote) ~ 10 steps on real planes), one
    cumsum for the tie ranks, and a _stream_select. Unlike TopK/argsort
    its compile time and runtime are k-independent (the k=16384
    overflow selection rides the same passes). `iters` is retained for
    API compatibility and ignored.

    via="sort": same output, selected with one stable f32 argsort plus a
    [k] index re-sort instead of the counting search. Callers pick:
    the propose stage (full accumulator planes, 10^5 rows x 100+
    vmapped planes) counts, the stream stages (10^4-10^5 rows) sort.
    Which is faster on the current device is not yet measured.

    Returns (votes [k], idx [k], valid [k]): valid is a prefix; rows
    beyond it are clipped fill, votes gathered as-is.
    """
    if via == "sort":
        N = score.shape[0]
        # vote-descending stable argsort = the top_k set with ties to the
        # smaller index; re-sorting the kept indices (dead rows keyed to
        # N so they sink) restores stream order with a valid prefix
        order = jnp.argsort(-score, stable=True)[:k]
        livek = score[order] > 0
        skey = jnp.where(livek, order, N)
        if skey.shape[0] < k:  # inputs shorter than the budget: pad dead
            skey = jnp.concatenate(
                [skey, jnp.full((k - skey.shape[0],), N, skey.dtype)])
        skey = jnp.sort(skey)
        ok = skey < N
        idx = jnp.clip(skey, 0, N - 1)
        return score[idx], idx, ok
    n_above_k = jnp.sum(score > 0) <= k  # cheap common case: nothing cut
    hi0 = jnp.maximum(jnp.max(score), 0.0).astype(jnp.int32)

    def body(lohi):
        lo, hi = lohi
        # invariant: count(> lo) > k, count(> hi) <= k; converge on the
        # smallest v with count(> v) <= k
        mid = (lo + hi) // 2
        over = jnp.sum(score > mid.astype(score.dtype)) > k
        return jnp.where(over, mid, lo), jnp.where(over, hi, mid)

    # adaptive trip count: each step is one [N] count-reduce, and real
    # vote maxima are a few hundred, so converging in ceil(log2(hi0)) ~
    # 10 steps beats any fixed bound that must also cover the full int32
    # range
    lo, hi = jax.lax.while_loop(
        lambda lohi: lohi[0] + 1 < lohi[1],
        body, (jnp.int32(-1), hi0 + 1))
    del iters
    vstar = jnp.where(n_above_k, jnp.int32(-1), hi).astype(score.dtype)
    above = score > vstar
    ties = (score == vstar) & (score > 0)
    n_above = jnp.sum(above, dtype=jnp.int32)
    tie_rank = jnp.cumsum(ties.astype(jnp.int32)) - 1
    sel = above | (ties & (tie_rank < k - n_above))
    idx, ok = _stream_select(sel, k)
    return score[idx], idx, ok


def centre_candidates(acc, acc_threshold: float, top_k: int, hw=None,
                      block: int = 1, with_count: bool = False,
                      margin: float | None = None,
                      select_min: float | None = None):
    """The top_k accumulator local maxima > threshold, as a SET (the same
    rows a vote-descending top_k would keep, ties toward smaller flat
    index) returned in STREAM order with a valid prefix — see
    top_k_set_by_count. Callers must not rely on row order, only on the
    set and the valid-prefix property. (The block > 1 path still returns
    vote-descending rows via top_k_desc.)

    Returns (ys, xs, votes, valid) each [top_k]; with_count appends the
    TOTAL number of qualifying maxima in the plane (before the top_k
    truncation), which callers use for exact saturation detection
    (n > top_k means real maxima were truncated; n == top_k means the
    budget was exactly filled and nothing was lost). margin (requires
    with_count) additionally appends the count of qualifying maxima with
    votes >= margin — see propose_from_acc's margin-gated saturation.
    Border cells excluded (OpenCV scans y, x in [1, size-2]); with
    hw=(h, w) the scan bound is the content block, not the canvas.

    block > 1: keep only the strongest maximum per (block x block) tile
    before ranking. This spends the fixed candidate budget on DISTINCT
    regions: on dense scans thousands of near-duplicate junk maxima
    otherwise crowd real (weaker) circle peaks out of the top_k, and the
    exact-rescore stage recovers any true peak within +-2 of a proposal
    anyway (circle_candidates), so one representative per tile suffices.
    Also shrinks the top_k input by block^2.
    """
    H, W = acc.shape
    h, w = (H, W) if hw is None else hw
    left = shift2d(acc, 0, 1)
    right = shift2d(acc, 0, -1)
    up = shift2d(acc, 1, 0)
    down = shift2d(acc, -1, 0)
    ys_i = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs_i = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    interior = (ys_i >= 1) & (ys_i <= h - 2) & (xs_i >= 1) & (xs_i <= w - 2)
    is_max = (
        (acc > acc_threshold)
        & (acc > left)
        & (acc >= right)
        & (acc > up)
        & (acc >= down)
        & interior
    )
    n_live = jnp.sum(is_max, dtype=jnp.int32)
    counts = (n_live,)
    if margin is not None:
        counts = counts + (jnp.sum(is_max & (acc >= margin), dtype=jnp.int32),)
    if select_min is not None:
        # restrict the SELECTION (not the counts above) to maxima at or
        # above select_min — done inside the score plane so the returned
        # rows keep the valid-prefix property the rescore's dead-chunk
        # skip depends on (a post-hoc valid &= filter would punch holes
        # in the prefix)
        is_max = is_max & (acc >= select_min)
    if block > 1:
        b = block
        Hb, Wb = -(-H // b), -(-W // b)
        s = jnp.full((Hb * b, Wb * b), -1.0, acc.dtype)
        s = s.at[:H, :W].set(jnp.where(is_max, acc, -1.0))
        tiles = s.reshape(Hb, b, Wb, b).transpose(0, 2, 1, 3).reshape(-1, b * b)
        bmax = jnp.max(tiles, axis=1)
        barg = jnp.argmax(tiles, axis=1)  # first max = scan order in tile
        votes, bidx = top_k_desc(bmax, top_k)
        cell = jnp.take(barg, bidx)
        ys = (bidx // Wb) * b + cell // b
        xs = (bidx % Wb) * b + cell % b
        valid = votes > 0
        # blockwise compaction keeps one max per tile, so the relevant
        # live count for saturation is the number of live TILES
        counts = (jnp.sum(bmax > 0, dtype=jnp.int32),)
        if margin is not None:
            counts = counts + (jnp.sum(bmax >= margin, dtype=jnp.int32),)
        out = (jnp.minimum(ys, H - 1), jnp.minimum(xs, W - 1), votes, valid)
        return out + counts if with_count else out
    score = jnp.where(is_max, acc, -1.0).reshape(-1)
    if W % 2 == 0:
        # lossless 2x shrink before the (sort-bound) top_k: two
        # horizontally adjacent cells can never BOTH be maxima (a >= right
        # contradicts b > left), so the max over each in-row [2] pair
        # keeps every candidate. Exactness incl. tie order: within a pair
        # only one cell can be a valid max (the other scores -1), and
        # across pairs top_k's smaller-index tie rule on pair indices
        # equals the flat-index rule. Even W keeps pairs inside one row
        # (a cross-row pair could hold two maxima); odd-W planes take the
        # direct path below.
        pairs = score.reshape(-1, 2)
        pmax = jnp.max(pairs, axis=1)
        votes, pidx, ok = top_k_set_by_count(pmax, top_k)
        left = jnp.take(score, 2 * pidx)
        flat = 2 * pidx + jnp.where(left == votes, 0, 1)
    else:
        votes, flat, ok = top_k_set_by_count(score, top_k)
    valid = ok & (votes > 0)
    out = (flat // W, flat % W, votes, valid)
    return out + counts if with_count else out


def pixel_steps(dx, dy):
    """Per-pixel fixed-point walk steps, exactly OpenCV: sx =
    cvRound(1024*dx/mag) with mag = sqrt(dx^2+dy^2) in float32."""
    fx = dx.astype(jnp.float32)
    fy = dy.astype(jnp.float32)
    mag = jnp.sqrt(fx * fx + fy * fy)
    safe = jnp.maximum(mag, 1e-20)
    sx = jnp.rint(1024.0 * fx / safe).astype(jnp.int32)
    sy = jnp.rint(1024.0 * fy / safe).astype(jnp.int32)
    return sx, sy


def exact_rescore(edge_mask, sx, sy, ys, xs, min_r: int, max_r: int,
                  cells: int = 3, valid=None):
    """Exact OpenCV accumulator votes on a (cells x cells) patch around each
    candidate centre.

    A window pixel p votes for cell c iff for some radius r and sign s,
    floor(r*s*sx_p/1024) == c_x - p_x (same for y) — evaluated with integer
    arithmetic shifts, bit-identical to the reference walk. Returns
    scores [K, cells, cells] f32.
    """
    assert cells in (3, 5), "rescore patch must be 3x3 or 5x5"
    reach = cells // 2
    # pixels up to max_r + reach + ~1.5 away can still land in the patch
    # (floor bias + patch extent), so the gather window is padded by reach+2
    ext = max_r + reach + 2
    win = 2 * ext + 1
    pad = ext + reach
    # pack (edge, sx+1024, sy+1024) into one int32 plane: windows are
    # gathered once instead of three times (gathers dominate this stage)
    packed = (
        edge_mask.astype(jnp.int32)
        | ((sx + 1024) << 1)   # 12-bit field: sx+1024 in [0, 2048]
        | ((sy + 1024) << 13)
    )
    pk = jnp.pad(packed, pad)
    half = reach

    # static per-window-pixel offsets to the candidate cell (p = c + (u-ext))
    uu = np.broadcast_to(np.arange(win)[:, None] - ext, (win, win))
    vv = np.broadcast_to(np.arange(win)[None, :] - ext, (win, win))
    base_oy_np = (-uu).reshape(-1)  # [win*win]
    base_ox_np = (-vv).reshape(-1)
    base_oy = jnp.asarray(base_oy_np, jnp.int32)
    base_ox = jnp.asarray(base_ox_np, jnp.int32)

    # A walk step lands within the patch only if |r*g - b| <= reach + 1.015
    # per coordinate (g = signed unit gradient, b = offset to the candidate,
    # reach + floor bias 1 + fixed-point rounding r*0.5/1024), i.e.
    # |r*g - b|_2 <= L2 = sqrt(2)*(reach + 1.015). Two exact consequences:
    #   * |r - d| <= L2 where d = |b|, so with rhat = round(d) only
    #     k = r - rhat with |k| <= floor(L2 + 0.5) can land
    #     (7 steps at reach 1, 9 at reach 2 — instead of 60);
    #   * the wrong-sign walk (g pointing away from the candidate) requires
    #     d <= L2, so outside the central block of half-width 2*reach
    #     (covers every lattice distance <= L2: max needed is 2.83 <= 2.85
    #     at reach 1, 4.25 <= 4.27 at reach 2) only the toward-the-candidate
    #     sign needs walking. The central block gets a tiny second pass with
    #     the opposite sign.
    # Verified exact against the brute-force 60-step walk in
    # tests/test_circles_exact.py (both patch sizes).
    d_pix = np.sqrt(base_oy_np.astype(np.float64) ** 2 + base_ox_np.astype(np.float64) ** 2)
    rhat = np.round(d_pix).astype(np.int32)
    kmax = int(math.floor(math.sqrt(2.0) * (reach + 1.015) + 0.5))
    ks = range(-kmax, kmax + 1)
    # flat indices of the central block (wrong-sign pass)
    ih = 2 * reach
    inner_flat_np = (
        (np.arange(-ih, ih + 1)[:, None] + ext) * win
        + (np.arange(-ih, ih + 1)[None, :] + ext)
    ).reshape(-1)
    rhat_inner = rhat[inner_flat_np]

    def windows(y, x):
        # padded index (y + half) puts the window at unpadded rows y - ext
        p = jax.lax.dynamic_slice(pk, (y + half, x + half), (win, win)).reshape(-1)
        e = (p & 1).astype(jnp.float32)
        wx = ((p >> 1) & 0xFFF).astype(jnp.float32) - 1024.0
        wy = ((p >> 13) & 0xFFF).astype(jnp.float32) - 1024.0
        # non-edge pixels are packed with sx=sy=0 and e=0, so their walk
        # contributes nothing to the e-weighted scores
        return e, wx, wy

    inv1024 = jnp.float32(1.0 / 1024.0)  # exact power-of-two scale
    base_ox_f = base_ox.astype(jnp.float32)
    base_oy_f = base_oy.astype(jnp.float32)

    n_cells = cells * cells
    PER = 6  # 5-bit count fields per int32 accumulator
    n_acc = -(-n_cells // PER)
    reach_f = float(reach)
    cells_f = float(cells)

    def walk_pass(wxs, wys, rhat_s, box_f, boy_f):
        """Bit-packed patch-cell vote counts for one signed walk over a slot
        subset (5 bits per cell, PER cells per int32 accumulator). The chain
        is purely elementwise, so XLA fuses it into a single pass.

        Field capacity: each field counts k-steps landing on one cell for
        one pixel, <= len(ks) <= 9 < 31. f32 replication of the walk:
        |r*s| <= 30720 < 2^24 is an exact f32 integer and /1024 an exact
        scale, so floor reproduces OpenCV's arithmetic shift bit-exactly
        (incl. toward--inf on negatives).
        """
        accs = [jnp.zeros(wxs.shape, jnp.int32) for _ in range(n_acc)]
        one = jnp.int32(1)
        for k in ks:
            r_raw = rhat_s + k
            r_ok = (r_raw >= min_r) & (r_raw <= max_r)
            rv = jnp.asarray(np.clip(r_raw, min_r, max_r).astype(np.float32))[None, :]
            rmask = jnp.asarray(r_ok)[None, :]
            ddx = jnp.floor(rv * wxs * inv1024) - box_f[None, :]
            ddy = jnp.floor(rv * wys * inv1024) - boy_f[None, :]
            inb = (jnp.abs(ddx) <= reach_f) & (jnp.abs(ddy) <= reach_f) & rmask
            code = ((ddy + reach_f) * cells_f + (ddx + reach_f)).astype(jnp.int32)
            code = jnp.where(inb, code, n_cells)
            for a in range(n_acc):
                lo = a * PER
                sel = (code >= lo) & (code < min(lo + PER, n_cells))
                # clamp the shift amount so out-of-slab codes stay defined
                sh = 5 * jnp.clip(code - lo, 0, PER - 1)
                accs[a] = accs[a] + jnp.where(sel, one << sh, 0)
        return accs

    inner_flat = jnp.asarray(inner_flat_np)

    def score_chunk(args):
        cy, cx = args
        e, wx, wy = jax.vmap(windows)(cy, cx)  # [C, W2] each, f32
        # main pass: toward-the-candidate sign only (see pruning proof above)
        proj = wy * base_oy_f[None, :] + wx * base_ox_f[None, :]
        sgn = jnp.where(proj >= 0.0, 1.0, -1.0)
        accs = walk_pass(sgn * wx, sgn * wy, rhat, base_ox_f, base_oy_f)
        # inner pass: central-block slots also walk the opposite sign
        e_i = e[:, inner_flat_np]
        sgn_i = sgn[:, inner_flat_np]
        accs_i = walk_pass(
            -sgn_i * wx[:, inner_flat_np],
            -sgn_i * wy[:, inner_flat_np],
            rhat_inner,
            base_ox_f[inner_flat],
            base_oy_f[inner_flat],
        )

        def cell_count(acc_list, c):
            a, off = divmod(c, PER)
            return ((acc_list[a] >> (5 * off)) & 31).astype(jnp.float32)

        score = [
            jnp.sum(e * cell_count(accs, c), axis=1)
            + jnp.sum(e_i * cell_count(accs_i, c), axis=1)
            for c in range(n_cells)
        ]
        return jnp.stack(score, axis=1)

    # chunk the candidate axis: window gathers for every candidate at once
    # would hold K*win^2 live per array (OOM at batch scale)
    K = ys.shape[0]
    C = min(32, K)
    if valid is None:
        valid = jnp.ones((K,), jnp.bool_)
    if K % C:
        padn = C - K % C
        ys = jnp.concatenate([ys, jnp.zeros((padn,), ys.dtype)])
        xs = jnp.concatenate([xs, jnp.zeros((padn,), xs.dtype)])
        valid = jnp.concatenate([valid, jnp.zeros((padn,), jnp.bool_)])

    # candidates arrive in descending vote order, so validity is a prefix:
    # whole trailing chunks are dead and lax.cond (sequential inside
    # lax.map's scan, so a real branch, not a select) skips their gathers
    # and walk entirely — most images fill a fraction of the top_k budget
    def maybe_chunk(args):
        cy, cx, any_valid = args
        nc = cy.shape[0]
        zeros = jnp.zeros((nc, cells * cells), jnp.float32)
        return jax.lax.cond(
            any_valid, lambda: score_chunk((cy, cx)), lambda: zeros
        )

    chunk_valid = jnp.any(valid.reshape(-1, C), axis=1)
    score = jax.lax.map(
        maybe_chunk, (ys.reshape(-1, C), xs.reshape(-1, C), chunk_valid)
    )
    score = score.reshape(-1, cells * cells)[:K]
    return score.reshape(K, cells, cells)


@functools.lru_cache(maxsize=32)
def _hist10_tables(min_r: int, max_r: int, dr: float = 1.0):
    """Static distance->bin one-hot for OpenCV 4.x/5.x's radius histogram.

    cv2's HoughCircleEstimateRadiusInvoker measures, for every edge pixel
    within [minR, maxR] of the centre (cx+.5, cy+.5), the float32 distance
    and drops it into a histogram with 10 bins per dr. Candidate centres
    are integer accumulator cells, so over a fixed (2*maxR+1)^2 gather
    window every pixel's distance — and hence its bin — is STATIC. All
    arithmetic here is numpy float32 to match cv2 bit-for-bit (verified
    float-exact against cv2 5.0 per-variant output, tools/cv_oracle.py).
    """
    nbins_per_dr = 10
    nbins = int(round((max_r - min_r) / dr * nbins_per_dr))
    ext = max_r
    win = 2 * ext + 1
    # pixel at window cell (u, v) sits at centre + (u-ext, v-ext); cv2
    # measures from (centre_x + 0.5, centre_y + 0.5)
    off = np.arange(win, dtype=np.float32) - np.float32(ext)
    dyy = (np.float32(0.5) - off)[:, None]
    dxx = (np.float32(0.5) - off)[None, :]
    r2 = (dxx * dxx + dyy * dyy).astype(np.float32)
    sel = (r2 >= np.float32(min_r * min_r)) & (r2 <= np.float32(max_r * max_r))
    d = np.sqrt(r2, dtype=np.float32)
    b = np.rint((d - np.float32(min_r)) / np.float32(dr)
                * nbins_per_dr).astype(np.int64)
    np.clip(b, 0, nbins - 1, out=b)
    onehot = np.zeros((win * win, nbins), np.float32)
    onehot[np.arange(win * win), b.ravel()] = sel.ravel().astype(np.float32)
    return onehot, win, nbins


def _hist10_scan(counts, min_r: int, dr: float = 1.0):
    """cv2's run scan over the radius histogram, vectorized across
    candidates.

    The C++ loop walks bins from large radii down; each nonempty bin j > 0
    anchors a run of the next 10 bins (the 11th below is skipped entirely),
    rCur is the run's bin-index midpoint, and a run replaces the best when
    curCount*rBest >= maxCount*rCur (the first run always wins via the
    FLT_EPSILON clause). Anchors are data-dependent, but every anchor
    consumes >= 11 bins of walk, so a fixed ceil((nbins-1)/11)-iteration
    loop with a masked highest-nonempty-bin reduction reproduces the scan
    exactly. counts [..., nbins] f32 integer values.
    Returns (r_best [...], max_count [...]) f32.
    """
    nbins_per_dr = 10
    nbins = counts.shape[-1]
    csum = jnp.cumsum(counts, axis=-1)
    iota = jnp.arange(nbins, dtype=jnp.int32)
    nonempty = counts > 0
    shape = counts.shape[:-1]
    j0 = jnp.full(shape, nbins - 1, jnp.int32)
    r0 = jnp.zeros(shape, jnp.float32)
    c0 = jnp.zeros(shape, jnp.float32)
    n_iter = (nbins - 2) // (nbins_per_dr + 1) + 1

    def body(_, state):
        j, r_best, max_count = state
        mask = nonempty & (iota >= 1) & (iota <= j[..., None])
        anchor = jnp.max(jnp.where(mask, iota, -1), axis=-1)
        has = anchor >= 0
        # run = bins [anchor-9, anchor] (clipped at 0); the inner while
        # leaves j at anchor-10 (or -1), which feeds the midpoint radius
        j_after = jnp.maximum(anchor - nbins_per_dr, -1)
        top = jnp.take_along_axis(csum, jnp.maximum(anchor, 0)[..., None],
                                  -1)[..., 0]
        lo = jnp.take_along_axis(csum, jnp.maximum(j_after, 0)[..., None],
                                 -1)[..., 0]
        cnt = top - jnp.where(j_after >= 0, lo, 0.0)
        r_cur = ((anchor + j_after).astype(jnp.float32) / 2.0
                 / nbins_per_dr * dr + min_r)
        better = has & (
            (cnt * r_best >= max_count * r_cur)
            | ((r_best < 1.19e-7) & (cnt >= max_count))
        )
        r_best = jnp.where(better, r_cur, r_best)
        max_count = jnp.where(better, cnt, max_count)
        # outer loop decrements past j_after before the next bin test
        j = jnp.where(has, anchor - (nbins_per_dr + 1), -1)
        return j, r_best, max_count

    _, r_best, max_count = jax.lax.fori_loop(0, n_iter, body, (j0, r0, c0))
    return r_best, max_count


def greedy_min_dist(ys, xs, live, min_dist: float, max_out: int | None = None):
    """Sequential acceptance in the GIVEN order with centre spacing >=
    min_dist (cv2's overlap removal over the support-sorted candidates).

    Candidates too close to an already-accepted circle are skipped; skipped
    or dead candidates do not block later ones (OpenCV semantics).

    max_out bounds the per-step distance test to the accepted-so-far list
    (a [max_out] position buffer) instead of all K candidates — O(max_out)
    work per step instead of O(K). Acceptances past max_out still return
    accepted=True but stop blocking; that is output-equivalent, because
    every candidate they could block ranks after them and is truncated by
    the same [max_out] output capacity anyway (circle_finalize slices the
    acceptance-ordered prefix).
    """
    K = ys.shape[0]
    md2 = min_dist * min_dist
    fy = ys.astype(jnp.float32)
    fx = xs.astype(jnp.float32)
    # the loop is inherently sequential, but positions beyond the last
    # live candidate can never flip; stop there (live is a prefix after
    # circle_finalize's sort, but stay correct for any order)
    K_i = jnp.arange(K)
    n_live = jnp.max(jnp.where(live, K_i, -1)) + 1

    if max_out is None:
        def body(i, accepted):
            d2 = (fy - fy[i]) ** 2 + (fx - fx[i]) ** 2
            clash = jnp.any(accepted & (K_i < i) & (d2 < md2))
            return accepted.at[i].set(live[i] & jnp.logical_not(clash))

        return jax.lax.fori_loop(0, n_live, body, jnp.zeros((K,), jnp.bool_))

    # dead slots sit at -2^30: any live candidate is farther than min_dist
    far = jnp.float32(-(2.0 ** 30))
    acc0 = (
        jnp.full((max_out,), far),
        jnp.full((max_out,), far),
        jnp.int32(0),
        jnp.zeros((K,), jnp.bool_),
    )

    def body(i, state):
        ay, ax, cnt, accepted = state
        d2 = (ay - fy[i]) ** 2 + (ax - fx[i]) ** 2
        take = live[i] & jnp.logical_not(jnp.any(d2 < md2))
        store = take & (cnt < max_out)
        slot = jnp.minimum(cnt, max_out - 1)
        ay = ay.at[slot].set(jnp.where(store, fy[i], ay[slot]))
        ax = ax.at[slot].set(jnp.where(store, fx[i], ax[slot]))
        return (ay, ax, cnt + store.astype(jnp.int32),
                accepted.at[i].set(take))

    _, _, _, accepted = jax.lax.fori_loop(0, n_live, body, acc0)
    return accepted


def cascade_pool_eligible(num_bins: int, min_r: int, max_r: int) -> bool:
    """True when the byte-packed pooled accumulator's exact integer
    bounds hold (see vote_accumulator_packed4)."""
    n_r = max_r - min_r + 1
    return n_r % 5 == 0 and num_bins <= 0x7E and 8 * n_r <= 255


def circle_plane_state(img_u8, canny_high: float, min_r: int, max_r: int,
                       num_bins: int, hysteresis_iters: int = 24, hw=None,
                       with_acc: bool = True, edges=None):
    """Stage 1a — the budget-INDEPENDENT per-plane work: internal Canny,
    gradient walk steps, and the approximate vote accumulator.

    Split out of circle_propose so the saturation-gated overflow pass
    (pipeline._circles_pooled) can rerun the budget-dependent selection
    stages at a bigger capacity WITHOUT recomputing Sobel/Canny/cascade
    (~60% of stage-1 cost). Returns dict(emask, sx, sy, acc).

    with_acc=False: return dict(emask, sx, sy, lbl) instead — the uint8
    direction-label plane that feeds the pooled byte-packed accumulator
    (pipeline._plane_state_pool computes the acc for 4 planes per uint32
    element there; the per-plane accumulator here is the fallback and
    the single-image path).

    edges: precomputed internal-Canny edge map for this plane (the batch
    path computes it for the whole plane pool at once via canny_pool's
    shared bit-packed hysteresis); None = compute per-plane here.
    """
    if hw is not None:
        from ..ops.common import border_remap

        img_r = border_remap(img_u8, hw[0], hw[1], "replicate")
    else:
        img_r = img_u8
    dx, dy = sobel3(img_r.astype(jnp.int32))
    if edges is None:
        edges = canny(img_u8, max(canny_high / 2, 1), canny_high,
                      iters=hysteresis_iters, hw=hw)
    emask = (edges > 0) & ((dx != 0) | (dy != 0))
    sx, sy = pixel_steps(dx, dy)
    out = dict(
        emask=emask,
        sx=jnp.where(emask, sx, 0),
        sy=jnp.where(emask, sy, 0),
    )
    if with_acc:
        out["acc"] = vote_accumulator(emask, dx, dy, num_bins, min_r, max_r)
    else:
        out["lbl"] = direction_labels(emask, dx, dy, num_bins)
    return out


def propose_from_acc(acc, acc_threshold: float, top_k: int, hw=None,
                     block: int = 1, threshold_factor: float = 0.5,
                     margin_factor: float | None = None,
                     select_floor: float | None = None):
    """Stage 1b — budget-dependent proposal selection from the accumulator.

    Returns (ys, xs, valid, sat): the SET of top_k qualifying maxima (by
    votes, ties toward smaller flat index) in stream order with a valid
    prefix (centre_candidates / top_k_set_by_count — row order carries no
    meaning downstream), plus an EXACT saturation flag (more qualifying
    maxima existed than top_k slots — the overflow trigger; an
    exactly-filled budget is complete, not saturated).

    margin_factor gates the trigger on the vote level the truncation cut
    into: proposals matter only as carriers of a cv2-accepted exact peak,
    and the measured floor-margin analysis (DetectionConfig
    .propose_threshold_factor: every cv2-kept circle's best proposal
    carries >= margin_factor * acc_threshold approximate votes, 0.7 = 21
    at the defaults, over 4950 circles / 17 fixtures) means a truncation
    that only dropped proposals BELOW that level cannot have lost a
    needed one — the needed (>= margin) proposals all rank above the
    dropped ones and were kept. So sat additionally requires that >=
    top_k maxima sit at-or-above the margin (i.e. the top_k'th kept vote
    reached it). Junk-dense planes whose sub-margin maxima overflow the
    budget — the steady state on dense scans — no longer trigger the
    big-budget rerun. None, or a margin at/below the proposal floor,
    restores the pure-count trigger.

    select_floor: drop proposals whose approximate votes fall below this
    absolute vote level (DetectionConfig.carrier_floor_factor *
    acc_threshold — the measured carrier floor, NOT the 0.7 margin:
    ex4 v9's cv2-needed carrier sits at exactly 20 approximate votes,
    below 0.7 * 30 = 21, so filtering at the margin loses it; see the
    config field for the measurement). Sub-floor proposals are pure
    rescore cost (dense planes carry thousands of junk rows at the >18
    proposal floor — measured 2026-08-20, tools/diag_tier_counts.py).
    Applied inside the selection so the returned rows keep the
    valid-prefix property. Saturation counts are unaffected.
    """
    H, W = acc.shape
    floor = threshold_factor * acc_threshold
    # sub-1x: margin for direction-quantization + cascade rounding smear;
    # stage 2 restores exact votes so extra proposals only cost rescore work
    margin = None
    if margin_factor is not None and margin_factor * acc_threshold > floor:
        margin = margin_factor * acc_threshold
    sel_min = None
    if select_floor is not None and select_floor > floor:
        sel_min = select_floor
    if margin is None:
        ys, xs, votes, valid, n_live = centre_candidates(
            acc, floor, top_k, hw=hw, block=block, with_count=True,
            select_min=sel_min,
        )
        sat = n_live > top_k
    else:
        ys, xs, votes, valid, n_live, n_margin = centre_candidates(
            acc, floor, top_k, hw=hw, block=block, with_count=True,
            margin=margin, select_min=sel_min,
        )
        sat = (n_live > top_k) & (n_margin >= top_k)
    return (jnp.clip(ys, 0, H - 1), jnp.clip(xs, 0, W - 1), valid, sat)


def circle_propose(img_u8, canny_high: float, acc_threshold: float,
                   min_r: int, max_r: int, num_bins: int, top_k: int,
                   hysteresis_iters: int = 24, hw=None, block: int = 1,
                   threshold_factor: float = 0.5):
    """Stage 1: edges + gradient steps + approximate-accumulator proposals
    (circle_plane_state + propose_from_acc).

    Returns dict(emask, sx, sy, ys, xs, valid, sat). A lower threshold
    (threshold_factor x acc_threshold) compensates for direction
    quantization spreading votes off the true peak cell; stage 2 restores
    exact OpenCV vote counts. See DetectionConfig.propose_threshold_factor
    for the measured margin behind the pipeline's default.
    """
    state = circle_plane_state(img_u8, canny_high, min_r, max_r, num_bins,
                               hysteresis_iters=hysteresis_iters, hw=hw)
    ys, xs, valid, sat = propose_from_acc(
        state["acc"], acc_threshold, top_k, hw=hw, block=block,
        threshold_factor=threshold_factor,
    )
    return dict(
        emask=state["emask"],
        sx=state["sx"],
        sy=state["sy"],
        ys=ys,
        xs=xs,
        valid=valid,
        sat=sat,
    )


def circle_votes(emask, sx, sy, ys, xs, valid, min_r: int, max_r: int,
                 cells: int = 3):
    """Stage 2a: exact OpenCV accumulator votes on the (cells x cells)
    patch around each proposal. patch [K, cells, cells] f32.

    cells=5 gives every reachable recentre position (the central 3x3) its
    true 4-neighbourhood, so stage 2b's OpenCV NMS test is exact (no
    out-of-patch fallback accepts)."""
    return exact_rescore(
        emask, sx, sy, ys, xs, min_r, max_r, cells=cells, valid=valid,
    )


def circle_recentre(patch, ys, xs, valid, acc_threshold: float, H: int, W: int,
                    hw=None):
    """Stage 2b: emit EVERY cell of each proposal's central 3x3 that passes
    OpenCV's candidate test on the exact votes.

    With a 5x5 patch (the pipeline path) every cell of the central 3x3 has
    all four neighbours in-patch, so OpenCV's test (votes > threshold,
    > left, >= right, > up, >= down, cell in the accumulator interior) is
    evaluated EXACTLY for each of the 9 reachable positions. ALL passing
    cells are emitted — not just the best: under cv2's modern selection
    (support-sorted, see circle_finalize) a lower-VOTED neighbouring peak
    can outrank a higher-voted one by radius support, so every exact NMS
    peak within reach of a proposal must survive to the radius stage.
    The same peak emitted by several overlapping patches yields duplicate
    rows; they sort adjacently in circle_finalize (identical keys) and the
    greedy pass drops the extras at distance 0.

    hw=(h, w): content dims inside the canvas — OpenCV scans accumulator
    cells in [1, h-2] x [1, w-2] only.

    Returns (ys_c, xs_c, exact_votes, valid2), each [K*9] for the 5x5
    path ([K] for the legacy argmax 3x3 path used by diagnostics).
    """
    K, cells = patch.shape[0], patch.shape[1]
    flat = patch.reshape(K, -1)
    if cells == 5:
        h, w = (H, W) if hw is None else hw
        centre = np.array([i * 5 + j for i in (1, 2, 3) for j in (1, 2, 3)])
        v = flat[:, centre]
        nms_ok = (
            (v > flat[:, centre - 1])
            & (v >= flat[:, centre + 1])
            & (v > flat[:, centre - 5])
            & (v >= flat[:, centre + 5])
        )
        offy = jnp.asarray(centre // 5 - 2, jnp.int32)
        offx = jnp.asarray(centre % 5 - 2, jnp.int32)
        cy = ys[:, None] + offy[None, :]
        cx = xs[:, None] + offx[None, :]
        interior = (cy >= 1) & (cy <= h - 2) & (cx >= 1) & (cx <= w - 2)
        ok = valid[:, None] & nms_ok & (v > acc_threshold) & interior
        ys_c = jnp.clip(cy, 0, H - 1).reshape(-1)
        xs_c = jnp.clip(cx, 0, W - 1).reshape(-1)
        return ys_c, xs_c, v.reshape(-1), ok.reshape(-1)
    best_cell = jnp.argmax(flat, axis=1)
    exact_votes = jnp.take_along_axis(flat, best_cell[:, None], axis=1)[:, 0]
    py, px = best_cell // 3, best_cell % 3

    # OpenCV's NMS pattern on the exact votes, where the patch shows the
    # neighbour: > left, >= right, > up, >= down (out-of-patch passes)
    def nbr(dy_, dx_, fallback):
        yy, xx = py + dy_, px + dx_
        inside = (yy >= 0) & (yy < 3) & (xx >= 0) & (xx < 3)
        idx = jnp.clip(yy, 0, 2) * 3 + jnp.clip(xx, 0, 2)
        nv = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]
        return jnp.where(inside, nv, fallback)

    nms_ok = (
        (exact_votes > nbr(0, -1, -1.0))
        & (exact_votes >= nbr(0, 1, -1.0))
        & (exact_votes > nbr(-1, 0, -1.0))
        & (exact_votes >= nbr(1, 0, -1.0))
    )
    ys_c = jnp.clip(ys + py - 1, 0, H - 1)
    xs_c = jnp.clip(xs + px - 1, 0, W - 1)
    valid2 = valid & (exact_votes > acc_threshold) & nms_ok
    return ys_c, xs_c, exact_votes, valid2


def provisional_ring(patch, ys, xs, valid, acc_threshold: float, H: int,
                     W: int, budget: int, hw=None):
    """Outer-ring (cheb-2) cells of each 5x5 exact-vote patch that pass the
    PARTIAL OpenCV candidate test (votes > threshold; strict/non-strict
    neighbour comparisons using in-patch values, out-of-patch neighbours
    assumed passing; accumulator interior).

    Cascade smear can displace an approximate peak 2 px from the exact
    accumulator peak (measured: 7 of ~4700 cv2-accepted peaks across the
    fixtures sit at Chebyshev distance 2 from every proposal, none
    further), so the +-1 emission reach of circle_recentre misses them.
    The partial test alone may accept false peaks (the unknown neighbour
    might dominate), so survivors get a second exact-vote pass at
    cells=3, which sees all four neighbours and decides the full test —
    see circle_candidates. Returns (ys_p, xs_p, valid_p, n_live): the
    first three [budget] — the SET a vote-descending top_k would keep
    (top_k_set_by_count: validity encoded as score > 0), in stream order
    with a valid prefix, so if the budget ever truncates it drops the
    least-voted ring cells; n_live is the exact pre-truncation count of
    passing ring cells (n_live > budget == real truncation — the
    overflow trigger).
    """
    K = patch.shape[0]
    flat = patch.reshape(K, 25)
    h, w = (H, W) if hw is None else hw
    ring = np.array([i * 5 + j for i in range(5) for j in range(5)
                     if i in (0, 4) or j in (0, 4)])  # 16 cells

    def nbr(off):
        """Neighbour votes for each ring cell; -1 (always passes) when the
        neighbour falls outside the 5x5 patch."""
        cols = []
        for c in ring:
            i, j = divmod(int(c), 5)
            ni, nj = i + off[0], j + off[1]
            cols.append(ni * 5 + nj if 0 <= ni < 5 and 0 <= nj < 5 else -1)
        known = np.array([c >= 0 for c in cols])
        idx = np.array([max(c, 0) for c in cols])
        vals = flat[:, idx]
        return jnp.where(jnp.asarray(known)[None, :], vals, -1.0)

    v = flat[:, ring]
    ok = (
        (v > acc_threshold)
        & (v > nbr((0, -1)))
        & (v >= nbr((0, 1)))
        & (v > nbr((-1, 0)))
        & (v >= nbr((1, 0)))
    )
    offy = jnp.asarray(ring // 5 - 2, jnp.int32)
    offx = jnp.asarray(ring % 5 - 2, jnp.int32)
    cy = ys[:, None] + offy[None, :]
    cx = xs[:, None] + offx[None, :]
    interior = (cy >= 1) & (cy <= h - 2) & (cx >= 1) & (cx <= w - 2)
    ok = valid[:, None] & ok & interior
    score = jnp.where(ok, v, -1.0).reshape(-1)
    top, idx, live = top_k_set_by_count(score, budget, via="sort")
    ys_p = jnp.clip(cy.reshape(-1)[idx], 0, H - 1)
    xs_p = jnp.clip(cx.reshape(-1)[idx], 0, W - 1)
    return ys_p, xs_p, live & (top > 0.0), jnp.sum(ok, dtype=jnp.int32)


def circle_candidates(emask, sx, sy, ys, xs, valid, min_r: int, max_r: int,
                      acc_threshold: float, H: int, W: int, hw=None,
                      prov_budget: int = 512,
                      peak_budget: int | None = None,
                      dedupe_first: bool = False):
    """Stages 2a-2c: exact candidate extraction around the proposals.

    1. 5x5 exact-vote patches (circle_votes) + multi-emission recentre:
       every exact accumulator NMS peak within +-1 of a proposal.
    2. Provisional outer-ring cells (+-2, partial test) verified by a
       second cells=3 exact-vote pass that sees all four neighbours —
       recovers peaks the cascade displaced by 2 px.
    3. (peak_budget set) dedupe + compact the stream to [peak_budget]
       rows (compact_candidates) so the radius and finalize stages work
       on unique live peaks instead of the full emission stream.

    Returns (ys_c, xs_c, votes, valid2, sat): the first four
    [K*9 + prov_budget] (or [peak_budget] when compacting); sat is a
    scalar bool — a capacity TRUNCATED real candidates (more passing ring
    cells than the ring budget, or more unique peaks than peak_budget),
    so callers must trigger the big-budget overflow pass.
    """
    patch = circle_votes(emask, sx, sy, ys, xs, valid, min_r, max_r,
                         cells=5)
    ys_c, xs_c, votes_c, ok_c = circle_recentre(
        patch, ys, xs, valid, acc_threshold, H, W, hw=hw)
    ys_p, xs_p, valid_p, n_ring = provisional_ring(
        patch, ys, xs, valid, acc_threshold, H, W, prov_budget, hw=hw)
    patch3 = circle_votes(emask, sx, sy, ys_p, xs_p, valid_p, min_r, max_r,
                          cells=3)
    c = patch3[:, 1, 1]
    h, w = (H, W) if hw is None else hw
    ok_p = (
        valid_p
        & (c > acc_threshold)
        & (c > patch3[:, 1, 0])
        & (c >= patch3[:, 1, 2])
        & (c > patch3[:, 0, 1])
        & (c >= patch3[:, 2, 1])
        & (ys_p >= 1) & (ys_p <= h - 2) & (xs_p >= 1) & (xs_p <= w - 2)
    )
    ys_all = jnp.concatenate([ys_c, ys_p])
    xs_all = jnp.concatenate([xs_c, xs_p])
    votes_all = jnp.concatenate([votes_c, c])
    ok_all = jnp.concatenate([ok_c, ok_p])
    ring_sat = n_ring > prov_budget
    if peak_budget is None:
        return ys_all, xs_all, votes_all, ok_all, ring_sat
    ys_k, xs_k, votes_k, ok_k, over = compact_candidates(
        ys_all, xs_all, votes_all, ok_all, W, peak_budget, dedupe=True,
        dedupe_first=dedupe_first,
    )
    return ys_k, xs_k, votes_k, ok_k, ring_sat | over


def _stream_select(live, budget: int):
    """Indices of the first `budget` live rows, in stream order: one
    stable bool argsort (live rows first, original order preserved).

    Returns (idx [budget], ok [budget] bool) even when the input
    has fewer than `budget` rows (zero-fill; ok is False there)."""
    order = jnp.argsort(jnp.logical_not(live), stable=True)
    if order.shape[0] < budget:
        order = jnp.concatenate(
            [order, jnp.zeros((budget - order.shape[0],), order.dtype)])
    idx = order[:budget]
    total = jnp.sum(live, dtype=jnp.int32)
    ok = jnp.arange(budget, dtype=jnp.int32) < total
    return idx, ok


def compact_candidates(ys, xs, votes, valid, W: int, budget: int,
                       dedupe: bool = False, dedupe_first: bool = False):
    """Compact the candidate stream to a fixed [budget] live-first prefix.

    The multi-emission recentre emits ~0-2 surviving cells per proposal,
    so the [K*9 + ring] stream is mostly dead rows; compacting it before
    the radius stage is what keeps radius/finalize work proportional to
    real peaks instead of the emission budget. Selection semantics are
    unchanged: circle_finalize's sort key (support, r, cx, cy) is a total
    order, so input order never matters.

    dedupe additionally drops duplicate (y, x) rows (the same exact peak
    emitted from several overlapping 5x5 patches or re-emitted by the
    ring pass; exact votes are a function of the cell, so duplicates are
    bitwise-identical rows). Output-equivalent either way — duplicates
    sort adjacently in circle_finalize and die at distance 0 in the
    greedy pass — but deduped streams keep the radius/finalize stages
    proportional to unique peaks instead of carrying duplicates through
    them.

    The default path compacts live rows in STREAM order (sort-free
    _stream_select); when truncation occurs it sets sat and the caller's
    big-budget rerun replaces the plane's results wholesale, so which
    rows were kept is unobservable. Only dedupe_first (below) selects
    the vote-descending SET — it serves the overflow pass, whose own
    sat flag has no further rerun to trigger, so ITS truncation must
    drop the weakest unique peaks (ties toward smaller stream index via
    top_k_set_by_count). The default path's dedupe runs on the
    [budget]-sized compacted prefix rather than the full [K*9+512]
    stream, so its key sort is several times smaller.

    dedupe_first: dedupe the FULL stream before the budget truncation, so
    the budget applies to UNIQUE peaks and sat is exact on the unique
    count. This is the big-budget overflow path's mode: its emission
    stream on dense scans carries ~2.5x duplicates (measured ex5: up to
    6715 live rows but only ~2640 unique peaks per plane), so truncating
    before deduping threw away real peaks while keeping redundant copies
    — the source of the round-3 ex5 circle-count residual. The full-
    stream key sort costs more than the compact-then-dedupe order, which
    is why the BASE pass keeps the cheap order (its truncation triggers
    the big rerun via sat, so nothing is lost there).

    Returns (ys, xs, votes, valid, sat) each [budget]; sat flags that
    more than `budget` live rows existed (truncation possible — callers
    treat it like a proposal-budget saturation and rerun big).
    """
    if dedupe_first:
        big = jnp.iinfo(jnp.int32).max
        key = jnp.where(valid, ys * W + xs, big)
        order = jnp.argsort(key)
        ks = key[order]
        dup = jnp.concatenate(
            [jnp.zeros((1,), jnp.bool_), ks[1:] == ks[:-1]]
        )
        live = (ks < big) & jnp.logical_not(dup)
        sat = jnp.sum(live) > budget
        # duplicates share bitwise-identical votes, so dropping the extra
        # copies first and THEN truncating by descending votes keeps the
        # strongest `budget` unique peaks (sort selection: identical
        # SET to a vote-ordered top_k incl. the smaller-index tie rule,
        # evaluated in the cell-key-sorted index space)
        score = jnp.where(live, votes[order], -1.0)
        top, sel2, okk = top_k_set_by_count(
            score, min(budget, score.shape[0]), via="sort")
        sel = order[sel2]
        return ys[sel], xs[sel], votes[sel], okk & (top > 0.0), sat
    # conservative saturation: counted on the full stream INCLUDING
    # duplicates (a dup-inflated count can only add big-pass reruns,
    # never miss one)
    sat = jnp.sum(valid) > budget
    # BASE-pass compaction is stream-order (sort-free _stream_select, not
    # a vote-ordered top_k): if truncation occurs sat is set and the
    # caller's big-budget rerun REPLACES this plane's results wholesale
    # (_circles_pooled), so which rows the truncation kept is never
    # observable; when it doesn't occur every live row is kept and
    # circle_finalize's total-order sort key makes input order moot. Only
    # the overflow pass (dedupe_first above), whose own truncation has no
    # further rerun, needs the vote-ordered keep-strongest semantics.
    b = min(budget, valid.shape[0])
    sel, ok = _stream_select(valid, b)
    ys, xs, votes, valid = ys[sel], xs[sel], votes[sel], ok
    if not dedupe:
        return ys, xs, votes, valid, sat
    key = jnp.where(valid, ys * W + xs, jnp.iinfo(jnp.int32).max)
    order = jnp.argsort(key)
    ks = key[order]
    dup = jnp.concatenate(
        [jnp.zeros((1,), jnp.bool_), ks[1:] == ks[:-1]]
    )
    live = (ks < jnp.iinfo(jnp.int32).max) & jnp.logical_not(dup)
    order2 = jnp.argsort(jnp.logical_not(live), stable=True)
    sel2 = order[order2]
    return ys[sel2], xs[sel2], votes[sel2], live[order2], sat


def radius_support_pool(emask_planes, ys, xs, want, min_r: int, max_r: int,
                        chunk: int | None = None):
    """cv2 radius estimate + run support at given centres, for a POOL of
    planes — cost proportional to the number of `want` candidates.

    emask_planes [P, H, W] bool; ys/xs/want [P, K]. The pool is flattened,
    sorted want-first, and processed in chunks under lax.map whose per-
    chunk lax.cond skips all-dead chunks. This only branches for real when
    the caller is NOT inside a vmap (vmap lowers cond to select) — which
    is exactly how detect_board/_batch call it (the pool axis IS the
    batch x variant axis, outside any vmap).

    Radius semantics are OpenCV 4.x/5.x HoughCircleEstimateRadiusInvoker:
    a 10-bins-per-dr histogram over f32 edge-pixel distances from
    (cx+.5, cy+.5) — built here as one matmul against a static one-hot
    (_hist10_tables) — scanned by _hist10_scan. Returns (r_best [P, K]
    f32, support [P, K] f32 run counts), zeros where not wanted.
    """
    P, H, W = emask_planes.shape
    K = ys.shape[1]
    N = P * K
    onehot_np, win, _nb = _hist10_tables(min_r, max_r)
    onehot = jnp.asarray(onehot_np)
    pad = max_r
    ep = jnp.pad(emask_planes.astype(jnp.float32),
                 ((0, 0), (pad, pad), (pad, pad)))

    want_f = want.reshape(-1)
    order = jnp.argsort(jnp.logical_not(want_f), stable=True)
    gy = ys.reshape(-1)[order]
    gx = xs.reshape(-1)[order]
    gp = (order // K).astype(jnp.int32)
    gw = want_f[order]

    if chunk is None:
        # scale the chunk with the pool so the scan stays ~<=128 steps at
        # batch scale: every lax.map step has a fixed launch cost, and the
        # live prefix (want-first sort) fits in a few dozen steps. Bigger
        # chunks trade a larger per-step gather (2048 x win^2 f32 ~ 30 MB)
        # for far fewer steps; dead chunks after the live prefix still
        # skip via the cond.
        chunk = min(2048, max(512, N // 128))
    C = min(chunk, N)
    while N % C:
        C //= 2
    assert C >= 1

    def window(p, y, x):
        return jax.lax.dynamic_slice(ep, (p, y, x), (1, win, win)).reshape(-1)

    def run_chunk(cp, cy, cx):
        w = jax.vmap(window)(cp, cy, cx)   # [C, win*win]
        # 0/1 operands with integer sums < 2^24: exact at any matmul
        # precision, TF32 included, so the default precision is kept
        counts = w @ onehot                # [C, nbins] integer f32
        return _hist10_scan(counts, min_r)

    def maybe_chunk(args):
        cp, cy, cx, any_want = args
        zeros = (jnp.zeros((C,), jnp.float32), jnp.zeros((C,), jnp.float32))
        return jax.lax.cond(
            any_want, lambda: run_chunk(cp, cy, cx), lambda: zeros
        )

    chunk_want = jnp.any(gw.reshape(-1, C), axis=1)
    r_s, s_s = jax.lax.map(
        maybe_chunk,
        (gp.reshape(-1, C), gy.reshape(-1, C), gx.reshape(-1, C), chunk_want),
    )
    inv = jnp.argsort(order)
    r_best = r_s.reshape(-1)[inv].reshape(P, K)
    support = s_s.reshape(-1)[inv].reshape(P, K)
    zero = jnp.zeros((), jnp.float32)
    return (jnp.where(want, r_best, zero), jnp.where(want, support, zero))


def circle_finalize(ys_c, xs_c, valid2, r_best, support, acc_threshold: float,
                    min_dist: float, max_out: int, packed_sort: bool = True):
    """Stage 3, cv2 4.x/5.x flow: keep supported candidates
    (run count > param2), sort ALL of them by (support desc, radius desc,
    cx asc, cy asc), then greedy minDist overlap removal in that order.

    Duplicate recentred cells carry identical keys; the stable sort keeps
    their incoming (vote) order and the greedy pass drops the later one at
    distance 0. Returns (circles [max_out, 3] f32 as (cx, cy, r) with
    OpenCV's +0.5 px centre offset, valid [max_out] bool), compacted in
    cv2's acceptance order.
    """
    supported = valid2 & (support > acc_threshold)
    if packed_sort:
        # pack the 4 sort keys into 2 int32s (half the stable-sort
        # passes). Exactness: support is an integer run count
        # <= (2*max_r+1)^2 < 8192 for max_r <= 44 (the packed_sort
        # gate), and r_best is a multiple of 0.05 by construction
        # (_hist10_scan's midpoint formula with integer anchors), so
        # round(r*20) separates every distinct radius; centres fit
        # x*65536 + y for canvases to 32767 x 65535 (the bucket ladder
        # tops out at 2048).
        k1 = jnp.where(
            supported,
            support.astype(jnp.int32) * 8192
            + jnp.round(r_best * 20.0).astype(jnp.int32),
            -1,
        )
        k2 = xs_c.astype(jnp.int32) * 65536 + ys_c.astype(jnp.int32)
        order = jnp.lexsort((k2, -k1))
    else:
        s_key = jnp.where(supported, support, -1.0)
        order = jnp.lexsort((ys_c, xs_c, -r_best, -s_key))
    ys_s = ys_c[order]
    xs_s = xs_c[order]
    r_s = r_best[order]
    accepted = greedy_min_dist(ys_s, xs_s, supported[order], min_dist,
                               max_out=max_out)
    keep = jnp.argsort(jnp.logical_not(accepted), stable=True)[:max_out]
    out_valid = accepted[keep]
    cx = xs_s[keep].astype(jnp.float32) + 0.5
    cy = ys_s[keep].astype(jnp.float32) + 0.5
    circles = jnp.stack([cx, cy, r_s[keep]], axis=1)
    return jnp.where(out_valid[:, None], circles, 0.0), out_valid


def hough_circles_gradient(img_u8, canny_high: float, acc_threshold: float,
                           min_dist: float, min_r: int, max_r: int,
                           num_bins: int, top_k: int, max_out: int,
                           hysteresis_iters: int = 24, hw=None,
                           cells: int = 5):
    """Full HOUGH_GRADIENT on one [H, W] uint8 image (stage composition).

    Returns (circles [max_out, 3] f32 as (cx, cy, r), valid [max_out] bool).
    Centres carry OpenCV's +0.5 px offset. hw=(h, w): content dims inside a
    fixed canvas (shape-bucketed mode) — edges are confined to the content
    block, candidate NMS scans its interior, and results match native size.
    """
    H, W = img_u8.shape
    assert cells == 5, "the cv2-exact candidate flow requires 5x5 patches"
    st = circle_propose(img_u8, canny_high, acc_threshold, min_r, max_r,
                        num_bins, top_k, hysteresis_iters, hw=hw)
    ys_c, xs_c, votes, valid2, _ring_sat = circle_candidates(
        st["emask"], st["sx"], st["sy"], st["ys"], st["xs"], st["valid"],
        min_r, max_r, acc_threshold, H, W, hw=hw,
    )
    r_best, support = radius_support_pool(
        st["emask"][None], ys_c[None], xs_c[None], valid2[None], min_r, max_r
    )
    return circle_finalize(ys_c, xs_c, valid2, r_best[0], support[0],
                           acc_threshold, min_dist, max_out)
