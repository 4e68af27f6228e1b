"""exact_rescore must reproduce OpenCV's vote walk bit-exactly.

Brute-force reference: for every edge pixel, walk both directions at all
radii with the 10-bit fixed-point steps and count landings per patch cell.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from img2sgf_tpu.hough.circles import exact_rescore


def _brute(emask, sx, sy, cy, cx, min_r, max_r, cells=3):
    H, W = emask.shape
    reach = cells // 2
    score = np.zeros((cells, cells))
    far = max_r + 7
    for py in range(max(0, cy - far), min(H, cy + far + 1)):
        for px in range(max(0, cx - far), min(W, cx + far + 1)):
            if not emask[py, px]:
                continue
            for sign in (1, -1):
                for r in range(min_r, max_r + 1):
                    ly = py + ((r * sign * sy[py, px]) >> 10)
                    lx = px + ((r * sign * sx[py, px]) >> 10)
                    if -reach <= ly - cy <= reach and -reach <= lx - cx <= reach:
                        score[ly - cy + reach, lx - cx + reach] += 1
    return score


@pytest.mark.parametrize("cells", [3, 5])
def test_exact_rescore_matches_brute_force_walk(cells):
    rng = np.random.default_rng(7)
    H = W = 96
    emask = rng.random((H, W)) < 0.10
    ang = rng.uniform(0, 2 * np.pi, (H, W))
    sx = (np.rint(1024 * np.cos(ang)).astype(np.int32)) * emask
    sy = (np.rint(1024 * np.sin(ang)).astype(np.int32)) * emask
    ys = rng.integers(5, H - 5, 12)
    xs = rng.integers(5, W - 5, 12)
    patch = exact_rescore(
        jnp.asarray(emask), jnp.asarray(sx), jnp.asarray(sy),
        jnp.asarray(ys), jnp.asarray(xs), 1, 30, cells,
    )
    got = np.asarray(patch)
    for i in range(12):
        want = _brute(emask, sx, sy, int(ys[i]), int(xs[i]), 1, 30, cells)
        np.testing.assert_array_equal(got[i], want, err_msg=f"candidate {i}")


def _full_accumulator(emask, sx, sy, min_r, max_r):
    """Brute-force exact centre-vote accumulator (the full-image analogue
    of _brute): every edge pixel walks both directions at all radii with
    the 10-bit fixed-point steps."""
    H, W = emask.shape
    acc = np.zeros((H, W))
    for py, px in zip(*np.nonzero(emask)):
        for sign in (1, -1):
            for r in range(min_r, max_r + 1):
                ly = py + ((r * sign * sy[py, px]) >> 10)
                lx = px + ((r * sign * sx[py, px]) >> 10)
                if 0 <= ly < H and 0 <= lx < W:
                    acc[ly, lx] += 1
    return acc


def test_circle_candidates_recovers_cheb2_peaks():
    """circle_candidates == the full-accumulator OpenCV candidate scan,
    restricted to peaks within Chebyshev distance 2 of a proposal: every
    such peak is emitted with its exact votes (the ±2 ring cells travel
    through the provisional partial test + cells=3 exact verification),
    and nothing that fails the true 4-neighbour NMS test survives."""
    import jax

    from img2sgf_tpu.hough.circles import circle_candidates

    rng = np.random.default_rng(17)
    H = W = 96
    thr = 8.0
    emask = rng.random((H, W)) < 0.12
    ang = rng.uniform(0, 2 * np.pi, (H, W))
    sx = (np.rint(1024 * np.cos(ang)).astype(np.int32)) * emask
    sy = (np.rint(1024 * np.sin(ang)).astype(np.int32)) * emask

    acc = _full_accumulator(emask, sx, sy, 1, 30)
    is_peak = np.zeros((H, W), bool)
    for cy in range(1, H - 1):
        for cx in range(1, W - 1):
            v = acc[cy, cx]
            is_peak[cy, cx] = (
                v > thr
                and v > acc[cy, cx - 1] and v >= acc[cy, cx + 1]
                and v > acc[cy - 1, cx] and v >= acc[cy + 1, cx]
            )
    peaks = np.argwhere(is_peak)
    assert len(peaks) >= 5, "fixture too sparse to exercise the test"

    # proposals: true peaks displaced by 0..2 in each axis (the cascade
    # smear cases), plus junk proposals nowhere near a peak
    K = 64
    ys = rng.integers(3, H - 3, K).astype(np.int32)
    xs = rng.integers(3, W - 3, K).astype(np.int32)
    for i, (py, px) in enumerate(peaks[: K - 8]):
        dy_, dx_ = rng.integers(-2, 3, 2)
        ys[i] = np.clip(py + dy_, 0, H - 1)
        xs[i] = np.clip(px + dx_, 0, W - 1)
    valid = np.ones(K, bool)
    valid[-4:] = False

    got_y, got_x, got_v, got_ok, _sat = jax.jit(
        lambda e, a, b, y, x, v: circle_candidates(
            e, a, b, y, x, v, 1, 30, thr, H, W)
    )(jnp.asarray(emask), jnp.asarray(sx), jnp.asarray(sy),
      jnp.asarray(ys), jnp.asarray(xs), jnp.asarray(valid))
    got = {
        (int(y), int(x)): float(v)
        for y, x, v, ok in zip(np.asarray(got_y), np.asarray(got_x),
                               np.asarray(got_v), np.asarray(got_ok))
        if ok
    }

    want = set()
    for (py, px) in peaks:
        d = np.maximum(np.abs(ys[valid] - py), np.abs(xs[valid] - px))
        if d.min() <= 2:
            want.add((int(py), int(px)))
    assert set(got) == want
    for (cy, cx), v in got.items():
        assert v == acc[cy, cx], f"votes mismatch at {(cy, cx)}"


def _hist10_numpy(emask, cy, cx, min_r, max_r, dr=1.0):
    """Reference scalar transcription of cv2 4.x/5.x's radius estimator
    (HoughCircleEstimateRadiusInvoker): f32 distances from (cx+.5, cy+.5),
    a 10-bins-per-dr histogram, and the large-to-small anchored run scan
    with the 11th-bin skip. Validated float-exact against cv2 5.0
    per-variant circle output (tools/cv_oracle.py)."""
    nzy, nzx = np.nonzero(emask)
    fx = np.float32(cx + 0.5) - nzx.astype(np.float32)
    fy = np.float32(cy + 0.5) - nzy.astype(np.float32)
    r2 = fx * fx + fy * fy
    sel = (r2 >= np.float32(min_r * min_r)) & (r2 <= np.float32(max_r * max_r))
    dists = np.sqrt(r2[sel], dtype=np.float32)
    nbins_per_dr = 10
    nbins = int(round((max_r - min_r) / dr * nbins_per_dr))
    bins = np.zeros(max(nbins, 1), np.int64)
    b = np.rint((dists - np.float32(min_r)) / np.float32(dr)
                * nbins_per_dr).astype(np.int64)
    np.clip(b, 0, nbins - 1, out=b)
    np.add.at(bins, b, 1)
    r_best = 0.0
    max_count = 0
    j = nbins - 1
    while j > 0:
        if bins[j]:
            upbin = j
            cur_count = 0
            while j > upbin - nbins_per_dr and j >= 0:
                cur_count += int(bins[j])
                j -= 1
            r_cur = (upbin + j) / 2.0 / nbins_per_dr * dr + min_r
            if (cur_count * r_best >= max_count * r_cur
                    or (r_best < 1.19e-7 and cur_count >= max_count)):
                r_best = r_cur
                max_count = cur_count
        j -= 1
    return np.float32(r_best), max_count


def test_radius_pool_matches_cv2_hist10():
    """radius_support_pool == the scalar cv2 radius-histogram reference,
    exactly (radius and run count), on dense random edge maps."""
    from img2sgf_tpu.hough.circles import radius_support_pool

    rng = np.random.default_rng(5)
    H = W = 128
    K = 24
    emask = rng.random((H, W)) < 0.12
    # a few synthetic rings so real runs (not just noise) are scanned
    yy, xx = np.mgrid[0:H, 0:W]
    for (ry, rx, rr) in ((40, 40, 11), (80, 90, 23), (64, 64, 5)):
        d = np.sqrt((yy - ry) ** 2 + (xx - rx) ** 2)
        emask |= np.abs(d - rr) < 0.6
    ys = rng.integers(34, H - 34, K)
    xs = rng.integers(34, W - 34, K)
    ys[:3], xs[:3] = (40, 80, 64), (40, 90, 64)  # on-ring centres

    got_r, got_s = radius_support_pool(
        jnp.asarray(emask)[None], jnp.asarray(ys)[None],
        jnp.asarray(xs)[None], jnp.ones((1, K), bool), 1, 30, chunk=8,
    )
    for i in range(K):
        want_r, want_c = _hist10_numpy(emask, int(ys[i]), int(xs[i]), 1, 30)
        np.testing.assert_allclose(
            np.asarray(got_r)[0, i], want_r, rtol=2e-7,
            err_msg=f"candidate {i} radius")
        assert int(np.asarray(got_s)[0, i]) == want_c, f"candidate {i} count"


def test_selection_budget_exceeds_plane():
    """Budgets larger than the plane's candidate population (a small
    canvas under the 16384 overflow budget — no_circles.jpg's 128-bucket
    hit this) must produce full-[k] shapes with a dead tail, in every
    selection primitive (regression: the argsort _stream_select returned
    min(N, k) rows and crashed propose on (16384,) & (8192,))."""
    from img2sgf_tpu.hough.circles import (
        _stream_select, propose_from_acc, top_k_set_by_count,
    )

    rng = np.random.default_rng(3)
    live = jnp.asarray(rng.random(100) < 0.3)
    idx, ok = _stream_select(live, 256)
    assert idx.shape == (256,) and ok.shape == (256,)
    assert int(ok.sum()) == int(live.sum())

    score = jnp.where(live, 7.0, -1.0)
    for via in ("count", "sort"):
        v, i, o = top_k_set_by_count(score, 256, via=via)
        assert v.shape == (256,) and i.shape == (256,) and o.shape == (256,)
        assert int(o.sum()) == int(live.sum())

    acc = jnp.asarray((rng.random((64, 64)) < 0.01) * 40.0)
    ys, xs, valid, sat = propose_from_acc(
        acc, 30.0, 16384, margin_factor=0.7, select_floor=19.5)
    assert ys.shape == (16384,) and valid.shape == (16384,)
    assert not bool(sat)


def test_finalize_matches_cv2_selection():
    """circle_finalize == cv2's modern selection: supported candidates
    sorted by (support desc, r desc, cx asc, cy asc), then greedy minDist
    removal — checked against a scalar transcription with heavy ties."""
    import jax

    from img2sgf_tpu.hough.circles import circle_finalize

    rng = np.random.default_rng(13)
    K = 96
    ys = rng.integers(0, 60, K).astype(np.int32)
    xs = rng.integers(0, 60, K).astype(np.int32)
    r = (rng.integers(2, 8, K) * 2.5).astype(np.float32)
    support = rng.integers(28, 36, K).astype(np.float32)  # ties + gating
    valid = rng.random(K) < 0.85
    thr, min_dist = 30.0, 10.0

    circles, ok = jax.jit(
        lambda y, x, v, rr, s: circle_finalize(y, x, v, rr, s, thr,
                                               min_dist, K)
    )(jnp.asarray(ys), jnp.asarray(xs), jnp.asarray(valid),
      jnp.asarray(r), jnp.asarray(support))

    est = [
        (float(xs[i] + 0.5), float(ys[i] + 0.5), float(r[i]),
         float(support[i]), i)
        for i in range(K) if valid[i] and support[i] > thr
    ]
    est.sort(key=lambda t: (-t[3], -t[2], t[0], t[1]))
    want = []
    for (cx, cy, rr_, _s, _i) in est:
        if all((ax - cx) ** 2 + (ay - cy) ** 2 >= min_dist ** 2
               for (ax, ay, _ar) in want):
            want.append((cx, cy, rr_))
    got = [tuple(map(float, c)) for c, o in zip(np.asarray(circles),
                                                np.asarray(ok)) if o]
    assert got == want


def test_paired_topk_matches_direct():
    """centre_candidates' paired top_k (even W) must be bit-identical to a
    direct lax.top_k over the masked score plane, including tie order."""
    import jax

    from img2sgf_tpu.hough.circles import centre_candidates

    rng = np.random.default_rng(3)
    H, W, K = 64, 128, 64
    # small integer votes force many ties
    acc = jnp.asarray(rng.integers(0, 6, (H, W)).astype(np.float32))

    ys, xs, votes, valid = jax.jit(
        lambda a: centre_candidates(a, 1.0, K)
    )(acc)

    # direct reference: same NMS mask, plain top_k
    from img2sgf_tpu.ops.common import shift2d

    left = shift2d(acc, 0, 1)
    right = shift2d(acc, 0, -1)
    up = shift2d(acc, 1, 0)
    down = shift2d(acc, -1, 0)
    ys_i, xs_i = np.mgrid[0:H, 0:W]
    interior = (ys_i >= 1) & (ys_i <= H - 2) & (xs_i >= 1) & (xs_i <= W - 2)
    is_max = (
        (np.asarray(acc) > 1.0)
        & (np.asarray(acc) > np.asarray(left))
        & (np.asarray(acc) >= np.asarray(right))
        & (np.asarray(acc) > np.asarray(up))
        & (np.asarray(acc) >= np.asarray(down))
        & interior
    )
    score = np.where(is_max, np.asarray(acc), -1.0).ravel()
    want_votes, want_flat = jax.lax.top_k(jnp.asarray(score), K)
    np.testing.assert_array_equal(np.asarray(votes), np.asarray(want_votes))
    flat = np.asarray(ys) * W + np.asarray(xs)
    np.testing.assert_array_equal(
        flat[np.asarray(valid)], np.asarray(want_flat)[np.asarray(want_votes) > 0]
    )


def test_block_compacted_candidates():
    """centre_candidates(block=4) == numpy reference: strongest NMS
    maximum per 4x4 tile (scan-order tiebreak inside the tile), tiles
    ranked by vote desc / tile-index asc."""
    import jax

    from img2sgf_tpu.hough.circles import centre_candidates

    rng = np.random.default_rng(29)
    H, W, K, b = 60, 100, 48, 4  # non-multiples of b exercise the pad
    acc = jnp.asarray(rng.integers(0, 6, (H, W)).astype(np.float32))

    ys, xs, votes, valid = jax.jit(
        lambda a: centre_candidates(a, 1.0, K, block=b)
    )(acc)

    a = np.asarray(acc)
    is_max = (a > 1.0)
    is_max[:, 1:] &= a[:, 1:] > a[:, :-1]
    is_max[:, :-1] &= a[:, :-1] >= a[:, 1:]
    is_max[1:, :] &= a[1:, :] > a[:-1, :]
    is_max[:-1, :] &= a[:-1, :] >= a[1:, :]
    is_max[0, :] = is_max[-1, :] = False
    is_max[:, 0] = is_max[:, -1] = False
    score = np.where(is_max, a, -1.0)
    Hb, Wb = -(-H // b), -(-W // b)
    s = np.full((Hb * b, Wb * b), -1.0, np.float32)
    s[:H, :W] = score
    tiles = s.reshape(Hb, b, Wb, b).transpose(0, 2, 1, 3).reshape(-1, b * b)
    bmax = tiles.max(axis=1)
    barg = tiles.argmax(axis=1)
    order = np.lexsort((np.arange(len(bmax)), -bmax))[:K]
    want = [
        ((i // Wb) * b + barg[i] // b, (i % Wb) * b + barg[i] % b, bmax[i])
        for i in order if bmax[i] > 0
    ]
    got = [
        (int(y), int(x), float(v))
        for y, x, v, ok in zip(np.asarray(ys), np.asarray(xs),
                               np.asarray(votes), np.asarray(valid))
        if ok
    ]
    assert got == [(int(y), int(x), float(v)) for (y, x, v) in want]


def test_recentre_5x5_true_nms_semantics():
    """circle_recentre on a 5x5 patch == plain-numpy OpenCV NMS over the
    central 3x3: EVERY cell with votes > threshold, > left, >= right,
    > up, >= down (all four neighbours known in-patch) that lies in the
    accumulator interior [1, h-2] x [1, w-2] is emitted (multiset —
    neighbouring proposals may emit the same peak twice)."""
    import jax

    from img2sgf_tpu.hough.circles import circle_recentre

    rng = np.random.default_rng(9)
    K, H, W = 256, 100, 120
    thr = 5.0
    # small integer votes force plateaus and NMS tie cases
    patch = rng.integers(0, 12, (K, 5, 5)).astype(np.float32)
    ys = rng.integers(0, H, K).astype(np.int32)
    xs = rng.integers(0, W, K).astype(np.int32)
    valid = rng.random(K) < 0.9

    got_y, got_x, got_v, got_ok = jax.jit(
        lambda p, y, x, v: circle_recentre(p, y, x, v, thr, H, W)
    )(jnp.asarray(patch), jnp.asarray(ys), jnp.asarray(xs),
      jnp.asarray(valid))

    want = []
    for i in range(K):
        if not valid[i]:
            continue
        for py in (1, 2, 3):
            for px in (1, 2, 3):
                v = patch[i, py, px]
                cy, cx = ys[i] + py - 2, xs[i] + px - 2
                if not (1 <= cy <= H - 2 and 1 <= cx <= W - 2):
                    continue
                if (
                    v > thr
                    and v > patch[i, py, px - 1]
                    and v >= patch[i, py, px + 1]
                    and v > patch[i, py - 1, px]
                    and v >= patch[i, py + 1, px]
                ):
                    want.append((cy, cx, float(v)))

    got = sorted(
        (int(y), int(x), float(v))
        for y, x, v, ok in zip(
            np.asarray(got_y), np.asarray(got_x),
            np.asarray(got_v), np.asarray(got_ok),
        )
        if ok
    )
    assert got == sorted(want)


def test_margin_gated_overflow_trigger():
    """propose_from_acc margin gate: a proposal-budget overflow made of
    sub-margin junk maxima must NOT flag saturation (the dropped
    proposals cannot carry a cv2-accepted peak — DetectionConfig
    .overflow_margin_factor), while an overflow that cuts into >= margin
    votes must. Maxima here are isolated cells on an odd-index lattice
    so the NMS test keeps all of them."""
    import jax

    from img2sgf_tpu.hough.circles import propose_from_acc

    H = W = 64
    K = 16
    thresh, floor_f, margin_f = 30.0, 0.6, 0.7  # floor 18, margin 21

    def plane(n_low, n_high):
        a = np.zeros((H, W), np.float32)
        cells = [(y, x) for y in range(1, H - 1, 2)
                 for x in range(1, W - 1, 2)]
        for i in range(n_low):
            a[cells[i]] = 19.0  # above floor, below margin
        for i in range(n_high):
            a[cells[n_low + i]] = 25.0  # above margin
        return jnp.asarray(a)

    run = jax.jit(lambda a: propose_from_acc(
        a, thresh, K, threshold_factor=floor_f, margin_factor=margin_f))

    # 40 junk maxima overflow the 16-slot budget, but none reach 21 votes
    _, _, valid, sat = run(plane(40, 0))
    assert not bool(sat)
    assert int(np.asarray(valid).sum()) == K  # budget genuinely overflowed

    # mixed overflow: 10 junk + 30 strong — the cut is inside >= margin
    _, _, _, sat = run(plane(10, 30))
    assert bool(sat)

    # strong maxima exactly fill the budget: complete, not saturated
    _, _, _, sat = run(plane(0, K))
    assert not bool(sat)

    # margin at/below the floor degrades to the pure-count trigger
    run_nomargin = jax.jit(lambda a: propose_from_acc(
        a, thresh, K, threshold_factor=floor_f, margin_factor=floor_f))
    _, _, _, sat = run_nomargin(plane(40, 0))
    assert bool(sat)


def test_packed4_pool_accumulator_bit_exact():
    """The byte-packed 4-planes-per-uint32 cascade (the pipeline's pooled
    accumulator) must equal the per-plane cascade bit-for-bit, including
    on pools that need dead-plane padding (P % 4 != 0)."""
    import jax

    from img2sgf_tpu.hough.circles import (
        vote_accumulator_cascade,
        vote_accumulator_pool,
    )

    rng = np.random.default_rng(11)
    for P in (4, 6):  # aligned and padded pool sizes
        emask = jnp.asarray(rng.random((P, 48, 64)) < 0.15)
        dx = jnp.asarray(rng.integers(-255, 256, (P, 48, 64)).astype(np.int32))
        dy = jnp.asarray(rng.integers(-255, 256, (P, 48, 64)).astype(np.int32))
        pooled = jax.jit(
            lambda e, a, b: vote_accumulator_pool(e, a, b, 64, 1, 30)
        )(emask, dx, dy)
        per_plane = jax.jit(
            jax.vmap(lambda e, a, b: vote_accumulator_cascade(e, a, b, 64, 1, 30))
        )(emask, dx, dy)
        np.testing.assert_array_equal(np.asarray(pooled), np.asarray(per_plane))
