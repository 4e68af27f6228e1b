"""Always-on pipeline smoke tests at tiny sizes (CPU-friendly compiles).

Full-fixture board parity runs on the GPU via tools/parity_report.py; here we
verify the jitted program end-to-end on a synthetic grid: detection,
classification, SGF round trip, and batch/vmap consistency.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from img2sgf_tpu.config import DetectionConfig
from img2sgf_tpu.core import to_sgf
from img2sgf_tpu.pipeline import detect_board_batch, detect_board_jit

TINY = DetectionConfig(
    # 256 candidate slots: this synthetic's 81 phantom grid intersections
    # (see test_stones_classified) compete with the real stones for
    # stage-1 slots; 64 is below what the image needs (default is 1024)
    max_center_candidates=256,
    overflow_center_candidates=0,  # keep one compiled budget branch (CPU)
    max_circles_per_variant=32,
    max_lines=256,
    hysteresis_iters=8,
)


def synth_board(size=160, n=9, stones=((2, 3, 0), (4, 4, 255), (6, 2, 0))):
    """Anti-aliased synthetic diagram (no cv2 dependency)."""
    img = np.full((size, size), 250, np.float32)
    lo, hi = 14, size - 14
    coords = np.linspace(lo, hi, n)
    for c in coords:
        ci = int(round(c))
        img[ci, int(lo) : int(hi) + 1] = 10
        img[int(lo) : int(hi) + 1, ci] = 10
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    r = (coords[1] - coords[0]) * 0.42
    for i, j, colour in stones:
        cx, cy = coords[i], coords[j]
        d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
        inside = np.clip(r + 0.5 - d, 0, 1)  # soft edge
        img = img * (1 - inside) + colour * inside
        ring = np.clip(0.8 - np.abs(d - r), 0, 1)
        img = img * (1 - ring) + 10 * ring
    return np.repeat(img.astype(np.uint8)[:, :, None], 3, axis=2)


@pytest.fixture(scope="module")
def result():
    rgb = synth_board()
    return detect_board_jit(jnp.asarray(rgb), TINY, 28.0)


def test_grid_found(result):
    assert bool(result.valid_grid)
    assert int(result.hsize) == 9 and int(result.vsize) == 9
    assert bool(result.board_ready)


def test_stones_classified(result):
    b = np.asarray(result.detected_board)
    assert b[2, 3] == 1  # black
    assert b[4, 4] == 2  # white
    assert b[6, 2] == 1
    # No exact stone-count assertion: on this synthetic the thin 1px grid
    # intersections themselves vote as circles in HOUGH_GRADIENT — the
    # OpenCV reference detects ~12 phantom stones here too (verified with
    # tools/reference_headless.py). Exact-count parity is tracked on the
    # real fixtures via tools/parity_report.py goldens instead.
    assert (b != 0).sum() <= 19  # sanity: not runaway detection


def test_sgf_roundtrip(result):
    sgf = to_sgf(np.asarray(result.full_board), int(result.side_to_move))
    assert sgf.startswith("(;GM[1]FF[4]SZ[19]")
    assert "AB" in sgf and "AW" in sgf


@pytest.mark.slow
def test_batch_matches_single(result):
    rgb = synth_board()
    batch = jnp.asarray(np.stack([rgb, rgb]))
    thr = jnp.asarray([28.0, 28.0])
    bres = detect_board_batch(batch, TINY, thr)
    np.testing.assert_array_equal(
        np.asarray(bres.full_board[0]), np.asarray(result.full_board)
    )
    np.testing.assert_array_equal(
        np.asarray(bres.full_board[0]), np.asarray(bres.full_board[1])
    )


@pytest.mark.slow
def test_overflow_budget_gating():
    """Saturation-gated overflow (_circles_pooled): a plane that fills the
    base candidate budget triggers the big-budget rerun under lax.cond, and
    the result is bit-identical to running the big budget directly; an
    unsaturated pool's result is unchanged by enabling overflow."""
    from img2sgf_tpu.pipeline.detect import (
        _circles_on_planes, _circles_pooled, _pre_circles, _variant_dedup,
    )

    def planes_of(im, c):
        _, _, variants = _pre_circles(jnp.asarray(im), c, None)
        keep, _ = _variant_dedup(c, variants.shape[0])
        return variants[jnp.asarray(keep)]

    rng = np.random.default_rng(5)
    noisy = rng.integers(0, 256, (96, 96, 3)).astype(np.uint8)
    # margin gating is disabled (margin <= threshold factor restores the
    # pure-count trigger) so this tests the rerun MECHANISM independently
    # of the gate — the pooled==big identity only holds when no plane sits
    # in the truncated-but-margin-gated regime, and coupling the assertion
    # to the noise fixture's vote distribution would make it fragile. The
    # gate itself is tested by test_margin_gated_overflow_trigger.
    cfg = DetectionConfig(
        max_center_candidates=16, overflow_center_candidates=96,
        max_ring_candidates=16, overflow_ring_candidates=64,
        max_circles_per_variant=16, hysteresis_iters=4,
        overflow_margin_factor=0.0,
    )
    planes = jax.jit(lambda im: planes_of(im, cfg))(noisy)
    _, _, sat = jax.jit(lambda p: _circles_on_planes(p, cfg, None))(planes)
    assert bool(jnp.any(sat)), "noise fixture no longer saturates 16 slots"
    got_c, got_v = jax.jit(lambda p: _circles_pooled(p, cfg, None))(planes)
    want_c, want_v = jax.jit(
        lambda p: _circles_on_planes(p, cfg, None, top_k=96,
                                     prov_budget=64)[:2]
    )(planes)
    np.testing.assert_array_equal(np.asarray(got_v), np.asarray(want_v))
    np.testing.assert_array_equal(np.asarray(got_c), np.asarray(want_c))

    # unsaturated: the cond takes the base branch; results identical to the
    # overflow-disabled config
    clean = synth_board(size=96, n=5, stones=((1, 1, 0),))
    cfg2 = cfg.replace(max_center_candidates=1024,
                       overflow_center_candidates=2048,
                       max_ring_candidates=512)
    planes2 = jax.jit(lambda im: planes_of(im, cfg2))(clean)
    base_c, base_v, sat2 = jax.jit(
        lambda p: _circles_on_planes(p, cfg2, None)
    )(planes2)
    assert not bool(jnp.any(sat2)), "clean synthetic unexpectedly saturates"
    on_c, on_v = jax.jit(lambda p: _circles_pooled(p, cfg2, None))(planes2)
    np.testing.assert_array_equal(np.asarray(on_v), np.asarray(base_v))
    np.testing.assert_array_equal(np.asarray(on_c), np.asarray(base_c))
