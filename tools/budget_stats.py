"""Measure proposal-budget pressure against every fixture plane.

For each fixture, at its PRODUCTION bucket canvas shape, reports per-plane
counts from the approximate (cascade) accumulator:
  n_live    — NMS maxima above the proposal floor
              (sizes max_center_candidates / overflow_center_candidates)
  n_margin  — maxima at/above the overflow margin gate
              (the count the margin-gated saturation trigger compares)

These size the proposal budgets: any plane whose n_live exceeds the
overflow budget will truncate proposals there (vote-ordered, weakest
first). Ring/peak budget pressure is content-dependent downstream work —
validate those empirically with tools/diag_residual.py (which diffs the
production path against cv2 per variant) after any budget change.

Usage: python tools/budget_stats.py [--cpu] [fixture ...]   (default: all)
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

sys.path.insert(0, "/root/repo")

import jax
import jax.numpy as jnp

FIXTURES = pathlib.Path("/root/reference/test_images")


def main(names):
    if "--cpu" in names:
        names.remove("--cpu")
        jax.config.update("jax_platforms", "cpu")
    from img2sgf_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    from img2sgf_tpu.config import DetectionConfig
    from img2sgf_tpu.hostio import load_rgb
    from img2sgf_tpu.ops.common import shift2d
    from img2sgf_tpu.pipeline.detect import (
        _plane_state_pool, _pre_circles, _variant_dedup, bucket_dim,
    )

    cfg = DetectionConfig()
    floor = cfg.propose_threshold_factor * cfg.circle_acc_threshold
    margin = cfg.overflow_margin_factor * cfg.circle_acc_threshold

    if not names:
        names = sorted(p.stem for p in FIXTURES.glob("*.jpg"))

    @jax.jit
    def counts(acc, h, w):
        H, W = acc.shape
        left = shift2d(acc, 0, 1)
        right = shift2d(acc, 0, -1)
        up = shift2d(acc, 1, 0)
        down = shift2d(acc, -1, 0)
        ys_i = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
        xs_i = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
        interior = ((ys_i >= 1) & (ys_i <= h - 2)
                    & (xs_i >= 1) & (xs_i <= w - 2))
        is_max = ((acc > floor) & (acc > left) & (acc >= right)
                  & (acc > up) & (acc >= down) & interior)
        return (jnp.sum(is_max, dtype=jnp.int32),
                jnp.sum(is_max & (acc >= margin), dtype=jnp.int32))

    worst = [0, 0]
    for name in names:
        rgb = load_rgb(str(FIXTURES / f"{name}.jpg"))
        h, w = rgb.shape[:2]
        Hb, Wb = bucket_dim(h), bucket_dim(w)
        canv = np.zeros((Hb, Wb, 3), np.uint8)
        canv[:h, :w] = rgb
        img = jnp.asarray(canv)

        def pool_fn(im):
            grey, edges, variants = _pre_circles(im, cfg, (h, w))
            keep, _ = _variant_dedup(cfg, variants.shape[0])
            return variants[jnp.asarray(keep)]

        pool = jax.jit(pool_fn)(img)
        P = pool.shape[0]
        hwp = (jnp.full((P,), h, jnp.int32), jnp.full((P,), w, jnp.int32))
        st = jax.jit(lambda p: _plane_state_pool(p, cfg, hwp))(pool)
        rows = [tuple(int(v) for v in counts(st["acc"][p], h, w))
                for p in range(P)]
        mx = [max(r[i] for r in rows) for i in range(2)]
        worst = [max(a, b) for a, b in zip(worst, mx)]
        print(f"{name:10s} bucket={Hb}x{Wb} planes={P} "
              f"max_n_live={mx[0]} max_n_margin={mx[1]} "
              f"per_plane={[r[0] for r in rows]}", flush=True)
    print(f"WORST over fixtures: n_live={worst[0]} n_margin={worst[1]}")
    print(f"budgets: base center={cfg.max_center_candidates} "
          f"overflow center={cfg.overflow_center_candidates}")


if __name__ == "__main__":
    main(sys.argv[1:])
