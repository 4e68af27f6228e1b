"""Per-plane candidate-population counts that drive the overflow tier
ladder design: for each fixture, every unique variant plane's

  n_live    qualifying proposal maxima (> propose floor, 0.6 * param2)
  n_margin  maxima at/above the overflow margin (0.7 * param2)
  n_ring    passing provisional-ring cells at the big budget
  n_uniq    unique exact NMS peaks (the peak-budget population)

These are budget-INDEPENDENT populations (counted on the full plane), so
one probe answers: which tier budget does each plane's margin-gated
saturation test select? Tier t (budget K) escalates iff n_live > K and
n_margin >= K.

Usage: python tools/diag_tier_counts.py [fixture ...]   (default: the
768-bucket bench fixtures ex1 ex2 ex5 ex6 ex13 ex14)
"""

from __future__ import annotations

import sys

import numpy as np

sys.path.insert(0, "/root/repo")

import jax

from img2sgf_tpu.compile_cache import enable_compile_cache

enable_compile_cache()
import jax.numpy as jnp


def main(names):
    from img2sgf_tpu.config import DetectionConfig
    from img2sgf_tpu.hostio import load_rgb
    from img2sgf_tpu.pipeline.detect import (
        _plane_state_pool, _pre_circles, _variant_dedup, bucket_dim,
    )
    from img2sgf_tpu.hough.circles import (
        centre_candidates, circle_candidates,
    )

    cfg = DetectionConfig()
    kb = cfg.overflow_center_candidates
    for name in names or ["ex1", "ex2", "ex5", "ex6", "ex13", "ex14"]:
        rgb = load_rgb(f"/root/reference/test_images/{name}.jpg")
        h, w = rgb.shape[:2]
        hb, wb = bucket_dim(h), bucket_dim(w)
        canvas = np.zeros((hb, wb, 3), np.uint8)
        canvas[:h, :w] = rgb

        @jax.jit
        def probe(img):
            _, _, variants = _pre_circles(img, cfg, (h, w))
            keep, _ = _variant_dedup(cfg, variants.shape[0])
            planes = variants[jnp.asarray(keep)]
            P = planes.shape[0]
            hwp = (jnp.full((P,), h, jnp.int32), jnp.full((P,), w, jnp.int32))
            st = _plane_state_pool(planes, cfg, hwp)
            H, W = st["acc"].shape[-2], st["acc"].shape[-1]
            floor = cfg.propose_threshold_factor * cfg.circle_acc_threshold
            margin = cfg.overflow_margin_factor * cfg.circle_acc_threshold

            def counts(a, hh, ww):
                ys, xs, votes, valid, n_live, n_margin = centre_candidates(
                    a, floor, kb, hw=(hh, ww), with_count=True, margin=margin,
                )
                return ys, xs, valid, n_live, n_margin

            ys, xs, pvalid, n_live, n_margin = jax.vmap(counts)(
                st["acc"], hwp[0], hwp[1])
            ys_c, xs_c, votes, valid2, _ = jax.vmap(
                lambda e, a, b, y, x, v, hh, ww: circle_candidates(
                    e, a, b, y, x, v, cfg.circle_min_radius,
                    cfg.circle_max_radius, cfg.circle_acc_threshold, H, W,
                    hw=(hh, ww),
                    prov_budget=max(cfg.overflow_ring_candidates,
                                    cfg.max_ring_candidates),
                    peak_budget=None,
                )
            )(st["emask"], st["sx"], st["sy"], ys, xs, pvalid,
              hwp[0], hwp[1])
            key = jnp.where(valid2, ys_c * W + xs_c, jnp.int32(2 ** 30))
            ks = jnp.sort(key, axis=1)
            uniq = (ks < 2 ** 30) & jnp.concatenate(
                [jnp.ones_like(ks[:, :1], bool), ks[:, 1:] != ks[:, :-1]],
                axis=1,
            )
            return n_live, n_margin, jnp.sum(valid2, 1), jnp.sum(uniq, 1)

        n_live, n_margin, n_rows, n_uniq = map(
            np.asarray, probe(jnp.asarray(canvas)))
        print(f"{name} ({h}x{w}):")
        print(f"  n_live/plane:   {n_live.tolist()}")
        print(f"  n_margin/plane: {n_margin.tolist()}")
        print(f"  ring+recentre live rows/plane: {n_rows.tolist()}")
        print(f"  unique peaks/plane:            {n_uniq.tolist()}",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
