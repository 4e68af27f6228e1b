"""Measure big-budget pass saturation on a fixture: unique live peak
counts per plane vs the overflow peak budget, and the ring-pass live
counts vs the overflow ring budget.

Usage: python tools/diag_overflow_sat.py [fixture ...] (default ex5)
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
        _circles_from_state, _plane_state_pool, _pre_circles, _variant_dedup,
        bucket_dim,
    )

    cfg = DetectionConfig()
    for name in names or ["ex5"]:
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
            # big-budget selection with an XL peak budget (no truncation)
            ys, xs, votes, valid2, sat = [None] * 5
            from img2sgf_tpu.hough.circles import (
                circle_candidates, propose_from_acc,
            )
            H, W = st["acc"].shape[-2], st["acc"].shape[-1]
            kb = cfg.overflow_center_candidates
            ys, xs, pvalid, psat = jax.vmap(
                lambda a, hh, ww: propose_from_acc(
                    a, cfg.circle_acc_threshold, kb, hw=(hh, ww),
                    block=cfg.propose_block,
                    threshold_factor=cfg.propose_threshold_factor,
                    margin_factor=cfg.overflow_margin_factor,
                )
            )(st["acc"], hwp[0], hwp[1])
            ys_c, xs_c, votes, valid2, ring_sat = jax.vmap(
                lambda e, a, b, y, x, v, hh, ww: circle_candidates(
                    e, a, b, y, x, v, cfg.circle_min_radius,
                    cfg.circle_max_radius, cfg.circle_acc_threshold, H, W,
                    hw=(hh, ww),
                    prov_budget=max(cfg.overflow_ring_candidates,
                                    cfg.max_ring_candidates),
                    peak_budget=None,  # full stream, no compaction
                )
            )(st["emask"], st["sx"], st["sy"], ys, xs, pvalid,
              hwp[0], hwp[1])
            # unique live peaks per plane
            key = jnp.where(valid2, ys_c * W + xs_c, jnp.int32(2 ** 30))
            ks = jnp.sort(key, axis=1)
            uniq = (ks < 2 ** 30) & jnp.concatenate(
                [jnp.ones_like(ks[:, :1], bool), ks[:, 1:] != ks[:, :-1]],
                axis=1,
            )
            return (jnp.sum(pvalid, 1), psat, jnp.sum(valid2, 1),
                    jnp.sum(uniq, 1), ring_sat)

        nprop, psat, nlive, nuniq, ring_sat = map(np.asarray,
                                                  probe(jnp.asarray(canvas)))
        print(f"{name}: big-pass proposals/plane: {nprop.tolist()}")
        print(f"  psat={psat.tolist()} ring_sat={ring_sat.tolist()}")
        print(f"  live rows/plane:    {nlive.tolist()}")
        print(f"  unique peaks/plane: {nuniq.tolist()} "
              f"(overflow_peak_budget={cfg.overflow_peak_candidates})",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
