"""Residual circle-delta root-cause: PRODUCTION pipeline vs cv2, per variant.

tools/diag_circles_diff.py diffs the BASE-budget stages, which overstates
misses on dense fixtures (the production path reruns saturated planes at
the big overflow budget). This tool runs the real `_circles_pooled`
production path (PARITY.md's counts come from it via parity_report), diffs
the accepted per-variant circle sets against cv2's own HoughCircles streams
(reference_headless), then blames each residual miss by re-running the
selection stages at the OVERFLOW budgets with intermediates exposed:

  notprop — no big-budget proposal within 2px (cascade peak truly absent)
  votes   — proposed, exact 5x5 votes never exceed param2 near the centre
  nms     — vote-passing cell rejected by the in-patch NMS pattern
  radius  — candidate's radius-histogram support <= param2
  greedy  — lost to minDist spacing against an earlier acceptance

Usage: python tools/diag_residual.py [--cpu] [fixture ...]
       (default: ex4 ex5 ex12 — the PARITY.md residual fixtures)
"""

from __future__ import annotations

import sys

import numpy as np
from PIL import Image

sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/tools")

import jax
import jax.numpy as jnp

FIXTURES = "/root/reference/test_images"


def production_circles_per_variant(img_rgb_u8, cfg):
    """Accepted circles per ORIGINAL blur variant, via the real pooled path."""
    from img2sgf_tpu.pipeline.detect import (
        _circles_pooled, _pre_circles, _variant_dedup,
    )

    dev = jnp.asarray(img_rgb_u8)
    grey, edges, variants = jax.jit(
        lambda im: _pre_circles(im, cfg, None))(dev)
    keep, expand = _variant_dedup(cfg, variants.shape[0])
    pool = variants[jnp.asarray(keep)]
    circles, valid = jax.jit(
        lambda p: _circles_pooled(p, cfg, None))(pool)
    circles = np.asarray(circles)[np.asarray(expand)]
    valid = np.asarray(valid)[np.asarray(expand)]
    return ([circles[v][valid[v]] for v in range(len(expand))],
            np.asarray(pool), list(keep), list(expand))


def big_budget_stages(plane_u8, cfg):
    """Selection-stage intermediates at the OVERFLOW budgets for one plane."""
    from img2sgf_tpu.hough.circles import (
        circle_candidates, circle_finalize, circle_plane_state,
        propose_from_acc, radius_support_pool,
    )

    H, W = plane_u8.shape
    top_k = cfg.overflow_center_candidates
    prov = cfg.overflow_ring_candidates
    peak = cfg.overflow_peak_candidates

    def run(img):
        st = circle_plane_state(
            img, cfg.circle_canny_high, cfg.circle_min_radius,
            cfg.circle_max_radius, cfg.num_angle_bins,
            hysteresis_iters=cfg.hysteresis_iters, with_acc=True)
        ys, xs, pvalid, _ = propose_from_acc(
            st["acc"], cfg.circle_acc_threshold, top_k,
            block=cfg.propose_block,
            threshold_factor=cfg.propose_threshold_factor,
            margin_factor=cfg.overflow_margin_factor)
        ys_c, xs_c, votes, valid2, _ = circle_candidates(
            st["emask"], st["sx"], st["sy"], ys, xs, pvalid,
            cfg.circle_min_radius, cfg.circle_max_radius,
            cfg.circle_acc_threshold, H, W,
            prov_budget=prov, peak_budget=peak, dedupe_first=True)
        r_best, support = radius_support_pool(
            st["emask"][None], ys_c[None], xs_c[None], valid2[None],
            cfg.circle_min_radius, cfg.circle_max_radius)
        circles, accepted = circle_finalize(
            ys_c, xs_c, valid2, r_best[0], support[0],
            cfg.circle_acc_threshold, cfg.circle_min_dist,
            cfg.max_circles_per_variant)
        return dict(ys1=ys, xs1=xs, valid1=pvalid, ys=ys_c, xs=xs_c,
                    evotes=votes, valid2=valid2, support=support[0],
                    circles=circles, accepted=accepted)

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(jnp.asarray(plane_u8)))


def blame(st, cx, cy, tol, acc_thresh):
    d1 = np.hypot(st["xs1"] + 0.5 - cx, st["ys1"] + 0.5 - cy)
    if not (st["valid1"] & (d1 <= tol + 2.5)).any():
        return "notprop"
    d2 = np.hypot(st["xs"] + 0.5 - cx, st["ys"] + 0.5 - cy)
    near = d2 <= tol
    votes_ok = near & (st["evotes"] > acc_thresh)
    if not votes_ok.any():
        return "votes"
    if not (votes_ok & st["valid2"]).any():
        return "nms"
    if not (votes_ok & st["valid2"] & (st["support"] > acc_thresh)).any():
        return "radius"
    return "greedy"


def main(names):
    if "--cpu" in names:
        names.remove("--cpu")
        jax.config.update("jax_platforms", "cpu")
    from img2sgf_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    from img2sgf_tpu.config import DetectionConfig
    from reference_headless import detect_circles, preprocess as ref_preprocess

    cfg = DetectionConfig()
    tol = 2.0
    for name in names:
        img = Image.open(f"{FIXTURES}/{name}.jpg").convert("RGB")
        rgb = np.asarray(img, np.uint8)
        import cv2 as cv

        rgb_ref = ref_preprocess(img)
        grey_ref = cv.cvtColor(rgb_ref, cv.COLOR_BGR2GRAY)
        edges_ref = cv.Canny(rgb_ref, 50, 200, apertureSize=3, L2gradient=False)
        _, per_variant = detect_circles(rgb_ref, grey_ref, edges_ref, cfg.maxblur)

        mine_per_v, pool, keep, expand = production_circles_per_variant(rgb, cfg)
        print(f"=== {name} ({rgb.shape[0]}x{rgb.shape[1]})", flush=True)
        tot_ref = tot_mine = tot_miss = tot_extra = 0
        miss_by_plane = {}
        for v in range(len(per_variant)):
            ref = np.asarray(per_variant[v]).reshape(-1, 3)
            mine = mine_per_v[v]
            tot_ref += len(ref)
            tot_mine += len(mine)
            used = np.zeros(len(mine), bool)
            miss = []
            for c in ref:
                d = (np.hypot(mine[:, 0] - c[0], mine[:, 1] - c[1])
                     if len(mine) else np.array([np.inf]))
                j = int(np.argmin(d)) if len(mine) else -1
                if j >= 0 and d[j] <= tol and not used[j]:
                    used[j] = True
                else:
                    miss.append(c)
            extra = int((~used).sum())
            tot_miss += len(miss)
            tot_extra += extra
            if miss or extra:
                print(f"  v{v}: ref={len(ref):4d} mine={len(mine):4d} "
                      f"miss={len(miss):3d} extra={extra:3d} "
                      f"missing={[(round(float(c[0]),1), round(float(c[1]),1), round(float(c[2]),2)) for c in miss]}")
            if miss:
                miss_by_plane.setdefault(expand[v], []).extend(miss)
        print(f"  TOTAL ref={tot_ref} mine={tot_mine} miss={tot_miss} "
              f"extra={tot_extra}", flush=True)
        blames = {}
        for uidx, misses in sorted(miss_by_plane.items()):
            st = big_budget_stages(pool[uidx], cfg)
            for c in misses:
                b = blame(st, float(c[0]), float(c[1]), tol,
                          cfg.circle_acc_threshold)
                blames.setdefault(b, []).append(
                    (uidx, round(float(c[0]), 1), round(float(c[1]), 1)))
        if blames:
            print(f"  BLAME: { {k: v for k, v in blames.items()} }", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["ex4", "ex5", "ex12"])
