"""Per-variant circle-set diff: our HOUGH_GRADIENT vs cv2, with stage blame.

For each fixture, runs the reference's cv.HoughCircles per blur variant and
our hough_circles_gradient on the same (bit-exact) preprocessed planes, then
matches the accepted circle sets (centres within `tol` px). For circles cv2
accepts but we miss, drills into WHERE they were lost:
  notprop — never proposed at stage 1 (cascade peak missing / budget)
  votes   — proposed, but exact 3x3 votes never exceeded param2
  nms     — exact votes pass but OpenCV NMS pattern rejects the recentred cell
  radius  — vote-accepted but radius support <= param2
  greedy  — lost to minDist spacing against an earlier (different) acceptance

Usage: python tools/diag_circles_diff.py [fixture ...]   (default ex3 ex4 ex12)
"""

from __future__ import annotations

import sys

import numpy as np
from PIL import Image

sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/tools")

import jax
import jax.numpy as jnp

from img2sgf_tpu.config import DetectionConfig
from img2sgf_tpu.hough.circles import (
    centre_candidates, circle_finalize, circle_recentre, circle_votes,
    pixel_steps, radius_support_pool, vote_accumulator,
)
from img2sgf_tpu.ops.blur import blur_pyramid
from img2sgf_tpu.ops.canny import canny
from img2sgf_tpu.ops.color import grey_bgr_quirk, preprocess
from img2sgf_tpu.ops.sobel import sobel3

from reference_headless import detect_circles, preprocess as ref_preprocess

FIXTURES = "/root/reference/test_images"


def our_stages(variants, cfg):
    """Stage-by-stage intermediates for every variant plane."""

    def stage(v):
        dx, dy = sobel3(v.astype(jnp.int32))
        e2 = canny(v, cfg.circle_canny_high / 2, cfg.circle_canny_high,
                   iters=cfg.hysteresis_iters)
        emask = (e2 > 0) & ((dx != 0) | (dy != 0))
        acc = vote_accumulator(emask, dx, dy, cfg.num_angle_bins,
                               cfg.circle_min_radius, cfg.circle_max_radius)
        ys, xs, votes, valid = centre_candidates(
            acc, 0.5 * cfg.circle_acc_threshold, cfg.max_center_candidates)
        sx, sy = pixel_steps(dx, dy)
        sx = jnp.where(emask, sx, 0)
        sy = jnp.where(emask, sy, 0)
        H, W = v.shape
        ys = jnp.clip(ys, 0, H - 1)
        xs = jnp.clip(xs, 0, W - 1)
        patch = circle_votes(emask, sx, sy, ys, xs, valid,
                             cfg.circle_min_radius, cfg.circle_max_radius,
                             cells=cfg.rescore_cells)
        ys_c, xs_c, evotes, valid2 = circle_recentre(
            patch, ys, xs, valid, cfg.circle_acc_threshold, H, W)
        return dict(emask=emask, ys1=ys, xs1=xs, valid1=valid,
                    ys=ys_c, xs=xs_c, evotes=evotes, valid2=valid2)

    st = jax.jit(jax.vmap(stage))(variants)
    r_best, support = jax.jit(
        lambda e, y, x, v: radius_support_pool(
            e, y, x, v, cfg.circle_min_radius, cfg.circle_max_radius)
    )(st["emask"], st["ys"], st["xs"], st["valid2"])
    fin = jax.jit(jax.vmap(
        lambda y, x, v, r, s: circle_finalize(
            y, x, v, r, s, cfg.circle_acc_threshold, cfg.circle_min_dist,
            cfg.max_circles_per_variant)
    ))(st["ys"], st["xs"], st["valid2"], r_best, support)
    st["r_best"], st["support"] = r_best, support
    st["circles"], st["accepted"] = fin
    return jax.tree_util.tree_map(np.asarray, st)


def blame(st_v, cx, cy, tol, acc_thresh):
    """Why did our pipeline not accept a circle at (cx, cy)?"""
    ys1, xs1 = st_v["ys1"], st_v["xs1"]
    d1 = np.hypot(xs1 + 0.5 - cx, ys1 + 0.5 - cy)
    prop = st_v["valid1"] & (d1 <= tol + 1.5)  # pre-recentre: allow 1px drift
    if not prop.any():
        return "notprop"
    ys, xs = st_v["ys"], st_v["xs"]
    d2 = np.hypot(xs + 0.5 - cx, ys + 0.5 - cy)
    near = d2 <= tol
    votes_ok = near & (st_v["evotes"] > acc_thresh)
    if not votes_ok.any():
        return "votes" if not near.any() else "votes"
    if not (votes_ok & st_v["valid2"]).any():
        return "nms"
    if not (votes_ok & st_v["valid2"] & (st_v["support"] > acc_thresh)).any():
        return "radius"
    return "greedy"


def main(names):
    if "--cpu" in names:
        names.remove("--cpu")
        jax.config.update("jax_platforms", "cpu")
    from img2sgf_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    cfg = DetectionConfig()
    for n in list(names):
        if n.startswith("--cells="):
            cfg = cfg.replace(rescore_cells=int(n.split("=")[1]))
            names.remove(n)
    tol = 2.0
    for name in names:
        img = Image.open(f"{FIXTURES}/{name}.jpg").convert("RGB")
        rgb_ref = ref_preprocess(img)
        import cv2 as cv

        grey_ref = cv.cvtColor(rgb_ref, cv.COLOR_BGR2GRAY)
        edges_ref = cv.Canny(rgb_ref, 50, 200, apertureSize=3, L2gradient=False)
        _, per_variant = detect_circles(rgb_ref, grey_ref, edges_ref, cfg.maxblur)

        dev = jnp.asarray(np.asarray(img, np.uint8))
        rgb = preprocess(dev, cfg.contrast, cfg.brightness)
        grey = grey_bgr_quirk(rgb)
        edges = canny(rgb, cfg.edge_min, cfg.edge_max, cfg.gradient_l2,
                      iters=cfg.hysteresis_iters)
        variants = blur_pyramid(grey, edges, cfg.maxblur)
        st = our_stages(variants, cfg)

        print(f"=== {name} ({dev.shape[0]}x{dev.shape[1]})", flush=True)
        tot_miss = tot_extra = tot_ref = tot_mine = 0
        blames = {}
        for v in range(len(per_variant)):
            ref = np.asarray(per_variant[v]).reshape(-1, 3)
            mine_mask = st["accepted"][v]
            mine = st["circles"][v][mine_mask]
            tot_ref += len(ref)
            tot_mine += len(mine)
            used = np.zeros(len(mine), bool)
            miss = []
            for c in ref:
                d = np.hypot(mine[:, 0] - c[0], mine[:, 1] - c[1]) if len(mine) else np.array([np.inf])
                j = int(np.argmin(d)) if len(mine) else -1
                if j >= 0 and d[j] <= tol and not used[j]:
                    used[j] = True
                else:
                    miss.append(c)
            extra = (~used).sum()
            tot_miss += len(miss)
            tot_extra += int(extra)
            st_v = {k: st[k][v] for k in
                    ("ys1", "xs1", "valid1", "ys", "xs", "evotes", "valid2",
                     "support")}
            for c in miss:
                b = blame(st_v, c[0], c[1], tol, cfg.circle_acc_threshold)
                blames[b] = blames.get(b, 0) + 1
            if len(miss) or extra:
                print(f"  v{v}: ref={len(ref):4d} mine={len(mine):4d} "
                      f"miss={len(miss):3d} extra={int(extra):3d}")
        print(f"  TOTAL ref={tot_ref} mine={tot_mine} miss={tot_miss} "
              f"extra={tot_extra}  blame={blames}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["ex3", "ex4", "ex12"])
