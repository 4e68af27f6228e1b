"""The full detection pipeline: RGB image -> board + diagnostics.

One jittable program reproducing process_image + find_grid + identify_board
(img2sgf.py:117-204, 546-576, 497-543) minus the GUI: preprocess, grey,
Canny, blur pyramid, HoughCircles over all variants, circle erasure, Hough
lines, clustering, grid validation, stone snapping and classification.

detect_board() is pure and static-shaped: batch it with jax.vmap, shard it
with shard_map over a data mesh (see img2sgf_tpu.parallel).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp

from ..config import DetectionConfig
from ..core.board import align_board_jnp
from ..grid.cluster import cluster_1d
from ..grid.complete import validate_grid
from ..grid.identify import identify_board
from ..hough.circles import (
    circle_finalize,
    circle_plane_state,
    circle_candidates,
    propose_from_acc,
    radius_support_pool,
)
from ..hough.erase import erase_circles
from ..hough.lines import hough_lines_intercepts
from ..ops.blur import blur_pyramid
from ..ops.canny import canny
from ..ops.color import grey_bgr_quirk, preprocess


@dataclasses.dataclass
class BoardResult:
    """Pipeline output pytree (all fixed-shape device arrays)."""

    board_ready: Any  # bool: grid valid and fits the board
    valid_grid: Any  # bool
    full_board: Any  # [19,19] int32 BoardStates (LEFT/TOP aligned)
    detected_board: Any  # [19,19] int32, top-left hsize x vsize block
    hsize: Any
    vsize: Any
    side_to_move: Any  # 1 black / 2 white
    num_black: Any
    num_white: Any
    # diagnostics (mirror the reference's log/plot data)
    circles: Any  # [C,3] all raw circles from every variant
    circles_valid: Any
    circles_filtered_valid: Any  # after the size filter (img2sgf.py:439-443)
    hlines: Any  # [L] y-intercepts of detected horizontal lines
    hlines_valid: Any
    vlines: Any
    vlines_valid: Any
    hcentres: Any  # [M] cluster centres (+inf padded)
    hcount: Any
    vcentres: Any
    vcount: Any
    hcentres_complete: Any
    vcentres_complete: Any
    hspace: Any
    vspace: Any
    hreason: Any  # grid rejection reason codes (grid.complete)
    vreason: Any
    hdiag: Any  # [6] narration diagnostics per axis (grid.validate_axis)
    vdiag: Any
    intensities: Any  # [19,19] mean window intensity per grid point
    stone_mask: Any  # [19,19] bool
    grey: Any  # [H,W] uint8 processed grey image
    edges: Any  # [H,W] uint8 Canny edges
    circles_removed: Any  # [H,W] uint8 edge map after erasure


jax.tree_util.register_dataclass(
    BoardResult, data_fields=[f.name for f in dataclasses.fields(BoardResult)],
    meta_fields=[],
)


def _variant_dedup(cfg: DetectionConfig, V: int):
    """Identity-blur dedup: cv.medianBlur / cv.GaussianBlur at ksize 1 are
    identities (img2sgf.py:174-175 with k=1), so variants 2 and 3 equal
    variant 0 (grey). Detection is a deterministic function of the plane,
    so run unique planes once and replicate the outputs — bit-identical to
    the reference's 10 runs at 8/10 of the work."""
    if cfg.maxblur >= 0 and V >= 4:
        keep = [0, 1] + list(range(4, V))
        expand = [0, 1, 0, 0] + list(range(2, 2 + V - 4))
    else:
        keep = list(range(V))
        expand = keep
    return keep, expand


def _pre_rgb(rgb_u8, cfg: DetectionConfig, hw):
    """Preprocess + grey (img2sgf.py:142-153)."""
    with jax.named_scope("preprocess"):
        rgb = preprocess(rgb_u8, cfg.contrast, cfg.brightness, hw=hw)
        return rgb, grey_bgr_quirk(rgb)


def _pre_circles(rgb_u8, cfg: DetectionConfig, hw, edges=None):
    """Preprocess through the blur pyramid (img2sgf.py:142-175).

    edges: precomputed outer Canny for the preprocessed image (the batch
    path computes it for the whole batch at once via canny_rgb_pool's
    shared bit-packed hysteresis); None = compute per-image here.
    """
    rgb, grey = _pre_rgb(rgb_u8, cfg, hw)
    if edges is None:
        with jax.named_scope("canny"):
            edges = canny(rgb, cfg.edge_min, cfg.edge_max, cfg.gradient_l2,
                          iters=cfg.hysteresis_iters, hw=hw)
    with jax.named_scope("blur_pyramid"):
        variants = blur_pyramid(grey, edges, cfg.maxblur, hw=hw)
    return grey, edges, variants


def _plane_state_pool(planes, cfg: DetectionConfig, hw_planes):
    """Budget-independent per-plane circle state (internal Canny, walk
    steps, cascade accumulator) over a pool of [P, H, W] planes.

    Computed ONCE per plane; the budget-dependent selection stages
    (_circles_from_state) can then run repeatedly — base budget first,
    big-budget overflow for saturated planes — without redoing the ~60%
    of stage-1 cost that doesn't depend on any capacity knob.

    Chunks the plane axis (CP planes per lax.map step) to bound the size
    of each fused program and the live intermediates.

    The accumulator runs OUTSIDE the per-plane map when the byte-packed
    pooled cascade's bounds hold (the defaults): 4 planes share each
    uint32 element, so each vector op moves 4 planes
    (hough.circles.vote_accumulator_packed4, bit-exact). The internal
    Canny's hysteresis also runs OUTSIDE the map: one shared bit-packed
    fixed-point loop over all P planes (ops.canny.canny_pool, 32 planes
    per uint32) replaces P per-plane sweeps.
    """
    from ..hough.circles import cascade_pool_eligible, vote_accumulator_pool_labels
    from ..ops.canny import canny_pool

    P = planes.shape[0]
    CP = 16 if P % 16 == 0 else (8 if P % 8 == 0 else P)
    pooled_acc = cascade_pool_eligible(
        cfg.num_angle_bins, cfg.circle_min_radius, cfg.circle_max_radius
    )

    with jax.named_scope("canny_pool"):
        edges_pool = canny_pool(
            planes, max(cfg.circle_canny_high / 2, 1), cfg.circle_canny_high,
            iters=cfg.hysteresis_iters, hw_planes=hw_planes,
        )

    def state(img, edges, hw):
        return circle_plane_state(
            img, cfg.circle_canny_high, cfg.circle_min_radius,
            cfg.circle_max_radius, cfg.num_angle_bins,
            hysteresis_iters=cfg.hysteresis_iters, hw=hw,
            with_acc=not pooled_acc, edges=edges,
        )

    with jax.named_scope("circle_plane_state"):
        if hw_planes is None:
            st = jax.lax.map(
                lambda t: jax.vmap(lambda im, e: state(im, e, None))(*t),
                (
                    planes.reshape(P // CP, CP, *planes.shape[1:]),
                    edges_pool.reshape(P // CP, CP, *planes.shape[1:]),
                ),
            )
        else:
            st = jax.lax.map(
                lambda t: jax.vmap(
                    lambda im, e, h, w: state(im, e, (h, w)))(*t),
                (
                    planes.reshape(P // CP, CP, *planes.shape[1:]),
                    edges_pool.reshape(P // CP, CP, *planes.shape[1:]),
                    hw_planes[0].reshape(P // CP, CP),
                    hw_planes[1].reshape(P // CP, CP),
                ),
            )
        st = jax.tree_util.tree_map(
            lambda x: x.reshape(P, *x.shape[2:]), st
        )
    if pooled_acc:
        with jax.named_scope("cascade_packed4"):
            st["acc"] = vote_accumulator_pool_labels(
                st.pop("lbl"), cfg.num_angle_bins,
                cfg.circle_min_radius, cfg.circle_max_radius,
            )
    return st


def _circles_from_state(st, cfg: DetectionConfig, hw_planes,
                        top_k: int | None = None,
                        prov_budget: int | None = None,
                        peak_budget: int | None = None,
                        dedupe_first: bool = False,
                        margin_filter: bool = False,
                        skip_saturated: bool = False):
    """Budget-dependent circle selection from precomputed plane state.

    Stages 1b-2 (proposal top-k, exact patch votes, recentre/NMS) are
    vmapped per plane; the radius/support stage runs over the FLAT pool so
    its chunked skip-dead-work branch stays outside any vmap (see
    radius_support_pool). top_k / prov_budget / peak_budget override the
    config capacities (the overflow pass). Returns (circles [P, max_out,
    3], valid [P, max_out], sat [P] bool) — sat flags planes where a
    capacity TRUNCATED candidates (exact counts, not filled-slot
    heuristics), i.e. the plane needs the big-budget rerun.

    margin_filter: prune proposals below the measured carrier floor
    (cfg.carrier_floor_factor — see the config field and
    propose_from_acc's select_floor; applied in both the base and the
    overflow pass, no-op when the config disables it).
    skip_saturated (base-pass mode under an enabled overflow): zero out
    ALL proposals of proposal-saturated planes right after the propose
    stage — their base results are replaced wholesale by the big-budget
    rerun (_circles_pooled), so their rescore/radius work is pure waste
    (the rescore's and the radius pool's dead-chunk skips turn zero
    proposals into ~zero cost).
    """
    H, W = st["acc"].shape[-2], st["acc"].shape[-1]
    top_k = cfg.max_center_candidates if top_k is None else top_k
    prov_budget = cfg.max_ring_candidates if prov_budget is None else prov_budget
    peak_budget = cfg.max_peak_candidates if peak_budget is None else peak_budget

    sel_floor = None
    if margin_filter and cfg.carrier_floor_factor is not None:
        sel_floor = cfg.carrier_floor_factor * cfg.circle_acc_threshold
    with jax.named_scope("circle_propose"):
        if hw_planes is None:
            ys, xs, pvalid, psat = jax.vmap(
                lambda a: propose_from_acc(
                    a, cfg.circle_acc_threshold, top_k,
                    block=cfg.propose_block,
                    threshold_factor=cfg.propose_threshold_factor,
                    margin_factor=cfg.overflow_margin_factor,
                    select_floor=sel_floor,
                )
            )(st["acc"])
        else:
            ys, xs, pvalid, psat = jax.vmap(
                lambda a, h, w: propose_from_acc(
                    a, cfg.circle_acc_threshold, top_k, hw=(h, w),
                    block=cfg.propose_block,
                    threshold_factor=cfg.propose_threshold_factor,
                    margin_factor=cfg.overflow_margin_factor,
                    select_floor=sel_floor,
                )
            )(st["acc"], hw_planes[0], hw_planes[1])
        if skip_saturated:
            pvalid = pvalid & jnp.logical_not(psat)[:, None]
    with jax.named_scope("circle_candidates"):
        if hw_planes is None:
            ys_c, xs_c, votes, valid2, ring_sat = jax.vmap(
                lambda e, a, b, y, x, v: circle_candidates(
                    e, a, b, y, x, v, cfg.circle_min_radius,
                    cfg.circle_max_radius, cfg.circle_acc_threshold, H, W,
                    prov_budget=prov_budget, peak_budget=peak_budget,
                    dedupe_first=dedupe_first,
                )
            )(st["emask"], st["sx"], st["sy"], ys, xs, pvalid)
        else:
            ys_c, xs_c, votes, valid2, ring_sat = jax.vmap(
                lambda e, a, b, y, x, v, h, w: circle_candidates(
                    e, a, b, y, x, v, cfg.circle_min_radius,
                    cfg.circle_max_radius, cfg.circle_acc_threshold, H, W,
                    hw=(h, w),
                    prov_budget=prov_budget, peak_budget=peak_budget,
                    dedupe_first=dedupe_first,
                )
            )(st["emask"], st["sx"], st["sy"], ys, xs, pvalid,
              hw_planes[0], hw_planes[1])
    with jax.named_scope("circle_radius"):
        r_best, support = radius_support_pool(
            st["emask"], ys_c, xs_c, valid2,
            cfg.circle_min_radius, cfg.circle_max_radius,
        )
    with jax.named_scope("circle_finalize"):
        circles, valid = jax.vmap(
            lambda y, x, v, r, s: circle_finalize(
                y, x, v, r, s, cfg.circle_acc_threshold,
                cfg.circle_min_dist, cfg.max_circles_per_variant,
                packed_sort=cfg.circle_max_radius <= 44,
            )
        )(ys_c, xs_c, valid2, r_best, support)
    return circles, valid, psat | ring_sat


def _circles_on_planes(planes, cfg: DetectionConfig, hw_planes,
                       top_k: int | None = None,
                       prov_budget: int | None = None,
                       peak_budget: int | None = None):
    """Circle detection over a pool of [P, H, W] planes
    (_plane_state_pool + _circles_from_state)."""
    st = _plane_state_pool(planes, cfg, hw_planes)
    return _circles_from_state(st, cfg, hw_planes, top_k=top_k,
                               prov_budget=prov_budget,
                               peak_budget=peak_budget)


def _overflow_chunk(P: int) -> int:
    """Rerun-chunk width for the overflow pass: a divisor of P so chunks
    reshape cleanly, SMALL so the saturated-plane-sorted prefix wastes
    few innocent planes per big-budget chunk (RP=4 runs the big pass on
    at most 3 unsaturated planes, at the price of more chunk steps)."""
    for c in (4, 6, 8, 2, 16, 1):
        if c <= P and P % c == 0:
            return c
    return P


def _circles_pooled(planes, cfg: DetectionConfig, hw_planes):
    """_circles_on_planes with saturation-gated, per-plane-compacted
    overflow.

    Dense scans (ex5-class: thousands of junk accumulator maxima crowding
    real peaks) need a much larger proposal budget than clean diagrams for
    cv2 parity (measured worst needed vote-order rank: ~5.3k on ex5, vs
    <200 on typical diagrams). Static budgets can't be content-adaptive,
    but compute can: compute the budget-independent plane state ONCE
    (_plane_state_pool), run the base-budget selection, then rerun ONLY
    the saturated planes' selection at the big budget — Canny/cascade are
    shared, not recomputed. Saturated plane INDICES are sorted to the
    front and the big-budget selection runs over fixed chunks of
    _overflow_chunk(P) planes under a sequential lax.map whose per-chunk
    lax.cond is a REAL branch (lax.map lowers to scan, not vmap), so
    chunks with no saturated plane cost ~nothing — even their state
    gather sits inside the branch. Overflow cost is therefore
    proportional to the number of saturated planes (VERDICT r2 weak #2),
    and saturation itself is an exact truncation count (propose_from_acc
    / provisional_ring n_live), not a filled-slot heuristic, so an
    exactly-filled budget no longer triggers a spurious rerun. Proposal
    truncation is additionally margin-gated (propose_from_acc
    margin_factor / DetectionConfig.overflow_margin_factor): overflowing
    the budget with sub-margin junk maxima — the steady state on dense
    planes — cannot have dropped a proposal that carries a cv2-accepted
    peak, so only a truncation that cut into >= margin votes reruns.
    Unsaturated planes keep their base results; they would be identical
    under either budget (the valid candidate set is the same, selection
    is a pure function of it).
    """
    st = _plane_state_pool(planes, cfg, hw_planes)
    kb = cfg.overflow_center_candidates
    if kb <= cfg.max_center_candidates:
        # overflow disabled by config: there is no big-budget rerun to
        # escape to, so a saturated plane's truncation is FINAL — use the
        # vote-ordered unique-peak selection (dedupe_first) so it keeps
        # the strongest candidates instead of arbitrary first-in-stream
        # rows (the base pass below can afford the cheaper stream-order
        # compaction only because its truncations trigger the rerun)
        circles, valid, _ = _circles_from_state(
            st, cfg, hw_planes, dedupe_first=True,
            margin_filter=True)
        return circles, valid
    circles, valid, sat = _circles_from_state(
        st, cfg, hw_planes, skip_saturated=True,
        margin_filter=True)

    P = planes.shape[0]
    RP = _overflow_chunk(P)
    order = jnp.argsort(jnp.logical_not(sat), stable=True)
    inv = jnp.argsort(order)
    sat_chunk = jnp.any(sat[order].reshape(P // RP, RP), axis=1)
    prov = max(cfg.overflow_ring_candidates, cfg.max_ring_candidates)
    peak = max(cfg.overflow_peak_candidates, cfg.max_peak_candidates)

    def big_chunk(args):
        idx, any_sat = args

        def run():
            # gather ONLY this chunk's precomputed plane state (the gather
            # sits inside the cond branch, so unsaturated chunks pay
            # nothing); Canny/cascade are NOT recomputed at the big budget
            stc = jax.tree_util.tree_map(lambda a: a[idx], st)
            hwc = (None if hw_planes is None
                   else (hw_planes[0][idx], hw_planes[1][idx]))
            # dedupe_first: the big pass has no further rerun to trigger,
            # so its peak budget must apply to UNIQUE peaks (dense scans
            # carry ~2.5x duplicate emissions; see compact_candidates)
            c, v, _ = _circles_from_state(
                stc, cfg, hwc, top_k=kb, prov_budget=prov, peak_budget=peak,
                dedupe_first=True, margin_filter=True,
            )
            return c, v

        def skip():
            return (
                jnp.zeros((RP, cfg.max_circles_per_variant, 3), jnp.float32),
                jnp.zeros((RP, cfg.max_circles_per_variant), jnp.bool_),
            )

        return jax.lax.cond(any_sat, run, skip)

    big_c, big_v = jax.lax.map(
        big_chunk, (order.reshape(P // RP, RP), sat_chunk)
    )
    big_c = big_c.reshape(P, -1, 3)[inv]
    big_v = big_v.reshape(P, -1)[inv]
    circles = jnp.where(sat[:, None, None], big_c, circles)
    valid = jnp.where(sat[:, None], big_v, valid)
    return circles, valid


def _post_circles(grey, edges, circles, circles_valid, cfg: DetectionConfig,
                  line_threshold, hw) -> BoardResult:
    """Erasure through board assembly (img2sgf.py:188-198, 230-576)."""
    # --- erase circles from the edge map (img2sgf.py:188-198)
    with jax.named_scope("erase_circles"):
        removed = erase_circles(edges, circles, circles_valid, hw=hw)

    # --- lines + clustering (img2sgf.py:230-332)
    with jax.named_scope("hough_lines"):
        hvals, hvalid, _ = hough_lines_intercepts(
            removed, line_threshold, True, cfg.angle_delta, cfg.max_lines
        )
        vvals, vlvalid, _ = hough_lines_intercepts(
            removed, line_threshold, False, cfg.angle_delta, cfg.max_lines
        )
    with jax.named_scope("cluster"):
        hcentres, hcount = cluster_1d(hvals, hvalid, cfg.min_grid_spacing, cfg.max_grid_lines)
        vcentres, vcount = cluster_1d(vvals, vlvalid, cfg.min_grid_spacing, cfg.max_grid_lines)

    # --- grid validation (img2sgf.py:420-445)
    grid = validate_grid(
        hcentres, hcount, vcentres, vcount,
        cfg.board_size, cfg.min_grid_spacing, cfg.big_space_ratio,
    )
    valid = grid["valid"]

    # circle size filter (img2sgf.py:439-443), strict inequalities
    min_cs = jnp.minimum(grid["hspace"], grid["vspace"]) * 0.3
    max_cs = jnp.maximum(grid["hspace"], grid["vspace"]) * 0.65
    cf_valid = circles_valid & (circles[:, 2] > min_cs) & (circles[:, 2] < max_cs)
    cf_valid = cf_valid & valid

    # size gate (img2sgf.py:568-571)
    fits = valid & (grid["hsize"] <= cfg.board_size) & (grid["vsize"] <= cfg.board_size)

    ident = identify_board(
        grey, circles, cf_valid, grid, cfg.black_stone_threshold, cfg.board_size,
        hw=hw,
    )
    detected = jnp.where(fits, ident["detected_board"], 0)
    full = align_board_jnp(
        detected, grid["hsize"], grid["vsize"],
        jnp.bool_(False), jnp.bool_(False), cfg.board_size,
    )

    return BoardResult(
        board_ready=fits,
        valid_grid=valid,
        full_board=full,
        detected_board=detected,
        hsize=grid["hsize"],
        vsize=grid["vsize"],
        side_to_move=jnp.where(fits, ident["side_to_move"], 1),
        num_black=jnp.where(fits, ident["num_black"], 0),
        num_white=jnp.where(fits, ident["num_white"], 0),
        circles=circles,
        circles_valid=circles_valid,
        circles_filtered_valid=cf_valid,
        hlines=hvals,
        hlines_valid=hvalid,
        vlines=vvals,
        vlines_valid=vlvalid,
        hcentres=hcentres,
        hcount=hcount,
        vcentres=vcentres,
        vcount=vcount,
        hcentres_complete=grid["hcentres_complete"],
        vcentres_complete=grid["vcentres_complete"],
        hspace=grid["hspace"],
        vspace=grid["vspace"],
        hreason=grid["hreason"],
        vreason=grid["vreason"],
        hdiag=grid["hdiag"],
        vdiag=grid["vdiag"],
        intensities=ident["intensities"],
        stone_mask=ident["stone_mask"],
        grey=grey,
        edges=edges,
        circles_removed=removed,
    )


def _hw_pool(hw, P: int):
    """Broadcast one image's content dims over its P variant planes."""
    if hw is None:
        return None
    return (jnp.broadcast_to(jnp.asarray(hw[0]), (P,)),
            jnp.broadcast_to(jnp.asarray(hw[1]), (P,)))


def detect_board(rgb_u8, cfg: DetectionConfig, line_threshold=None,
                 content_hw=None) -> BoardResult:
    """rgb_u8: [H, W, 3] uint8. line_threshold: scalar (traced ok);
    defaults to cfg.line_threshold (img2sgf.py:44) when omitted — callers
    that mirror the GUI/CLI auto-tuning pass choose_line_threshold(h, w).

    content_hw=(h, w) (traced scalars ok): shape-bucketed mode — rgb_u8 is
    a fixed-size canvas whose top-left [h, w] block is the real image, and
    results match running the pipeline at native [h, w] size. One compiled
    program then serves every image that fits the canvas (the GUI's
    zoom-to-region and the CLI would otherwise recompile per image shape).

    Returns BoardResult. Jit with cfg static:
        jax.jit(detect_board, static_argnums=1)
    """
    if line_threshold is None:
        line_threshold = float(cfg.line_threshold)
    hw = content_hw
    grey, edges, variants = _pre_circles(rgb_u8, cfg, hw)
    keep, expand = _variant_dedup(cfg, variants.shape[0])
    planes = variants[jnp.asarray(keep)]
    vcircles_u, vvalid_u = _circles_pooled(
        planes, cfg, _hw_pool(hw, len(keep))
    )
    vcircles = vcircles_u[jnp.asarray(expand)]
    vvalid = vvalid_u[jnp.asarray(expand)]
    return _post_circles(
        grey, edges, vcircles.reshape(-1, 3), vvalid.reshape(-1),
        cfg, line_threshold, hw,
    )


@functools.partial(jax.jit, static_argnums=1)
def detect_board_jit(rgb_u8, cfg: DetectionConfig, line_threshold):
    return detect_board(rgb_u8, cfg, line_threshold)


# canvas-size ladder for shape-bucketed execution: one compile per bucket
# instead of one per exact image shape (GUI zoom changes the crop shape on
# every drag; CLI images vary). Ratios ~1.25 bound padding waste to <2x area.
_BUCKETS = (128, 160, 192, 256, 320, 384, 512, 640, 768, 960, 1280, 1600, 2048)


def bucket_dim(n: int) -> int:
    """Smallest ladder canvas dim >= n (multiples of 512 beyond the ladder)."""
    for b in _BUCKETS:
        if n <= b:
            return b
    return -(-n // 512) * 512


@functools.partial(jax.jit, static_argnums=1)
def _detect_board_bucket_jit(rgb_canvas, cfg: DetectionConfig, line_threshold,
                             h, w):
    return detect_board(rgb_canvas, cfg, line_threshold, content_hw=(h, w))


def detect_board_auto(rgb_np, cfg: DetectionConfig, line_threshold) -> BoardResult:
    """Host entry: run one [h, w, 3] uint8 image via the shared bucketed
    program (results match native-size detection; see detect_board's
    content_hw). Image-plane diagnostics are cropped back to [h, w]."""
    import numpy as np

    h, w = int(rgb_np.shape[0]), int(rgb_np.shape[1])
    hb, wb = bucket_dim(h), bucket_dim(w)
    canvas = np.zeros((hb, wb, 3), np.uint8)
    canvas[:h, :w] = np.asarray(rgb_np, np.uint8)
    res = _detect_board_bucket_jit(jnp.asarray(canvas), cfg, line_threshold, h, w)
    return dataclasses.replace(
        res,
        grey=res.grey[:h, :w],
        edges=res.edges[:h, :w],
        circles_removed=res.circles_removed[:h, :w],
    )


def _detect_batch_impl(rgb_u8_batch, cfg: DetectionConfig, line_thresholds,
                       hs=None, ws=None):
    """Batched pipeline: pre/post stages vmapped per image, circle stages
    pooled over the flat [B x unique-variant] plane axis so the radius
    stage's skip-dead-chunks branch runs for real (outside vmap)."""
    from ..ops.canny import canny_rgb_pool

    B = rgb_u8_batch.shape[0]
    # outer Canny pooled over the batch: one bit-packed hysteresis loop for
    # all B images (XLA CSEs the duplicated elementwise preprocess)
    if hs is None:
        rgbp = jax.vmap(lambda im: _pre_rgb(im, cfg, None)[0])(rgb_u8_batch)
        edges_b = canny_rgb_pool(rgbp, cfg.edge_min, cfg.edge_max,
                                 cfg.gradient_l2, iters=cfg.hysteresis_iters)
        grey, edges, variants = jax.vmap(
            lambda im, e: _pre_circles(im, cfg, None, edges=e)
        )(rgb_u8_batch, edges_b)
    else:
        rgbp = jax.vmap(
            lambda im, h, w: _pre_rgb(im, cfg, (h, w))[0]
        )(rgb_u8_batch, hs, ws)
        edges_b = canny_rgb_pool(rgbp, cfg.edge_min, cfg.edge_max,
                                 cfg.gradient_l2, iters=cfg.hysteresis_iters,
                                 hw_batch=(hs, ws))
        grey, edges, variants = jax.vmap(
            lambda im, e, h, w: _pre_circles(im, cfg, (h, w), edges=e)
        )(rgb_u8_batch, edges_b, hs, ws)
    keep, expand = _variant_dedup(cfg, variants.shape[1])
    Vu = len(keep)
    planes = variants[:, jnp.asarray(keep)]
    pool = planes.reshape(B * Vu, planes.shape[2], planes.shape[3])
    if hs is None:
        hwp = None
    else:
        hwp = (jnp.repeat(hs, Vu), jnp.repeat(ws, Vu))
    vcirc_u, vval_u = _circles_pooled(pool, cfg, hwp)
    vcirc = vcirc_u.reshape(B, Vu, -1, 3)[:, jnp.asarray(expand)]
    vval = vval_u.reshape(B, Vu, -1)[:, jnp.asarray(expand)]
    circles = vcirc.reshape(B, -1, 3)
    circles_valid = vval.reshape(B, -1)
    if hs is None:
        return jax.vmap(
            lambda g, e, c, cv, t: _post_circles(g, e, c, cv, cfg, t, None)
        )(grey, edges, circles, circles_valid, line_thresholds)
    return jax.vmap(
        lambda g, e, c, cv, t, h, w: _post_circles(g, e, c, cv, cfg, t, (h, w))
    )(grey, edges, circles, circles_valid, line_thresholds, hs, ws)


@functools.partial(jax.jit, static_argnums=1)
def detect_board_batch(rgb_u8_batch, cfg: DetectionConfig, line_thresholds):
    """Batched pipeline over a [B, H, W, 3] batch."""
    return _detect_batch_impl(rgb_u8_batch, cfg, line_thresholds)


@functools.partial(jax.jit, static_argnums=1)
def detect_board_bucket_batch(canvases, cfg: DetectionConfig, line_thresholds,
                              hs, ws):
    """Batched shape-bucketed pipeline: [B, Hc, Wc, 3] canvases whose
    top-left [hs[i], ws[i]] blocks are the real images (mixed native sizes
    share one compiled program per canvas bucket — the serving path)."""
    return _detect_batch_impl(canvases, cfg, line_thresholds, hs, ws)
