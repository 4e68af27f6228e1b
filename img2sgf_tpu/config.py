"""Detection configuration.

One frozen dataclass holding every tunable of the reference pipeline plus the
static capacity knobs a jitted build needs (fixed shapes under jit).

Reference field origins (file:line in /root/reference/img2sgf.py):
  board_size=19                 :43
  line_threshold default 80     :44   (usually auto-chosen, see choose_line_threshold)
  black_stone_threshold=128     :45-46
  edge_min/edge_max=50/200      :47-48
  sobel_aperture=3              :49
  gradient L1                   :50
  maxblur=3 (-> blur k=1,3,5,7) :51
  angle_tolerance=1 degree      :52-53
  min_grid_spacing=10 px        :54
  big_space_ratio=1.6           :55
  contrast/brightness=70/50     :56-57
  HoughCircles(dp=1, minDist=10, param1=100, param2=30, r in [1,30])  :180
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    # Board / grid model
    board_size: int = 19
    min_grid_spacing: float = 10.0
    big_space_ratio: float = 1.6

    # Line detection (Hough). line_threshold is the DEFAULT vote threshold
    # (img2sgf.py:44): detect_board uses it when no per-call threshold is
    # given; the CLI/GUI normally auto-choose one per image size instead
    # (choose_line_threshold, mirroring img2sgf.py:638,721).
    line_threshold: int = 80
    angle_tolerance_deg: float = 1.0

    # Stone colour classification
    black_stone_threshold: float = 128.0

    # Canny edge detection
    edge_min: float = 50.0
    edge_max: float = 200.0
    sobel_aperture: int = 3
    gradient_l2: bool = False

    # Preprocess
    contrast: float = 70.0
    brightness: float = 50.0

    # Blur pyramid for circle detection: k = 1, 3, ..., 2*maxblur+1
    maxblur: int = 3

    # Circle detection (OpenCV HOUGH_GRADIENT semantics, img2sgf.py:180)
    circle_min_dist: float = 10.0
    circle_canny_high: float = 100.0   # param1; internal Canny runs (param1/2, param1)
    circle_acc_threshold: float = 30.0  # param2; centre vote + radius support threshold
    circle_min_radius: int = 1
    circle_max_radius: int = 30

    # --- static-shape capacity knobs (not present in the reference; the
    # reference uses dynamic Python lists, we use fixed-capacity arrays+counts)
    max_circles_per_variant: int = 384  # accepted circles kept per blur
    #                                     variant. Must exceed the densest
    #                                     fixture's per-variant cv2 accept
    #                                     count (measured worst: ex3 v5 =
    #                                     214; 192 truncated it). Cost of
    #                                     headroom is small: finalize's
    #                                     greedy runs over the candidate
    #                                     pool either way, this only sizes
    #                                     the output arrays.
    max_lines: int = 512                # max Hough line intercepts per direction
    max_grid_lines: int = 64            # max cluster centres per axis
    num_angle_bins: int = 64            # gradient-direction bins for circle voting
    max_center_candidates: int = 2048    # accumulator peaks considered per
    #                                     variant (base pass). Selection work
    #                                     is proportional to the LIVE count,
    #                                     not the budget (exact_rescore's
    #                                     chunked map skips dead chunks), so
    #                                     headroom is cheap; 2048 keeps the
    #                                     512^2 bench batch out of the
    #                                     overflow rerun entirely (measured
    #                                     r4: worst plane n_margin=1745) and
    #                                     carries ex4 v9's rank-1027
    #                                     sub-margin proposal in base.
    max_ring_candidates: int = 1024     # provisional +-2 ring cells verified
    #                                     per variant (hough.circles
    #                                     .provisional_ring budget)
    overflow_center_candidates: int = 16384  # big-budget rerun capacity when
    #                                     a plane SATURATES the base candidate
    #                                     budget (real maxima may have been
    #                                     truncated). ex5's junk-dense planes
    #                                     saturate even 6144 (measured r4:
    #                                     cv2-needed carriers at vote-order
    #                                     rank 4398+) and the truncation cost
    #                                     4 of the 6 round-3 circle deltas;
    #                                     sparse images never saturate, so a
    #                                     lax.cond pays for the big pass only
    #                                     when needed (pipeline.detect
    #                                     ._circles_pooled). <= base disables.
    overflow_ring_candidates: int = 8192  # ring budget inside the big pass.
    #                                     Ring cells pass an exact >param2
    #                                     vote test, so the stream is real
    #                                     peaks; 3072 truncated cv2-accepted
    #                                     cells on ex5/ex12 (r4 root-cause)
    max_peak_candidates: int = 1024     # unique exact-NMS peaks kept per
    #                                     variant after dedupe+compaction
    #                                     (hough.circles.compact_candidates).
    #                                     Sizes the radius/finalize stages;
    #                                     overflowing it saturates the plane
    #                                     like a proposal-budget fill.
    #                                     Measured worst base-pass unique
    #                                     peak count: 426 (bench dense
    #                                     synthetics); real scans run lower.
    overflow_peak_candidates: int = 8192  # peak budget inside the big pass
    #                                     (unique peaks; measured worst on
    #                                     ex5 ~2.6k — headroom is cheap)
    propose_threshold_factor: float = 0.6  # proposal floor as a fraction of
    #                                     circle_acc_threshold. The cascade
    #                                     accumulator under-votes true peaks
    #                                     (direction quantization + rounding
    #                                     smear), so proposals use a lower
    #                                     bar and the exact rescore restores
    #                                     true votes. Measured over every
    #                                     cv2-accepted circle on all 17
    #                                     positive fixtures (4950 circles):
    #                                     the best proposal near a kept
    #                                     circle never falls below 21 votes
    #                                     except two circles invisible at
    #                                     ANY factor (the known ex4/ex16
    #                                     residual); 0.6 (=18) loses nothing
    #                                     vs the old 0.5 and prunes ~6x the
    #                                     junk maxima on dense content; the
    #                                     first marginal loss appears at 0.7
    #                                     (=21, ex8). Raise only with a
    #                                     fresh margin measurement.
    overflow_margin_factor: float = 0.7  # overflow-trigger vote gate, as a
    #                                     fraction of circle_acc_threshold.
    #                                     A proposal-budget truncation needs
    #                                     the big-budget rerun only if it cut
    #                                     into proposals that could carry a
    #                                     cv2-accepted peak — and the same
    #                                     fixture-wide margin measurement
    #                                     behind propose_threshold_factor
    #                                     shows every kept circle's best
    #                                     proposal carries >= 0.7 * param2
    #                                     (= 21) approximate votes. Dense
    #                                     planes whose sub-21 junk maxima
    #                                     overflow the budget (the steady
    #                                     state on dense scans: measured
    #                                     ~3000 qualifying maxima per
    #                                     Gaussian-k7 plane at 512^2, junk
    #                                     hovering at the 18-vote floor) no
    #                                     longer rerun big. <= propose_
    #                                     threshold_factor restores the
    #                                     pure-count trigger.
    carrier_floor_factor: float | None = 0.65  # proposal-selection prune,
    #                                     applied in BOTH the base and the
    #                                     big-budget pass: proposals whose
    #                                     approximate votes fall below
    #                                     factor * circle_acc_threshold
    #                                     (0.65 = 19.5 at the defaults,
    #                                     i.e. integer votes <= 19) are
    #                                     dropped before the exact-vote
    #                                     rescore — they are pure rescore
    #                                     cost unless they carry a
    #                                     cv2-accepted peak. Measured
    #                                     carrier floor over the committed
    #                                     per-variant golden streams
    #                                     (ex4/ex5/ex12, every cv2 circle's
    #                                     best cheb-2 accumulator vote,
    #                                     2026-08-20): minimum 20.0 (ex4 v9
    #                                     at (127,360) — the rank-1027 case
    #                                     that falsifies 0.7 as a carrier
    #                                     bound), next-lowest 26/27. 0.65
    #                                     keeps every measured carrier with
    #                                     half a vote of headroom and
    #                                     prunes the 19-vote junk band
    #                                     (dense planes hover at the >18
    #                                     proposal floor). This is a
    #                                     fixture-measured bound, not a
    #                                     proof; None disables the prune
    #                                     and restores the full 0.6x floor
    #                                     at ~10-15% selection cost.
    #                                     test_circle_residual.py is the
    #                                     regression net.
    propose_block: int = 1              # proposal compaction: keep the top
    #                                     cell per BxB block of the masked
    #                                     cascade accumulator before top_k
    #                                     (1 = every NMS maximum competes;
    #                                     >1 spends the candidate budget on
    #                                     distinct regions instead of
    #                                     clusters of near-duplicate maxima)
    hysteresis_iters: int = 256         # Canny hysteresis sweep bound. The
    #                                     sweep loop early-exits on
    #                                     convergence (while_loop), so the
    #                                     bound is runtime-free for converged
    #                                     images; it must sit above the
    #                                     worst-case fixture (ex17 at
    #                                     1193x1135 needs >24, <=64 sweeps —
    #                                     24 left 152 wrong edge pixels)
    rescore_cells: int = 5              # exact-vote patch width (3 or 5; 5 =
    #                                     true-NMS multi-emission recentre —
    #                                     REQUIRED for cv2-exact selection
    #                                     (hough.circles.circle_recentre);
    #                                     3 = legacy argmax diagnostics path

    def __post_init__(self):
        # sobel_aperture is a documented-static field: the reference never
        # changes it from 3 (img2sgf.py:49) and ops/sobel.py implements the
        # 3x3 stencil only. Reject silently-ignored values.
        if self.sobel_aperture != 3:
            raise ValueError(
                "sobel_aperture must be 3 (the only aperture the reference "
                "uses and ops/sobel.py implements)"
            )

    @property
    def angle_delta(self) -> float:
        import math

        return math.pi / 180.0 * self.angle_tolerance_deg

    @property
    def num_blur_variants(self) -> int:
        # grey, edges, then (median, gaussian) per blur radius (img2sgf.py:171-175)
        return 2 + 2 * (self.maxblur + 1)

    def replace(self, **kw) -> "DetectionConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def fast(cls, **kw) -> "DetectionConfig":
        """Serving preset: same exact detection algorithm over a reduced
        blur pyramid (maxblur=2: the k=7 median/Gaussian pair is dropped,
        leaving 6 unique planes instead of 8 — PARITY.md measured the
        4-plane maxblur=1 preset losing real fixtures and rejected it).

        The reference runs HoughCircles on blurs up to k=7 (img2sgf.py:
        169-175) purely for recall on degraded scans. Measured contract
        (docs/PARITY.md, previous accelerator): bit-exact boards on every
        clean printed fixture, but NOT a parity mode — 16/18 detect
        agreement (ex17 lost, ex11 spurious) and small stone deltas on the
        dense scans (ex5 0.992, ex12 0.983). Use the default config for
        hard book scans; re-run `tools/parity_report.py --fast` after any
        detection change.
        """
        return cls(maxblur=2, **kw)


def choose_line_threshold(height: int, width: int) -> int:
    """Auto line-detection threshold from image size.

    Mirrors choose_threshold (img2sgf.py:606-613): t = min_dim/12.8 + 16,
    clamped to [20, 200].
    """
    x = min(height, width)
    t = int(x / 12.8 + 16)
    return int(min(max(t, 20), 200))
