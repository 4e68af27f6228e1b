"""Headless re-run of the reference detection algorithm (golden generator).

This module is a TEST UTILITY, not part of the shipped framework. It uses
OpenCV + scikit-learn to reproduce, stage by stage, what the reference GUI
tool computes (/root/reference/img2sgf.py), so we can commit golden outputs
(final boards + SGF + stage summaries) that the JAX pipeline is
judged against, and measure the reference's CPU performance for BASELINE.md.

Structured as pure functions over an explicit config; no GUI, no globals.
Every function cites the reference lines whose semantics it reproduces.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np

try:
    import cv2 as cv
    from sklearn.cluster import AgglomerativeClustering

    HAVE_CV = True
except ImportError:  # pragma: no cover
    HAVE_CV = False

from PIL import Image, ImageEnhance

BOARD_SIZE = 19
ANGLE_DELTA = math.pi / 180.0  # img2sgf.py:52-53
MIN_GRID_SPACING = 10  # :54
BIG_SPACE_RATIO = 1.6  # :55


@dataclass
class RefResult:
    valid_grid: bool = False
    board_ready: bool = False
    reasons: list = field(default_factory=list)
    log: list = field(default_factory=list)  # verbatim reference log lines
    circles_raw: np.ndarray | None = None  # all Hough hits, pre-filter
    circles: np.ndarray | None = None  # size-filtered
    hcentres: np.ndarray | None = None
    vcentres: np.ndarray | None = None
    hcentres_complete: np.ndarray | None = None
    vcentres_complete: np.ndarray | None = None
    hsize: int = 0
    vsize: int = 0
    hspace: float = 0.0
    vspace: float = 0.0
    detected_board: np.ndarray | None = None  # hsize x vsize, states
    full_board: np.ndarray | None = None  # 19x19
    stone_brightnesses: np.ndarray | None = None
    num_black: int = 0
    num_white: int = 0
    side_to_move: int = 1
    sgf: str | None = None
    timings: dict = field(default_factory=dict)
    # intermediates for op-level debugging (not committed)
    grey: np.ndarray | None = None
    edges: np.ndarray | None = None
    circles_removed: np.ndarray | None = None
    line_threshold: int = 0


def choose_threshold(w: int, h: int) -> int:
    # img2sgf.py:606-613
    t = int(min(w, h) / 12.8 + 16)
    return min(max(t, 20), 200)


def preprocess(img_pil: Image.Image, contrast: float = 70, brightness: float = 50):
    # img2sgf.py:142-150
    scaled_contrast = 102.0 / (101.0 - contrast) - 1.0
    img_pil = ImageEnhance.Contrast(img_pil).enhance(scaled_contrast)
    scaled_brightness = 450.0 / (200.0 - brightness) - 2.0
    img_pil = ImageEnhance.Brightness(img_pil).enhance(scaled_brightness)
    return np.array(img_pil)


def detect_circles(rgb: np.ndarray, grey: np.ndarray, edges: np.ndarray, maxblur: int = 3):
    # Blur pyramid + HoughCircles over each variant (img2sgf.py:169-186)
    blurs = [grey, edges]
    for i in range(maxblur + 1):
        b = 2 * i + 1
        blurs.append(cv.medianBlur(grey, b))
        blurs.append(cv.GaussianBlur(grey, (b, b), b))
    per_variant = []
    circles = np.zeros((0, 3), np.float32)
    for bimg in blurs:
        c = cv.HoughCircles(bimg, cv.HOUGH_GRADIENT, 1, 10, np.array([]), 100, 30, 1, 30)
        if c is not None and len(c) > 0:
            per_variant.append(c[0])
            circles = np.vstack((circles, c[0])) if len(circles) else c[0]
        else:
            per_variant.append(np.zeros((0, 3), np.float32))
    return circles, per_variant


def erase_circles(edges: np.ndarray, circles: np.ndarray) -> np.ndarray:
    # img2sgf.py:188-198
    out = edges.copy()
    for i in range(len(circles)):
        xc, yc, r = circles[i, :]
        r = r + 2
        ul = (int(round(xc - r)), int(round(yc - r)))
        lr = (int(round(xc + r)), int(round(yc + r)))
        middle = (int(round(xc)), int(round(yc)))
        cv.rectangle(out, ul, lr, (0, 0, 0), -1)
        cv.circle(out, middle, 1, (255, 255, 255), -1)
    return out


def find_lines(img: np.ndarray, threshold: int, horizontal: bool) -> np.ndarray:
    # img2sgf.py:230-255
    if horizontal:
        lines = cv.HoughLines(
            img, rho=1, theta=math.pi / 180.0, threshold=threshold,
            min_theta=math.pi / 2 - ANGLE_DELTA, max_theta=math.pi / 2 + ANGLE_DELTA,
        )
    else:
        v1 = cv.HoughLines(img, 1, math.pi / 180.0, threshold, min_theta=0, max_theta=ANGLE_DELTA)
        v2 = cv.HoughLines(
            img, 1, math.pi / 180.0, threshold,
            min_theta=math.pi - ANGLE_DELTA, max_theta=math.pi,
        )
        if v2 is not None:
            v2[:, 0, 0] = -v2[:, 0, 0]
            v2[:, 0, 1] = v2[:, 0, 1] - math.pi
            lines = np.vstack((v1, v2)) if v1 is not None else v2
        else:
            lines = v1
    return np.zeros((0, 1)) if lines is None else lines[:, 0, 0].reshape(-1, 1)


def cluster_centres(lines: np.ndarray) -> np.ndarray:
    # img2sgf.py:268-292: single-linkage agglomerative clustering, threshold 10
    if lines is None or len(lines) < 2:
        return np.zeros(0)
    model = AgglomerativeClustering(
        n_clusters=None, linkage="single", distance_threshold=MIN_GRID_SPACING
    )
    try:
        model.fit(lines)
    except Exception:
        return np.zeros(0)
    centres = np.zeros(model.n_clusters_)
    for i in range(model.n_clusters_):
        centres[i] = lines[model.labels_ == i].mean()
    centres.sort()
    return centres


def complete_grid(x: np.ndarray | None, reasons: list,
                  log=None) -> np.ndarray | None:
    # img2sgf.py:335-397. `log`, when given, receives the reference's
    # VERBATIM log messages (for narration-parity tests).
    log = log if log is not None else (lambda _m: None)
    if x is None or len(x) == 0:
        reasons.append("no grid lines")
        log("No grid lines found at all!")
        return None
    if len(x) == 1:
        reasons.append("only one grid line")
        log("Only found one grid line")
        return None
    spaces = x[1:] - x[:-1]
    min_space = spaces.min()
    if min_space < MIN_GRID_SPACING:
        reasons.append(f"grid lines too close: {min_space}")
        # five spaces before "pixels": verbatim img2sgf.py:351
        log("Grid lines are too close together: minimum spacing is "
            + str(min_space) + "     pixels")
        return None
    bound = min_space * BIG_SPACE_RATIO
    big_spaces = spaces[spaces > bound]
    if len(big_spaces) == 0:
        log("Got a complete grid of " + str(len(x)) + " lines")
        return x
    small_spaces = spaces[spaces <= bound]
    max_space = small_spaces.max()
    average_space = (min_space + max_space) / 2
    n = len(small_spaces)
    for s in big_spaces:
        n += int(round(s / average_space))
    if n > BOARD_SIZE + 2:
        reasons.append(f"grid span {n}x min space: extra lines?")
        log("Distance between edges of grid is " + str(n) + " times minimum space.")
        log("Extra lines on diagram, or a grid line detected twice?")
        return None
    n += 1
    log("Got " + str(len(x)) + " lines within a grid of size " + str(n))
    if len(x) < n:
        log("Filling in gaps.")
        answer = np.zeros(n)
        answer[0] = x[0]
        i, j = 1, 1
        for s in spaces:
            if s <= max_space:
                answer[i] = x[j]
                i += 1
                j += 1
            else:
                m = int(round(s / average_space))
                for k in range(m):
                    answer[i] = x[j - 1] + (k + 1) * s / m
                    i += 1
                j += 1
        return answer
    return x


def truncate_grid(x: np.ndarray | None, log=None) -> np.ndarray | None:
    # img2sgf.py:400-417
    log = log if log is not None else (lambda _m: None)
    if x is None:
        return None
    if len(x) == BOARD_SIZE + 2:
        log("Dropping two extra lines at the outsides of the grid")
        return x[1:-1]
    if len(x) == BOARD_SIZE + 1:
        log("Dropping one extra line at the end of the grid")
        return x[:-1]
    return x


def closest_index(a: float, x: np.ndarray) -> int:
    # img2sgf.py:448-459
    from bisect import bisect_left

    i = bisect_left(list(x), a)
    if i == 0:
        return 0
    if i == len(x):
        return i - 1
    return i - 1 if a - x[i - 1] <= x[i] - a else i


def run_pipeline(img_pil: Image.Image, contrast: float = 70, brightness: float = 50,
                 black_stone_threshold: float = 128, line_threshold: int | None = None,
                 maxblur: int = 3) -> RefResult:
    """Full reference pipeline on one image (as after open_file + process_image)."""
    assert HAVE_CV, "cv2/sklearn required for golden generation"
    res = RefResult()
    log = res.log.append  # verbatim reference log script (img2sgf.py log())
    t = {}
    t0 = time.perf_counter()

    if line_threshold is None:
        line_threshold = choose_threshold(*img_pil.size)  # :638
    res.line_threshold = line_threshold

    log("\nProcessing image")
    log("Contrast = " + str(contrast))
    log("Brightness = " + str(brightness))
    rgb = preprocess(img_pil.convert("RGB"), contrast, brightness)
    t["preprocess"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    log("Converting to greyscale")
    grey = cv.cvtColor(rgb, cv.COLOR_BGR2GRAY)  # BGR quirk on RGB data, :153
    log("Running Canny edge detection algorithm")
    edges = cv.Canny(rgb, 50, 200, apertureSize=3, L2gradient=False)  # :162-165
    t["grey_canny"] = time.perf_counter() - t1
    res.grey, res.edges = grey, edges

    t1 = time.perf_counter()
    log("Detecting circles")
    circles, _ = detect_circles(rgb, grey, edges, maxblur)
    t["circles"] = time.perf_counter() - t1
    res.circles_raw = np.array(circles, np.float32).reshape(-1, 3)

    t1 = time.perf_counter()
    removed = erase_circles(edges, res.circles_raw)
    t["erase"] = time.perf_counter() - t1
    res.circles_removed = removed

    t1 = time.perf_counter()
    hlines = find_lines(removed, line_threshold, True)
    vlines = find_lines(removed, line_threshold, False)
    log("Found " + str(len(hlines)) + " distinct horizontal lines and "
        + str(len(vlines)) + " distinct vertical lines")
    # cluster (reference recomputes lines inside, same result: img2sgf.py:269)
    hcentres = cluster_centres(hlines)
    vcentres = cluster_centres(vlines)
    log("Got " + str(len(hcentres)) + " horizontal and "
        + str(len(vcentres)) + " vertical grid lines")
    t["lines_cluster"] = time.perf_counter() - t1
    res.hcentres, res.vcentres = hcentres, vcentres

    # validate_grid (img2sgf.py:420-445)
    t1 = time.perf_counter()
    log("Assessing horizontal lines.")
    hc = truncate_grid(complete_grid(truncate_grid(hcentres, log), res.reasons, log), log)
    if hc is None:
        res.timings = t
        return res
    log("Assessing vertical lines.")
    vc = truncate_grid(complete_grid(truncate_grid(vcentres, log), res.reasons, log), log)
    if vc is None:
        res.timings = t
        return res
    res.valid_grid = True
    vsize, hsize = len(hc), len(vc)
    hspace = (hc[-1] - hc[0]) / vsize
    vspace = (vc[-1] - vc[0]) / hsize
    res.hcentres_complete, res.vcentres_complete = hc, vc
    res.hsize, res.vsize, res.hspace, res.vspace = hsize, vsize, hspace, vspace
    min_cs = min(hspace, vspace) * 0.3
    max_cs = max(hspace, vspace) * 0.65
    circles = np.array([c for c in res.circles_raw if min_cs < c[2] < max_cs], np.float32).reshape(-1, 3)
    res.circles = circles

    if hsize > BOARD_SIZE or vsize > BOARD_SIZE:  # img2sgf.py:568-571
        log("Too many vertical lines!" if hsize > BOARD_SIZE
            else "Too many horizontal lines!")
        res.reasons.append("too many lines")
        res.timings = t
        return res
    log("Guessing stone colours based on a threshold of "
        + str(black_stone_threshold))

    # identify_board (img2sgf.py:497-543)
    def average_intensity(i, j):
        x = vc[i]
        xmin, xmax = int(round(x - hspace / 2)), int(round(x + hspace / 2))
        y = hc[j]
        ymin, ymax = int(round(y - vspace / 2)), int(round(y + vspace / 2))
        xmin, ymin = max(0, xmin), max(0, ymin)
        xmax, ymax = min(grey.shape[1], xmax), min(grey.shape[0], ymax)
        return np.mean(grey[ymin:ymax, xmin:xmax])

    board = np.zeros((hsize, vsize))
    for c in circles:
        i = closest_index(c[0], vc)
        j = closest_index(c[1], hc)
        board[i, j] = 3  # STONE
    num_stones = int(np.count_nonzero(board))
    sb = np.zeros(num_stones)
    k = 0
    for j in range(hsize):
        for kk in range(vsize):
            if board[j, kk] == 3:
                sb[k] = average_intensity(j, kk)
                k += 1
    res.stone_brightnesses = sb
    res.num_black = int((sb <= black_stone_threshold).sum())
    res.num_white = num_stones - res.num_black
    res.side_to_move = 1 if res.num_black <= res.num_white else 2
    log("Detected " + str(res.num_black) + " black stone"
        + ("s" if res.num_black != 1 else "") + " and " + str(res.num_white)
        + " white stone" + ("s" if res.num_white != 1 else "") + " on a "
        + str(hsize) + "x" + str(vsize) + " board.")
    log("Guessing black to play" if res.num_black <= res.num_white
        else "Guessing white to play")
    for i in range(hsize):
        for j in range(vsize):
            if board[i, j] == 3:
                board[i, j] = 1 if average_intensity(i, j) <= black_stone_threshold else 2
    res.detected_board = board
    t["identify"] = time.perf_counter() - t1

    # align LEFT/TOP default (img2sgf.py:627), to_SGF (:781-810)
    full = np.zeros((BOARD_SIZE, BOARD_SIZE))
    full[:hsize, :vsize] = board
    res.full_board = full
    res.board_ready = True

    import sys
    sys.path.insert(0, "/root/repo")
    from img2sgf_tpu.core import to_sgf

    res.sgf = to_sgf(full.astype(int), side_to_move=res.side_to_move)
    t["total"] = time.perf_counter() - t0
    res.timings = t
    return res
