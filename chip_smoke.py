"""Smoke run of the detection pipeline on the GPU, through its public entry
points, at the default DetectionConfig.

    python chip_smoke.py               one card
    python chip_smoke.py --four-cards  the sharded detector over four cards

One card: a mixed batch of 8 rendered diagrams through
detect_board_bucket_batch (the CLI's --batch path, 768 canvas bucket), one
512-class image through detect_board_auto + to_sgf (the headless CLI path)
and, where Pillow is installed, through cli.main on a saved PNG. Every
board must equal the rendered truth; the integer outputs of the 512-class
image must equal the same program run on the CPU backend of this process;
the grid's cluster centres must equal float64 means of the detected line
intercepts to 1e-3 px.

Four cards: the same batch through parallel.make_sharded_detector over a
1-D mesh of four GPUs (one process), compared bit for bit with the batch
on one card.

Inputs are Go diagrams rendered with numpy from fixed seeds
(render_diagram). The script exits non-zero and prints no result when JAX
finds no GPU or any phase fails. Its last line of standard output is one
JSON object naming the device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPS = 7  # timed repetitions per program; the median is reported

# The 768-bucket batch: (seed, height, width, cols, rows); cols/rows 0 is
# the image with no board. Native sizes span 640-768 so all share one
# canvas; the no-board image is last so it lands in the last shard of a
# four-card mesh. On every spec the OpenCV reference algorithm
# (tools/reference_headless.py) reads the rendered truth exactly; some
# other seeds give it phantom stones in empty cells, which the k=7
# Gaussian variant rounds into circles.
BATCH_SPECS = (
    (1, 700, 720, 19, 19),
    (2, 768, 768, 19, 19),
    (10, 650, 690, 19, 19),
    (4, 660, 740, 13, 9),
    (5, 745, 700, 19, 19),
    (6, 720, 640, 10, 12),
    (7, 690, 760, 19, 19),
    (8, 700, 700, 0, 0),
)
# The 512-class image: a partial board, since a full 19x19 grid in 512 px
# has lines too close for the gap-cut clustering at 1 degree of tolerance.
SMALL_SPEC = (9, 480, 496, 12, 11)


def render_diagram(seed: int, height: int, width: int, cols: int = 19,
                   rows: int = 19, stone_prob: float = 0.25):
    """A printed Go diagram: 1-px grid, antialiased stones (black filled,
    white with a dark outline), light paper noise.

    cols/rows 0 draws a page with text-like blocks and no board. Returns
    (rgb [H, W, 3] uint8, truth [19, 19] int32 BoardStates, LEFT/TOP
    aligned and indexed [column, row] like BoardResult.full_board).
    """
    rng = np.random.default_rng(seed)
    paper = rng.uniform(232.0, 248.0)
    img = np.full((height, width), paper, np.float32)
    truth = np.zeros((19, 19), np.int32)
    if cols == 0:
        for _ in range(rng.integers(12, 20)):
            y = int(rng.integers(10, height - 20))
            x = int(rng.integers(10, width // 2))
            bh = int(rng.integers(4, 9))
            bw = int(rng.integers(20, width // 2))
            img[y:y + bh, x:x + bw] = rng.uniform(20.0, 80.0)
    else:
        s = int(min((width - 1) / (cols - 1 + 1.6),
                    (height - 1) / (rows - 1 + 1.6)))
        x0 = (width - (cols - 1) * s) // 2
        y0 = (height - (rows - 1) * s) // 2
        xs = x0 + s * np.arange(cols)
        ys = y0 + s * np.arange(rows)
        ink = 25.0
        for x in xs:
            img[ys[0]:ys[-1] + 1, x] = ink
        for y in ys:
            img[y, xs[0]:xs[-1] + 1] = ink
        yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
        r = 0.44 * s
        occ = rng.random((cols, rows)) < stone_prob
        black = rng.random((cols, rows)) < 0.5
        for i in range(cols):
            for j in range(rows):
                if not occ[i, j]:
                    continue
                cx, cy = float(xs[i]), float(ys[j])
                y_lo, y_hi = int(cy - r - 3), int(cy + r + 4)
                x_lo, x_hi = int(cx - r - 3), int(cx + r + 4)
                win = img[y_lo:y_hi, x_lo:x_hi]
                d = np.hypot(xx[y_lo:y_hi, x_lo:x_hi] - cx,
                             yy[y_lo:y_hi, x_lo:x_hi] - cy)
                fill = np.clip(r + 0.5 - d, 0.0, 1.0)
                tone = 20.0 if black[i, j] else 252.0
                win[...] = win * (1.0 - fill) + tone * fill
                if not black[i, j]:
                    ring = np.clip(1.25 - np.abs(d - (r - 0.75)), 0.0, 1.0)
                    win[...] = win * (1.0 - ring) + ink * ring
                truth[i, j] = 1 if black[i, j] else 2
    img += rng.normal(0.0, 1.5, img.shape).astype(np.float32)
    tint = rng.uniform(-6.0, 6.0, 3).astype(np.float32)
    rgb = np.clip(img[:, :, None] + tint, 0.0, 255.0)
    return np.rint(rgb).astype(np.uint8), truth


def truth_side(truth) -> int:
    """Side to move as the pipeline guesses it: black iff #black <= #white."""
    return 1 if (truth == 1).sum() <= (truth == 2).sum() else 2


def cluster_means64(values, valid, threshold: float):
    """Float64 single-linkage gap-cut means, the reference for cluster_1d."""
    v = np.sort(np.asarray(values, np.float64)[np.asarray(valid)])
    if v.size < 2:
        return np.zeros(0)
    seg = np.concatenate([[0], np.cumsum(np.diff(v) >= threshold)])
    return np.array([v[seg == k].mean() for k in range(seg[-1] + 1)])


class Smoke:
    """Collects named checks and labelled measurements for one run."""

    def __init__(self, card: str):
        self.card = card
        self.failed: list[str] = []

    def check(self, name: str, ok: bool, detail: str = "") -> None:
        print(f"check {name}: {'PASS' if ok else 'FAIL'} {detail}".rstrip(),
              flush=True)
        if not ok:
            self.failed.append(name)

    def measure(self, name: str, **values) -> None:
        vals = " ".join(f"{k}={v}" for k, v in values.items())
        print(f"[{self.card}] {name}: {vals}", flush=True)


def timed(fn, reps: int = REPS):
    """(first-call seconds, median steady seconds, last result); every call
    is synced with block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return first, float(np.median(times)), out


def bucket_batch(specs):
    """Render specs and pad them into one canvas bucket, as cli.run_batch
    does. Returns (canvases, thresholds, hs, ws, truths)."""
    from img2sgf_tpu import choose_line_threshold
    from img2sgf_tpu.pipeline import bucket_dim

    imgs, truths = zip(*(render_diagram(*s) for s in specs))
    hb = max(bucket_dim(im.shape[0]) for im in imgs)
    wb = max(bucket_dim(im.shape[1]) for im in imgs)
    B = len(imgs)
    canv = np.zeros((B, hb, wb, 3), np.uint8)
    hs = np.zeros(B, np.int32)
    ws = np.zeros(B, np.int32)
    thr = np.zeros(B, np.float32)
    for i, im in enumerate(imgs):
        h, w = im.shape[:2]
        canv[i, :h, :w] = im
        hs[i], ws[i] = h, w
        thr[i] = choose_line_threshold(h, w)
    return canv, thr, hs, ws, np.stack(truths)


def check_boards(smoke: Smoke, tag: str, res, truths, ready_want) -> None:
    ready = np.asarray(res.board_ready)
    boards = np.asarray(res.full_board)
    sides = np.asarray(res.side_to_move)
    for i in range(len(truths)):
        if not ready_want[i]:
            smoke.check(f"{tag}[{i}] no board", not bool(ready[i]))
            continue
        bad = int((boards[i] != truths[i]).sum())
        smoke.check(f"{tag}[{i}] board == truth",
                    bool(ready[i]) and bad == 0
                    and int(sides[i]) == truth_side(truths[i]),
                    f"(ready={bool(ready[i])}, cells differing={bad})")


def check_clusters(smoke: Smoke, tag: str, res, threshold: float) -> None:
    """Cluster centres vs float64 means of the same intercepts."""
    worst = 0.0
    for axis in ("h", "v"):
        lines = np.asarray(getattr(res, f"{axis}lines"))
        valid = np.asarray(getattr(res, f"{axis}lines_valid"))
        centres = np.asarray(getattr(res, f"{axis}centres"))
        count = np.asarray(getattr(res, f"{axis}count"))
        if lines.ndim == 1:
            lines, valid, centres, count = (
                lines[None], valid[None], centres[None], count[None])
        for b in range(lines.shape[0]):
            want = cluster_means64(lines[b], valid[b], threshold)
            got = centres[b, :int(count[b])].astype(np.float64)
            if got.shape != want.shape:
                smoke.check(f"{tag}[{b}] {axis} cluster count", False,
                            f"({got.size} vs {want.size})")
                continue
            if got.size:
                worst = max(worst, float(np.max(np.abs(got - want))))
    smoke.check(f"{tag} cluster centres within 1e-3 px of float64 means",
                worst <= 1e-3, f"(max deviation {worst!r} px)")


def one_card(smoke: Smoke) -> None:
    import jax
    import jax.numpy as jnp

    from img2sgf_tpu import DetectionConfig, choose_line_threshold, to_sgf
    from img2sgf_tpu.pipeline import (
        bucket_dim, detect_board_auto, detect_board_bucket_batch)

    cfg = DetectionConfig()
    gpu = jax.devices()[0]

    # --- bulk path: the --batch program on the 768 bucket
    canv, thr, hs, ws, truths = bucket_batch(BATCH_SPECS)
    args = [jax.device_put(jnp.asarray(a), gpu) for a in (canv, thr, hs, ws)]
    first, med, res = timed(
        lambda: detect_board_bucket_batch(args[0], cfg, *args[1:]))
    B = canv.shape[0]
    smoke.measure(f"bulk detect_board_bucket_batch {B}x{canv.shape[1]}x"
                  f"{canv.shape[2]}", first_call_s=round(first, 3),
                  compile_s=round(first - med, 3), steady_s=round(med, 5),
                  images_per_s=round(B / med, 3))
    ready_want = [s[3] > 0 for s in BATCH_SPECS]
    check_boards(smoke, "bulk", res, truths, ready_want)
    check_clusters(smoke, "bulk", res, cfg.min_grid_spacing)

    # --- single-image path: detect_board_auto + to_sgf (run_headless)
    rgb, truth = render_diagram(*SMALL_SPEC)
    lt = choose_line_threshold(*rgb.shape[:2])
    first, med, single = timed(lambda: detect_board_auto(rgb, cfg, lt))
    smoke.measure(f"single detect_board_auto {rgb.shape[0]}x{rgb.shape[1]} "
                  f"({bucket_dim(max(rgb.shape[:2]))} bucket)",
                  first_call_s=round(first, 3),
                  compile_s=round(first - med, 3), steady_s=round(med, 5),
                  images_per_s=round(1 / med, 3))
    check_boards(smoke, "single", jax.tree_util.tree_map(
        lambda x: x[None], single), truth[None], [True])
    check_clusters(smoke, "single", single, cfg.min_grid_spacing)
    sgf = to_sgf(np.asarray(single.full_board), int(single.side_to_move))
    smoke.check("single to_sgf == truth SGF",
                sgf == to_sgf(truth, truth_side(truth)))

    # --- the same program on the CPU backend of this process
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    with jax.default_device(cpu):
        ref = jax.block_until_ready(detect_board_auto(rgb, cfg, lt))
    smoke.measure("CPU reference detect_board_auto (host CPU)",
                  first_call_s=round(time.perf_counter() - t0, 3))
    for f in ("board_ready", "full_board", "hsize", "vsize",
              "side_to_move", "grey", "edges"):
        a, b = np.asarray(getattr(single, f)), np.asarray(getattr(ref, f))
        smoke.check(f"GPU == CPU {f}", np.array_equal(a, b),
                    f"({int((a != b).sum())} elements differ)")
    cg = np.asarray(single.circles)[np.asarray(single.circles_valid)]
    cc = np.asarray(ref.circles)[np.asarray(ref.circles_valid)]
    same_n = cg.shape == cc.shape
    if same_n and cg.size:
        cg, cc = cg[np.lexsort(cg.T[::-1])], cc[np.lexsort(cc.T[::-1])]
        dc = float(np.max(np.abs(cg[:, :2] - cc[:, :2])))
        dr = float(np.max(np.abs(cg[:, 2] - cc[:, 2])))
    else:
        dc = dr = 0.0
    # Centres are integer cells + 0.5: exact. Radii are k/20 + min_r
    # evaluated in float32, whose last bit depends on how each backend
    # divides; distinct radii are >= 0.05 apart, so 1e-4 px tells the
    # same radius from a different one.
    smoke.check("GPU == CPU circles (centres exact, radii to 1e-4 px)",
                same_n and dc == 0.0 and dr <= 1e-4,
                f"(GPU {cg.shape[0]}, CPU {cc.shape[0]} circles, centre "
                f"deviation {dc!r}, radius deviation {dr!r})")

    # --- the CLI itself on a saved image file, where Pillow exists
    if importlib.util.find_spec("PIL") is None:
        print("Pillow is not installed: cli.main on an image file skipped")
    else:
        from PIL import Image

        from img2sgf_tpu import cli

        with tempfile.TemporaryDirectory() as d:
            src, out = os.path.join(d, "diagram.png"), os.path.join(d, "d.sgf")
            Image.fromarray(rgb).save(src)
            rc = cli.main([src, out])
            text = open(out).read() if os.path.exists(out) else ""
        smoke.check("cli.main on a PNG file", rc == 0 and text == sgf,
                    f"(rc={rc})")

    stats = gpu.memory_stats() or {}
    smoke.measure("device memory", peak_bytes_in_use=stats.get(
        "peak_bytes_in_use"))


def four_cards(smoke: Smoke) -> None:
    import jax
    import jax.numpy as jnp

    from img2sgf_tpu import DetectionConfig
    from img2sgf_tpu.parallel import (
        data_mesh, make_sharded_detector, shard_batch)
    from img2sgf_tpu.pipeline import detect_board_bucket_batch

    gpus = jax.devices()
    if len(gpus) < 4:
        smoke.check("four GPUs present", False, f"({len(gpus)} found)")
        return
    cfg = DetectionConfig()
    canv, thr, hs, ws, truths = bucket_batch(BATCH_SPECS)
    B = canv.shape[0]

    mesh = data_mesh(gpus[:4])
    run = make_sharded_detector(mesh, cfg, bucketed=True)
    sargs = [shard_batch(mesh, jnp.asarray(a)) for a in (canv, thr, hs, ws)]
    first, med, res4 = timed(lambda: run(*sargs))
    smoke.measure(f"four-card make_sharded_detector {B}x{canv.shape[1]}x"
                  f"{canv.shape[2]}", first_call_s=round(first, 3),
                  compile_s=round(first - med, 3), steady_s=round(med, 5),
                  images_per_s=round(B / med, 3))

    args = [jax.device_put(jnp.asarray(a), gpus[0])
            for a in (canv, thr, hs, ws)]
    first, med, res1 = timed(
        lambda: detect_board_bucket_batch(args[0], cfg, *args[1:]))
    smoke.measure(f"one-card detect_board_bucket_batch {B}x{canv.shape[1]}x"
                  f"{canv.shape[2]}", first_call_s=round(first, 3),
                  compile_s=round(first - med, 3), steady_s=round(med, 5),
                  images_per_s=round(B / med, 3))

    for f in ("board_ready", "full_board", "hsize", "vsize", "side_to_move",
              "num_black", "num_white"):
        a, b = np.asarray(getattr(res4, f)), np.asarray(getattr(res1, f))
        smoke.check(f"four cards == one card {f}", np.array_equal(a, b))
    check_boards(smoke, "four-card", res4, truths,
                 [s[3] > 0 for s in BATCH_SPECS])
    for d in gpus[:4]:
        smoke.measure(f"device {d.id} memory", peak_bytes_in_use=(
            d.memory_stats() or {}).get("peak_bytes_in_use"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded four-card path")
    opts = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform} devices only",
              file=sys.stderr)
        return 1

    from img2sgf_tpu.compile_cache import enable_compile_cache

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    card = card.splitlines()[0]
    print(f"compile cache: {enable_compile_cache()}", flush=True)

    smoke = Smoke(card)
    (four_cards if opts.four_cards else one_card)(smoke)
    if smoke.failed:
        print(f"{len(smoke.failed)} checks failed: {smoke.failed}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
