"""Benchmark: batched 512x512 diagram detection throughput on one chip.

Prints one JSON line per metric; the driver parses the LAST line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, ...}

The final line also carries:
  real_scan_img_s / large_scan_img_s   content-honest throughput on the
        reference fixtures at native size (768- and 1280-bucket classes),
        each with a parity digest against the committed cv2 goldens and a
        per-CLASS CPU-baseline ratio (the blended 18-fixture baseline
        over-weights small fixtures; see tools/baseline_perclass.py)
  fast_img_s   the --fast preset's throughput on the same 768 class
        (its accuracy contract is measured in docs/PARITY.md)
  stage_ms / bw_util   per-stage device time on the headline batch and
        the fraction of the device's memory-bandwidth peak each stage
        reaches (analytic bytes over stage time; peaks in PEAKS)

Baselines (single-thread CPU, reference algorithm re-run headlessly —
BASELINE.md): blended 18-fixture mean 6.66 img/s; per-class means in
PERCLASS_BASELINE below.
"""

from __future__ import annotations

import json
import time

import numpy as np

BASELINE_DIAGRAMS_PER_SEC = 6.66  # reference CPU, 18-fixture blend, BASELINE.md
# per-class single-thread CPU baselines, idle machine 2026-08-20
# (BASELINE.md "Per-class baseline"; tools/baseline_perclass.py)
PERCLASS_BASELINE = {768: 5.59, 1280: 3.44}
# Published peaks by jax device_kind (NVIDIA H100 SXM data sheet: dense
# rates, at the full 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "bf16_tflops": 989.0,
                              "f32_tflops": 67.0},
}


def device_peaks(device_kind: str) -> dict:
    """Peak rates of one device kind; an unknown kind is an error."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {device_kind!r}")
    return PEAKS[device_kind]


BATCH = 32
SIZE = 512


def make_batch(batch: int, size: int = 512) -> np.ndarray:
    """Synthetic Go-diagram batch: grids + stones rendered with numpy."""
    rng = np.random.default_rng(0)
    imgs = np.full((batch, size, size), 235, np.uint8)
    coords = np.linspace(30, size - 30, 19).astype(int)
    yy, xx = np.mgrid[0:size, 0:size]
    base = np.full((size, size), 235, np.uint8)
    for c in coords:
        base[c, coords[0] : coords[-1] + 1] = 10
        base[coords[0] : coords[-1] + 1, c] = 10
    r = int((coords[1] - coords[0]) * 0.45)
    for b in range(batch):
        img = base.copy()
        occ = rng.random((19, 19)) < 0.25
        colors = rng.random((19, 19)) < 0.5
        for i in range(19):
            for j in range(19):
                if occ[i, j]:
                    m = (xx - coords[i]) ** 2 + (yy - coords[j]) ** 2 <= r * r
                    img[m] = 15 if colors[i, j] else 250
        imgs[b] = img
    return np.repeat(imgs[:, :, :, None], 3, axis=3)


def _load_bucket(bucket: int):
    import pathlib
    import jax.numpy as jnp

    from img2sgf_tpu.config import choose_line_threshold
    from img2sgf_tpu.hostio import load_rgb
    from img2sgf_tpu.pipeline.detect import bucket_dim

    fdir = pathlib.Path("/root/reference/test_images")
    if not fdir.is_dir():
        return None
    imgs, names = [], []
    for f in sorted(fdir.glob("*.jpg")):
        rgb = load_rgb(str(f))
        h, w = rgb.shape[:2]
        if bucket_dim(h) == bucket and bucket_dim(w) == bucket:
            imgs.append(rgb)
            names.append(f.stem)
    if not imgs:
        return None
    B = len(imgs)
    canv = np.zeros((B, bucket, bucket, 3), np.uint8)
    hs = np.zeros(B, np.int32)
    ws = np.zeros(B, np.int32)
    thr = np.zeros(B, np.float32)
    for i, rgb in enumerate(imgs):
        h, w = rgb.shape[:2]
        canv[i, :h, :w] = rgb
        hs[i], ws[i] = h, w
        thr[i] = choose_line_threshold(h, w)
    return (jnp.asarray(canv), jnp.asarray(hs), jnp.asarray(ws),
            jnp.asarray(thr), names)


def bench_real_scans(cfg, sync, bucket: int = 768, with_parity: bool = True,
                     reps: int = 5):
    """Honest content-dependent throughput: the reference fixtures that
    share one canvas bucket, run at native size through the bucketed
    serving path. Returns (metric dict or None)."""
    import pathlib

    from img2sgf_tpu.pipeline import detect_board_bucket_batch

    loaded = _load_bucket(bucket)
    if loaded is None:
        return None
    canv, hs, ws, thr, names = loaded
    B = canv.shape[0]

    res = detect_board_bucket_batch(canv, cfg, thr, hs, ws)  # compile
    sync(res)
    t0 = time.perf_counter()
    for _ in range(reps):
        sync(detect_board_bucket_batch(canv, cfg, thr, hs, ws))
    dt = (time.perf_counter() - t0) / reps

    out = {
        "metric": (f"native-size reference scans/sec/chip "
                   f"({B} fixtures, {bucket} bucket)"),
        "value": round(B / dt, 2),
        "unit": "images/sec",
        "vs_baseline": round(B / dt / BASELINE_DIAGRAMS_PER_SEC, 2),
    }
    if bucket in PERCLASS_BASELINE:
        out["vs_class_baseline"] = round(
            B / dt / PERCLASS_BASELINE[bucket], 2)
    if not with_parity:
        return out

    # parity fingerprint (VERDICT r2 #3): the detection results are already
    # in hand — grade them against the committed cv2 goldens so every
    # BENCH_rN.json records whether throughput was bought with parity
    parity = {}
    gdir = pathlib.Path(__file__).parent / "tests" / "golden"
    ready = np.asarray(res.board_ready)
    boards = np.asarray(res.full_board)
    for i, name in enumerate(names):
        sfile = gdir / name / "summary.json"
        if not sfile.exists():
            continue
        want_ready = json.loads(sfile.read_text())["board_ready"]
        if bool(ready[i]) != want_ready:
            parity[name] = "READY_MISMATCH"
        elif want_ready:
            golden = np.load(gdir / name / "board.npy")
            parity[name] = round(float((golden == boards[i]).mean()), 4)
        else:
            parity[name] = "agree_not_ready"
    out["parity"] = parity
    return out


def bench_stages(cfg, images, thresholds):
    """Per-stage device time on the headline batch
    + analytic HBM-bandwidth utilization per stage. Four composite
    programs (pre / plane state / circle selection / post) — the full
    roofline story lives in tools/profile_batched.py."""
    import jax
    import jax.numpy as jnp

    from img2sgf_tpu.pipeline.detect import (
        _circles_pooled, _plane_state_pool, _post_circles, _pre_circles,
        _variant_dedup,
    )

    def one(fn, *args, reps=5):
        out = jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = jax.block_until_ready(fn(*args))
        return (time.perf_counter() - t0) * 1e3 / reps, out

    B = images.shape[0]
    size = images.shape[1]
    stage_ms = {}
    pre = jax.jit(jax.vmap(lambda im: _pre_circles(im, cfg, None)))
    stage_ms["pre"], (grey, edges, variants) = one(pre, images)
    keep, expand = _variant_dedup(cfg, variants.shape[1])
    Vu = len(keep)
    pool = variants[:, jnp.asarray(keep)].reshape(B * Vu, size, size)
    f_state = jax.jit(lambda p: _plane_state_pool(p, cfg, None))
    stage_ms["state"], _ = one(f_state, pool)
    f_pool = jax.jit(lambda p: _circles_pooled(p, cfg, None))
    t_all, (circ_u, val_u) = one(f_pool, pool)
    stage_ms["select"] = t_all - stage_ms["state"]
    vcirc = circ_u.reshape(B, Vu, -1, 3)[:, jnp.asarray(expand)]
    vval = val_u.reshape(B, Vu, -1)[:, jnp.asarray(expand)]
    f_post = jax.jit(jax.vmap(
        lambda g_, e, c, cv, t: _post_circles(g_, e, c, cv, cfg, t, None)))
    stage_ms["post"], _ = one(f_post, grey, edges,
                              vcirc.reshape(B, -1, 3), vval.reshape(B, -1),
                              thresholds)
    # analytic HBM bytes (see tools/profile_batched.py for the model)
    px = size * size
    P = B * Vu
    n_bins = cfg.num_angle_bins
    n_seg = (cfg.circle_max_radius - cfg.circle_min_radius + 1) // 5
    gb = {
        "pre": B * px * (3 + 16 + Vu + 2 + 24) / 1e9,
        "state": (P * px * 17 / 1e9 + (P / 32) * px * 96 / 1e9
                  + (P / 4) * n_bins * px * 4 * (1 + 1.4 * n_seg / 6) / 1e9),
        "select": P * px * 4 * 24 / 1e9,
        "post": B * px * 32 / 1e9,
    }
    hbm_gbps = device_peaks(jax.devices()[0].device_kind)["hbm_gbps"]
    bw_util = {k: round(gb[k] / hbm_gbps * 1e3 / stage_ms[k], 3)
               for k in gb if stage_ms.get(k, 0) > 0}
    return ({k: round(v, 1) for k, v in stage_ms.items()}, bw_util)


def main():
    import jax
    import jax.numpy as jnp

    from img2sgf_tpu.config import DetectionConfig, choose_line_threshold
    from img2sgf_tpu.pipeline import detect_board_batch

    cfg = DetectionConfig()
    images = jnp.asarray(make_batch(BATCH, SIZE))
    thresholds = jnp.full((BATCH,), float(choose_line_threshold(SIZE, SIZE)),
                          jnp.float32)

    res = jax.block_until_ready(
        detect_board_batch(images, cfg, thresholds))  # compile

    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        res = jax.block_until_ready(
            detect_board_batch(images, cfg, thresholds))
    dt = (time.perf_counter() - t0) / reps
    throughput = BATCH / dt

    ready = int(np.asarray(res.board_ready).sum())
    assert ready >= BATCH * 0.9, f"detection collapsed: {ready}/{BATCH} boards"

    # content-honest metrics on real book scans at native size (VERDICT r1
    # weak #7); the 1280 bucket is the large-scan class (VERDICT r3 #5)
    sync = jax.block_until_ready
    real = bench_real_scans(cfg, sync)
    if real is not None:
        print(json.dumps(real))
    big = bench_real_scans(cfg, sync, bucket=1280)
    if big is not None:
        print(json.dumps(big))

    # the --fast serving preset, same 768-bucket class (VERDICT r4 #4;
    # accuracy contract measured in docs/PARITY.md)
    fast = bench_real_scans(DetectionConfig.fast(), sync, with_parity=False)
    if fast is not None:
        fast["metric"] = "--fast preset " + fast["metric"]
        print(json.dumps(fast))

    stage_ms, bw_util = bench_stages(cfg, images, thresholds)

    final = {
        "metric": "512x512 diagrams/sec/chip (batched detection)",
        "value": round(throughput, 2),
        "unit": "images/sec",
        "vs_baseline": round(throughput / BASELINE_DIAGRAMS_PER_SEC, 2),
        "batch": BATCH,
        "real_scan_img_s": None if real is None else real["value"],
        "large_scan_img_s": None if big is None else big["value"],
        "fast_img_s": None if fast is None else fast["value"],
        "stage_ms": stage_ms,
        "bw_util": bw_util,
        "parity": None if real is None else real["parity"],
        "parity_1280": None if big is None else big["parity"],
    }
    # the driver parses the LAST line: keep the headline metric there
    print(json.dumps(final))


if __name__ == "__main__":
    from img2sgf_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
