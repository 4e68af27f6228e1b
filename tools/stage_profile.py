"""Per-stage device time of the detection pipeline on the GPU.

    python tools/stage_profile.py [--out DIR]

1. Traces the 768-bucket batch of chip_smoke.py (8 rendered diagrams,
   default DetectionConfig) with jax.profiler and sums device time per
   jax.named_scope stage (canny_pool, circle_candidates, circle_radius, ...),
   plus the device's busy and idle share over the traced window.
2. Times Canny hysteresis on a synthetic 1280x1280 plane that needs many
   sweeps: one strong seed at the end of a staircase of horizontal runs,
   each run joined to the next only diagonally, so each sweep crosses one
   run. Both the single-plane loop (ops.canny.hysteresis) and the
   bit-packed pool (hysteresis_pool, 32 planes) are timed.
3. Times one 1280-class image end to end (detect_board_auto).
4. Shows what TF32 would do to the grid's cluster sums: the one-hot dot of
   grid.cluster at default and at HIGHEST precision against float64.

XLA's command buffers (CUDA graphs) are turned off here, so that each HLO
op is its own event in the trace; the step time printed is under that
setting (chip_smoke.py reports the default one). Every number is printed
beside the card's name and power limit; a JSON summary goes to
DIR/stage_profile.json (default profile_out/). Needs a GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# innermost named_scope wins; order does not matter. Work outside every
# scope (grid validation, stone classification, the overflow map) is
# reported as "unscoped".
SCOPES = (
    "preprocess", "canny", "blur_pyramid", "canny_pool", "circle_plane_state",
    "cascade_packed4", "circle_propose", "circle_candidates", "circle_radius",
    "circle_finalize", "erase_circles", "hough_lines", "cluster",
)


def median_time(fn, reps: int = 5):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def op_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> innermost known named_scope of its op_name
    (scopes under vmap appear as "vmap(name)")."""
    out = {}
    pat = re.compile(
        r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name=\"([^\"]*)\"")
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if not m:
            continue
        hits = [t for t in re.findall(r"\w+", m.group(2)) if t in SCOPES]
        out[m.group(1)] = hits[-1] if hits else "unscoped"
    return out


def reduce_trace(trace_dir: str, scopes: dict, n_runs: int):
    """(device ms per scope per run, busy share, window ms, top ops).

    Device events are taken from the GPU plane's "XLA Ops" line (one event
    per HLO op) and mapped to scopes by their hlo_op name; names missing
    from the compiled module's text count as "unmapped". Busy share is the
    union of kernel intervals on the stream lines over the window."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb"))[-1]
    pd = ProfileData.from_file(path)
    plane = [p for p in pd.planes if p.name.startswith("/device:GPU")][0]
    op_lines = [ln for ln in plane.lines if ln.name == "XLA Ops"]
    kern_lines = [ln for ln in plane.lines if ln.name.startswith("Stream")]
    per, by_op = {}, {}
    for ln in op_lines or kern_lines:
        for ev in ln.events:
            name = dict(ev.stats).get("hlo_op", ev.name)
            sc = scopes.get(name, "unmapped")
            ms = ev.duration_ns / 1e6
            per[sc] = per.get(sc, 0.0) + ms
            by_op[(name, sc)] = by_op.get((name, sc), 0.0) + ms
    iv = sorted((ev.start_ns, ev.start_ns + ev.duration_ns)
                for ln in (kern_lines or op_lines) for ev in ln.events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (iv[-1][1] - iv[0][0]) if iv else 0.0
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:15]
    return ({k: v / n_runs for k, v in sorted(per.items())},
            busy / window if window else 0.0, window / 1e6,
            [(n, sc, ms / n_runs) for (n, sc), ms in top])


def staircase(n: int = 1280, width: int = 20):
    """(strong, cand, runs): runs of `width` pixels, run r in row r, joined
    to run r+1 only through a diagonal step; one strong seed at (0, 0)."""
    runs = n // width
    cand = np.zeros((n, n), bool)
    for r in range(runs):
        cand[r, r * width:(r + 1) * width] = True
    strong = np.zeros((n, n), bool)
    strong[0, 0] = True
    return strong, cand, runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "profile_out"))
    opts = ap.parse_args(argv)

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=").strip()
    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        print("no GPU found", file=sys.stderr)
        return 1
    from chip_smoke import BATCH_SPECS, bucket_batch, render_diagram
    from img2sgf_tpu import DetectionConfig, choose_line_threshold
    from img2sgf_tpu.compile_cache import enable_compile_cache
    from img2sgf_tpu.ops.canny import hysteresis, hysteresis_pool
    from img2sgf_tpu.pipeline import (
        detect_board_auto, detect_board_bucket_batch)

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out_dir = pathlib.Path(opts.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    summary = {"card": card, "device_kind": jax.devices()[0].device_kind,
               "xla_flags": os.environ["XLA_FLAGS"]}
    cfg = DetectionConfig()

    # 1. stage breakdown of the 768-bucket batch
    canv, thr, hs, ws, _ = bucket_batch(BATCH_SPECS)
    args = [jnp.asarray(a) for a in (canv, thr, hs, ws)]
    compiled = detect_board_bucket_batch.lower(
        args[0], cfg, *args[1:]).compile()
    scopes = op_scopes(compiled.as_text())
    step = median_time(lambda: compiled(*args))
    n_runs = 3
    # the trace is large: keep it out of the output directory
    with tempfile.TemporaryDirectory() as tdir:
        with jax.profiler.trace(tdir):
            for _ in range(n_runs):
                jax.block_until_ready(compiled(*args))
        per, busy, window_ms, top = reduce_trace(tdir, scopes, n_runs)
    summary["batch768"] = {"images": int(canv.shape[0]), "step_s": step,
                           "scope_ms": per, "busy_share": busy,
                           "window_ms": window_ms, "top_ops": top}
    print(f"[{card}] 768 bucket batch of {canv.shape[0]}: step {step!r} s, "
          f"device busy share {busy!r} over {window_ms!r} ms", flush=True)
    for k, v in sorted(per.items(), key=lambda kv: -kv[1]):
        print(f"[{card}]   {k}: {v!r} ms/step", flush=True)
    for name, sc, ms in top:
        print(f"[{card}]   op {name} ({sc}): {ms!r} ms/step", flush=True)

    # 2. many-sweep hysteresis at 1280^2
    summary["hysteresis"] = []
    for width in (20, 6):
        strong, cand, runs = staircase(1280, width)
        s1, c1 = jnp.asarray(strong), jnp.asarray(cand)
        f1 = jax.jit(lambda s, c: hysteresis(s, c, cfg.hysteresis_iters))
        full = np.asarray(f1(s1, c1))
        sp = jnp.zeros((32, 1280, 1280), bool).at[0].set(s1)
        cp = jnp.zeros((32, 1280, 1280), bool).at[0].set(c1)
        fp = jax.jit(lambda s, c: hysteresis_pool(s, c, cfg.hysteresis_iters))
        pool = np.asarray(fp(sp, cp)[0])
        short = np.asarray(jax.jit(
            lambda s, c: hysteresis(s, c, runs - 1))(s1, c1))
        ok = (np.array_equal(full, cand) and np.array_equal(pool, cand)
              and not np.array_equal(short, cand))
        t1 = median_time(lambda: f1(s1, c1))
        tp = median_time(lambda: fp(sp, cp))
        rec = {"run_width": width, "sweeps_to_fixed_point": runs,
               "loop_sweeps": runs + 1, "exact": ok, "single_plane_s": t1,
               "pool32_s": tp}
        summary["hysteresis"].append(rec)
        print(f"[{card}] hysteresis 1280x1280 staircase, {runs} sweeps to "
              f"the fixed point ({runs + 1} loop sweeps), exact={ok}: "
              f"single plane {t1!r} s, 32-plane pool {tp!r} s", flush=True)

    # 3. one 1280-class image end to end
    rgb, _ = render_diagram(21, 1190, 1150, 19, 19)
    lt = choose_line_threshold(*rgb.shape[:2])
    t0 = time.perf_counter()
    jax.block_until_ready(detect_board_auto(rgb, cfg, lt))
    first = time.perf_counter() - t0
    t_img = median_time(lambda: detect_board_auto(rgb, cfg, lt))
    summary["image1280"] = {"shape": list(rgb.shape), "first_call_s": first,
                            "steady_s": t_img}
    print(f"[{card}] 1280 bucket image {rgb.shape[0]}x{rgb.shape[1]}: "
          f"first call {first!r} s, steady {t_img!r} s", flush=True)

    # 4. TF32 and the cluster sums
    rng = np.random.default_rng(0)
    vals = np.sort(rng.integers(0, 2560, 512)) * 0.5
    seg = np.minimum(np.arange(512) // 9, 63)
    onehot = (seg[None, :] == np.arange(64)[:, None]).astype(np.float32)
    want = onehot.astype(np.float64) @ vals
    errs = {}
    for name, prec in (("default", None),
                       ("highest", jax.lax.Precision.HIGHEST)):
        got = jnp.matmul(jnp.asarray(onehot), jnp.asarray(vals, jnp.float32),
                         precision=prec)
        errs[name] = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
    summary["cluster_sum_error_px"] = errs
    print(f"[{card}] cluster sums of 9 intercepts < 1280 px: max error "
          f"default precision {errs['default']!r}, HIGHEST "
          f"{errs['highest']!r}", flush=True)

    with open(out_dir / "stage_profile.json", "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
