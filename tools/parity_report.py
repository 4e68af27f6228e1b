"""End-to-end parity report: pipeline vs committed reference goldens.

Runs detect_board on fixture images (on whatever backend jax selects) and
compares the final board against
tests/golden/<name>/board.npy plus stage-level counts from summary.json.

Usage: python tools/parity_report.py [--fast] [fixture ...]
  --fast: use DetectionConfig.fast() (reduced blur pyramid serving preset)
          to measure its accuracy against the same goldens.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")

FIXTURES = pathlib.Path("/root/reference/test_images")
GOLDEN = pathlib.Path("/root/repo/tests/golden")


def main(names):
    from img2sgf_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from img2sgf_tpu.config import DetectionConfig, choose_line_threshold
    from img2sgf_tpu.hostio import load_rgb
    from img2sgf_tpu.pipeline import detect_board_auto

    fast = "--fast" in names
    names = [n for n in names if n != "--fast"]
    bins = cells = None
    for n in list(names):
        if n.startswith("--bins="):
            bins = int(n.split("=")[1])
            names.remove(n)
        elif n.startswith("--cells="):
            cells = int(n.split("=")[1])
            names.remove(n)
    cfg = DetectionConfig.fast() if fast else DetectionConfig()
    if bins is not None:
        cfg = cfg.replace(num_angle_bins=bins)
    if cells is not None:
        cfg = cfg.replace(rescore_cells=cells)
    files = sorted(GOLDEN.iterdir()) if not names else [GOLDEN / n for n in names]
    rows = []
    for gdir in files:
        if not (gdir / "summary.json").exists():
            continue
        name = gdir.name
        summary = json.loads((gdir / "summary.json").read_text())
        rgb = load_rgb(str(FIXTURES / summary["image"]))
        thr = choose_line_threshold(rgb.shape[0], rgb.shape[1])
        t0 = time.time()
        # bucketed path: results are bit-identical to native-size runs
        # (tests/test_bucketed.py) and 18 fixtures share ~8 canvas shapes,
        # so a cold-cache report compiles far fewer programs
        res = detect_board_auto(np.asarray(rgb), cfg, thr)
        ready = bool(res.board_ready)
        dt = time.time() - t0
        n_circ = int(np.asarray(res.circles_valid).sum())
        want_ready = summary["board_ready"]
        row = {
            "name": name,
            "time_s": round(dt, 1),
            "circles": f"{n_circ}/{summary['n_circles_raw']}",
            "grid": f"{int(res.hsize)}x{int(res.vsize)}/"
                    f"{summary['hsize']}x{summary['vsize']}",
            "ready": f"{ready}/{want_ready}",
        }
        if ready and want_ready:
            golden_board = np.load(gdir / "board.npy")
            got_board = np.asarray(res.full_board)
            agree = (golden_board == got_board).mean()
            row["board_acc"] = round(float(agree), 4)
            row["stones"] = (
                f"B{int(res.num_black)}/{summary['num_black']} "
                f"W{int(res.num_white)}/{summary['num_white']}"
            )
        rows.append(row)
        print(row, flush=True)
    exact = sum(1 for r in rows if r.get("board_acc") == 1.0)
    both_ready = sum(1 for r in rows if r["ready"] in ("True/True", "False/False"))
    print(f"\nready-status agreement: {both_ready}/{len(rows)}; exact boards: {exact}")


if __name__ == "__main__":
    main(sys.argv[1:])
