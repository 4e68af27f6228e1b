"""Headless CLI: python -m img2sgf_tpu [--fast] input_image [output.sgf]

Mirrors the reference's argv semantics (img2sgf.py:1256-1269): arg1 is the
input image, arg2 the output SGF (default: input stem + .sgf). Unlike the
reference it runs without a GUI; pass --gui to open the editor instead.

Batch serving mode: python -m img2sgf_tpu --batch 'scans/*.jpg' -o out/
[--batch-size N] — groups mixed-size images by canvas bucket and converts
them through the vmapped bucketed pipeline (one compile per bucket).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .compile_cache import enable_compile_cache


def run_headless(input_path: str, output_path: str | None, verbose: bool = True,
                 fast: bool = False) -> int:
    enable_compile_cache()
    from .config import DetectionConfig, choose_line_threshold
    from .core import to_sgf
    from .hostio import load_rgb
    from .pipeline import detect_board_auto

    try:
        rgb = load_rgb(input_path)
    except (OSError, ValueError) as e:
        # reference shows an error dialog (img2sgf.py:650-656); headless
        # prints the same message and fails cleanly
        print(f"Error opening file {input_path}:\n{e}", file=sys.stderr)
        return 1
    cfg = DetectionConfig.fast() if fast else DetectionConfig()
    thr = choose_line_threshold(rgb.shape[0], rgb.shape[1])
    if verbose:
        print(f"Image size {rgb.shape[1]}x{rgb.shape[0]}, line threshold {thr}")
    # shape-bucketed execution: one compiled program per canvas bucket (plus
    # the persistent cache above) instead of a 20-90 s compile per image size
    res = detect_board_auto(rgb, cfg, thr)
    ready = bool(res.board_ready)
    if verbose:
        n_circ = int(np.asarray(res.circles_valid).sum())
        print(f"Found {n_circ} circles; grid "
              f"{int(res.hsize)}x{int(res.vsize)} valid={bool(res.valid_grid)}")
    if not ready:
        print("Board not detected! Things to try: select a smaller region, "
              "rotate the image, increase contrast or threshold.")
        return 1
    board = np.asarray(res.full_board)
    side = int(res.side_to_move)
    print(f"Detected {int(res.num_black)} black and {int(res.num_white)} white "
          f"stones on a {int(res.hsize)}x{int(res.vsize)} board; "
          f"{'black' if side == 1 else 'white'} to play")
    sgf = to_sgf(board, side_to_move=side)
    if output_path is None:
        output_path = os.path.splitext(input_path)[0] + ".sgf"
    with open(output_path, "w") as f:
        f.write(sgf)
    print(f"Saved to file {output_path}")
    return 0


def run_batch(inputs, outdir: str | None, batch_size: int = 16,
              verbose: bool = True, fast: bool = False) -> int:
    """Serving path: convert many images with one compiled program per
    canvas bucket, batching same-bucket images together.

    Mixed native sizes are grouped by bucket_dim canvas, padded top-left,
    and run through the vmapped bucketed pipeline (per-image content
    dims/thresholds ride as traced scalars, so results match native-size
    detection exactly).
    """
    import glob as globmod
    import time

    enable_compile_cache()
    import jax.numpy as jnp

    from .config import DetectionConfig, choose_line_threshold
    from .core import to_sgf
    from .hostio import load_rgb
    from .pipeline import bucket_dim, detect_board_bucket_batch

    files: list[str] = []
    for pat in inputs:
        hits = sorted(globmod.glob(pat))
        files.extend(hits if hits else [pat])
    if not files:
        print("No input images.", file=sys.stderr)
        return 1
    if outdir:
        os.makedirs(outdir, exist_ok=True)

    cfg = DetectionConfig.fast() if fast else DetectionConfig()
    # load host-side and group by canvas bucket
    groups: dict[tuple[int, int], list[tuple[str, np.ndarray]]] = {}
    for path in files:
        try:
            rgb = load_rgb(path)
        except (OSError, ValueError) as e:
            print(f"Error opening file {path}:\n{e}", file=sys.stderr)
            continue
        key = (bucket_dim(rgb.shape[0]), bucket_dim(rgb.shape[1]))
        groups.setdefault(key, []).append((path, rgb))

    n_ok = n_fail = 0
    t0 = time.perf_counter()
    for (hb, wb), items in sorted(groups.items()):
        for start in range(0, len(items), batch_size):
            chunk = items[start : start + batch_size]
            B = len(chunk)
            canvases = np.zeros((B, hb, wb, 3), np.uint8)
            hs = np.zeros((B,), np.int32)
            ws = np.zeros((B,), np.int32)
            ths = np.zeros((B,), np.float32)
            for i, (_, rgb) in enumerate(chunk):
                h, w = rgb.shape[:2]
                canvases[i, :h, :w] = rgb
                hs[i], ws[i] = h, w
                ths[i] = choose_line_threshold(h, w)
            res = detect_board_bucket_batch(
                jnp.asarray(canvases), cfg, jnp.asarray(ths),
                jnp.asarray(hs), jnp.asarray(ws),
            )
            ready = np.asarray(res.board_ready)
            boards = np.asarray(res.full_board)
            sides = np.asarray(res.side_to_move)
            for i, (path, _) in enumerate(chunk):
                stem = os.path.splitext(os.path.basename(path))[0]
                out = (os.path.join(outdir, stem + ".sgf") if outdir
                       else os.path.splitext(path)[0] + ".sgf")
                if not ready[i]:
                    n_fail += 1
                    if verbose:
                        print(f"{path}: board not detected")
                    continue
                with open(out, "w") as f:
                    f.write(to_sgf(boards[i], side_to_move=int(sides[i])))
                n_ok += 1
                if verbose:
                    print(f"{path} -> {out}")
    dt = time.perf_counter() - t0
    print(f"{n_ok} converted, {n_fail} not detected, "
          f"{len(files)} files in {dt:.1f}s ({len(files) / dt:.1f} img/s)")
    return 0 if n_ok else 1


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    use_gui = "--gui" in argv
    if use_gui:
        argv.remove("--gui")
    # --fast: reduced blur-pyramid serving preset (DetectionConfig.fast);
    # accuracy vs the full pipeline is recorded in docs/PARITY.md
    fast = "--fast" in argv
    if fast:
        argv.remove("--fast")
    if "--batch" in argv:
        argv.remove("--batch")
        outdir = None
        if "-o" in argv:
            i = argv.index("-o")
            outdir = argv[i + 1]
            del argv[i : i + 2]
        bs = 16
        if "--batch-size" in argv:
            i = argv.index("--batch-size")
            bs = int(argv[i + 1])
            del argv[i : i + 2]
        return run_batch(argv, outdir, batch_size=bs, fast=fast)
    if len(argv) > 2:
        sys.exit("Too many command line arguments.")
    input_path = argv[0] if len(argv) > 0 else None
    output_path = argv[1] if len(argv) > 1 else None

    if use_gui or input_path is None:
        from .gui.app import run_gui

        return run_gui(input_path, output_path)
    return run_headless(input_path, output_path, fast=fast)


if __name__ == "__main__":
    raise SystemExit(main())
