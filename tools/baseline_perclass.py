"""Per-class CPU baseline for the reference algorithm: mean end-to-end
latency/throughput of the headless reference re-run on each canvas-bucket
class the bench reports (768-bucket book scans, 1280-bucket large
scans) — so bench.py's vs_baseline ratios compare like against like
(BASELINE.md's 6.66 img/s is an 18-fixture mean dominated by small
fixtures; the large-scan class is much slower on CPU too).

Usage: python tools/baseline_perclass.py [reps]
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from PIL import Image

from reference_headless import run_pipeline  # noqa: E402

sys.path.insert(0, "/root/repo")

from img2sgf_tpu.pipeline.detect import bucket_dim  # noqa: E402


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    fdir = pathlib.Path("/root/reference/test_images")
    classes: dict[int, list[pathlib.Path]] = {}
    for f in sorted(fdir.glob("*.jpg")):
        with Image.open(f) as im:
            w, h = im.size
        b = max(bucket_dim(h), bucket_dim(w))
        classes.setdefault(b, []).append(f)

    out = {}
    for b in sorted(classes):
        files = classes[b]
        times = []
        for f in files:
            img = Image.open(f).convert("RGB")
            run_pipeline(img)  # warm (file cache, numpy alloc)
            t0 = time.perf_counter()
            for _ in range(reps):
                run_pipeline(img)
            dt = (time.perf_counter() - t0) / reps
            times.append(dt)
            print(f"  {f.stem}: {dt * 1e3:.1f} ms", flush=True)
        mean_ms = sum(times) / len(times) * 1e3
        out[str(b)] = {
            "fixtures": [f.stem for f in files],
            "mean_ms": round(mean_ms, 1),
            "img_per_s": round(1e3 / mean_ms, 2),
        }
        print(f"bucket {b}: {len(files)} fixtures, mean {mean_ms:.1f} ms "
              f"= {1e3 / mean_ms:.2f} img/s", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
