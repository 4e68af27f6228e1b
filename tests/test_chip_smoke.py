"""chip_smoke.py off the GPU, its renderer, and compile-cache placement.

The smoke run itself needs a GPU; here it must refuse to run (non-zero
exit, no result line) on the CPU and in a directory that holds nothing of
the repository but the script.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from img2sgf_tpu.compile_cache import DEFAULT_CACHE_DIR

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("where", ["cpu_backend", "bare_directory"])
def test_chip_smoke_fails_without_gpu_or_repo(where, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if where == "bare_directory":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
        env.pop("PYTHONPATH", None)
    else:
        script, cwd = ROOT / "chip_smoke.py", ROOT
    p = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


@pytest.mark.parametrize(
    "spec", list(chip_smoke.BATCH_SPECS) + [chip_smoke.SMALL_SPEC])
def test_renderer_is_deterministic(spec):
    a, ta = chip_smoke.render_diagram(*spec)
    b, tb = chip_smoke.render_diagram(*spec)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ta, tb)
    seed, h, w, cols, rows = spec
    assert a.shape == (h, w, 3) and a.dtype == np.uint8
    # truth is LEFT/TOP aligned [column, row], like BoardResult.full_board
    assert not ta[cols:].any() and not ta[:, rows:].any()
    assert set(np.unique(ta)) <= {0, 1, 2}
    assert (ta > 0).any() == (cols > 0)
    c, _ = chip_smoke.render_diagram(seed + 100, h, w, cols, rows)
    assert not np.array_equal(a, c)


def test_bucket_batch_pads_into_one_canvas():
    canv, thr, hs, ws, truths = chip_smoke.bucket_batch(chip_smoke.BATCH_SPECS)
    assert canv.shape == (len(chip_smoke.BATCH_SPECS), 768, 768, 3)
    assert truths.shape == (len(chip_smoke.BATCH_SPECS), 19, 19)
    for i, (_, h, w, _, _) in enumerate(chip_smoke.BATCH_SPECS):
        assert (hs[i], ws[i]) == (h, w)
        assert not canv[i, h:].any() and not canv[i, :, w:].any()


_PRINT_CACHE = ("from img2sgf_tpu.compile_cache import enable_compile_cache;"
                "print(enable_compile_cache())")


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(env_dir, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    p = subprocess.run([sys.executable, "-c", _PRINT_CACHE], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120,
                       check=True)
    want = str(tmp_path / env_dir) if env_dir else str(DEFAULT_CACHE_DIR)
    assert p.stdout.strip() == want
    assert DEFAULT_CACHE_DIR == ROOT / ".jax_cache"


@pytest.mark.parametrize(
    "spec", list(chip_smoke.BATCH_SPECS) + [chip_smoke.SMALL_SPEC])
def test_reference_algorithm_reads_the_rendered_truth(spec):
    """The OpenCV reference reads every smoke-run image as rendered, so a
    board that differs on the GPU is the pipeline's fault, not the
    renderer's."""
    pytest.importorskip("cv2")
    pytest.importorskip("sklearn")
    sys.path.insert(0, str(ROOT / "tools"))
    import reference_headless
    from PIL import Image

    rgb, truth = chip_smoke.render_diagram(*spec)
    ref = reference_headless.run_pipeline(Image.fromarray(rgb))
    assert ref.board_ready == (spec[3] > 0)
    if ref.board_ready:
        np.testing.assert_array_equal(ref.full_board, truth)
        assert ref.side_to_move == chip_smoke.truth_side(truth)
