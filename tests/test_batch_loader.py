"""Native batch loader: decode correctness vs PIL, fallback path.

The JPEGs are rendered diagrams (chip_smoke.render_diagram) written by PIL.
"""

import numpy as np
import pytest
from PIL import Image

import chip_smoke
import img2sgf_tpu.hostio.batch_loader as bl


@pytest.fixture(scope="module")
def jpeg_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    paths = []
    for seed, (h, w, n) in enumerate(((200, 180, 9), (240, 260, 11),
                                      (160, 160, 7), (220, 200, 0))):
        rgb, _ = chip_smoke.render_diagram(seed, h, w, n, n)
        paths.append(str(d / f"d{seed}.jpg"))
        Image.fromarray(rgb).save(paths[-1], quality=90)
    return paths


def test_native_loader_builds_from_the_tree():
    assert bl.native_available()
    assert bl._SO.parent.name == "build" and bl._SO.exists()


def test_decode_batch_matches_pil_closely(jpeg_paths):
    out = bl.decode_batch(jpeg_paths, 256, 256)
    assert out.shape == (len(jpeg_paths), 256, 256, 3)
    for i, p in enumerate(jpeg_paths):
        ref = np.asarray(
            Image.open(p).convert("RGB").resize((256, 256), Image.BILINEAR)
        ).astype(np.int32)
        diff = np.abs(out[i].astype(np.int32) - ref)
        # different bilinear implementations: expect close but not identical
        assert diff.mean() < 4.0, f"{p}: mean diff {diff.mean()}"


def test_missing_file_falls_back_cleanly(tmp_path, jpeg_paths):
    bad = [jpeg_paths[0], str(tmp_path / "nope.jpg")]
    with pytest.raises(Exception):
        bl.decode_batch(bad, 64, 64)


def test_reuses_output_buffer(jpeg_paths):
    buf = np.empty((len(jpeg_paths), 128, 128, 3), np.uint8)
    out = bl.decode_batch(jpeg_paths, 128, 128, out=buf)
    assert out is buf
