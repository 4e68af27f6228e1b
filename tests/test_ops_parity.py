"""Op-level parity tests vs PIL / OpenCV on real fixture images.

These quantify how close each op is to the library call it replaces.
Preprocess and greyscale must be bit-exact; blurs and Canny are allowed a
tiny mismatch budget (documented per-op) since downstream detection is
judged at board level against tests/golden/.
"""

import numpy as np
import pytest
from PIL import Image, ImageEnhance

import jax.numpy as jnp

from img2sgf_tpu.ops import (
    canny,
    gaussian_blur,
    grey_bgr_quirk,
    median_blur,
    preprocess,
)

cv = pytest.importorskip("cv2")

FIXTURES = "/root/reference/test_images"


@pytest.fixture(scope="module")
def ex1_rgb():
    # fixed-size crop keeps XLA compile times bounded across the suite
    return np.array(Image.open(f"{FIXTURES}/ex1.jpg").convert("RGB"))[100:484, 150:534]


@pytest.fixture(scope="module")
def ex7_rgb():
    # colour photo-realistic fixture (335x371 native)
    return np.array(Image.open(f"{FIXTURES}/ex7.jpg").convert("RGB"))


def _pil_preprocess(rgb, contrast=70, brightness=50):
    img = Image.fromarray(rgb)
    img = ImageEnhance.Contrast(img).enhance(102.0 / (101.0 - contrast) - 1.0)
    img = ImageEnhance.Brightness(img).enhance(450.0 / (200.0 - brightness) - 2.0)
    return np.array(img)


@pytest.mark.parametrize("contrast,brightness", [(70, 50), (50, 50), (90, 30), (0, 100 - 1)])
def test_preprocess_bit_exact(ex7_rgb, contrast, brightness):
    want = _pil_preprocess(ex7_rgb, contrast, brightness)
    got = np.asarray(preprocess(jnp.asarray(ex7_rgb), contrast, brightness))
    mismatch = (want != got).mean()
    assert mismatch == 0.0, f"preprocess mismatch rate {mismatch}"


def test_grey_bgr_quirk_bit_exact(ex7_rgb):
    pre = _pil_preprocess(ex7_rgb)
    want = cv.cvtColor(pre, cv.COLOR_BGR2GRAY)
    got = np.asarray(grey_bgr_quirk(jnp.asarray(pre)))
    assert (want != got).mean() == 0.0


@pytest.mark.parametrize("k", [3, 5, 7])
def test_median_blur_exact(ex1_rgb, k):
    grey = cv.cvtColor(_pil_preprocess(ex1_rgb), cv.COLOR_BGR2GRAY)
    want = cv.medianBlur(grey, k)
    got = np.asarray(median_blur(jnp.asarray(grey), k))
    # interior must be exact; OpenCV's border handling may differ on the
    # outermost r rows/cols
    r = k // 2
    assert (want[r:-r, r:-r] != got[r:-r, r:-r]).mean() == 0.0


@pytest.mark.parametrize("k", [3, 5, 7])
def test_gaussian_blur_bit_exact(ex1_rgb, k):
    grey = cv.cvtColor(_pil_preprocess(ex1_rgb), cv.COLOR_BGR2GRAY)
    want = cv.GaussianBlur(grey, (k, k), k)
    got = np.asarray(gaussian_blur(jnp.asarray(grey), k, float(k)))
    assert (want != got).mean() == 0.0


def test_canny_rgb_parity(ex1_rgb):
    pre = _pil_preprocess(ex1_rgb)
    want = cv.Canny(pre, 50, 200, apertureSize=3, L2gradient=False)
    got = np.asarray(canny(jnp.asarray(pre), 50, 200))
    assert (want != got).sum() == 0


def test_canny_grey_parity(ex7_rgb):
    grey = cv.cvtColor(_pil_preprocess(ex7_rgb), cv.COLOR_BGR2GRAY)
    want = cv.Canny(grey, 50, 100, apertureSize=3, L2gradient=False)
    got = np.asarray(canny(jnp.asarray(grey), 50, 100))
    assert (want != got).sum() == 0


def test_canny_pool_matches_per_plane(ex1_rgb, ex7_rgb):
    """canny_pool (shared bit-packed hysteresis, 32 planes per uint32) must
    be bit-identical to per-plane canny() — it is the batch pipeline's
    internal-Canny path (pipeline._plane_state_pool)."""
    from img2sgf_tpu.ops.canny import canny_pool

    g1 = cv.cvtColor(_pil_preprocess(ex1_rgb), cv.COLOR_BGR2GRAY)
    g2 = cv.cvtColor(_pil_preprocess(ex7_rgb), cv.COLOR_BGR2GRAY)[:384, :384]
    g2 = np.pad(g2, ((0, 384 - g2.shape[0]), (0, 384 - g2.shape[1])))
    planes = [g1, 255 - g1, cv.medianBlur(g1, 5), cv.GaussianBlur(g1, (7, 7), 7),
              g2]
    pool = jnp.asarray(np.stack(planes))
    got = np.asarray(canny_pool(pool, 50, 100, iters=256))
    for p in range(pool.shape[0]):
        want = np.asarray(canny(pool[p], 50, 100, iters=256))
        assert (want != got[p]).sum() == 0, f"plane {p} differs"


def test_canny_rgb_pool_matches_per_image(ex1_rgb, ex7_rgb):
    """canny_rgb_pool (batched outer Canny, shared bit-packed hysteresis)
    must be bit-identical to per-image canny() on 3-channel input."""
    from img2sgf_tpu.ops.canny import canny_rgb_pool

    a = _pil_preprocess(ex1_rgb)
    b = np.zeros_like(a)
    p7 = _pil_preprocess(ex7_rgb)
    b[: min(a.shape[0], p7.shape[0]), : min(a.shape[1], p7.shape[1])] = (
        p7[: a.shape[0], : a.shape[1]])
    batch = jnp.asarray(np.stack([a, b]))
    got = np.asarray(canny_rgb_pool(batch, 50, 200))
    for i in range(2):
        want = np.asarray(canny(batch[i], 50, 200))
        assert (want != got[i]).sum() == 0, f"image {i} differs"


def test_canny_pool_bucketed_matches_native():
    """canny_pool with per-plane hw content dims must equal native-size
    canny inside the content block and stay zero outside it."""
    from img2sgf_tpu.ops.canny import canny_pool

    rng = np.random.default_rng(7)
    canvas = np.zeros((2, 256, 256), np.uint8)
    dims = [(200, 180), (256, 131)]
    native = []
    for p, (h, w) in enumerate(dims):
        img = rng.integers(0, 256, (h, w), np.uint8)
        canvas[p, :h, :w] = img
        native.append(np.asarray(canny(jnp.asarray(img), 50, 100, iters=256)))
    hs = jnp.asarray([d[0] for d in dims], jnp.int32)
    ws = jnp.asarray([d[1] for d in dims], jnp.int32)
    got = np.asarray(canny_pool(jnp.asarray(canvas), 50, 100, iters=256,
                                hw_planes=(hs, ws)))
    for p, (h, w) in enumerate(dims):
        assert (got[p, :h, :w] != native[p]).sum() == 0
        assert got[p, h:, :].sum() == 0 and got[p, :, w:].sum() == 0


def test_canny_hysteresis_bound_covers_ex17():
    """ex17 (1193x1135, the largest fixture) needs >24 hysteresis sweeps to
    converge — the old 24-sweep default left 152 wrong edge pixels and a
    0.997 board. The config default must converge it exactly. Synthetic
    worst cases are hard to build (axis-aligned paths are shortcut by the
    segmented fills; isolated diagonals die in NMS), so this pins the real
    image. Both hysteresis paths early-exit on convergence, so a generous
    bound is runtime-free."""
    from img2sgf_tpu.config import DetectionConfig

    rgb = np.array(Image.open(f"{FIXTURES}/ex17.jpg").convert("RGB"))
    pre = _pil_preprocess(rgb)
    want = cv.Canny(pre, 50, 200, apertureSize=3, L2gradient=False)
    got = np.asarray(
        canny(jnp.asarray(pre), 50, 200,
              iters=DetectionConfig().hysteresis_iters)
    )
    assert (want != got).sum() == 0
    # sanity: the old bound was genuinely insufficient on this image
    old = np.asarray(canny(jnp.asarray(pre), 50, 200, iters=24))
    assert (want != old).sum() > 0
