"""cluster_1d centres are float64-accurate means of non-integer intercepts.

Its one-hot sums are float32 dots; at default precision a GPU may run them
in TF32 (10-bit mantissa), which moves centres by whole pixels. The dots
must ask for HIGHEST precision.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from img2sgf_tpu.grid.cluster import cluster_1d


def _gap_cut_means(values, threshold):
    v = np.sort(values.astype(np.float64))
    seg = np.concatenate([[0], np.cumsum(np.diff(v) >= threshold)])
    return np.array([v[seg == k].mean() for k in range(seg[-1] + 1)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cluster_centres_match_float64_means(seed):
    rng = np.random.default_rng(seed)
    # 19 grid lines up to ~1280 px, each seen as several intercepts
    # spread by a few px, at the half-pixel steps Hough rho takes
    lines = np.sort(rng.uniform(20.0, 1260.0, 19))
    lines = lines[np.concatenate([[True], np.diff(lines) > 30.0])]
    vals = np.concatenate([
        ln + np.round(rng.uniform(-3.0, 3.0, rng.integers(2, 9)) * 2) / 2
        for ln in lines]).astype(np.float32)
    n = vals.size
    padded = np.zeros(256, np.float32)
    padded[:n] = rng.permutation(vals)
    valid = np.arange(256) < n
    centres, count = cluster_1d(jnp.asarray(padded), jnp.asarray(valid),
                                10.0, 64)
    want = _gap_cut_means(vals, 10.0)
    assert int(count) == want.size
    np.testing.assert_allclose(np.asarray(centres)[:want.size], want,
                               rtol=0, atol=1e-3)


def test_cluster_dots_run_at_highest_precision():
    jaxpr = jax.make_jaxpr(
        lambda v, m: cluster_1d(v, m, 10.0, 64))(
            jnp.zeros(32, jnp.float32), jnp.ones(32, bool))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 2
    for e in dots:
        prec = e.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), prec
