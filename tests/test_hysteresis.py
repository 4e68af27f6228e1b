"""Canny hysteresis equals 8-connected component labelling.

Hysteresis keeps every candidate pixel 8-connected (through candidates) to
a strong seed: the least fixed point of a monotone propagation. The
reference is scipy.ndimage.label with a 3x3 structure: a component is an
edge iff it holds a strong candidate. Cases: random planes of several
densities, and a staircase that needs one sweep per run.
"""

import pathlib
import sys

import numpy as np
import pytest
from scipy import ndimage

import jax.numpy as jnp

from img2sgf_tpu.ops.canny import hysteresis, hysteresis_pool

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
from stage_profile import staircase  # noqa: E402


def _reference(strong, cand):
    lbl, _ = ndimage.label(cand, structure=np.ones((3, 3), int))
    seeds = np.unique(lbl[strong & cand])
    return np.isin(lbl, seeds[seeds > 0])


def _random_case(seed, density, n=64):
    rng = np.random.default_rng(seed)
    cand = rng.random((n, n)) < density
    strong = cand & (rng.random((n, n)) < 0.02)
    return strong, cand


CASES = {
    "sparse": _random_case(0, 0.30),
    "percolating": _random_case(1, 0.45),
    "dense": _random_case(2, 0.60),
    "tall": _random_case(3, 0.50, n=48),
    "staircase": staircase(96, 6)[:2],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hysteresis_matches_label_reference(case):
    strong, cand = CASES[case]
    got = np.asarray(hysteresis(jnp.asarray(strong), jnp.asarray(cand), 256))
    np.testing.assert_array_equal(got, _reference(strong, cand))


@pytest.mark.parametrize("case", sorted(CASES))
def test_hysteresis_pool_matches_label_reference(case):
    # a pool of 3 planes (padded to one 32-bit group): the case, its
    # transpose and an empty plane, so planes converge at different sweeps
    strong, cand = CASES[case]
    s = np.stack([strong, strong.T, np.zeros_like(strong)])
    c = np.stack([cand, cand.T, cand])
    got = np.asarray(hysteresis_pool(jnp.asarray(s), jnp.asarray(c), 256))
    for p in range(3):
        np.testing.assert_array_equal(got[p], _reference(s[p], c[p]),
                                      err_msg=f"plane {p}")


def test_staircase_needs_one_sweep_per_run():
    strong, cand, runs = staircase(96, 6)
    s, c = jnp.asarray(strong), jnp.asarray(cand)
    assert np.array_equal(np.asarray(hysteresis(s, c, runs)), cand)
    assert not np.array_equal(np.asarray(hysteresis(s, c, runs - 1)), cand)
