"""K7 (score_argmax) and K8 (score_features) in the port against the JAX
package's Pallas kernels, run on the CPU as tests/test_ops.py runs them
(interpret mode).  The port's wrappers take their plain versions for CPU
tensors.

Labels must be equal.  Scores are held at the JAX tests' own tolerance,
rtol 2e-4 / atol 2e-3 (f32 sums of 512 products in another order).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlmaps_tpu.ops import similarity as jsim
from avlmaps_torch.ops import similarity as tsim

FLAGS = list(itertools.product([False, True], repeat=2))


def _feats(kind, rng):
    """(map features, text features) for one of test_ops.py's cases."""
    if kind == "random":  # n=3000, d=512, c=11
        return (rng.normal(size=(3000, 512)).astype(np.float32) * 2,
                rng.normal(size=(11, 512)).astype(np.float32))
    if kind == "all_negative":  # every score < 0 once both sides normalise
        return (np.abs(rng.normal(size=(3000, 512))).astype(np.float32),
                -np.abs(rng.normal(size=(11, 512))).astype(np.float32))
    if kind == "zero_rows":  # zero rows tie every category
        x = np.zeros((16, 32), np.float32)
        x[8:] = rng.normal(size=(8, 32))
        return x, rng.normal(size=(4, 32)).astype(np.float32)
    if kind == "odd_13x7":
        return (rng.normal(size=(13, 7)).astype(np.float32),
                rng.normal(size=(3, 7)).astype(np.float32))
    assert kind == "odd_3x7"
    return (rng.normal(size=(3, 7)).astype(np.float32),
            rng.normal(size=(2, 7)).astype(np.float32))


KINDS = ["random", "all_negative", "zero_rows", "odd_13x7", "odd_3x7"]


@pytest.mark.parametrize("normalize_map,normalize_text", FLAGS)
@pytest.mark.parametrize("kind", KINDS)
def test_score_features_matches_jax(rng, kind, normalize_map,
                                    normalize_text):
    x, t = _feats(kind, rng)
    want = np.asarray(jsim.score_features(
        jnp.asarray(x), jnp.asarray(t), normalize_map=normalize_map,
        normalize_text=normalize_text))
    got = tsim.score_features(torch.from_numpy(x), torch.from_numpy(t),
                              normalize_map=normalize_map,
                              normalize_text=normalize_text)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("normalize_map,normalize_text", FLAGS)
@pytest.mark.parametrize("kind", KINDS)
def test_score_argmax_matches_jax(rng, kind, normalize_map, normalize_text):
    x, t = _feats(kind, rng)
    want = np.asarray(jsim.score_argmax(
        jnp.asarray(x), jnp.asarray(t), normalize_map=normalize_map,
        normalize_text=normalize_text))
    got = tsim.score_argmax(torch.from_numpy(x), torch.from_numpy(t),
                            normalize_map=normalize_map,
                            normalize_text=normalize_text)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "zero_rows":
        assert (got.numpy()[:8] == 0).all()


def test_all_negative_case_is_all_negative(rng):
    """The all-negative case does what it is named for: with both sides
    normalised every score is below zero."""
    x, t = _feats("all_negative", rng)
    s = tsim.score_features(torch.from_numpy(x), torch.from_numpy(t),
                            normalize_map=True, normalize_text=True)
    assert float(s.max()) < 0


def test_duplicate_categories_tie_to_the_lower_index(rng):
    x = rng.normal(size=(500, 64)).astype(np.float32)
    t = rng.normal(size=(6, 64)).astype(np.float32)
    t[5] = t[2]
    got = tsim.score_argmax(torch.from_numpy(x), torch.from_numpy(t),
                            normalize_text=True).numpy()
    assert (got == 2).any() and not (got == 5).any()
    np.testing.assert_array_equal(got, np.asarray(jsim.score_argmax(
        jnp.asarray(x), jnp.asarray(t), normalize_text=True)))


def test_helpers_match_jax(rng):
    scores = rng.normal(size=(100, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        tsim.topk_categories(torch.from_numpy(scores)).numpy(),
        np.asarray(jsim.topk_categories(jnp.asarray(scores))))
    x, t = _feats("random", rng)
    np.testing.assert_array_equal(
        tsim.score_and_mask(torch.from_numpy(x), torch.from_numpy(t),
                            3).numpy(),
        np.asarray(jsim.score_and_mask(jnp.asarray(x), jnp.asarray(t), 3)))


def test_wrappers_refuse_what_the_kernel_does_not_take():
    """The CUDA checks run before any launch, so they are testable here:
    an unsupported device or layout raises instead of falling back."""
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        tsim._check_cuda("score_argmax", x.to("meta"), x.to("meta"))
    assert tsim.score_argmax.launches == 0
    assert tsim.score_features.launches == 0
