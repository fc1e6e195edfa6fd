"""The port's pooling and morphology (avlmaps_torch/ops/{pooling,
morphology}.py) against the JAX package's, on the CPU.  Masks and pooled
values are exact; the blur sums the same f32 taps in another order
(atol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlmaps_tpu.ops import morphology as jmorph
from avlmaps_tpu.ops import pooling as jpool
from avlmaps_torch.ops import morphology as tmorph
from avlmaps_torch.ops import pooling as tpool

GS = 24


def _voxels(rng, n=500):
    # some positions fall outside the (GS, GS) grid: both packages drop them
    pos = np.stack([rng.integers(-2, GS + 2, n), rng.integers(-2, GS + 2, n),
                    rng.integers(0, 6, n)], 1).astype(np.int32)
    return pos


def test_pool_label_and_value_match_jax(rng):
    pos = _voxels(rng)
    mask = rng.random(len(pos)) < 0.3
    vals = rng.normal(size=len(pos)).astype(np.float32)
    np.testing.assert_array_equal(tpool.pool_3d_label_to_2d(mask, pos, GS),
                                  jpool.pool_3d_label_to_2d(mask, pos, GS))
    np.testing.assert_array_equal(
        tpool.pool_3d_value_to_2d_max(vals, pos, GS),
        jpool.pool_3d_value_to_2d_max(vals, pos, GS))


def test_rgb_pool_and_lift_match_jax(rng):
    pos = np.abs(_voxels(rng)) % GS
    rgb = rng.integers(0, 255, (len(pos), 3), dtype=np.uint8)
    np.testing.assert_array_equal(tpool.pool_3d_rgb_to_2d(rgb, pos, GS),
                                  jpool.pool_3d_rgb_to_2d(rgb, pos, GS))
    heat = rng.random((GS, GS)).astype(np.float32)
    np.testing.assert_array_equal(tpool.lift_2d_to_3d(heat, pos),
                                  jpool.lift_2d_to_3d(heat, pos))


@pytest.mark.parametrize("iterations", [1, 3])
def test_binary_morphology_matches_jax(rng, iterations):
    mask = rng.random((20, 17)) < 0.35
    t = torch.from_numpy(mask)
    for ours, theirs in ((tmorph.binary_dilation, jmorph.binary_dilation_jax),
                         (tmorph.binary_erosion, jmorph.binary_erosion_jax),
                         (tmorph.binary_closing, jmorph.binary_closing_jax)):
        np.testing.assert_array_equal(
            ours(t, iterations).numpy(),
            np.asarray(theirs(jnp.asarray(mask), iterations)))


@pytest.mark.parametrize("sigma", [0.8, 1.0, 4.0])
def test_gaussian_blur_matches_jax(rng, sigma):
    """sigma 4 on a 9-row image: the symmetric pad is wider than the
    image, so it reflects more than once."""
    img = rng.random((9, 31)).astype(np.float32)
    np.testing.assert_allclose(
        tmorph.gaussian_blur(torch.from_numpy(img), sigma, 3.0).numpy(),
        np.asarray(jmorph.gaussian_blur_jax(jnp.asarray(img), sigma=sigma,
                                            truncate=3.0)), atol=1e-6)
