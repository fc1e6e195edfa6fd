"""The benchmark's numpy threefry (portbench/reference/vlmap_whole.py),
which draws the device-sampled build's pixels for its reference map,
against ``jax.random`` and the port's ``device_sample_indices``, bit for
bit."""

import jax
import numpy as np
import pytest
import torch

from avlmaps_torch.map.vlmap_builder import device_sample_indices
from portbench.reference import vlmap_whole as ref

H, W, RATE = 720, 1080, 100
IDS = np.array([0, 1, 2, 191, 575])


@pytest.mark.parametrize("seed", [0, 16, 2 ** 31 - 1])
def test_draws_equal_jax_and_the_port(seed):
    n = H * W // RATE
    got = ref.draws(seed, IDS.max() + 1, H, W, RATE)[IDS]
    key = jax.random.PRNGKey(seed)
    want = np.stack([np.sort(np.asarray(jax.random.randint(
        jax.random.fold_in(key, int(i)), (n,), 0, H * W))) for i in IDS])
    port = device_sample_indices(torch.from_numpy(IDS.astype(np.int32)),
                                 seed=seed, max_pts=n, n_pixels=H * W)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, port.numpy())


@pytest.mark.parametrize("span", [7, 1000, 2 ** 31 - 1])
def test_randint_equals_jax_unsorted(span):
    key = ref.fold_in(5, np.array([3]))
    got = ref.randint(key, 64, span)[0]
    want = jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(5), 3),
                              (64,), 0, span)
    np.testing.assert_array_equal(got, np.asarray(want))
