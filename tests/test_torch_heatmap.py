"""The port's 3D heatmap (avlmaps_torch/ops/heatmap.py) against the JAX
package's, on the CPU.

Both compute the same f32 arithmetic (squared lattice distances are exact
integers below 2^24; the direct scan sums the coordinate differences in
one order), so heat is held at atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlmaps_tpu.ops import heatmap as jheat
from avlmaps_torch.ops import heatmap as theat

CS = 0.05


def _scene(rng, n=600, extent=(24, 20, 8), frac=0.08):
    pos = np.stack([rng.integers(0, e, n) for e in extent],
                   axis=1).astype(np.int32)
    mask = rng.random(n) < frac
    return pos, mask


def _both(pos, mask, **kw):
    want = jheat.heatmap_from_mask_3d(pos, mask, **kw)
    got = theat.heatmap_from_mask_3d(pos, mask, device="cpu", **kw)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    return got, np.asarray(want)


@pytest.mark.parametrize("decay_rate", [0.01, 0.004])
@pytest.mark.parametrize("method", ["dense", "direct", "auto"])
def test_integer_cells_match_jax(rng, method, decay_rate):
    pos, mask = _scene(rng)
    got, want = _both(pos, mask, cell_size=CS, decay_rate=decay_rate,
                      method=method)
    np.testing.assert_allclose(got, want, atol=1e-6)
    rest = got[~mask]  # voxels sharing a target's cell also get 1
    assert (got[mask] == 1).all() and ((rest > 0) & (rest < 1)).any()


@pytest.mark.parametrize("grid_shape", [None, (24, 20, 8)])
def test_declared_lattice_matches_jax(rng, grid_shape):
    """lattice_unit (and grid_shape: the serving form with no host sync)
    skip the host probe; the heat is the same."""
    pos, mask = _scene(rng)
    got, want = _both(pos, mask, cell_size=CS, decay_rate=0.01,
                      method="dense", lattice_unit=1.0,
                      grid_shape=grid_shape)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_metric_positions_on_a_cell_size_lattice(rng):
    """Voxel centres in metres (grid * cs) snap to the cs lattice."""
    pos, mask = _scene(rng)
    metric = pos.astype(np.float32) * np.float32(CS)
    for method in ("dense", "auto"):
        got, want = _both(metric, mask, cell_size=CS, decay_rate=0.2,
                          method=method)
        np.testing.assert_allclose(got, want, atol=1e-6)
    got, want = _both(metric, mask, cell_size=CS, decay_rate=0.2,
                      method="dense", lattice_unit=CS)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_float_positions_take_the_direct_path(rng):
    pos = rng.uniform(0, 30, (500, 3)).astype(np.float32)
    mask = rng.random(500) < 0.1
    got, want = _both(pos, mask, cell_size=CS, decay_rate=0.01)
    np.testing.assert_allclose(got, want, atol=1e-6)
    with pytest.raises(ValueError, match="lattice"):
        theat.heatmap_from_mask_3d(pos, mask, method="dense", device="cpu")


@pytest.mark.parametrize("method", ["dense", "direct", "auto"])
def test_empty_mask_gives_zero_heat(rng, method):
    pos, _ = _scene(rng)
    mask = np.zeros(len(pos), bool)
    got, want = _both(pos, mask, cell_size=CS, decay_rate=0.01,
                      method=method)
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all()


def test_as_device_and_no_decay(rng):
    pos, mask = _scene(rng)
    dev = theat.heatmap_from_mask_3d(torch.from_numpy(pos),
                                     torch.from_numpy(mask), cell_size=CS,
                                     decay_rate=0.01, method="dense",
                                     lattice_unit=1.0, as_device=True)
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_allclose(dev.numpy(), jheat.heatmap_from_mask_3d(
        pos, mask, cell_size=CS, decay_rate=0.01), atol=1e-6)
    ones = theat.heatmap_from_mask_3d(pos, mask, decay_rate=0.0,
                                      device="cpu")
    assert (ones == 1).all()


@pytest.mark.parametrize("scale", [1.0, 1000.0])
def test_min_dist_to_targets_matches_jax(rng, scale):
    """The exact-difference scan at grid-coordinate magnitudes (~1000,
    where the |a|^2+|b|^2-2ab expansion loses ~0.3 in d^2), with more rows
    and targets than one chunk."""
    pts = (rng.uniform(0, 1, (3000, 3)) * scale).astype(np.float32)
    tgt = (rng.uniform(0, 1, (1500, 3)) * scale).astype(np.float32)
    want = np.asarray(jheat._min_dist_to_targets(jnp.asarray(pts),
                                                 jnp.asarray(tgt)))
    got = theat._min_dist_to_targets(torch.from_numpy(pts),
                                     torch.from_numpy(tgt),
                                     row_chunk=1024, tgt_chunk=512)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * scale)
    exact = np.sqrt(((pts[:, None, :].astype(np.float64)
                      - tgt[None].astype(np.float64)) ** 2).sum(-1)).min(1)
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-6,
                               atol=1e-6 * scale)


def test_banded_pass_matches_jax(rng):
    d2 = np.where(rng.random((12, 9, 7)) < 0.05, 0.0,
                  theat._INF).astype(np.float32)
    for axis in range(3):
        np.testing.assert_array_equal(
            theat._banded_axis_pass(torch.from_numpy(d2), 4, axis).numpy(),
            np.asarray(jheat._banded_axis_pass(jnp.asarray(d2), 4, axis)))
