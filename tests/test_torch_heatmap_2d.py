"""The port's 2D heat (the exact EDT, heatmap_from_mask_2d, the radial
decay and the per-event decay stacks of the area and sound queries,
avlmaps_torch/ops/heatmap.py) against the JAX package's, on the CPU.

Squared distances are integers below 2^24 in both packages, so the EDT is
exact; the decay stacks compute the same f32 terms in the same event
order (the JAX package pads events and seeds to powers of two, the port
does not), so heat is held at atol 1e-5.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from avlmaps_tpu.ops import heatmap as jheat
from avlmaps_torch.ops import heatmap as theat

ATOL = 1e-5


def _tracks(rng, shape, lengths):
    return [np.stack([rng.uniform(0, shape[0], n),
                      rng.uniform(0, shape[1], n)], axis=1).astype(np.float32)
            for n in lengths]


def _both(shape, points, confs, decay, combine, normalize):
    want = jheat.decayed_point_heatmap_2d(shape, points, confs, decay,
                                          combine=combine,
                                          normalize=normalize)
    got = theat.decayed_point_heatmap_2d(shape, points, confs, decay,
                                         combine=combine,
                                         normalize=normalize, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == tuple(shape)
    return got, np.asarray(want)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("combine", ["max", "sum"])
@pytest.mark.parametrize("lengths", [[1] * 5, [1, 7, 3, 12, 2, 9],
                                     [30, 1, 17]],
                         ids=["one-seed-5-events", "unequal-6-events",
                              "long-3-events"])
def test_decay_stack_matches_jax(rng, combine, normalize, lengths):
    """Event counts 5, 6 and 3 (none a power of two) and tracks of
    unequal length: the JAX package pads both axes, the port pads
    neither."""
    shape = (37, 45)
    tracks = _tracks(rng, shape, lengths)
    confs = rng.uniform(-0.2, 1.0, len(tracks)).astype(np.float32)
    got, want = _both(shape, tracks, confs, 0.05, combine, normalize)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert got.max() > 0
    if normalize:
        assert got.min() == 0.0 and got.max() == pytest.approx(1.0)


def test_flat_seed_array_is_one_seed_per_event(rng):
    """A flat (E, 2) array (the area query's form) is E one-seed events."""
    shape = (20, 24)
    seeds = rng.uniform(0, 20, (6, 2)).astype(np.float32)
    confs = rng.uniform(0, 1, 6)
    got, want = _both(shape, seeds, confs, 0.1, "max", True)
    np.testing.assert_allclose(got, want, atol=ATOL)
    listed, _ = _both(shape, list(seeds[:, None]), confs, 0.1, "max", True)
    np.testing.assert_array_equal(got, listed)


@pytest.mark.parametrize("combine", ["max", "sum"])
def test_no_events_and_empty_tracks(rng, combine):
    got, want = _both((8, 9), [], [], 0.1, combine, True)
    np.testing.assert_array_equal(got, np.zeros((8, 9), np.float32))
    np.testing.assert_array_equal(got, want)
    # an empty track is all padding in the JAX package: it adds nothing
    tracks = _tracks(rng, (8, 9), [3]) + [np.zeros((0, 2), np.float32)]
    got, want = _both((8, 9), tracks, [0.7, 0.9], 0.1, combine, False)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_seed_chunks_give_the_same_heat(rng):
    """Seeds folded in chunks of one and in one block: the min is exact."""
    shape = (16, 18)
    tracks = _tracks(rng, shape, [11, 4])
    conf = torch.tensor([0.8, 0.5])
    ts = [torch.from_numpy(t) for t in tracks]
    one = theat._stacked_decay_scan(ts, conf, *shape, 0.05, "sum",
                                    chunk_bytes=4 * shape[0] * shape[1])
    block = theat._stacked_decay_scan(ts, conf, *shape, 0.05, "sum")
    torch.testing.assert_close(one, block, rtol=0, atol=0)


def test_device_delivery_and_default_device(rng, monkeypatch):
    tracks = _tracks(rng, (10, 12), [2, 3])
    out = theat.decayed_point_heatmap_2d((10, 12), tracks, [0.5, 1.0], 0.1,
                                         as_device=True, device="cpu")
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        theat.decayed_point_heatmap_2d((10, 12), tracks, [0.5, 1.0], 0.1)


@pytest.mark.parametrize("shape,frac", [((40, 33), 0.03), ((17, 64), 0.2),
                                        ((9, 9), 0.0)])
def test_edt_is_exact(rng, shape, frac):
    mask = rng.random(shape) < frac
    got = theat.distance_transform_edt(torch.from_numpy(mask)).numpy()
    want = np.asarray(jheat.distance_transform_edt_jax(mask))
    np.testing.assert_array_equal(got, want)
    if mask.any():
        np.testing.assert_allclose(got, ndi.distance_transform_edt(~mask),
                                   rtol=1e-6)


@pytest.mark.parametrize("decay_rate", [0.01, 0.002, 0.0])
def test_heatmap_from_mask_2d_matches_jax(rng, decay_rate):
    """0.01 at cell 0.05 takes the banded EDT (r = 6); 0.002 and 0 the
    full one."""
    mask = (rng.random((48, 40)) < 0.02).astype(np.uint8)
    want = np.asarray(jheat.heatmap_from_mask_2d(mask, cell_size=0.05,
                                                 decay_rate=decay_rate))
    got = theat.heatmap_from_mask_2d(mask, cell_size=0.05,
                                     decay_rate=decay_rate, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    dev = theat.heatmap_from_mask_2d(torch.from_numpy(mask), cell_size=0.05,
                                     decay_rate=decay_rate, as_device=True)
    np.testing.assert_array_equal(dev.numpy(), got)


def test_radial_decay_matches_jax(rng):
    pos = rng.integers(0, 50, (300, 3)).astype(np.int32)
    center = np.array([20, 31, 4], np.float32)
    want = np.asarray(jheat.radial_decay_heatmap(pos, center, 0.02, 0.9))
    got = theat.radial_decay_heatmap(pos, center, 0.02, 0.9, device="cpu")
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
