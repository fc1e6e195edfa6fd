"""The port's sorted segment scatter-add (K4, avlmaps_torch/ops/
segment_scatter.py) against the JAX package's split-payload Pallas kernel
in interpret mode.

The JAX kernel runs on its compiled-path shapes (d and the aux width
multiples of 128, capacity + 1 rows): the trash row (the last) is
unspecified in both, so rows [0, capacity) are compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlmaps_tpu.ops.segment_scatter import sorted_segment_scatter_add_split \
    as jax_split
from avlmaps_torch.ops.segment_scatter import (
    sorted_segment_scatter_add_split, sorted_segment_scatter_add_split_ref)

CAP, D, AUX = 64, 128, 128


def _slots(rng, pattern, b):
    if pattern == "collisions":
        s = np.sort(rng.integers(0, CAP, b))
    elif pattern == "unique":
        s = np.sort(rng.choice(CAP, b, replace=False))
    elif pattern == "one_slot":
        s = np.full(b, 17)
    else:  # trash tail: invalid points sort last, into row CAP
        s = np.sort(np.concatenate([rng.integers(0, CAP, b - 12),
                                    np.full(12, CAP)]))
    return s.astype(np.int32)


@pytest.mark.parametrize("feat_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pattern", ["collisions", "unique", "one_slot",
                                     "trash_tail"])
def test_plain_version_matches_jax_split_kernel(rng, pattern, feat_dtype):
    b = 50
    accum = rng.normal(size=(CAP + 1, D + AUX)).astype(np.float32)
    slots = _slots(rng, pattern, b)
    feats = rng.normal(size=(b, D)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, b).astype(np.float32)
    aux = rng.normal(size=(b, AUX)).astype(np.float32)

    jfeats = jnp.asarray(feats, getattr(jnp, feat_dtype))
    want = np.asarray(jax_split(jnp.asarray(accum), jnp.asarray(slots),
                                jfeats, jnp.asarray(w), jnp.asarray(aux),
                                block_rows=16, interpret=True))
    tfeats = torch.from_numpy(feats).to(getattr(torch, feat_dtype))
    got = sorted_segment_scatter_add_split(
        torch.from_numpy(accum.copy()), torch.from_numpy(slots), tfeats,
        torch.from_numpy(w), torch.from_numpy(aux))
    # f32 sums of the same rows, in-kernel FMA vs separate multiply-add:
    # the contract of tests/test_segment_scatter.py
    np.testing.assert_allclose(got.numpy()[:CAP], want[:CAP], rtol=1e-5,
                               atol=1e-5)


def test_updates_in_place_and_returns_accum(rng):
    accum = torch.zeros((CAP + 1, D + AUX))
    slots = torch.from_numpy(_slots(rng, "collisions", 20))
    out = sorted_segment_scatter_add_split(
        accum, slots, torch.ones(20, D), torch.ones(20),
        torch.zeros(20, AUX))
    assert out is accum
    counts = np.bincount(slots.numpy(), minlength=CAP + 1)
    np.testing.assert_array_equal(accum[:, 0].numpy(), counts)


def test_empty_batch_is_a_noop(rng):
    accum = torch.from_numpy(rng.normal(size=(CAP + 1, D + AUX)).astype(
        np.float32))
    before = accum.clone()
    launches = sorted_segment_scatter_add_split.launches
    out = sorted_segment_scatter_add_split(
        accum, torch.zeros(0, dtype=torch.int32), torch.zeros(0, D),
        torch.zeros(0), torch.zeros(0, AUX))
    assert out is accum
    assert sorted_segment_scatter_add_split.launches == launches
    torch.testing.assert_close(accum, before, rtol=0, atol=0)


def test_plain_version_is_index_add(rng):
    """The plain version is index_add_ of the assembled f32 update."""
    b = 30
    accum = rng.normal(size=(CAP + 1, D + AUX)).astype(np.float32)
    slots = _slots(rng, "collisions", b)
    feats = rng.normal(size=(b, D)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, b).astype(np.float32)
    aux = rng.normal(size=(b, AUX)).astype(np.float32)
    got = sorted_segment_scatter_add_split_ref(
        torch.from_numpy(accum.copy()), torch.from_numpy(slots),
        torch.from_numpy(feats), torch.from_numpy(w), torch.from_numpy(aux))
    want = np.array(accum, np.float64)
    upd = np.concatenate([w[:, None] * feats, aux], axis=1)
    for k in range(b):
        want[slots[k]] += upd[k]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- K5 ---

from avlmaps_tpu.ops.segment_scatter import sorted_segment_scatter_add \
    as jax_k5  # noqa: E402
from avlmaps_torch.ops import segment_scatter as tss  # noqa: E402


@pytest.mark.parametrize("rows", [CAP + 1, CAP, CAP + 3],
                         ids=["trash_row", "aligned", "xla_route"])
@pytest.mark.parametrize("rle", [True, False])
@pytest.mark.parametrize("pattern", ["collisions", "unique", "one_slot",
                                     "trash_tail"])
def test_k5_plain_version_matches_jax_kernel(rng, pattern, rle, rows):
    """K5's plain version against the JAX kernel (both of its payload
    kernels, ``rle``, interpret mode; the port has one) on the four slot
    patterns.  With capacity + 1 rows the
    JAX kernel discards the trash row's updates, so rows [0, CAP) are
    compared; with an 8-aligned accumulator every row counts; with
    S % 8 == 3 the JAX package takes its XLA scatter."""
    b = 50
    w = D + AUX
    accum = rng.normal(size=(rows, w)).astype(np.float32)
    slots = np.minimum(_slots(rng, pattern, b), rows - 1).astype(np.int32)
    updates = rng.normal(size=(b, w)).astype(np.float32)
    want = np.asarray(jax_k5(jnp.asarray(accum), jnp.asarray(slots),
                             jnp.asarray(updates), block_rows=16, rle=rle,
                             interpret=True))
    got = tss.sorted_segment_scatter_add(
        torch.from_numpy(accum.copy()), torch.from_numpy(slots),
        torch.from_numpy(updates))
    n = CAP if rows == CAP + 1 else rows
    np.testing.assert_allclose(got.numpy()[:n], want[:n], rtol=1e-5,
                               atol=1e-5)


def test_k5_updates_in_place_and_skips_empty_batches(rng):
    accum = torch.zeros((CAP + 1, 8))
    before = tss.sorted_segment_scatter_add.launches
    assert tss.sorted_segment_scatter_add(
        accum, torch.zeros(0, dtype=torch.int32), torch.zeros(0, 8)) \
        is accum
    slots = torch.from_numpy(_slots(rng, "collisions", 20))
    out = tss.sorted_segment_scatter_add(accum, slots, torch.ones(20, 8))
    assert out is accum
    np.testing.assert_array_equal(
        accum[:, 3].numpy(), np.bincount(slots.numpy(), minlength=CAP + 1))
    # CPU tensors take the plain version: no kernel launch is counted
    assert tss.sorted_segment_scatter_add.launches == before


def test_split_route_rule_is_the_jax_packages():
    """The split kernel's row budget is the JAX package's, so a batch takes
    the same route in both."""
    from avlmaps_tpu.ops import segment_scatter as jss

    assert tss._SPLIT_MAX_ROWS == jss._SPLIT_MAX_ROWS == 100_000


def test_wrappers_reject_other_devices():
    """A tensor on neither the CPU nor CUDA never reaches a plain version,
    through K4, its fallback to K5, or K5."""
    accum = torch.empty((CAP + 1, D + AUX), device="meta")
    slots = torch.empty((8,), dtype=torch.int32, device="meta")
    feats = torch.empty((8, D), device="meta")
    w = torch.empty((8,), device="meta")
    aux = torch.empty((8, AUX), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sorted_segment_scatter_add_split(accum, slots, feats, w, aux)
    with pytest.raises(ValueError, match="unsupported device"):
        sorted_segment_scatter_add_split(
            torch.empty((CAP + 1, 2000), device="meta"), slots,
            torch.empty((8, 1000), device="meta"), w,
            torch.empty((8, 1000), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tss.sorted_segment_scatter_add(accum, slots,
                                       torch.empty((8, D + AUX),
                                                   device="meta"))
