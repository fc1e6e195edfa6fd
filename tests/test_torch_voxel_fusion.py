"""The port's voxel fusion (avlmaps_torch/ops/voxel_fusion.py) against the
JAX package's ``fuse_points``, with its XLA scatter and with its dedup
Pallas kernel (interpret mode).

Slot allocation depends only on the order of the (stable) sort, so the
slot table, the slot count and the dropped count must be equal; the
accumulator rows are sums in another order (rtol 1e-5, atol 1e-4, the
contract of tests/test_segment_scatter.py), and the trash row is
unspecified.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlmaps_tpu.ops import segment_scatter as jax_ss
from avlmaps_tpu.ops import voxel_fusion as jvf
from avlmaps_torch.ops import voxel_fusion as tvf

GS, VH, D = 16, 4, 24


def _batch(rng, b, n_vox=GS * GS * VH):
    return (rng.integers(0, n_vox, b).astype(np.int32),
            rng.normal(size=(b, D)).astype(np.float32),
            rng.integers(0, 255, (b, 3)).astype(np.float32),
            rng.uniform(0.1, 1.0, b).astype(np.float32),
            rng.random(b) > 0.1)


def _jax_fuse(state, batch, dedup):
    return jvf.fuse_points(state, *map(jnp.asarray, batch), gs=GS, vh=VH,
                           dedup_scatter=dedup)


def _torch_fuse(state, batch):
    return tvf.fuse_points(state, *map(torch.from_numpy, batch), gs=GS,
                           vh=VH)


def _assert_same_state(ts, js):
    assert int(ts.n_slots) == int(js.n_slots)
    assert int(ts.n_dropped) == int(js.n_dropped)
    np.testing.assert_array_equal(ts.occupied_flat.numpy(),
                                  np.asarray(js.occupied_flat))
    np.testing.assert_allclose(ts.accum.numpy()[:-1],
                               np.asarray(js.accum)[:-1], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("capacity", [256, 100])
def test_fuse_points_matches_jax(rng, dedup, capacity):
    """Three consecutive batches (new and already-allocated voxels); at
    capacity 100 the later batches overflow and drop points."""
    batches = [_batch(rng, 300) for _ in range(3)]
    js = jvf.init_fusion_state(GS, VH, D, capacity)
    ts = tvf.init_fusion_state(GS, VH, D, capacity, device="cpu")
    jax_ss.FORCE_INTERPRET = dedup
    try:
        for batch in batches:
            js = _jax_fuse(js, batch, dedup)
            ts = _torch_fuse(ts, batch)
            _assert_same_state(ts, js)
    finally:
        jax_ss.FORCE_INTERPRET = False
    if capacity == 100:
        assert int(ts.n_slots) == 100 and int(ts.n_dropped) > 0


def test_capacity_overflow(rng):
    """5000 points into 100 slots: the table fills, the rest is counted as
    dropped, nothing crashes -- equal to the JAX package's counts."""
    batch = _batch(rng, 5000)
    js = _jax_fuse(jvf.init_fusion_state(GS, VH, D, 100), batch, False)
    ts = _torch_fuse(tvf.init_fusion_state(GS, VH, D, 100, device="cpu"),
                     batch)
    assert int(ts.n_slots) == 100
    _assert_same_state(ts, js)


def test_fuse_points_updates_state_in_place(rng):
    ts = tvf.init_fusion_state(GS, VH, D, 256, device="cpu")
    occ, acc = ts.occupied_flat, ts.accum
    out = _torch_fuse(ts, _batch(rng, 50))
    assert out.occupied_flat is occ and out.accum is acc
    assert int(out.n_slots) > 0


def test_export_matches_jax_and_restores(rng):
    batches = [_batch(rng, 300) for _ in range(2)]
    js = jvf.init_fusion_state(GS, VH, D, 256)
    ts = tvf.init_fusion_state(GS, VH, D, 256, device="cpu")
    for batch in batches:
        js = _jax_fuse(js, batch, False)
        ts = _torch_fuse(ts, batch)
    got = tvf.export_fusion_state(ts, GS, VH)
    want = jvf.export_fusion_state(js, GS, VH)
    np.testing.assert_array_equal(got[1], want[1])  # grid_pos
    np.testing.assert_array_equal(got[3], want[3])  # occupied_ids
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)
    # colour truncates to uint8: a sum in another order may cross an
    # integer by one
    assert np.abs(got[4].astype(int) - want[4]).max() <= 1

    # round trip: restore the export, export again
    restored = tvf.restore_fusion_state(GS, VH, 256, *got, device="cpu")
    again = tvf.export_fusion_state(restored, GS, VH)
    for a, b in zip(got[:4], again[:4]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    # w * u8 / w truncates back to the same byte or one below
    assert np.abs(got[4].astype(int) - again[4]).max() <= 1
    np.testing.assert_array_equal(restored.occupied_flat.numpy(),
                                  ts.occupied_flat.numpy())


def test_resume_matches_uninterrupted(rng):
    """Export after two batches, restore, fuse the third: the same map as
    fusing all three without a break (up to the export's rounding)."""
    batches = [_batch(rng, 300) for _ in range(3)]
    full = tvf.init_fusion_state(GS, VH, D, 256, device="cpu")
    for batch in batches:
        full = _torch_fuse(full, batch)
    part = tvf.init_fusion_state(GS, VH, D, 256, device="cpu")
    for batch in batches[:2]:
        part = _torch_fuse(part, batch)
    part = tvf.restore_fusion_state(
        GS, VH, 256, *tvf.export_fusion_state(part, GS, VH), device="cpu")
    part = _torch_fuse(part, batches[2])
    a = tvf.export_fusion_state(full, GS, VH)
    b = tvf.export_fusion_state(part, GS, VH)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[3], b[3])
    np.testing.assert_allclose(a[0], b[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a[2], b[2], rtol=1e-5, atol=1e-5)


def test_concept_fusion_alpha_matches_jax(rng):
    pts = rng.normal(size=(3, 50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tvf.concept_fusion_alpha(torch.from_numpy(pts)).numpy(),
        np.asarray(jvf.concept_fusion_alpha(jnp.asarray(pts))), rtol=1e-6)


def test_occupied_from_grid_pos_inverts_slots(rng):
    ids = rng.choice(GS * GS * VH, 20, replace=False)
    pos = np.stack(np.unravel_index(ids, (GS, GS, VH)), axis=1).astype(
        np.int32)
    occ = tvf.occupied_from_grid_pos(pos, GS, VH)
    assert (occ >= 0).sum() == 20
    np.testing.assert_array_equal(occ[pos[:, 0], pos[:, 1], pos[:, 2]],
                                  np.arange(20))


# (dedup_scatter, scatter_split, scatter_rle): the accumulate's routes;
# scatter_rle picks one of the JAX package's two K5 kernels, and the
# port's one K5 is held against both
ROUTES = [(False, True, True), (True, True, True), (True, False, True),
          (True, False, False)]


@pytest.mark.parametrize("route", ROUTES,
                         ids=["xla", "split", "assembled", "assembled_norle"])
@pytest.mark.parametrize("b", [300, 100_050], ids=["small", "over_split"])
def test_fuse_points_routes_match_jax(rng, route, b):
    """Every accumulate route with the JAX package's flags, the JAX kernels
    interpreted.  D = 128 keeps the JAX split kernel on its compiled path
    for the small batch; the 100,050-row batch exceeds its row budget, so
    the split route falls back to the assembled kernel there (and in the
    port on a card)."""
    dedup, split, rle = route
    d = 128
    vids = rng.integers(0, GS * GS * VH, b).astype(np.int32)
    batch = (vids, rng.normal(size=(b, d)).astype(np.float32),
             rng.integers(0, 255, (b, 3)).astype(np.float32),
             rng.uniform(0.1, 1.0, b).astype(np.float32), rng.random(b) > 0.1)
    js = jvf.init_fusion_state(GS, VH, d, 256)
    ts = tvf.init_fusion_state(GS, VH, d, 256, device="cpu")
    jax_ss.FORCE_INTERPRET = dedup
    try:
        for _ in range(2):
            js = jvf.fuse_points(js, *map(jnp.asarray, batch), gs=GS, vh=VH,
                                 dedup_scatter=dedup, scatter_split=split,
                                 scatter_rle=rle)
            ts = tvf.fuse_points(ts, *map(torch.from_numpy, batch), gs=GS,
                                 vh=VH, dedup_scatter=dedup,
                                 scatter_split=split)
            _assert_same_state(ts, js)
    finally:
        jax_ss.FORCE_INTERPRET = False


def test_sort_batch_orders_rows_by_final_slot(rng):
    """The accumulate's input: ascending slots, invalid points last in the
    trash slot, weights zero for them, positions once per new slot."""
    batch = _batch(rng, 400)
    state = tvf.init_fusion_state(GS, VH, D, 256, device="cpu")
    sb = tvf.sort_batch(state, *map(torch.from_numpy, batch), gs=GS, vh=VH)
    slots = sb.slots.numpy()
    assert (np.diff(slots) >= 0).all()
    n_invalid = int((~batch[4]).sum())
    assert (slots[-n_invalid:] == 256).all()
    assert (sb.w.numpy()[-n_invalid:] == 0).all()
    assert int(sb.n_unique) == len(np.unique(batch[0][batch[4]]))
    # the (row, col, h) columns are added once per allocated slot
    assert int((sb.aux[:, 4:7].abs().sum(1) > 0).sum()) <= int(sb.n_unique)
    assert sb.feats.shape == (400, D) and sb.aux.shape == (400, 128)


def test_dedup_defaults_by_device(rng, monkeypatch):
    """``dedup_scatter=None`` is off for a CPU state (the JAX default off
    its accelerator): the XLA-scatter route, ``index_add_``."""
    calls = []
    monkeypatch.setattr(tvf, "sorted_segment_scatter_add_split",
                        lambda *a, **k: calls.append("split"))
    monkeypatch.setattr(tvf, "sorted_segment_scatter_add",
                        lambda *a, **k: calls.append("assembled"))
    ts = tvf.init_fusion_state(GS, VH, D, 256, device="cpu")
    _torch_fuse(ts, _batch(rng, 50))
    assert calls == [] and int(ts.n_slots) > 0
    tvf.fuse_points(ts, *map(torch.from_numpy, _batch(rng, 50)), gs=GS,
                    vh=VH, dedup_scatter=True)
    tvf.fuse_points(ts, *map(torch.from_numpy, _batch(rng, 50)), gs=GS,
                    vh=VH, dedup_scatter=True, scatter_split=False)
    assert calls == ["split", "assembled"]
