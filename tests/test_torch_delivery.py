"""The port's delivery heads and serving queries
(avlmaps_torch/ops/delivery.py) against the JAX package's, on the CPU;
mirrors tests/test_delivery.py.

Positions and top-k orders are exact: every target voxel has heat exactly
1.0, so the top-k is a tie that both sides must break lowest index first.
Heat is held at atol 1e-6 (1e-5 where a CLIP encode precedes it), u8 and
labels exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avlmaps_tpu.models.clip import ClipEncoder as JaxClipEncoder
from avlmaps_tpu.ops import delivery as jdlv
from avlmaps_tpu.ops.similarity import score_features as jscore
from avlmaps_torch.models.clip import ClipEncoder, params_from_flax
from avlmaps_torch.ops import delivery as tdlv


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_u8_quantisation_matches_jax(rng):
    heat = np.concatenate([rng.uniform(0, 1, 4096),
                           (np.arange(256) + 0.5) / 255, [0.0, 1.0, -0.1,
                                                          1.2]]).astype(
        np.float32)
    got = tdlv.quantize_heat_u8(_t(heat))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jdlv.quantize_heat_u8(jnp.asarray(heat))))
    back = tdlv.dequantize_heat_u8(tdlv.fetch_np(got))
    assert back.dtype == np.float32
    assert np.abs(back[:4096] - heat[:4096]).max() <= 0.5 / 255 + 1e-7


def test_topk_peaks_match_jax_with_ties(rng):
    heat = rng.uniform(0, 1, 2048).astype(np.float32)
    heat[rng.random(2048) < 0.3] = 1.0
    pos = rng.integers(0, 50, (2048, 3)).astype(np.int32)
    vals, got_pos = tdlv.fetch_np(*tdlv.topk_peaks(_t(heat), _t(pos), k=64))
    want_vals, want_pos = jdlv.fetch_np(*jdlv.topk_peaks(
        jnp.asarray(heat), jnp.asarray(pos), k=64))
    np.testing.assert_array_equal(vals, want_vals)
    np.testing.assert_array_equal(got_pos, want_pos)
    order = np.argsort(-heat, kind="stable")[:64]
    np.testing.assert_array_equal(got_pos, pos[order])


def test_fused_goal_pick_matches_jax(rng):
    n = 4096
    pos = rng.integers(0, 100, (n, 3)).astype(np.int32)
    heats = [rng.uniform(0, 1, n).astype(np.float32) for _ in range(3)]
    got_pos, got_val = tdlv.fetch_np(*tdlv.fused_goal_pick(
        [_t(h) for h in heats], _t(pos)))
    want_pos, want_val = jdlv.fetch_np(*jdlv.fused_goal_pick(
        [jnp.asarray(h) for h in heats], jnp.asarray(pos)))
    np.testing.assert_array_equal(got_pos, want_pos)
    np.testing.assert_allclose(got_val, want_val, rtol=1e-6)


def test_fused_goal_pick_tie_breaks_to_first_index():
    heat = np.array([0.5, 1.0, 1.0, 0.25], np.float32)
    pos = np.arange(12, dtype=np.int32).reshape(4, 3)
    got_pos, _ = tdlv.fetch_np(*tdlv.fused_goal_pick([_t(heat)], pos))
    np.testing.assert_array_equal(got_pos, pos[1])


def _assert_clear_labels(feats, text):
    """The data has no near ties: every row's top-2 score gap exceeds
    1e-4, so labels computed in another summation order must agree."""
    s = np.sort(np.asarray(jscore(jnp.asarray(feats), jnp.asarray(text),
                                  normalize_map=True, normalize_text=True)),
                axis=1)
    assert (s[:, -1] - s[:, -2] > 1e-4).all()


def _compare(got, want, keys, heat_atol):
    got = dict(zip(keys, tdlv.fetch_np(*(got[k] for k in keys))))
    want = dict(zip(keys, jdlv.fetch_np(*(want[k] for k in keys))))
    np.testing.assert_allclose(got["heat"], want["heat"], atol=heat_atol)
    for k in keys:
        if k != "heat":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got


def test_object_query_matches_jax(rng):
    n, d, c = 1024, 64, 6
    gs, vh = 40, 8
    feats = rng.normal(size=(n, d)).astype(np.float32)
    text = rng.normal(size=(c, d)).astype(np.float32)
    grid_pos = np.stack([rng.integers(0, gs, n), rng.integers(0, gs, n),
                         rng.integers(0, vh, n)], axis=1).astype(np.int32)
    _assert_clear_labels(feats, text)
    kw = dict(cell_size=0.05, decay_rate=0.01, k=8)
    got = tdlv.make_object_query((gs, gs, vh), device="cpu", **kw)(
        _t(feats), _t(text), _t(grid_pos))
    want = jdlv.make_object_query((gs, gs, vh), **kw)(feats, text, grid_pos)
    out = _compare(got, want, ["heat", "heat_u8", "goal_pos", "topk_vals",
                               "topk_pos"], 1e-6)
    assert (out["topk_vals"] == 1).all()  # the top-8 is a tie of targets


@pytest.fixture(scope="module")
def tiny_clip_pair():
    jenc = JaxClipEncoder("tiny")
    return jenc, ClipEncoder("tiny", params=params_from_flax(jenc.params),
                             device="cpu")


def test_text_object_query_matches_jax(rng, tiny_clip_pair):
    jenc, tenc = tiny_clip_pair
    n, d = 512, tenc.feat_dim
    gs, vh = 32, 4
    feats = rng.normal(size=(n, d)).astype(np.float32)
    grid_pos = np.stack([rng.integers(0, gs, n), rng.integers(0, gs, n),
                         rng.integers(0, vh, n)], 1).astype(np.int32)
    other = rng.normal(size=(5, d)).astype(np.float32)
    query_feat = jenc.get_text_feats_multiple_templates(["chair"])
    _assert_clear_labels(feats, np.concatenate([query_feat, other]))

    kw = dict(cell_size=0.05, decay_rate=0.01, k=8, with_u8=True)
    got = tdlv.make_text_object_query(tenc, (gs, gs, vh), device="cpu",
                                      **kw)("chair", _t(feats),
                                            _t(grid_pos), _t(other))
    want = jdlv.make_text_object_query(jenc, (gs, gs, vh), **kw)(
        "chair", feats, grid_pos, other)
    _compare(got, want, ["heat", "heat_u8", "goal_pos", "topk_vals",
                         "topk_pos"], 1e-5)


def test_text_object_query_refuses_another_device(tiny_clip_pair):
    _, tenc = tiny_clip_pair
    with pytest.raises(ValueError, match="encoder lives on"):
        tdlv.make_text_object_query(tenc, (8, 8, 4), device="meta")


def test_fetch_passes_host_values_through():
    a = np.arange(3)
    b = torch.arange(4)
    got_a, got_b = tdlv.fetch_np(a, b)
    np.testing.assert_array_equal(got_a, a)
    np.testing.assert_array_equal(got_b, b.numpy())
    assert tdlv.copy_to_host_async(a, b)[1] is None
