"""The port's SuperGlue (avlmaps_torch/models/superglue) against the JAX
package's, on the CPU in f32, at tiny widths.

The weights come from the torch-layout oracle of tools/torch_reference
(gain 3 sharpens attention, so a blocked instead of strided head layout
cannot hide), ported by each package; the port's BatchNorm folding must
give the very tensors the JAX porter gives.

Tolerances: the full log assignment Z at atol 1e-4 (the same f32
network and Sinkhorn summed in another order); the Sinkhorn alone at
atol 2e-5 after 20 and after 100 iterations; padding changes the valid
block by at most 1e-4, as in the JAX package's own test; the decisions
(matches) are exact and the match scores at atol 1e-4.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlmaps_tpu.models.superglue import SuperGlueConfig as JaxSGConfig
from avlmaps_tpu.models.superglue import SuperGlueMatcher as JaxSGMatcher
from avlmaps_tpu.models.superglue import SuperGlueNet as JaxSGNet
from avlmaps_tpu.models.superglue import model as jsg
from avlmaps_tpu.models.superglue import port as jport
from avlmaps_torch.models.superglue import (SuperGlueConfig,
                                            SuperGlueMatcher,
                                            config_from_state_dict,
                                            init_params,
                                            load_superglue_checkpoint,
                                            log_optimal_transport,
                                            match_from_assignment,
                                            params_from_flax,
                                            port_superglue_state_dict)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools.torch_reference.superglue_torch import (  # noqa: E402
    TorchSuperGlueSpec, build_torch_superglue, export_reference_state_dict)

TINY = SuperGlueConfig.tiny()
HW, HW1 = (48, 64), (64, 80)
KEYS = ("keypoints", "scores", "descriptors", "valid")


def _unit(x):
    x = np.asarray(x, np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _feats(rng, k, d=TINY.desc_dim, hw=HW, n_valid=None):
    h, w = hw
    valid = np.ones((1, k), bool)
    if n_valid is not None:
        valid[0, n_valid:] = False
    return {"keypoints": np.stack([rng.uniform(0, w, k),
                                   rng.uniform(0, h, k)],
                                  -1).astype(np.float32)[None],
            "scores": rng.uniform(0.1, 1.0, k).astype(np.float32)[None],
            "descriptors": _unit(rng.normal(size=(k, d)))[None],
            "valid": valid}


@pytest.fixture(scope="module")
def ported():
    """(torch-layout state dict, JAX variables ported from it)."""
    tm = build_torch_superglue(TorchSuperGlueSpec.tiny(), seed=0, gain=3.0)
    sd = export_reference_state_dict(tm)
    return sd, jport.port_superglue_state_dict(sd)


def _jax_z(variables, f0, f1, hw1=None):
    args = [jnp.asarray(f0[k]) for k in KEYS] + [jnp.asarray(f1[k])
                                                  for k in KEYS]
    return np.asarray(JaxSGNet(JaxSGConfig.tiny()).apply(variables, *args,
                                                         HW, hw1))


def test_bn_folding_port_matches_jax(ported, tmp_path):
    sd, variables = ported
    got = port_superglue_state_dict(sd)
    want = params_from_flax(variables)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    cfg, jcfg = config_from_state_dict(sd), jport.config_from_state_dict(sd)
    assert (cfg.desc_dim, cfg.kenc_layers, cfg.gnn_layers, cfg.heads,
            cfg.sinkhorn_iters) == (jcfg.desc_dim, jcfg.kenc_layers,
                                    jcfg.gnn_layers, jcfg.heads,
                                    jcfg.sinkhorn_iters)
    assert cfg.sinkhorn_iters == 100
    path = tmp_path / "superglue_indoor.pth"
    torch.save(sd, path)
    cfg20, loaded = load_superglue_checkpoint(str(path), sinkhorn_iters=20)
    assert cfg20.sinkhorn_iters == 20 and loaded.keys() == got.keys()


def test_assignment_matches_jax_on_bridged_weights(ported):
    """The full Z and the decisions, each set normalised by its own image
    shape, with a few padded keypoints in set 1."""
    sd, variables = ported
    rng = np.random.default_rng(0)
    f0 = _feats(rng, 24)
    f1 = _feats(rng, 30, hw=HW1, n_valid=27)
    want = _jax_z(variables, f0, f1, HW1)
    m = SuperGlueMatcher(TINY, params=port_superglue_state_dict(sd),
                         device="cpu")
    got = m.assignment(f0, f1, HW, HW1).numpy()
    assert got.shape == (1, 25, 31) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4)
    tmatch, tscore = m.match(f0, f1, HW, HW1)
    # the untrained tiny net's mutual pairs score ~0.016: the default 0.2
    # threshold keeps none, so the rule is also held at 0.01 and 0
    for threshold, t in ((TINY.match_threshold, tmatch), (0.01, None),
                         (0.0, None)):
        jm, js = jsg.match_from_assignment(
            jnp.asarray(want), jnp.asarray(f0["valid"]),
            jnp.asarray(f1["valid"]), threshold=threshold)
        if t is None:
            t, tscore = match_from_assignment(
                torch.from_numpy(got), torch.from_numpy(f0["valid"]),
                torch.from_numpy(f1["valid"]), threshold)
        np.testing.assert_array_equal(t.numpy(), np.asarray(jm))
        np.testing.assert_allclose(tscore.numpy(), np.asarray(js),
                                   atol=1e-4)
    assert (t.numpy() >= 0).sum() >= 3


def test_padding_invariance(ported):
    """Padding either set leaves the valid block and both dustbins."""
    sd, _ = ported
    m = SuperGlueMatcher(TINY, params=port_superglue_state_dict(sd),
                         device="cpu")
    rng = np.random.default_rng(1)
    k0, k1, pad = 16, 20, 8
    f0, f1 = _feats(rng, k0), _feats(rng, k1)

    def padded(f):
        return {k: np.concatenate([v, np.zeros((1, pad) + v.shape[2:],
                                               v.dtype)], 1)
                for k, v in f.items()}

    z = m.assignment(f0, f1, HW).numpy()
    zp = m.assignment(padded(f0), padded(f1), HW).numpy()
    np.testing.assert_allclose(zp[:, :k0, :k1], z[:, :k0, :k1], atol=1e-4)
    np.testing.assert_allclose(zp[:, -1, :k1], z[:, -1, :k1], atol=1e-4)
    np.testing.assert_allclose(zp[:, :k0, -1], z[:, :k0, -1], atol=1e-4)


@pytest.mark.parametrize("iters", [20, 100])
def test_sinkhorn_matches_jax(iters):
    """Masked log-domain Sinkhorn (u first, then v), an all-padded set
    included: NEG, not -inf, keeps it finite."""
    rng = np.random.default_rng(iters)
    scores = rng.normal(scale=2.0, size=(3, 20, 24)).astype(np.float32)
    v0 = rng.uniform(size=(3, 20)) < 0.8
    v1 = rng.uniform(size=(3, 24)) < 0.7
    v1[2] = False
    want = np.asarray(jsg.log_optimal_transport(
        jnp.asarray(scores), jnp.asarray(1.3), jnp.asarray(v0),
        jnp.asarray(v1), iters))
    got = log_optimal_transport(torch.from_numpy(scores), 1.3,
                                torch.from_numpy(v0), torch.from_numpy(v1),
                                iters).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_match_from_assignment_matches_jax(rng):
    """The mutual-max rule on a Z with clear and ambiguous rows."""
    k = 32
    perm = rng.permutation(k)
    scores = rng.normal(scale=0.5, size=(2, k, k)).astype(np.float32)
    scores[:, np.arange(k), np.argsort(perm)] += np.linspace(
        0.0, 6.0, k, dtype=np.float32)
    valid = np.ones((2, k), bool)
    valid[1, 5:9] = False
    z = np.array(jsg.log_optimal_transport(
        jnp.asarray(scores), jnp.asarray(1.0), jnp.asarray(valid),
        jnp.asarray(valid), 30))
    for threshold in (0.05, 0.2, 0.6):
        jm, js = jsg.match_from_assignment(jnp.asarray(z),
                                           jnp.asarray(valid),
                                           jnp.asarray(valid), threshold)
        tm, ts = match_from_assignment(torch.from_numpy(z),
                                       torch.from_numpy(valid),
                                       torch.from_numpy(valid), threshold)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    assert (tm.numpy()[1, 5:9] == -1).all()


def test_matcher_matches_jax_matcher():
    """The wrappers on bridged seeded weights: same matches, invalid
    queries never matched."""
    jm = JaxSGMatcher(JaxSGConfig.tiny(), seed=0)
    rng = np.random.default_rng(3)
    f0, f1 = _feats(rng, 16, n_valid=10), _feats(rng, 20)
    want_m, want_s = jm.match(f0, f1, HW)
    tm = SuperGlueMatcher(TINY, params=params_from_flax(jm.params),
                          device="cpu")
    got_m, got_s = tm.match(f0, f1, HW)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)
    assert (got_m.numpy()[0, 10:] == -1).all()


def test_init_params_seeded_at_full_width():
    cfg = SuperGlueConfig()
    a = init_params(cfg, torch.Generator().manual_seed(2))
    b = init_params(cfg, torch.Generator().manual_seed(2))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert len([k for k in a if k.startswith("gnn.")]) == 18 * 12
    assert float(a["bin_score"]) == 1.0
