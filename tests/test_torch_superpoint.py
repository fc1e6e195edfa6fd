"""The port's SuperPoint (avlmaps_torch/models/superpoint) against the JAX
package's, on the CPU in f32, at tiny widths on weights bridged from flax.

Tolerances: the forward's scores at rtol 1e-4 / atol 1e-6 and its unit
descriptors at atol 1e-5 (the same f32 convolutions summed in another
order); keypoint selection, its tie order and the mutual-NN decisions
are exact; sampled descriptors at atol 1e-6; the state-dict port and the
checkpoint loader are exact.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlmaps_tpu.models.superpoint import SuperPointConfig as JaxSPConfig
from avlmaps_tpu.models.superpoint import SuperPointExtractor as JaxSPExt
from avlmaps_tpu.models.superpoint import SuperPointNet as JaxSPNet
from avlmaps_tpu.models.superpoint import model as jsp
from avlmaps_tpu.models.superpoint import port as jport
from avlmaps_torch.models.superpoint import (SuperPointConfig,
                                             SuperPointExtractor,
                                             SuperPointNet,
                                             config_from_state_dict,
                                             init_params,
                                             load_superpoint_checkpoint,
                                             mutual_nearest_matches,
                                             params_from_flax,
                                             port_superpoint_state_dict,
                                             sample_descriptors,
                                             select_keypoints)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools.torch_reference.superpoint_torch import TorchSuperPoint  # noqa

TINY = SuperPointConfig.tiny()


def _variables(seed: int = 0):
    """Flax SuperPoint variables with non-zero biases."""
    jnet = JaxSPNet(JaxSPConfig.tiny())
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(seed),
                                   jnp.zeros((1, 48, 64, 1), jnp.float32))
    noise = np.random.default_rng(seed + 1)
    return jax.tree.map(lambda a: np.asarray(a) + noise.normal(
        size=a.shape).astype(np.float32) * 0.05, variables)


def test_forward_matches_jax():
    variables = _variables()
    net = SuperPointNet(TINY, device="cpu")
    net.load_state_dict(params_from_flax(variables), strict=True)
    x = np.random.default_rng(2).uniform(0, 1, (2, 48, 64)).astype(
        np.float32)
    want_s, want_d = JaxSPNet(JaxSPConfig.tiny()).apply(
        variables, jnp.asarray(x[..., None]))
    with torch.no_grad():
        got_s, got_d = net(torch.from_numpy(x))
    assert got_s.shape == (2, 48, 64) and got_d.shape == (2, 6, 8, 32)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5)


def _plateau_scores(rng):
    """Scores with flat plateaus (NMS keeps every pixel of one), exact
    ties between peaks, and a zero background."""
    s = np.zeros((2, 40, 48), np.float32)
    s[:, 3:6, 4:7] = 0.5           # a 3x3 plateau
    s[:, 20, 10] = s[:, 30, 40] = 0.7  # a tie between two peaks
    s[:, 12, 30] = 0.9
    s[:, 12, 33] = 0.8             # inside the 0.9 peak's radius
    s[1] += rng.uniform(0, 0.01, (40, 48)).astype(np.float32) * (
        rng.uniform(size=(40, 48)) < 0.05)
    return s


@pytest.mark.parametrize("threshold", [0.0, 0.1])
def test_select_keypoints_and_tie_order_match_jax(rng, threshold):
    """NMS plateaus, ties and the zero tail come out in jax.lax.top_k's
    order (the lower flat index first), coordinates of invalid rows too."""
    s = _plateau_scores(rng)
    want = jsp.select_keypoints(jnp.asarray(s), 32, 2, threshold)
    got = select_keypoints(torch.from_numpy(s), 32, 2, threshold)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # image 0: the 9 plateau pixels, the tied pair, 0.9 and 0.8 (3 px off)
    assert int(got[2][0].sum()) == 13


def test_sample_descriptors_match_jax(rng):
    """MagicLeap's mapping, border and out-of-map keypoints included."""
    desc = rng.normal(size=(2, 6, 8, 16)).astype(np.float32)
    xy = np.stack([rng.uniform(-6, 70, (2, 50)),
                   rng.uniform(-6, 54, (2, 50))], -1).astype(np.float32)
    xy[:, :4] = [[0, 0], [63, 47], [3.5, 3.5], [60.5, 44.5]]
    want = jsp.sample_descriptors(jnp.asarray(desc), jnp.asarray(xy))
    got = sample_descriptors(torch.from_numpy(desc), torch.from_numpy(xy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("ratio", [False, True])
def test_mutual_nearest_matches_match_jax(rng, ratio):
    d = rng.normal(size=(40, 16)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    db = d[rng.permutation(40)[:30]] + rng.normal(size=(30, 16)).astype(
        np.float32) * 0.3
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    va, vb = rng.uniform(size=40) < 0.8, rng.uniform(size=30) < 0.9
    want = jsp.mutual_nearest_matches(jnp.asarray(d), jnp.asarray(db),
                                      jnp.asarray(va), jnp.asarray(vb),
                                      0.2, ratio=ratio)
    got = mutual_nearest_matches(torch.from_numpy(d), torch.from_numpy(db),
                                 torch.from_numpy(va), torch.from_numpy(vb),
                                 0.2, ratio=ratio)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == torch.int32 and (got[0].numpy() >= 0).sum() > 5
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6)


def test_extract_with_padding_matches_jax():
    """Inputs of 30x41 pad to 32x48 with zeroed padded scores; the
    fixed-size keypoint batch equals JAX's."""
    variables = _variables(3)
    cfg = SuperPointConfig(channels=TINY.channels, det_ch=TINY.det_ch,
                           desc_ch=TINY.desc_ch, desc_dim=TINY.desc_dim,
                           max_keypoints=48, score_threshold=0.0)
    jext = JaxSPExt(JaxSPConfig(channels=cfg.channels, det_ch=cfg.det_ch,
                                desc_ch=cfg.desc_ch, desc_dim=cfg.desc_dim,
                                max_keypoints=48, score_threshold=0.0),
                    params=variables)
    text = SuperPointExtractor(cfg, params=params_from_flax(variables),
                               device="cpu")
    imgs = np.random.default_rng(4).uniform(0, 1, (2, 30, 41)).astype(
        np.float32)
    want, got = jext.extract(imgs), text.extract(imgs)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["keypoints"], want["keypoints"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got["descriptors"], want["descriptors"],
                               atol=1e-5)
    kp = got["keypoints"][got["valid"]]
    assert (kp[:, 0] < 41).all() and (kp[:, 1] < 30).all()


def test_state_dict_port_matches_jax(tmp_path):
    """superpoint_v1.pth's layout loads straight into the module: the same
    tensors the JAX porter makes, and the same config."""
    torch.manual_seed(0)
    ref = TorchSuperPoint(channels=TINY.channels, det_ch=TINY.det_ch,
                          desc_ch=TINY.desc_ch, desc_dim=TINY.desc_dim)
    sd = ref.state_dict()
    got = port_superpoint_state_dict(sd)
    want = params_from_flax(jport.port_superpoint_state_dict(sd))
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    jcfg = jport.config_from_state_dict(sd)
    cfg = config_from_state_dict(sd)
    assert (cfg.channels, cfg.det_ch, cfg.desc_ch, cfg.desc_dim) == (
        jcfg.channels, jcfg.det_ch, jcfg.desc_ch, jcfg.desc_dim)
    path = tmp_path / "superpoint_v1.pth"
    torch.save(sd, path)
    cfg2, loaded = load_superpoint_checkpoint(str(path))
    assert cfg2 == cfg
    net = SuperPointNet(cfg2, device="cpu")
    net.load_state_dict(loaded, strict=True)
    x = torch.rand(1, 1, 24, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ws, wd = ref(x)
        gs, gd = net(x[:, 0])
    torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(gd, wd.permute(0, 2, 3, 1), rtol=1e-5,
                               atol=1e-6)


def test_init_params_seeded_at_full_width():
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a, b = init_params(SuperPointConfig(), g1), init_params(
        SuperPointConfig(), g2)
    assert a.keys() == SuperPointNet(SuperPointConfig(),
                                     device="meta").state_dict().keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert a["convDb.weight"].shape == (256, 256, 1, 1)
    assert float(a["conv1a.bias"].abs().max()) == 0.0
