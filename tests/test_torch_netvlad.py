"""The port's NetVLAD (avlmaps_torch/models/netvlad) against the JAX
package's, on the CPU in f32, at tiny widths (clusters 4, dim 32,
whitening 16; the JAX package's two-conv test plan).

Tolerances: descriptors (unit vectors) at atol 1e-5, the same f32
network summed in another order; the ``.mat`` loader is exact.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlmaps_tpu.models.netvlad import NetVLAD as JaxNetVLAD
from avlmaps_tpu.models.netvlad import NetVLADConfig as JaxNVConfig
from avlmaps_tpu.models.netvlad import NetVLADEncoder as JaxNVEncoder
from avlmaps_tpu.models.netvlad import load_netvlad_encoder as jax_load_enc
from avlmaps_tpu.models.netvlad import load_netvlad_mat as jax_load_mat
from avlmaps_torch.models.netvlad import (NetVLAD, NetVLADConfig,
                                          NetVLADEncoder, init_params,
                                          load_netvlad_encoder,
                                          load_netvlad_mat, params_from_flax)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tests.test_netvlad import TestNetVLADPorter  # noqa: E402

CFG = NetVLADConfig.tiny()


def _variables():
    """Flax NetVLAD variables with non-zero biases."""
    model = JaxNetVLAD(JaxNVConfig.tiny())
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 16, 16, 3), jnp.float32))
    noise = np.random.default_rng(1)
    return jax.tree.map(lambda a: np.asarray(a) + noise.normal(
        size=a.shape).astype(np.float32) * 0.05, variables)


def test_forward_matches_jax(rng):
    variables = _variables()
    net = NetVLAD(CFG, device="cpu")
    net.load_state_dict(params_from_flax(variables), strict=True)
    x = rng.normal(size=(3, 24, 32, 3)).astype(np.float32) * 60.0
    want = np.asarray(JaxNetVLAD(JaxNVConfig.tiny()).apply(variables,
                                                           jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (3, CFG.whiten_dim)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_encoder_matches_jax_across_batches():
    """get_img_feats / get_imgs_feats_batch with the average image
    subtracted, 5 images in batches of 2."""
    avg = np.asarray([100.0, 110.0, 120.0], np.float32)
    jenc = JaxNVEncoder(JaxNVConfig.tiny(), params=_variables(),
                        average_image=avg)
    tenc = NetVLADEncoder(CFG, params=params_from_flax(jenc.params),
                          average_image=avg, device="cpu")
    assert tenc.feat_dim == jenc.feat_dim == 16
    imgs = [np.random.default_rng(i).integers(0, 255, (24, 32, 3)).astype(
        np.uint8) for i in range(5)]
    np.testing.assert_allclose(tenc.get_imgs_feats_batch(imgs, 2),
                               jenc.get_imgs_feats_batch(imgs, 2),
                               atol=1e-5)
    np.testing.assert_allclose(tenc.get_img_feats(imgs[0]),
                               jenc.get_img_feats(imgs[0]), atol=1e-5)


def test_mat_loader_matches_jax(tmp_path, rng):
    """A matconvnet file built as tests/test_netvlad.py builds one: the
    port's state_dict is the JAX porter's (centres un-negated), and the
    loaded encoders agree."""
    mat = tmp_path / "netvlad.mat"
    TestNetVLADPorter()._write_mat(mat, rng)
    sd, avg, cfg = load_netvlad_mat(str(mat))
    jparams, javg, jcfg = jax_load_mat(str(mat))
    assert (cfg.clusters, cfg.dim, cfg.whiten_dim) == (
        jcfg.clusters, jcfg.dim, jcfg.whiten_dim)
    np.testing.assert_array_equal(avg, javg)
    want = params_from_flax(jparams)
    assert sd.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)
    tenc = load_netvlad_encoder(str(mat), device="cpu")
    jenc = jax_load_enc(str(mat))
    img = rng.integers(0, 255, (16, 16, 3)).astype(np.uint8)
    np.testing.assert_allclose(tenc.get_img_feats(img),
                               jenc.get_img_feats(img), atol=1e-5)


def test_mat_loader_rejects_an_unknown_layout(tmp_path):
    from scipy.io import savemat

    path = tmp_path / "bad.mat"  # a conv layer, no VLAD core, no WPCA
    weights = np.empty(2, object)
    weights[0] = np.ones((3, 3, 3, 4), np.float32)
    weights[1] = np.zeros(4, np.float32)
    savemat(path, {"net": {"layers": [{"name": "conv1_1",
                                       "weights": weights}]}})
    with pytest.raises(ValueError, match="unrecognised NetVLAD"):
        load_netvlad_mat(str(path))


def test_full_width_layout_and_seeded_init():
    """VGG16 to conv5_3 (13 convs), K*D = 32,768 -> 4,096 whitening."""
    cfg = NetVLADConfig()
    shapes = NetVLAD(cfg, device="meta").state_dict()
    assert sum(k.endswith(".weight") and k.startswith("backbone")
               for k in shapes) == 13
    assert tuple(shapes["whiten.weight"].shape) == (4096, 32768)
    a = init_params(CFG, torch.Generator().manual_seed(3))
    b = init_params(CFG, torch.Generator().manual_seed(3))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    # the seeded assignment is NetVLAD's, from the centres
    c = a["centers"]
    torch.testing.assert_close(a["assign.weight"], 200.0 * c)
    torch.testing.assert_close(a["assign.bias"], -100.0 * (c * c).sum(1))
