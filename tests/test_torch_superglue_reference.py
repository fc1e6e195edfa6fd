"""The port's SuperPoint and SuperGlue against the benchmark's plain
reference (portbench/reference/superglue.py) on seeded tiny weights on
the CPU, faults planted in the port that the comparison must catch, and
the image query's ranges and counters (avlmaps_torch/map/visual_map.py),
and the benchmark's decision and pose (portbench/reference/superglue.py
``matches``, portbench/reference/pose.py) against the port's.

The reference imports nothing of the port; both get the same weights.
SuperPoint's keypoints must be equal and its descriptors within 1e-5;
SuperGlue's log assignment within 1e-5 over the valid rows and columns
and the dustbins, the reference running on the valid keypoints alone.
"""

import dataclasses
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from avlmaps_torch.config import load_config
from avlmaps_torch.geometry.projection import get_sim_cam_mat
from avlmaps_torch.map.visual_map import VisualMap, rgb_to_gray_u8
from avlmaps_torch.models import superglue as tsg
from avlmaps_torch.models.clip import ClipEncoder
from avlmaps_torch.models.superglue import SuperGlueConfig, SuperGlueMatcher
from avlmaps_torch.models.superpoint import (SuperPointConfig,
                                             SuperPointExtractor)
from portbench.reference import pose as ref_pose
from portbench.reference import superglue as ref
from portbench.reference.precision import Precision

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tests.test_visual_map import (DEPTH, H, TX, W,  # noqa: E402
                                   textured_canvas)

TOL = 1e-5
RANGES = ("query.image.retrieve", "query.image.superpoint",
          "query.image.ref", "query.image.gnn", "query.image.sinkhorn",
          "query.image.decide", "query.image.pnp")


def _sp_config(**kw):
    return dataclasses.replace(SuperPointConfig.tiny(), nms_radius=3,
                               max_keypoints=48, score_threshold=0.015,
                               **kw)


def _images(seed, n, h, w):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("seed,h,w", [(0, 64, 88), (1, 61, 90),
                                      (2, 48, 48)])
def test_superpoint_matches_reference(seed, h, w):
    sp = SuperPointExtractor(_sp_config(), seed=seed, device="cpu")
    rgb = _images(seed, 2, h, w)
    gray = rgb_to_gray_u8(rgb).astype(np.float32) / 255.0
    np.testing.assert_array_equal(ref.gray(rgb), gray)
    out = sp.extract_device(gray)
    cfg = dataclasses.asdict(sp.cfg)
    for b in range(2):
        r = ref.superpoint(sp.model.state_dict(), torch.from_numpy(gray[b]),
                           cfg, Precision())
        v = out["valid"][b]
        assert 0 < int(v.sum()) <= cfg["max_keypoints"]
        assert torch.equal(out["keypoints"][b][v], r["keypoints"])
        for k in ("scores", "descriptors"):
            assert float((out[k][b][v] - r[k]).abs().max()) <= TOL


def _features(seed, k, n_valid, hw):
    """A padded (1, k, ...) keypoint set with ``n_valid`` valid rows."""
    g = torch.Generator().manual_seed(seed)
    h, w = hw
    xy = torch.rand(1, k, 2, generator=g) * torch.tensor([w - 1.0, h - 1.0])
    valid = torch.zeros(1, k, dtype=torch.bool)
    valid[0, torch.randperm(k, generator=g)[:n_valid]] = True
    return {"keypoints": xy.round(), "scores": torch.rand(1, k, generator=g),
            "descriptors": F.normalize(torch.randn(1, k, 32, generator=g),
                                       dim=-1), "valid": valid}


def _assignment_gap(sg, f0, f1, hw0, hw1):
    """max |Z - Z_ref| over the valid rows and columns and the dustbins."""
    z = sg.assignment(f0, f1, hw0, hw1)[0]
    v0, v1 = f0["valid"][0], f1["valid"][0]
    sub = [{k: f[k][0][v] for k in ("keypoints", "scores", "descriptors")}
           for f, v in ((f0, v0), (f1, v1))]
    zr = ref.superglue(sg.model.state_dict(), *sub, hw0, hw1,
                       dataclasses.asdict(sg.cfg), Precision())
    rows = torch.cat([v0.nonzero()[:, 0], torch.tensor([len(v0)])])
    cols = torch.cat([v1.nonzero()[:, 0], torch.tensor([len(v1)])])
    return float((z[rows][:, cols] - zr).abs().max())


CASES = {"unpadded": ((40, 40), (56, 56)), "padded": ((40, 29), (56, 33))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_superglue_matches_reference(case):
    (k0, n0), (k1, n1) = CASES[case]
    sg = SuperGlueMatcher(SuperGlueConfig.tiny(), seed=3, device="cpu")
    f0 = _features(4, k0, n0, (64, 88))
    f1 = _features(5, k1, n1, (72, 96))
    assert _assignment_gap(sg, f0, f1, (64, 88), (72, 96)) <= TOL


@pytest.mark.parametrize("iters", [1, 3, 100])
def test_padded_sinkhorn_starts_on_the_valid_set(iters):
    """Sharp scores (a range of 60) and padded entries scoring high: the
    padded columns must not enter the first u update, or Z keeps their
    trace until the iterations converge."""
    g = torch.Generator().manual_seed(7)
    scores = 30.0 * torch.rand(1, 24, 20, generator=g) - 10.0
    valid0 = torch.arange(24)[None] < 17
    valid1 = torch.arange(20)[None] < 13
    scores[:, 17:] = 50.0
    scores[:, :, 13:] = 50.0
    alpha = torch.tensor(1.0)
    z = tsg.log_optimal_transport(scores, alpha, valid0, valid1, iters)[0]
    zr = ref.log_optimal_transport(scores[:, :17, :13], alpha, iters)[0]
    rows = torch.cat([torch.arange(17), torch.tensor([24])])
    cols = torch.cat([torch.arange(13), torch.tensor([20])])
    assert float((z[rows][:, cols] - zr).abs().max()) <= TOL


def _blocked_heads(self, x, src, src_valid):
    """Head h owns channels [h * hd, (h + 1) * hd): blocked, not strided."""
    b, n, d = x.shape
    h = self.heads
    hd = d // h
    q = self.q(x).reshape(b, n, h, hd).transpose(2, 3)
    k = self.k(src).reshape(b, src.shape[1], h, hd).transpose(2, 3)
    v = self.v(src).reshape(b, src.shape[1], h, hd).transpose(2, 3)
    logits = torch.einsum("bqdh,bkdh->bhqk", q, k) / hd ** 0.5
    logits = torch.where(src_valid[:, None, None, :], logits,
                         torch.full_like(logits, tsg.NEG))
    msg = torch.einsum("bhqk,bkdh->bqdh", torch.softmax(logits, -1), v)
    msg = msg.transpose(2, 3).reshape(b, n, d)
    return self.mlp1(F.relu(self.mlp0(torch.cat([x, self.merge(msg)], -1))))


def _cross_reads_updated(self, kpts0, scores0, desc0, valid0, kpts1,
                         scores1, desc1, valid1, hw0, hw1=None):
    """The second cross delta reads set 0 after its cross update."""
    d0 = desc0 + self.kenc(kpts0, scores0, hw0)
    d1 = desc1 + self.kenc(kpts1, scores1, hw1 or hw0)
    for pair in range(self.cfg.gnn_layers):
        s, c = self.gnn[2 * pair], self.gnn[2 * pair + 1]
        d0, d1 = d0 + s(d0, d0, valid0), d1 + s(d1, d1, valid1)
        d0 = d0 + c(d0, d1, valid1)
        d1 = d1 + c(d1, d0, valid0)
    scores = torch.einsum("bnd,bmd->bnm", self.final_proj(d0),
                          self.final_proj(d1)) / self.cfg.desc_dim ** 0.5
    return tsg.log_optimal_transport(scores, self.bin_score, valid0, valid1,
                                     self.cfg.sinkhorn_iters)


def _v_before_u(scores, alpha, valid0, valid1, iters):
    """The Sinkhorn with each iteration's v updated before its u."""
    b, m, n = scores.shape
    nv0, nv1 = valid0.sum(1).float(), valid1.sum(1).float()
    norm = -torch.log(nv0 + nv1)[:, None]
    a = torch.as_tensor(alpha).reshape(1, 1, 1).expand(b, 1, 1)
    c = torch.cat([torch.cat([scores, a.expand(b, m, 1)], 2),
                   torch.cat([a.expand(b, 1, n), a], 2)], 1)
    neg = torch.tensor(tsg.NEG)
    mu = torch.cat([torch.where(valid0, norm, neg), nv1.log()[:, None] + norm],
                   1)
    nu = torch.cat([torch.where(valid1, norm, neg), nv0.log()[:, None] + norm],
                   1)
    u, v = torch.zeros_like(mu), torch.zeros_like(nu)
    for _ in range(iters):
        v = nu - torch.logsumexp(c + u[:, :, None], dim=1)
        u = mu - torch.logsumexp(c + v[:, None, :], dim=2)
    return c + u[:, :, None] + v[:, None, :] - norm[..., None]


FAULTS = {
    "blocked_heads": (tsg.model.Propagation, "forward", _blocked_heads),
    "cross_reads_updated": (tsg.model.SuperGlueNet, "forward",
                            _cross_reads_updated),
    "v_before_u": (tsg.model, "log_optimal_transport", _v_before_u),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_comparison(fault, monkeypatch):
    owner, name, planted = FAULTS[fault]
    # three iterations: ten nearly converge, and then the order of the
    # half-updates no longer shows
    sg = SuperGlueMatcher(dataclasses.replace(SuperGlueConfig.tiny(),
                                              sinkhorn_iters=3),
                          seed=3, device="cpu")
    f0 = _features(4, 40, 29, (64, 88))
    f1 = _features(5, 56, 33, (72, 96))
    assert _assignment_gap(sg, f0, f1, (64, 88), (72, 96)) <= TOL
    monkeypatch.setattr(owner, name, planted)
    assert _assignment_gap(sg, f0, f1, (64, 88), (72, 96)) > 10 * TOL


@pytest.fixture
def scene(tmp_path):
    root = tmp_path / "scene"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    intr = get_sim_cam_mat(H, W)
    shift = int(round(intr[0, 0] * TX / DEPTH))
    tex = textured_canvas(np.random.default_rng(0), H, W + shift)
    cv2.imwrite(str(root / "rgb" / "000000.png"), tex[:, :W, ::-1])
    np.save(root / "depth" / "000000.npy", np.full((H, W), DEPTH,
                                                   np.float32))
    np.savetxt(root / "poses.txt", np.asarray([[0, 0, 0, 0, 0, 0, 1.0]]))
    return root, np.ascontiguousarray(tex[:, shift:W + shift])


def _similarity_glue(desc_dim: int) -> SuperGlueMatcher:
    """The real SuperGlue with every residual delta and the keypoint
    encoding zeroed and a scaled identity projection: its scores are
    100 x the descriptors' cosines, so it matches as a mutual-NN does."""
    cfg = SuperGlueConfig(desc_dim=desc_dim, kenc_layers=(8, 16),
                          gnn_layers=2, heads=4, sinkhorn_iters=20)
    sg = SuperGlueMatcher(cfg, seed=0, device="cpu")
    sd = sg.model.state_dict()
    last = f"kenc.enc{sg.model.kenc.n - 1}."
    for k in sd:
        if k.startswith(last) or ".mlp1." in k:
            sd[k] = torch.zeros_like(sd[k])
    sd["final_proj.weight"] = torch.eye(desc_dim) * (
        100.0 * desc_dim ** 0.5) ** 0.5
    sd["final_proj.bias"] = torch.zeros(desc_dim)
    sg.model.load_state_dict(sd)
    return sg


def _visual_map(root, sg):
    """A map of the textured scene with a tiny SuperPoint and ``sg``."""
    mc = load_config().map_config
    mc.cam_calib_mat = tuple(get_sim_cam_mat(H, W).reshape(-1))
    sp = SuperPointExtractor(SuperPointConfig(
        channels=(8, 8, 16, 16), det_ch=32, desc_ch=32, desc_dim=32,
        max_keypoints=512, score_threshold=0.0), device="cpu")
    vm = VisualMap(mc, str(root), clip_encoder=ClipEncoder("tiny",
                                                           device="cpu"),
                   superpoint=sp, superglue=sg, device="cpu")
    vm.create_and_load_map(root)
    return vm


def test_localize_image_opens_every_range_and_counts(scene):
    root, query = scene
    vm = _visual_map(root, _similarity_glue(32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cam, _ = vm.localize_image(query)
    names = {e.name for e in prof.events()}
    assert set(RANGES) <= names, set(RANGES) - names
    s = vm.stats
    assert s["queries"] == 1 and s["ref_misses"] == 1
    assert 0 < s["keypoints_query"] <= 512 and 0 < s["keypoints_ref"] <= 512
    assert s["matches"] >= 12
    assert s["pnp_attempted"] == s["pnp_solved"] == 1
    assert abs(cam[0, 3] - TX) < 0.06
    vm.localize_image(query)  # a hit: no second miss
    assert vm.stats["queries"] == 2 and vm.stats["ref_misses"] == 1


@pytest.mark.parametrize("seed,k0,k1", [(0, 40, 56), (1, 33, 33),
                                        (2, 1, 20)])
def test_reference_decision_equals_port(seed, k0, k1):
    sg = _similarity_glue(32)
    f0 = _features(seed, k0, k0, (64, 88))
    f1 = _features(seed + 10, k1, k1, (72, 96))
    # half the second set's descriptors are the first set's, perturbed
    n = min(k0, k1) // 2
    f1["descriptors"][0, :n] = F.normalize(
        f0["descriptors"][0, :n] + 0.05 * torch.randn(n, 32), dim=-1)
    z = sg.assignment(f0, f1, (64, 88), (72, 96))
    got, _ = sg.match(f0, f1, (64, 88), (72, 96))
    want = ref.matches(z[0], sg.cfg.match_threshold)
    assert (got[0].long() == want).all()
    assert int((want >= 0).sum()) >= n // 2


def _localized(scene):
    """``localize_image`` on the textured scene with the port's matches
    recorded: (camera tf, the matched reference and query pixels, the
    map configuration, the query)."""
    root, query = scene
    sg = _similarity_glue(32)
    vm = _visual_map(root, sg)
    seen = {}
    match = sg.match

    def recording(f0, f1, hw, hw1=None):
        out = match(f0, f1, hw, hw1)
        seen.update(f0=f0, f1=f1, m=out[0][0].numpy())
        return out

    sg.match = recording
    cam, _ = vm.localize_image(query)
    sel = seen["m"] >= 0
    return (cam, seen["f1"]["keypoints"][0][seen["m"][sel]],
            seen["f0"]["keypoints"][0][sel], vm.map_config, query)


def _reference_pose(root, mc, ref_xy, q_xy, query):
    pi = {"camera_height": mc.pose_info.camera_height}
    return ref_pose.pnp_pose(
        ref_xy, q_xy, np.load(root / "depth" / "000000.npy"),
        np.asarray(mc.cam_calib_mat, np.float64).reshape(3, 3),
        ref_pose.fov_intrinsics(*query.shape[:2]),
        ref_pose.camera_tf(np.loadtxt(root / "poses.txt"), pi))


def test_reference_pose_equals_port(scene):
    cam, ref_xy, q_xy, mc, query = _localized(scene)
    assert len(ref_xy) >= 12
    want = _reference_pose(scene[0], mc, ref_xy, q_xy, query)
    assert want is not None
    np.testing.assert_allclose(cam, want, rtol=0, atol=1e-12)


FRAME_FAULTS = {
    # the frame's camera left at the base's height
    "no_sensor_height": ("_ref_cam_tf",
                         lambda self, frame_id: self.poses[frame_id].copy()),
    # the solve dropped: the frame's pose returned
    "solve_dropped": ("_solve_pose", lambda self, *a: None),
}


@pytest.mark.parametrize("fault", sorted(FRAME_FAULTS))
def test_reference_pose_catches_a_planted_fault(scene, fault,
                                                monkeypatch):
    monkeypatch.setattr(VisualMap, *FRAME_FAULTS[fault])
    cam, ref_xy, q_xy, mc, query = _localized(scene)
    want = _reference_pose(scene[0], mc, ref_xy, q_xy, query)
    assert np.abs(cam - want).max() > 0.01
