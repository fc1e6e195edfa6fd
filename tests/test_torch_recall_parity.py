"""The port's recall-parity harness (avlmaps_torch/tools/recall_parity.py)
against the JAX tool (tools/recall_parity.py) on the CPU.

- The port's copy of the reference network equals
  tools/torch_reference/lseg_torch.py bit for bit (same seed, same
  input).
- Each mode's report equals the JAX tool's: voxel counts and IoU exactly
  (the same pixel draws and the same geometry on both sides), top-1
  agreement within one voxel (the port's fusion adds with ``index_add_``
  in another order than JAX's scatter), cosines within 1e-5.
"""

import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from avlmaps_torch.tools import recall_parity as trp  # noqa: E402
from avlmaps_torch.tools import reference_lseg as tref  # noqa: E402
from tools import recall_parity as jrp  # noqa: E402
from tools.torch_reference import lseg_torch as jref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the suite runs in several worker
    processes at once, and torch's default of one thread a core makes
    them fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("spec,hw", [("tiny16", 32), ("medium", 64)])
def test_reference_copy_is_the_oracle_bit_for_bit(spec, hw):
    a = tref.build_torch_lseg(getattr(tref.TorchLSegSpec, spec)(), seed=3)
    b = jref.build_torch_lseg(getattr(jref.TorchLSegSpec, spec)(), seed=3)
    sa, sb = (tref.export_reference_state_dict(a),
              jref.export_reference_state_dict(b))
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 3, hw, hw)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(a(x), b(x))


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    return rc, out, json.loads(out[out.index("{"):out.rindex("}") + 1])


@pytest.fixture(scope="module", params=["--tiny", "--medium"])
def reports(request):
    return (_run(trp.main, [request.param, "--device", "cpu"]),
            _run(jrp.main, [request.param]))


def test_port_tool_passes(reports):
    (rc, out, report), _ = reports
    assert rc == 0
    assert out.rstrip().endswith("RECALL PARITY: PASS")
    assert report["mode"] in ("tiny-synthetic", "medium-synthetic")


def test_report_matches_the_jax_tool(reports):
    (_, _, got), (jrc, _, want) = reports
    assert jrc == 0
    assert got.keys() == want.keys()
    for key in ("mode", "voxels_flax", "voxels_oracle", "voxel_iou"):
        assert got[key] == want[key], key
    common = round(want["voxel_iou"] * (want["voxels_flax"]
                                        + want["voxels_oracle"])
                   / (1 + want["voxel_iou"]))
    assert abs(got["top1_agreement"] - want["top1_agreement"]) * common \
        <= 1 + 1e-9
    for key in ("feature_cos_mean", "feature_cos_min"):
        assert abs(got[key] - want[key]) <= 1e-5, key
    assert got["per_landmark_iou"].keys() == want["per_landmark_iou"].keys()
    assert got["feature_cos_min"] > 0.99


def test_near_ties_split_the_disagreements():
    """A voxel whose oracle top-2 margin is below the given tolerance is a
    near tie; one above it is not, however far the map under test is off
    elsewhere."""
    text = np.eye(3, dtype=np.float32)
    pos = np.array([[0, 0, 0], [0, 0, 1], [0, 0, 2]], np.int32)
    ofeat = np.array([[1.0, 0.99, 0], [0.8, 0.6, 0], [0, 0, 1]],
                     np.float32)
    feat = ofeat.copy()
    feat[0] = [0.98, 1.0, 0]  # flips a near tie (margin 0.007)
    # flips a clear winner (margin 0.2) by moving each score by ~0.1
    feat[1] = [0.69, 0.71, 0]
    top1, otop1 = trp.score_top1(feat, text), trp.score_top1(ofeat, text)
    got = trp.near_ties(pos, feat, top1, pos, ofeat, otop1, text, tol=0.05)
    assert (got["disagreements"], got["near_ties"],
            got["not_near_ties"]) == (2, 1, 1)
    assert got["tie_tol"] == 0.05
    assert abs(got["max_score_d"] - 0.117) < 1e-3
    # a map further off raises its largest score difference past both
    # margins; the split stays where the tolerance puts it
    feat[2] = [0.0, 0.6, 0.8]
    top1 = trp.score_top1(feat, text)
    got = trp.near_ties(pos, feat, top1, pos, ofeat, otop1, text, tol=0.05)
    assert got["max_score_d"] > 0.2
    assert (got["disagreements"], got["near_ties"],
            got["not_near_ties"]) == (2, 1, 1)
