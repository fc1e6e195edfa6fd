"""SuperGlue's Sinkhorn (``ops/sinkhorn.py``): the plain version against
the torch loop it came from, and the kernel against the plain version.

The CPU tests hold the plain version, which a CPU tensor takes, to the
loop ``models/superglue/model.py`` ran before the kernel existed, bit for
bit (``torch.equal``).  The tests marked ``cuda`` hold the kernel of
``csrc/sinkhorn.cu`` to the plain version on the card at the image query's
shape, 4096 x 4096 keypoints and 100 iterations, and show that a CUDA
tensor never runs the plain loop; they skip without a card.  The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_sinkhorn.py
"""

import pytest
import torch

from avlmaps_torch.models.superglue import (SuperGlueConfig,
                                            SuperGlueMatcher,
                                            match_from_assignment)
from avlmaps_torch.ops import sinkhorn as sk

# |Z - Z_plain| over the valid rows and columns and the dustbins.  Both
# sides run the same f32 operations in the same order; only each
# logsumexp's sum is taken in another order (32 lanes, a rescale when a
# lane's max grows), a few f32 ulps of a log-sum near 10 (ulp 1e-6).  The
# iterations contract, so the gap stays near one half-update's: a CPU
# emulation of the kernel's order read 5.7e-06 at 2048 x 2048 and 100
# iterations.  On an H100 at the 4096 x 4096 case below (all valid, and
# the last quarter of the columns padded) the kernel read 1.5e-05 and
# 1.9e-05, and planted faults in a torch copy of the loop read: the
# dustbin column left out of u's sums 3.0 and 3.4, the last valid column
# left out 1.1 and 1.6, v updated before u 2.3e-04 and 3.8e-04.  One
# iteration short read 1.1e-05 and 1.9e-05 there (the loop has converged),
# so the small pairs at 0 and 1 iterations are what hold the count.
TOL = 1e-4


def _seed_loop(scores, alpha, valid0, valid1, iters):
    """The loop ``log_optimal_transport`` ran before the kernel, as it was."""
    b, m, n = scores.shape
    dev = scores.device
    scores = scores.float()
    nv0 = valid0.sum(dim=1).float()
    nv1 = valid1.sum(dim=1).float()
    norm = -torch.log(torch.clamp(nv0 + nv1, min=1.0))[:, None]  # (B, 1)
    a = torch.as_tensor(alpha, dtype=torch.float32, device=dev).reshape(
        1, 1, 1).expand(b, 1, 1)
    couplings = torch.cat([torch.cat([scores, a.expand(b, m, 1)], dim=2),
                           torch.cat([a.expand(b, 1, n), a], dim=2)], dim=1)

    def safe_log(x):
        return torch.log(torch.clamp(x, min=1e-30))

    neg = torch.tensor(sk.NEG, dtype=torch.float32, device=dev)
    log_mu = torch.cat([torch.where(valid0, norm, neg),
                        safe_log(nv1)[:, None] + norm], dim=1)
    log_nu = torch.cat([torch.where(valid1, norm, neg),
                        safe_log(nv0)[:, None] + norm], dim=1)
    u = torch.zeros_like(log_mu)
    v = torch.where(log_nu > neg, 0.0, neg)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :] - norm[..., None]


def _case(m, n, mask, b=2, seed=0, scale=2.0, planted=0.0, device="cpu"):
    """(scores, valid0, valid1): normal scores of std ``scale``,
    ``planted`` added on a permutation (clear matches); ``mask`` pads the
    last quarter of the rows, the columns, or neither, and the second pair
    a little more."""
    g = torch.Generator().manual_seed(seed)
    scores = scale * torch.randn(b, m, n, generator=g)
    k = min(m, n)
    perm = torch.randperm(n, generator=g)[:k]
    scores[:, torch.arange(k), perm] += planted
    valid0 = torch.ones(b, m, dtype=torch.bool)
    valid1 = torch.ones(b, n, dtype=torch.bool)
    if mask == "padded_rows":
        valid0[:, 3 * m // 4:] = False
        valid0[1:, m // 2:] = False
    elif mask == "padded_cols":
        valid1[:, 3 * n // 4:] = False
        valid1[1:, n // 2:] = False
    return scores.to(device), valid0.to(device), valid1.to(device)


SHAPES = {"square": (12, 12), "ragged": (9, 14)}
MASKS = ["all_valid", "padded_rows", "padded_cols"]


@pytest.mark.parametrize("iters", [1, 20, 100])
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_version_is_the_seed_loop_bit_for_bit(shape, mask, iters):
    scores, valid0, valid1 = _case(*SHAPES[shape], mask)
    want = _seed_loop(scores, 1.3, valid0, valid1, iters)
    got = sk.sinkhorn(scores, 1.3, valid0, valid1, iters)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    assert torch.equal(sk.sinkhorn_ref(scores, torch.tensor(1.3), valid0,
                                       valid1, iters), want)


def test_cpu_never_counts_a_launch():
    scores, valid0, valid1 = _case(5, 7, "all_valid")
    before = sk.sinkhorn.launches
    sk.sinkhorn(scores, 1.0, valid0, valid1, 3)
    assert sk.sinkhorn.launches == before


@pytest.mark.parametrize("bad", ["scores_2d", "mask_shape", "iters"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    scores, valid0, valid1 = _case(4, 6, "all_valid")
    args = dict(scores=scores, alpha=1.0, valid0=valid0, valid1=valid1,
                iters=2)
    if bad == "scores_2d":
        args["scores"] = scores[0]
    elif bad == "mask_shape":
        args["valid1"] = valid1[:, :5]
    else:
        args["iters"] = -1
    with pytest.raises(ValueError, match="sinkhorn"):
        sk.sinkhorn(**args)


def test_pitch_rounds_rows_up_to_16_bytes():
    assert [sk._pitch(k) for k in (1, 4, 5, 4097)] == [4, 4, 8, 4100]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _gap(z, zp, valid0, valid1):
    """max |z - zp| over the valid rows and columns and the dustbins."""
    rows = torch.cat([valid0, torch.ones_like(valid0[:, :1])], 1)
    cols = torch.cat([valid1, torch.ones_like(valid1[:, :1])], 1)
    keep = rows[:, :, None] & cols[:, None, :]
    return float((z - zp).abs()[keep].max())


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["all_valid", "padded_cols"])
def test_kernel_matches_plain_at_the_image_query_shape(card, mask):
    scores, valid0, valid1 = _case(4096, 4096, mask, b=1, seed=21,
                                   scale=1.0, planted=12.0, device=card)
    alpha = torch.tensor(1.0, device=card)
    before = sk.sinkhorn.launches
    z = sk.sinkhorn(scores, alpha, valid0, valid1, 100)
    assert sk.sinkhorn.launches == before + 1
    zp = sk.sinkhorn_ref(scores, alpha, valid0, valid1, 100)
    assert torch.isfinite(z).all()
    assert _gap(z, zp, valid0, valid1) <= TOL
    got = match_from_assignment(z, valid0, valid1)
    want = match_from_assignment(zp, valid0, valid1)
    assert torch.equal(got[0], want[0])
    assert int((got[0] >= 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [0, 1, 20])
def test_kernel_matches_plain_on_small_ragged_pairs(card, iters):
    """B = 2; rows of 2 to 176 float4 loads (one lane's chunk to two),
    most with a partial last one; padded rows, padded columns, none."""
    for mask, (m, n) in (("padded_rows", (9, 14)), ("padded_cols", (37, 6)),
                         ("all_valid", (520, 700))):
        scores, valid0, valid1 = _case(m, n, mask, device=card)
        z = sk.sinkhorn(scores, 0.7, valid0, valid1, iters)
        zp = sk.sinkhorn_ref(scores, 0.7, valid0, valid1, iters)
        assert _gap(z, zp, valid0, valid1) <= TOL, (mask, m, n)


@pytest.mark.cuda
def test_cuda_input_never_runs_the_plain_loop(card, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain Sinkhorn on the CUDA path")

    monkeypatch.setattr(sk, "sinkhorn_ref", refuse)
    monkeypatch.setattr(torch, "logsumexp", refuse)
    sg = SuperGlueMatcher(SuperGlueConfig.tiny(), seed=1, device=card)
    g = torch.Generator().manual_seed(2)

    def feats(k):
        d = torch.nn.functional.normalize(torch.randn(1, k, 32, generator=g),
                                          dim=-1)
        return {"keypoints": 60 * torch.rand(1, k, 2, generator=g),
                "scores": torch.rand(1, k, generator=g), "descriptors": d,
                "valid": torch.ones(1, k, dtype=torch.bool)}

    before = sk.sinkhorn.launches
    z = sg.assignment(feats(40), feats(33), (64, 64))
    assert sk.sinkhorn.launches == before + 1
    assert z.shape == (1, 41, 34) and torch.isfinite(z).all()
