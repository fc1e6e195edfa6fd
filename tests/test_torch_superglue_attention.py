"""SuperGlue's masked attention (``ops/superglue_attention.py``): the
plain version against the lines it came from, and the kernel against the
plain version.

The CPU tests hold the plain version, which a CPU tensor takes, to the
attention lines ``Propagation.forward`` ran before the kernel existed,
bit for bit (``torch.equal``), and count the model's launches: one a
layer, both images as one batch (``tests/test_torch_superglue.py`` holds
that batched path to the JAX package).  The tests marked ``cuda`` hold
the kernel of ``csrc/superglue_attention.cu`` to the plain version on the
card at the image query's shapes, (1, 4096, 4096) and the (2, 4096,
4096) launch of both images with a mask each, 256 channels in 4 heads,
count its launches in a full ``SuperGlueMatcher.assignment`` and show
that a CUDA tensor never runs the plain attention; they skip without a
card.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_superglue_attention.py
"""

import dataclasses

import pytest
import torch

from avlmaps_torch.models.superglue import (SuperGlueConfig,
                                            SuperGlueMatcher,
                                            match_from_assignment)
from avlmaps_torch.models.superglue import model as sg_model
from avlmaps_torch.ops import superglue_attention as sa
from avlmaps_torch.ops.sinkhorn import NEG

# max |out - out_plain| over max(1, max |out_plain|).  Both sides take
# the same f32 products; the kernel sums the 64 products of a logit and
# the M weighted values in another order than cuBLAS, rescales its
# running sums as a row's maximum grows (online softmax), takes exp as
# ex2.approx of (x - max) * log2(e) (2 ulp) and divides once at the end,
# where the plain version normalises every probability.  Each moves an
# output by a few f32 ulps of the largest value averaged, so the gap
# grows with the outputs (unit normal values, |out| < 5): on an H100 at
# the image query's shapes max |out - out_plain| read 1.0e-05 to 1.24e-05
# against outputs of 3.9 to 4.8, 2.2e-06 to 3.3e-06 of their scale, and
# up to 1.9e-06 over the head widths' ragged cases.  1e-5 of the scale
# leaves 3x; the planted faults below read 0.91 to 1.26 of it, and the
# plain version in TF32 1.4e-03.
TOL = 1e-5
# |Z - Z_plain| of a full matcher at 4096 x 4096 keypoints and 100
# Sinkhorn iterations, over the valid rows and columns and the dustbins:
# eighteen attentional layers carry each layer's 1e-6 output gap through
# the residuals and the MLPs into scores of magnitude ~10, and the
# Sinkhorn adds its own.  On an H100 the case below read 2.0e-04 (the
# benchmark's reference, computed in another order, reads 1.1e-4 to
# 4.0e-4 against the port); 1e-3 leaves 5x, and a TF32 product reads
# 0.15 or more.
Z_TOL = 1e-3


def _seed_lines(q, k, v, src_valid, h):
    """The attention lines of ``Propagation.forward`` before the kernel,
    as they were (x and src projected already)."""
    b, n, d = q.shape
    hd = d // h
    q = q.reshape(b, n, hd, h)
    k = k.reshape(b, k.shape[1], hd, h)
    v = v.reshape(b, v.shape[1], hd, h)
    logits = torch.einsum("bqdh,bkdh->bhqk", q, k) / (hd ** 0.5)
    logits = torch.where(src_valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG))
    prob = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkdh->bqdh", prob, v).reshape(b, n, d)


def _case(b, n, m, d, mask, seed=0, std=2.0, device="cpu"):
    """(q, k, v, valid): normal q and k of std ``std`` (scaled logits of
    std ``std**2``), unit normal v; ``mask`` pads the last quarter of the
    keys (the second pair the last half), all of them, none, or
    ("mixed") all of the second pair's and none of the first's."""
    g = torch.Generator().manual_seed(seed)
    q = std * torch.randn(b, n, d, generator=g)
    k = std * torch.randn(b, m, d, generator=g)
    v = torch.randn(b, m, d, generator=g)
    valid = torch.ones(b, m, dtype=torch.bool)
    if mask == "padded":
        valid[:, 3 * m // 4:] = False
        valid[1:, m // 2:] = False
    elif mask == "all_padded":
        valid[:] = False
    elif mask == "mixed":
        valid[1:] = False
    return tuple(t.to(device) for t in (q, k, v, valid))


MASKS = ["all_valid", "padded", "all_padded"]
WIDTHS = {"tiny": 32, "full": 256}  # SuperGlueConfig.tiny()'s and HLoc's


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_plain_version_is_the_seed_lines_bit_for_bit(width, mask):
    q, k, v, valid = _case(2, 37, 53, WIDTHS[width], mask)
    want = _seed_lines(q, k, v, valid, 4)
    got = sa.masked_attention(q, k, v, valid, 4)
    assert got.shape == q.shape and torch.isfinite(got).all()
    assert torch.equal(got, want)
    assert torch.equal(sa.masked_attention_ref(q, k, v, valid, 4), want)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_all_padded_keys_average_every_value(width):
    """A query with no valid key weighs all M keys alike, as a softmax
    over equal NEG logits does."""
    q, k, v, valid = _case(1, 9, 40, WIDTHS[width], "all_padded")
    got = sa.masked_attention(q, k, v, valid, 4)
    want = v.mean(dim=1, keepdim=True).expand_as(got)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_propagation_keeps_its_seed_bits(width):
    """``Propagation.forward`` through the op equals the forward the model
    ran before it, bit for bit, on the CPU."""
    cfg = dataclasses.replace(SuperGlueConfig.tiny(),
                              desc_dim=WIDTHS[width])
    torch.manual_seed(3)
    prop = sg_model.Propagation(cfg)
    x, src, _, valid = _case(1, 21, 30, WIDTHS[width], "padded", seed=4,
                             std=1.0)
    msg = _seed_lines(prop.q(x), prop.k(src), prop.v(src), valid, 4)
    want = prop.mlp1(torch.relu(prop.mlp0(torch.cat([x, prop.merge(msg)],
                                                    -1))))
    assert torch.equal(prop(x, src, valid), want)


def _feats(k, d, n_valid, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    valid = torch.arange(k)[None] < n_valid
    return {"keypoints": 60 * torch.rand(1, k, 2, generator=g),
            "scores": torch.rand(1, k, generator=g),
            "descriptors": torch.nn.functional.normalize(
                torch.randn(1, k, d, generator=g), dim=-1),
            "valid": valid}


@pytest.mark.parametrize("sizes", [(40, 40), (40, 33), (29, 40)],
                         ids=["one_shape", "set1_shorter", "set0_shorter"])
def test_every_layer_runs_both_images_as_one_batch(sizes, monkeypatch):
    """One attention call a propagation pair's half, B = 2, whatever the
    two sets' sizes: the shorter set is padded to the longer."""
    sg = SuperGlueMatcher(SuperGlueConfig.tiny(), seed=3, device="cpu")
    calls = []
    real = sa.masked_attention

    def counted(q, *args):
        calls.append(tuple(q.shape[:2]))
        return real(q, *args)

    monkeypatch.setattr(sg_model, "masked_attention", counted)
    k0, k1 = sizes
    z = sg.assignment(_feats(k0, 32, k0 - 3, 4), _feats(k1, 32, k1, 5),
                      (64, 88))
    assert z.shape == (1, k0 + 1, k1 + 1) and torch.isfinite(z).all()
    assert calls == [(2, max(sizes))] * 2 * sg.cfg.gnn_layers


def test_cpu_never_counts_a_launch():
    before = sa.masked_attention.launches
    sa.masked_attention(*_case(1, 5, 7, 32, "all_valid"), 4)
    assert sa.masked_attention.launches == before


REFUSED = {
    "q_2d": dict(q=(5, 32)),
    "kv_width": dict(k=(1, 7, 16), v=(1, 7, 16)),
    "v_keys": dict(v=(1, 6, 32)),
    "mask_shape": dict(valid=(1, 6)),
    "heads_split": dict(heads=5),
}
# the kernel's own range: checked for any tensor off the CPU ("meta"
# here), after the checks every device gets and before the device's
KERNEL_REFUSED = {
    "two_heads": dict(d=64, heads=2, match="4 heads"),
    "head_dim_4": dict(d=16, heads=4, match="heads of 4"),
    "head_dim_12": dict(d=48, heads=4, match="heads of 12"),
    "head_dim_72": dict(d=288, heads=4, match="heads of 72"),
    "f64": dict(d=256, heads=4, dtype=torch.float64, match="f32"),
    "f16": dict(d=256, heads=4, dtype=torch.float16, match="f32"),
    "in_range": dict(d=256, heads=4, match="unsupported device meta"),
}


@pytest.mark.parametrize("bad", sorted(REFUSED))
def test_wrapper_refuses_what_no_version_takes(bad):
    spec = dict(q=(1, 5, 32), k=(1, 7, 32), v=(1, 7, 32), valid=(1, 7),
                heads=4)
    spec.update(REFUSED[bad])
    args = [torch.zeros(spec[n]) for n in "qkv"]
    args.append(torch.ones(spec["valid"], dtype=torch.bool))
    with pytest.raises(ValueError, match="masked_attention"):
        sa.masked_attention(*args, spec["heads"])


@pytest.mark.parametrize("on_meta", ["q", "k", "v", "valid"])
def test_wrapper_refuses_inputs_on_two_devices(on_meta):
    """A key, value or mask off q's device never reaches the kernel as a
    pointer of another device: every mix is refused, either way round."""
    args = dict(zip(("q", "k", "v", "valid"),
                    _case(1, 64, 96, 256, "padded")))
    args[on_meta] = args[on_meta].to("meta")
    before = sa.masked_attention.launches
    with pytest.raises(ValueError, match="need one device"):
        sa.masked_attention(*args.values(), 4)
    assert sa.masked_attention.launches == before


def test_wrapper_refuses_a_float_mask():
    q, k, v, valid = _case(1, 5, 7, 32, "all_valid")
    with pytest.raises(ValueError, match="bool key mask"):
        sa.masked_attention(q, k, v, valid.float(), 4)


@pytest.mark.parametrize("bad", sorted(KERNEL_REFUSED))
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    spec = KERNEL_REFUSED[bad]
    dt = spec.get("dtype", torch.float32)
    q = torch.empty(1, 64, spec["d"], dtype=dt, device="meta")
    k = torch.empty(1, 96, spec["d"], dtype=dt, device="meta")
    valid = torch.empty(1, 96, dtype=torch.bool, device="meta")
    before = sa.masked_attention.launches
    with pytest.raises(ValueError, match=spec["match"]):
        sa.masked_attention(q, k, k, valid, spec["heads"])
    assert sa.masked_attention.launches == before


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _gap(got, want):
    """max |got - want| over the outputs' scale, max(1, max |want|)."""
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


IMAGE_CASES = [(1, m) for m in MASKS] + [(2, m) for m in MASKS + ["mixed"]]


@pytest.mark.cuda
@pytest.mark.parametrize("b, mask", IMAGE_CASES,
                         ids=[f"b{b}-{m}" for b, m in IMAGE_CASES])
def test_kernel_matches_plain_at_the_image_query_shape(card, b, mask):
    """B = 1, and B = 2 as the model launches both images of a layer:
    there "padded" and "mixed" give the two pairs masks of their own."""
    q, k, v, valid = _case(b, 4096, 4096, 256, mask, seed=23, device=card)
    before = sa.masked_attention.launches
    got = sa.masked_attention(q, k, v, valid, 4)
    assert sa.masked_attention.launches == before + 1
    want = sa.masked_attention_ref(q, k, v, valid, 4)
    assert torch.isfinite(got).all()
    assert _gap(got, want) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("hd", sa.KERNEL_HEAD_DIMS)
def test_kernel_matches_plain_at_every_head_width(card, hd):
    """B = 2 with ragged query and key counts (a partial last query block
    and key tile), each mask, each head width the kernel takes."""
    for mask, (n, m) in (("padded", (70, 45)), ("all_valid", (130, 33)),
                         ("all_padded", (9, 100)), ("padded", (1, 1))):
        q, k, v, valid = _case(2, n, m, 4 * hd, mask, seed=hd, device=card)
        got = sa.masked_attention(q, k, v, valid, 4)
        want = sa.masked_attention_ref(q, k, v, valid, 4)
        assert _gap(got, want) <= TOL, (mask, n, m)


def _launch_unscaled(q, k, v, valid):
    """The kernel called as the wrapper calls it, but with scale 1."""
    from avlmaps_torch.kernels import build

    b, n, d = q.shape
    out = torch.empty_like(q)
    build.check(build.load("superglue_attention").avl_superglue_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        out.data_ptr(), b, n, k.shape[1], d // 4, 1.0,
        torch.cuda.current_stream(q.device).cuda_stream), "unscaled")
    return out


# the kernel given inputs that plant a fault of the kind TOL must catch:
# the logits left unscaled, each head's queries read from the next head's
# channels, the first key tile of each pair left out, the mask ignored,
# the two pairs' masks swapped, the first pair's keys and values read for
# both
FAULTS = {
    "unscaled": lambda q, k, v, valid: _launch_unscaled(q, k, v, valid),
    "wrong_head": lambda q, k, v, valid: sa.masked_attention(
        q.roll(1, -1).contiguous(), k, v, valid, 4),
    "key_tile_left_out": lambda q, k, v, valid: sa.masked_attention(
        q, k, v, valid & (torch.arange(valid.shape[1], device=q.device)
                          >= 64), 4),
    "mask_ignored": lambda q, k, v, valid: sa.masked_attention(
        q, k, v, torch.ones_like(valid), 4),
    "masks_swapped": lambda q, k, v, valid: sa.masked_attention(
        q, k, v, valid.flip(0).contiguous(), 4),
    "first_pair_keys": lambda q, k, v, valid: sa.masked_attention(
        q, k[:1].expand_as(k).contiguous(), v[:1].expand_as(v).contiguous(),
        valid, 4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_read_far_above_the_tolerance(card, fault):
    """At the (2, 4096, 4096) launch, each planted fault moves the output
    by more than 1e-2 of its scale, 1000 TOL."""
    q, k, v, valid = _case(2, 4096, 4096, 256, "padded", seed=23,
                           device=card)
    want = sa.masked_attention_ref(q, k, v, valid, 4)
    assert _gap(FAULTS[fault](q, k, v, valid), want) > 1e-2


def _matcher_case(card, k0, k1):
    sg = SuperGlueMatcher(dataclasses.replace(SuperGlueConfig(),
                                              sinkhorn_iters=100),
                          seed=5, device=card)
    f0 = _feats(k0, 256, k0 - k0 // 8, 6)
    f1 = _feats(k1, 256, k1, 7)
    return sg, f0, f1


@pytest.mark.cuda
def test_matcher_matches_the_plain_path_at_4096_keypoints(card,
                                                          monkeypatch):
    sg, f0, f1 = _matcher_case(card, 4096, 4096)
    before = sa.masked_attention.launches
    z = sg.assignment(f0, f1, (720, 1080))
    # 9 self/cross pairs, both images of each propagation in one launch
    assert sa.masked_attention.launches == before + 18
    monkeypatch.setattr(sg_model, "masked_attention",
                        sa.masked_attention_ref)
    zp = sg.assignment(f0, f1, (720, 1080))
    v0, v1 = (f["valid"].to(card) for f in (f0, f1))
    rows = torch.cat([v0, torch.ones_like(v0[:, :1])], 1)
    cols = torch.cat([v1, torch.ones_like(v1[:, :1])], 1)
    keep = rows[:, :, None] & cols[:, None, :]
    assert torch.isfinite(z).all()
    assert float((z - zp).abs()[keep].max()) <= Z_TOL
    got = match_from_assignment(z, v0, v1, 0.0)[0]
    want = match_from_assignment(zp, v0, v1, 0.0)[0]
    assert float((got == want).float().mean()) >= 0.99


@pytest.mark.cuda
def test_sets_of_two_sizes_launch_once_a_layer(card):
    sg, f0, f1 = _matcher_case(card, 512, 384)
    before = sa.masked_attention.launches
    z = sg.assignment(f0, f1, (720, 1080))
    assert sa.masked_attention.launches == before + 18
    assert z.shape == (1, 513, 385) and torch.isfinite(z).all()


@pytest.mark.cuda
def test_cuda_input_never_runs_the_plain_attention(card, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain attention on the CUDA path")

    monkeypatch.setattr(sa, "masked_attention_ref", refuse)
    monkeypatch.setattr(torch, "softmax", refuse)
    sg = SuperGlueMatcher(SuperGlueConfig.tiny(), seed=1, device=card)
    before = sa.masked_attention.launches
    z = sg.assignment(_feats(40, 32, 35, 2), _feats(40, 32, 40, 3),
                      (64, 64))
    assert sa.masked_attention.launches == before + 4
    assert z.shape == (1, 41, 41) and torch.isfinite(z).all()
