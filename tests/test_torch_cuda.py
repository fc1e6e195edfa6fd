"""The port's CUDA kernels against their plain versions, on a card.

These tests need a CUDA card and skip without one.  They import neither
JAX nor the JAX package, so on a machine with a card and no JAX they run
without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Shapes are small but inside what each kernel takes (width 256, head dim
64, a partial last row block; for K7/K8 odd row counts, D from 24 to 768
and a C that needs two shared-memory chunks); chip_smoke.py repeats the
checks at the map-building and serving-query shapes.
"""

import math

import pytest
import torch

from avlmaps_torch.ops import fused_vit as fv
from avlmaps_torch.ops import segment_scatter as ss
from avlmaps_torch.ops import similarity as sim
from avlmaps_torch.ops import voxel_fusion as vf

pytestmark = pytest.mark.cuda

# bf16 outputs: two bf16 ulps of the plain value plus 1e-2 near zero
BF16 = dict(atol=1e-2, rtol=2.0 ** -6)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _randn(gen, *shape, std=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)


def _ln_inputs(gen, m, k):
    return (_randn(gen, m, k),
            1 + _randn(gen, k, std=0.1, dtype=torch.float32),
            _randn(gen, k, std=0.1, dtype=torch.float32))


@pytest.mark.parametrize("m", [200, 64])
def test_ln_matmul_kernel(gen, m):
    x, g, c = _ln_inputs(gen, m, 256)
    w = _randn(gen, 384, 256, std=1 / 16)
    bias = _randn(gen, 384, std=0.1, dtype=torch.float32)
    before = fv.ln_matmul.launches
    got = fv.ln_matmul(x, g, c, w, bias, eps=1e-6)
    torch.cuda.synchronize()
    assert fv.ln_matmul.launches == before + 1
    torch.testing.assert_close(got.float(), fv.ln_matmul_ref(
        x, g, c, w, bias, eps=1e-6).float(), **BF16)


@pytest.mark.parametrize("t_real", [77, 70])
def test_mha_kernel(gen, t_real):
    b, t, heads = 3, 77, 4
    qkv = _randn(gen, b * t, 3 * heads * 64)
    got = fv.mha_oneshot_2d(qkv, b, t, heads, scale=0.125, t_real=t_real)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), fv.mha_oneshot_2d_ref(
        qkv, b, t, heads, scale=0.125, t_real=t_real).float(), **BF16)


def test_ln_mlp_residual_kernel(gen):
    x, g, c = _ln_inputs(gen, 130, 256)
    w1 = _randn(gen, 1024, 256, std=1 / 16)
    w2 = _randn(gen, 256, 1024, std=1 / 32)
    b1 = _randn(gen, 1024, std=0.1, dtype=torch.float32)
    b2 = _randn(gen, 256, std=0.1, dtype=torch.float32)
    got = fv.ln_mlp_residual(x, g, c, w1, b1, w2, b2, eps=1e-6)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), fv.ln_mlp_residual_ref(
        x, g, c, w1, b1, w2, b2, eps=1e-6).float(), **BF16)


@pytest.mark.parametrize("feat_dtype", [torch.float32, torch.bfloat16])
def test_segment_scatter_kernel(gen, feat_dtype):
    b, cap, d = 3000, 5000, 512
    slots = torch.sort(torch.randint(0, 400, (b,), generator=gen,
                                     device="cuda"))[0].to(torch.int32)
    slots[-100:] = cap
    feats = _randn(gen, b, d, dtype=feat_dtype)
    w = torch.rand(b, generator=gen, device="cuda")
    aux = _randn(gen, b, 128, dtype=torch.float32)
    base = torch.randn(cap + 1, d + 128, generator=gen, device="cuda")
    got = ss.sorted_segment_scatter_add_split(base.clone(), slots, feats, w,
                                              aux)
    want = ss.sorted_segment_scatter_add_split_ref(base.clone(), slots,
                                                   feats, w, aux)
    torch.testing.assert_close(got[:cap], want[:cap], atol=1e-4, rtol=1e-5)


def test_fuse_points_on_the_card_matches_the_cpu(gen):
    """The whole fusion step, card (K4) vs CPU (plain version)."""
    gs, vh, d, cap, b = 32, 8, 64, 4000, 5000
    vids = torch.randint(0, gs * gs * vh, (b,), generator=gen,
                         device="cuda").to(torch.int32)
    feats = _randn(gen, b, d, dtype=torch.float32)
    rgbs = torch.rand(b, 3, generator=gen, device="cuda") * 255
    alphas = torch.rand(b, generator=gen, device="cuda")
    valid = torch.rand(b, generator=gen, device="cuda") > 0.2
    states = []
    for dev in ("cuda", "cpu"):
        s = vf.init_fusion_state(gs, vh, d, cap, device=dev)
        args = [t.to(dev) for t in (vids, feats, rgbs, alphas, valid)]
        states.append(vf.fuse_points(s, *args, gs=gs, vh=vh))
    card, cpu = states
    assert int(card.n_slots) == int(cpu.n_slots) > 0
    assert torch.equal(card.occupied_flat.cpu(), cpu.occupied_flat)
    torch.testing.assert_close(card.accum[:-1].cpu(), cpu.accum[:-1],
                               atol=1e-4, rtol=1e-5)


def test_vit_block_on_the_card(gen):
    """A bf16 ViT block through K1-K3 vs the same block on the CPU."""
    from avlmaps_torch.models.lseg.vit import ViTBlock

    blk = ViTBlock(256, 4, 4, 1e-6, torch.bfloat16).cuda()
    x = _randn(gen, 2, 50, 256)
    with torch.no_grad():
        got = blk(x, t_real=50).float().cpu()
        want = blk.cpu()(x.cpu(), t_real=50).float()
    assert math.isfinite(float(got.abs().max()))
    torch.testing.assert_close(got, want, atol=5e-2, rtol=2e-2)


# K7/K8 shapes: the serving width, the tiny CLIP width, a width that
# needs 6 float4 slices per lane, and C = 60 > 48, which takes two
# category chunks of shared memory at D = 512
SCORE_SHAPES = [(5000, 512, 22), (3001, 24, 7), (2000, 768, 13),
                (1500, 512, 60)]


@pytest.mark.parametrize("norm", [(False, False), (True, True),
                                  (True, False), (False, True)])
@pytest.mark.parametrize("n,d,c", SCORE_SHAPES)
def test_score_features_kernel(gen, n, d, c, norm):
    x = torch.randn(n, d, generator=gen, device="cuda") * 2
    t = torch.randn(c, d, generator=gen, device="cuda")
    before = sim.score_features.launches
    got = sim.score_features(x, t, *norm)
    torch.cuda.synchronize()
    assert sim.score_features.launches > before
    # f32 sums of D products in another order: a few f32 ulps of |x||t|
    torch.testing.assert_close(got, sim.score_features_ref(x, t, *norm),
                               atol=1e-5 * d ** 0.5, rtol=1e-5)


@pytest.mark.parametrize("normalize_text", [False, True])
@pytest.mark.parametrize("n,d,c", SCORE_SHAPES)
def test_score_argmax_kernel(gen, n, d, c, normalize_text):
    x = torch.randn(n, d, generator=gen, device="cuda")
    t = torch.randn(c, d, generator=gen, device="cuda")
    got = sim.score_argmax(x, t, normalize_map=True,
                           normalize_text=normalize_text)
    want = sim.score_argmax_ref(x, t, normalize_text=normalize_text)
    s = sim.score_features_ref(x, t, normalize_text=normalize_text)
    top2 = s.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-5 * top2[:, 0].abs()
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert torch.equal(got[clear], want[clear])


def test_score_argmax_kernel_ties_go_low(gen):
    """Zero rows tie every category and identical categories tie each
    other (in one shared-memory chunk and across two): every affected row
    takes the lower index."""
    n, d = 4096 + 512, 512
    x = torch.randn(n, d, generator=gen, device="cuda")
    x[:4096] = 0
    t = torch.randn(60, d, generator=gen, device="cuda")
    t[9] = t[4]
    t[50] = t[4]
    for c in (22, 60):
        got = sim.score_argmax(x, t[:c].contiguous(), normalize_text=True)
        torch.cuda.synchronize()
        assert bool((got[:4096] == 0).all())
        assert not bool(((got == 9) | (got == 50)).any())
        assert bool((got[4096:] == 4).any())
