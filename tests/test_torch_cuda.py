"""The port's CUDA kernels against their plain versions, on a card.

These tests need a CUDA card and skip without one.  They import neither
JAX nor the JAX package, so on a machine with a card and no JAX they run
without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Shapes are small but inside what each kernel takes (width 256, head dim
64, a partial last row block; for K7/K8 odd row counts, D from 24 to 768
and a C that needs two shared-memory chunks); chip_smoke.py repeats the
checks at the map-building and serving-query shapes.  K5 is held equal to
K4 bit for bit on the same batch, both are held bit for bit to an in-order
f32 sum per run on the CPU, and a K4 batch the split kernel cannot take
(W = 1152) goes through K5 instead of raising.
"""

import math

import numpy as np
import pytest
import torch

from avlmaps_torch.kernels import build
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


# (M, K, N): width 256 with 128 x 192 tiles (N = 384, 768), 128 x 128
# tiles (N = 640) and 128 x 256 tiles (N = 1024); ViT-L's qkv (N = 3072,
# 128 x 192 tiles) and unfused fc (N = 4096, 128 x 256 tiles) at the map
# builds' row counts, whose last 128-row tile is partial (7208 % 128 = 40,
# 11,984 % 128 = 80: the staged epilogue's second 64-row store is clipped
# or skipped)
@pytest.mark.parametrize("m,k,n", [(200, 256, 384), (64, 256, 384),
                                   (130, 256, 768), (200, 256, 640),
                                   (130, 256, 1024), (7208, 1024, 3072),
                                   (11984, 1024, 3072), (7208, 1024, 4096),
                                   (11984, 1024, 4096), (7208, 1024, 384)])
def test_ln_matmul_kernel(gen, m, k, n):
    x, g, c = _ln_inputs(gen, m, k)
    w = _randn(gen, n, k, std=k ** -0.5)
    bias = _randn(gen, n, std=0.1, dtype=torch.float32)
    before = fv.ln_matmul.launches
    got = fv.ln_matmul(x, g, c, w, bias, eps=1e-6)
    torch.cuda.synchronize()
    assert fv.ln_matmul.launches == before + 1
    torch.testing.assert_close(got.float(), fv.ln_matmul_ref(
        x, g, c, w, bias, eps=1e-6).float(), **BF16)


@pytest.mark.parametrize("t,t_real", [(77, 77), (77, 70), (70, 66),
                                      (727, 700)])
def test_mha_kernel(gen, t, t_real):
    """K2 on the qkv matrix: 3 crops, so query and key tiles straddle
    crops; T = 727 is the throughput build's token count."""
    b, heads = 3, 4
    qkv = _randn(gen, b * t, 3 * heads * 64)
    before = fv.mha_oneshot_2d.launches
    got = fv.mha_oneshot_2d(qkv, b, t, heads, scale=0.125, t_real=t_real)
    torch.cuda.synchronize()
    assert fv.mha_oneshot_2d.launches == before + 1
    torch.testing.assert_close(got.float(), fv.mha_oneshot_2d_ref(
        qkv, b, t, heads, scale=0.125, t_real=t_real).float(), atol=4e-3,
        rtol=BF16["rtol"])


@pytest.mark.parametrize("t", [70, 77, 727])
def test_mha_kernel_stops_at_t(gen, t):
    """The last query tile of a crop runs past T; its rows must not reach
    the next crop's output.  Crops 0 and 1 of 3 are launched into an
    output whose crop-2 rows (and a tail) hold a sentinel."""
    b, heads, w = 3, 4, 256
    qkv = _randn(gen, b * t, 3 * w)
    big = torch.full((b * t + 128, w), 7.0, dtype=torch.bfloat16,
                     device="cuda")
    out = big[:(b - 1) * t]
    q, k, v = (qkv[:(b - 1) * t, i * w:(i + 1) * w] for i in range(3))
    strides = [t * 3 * w, 64, 3 * w] * 3 + [t * w, 64, w]
    fv._launch_mha("mha_oneshot_2d", q, k, v, out, strides, b - 1, t, heads,
                   t - 3, 0.125)
    torch.cuda.synchronize()
    assert bool((big[(b - 1) * t:] == 7.0).all())
    want = fv.mha_oneshot_2d_ref(qkv[:(b - 1) * t], b - 1, t, heads,
                                 scale=0.125, t_real=t - 3)
    torch.testing.assert_close(out.float(), want.float(), atol=4e-3,
                               rtol=BF16["rtol"])


@pytest.mark.parametrize("m", [64, 130, 1000])
@pytest.mark.parametrize("k,n1", [(256, 1024), (1024, 4096), (256, 384)])
def test_ln_mlp_residual_kernel(gen, m, k, n1):
    """K3 at widths 256 and 1024 with N1 = 4 x width (128 x 256 tiles) and
    N1 = 384 (the fc on 128 x 192 tiles, the proj on 128 x 256); M = 1000
    leaves a partial row tile."""
    x, g, c = _ln_inputs(gen, m, k)
    w1 = _randn(gen, n1, k, std=k ** -0.5)
    w2 = _randn(gen, k, n1, std=n1 ** -0.5)
    b1 = _randn(gen, n1, std=0.1, dtype=torch.float32)
    b2 = _randn(gen, k, std=0.1, dtype=torch.float32)
    before = fv.ln_mlp_residual.launches
    got = fv.ln_mlp_residual(x, g, c, w1, b1, w2, b2, eps=1e-6)
    torch.cuda.synchronize()
    assert fv.ln_mlp_residual.launches == before + 1
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


def _sorted_batch(gen, b, cap, d, aux_w, n_slots=400):
    slots = torch.sort(torch.randint(0, n_slots, (b,), generator=gen,
                                     device="cuda"))[0].to(torch.int32)
    slots[-100:] = cap
    feats = _randn(gen, b, d, dtype=torch.float32)
    w = torch.rand(b, generator=gen, device="cuda")
    aux = _randn(gen, b, aux_w, dtype=torch.float32)
    return slots, feats, w, aux


@pytest.mark.parametrize("rows", ["trash", "aligned"])
def test_assembled_kernel_matches_plain_and_split_bitwise(gen, rows):
    """K5 against index_add_ of the same update, and against K4 on the
    split form of the same batch: equal bits on every row K4 writes."""
    b, cap, d = 3000, 5000, 512
    slots, feats, w, aux = _sorted_batch(gen, b, cap, d, 128)
    s = cap + 1 if rows == "trash" else cap + 8
    base = torch.randn(s, d + 128, generator=gen, device="cuda")
    update = torch.cat([w[:, None] * feats, aux], dim=1)
    before = ss.sorted_segment_scatter_add.launches
    got = ss.sorted_segment_scatter_add(base.clone(), slots, update)
    torch.cuda.synchronize()
    assert ss.sorted_segment_scatter_add.launches == before + 1
    want = ss.sorted_segment_scatter_add_ref(base.clone(), slots, update)
    torch.testing.assert_close(got[:cap], want[:cap], atol=1e-4, rtol=1e-5)
    split = ss.split_kernel(base.clone(), slots, feats, w, aux)
    assert torch.equal(got[:cap], split[:cap])
    if rows == "aligned":  # no trash row: the last real rows count too
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


class _AllocatingLib:
    """The kernel library with one launch function wrapped: just before it
    forwards, it allocates 16 ``torch.zeros`` of the batch's row count on
    the launch's stream, as the loader's producer thread may between the
    wrapper's checks and the launch.  A kernel that read anything but its
    arguments -- a scratch tensor the wrapper let go of -- could find its
    block zeroed ahead of the launch."""

    def __init__(self, lib, name: str, n_rows: int):
        self._lib, self._name, self._n = lib, name, n_rows
        self.held = []

    def __getattr__(self, attr):
        fn = getattr(self._lib, attr)
        if attr != self._name:
            return fn

        def launch(*args):
            for _ in range(16):
                self.held.append(torch.zeros(self._n, dtype=torch.uint8,
                                             device="cuda"))
            return fn(*args)

        return launch


@pytest.mark.parametrize("kernel", ["split", "assembled"])
def test_launch_reads_only_its_arguments(gen, monkeypatch, kernel):
    """K4 and K5 with allocations between the wrapper and the launch give
    the bits they give alone."""
    b, cap, d = 3000, 5000, 512
    slots, feats, w, aux = _sorted_batch(gen, b, cap, d, 128)
    base = torch.randn(cap + 1, d + 128, generator=gen, device="cuda")
    update = torch.cat([w[:, None] * feats, aux], 1)

    def run():
        if kernel == "split":
            return ss.split_kernel(base.clone(), slots, feats, w, aux)
        return ss.sorted_segment_scatter_add(base.clone(), slots, update)

    alone = run()
    name = ("avl_segment_scatter_add_split" if kernel == "split"
            else "avl_segment_scatter_add")
    load = build.load
    lib = _AllocatingLib(load("segment_scatter"), name, b)
    monkeypatch.setattr(build, "load", lambda n: lib if n == "segment_scatter"
                        else load(n))
    got = run()
    torch.cuda.synchronize()
    assert lib.held, "the launch did not go through the wrapped library"
    assert torch.equal(got, alone)
    want = ss.sorted_segment_scatter_add_split_ref(base.clone(), slots,
                                                   feats, w, aux)
    torch.testing.assert_close(got[:cap], want[:cap], atol=1e-4, rtol=1e-5)


def _sequential(base, slots, rows, skip):
    """The accumulator after each run's f32 rows are summed one by one in
    row order from 0 and the sum added to its slot once (CPU, numpy)."""
    out = base.cpu().numpy().copy()
    s = slots.cpu().numpy()
    rows = rows.cpu().numpy()
    k, b = 0, len(s)
    while k < b:
        e = k
        while e < b and s[e] == s[k]:
            e += 1
        if s[k] != skip:
            acc = np.zeros(rows.shape[1], np.float32)
            for r in range(k, e):
                acc += rows[r]
            out[s[k]] += acc
        k = e
    return torch.from_numpy(out)


# (rows, distinct slots or a pattern, feature type, W): a run past the
# kernel's 32-row column-split threshold, runs of ~40 rows crossing its
# 32-row tiles (a tile inside a run owns none), one slot for the whole
# batch, a batch all in the trash run, all-unique slots, bf16 features,
# and K5 alone at W = 2100 (a float4 row of 17 column groups) and W =
# 2099 (one column a lane)
RUN_CASES = {
    "long_run": (3000, "long", torch.float32, 640),
    "tile_crossing": (3000, 75, torch.float32, 640),
    "one_slot": (3000, 1, torch.float32, 640),
    "all_trash": (3000, "trash", torch.float32, 640),
    "unique": (3000, "unique", torch.float32, 640),
    "bf16": (3000, 400, torch.bfloat16, 640),
    "wide_k5": (2000, 300, torch.float32, 2100),
    "odd_width_k5": (2000, 300, torch.float32, 2099),
}


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_segment_scatter_sums_each_run_in_row_order(gen, case):
    """K4 and K5 give the bits of an in-order f32 sum per run: the split
    mode multiplies w * feat, then adds; the trash run is left out."""
    b, pattern, ftype, wd = RUN_CASES[case]
    cap, d = 5000, 512
    if pattern == "long":
        slots = torch.sort(torch.randint(0, 400, (b,), generator=gen,
                                         device="cuda"))[0]
        slots[1000:1500] = slots[1000]
    elif pattern == "trash":
        slots = torch.full((b,), cap, device="cuda")
    elif pattern == "unique":
        slots = torch.arange(b, device="cuda") * (cap // b)
    else:
        slots = torch.sort(torch.randint(0, pattern, (b,), generator=gen,
                                         device="cuda"))[0] * 7
    slots = slots.to(torch.int32)
    base = torch.randn(cap + 1, wd, generator=gen, device="cuda")
    if wd > 1024:  # K5 alone: the split kernel takes W <= 1024
        update = torch.randn(b, wd, generator=gen, device="cuda")
        want = _sequential(base, slots, update, cap)
        got = ss.sorted_segment_scatter_add(base.clone(), slots, update)
        assert torch.equal(got.cpu(), want)
        return
    feats = _randn(gen, b, d, dtype=ftype)
    w = torch.rand(b, generator=gen, device="cuda")
    aux = _randn(gen, b, wd - d, dtype=torch.float32)
    update = torch.cat([w[:, None] * feats.float(), aux], 1)
    want = _sequential(base, slots, update, cap)
    k4 = ss.split_kernel(base.clone(), slots, feats, w, aux)
    k5 = ss.sorted_segment_scatter_add(base.clone(), slots, update)
    assert torch.equal(k4.cpu(), want)
    assert torch.equal(k5.cpu(), want)


@pytest.mark.parametrize("wd", [640, 2100])
def test_assembled_kernel_widths(gen, wd):
    """Rows wider than one 1024-column chunk loop over chunks."""
    b, cap = 2000, 3000
    slots = torch.sort(torch.randint(0, 300, (b,), generator=gen,
                                     device="cuda"))[0].to(torch.int32)
    update = torch.randn(b, wd, generator=gen, device="cuda")
    base = torch.randn(cap + 1, wd, generator=gen, device="cuda")
    got = ss.sorted_segment_scatter_add(base.clone(), slots, update)
    want = ss.sorted_segment_scatter_add_ref(base.clone(), slots, update)
    torch.testing.assert_close(got[:cap], want[:cap], atol=1e-4, rtol=1e-5)


def test_split_falls_back_to_assembled_kernel(gen):
    """d = 1024, W = 1152: past the split kernel's width, the JAX route
    assembles the update for K5 -- plain rows, no error."""
    b, cap, d = 2000, 3000, 1024
    slots, feats, w, aux = _sorted_batch(gen, b, cap, d, 128)
    base = torch.randn(cap + 1, d + 128, generator=gen, device="cuda")
    k4, k5 = (ss.sorted_segment_scatter_add_split.launches,
              ss.sorted_segment_scatter_add.launches)
    got = ss.sorted_segment_scatter_add_split(base.clone(), slots, feats, w,
                                              aux)
    torch.cuda.synchronize()
    assert ss.sorted_segment_scatter_add_split.launches == k4
    assert ss.sorted_segment_scatter_add.launches == k5 + 1
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


# (M, K, N): width 256's proj (K = 1024, N = 256), 128 x 192 (N = 384)
# and 128 x 128 tiles (N = 640), and ViT-L's proj (K = 4096, N = 1024) at
# the map builds' row counts
@pytest.mark.parametrize("m,k,n", [(200, 1024, 256), (64, 1024, 256),
                                   (130, 1024, 384), (130, 1024, 640),
                                   (7208, 4096, 1024), (11984, 4096, 1024),
                                   (7208, 4096, 384)])
def test_gelu_matmul_kernel(gen, m, k, n):
    x = _randn(gen, m, k)
    w = _randn(gen, n, k, std=k ** -0.5)
    bias = _randn(gen, n, std=0.1, dtype=torch.float32)
    before = fv.gelu_matmul.launches
    got = fv.gelu_matmul(x, w, bias)
    torch.cuda.synchronize()
    assert fv.gelu_matmul.launches == before + 1
    torch.testing.assert_close(got.float(), fv.gelu_matmul_ref(
        x, w, bias).float(), **BF16)


@pytest.mark.parametrize("t,t_real", [(77, 77), (77, 70), (70, 66),
                                      (727, 700)])
def test_mha_bhtd_kernel(gen, t, t_real):
    """K2 on contiguous (B, H, T, 64) tensors and on strided views (the
    head split of a qkv matrix)."""
    b, heads = 3, 4
    q, k, v = (_randn(gen, b, heads, t, 64) for _ in range(3))
    before = fv.mha_bhtd.launches
    got = fv.mha_bhtd(q, k, v, scale=0.125, t_real=t_real)
    torch.cuda.synchronize()
    assert fv.mha_bhtd.launches == before + 1
    torch.testing.assert_close(got.float(), fv.mha_bhtd_ref(
        q, k, v, scale=0.125, t_real=t_real).float(), atol=4e-3,
        rtol=BF16["rtol"])
    qkv = _randn(gen, b, t, 3, heads, 64).permute(2, 0, 3, 1, 4)
    got = fv.mha_bhtd(qkv[0], qkv[1], qkv[2], scale=0.125, t_real=t_real)
    torch.testing.assert_close(got.float(), fv.mha_bhtd_ref(
        qkv[0], qkv[1], qkv[2], scale=0.125, t_real=t_real).float(),
        atol=4e-3, rtol=BF16["rtol"])


@pytest.mark.parametrize("attn_impl,mlp_fuse", [("fused", False),
                                                ("flash", True),
                                                ("splash", True)])
def test_vit_block_routes_on_the_card(gen, monkeypatch, attn_impl,
                                      mlp_fuse):
    """The unfused-MLP route (K1 + K6) and the flash/splash route (K2 on
    (B, H, T, D)) on the card vs the same block on the CPU."""
    from avlmaps_torch.models.lseg.vit import ViTBlock

    monkeypatch.setattr(fv, "MLP_FUSE", mlp_fuse)
    blk = ViTBlock(256, 4, 4, 1e-6, torch.bfloat16, attn_impl).cuda()
    x = _randn(gen, 2, 50, 256)
    counts = (fv.gelu_matmul.launches, fv.mha_bhtd.launches)
    with torch.no_grad():
        got = blk(x, t_real=50).float().cpu()
        want = blk.cpu()(x.cpu(), t_real=50).float()
    assert (fv.gelu_matmul.launches - counts[0],
            fv.mha_bhtd.launches - counts[1]) == (
        (1, 0) if attn_impl == "fused" else (0, 1))
    torch.testing.assert_close(got, want, atol=5e-2, rtol=2e-2)


def test_f32_vit_block_runs_on_the_card(gen):
    """An f32 block on CUDA takes the unfused plain ops in full f32 (TF32
    off), as the JAX package does off the TPU kernels."""
    from avlmaps_torch.models.lseg.vit import ViTBlock

    assert not torch.backends.cuda.matmul.allow_tf32
    blk = ViTBlock(256, 4, 4, 1e-6, torch.float32).cuda()
    x = torch.randn(2, 50, 256, generator=gen, device="cuda")
    with torch.no_grad():
        got = blk(x, t_real=50).cpu()
        want = blk.cpu()(x.cpu(), t_real=50)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_device_sampled_step_makes_no_host_sync(gen):
    """A warm device-sampled step (a 4-block bf16 LSeg of width 256 and
    head dim 64, so the block kernels take it; whole canvas) runs under
    set_sync_debug_mode('error'), and draws JAX's threefry bits on the
    card as on the CPU."""
    import numpy as np

    from avlmaps_torch.geometry.projection import get_sim_cam_mat
    from avlmaps_torch.map.vlmap_builder import (
        device_sample_indices, make_frame_step_device_sampled)
    from avlmaps_torch.models.lseg import (DenseViTConfig, LSegConfig,
                                           LSegNet,
                                           cast_params_for_inference,
                                           init_params)

    bf16 = torch.bfloat16
    cfg = LSegConfig(
        vit=DenseViTConfig(patch_size=16, width=256, layers=4, heads=4,
                           hooks=(0, 1, 2, 3), pretrain_grid=4, dtype=bf16),
        features=64, reassemble_ch=(64, 128, 256, 256), out_dim=96,
        dtype=bf16)
    net = LSegNet(cfg, device="cuda")
    net.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    cast_params_for_inference(net)
    h, w, b = 48, 64, 4
    step = make_frame_step_device_sampled(
        lambda x: net(x, upsample=False), gs=64, cs=0.1, vh=8,
        calib_mat=get_sim_cam_mat(h, w), image_hw=(h, w), base_size=64,
        crop_size=64, max_pts=500, seed=1, device="cuda")
    state = vf.init_fusion_state(64, 8, 96, 4096, device="cuda")
    canvas = torch.randint(0, 255, (b, 48, 64, 3), generator=gen,
                           device="cuda").to(torch.uint8)
    depth = torch.randint(300, 3000, (b, h, w), generator=gen,
                          device="cuda").to(torch.int32)
    pose = torch.eye(4, device="cuda").expand(b, 4, 4).contiguous()
    fids = torch.arange(b, dtype=torch.int32, device="cuda")
    valid = torch.ones(b, dtype=torch.bool, device="cuda")
    with torch.no_grad():
        step(state, canvas, depth, pose, fids, valid)  # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(state, canvas, depth, pose, fids + b, valid)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert int(state.n_slots) > 0
    on_card = device_sample_indices(fids, seed=1, max_pts=500,
                                    n_pixels=h * w).cpu()
    on_cpu = device_sample_indices(fids.cpu(), seed=1, max_pts=500,
                                   n_pixels=h * w)
    np.testing.assert_array_equal(on_card.numpy(), on_cpu.numpy())


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
