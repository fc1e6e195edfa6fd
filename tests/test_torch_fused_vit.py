"""The port's ViT-block kernels (avlmaps_torch/ops/fused_vit.py) against the
JAX package's Pallas kernels, which run here in interpret mode.

On the CPU each wrapper takes its plain PyTorch version; the CUDA kernels
themselves are held against those plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).  Inputs come from a seeded
numpy generator and feed both packages in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlmaps_tpu.models.lseg.vit import ViTBlock as JaxViTBlock
from avlmaps_tpu.ops import fused_vit as jfv
from avlmaps_torch.models.lseg.port import params_from_flax
from avlmaps_torch.models.lseg.vit import ViTBlock
from avlmaps_torch.ops import fused_vit as tfv


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("m", [1100, 64])
def test_ln_matmul_ref_matches_jax(rng, m):
    # the tolerance of tests/test_fused_vit.py for the same kernel: f32
    # matmuls summed in different orders
    k, n, eps = 96, 256, 1e-6
    x = rng.normal(size=(m, k)).astype(np.float32)
    g = rng.normal(size=(k,)).astype(np.float32)
    c = rng.normal(size=(k,)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32)
    want = jfv.ln_matmul(jnp.asarray(x), jnp.asarray(g), jnp.asarray(c),
                         jnp.asarray(w), jnp.asarray(bias), eps=eps,
                         interpret=True)
    before = tfv.ln_matmul.launches
    got = tfv.ln_matmul(_t(x), _t(g), _t(c), _t(w.T.copy()), _t(bias),
                        eps=eps)
    assert tfv.ln_matmul.launches == before  # CPU: plain version, no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("t_real", [None, 30])
def test_mha_ref_matches_jax(rng, t_real):
    # keys at or beyond t_real are masked in both; f32 softmax, atol 1e-5
    # as tests/test_fused_vit.py holds the Pallas kernel to the einsum
    b, t, heads, hd = 2, 37, 4, 16
    w = heads * hd
    qkv = rng.normal(size=(b * t, 3 * w)).astype(np.float32)
    want = jfv.mha_oneshot_2d(jnp.asarray(qkv), b, t, heads,
                              scale=1.0 / np.sqrt(hd), t_real=t_real,
                              interpret=True)
    got = tfv.mha_oneshot_2d(_t(qkv), b, t, heads, scale=1.0 / np.sqrt(hd),
                             t_real=t_real)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("t_real", [None, 30])
def test_mha_oneshot_matches_jax(rng, t_real):
    # the (B, T, 3W) wrapper over the same kernel: the tolerance above
    b, t, heads, hd = 2, 37, 4, 16
    w = heads * hd
    qkv = rng.normal(size=(b, t, 3 * w)).astype(np.float32)
    want = jfv.mha_oneshot(jnp.asarray(qkv), heads, scale=1.0 / np.sqrt(hd),
                           t_real=t_real, interpret=True)
    before = tfv.mha_oneshot_2d.launches
    got = tfv.mha_oneshot(_t(qkv), heads, scale=1.0 / np.sqrt(hd),
                          t_real=t_real)
    assert tfv.mha_oneshot_2d.launches == before  # CPU: plain version
    assert got.shape == (b, t, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_mha_masked_keys_do_not_leak(rng):
    """With t_real < t, the first t_real rows equal attention over the
    first t_real tokens alone, whatever the pad rows hold."""
    b, t, t_real, heads, hd = 2, 24, 17, 2, 16
    w = heads * hd
    qkv = rng.normal(size=(b, t, 3 * w)).astype(np.float32)
    full = tfv.mha_oneshot_2d(_t(qkv.reshape(b * t, 3 * w)), b, t, heads,
                              scale=0.25, t_real=t_real).reshape(b, t, w)
    short = tfv.mha_oneshot_2d(
        _t(qkv[:, :t_real].reshape(b * t_real, 3 * w)), b, t_real, heads,
        scale=0.25).reshape(b, t_real, w)
    np.testing.assert_allclose(full[:, :t_real].numpy(), short.numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("m", [100, 16])
def test_ln_mlp_residual_ref_matches_jax(rng, m):
    # atol 5e-4 as tests/test_fused_vit.py: the Pallas kernel's polynomial
    # erf (|err| <= 3.4e-5) against the port's exact erf
    k, n1, eps = 64, 256, 1e-6
    x = rng.normal(size=(m, k)).astype(np.float32)
    g = rng.normal(size=(k,)).astype(np.float32)
    c = rng.normal(size=(k,)).astype(np.float32)
    w1 = (rng.normal(size=(k, n1)) * 0.1).astype(np.float32)
    b1 = rng.normal(size=(n1,)).astype(np.float32)
    w2 = (rng.normal(size=(n1, k)) * 0.1).astype(np.float32)
    b2 = rng.normal(size=(k,)).astype(np.float32)
    want = jfv.ln_mlp_residual(*map(jnp.asarray, (x, g, c, w1, b1, w2, b2)),
                               eps=eps, interpret=True)
    got = tfv.ln_mlp_residual(_t(x), _t(g), _t(c), _t(w1.T.copy()), _t(b1),
                              _t(w2.T.copy()), _t(b2), eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4,
                               rtol=1e-5)


def test_bf16_plain_versions_round_like_the_kernels(rng):
    """The plain versions round where the kernels do: a bf16 K1 result is
    the f32 result of the bf16-rounded normalised rows, rounded once."""
    m, k, n = 40, 256, 128
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    g = torch.ones(k)
    c = torch.zeros(k)
    w = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32) * 0.05)
    bias = torch.zeros(n)
    got = tfv.ln_matmul(x.bfloat16(), g, c, w.bfloat16(), bias, eps=1e-6)
    assert got.dtype == torch.bfloat16
    xb = x.bfloat16().float()
    xn = torch.nn.functional.layer_norm(xb, (k,), eps=1e-6).bfloat16()
    want = (xn.float() @ w.bfloat16().float().t()).bfloat16()
    # one bf16 ulp: the f32 LN statistics may round the other way
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=2e-2, rtol=2 ** -7)


@pytest.mark.parametrize("m", [300, 16])
def test_ln_pass_is_k1s_operand_and_matches_jax(rng, m):
    """The LN pass's plain version is, bit for bit, the bf16 operand that
    ln_matmul_ref multiplies (read back through an identity weight, which
    the f32 product passes exactly), and matches the JAX kernel's
    normalised rows (its ln_matmul with an identity weight, interpreted)
    at the ln_matmul tolerance."""
    k, eps = 256, 1e-6
    x = rng.normal(size=(m, k)).astype(np.float32)
    g = rng.normal(size=(k,)).astype(np.float32)
    c = rng.normal(size=(k,)).astype(np.float32)
    eye, zero = np.eye(k, dtype=np.float32), np.zeros(k, np.float32)
    bf = torch.bfloat16
    rows = tfv.ln_rows_ref(_t(x).to(bf), _t(g), _t(c), eps=eps, dtype=bf)
    operand = tfv.ln_matmul_ref(_t(x).to(bf), _t(g), _t(c), _t(eye).to(bf),
                                _t(zero), eps=eps)
    assert rows.dtype == bf and torch.equal(rows, operand)
    want = jfv.ln_matmul(jnp.asarray(x), jnp.asarray(g), jnp.asarray(c),
                         jnp.asarray(eye), jnp.asarray(zero), eps=eps,
                         interpret=True)
    got = tfv.ln_rows_ref(_t(x), _t(g), _t(c), eps=eps, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("scale", [1.0, 0.1])
def test_gelu_pass_is_k6s_operand_and_matches_jax(rng, scale):
    """The GELU pass's plain version is, bit for bit, the bf16 operand
    that gelu_matmul_ref multiplies, and matches the JAX kernel's GELU
    (its gelu_matmul with an identity weight, interpreted; polynomial erf
    within 3.4e-5) at the gelu_matmul tolerance."""
    m, k = 530, 128
    x = (rng.normal(size=(m, k)) * scale).astype(np.float32)
    eye, zero = np.eye(k, dtype=np.float32), np.zeros(k, np.float32)
    bf = torch.bfloat16
    rows = tfv.gelu_rows_ref(_t(x).to(bf), dtype=bf)
    operand = tfv.gelu_matmul_ref(_t(x).to(bf), _t(eye).to(bf), _t(zero))
    assert rows.dtype == bf and torch.equal(rows, operand)
    want = jfv.gelu_matmul(jnp.asarray(x), jnp.asarray(eye),
                           jnp.asarray(zero), interpret=True)
    got = tfv.gelu_rows_ref(_t(x), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-5)


def _jax_block(attn_impl, width, heads):
    return JaxViTBlock(width=width, heads=heads, mlp_ratio=4, ln_eps=1e-6,
                       dtype=jnp.float32, attn_impl=attn_impl)


@pytest.mark.parametrize("t", [19, 24])
def test_vit_block_matches_jax_fused_block(rng, t):
    """The port's block (three wrappers + the plain projection) against
    the JAX package's fused block with its Pallas kernels interpreted,
    same weights; tolerance of tests/test_fused_vit.py's block test."""
    width, heads = 64, 4
    x = rng.normal(size=(2, t, width)).astype(np.float32)
    variables = _jax_block("einsum", width, heads).init(
        jax.random.PRNGKey(0), jnp.asarray(x))
    # non-trivial LN scales and biases
    noise = np.random.default_rng(1)
    variables = jax.tree.map(
        lambda a: np.asarray(a) + noise.normal(size=a.shape).astype(
            np.float32) * 0.05, variables)
    jfv.FORCE_INTERPRET = True
    try:
        want = _jax_block("fused", width, heads).apply(variables,
                                                       jnp.asarray(x))
    finally:
        jfv.FORCE_INTERPRET = False
    blk = ViTBlock(width, heads, 4, 1e-6, torch.float32)
    blk.load_state_dict(params_from_flax(variables), strict=True)
    with torch.no_grad():
        got = blk(torch.from_numpy(x), t_real=t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=1e-4)


def test_wrappers_reject_other_devices():
    """A tensor on neither the CPU nor CUDA never reaches a plain version."""
    x = torch.empty((8, 256), device="meta")
    v = torch.empty((256,), device="meta")
    w = torch.empty((128, 256), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfv.ln_matmul(x, v, v, w, torch.empty(128, device="meta"), eps=1e-6)
    with pytest.raises(ValueError, match="unsupported device"):
        tfv.mha_oneshot_2d(torch.empty((8, 192), device="meta"), 1, 8, 1,
                           scale=0.125)


# ------------------------------------------------------------------- K6 ---

@pytest.mark.parametrize("k,scale", [(128, 1.0), (2048, 0.1)])
@pytest.mark.parametrize("gelu_chunks", [1, 2])
def test_gelu_matmul_ref_matches_jax(rng, monkeypatch, k, scale,
                                     gelu_chunks):
    """K6's plain version against the JAX kernel in interpret mode, at the
    shapes and tolerance of tests/test_fused_vit.py (m = 530 covers the
    masked last row block; the JAX kernel's polynomial erf is within
    3.4e-5 of the exact erf)."""
    monkeypatch.setattr(jfv, "GELU_CHUNKS", gelu_chunks)
    m, n = 530, 128
    x = (rng.normal(size=(m, k)) * scale).astype(np.float32)
    w = (rng.normal(size=(k, n)) * scale).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32)
    want = jfv.gelu_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                           interpret=True)
    before = tfv.gelu_matmul.launches
    got = tfv.gelu_matmul(_t(x), _t(w.T.copy()), _t(bias))
    assert tfv.gelu_matmul.launches == before  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-5)


def test_ln_mlp_residual_oversize_weights_match_jax_fallback(rng,
                                                             monkeypatch):
    """Weights over 24 MiB take ln_matmul -> gelu_matmul -> residual add
    in both packages (tests/test_fused_vit.py's oversize case)."""
    m, k, n1 = 16, 2048, 4096
    x = rng.normal(size=(m, k)).astype(np.float32)
    g, c = np.ones(k, np.float32), np.zeros(k, np.float32)
    w1 = (rng.normal(size=(k, n1)) * 0.02).astype(np.float32)
    w2 = (rng.normal(size=(n1, k)) * 0.02).astype(np.float32)
    b1, b2 = np.zeros(n1, np.float32), np.zeros(k, np.float32)
    want = jfv.ln_mlp_residual(*map(jnp.asarray, (x, g, c, w1, b1, w2, b2)),
                               eps=1e-6, interpret=True)
    calls = []
    orig = tfv.gelu_matmul
    monkeypatch.setattr(tfv, "gelu_matmul",
                        lambda *a: calls.append(1) or orig(*a))
    got = tfv.ln_mlp_residual(_t(x), _t(g), _t(c), _t(w1.T.copy()), _t(b1),
                              _t(w2.T.copy()), _t(b2), eps=1e-6)
    assert calls, "oversize weights should take the unfused route"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4,
                               rtol=1e-5)


# ----------------------------------------------------- K2 on (B, H, T, D) --

@pytest.mark.parametrize("t_real", [None, 30])
def test_mha_bhtd_ref_matches_jax_oneshot(rng, t_real):
    """(B, H, T, D) attention equals the qkv-matrix attention of the JAX
    kernel on the same heads (f32, atol 1e-5 as test_mha_ref_matches_jax)."""
    b, t, heads, hd = 2, 37, 4, 16
    w = heads * hd
    qkv = rng.normal(size=(b * t, 3 * w)).astype(np.float32)
    want = np.asarray(jfv.mha_oneshot_2d(jnp.asarray(qkv), b, t, heads,
                                         scale=0.25, t_real=t_real,
                                         interpret=True))
    q, k, v = _t(qkv).view(b, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    got = tfv.mha_bhtd(q, k, v, scale=0.25, t_real=t_real)
    assert got.shape == (b, heads, t, hd)
    np.testing.assert_allclose(
        got.permute(0, 2, 1, 3).reshape(b * t, w).numpy(), want, atol=1e-5)


def test_mha_bhtd_rejects_other_devices():
    z = torch.empty((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfv.mha_bhtd(z, z, z, scale=0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        tfv.gelu_matmul(torch.empty((8, 256), device="meta"),
                        torch.empty((128, 256), device="meta"),
                        torch.empty((128,), device="meta"))


# ------------------------------------------------------------ ViT routes --

def _block_pair(rng, attn_impl, t, dtype=np.float32):
    width, heads = 64, 4
    x = rng.normal(size=(2, t, width)).astype(np.float32)
    variables = _jax_block("einsum", width, heads).init(
        jax.random.PRNGKey(0), jnp.asarray(x))
    noise = np.random.default_rng(1)
    variables = jax.tree.map(
        lambda a: np.asarray(a) + noise.normal(size=a.shape).astype(
            np.float32) * 0.05, variables)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    blk = ViTBlock(width, heads, 4, 1e-6, tdt, attn_impl)
    blk.load_state_dict(params_from_flax(variables), strict=True)
    return x, variables, blk


@pytest.mark.parametrize("t", [19, 24])
def test_vit_block_unfused_mlp_matches_jax(rng, monkeypatch, t):
    """MLP_FUSE=False in both packages: the fused block's MLP runs K1 + K6
    (interpreted in JAX, plain versions here); f32, the block test's
    tolerance."""
    x, variables, blk = _block_pair(rng, "fused", t)
    monkeypatch.setattr(jfv, "MLP_FUSE", False)
    monkeypatch.setattr(tfv, "MLP_FUSE", False)
    monkeypatch.setattr(jfv, "FORCE_INTERPRET", True)
    want = _jax_block("fused", 64, 4).apply(variables, jnp.asarray(x))
    calls = []
    orig = tfv.gelu_matmul
    monkeypatch.setattr(
        "avlmaps_torch.models.lseg.vit.gelu_matmul",
        lambda *a: calls.append(1) or orig(*a))
    with torch.no_grad():
        got = blk(torch.from_numpy(x), t_real=t)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=1e-4)


def test_vit_block_unfused_mlp_rounds_like_jax_in_bf16(rng, monkeypatch):
    """A bf16 block with MLP_FUSE=False against the JAX package's bf16
    fused block with its kernels interpreted: the fc output and the
    residual add round to bf16 where the JAX route rounds them (K3 would
    feed the GELU its f32 fc output).  Two bf16 ulps; and with the same
    rounding points only f32 sums taken in another order may flip a bf16
    rounding, so few elements differ at all (about 1%, where K3's
    rounding moves about half of them)."""
    width, heads, t = 64, 4, 24
    x = rng.normal(size=(2, t, width)).astype(np.float32)
    variables = _jax_block("einsum", width, heads).init(
        jax.random.PRNGKey(0), jnp.asarray(x))
    monkeypatch.setattr(jfv, "MLP_FUSE", False)
    monkeypatch.setattr(tfv, "MLP_FUSE", False)
    monkeypatch.setattr(jfv, "FORCE_INTERPRET", True)
    jblk = JaxViTBlock(width=width, heads=heads, mlp_ratio=4, ln_eps=1e-6,
                       dtype=jnp.bfloat16, attn_impl="fused")
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jblk.apply(variables, xb).astype(jnp.float32))
    blk = ViTBlock(width, heads, 4, 1e-6, torch.bfloat16, "fused")
    blk.load_state_dict(params_from_flax(variables), strict=True)
    with torch.no_grad():
        got = blk(torch.from_numpy(x).bfloat16(), t_real=t).float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2 ** -6)
    assert (got != want).mean() < 0.05


@pytest.mark.parametrize("attn_impl", ["flash", "splash", "xla", "einsum"])
def test_vit_block_attention_routes_match_jax(rng, monkeypatch,
                                              attn_impl):
    """Each attn_impl against the JAX block with the same attn_impl on the
    CPU (its einsum or XLA path): "flash"/"splash" take mha_bhtd's plain
    version here, the rest the unfused torch ops."""
    x, variables, blk = _block_pair(rng, attn_impl, 19)
    want = _jax_block(attn_impl, 64, 4).apply(variables, jnp.asarray(x))
    calls = []
    orig = tfv.mha_bhtd
    monkeypatch.setattr("avlmaps_torch.models.lseg.vit.mha_bhtd",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    with torch.no_grad():
        got = blk(torch.from_numpy(x), t_real=19)
    assert len(calls) == (attn_impl in ("flash", "splash"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=1e-4)
