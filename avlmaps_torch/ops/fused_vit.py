"""The kernels of a ViT-L block: wrappers, plain versions, counters.

Counterpart of ``avlmaps_tpu/ops/fused_vit.py``.  Each wrapper takes the
plain PyTorch version for a tensor that lies on the CPU and, for a CUDA
tensor, launches the hand-written kernel of ``csrc/fused_vit.cu`` or
raises; it never falls back.  ``<wrapper>.launches`` counts kernel
launches, so a run can show that its main path went through the kernels.

Layouts: activations are the ``(B*T, width)`` row matrices of the JAX
package (qkv is ``(B*T, 3W)`` laid out ``[q | k | v]``); weights are in
the ``torch.nn.Linear`` layout ``(out_features, in_features)``.

- ``ln_matmul`` (K1): ``LayerNorm(x) @ w.T + bias``.  LN statistics in
  f32, normalised rows rounded to the weight dtype (``ln_rows_ref``), f32
  accumulation.  On the card an LN pass writes the rows, then the wgmma
  GEMM reads them.
- ``mha_oneshot_2d`` (K2): 16-head softmax attention read straight from
  the qkv matrix; keys at or beyond ``t_real`` are masked.  ``mha_bhtd``
  runs the same kernel on (B, H, T, D) tensors, the layout of the JAX
  package's flash/splash attention (``models/lseg/vit.py``), with no pad.
  The kernel reads its operands through TMA tensor maps built from the
  (batch, head, token) strides, so rows must be 16-byte aligned and the
  strides multiples of 8 elements.
- ``ln_mlp_residual`` (K3): ``x + GELU(LN(x) @ w1.T + b1) @ w2.T + b2``
  with exact-erf GELU; the GELU output is rounded to the weight dtype
  before the second product, as on the TPU.  On the card: K1's LN pass,
  then two wgmma GEMMs.  Weights over 24 MiB take
  the JAX package's unfused route, ``ln_matmul`` -> ``gelu_matmul`` ->
  residual add.
- ``gelu_matmul`` (K6): ``GELU(x) @ w.T + bias``, the GELU of the input
  rounded to the weight dtype (``gelu_rows_ref``).  It uses exact erf
  (``erff`` on the card), where the TPU kernel uses a 10-term polynomial
  with |error| <= 3.4e-5, well inside bf16 resolution.  On the card a
  GELU pass writes the rounded input, then the wgmma GEMM reads it.

``MLP_FUSE`` (read at call time, as in the JAX package) routes the ViT
block's MLP through K3 when True and through K1 + K6 when False.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from avlmaps_torch.kernels import build
from avlmaps_torch.kernels.build import require

_LIB = "fused_vit"

# Route the ViT MLP sub-block through ln_mlp_residual (K3) instead of the
# ln_matmul / gelu_matmul pair; read at call time.
MLP_FUSE = True

# ln_mlp_residual's weight budget: above it the JAX package's kernel cannot
# keep both panels resident and takes the unfused route; kept so the same
# weights take the same route in both packages
_MLP_FUSE_MAX_BYTES = 24 * 2 ** 20


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        require(t.device == dev, "{}: tensors on {} and {}", name, t.device,
                dev)
        require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                "{}: tensor of shape {} is not contiguous and 16-byte "
                "aligned", name, tuple(t.shape))


def _vec_f32(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float32).contiguous()


def _layer_norm_f32(x2d: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x2d.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * scale.float() + bias.float()


# ------------------------------------------------------------------- K1 ---

def ln_rows_ref(x2d: torch.Tensor, ln_scale: torch.Tensor,
                ln_bias: torch.Tensor, *, eps: float,
                dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K1's LN pass: the normalised rows in f32, rounded
    once to ``dtype`` -- the A operand of K1's product."""
    return _layer_norm_f32(x2d, ln_scale, ln_bias, eps).to(dtype)


def ln_matmul_ref(x2d: torch.Tensor, ln_scale: torch.Tensor,
                  ln_bias: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  *, eps: float) -> torch.Tensor:
    """Plain version of :func:`ln_matmul`, rounding where the kernel does."""
    xn = ln_rows_ref(x2d, ln_scale, ln_bias, eps=eps, dtype=w.dtype).float()
    y = xn @ w.float().t() + bias.float()
    return y.to(x2d.dtype)


def ln_matmul(x2d: torch.Tensor, ln_scale: torch.Tensor,
              ln_bias: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
              eps: float) -> torch.Tensor:
    """``LayerNorm(x2d) @ w.T + bias``.

    x2d: (M, K); ln_scale/ln_bias: (K,); w: (N, K); bias: (N,).  On CUDA:
    bf16 x and w, K a multiple of 256 up to 1024, N a multiple of 128; the
    LN pass writes the (M, K) bf16 rows to a scratch buffer that the wgmma
    GEMM reads."""
    if x2d.device.type == "cpu":
        return ln_matmul_ref(x2d, ln_scale, ln_bias, w, bias, eps=eps)
    require(x2d.is_cuda, "ln_matmul: unsupported device {}", x2d.device)
    m, k = x2d.shape
    n = w.shape[0]
    require(x2d.dtype == torch.bfloat16 and w.dtype == torch.bfloat16,
            "ln_matmul: kernel takes bf16 x and w, got {}, {}", x2d.dtype,
            w.dtype)
    require(w.shape == (n, k) and ln_scale.shape == (k,)
            and ln_bias.shape == (k,) and bias.shape == (n,),
            "ln_matmul: shape mismatch")
    require(k % 256 == 0 and k <= 1024 and n % 128 == 0,
            "ln_matmul: kernel needs K % 256 == 0, K <= 1024 and "
            "N % 128 == 0, got K={}, N={}", k, n)
    g, c, bb = _vec_f32(ln_scale), _vec_f32(ln_bias), _vec_f32(bias)
    _check_cuda("ln_matmul", x2d, w, g, c, bb)
    xn = torch.empty_like(x2d)
    out = torch.empty((m, n), dtype=x2d.dtype, device=x2d.device)
    build.check(build.load(_LIB).avl_ln_matmul(
        x2d.data_ptr(), g.data_ptr(), c.data_ptr(), w.data_ptr(),
        bb.data_ptr(), xn.data_ptr(), out.data_ptr(), m, n, k, float(eps),
        _stream()), "ln_matmul")
    ln_matmul.launches += 1
    return out


ln_matmul.launches = 0


# ------------------------------------------------------------------- K2 ---

def mha_bhtd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 scale: float, t_real: Optional[int] = None) -> torch.Tensor:
    """Plain version of :func:`mha_bhtd` (f32 logits and softmax,
    probabilities rounded to the input dtype for the PV product)."""
    t = q.shape[2]
    if t_real is None:
        t_real = t
    logits = (q * scale).float() @ k.float().transpose(-1, -2)
    if t_real < t:
        logits[..., t_real:] = float("-inf")
    mx = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - mx)
    s = p.sum(-1, keepdim=True)
    pv = p.to(v.dtype).float() @ v.float()
    return (pv / s).to(q.dtype)


def _strides(t: torch.Tensor, b: int, h: int, tok: int) -> list:
    return [t.stride(b), t.stride(h), t.stride(tok)]


def _launch_mha(name: str, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, out: torch.Tensor, strides: list, b: int,
                t: int, n_heads: int, t_real: int, scale: float) -> None:
    """K2 on operands given by base tensor and (batch, head, token)
    element strides; the head dim (64) is contiguous."""
    for i, x in enumerate((q, k, v, out)):
        require(x.device == q.device and x.dtype == torch.bfloat16,
                "{}: kernel takes bf16 on one device", name)
        require(x.stride(-1) == 1 and x.data_ptr() % 16 == 0
                and all(st % 8 == 0 for st in strides[3 * i:3 * i + 3]),
                "{}: kernel needs 16-byte aligned rows of 64 contiguous "
                "elements", name)
    arr = (ctypes.c_longlong * 12)(*strides)
    build.check(build.load(_LIB).avl_mha(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), arr, b, t,
        n_heads, t_real, float(scale), _stream()), name)


def mha_oneshot_2d_ref(qkv2d: torch.Tensor, b: int, t: int, n_heads: int, *,
                       scale: float,
                       t_real: Optional[int] = None) -> torch.Tensor:
    """Plain version of :func:`mha_oneshot_2d`."""
    m, three_w = qkv2d.shape
    w = three_w // 3
    qkv = qkv2d.view(b, t, 3, n_heads, w // n_heads).permute(2, 0, 3, 1, 4)
    out = mha_bhtd_ref(qkv[0], qkv[1], qkv[2], scale=scale, t_real=t_real)
    return out.permute(0, 2, 1, 3).reshape(m, w)


def mha_oneshot(qkv: torch.Tensor, n_heads: int, *, scale: float,
                t_real: Optional[int] = None) -> torch.Tensor:
    """Multi-head self-attention on the fused (B, T, 3W) qkv tensor, laid
    out [q | k | v] along the last axis (the qkv dense layer's output);
    returns (B, T, W) with heads merged.  :func:`mha_oneshot_2d` (K2) on
    its (B*T, 3W) view."""
    b, t, three_w = qkv.shape
    return mha_oneshot_2d(qkv.reshape(b * t, three_w), b, t, n_heads,
                          scale=scale, t_real=t_real
                          ).reshape(b, t, three_w // 3)


def mha_oneshot_2d(qkv2d: torch.Tensor, b: int, t: int, n_heads: int, *,
                   scale: float, t_real: Optional[int] = None) -> torch.Tensor:
    """Multi-head self-attention on the (B*T, 3W) qkv matrix; returns
    (B*T, W) with heads merged.  On CUDA: bf16, head dim 64."""
    if t_real is None:
        t_real = t
    m, three_w = qkv2d.shape
    require(m == b * t and three_w % 3 == 0, "mha_oneshot_2d: shape")
    require(0 < t_real <= t, "mha_oneshot_2d: t_real={}, t={}", t_real, t)
    if qkv2d.device.type == "cpu":
        return mha_oneshot_2d_ref(qkv2d, b, t, n_heads, scale=scale,
                                  t_real=t_real)
    require(qkv2d.is_cuda, "mha_oneshot_2d: unsupported device {}",
            qkv2d.device)
    w = three_w // 3
    require(w == n_heads * 64, "mha_oneshot_2d: kernel needs head dim 64, "
            "got width {} over {} heads", w, n_heads)
    _check_cuda("mha_oneshot_2d", qkv2d)
    out = torch.empty((m, w), dtype=qkv2d.dtype, device=qkv2d.device)
    # q, k and v are column blocks of the qkv matrix: token stride 3W, head
    # stride 64, batch stride T * 3W
    q, k, v = (qkv2d[:, i * w:(i + 1) * w] for i in range(3))
    strides = [t * three_w, 64, three_w] * 3 + [t * w, 64, w]
    _launch_mha("mha_oneshot_2d", q, k, v, out, strides, b, t, n_heads,
                t_real, scale)
    mha_oneshot_2d.launches += 1
    return out


mha_oneshot_2d.launches = 0


def mha_bhtd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             scale: float, t_real: Optional[int] = None) -> torch.Tensor:
    """Softmax attention on (B, H, T, D) tensors, the layout of the JAX
    package's ``_flash_attention`` / ``_splash_attention``; returns
    (B, H, T, D).  Keys at or beyond ``t_real`` are masked, so no pad to a
    block multiple is needed.  On CUDA: bf16, D = 64, 16-byte aligned
    rows; any (batch, head, token) strides."""
    b, h, t, d = q.shape
    if t_real is None:
        t_real = t
    require(k.shape == q.shape and v.shape == q.shape,
            "mha_bhtd: q, k, v shapes differ")
    require(0 < t_real <= t, "mha_bhtd: t_real={}, t={}", t_real, t)
    if q.device.type == "cpu":
        return mha_bhtd_ref(q, k, v, scale=scale, t_real=t_real)
    require(q.is_cuda, "mha_bhtd: unsupported device {}", q.device)
    require(d == 64, "mha_bhtd: kernel needs head dim 64, got {}", d)
    out = torch.empty((b, h, t, d), dtype=q.dtype, device=q.device)
    strides = (_strides(q, 0, 1, 2) + _strides(k, 0, 1, 2)
               + _strides(v, 0, 1, 2) + _strides(out, 0, 1, 2))
    _launch_mha("mha_bhtd", q, k, v, out, strides, b, t, h, t_real, scale)
    mha_bhtd.launches += 1
    return out


mha_bhtd.launches = 0


# ------------------------------------------------------------------- K3 ---

def ln_mlp_residual_ref(x2d: torch.Tensor, ln_scale: torch.Tensor,
                        ln_bias: torch.Tensor, w1: torch.Tensor,
                        b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                        *, eps: float) -> torch.Tensor:
    """Plain version of :func:`ln_mlp_residual`."""
    xn = ln_rows_ref(x2d, ln_scale, ln_bias, eps=eps, dtype=w1.dtype).float()
    h = xn @ w1.float().t() + b1.float()
    gl = F.gelu(h).to(w2.dtype).float()  # exact erf
    y = gl @ w2.float().t() + b2.float()
    return (x2d.float() + y).to(x2d.dtype)


def ln_mlp_residual(x2d: torch.Tensor, ln_scale: torch.Tensor,
                    ln_bias: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor, *,
                    eps: float) -> torch.Tensor:
    """``x + GELU(LayerNorm(x) @ w1.T + b1) @ w2.T + b2``, the pre-LN MLP
    sub-block with its residual.

    x2d: (M, K); w1: (N1, K); w2: (K, N1).  On CUDA: bf16, K a multiple of
    256 up to 1024, N1 a multiple of 128; the LN pass writes the (M, K)
    bf16 rows and the fc GEMM the (M, N1) bf16 GELU output to scratch
    buffers that the next launch reads.
    Weights over 24 MiB take ``ln_matmul`` -> ``gelu_matmul`` -> residual
    add, each rounded to x's dtype, as the JAX package does."""
    wbytes = (w1.numel() + w2.numel()) * w1.element_size()
    if wbytes > _MLP_FUSE_MAX_BYTES:
        h = ln_matmul(x2d, ln_scale, ln_bias, w1, b1, eps=eps)
        return x2d + gelu_matmul(h, w2, b2)
    if x2d.device.type == "cpu":
        return ln_mlp_residual_ref(x2d, ln_scale, ln_bias, w1, b1, w2, b2,
                                   eps=eps)
    require(x2d.is_cuda, "ln_mlp_residual: unsupported device {}",
            x2d.device)
    m, k = x2d.shape
    n1 = w1.shape[0]
    require(all(t.dtype == torch.bfloat16 for t in (x2d, w1, w2)),
            "ln_mlp_residual: kernel takes bf16 x, w1, w2")
    require(w1.shape == (n1, k) and w2.shape == (k, n1)
            and b1.shape == (n1,) and b2.shape == (k,)
            and ln_scale.shape == (k,) and ln_bias.shape == (k,),
            "ln_mlp_residual: shape mismatch")
    require(k % 256 == 0 and k <= 1024 and n1 % 128 == 0,
            "ln_mlp_residual: kernel needs K % 256 == 0, K <= 1024 and "
            "N1 % 128 == 0, got K={}, N1={}", k, n1)
    g, c = _vec_f32(ln_scale), _vec_f32(ln_bias)
    bb1, bb2 = _vec_f32(b1), _vec_f32(b2)
    _check_cuda("ln_mlp_residual", x2d, w1, w2, g, c, bb1, bb2)
    xn = torch.empty_like(x2d)
    h = torch.empty((m, n1), dtype=x2d.dtype, device=x2d.device)
    out = torch.empty_like(x2d)
    build.check(build.load(_LIB).avl_ln_mlp_residual(
        x2d.data_ptr(), g.data_ptr(), c.data_ptr(), w1.data_ptr(),
        bb1.data_ptr(), w2.data_ptr(), bb2.data_ptr(), xn.data_ptr(),
        h.data_ptr(), out.data_ptr(), m, k, n1, float(eps), _stream()),
        "ln_mlp_residual")
    ln_mlp_residual.launches += 1
    return out


ln_mlp_residual.launches = 0


# ------------------------------------------------------------------- K6 ---

def gelu_rows_ref(x2d: torch.Tensor, *, dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K6's GELU pass: exact-erf GELU in f32, rounded once
    to ``dtype`` -- the A operand of K6's product."""
    return F.gelu(x2d.float()).to(dtype)


def gelu_matmul_ref(x2d: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gelu_matmul`: exact-erf GELU in f32, rounded
    to the weight dtype, f32 product plus bias, rounded to x's dtype."""
    g = gelu_rows_ref(x2d, dtype=w.dtype).float()
    y = g @ w.float().t() + bias.float()
    return y.to(x2d.dtype)


def gelu_matmul(x2d: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """``GELU(x2d) @ w.T + bias``.

    x2d: (M, K); w: (N, K); bias: (N,).  On CUDA: bf16 x and w, K a
    multiple of 64 (every caller passes K = 4 x a ViT width that is a
    multiple of 256), N a multiple of 128; the GELU pass writes the (M, K)
    bf16 operand to a scratch buffer that the wgmma GEMM reads."""
    if x2d.device.type == "cpu":
        return gelu_matmul_ref(x2d, w, bias)
    require(x2d.is_cuda, "gelu_matmul: unsupported device {}", x2d.device)
    m, k = x2d.shape
    n = w.shape[0]
    require(x2d.dtype == torch.bfloat16 and w.dtype == torch.bfloat16,
            "gelu_matmul: kernel takes bf16 x and w, got {}, {}",
            x2d.dtype, w.dtype)
    require(w.shape == (n, k) and bias.shape == (n,),
            "gelu_matmul: shape mismatch")
    require(k % 64 == 0 and n % 128 == 0,
            "gelu_matmul: kernel needs K % 64 == 0 and N % 128 == 0, got "
            "K={}, N={}", k, n)
    bb = _vec_f32(bias)
    _check_cuda("gelu_matmul", x2d, w, bb)
    gx = torch.empty_like(x2d)
    out = torch.empty((m, n), dtype=x2d.dtype, device=x2d.device)
    build.check(build.load(_LIB).avl_gelu_matmul(
        x2d.data_ptr(), w.data_ptr(), bb.data_ptr(), gx.data_ptr(),
        out.data_ptr(), m, n, k, _stream()), "gelu_matmul")
    gelu_matmul.launches += 1
    return out


gelu_matmul.launches = 0
