"""Open-vocabulary map scoring (K7, K8): wrappers, plain versions, counters.

Counterpart of ``avlmaps_tpu/ops/similarity.py``.  Scores are
``x . t^`` in full f32 for map features ``x`` (N, D) and text features
``t`` (C, D), where ``t^`` is ``t`` L2-normalised per row when
``normalize_text`` (``t * rsqrt(max(sum t^2, 1e-12))``):

- ``score_features`` (K8): the (N, C) f32 scores; with ``normalize_map``
  each row is multiplied by ``rsqrt(max(sum x^2, 1e-12))`` (the row norm
  is applied to the output, as on the TPU).
- ``score_argmax`` (K7): the (N,) int32 first index of each row's maximum
  score; the (N, C) matrix is never stored.  ``normalize_map`` is accepted
  and ignored: a positive row scale cannot change an argmax.  Ties go to
  the lowest index, as ``np.argmax``: all-zero rows give 0.

A tensor on the CPU takes the plain version (explicit f32 torch,
``torch.argmax``, which returns the first maximum); a CUDA tensor launches
the kernel of ``csrc/similarity.cu`` or raises.  The kernels take f32,
contiguous, 16-byte aligned operands with D a multiple of 4 and at most
1024.  ``<wrapper>.launches`` counts kernel launches (one per call unless
C needs more than one category chunk of shared memory).
"""

from __future__ import annotations

import ctypes

import torch

from avlmaps_torch.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "avl_score_features": [_P, _P, _P] + [_I] * 7 + [_P],
    "avl_score_argmax": [_P, _P, _P, _P] + [_I] * 6 + [_P],
}
# shared memory one block gives to its chunk of text rows: at D = 512 that
# is 48 categories, so the serving shape (C = 22) and the ~40-category
# init_categories lists read x once
_TEXT_SMEM_BYTES = 100 * 1024


def _lib() -> ctypes.CDLL:
    lib = build.load("similarity")
    if not getattr(lib, "_avl_bound", False):
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib._avl_bound = True
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _text_hat(text_feats: torch.Tensor, normalize_text: bool) -> torch.Tensor:
    t = text_feats.float()
    if normalize_text:
        t = t * torch.rsqrt(torch.clamp((t * t).sum(1, keepdim=True),
                                        min=1e-12))
    return t


def score_features_ref(map_feats: torch.Tensor, text_feats: torch.Tensor,
                       normalize_map: bool = False,
                       normalize_text: bool = False) -> torch.Tensor:
    """Plain version of K8: f32 product, row scale on the output."""
    x = map_feats.float()
    s = x @ _text_hat(text_feats, normalize_text).T
    if normalize_map:
        s = s * torch.rsqrt(torch.clamp((x * x).sum(1, keepdim=True),
                                        min=1e-12))
    return s


def score_argmax_ref(map_feats: torch.Tensor, text_feats: torch.Tensor,
                     normalize_map: bool = False,
                     normalize_text: bool = False) -> torch.Tensor:
    """Plain version of K7: f32 product, first index of the row maximum."""
    del normalize_map  # argmax-invariant
    s = map_feats.float() @ _text_hat(text_feats, normalize_text).T
    return torch.argmax(s, dim=1).to(torch.int32)


def _check_cuda(name: str, x: torch.Tensor, t: torch.Tensor) -> None:
    _require(x.is_cuda, f"{name}: unsupported device {x.device}")
    _require(x.dim() == 2 and t.dim() == 2 and x.shape[1] == t.shape[1],
             f"{name}: need (N, D) and (C, D), got {tuple(x.shape)} and "
             f"{tuple(t.shape)}")
    _require(x.dtype == torch.float32 and t.dtype == torch.float32,
             f"{name}: the kernel takes f32, got {x.dtype} and {t.dtype}")
    _require(t.device == x.device, f"{name}: operands on two devices")
    for a in (x, t):
        _require(a.is_contiguous() and a.data_ptr() % 16 == 0,
                 f"{name}: operands must be contiguous and 16-byte aligned")
    d = x.shape[1]
    _require(d % 4 == 0 and 0 < d <= 1024,
             f"{name}: the kernel needs D a multiple of 4 and <= 1024, got "
             f"{d}")
    _require(x.shape[0] < 2 ** 31 and t.shape[0] >= 1,
             f"{name}: need N < 2^31 and at least one category")


def _chunk(d: int) -> int:
    return max(1, _TEXT_SMEM_BYTES // (4 * d))


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def score_features(map_feats: torch.Tensor, text_feats: torch.Tensor,
                   normalize_map: bool = False,
                   normalize_text: bool = False) -> torch.Tensor:
    """(N, D) x (C, D) -> (N, C) f32 scores (K8)."""
    if map_feats.device.type == "cpu":
        return score_features_ref(map_feats, text_feats, normalize_map,
                                  normalize_text)
    _check_cuda("score_features", map_feats, text_feats)
    n, d = map_feats.shape
    c = text_feats.shape[0]
    out = torch.empty((n, c), dtype=torch.float32, device=map_feats.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream().cuda_stream
    step = _chunk(d)
    for c0 in range(0, c, step):
        rc = _lib().avl_score_features(
            map_feats.data_ptr(), text_feats.data_ptr(), out.data_ptr(), n,
            d, c, c0, min(step, c - c0), int(normalize_map),
            int(normalize_text), stream)
        _raise_on(rc, "score_features")
        score_features.launches += 1
    return out


def score_argmax(map_feats: torch.Tensor, text_feats: torch.Tensor,
                 normalize_map: bool = False,
                 normalize_text: bool = False) -> torch.Tensor:
    """(N, D) x (C, D) -> (N,) int32 first-index argmax of the scores
    (K7)."""
    if map_feats.device.type == "cpu":
        return score_argmax_ref(map_feats, text_feats, normalize_map,
                                normalize_text)
    _check_cuda("score_argmax", map_feats, text_feats)
    n, d = map_feats.shape
    c = text_feats.shape[0]
    labels = torch.empty((n,), dtype=torch.int32, device=map_feats.device)
    if n == 0:
        return labels
    stream = torch.cuda.current_stream().cuda_stream
    step = _chunk(d)
    best = None
    if c > step:  # the running best crosses category chunks
        best = torch.empty((n,), dtype=torch.float32,
                           device=map_feats.device)
    for c0 in range(0, c, step):
        rc = _lib().avl_score_argmax(
            map_feats.data_ptr(), text_feats.data_ptr(), labels.data_ptr(),
            None if best is None else best.data_ptr(), n, d, c0,
            min(step, c - c0), int(normalize_text), int(c0 == 0), stream)
        _raise_on(rc, "score_argmax")
        score_argmax.launches += 1
    return labels


score_features.launches = 0
score_argmax.launches = 0


def score_features_hbm(map_feats: torch.Tensor, text_feats: torch.Tensor,
                       **kw) -> torch.Tensor:
    """Alias of :func:`score_features` (the JAX package's name for it:
    the kernel streams (N, D) rows from device memory tile by tile, so any
    N works).  Launches count on ``score_features.launches``."""
    return score_features(map_feats, text_feats, **kw)


def topk_categories(scores: torch.Tensor) -> torch.Tensor:
    """Per-voxel argmax category (reference vlmap.py:123-125)."""
    return torch.argmax(scores, dim=-1)


def score_and_mask(map_feats: torch.Tensor, text_feats: torch.Tensor,
                   cat_id: int) -> torch.Tensor:
    """Score + argmax == cat mask (reference VLMap.index_map,
    vlmap.py:104-125)."""
    scores = score_features(map_feats, text_feats)
    return torch.argmax(scores, dim=-1) == cat_id
