"""Sorted segment scatter-add (K4, K5): wrappers, plain versions, counters.

Counterpart of ``avlmaps_tpu/ops/segment_scatter.py``, the accumulate of
the voxel fusion.  For rows sorted by ascending slot,

    K4 sorted_segment_scatter_add_split:
        accum[slots[k]] += concat(w[k] * float(feats[k]), aux[k])
    K5 sorted_segment_scatter_add:
        accum[slots[k]] += updates[k]

updated IN PLACE (the JAX package donates the buffer to the same effect).
A tensor on the CPU takes the plain version, ``index_add_`` of the
assembled f32 update; a CUDA tensor launches the kernel of
``csrc/segment_scatter.cu`` (one template, two payload modes) or raises.
``b == 0`` is a no-op.  The shape routes are the JAX package's:

- K4 hands a batch it cannot take to K5 with the update assembled (more
  than ``_SPLIT_MAX_ROWS`` rows, d or W not a multiple of 32, W > 1024,
  or an accumulator K5 would not take either);
- K5 discards the trash row's updates when ``S % 8 == 1`` (the fusion's
  capacity + 1 rows), and for ``S % 8`` not in {0, 1} takes the XLA
  scatter's counterpart, ``index_add_``, which is no kernel of the TPU
  either.

Both kernels sum each run of equal slots in row order and add it once, so
the two give bitwise-equal rows for one batch.  A wrapper call enqueues one
kernel launch and nothing else: the kernel finds the runs itself and reads
only its arguments.  The contents of the trash row are unspecified: the
plain version adds its rows, the kernels skip them.
"""

from __future__ import annotations

import torch

from avlmaps_torch.kernels import build
from avlmaps_torch.kernels.build import require

_LIB = "segment_scatter"

# The JAX package's route rule (its SMEM prefetch budget), kept so that the
# same batch takes the same route in both packages.
_SPLIT_MAX_ROWS = 100_000


def _kernel_takes_rows(s: int) -> bool:
    """The TPU kernels' row rule: whole 8-row windows, plus at most the
    trash row."""
    return s % 8 in (0, 1) and s - s % 8 > 0


def _check_cuda(name: str, accum: torch.Tensor, slots: torch.Tensor,
                *rows: torch.Tensor) -> None:
    require(accum.is_cuda, "{}: unsupported device {}", name, accum.device)
    require(accum.dtype == torch.float32 and slots.dtype == torch.int32,
            "{}: accum f32 and slots int32", name)
    for t in (accum, slots, *rows):
        require(t.device == accum.device and t.is_contiguous(),
                "{}: inputs must be contiguous and on one device", name)


def _skip_slot(s: int) -> int:
    """The row the kernels leave out: the trash row of a capacity + 1
    accumulator, else none."""
    return s - 1 if s % 8 == 1 else -1


def _assemble(feats: torch.Tensor, w: torch.Tensor,
              aux: torch.Tensor) -> torch.Tensor:
    return torch.cat([w[:, None] * feats.float(), aux.float()], dim=1)


# ------------------------------------------------------------------- K4 ---

def sorted_segment_scatter_add_split_ref(accum: torch.Tensor,
                                         slots: torch.Tensor,
                                         feats: torch.Tensor,
                                         w: torch.Tensor,
                                         aux: torch.Tensor) -> torch.Tensor:
    """Plain version: ``index_add_`` of the assembled f32 update."""
    return accum.index_add_(0, slots.long(), _assemble(feats, w, aux))


def split_kernel(accum: torch.Tensor, slots: torch.Tensor,
                 feats: torch.Tensor, w: torch.Tensor,
                 aux: torch.Tensor) -> torch.Tensor:
    """Launch K4's kernel on a CUDA batch, whatever its row count (the
    wrapper's route rule sends more than ``_SPLIT_MAX_ROWS`` rows to K5);
    d and W multiples of 32, W <= 1024.  Counted on
    ``sorted_segment_scatter_add_split.launches``."""
    name = "sorted_segment_scatter_add_split"
    b = slots.shape[0]
    s, wd = accum.shape
    d = feats.shape[1]
    _check_cuda(name, accum, slots, feats, w, aux)
    require(w.dtype == torch.float32 and aux.dtype == torch.float32,
            "{}: w and aux f32", name)
    require(feats.dtype in (torch.float32, torch.bfloat16), "{}: feats {}",
            name, feats.dtype)
    require(feats.shape == (b, d) and w.shape == (b,)
            and aux.shape == (b, wd - d), "{}: shape mismatch", name)
    require(d % 32 == 0 and wd % 32 == 0 and wd <= 1024,
            "{}: the split kernel needs d, W multiples of 32 and W <= 1024, "
            "got d={}, W={}", name, d, wd)
    build.check(build.load(_LIB).avl_segment_scatter_add_split(
        accum.data_ptr(), slots.data_ptr(), feats.data_ptr(),
        int(feats.dtype == torch.bfloat16), w.data_ptr(), aux.data_ptr(), b,
        d, wd, _skip_slot(s), torch.cuda.current_stream().cuda_stream), name)
    sorted_segment_scatter_add_split.launches += 1
    return accum


def sorted_segment_scatter_add_split(accum: torch.Tensor, slots: torch.Tensor,
                                     feats: torch.Tensor, w: torch.Tensor,
                                     aux: torch.Tensor) -> torch.Tensor:
    """``accum[slots[k]] += concat(w[k]*feats[k], aux[k])`` in place for
    ascending ``slots``; returns ``accum``.

    accum: (S, W) f32; slots: (B,) int32 ascending; feats: (B, d) f32 or
    bf16; w: (B,) f32; aux: (B, W-d) f32.  On CUDA, K4's kernel takes
    B <= ``_SPLIT_MAX_ROWS``, d and W multiples of 32, W <= 1024 and
    ``S % 8`` in {0, 1}; any other batch goes to :func:`
    sorted_segment_scatter_add` with the update assembled, as in the JAX
    package."""
    b = slots.shape[0]
    if b == 0:
        return accum
    if accum.device.type == "cpu":
        return sorted_segment_scatter_add_split_ref(accum, slots, feats, w,
                                                    aux)
    s, wd = accum.shape
    d = feats.shape[1]
    if not (_kernel_takes_rows(s) and b <= _SPLIT_MAX_ROWS and d % 32 == 0
            and wd % 32 == 0 and wd <= 1024 and aux.shape[1] == wd - d):
        return sorted_segment_scatter_add(accum, slots,
                                          _assemble(feats, w, aux))
    return split_kernel(accum, slots, feats, w, aux)


sorted_segment_scatter_add_split.launches = 0


# ------------------------------------------------------------------- K5 ---

def sorted_segment_scatter_add_ref(accum: torch.Tensor, slots: torch.Tensor,
                                   updates: torch.Tensor) -> torch.Tensor:
    """Plain version: ``index_add_`` of the f32 updates."""
    return accum.index_add_(0, slots.long(), updates.float())


def sorted_segment_scatter_add(accum: torch.Tensor, slots: torch.Tensor,
                               updates: torch.Tensor) -> torch.Tensor:
    """``accum[slots[k]] += updates[k]`` in place for ascending ``slots``;
    returns ``accum``.

    accum: (S, W) f32; slots: (B,) int32 ascending; updates: (B, W) f32.
    The JAX package's two TPU payload kernels are bitwise equal, and one
    in-order sum per run gives the same by construction, so the port has
    one.  On CUDA, ``S % 8 == 1`` discards the trash row's updates;
    ``S % 8`` not in {0, 1} takes ``index_add_``."""
    b = slots.shape[0]
    if b == 0:
        return accum
    if accum.device.type == "cpu":
        return sorted_segment_scatter_add_ref(accum, slots, updates)
    name = "sorted_segment_scatter_add"
    s, wd = accum.shape
    _check_cuda(name, accum, slots)
    if not _kernel_takes_rows(s):
        return accum.index_add_(0, slots.long(), updates.float())
    updates = updates.float().contiguous()
    _check_cuda(name, accum, slots, updates)
    require(updates.shape == (b, wd), "{}: shape mismatch", name)
    build.check(build.load(_LIB).avl_segment_scatter_add(
        accum.data_ptr(), slots.data_ptr(), updates.data_ptr(), b, wd,
        _skip_slot(s), torch.cuda.current_stream().cuda_stream), name)
    sorted_segment_scatter_add.launches += 1
    return accum


sorted_segment_scatter_add.launches = 0
