"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import contextlib
from typing import Union

import numpy as np
import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is asked
    for and no card is present, so no entry point silently runs on the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA card is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def to_device(a, device: torch.device, dtype=None,
              non_blocking: bool = False) -> torch.Tensor:
    """``a`` (tensor, numpy array or nested sequence) as a tensor on
    ``device``; a tensor already there with the dtype is returned as is.
    ``non_blocking=True`` stages a host array in pinned memory and copies
    it asynchronously: a copy from pageable memory makes the host wait for
    the card, pinned staging does not."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
        if non_blocking and device.type == "cuda":
            a = a.pin_memory()
    return a.to(device=device, dtype=dtype, non_blocking=non_blocking)


@contextlib.contextmanager
def full_f32():
    """f32 convolutions and matmuls without TF32 inside the block; the
    previous settings come back on exit.  cuDNN computes f32 convolutions
    in TF32 unless told otherwise (``torch.backends.cudnn.allow_tf32`` is
    True out of the box), and a user may switch cuBLAS's on: every f32
    model of the port whose output decides by argmax or feeds a log runs
    its forward under this."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled,
                benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
