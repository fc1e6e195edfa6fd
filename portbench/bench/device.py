"""The card a run uses, the caches it keeps in the checkout, and the check
that no JAX module was loaded."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "avlmaps_tpu")


def prepare_environment(root: Path) -> None:
    """Before torch is imported: kernel caches at fixed paths inside the
    checkout (the port's nvcc libraries already live in
    ``avlmaps_torch/_build``) and no library loading JAX by itself."""
    cache = root / "portbench" / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def require_cards(n: int) -> None:
    """Exit 3, with no result, unless ``n`` CUDA cards are visible."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {n} CUDA card(s), found {have}; "
              "no result", file=sys.stderr)
        sys.exit(3)


def full_f32() -> None:
    """f32 matmuls and convolutions without TF32, for the whole run: the
    configurations state f32 with TF32 off wherever they state f32."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
        return out[0].strip() if out else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def device_record(device, count: int) -> dict:
    """``device`` of the result line: platform, card name, count, the
    peak of allocated memory on the fullest card, and the power limit."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0, "power_limit": "none"}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count, "memory_peak_bytes": int(peak),
            "power_limit": power_limit()}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)
