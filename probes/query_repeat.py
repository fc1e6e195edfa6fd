"""Run ``chip_smoke.py``'s serving object query alone, several times in
one process, to time the query's host pace apart from the smoke's other
phases.

    python3 probes/query_repeat.py TREE [REPEATS] [PROFILES]

TREE is a checkout of the repository (``.`` for this one, or a
``git archive`` of another commit unpacked into an ignored directory).
Builds the tree's kernels, makes the full-width ViT-B/32 text encoder
(seeded weights) and runs the tree's ``serving_run`` REPEATS times (3 by
default), each printing its queries/s and synchronous latency.  With
PROFILES > 0 it first opens and closes that many ``torch.profiler``
sessions around a few CUDA launches, as the smoke's kernel checks do
before the query phase, to see whether they slow the host afterwards.
Run two trees in one call, alternating, to compare them on one card.
"""

from __future__ import annotations

import sys
from pathlib import Path


def main() -> int:
    tree = Path(sys.argv[1]).resolve()
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    profiles = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    sys.path.insert(0, str(tree))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from avlmaps_torch.kernels import build
    from avlmaps_torch.models.clip import ClipEncoder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    x = torch.randn(1024, 1024, device="cuda")
    for _ in range(profiles):
        with profile(activities=[ProfilerActivity.CUDA]):
            for _ in range(20):
                x = x @ x.t() / 1024
            torch.cuda.synchronize()
    enc = ClipEncoder("ViT-B/32", seed=0, device="cuda")
    print(f"{tree.name}: {profiles} profiler sessions before the queries",
          flush=True)
    for r in range(reps):
        print(f"repeat {r}:", flush=True)
        cs.serving_run(enc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
