"""Run ``chip_smoke.py``'s throughput phase several times in one process.

The phase packs a 64-frame scene and builds it twice at batch 16 (device
sampling, then the canvas transport with host sampling), each build
checked and profiled as the smoke does.  Repeating it looks for faults
that show in one run out of many, and times the builds of two commits in
one call on one card:

    python3 probes/throughput_repeat.py TREE [REPEATS]

TREE is a checkout of the repository (``.`` for this one, or a
``git archive`` of another commit unpacked into an ignored directory).
Prints each repeat's lines from the smoke and a count of failed repeats;
exits 1 if any failed.  Where the tree's smoke has the position gate, it
checks every slot position after each fusion step of each build.
"""

from __future__ import annotations

import sys
import tempfile
import traceback
from pathlib import Path


def main() -> int:
    tree = Path(sys.argv[1]).resolve()
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from avlmaps_torch.kernels import build
    from avlmaps_torch.models.lseg import (LSegConfig, LSegNet,
                                           cast_params_for_inference,
                                           init_params)
    from avlmaps_torch.ops import fused_vit as fv
    from avlmaps_torch.ops import segment_scatter as ss

    if hasattr(cs, "PositionGate"):  # older trees have no gate
        cs.GATE = cs.PositionGate()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    cfg = LSegConfig.vitl16(torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    net = LSegNet(cfg, device="cuda")
    net.load_state_dict(init_params(cfg, gen), strict=True)
    cast_params_for_inference(net)
    net.eval().requires_grad_(False)

    rows = [dict(name=f.__name__, fn=f) for f in (
        fv.ln_matmul, fv.mha_oneshot_2d, fv.ln_mlp_residual,
        ss.sorted_segment_scatter_add_split)]
    k5_row = dict(name="sorted_segment_scatter_add",
                  fn=ss.sorted_segment_scatter_add)
    fails = 0
    for r in range(reps):
        print(f"repeat {r}:", flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            try:
                cs.throughput_run(net, Path(tmp), k5_row, rows)
            except Exception as e:  # noqa: BLE001 -- count and go on
                fails += 1
                print(f"repeat {r} failed: {type(e).__name__}: {e}",
                      flush=True)
                traceback.print_exc()
        torch.cuda.empty_cache()
    print(f"{tree.name}: {fails} failed repeats of {reps}", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
