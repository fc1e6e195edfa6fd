"""chip_smoke.py's slice-11 phase alone, in about two minutes on one card:

    python3 probes/recall_phase.py                 # the smoke's faults
    python3 probes/recall_phase.py --faults all    # every planted fault

builds the kernels, then runs ``recall_parity_run``: the seeded ViT-L/16
reference network (f32, host-loop fusion) against the port's build of 8
frames of 480^2 in f32, in bf16 and in bf16 with each planted fault
(``chip_smoke.PLANTED_FAULTS``), K4 at the build's shape and
``loc_eval`` on the card and the CPU; prints its checks and numbers.
Exits 1 if a check fails."""
import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402


def main():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    from avlmaps_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    from avlmaps_torch.ops import fused_vit as fv, segment_scatter as ss
    from avlmaps_torch.ops import similarity as sim
    rows = [dict(name="ln_matmul", fn=fv.ln_matmul),
            dict(name="mha_oneshot_2d", fn=fv.mha_oneshot_2d),
            dict(name="ln_mlp_residual", fn=fv.ln_mlp_residual),
            dict(name="sorted_segment_scatter_add_split",
                 fn=ss.sorted_segment_scatter_add_split, route="cuda",
                 source="avlmaps_torch/csrc/segment_scatter.cu",
                 replaces="avlmaps_tpu/ops/segment_scatter.py:273"),
            dict(name="score_features", fn=sim.score_features),
            dict(name="score_argmax", fn=sim.score_argmax)]
    faults = (tuple(cs.PLANTED_FAULTS) if "all" in sys.argv[1:]
              else cs.S11_FAULTS)
    checks = {}
    with tempfile.TemporaryDirectory() as tmp:
        numbers = cs.recall_parity_run(Path(tmp), rows, checks, faults)
    for k, v in checks.items():
        print("pass" if v else "FAIL", k)
    print(json.dumps({"slice11": numbers}))
    print(cs.card_line())
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
