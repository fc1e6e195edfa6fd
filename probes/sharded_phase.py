"""chip_smoke.py's slice-10 phase alone, in about 90 s on one card:

    python3 probes/sharded_phase.py            # one card
    python3 probes/sharded_phase.py --cards    # 2 or more cards

builds the kernels, the ViT-L/16 net (seeded), the slice-1 scene's map
(batch 4) and slice 9's two-floor map (batch 8) that the phase reads,
then runs ``sharded_build_run`` and ``sharded_query_run`` and prints
their checks and numbers.  ``--cards`` writes the slice-1 scene and runs
only ``dryrun_multichip`` over the cards and ``real_cards_run``: the
build over the machine's cards (a copy of the net on each) against the
single-device build.  Exits 1 if a check
fails."""
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
    cs.GATE = cs.PositionGate()
    from avlmaps_torch.models.lseg import (LSegConfig, LSegNet,
                                           cast_params_for_inference,
                                           init_params)
    from avlmaps_torch.ops import fused_vit as fv, segment_scatter as ss
    from avlmaps_torch.ops import similarity as sim
    scatter = dict(route="cuda",
                   source="avlmaps_torch/csrc/segment_scatter.cu")
    rows = [dict(name="ln_matmul", fn=fv.ln_matmul),
            dict(name="mha_oneshot_2d", fn=fv.mha_oneshot_2d),
            dict(name="ln_mlp_residual", fn=fv.ln_mlp_residual),
            dict(name="sorted_segment_scatter_add_split",
                 fn=ss.sorted_segment_scatter_add_split,
                 replaces="avlmaps_tpu/ops/segment_scatter.py:273",
                 **scatter),
            dict(name="score_features", fn=sim.score_features),
            dict(name="score_argmax", fn=sim.score_argmax)]
    k5 = dict(name="sorted_segment_scatter_add",
              fn=ss.sorted_segment_scatter_add,
              replaces="avlmaps_tpu/ops/segment_scatter.py:358", **scatter)
    cfg = LSegConfig.vitl16(torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    net = LSegNet(cfg, device="cuda")
    net.load_state_dict(init_params(cfg, gen), strict=True)
    cast_params_for_inference(net)
    net.eval().requires_grad_(False)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        scene = cs.write_scene(tmp / "scene", cs.N_FRAMES, seed=0)
        if "--cards" in sys.argv[1:]:
            from avlmaps_torch.parallel.dryrun import dryrun_multichip
            n_cards = min(4, torch.cuda.device_count())
            if n_cards >= 2:
                dryrun_multichip(n_cards)
            checks = {}
            cs.real_cards_run(net, scene, tmp, checks)
            for k, v in checks.items():
                print("pass" if v else "FAIL", k)
            return 0 if checks and all(checks.values()) else 1
        mf_scene = tmp / "two_floors"
        tfs = cs.write_two_floor_scene(mf_scene)
        mc, tfs1 = cs._map_setup()
        from avlmaps_torch.map.vlmap_builder import VLMapBuilder
        from avlmaps_torch.map.vlmap_builder_multi_floor import \
            VLMapBuilderMultiFloor
        VLMapBuilder(scene, mc, scene / "poses.txt", *cs._frames(scene),
                     *tfs1, lseg_apply=lambda x: net(x, upsample=False),
                     feat_dim=cs.FEAT, batch_size=cs.BATCH, seed=0,
                     half_res_apply=True, device="cuda"
                     ).create_mobile_base_map(save_every=0, progress=False)
        VLMapBuilderMultiFloor(
            mf_scene, mc, sorted((mf_scene / "rgb").glob("*.png")),
            sorted((mf_scene / "depth").glob("*.npy")), tfs,
            lseg_apply=net, feat_dim=cs.FEAT, batch_size=cs.MF_BATCH,
            seed=0, device="cuda").create_global_map(progress=False)
        print(f"set-up builds in {time.perf_counter() - t0:.1f} s")
        checks = {}
        s10 = cs.sharded_build_run(net, scene, mf_scene, tmp, rows, k5,
                                   checks)
        del net
        torch.cuda.empty_cache()
        from avlmaps_torch.models.clip import ClipEncoder
        enc = ClipEncoder("ViT-B/32", device="cuda")
        s10["query"] = cs.sharded_query_run(enc, scene, rows[5], checks)
        for k, v in checks.items():
            print("pass" if v else "FAIL", k)
        print({r["name"]: r.get("slice10_launches") for r in rows + [k5]})
        import json
        print(json.dumps({"more_shapes": s10.pop("scatter_rows")}))
        print(json.dumps({"slice10": s10}))
        return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
