"""The candidates for an LSeg forward that does not depend on the batch
size, measured in about a minute on one card:

    python3 probes/dpt_batch.py

builds the kernels and the ViT-L/16 bf16 LSeg (seeded), then runs
``dpt_batch_run``: the forward of 16 random 480^2 crops against that of
their first 4, call by call from the decoder on (chip_smoke's
``forward_batch_probe``), with the decoder as shipped, under cuDNN's
deterministic flag and in micro-batches of 4, 2 and 1 crops, each with
the decoder's device ms on a batch-8 sliding step's taps and on the
throughput build's 16 whole canvases.  Exits 1 if a crop's output
depends on another's at a fixed batch."""
import contextlib
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402


@contextlib.contextmanager
def dpt_candidate(decoder, how):
    """The DPT decoder run as one candidate for a forward that does not
    depend on the batch size: ``"deterministic"`` under
    ``torch.backends.cudnn.flags(deterministic=True)``, scoped to the
    decoder; an int ``m``, in micro-batches of ``m`` crops (a batch of a
    multiple of ``m``); None, as the model has it."""
    import torch

    decode = decoder.forward

    def deterministic(taps, gh, gw):
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=True, allow_tf32=cudnn.allow_tf32):
            return decode(taps, gh, gw)

    def micro_batched(taps, gh, gw):
        b = taps[0].shape[0]
        if b % how:
            raise ValueError(f"a batch of {b} in micro-batches of {how}")
        return torch.cat([decode([t[i:i + how] for t in taps], gh, gw)
                          for i in range(0, b, how)])

    if how is not None:
        decoder.forward = (deterministic if how == "deterministic"
                           else micro_batched)
    try:
        yield
    finally:
        if how is not None:
            del decoder.forward


def dpt_batch_run(net, crops, per: int, canvases, checks: dict,
                  micro=()) -> dict:
    """Part A: whether the LSeg forward of all ``crops`` equals that of
    their first ``per`` alone, on the decoder as shipped and on each
    candidate of :func:`dpt_candidate` (cuDNN's deterministic flag;
    micro-batches of ``per`` crops, and of each size in ``micro``): the
    probe's final max |d| and first differing call, and the decoder's
    device ms (the ``lseg.dpt`` range) on the taps of all ``crops`` (a
    batch-8 sliding step) and of the throughput build's 16 whole
    ``canvases``.  Fails if a crop's output depends on another's at a
    fixed batch."""
    import torch

    with torch.no_grad():
        taps = net.backbone(crops)
        thr_taps = net.backbone(canvases)
    g = crops.shape[1] // 16
    tg = (canvases.shape[1] // 16, canvases.shape[2] // 16)
    out = {}
    for how in (None, "deterministic", per, *micro):
        label = {None: "as shipped", "deterministic":
                 "(a) cuDNN deterministic"}.get(how,
                                                f"(b) micro-batches of {how}")
        with dpt_candidate(net.decoder, how), torch.no_grad():
            probe = cs.forward_batch_probe(net, crops, per)
            ms = cs.device_ms(lambda: net.decoder(taps, g, g), iters=10)
            thr_ms = cs.device_ms(lambda: net.decoder(thr_taps, *tg),
                                  iters=10)
        out[label] = dict(probe, dpt_ms=ms, dpt_ms_throughput=thr_ms)
        print(f"  part A, {label}: {len(crops)} crops against their first "
              f"{per}: output max |d| {probe['output_d']:.3e}; first call "
              f"to differ {probe['first_call']} "
              f"{probe.get('first_call_name')} (inputs equal "
              f"{probe.get('first_call_inputs_equal')}, shapes "
              f"{probe.get('first_call_input_shapes')}, max |d| "
              f"{probe.get('first_call_d')}); call sequences part at "
              f"{probe['sequences_part_at']}; lseg.dpt device "
              f"{ms:.4f} ms on {tuple(taps[0].shape)} taps, {thr_ms:.4f} "
              f"ms on the throughput build's {tuple(thr_taps[0].shape)}; "
              f"crops independent {probe['crops_independent']}")
        checks[f"part A, {label}: no crop's LSeg output depends on another "
               "crop's at a fixed batch"] = probe["crops_independent"]
    return out


def main() -> int:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    from avlmaps_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    from avlmaps_torch.models.lseg import (LSegConfig, LSegNet,
                                           cast_params_for_inference,
                                           init_params)
    cfg = LSegConfig.vitl16(torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    net = LSegNet(cfg, device="cuda")
    net.load_state_dict(init_params(cfg, gen), strict=True)
    cast_params_for_inference(net)
    net.eval().requires_grad_(False)
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    crops = torch.randn(cs.S10_BATCH * cs.CROPS, 480, 480, 3, generator=g,
                        device="cuda")
    canvases = torch.randn(cs.THR_BATCH, 352, 544, 3, generator=g,
                           device="cuda")
    checks = {}
    dpt_batch_run(net, crops, cs.S10_BATCH // cs.S10_SHARDS * cs.CROPS,
                     canvases, checks, micro=(2, 1))
    for k, v in checks.items():
        print("pass" if v else "FAIL", k)
    print(cs.card_line())
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
