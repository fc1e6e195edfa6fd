"""The candidates for an LSeg forward that does not depend on the batch
size, measured in about a minute on one card:

    python3 probes/dpt_batch.py [c | build | position [SIZES...]]

builds the kernels and the ViT-L/16 bf16 LSeg (seeded), then runs
``dpt_batch_run``: the forward of 16 random 480^2 crops against that of
their first 4, call by call from the decoder on (chip_smoke's
``forward_batch_probe``), with the decoder as shipped, under cuDNN's
deterministic flag and in micro-batches of 4, 2 and 1 crops, then
``one_conv_run``: (c), only the convolutions that differ, each in
micro-batches of 4 crops, starting from the fourth reassemble stage's
3x3 stride-2 conv and adding the next conv to differ until the output
does not depend on the batch; each row with the decoder's device ms on a
batch-8 sliding step's taps and on the throughput build's 16 whole
canvases.  With ``c``, only the shipped decoder and (c).  With
``build``, ``build_batch_run``: the slice-1 scene built at batch 8
against batch 2, forward by forward and module by module.  With
``position``, ``position_run``: (c) held to a crop's place in the batch
as well, for micro-batches of each size given (default 4, 2 and 1).
Exits 1 if a crop's output depends on another's at a fixed batch.

(c) in micro-batches of 4 made the 16 crops' output equal their first
4's, but a crop's output still depended on its place among the 4
(``position``), so a batch-8 build still parted from a batch-2 one; the
shipped decoder runs that conv one image at a time
(``models/lseg/dpt.py``, ``conv_per_image``).  On this tree the shipped
row and every (c) row are that path; run on a tree before the change,
the probe measures the candidates.
"""
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


@contextlib.contextmanager
def micro_convs(net, sites, per: int, record=None):
    """Every ``conv(x, m, dt)`` call of the LSeg decoder and head (the
    model's one helper for its convolutions) whose module ``m`` is in
    ``sites`` runs in micro-batches of ``per`` crops; the rest as
    whole batches (the shipped per-image conv too).  With ``record`` (a
    list), every call appends its module's name, input and output."""
    import torch

    from avlmaps_torch.models.lseg import dpt, model

    shipped, per_image = dpt.conv, getattr(dpt, "conv_per_image", None)
    names = {id(m): n for n, m in net.named_modules()}
    chosen = {id(m) for m in sites}

    def conv(x, m, dt):
        if id(m) in chosen and x.shape[0] > per:
            out = torch.cat([shipped(c, m, dt) for c in x.split(per)])
        else:
            out = shipped(x, m, dt)
        if record is not None:
            record.append((names[id(m)], x.clone(), out.clone()))
        return out

    dpt.conv = model.conv = conv
    if per_image is not None:
        dpt.conv_per_image = conv
    try:
        yield
    finally:
        dpt.conv = model.conv = shipped
        if per_image is not None:
            dpt.conv_per_image = per_image


def first_conv_to_differ(net, crops, per: int, sites):
    """The first convolution, in call order, whose output over the first
    ``per`` crops differs between the forward of all ``crops`` and that of
    those ``per`` alone, with ``sites`` micro-batched: (module name,
    inputs equal, output max |d|), or None."""
    import torch

    runs = []
    for x in (crops[:per], crops):
        rec = []
        with micro_convs(net, sites, per, rec), torch.no_grad():
            net(x, upsample=False)
        runs.append(rec)
    for (name, xa, oa), (_, xb, ob) in zip(*runs):
        xb, ob = xb[:per], ob[:per]
        if not torch.equal(oa, ob):
            return name, torch.equal(xa, xb), float(
                (oa.float() - ob.float()).abs().max())
    return None


def one_conv_run(net, crops, per: int, canvases, checks: dict,
                 rounds: int = 8) -> dict:
    """Candidate (c): only the convolutions that make the forward depend
    on the batch, each in micro-batches of ``per`` crops (the sharded
    build's smallest forward batch), starting from the fourth reassemble
    stage's 3x3 stride-2 conv; while the probe's output still differs,
    the next conv to differ (:func:`first_conv_to_differ`) joins them.
    Each round prints the probe's row and ``lseg.dpt``'s device ms on
    the taps of all ``crops`` and of the throughput build's
    ``canvases``."""
    import torch

    with torch.no_grad():
        taps = net.backbone(crops)
        thr_taps = net.backbone(canvases)
    g = crops.shape[1] // 16
    tg = (canvases.shape[1] // 16, canvases.shape[2] // 16)
    names = {m: n for n, m in net.named_modules()}
    sites = [net.decoder.reassemble[3].resample]
    out = []
    for _ in range(rounds):
        label = ("(c) micro-batches of " + str(per) + " in "
                 + ", ".join(names[m] for m in sites))
        with micro_convs(net, sites, per), torch.no_grad():
            probe = cs.forward_batch_probe(net, crops, per)
            ms = cs.device_ms(lambda: net.decoder(taps, g, g), iters=10)
            thr_ms = cs.device_ms(lambda: net.decoder(thr_taps, *tg),
                                  iters=10)
        nxt = (None if probe["output_d"] == 0 else
               first_conv_to_differ(net, crops, per, sites))
        row = dict(probe, sites=[names[m] for m in sites], dpt_ms=ms,
                   dpt_ms_throughput=thr_ms, next_conv=nxt)
        out.append(row)
        print(f"  part A, {label}: output max |d| {probe['output_d']:.3e}; "
              f"first call to differ {probe['first_call']} "
              f"{probe.get('first_call_name')}; call sequences part at "
              f"{probe['sequences_part_at']}; next conv to differ {nxt}; "
              f"lseg.dpt device {ms:.4f} ms on {tuple(taps[0].shape)} taps, "
              f"{thr_ms:.4f} ms on {tuple(thr_taps[0].shape)}; crops "
              f"independent {probe['crops_independent']}")
        checks[f"part A, {label}: no crop's LSeg output depends on another "
               "crop's at a fixed batch"] = probe["crops_independent"]
        if nxt is None:
            break
        sites.append(net.get_submodule(nxt[0]))
    return out


def permuted_conv(net, x, perm, sites, per: int):
    """With ``sites`` in micro-batches of ``per``: the LSeg output's max
    |d| between ``net(x)[perm]`` and ``net(x[perm])`` (a crop's output
    depending on its place in the batch), and the first conv, in call
    order, whose output so differs: (module name, inputs equal, max
    |d|), or None."""
    import torch

    runs = []
    for xx in (x, x[perm]):
        rec = []
        with micro_convs(net, sites, per, rec), torch.no_grad():
            y = net(xx, upsample=False)
        runs.append((y, rec))
    (ya, reca), (yb, recb) = runs
    first = None
    for (name, ia, oa), (_, ib, ob) in zip(reca, recb):
        if oa.shape[0] == x.shape[0] and not torch.equal(oa[perm], ob):
            first = (name, torch.equal(ia[perm], ib),
                     float((oa[perm].float() - ob.float()).abs().max()))
            break
    return float((ya[perm].float() - yb.float()).abs().max()), first


def position_run(net, tmp, crops, canvases, checks: dict,
                 sizes=(4, 2, 1), rounds: int = 4) -> list:
    """Candidate (c) again, held to a crop's place in the batch: for each
    micro-batch size, starting from the fourth reassemble stage's strided
    conv, the convs whose output depends on where a crop sits among 4
    (the batch reversed) join the micro-batched ones until the output
    does not; then the decoder's device ms at both shapes and the build of the
    slice-1 scene at batch 8 against batch 2 (:func:`build_batch_run`)."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    x = torch.randn(4, 480, 480, 3, generator=g, device="cuda")
    perm = [3, 2, 1, 0]  # every crop in another place, pairs too
    with torch.no_grad():
        taps = net.backbone(crops)
        thr_taps = net.backbone(canvases)
    gh = crops.shape[1] // 16
    tg = (canvases.shape[1] // 16, canvases.shape[2] // 16)
    rows = []
    for i, per in enumerate(sizes):
        sites = [net.decoder.reassemble[3].resample]
        for _ in range(rounds):
            d, first = permuted_conv(net, x, perm, sites, per)
            if d == 0 or first is None:
                break
            sites.append(net.get_submodule(first[0]))
        names = [n for n, m in net.named_modules() if m in sites]
        with micro_convs(net, sites, per), torch.no_grad():
            ms = cs.device_ms(lambda: net.decoder(taps, gh, gh), iters=10)
            thr_ms = cs.device_ms(lambda: net.decoder(thr_taps, *tg),
                                  iters=10)
            build = build_batch_run(net, tmp / f"{i}_m{per}", checks)
        row = dict(per=per, sites=names, permuted_d=d, first=first,
                   dpt_ms=ms, dpt_ms_throughput=thr_ms, build=build)
        rows.append(row)
        print(f"  part A, (c) in micro-batches of {per} in {names}: output "
              f"of 4 crops permuted max |d| {d:.3e} (first conv to differ "
              f"{first}); lseg.dpt device {ms:.4f} ms on "
              f"{tuple(taps[0].shape)} taps, {thr_ms:.4f} ms on "
              f"{tuple(thr_taps[0].shape)}; build batch 8 against batch 2: "
              f"LSeg outputs {build['outputs_d']:.3e}, fused features "
              f"{build['fuse_feats_d']:.3e}")
    return rows


def _by_crop(calls, batch: int, n_crops: int) -> dict:
    """(window, frame) -> a recorded forward's row, for forwards of
    ``batch`` frames whose crops come window-major (``_crop_batch``)."""
    out = {}
    for k, t in enumerate(calls):
        for j in range(t.shape[0]):
            out[(j // batch, k * batch + j % batch)] = t[j]
    return out


def _max_d(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def module_outputs(net, x) -> list:
    """Every submodule's tensor output of ``net(x, upsample=False)``, in
    the order the modules finish (children before their parents)."""
    import torch

    rec = []
    hooks = [m.register_forward_hook(
        lambda m, i, o, n=n: rec.append((n, o.detach().clone()))
        if isinstance(o, torch.Tensor) else None)
        for n, m in net.named_modules() if n]
    try:
        with torch.no_grad():
            net(x, upsample=False)
    finally:
        for h in hooks:
            h.remove()
    return rec


def build_batch_run(net, tmp, checks: dict, big: int = 8, small: int = 2,
                    frames: int = 8) -> dict:
    """Where a batch-``big`` build of the slice-1 scene parts from a
    batch-``small`` build of the same frames (the 4-shard build's
    forward): each forward's input crops and output maps by (window,
    frame), the first ``fuse_points`` inputs by frame, and the maps; if
    the outputs differ on equal inputs, the first module (in the order
    modules finish) whose output differs, and whether a forward of the
    same 4 crops in another order gives each crop the same output."""
    import torch

    from avlmaps_torch.map import vlmap_builder as vb

    scene = cs.write_scene(tmp / "scene_b", frames, seed=0)
    runs = {}
    for batch in (big, small):
        ins, outs = [], []

        def apply(x):
            y = net(x, upsample=False)
            ins.append(x.detach().clone())
            outs.append(y.detach().clone())
            return y

        with cs._FuseInputs(frames // batch, vb) as fused:
            m = cs._s10_build(apply, scene, tmp / f"batch{batch}",
                              batch=batch)[0]
        n_crops = ins[0].shape[0] // batch
        feats = torch.cat([f[1].reshape(batch, -1, f[1].shape[-1])
                           for f in fused.got])
        runs[batch] = dict(ins=_by_crop(ins, batch, n_crops),
                           outs=_by_crop(outs, batch, n_crops),
                           feats=feats, map=cs._arrays(m))
    a, b = runs[big], runs[small]
    res = dict(inputs_d=_max_d(a["ins"], b["ins"]),
               outputs_d=_max_d(a["outs"], b["outs"]),
               fuse_feats_d=float((a["feats"] - b["feats"]).abs().max()))
    cs._s10_held(f"build batch {big} against batch {small}", a["map"],
                 b["map"], None, checks)
    if res["inputs_d"] == 0 and res["outputs_d"] > 0:
        # the first frames' crops as the big forward and the small one
        # see them, module by module (rows by window and frame)
        n_crops = len(a["ins"]) // frames
        x_big = torch.stack([a["ins"][(c, f)] for c in range(n_crops)
                             for f in range(big)])
        x_small = torch.stack([a["ins"][(c, f)] for c in range(n_crops)
                               for f in range(small)])
        rows_big = [c * big + f for c in range(n_crops) for f in range(small)]
        first = None
        for (n, ob), (_, os_) in zip(module_outputs(net, x_big),
                                     module_outputs(net, x_small)):
            if ob.shape[0] == x_big.shape[0] and ob.shape[1:] == \
                    os_.shape[1:] and not torch.equal(ob[rows_big], os_):
                first = (n, float((ob[rows_big].float() - os_.float())
                                  .abs().max()))
                break
        res["first_module"] = first
        g = torch.Generator(device="cuda")
        g.manual_seed(5)
        x = torch.randn(4, 480, 480, 3, generator=g, device="cuda")
        perm = [2, 3, 0, 1]
        with torch.no_grad():
            y = net(x, upsample=False)
            y_perm = net(x[perm], upsample=False)
        res["permuted_crops_d"] = float((y[perm].float()
                                         - y_perm.float()).abs().max())
    print(f"  build batch {big} against batch {small} ({frames} frames): "
          f"input crops max |d| {res['inputs_d']:.3e}, LSeg outputs "
          f"{res['outputs_d']:.3e}, first fuse_points features "
          f"{res['fuse_feats_d']:.3e}; {res}")
    return res


def dpt_batch_run(net, crops, per: int, canvases, checks: dict,
                  micro=(), candidates=(None, "deterministic")) -> dict:
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
    for how in (*candidates, *micro):
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


def main(argv) -> int:
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
    per = cs.S10_BATCH // cs.S10_SHARDS * cs.CROPS
    if argv and argv[0] in ("build", "position"):
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            if argv[0] == "build":
                build_batch_run(net, Path(tmp), checks)
            else:
                position_run(net, Path(tmp), crops, canvases, checks,
                             sizes=tuple(int(a) for a in argv[1:])
                             or (4, 2, 1))
    elif argv == ["c"]:
        dpt_batch_run(net, crops, per, canvases, checks, candidates=(None,))
    else:
        dpt_batch_run(net, crops, per, canvases, checks,
                      micro=(per, 2, 1))
    if not argv or argv[0] not in ("build", "position"):
        one_conv_run(net, crops, per, canvases, checks)
    for k, v in checks.items():
        print("pass" if v else "FAIL", k)
    print(cs.card_line())
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
