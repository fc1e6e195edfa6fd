"""Where the sorted segment scatter-add's time goes on an H100: K4 and K5
on three batches, against ``index_add_``.

    python3 probes/scatter_pieces.py               # this checkout
    python3 probes/scatter_pieces.py --tree TREE   # another checkout

TREE is a checkout of the repository (a ``git archive`` of another commit
unpacked into an ignored directory); its ``avlmaps_torch`` is imported, so
two commits can be timed in one call on one card.  The batches, the same
for every tree:

1. the smoke's synthetic K4 batch: 31,104 rows, slots uniform in
   [0, 6000), the last 5% at the trash slot, d = 512, W = 640, with f32
   and bf16 features;
2. a real batch-4 sliding map-build step: the fusion inputs of the first
   step of a 4-frame build of ``chip_smoke.write_scene``'s scene (seed 0),
   sorted by ``sort_batch`` into a fresh 1e6-slot state;
3. K5's real batch-16 step: the first step of the smoke's device-sampled
   whole-canvas build (16 packed frames, seed 3), 124,416 rows.

The slots of a step depend on the frames' geometry and the pixel draws,
not on the features, so the builds run with a stand-in for the LSeg
network (seeded random bf16 half-resolution maps of 512 channels): the
rows are those of the smoke's steps without ViT-L's minutes of set-up.

For each batch it prints the run-length profile (runs of real slots, their
mean and longest length, rows in runs longer than 32 and 256, the trash
run's length), and, from ``torch.profiler``, the device time a call of
each kernel the tree's K4 wrapper (``split_kernel``, whatever the row
count) and K5 wrapper launch, their sum (the whole wrapper call), and
``index_add_`` of the assembled update (the index cast outside the
timing), beside the bound: the bytes this batch needs (each real row read
once, one read-modify-write of each distinct real slot) over 3.35 TB/s.
CUDA-event times a call (10 calls) stand beside them.

Alternatives are built beside the tree's kernel, checked bitwise against
it and timed on the same batches: ``probes/scatter_pieces.cu``, the kernel
of ``csrc/segment_scatter.cu`` with each run's rows staged into shared
memory by ``cp.async.bulk`` copies instead of 128-bit loads, and this
checkout's kernel with other tiles, CTA sizes and row unrolls.
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FEAT, ACCUM_W, CAPACITY = 512, 640, 1_000_000
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s


def smoke():
    """This checkout's chip_smoke.py (the scene writer and map settings)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def standin(seed: int):
    """LSeg's half-resolution output, seeded random: (B, h/2, w/2, 512)
    bf16 for (B, h, w, 3) inputs."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def apply(x):
        return torch.randn(x.shape[0], x.shape[1] // 2, x.shape[2] // 2,
                           FEAT, generator=g, device="cuda").to(
                               torch.bfloat16)
    return apply


def capture_step(cs, scene: Path, batch: int, **kw):
    """The fusion inputs of the first step of a build of ``scene``."""
    from avlmaps_torch.map import vlmap_builder as vb
    from avlmaps_torch.map.vlmap_builder import VLMapBuilder

    mc, tfs = cs._map_setup()
    if kw.get("sampling") == "device":
        mc.lseg_eval = "whole"
    captured = []
    fuse = vb.fuse_points

    def capture(state, *args, **kwa):
        if not captured:
            captured.extend(a.clone() for a in args)
        return fuse(state, *args, **kwa)

    vb.fuse_points = capture
    try:
        VLMapBuilder(scene, mc, scene / "poses.txt", *cs._frames(scene),
                     *tfs, lseg_apply=standin(batch), feat_dim=FEAT,
                     batch_size=batch, seed=0, half_res_apply=True,
                     device="cuda", **kw).create_mobile_base_map(
            save_every=0, progress=False)
    finally:
        vb.fuse_points = fuse
    return captured


def real_batches(tmp: Path):
    """(name, slots, feats, w, aux) of the two captured steps, sorted."""
    from avlmaps_torch.models.lseg.window import plan_windows
    from avlmaps_torch.ops import voxel_fusion as vf
    from avlmaps_torch.pipeline.packed import pack_scene

    cs = smoke()
    mc, _ = cs._map_setup()
    out = []
    scene = cs.write_scene(tmp / "map", cs.BATCH, seed=0)
    thr = cs.write_scene(tmp / "thr", cs.THR_BATCH, seed=3)
    pack_scene(*cs._frames(thr), thr / "scene.avpack",
               canvas_hw=plan_windows(720, 1080)[:2])
    for name, args in (
            ("real batch-4 sliding step",
             capture_step(cs, scene, cs.BATCH)),
            ("real batch-16 whole-canvas step (K5's)",
             capture_step(cs, thr, cs.THR_BATCH, sampling="device"))):
        state = vf.init_fusion_state(mc.gs, mc.vh, FEAT, CAPACITY,
                                     device="cuda")
        sb = vf.sort_batch(state, *args, gs=mc.gs, vh=mc.vh)
        out.append((name, sb.slots, sb.feats.float().contiguous(), sb.w,
                    sb.aux))
    return out


def synthetic_batch():
    """The smoke's K4 batch: 31,104 rows, slots uniform in [0, 6000), the
    last 5% at the trash slot."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    b = 4 * 7776
    slots = torch.sort(torch.randint(0, 6000, (b,), generator=g,
                                     device="cuda"))[0].to(torch.int32)
    slots[-b // 20:] = CAPACITY
    feats = torch.randn(b, FEAT, generator=g, device="cuda")
    w = torch.rand(b, generator=g, device="cuda")
    aux = torch.randn(b, ACCUM_W - FEAT, generator=g, device="cuda")
    return "synthetic smoke batch", slots, feats, w, aux


def run_profile(slots) -> dict:
    import torch

    vals, counts = torch.unique_consecutive(slots, return_counts=True)
    real = vals != CAPACITY
    c = counts[real]
    return dict(rows=int(slots.numel()), real_rows=int(c.sum()),
                runs=int(c.numel()), mean=float(c.float().mean()),
                max=int(c.max()), rows_over_32=int(c[c > 32].sum()),
                rows_over_256=int(c[c > 256].sum()),
                trash=int(counts[~real].sum()))


def kernels_ms(fn, iters: int = 20) -> dict:
    """Device ms a call of each kernel ``fn`` launches (torch.profiler):
    each at its mean time a launch times its launches a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / e.count * max(1, round(
        e.count / iters)) / 1e3 for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA}


def event_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def report(label: str, fn) -> dict:
    ks = kernels_ms(fn)
    kern = sum(v for k, v in ks.items() if "scatter_kernel" in k)
    rest = {k[:60]: round(v, 4) for k, v in ks.items()
            if "scatter_kernel" not in k}
    total = sum(ks.values())
    ev = event_ms(fn)
    print(f"    {label}: kernel {kern:.4f} ms, other launches "
          f"{total - kern:.4f} ms {rest}, whole call {total:.4f} ms "
          f"(device); events {ev:.4f} ms")
    return dict(kernel=kern, other=total - kern, call=total, events=ev)


def ptxas_summary(kb, log: str) -> str:
    """Registers and spill-store bytes of each kernel instantiation in an
    nvcc log, in the order compiled."""
    info = [v for k, v in kb.ptxas_report(log).items()
            if "kernel" in k and "registers" in v]
    return (f"ptxas registers {[v['registers'] for v in info]}, spill "
            f"stores {[v.get('spill_stores', 0) for v in info]} bytes")


def build_variants(out_dir: Path) -> dict:
    """The alternatives to the tree's kernel, by label: (K4 entry, K5
    entry), each with the C interface of ``csrc/segment_scatter.cu``.  The
    bulk-copy kernel of ``probes/scatter_pieces.cu`` and, where this
    checkout's kernel takes ``AVL_SCATTER_TILE``, ``AVL_SCATTER_THREADS``
    and ``AVL_SCATTER_ROW_UNROLL``, other tiles, CTA sizes and row unrolls
    (the source's defaults are the tree's own).  One nvcc each, all at
    once."""
    from avlmaps_torch.kernels import build as kb

    csrc = REPO / "avlmaps_torch" / "csrc"
    jobs = {}
    if (REPO / "probes" / "scatter_pieces.cu").exists():
        jobs["bulk-copy staging"] = ([], REPO / "probes" / "scatter_pieces.cu",
                                     "probe_scatter_bulk")
    if "AVL_SCATTER_ROW_UNROLL" in (csrc / "segment_scatter.cu").read_text():
        for tile, threads, unroll in ((64, 128, 2), (32, 256, 2),
                                      (128, 256, 2), (32, 128, 1),
                                      (32, 128, 4)):
            jobs[f"tile {tile} x {threads} threads, unroll {unroll}"] = (
                [f"-DAVL_SCATTER_TILE={tile}",
                 f"-DAVL_SCATTER_THREADS={threads}",
                 f"-DAVL_SCATTER_ROW_UNROLL={unroll}"],
                csrc / "segment_scatter.cu", "avl_segment_scatter_add")
    procs = {}
    for i, (label, (flags, src, _)) in enumerate(jobs.items()):
        so = out_dir / f"variant{i}.so"
        procs[label] = (so, subprocess.Popen(
            [kb._nvcc(), *kb.NVCC_FLAGS, *flags, "-I", str(csrc), "-o",
             str(so), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for label, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"  {label}: nvcc failed, left out:\n{log[-4000:]}")
            continue
        print(f"  {label}: {ptxas_summary(kb, log)}")
        lib = ctypes.CDLL(str(so))
        prefix = jobs[label][2]
        split, asm = (getattr(lib, f"{prefix}_split"), getattr(lib, prefix))
        split.argtypes = [p, p, p, i, p, p, i, i, i, i, p]
        asm.argtypes = [p, p, p, i, i, i, p]
        split.restype = asm.restype = i
        out[label] = (split, asm)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    tree = REPO
    if sys.argv[1:2] == ["--tree"]:
        tree = Path(sys.argv[2]).resolve()
    sys.path.insert(0, str(tree))
    from avlmaps_torch.kernels import build as kb
    from avlmaps_torch.ops import segment_scatter as ss

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; tree {tree}")
    print(f"  tree: {ptxas_summary(kb, kb.build_all()['segment_scatter'])}")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        # the alternatives are this checkout's, timed beside its own kernel
        variants = build_variants(Path(tmp)) if tree == REPO else {}
        batches = [synthetic_batch()] + real_batches(Path(tmp))
    base = torch.zeros(CAPACITY + 1, ACCUM_W, device="cuda")
    for name, slots, feats, w, aux in batches:
        prof = run_profile(slots)
        print(f"  {name}: {prof}")
        real = slots[slots != CAPACITY]
        n_rows, n_unique = int(real.numel()), int(torch.unique(real).numel())
        update = torch.cat([w[:, None] * feats, aux], dim=1)
        idx = slots.long()
        acc = base.clone()  # the timed calls add into it; base stays 0
        b = slots.numel()
        # bitwise: the assembled kernel against the split kernel
        k4 = ss.split_kernel(base.clone(), slots, feats, w, aux)
        k5 = ss.sorted_segment_scatter_add(base.clone(), slots, update)
        print(f"    K5 == K4 bitwise: {torch.equal(k4[:-1], k5[:-1])}")
        for dtype in ((torch.float32, torch.bfloat16)
                      if name.startswith("synthetic") else (torch.float32,)):
            f = feats.to(dtype)
            bf = int(dtype == torch.bfloat16)
            bound = (n_rows * (f.element_size() * FEAT + 4
                               + 4 * (ACCUM_W - FEAT))
                     + n_unique * ACCUM_W * 8) / PEAK_BYTES * 1e3
            print(f"    K4 {str(dtype)[6:]}: bound {bound:.4f} ms (bytes; "
                  f"{n_rows} real rows, {n_unique} slots)")
            report("K4 split_kernel",
                   lambda: ss.split_kernel(acc, slots, f, w, aux))
            want = ss.split_kernel(base.clone(), slots, f, w, aux)
            for label, (split, _) in variants.items():
                def call(out):
                    return split(out.data_ptr(), slots.data_ptr(),
                                 f.data_ptr(), bf, w.data_ptr(),
                                 aux.data_ptr(), b, FEAT, ACCUM_W, CAPACITY,
                                 stream())
                got = base.clone()
                call(got)
                print(f"    K4 {label} == K4 bitwise: "
                      f"{torch.equal(got[:-1], want[:-1])}")
                report(f"K4 {label}", lambda: call(acc))
            del want
        bound = (n_rows * (4 * ACCUM_W + 4)
                 + n_unique * ACCUM_W * 8) / PEAK_BYTES * 1e3
        print(f"    K5: bound {bound:.4f} ms (bytes)")
        report("K5 sorted_segment_scatter_add",
               lambda: ss.sorted_segment_scatter_add(acc, slots, update))
        for label, (_, asm) in variants.items():
            def call(out):
                return asm(out.data_ptr(), slots.data_ptr(),
                           update.data_ptr(), b, ACCUM_W, CAPACITY, stream())
            got = base.clone()
            call(got)
            print(f"    K5 {label} == K5 bitwise: "
                  f"{torch.equal(got[:-1], k5[:-1])}")
            report(f"K5 {label}", lambda: call(acc))
        report("library index_add_",
               lambda: acc.index_add_(0, idx, update))
        del k4, k5, update, idx
    return 0


if __name__ == "__main__":
    sys.exit(main())
