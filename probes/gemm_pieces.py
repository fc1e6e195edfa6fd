"""Where the wgmma GEMMs' time goes on an H100: K1, K6 and K3, piece by
piece, against cuBLAS.

    python3 probes/gemm_pieces.py               # one card; writes nothing
    python3 probes/gemm_pieces.py --host TREE   # host cost of the wrappers

Builds ``probes/gemm_pieces.cu`` (the GEMM of ``csrc/fused_vit.cu`` with
every tile width and epilogue as one entry point, and the LN and GELU
passes) and prints, at ViT-L width and the two row counts of the map
builds (8 crops of 480^2: M = 7208; the batch-16 whole canvas: M =
11,984), the device time of each piece beside cuBLAS's ``F.linear`` for
the same product, the port's wrapper for the whole kernel and the
library calls the smoke times beside it:

- K1 (LN -> qkv, N = 3072, K = 1024): the LN pass, then the GEMM on each
  tile (128 x 256, 128 x 192, 128 x 128);
- K6 (GELU -> proj, N = 1024, K = 4096): the GELU pass, then the GEMM on
  128 x 256 and 128 x 128 tiles;
- K3: the fc (N = 4096, bias + GELU) and the proj (N = 1024, bias +
  residual) on the same two tiles.

Device times are read from ``torch.profiler`` (the kernels' own time, no
launch gap).  It also checks that every tile gives the bits of the 128 x
256 one, and that each wrapper gives the bits of its pass and GEMM.

``--host TREE`` imports ``avlmaps_torch`` from the checkout TREE (``.``
or a ``git archive`` of another commit) and prints the host microseconds
a call of its K1, K6 and K3 wrappers takes to enqueue, at M = 7208.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WIDTH, MLP, EPS = 1024, 4096, 1e-6
ROWS = (7208, 11984)
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s
TILES = {0: "128x256", 1: "128x128"}
TILE_192 = "128x192"  # tile 2, K1 only: 192 divides N = 3072
BIAS, GELU, RESID = 0, 1, 2  # epilogues


def build(out_dir: Path) -> ctypes.CDLL:
    from avlmaps_torch.kernels import build as kb

    so = out_dir / "gemm_pieces.so"
    r = subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(so),
                        str(REPO / "probes" / "gemm_pieces.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stderr[-4000:]}")
    for name, info in kb.ptxas_report(r.stdout + r.stderr).items():
        if "kernel" in name and "registers" in info:
            m = re.search(r"\d+([a-z_]+kernel)((?:I(?:L[^E]*E)+E)?)", name)
            label = "".join(m.groups()) if m else name[:70]
            print(f"  ptxas {label}: {info['registers']} registers, "
                  f"{info.get('spill_stores', 0)} bytes spill stores")
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.probe_gemm.argtypes = [i, i] + [p] * 5 + [i] * 3 + [p]
    lib.probe_ln_rows.argtypes = [p] * 4 + [i, i, f, p]
    lib.probe_gelu_rows.argtypes = [p, p, ctypes.c_longlong, p]
    for fn in (lib.probe_gemm, lib.probe_ln_rows, lib.probe_gelu_rows):
        fn.restype = i
    lib.probe_encode_us.argtypes = [p, i, i, i, i]
    lib.probe_encode_us.restype = ctypes.c_double
    return lib


def device_ms(fn, iters: int = 20) -> float:
    """Device time of every kernel ``fn`` launches, per call: each kernel
    at its mean time per launch times its launches per call (a profile
    can miss some records; chip_smoke.py's device_ms does the same)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total / e.count * max(1, round(
        e.count / iters)) for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def host_us(fn, iters: int = 200) -> float:
    """Host microseconds a call takes to return (the enqueue), with the
    launch queue far from full."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return t


def rand(g, *shape, std=1.0, dtype=None):
    import torch

    return (torch.randn(shape, generator=g, device="cuda") * std).to(
        dtype or torch.bfloat16)


def weights(g):
    import torch

    f32 = torch.float32
    return dict(
        gam=1.0 + rand(g, WIDTH, std=0.1, dtype=f32),
        bet=rand(g, WIDTH, std=0.1, dtype=f32),
        wq=rand(g, 3 * WIDTH, WIDTH, std=WIDTH ** -0.5),
        bq=rand(g, 3 * WIDTH, std=0.1, dtype=f32),
        w1=rand(g, MLP, WIDTH, std=WIDTH ** -0.5),
        b1=rand(g, MLP, std=0.1, dtype=f32),
        w2=rand(g, WIDTH, MLP, std=MLP ** -0.5),
        b2=rand(g, WIDTH, std=0.1, dtype=f32))


def host_main(tree: Path) -> int:
    import torch

    sys.path.insert(0, str(tree))
    from avlmaps_torch.kernels import build as kb
    from avlmaps_torch.ops import fused_vit as fv

    kb.build_all()
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    w = weights(g)
    m = ROWS[0]
    x, h = rand(g, m, WIDTH), rand(g, m, MLP)
    calls = {
        "ln_matmul (K1)": lambda: fv.ln_matmul(x, w["gam"], w["bet"],
                                               w["wq"], w["bq"], eps=EPS),
        "gelu_matmul (K6)": lambda: fv.gelu_matmul(h, w["w2"], w["b2"]),
        "ln_mlp_residual (K3)": lambda: fv.ln_mlp_residual(
            x, w["gam"], w["bet"], w["w1"], w["b1"], w["w2"], w["b2"],
            eps=EPS),
    }
    print(f"{torch.cuda.get_device_name(0)}; tree {tree}")
    for name, fn in calls.items():
        print(f"  host {name}: {host_us(fn):.1f} us per call (M={m})")
    return 0


def host_parts(lib, fv, w, x) -> None:
    """This tree's K1 host cost taken apart: the bare ctypes call of its
    C entry point (two launches, two tensor maps) against the whole
    wrapper, and one tensor map, encoded or from the cache."""
    import torch

    from avlmaps_torch.kernels import build as kb

    m = x.shape[0]
    xn, out = torch.empty_like(x), torch.empty(m, 3 * WIDTH,
                                               dtype=x.dtype, device="cuda")
    args = (x.data_ptr(), w["gam"].data_ptr(), w["bet"].data_ptr(),
            w["wq"].data_ptr(), w["bq"].data_ptr(), xn.data_ptr(),
            out.data_ptr(), m, 3 * WIDTH, WIDTH, EPS,
            torch.cuda.current_stream().cuda_stream)
    c_call = kb.load("fused_vit").avl_ln_matmul
    c_us = host_us(lambda: c_call(*args))
    wrapper_us = host_us(lambda: fv.ln_matmul(x, w["gam"], w["bet"],
                                              w["wq"], w["bq"], eps=EPS))
    encode_us = lib.probe_encode_us(x.data_ptr(), m, WIDTH, 1000, 1)
    cached_us = lib.probe_encode_us(x.data_ptr(), m, WIDTH, 1000, 0)
    print(f"  host K1 C entry alone: {c_us:.1f} us per call; wrapper "
          f"{wrapper_us:.1f} us; a tensor map: encoded {encode_us:.2f} us, "
          f"from the cache {cached_us:.2f} us")


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--host"]:
        return host_main(Path(sys.argv[2]).resolve())
    sys.path.insert(0, str(REPO))
    from avlmaps_torch.ops import fused_vit as fv

    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(tmp))
        g = torch.Generator(device="cuda")
        g.manual_seed(3)
        w = weights(g)
        print(torch.cuda.get_device_name(0))
        host_parts(lib, fv, w, rand(g, ROWS[0], WIDTH))
        for m in ROWS:
            x = rand(g, m, WIDTH)
            hin = rand(g, m, MLP)  # K6's input: an fc output
            xn, gx = torch.empty_like(x), torch.empty_like(hin)
            outs = {n: torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
                    for n in (WIDTH, 3 * WIDTH, MLP)}

            def gemm(epi, tile, a, wt, bias, resid=None):
                n, k = wt.shape
                out = outs[n]
                rc = lib.probe_gemm(
                    epi, tile, a.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                    None if resid is None else resid.data_ptr(),
                    out.data_ptr(), m, n, k, stream())
                if rc:
                    raise RuntimeError(f"probe_gemm: cudaError {rc}")
                return out

            def ln_rows():
                if lib.probe_ln_rows(x.data_ptr(), w["gam"].data_ptr(),
                                     w["bet"].data_ptr(), xn.data_ptr(), m,
                                     WIDTH, EPS, stream()):
                    raise RuntimeError("probe_ln_rows")

            def gelu_rows():
                if lib.probe_gelu_rows(hin.data_ptr(), gx.data_ptr(),
                                       m * MLP, stream()):
                    raise RuntimeError("probe_gelu_rows")

            k1 = lambda: fv.ln_matmul(x, w["gam"], w["bet"], w["wq"],  # noqa: E731
                                      w["bq"], eps=EPS)
            k6 = lambda: fv.gelu_matmul(hin, w["w2"], w["b2"])  # noqa: E731
            k3 = lambda: fv.ln_mlp_residual(  # noqa: E731
                x, w["gam"], w["bet"], w["w1"], w["b1"], w["w2"], w["b2"],
                eps=EPS)
            ln_rows()
            gelu_rows()
            # the same bits on every tile, and from each wrapper
            cases = {"K1": (BIAS, xn, w["wq"], w["bq"], None),
                     "K6": (BIAS, gx, w["w2"], w["b2"], None),
                     "K3 fc": (GELU, xn, w["w1"], w["b1"], None),
                     "K3 proj": (RESID, hin, w["w2"], w["b2"], x)}
            same, refs = {}, {}
            for label, (epi, a, wt, bias, resid) in cases.items():
                refs[label] = gemm(epi, 0, a, wt, bias, resid).clone()
                same[f"{label} {TILES[1]}"] = torch.equal(
                    gemm(epi, 1, a, wt, bias, resid), refs[label])
            same[f"K1 {TILE_192}"] = torch.equal(
                gemm(BIAS, 2, xn, w["wq"], w["bq"]), refs["K1"])
            same["K1 wrapper"] = torch.equal(k1(), refs["K1"])
            same["K6 wrapper"] = torch.equal(k6(), refs["K6"])
            torch.cuda.synchronize()
            print(f"M={m}: bitwise equal to {TILES[0]}: " + ", ".join(
                f"{k} {v}" for k, v in same.items()))
            if not all(same.values()):
                print("  FAIL: a tile or wrapper changed the bits")

            bq, b1, b2 = (w[k].to(torch.bfloat16) for k in ("bq", "b1", "b2"))
            pieces = [("K1 LN pass writing the rows", 0, ln_rows)]
            pieces += [(f"K1 GEMM, {tname}", 3 * WIDTH * WIDTH,
                        lambda s=tile: gemm(BIAS, s, xn, w["wq"], w["bq"]))
                       for tile, tname in {**TILES, 2: TILE_192}.items()]
            pieces += [
                ("K1 cuBLAS F.linear on the rows", 3 * WIDTH * WIDTH,
                 lambda: F.linear(xn, w["wq"], bq)),
                ("K1 ln_matmul wrapper", 3 * WIDTH * WIDTH, k1),
                ("K1 library: layer_norm + linear", 3 * WIDTH * WIDTH,
                 lambda: F.linear(F.layer_norm(
                     x, (WIDTH,), w["gam"].to(x.dtype),
                     w["bet"].to(x.dtype), EPS), w["wq"], bq)),
                ("K6 GELU pass", 0, gelu_rows),
            ]
            pieces += [(f"K6 GEMM, {tname}", MLP * WIDTH,
                        lambda s=tile: gemm(BIAS, s, gx, w["w2"], w["b2"]))
                       for tile, tname in TILES.items()]
            pieces += [
                ("K6 cuBLAS F.linear on the GELU rows", MLP * WIDTH,
                 lambda: F.linear(gx, w["w2"], b2)),
                ("K6 gelu_matmul wrapper", MLP * WIDTH, k6),
                ("K6 library: gelu + linear", MLP * WIDTH,
                 lambda: F.linear(F.gelu(hin), w["w2"], b2)),
            ]
            for tile, tname in TILES.items():
                pieces += [
                    (f"K3 fc + GELU, {tname}", MLP * WIDTH,
                     lambda s=tile: gemm(GELU, s, xn, w["w1"], w["b1"])),
                    (f"K3 proj + b2 + residual, {tname}", MLP * WIDTH,
                     lambda s=tile: gemm(RESID, s, hin, w["w2"], w["b2"],
                                          x)),
                ]
            pieces += [
                ("K3 fc cuBLAS F.linear", MLP * WIDTH,
                 lambda: F.linear(xn, w["w1"], b1)),
                ("K3 proj cuBLAS F.linear", MLP * WIDTH,
                 lambda: F.linear(hin, w["w2"], b2)),
                ("K3 ln_mlp_residual wrapper", 2 * MLP * WIDTH, k3),
            ]
            for name, macs, fn in pieces:
                ms = device_ms(fn)
                rate = ""
                if macs:
                    tf = 2 * m * macs / (ms * 1e-3) / 1e12
                    rate = (f"  {tf:6.1f} TFLOP/s "
                            f"({tf * 1e12 / PEAK_BF16:.2f} of peak)")
                print(f"  M={m} {name:<40} {ms:.4f} ms{rate}")
            del x, hin, xn, gx, outs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
