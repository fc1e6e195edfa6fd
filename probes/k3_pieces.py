"""Where K3's (``ln_mlp_residual``) time goes on an H100.

Builds ``probes/k3_pieces.cu`` (the wgmma GEMM of ``csrc/fused_vit.cu``
with each prologue and epilogue as its own entry point, plus a LayerNorm
pass that writes the normalised rows) and prints, at ViT-L width and the
map build's two row counts (8 crops of 480^2: M = 7208; the batch-16
whole canvas: M = 11984), the device time of each piece beside cuBLAS's
``F.linear`` for the same product:

    python3 probes/k3_pieces.py          # one card; writes nothing

Device times are read from ``torch.profiler`` (the kernels' own time, no
launch overhead), as ``chip_smoke.py`` reads the build's kernels.  It also
checks that the fc product on the rows the LN pass wrote equals, bit for
bit, the fc product with the LN prologue.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WIDTH, MLP, EPS = 1024, 4096, 1e-6
ROWS = (7208, 11984)
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s


def build(out_dir: Path) -> ctypes.CDLL:
    from avlmaps_torch.kernels import build as kb

    so = out_dir / "k3_pieces.so"
    r = subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(so),
                        str(REPO / "probes" / "k3_pieces.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.probe_gemm.argtypes = [i, i] + [p] * 8 + [i] * 3 + [p]
    lib.probe_stats.argtypes = [p, p, i, i, f, p]
    lib.probe_ln_rows.argtypes = [p] * 4 + [i, i, f, p]
    for fn in (lib.probe_gemm, lib.probe_stats, lib.probe_ln_rows):
        fn.restype = i
    return lib


def device_ms(fn, iters: int = 20) -> float:
    """Device time of every kernel ``fn`` launches, per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / iters


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from avlmaps_torch.ops import fused_vit as fv

    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(tmp))
        g = torch.Generator(device="cuda")
        g.manual_seed(3)

        def rn(*shape, std=1.0, dtype=torch.bfloat16):
            return (torch.randn(shape, generator=g, device="cuda")
                    * std).to(dtype)

        w1, w2 = rn(MLP, WIDTH, std=WIDTH ** -0.5), rn(WIDTH, MLP,
                                                       std=MLP ** -0.5)
        b1 = rn(MLP, std=0.1, dtype=torch.float32)
        b2 = rn(WIDTH, std=0.1, dtype=torch.float32)
        gam = 1.0 + rn(WIDTH, std=0.1, dtype=torch.float32)
        bet = rn(WIDTH, std=0.1, dtype=torch.float32)
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        print(torch.cuda.get_device_name(0))
        for m in ROWS:
            x = rn(m, WIDTH)
            stats = torch.empty(m, 2, device="cuda")
            xn = torch.empty_like(x)
            h = torch.empty(m, MLP, dtype=torch.bfloat16, device="cuda")
            h_xn = torch.empty_like(h)
            out = torch.empty_like(x)

            def gemm(pro, epi, a, w, bias, dst, n, k, resid=None):
                rc = lib.probe_gemm(
                    pro, epi, a.data_ptr(), stats.data_ptr(),
                    gam.data_ptr(), bet.data_ptr(), w.data_ptr(),
                    bias.data_ptr(),
                    None if resid is None else resid.data_ptr(),
                    dst.data_ptr(), m, n, k, stream())
                if rc:
                    raise RuntimeError(f"probe_gemm: cudaError {rc}")

            def ln_stats():
                if lib.probe_stats(x.data_ptr(), stats.data_ptr(), m, WIDTH,
                                   EPS, stream()):
                    raise RuntimeError("probe_stats")

            def ln_rows():
                if lib.probe_ln_rows(x.data_ptr(), gam.data_ptr(),
                                     bet.data_ptr(), xn.data_ptr(), m, WIDTH,
                                     EPS, stream()):
                    raise RuntimeError("probe_ln_rows")

            # pro: 1 = LN prologue, 0 = none; epi: 0 bias, 1 GELU, 2 resid
            ln_stats()
            ln_rows()
            gemm(1, 1, x, w1, b1, h, MLP, WIDTH)
            gemm(0, 1, xn, w1, b1, h_xn, MLP, WIDTH)
            gemm(0, 2, h, w2, b2, out, WIDTH, MLP, resid=x)
            k3 = fv.ln_mlp_residual(x, gam, bet, w1, b1, w2, b2, eps=EPS)
            torch.cuda.synchronize()
            print(f"M={m}: fc with the LN prologue == fc on the LN pass's "
                  f"rows, bitwise: {torch.equal(h, h_xn)}; the pieces "
                  f"chained == ln_mlp_residual, bitwise: "
                  f"{torch.equal(out, k3)}")
            b1h, b2h = b1.to(torch.bfloat16), b2.to(torch.bfloat16)
            pieces = [
                ("row stats (ln_stats_kernel)", None, ln_stats),
                ("LN pass writing the rows", None, ln_rows),
                ("fc: LN prologue + GELU (K3)", 1,
                 lambda: gemm(1, 1, x, w1, b1, h, MLP, WIDTH)),
                ("fc: LN prologue + bias", 1,
                 lambda: gemm(1, 0, x, w1, b1, h_xn, MLP, WIDTH)),
                ("fc: on LN rows + GELU", 1,
                 lambda: gemm(0, 1, xn, w1, b1, h_xn, MLP, WIDTH)),
                ("fc: on LN rows + bias", 1,
                 lambda: gemm(0, 0, xn, w1, b1, h_xn, MLP, WIDTH)),
                ("fc: cuBLAS F.linear", 1, lambda: F.linear(xn, w1, b1h)),
                ("proj: + b2 + residual (K3)", 1,
                 lambda: gemm(0, 2, h, w2, b2, out, WIDTH, MLP, resid=x)),
                ("proj: + bias", 1,
                 lambda: gemm(0, 0, h, w2, b2, out, WIDTH, MLP)),
                ("proj: cuBLAS F.linear", 1, lambda: F.linear(h, w2, b2h)),
                ("ln_mlp_residual, all launches", 2,
                 lambda: fv.ln_mlp_residual(x, gam, bet, w1, b1, w2, b2,
                                            eps=EPS)),
            ]
            for name, products, fn in pieces:
                ms = device_ms(fn)
                rate = ""
                if products:
                    tf = products * 2 * m * WIDTH * MLP / (ms * 1e-3) / 1e12
                    rate = (f"  {tf:6.1f} TFLOP/s "
                            f"({tf * 1e12 / PEAK_BF16:.2f} of peak)")
                print(f"  {name:<32} {ms:.4f} ms{rate}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
