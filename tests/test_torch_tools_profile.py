"""The port's profile and trace tools on the CPU: ``trace_step``'s
categories and its summary of an exported Chrome trace (exact totals on
a trace written here), a tiny16 capture whose summary shows the port's
ranges, ``profile_step``'s fusion segment and ``ab_fusion_prep``'s
holding check at small geometries (every route is its plain version on
the CPU, so the accumulators agree exactly)."""

import json

import numpy as np
import pytest
import torch

from avlmaps_torch.tools import ab_fusion_prep as ab
from avlmaps_torch.tools import profile_step as ps
from avlmaps_torch.tools import trace_step as ts

KERNELS = {
    "void wgmma_gemm_kernel<0, 192>(CUtensorMap_st, CUtensorMap_st, "
    "__nv_bfloat16*, float const*, int, int, int)": "port wgmma_gemm_kernel",
    "ln_rows_kernel(__nv_bfloat16 const*, float const*, float const*, "
    "__nv_bfloat16*, int, int, float)": "port ln_rows_kernel",
    "gelu_rows_kernel(__nv_bfloat16 const*, __nv_bfloat16*, long)":
        "port gelu_rows_kernel",
    "attn_wgmma_kernel(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
    "__nv_bfloat16*, int, int, float)": "port attn_wgmma_kernel",
    "void segment_scatter_kernel<float, false, 4, 5>(float*, int const*, "
    "float const*, float const*, float const*, int, int, int, int)":
        "port segment_scatter_kernel",
    "score_kernel(float const*, float const*, float*, int*, int, int, int)":
        "port score_kernel",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_off_"
    "kernel__5x_cudnn": "cuDNN convolution",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, "
    "__nv_bfloat16, float, false, true, (cudnnKernelDataType_t)0>"
    "(cudnn::engines_precompiled::nchw2nhwc_params_t<float>, "
    "__nv_bfloat16 const*, __nv_bfloat16*)": "cuDNN convolution",
    "void implicit_convolve_sgemm<float, float, 128, 5, 5, 3, 3, 3, 1, "
    "false, false, true>(int, int, int, float const*, int, float*, "
    "float const*, kernel_conv_params, unsigned long long, int, float, "
    "float, int, float const*, float const*, bool, int, int)":
        "cuDNN convolution",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64_"
    "warpgroupsize2x1x1_execute_segment_k_off_kernel__5x_cublas":
        "library GEMM",
    "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_"
    "64x64_64x4_tn_align8>(cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_"
    "64x64_64x4_tn_align8::Params)": "library GEMM",
    "ampere_sgemm_128x64_tn": "library GEMM",
    "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_"
    "detail::cub::DeviceRadixSortPolicy<int, long, unsigned int>::Policy900,"
    " false, int, long, unsigned int, int, int>(int*, int*, int*, int*, "
    "long*, long*, int, int, int)": "sort and scan",
    "void at_cuda_detail::cub::DeviceScanKernel<at_cuda_detail::cub::"
    "DeviceScanPolicy<int>::Policy900, int const*, int*, at_cuda_detail::"
    "cub::ScanTileState<int, true>, std::plus<int>, at_cuda_detail::cub::"
    "NullType, int>(int const*, int*, at_cuda_detail::cub::ScanTileState"
    "<int, true>, int, std::plus<int>, at_cuda_detail::cub::NullType, int)":
        "sort and scan",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "BinaryFunctor<float, float, float, at::native::binary_internal::"
    "MulFunctor<float> >, std::array<char*, 3ul> >(int, at::native::"
    "BinaryFunctor<float, float, float, at::native::binary_internal::"
    "MulFunctor<float> >, std::array<char*, 3ul>)":
        "elementwise and reduce",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::func_wrapper_t<float, at::native::sum_functor<float, "
    "float, float>::operator()(at::TensorIterator&)::{lambda(float, "
    "float)#1}>, unsigned int, float, 4, 4> >(at::native::ReduceOp<float,"
    " at::native::func_wrapper_t<float, at::native::sum_functor<float, "
    "float, float>::operator()(at::TensorIterator&)::{lambda(float, float)"
    "#1}>, unsigned int, float, 4, 4>)": "elementwise and reduce",
    "void at::native::(anonymous namespace)::convert_indices_from_coo_to_"
    "csr_cuda_kernel<int, long>(int*, long const*, long, long)":
        "elementwise and reduce",
    "Memcpy HtoD (Pageable -> Device)": "copies and memsets",
    "Memset (Device)": "copies and memsets",
    "triton_poi_fused_add_0": "other",
}


@pytest.mark.parametrize("name", list(KERNELS))
def test_categorize_real_kernel_names(name):
    assert ts.categorize(name) == KERNELS[name]


def test_every_category_has_a_named_kernel():
    assert set(KERNELS.values()) == {f"port {k}" for k in ts.PORT_KERNELS} \
        | set(ts.CATEGORIES)


def _trace(tmp_path):
    """Two steps of a hand-written Chrome trace: host ranges build.lseg >
    lseg.vit and build.fuse, runtime launches with correlation ids, and
    their kernels, a copy and a memset on the device (plus a device-side
    range annotation and a DtoH copy, both left out)."""
    host = dict(ph="X", pid=10, tid=11)
    dev = dict(ph="X", pid=0, tid=7)
    ev = []
    for step, t0 in enumerate((0.0, 1000.0)):
        ev += [dict(host, cat="user_annotation", name="build.lseg",
                    ts=t0 + 100, dur=100),
               dict(host, cat="user_annotation", name="lseg.vit",
                    ts=t0 + 110, dur=40),
               dict(host, cat="user_annotation", name="build.fuse",
                    ts=t0 + 210, dur=50),
               dict(dev, cat="gpu_user_annotation", name="lseg.vit",
                    ts=t0 + 300, dur=60)]
        launches = [  # (host ts, device event)
            (t0 + 120, dict(cat="kernel", dur=1.5, name="void "
                            "wgmma_gemm_kernel<0, 192>(CUtensorMap_st)")),
            (t0 + 130, dict(cat="kernel", dur=2.25, name="attn_wgmma_"
                            "kernel(CUtensorMap_st)")),
            (t0 + 160, dict(cat="kernel", dur=3.125, name="sm90_xmma_fprop_"
                            "implicit_gemm_bf16_cudnn")),
            (t0 + 220, dict(cat="kernel", dur=0.5, name="void at_cuda_"
                            "detail::cub::DeviceRadixSortOnesweepKernel<>")),
            (t0 + 230, dict(cat="kernel", dur=0.75, name="void segment_"
                            "scatter_kernel<float, true, 4, 5>()")),
            (t0 + 240, dict(cat="gpu_memset", dur=0.25,
                            name="Memset (Device)")),
            (t0 + 400, dict(cat="gpu_memcpy", dur=1.0,
                            name="Memcpy HtoD (Pageable -> Device)")),
            (t0 + 410, dict(cat="gpu_memcpy", dur=9.0,
                            name="Memcpy DtoH (Device -> Pinned)")),
        ]
        for i, (t, e) in enumerate(launches):
            corr = 100 * step + i
            ev.append(dict(host, cat="cuda_runtime", name="cudaLaunchKernel",
                           ts=t, dur=2, args={"correlation": corr}))
            ev.append(dict(dev, ts=t + 50, args={"correlation": corr}, **e))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_summarise_gives_the_exact_totals(tmp_path):
    out = ts.summarise(_trace(tmp_path), reps=2)
    assert out["device"] == "cuda"
    # 1.5 + 2.25 + 3.125 + 0.5 + 0.75 + 0.25 + 1.0 us a step
    assert out["total_ns"] == 2 * 9375
    assert out["total_ms"] == 9375 / 1e6
    assert sum(out["category_ns"].values()) == out["total_ns"]
    cats = {c: v for c, v in out["categories"].items() if v}
    assert cats == {"port wgmma_gemm_kernel": 1500 / 1e6,
                    "port attn_wgmma_kernel": 2250 / 1e6,
                    "cuDNN convolution": 3125 / 1e6,
                    "sort and scan": 500 / 1e6,
                    "port segment_scatter_kernel": 750 / 1e6,
                    "copies and memsets": 1250 / 1e6}
    assert out["launches"]["copies and memsets"] == 2
    assert out["ranges"] == {"lseg.vit < build.lseg": 3750 / 1e6,
                             "build.lseg": 3125 / 1e6,
                             "build.fuse": 1500 / 1e6,
                             "-": 1000 / 1e6}


def test_trace_cli_summarises_an_exported_trace(tmp_path, capsys):
    out = ts.main(["--trace", str(_trace(tmp_path)), "--reps", "2",
                   "--per-op"])
    assert out["total_ns"] == 2 * 9375
    text = capsys.readouterr().out
    assert "lseg.vit < build.lseg" in text and "top ops:" in text


def test_capture_on_the_cpu_shows_the_port_ranges(tmp_path):
    path = ts.capture(tmp_path, 2, device="cpu", warm=0, lseg="tiny16",
                      hw=(96, 128), gs=100, capacity=20000, batch=2)
    out = ts.summarise(path, 2)
    assert out["device"] == "cpu" and out["total_ms"] > 0
    assert sum(out["category_ns"].values()) == out["total_ns"]
    for r in ("lseg.vit < build.lseg", "lseg.dpt < build.lseg",
              "lseg.head < build.lseg", "build.fuse", "build.geometry"):
        assert out["ranges"].get(r, 0) > 0, r


def test_vit_flops_count_the_real_tokens():
    t, d = 901, 1024
    assert ps.vit_flops(1) == 24 * (t * 2 * d * 12 * d + 4 * t * t * d)
    assert ps.vit_flops(16) == 16 * ps.vit_flops(1)


def test_profile_fusion_segment_on_the_cpu():
    ms, state = ps.fusion_segment("cpu", gs=100, capacity=20000, rows=3000,
                                  reps=2, warm=1)
    assert ms > 0
    vids, feats, _, alphas, _ = ps.fusion_inputs("cpu", 100, 3000)
    assert int(state.n_slots) == len(torch.unique(vids))
    # 3 calls of the same batch: each voxel's weight is 3 x its alphas' sum
    w = np.zeros(100 * 100 * 30)
    np.add.at(w, vids.numpy(), alphas.numpy().astype(np.float64))
    ids = torch.nonzero(state.occupied_flat >= 0).squeeze(1)
    slots = state.occupied_flat[ids].long()
    np.testing.assert_allclose(
        state.accum[slots, feats.shape[1] + 3].double().numpy(),
        3 * w[ids.numpy()], rtol=1e-5)


def test_ab_fusion_prep_holds_every_route_on_the_cpu():
    out = ab.run("cpu", reps=1, rows=4000, gs=100, capacity=20000)
    assert set(out["routes"]) == set(ab.ROUTES)
    assert set(out["stages"]) == {"slot_gather", "argsort", "payload_gather",
                                  "gather+assemble"}
    assert all(v == 0.0 for v in out["held"].values())


def test_ab_fusion_prep_refuses_a_route_that_drops_rows(monkeypatch):
    from avlmaps_torch.ops import voxel_fusion

    plain = voxel_fusion.sorted_segment_scatter_add

    def drop_first(accum, slots, updates, **kw):
        return plain(accum, slots[1:], updates[1:], **kw)

    monkeypatch.setattr(voxel_fusion, "sorted_segment_scatter_add",
                        drop_first)
    with pytest.raises(AssertionError, match="K5 rle"):
        ab.run("cpu", reps=1, rows=4000, gs=100, capacity=20000)
