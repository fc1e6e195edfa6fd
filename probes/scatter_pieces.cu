// K4/K5 with each run's rows staged into shared memory by bulk copies
// (cp.async.bulk, completion on an mbarrier) instead of 128-bit loads: the
// alternative probes/scatter_pieces.py times against the kernel of
// avlmaps_torch/csrc/segment_scatter.cu, whose run finding and work split
// it shares (that file is included).  Each warp owns a buffer of STAGE
// rows: lane 0 copies a run's feature rows and aux rows (or assembled rows)
// in one or two bulk copies a chunk, the warp waits on its mbarrier and sums
// the chunk from shared memory in row order; the weights and the accum row
// are read directly.  Needs rows whose byte widths are multiples of 16
// (d * sizeof(feature) and (W - d) * 4) and 16-byte aligned bases: d = 512,
// W = 640 in the probe.

#include "segment_scatter.cu"

namespace {

constexpr int STAGE = 4;  // rows a warp stages at once

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t i = 0; !done; ++i) {
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P1;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (i == (1u << 24)) __trap();
  }
}

// 4 staged values from shared memory as f32
__device__ __forceinline__ float4 smem4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 smem4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

template <typename FT, bool ASSEMBLED>
__global__ void __launch_bounds__(THREADS)
bulk_scatter_kernel(float* __restrict__ accum, const int* __restrict__ slots,
                    const FT* __restrict__ feats, const float* __restrict__ w,
                    const float* __restrict__ aux, int b, int d, int wd,
                    int skip_slot) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ TileRuns t;
  __shared__ __align__(8) uint64_t bars[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fw = ASSEMBLED ? wd : d, aw = wd - d;  // row widths staged
  const int row_bytes = fw * sizeof(FT) + (ASSEMBLED ? 0 : aw * 4);
  FT* fbuf = reinterpret_cast<FT*>(smem + warp * STAGE * row_bytes);
  float* abuf = reinterpret_cast<float*>(fbuf + STAGE * fw);
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_u32(&bars[warp])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int t0 = blockIdx.x * TILE;
  const int t1 = min(t0 + TILE, b);
  const int n = list_runs(t, slots, t0, t1, b, skip_slot);  // syncs
  if (n == 0) return;
  uint32_t phase = 0;
  for_each_item(t, n, t0, 1, skip_slot,
                [&](int r0, int r1, int slot, int, int) {
    constexpr int NG = 5;  // W = 640: five float4 groups a lane
    float* dst = accum + static_cast<size_t>(slot) * wd;
    float4 acc[NG], old[NG];
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int col = i * 128 + lane * 4;
      acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (col < wd) old[i] = *reinterpret_cast<const float4*>(dst + col);
    }
    for (int c = r0; c < r1; c += STAGE) {
      const int nr = min(STAGE, r1 - c);
      if (lane == 0) {
        const uint32_t fb = nr * fw * sizeof(FT), ab = nr * aw * 4;
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
            :: "r"(smem_u32(&bars[warp])),
               "r"(ASSEMBLED ? fb : fb + ab) : "memory");
        bulk_copy(fbuf, feats + static_cast<size_t>(c) * fw, fb,
                  &bars[warp]);
        if (!ASSEMBLED)
          bulk_copy(abuf, aux + static_cast<size_t>(c) * aw, ab,
                    &bars[warp]);
      }
      mbar_wait(&bars[warp], phase);
      phase ^= 1;
      for (int r = 0; r < nr; ++r) {
        const float wr = ASSEMBLED ? 0.f : __ldg(w + c + r);
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          const int col = i * 128 + lane * 4;
          if (col >= wd) continue;
          float4 v;
          if (ASSEMBLED || col < d) {
            v = smem4(fbuf + r * fw + col);
            if (!ASSEMBLED) {
              v.x = __fmul_rn(wr, v.x); v.y = __fmul_rn(wr, v.y);
              v.z = __fmul_rn(wr, v.z); v.w = __fmul_rn(wr, v.w);
            }
          } else {
            v = smem4(abuf + r * aw + col - d);
          }
          acc[i].x += v.x; acc[i].y += v.y; acc[i].z += v.z; acc[i].w += v.w;
        }
      }
      __syncwarp();  // the buffer is read before the next copy fills it
    }
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int col = i * 128 + lane * 4;
      if (col < wd)
        *reinterpret_cast<float4*>(dst + col) =
            make_float4(old[i].x + acc[i].x, old[i].y + acc[i].y,
                        old[i].z + acc[i].z, old[i].w + acc[i].w);
    }
  });
}

template <typename FT, bool ASSEMBLED>
int launch_bulk(void* accum, const void* slots, const void* feats,
                const void* w, const void* aux, int b, int d, int wd,
                int skip_slot, void* stream) {
  if (b <= 0) return 0;
  if (wd > 640) return static_cast<int>(cudaErrorInvalidValue);
  const int fw = ASSEMBLED ? wd : d;
  const int bytes = WARPS * STAGE * (fw * static_cast<int>(sizeof(FT)) +
                                     (ASSEMBLED ? 0 : (wd - d) * 4));
  auto* kernel = bulk_scatter_kernel<FT, ASSEMBLED>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  kernel<<<(b + TILE - 1) / TILE, THREADS, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(accum), static_cast<const int*>(slots),
      static_cast<const FT*>(feats), static_cast<const float*>(w),
      static_cast<const float*>(aux), b, d, wd, skip_slot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int probe_scatter_bulk_split(void* accum, const void* slots,
                                        const void* feats, int feat_bf16,
                                        const void* w, const void* aux, int b,
                                        int d, int wd, int skip_slot,
                                        void* stream) {
  if (feat_bf16)
    return launch_bulk<__nv_bfloat16, false>(accum, slots, feats, w, aux, b,
                                             d, wd, skip_slot, stream);
  return launch_bulk<float, false>(accum, slots, feats, w, aux, b, d, wd,
                                   skip_slot, stream);
}

extern "C" int probe_scatter_bulk(void* accum, const void* slots,
                                  const void* update, int b, int wd,
                                  int skip_slot, void* stream) {
  return launch_bulk<float, true>(accum, slots, update, nullptr, nullptr, b,
                                  wd, wd, skip_slot, stream);
}
