// Hand-written Hopper (sm_90a) kernels for the ViT-L/16 block of LSeg.
//
// Replaces the Pallas TPU kernels of avlmaps_tpu/ops/fused_vit.py:
//   K1 avl_ln_matmul        <- ln_matmul        (_ln_matmul_kernel)
//   K2 avl_mha              <- mha_oneshot_2d   (_mha_kernel), and the
//                              (B, H, T, D) attention of
//                              models/lseg/vit.py::_flash_attention /
//                              _splash_attention (JAX's bundled kernels)
//   K3 avl_ln_mlp_residual  <- ln_mlp_residual  (_ln_mlp_kernel)
//   K6 avl_gelu_matmul      <- gelu_matmul      (_gelu_matmul_kernel)
//
// What bounds them on an H100: at the map-building shape (8 crops of 480^2,
// M = 8 * 901 = 7208 token rows, width 1024) all four are bf16 tensor-core
// work well above the card's ~295 FLOP/byte ridge (K1: 45 GFLOP over
// 21 MB; K3: 121 GFLOP over 46 MB; K2: 27 GFLOP over 59 MB; K6: 60 GFLOP
// over 69 MB), so the bound is the 989 TFLOP/s bf16 peak, which only
// wgmma reaches.
//
// All four are Hopper designs: TMA feeds shared memory (128-byte swizzle,
// mbarrier rings, one producer thread) and wgmma computes with f32
// accumulators in registers.
//
// K1, K3, K6: a pass that writes the GEMM's bf16 A operand, then the
//     persistent wgmma_gemm_kernel.  K1 and K3 run ln_rows_kernel (row
//     statistics in f32, two-pass, one warp per row; (x - mean) * rstd *
//     gamma + beta rounded once to bf16: 2 x 15 MB at M = 7208); K6 runs
//     gelu_rows_kernel (bf16(0.5 x (1 + erff(x / sqrt 2))): 2 x 59 MB; the
//     TPU kernel's 10-term polynomial erf was a VPU economy, erff is K3's
//     GELU).  A pass beat normalising or activating each landed x tile in
//     shared memory inside the GEMM at every measured shape: there the
//     consumers did it on the tensor cores' critical path, once per
//     column tile (probes/gemm_pieces.py; PERF.md).  The GEMM: one block
//     per SM walks 128 x TBN output tiles (neighbouring blocks on
//     neighbouring row tiles of one weight panel); one producer thread
//     keeps a 4-stage ring of 64-deep TMA tiles in flight; two consumer
//     warpgroups run wgmma with the accumulators in registers (setmaxnreg
//     moves registers from the producer to them), both on each 128 x 256
//     or 128 x 192 tile (launch_wgmma_gemm).  Epilogues add the bias in
//     f32 from the registers and round once to bf16; K1's qkv epilogue
//     stages the 128 x 192 tile in shared memory for TMA stores, the
//     others store bf16 pairs (K3's also apply GELU or add the
//     residual).  K3 is the LN pass, the fc with bias + GELU writing the
//     (M, 4096) bf16 intermediate -- the bf16 values the TPU
//     kernel feeds its second MXU product -- and the proj with bias + x.
//     One fused K3 would need the (rows, 1024) f32 accumulator of the
//     second product resident beside the fc chunks -- 256 KB for 64 rows,
//     the whole register file -- so full fusion is left to a cluster /
//     distributed-shared-memory design.
// K2: attn_wgmma_kernel, FlashAttention-3's structure.  A block owns
//     (batch, head, 128 queries): two consumer warpgroups of 64 query rows
//     and one producer warp.  Q arrives once by TMA; K and V tiles of 64
//     keys arrive by TMA into a 4-stage ring.  S = Q K^T is a wgmma from
//     shared memory into registers; the online softmax (f32, running max
//     and sum, exp2 with scale * log2 e folded in) runs in registers with
//     quad shuffles; P is rounded to bf16 in registers and is the register
//     A operand of the P V wgmma (V MN-major: the transposed-B form).  S, P
//     and O never touch shared memory until O / l is staged for one TMA
//     store.  Operands are 4-D tensor maps (d = 64, token, head, batch)
//     built from the (batch, head, token) element strides, so the (B*T, 3W)
//     qkv matrix and (B, H, T, 64) tensors are one kernel with no copy and
//     no pad: tokens >= T of a crop load as zeros, not as the next crop's
//     rows, and the output store stops at T.  Keys >= t_real are masked to
//     -inf in the last key tile only.
//
// Every launcher returns a cudaError_t (0 on success) so the Python
// wrapper can raise on a refused launch.  Tensor maps come from the
// driver entry point cuTensorMapEncodeTiled (no -lcuda), through a cache
// keyed by everything the encode reads, and are passed by value as
// __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>
#include <math.h>

#include <atomic>
#include <mutex>

typedef __nv_bfloat16 bf16;

namespace {

enum { EPI_BIAS = 0, EPI_GELU = 1, EPI_RESID = 2 };

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The LN pass: per-row LayerNorm in f32, one warp per row, K/32 values per
// lane in registers (K <= 1024, K % 256 == 0), two-pass variance as the
// TPU kernel computes it; writes the normalised rows, (x - mean) * rstd *
// gamma + beta rounded once to bf16 -- the A operand of K1's and K3's fc
// products.
__global__ void __launch_bounds__(256)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, bf16* __restrict__ xn, int M,
               int K, float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* src = x + static_cast<size_t>(row) * K;
  const int nch = K / 256;
  float v[32];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < nch) {
      uint4 u = *reinterpret_cast<const uint4*>(src + i * 256 + lane * 8);
      const bf16* hv = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[i * 8 + j] = __bfloat162float(hv[j]);
        s += v[i * 8 + j];
      }
    }
  }
  const float mu = warp_sum(s) / K;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < nch) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[i * 8 + j] - mu;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / K + eps);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < nch) {
      const int k = i * 256 + lane * 8;
      const float4 g0 = *reinterpret_cast<const float4*>(gamma + k);
      const float4 g1 = *reinterpret_cast<const float4*>(gamma + k + 4);
      const float4 c0 = *reinterpret_cast<const float4*>(beta + k);
      const float4 c1 = *reinterpret_cast<const float4*>(beta + k + 4);
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      uint4 u;
      bf16* hv = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        hv[j] = __float2bfloat16((v[i * 8 + j] - mu) * rstd * g[j] + c[j]);
      *reinterpret_cast<uint4*>(xn + static_cast<size_t>(row) * K + k) = u;
    }
  }
}

// g = bf16(GELU(x)) elementwise, 8 bf16 (16 bytes) a thread per step of a
// grid-stride loop: K6's A operand.
__global__ void __launch_bounds__(256)
gelu_rows_kernel(const bf16* __restrict__ x, bf16* __restrict__ g,
                 size_t n8) {
  for (size_t i = blockIdx.x * 256ull + threadIdx.x; i < n8;
       i += gridDim.x * 256ull) {
    uint4 u = reinterpret_cast<const uint4*>(x)[i];
    bf16* hv = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      hv[j] = __float2bfloat16(gelu_erf(__bfloat162float(hv[j])));
    reinterpret_cast<uint4*>(g)[i] = u;
  }
}

// ------------------------------------------------ Hopper primitives ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Spin until the barrier's phase with the given parity has completed.  A
// pipeline that never completes (a lost TMA transaction) traps after
// 2^24 polls -- seconds, against microseconds for a real wait -- so a
// fault surfaces as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t i = 0; !mbar_try_wait(addr, parity); ++i)
    if (i == (1u << 24)) __trap();
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// Shared -> global tile store; elements outside the tensor are dropped.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Shared -> global 2-D tile store, committed as its own bulk group;
// elements outside the tensor are dropped.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(c0), "r"(c1) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's bulk store groups still read
// shared memory (N = 0 at exit: all of them).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accesses to accumulator registers across
// the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Shared-memory matrix descriptor for a tile whose rows are 128 bytes
// (64 bf16), 128-byte swizzled by TMA, from a 1024-byte aligned base:
// 8-row swizzle atoms of 1024 bytes.  Both byte offsets are 1024: for a
// K-major operand the stride between 8-row groups (the leading offset is
// unused); for an MN-major operand 64 wide the stride between 8-deep K
// groups (the other is unused).  Advancing the start address by 32 bytes
// steps 16 elements along a K-major row.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16)
         | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared
// memory (128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32],
                                                uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B K-major in shared
// memory (128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64],
                                                uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 192] (+)= A[64 x 16] . B[16 x 192], A and B K-major in shared
// memory (128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n192_ss(float (&d)[96],
                                                uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 256] (+)= A[64 x 16] . B[16 x 256], A and B K-major in shared
// memory (128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n256_ss(float (&d)[128],
                                                uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (bf16 pairs
// in the accumulator layout), B MN-major in shared memory (transposed).
__device__ __forceinline__ void wgmma_m64n64_rs_tb(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// ------------------------------------- K1, K3, K6: the wgmma GEMM ----

constexpr int WG_BM = 128;       // output tile rows
constexpr int WG_BK = 64;        // one 128-byte swizzled row of bf16
constexpr int WG_STAGES = 4;     // TMA ring depth
constexpr int WG_THREADS = 384;  // producer warpgroup + two consumers

constexpr int WG_STG = 2 * 2 * 64 * 64;  // staging: 2 pieces a warpgroup

// Whether the epilogue stages the tile for TMA stores (wgmma_gemm_kernel).
template <int EPI, int TBN>
__host__ __device__ constexpr bool wg_staged() {
  return EPI == EPI_BIAS && TBN != 256;
}

template <int EPI, int TBN>
constexpr size_t wg_gemm_smem() {
  return 1024  // slack to align the dynamic base to the 1024-byte atom
         + static_cast<size_t>(WG_STAGES) * (WG_BM + TBN) * WG_BK
               * sizeof(bf16)
         + (wg_staged<EPI, TBN>() ? WG_STG * sizeof(bf16) : 0)
         + 2 * WG_STAGES * sizeof(uint64_t);
}

template <int TBN>
__device__ __forceinline__ void wgmma_tile(float (&acc)[TBN / 2],
                                           uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (TBN == 256) wgmma_m64n256_ss(acc, da, db, scale_d);
  else if constexpr (TBN == 192) wgmma_m64n192_ss(acc, da, db, scale_d);
  else wgmma_m64n128_ss(acc, da, db, scale_d);
}

// out[M, N] = epi(A[M, K] . W[N, K]^T): epi adds the bias, then applies
// GELU (EPI_GELU) or adds the residual (EPI_RESID), in f32, and rounds to
// bf16 once.  tmA / tmB are 2-D tensor maps of A (M, K) and W (N, K) with
// 64 x 128 and 64 x TBN boxes, 128-byte swizzle.  K % 64 == 0 and
// N % TBN == 0; rows past M load as zeros and are not stored.
//
// Persistent: block b walks tiles b, b + grid, ... (column-major over the
// 128 x TBN tiles, so neighbouring blocks share a weight panel); one
// producer thread keeps the TMA ring full across them, and both consumer
// warpgroups take every stage, 64 rows each of the tile.
//
// EPI_BIAS on 128 x 192 and 128 x 128 tiles (wg_staged) stages each
// warpgroup's 64 x 64 bf16 pieces of the tile in shared memory (two
// buffers a warpgroup, 128-byte swizzle) and writes them with TMA stores
// through tmC, a map of out (M, N) with a 64 x 64 box, so the consumers go
// on to the next tile while the stores drain.  Every other instantiation
// stores bf16 pairs straight from the accumulator layout: staged, the GELU
// and residual epilogues ran slower, and the bias epilogue on 128 x 256
// tiles, beside 128 accumulators a thread, spilled registers
// (probes/gemm_pieces.py; PERF.md).
template <int EPI, int TBN>
__global__ void __launch_bounds__(WG_THREADS, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap tmA,
                  const __grid_constant__ CUtensorMap tmB,
                  const __grid_constant__ CUtensorMap tmC,
                  const float* __restrict__ bias,
                  const bf16* __restrict__ resid, bf16* __restrict__ out,
                  int M, int N, int K) {
  constexpr int A_ELEMS = WG_BM * WG_BK, B_ELEMS = TBN * WG_BK;
  constexpr uint32_t STAGE_BYTES = (A_ELEMS + B_ELEMS) * sizeof(bf16);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + WG_STAGES * A_ELEMS;
  constexpr bool STAGED = wg_staged<EPI, TBN>();
  bf16* Cs = Bs + WG_STAGES * B_ELEMS;  // staging (1024-aligned)
  uint64_t* full = reinterpret_cast<uint64_t*>(Cs + (STAGED ? WG_STG : 0));
  uint64_t* empty = full + WG_STAGES;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m_tiles = (M + WG_BM - 1) / WG_BM;
  const int n_tiles_total = m_tiles * (N / TBN);
  const int nk = K / WG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full across this block's tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles_total; tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * WG_BM;
        const int n0 = (tile / m_tiles) * TBN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          tma_load_2d(As + stage * A_ELEMS, &tmA, &full[stage], kb * WG_BK,
                      m0);
          tma_load_2d(Bs + stage * B_ELEMS, &tmB, &full[stage], kb * WG_BK,
                      n0);
          if (++stage == WG_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;  // this consumer's 64-row half of the tile
    const int warp = tid / 32, lane = tid % 32;
    float acc[TBN / 2];
    int stage = 0, sc = 0;  // sc: pieces staged so far
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles_total; tile += gridDim.x) {
      const int m0 = (tile % m_tiles) * WG_BM;
      const int n0 = (tile / m_tiles) * TBN;
      const bf16* a0 = As + cw * 64 * WG_BK;
      int prev = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint64_t da = sw128_desc(a0 + stage * A_ELEMS);
        const uint64_t db = sw128_desc(Bs + stage * B_ELEMS);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk)
          wgmma_tile<TBN>(acc, da + 2 * kk, db + 2 * kk, (kb | kk) != 0);
        wgmma_commit();
        fence_regs(acc);
        // keep one group in flight: the previous stage is now free
        wgmma_wait<1>();
        fence_regs(acc);
        if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == WG_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // epilogue from the accumulator registers: d[4j + {0,1}] is (row,
      // col + {0,1}) and d[4j + {2,3}] is (row + 8, col + {0,1})
      const int row0 = m0 + cw * 64 + warp * 16 + lane / 4;
      const int colb = n0 + 2 * (lane % 4);
      if constexpr (STAGED) {
        // piece c: this warpgroup's 64 rows x columns 64c .. 64c + 63,
        // i.e. accumulator column blocks j = 8c .. 8c + 7, in the swizzled
        // layout of the store's box: row rr's 16-byte chunk jj sits at
        // chunk jj ^ (rr % 8), and rr % 8 == lane / 4 for both of a
        // thread's rows (rr and rr + 8)
#pragma unroll
        for (int c = 0; c < TBN / 64; ++c, ++sc) {
          unsigned char* buf = reinterpret_cast<unsigned char*>(
              Cs + (2 * cw + (sc & 1)) * 64 * 64);
          unsigned char* rowp =
              buf + (warp * 16 + lane / 4) * 128 + 4 * (lane % 4);
          // the store that last read this buffer (two pieces ago) is done
          if (tid == 0) bulk_wait_read<1>();
          named_bar_sync(1 + cw, 128);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * c + jj;
            const float2 bb =
                *reinterpret_cast<const float2*>(bias + colb + 8 * j);
            unsigned char* p = rowp + ((jj ^ (lane / 4)) << 4);
            *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(
                acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
            *reinterpret_cast<__nv_bfloat162*>(p + 8 * 128) =
                __floats2bfloat162_rn(acc[4 * j + 2] + bb.x,
                                      acc[4 * j + 3] + bb.y);
          }
          fence_proxy_async();
          named_bar_sync(1 + cw, 128);
          if (tid == 0 && m0 + cw * 64 < M)
            tma_store_2d(&tmC, buf, n0 + 64 * c, m0 + cw * 64);
        }
      } else {
#pragma unroll
        for (int j = 0; j < TBN / 8; ++j) {
          const int col = colb + 8 * j;
          const float2 bb = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = row0 + 8 * hh;
            if (row >= M) continue;
            float v0 = acc[4 * j + 2 * hh] + bb.x;
            float v1 = acc[4 * j + 2 * hh + 1] + bb.y;
            const size_t off = static_cast<size_t>(row) * N + col;
            if constexpr (EPI == EPI_GELU) {
              v0 = gelu_erf(v0);
              v1 = gelu_erf(v1);
            } else if constexpr (EPI == EPI_RESID) {
              const float2 r = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(resid + off));
              v0 += r.x;
              v1 += r.y;
            }
            *reinterpret_cast<__nv_bfloat162*>(out + off) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
    if constexpr (STAGED) {
      if (tid == 0) bulk_wait_read<0>();  // shared memory outlives the reads
    }
  }
}

// ------------------------------------------- K2: wgmma attention ----

constexpr int AT_QT = 128;      // queries per block: two warpgroups of 64
constexpr int AT_KT = 64;       // keys per tile
constexpr int AT_HD = 64;       // head dim: one 128-byte row
constexpr int AT_STAGES = 4;    // K/V ring depth
constexpr int AT_THREADS = 288;  // two consumer warpgroups + producer warp
constexpr int AT_TILE = AT_KT * AT_HD;  // elements of one K or V tile
constexpr size_t AT_SMEM = 1024 + (AT_QT * AT_HD + 2 * AT_STAGES * AT_TILE)
                                      * sizeof(bf16)
                           + (1 + 2 * AT_STAGES) * sizeof(uint64_t);

// tmQ, tmK, tmV, tmO: 4-D tensor maps (d = 64, token, head, batch) with
// 64 x 64 boxes, 128-byte swizzle.  Block (query tile, head, batch).
__global__ void __launch_bounds__(AT_THREADS, 2)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap tmQ,
                  const __grid_constant__ CUtensorMap tmK,
                  const __grid_constant__ CUtensorMap tmV,
                  const __grid_constant__ CUtensorMap tmO, int T, int t_real,
                  float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // two 64-row halves
  bf16* Ks = Qs + AT_QT * AT_HD;
  bf16* Vs = Ks + AT_STAGES * AT_TILE;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Vs + AT_STAGES * AT_TILE);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + AT_STAGES;

  const int q0 = blockIdx.x * AT_QT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_kv = (t_real + AT_KT - 1) / AT_KT;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < AT_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {
    // producer warp: Q once, then the K/V ring
    if (lane == 0) {
      mbar_expect_tx(qbar, AT_QT * AT_HD * sizeof(bf16));
      tma_load_4d(Qs, &tmQ, qbar, 0, q0, h, b);
      tma_load_4d(Qs + 64 * AT_HD, &tmQ, qbar, 0, q0 + 64, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_kv; ++j) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], 2 * AT_TILE * sizeof(bf16));
        tma_load_4d(Ks + stage * AT_TILE, &tmK, &full[stage], 0, j * AT_KT,
                    h, b);
        tma_load_4d(Vs + stage * AT_TILE, &tmV, &full[stage], 0, j * AT_KT,
                    h, b);
        if (++stage == AT_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    const int cw = warp / 4, tid = threadIdx.x % 128;
    bf16* Qh = Qs + cw * 64 * AT_HD;
    // log2-domain logits: p = exp2(s * scale * log2 e - m)
    const float sl2 = scale * 1.4426950408889634f;
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    mbar_wait(qbar, 0);
    const uint64_t dq = sw128_desc(Qh);
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < n_kv; ++j) {
      mbar_wait(&full[stage], phase);
      float s[32];
      const uint64_t dk = sw128_desc(Ks + stage * AT_TILE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < AT_HD / 16; ++kk)
        wgmma_m64n64_ss(s, dq + 2 * kk, dk + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // s[4n + {0,1}]: row r, keys 8n + 2 (lane % 4) + {0,1};
      // s[4n + {2,3}]: row r + 8, the same keys
      if (j == n_kv - 1) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (j * AT_KT + 8 * n + 2 * (lane % 4) + e >= t_real) {
              s[4 * n + e] = -INFINITY;
              s[4 * n + 2 + e] = -INFINITY;
            }
          }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mx = fmaxf(mx, fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // finite: key j * 64 < t_real for every tile
        const float m_new = fmaxf(m_run[r], mx * sl2);
        alpha[r] = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(fmaf(s[4 * n + 2 * r + e], sl2, -m_new));
            s[4 * n + 2 * r + e] = p;
            sum += p;
          }
        // per-thread partial row sums; the quad is summed at the end
        l_run[r] = l_run[r] * alpha[r] + sum;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
      // P in bf16 as the register A operand: k-step kk covers keys
      // 16 kk .. 16 kk + 15, the accumulator's n-blocks 2 kk and 2 kk + 1
      const uint64_t dv = sw128_desc(Vs + stage * AT_TILE);
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = 2 * kk + i / 2, e = 2 * (i % 2);
          __nv_bfloat162 v = __floats2bfloat162_rn(s[4 * n + e],
                                                   s[4 * n + e + 1]);
          pa[kk][i] = *reinterpret_cast<uint32_t*>(&v);
        }
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < AT_KT / 16; ++kk)
        wgmma_m64n64_rs_tb(o, pa[kk], dv + (kk * 16 * 128 >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == AT_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // O / l into this warpgroup's (now free) Q half, in the swizzled
    // layout the output tensor map expects, then one TMA store
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int rr = (tid / 32) * 16 + lane / 4 + 8 * r;
      unsigned char* rowp = reinterpret_cast<unsigned char*>(Qh) + rr * 128;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            o[4 * n + 2 * r] / l, o[4 * n + 2 * r + 1] / l);
        *reinterpret_cast<__nv_bfloat162*>(
            rowp + ((n ^ (rr % 8)) << 4) + 4 * (lane % 4)) = v;
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + cw, 128);
    if (tid == 0 && q0 + 64 * cw < T)
      tma_store_4d(&tmO, Qh, 0, q0 + 64 * cw, h, b);
  }
}

// ------------------------------------------------------------ host ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, fetched through the runtime so
// that the library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Encoded maps by everything an encode reads (address, rank, dims, byte
// strides, box): a map holds no more than that, so an entry is right for
// any tensor that has the same key, whatever the memory at that address
// held before.  Direct-mapped; one encode costs several microseconds of
// host time and a ViT block makes ten (probes/gemm_pieces.py --host).
struct MapKey {
  const void* base;
  uint64_t dims[4], strides[3];
  int rank;
  uint32_t box_rows;
};

struct MapCache {
  static constexpr int SIZE = 1024;
  std::mutex mu;
  MapKey key[SIZE];
  CUtensorMap map[SIZE];
  bool used[SIZE] = {};
};

MapCache& map_cache() {
  static MapCache cache;
  return cache;
}

int map_slot(const MapKey& k) {
  uint64_t h = 1469598103934665603ull;  // FNV-1a over the key's bytes
  const unsigned char* p = reinterpret_cast<const unsigned char*>(&k);
  for (size_t i = 0; i < sizeof(MapKey); ++i)
    h = (h ^ p[i]) * 1099511628211ull;
  return static_cast<int>(h % MapCache::SIZE);
}

// A bf16 tensor map with rows of 64 elements (128 bytes, 128-byte
// swizzle): dims and byte strides innermost first (dims[0] == 64), box
// {64, box_rows, 1, ...}.  Elements outside dims load as zeros.
cudaError_t make_map(CUtensorMap* map, const void* base, int rank,
                     const uint64_t* dims, const uint64_t* strides,
                     uint32_t box_rows) {
  MapKey k;
  memset(&k, 0, sizeof(k));  // padding too: the slot hashes bytes
  k.base = base;
  k.rank = rank;
  k.box_rows = box_rows;
  for (int i = 0; i < rank; ++i) {
    k.dims[i] = dims[i];
    if (i > 0) k.strides[i - 1] = strides[i - 1];
  }
  MapCache& c = map_cache();
  const int slot = map_slot(k);
  {
    std::lock_guard<std::mutex> lock(c.mu);
    if (c.used[slot] && memcmp(&c.key[slot], &k, sizeof(k)) == 0) {
      *map = c.map[slot];
      return cudaSuccess;
    }
  }
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  cuuint64_t d[4], s[3];
  cuuint32_t box[4], es[4];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    box[i] = i == 0 ? 64 : (i == 1 ? box_rows : 1);
    es[i] = 1;
    if (i > 0) s[i - 1] = strides[i - 1];
  }
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                         const_cast<void*>(base), d, s, box, es,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(c.mu);
  c.key[slot] = k;
  c.map[slot] = *map;
  c.used[slot] = true;
  return cudaSuccess;
}

// A row-major (rows, cols) bf16 matrix, cols % 64 == 0, box 64 x box_rows.
cudaError_t matrix_map(CUtensorMap* map, const bf16* base, int rows,
                       int cols, uint32_t box_rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols),
                            static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(cols) * sizeof(bf16)};
  return make_map(map, base, 2, dims, strides, box_rows);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// The shared-memory attribute of wgmma_gemm_kernel<EPI, TBN>, set once
// on each card: cudaFuncSetAttribute acts on the current device only, and
// one process may drive several cards (parallel/sharded.py).
template <int EPI, int TBN>
cudaError_t gemm_smem_attr(int smem) {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> set[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && set[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  e = cudaFuncSetAttribute(wgmma_gemm_kernel<EPI, TBN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && dev < kMaxDevices)
    set[dev].store(true, std::memory_order_release);
  return e;
}

// One launch of wgmma_gemm_kernel<EPI, TBN>, one block per SM (or per
// tile, if fewer); the two tensor maps come from the map cache.
template <int EPI, int TBN>
cudaError_t launch_gemm_cfg(const bf16* A, const bf16* W, const float* bias,
                            const bf16* resid, bf16* out, int M, int N,
                            int K, cudaStream_t stream) {
  auto kern = wgmma_gemm_kernel<EPI, TBN>;
  constexpr size_t smem = wg_gemm_smem<EPI, TBN>();
  const cudaError_t attr = gemm_smem_attr<EPI, TBN>(static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  if (M == 0) return cudaSuccess;
  CUtensorMap ta, tb, tc{};
  cudaError_t e = matrix_map(&ta, A, M, K, WG_BM);
  if (e == cudaSuccess) e = matrix_map(&tb, W, N, K, TBN);
  if (wg_staged<EPI, TBN>() && e == cudaSuccess)
    e = matrix_map(&tc, out, M, N, 64);
  if (e != cudaSuccess) return e;
  const int tiles = (M + WG_BM - 1) / WG_BM * (N / TBN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  kern<<<grid, WG_THREADS, smem, stream>>>(ta, tb, tc, bias, resid, out, M,
                                           N, K);
  return cudaGetLastError();
}

// out[M, N] = epi(A[M, K] . W[N, K]^T).  Tile widths as measured on an
// H100 (probes/gemm_pieces.py; PERF.md): the bias epilogue runs 128 x 192
// tiles, staged, where 192 divides N -- K1's qkv (N = 3072) in 0.0688 /
// 0.1188 ms at M = 7208 / 11,984, against 0.0850 / 0.1330 staged on
// 128 x 256 and 0.1041 / 0.1602 direct on 128 x 256 -- else 128 x 256;
// the other epilogues run 128 x 256 where 256 divides N
// (K1's product with direct stores: 0.1602 ms on 128 x 256 against 0.1655
// on 128 x 192 at M = 11,984), else 128 x 192, else 128 x 128 (K6's
// product: 0.1399 ms on 128 x 128 against 0.0966 on 128 x 256).  A
// ping-pong schedule (each consumer warpgroup on its own 128 x 128 tile,
// its epilogue under the other's products, direct stores) measured 2-45%
// slower than 128 x 256 at every shape but K1's at M = 7208, where it
// took 0.0983 ms against 0.1052: slower than the staged 128 x 192 tile.
template <int EPI>
cudaError_t launch_wgmma_gemm(const bf16* A, const bf16* W, const float* bias,
                              const bf16* resid, bf16* out, int M, int N,
                              int K, cudaStream_t stream) {
  if (N % 192 == 0 && (EPI == EPI_BIAS || N % 256 != 0))
    return launch_gemm_cfg<EPI, 192>(A, W, bias, resid, out, M, N, K, stream);
  if (N % 256 == 0)
    return launch_gemm_cfg<EPI, 256>(A, W, bias, resid, out, M, N, K, stream);
  return launch_gemm_cfg<EPI, 128>(A, W, bias, resid, out, M, N, K, stream);
}

// The LN pass: the normalised rows, bf16.
cudaError_t launch_ln_rows(const bf16* x, const float* gamma,
                           const float* beta, bf16* xn, int M, int K,
                           float eps, cudaStream_t stream) {
  if (M == 0) return cudaSuccess;
  ln_rows_kernel<<<(M + 7) / 8, 256, 0, stream>>>(x, gamma, beta, xn, M, K,
                                                  eps);
  return cudaGetLastError();
}

// The GELU pass over n elements (n % 8 == 0).
cudaError_t launch_gelu_rows(const bf16* x, bf16* g, size_t n,
                             cudaStream_t stream) {
  const size_t n8 = n / 8;
  if (n8 == 0) return cudaSuccess;
  const size_t most = static_cast<size_t>(sm_count()) * 8;
  const size_t blocks = (n8 + 255) / 256 < most ? (n8 + 255) / 256 : most;
  gelu_rows_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(x, g,
                                                                     n8);
  return cudaGetLastError();
}

// One attention operand as a 4-D tensor map (d = 64, token, head, batch)
// from its (batch, head, token) element strides.
cudaError_t attn_map(CUtensorMap* map, const void* base,
                     const long long* st, int B, int T, int H) {
  const uint64_t dims[4] = {64, static_cast<uint64_t>(T),
                            static_cast<uint64_t>(H),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(st[2]) * sizeof(bf16),
                               static_cast<uint64_t>(st[1]) * sizeof(bf16),
                               static_cast<uint64_t>(st[0]) * sizeof(bf16)};
  return make_map(map, base, 4, dims, strides, 64);
}

}  // namespace

// K1: the LN pass writes the rows to xn (M, K), then the GEMM adds the
// bias.
extern "C" int avl_ln_matmul(const void* x, const void* gamma,
                             const void* beta, const void* w,
                             const void* bias, void* xn, void* out, int M,
                             int N, int K, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_ln_rows(static_cast<const bf16*>(x),
                                 static_cast<const float*>(gamma),
                                 static_cast<const float*>(beta),
                                 static_cast<bf16*>(xn), M, K, eps, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_wgmma_gemm<EPI_BIAS>(
      static_cast<const bf16*>(xn), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), nullptr, static_cast<bf16*>(out), M,
      N, K, s));
}

// K3: the LN pass (xn), the fc GEMM with bias and GELU (h), the proj GEMM
// with bias and the residual.
extern "C" int avl_ln_mlp_residual(const void* x, const void* gamma,
                                   const void* beta, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* xn, void* h,
                                   void* out, int M, int K, int N1,
                                   float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_ln_rows(static_cast<const bf16*>(x),
                                 static_cast<const float*>(gamma),
                                 static_cast<const float*>(beta),
                                 static_cast<bf16*>(xn), M, K, eps, s);
  if (e == cudaSuccess)
    e = launch_wgmma_gemm<EPI_GELU>(
        static_cast<const bf16*>(xn), static_cast<const bf16*>(w1),
        static_cast<const float*>(b1), nullptr, static_cast<bf16*>(h), M, N1,
        K, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_wgmma_gemm<EPI_RESID>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const bf16*>(x),
      static_cast<bf16*>(out), M, K, N1, s));
}

// strides: 12 element strides, (batch, head, token) of q, k, v and out.
extern "C" int avl_mha(const void* q, const void* k, const void* v,
                       void* out, const long long* strides, int B, int T,
                       int H, int t_real, float scale, void* stream) {
  CUtensorMap tq, tk, tv, to;
  cudaError_t e = attn_map(&tq, q, strides, B, T, H);
  if (e == cudaSuccess) e = attn_map(&tk, k, strides + 3, B, T, H);
  if (e == cudaSuccess) e = attn_map(&tv, v, strides + 6, B, T, H);
  if (e == cudaSuccess) e = attn_map(&to, out, strides + 9, B, T, H);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(AT_SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((T + AT_QT - 1) / AT_QT, H, B);
  attn_wgmma_kernel<<<grid, AT_THREADS, AT_SMEM,
                      static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, to, T,
                                                           t_real, scale);
  return static_cast<int>(cudaGetLastError());
}

// K6: the GELU pass writes g (M, K), then the GEMM adds the bias.
extern "C" int avl_gelu_matmul(const void* x, const void* w,
                               const void* bias, void* g, void* out, int M,
                               int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_gelu_rows(static_cast<const bf16*>(x),
                                   static_cast<bf16*>(g),
                                   static_cast<size_t>(M) * K, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_wgmma_gemm<EPI_BIAS>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), nullptr, static_cast<bf16*>(out), M,
      N, K, s));
}
