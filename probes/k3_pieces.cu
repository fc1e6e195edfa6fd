// K3's pieces as separate entry points, for probes/k3_pieces.py: the
// wgmma GEMM of csrc/fused_vit.cu with each prologue (LN in shared memory,
// none) and epilogue (bias, bias + GELU, bias + residual), and a row
// LayerNorm pass that writes the normalised rows to device memory with
// the same f32 arithmetic as the LN prologue.
#include "../avlmaps_torch/csrc/fused_vit.cu"

namespace {
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
      uint4 u;
      bf16* hv = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        hv[j] = __float2bfloat16((v[i * 8 + j] - mu) * rstd * gamma[k + j]
                                 + beta[k + j]);
      *reinterpret_cast<uint4*>(xn + static_cast<size_t>(row) * K + k) = u;
    }
  }
}
}  // namespace

extern "C" int probe_gemm(int pro, int epi, const void* A, const void* stats,
                          const void* g, const void* b, const void* W,
                          const void* bias, const void* resid, void* out,
                          int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define CALL(P, E)                                                          \
  e = launch_wgmma_gemm<P, E>(                                              \
      (const bf16*)A, (const float2*)stats, (const float*)g,                \
      (const float*)b, (const bf16*)W, (const float*)bias,                  \
      (const bf16*)resid, (bf16*)out, M, N, K, s)
  if (pro == 1 && epi == 1) CALL(PRO_LN, EPI_GELU);
  else if (pro == 0 && epi == 1) CALL(PRO_NONE, EPI_GELU);
  else if (pro == 0 && epi == 0) CALL(PRO_NONE, EPI_BIAS);
  else if (pro == 1 && epi == 0) CALL(PRO_LN, EPI_BIAS);
  else CALL(PRO_NONE, EPI_RESID);
  return static_cast<int>(e);
}

extern "C" int probe_stats(const void* x, void* stats, int M, int K,
                           float eps, void* stream) {
  return static_cast<int>(launch_stats((const bf16*)x, (float2*)stats, M, K,
                                       eps, (cudaStream_t)stream));
}

extern "C" int probe_ln_rows(const void* x, const void* g, const void* b,
                             void* xn, int M, int K, float eps,
                             void* stream) {
  ln_rows_kernel<<<(M + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)g, (const float*)b, (bf16*)xn, M, K, eps);
  return static_cast<int>(cudaGetLastError());
}
