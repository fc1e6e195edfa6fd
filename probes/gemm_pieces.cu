// The wgmma GEMM of csrc/fused_vit.cu with each tile width (128 x 256,
// 128 x 192, 128 x 128) and epilogue (bias, bias + GELU, bias + residual)
// as one entry point, and the LN and GELU passes, for
// probes/gemm_pieces.py.
#include "../avlmaps_torch/csrc/fused_vit.cu"

#include <chrono>

// tile: 0 128 x 256, 1 128 x 128, 2 128 x 192 (N % 192 == 0).
extern "C" int probe_gemm(int epi, int tile, const void* A, const void* W,
                          const void* bias, const void* resid, void* out,
                          int M, int N, int K, void* stream) {
#define CASE(E, S, T)                                                       \
  if (epi == E && tile == S)                                                \
    return static_cast<int>(launch_gemm_cfg<E, T>(                          \
        (const bf16*)A, (const bf16*)W, (const float*)bias,                 \
        (const bf16*)resid, (bf16*)out, M, N, K, (cudaStream_t)stream));
#define TILES(E) CASE(E, 0, 256) CASE(E, 1, 128) CASE(E, 2, 192)
  TILES(EPI_BIAS)
  TILES(EPI_GELU)
  TILES(EPI_RESID)
#undef TILES
#undef CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int probe_ln_rows(const void* x, const void* g, const void* b,
                             void* xn, int M, int K, float eps,
                             void* stream) {
  return static_cast<int>(launch_ln_rows((const bf16*)x, (const float*)g,
                                         (const float*)b, (bf16*)xn, M, K,
                                         eps, (cudaStream_t)stream));
}

extern "C" int probe_gelu_rows(const void* x, void* g, long long n,
                               void* stream) {
  return static_cast<int>(launch_gelu_rows((const bf16*)x, (bf16*)g,
                                           static_cast<size_t>(n),
                                           (cudaStream_t)stream));
}

// Host microseconds per tensor map of a (rows, cols) bf16 matrix with a
// 128-row box, as each GEMM launch makes two: from the map cache when
// every call has the same address (distinct == 0), else encoded anew
// (each call 128 bytes further on, a new key).
extern "C" double probe_encode_us(const void* base, int rows, int cols,
                                  int iters, int distinct) {
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    const bf16* a = (const bf16*)base + (distinct ? 64 * i : 0);
    if (matrix_map(&map, a, rows, cols, WG_BM) != cudaSuccess) return -1.0;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / iters;
}
