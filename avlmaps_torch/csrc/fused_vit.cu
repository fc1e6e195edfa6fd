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
// over 69 MB), so the bound is the 989 TFLOP/s bf16 peak.  The design keeps
// the operands of every product in shared memory and feeds the tensor cores
// through WMMA (mma.sync, bf16 in, f32 accumulate); wgmma/TMA pipelines are
// later work.
//
// K1: two launches.  ln_stats_kernel computes each row's mean and
//     1/sqrt(var + eps) in f32 (two-pass, one warp per row; 8 bytes a row
//     go to device memory).  The GEMM block owns a 64x128 output tile; x
//     and W stream through a 3-stage cp.async ring in 32-deep slices, and
//     each x slice is normalised in shared memory -- (x - mean) * rstd *
//     gamma + beta in f32, rounded to bf16 -- before the tensor cores read
//     it, so the LayerNorm output never reaches device memory.  The ring
//     takes 46 KB of shared memory, so several blocks share an SM, where
//     normalising the block's 64 full rows up front would hold 128 KB and
//     leave one block per SM.  The epilogue adds the bias in f32 and
//     rounds to bf16 once.
// K2: flash-style.  K and V of one head at T=901 are 2 x 115 KB in bf16,
//     too much for one block beside Q and the logits, so a block owns
//     (batch, head, 64 queries) and walks K/V in 64-key tiles with an
//     online-softmax running max and sum (f32).  q, k, v and the output are
//     addressed by (batch, head, token) element strides: the (B*T, 3W) qkv
//     matrix (q, k, v at column offsets h*64, W+h*64, 2W+h*64, the output
//     at (row, h*64) of (B*T, W)) and contiguous (B, H, T, 64) tensors are
//     the same kernel, with no transpose and no pad copy.  Keys >= t_real
//     are masked to -inf.  P is rounded to bf16 for the PV product, as the
//     TPU kernel does; the row sum stays f32.
// K3: K1's row statistics, then two launches of the K1 GEMM body (a fused
//     single-kernel form is later work): LN -> fc -> +b1 -> exact-erf GELU
//     (erff), which writes the (M, 4096) bf16 intermediate -- the same
//     bf16 values the TPU kernel feeds its second MXU product -- then
//     h.W2^T + b2 + x.  Each 64-row block reads the whole of W1 (fc) or W2
//     (proj) across its column blocks, so at M=7208 each 8 MB weight is
//     read ceil(M/64) = 113 times per launch, from L2 (50 MB) after the
//     first pass; the intermediate costs 2 x 59 MB of device traffic.
// K6: the same GEMM body with a GELU prologue: each landed x slice becomes
//     bf16(0.5 x (1 + erff(x / sqrt 2))) in shared memory, as K1 normalises
//     its slice, so the GELU output never reaches device memory; the
//     epilogue adds the bias.  The TPU kernel's 10-term polynomial erf was
//     a VPU economy; erff is K3's GELU.
//
// Every launcher returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <math.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;             // GEMM block rows
constexpr int BN = 128;            // GEMM block cols
constexpr int BK = 32;             // K slice per pipeline stage
constexpr int PAD = 8;             // bf16 row padding against bank conflicts
constexpr int LDB = BK + PAD;      // stage row stride (elements)
constexpr int LDC = BN + 4;        // f32 epilogue tile row stride
constexpr int STAGES = 3;          // cp.async ring depth
constexpr int GEMM_THREADS = 256;  // 8 warps: 2 (rows) x 4 (cols), 32x32 each

enum { PRO_NONE = 0, PRO_LN = 1, PRO_GELU = 2 };
enum { EPI_BIAS = 0, EPI_GELU = 1, EPI_RESID = 2 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Per-row LayerNorm statistics (mean, 1/sqrt(var + eps)) in f32: one warp
// per row, K/32 values per lane in registers (K <= 1024, K % 256 == 0),
// two-pass variance as the TPU kernel computes it.
__global__ void __launch_bounds__(256)
ln_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ stats,
                int M, int K, float eps) {
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
  if (lane == 0) stats[row] = make_float2(mu, rstd);
}

// out[M, N] = epi(A'[M, K] . W[N, K]^T + bias) with A' = LN(A) (PRO_LN),
// GELU(A) (PRO_GELU) or A.  W is a torch Linear weight (out_features,
// in_features), row-major.  A and W stream through a STAGES-deep cp.async
// ring in 32-deep slices; with a prologue each A slice is transformed in
// shared memory (LN from the precomputed row statistics) before the tensor
// cores read it, so the transformed A never reaches device memory.  The
// f32 epilogue tile aliases the ring.
template <int PRO, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const bf16* __restrict__ A, const float2* __restrict__ stats,
            const float* __restrict__ gamma, const float* __restrict__ beta,
            const bf16* __restrict__ W, const float* __restrict__ bias,
            const bf16* __restrict__ resid, bf16* __restrict__ out, int M,
            int N, int K) {
  static_assert(BM * BK / 8 == GEMM_THREADS, "one A vector per thread");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * BM * LDB;
  float2* St = reinterpret_cast<float2*>(Bs + STAGES * BN * LDB);
  float* Cs = reinterpret_cast<float*>(smem);  // after the main loop

  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = K / BK;

  auto load_stage = [&](int stage, int kt) {
    bf16* a = As + stage * BM * LDB;
    for (int c = tid; c < BM * (BK / 8); c += GEMM_THREADS) {
      const int r = c / (BK / 8), q = (c % (BK / 8)) * 8;
      const bool ok = m0 + r < M;
      cp_async16(a + r * LDB + q,
                 A + static_cast<size_t>(ok ? m0 + r : 0) * K + kt * BK + q,
                 ok);
    }
    bf16* b = Bs + stage * BN * LDB;
    for (int c = tid; c < BN * (BK / 8); c += GEMM_THREADS) {
      const int r = c / (BK / 8), q = (c % (BK / 8)) * 8;
      cp_async16(b + r * LDB + q,
                 W + static_cast<size_t>(n0 + r) * K + kt * BK + q, true);
    }
  };

  if (PRO == PRO_LN) {
    for (int r = tid; r < BM; r += GEMM_THREADS)
      St[r] = m0 + r < M ? stats[m0 + r] : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wm = warp / 4, wn = warp % 4;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt-1 fully consumed
    bf16* as = As + (kt % STAGES) * BM * LDB;
    const bf16* bs = Bs + (kt % STAGES) * BN * LDB;
    if (PRO != PRO_NONE) {
      const int r = tid / (BK / 8), q = (tid % (BK / 8)) * 8;
      const int k = kt * BK + q;
      uint4 u = *reinterpret_cast<uint4*>(as + r * LDB + q);
      bf16* hv = reinterpret_cast<bf16*>(&u);
      if (PRO == PRO_LN) {
        const float2 st = St[r];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          hv[j] = __float2bfloat16((__bfloat162float(hv[j]) - st.x) * st.y
                                   * gamma[k + j] + beta[k + j]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = __bfloat162float(hv[j]);
          hv[j] = __float2bfloat16(0.5f * v
                                   * (1.f + erff(v * 0.70710678118654752f)));
        }
      }
      *reinterpret_cast<uint4*>(as + r * LDB + q) = u;
      __syncthreads();
    }
    if (kt + STAGES - 1 < nk)
      load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * LDB + kk, LDB);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + (wn * 32 + j * 16) * LDB + kk, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the epilogue tile

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  for (int c = tid; c < BM * BN / 8; c += GEMM_THREADS) {
    const int r = c / (BN / 8), q = (c % (BN / 8)) * 8;
    const int row = m0 + r;
    if (row >= M) continue;
    const int col = n0 + q;
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = Cs[r * LDC + q + j] + bias[col + j];
    if (EPI == EPI_GELU) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[j] = 0.5f * o[j] * (1.f + erff(o[j] * 0.70710678118654752f));
    }
    if (EPI == EPI_RESID) {
      uint4 u = *reinterpret_cast<const uint4*>(
          resid + static_cast<size_t>(row) * N + col);
      const bf16* hv = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] += __bfloat162float(hv[j]);
    }
    uint4 u;
    bf16* hv = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) hv[j] = __float2bfloat16(o[j]);
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * N + col) = u;
  }
}

constexpr size_t GEMM_SMEM =
    static_cast<size_t>(STAGES) * (BM + BN) * LDB * sizeof(bf16)
    + BM * sizeof(float2);
static_assert(static_cast<size_t>(BM) * LDC * sizeof(float)
              <= static_cast<size_t>(STAGES) * (BM + BN) * LDB * sizeof(bf16),
              "the epilogue tile fits in the ring it reuses");

cudaError_t launch_stats(const bf16* x, float2* stats, int M, int K,
                         float eps, cudaStream_t stream) {
  ln_stats_kernel<<<(M + 7) / 8, 256, 0, stream>>>(x, stats, M, K, eps);
  return cudaGetLastError();
}

template <int PRO, int EPI>
cudaError_t launch_gemm(const bf16* A, const float2* stats,
                        const float* gamma, const float* beta, const bf16* W,
                        const float* bias, const bf16* resid, bf16* out,
                        int M, int N, int K, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<PRO, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(GEMM_SMEM));
  if (e != cudaSuccess) return e;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_kernel<PRO, EPI><<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(
      A, stats, gamma, beta, W, bias, resid, out, M, N, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- K2 ----
constexpr int HD = 64;              // head dim
constexpr int QT = 64;              // queries per block (16 per warp)
constexpr int KT = 64;              // keys per tile
constexpr int LDH = HD + 8;         // bf16 tile row stride
constexpr int LDS = KT + 4;         // f32 tile row stride (also for O, 64 wide)
constexpr int MHA_THREADS = 128;
constexpr size_t MHA_SMEM =
    3 * QT * LDH * sizeof(bf16)           // Q, K, V tiles
    + 4 * 16 * LDS * sizeof(float)        // per-warp logits
    + 4 * 16 * LDH * sizeof(bf16)         // per-warp probabilities
    + 4 * 16 * LDS * sizeof(float);       // per-warp output accumulator

// Element strides of one operand: batch, head, token (the head dim is
// contiguous).
struct Strides {
  long long b, h, t;
};

__global__ void __launch_bounds__(MHA_THREADS)
mha_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ out, Strides sq,
           Strides sk, Strides sv, Strides so, int T, int t_real,
           float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + QT * LDH;
  bf16* Vs = Ks + KT * LDH;
  float* Ss = reinterpret_cast<float*>(Vs + KT * LDH);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + 4 * 16 * LDS);
  float* Os = reinterpret_cast<float*>(Ps + 4 * 16 * LDH);

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  // tokens r0..r0+63 of one (batch, head); tokens >= T read as zero
  auto load_tile = [&](bf16* dst, const bf16* src, long long st, int r0) {
    for (int c = tid; c < 64 * (HD / 8); c += MHA_THREADS) {
      const int r = c / (HD / 8), e = (c % (HD / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < T)
        val = *reinterpret_cast<const uint4*>(src + (r0 + r) * st + e);
      *reinterpret_cast<uint4*>(dst + r * LDH + e) = val;
    }
  };

  load_tile(Qs, qb, sq.t, q0);
  float* Sw = Ss + warp * 16 * LDS;
  bf16* Pw = Ps + warp * 16 * LDH;
  float* Ow = Os + warp * 16 * LDS;
  for (int i = lane; i < 16 * LDS; i += 32) Ow[i] = 0.f;

  // lane pair (2r, 2r+1) owns row r of the warp's 16; each lane 32 columns
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  float m_run = -INFINITY, l_run = 0.f;
  const int n_kv = (t_real + KT - 1) / KT;

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * KT;
    __syncthreads();  // previous tile fully consumed
    load_tile(Ks, kb, sk.t, k0);
    load_tile(Vs, vb, sv.t, k0);
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> s[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(s[n], 0.f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qs + warp * 16 * LDH + kk, LDH);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + n * 16 * LDH + kk, LDH);
        wmma::mma_sync(s[n], a, kf, s[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::store_matrix_sync(Sw + n * 16, s[n], LDS, wmma::mem_row_major);
    __syncwarp();

    // online softmax over this tile for row r (f32 throughout)
    float lg[32];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = Sw[r * LDS + c0 + i] * scale;
      if (k0 + c0 + i >= t_real) x = -INFINITY;
      lg[i] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);  // finite: key k0 < t_real
    const float alpha = expf(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = expf(lg[i] - m_new);
      sum += p;
      Pw[r * LDH + c0 + i] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * alpha + sum;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < 32; ++i) Ow[r * LDS + c0 + i] *= alpha;
    __syncwarp();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::load_matrix_sync(o[n], Ow + n * 16, LDS, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < KT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Pw + kk, LDH);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, Vs + kk * LDH + n * 16, LDH);
        wmma::mma_sync(o[n], a, vf, o[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::store_matrix_sync(Ow + n * 16, o[n], LDS, wmma::mem_row_major);
    __syncwarp();
  }

  const int row = q0 + warp * 16 + r;
  if (row < T) {
    bf16* dst = out + b * so.b + h * so.h + row * so.t + c0;
#pragma unroll
    for (int i = 0; i < 32; i += 8) {
      uint4 u;
      bf16* hv = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        hv[j] = __float2bfloat16(Ow[r * LDS + c0 + i + j] / l_run);
      *reinterpret_cast<uint4*>(dst + i) = u;
    }
  }
}

}  // namespace

extern "C" int avl_ln_matmul(const void* x, const void* gamma,
                             const void* beta, const void* w,
                             const void* bias, void* stats, void* out, int M,
                             int N, int K, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_stats(static_cast<const bf16*>(x),
                               static_cast<float2*>(stats), M, K, eps, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_gemm<PRO_LN, EPI_BIAS>(
      static_cast<const bf16*>(x), static_cast<const float2*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const bf16*>(w), static_cast<const float*>(bias), nullptr,
      static_cast<bf16*>(out), M, N, K, s));
}

extern "C" int avl_ln_mlp_residual(const void* x, const void* gamma,
                                   const void* beta, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* stats, void* h,
                                   void* out, int M, int K, int N1,
                                   float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_stats(static_cast<const bf16*>(x),
                               static_cast<float2*>(stats), M, K, eps, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_gemm<PRO_LN, EPI_GELU>(
      static_cast<const bf16*>(x), static_cast<const float2*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1), nullptr,
      static_cast<bf16*>(h), M, N1, K, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_gemm<PRO_NONE, EPI_RESID>(
      static_cast<const bf16*>(h), nullptr, nullptr, nullptr,
      static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<const bf16*>(x), static_cast<bf16*>(out), M, K, N1, s));
}

// strides: 12 element strides, (batch, head, token) of q, k, v and out.
extern "C" int avl_mha(const void* q, const void* k, const void* v,
                       void* out, const long long* strides, int B, int T,
                       int H, int t_real, float scale, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      mha_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(MHA_SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  dim3 grid((T + QT - 1) / QT, H, B);
  mha_kernel<<<grid, MHA_THREADS, MHA_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), sq, sk, sv, so, T,
      t_real, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int avl_gelu_matmul(const void* x, const void* w,
                               const void* bias, void* out, int M, int N,
                               int K, void* stream) {
  return static_cast<int>(launch_gemm<PRO_GELU, EPI_BIAS>(
      static_cast<const bf16*>(x), nullptr, nullptr, nullptr,
      static_cast<const bf16*>(w), static_cast<const float*>(bias), nullptr,
      static_cast<bf16*>(out), M, N, K, static_cast<cudaStream_t>(stream)));
}
