// Hand-written Hopper (sm_90a) kernel for the attention of SuperGlue's
// attentional propagation (models/superglue/model.py: Propagation), in f32.
//
// Replaces no TPU kernel: avlmaps_tpu computes this attention in plain jnp
// (avlmaps_tpu/models/superglue/model.py:100-110) and leaves it to XLA.
// The port ran it as torch ops that wrote the (B, 4, N, M) f32 logits
// (268 MB at 4096 keypoints a side) and read and wrote them again for the
// scale, the key mask and the softmax before the probability product
// read them once more.  Here no logit reaches device memory: a block
// keeps 128 queries' logits, running maxima and sums on chip and streams
// the keys past them (online softmax).
//
// Arithmetic, as the plain version's (ops/superglue_attention.py):
// logit = (q_h . k_h) * scale, scale = 1 / sqrt(hd) (0.125 at hd = 64,
// exact); a padded key's logit is REPLACED by NEG = -1e9, so a query whose
// keys are all padded averages all m values, as a softmax over equal
// logits does; then softmax over the keys and the weighted sum of the
// values.  Every product is an f32 FFMA with f32 sums: no tensor cores,
// no TF32.  exp is ex2.approx of (x - max) * log2(e).
//
// What bounds it on an H100: operations.  A (4096 x 4096) propagation is
// 17.2 GFLOP (4 heads x 4096^2 x 64 x 2 products x 2 flops) against 12 MB
// of inputs and output: 0.257 ms at the 67 TFLOP/s f32 peak, where one
// read of the inputs takes 4 us.  Next to the FFMA pipes (128 lanes an SM)
// the scarce resource is shared memory's 128 bytes a clock: a float that
// a thread loads costs a warp 1/32 of a clock whether or not its lanes
// share it, so a thread has to use each float it loads in 4 FFMAs to keep
// up with the pipes.  The design therefore gives each thread an 8 x 8
// tile of one head, for the logits (8 queries x 8 keys) and for the
// output (8 queries x 8 dims): 64 FFMAs per 16 floats loaded.
//  1. A block serves one pair of heads (2 x 128 threads) of 128 queries;
//     at 4 heads a block the 8 x 8 tiles would need 256 KB of shared
//     memory.  Heads are strided (channel c belongs to head c % 4), so the
//     loads split them: 4-byte cp.async copies put each head's queries
//     and keys dim-major ([dim][row]) and its values key-major, every
//     thread's operands 16-byte vectors; no strided-head copy is made in
//     device memory.  Keys and values are read from L2 (both images' 16 MB
//     stay there).
//  2. Each thread's 8 keys are 4kg..4kg+3 and 32+4kg..32+4kg+3, so the 8
//     threads of a quarter warp read 128 contiguous bytes.  The 8 threads
//     of a row group (lanes t % 8) share its queries: a tile's maximum is
//     three xor shuffles; the sums stay per thread until the end.  The
//     output is rescaled only where a maximum grew.
//  3. Shared memory holds the queries, one tile of 64 keys and one of 64
//     values, and the tile's probabilities ([key][query], the query quad
//     XOR-swizzled by the key, so the writes do not collide): 200 KB at
//     hd = 64, one block an SM.  cp.async brings the tile's values while
//     the logits are computed, and the next tile's keys while the values
//     are summed.
// The image query runs both images' propagations of a layer as one launch
// (B = 2): 128 blocks on 132 SMs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HEADS = 4;
constexpr int BQ = 128;        // queries a block
constexpr int BK = 64;         // keys a tile
constexpr int THREADS = 256;   // 128 a head, two heads a block
constexpr int TR = 8;          // queries a thread: 8 rg .. 8 rg + 7
constexpr int TK = 8;          // keys a thread (see key_of)
constexpr float NEG = -1e9f;   // a padded key's logit (ops/sinkhorn.py's)
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory layout in floats for head width HD, each array one per
// head of the pair: queries [dim][query] and keys [dim][key] (pitches 8
// past the row and heads 4 past a multiple of 32, so a warp's 4-byte
// copies hit 32 banks), values [key][dim], probabilities [key][query].
template <int HD>
struct Layout {
  static constexpr int D = HEADS * HD;     // floats a row in device memory
  static constexpr int QP = BQ + 8;
  static constexpr int QH = HD * QP + 4;
  static constexpr int KP = BK + 8;
  static constexpr int KH = HD * KP + 4;
  static constexpr int VH = BK * HD + 16;  // the heads 16 banks apart
  static constexpr int PH = BK * BQ;
  static constexpr int K0 = 2 * QH;
  static constexpr int V0 = K0 + 2 * KH;
  static constexpr int P0 = V0 + 2 * VH;
  static constexpr int BYTES = (P0 + 2 * PH) * 4;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one float to shared memory, or a zero where `in` is false
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_loads() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ROWS rows of the head pair at `src` (row 0, channel 2 hp) into
// dst[head * H + dim * P + row]; rows at or past `avail` read as zero.  A
// warp copies 4 rows x 2 heads x 4 dims.
template <int HD, int ROWS, int P, int H>
__device__ __forceinline__ void load_dim_major(float* dst, const float* src,
                                               int avail) {
  constexpr int D = HEADS * HD;
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * HD * 2; e += THREADS) {
    const int kk = e & 3, h = (e >> 2) & 1, rest = e >> 3;
    const int dd = rest % HD, row = rest / HD * 4 + kk;
    const bool in = row < avail;
    copy4(dst + h * H + dd * P + row,
          in ? src + static_cast<size_t>(row) * D + 4 * dd + h : src, in);
  }
}

// BK value rows of the head pair into dst[head * VH + key * HD + dim].
template <int HD>
__device__ __forceinline__ void load_values(float* dst, const float* src,
                                            int avail) {
  constexpr int D = HEADS * HD;
#pragma unroll 4
  for (int e = threadIdx.x; e < BK * HD * 2; e += THREADS) {
    const int h = e & 1, rest = e >> 1;
    const int dd = rest % HD, row = rest / HD;
    const bool in = row < avail;
    copy4(dst + h * Layout<HD>::VH + rest,
          in ? src + static_cast<size_t>(row) * D + 4 * dd + h : src, in);
  }
}

// the tile's key of a thread's c-th logit column
__device__ __forceinline__ int key_of(int kg, int c) {
  return (c < 4 ? 0 : 28) + 4 * kg + c;
}

// the head's dim of a thread's c-th output column: 16-byte groups where
// the head width allows them
template <int HD>
__device__ __forceinline__ int dim_of(int kg, int c) {
  return HD % 32 == 0 ? (c >> 2) * 32 + 4 * kg + (c & 3) : kg + 8 * c;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// q (B, n, 4 HD), k and v (B, m, 4 HD), valid (B, m) bytes, out (B, n,
// 4 HD); strided heads.  Grid (ceil(n / BQ), 2 head pairs, B).
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const unsigned char* __restrict__ valid,
                 float* __restrict__ out, int n, int m, float scale) {
  using L = Layout<HD>;
  constexpr int D = L::D;
  constexpr int DPT = HD / 8;  // output dims a thread
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const qs = smem;
  float* const ks = smem + L::K0;
  float* const vs = smem + L::V0;
  float* const ps = smem + L::P0;

  const int hh = threadIdx.x >> 7;  // the thread's head of the pair
  const int rg = (threadIdx.x & 127) >> 3, kg = threadIdx.x & 7;
  const int b = blockIdx.z, hp = blockIdx.y, row0 = blockIdx.x * BQ;
  const float* kb = k + static_cast<size_t>(b) * m * D + 2 * hp;
  const float* vb = v + static_cast<size_t>(b) * m * D + 2 * hp;
  const unsigned char* validb = valid + static_cast<size_t>(b) * m;

  load_dim_major<HD, BQ, L::QP, L::QH>(
      qs, q + (static_cast<size_t>(b) * n + row0) * D + 2 * hp, n - row0);
  load_dim_major<HD, BK, L::KP, L::KH>(ks, kb, m);
  commit();

  const float* qt = qs + hh * L::QH + 8 * rg;  // + dim * QP
  const float* kt = ks + hh * L::KH + 4 * kg;  // + dim * KP (+ 32)
  float* const pt = ps + hh * L::PH;           // + key * BQ
  const float* vt = vs + hh * L::VH;           // + key * HD

  float o[TR][DPT], mrow[TR], lrow[TR];
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    mrow[r] = -INFINITY;
    lrow[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) o[r][c] = 0.0f;
  }

  const int tiles = (m + BK - 1) / BK;
  for (int t = 0; t < tiles; ++t) {
    const int key0 = t * BK;
    wait_loads();
    __syncthreads();  // keys t (and the queries) in; values, P free
    load_values<HD>(vs, vb + static_cast<size_t>(key0) * D, m - key0);
    commit();

    // logits of queries 8 rg + r, keys key_of(kg, c)
    float s[TR][TK];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < TK; ++c) s[r][c] = 0.0f;
#pragma unroll 8
    for (int dd = 0; dd < HD; ++dd) {
      const float4 qa = ld4(qt + dd * L::QP), qb = ld4(qt + dd * L::QP + 4);
      const float4 ka = ld4(kt + dd * L::KP), kb4 = ld4(kt + dd * L::KP + 32);
      const float qv[TR] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      const float kv[TK] = {ka.x, ka.y, ka.z, ka.w,
                            kb4.x, kb4.y, kb4.z, kb4.w};
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < TK; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

    // scale and mask: a padded key's logit is NEG; a key past m is -inf
    // and weighs exactly 0
#pragma unroll
    for (int c = 0; c < TK; ++c) {
      const int key = key0 + key_of(kg, c);
      const bool in = key < m;
      const bool ok = in && validb[key] != 0;
#pragma unroll
      for (int r = 0; r < TR; ++r)
        s[r][c] = ok ? s[r][c] * scale : (in ? NEG : -INFINITY);
    }

    // online softmax: every tile holds a key below m, so the new maximum
    // is finite; the first tile's alpha is ex2(-inf) = 0.  x == max gives
    // ex2(0) = 1 exactly, so a row of NEG logits weighs its keys equally.
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      float mx = s[r][0];
#pragma unroll
      for (int c = 1; c < TK; ++c) mx = fmaxf(mx, s[r][c]);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float mnew = fmaxf(mrow[r], mx);
      const float alpha = ex2((mrow[r] - mnew) * LOG2E);
      mrow[r] = mnew;
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < TK; ++c) {
        s[r][c] = ex2((s[r][c] - mnew) * LOG2E);
        sum += s[r][c];
      }
      lrow[r] = lrow[r] * alpha + sum;
      if (alpha != 1.0f) {
#pragma unroll
        for (int c = 0; c < DPT; ++c) o[r][c] *= alpha;
      }
    }
    // P[key][query]: the query quad q4 is stored at q4 ^ ((key / 4) % 8)
#pragma unroll
    for (int c = 0; c < TK; ++c) {
      const int key = key_of(kg, c), sw = (key >> 2) & 7;
      float* prow = pt + key * BQ;
      *reinterpret_cast<float4*>(prow + 4 * ((2 * rg) ^ sw)) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
      *reinterpret_cast<float4*>(prow + 4 * ((2 * rg + 1) ^ sw)) =
          make_float4(s[4][c], s[5][c], s[6][c], s[7][c]);
    }

    wait_loads();
    __syncthreads();  // values t and P in; every thread is done with keys t
    if (t + 1 < tiles) {
      load_dim_major<HD, BK, L::KP, L::KH>(
          ks, kb + static_cast<size_t>(key0 + BK) * D, m - key0 - BK);
      commit();
    }

    // o += P v over the tile's keys: queries 8 rg + r, dims dim_of(kg, c)
#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      const int sw = (j >> 2) & 7;
      const float* prow = pt + j * BQ;
      const float4 pa = ld4(prow + 4 * ((2 * rg) ^ sw));
      const float4 pb = ld4(prow + 4 * ((2 * rg + 1) ^ sw));
      const float pv[TR] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      const float* vrow = vt + j * HD;
      float vv[DPT];
      if constexpr (HD % 32 == 0) {
#pragma unroll
        for (int g = 0; g < DPT / 4; ++g) {
          const float4 x = ld4(vrow + 32 * g + 4 * kg);
          vv[4 * g] = x.x;
          vv[4 * g + 1] = x.y;
          vv[4 * g + 2] = x.z;
          vv[4 * g + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < DPT; ++c) vv[c] = vrow[dim_of<HD>(kg, c)];
      }
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < DPT; ++c) o[r][c] = fmaf(pv[r], vv[c], o[r][c]);
    }
  }

  // the row group's sums, then out = o / sum at channel 4 dim + head
  const int head = 2 * hp + hh;
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    float l = lrow[r];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) l += __shfl_xor_sync(FULL, l, off);
    const int row = row0 + 8 * rg + r;
    if (row >= n) continue;
    float* orow = out + (static_cast<size_t>(b) * n + row) * D + head;
#pragma unroll
    for (int c = 0; c < DPT; ++c) orow[4 * dim_of<HD>(kg, c)] = o[r][c] / l;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* out, int b, int n, int m, float scale, cudaStream_t s) {
  constexpr int bytes = Layout<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_kernel<HD><<<dim3((n + BQ - 1) / BQ, HEADS / 2, b), THREADS,
                         bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const unsigned char*>(valid),
      static_cast<float*>(out), n, m, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (b, n, 4 hd), k and v (b, m, 4 hd) f32, valid (b, m) bool bytes ->
// out (b, n, 4 hd) f32, heads strided (channel c belongs to head c % 4);
// hd is 8 to 64 in steps of 8; n, m >= 1, b < 65536.  scale multiplies
// the logits (1 / sqrt(hd)).
extern "C" int avl_superglue_attention(const void* q, const void* k,
                                       const void* v, const void* valid,
                                       void* out, int b, int n, int m,
                                       int hd, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return launch<8>(q, k, v, valid, out, b, n, m, scale, s);
    case 16: return launch<16>(q, k, v, valid, out, b, n, m, scale, s);
    case 24: return launch<24>(q, k, v, valid, out, b, n, m, scale, s);
    case 32: return launch<32>(q, k, v, valid, out, b, n, m, scale, s);
    case 40: return launch<40>(q, k, v, valid, out, b, n, m, scale, s);
    case 48: return launch<48>(q, k, v, valid, out, b, n, m, scale, s);
    case 56: return launch<56>(q, k, v, valid, out, b, n, m, scale, s);
    case 64: return launch<64>(q, k, v, valid, out, b, n, m, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
