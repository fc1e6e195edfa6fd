// Hand-written Hopper (sm_90a) kernels for open-vocabulary map scoring.
//
// Replaces the Pallas TPU kernels of avlmaps_tpu/ops/similarity.py:
//   K8 avl_score_features <- score_features (_score_kernel)
//   K7 avl_score_argmax   <- score_argmax   (_score_argmax_kernel)
//
// Both compute s[n, c] = x[n] . t^[c] in full f32 (FFMA on the CUDA cores,
// matching the TPU's Precision.HIGHEST; no TF32, no bf16: a flipped argmax
// changes the query's mask, its heat and its goal), where
//   t^[c] = t[c] * 1/sqrt(max(sum t[c]^2, 1e-12))  when normalize_text,
// else t[c].  K8 writes the (N, C) scores, multiplied by the row's
// 1/sqrt(max(sum x^2, 1e-12)) when normalize_map (taken from the same loads
// of x).  K7 writes the (N,) int32 first index of the row maximum and never
// stores the scores; the map-side norm cannot change an argmax, so it is
// skipped.  Ties go to the lowest index, as np.argmax does: the running
// best is replaced only by a strictly greater score, in ascending category
// order, and all-zero rows tie every category to 0.
//
// What bounds them on an H100: at the serving shape (N = 1e6 voxels,
// D = 512, C = 22) each call reads 2.05 GB of x and does 22.5 GFLOP, so
// the 3.35 TB/s of device memory binds (0.61-0.64 ms) ahead of the
// 67 TFLOP/s f32 rate (0.34 ms); past C ~ 40 the arithmetic binds.  So x
// is read once for all categories.
//
// Design: the block loads its chunk of t (up to ~100 KB: 48 categories at
// D = 512) into shared memory once and normalises it there.  Each warp
// then walks groups of R rows (grid-stride over a persistent grid sized by
// the occupancy calculator): lane l holds x[row][128 j + 4 l .. +3] for
// every j, read with coalesced 16-byte streaming loads.  Per category it
// reads the same float4 slices of t^[c] from shared memory (conflict-free,
// reused across the R rows), accumulates its 4 NJ products per row with
// FFMA, and a 5-step xor-shuffle butterfly leaves the row's full sum in
// every lane; two categories go through each pass, so 2R FMA and shuffle
// chains are in flight.  K8's lane c keeps category c of each 32-category
// run and stores it; K7 keeps a running (best, index) per row in
// registers.  There is no N or C padding.  When C does not fit the
// shared-memory budget the wrapper launches one chunk of categories at a
// time: K8 writes its column slice, K7 carries (best score, index) across
// chunks in a scratch row.
// wgmma and 3xTF32 splitting are later work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// t rows [c0, c0 + nc) -> shared memory, normalised when asked.
__device__ void load_text(float* ts, const float* __restrict__ text, int c0,
                          int nc, int d, int norm_text) {
  const int n4 = nc * d / 4;
  const float4* src = reinterpret_cast<const float4*>(
      text + static_cast<size_t>(c0) * d);
  float4* dst = reinterpret_cast<float4*>(ts);
  for (int i = threadIdx.x; i < n4; i += THREADS) dst[i] = src[i];
  __syncthreads();
  if (!norm_text) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < nc; c += WARPS) {
    float* row = ts + c * d;
    float s = 0.f;
    for (int k = lane; k < d; k += 32) s = fmaf(row[k], row[k], s);
    s = warp_sum(s);
    const float inv = 1.f / sqrtf(fmaxf(s, 1e-12f));
    for (int k = lane; k < d; k += 32) row[k] *= inv;
  }
  __syncthreads();
}

// NJ float4 slices of x per lane (D <= 128 NJ), R rows per warp pass.
// ARGMAX selects K7 (labels, optional cross-chunk best) or K8 (scores).
template <int NJ, int R, bool ARGMAX>
__global__ void __launch_bounds__(THREADS)
score_kernel(const float* __restrict__ x, const float* __restrict__ text,
             float* __restrict__ scores, int* __restrict__ labels,
             float* __restrict__ best_val, int n, int d, int c_total, int c0,
             int nc, int norm_map, int norm_text, int first_chunk) {
  extern __shared__ float4 smem4[];
  float* ts = reinterpret_cast<float*>(smem4);
  load_text(ts, text, c0, nc, d, norm_text);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (n + R - 1) / R;
  for (int g = blockIdx.x * WARPS + warp; g < groups;
       g += gridDim.x * WARPS) {
    const int row0 = g * R;
    float4 xv[R][NJ];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int k = j * 128 + lane * 4;
        xv[r][j] = (row < n && k < d)
                       ? __ldcs(reinterpret_cast<const float4*>(
                             x + static_cast<size_t>(row) * d + k))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }

    float best[R];
    int bi[R];
    float inv[R];
    if (ARGMAX) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + r;
        if (first_chunk || row >= n) {
          best[r] = -INFINITY;
          bi[r] = 0;
        } else {
          best[r] = best_val[row];
          bi[r] = labels[row];
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float sq = 0.f;
        if (norm_map) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float4 v = xv[r][j];
            sq = fmaf(v.x, v.x, sq);
            sq = fmaf(v.y, v.y, sq);
            sq = fmaf(v.z, v.z, sq);
            sq = fmaf(v.w, v.w, sq);
          }
          sq = warp_sum(sq);
        }
        inv[r] = norm_map ? 1.f / sqrtf(fmaxf(sq, 1e-12f)) : 1.f;
      }
    }

    for (int cb = 0; cb < nc; cb += 32) {
      const int ce = min(nc, cb + 32);
      float keep[R];
#pragma unroll
      for (int r = 0; r < R; ++r) keep[r] = 0.f;
      // two categories per pass: 2R independent FMA and shuffle chains
      for (int c = cb; c < ce; c += 2) {
        const bool two = c + 1 < ce;
        const float4* tv0 = reinterpret_cast<const float4*>(ts + c * d);
        const float4* tv1 =
            reinterpret_cast<const float4*>(ts + (two ? c + 1 : c) * d);
        float a0[R], a1[R];
#pragma unroll
        for (int r = 0; r < R; ++r) a0[r] = a1[r] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j * 128 + lane * 4 < d) {
            const float4 t0 = tv0[j * 32 + lane];
            const float4 t1 = tv1[j * 32 + lane];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float4 v = xv[r][j];
              a0[r] = fmaf(v.x, t0.x, a0[r]);
              a1[r] = fmaf(v.x, t1.x, a1[r]);
              a0[r] = fmaf(v.y, t0.y, a0[r]);
              a1[r] = fmaf(v.y, t1.y, a1[r]);
              a0[r] = fmaf(v.z, t0.z, a0[r]);
              a1[r] = fmaf(v.z, t1.z, a1[r]);
              a0[r] = fmaf(v.w, t0.w, a0[r]);
              a1[r] = fmaf(v.w, t1.w, a1[r]);
            }
          }
        }
        // every butterfly first, then branch-free selects, so the 2R
        // shuffle chains overlap instead of waiting on each compare
#pragma unroll
        for (int r = 0; r < R; ++r) {
          a0[r] = warp_sum(a0[r]);
          a1[r] = warp_sum(a1[r]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (ARGMAX) {  // ascending order: a tie keeps the lower index
            const bool b0 = a0[r] > best[r];
            best[r] = b0 ? a0[r] : best[r];
            bi[r] = b0 ? c0 + c : bi[r];
            const bool b1 = two && a1[r] > best[r];
            best[r] = b1 ? a1[r] : best[r];
            bi[r] = b1 ? c0 + c + 1 : bi[r];
          } else {
            keep[r] = lane == c - cb ? a0[r] : keep[r];
            keep[r] = two && lane == c + 1 - cb ? a1[r] : keep[r];
          }
        }
      }
      if (!ARGMAX) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = row0 + r;
          if (row < n && lane < ce - cb)
            scores[static_cast<size_t>(row) * c_total + c0 + cb + lane] =
                keep[r] * inv[r];
        }
      }
    }

    if (ARGMAX) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + r;
        if (lane == r && row < n) {
          labels[row] = bi[r];
          if (best_val != nullptr) best_val[row] = best[r];
        }
      }
    }
  }
}

template <int NJ, bool ARGMAX>
cudaError_t launch(const float* x, const float* text, float* scores,
                   int* labels, float* best_val, int n, int d, int c_total,
                   int c0, int nc, int norm_map, int norm_text,
                   int first_chunk, cudaStream_t s) {
  constexpr int R = NJ <= 4 ? 4 : 2;
  auto kern = score_kernel<NJ, R, ARGMAX>;
  const int smem = nc * d * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, THREADS, smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long groups = (static_cast<long long>(n) + R - 1) / R;
  const long long want = (groups + WARPS - 1) / WARPS;
  const int blocks = static_cast<int>(
      want < static_cast<long long>(sms) * per_sm
          ? want : static_cast<long long>(sms) * per_sm);
  kern<<<blocks, THREADS, smem, s>>>(x, text, scores, labels, best_val, n, d,
                                     c_total, c0, nc, norm_map, norm_text,
                                     first_chunk);
  return cudaGetLastError();
}

template <bool ARGMAX>
int dispatch(const void* x, const void* text, void* scores, void* labels,
             void* best_val, int n, int d, int c_total, int c0, int nc,
             int norm_map, int norm_text, int first_chunk, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(text);
  float* sp = static_cast<float*>(scores);
  int* lp = static_cast<int*>(labels);
  float* bp = static_cast<float*>(best_val);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nj = (d + 127) / 128;
  cudaError_t e;
  if (nj <= 1)
    e = launch<1, ARGMAX>(xp, tp, sp, lp, bp, n, d, c_total, c0, nc,
                          norm_map, norm_text, first_chunk, s);
  else if (nj <= 2)
    e = launch<2, ARGMAX>(xp, tp, sp, lp, bp, n, d, c_total, c0, nc,
                          norm_map, norm_text, first_chunk, s);
  else if (nj <= 4)
    e = launch<4, ARGMAX>(xp, tp, sp, lp, bp, n, d, c_total, c0, nc,
                          norm_map, norm_text, first_chunk, s);
  else if (nj <= 8)
    e = launch<8, ARGMAX>(xp, tp, sp, lp, bp, n, d, c_total, c0, nc,
                          norm_map, norm_text, first_chunk, s);
  else
    e = cudaErrorInvalidValue;  // D > 1024: the wrapper refuses it first
  return static_cast<int>(e);
}

}  // namespace

// K8: scores[:, c0:c0+nc] of the (n, c_total) f32 output.
extern "C" int avl_score_features(const void* x, const void* text,
                                  void* scores, int n, int d, int c_total,
                                  int c0, int nc, int norm_map,
                                  int norm_text, void* stream) {
  return dispatch<false>(x, text, scores, nullptr, nullptr, n, d, c_total,
                         c0, nc, norm_map, norm_text, 1, stream);
}

// K7: labels over categories [0, c0+nc); best_val carries the running best
// score between chunks (nullptr when one chunk covers every category).
extern "C" int avl_score_argmax(const void* x, const void* text,
                                void* labels, void* best_val, int n, int d,
                                int c0, int nc, int norm_text,
                                int first_chunk, void* stream) {
  return dispatch<true>(x, text, nullptr, labels, best_val, n, d, 0, c0, nc,
                        0, norm_text, first_chunk, stream);
}
