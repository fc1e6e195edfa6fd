// Hand-written Hopper (sm_90a) kernel for the voxel-fusion accumulate.
//
// Replaces two Pallas kernels of avlmaps_tpu/ops/segment_scatter.py, both
// "for rows sorted by ascending slot, accum[slot[k]] += row[k]":
//   K4 sorted_segment_scatter_add_split (body _kernel_rle_split): the row is
//      built from its parts, concat(w[k] * float(feat[k]), aux[k]);
//   K5 sorted_segment_scatter_add (bodies _kernel_rle, _kernel): the row is
//      one pre-assembled f32 update.
// One template serves both: ASSEMBLED selects how a row is read.
//
// What bounds it on an H100: bytes.  Each call reads the sorted rows once
// (features f32 or bf16, weights and aux columns, or the assembled f32
// update) and read-modify-writes one W-wide f32 row per UNIQUE slot, with a
// handful of flops per byte, so the 3.35 TB/s of device memory is the limit.
//
// Design: slots ascend, so the rows of one slot form one contiguous run and
// runs never overlap -- no atomics.  The wrapper marks run starts with plain
// torch (slots[k] != slots[k-1]); one warp takes one run: it sums the run's
// rows in f32, in row order, with lane i owning columns i, i+32, ... of a
// 1024-column chunk (coalesced row reads), then does ONE read-modify-write
// of accum[slot] for the chunk; wider assembled rows loop over chunks.  The
// split mode keeps K4's warp-uniform column groups (its route guarantees
// widths that are multiples of 32, up to 1024): with a bounds check per
// column it ran at half the speed on an H100 (0.48 against 0.25 ms at the
// map-building batch of 31,104 rows).  Both modes add
// the same f32 values in the same order -- the split mode multiplies with
// __fmul_rn, so no FMA contraction folds the product into the sum -- and
// give bitwise-equal rows for the same batch.  Warps of non-start rows exit
// at once.  Rows of ``skip_slot`` (the wrapper passes the trash slot when
// the accumulator has capacity + 1 rows, as the TPU kernels discard it, else
// -1) are not accumulated: every invalid point of a batch sorts into that
// one run, often half the batch, and summing it would serialise one warp
// over thousands of rows.  The TPU kernel's 8-row window DMA, SMEM word
// packing and row budget are artefacts of Mosaic and are dropped.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAXC = 32;  // columns per lane and chunk: 32 * 32 = 1024
constexpr int CHUNK = 32 * MAXC;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ASSEMBLED: ``feats`` is the (B, wd) f32 update, any width, and w/aux
// are unused.  Otherwise the row is [w * feats (B, d) | aux (B, wd - d)]
// with d and wd multiples of 32 and wd <= CHUNK (the wrapper's route rule),
// so each lane's column groups are warp-uniform and one chunk holds the
// row: the accumulators stay in registers without per-column bounds.
template <typename FT, bool ASSEMBLED>
__global__ void __launch_bounds__(THREADS)
segment_scatter_kernel(float* __restrict__ accum,
                       const int* __restrict__ slots,
                       const uint8_t* __restrict__ start,
                       const FT* __restrict__ feats,
                       const float* __restrict__ w,
                       const float* __restrict__ aux, int b, int d, int wd,
                       int skip_slot) {
  const int k = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= b || !start[k]) return;
  const int slot = slots[k];
  if (slot == skip_slot) return;  // the trash run: contents unspecified
  int end = k + 1;
  while (end < b && !start[end]) ++end;
  float* dst = accum + static_cast<size_t>(slot) * wd;

  if (ASSEMBLED) {
    for (int c0 = 0; c0 < wd; c0 += CHUNK) {
      float acc[MAXC];
#pragma unroll
      for (int i = 0; i < MAXC; ++i) acc[i] = 0.f;
#pragma unroll 2
      for (int r = k; r < end; ++r) {
        const FT* ur = feats + static_cast<size_t>(r) * wd;
#pragma unroll
        for (int i = 0; i < MAXC; ++i) {
          const int col = c0 + i * 32 + lane;
          if (col < wd) acc[i] += to_f32(ur[col]);
        }
      }
#pragma unroll
      for (int i = 0; i < MAXC; ++i) {
        const int col = c0 + i * 32 + lane;
        if (col < wd) dst[col] += acc[i];
      }
    }
    return;
  }

  const int nfeat = d / 32, ncol = wd / 32, aw = wd - d;
  float acc[MAXC];
#pragma unroll
  for (int i = 0; i < MAXC; ++i) acc[i] = 0.f;
#pragma unroll 2
  for (int r = k; r < end; ++r) {
    const float wr = w[r];
    const FT* fr = feats + static_cast<size_t>(r) * d;
    const float* ar = aux + static_cast<size_t>(r) * aw;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      if (i < nfeat)
        acc[i] += __fmul_rn(wr, to_f32(fr[i * 32 + lane]));
      else if (i < ncol)
        acc[i] += ar[(i - nfeat) * 32 + lane];
    }
  }
#pragma unroll
  for (int i = 0; i < MAXC; ++i)
    if (i < ncol) dst[i * 32 + lane] += acc[i];
}

template <typename FT, bool ASSEMBLED>
int launch(void* accum, const void* slots, const void* start,
           const void* feats, const void* w, const void* aux, int b, int d,
           int wd, int skip_slot, void* stream) {
  const int blocks = (b + THREADS / 32 - 1) / (THREADS / 32);
  segment_scatter_kernel<FT, ASSEMBLED>
      <<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<float*>(accum), static_cast<const int*>(slots),
          static_cast<const uint8_t*>(start), static_cast<const FT*>(feats),
          static_cast<const float*>(w), static_cast<const float*>(aux), b, d,
          wd, skip_slot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4: accum[slot[k]] += concat(w[k] * feat[k], aux[k]).
extern "C" int avl_segment_scatter_add_split(void* accum, const void* slots,
                                             const void* start,
                                             const void* feats, int feat_bf16,
                                             const void* w, const void* aux,
                                             int b, int d, int wd,
                                             int skip_slot, void* stream) {
  if (feat_bf16)
    return launch<__nv_bfloat16, false>(accum, slots, start, feats, w, aux, b,
                                        d, wd, skip_slot, stream);
  return launch<float, false>(accum, slots, start, feats, w, aux, b, d, wd,
                              skip_slot, stream);
}

// K5: accum[slot[k]] += update[k].
extern "C" int avl_segment_scatter_add(void* accum, const void* slots,
                                       const void* start, const void* update,
                                       int b, int wd, int skip_slot,
                                       void* stream) {
  return launch<float, true>(accum, slots, start, update, nullptr, nullptr, b,
                             wd, wd, skip_slot, stream);
}
