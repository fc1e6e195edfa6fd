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
// In the map builds' steps a run is short (1.4-1.6 rows on average, at most
// 11; the smoke's synthetic batch 5.2, at most 17) and two thirds of the
// rows are the trash run, so the read-modify-write of accum is half the
// bytes and the rows the other half.
//
// Design: slots ascend, so the rows of one slot form one contiguous run and
// runs never overlap -- no atomics.  One launch, no scratch tensor:
// - a CTA of 4 warps takes TILE = 32 consecutive rows, loads slots[t0 - 1,
//   t1) into shared memory and lists the rows that start a run (k == 0 or
//   slots[k] != slots[k-1]) with a ballot and a prefix count.  A run
//   belongs to the tile it starts in; the end of the tile's last run is
//   found past the tile by a 32-way galloping search.  A tile that lies
//   wholly inside the ``skip_slot`` run exits after its slot load.
// - the CTA's warps take the listed runs in turn.  A run longer than
//   SPLIT_ROWS is cut into column slices (one 128-column group each), one
//   warp a slice; never into rows, so each column is still summed in row
//   order by one thread.
// - a lane owns 4 contiguous columns of each 128-column group: f32 rows,
//   aux and the accum row move as float4, bf16 features 4 at a time (8
//   bytes).  A width that is not a multiple of 4, or a pointer that is not
//   aligned for that, takes the same code with one column a lane (V = 1).
//   The accum row is read before the run's rows, so both reads are in
//   flight together.
// Small tiles keep many short runs in flight: a run is one or two rows, so
// a warp's loads are one accum row and a row or two, and the card needs
// thousands of warps' loads in flight to reach its bandwidth.  On one H100
// (probes/scatter_pieces.py) tiles of 32 rows on 4 warps beat 64 or 128
// rows on 4 or 8 warps by up to 1.7x on the map builds' steps, and staging
// the rows in shared memory with cp.async.bulk (probes/scatter_pieces.cu)
// was slower than these 128-bit loads for f32 rows.
//
// Each column's f32 sum runs in row order from 0, then ONE accum[slot] +=
// sum, so both modes give the same bits; the split mode multiplies with
// __fmul_rn, so no FMA contraction folds the product into the sum.  Rows of
// ``skip_slot`` (the wrapper passes the trash slot when the accumulator has
// capacity + 1 rows, as the TPU kernels discard it, else -1) are not
// accumulated.  The TPU kernel's 8-row window DMA, SMEM word packing and
// row budget are artefacts of Mosaic and are dropped.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Tile, CTA size and rows in flight a warp: probes/scatter_pieces.py
// builds other values with -D to time them; these are the fastest it
// measured.
#ifndef AVL_SCATTER_THREADS
#define AVL_SCATTER_THREADS 128
#endif
#ifndef AVL_SCATTER_TILE
#define AVL_SCATTER_TILE 32
#endif
constexpr int THREADS = AVL_SCATTER_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = AVL_SCATTER_TILE;  // rows a CTA owns runs in
static_assert(TILE % 32 == 0 && TILE <= THREADS, "a lane per tile row");
// Runs longer than this are split into column slices.  The map builds'
// runs are at most 11 rows long (17 in the smoke's synthetic batch;
// probes/scatter_pieces.py), so only an unusual batch -- a few voxels
// taking a whole batch's points -- pays for the split.
constexpr int SPLIT_ROWS = 32;
#ifndef AVL_SCATTER_ROW_UNROLL
#define AVL_SCATTER_ROW_UNROLL 2
#endif
constexpr int ROW_UNROLL = AVL_SCATTER_ROW_UNROLL;  // rows in flight a warp

// The rows: read once, so streamed past the caches (__ldcs).
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

// 4 bf16 -> 4 f32 (exact: a bf16 is the high half of its f32)
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float ld1(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Column values a lane owns in one group: V = 4 (float4) or 1.
template <int V>
struct Cols {
  float v[V];
};

// The accum row: a cached load, as it is written back.
template <int V>
__device__ __forceinline__ Cols<V> load_plain(const float* p) {
  Cols<V> c;
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    c.v[0] = q.x; c.v[1] = q.y; c.v[2] = q.z; c.v[3] = q.w;
  } else {
    c.v[0] = *p;
  }
  return c;
}

template <int V, typename T>
__device__ __forceinline__ Cols<V> load_cols(const T* p) {
  Cols<V> c;
  if constexpr (V == 4) {
    const float4 q = ld4(p);
    c.v[0] = q.x; c.v[1] = q.y; c.v[2] = q.z; c.v[3] = q.w;
  } else {
    c.v[0] = ld1(p);
  }
  return c;
}

// accum[slot] += the sum of rows [r0, r1) in column groups [g0, g1) (a
// group is 32 * V columns), NG groups a pass held in registers.  One warp.
//
// Each group's source (feature, aux or assembled columns) and row stride
// are fixed before the row loop, and a group the lane does not own reads
// the pass's first column instead (a line its neighbours read anyway) and
// is never stored: a row's loads are then unconditional and issue back to
// back.  With a branch around each load and its product, the compiler
// waited for each load in turn (2x the time on an H100).
template <typename FT, bool ASSEMBLED, int V, int NG>
__device__ __forceinline__ void sum_run(float* __restrict__ accum,
                                        const FT* __restrict__ feats,
                                        const float* __restrict__ w,
                                        const float* __restrict__ aux, int r0,
                                        int r1, int slot, int d, int wd,
                                        int g0, int g1, int lane) {
  constexpr int GW = 32 * V;
  constexpr bool ONE_ARRAY = ASSEMBLED || sizeof(FT) == 4;
  using Src = typename std::conditional<ONE_ARRAY, float, FT>::type;
  float* dst = accum + static_cast<size_t>(slot) * wd;
  for (int ga = g0; ga < g1; ga += NG) {
    Cols<V> acc[NG], old[NG];
    const Src* fsrc[NG];    // row 0's feature (or assembled) columns
    const float* asrc[NG];  // row 0's aux columns (bf16 features only)
    int stride[NG];
    bool on[NG], feat[NG];
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      on[i] = ga + i < g1 && (ga + i) * GW + lane * V < wd;
      const int col = on[i] ? (ga + i) * GW + lane * V : ga * GW;
      feat[i] = !ASSEMBLED && col < d;  // d % V == 0: all V or none
      const Src* f = reinterpret_cast<const Src*>(feats);
      fsrc[i] = ASSEMBLED || feat[i] ? f + col
                : ONE_ARRAY ? reinterpret_cast<const Src*>(aux) + (col - d)
                            : f;
      if constexpr (!ONE_ARRAY) asrc[i] = aux + (col - d);  // aux groups
      stride[i] = ASSEMBLED ? wd : feat[i] ? d : wd - d;
#pragma unroll
      for (int j = 0; j < V; ++j) acc[i].v[j] = 0.f;
      old[i] = load_plain<V>(dst + col);  // in flight with the rows
    }
#pragma unroll ROW_UNROLL
    for (int r = r0; r < r1; ++r) {
      const float wr = ASSEMBLED ? 0.f : __ldg(w + r);
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        Cols<V> c;
        if constexpr (ONE_ARRAY) {
          c = load_cols<V>(fsrc[i] + static_cast<size_t>(r) * stride[i]);
        } else {  // bf16 features (off the main path): one array or the other
          c = feat[i] ? load_cols<V>(fsrc[i] + static_cast<size_t>(r) * d)
                      : load_cols<V>(asrc[i] +
                                     static_cast<size_t>(r) * (wd - d));
        }
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[i].v[j] += feat[i] ? __fmul_rn(wr, c.v[j]) : c.v[j];
      }
    }
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      if (!on[i]) continue;
      const int col = (ga + i) * GW + lane * V;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(dst + col) =
            make_float4(old[i].v[0] + acc[i].v[0], old[i].v[1] + acc[i].v[1],
                        old[i].v[2] + acc[i].v[2], old[i].v[3] + acc[i].v[3]);
      } else {
        dst[col] = old[i].v[0] + acc[i].v[0];
      }
    }
  }
}

// The first row at or after ``lo`` whose slot is not ``s`` (slots ascend
// from a row holding s), or b.  One warp: 32 probes a round, the stride
// growing 32-fold until a probe leaves the run, then shrinking 32-fold
// inside the last stride; a run ending within 32 rows takes one round.
__device__ __forceinline__ int run_end(const int* __restrict__ slots, int lo,
                                       int b, int s, int lane) {
  int hi = b;  // rows at or past hi are outside the run
  long long step = 1;
  bool gallop = true;
  while (lo < hi) {
    if (!gallop) step = (hi - lo + 31) / 32;
    const long long p = lo + lane * step;
    const bool out = p >= hi || __ldg(slots + p) != s;
    const unsigned m = __ballot_sync(0xffffffffu, out);
    if (m == 0) {  // all 32 probes inside: the run goes on past them
      lo = static_cast<int>(lo + 31 * step + 1);
      if (gallop) step *= 32;
      continue;
    }
    const int f = __ffs(m) - 1;
    if (f == 0) return lo;
    hi = static_cast<int>(lo + f * step < hi ? lo + f * step : hi);
    lo = static_cast<int>(lo + (f - 1) * step + 1);
    gallop = false;
  }
  return lo;
}

// A tile's runs, in shared memory.
struct TileRuns {
  int slot[TILE + 1];  // slots[t0 - 1, t1)
  int start[TILE];     // the tile rows (from t0) that start a run, in order
  int count[TILE / 32];
  int last_end;        // the end of the last listed run, maybe past t1
};

// Lists the runs that start in rows [t0, t1) and returns their count, or 0
// when the tile has nothing to add: it lies wholly inside the skip run, or
// inside a run that started in an earlier tile.  Every thread calls it and
// gets the same count.
__device__ __forceinline__ int list_runs(TileRuns& t,
                                         const int* __restrict__ slots,
                                         int t0, int t1, int b,
                                         int skip_slot) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i <= t1 - t0; i += THREADS)
    t.slot[i] = t0 + i > 0 ? __ldg(slots + t0 - 1 + i) : 0;
  __syncthreads();
  if (t.slot[1] == skip_slot && t.slot[t1 - t0] == skip_slot) return 0;

  // a ballot a warp of rows, then prefix counts
  bool start = false;
  unsigned mask = 0;
  if (warp < TILE / 32) {
    const int i = warp * 32 + lane;
    start = t0 + i < t1 && (t0 + i == 0 || t.slot[i + 1] != t.slot[i]);
    mask = __ballot_sync(0xffffffffu, start);
    if (lane == 0) t.count[warp] = __popc(mask);
  }
  __syncthreads();
  int n = 0, before = 0;
#pragma unroll
  for (int i = 0; i < TILE / 32; ++i) {
    before += i < warp ? t.count[i] : 0;
    n += t.count[i];
  }
  if (start)
    t.start[before + __popc(mask & ((1u << lane) - 1))] = warp * 32 + lane;
  if (n == 0) return 0;
  if (warp == 0) {
    const int e = run_end(slots, t1, b, t.slot[t1 - t0], lane);
    if (lane == 0) t.last_end = e;
  }
  __syncthreads();
  return n;
}

// Calls f(r0, r1, slot, g0, g1) for this warp's share of the tile's work:
// the listed runs in turn, one item a run, or one a column group for a run
// longer than SPLIT_ROWS; the skip run is left out.
template <typename F>
__device__ __forceinline__ void for_each_item(const TileRuns& t, int n, int t0,
                                              int groups, int skip_slot,
                                              F&& f) {
  const int warp = threadIdx.x >> 5;
  int item = 0;
  for (int j = 0; j < n; ++j) {
    const int i0 = t.start[j];
    const int slot = t.slot[i0 + 1];
    const int r0 = t0 + i0;
    const int r1 = j + 1 < n ? t0 + t.start[j + 1] : t.last_end;
    if (slot == skip_slot) continue;
    if (r1 - r0 <= SPLIT_ROWS) {
      if (item++ % WARPS == warp) f(r0, r1, slot, 0, groups);
    } else {
      for (int g = 0; g < groups; ++g)
        if (item++ % WARPS == warp) f(r0, r1, slot, g, g + 1);
    }
  }
}

template <typename FT, bool ASSEMBLED, int V, int NG>
__global__ void __launch_bounds__(THREADS)
segment_scatter_kernel(float* __restrict__ accum,
                       const int* __restrict__ slots,
                       const FT* __restrict__ feats,
                       const float* __restrict__ w,
                       const float* __restrict__ aux, int b, int d, int wd,
                       int skip_slot) {
  __shared__ TileRuns t;
  const int t0 = blockIdx.x * TILE;
  const int t1 = min(t0 + TILE, b);
  const int n = list_runs(t, slots, t0, t1, b, skip_slot);
  if (n == 0) return;
  const int lane = threadIdx.x & 31;
  for_each_item(t, n, t0, (wd + 32 * V - 1) / (32 * V), skip_slot,
                [&](int r0, int r1, int slot, int g0, int g1) {
                  sum_run<FT, ASSEMBLED, V, NG>(accum, feats, w, aux, r0, r1,
                                                slot, d, wd, g0, g1, lane);
                });
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename FT, bool ASSEMBLED>
int launch(void* accum, const void* slots, const void* feats, const void* w,
           const void* aux, int b, int d, int wd, int skip_slot,
           void* stream) {
  if (b <= 0) return 0;
  const bool vec = d % 4 == 0 && wd % 4 == 0 && aligned(accum, 16) &&
                   aligned(feats, 4 * sizeof(FT)) &&
                   (ASSEMBLED || aligned(aux, 16));
  // the map builds' rows (W = 640) take five float4 groups a lane; wider
  // rows eight a pass, as does one column a lane
  auto* kernel = !vec       ? segment_scatter_kernel<FT, ASSEMBLED, 1, 8>
                 : wd <= 640 ? segment_scatter_kernel<FT, ASSEMBLED, 4, 5>
                             : segment_scatter_kernel<FT, ASSEMBLED, 4, 8>;
  kernel<<<(b + TILE - 1) / TILE, THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(accum), static_cast<const int*>(slots),
      static_cast<const FT*>(feats), static_cast<const float*>(w),
      static_cast<const float*>(aux), b, d, wd, skip_slot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4: accum[slot[k]] += concat(w[k] * feat[k], aux[k]).
extern "C" int avl_segment_scatter_add_split(void* accum, const void* slots,
                                             const void* feats, int feat_bf16,
                                             const void* w, const void* aux,
                                             int b, int d, int wd,
                                             int skip_slot, void* stream) {
  if (feat_bf16)
    return launch<__nv_bfloat16, false>(accum, slots, feats, w, aux, b, d,
                                        wd, skip_slot, stream);
  return launch<float, false>(accum, slots, feats, w, aux, b, d, wd,
                              skip_slot, stream);
}

// K5: accum[slot[k]] += update[k].
extern "C" int avl_segment_scatter_add(void* accum, const void* slots,
                                       const void* update, int b, int wd,
                                       int skip_slot, void* stream) {
  return launch<float, true>(accum, slots, update, nullptr, nullptr, b, wd,
                             wd, skip_slot, stream);
}
