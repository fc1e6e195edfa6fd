// Hand-written Hopper (sm_90a) kernels for SuperGlue's masked log-domain
// Sinkhorn (models/superglue/model.py: log_optimal_transport).
//
// Replaces no TPU kernel: avlmaps_tpu runs the Sinkhorn as a lax.scan of
// XLA ops (avlmaps_tpu/models/superglue/model.py, log_optimal_transport),
// and the port ran it as a loop of torch ops that, per half-update, wrote
// the 67 MB broadcast sum `couplings + v` and took logsumexp's max, exp
// and sum passes over it.  It is the same arithmetic in f32: u first, then
// v, `iters` times; full-precision expf and logf.
//
// What bounds it on an H100: bytes.  At 4096 keypoints a side the
// coupling is 4097 x 4097 f32 (67 MB, more than the 50 MB L2); each of the
// 200 half-updates has to read it once (20 us at 3.35 TB/s) and does ~12
// instructions an element, a third of the read's time.  So each
// half-update streams the coupling from device memory once and reduces in
// registers: 25-26 us a half-update on an H100, 5.3-5.5 ms a Sinkhorn
// against its 4.03 ms bound (PERF.md).  Rows per block and loads per
// lane were swept (4-32 warps, 2-8 float4, with and without prefetching
// the next chunk): all read 25-28 us.
//
// Design:
//  1. coupling_kernel: one pass over the (B, K0, K1) scores writes the
//     coupling with its dustbin row and column of alpha twice, into `c`
//     (rows of K1 + 1, pitch p1) and transposed into `ct` (rows of K0 + 1,
//     pitch p0), pitches padded to 4 floats.  The v half-update is then the
//     u half-update's row reduction run over ct, and every load is a
//     coalesced 16-byte one.  Pitch padding is never read as data.
//  2. lse_rows_kernel: a warp per row computes
//     out[r] = marg[r] - log(sum_j exp(x[r, j] + w[j])).  Each lane keeps
//     UNROLL float4 loads in flight, takes the chunk's max, rescales its
//     running sum when the max grows and adds exp(x + w - max); the lanes'
//     (max, sum) pairs merge by shuffles.  w, the other side's potential
//     (16 KB), is read through L1.  Both half-updates sweep their buffer's
//     rows in increasing order with evict-first loads, so each finds the
//     other buffer's tail in L2, not its own head, and reads its 67 MB from
//     device memory.
//  3. assign_kernel: Z = ((c + u) + v) - norm, the contiguous
//     (B, K0 + 1, K1 + 1) log assignment, in the torch loop's order.
// avl_sinkhorn launches all 2 * iters + 2 kernels on one stream from one
// host call.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;
constexpr int TILE_ROWS = 8;
constexpr int LSE_WARPS = 16;  // rows a block
constexpr int UNROLL = 4;      // float4 loads a lane keeps in flight
constexpr int Z_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(TILE * TILE_ROWS)
coupling_kernel(const float* __restrict__ scores,
                const float* __restrict__ alpha, float* __restrict__ c,
                float* __restrict__ ct, int m, int n, int p0, int p1) {
  __shared__ float tile[TILE][TILE + 1];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  const float a = __ldg(alpha);
  const float* s = scores + static_cast<size_t>(b) * m * n;
  float* cb = c + static_cast<size_t>(b) * (m + 1) * p1;
  float* ctb = ct + static_cast<size_t>(b) * (n + 1) * p0;
  for (int r = threadIdx.y; r < TILE; r += TILE_ROWS) {
    const int i = i0 + r, j = j0 + threadIdx.x;
    if (i <= m && j <= n) {
      const float v = (i < m && j < n) ? s[static_cast<size_t>(i) * n + j]
                                       : a;
      cb[static_cast<size_t>(i) * p1 + j] = v;
      tile[r][threadIdx.x] = v;
    }
  }
  __syncthreads();
  for (int r = threadIdx.y; r < TILE; r += TILE_ROWS) {
    const int j = j0 + r, i = i0 + threadIdx.x;
    if (i <= m && j <= n)
      ctb[static_cast<size_t>(j) * p0 + i] = tile[threadIdx.x][r];
  }
}

// x: (B, rows, pitch) with `cols` valid columns; w: (B, pitch); marg:
// (B, rows); out: (B, out_pitch).
__global__ void __launch_bounds__(LSE_WARPS * 32)
lse_rows_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ marg, float* __restrict__ out,
                int rows, int cols, int pitch, int out_pitch) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * LSE_WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp: r is the warp's
  const int b = blockIdx.y;
  const float4* xr = reinterpret_cast<const float4*>(
      x + (static_cast<size_t>(b) * rows + r) * pitch);
  const float4* wb = reinterpret_cast<const float4*>(
      w + static_cast<size_t>(b) * pitch);
  const int n4 = (cols + 3) >> 2;
  float mx = -INFINITY, sum = 0.0f;
  for (int base = lane; base < n4; base += 32 * UNROLL) {
    float4 xv[UNROLL], wv[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int q = base + 32 * k;
      xv[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      wv[k] = xv[k];
      if (q < n4) {
        xv[k] = __ldcs(xr + q);
        wv[k] = __ldg(wb + q);
      }
    }
    // element e of load k is column 4 (base + 32 k) + e; past `cols` it
    // counts as exp(-inf) = 0.  k = 0, e = 0 is always a column, so the
    // chunk's max is finite.
    float v[4 * UNROLL];
    float cm = -INFINITY;
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int j = 4 * (base + 32 * k);
      v[4 * k + 0] = j + 0 < cols ? xv[k].x + wv[k].x : -INFINITY;
      v[4 * k + 1] = j + 1 < cols ? xv[k].y + wv[k].y : -INFINITY;
      v[4 * k + 2] = j + 2 < cols ? xv[k].z + wv[k].z : -INFINITY;
      v[4 * k + 3] = j + 3 < cols ? xv[k].w + wv[k].w : -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) cm = fmaxf(cm, v[4 * k + e]);
    }
    if (cm > mx) {
      sum *= expf(mx - cm);
      mx = cm;
    }
#pragma unroll
    for (int e = 0; e < 4 * UNROLL; ++e) sum += expf(v[e] - mx);
  }
  // merge the lanes' (max, sum); a lane past the row's end holds
  // (-inf, 0), and equal maxes skip the exp so -inf - -inf never occurs
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(FULL, mx, off);
    const float so = __shfl_xor_sync(FULL, sum, off);
    const float top = fmaxf(mx, mo);
    sum = (mx == top ? sum : sum * expf(mx - top))
          + (mo == top ? so : so * expf(mo - top));
    mx = top;
  }
  if (lane == 0)
    out[static_cast<size_t>(b) * out_pitch + r] =
        marg[static_cast<size_t>(b) * rows + r] - (logf(sum) + mx);
}

__global__ void __launch_bounds__(Z_THREADS)
assign_kernel(const float* __restrict__ c, const float* __restrict__ u,
              const float* __restrict__ v, const float* __restrict__ norm,
              float* __restrict__ z, int m1, int n1, int p0, int p1) {
  const int i = blockIdx.x, b = blockIdx.y;
  const float* cr = c + (static_cast<size_t>(b) * m1 + i) * p1;
  const float* vb = v + static_cast<size_t>(b) * p1;
  const float ui = u[static_cast<size_t>(b) * p0 + i];
  const float nb = norm[b];
  float* zr = z + (static_cast<size_t>(b) * m1 + i) * n1;
  for (int j = threadIdx.x; j < n1; j += Z_THREADS)
    __stcs(zr + j, ((__ldcs(cr + j) + ui) + __ldg(vb + j)) - nb);
}

}  // namespace

// scores (b, m, n) f32, alpha one f32; log_mu (b, m + 1), log_nu
// (b, n + 1), norm (b,); u (b, p0) and v (b, p1) hold the potentials, v
// its start on entry; c (b, m + 1, p1) and ct (b, n + 1, p0) are scratch;
// z (b, m + 1, n + 1) receives the log assignment.  p0 >= m + 1 and
// p1 >= n + 1 are multiples of 4; u, v, c and ct start on 16 bytes.
extern "C" int avl_sinkhorn(const void* scores, const void* alpha,
                            const void* log_mu, const void* log_nu,
                            const void* norm, void* u, void* v, void* c,
                            void* ct, void* z, int b, int m, int n, int p0,
                            int p1, int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m1 = m + 1, n1 = n + 1;
  float* cf = static_cast<float*>(c);
  float* ctf = static_cast<float*>(ct);
  float* uf = static_cast<float*>(u);
  float* vf = static_cast<float*>(v);
  coupling_kernel<<<dim3((n1 + TILE - 1) / TILE, (m1 + TILE - 1) / TILE, b),
                    dim3(TILE, TILE_ROWS), 0, s>>>(
      static_cast<const float*>(scores), static_cast<const float*>(alpha),
      cf, ctf, m, n, p0, p1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_u((m1 + LSE_WARPS - 1) / LSE_WARPS, b);
  const dim3 grid_v((n1 + LSE_WARPS - 1) / LSE_WARPS, b);
  for (int it = 0; it < iters; ++it) {
    lse_rows_kernel<<<grid_u, LSE_WARPS * 32, 0, s>>>(
        cf, vf, static_cast<const float*>(log_mu), uf, m1, n1, p1, p0);
    lse_rows_kernel<<<grid_v, LSE_WARPS * 32, 0, s>>>(
        ctf, uf, static_cast<const float*>(log_nu), vf, n1, m1, p0, p1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  assign_kernel<<<dim3(m1, b), Z_THREADS, 0, s>>>(
      cf, uf, vf, static_cast<const float*>(norm), static_cast<float*>(z),
      m1, n1, p0, p1);
  return static_cast<int>(cudaGetLastError());
}
