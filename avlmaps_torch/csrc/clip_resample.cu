// Hand-written Hopper (sm_90a) kernel for CLIP's image preprocess.
//
// Replaces no TPU kernel: the JAX package, like the port's CPU path,
// preprocesses on the host with PIL (models/clip/model.py,
// preprocess_images), and the area map's build waited on it.  It computes
// exactly what PIL does for an 8-bit RGB frame: Resample.c's bicubic
// resize of the short side to `size` (horizontal pass, then a vertical
// pass over its uint8 result), the centre crop, then (v / 255 - mean) /
// std in IEEE f32.  The coefficient tables come from the host
// (ops/clip_resample.py: crop_tables), built in doubles as PIL builds them
// and rounded to fixed point with 22 fraction bits; here every sum is
// int32, starts at 1 << 21 and is rounded by clip8 after each pass, so the
// bytes are PIL's.  Only the cropped outputs are computed: each output
// depends on its own taps alone.  The normalise uses the _rn intrinsics,
// so no flag or contraction can change its rounding.
//
// What bounds it on an H100: bytes in principle.  A batch of 64 720x1080
// frames reads the 720 x 730 input pixels under the crop's taps, 101 MB,
// and writes 38.5 MB of f32 (~42 us at 3.35 TB/s); the arithmetic is
// ~0.6 G int32 multiply-adds, each reading a staged byte from shared
// memory, and with the indexing around them the kernel issues
// instructions for about fourteen times the bytes' time (PERF.md).
//
// Design: one block per (frame, band of 16 output rows).  The band's input
// rows are streamed through shared memory `rows` at a time: each row's
// span of the columns the crop reads is staged with 16-byte loads (bytes
// at its unaligned ends), the horizontal pass turns the staged rows into
// uint8 rows of `size` pixels, and each output row of the band adds the
// taps that fall in those rows to its int32 sum, kept in shared memory.
// Integer sums do not depend on their order, so summing a row's taps
// chunk by chunk gives PIL's sum.  At the end each sum is clipped,
// normalised and stored; neighbouring threads store neighbouring floats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PRECISION_BITS = 22;

struct Norm {
  float mean[3];
  float std[3];
};

// Resample.c's clip8: the fixed-point sum to a byte, clamped to 0..255.
__device__ __forceinline__ int clip8(int v) {
  v >>= PRECISION_BITS;
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// tab: horizontal bounds (size x {first column, taps}), vertical bounds
// (size x {first row, taps}), horizontal weights tap-major (kh x size, so a
// warp's columns read one line), vertical weights (size x kv), all int32.
__global__ void __launch_bounds__(THREADS)
clip_resample_kernel(const uint8_t* __restrict__ src, float* __restrict__ out,
                     const int* __restrict__ tab, int h, int w, int size,
                     int kh, int kv, int band, int rows, int pitch,
                     Norm norm) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int e_n = size * 3;
  int* acc = reinterpret_cast<int*>(smem);
  uint8_t* stage = smem + ((band * e_n * 4 + 15) & ~15);
  uint8_t* hrow = stage + rows * pitch;

  const int* hb = tab;
  const int* vb = hb + 2 * size;
  const int* hk = vb + 2 * size;
  const int* vk = hk + size * kh;

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * band;
  const int nr = min(band, size - r0);
  const size_t row_bytes = static_cast<size_t>(w) * 3;
  const uint8_t* img = src + static_cast<size_t>(blockIdx.y) * h * row_bytes;
  const int x0 = hb[0];
  const int seg = (hb[2 * size - 2] + hb[2 * size - 1] - x0) * 3;
  const int y_lo = vb[2 * r0];
  const int y_hi = vb[2 * (r0 + nr - 1)] + vb[2 * (r0 + nr - 1) + 1];
  const int chunks = pitch / 16;

  for (int q = tid; q < nr * e_n; q += THREADS)
    acc[q] = 1 << (PRECISION_BITS - 1);

  for (int yc = y_lo; yc < y_hi; yc += rows) {
    const int ny = min(rows, y_hi - yc);
    // 1. Stage: row ry's byte p of the span lands at head + p of its slot,
    //    where head is the span's start modulo 16, so every whole 16-byte
    //    chunk of device memory lands on a 16-byte slot.
    for (int q = tid; q < ny * chunks; q += THREADS) {
      const int ry = q / chunks, k = q - ry * chunks;
      const uint8_t* g = img + static_cast<size_t>(yc + ry) * row_bytes
                         + x0 * 3;
      const int lo = k * 16 - static_cast<int>(
          reinterpret_cast<uintptr_t>(g) & 15);
      uint8_t* s = stage + ry * pitch + k * 16;
      if (lo >= 0 && lo + 16 <= seg) {
        *reinterpret_cast<uint4*>(s) =
            __ldg(reinterpret_cast<const uint4*>(g + lo));
      } else {
        for (int j = 0; j < 16; ++j) {
          const int p = lo + j;
          if (p >= 0 && p < seg) s[j] = g[p];
        }
      }
    }
    __syncthreads();
    // 2. Horizontal pass of the staged rows, rounded to bytes.
    for (int q = tid; q < ny * size; q += THREADS) {
      const int ry = q / size, c = q - ry * size;
      const uint8_t* g = img + static_cast<size_t>(yc + ry) * row_bytes
                         + x0 * 3;
      const int head = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
      const uint8_t* s = stage + ry * pitch + head + (hb[2 * c] - x0) * 3;
      const int n = hb[2 * c + 1];
      int s0 = 1 << (PRECISION_BITS - 1), s1 = s0, s2 = s0;
      for (int x = 0; x < n; ++x) {
        const int kx = hk[x * size + c];
        s0 += s[3 * x] * kx;
        s1 += s[3 * x + 1] * kx;
        s2 += s[3 * x + 2] * kx;
      }
      uint8_t* o = hrow + ry * e_n + c * 3;
      o[0] = static_cast<uint8_t>(clip8(s0));
      o[1] = static_cast<uint8_t>(clip8(s1));
      o[2] = static_cast<uint8_t>(clip8(s2));
    }
    __syncthreads();
    // 3. Vertical pass: each output value adds the taps in these rows.
    for (int q = tid; q < nr * e_n; q += THREADS) {
      const int r = q / e_n, e = q - r * e_n;
      const int ymin = vb[2 * (r0 + r)];
      const int lo = max(ymin, yc);
      const int hi = min(ymin + vb[2 * (r0 + r) + 1], yc + ny);
      if (lo >= hi) continue;
      const int* k = vk + (r0 + r) * kv;
      int sum = 0;
      for (int y = lo; y < hi; ++y)
        sum += hrow[(y - yc) * e_n + e] * k[y - ymin];
      acc[q] += sum;
    }
    __syncthreads();
  }

  // 4. Round, normalise in IEEE f32 and store the band's rows.
  float* o = out + (static_cast<size_t>(blockIdx.y) * size + r0) * e_n;
  for (int q = tid; q < nr * e_n; q += THREADS) {
    const int ch = q % 3;
    const float mean = ch == 0 ? norm.mean[0]
                       : (ch == 1 ? norm.mean[1] : norm.mean[2]);
    const float std = ch == 0 ? norm.std[0]
                      : (ch == 1 ? norm.std[1] : norm.std[2]);
    const float v = static_cast<float>(clip8(acc[q]));
    o[q] = __fdiv_rn(__fsub_rn(__fdiv_rn(v, 255.0f), mean), std);
  }
}

}  // namespace

// (b, h, w, 3) uint8 -> (b, size, size, 3) f32 on `stream`; band, rows and
// pitch as ops/clip_resample.py::_launch_shape picks them.
extern "C" int avl_clip_resample(const void* src, void* out,
                                 const void* tables, int b, int h, int w,
                                 int size, int kh, int kv, int band, int rows,
                                 int pitch, float mean0, float mean1,
                                 float mean2, float std0, float std1,
                                 float std2, void* stream) {
  const int smem = ((band * size * 3 * 4 + 15) & ~15)
                   + rows * (pitch + size * 3);
  cudaError_t err = cudaFuncSetAttribute(
      clip_resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Norm norm = {{mean0, mean1, mean2}, {std0, std1, std2}};
  const dim3 grid((size + band - 1) / band, b);
  clip_resample_kernel<<<grid, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<float*>(out),
      static_cast<const int*>(tables), h, w, size, kh, kv, band, rows, pitch,
      norm);
  return static_cast<int>(cudaGetLastError());
}
