// One-pass shear warp (the train-augmentation affine warp) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel rsgnet_tpu/ops/pallas/shear_warp.py::_kernel
// (entry points shear_warp_pallas / shear_warp_pallas_dp). Its plain PyTorch
// version is rsgnet_tpu_torch/ops/shear_warp.py::shear_warp_reference; the
// Python wrapper is rsgnet_tpu_torch/ops/cuda/shear_warp.py, and the
// positions come from ops/shear_warp.py::shear_prepare.
//
// For sample b, with positions p_a (out_w), s_a (S), p_b (out_h), s_b
// (out_w) and the frame flag swap[b], the two 1-D passes are
//   I(r, x, c)      = sum_i wA_i(p_a[x], s_a[r])
//                           * X[r, floor(p_a[x]) + floor(s_a[r]) + i, c]
//   out[b, c, y, x] = sum_j wB_j(p_b[y], s_b[x])
//                           * I(floor(p_b[y]) + floor(s_b[x]) + j, x, c)
// with w0 = max(0, 1 - phi), w2 = max(0, phi - 1), w1 = 1 - w0 - w2,
// phi = frac(p) + frac(s), each sum started at 0 and taken over taps 0, 1, 2
// in that order, and a tap whose index falls outside [0, S) skipped (it
// counts 0 in the plain version). X is the (S, S, C) source, or its
// transpose when swap[b]: a swap of the row and column strides, not a copy.
// The source is read in its own type (uint8 or fp32).
//
// Bound on an H100 (3.35 TB/s): memory. At the train shape (32, 640, 640, 3)
// uint8 -> (32, 3, 256, 192) fp32 the warp must write the 18.9 MB output
// and read the source pixels it depends on, 13.2 MB of the 39.3 MB batch on
// the augmentation matrices: 32.1 MB, about 9.6 us
// (chip_smoke.py::shear_bound_ms counts it on each run's matrices). The
// arithmetic, a few dozen fp32 operations per output element, is far below
// the card's peak rate, yet issuing it is what the kernel spends its time
// on above the bound: per output pixel, four sets of tap weights and
// indices, the loads of 27 taps (nine words for a uint8 RGB source) and 27
// separately rounded multiply-adds (PERF.md, section 6).
//
// Design: one kernel, one thread per output pixel (y, x) for all C
// channels, on TILE_W x TILE_H tiles of one sample, neighbouring threads on
// neighbouring x so the NCHW stores coalesce. The thread evaluates pass A
// only at the (at most three) rows r its pass-B taps reach, straight from
// the source: 9 taps per channel, no intermediate in device memory, and no
// pass-A work on rows no output reaches. Each I(r, x, c) is computed with
// the same operations in the same order as the plain version's stored
// intermediate, so the result has the same bits. The source footprint fits
// the 50 MB L2, so taps that neighbouring threads and rows read again come
// from L1 or L2. Index math: the grid is (sample, tile x, tile y), so no
// thread divides; tap indices are found in fp32 and 32-bit integers (see
// first_tap), with a 64-bit base pointer per sample and 32-bit offsets
// inside it (the wrapper refuses S * S * C or C * out_h * out_w beyond 31
// bits). A uint8 RGB source is read in aligned 32-bit words: a row's three
// taps in the untransposed frame are 9 adjacent bytes, three words. Built
// with -fmad=false, so every multiply and add rounds as in the plain
// version.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_W 32
#define TILE_H 4

// Weights w_j of the three taps at p + s, phi = frac(p) + frac(s), in the
// plain version's operation order (pf = floor(p)). Returns the first tap's
// index floor(p) + floor(s), clamped to [-4, S]: every tap of a clamped
// index is outside [0, S) as the unclamped one's, so the clamp changes
// nothing. The sum is taken in fp32, where it is exact whenever it lies in
// range (two integers whose sum is representable add exactly, and rounding
// keeps a sum outside [-4, S] outside), so no 64-bit integer is needed.
__device__ __forceinline__ int first_tap(float p, float pf, float s, int size,
                                         float* w) {
  const float sf = floorf(s);
  const float phi = (p - pf) + (s - sf);
  w[0] = fmaxf(0.0f, 1.0f - phi);
  w[2] = fmaxf(0.0f, phi - 1.0f);
  w[1] = 1.0f - w[0] - w[2];
  return (int)fminf(fmaxf(pf + sf, -4.0f), (float)size);
}

__device__ __forceinline__ float load_tap(const uint8_t* p) {
  return (float)(*p);
}
__device__ __forceinline__ float load_tap(const float* p) { return *p; }

// The aligned 32-bit word that holds byte p of a uint8 source. Each word
// read below holds a byte of a tap, so none lies outside the source's
// allocation.
__device__ __forceinline__ uint32_t word_at(const uint8_t* p) {
  return __ldg((const uint32_t*)((uintptr_t)p & ~(uintptr_t)3));
}

template <typename T, int CH>
__global__ void __launch_bounds__(TILE_W * TILE_H)
shear_warp_kernel(const T* __restrict__ src, const float* __restrict__ p_a,
                  const float* __restrict__ s_a, const float* __restrict__ p_b,
                  const float* __restrict__ s_b,
                  const uint8_t* __restrict__ swap, float* __restrict__ out,
                  int size, int ch_arg, int out_h, int out_w) {
  const int ch = CH > 0 ? CH : ch_arg;
  const int b = blockIdx.x;
  const int x = blockIdx.y * TILE_W + threadIdx.x;
  const int y = blockIdx.z * TILE_H + threadIdx.y;
  if (x >= out_w || y >= out_h) return;

  const int line = size * ch;
  const bool swapped = swap[b] != 0;
  const int row_stride = swapped ? ch : line;
  const int col_stride = swapped ? line : ch;
  const T* img = src + (long long)b * size * line;
  const float* sa = s_a + (long long)b * size;

  float wb[3];
  const float pb = p_b[(long long)b * out_h + y];
  const int row0 = first_tap(pb, floorf(pb), s_b[(long long)b * out_w + x],
                             size, wb);
  const float pa = p_a[(long long)b * out_w + x];
  const float paf = floorf(pa);

  // Pass A at the pass-B rows: weights, and each tap's offset in the
  // sample (-1 where the row or the tap falls outside the source).
  float wa[3][3];
  int off[3][3];
  bool row_ok[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int r = row0 + j;
    row_ok[j] = r >= 0 && r < size;
    const int col0 = first_tap(pa, paf, sa[row_ok[j] ? r : 0], size, wa[j]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int q = col0 + i;
      off[j][i] = row_ok[j] && q >= 0 && q < size
                      ? r * row_stride + q * col_stride
                      : -1;
    }
  }

  const int plane = out_h * out_w;
  float* dst = out + (long long)b * ch * plane + y * out_w + x;
  if constexpr (CH == 3 && sizeof(T) == 1) {
    const uint8_t* px = (const uint8_t*)img;
    float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (!row_ok[j]) continue;
      float v[3][3];    // v[i][c]: tap i, channel c
      if (!swapped && off[j][0] >= 0 && off[j][2] >= 0) {
        // the row's 9 bytes from three words, shifted to start at tap 0
        const uint8_t* p = px + off[j][0];
        const int sh = 8 * (int)((uintptr_t)p & 3);
        const uint32_t w0 = word_at(p), w1 = word_at(p + 4),
                       w2 = word_at(p + 8);
        const uint32_t a[3] = {__funnelshift_r(w0, w1, sh),
                               __funnelshift_r(w1, w2, sh),
                               __funnelshift_r(w2, 0u, sh)};
#pragma unroll
        for (int k = 0; k < 9; ++k)
          v[k / 3][k % 3] = (float)((a[k / 4] >> (8 * (k % 4))) & 0xffu);
      } else {
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            v[i][c] = off[j][i] >= 0 ? load_tap(px + off[j][i] + c) : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float inter = 0.0f;
#pragma unroll
        for (int i = 0; i < 3; ++i)
          if (off[j][i] >= 0) inter = inter + v[i][c] * wa[j][i];
        acc[c] = acc[c] + inter * wb[j];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) dst[c * plane] = acc[c];
  } else {
    for (int c = 0; c < ch; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (!row_ok[j]) continue;
        float inter = 0.0f;
#pragma unroll
        for (int i = 0; i < 3; ++i)
          if (off[j][i] >= 0)
            inter = inter + load_tap(img + off[j][i] + c) * wa[j][i];
        acc = acc + inter * wb[j];
      }
      dst[c * plane] = acc;
    }
  }
}

extern "C" {

// src: (n, size, size, ch) uint8 (src_is_u8 != 0) or float32, contiguous.
// p_a (n, out_w), s_a (n, size), p_b (n, out_h), s_b (n, out_w) float32;
// swap (n) bytes 0/1; out (n, ch, out_h, out_w) float32. The caller
// guarantees size * size * ch and ch * out_h * out_w below 2^31; a grid
// past CUDA's limits fails the launch. Launches the kernel once on
// ``stream``; returns the CUDA error code of the launch (0 on success).
int shear_warp_launch(const void* src, int src_is_u8, const float* p_a,
                      const float* s_a, const float* p_b, const float* s_b,
                      const uint8_t* swap, float* out, int n, int size,
                      int ch, int out_h, int out_w, cudaStream_t stream) {
  const dim3 grid(n, (out_w + TILE_W - 1) / TILE_W,
                  (out_h + TILE_H - 1) / TILE_H);
  const dim3 block(TILE_W, TILE_H);
  if (src_is_u8 && ch == 3) {
    shear_warp_kernel<uint8_t, 3><<<grid, block, 0, stream>>>(
        (const uint8_t*)src, p_a, s_a, p_b, s_b, swap, out, size, ch, out_h,
        out_w);
  } else if (src_is_u8) {
    shear_warp_kernel<uint8_t, 0><<<grid, block, 0, stream>>>(
        (const uint8_t*)src, p_a, s_a, p_b, s_b, swap, out, size, ch, out_h,
        out_w);
  } else {
    shear_warp_kernel<float, 0><<<grid, block, 0, stream>>>(
        (const float*)src, p_a, s_a, p_b, s_b, swap, out, size, ch, out_h,
        out_w);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
