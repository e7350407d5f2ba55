// Fused DARK sub-pixel heatmap decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rsgnet_tpu/ops/pallas/dark_decode.py::_kernel
// (entry points dark_decode_pallas / dark_decode_pallas_spmd). Its plain
// PyTorch version is rsgnet_tpu_torch/ops/decode.py::dark_decode_reference;
// the Python wrapper is rsgnet_tpu_torch/ops/cuda/dark_decode.py.
//
// Per (n, k) heatmap of H x W float32, in order:
//   1. first-match argmax (np.argmax tie order) and the raw peak value;
//   2. separable zero-fill Gaussian blur with cv2's tables, x pass then
//      y pass, taps accumulated t = 0..ks-1 from +0.0;
//   3. rescale to the raw peak: v * (maxv / max(blurred max, 1e-20));
//   4. log(clip(v, 1e-10, 50)) at the 13 taps the Newton step reads;
//   5. 10-tap gradient and Hessian, one 2x2 Newton step, taken only off the
//      2-px border and where det != 0;
//   6. coords zeroed where maxv <= 0.
//
// Bound on an H100 (3.35 TB/s): memory. At a bucket of 64 with K=17 and
// 96x72 maps the kernel must read 64*17*96*72*4 B = 30.1 MB of heatmaps and
// write 13 KB: 9.0 us. Beside it sits the fp32 issue floor: built with
// -fmad=false (so the blur rounds as the plain version's separate multiply
// and add), the blur alone is 2 passes x ks taps x (1 mul + 1 add) = 44
// fp32 instructions per pixel at ks = 11, 331 M for bucket 64's 7.5 M
// pixels, ~10 us at 132 SMs x 128 lanes x 1.98 GHz.
//
// Design, one block of 128 threads per map (the first port kept two fp32
// copies of the map, so 4 maps fitted an SM; loaded with 4-byte loads; ran
// its pixel loops with a division and a bounds test per tap; and left the
// Newton tail to one thread):
//   1. One staged copy of the map in shared memory. Each row sits after a
//      gap of G = round_up(r, 4) zeros (one more gap after the last row), so
//      the x pass reads its taps with no bounds test: a zero tap adds
//      k * +0.0 to an accumulator that is never -0.0, exactly as the plain
//      version's zero padding does. 96x72 at ks = 11 takes 31,072 B, so
//      shared memory holds 7 maps per SM (the two copies before held 4);
//      at 89 registers a thread, 5 are resident (660 of bucket 64's 1,088
//      maps at once), and capping registers for 7 ran no faster. The load
//      moves 16 bytes per access (where w % 4 == 0 and the maps are 16-byte
//      aligned; else 4), eight in flight per thread, and the first-match
//      argmax rides on it: each thread walks its elements in increasing
//      flat index with a strict '>', and the block combine keeps the
//      smallest index among equal values.
//   2. The x pass in place, a few whole rows per round: each thread reads
//      the windows of up to 4 groups of 4 columns with 16-byte shared loads
//      (16 independent tap sums), and after one sync writes them over the
//      raw values. A round reads only its own rows, so one sync per round
//      suffices (4 rounds at 96x72).
//   3. The y pass from registers: a thread owns 4 columns of a strip of
//      rows, keeps the last ks x-pass rows (zeros outside the map) in a
//      register ring and emits out[y] = sum_t k[t] * row (y + r - t). ks is
//      a template parameter (odd 1..31, one switch in the launcher), so the
//      loops unroll, the ring's slots are static and the taps are
//      constant-bank operands; no pixel divides or tests a bound per tap.
//   4. The blurred max is a running max per thread and one block max; the
//      13 Newton taps read a 5x5 tile around the peak that the owners of
//      those pixels wrote on the way. The 13 logf run on 13 lanes of warp
//      0, then lane 0 takes the Newton step with the plain version's
//      formulas.
// cudaFuncSetAttribute is called once per instantiation and device.
// Arithmetic is built with -fmad=false and follows the plain version's
// operation order, so the two round alike (held bit-equal on the card).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <mutex>

#define DARK_MAX_KSIZE 31
#define DARK_THREADS 128         // one block of 128 threads per map
#define DARK_SCRATCH_WORDS 80    // tile (25 of 32), 3 x 16 reduction words
#define DARK_GROUPS 4            // x-pass groups per thread and round
#define DARK_MAX_SHARED 232448   // per block on an H100 (227 KB)
#define DARK_MAX_DEVICES 64

struct BlurTaps {
  float k[DARK_MAX_KSIZE];
};

// Zeros between staged rows: at least r, a multiple of 4 for 16-byte stores.
__host__ __device__ constexpr int dark_gap(int r) { return (r + 3) & ~3; }

// The 13 Newton taps (dy, dx) in the order lane i computes them.
__constant__ signed char kTapDy[13] = {0, 0, 1, -1, 0, 0, 0, 2, -2, 1, -1, 1, -1};
__constant__ signed char kTapDx[13] = {1, -1, 0, 0, 0, 2, -2, 0, 0, 1, 1, -1, -1};

// C adjacent floats of a row; C = 4 moves as one 16-byte access.
template <int C>
struct Vec {
  float v[C];
};

template <int C>
__device__ __forceinline__ Vec<C> load_global(const float* p) {
  Vec<C> r;
  if constexpr (C == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = t.x;
    r.v[1] = t.y;
    r.v[2] = t.z;
    r.v[3] = t.w;
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

template <int C>
__device__ __forceinline__ Vec<C> load_shared(const float* p) {
  Vec<C> r;
  if constexpr (C == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x;
    r.v[1] = t.y;
    r.v[2] = t.z;
    r.v[3] = t.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int C>
__device__ __forceinline__ void store_shared(float* p, const Vec<C>& r) {
  if constexpr (C == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  else
    *p = r.v[0];
}

// (value, flat index) combine keeping the max value and, among equal
// values, the smallest index: first-match argmax.
__device__ __forceinline__ void argmax_combine(float& v, int& i, float ov,
                                               int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Copies the map into the staged rows (row y at gap + y * (w + gap)) in
// groups of C floats, eight loads in flight per thread, and folds each
// element into the thread's first-match argmax in increasing flat index.
template <int C>
__device__ __forceinline__ void stage_map(const float* __restrict__ src,
                                          float* stage, int h, int w,
                                          int gap, int tid, int nt,
                                          float& best, int& best_i) {
  constexpr int U = 8;
  const int wq = w / C, nq = h * wq, stride = w + gap;
  int y = tid / wq, c = tid - y * wq;
  const int dy = nt / wq, dc = nt - dy * wq;
  for (int q0 = tid; q0 < nq; q0 += U * nt) {
    Vec<C> v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (q0 + u * nt < nq) v[u] = load_global<C>(src + (q0 + u * nt) * C);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * nt;
      if (q < nq) {
        store_shared<C>(stage + gap + y * stride + c * C, v[u]);
#pragma unroll
        for (int i = 0; i < C; ++i) {
          if (v[u].v[i] > best) {
            best = v[u].v[i];
            best_i = q * C + i;
          }
        }
      }
      c += dc;
      y += dy;
      if (c >= wq) {
        c -= wq;
        ++y;
      }
    }
  }
}

// One block of DARK_THREADS per map; C columns per thread (4 where
// w % 4 == 0 and the maps are 16-byte aligned, else 1). The second bound
// caps registers at 128 a thread up to ks = 15, and leaves them free above.
template <int KS, int C>
__global__ void __launch_bounds__(DARK_THREADS, KS <= 15 ? 4 : 2)
dark_decode_kernel(const float* __restrict__ heatmaps,
                   float* __restrict__ coords, float* __restrict__ maxvals,
                   int* __restrict__ peaks, int h, int w, int cols,
                   int strips, const BlurTaps taps) {
  constexpr int R = (KS - 1) / 2;
  constexpr int G = dark_gap(R);
  constexpr int NQ = (R + C - 1) / C;   // vectors each side of a group
  constexpr int NV = 2 * NQ + 1;        // vectors in an x-pass window
  extern __shared__ __align__(16) float smem[];
  const int stride = w + G;
  float* stage = smem;                  // rows at G + y * stride
  float* tile = smem + G + h * stride;  // 5x5 blurred values at the peak
  float* red_v = tile + 32;             // per-warp argmax values
  int* red_i = reinterpret_cast<int*>(red_v + 16);   // ... and indices
  float* red_m = red_v + 32;            // per-warp blurred max

  const int hw = h * w, wq = w / C;
  const int map = blockIdx.x;
  const float* src = heatmaps + (size_t)map * hw;
  constexpr int nt = DARK_THREADS, nwarps = nt / 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned full = 0xffffffffu;

  // 1. stage the map with its gaps of zeros; first-match argmax on the way
  if constexpr (G > 0) {
    for (int e = tid; e < (h + 1) * G; e += nt) {
      const int g = e / G;
      stage[g * stride + (e - g * G)] = 0.0f;
    }
  }
  float best = -CUDART_INF_F;
  int best_i = hw;
  stage_map<C>(src, stage, h, w, G, tid, nt, best, best_i);
  for (int off = 16; off > 0; off >>= 1)
    argmax_combine(best, best_i, __shfl_xor_sync(full, best, off),
                   __shfl_xor_sync(full, best_i, off));
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = best_i;
  }
  __syncthreads();
  for (int i = 0; i < nwarps; ++i) argmax_combine(best, best_i, red_v[i], red_i[i]);
  if (best_i == hw) best_i = 0;          // every value -inf: np.argmax's 0
  const float maxv = best;
  const int py0 = best_i / w;
  const int px0 = best_i - py0 * w;

  // 2. x pass in place, whole rows per round: each thread computes up to
  // DARK_GROUPS groups of C columns from its row's staged window (the gaps
  // are the zero fill), then after a sync writes them over the raw values.
  // A round reads only its own rows, so one sync per round suffices.
  {
    const int rr = min(h, DARK_GROUPS * nt / wq);   // rows per round
    int gy[DARK_GROUPS], gx[DARK_GROUPS];
#pragma unroll
    for (int m = 0; m < DARK_GROUPS; ++m) {
      const int g = tid + m * nt;
      gy[m] = g / wq;
      gx[m] = G + (g - gy[m] * wq) * C;
    }
    for (int y0 = 0; y0 < h; y0 += rr) {
      const int nr = min(rr, h - y0);
      Vec<C> out[DARK_GROUPS];
#pragma unroll
      for (int m = 0; m < DARK_GROUPS; ++m) {
        if (gy[m] < nr) {
          const float* p = stage + (y0 + gy[m]) * stride + gx[m] - NQ * C;
          float win[NV * C];
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            const Vec<C> t = load_shared<C>(p + j * C);
#pragma unroll
            for (int i = 0; i < C; ++i) win[j * C + i] = t.v[i];
          }
#pragma unroll
          for (int i = 0; i < C; ++i) {
            float b = 0.0f;
#pragma unroll
            for (int t = 0; t < KS; ++t) b = b + taps.k[t] * win[NQ * C + i + R - t];
            out[m].v[i] = b;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < DARK_GROUPS; ++m)
        if (gy[m] < nr) store_shared<C>(stage + (y0 + gy[m]) * stride + gx[m], out[m]);
    }
    __syncthreads();
  }

  // 2. y pass from a register ring: a thread owns C columns of a strip of
  // rows, pushes x-pass row yi (zeros outside the map) into ring slot
  // (yi - y_start) % KS and, once row y + r is in, emits out[y] = sum_t
  // k[t] * row (y + r - t); the blurred max and the 5x5 tile on the way.
  float bmax = -CUDART_INF_F;
  const int ty = tid / cols, tx = tid - ty * cols;
  if (ty < strips) {
    const int rows = (h + strips - 1) / strips;
    const int y_lo = ty * rows, y_hi = min(h, y_lo + rows);
    const int y_start = y_lo - R, y_end = y_hi + R;
    for (int cg = tx; cg < wq; cg += cols) {
      const int x0 = cg * C;
      bool col_in[C];
#pragma unroll
      for (int i = 0; i < C; ++i) col_in[i] = (unsigned)(x0 + i - px0 + 2) < 5u;
      Vec<C> ring[KS];
      for (int base = y_start; base < y_end; base += KS) {
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          const int yi = base + j;           // ring slot j holds row yi
          if (yi < y_end) {
            if (yi >= 0 && yi < h) {
              ring[j] = load_shared<C>(stage + G + yi * stride + x0);
            } else {
#pragma unroll
              for (int i = 0; i < C; ++i) ring[j].v[i] = 0.0f;
            }
            const int y = yi - R;
            if (y >= y_lo) {
              const bool row_in = (unsigned)(y - py0 + 2) < 5u;
#pragma unroll
              for (int i = 0; i < C; ++i) {
                float acc = 0.0f;
#pragma unroll
                for (int t = 0; t < KS; ++t)
                  acc = acc + taps.k[t] * ring[(j - t + KS) % KS].v[i];
                bmax = fmaxf(bmax, acc);
                if (row_in && col_in[i])
                  tile[(y - py0 + 2) * 5 + (x0 + i - px0 + 2)] = acc;
              }
            }
          }
        }
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    bmax = fmaxf(bmax, __shfl_xor_sync(full, bmax, off));
  if (lane == 0) red_m[warp] = bmax;
  __syncthreads();
  if (warp != 0) return;

  // 3.-5. warp 0: rescale + log at the 13 taps (one per lane), Newton step
  for (int i = 0; i < nwarps; ++i) bmax = fmaxf(bmax, red_m[i]);
  const float ratio = maxv / fmaxf(bmax, 1e-20f);
  float lg = 0.0f;
  if (lane < 13) {
    const int yy = min(max(py0 + kTapDy[lane], 0), h - 1);
    const int xx = min(max(px0 + kTapDx[lane], 0), w - 1);
    const float v = tile[(yy - py0 + 2) * 5 + (xx - px0 + 2)] * ratio;
    lg = logf(fminf(fmaxf(v, 1e-10f), 50.0f));
  }
  float g[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) g[i] = __shfl_sync(full, lg, i);
  if (lane != 0) return;
  const float dx = 0.5f * (g[0] - g[1]);
  const float dy = 0.5f * (g[2] - g[3]);
  const float c = g[4];
  const float dxx = 0.25f * (g[5] - 2.0f * c + g[6]);
  const float dyy = 0.25f * (g[7] - 2.0f * c + g[8]);
  const float dxy = 0.25f * (g[9] - g[10] - g[11] + g[12]);
  const float det = dxx * dyy - dxy * dxy;
  const bool ok = (px0 > 1) && (px0 < w - 2) && (py0 > 1) && (py0 < h - 2) &&
                  (det != 0.0f);
  const float inv_det = (det == 0.0f) ? 0.0f : 1.0f / det;
  const float off_x = -(dyy * dx - dxy * dy) * inv_det;
  const float off_y = -(-dxy * dx + dxx * dy) * inv_det;
  const float okf = ok ? 1.0f : 0.0f;
  // 6. the reference get_max_preds zeroes coords where maxval <= 0
  const float alive = (maxv > 0.0f) ? 1.0f : 0.0f;
  coords[2 * map + 0] = ((float)px0 + off_x * okf) * alive;
  coords[2 * map + 1] = ((float)py0 + off_y * okf) * alive;
  maxvals[map] = maxv;
  if (peaks != nullptr) peaks[map] = best_i;
}

// The instantiation for blur ksize and C = 4 (c4) or 1 columns per thread.
template <int KS>
static const void* kernel_of(bool c4) {
  return c4 ? (const void*)dark_decode_kernel<KS, 4>
            : (const void*)dark_decode_kernel<KS, 1>;
}

static const void* kernel_for(int ksize, bool c4) {
  switch (ksize) {
#define DARK_CASE(K) \
  case K:            \
    return kernel_of<K>(c4);
    DARK_CASE(1) DARK_CASE(3) DARK_CASE(5) DARK_CASE(7) DARK_CASE(9)
    DARK_CASE(11) DARK_CASE(13) DARK_CASE(15) DARK_CASE(17) DARK_CASE(19)
    DARK_CASE(21) DARK_CASE(23) DARK_CASE(25) DARK_CASE(27) DARK_CASE(29)
    DARK_CASE(31)
#undef DARK_CASE
  }
  return nullptr;
}

// Opts the instantiation in to the card's whole shared memory, once per
// instantiation and device.
static cudaError_t configure_once(const void* kernel, int ksize, bool c4) {
  static std::mutex mu;
  static bool done[DARK_MAX_KSIZE + 1][2][DARK_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= DARK_MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  bool& done_here = done[ksize][c4][dev];
  if (done_here) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DARK_MAX_SHARED);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  done_here = (err == cudaSuccess);
  return err;
}

extern "C" {

int dark_decode_max_ksize() { return DARK_MAX_KSIZE; }

// Dynamic shared memory of one block for h x w maps at blur ksize: the
// staged rows with their gaps, then the scratch words.
long long dark_decode_shared_bytes(int h, int w, int ksize) {
  const long long g = dark_gap((ksize - 1) / 2);
  return 4LL * (g + (long long)h * (w + g) + DARK_SCRATCH_WORDS);
}

static bool dark_args_ok(int h, int w, int ksize) {
  return ksize >= 1 && ksize <= DARK_MAX_KSIZE && ksize % 2 == 1 && h >= 1 &&
         w >= 1 && w <= DARK_GROUPS * DARK_THREADS &&
         dark_decode_shared_bytes(h, w, ksize) <= DARK_MAX_SHARED;
}

// Launches one block of DARK_THREADS per map on `stream`.
// `taps_host` holds `ksize` float32 coefficients in host memory. `peaks`
// (may be null) receives each map's flat argmax index. Returns
// cudaGetLastError() after the launch (0 = success); the caller raises on
// anything else.
int dark_decode_launch(const void* heatmaps, void* coords, void* maxvals,
                       void* peaks, int num_maps, int h, int w,
                       const float* taps_host, int ksize, void* stream) {
  if (!dark_args_ok(h, w, ksize) || num_maps < 1)
    return (int)cudaErrorInvalidValue;
  const bool c4 =
      w % 4 == 0 && reinterpret_cast<uintptr_t>(heatmaps) % 16 == 0;
  const void* kernel = kernel_for(ksize, c4);
  cudaError_t err = configure_once(kernel, ksize, c4);
  if (err != cudaSuccess) return (int)err;
  BlurTaps taps;
  for (int t = 0; t < DARK_MAX_KSIZE; ++t)
    taps.k[t] = (t < ksize) ? taps_host[t] : 0.0f;
  // y pass: cols column groups x strips of rows fill the block's threads
  const int wq = c4 ? w / 4 : w;
  int cols = wq < DARK_THREADS ? wq : DARK_THREADS;
  int strips = DARK_THREADS / cols < h ? DARK_THREADS / cols : h;
  const float* hm = (const float*)heatmaps;
  void* args[] = {&hm, &coords, &maxvals, &peaks, &h, &w, &cols, &strips,
                  &taps};
  err = cudaLaunchKernel(kernel, dim3(num_maps), dim3(DARK_THREADS), args,
                         (size_t)dark_decode_shared_bytes(h, w, ksize),
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
