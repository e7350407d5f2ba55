// ConvBN epilogue for Hopper (sm_90a): the eval BatchNorm of a conv's
// output, an optional residual and an optional ReLU, in one pass.
//
// Replaces no TPU kernel. The JAX package leaves conv -> BatchNorm ->
// (+ residual) -> ReLU to XLA, which fuses such an elementwise tail into one
// pass over the conv's output. Eager PyTorch ran it as up to four passes,
// each reading and writing the whole activation in device memory: the bf16
// -> fp32 upcast, cuDNN's inference BatchNorm, the residual add and the
// ReLU. This kernel is that tail as one pass. Its plain PyTorch version is
// rsgnet_tpu_torch/ops/cuda/convbn_epilogue.py::convbn_epilogue_reference,
// beside the operator's wrapper.
//
// Per element of y (N, C, H, W), bf16 or fp32, in channel c, dense in
// NCHW order or in channels-last (NHWC) order:
//   out = (float(y) - mean[c]) * (weight[c] * rsqrtf(var[c] + eps)) + bias[c]
//   out = out + addend        (optional: fp32, y's shape and order)
//   out = out < 0 ? 0 : out   (optional ReLU; NaN stays NaN, as torch's)
// in fp32, each multiply and add rounded apart (-fmad=false); out is fp32
// in y's order, the type and layout the chain handed on before.
//
// Bound on an H100 (3.35 TB/s): memory. An element moves 6 bytes from bf16
// (2 read, 4 written), 10 with the addend; 8 and 12 from fp32. The four
// per-channel vectors are 16 bytes a channel and stay in L1 and L2. W48's
// stem output at a batch of 64, (64, 64, 192, 144) bf16, is 679 MB of
// traffic: 0.203 ms at the bound.
//
// Design, a pure stream with no shared memory and no synchronization:
//   - The tensor is rows of one order: in NCHW a row is an (n, c) plane,
//     all of one channel; in NHWC a row is a pixel's C channels. A thread
//     takes V consecutive elements of one row, read in one 16-byte load of
//     y (V = 8 in bf16, 4 in fp32) where the row's length and every pointer
//     allow it, else in 8, 4 or 2 bytes; the addend, the output (and in
//     NHWC the V channels' constants) move in 16-byte pieces. W48's NCHW
//     planes run from 27,648 px (the stem at 192x144) down to 108 px
//     (branch 4 at 12x9, 384 channels: V = 4, 8-byte loads of bf16);
//     ViTPose's decoder hands its deconvs' outputs on channels-last, rows
//     of 256 channels.
//   - Threads walk the flat vector index, so a block of 256 threads covers
//     many small planes or a chunk of a large one: every SM has blocks to
//     run at the smallest branch, and no thread idles at a plane's end. Each
//     thread reads its channels' four constants (L1 hits) and derives the
//     scale itself, so no kernel builds a scale per call.
//   - 32-bit index math: the launcher splits a tensor of 2^31 vectors or
//     more into launches of whole rows.
// The launcher allocates nothing, does not synchronize, returns the CUDA
// error of its launches (cudaGetLastError) and runs under graph capture.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#define EPI_THREADS 256

template <int BYTES>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<4> { using type = unsigned int; };
template <>
struct Raw<2> { using type = unsigned short; };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// V elements of y in one load of V * sizeof(T) bytes (at most 16).
template <typename T, int V>
__device__ __forceinline__ void load_y(const T* p, T (&v)[V]) {
  using R = typename Raw<sizeof(T) * V>::type;
  const R r = __ldg(reinterpret_cast<const R*>(p));
  memcpy(v, &r, sizeof(R));
}

// V fp32 values in pieces of up to 16 bytes.
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[V]) {
  constexpr int P = V >= 4 ? 4 : V;
  using R = typename Raw<4 * P>::type;
#pragma unroll
  for (int j = 0; j < V / P; ++j) {
    const R r = __ldg(reinterpret_cast<const R*>(p) + j);
    memcpy(v + j * P, &r, sizeof(R));
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[V]) {
  constexpr int P = V >= 4 ? 4 : V;
  using R = typename Raw<4 * P>::type;
#pragma unroll
  for (int j = 0; j < V / P; ++j) {
    R r;
    memcpy(&r, v + j * P, sizeof(R));
    reinterpret_cast<R*>(p)[j] = r;
  }
}

// nvec vectors of V elements from y, addend and out (already offset to the
// launch's first row); row_vecs vectors a row. NCHW: a row is a plane, the
// first in channel c0, so every element of a vector has one channel. NHWC:
// a row is a pixel, and a vector's V elements are V channels in a row.
template <typename T, int V, bool ADD, bool RELU, bool NHWC>
__global__ void __launch_bounds__(EPI_THREADS) convbn_epilogue_kernel(
    const T* __restrict__ y, const float* __restrict__ addend,
    const float* __restrict__ weight, const float* __restrict__ bias,
    const float* __restrict__ mean, const float* __restrict__ var,
    float* __restrict__ out, unsigned nvec, unsigned row_vecs,
    unsigned channels, unsigned c0, float eps) {
  const unsigned i = blockIdx.x * EPI_THREADS + threadIdx.x;
  if (i >= nvec) return;
  float m[V], s[V], b[V];
  if constexpr (NHWC) {
    const unsigned c = (i % row_vecs) * V;
    float w[V], v[V];
    load_f32<V>(weight + c, w);
    load_f32<V>(var + c, v);
    load_f32<V>(mean + c, m);
    load_f32<V>(bias + c, b);
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] = w[k] * rsqrtf(v[k] + eps);
  } else {
    const unsigned c = (c0 + i / row_vecs) % channels;
    const float mc = __ldg(mean + c);
    const float sc = __ldg(weight + c) * rsqrtf(__ldg(var + c) + eps);
    const float bc = __ldg(bias + c);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      m[k] = mc;
      s[k] = sc;
      b[k] = bc;
    }
  }
  const size_t e = (size_t)i * V;
  T x[V];
  load_y<T, V>(y + e, x);
  float r[V];
  if constexpr (ADD) load_f32<V>(addend + e, r);
  float o[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float t = (to_float(x[k]) - m[k]) * s[k] + b[k];
    if constexpr (ADD) t = t + r[k];
    if constexpr (RELU) t = t < 0.0f ? 0.0f : t;
    o[k] = t;
  }
  store_f32<V>(out + e, o);
}

struct Args {
  const float* addend;
  const float* weight;
  const float* bias;
  const float* mean;
  const float* var;
  float* out;
  unsigned nvec, row_vecs, channels, c0;
  float eps;
};

template <typename T, int V, bool NHWC>
static void launch(const T* y, const Args& a, int relu, cudaStream_t stream) {
  const unsigned blocks = (a.nvec + EPI_THREADS - 1) / EPI_THREADS;
#define EPI_LAUNCH(ADD, RELU)                                                \
  convbn_epilogue_kernel<T, V, ADD, RELU, NHWC>                              \
      <<<blocks, EPI_THREADS, 0, stream>>>(                                  \
          y, a.addend, a.weight, a.bias, a.mean, a.var, a.out, a.nvec,       \
          a.row_vecs, a.channels, a.c0, a.eps)
  if (a.addend && relu) {
    EPI_LAUNCH(true, true);
  } else if (a.addend) {
    EPI_LAUNCH(true, false);
  } else if (relu) {
    EPI_LAUNCH(false, true);
  } else {
    EPI_LAUNCH(false, false);
  }
#undef EPI_LAUNCH
}

template <typename T, bool NHWC>
static void launch_v(int v, const T* y, const Args& a, int relu,
                     cudaStream_t stream) {
  switch (v) {
    case 8:
      if constexpr (sizeof(T) == 2) launch<T, 8, NHWC>(y, a, relu, stream);
      break;
    case 4:
      launch<T, 4, NHWC>(y, a, relu, stream);
      break;
    case 2:
      launch<T, 2, NHWC>(y, a, relu, stream);
      break;
    default:
      launch<T, 1, NHWC>(y, a, relu, stream);
  }
}

static bool aligned(const void* p, int bytes) {
  return p == nullptr || (uintptr_t)p % (uintptr_t)bytes == 0;
}

// The widest vector (elements a thread) that the kernel takes: 8, 4, 2 or
// 1 in bf16 (y_bf16 != 0), 4, 2 or 1 in fp32, dividing the row's length
// (the plane's in NCHW, C in NHWC) with y, the addend, the output and, in
// NHWC, the four per-channel vectors aligned to its loads. A trace shows
// it as the kernel's second template argument.
static int vector_width(const void* y, int y_bf16, const float* addend,
                        const float* out, long long row, int nhwc,
                        const float* weight, const float* bias,
                        const float* mean, const float* var) {
  const int elem = y_bf16 ? 2 : 4;
  for (int v = y_bf16 ? 8 : 4; v > 1; v /= 2) {
    const int f32 = v >= 4 ? 16 : 4 * v;
    if (row % v == 0 && aligned(y, elem * v) && aligned(addend, f32) &&
        aligned(out, f32) &&
        (!nhwc || (aligned(weight, f32) && aligned(bias, f32) &&
                   aligned(mean, f32) && aligned(var, f32))))
      return v;
  }
  return 1;
}

extern "C" {

// y: (n, channels, hw) bf16 (y_bf16 != 0) or fp32 in NCHW order, or
// (n, hw, channels) with nhwc != 0; addend (nullable) and out: y's shape
// and order in fp32; weight, bias, mean, var: (channels) fp32; all dense,
// on one device. Launches the kernel on ``stream`` once per run of whole
// rows below 2^31 vectors (once at every shape of the port's models) and
// adds the launches made to *launches. Returns 0, or the CUDA error of the
// first launch that failed.
int convbn_epilogue_launch(const void* y, int y_bf16, const float* addend,
                           const float* weight, const float* bias,
                           const float* mean, const float* var, float* out,
                           long long n, int channels, long long hw, int nhwc,
                           float eps, int relu, cudaStream_t stream,
                           int* launches) {
  if (n <= 0 || hw <= 0 || channels <= 0) return 0;
  const long long rows = nhwc ? n * hw : n * channels;
  const long long row = nhwc ? channels : hw;
  const int v = vector_width(y, y_bf16, addend, out, row, nhwc, weight, bias,
                             mean, var);
  const long long cap = 0x7fffffffLL;
  if (row / v > cap) return (int)cudaErrorInvalidValue;
  const unsigned row_vecs = (unsigned)(row / v);
  const long long per_launch = cap / row_vecs;
  for (long long r0 = 0; r0 < rows; r0 += per_launch) {
    const long long nr = rows - r0 < per_launch ? rows - r0 : per_launch;
    const long long e0 = r0 * row;
    const Args a = {addend ? addend + e0 : nullptr, weight, bias, mean, var,
                    out + e0, (unsigned)(nr * (long long)row_vecs), row_vecs,
                    (unsigned)channels,
                    nhwc ? 0u : (unsigned)(r0 % channels), eps};
    if (y_bf16) {
      const __nv_bfloat16* yy = (const __nv_bfloat16*)y + e0;
      if (nhwc) launch_v<__nv_bfloat16, true>(v, yy, a, relu, stream);
      else launch_v<__nv_bfloat16, false>(v, yy, a, relu, stream);
    } else {
      const float* yy = (const float*)y + e0;
      if (nhwc) launch_v<float, true>(v, yy, a, relu, stream);
      else launch_v<float, false>(v, yy, a, relu, stream);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    *launches += 1;
  }
  return 0;
}

}  // extern "C"
