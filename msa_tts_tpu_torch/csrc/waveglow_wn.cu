// WaveGlow's WN layer, its elementwise work as two fused passes, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's WaveGlow has none (XLA fuses
// its elementwise ops).  In the port each WN layer
// (vocoders/waveglow.py WaveGlowVocoder.wn) runs a 1x1 conditioning
// product (cuBLAS, its bias folded), a dilated convolution (cuDNN) and a
// 1x1 res/skip product (cuBLAS); what lies between them ran as six eager
// PyTorch ops a layer, each a pass over an (N, 2C) or (N, C) tensor:
//
//   wn_gate_kernel      z = R(zc + zd)                 (N, 2C)
//                       acts = R(R(tanh z1) * R(sigmoid z2))   (N, C)
//   wn_residual_kernel  x = R(x + rs_res), zeroed where padded
//                       skip = R(skip + rs_skip)  (layer 0: rs_skip)
//                       the last layer: skip + rs as float32, for `end`
//
// R() rounds to the activation type (bf16; the identity in float32).
// Both kernels compute in float32 with the functions PyTorch's CUDA
// kernels use (tanhf; 1 / (1 + expf(-z)); IEEE division, no fast math),
// rounding where the eager ops store, so the bits equal the eager path's.
//
// What bounds them on an H100: bytes.  At the published width (C = 256)
// over N = 16 x 32,000 positions in bf16, the gate reads zc and zd
// (2 x 524 MB) and writes acts (262 MB): 1.31 GB, 0.39 ms at 3.35 TB/s,
// where the eager add, tanh, sigmoid and product moved ~3.4 GB.  The
// residual pass reads rs, x and skip and writes x and skip: 1.57 GB,
// 0.47 ms; the eager sums moved the same bytes, strided and unvectorized.
// What the design does about it: one thread takes V consecutive channels
// of one position (16-byte loads and stores where C allows, else 8 or 4),
// both halves of a row (tanh and sigmoid, res and skip) in the same
// thread, so every access is a contiguous vector and a warp reads whole
// 512-byte runs; each intermediate stays in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Rounds as PyTorch stores a float result (round to nearest even).
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return widen(narrow<T>(v));
}

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

// One thread: channels [g V, g V + V) of position p.  zc, zd (N, 2C);
// acts (N, C).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
wn_gate_kernel(const T* __restrict__ zc, const T* __restrict__ zd,
               T* __restrict__ acts, uint32_t groups, uint32_t total,
               int C) {
  const uint32_t i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const uint32_t p = i / groups, g = i - p * groups;
  const size_t in = (size_t)p * 2 * C + (size_t)g * V;
  const Vec<T, V> c1 = load<T, V>(zc + in), c2 = load<T, V>(zc + in + C);
  const Vec<T, V> d1 = load<T, V>(zd + in), d2 = load<T, V>(zd + in + C);
  Vec<T, V> out;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float z1 = rounded<T>(widen(c1.v[j]) + widen(d1.v[j]));
    const float z2 = rounded<T>(widen(c2.v[j]) + widen(d2.v[j]));
    const float t = rounded<T>(tanhf(z1));
    const float s = rounded<T>(1.0f / (1.0f + expf(-z2)));
    out.v[j] = narrow<T>(t * s);
  }
  *reinterpret_cast<Vec<T, V>*>(acts + (size_t)p * C + (size_t)g * V) = out;
}

// One thread: channels [g V, g V + V) of position p.  rs (N, 2C), or
// (N, C) at the last layer; x, skip (N, C).  Not LAST: x += rs_res
// (zeroed where pad[p]), skip_out = skip + rs_skip (skip_in null at
// layer 0: rs_skip); skip_out may be skip_in.  LAST: x is not touched;
// skip_out (float32) = skip_in + rs, or rs where skip_in is null.
template <typename T, int V, bool LAST>
__global__ void __launch_bounds__(THREADS)
wn_residual_kernel(const T* __restrict__ rs, T* __restrict__ x,
                   const T* skip_in,
                   typename std::conditional<LAST, float, T>::type* skip_out,
                   const uint8_t* __restrict__ pad, uint32_t groups,
                   uint32_t total, int C) {
  using Out = typename std::conditional<LAST, float, T>::type;
  const uint32_t i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const uint32_t p = i / groups, g = i - p * groups;
  const size_t row = (size_t)p * C + (size_t)g * V;
  const size_t in = (size_t)p * (LAST ? C : 2 * C) + (size_t)g * V;
  // every load first: skip_out may alias skip_in
  const Vec<T, V> r_skip = load<T, V>(rs + in + (LAST ? 0 : C));
  Vec<T, V> s_in, r_res, xv;
  if (skip_in != nullptr) s_in = load<T, V>(skip_in + row);
  if constexpr (!LAST) {
    r_res = load<T, V>(rs + in);
    xv = load<T, V>(x + row);
  }
  Vec<Out, V> s_out;
#pragma unroll
  for (int j = 0; j < V; ++j)
    s_out.v[j] = narrow<Out>(
        skip_in == nullptr
            ? widen(r_skip.v[j])
            : rounded<T>(widen(s_in.v[j]) + widen(r_skip.v[j])));
  *reinterpret_cast<Vec<Out, V>*>(skip_out + row) = s_out;
  if constexpr (!LAST) {
    const bool zero = pad != nullptr && pad[p];
#pragma unroll
    for (int j = 0; j < V; ++j)
      xv.v[j] = narrow<T>(zero ? 0.0f : widen(xv.v[j]) + widen(r_res.v[j]));
    *reinterpret_cast<Vec<T, V>*>(x + row) = xv;
  }
}

template <typename T, int V>
cudaError_t gate(const void* zc, const void* zd, void* acts, uint32_t n,
                 int C, cudaStream_t s) {
  const uint32_t groups = C / V, total = n * groups;
  wn_gate_kernel<T, V><<<(total + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      (const T*)zc, (const T*)zd, (T*)acts, groups, total, C);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t residual(const void* rs, void* x, const void* skip_in,
                     void* skip_out, const void* pad, uint32_t n, int C,
                     bool last, cudaStream_t s) {
  const uint32_t groups = C / V, total = n * groups;
  const uint32_t blocks = (total + THREADS - 1) / THREADS;
  if (last)
    wn_residual_kernel<T, V, true><<<blocks, THREADS, 0, s>>>(
        (const T*)rs, (T*)x, (const T*)skip_in, (float*)skip_out,
        (const uint8_t*)pad, groups, total, C);
  else
    wn_residual_kernel<T, V, false><<<blocks, THREADS, 0, s>>>(
        (const T*)rs, (T*)x, (const T*)skip_in, (T*)skip_out,
        (const uint8_t*)pad, groups, total, C);
  return cudaGetLastError();
}

// Elements of T a thread moves for a vector of ``vec_bytes`` bytes; 0 for
// a size the kernels do not take (16, 8 or 4 bytes).
int vec_elems(int vec_bytes, int bf16) {
  if (vec_bytes != 16 && vec_bytes != 8 && vec_bytes != 4) return 0;
  return vec_bytes / (bf16 ? 2 : 4);
}

}  // namespace

extern "C" {

const char* waveglow_wn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The gate pass on ``stream``; returns a cudaError_t code (0 = launched).
// zc, zd (n, 2c) and acts (n, c), contiguous, of one type (``bf16`` != 0:
// bfloat16, else float32), each aligned to ``vec_bytes`` (16, 8 or 4),
// which divides c's bytes; n * c < 2^31.
int waveglow_wn_gate(const void* zc, const void* zd, void* acts, int n,
                     int c, int bf16, int vec_bytes, void* stream) {
  const int v = vec_elems(vec_bytes, bf16);
  if (v == 0 || n < 0 || c <= 0 || c % v) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    if (v == 8) return gate<__nv_bfloat16, 8>(zc, zd, acts, n, c, s);
    if (v == 4) return gate<__nv_bfloat16, 4>(zc, zd, acts, n, c, s);
    return gate<__nv_bfloat16, 2>(zc, zd, acts, n, c, s);
  }
  if (v == 4) return gate<float, 4>(zc, zd, acts, n, c, s);
  if (v == 2) return gate<float, 2>(zc, zd, acts, n, c, s);
  return gate<float, 1>(zc, zd, acts, n, c, s);
}

// The residual pass on ``stream``; returns a cudaError_t code.  rs (n, 2c),
// or (n, c) where ``last`` != 0; x, skip_in, skip_out (n, c); skip_out is
// float32 where ``last``, else of the activation type and may be skip_in;
// skip_in null at the first layer; pad null or n bytes (0/1), read where
// not ``last``; x unused where ``last``.  Alignment as for the gate
// (skip_out's to vec_bytes times its elements' widening); n * c < 2^31.
int waveglow_wn_residual(const void* rs, void* x, const void* skip_in,
                         void* skip_out, const void* pad, int n, int c,
                         int bf16, int vec_bytes, int last, void* stream) {
  const int v = vec_elems(vec_bytes, bf16);
  if (v == 0 || n < 0 || c <= 0 || c % v) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool l = last != 0;
  if (bf16) {
    if (v == 8)
      return residual<__nv_bfloat16, 8>(rs, x, skip_in, skip_out, pad, n, c,
                                        l, s);
    if (v == 4)
      return residual<__nv_bfloat16, 4>(rs, x, skip_in, skip_out, pad, n, c,
                                        l, s);
    return residual<__nv_bfloat16, 2>(rs, x, skip_in, skip_out, pad, n, c,
                                      l, s);
  }
  if (v == 4)
    return residual<float, 4>(rs, x, skip_in, skip_out, pad, n, c, l, s);
  if (v == 2)
    return residual<float, 2>(rs, x, skip_in, skip_out, pad, n, c, l, s);
  return residual<float, 1>(rs, x, skip_in, skip_out, pad, n, c, l, s);
}

}  // extern "C"
