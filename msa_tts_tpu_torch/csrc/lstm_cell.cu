// Fused LSTM-cell kernel for Hopper (sm_90a).
//
// lstm_cell_kernel replaces
// msa_tts_tpu/experimental/pallas_lstm_cell.py::fused_lstm_cell (body
// _kernel): one LSTM step in one launch,
//
//   gates = x_proj + h @ w_hh_t        (B, 4H), gate order i, f, g, o
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h' = sigmoid(o) * tanh(c')
//
// with the recurrent product computed in the kernel's own loop, so the
// (B, 4H) gate pre-activations never reach device memory.
//
// What bounds it on an H100: the step reads all of w_hh_t once (16.8 MB
// in f32 at H = 1024, 8.4 MB in bf16) for 8 H^2 B operations, so it is
// bound by bytes: ~5 us from HBM, less when the weights are still in
// the 50 MB L2 from the previous step of a scan.  The design gives a
// block UNITS = 8 neighbouring hidden units (H must be a multiple of 8):
// for each input i their four gate weights are four 32-byte runs of
// w_hh_t's row i, so every sector fetched is used.  The block's 256
// threads are 8 unit lanes x 32 slices of the input dimension; each
// keeps the 4 x ROWS partial sums of its unit in registers, h is staged
// in shared memory once per block (rounded to bf16 first for bf16
// weights; sums are f32), and the slices are added in a fixed order:
// by shuffles inside a warp, then across the warps through shared
// memory by the threads that apply the gates.  Rows beyond ROWS = 16
// take further passes over the weights.
//
// The C entry point takes plain pointers and returns a cudaError_t code,
// so the library is loaded with ctypes and needs no PyTorch headers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNITS = 8;           // hidden units per block
constexpr int NT = 256;            // threads per block
constexpr int NW = NT / 32;        // warps per block
constexpr int SLICES = NT / UNITS; // slices of the input dimension
constexpr int ROWS = 16;           // batch rows per pass

size_t smem_bytes(int H) {
  return ((size_t)ROWS * H + (size_t)NW * 4 * ROWS * UNITS) * sizeof(float);
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// float -> bf16 -> float, round to nearest even (what a cast does).
__device__ __forceinline__ float round_bf16(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return v;          // NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

template <typename WT> __device__ __forceinline__ float as_input(float v);
template <> __device__ __forceinline__ float as_input<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float as_input<uint16_t>(float v) {
  return round_bf16(v);
}

__device__ __forceinline__ float load1(const float* w) { return __ldg(w); }
__device__ __forceinline__ float load1(const uint16_t* w) {
  return __uint_as_float((uint32_t)__ldg(w) << 16);
}

template <typename WT>
__global__ void __launch_bounds__(NT)
lstm_cell_kernel(const float* __restrict__ x_proj,   // (B, 4H)
                 const float* __restrict__ h,        // (B, H)
                 const float* __restrict__ c,        // (B, H)
                 const WT* __restrict__ w,           // (H, 4H)
                 float* __restrict__ h_out,          // (B, H)
                 float* __restrict__ c_out,          // (B, H)
                 int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                          // (ROWS, H)
  float* red = smem + (size_t)ROWS * H;      // (NW, 4, ROWS, UNITS)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ul = lane & (UNITS - 1);
  const int slice = warp * (32 / UNITS) + (lane >> 3);
  const int u = blockIdx.x * UNITS + ul;
  const size_t H4 = (size_t)4 * H;

  for (int b0 = 0; b0 < B; b0 += ROWS) {
    __syncthreads();               // the previous pass is done with smem
    for (int idx = threadIdx.x; idx < ROWS * H; idx += NT) {
      const int b = b0 + idx / H;
      hs[idx] = b < B ? as_input<WT>(__ldg(h + (size_t)b0 * H + idx)) : 0.0f;
    }
    __syncthreads();

    float acc[4][ROWS];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int bb = 0; bb < ROWS; ++bb) acc[g][bb] = 0.0f;
#pragma unroll 2
    for (int i = slice; i < H; i += SLICES) {
      const WT* wr = w + (size_t)i * H4 + u;
      const float w0 = load1(wr), w1 = load1(wr + H);
      const float w2 = load1(wr + 2 * H), w3 = load1(wr + 3 * H);
#pragma unroll
      for (int bb = 0; bb < ROWS; ++bb) {
        const float hv = hs[bb * H + i];
        acc[0][bb] = fmaf(w0, hv, acc[0][bb]);
        acc[1][bb] = fmaf(w1, hv, acc[1][bb]);
        acc[2][bb] = fmaf(w2, hv, acc[2][bb]);
        acc[3][bb] = fmaf(w3, hv, acc[3][bb]);
      }
    }
    // the warp's four slices, then one partial a warp into shared memory
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int bb = 0; bb < ROWS; ++bb) {
        float v = acc[g][bb];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < UNITS)
          red[((warp * 4 + g) * ROWS + bb) * UNITS + ul] = v;
      }
    __syncthreads();

    if (threadIdx.x < ROWS * UNITS) {
      const int bb = threadIdx.x / UNITS, k = threadIdx.x & (UNITS - 1);
      const int b = b0 + bb, uu = blockIdx.x * UNITS + k;
      if (b < B) {
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float s = 0.0f;
#pragma unroll
          for (int wq = 0; wq < NW; ++wq)
            s += red[((wq * 4 + g) * ROWS + bb) * UNITS + k];
          gate[g] = __ldg(x_proj + (size_t)b * H4 + (size_t)g * H + uu) + s;
        }
        const size_t o = (size_t)b * H + uu;
        const float cn = sigmoidf_(gate[1]) * __ldg(c + o)
                         + sigmoidf_(gate[0]) * tanhf(gate[2]);
        c_out[o] = cn;
        h_out[o] = sigmoidf_(gate[3]) * tanhf(cn);
      }
    }
  }
}

template <typename WT>
int launch(const void* const* ptrs, int B, int H, void* stream) {
  const void* kernel = (const void*)lstm_cell_kernel<WT>;
  const size_t smem = smem_bytes(H);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  lstm_cell_kernel<WT><<<H / UNITS, NT, smem, (cudaStream_t)stream>>>(
      (const float*)ptrs[0], (const float*)ptrs[1], (const float*)ptrs[2],
      (const WT*)ptrs[3], (float*)ptrs[4], (float*)ptrs[5], B, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lstm_cell_units(void) { return UNITS; }

size_t lstm_cell_smem_bytes(int H) { return smem_bytes(H); }

const char* lstm_cell_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launch one LSTM step on ``stream``; returns a cudaError_t code (0 =
// launched).  ``ptrs``: x_proj, h, c, w_hh_t, h_out, c_out (device
// pointers; the outputs must not overlap the inputs); ``bf16`` != 0 for
// a bf16 w_hh_t.  H must be a multiple of lstm_cell_units().
int lstm_cell_launch(const void* const* ptrs, int B, int H, int bf16,
                     void* stream) {
  return bf16 ? launch<uint16_t>(ptrs, B, H, stream)
              : launch<float>(ptrs, B, H, stream);
}

}  // extern "C"
