// WaveRNN sample-loop kernel for Hopper (sm_90a).
//
// wavernn_loop_kernel replaces
// msa_tts_tpu/vocoders/pallas_gen.py::make_pallas_generate (body
// _make_kernel): the whole autoregressive sample loop, all T steps for
// all B fold rows, runs in ONE persistent cooperative launch.  Per step:
//
//   1. GRU 1 on z = i_static[t] + x * w_x, then z1 = z + h1
//   2. GRU 2 on [z1, aux slice 0], then z2 = z1 + h2
//   3. fc1 + ReLU on [z2, aux slice 1]
//   4. fc2 + ReLU on [f1, aux slice 2]
//   5. fc3 logits and the sample (mixture of logistics from pre-drawn
//      gumbel and logistic noise, or a Gaussian from pre-drawn normal
//      noise), which feeds step t + 1
//
// each phase ending at a grid-wide barrier, because each reads all of
// the previous one's output.  The five matrix products are computed
// here, in the kernel's own loops (dot_tile); no library is called.
//
// What bounds it on an H100: every step reads all sample-loop weights,
// 3.77 M of them at the default width (15.07 MB in f32, 7.53 MB in bf16),
// which fit the 50 MB L2, so after the first step they stream from L2,
// not from HBM; at B rows a step also does 2 * 3.77 M * B float
// operations.  Both floors are a few microseconds; the five dependent
// barriers and the staging of each phase's inputs come on top.  The
// design spreads each layer's output units round-robin over the blocks,
// reads every weight row coalesced (lanes walk the contiguous input
// dimension of an (out, in) row, 16 bytes a lane in f32, 8 in bf16),
// stages the phase's input rows in shared memory once per block in
// chunks of STAGE_ROWS rows (so any B is served), and gives a warp a
// tile of ROW_TILE rows of one unit, so each weight value it loads is
// used ROW_TILE times.  fc3 stays in shared memory for the whole
// launch.  Weights resident in shared memory across steps and tensor
// cores for B >= 16 are left for later work.
//
// A row's sums are taken in an order fixed by the widths alone, never
// by B or the grid, so a row's samples do not depend on its batch.
//
// bf16 weights: the stored matrices are bf16, every product's input is
// rounded to bf16 (round to nearest even) where it is staged, products
// and sums are f32, biases and gate math f32 — the contraction of
// wavernn._mm.  State that one phase writes while other blocks still
// read it (h1, h2) is double-buffered; cross-block state is read with
// __ldcg (L2, never a possibly stale L1 line).
//
// The C entry points take plain pointers and return a cudaError_t code,
// so the library is loaded with ctypes and needs no PyTorch headers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;            // threads per block
constexpr int NW = NT / 32;        // warps per block
constexpr int ROW_TILE = 4;        // batch rows per warp work item
constexpr int STAGE_ROWS = 16;     // batch rows staged at a time
constexpr int FC_ROWS = 2;         // fc output units per warp work item
constexpr int LOGIT_GROUP = 6;     // fc3 outputs summed together
constexpr int STAGE_UNROLL = 4;    // 16-byte loads in flight per thread
constexpr float LOG_SCALE_MIN = -32.23619130191664f;   // log(1e-14)
constexpr float LOG_STD_MIN = -7.0f;

enum Ptr {
  P_ISTATIC, P_AREST, P_N1, P_N2,
  P_RNN1_IH, P_RNN1_HH, P_RNN1_BIH, P_RNN1_BHH,
  P_RNN2_IH_Z, P_RNN2_IH_A, P_RNN2_HH, P_RNN2_BIH, P_RNN2_BHH,
  P_FC1_Z, P_FC1_A, P_FC1_B, P_FC2_Z, P_FC2_A, P_FC2_B,
  P_FC3_W, P_FC3_B, P_W_X,
  P_OUT, P_SCRATCH, N_PTRS
};

enum Dim { D_T, D_B, D_R, D_F, D_D, D_NC, D_K, D_GAUSS, D_BF16, N_DIMS };

// Weight matrices are (out, in) row-major, float or bf16 (WT); biases
// and w_x are float.
template <typename WT>
struct Params {
  const float* i_static;   // (T, B, R)
  const float* a_rest;     // (T, B, 3 D) or null when D == 0
  const float* n1;         // (T, B, K) mixture noise (MOL) or null
  const float* n2;         // (T, B) sample noise
  const WT* rnn1_ih;       // (3R, R)
  const WT* rnn1_hh;       // (3R, R)
  const float* rnn1_bih; const float* rnn1_bhh;   // (3R)
  const WT* rnn2_ih_z;     // (3R, R)
  const WT* rnn2_ih_a;     // (3R, D)
  const WT* rnn2_hh;       // (3R, R)
  const float* rnn2_bih; const float* rnn2_bhh;
  const WT* fc1_z;         // (F, R)
  const WT* fc1_a;         // (F, D)
  const float* fc1_b;
  const WT* fc2_z;         // (F, F)
  const WT* fc2_a;         // (F, D)
  const float* fc2_b;
  const WT* fc3_w;         // (NC, F)
  const float* fc3_b;      // (NC)
  const float* w_x;        // (R)
  float* out;              // (B, T)
  // scratch state
  float* x;                // (B) previous sample
  float* h1[2]; float* h2[2];          // (B, R)
  float* z1; float* z2;                // (B, R)
  float* f1; float* f2;                // (B, F)
  int T, B, R, F, D, NC, K, gauss;
};

size_t scratch_floats(const int* d) {
  const size_t B = d[D_B];
  // the previous samples take B floats rounded up to 4, so that every
  // other buffer starts 16-byte aligned
  return ((B + 3) & ~(size_t)3) + B * (6 * (size_t)d[D_R] + 2 * (size_t)d[D_F]);
}

int imax(int a, int b) { return a > b ? a : b; }

// Shared memory: the staging area (two inputs of STAGE_ROWS rows, or one
// fc3 input row per warp), fc3 resident as floats, and NC logits a warp.
size_t stage_floats(const int* d) {
  const int k = imax(d[D_R], d[D_F]);
  return (size_t)imax(2 * STAGE_ROWS * k, NW * d[D_F]);
}

size_t smem_bytes(const int* d) {
  return (stage_floats(d) + (size_t)d[D_NC] * d[D_F]
          + (size_t)NW * d[D_NC]) * sizeof(float);
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// float -> bf16 -> float, round to nearest even (what a cast does).
__device__ __forceinline__ float round_bf16(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return v;          // NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// The rounding a product's input gets: none for float weights.
template <typename WT> __device__ __forceinline__ float as_input(float v);
template <> __device__ __forceinline__ float as_input<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float as_input<uint16_t>(float v) {
  return round_bf16(v);
}

// Four consecutive weights starting at w (16- or 8-byte aligned).
__device__ __forceinline__ float4 load4(const float* w) {
  return __ldg(reinterpret_cast<const float4*>(w));
}
__device__ __forceinline__ float4 load4(const uint16_t* w) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(w));
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xffff0000u));
}
__device__ __forceinline__ float load1(const float* w) { return __ldg(w); }
__device__ __forceinline__ float load1(const uint16_t* w) {
  return __uint_as_float((uint32_t)__ldg(w) << 16);
}

__device__ __forceinline__ float dot4(float4 w, float4 x, float acc) {
  acc = fmaf(w.x, x.x, acc);
  acc = fmaf(w.y, x.y, acc);
  acc = fmaf(w.z, x.z, acc);
  return fmaf(w.w, x.w, acc);
}

// This lane's part of NR weight rows (each n floats, n % 4 == 0) against
// ROW_TILE staged input rows xs (ROW_TILE, n): lanes walk the rows 16
// bytes at a time.
template <typename WT, int NR>
__device__ __forceinline__ void dot_tile(float (&acc)[NR][ROW_TILE],
                                         const WT* const (&w)[NR], int n,
                                         const float* xs, int lane) {
  const int n4 = n >> 2;
  for (int i = lane; i < n4; i += 32) {
    float4 wv[NR];
#pragma unroll
    for (int g = 0; g < NR; ++g) wv[g] = load4(w[g] + 4 * i);
#pragma unroll
    for (int bb = 0; bb < ROW_TILE; ++bb) {
      const float4 x = *reinterpret_cast<const float4*>(xs + bb * n + 4 * i);
#pragma unroll
      for (int g = 0; g < NR; ++g) acc[g][bb] = dot4(wv[g], x, acc[g][bb]);
    }
  }
}

// The aux part of the same NR outputs: weight rows wa (each D floats)
// against slice ``off`` of a_rest[t] for rows b0 .. b0 + ROW_TILE.
template <typename WT, int NR>
__device__ __forceinline__ void dot_aux(float (&acc)[NR][ROW_TILE],
                                        const WT* const (&wa)[NR],
                                        const float* a_t, int D, int off,
                                        int b0, int B, int lane) {
  for (int l = lane; l < D; l += 32) {
    float wv[NR];
#pragma unroll
    for (int g = 0; g < NR; ++g) wv[g] = load1(wa[g] + l);
#pragma unroll
    for (int bb = 0; bb < ROW_TILE; ++bb) {
      const int b = b0 + bb;
      const float a = b < B
          ? as_input<WT>(__ldg(a_t + (size_t)b * 3 * D + off + l)) : 0.0f;
#pragma unroll
      for (int g = 0; g < NR; ++g) acc[g][bb] = fmaf(wv[g], a, acc[g][bb]);
    }
  }
}

template <typename WT>
__device__ __forceinline__ float4 as_input4(float4 v) {
  return make_float4(as_input<WT>(v.x), as_input<WT>(v.y),
                     as_input<WT>(v.z), as_input<WT>(v.w));
}

// Stage rows [b0, b0 + STAGE_ROWS) of a (B, n) buffer into xs
// (STAGE_ROWS, n), rounded as a product input, zeros past row B.  Each
// thread moves 16 bytes at a time and starts all its loads before its
// first store, so a chunk costs one trip to L2, not one per element.
// ``load(b, i)`` gives elements i .. i + 3 of row b.

template <typename WT, typename Load>
__device__ __forceinline__ void stage_chunk(float* xs, int b0, int B, int n,
                                            Load load) {
  const int n4 = n >> 2, total = STAGE_ROWS * n4;
  for (int base = threadIdx.x; base < total; base += NT * STAGE_UNROLL) {
    float4 v[STAGE_UNROLL];
#pragma unroll
    for (int k = 0; k < STAGE_UNROLL; ++k) {
      const int idx = base + k * NT;
      const int bb = idx / n4, i = (idx - bb * n4) << 2;
      v[k] = (idx < total && b0 + bb < B)
          ? load(b0 + bb, i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int k = 0; k < STAGE_UNROLL; ++k) {
      const int idx = base + k * NT;
      if (idx < total)
        reinterpret_cast<float4*>(xs)[idx] = as_input4<WT>(v[k]);
    }
  }
}

template <typename WT>
__device__ void stage_rows(float* xs, const float* src, int b0, int B, int n) {
  stage_chunk<WT>(xs, b0, B, n, [=](int b, int i) {
    return __ldcg(reinterpret_cast<const float4*>(src + (size_t)b * n + i));
  });
}

// z[b, i] = i_static[t, b, i] + x[b] * w_x[i], the product rounded
// before the sum as the plain version's two operations are.
__device__ __forceinline__ float z_sum(float is, float x, float wx) {
  return __fadd_rn(is, __fmul_rn(x, wx));
}

template <typename WT>
__device__ __forceinline__ float z_of(const Params<WT>& p, int t, int b,
                                      int i) {
  return z_sum(__ldg(p.i_static + ((size_t)t * p.B + b) * p.R + i),
               __ldcg(p.x + b), __ldg(p.w_x + i));
}

template <typename WT>
__device__ void stage_z(const Params<WT>& p, float* xs, int t, int b0) {
  const float* ist = p.i_static + (size_t)t * p.B * p.R;
  const float* x = p.x;
  const float* w_x = p.w_x;
  const int R = p.R;
  stage_chunk<WT>(xs, b0, p.B, R, [=](int b, int i) {
    const float4 s = __ldg(reinterpret_cast<const float4*>(
        ist + (size_t)b * R + i));
    const float4 w = __ldg(reinterpret_cast<const float4*>(w_x + i));
    const float xb = __ldcg(x + b);
    return make_float4(z_sum(s.x, xb, w.x), z_sum(s.y, xb, w.y),
                       z_sum(s.z, xb, w.z), z_sum(s.w, xb, w.w));
  });
}

// One GRU layer for every row (torch gate order r, z, n).  Unit u's six
// weight rows (u, R + u, 2R + u of w_ih and of w_hh) go to one warp per
// tile of ROW_TILE rows; units go round-robin over blocks.  ``first``
// selects layer 1 (input z computed from the previous sample, output
// z1 = z + h1) or layer 2 (input [z1, aux slice 0], output z2 = z1 + h2).
template <typename WT>
__device__ void gru_phase(const Params<WT>& p, float* xs, int t, bool first,
                          const WT* w_ih, const WT* w_ih_a, const WT* w_hh,
                          const float* b_ih, const float* b_hh,
                          const float* h_in, float* h_out, float* z_out) {
  const int R = p.R, B = p.B, G = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slots = ((int)blockIdx.x < R) ? (R - 1 - (int)blockIdx.x) / G + 1 : 0;
  if (slots == 0) return;
  float* xs_z = xs;
  float* xs_h = xs + STAGE_ROWS * R;
  const float* a_t = p.D ? p.a_rest + (size_t)t * B * 3 * p.D : nullptr;
  constexpr int TILES = STAGE_ROWS / ROW_TILE;
  for (int c0 = 0; c0 < B; c0 += STAGE_ROWS) {
    __syncthreads();               // the previous chunk is done with xs
    if (first) stage_z(p, xs_z, t, c0);
    else stage_rows<WT>(xs_z, p.z1, c0, B, R);
    stage_rows<WT>(xs_h, h_in, c0, B, R);
    __syncthreads();
    const int tiles = (B - c0 < STAGE_ROWS)
        ? (B - c0 + ROW_TILE - 1) / ROW_TILE : TILES;
    for (int item = warp; item < slots * tiles; item += NW) {
      const int s = item / tiles, tile = item - s * tiles;
      const int u = blockIdx.x + s * G;
      const int b0 = c0 + tile * ROW_TILE;
      float gi[3][ROW_TILE], gh[3][ROW_TILE];
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int bb = 0; bb < ROW_TILE; ++bb) { gi[g][bb] = 0.0f; gh[g][bb] = 0.0f; }
      const WT* const wi[3] = {w_ih + (size_t)u * R,
                               w_ih + (size_t)(R + u) * R,
                               w_ih + (size_t)(2 * R + u) * R};
      const WT* const wh[3] = {w_hh + (size_t)u * R,
                               w_hh + (size_t)(R + u) * R,
                               w_hh + (size_t)(2 * R + u) * R};
      dot_tile<WT, 3>(gi, wi, R, xs_z + tile * ROW_TILE * R, lane);
      dot_tile<WT, 3>(gh, wh, R, xs_h + tile * ROW_TILE * R, lane);
      if (!first && p.D) {
        const WT* const wa[3] = {w_ih_a + (size_t)u * p.D,
                                 w_ih_a + (size_t)(R + u) * p.D,
                                 w_ih_a + (size_t)(2 * R + u) * p.D};
        dot_aux<WT, 3>(gi, wa, a_t, p.D, 0, b0, B, lane);
      }
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int bb = 0; bb < ROW_TILE; ++bb) {
          gi[g][bb] = warp_sum(gi[g][bb]);
          gh[g][bb] = warp_sum(gh[g][bb]);
        }
#pragma unroll
      for (int bb = 0; bb < ROW_TILE; ++bb) {
        const int b = b0 + bb;
        if (lane == bb && b < B) {
          const float i_r = gi[0][bb] + __ldg(b_ih + u);
          const float i_z = gi[1][bb] + __ldg(b_ih + R + u);
          const float i_n = gi[2][bb] + __ldg(b_ih + 2 * R + u);
          const float h_r = gh[0][bb] + __ldg(b_hh + u);
          const float h_z = gh[1][bb] + __ldg(b_hh + R + u);
          const float h_n = gh[2][bb] + __ldg(b_hh + 2 * R + u);
          const float r = sigmoidf_(i_r + h_r);
          const float zg = sigmoidf_(i_z + h_z);
          const float n = tanhf(i_n + r * h_n);
          const size_t o = (size_t)b * R + u;
          const float h = (1.0f - zg) * n + zg * __ldcg(h_in + o);
          h_out[o] = h;
          const float zin = first ? z_of(p, t, b, u) : __ldcg(p.z1 + o);
          z_out[o] = zin + h;
        }
      }
    }
  }
}

// One fully connected layer with ReLU for every row:
// out[b, j] = relu(w_z[j] . in[b] + w_a[j] . aux slice + bias[j]).
// FC_ROWS outputs go to one warp per tile of ROW_TILE rows.
template <typename WT>
__device__ void fc_phase(const Params<WT>& p, float* xs, int t, int N, int n,
                         const WT* w_z, const WT* w_a, const float* bias,
                         int aux_off, const float* in, float* out) {
  const int B = p.B, G = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (N + FC_ROWS - 1) / FC_ROWS;
  const int slots = ((int)blockIdx.x < groups)
      ? (groups - 1 - (int)blockIdx.x) / G + 1 : 0;
  if (slots == 0) return;
  const float* a_t = p.D ? p.a_rest + (size_t)t * B * 3 * p.D : nullptr;
  constexpr int TILES = STAGE_ROWS / ROW_TILE;
  for (int c0 = 0; c0 < B; c0 += STAGE_ROWS) {
    __syncthreads();
    stage_rows<WT>(xs, in, c0, B, n);
    __syncthreads();
    const int tiles = (B - c0 < STAGE_ROWS)
        ? (B - c0 + ROW_TILE - 1) / ROW_TILE : TILES;
    for (int item = warp; item < slots * tiles; item += NW) {
      const int s = item / tiles, tile = item - s * tiles;
      const int j0 = (blockIdx.x + s * G) * FC_ROWS;
      const int b0 = c0 + tile * ROW_TILE;
      float acc[FC_ROWS][ROW_TILE];
      const WT* wz[FC_ROWS];
      const WT* wa[FC_ROWS];
      int jj[FC_ROWS];
#pragma unroll
      for (int g = 0; g < FC_ROWS; ++g) {
        jj[g] = j0 + g < N ? j0 + g : N - 1;     // a clamped copy, dropped
        wz[g] = w_z + (size_t)jj[g] * n;
        wa[g] = w_a + (size_t)jj[g] * p.D;
#pragma unroll
        for (int bb = 0; bb < ROW_TILE; ++bb) acc[g][bb] = 0.0f;
      }
      dot_tile<WT, FC_ROWS>(acc, wz, n, xs + tile * ROW_TILE * n, lane);
      if (p.D) dot_aux<WT, FC_ROWS>(acc, wa, a_t, p.D, aux_off, b0, B, lane);
#pragma unroll
      for (int g = 0; g < FC_ROWS; ++g)
#pragma unroll
        for (int bb = 0; bb < ROW_TILE; ++bb) acc[g][bb] = warp_sum(acc[g][bb]);
#pragma unroll
      for (int g = 0; g < FC_ROWS; ++g)
#pragma unroll
        for (int bb = 0; bb < ROW_TILE; ++bb) {
          const int b = b0 + bb;
          if (lane == g * ROW_TILE + bb && b < B && j0 + g < N)
            out[(size_t)b * N + jj[g]] =
                fmaxf(acc[g][bb] + __ldg(bias + jj[g]), 0.0f);
        }
    }
  }
}

// fc3 and the sample, one warp per row: logits = w3 . f2[b] + b3 from
// the resident copy of w3, then by lane 0 the mixture-of-logistics
// sample (first argmax of logits[:K] + gumbel, the selected mean and
// log-scale clamped at log 1e-14) or the Gaussian sample (log-std
// clamped at -7), clipped to [-1, 1].
template <typename WT>
__device__ void sample_phase(const Params<WT>& p, float* xs,
                             const float* s_w3, float* s_logits, int t) {
  const int B = p.B, F = p.F, NC = p.NC, K = p.K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* row = xs + warp * F;
  float* logits = s_logits + warp * NC;
  __syncthreads();                 // the staging area is free again
  for (int b = warp * gridDim.x + blockIdx.x; b < B; b += NW * gridDim.x) {
    const float4* src4 = reinterpret_cast<const float4*>(p.f2 + (size_t)b * F);
    for (int i0 = lane; i0 < (F >> 2); i0 += 32 * STAGE_UNROLL) {
      float4 v[STAGE_UNROLL];          // all loads before the first store
#pragma unroll
      for (int k = 0; k < STAGE_UNROLL; ++k)
        if (i0 + 32 * k < (F >> 2)) v[k] = __ldcg(src4 + i0 + 32 * k);
#pragma unroll
      for (int k = 0; k < STAGE_UNROLL; ++k)
        if (i0 + 32 * k < (F >> 2))
          reinterpret_cast<float4*>(row)[i0 + 32 * k] = as_input4<WT>(v[k]);
    }
    __syncwarp();
    for (int j0 = 0; j0 < NC; j0 += LOGIT_GROUP) {
      float acc[LOGIT_GROUP];
      const float* w[LOGIT_GROUP];
#pragma unroll
      for (int g = 0; g < LOGIT_GROUP; ++g) {
        acc[g] = 0.0f;
        w[g] = s_w3 + (size_t)(j0 + g < NC ? j0 + g : NC - 1) * F;
      }
      for (int i = lane; i < F; i += 32) {
        const float xv = row[i];
#pragma unroll
        for (int g = 0; g < LOGIT_GROUP; ++g) acc[g] = fmaf(w[g][i], xv, acc[g]);
      }
#pragma unroll
      for (int g = 0; g < LOGIT_GROUP; ++g) {
        acc[g] = warp_sum(acc[g]);
        if (lane == 0 && j0 + g < NC)
          logits[j0 + g] = acc[g] + __ldg(p.fc3_b + j0 + g);
      }
    }
    __syncwarp();
    if (lane == 0) {
      const float noise = __ldg(p.n2 + (size_t)t * B + b);
      float mean, log_scale;
      if (p.gauss) {
        mean = logits[0];
        log_scale = fmaxf(logits[1], LOG_STD_MIN);
      } else {
        const float* g1 = p.n1 + ((size_t)t * B + b) * K;
        int sel = 0;
        float best = logits[0] + __ldg(g1);
        for (int k = 1; k < K; ++k) {
          const float v = logits[k] + __ldg(g1 + k);
          if (v > best) { best = v; sel = k; }   // ties keep the lowest k
        }
        mean = logits[K + sel];
        log_scale = fmaxf(logits[2 * K + sel], LOG_SCALE_MIN);
      }
      const float s = fminf(fmaxf(
          __fadd_rn(mean, __fmul_rn(expf(log_scale), noise)), -1.0f), 1.0f);
      p.x[b] = s;
      p.out[(size_t)b * p.T + t] = s;
    }
    __syncwarp();                  // row and logits are rewritten next row
  }
}

template <typename WT>
__global__ void __launch_bounds__(NT)
wavernn_loop_kernel(Params<WT> p, int stage_n) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* s_w3 = smem + stage_n;
  float* s_logits = s_w3 + (size_t)p.NC * p.F;

  const size_t gtid = (size_t)blockIdx.x * NT + threadIdx.x;
  const size_t gsize = (size_t)gridDim.x * NT;
  for (size_t i = gtid; i < (size_t)p.B * p.R; i += gsize) {
    p.h1[0][i] = 0.0f;
    p.h2[0][i] = 0.0f;
  }
  for (size_t i = gtid; i < (size_t)p.B; i += gsize) p.x[i] = 0.0f;
  for (int i = threadIdx.x; i < p.NC * p.F; i += NT)
    s_w3[i] = load1(p.fc3_w + i);
  grid.sync();

  for (int t = 0; t < p.T; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    gru_phase<WT>(p, xs, t, true, p.rnn1_ih, nullptr, p.rnn1_hh,
                  p.rnn1_bih, p.rnn1_bhh, p.h1[cur], p.h1[nxt], p.z1);
    grid.sync();
    gru_phase<WT>(p, xs, t, false, p.rnn2_ih_z, p.rnn2_ih_a, p.rnn2_hh,
                  p.rnn2_bih, p.rnn2_bhh, p.h2[cur], p.h2[nxt], p.z2);
    grid.sync();
    fc_phase<WT>(p, xs, t, p.F, p.R, p.fc1_z, p.fc1_a, p.fc1_b, p.D,
                 p.z2, p.f1);
    grid.sync();
    fc_phase<WT>(p, xs, t, p.F, p.F, p.fc2_z, p.fc2_a, p.fc2_b, 2 * p.D,
                 p.f1, p.f2);
    grid.sync();
    sample_phase<WT>(p, xs, s_w3, s_logits, t);
    grid.sync();
  }
}

template <typename WT>
void fill_params(Params<WT>& p, const void* const* ptrs, const int* d) {
  p.i_static = (const float*)ptrs[P_ISTATIC];
  p.a_rest = (const float*)ptrs[P_AREST];
  p.n1 = (const float*)ptrs[P_N1];
  p.n2 = (const float*)ptrs[P_N2];
  p.rnn1_ih = (const WT*)ptrs[P_RNN1_IH];
  p.rnn1_hh = (const WT*)ptrs[P_RNN1_HH];
  p.rnn1_bih = (const float*)ptrs[P_RNN1_BIH];
  p.rnn1_bhh = (const float*)ptrs[P_RNN1_BHH];
  p.rnn2_ih_z = (const WT*)ptrs[P_RNN2_IH_Z];
  p.rnn2_ih_a = (const WT*)ptrs[P_RNN2_IH_A];
  p.rnn2_hh = (const WT*)ptrs[P_RNN2_HH];
  p.rnn2_bih = (const float*)ptrs[P_RNN2_BIH];
  p.rnn2_bhh = (const float*)ptrs[P_RNN2_BHH];
  p.fc1_z = (const WT*)ptrs[P_FC1_Z];
  p.fc1_a = (const WT*)ptrs[P_FC1_A];
  p.fc1_b = (const float*)ptrs[P_FC1_B];
  p.fc2_z = (const WT*)ptrs[P_FC2_Z];
  p.fc2_a = (const WT*)ptrs[P_FC2_A];
  p.fc2_b = (const float*)ptrs[P_FC2_B];
  p.fc3_w = (const WT*)ptrs[P_FC3_W];
  p.fc3_b = (const float*)ptrs[P_FC3_B];
  p.w_x = (const float*)ptrs[P_W_X];
  p.out = (float*)ptrs[P_OUT];
  p.T = d[D_T]; p.B = d[D_B]; p.R = d[D_R]; p.F = d[D_F]; p.D = d[D_D];
  p.NC = d[D_NC]; p.K = d[D_K]; p.gauss = d[D_GAUSS];

  float* s = (float*)ptrs[P_SCRATCH];
  const size_t B = p.B;
  p.x = s; s += (B + 3) & ~(size_t)3;
  for (int k = 0; k < 2; ++k) { p.h1[k] = s; s += B * p.R; }
  for (int k = 0; k < 2; ++k) { p.h2[k] = s; s += B * p.R; }
  p.z1 = s; s += B * p.R;
  p.z2 = s; s += B * p.R;
  p.f1 = s; s += B * p.F;
  p.f2 = s; s += B * p.F;
}

// One cooperative launch on ``stream``, one block an SM.  Returns a
// cudaError_t code.
template <typename WT>
int launch(const void* const* ptrs, const int* dims, void* stream) {
  Params<WT> p;
  fill_params(p, ptrs, dims);
  int stage_n = (int)stage_floats(dims);
  const void* kernel = (const void*)wavernn_loop_kernel<WT>;
  const size_t smem = smem_bytes(dims);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, n_sm = 0, coop = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)) != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, kernel, NT, smem)) != cudaSuccess)
    return (int)e;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p, &stage_n};
  e = cudaLaunchCooperativeKernel(kernel, dim3(n_sm), dim3(NT), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t wavernn_loop_scratch_floats(const int* dims) {
  return scratch_floats(dims);
}

size_t wavernn_loop_smem_bytes(const int* dims) { return smem_bytes(dims); }

const char* wavernn_loop_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int wavernn_loop_n_ptrs(void) { return N_PTRS; }

// Launch the whole sample loop on ``stream``; returns a cudaError_t code
// (0 = launched).  ``ptrs``: N_PTRS device pointers in Ptr order (a_rest
// and the *_a weights null when dims[D_D] == 0, n1 null in Gaussian
// mode); ``dims``: N_DIMS ints in Dim order, dims[D_BF16] != 0 for bf16
// weight matrices.
int wavernn_loop_launch(const void* const* ptrs, const int* dims,
                        void* stream) {
  return dims[D_BF16] ? launch<uint16_t>(ptrs, dims, stream)
                      : launch<float>(ptrs, dims, stream);
}

}  // extern "C"
