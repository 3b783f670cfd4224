// Tacotron-2 inference decoder kernels for Hopper (sm_90a).
//
// decoder_loop_kernel replaces
// msa_tts_tpu/models/pallas_decoder.py::make_pallas_decoder_infer (step
// body _bind_step): the whole autoregressive loop, early exit included,
// runs in ONE persistent cooperative launch.  decoder_segment_kernel
// replaces make_pallas_decoder_segment: a fixed number of steps from a
// carried state, no early exit, for streaming; chained segments give
// the whole-loop kernel's bits.  Both run one shared step function
// (decoder_step).  Each step is a sequence of phases separated by
// grid-wide barriers:
//
//   1. prenet layer 1      (one block per output unit, its threads
//                           splitting the dot product)
//   2. prenet layer 2
//   3. attention LSTM      (two warps per hidden unit: its 4 gate rows)
//   4. query projection    (one block per output)
//   5. attention energies  (one warp per (row, encoder position): the
//                           location conv and dense, v·tanh(...); and one
//                           warp per row for the previous step's
//                           transition agent u)
//   6. attention           (several blocks per batch row, each
//                           normalising the row redundantly, then
//                           summing its slice of the context)
//   7. decoder LSTM
//   8. mel projection and gate (one block per output)
//   9. finished / mel_lengths bookkeeping, done redundantly by every
//      block from the gates of step t (no extra barrier), so every block
//      takes the same exit branch.
//
// What bounds it on an H100: every step reads all decoder weights.  At
// the shipped width (E = 768, H = Hd = 1024, P = 256, A = 128, r = 2)
// that is ~20.46 M floats, ~82 MB in f32 — more than the 50 MB L2, so
// each step streams them from HBM: ~24 us per step at the 3.35 TB/s
// datasheet bandwidth, before the eight barriers and the latency-bound
// attention phases.  The design keeps every weight row read coalesced
// (lanes walk the contiguous input dimension of a (out, in) row; the
// LSTM rows, 98% of the bytes, as 16-byte loads from rows the wrapper
// pads to a multiple of 4 floats) and stages the step's input vectors
// in shared memory once per block, so the only HBM stream is the
// weights.  wgmma, TMA and bf16 weights are
// left for later work.
//
// State that one phase writes while other blocks still read it is
// double-buffered (attention and decoder LSTM h/c, cumulative weights,
// alpha); everything else is written in one phase and read in later
// ones.  Cross-block state is read with __ldcg (L2, never a possibly
// stale L1 line).
//
// The C entry points take plain pointers and return a cudaError_t code,
// so the library is loaded with ctypes and needs no PyTorch headers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;            // threads per block
constexpr int NW = NT / 32;        // warps per block
constexpr int BCH = 4;             // batch rows per staged chunk
constexpr float MASK_VALUE = -1e30f;

enum Ptr {
  P_ENC, P_PIN, P_MASK, P_PREMASK,
  P_W_PRE1, P_W_PRE2, P_W_ATT, P_B_ATT, P_W_Q, P_W_LOC, P_W_LOCD,
  P_V_W, P_V_B, P_W_TA, P_B_TA, P_W_DEC, P_B_DEC, P_W_PG, P_B_PG,
  P_MELS, P_GATES, P_ALIGNS, P_MLEN, P_NSTEPS, P_SCRATCH, P_PHASE_NS,
  N_PTRS
};

constexpr int N_STAMPS = 10;       // phase_ns entries per step

enum Dim {
  D_B, D_T, D_E, D_H, D_HD, D_P, D_A, D_F, D_K, D_MR, D_S,
  D_EARLY, D_LOC, D_FWD, D_TAGENT, D_SIGMOID, D_MASKEN, N_DIMS
};

struct Params {
  const float* enc;      // (B, T, E)
  const float* pin;      // (B, T, A)
  const float* mask;     // (B, T) 1 = valid
  const float* premask;  // (S, 2, B, P) raw 0/1
  const float* w_pre1;   // (P, MR)
  const float* w_pre2;   // (P, P)
  const float* w_att;    // (4H, ld4(P+E+H))  [weight_ih | weight_hh | 0]
  const float* b_att;    // (4H)         bias_ih + bias_hh
  const float* w_q;      // (A, H)
  const float* w_loc;    // (F, 2, K)
  const float* w_locd;   // (A, F)
  const float* v_w;      // (A)
  const float* v_b;      // (1)
  const float* w_ta;     // (E+H)        [context | query]
  const float* b_ta;     // (1)
  const float* w_dec;    // (4Hd, ld4(H+E+Hd))
  const float* b_dec;    // (4Hd)
  const float* w_pg;     // (MR+1, Hd+E) projection rows, then the gate
  const float* b_pg;     // (MR+1)
  float* mels;           // (S, B, MR)
  float* gates;          // (S, B)
  float* aligns;         // (S, B, T)
  int* mel_lengths;      // (B)
  int* n_steps;          // (1)
  unsigned long long* phase_ns;  // (S, N_STAMPS) or null: see stamp()
  // scratch state
  float* ah[2]; float* ac[2]; float* dh[2]; float* dc[2];
  float* cum[2]; float* alpha[2];
  float* ctx; float* aw; float* u;
  float* din; float* p1; float* p2; float* pq; float* e;
  int B, T, E, H, Hd, P, A, F, K, MR, S;
  int early, loc, fwd, tagent, sigmoid_norm, mask_en;
  float keep, gate_threshold;
};

size_t scratch_floats(const int* d) {
  size_t B = d[D_B];
  return B * (4 * (size_t)d[D_H] + 4 * (size_t)d[D_HD] + d[D_E]
              + 6 * (size_t)d[D_T] + 1 + d[D_MR] + 2 * (size_t)d[D_P]
              + d[D_A]);
}

int imax(int a, int b) { return a > b ? a : b; }

// Row length of the LSTM weights and their staged inputs: the input
// length rounded up to 4 floats, for 16-byte loads.
__host__ __device__ int ld4(int n) { return (n + 3) & ~3; }

size_t stage_floats(const int* d) {
  int kx = imax(d[D_P] + d[D_E] + d[D_H], d[D_H] + d[D_E] + d[D_HD]);
  kx = imax(kx, d[D_HD] + d[D_E]);
  kx = imax(kx, imax(d[D_MR], imax(d[D_P], d[D_H])));
  int rows = d[D_B] < BCH ? d[D_B] : BCH;
  return (size_t)rows * ld4(kx);
}

// The attention's location and energy weights stay in shared memory for
// the whole launch (loaded once, ~24 KB at the shipped width).
__host__ __device__ size_t resident_floats(int A, int F, int K) {
  return (size_t)A * F + 2 * (size_t)F * K + A;
}

size_t energy_floats(const int* d) {
  return (size_t)NW * (2 * d[D_K] + d[D_F]);
}

size_t row_floats(const int* d) {
  return 3 * (size_t)d[D_T] + (size_t)NW * d[D_E];
}

constexpr int RED_FLOATS = 2 * BCH * NW;   // block-reduction scratch

// Shared-memory header: not_finished (B), mel_lengths (B) and the alive
// count as ints, rounded up to 16 bytes, then the reduction scratch.
__host__ __device__ size_t int_header_bytes(int B) {
  return ((size_t)(2 * B + 1) * sizeof(int) + 15) / 16 * 16;
}

__host__ __device__ size_t header_bytes(int B) {
  return int_header_bytes(B) + RED_FLOATS * sizeof(float);
}

size_t smem_bytes(const int* d) {
  size_t body = stage_floats(d);
  if (energy_floats(d) > body) body = energy_floats(d);
  if (row_floats(d) > body) body = row_floats(d);
  return header_bytes(d[D_B])
         + (resident_floats(d[D_A], d[D_F], d[D_K]) + body) * sizeof(float);
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Opt-in phase timing: with a phase_ns buffer, block 0 writes the device
// clock (ns) into phase_ns[t * N_STAMPS + k]: k = 0 at the start of step
// t, 1-8 after its phase barriers, 9 after the stop bookkeeping.  A null
// buffer (the default) skips it.
__device__ __forceinline__ void stamp(const Params& p, int t, int k) {
  if (p.phase_ns != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    p.phase_ns[(size_t)t * N_STAMPS + k] = ns;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum or max; every thread gets the result.  ``red`` holds
// at least NW + 1 floats.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();                 // red may still be read from a prior call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < NW ? red[lane] : (MAX ? -CUDART_INF_F : 0.0f);
    x = MAX ? warp_max(x) : warp_sum(x);
    if (lane == 0) red[NW] = x;
  }
  __syncthreads();
  return red[NW];
}

// Sums acc[bb] (bb < nb) over the block; afterwards warp 0 holds the
// totals in acc.  ``red`` holds BCH * NW floats.
__device__ void block_sum_n(float (&acc)[BCH], int nb, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int bb = 0; bb < BCH; ++bb) {
    if (bb < nb) {
      const float v = warp_sum(acc[bb]);
      if (lane == 0) red[bb * NW + warp] = v;
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int bb = 0; bb < BCH; ++bb)
      if (bb < nb) acc[bb] = warp_sum(lane < NW ? red[bb * NW + lane] : 0.0f);
  }
  __syncthreads();                 // red is reused by the next call
}

// Copy rows [b0, b0 + nb) of the concatenation [s0 (n0) | s1 (n1) |
// s2 (n2)] of (B, n) row-major buffers into xs (nb, ld), zero-filling
// the padding up to ld, through L2.
__device__ void stage_x(float* xs, int b0, int nb, int ld,
                        const float* s0, int n0, const float* s1, int n1,
                        const float* s2, int n2) {
  for (int idx = threadIdx.x; idx < nb * ld; idx += NT) {
    const int bb = idx / ld, i = idx - bb * ld, b = b0 + bb;
    float v = 0.0f;
    if (i < n0) v = __ldcg(s0 + (size_t)b * n0 + i);
    else if (i < n0 + n1) v = __ldcg(s1 + (size_t)b * n1 + (i - n0));
    else if (i < n0 + n1 + n2) v = __ldcg(s2 + (size_t)b * n2 + (i - n0 - n1));
    xs[idx] = v;
  }
}

__device__ __forceinline__ float dot4(float4 w, float4 x, float acc) {
  acc = fmaf(w.x, x.x, acc);
  acc = fmaf(w.y, x.y, acc);
  acc = fmaf(w.z, x.z, acc);
  return fmaf(w.w, x.w, acc);
}

// Hidden unit u's four gate rows (u, H+u, 2H+u, 3H+u) of W (4H, ld)
// against every staged batch row, then the LSTM cell.  Two warps of one
// block share a unit, each streaming half of the rows (twice the bytes
// in flight of one warp per unit); the second hands its partial sums to
// the first through ``red``.  Units go round-robin over blocks.
__device__ void lstm_phase(float* xs, float* red, int B, int N,
                           const float* W, const float* bias,
                           const float* s0, int n0, const float* s1, int n1,
                           const float* s2, int n2,
                           const float* c_in, float* h_out, float* c_out) {
  if ((int)blockIdx.x >= N) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pair = warp >> 1, side = warp & 1;
  constexpr int NP = NW / 2;                     // unit slots per block
  const int G = gridDim.x;
  const int per_block = (N + G - 1) / G;
  const int ld = ld4(n0 + n1 + n2), nv = ld >> 2, half = (nv + 1) / 2;
  const int i_lo = side ? half : 0, i_hi = side ? nv : half;
  const float4* xs4 = reinterpret_cast<const float4*>(xs);
  float* my_red = red + pair * 4 * BCH;
  for (int b0 = 0; b0 < B; b0 += BCH) {
    const int nb = B - b0 < BCH ? B - b0 : BCH;
    __syncthreads();
    stage_x(xs, b0, nb, ld, s0, n0, s1, n1, s2, n2);
    __syncthreads();
    for (int slot0 = 0; slot0 < per_block; slot0 += NP) {
      const int u = blockIdx.x + (slot0 + pair) * G;
      float acc[4][BCH];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int bb = 0; bb < BCH; ++bb) acc[g][bb] = 0.0f;
      if (u < N) {
        const float4* w0 = reinterpret_cast<const float4*>(W + (size_t)u * ld);
        const float4* w1 = w0 + (size_t)N * nv;
        const float4* w2 = w1 + (size_t)N * nv;
        const float4* w3 = w2 + (size_t)N * nv;
#pragma unroll 2
        for (int i = i_lo + lane; i < i_hi; i += 32) {
          const float4 a0 = __ldg(w0 + i), a1 = __ldg(w1 + i);
          const float4 a2 = __ldg(w2 + i), a3 = __ldg(w3 + i);
#pragma unroll
          for (int bb = 0; bb < BCH; ++bb) {
            if (bb < nb) {
              const float4 x = xs4[bb * nv + i];
              acc[0][bb] = dot4(a0, x, acc[0][bb]);
              acc[1][bb] = dot4(a1, x, acc[1][bb]);
              acc[2][bb] = dot4(a2, x, acc[2][bb]);
              acc[3][bb] = dot4(a3, x, acc[3][bb]);
            }
          }
        }
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int bb = 0; bb < BCH; ++bb)
            if (bb < nb) acc[g][bb] = warp_sum(acc[g][bb]);
        if (side == 1 && lane == 0) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int bb = 0; bb < BCH; ++bb) my_red[g * BCH + bb] = acc[g][bb];
        }
      }
      __syncthreads();
      if (u < N && side == 0) {
#pragma unroll
        for (int bb = 0; bb < BCH; ++bb) {
          if (bb < nb && lane == bb) {
            const float gi = acc[0][bb] + my_red[0 * BCH + bb] + __ldg(bias + u);
            const float gf = acc[1][bb] + my_red[1 * BCH + bb] + __ldg(bias + N + u);
            const float gg = acc[2][bb] + my_red[2 * BCH + bb] + __ldg(bias + 2 * N + u);
            const float go = acc[3][bb] + my_red[3 * BCH + bb] + __ldg(bias + 3 * N + u);
            const size_t o = (size_t)(b0 + bb) * N + u;
            const float c = sigmoidf_(gf) * __ldcg(c_in + o)
                            + sigmoidf_(gi) * tanhf(gg);
            c_out[o] = c;
            h_out[o] = sigmoidf_(go) * tanhf(c);
          }
        }
      }
      __syncthreads();             // red is reused by the next slot
    }
  }
}

enum LinMode { LIN_PRENET, LIN_QUERY, LIN_PROJ };

// One block per output row j of W (N, kx): the block's threads split the
// dot product against every staged batch row, then the mode's epilogue.
// For the small layers (N of a few hundred rows) this keeps all SMs
// streaming instead of a few hundred warps walking long rows serially.
template <int MODE>
__device__ void linear_phase(const Params& p, float* xs, float* red, int N,
                             int kx, const float* W, const float* s0, int n0,
                             const float* s1, int n1, float* out,
                             int layer, int t) {
  const bool block_busy = (int)blockIdx.x < N;
  if (!block_busy) return;
  for (int b0 = 0; b0 < p.B; b0 += BCH) {
    const int nb = p.B - b0 < BCH ? p.B - b0 : BCH;
    __syncthreads();
    stage_x(xs, b0, nb, kx, s0, n0, s1, n1, nullptr, 0);
    __syncthreads();
    for (int j = blockIdx.x; j < N; j += gridDim.x) {
      float acc[BCH];
#pragma unroll
      for (int bb = 0; bb < BCH; ++bb) acc[bb] = 0.0f;
      const float* w = W + (size_t)j * kx;
      for (int i = threadIdx.x; i < kx; i += NT) {
        const float a = __ldg(w + i);
#pragma unroll
        for (int bb = 0; bb < BCH; ++bb)
          if (bb < nb) acc[bb] = fmaf(a, xs[bb * kx + i], acc[bb]);
      }
      block_sum_n(acc, nb, red);
      if (threadIdx.x == 0) {
#pragma unroll
        for (int bb = 0; bb < BCH; ++bb) {
          if (bb >= nb) continue;
          const int b = b0 + bb;
          const float y = acc[bb];
          if (MODE == LIN_PRENET) {
            const float m = __ldg(
                p.premask + (((size_t)t * 2 + layer) * p.B + b) * p.P + j);
            out[(size_t)b * N + j] = fmaxf(y, 0.0f) / p.keep * m;
          } else if (MODE == LIN_QUERY) {
            out[(size_t)b * N + j] = y;
          } else {
            const float v = y + __ldg(p.b_pg + j);
            if (j < p.MR) {
              p.mels[((size_t)t * p.B + b) * p.MR + j] = v;
              p.din[(size_t)b * p.MR + j] = v;
            } else {
              p.gates[(size_t)t * p.B + b] = v;
            }
          }
        }
      }
    }
  }
}

// The location and energy weights, loaded once per launch, transposed
// so that lanes (over a, or over f) hit distinct banks:
// s_wd[f * A + a] = w_locd[a, f]; s_wl[(k * 2 + c) * F + f] = w_loc[f, c, k];
// then v.
__device__ void load_resident(const Params& p, float* s_wres) {
  const int A = p.A, F = p.F, K = p.K;
  float* s_wd = s_wres;
  float* s_wl = s_wd + A * F;
  float* s_v = s_wl + 2 * F * K;
  for (int i = threadIdx.x; i < A * F; i += NT) {
    const int a = i / F, f = i - a * F;
    s_wd[f * A + a] = __ldg(p.w_locd + i);
  }
  for (int i = threadIdx.x; i < 2 * F * K; i += NT) {
    const int f = i / (2 * K), ck = i - f * 2 * K;
    const int c = ck / K, k = ck - c * K;
    s_wl[(k * 2 + c) * F + f] = __ldg(p.w_loc + i);
  }
  for (int i = threadIdx.x; i < A; i += NT) s_v[i] = __ldg(p.v_w + i);
  __syncthreads();
}

// The transition agent of row b, by one warp:
// u[b] = sigmoid(w_ta · [ctx, attention h] + b_ta), written by lane 0.
// The energy phase of step t computes step t-1's agent with it, and the
// segment kernel its last step's, so both give the same bits.
__device__ void agent_u(const Params& p, int b, const float* ah,
                        float* u_out) {
  const int lane = threadIdx.x & 31;
  const float* ctx = p.ctx + (size_t)b * p.E;
  const float* h = ah + (size_t)b * p.H;
  float z = 0.0f;
  for (int i = lane; i < p.E; i += 32)
    z = fmaf(__ldcg(ctx + i), __ldg(p.w_ta + i), z);
  for (int i = lane; i < p.H; i += 32)
    z = fmaf(__ldcg(h + i), __ldg(p.w_ta + p.E + i), z);
  z = warp_sum(z);
  if (lane == 0) u_out[b] = sigmoidf_(z + __ldg(p.b_ta));
}

// Phase 5: the energy of every (row b, encoder position tt), one warp
// each: e = v · tanh(pq[b] + loc[tt] + pin[b, tt]) + v_b, masked to -1e30
// where asked.  loc[tt, f] is the K-tap conv over the previous and the
// cumulative attention weights, zero-padded (K-1)/2 per side, followed
// (in the dense) by the F -> A projection.  With ``agent`` (every step
// of a launch but its first: the carried u is already current there), B
// more warps compute the transition agent of the previous step: ctx and
// the previous h are still intact here, and phase 6 is the first to
// read u.
__device__ void energy_phase(const Params& p, const float* s_wres, float* sm,
                             bool agent, int cur) {
  const int T = p.T, A = p.A, F = p.F, K = p.K;
  const int items = p.B * T;
  const int n_ta = (agent && p.fwd && p.tagent) ? p.B : 0;
  if ((int)blockIdx.x >= items + n_ta) return;   // warp 0 has item blockIdx
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* s_wd = s_wres;                     // see load_resident
  const float* s_wl = s_wd + A * F;
  const float* s_v = s_wl + 2 * F * K;
  float* s_win = sm + warp * (2 * K + F);         // this warp's window
  float* s_loc = s_win + 2 * K;                   // and its loc[f]
  const float v_b = __ldg(p.v_b);
  const int pad = (K - 1) / 2;
  const int worker = warp * gridDim.x + blockIdx.x;
  const float* cum = p.cum[cur];
  for (int item = worker; item < items + n_ta; item += NW * gridDim.x) {
    if (item >= items) {
      agent_u(p, item - items, p.ah[cur], p.u);
      continue;
    }
    const int b = item / T, tt = item - b * T;
    const float* pq = p.pq + (size_t)b * A;
    const float* pin = p.pin + ((size_t)b * T + tt) * A;
    float q[4];                    // the first 128 of A, loaded early
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = lane + 32 * j;
      q[j] = a < A ? __ldcg(pq + a) + __ldg(pin + a) : 0.0f;
    }
    if (p.loc) {
      for (int k = lane; k < K; k += 32) {
        const int j = tt + k - pad;
        const bool in = j >= 0 && j < T;
        s_win[k] = in ? __ldcg(p.aw + (size_t)b * T + j) : 0.0f;
        s_win[K + k] = in ? __ldcg(cum + (size_t)b * T + j) : 0.0f;
      }
      __syncwarp();
      for (int f = lane; f < F; f += 32) {
        float acc = 0.0f;
        for (int k = 0; k < K; ++k) {
          acc = fmaf(s_wl[(2 * k) * F + f], s_win[k], acc);
          acc = fmaf(s_wl[(2 * k + 1) * F + f], s_win[K + k], acc);
        }
        s_loc[f] = acc;
      }
      __syncwarp();
    }
    float part = 0.0f;
    for (int a0 = 0; a0 < A; a0 += 128) {     // 4 independent chains a lane
      float pl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (a0 > 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int a = a0 + lane + 32 * j;
          q[j] = a < A ? __ldcg(pq + a) + __ldg(pin + a) : 0.0f;
        }
      }
      if (p.loc) {
        for (int f = 0; f < F; ++f) {
          const float l = s_loc[f];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int a = a0 + lane + 32 * j;
            if (a < A) pl[j] = fmaf(l, s_wd[f * A + a], pl[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int a = a0 + lane + 32 * j;
        if (a < A) part = fmaf(s_v[a], tanhf(q[j] + pl[j]), part);
      }
    }
    float e = warp_sum(part) + v_b;
    if (p.mask_en && __ldg(p.mask + (size_t)b * T + tt) <= 0.0f) e = MASK_VALUE;
    if (lane == 0) p.e[(size_t)b * T + tt] = e;
    __syncwarp();                  // s_win / s_loc are rewritten next item
  }
}

// Phase 6, one (row b, slice s of nslice) item per block: normalise the
// row's energies (softmax with the row max subtracted, or normalised
// sigmoid), the forward recursion and the cumulative weights — each
// slice redundantly, slice 0 writing them — then the slice's part of
// context = Σ_t align[t] · enc[b, t, :] (warp w sums t ≡ w mod NW, lanes
// over E; the NW partials are added in a fixed order).
__device__ void attention_slice(const Params& p, float* sm, float* s_red,
                                int b, int sl, int nslice, int t, int cur) {
  const int T = p.T, E = p.E;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nxt = cur ^ 1;
  const int e_lo = (int)((long long)E * sl / nslice);
  const int W = (int)((long long)E * (sl + 1) / nslice) - e_lo;
  float* s_cum = sm;
  float* s_alpha = s_cum + T;
  float* s_e = s_alpha + T;
  float* s_part = s_e + T;         // NW x W

  __syncthreads();                 // sm may still be in use
  for (int i = threadIdx.x; i < T; i += NT) {
    s_cum[i] = __ldcg(p.cum[cur] + (size_t)b * T + i);
    s_alpha[i] = __ldcg(p.alpha[cur] + (size_t)b * T + i);
    s_e[i] = __ldcg(p.e + (size_t)b * T + i);
  }
  const float u = __ldcg(p.u + b);
  __syncthreads();

  // normalise: softmax (row max subtracted) or normalised sigmoid
  if (p.sigmoid_norm) {
    float part = 0.0f;
    for (int i = threadIdx.x; i < T; i += NT) {
      const float s = sigmoidf_(s_e[i]);
      s_e[i] = s;
      part += s;
    }
    const float sum = block_reduce<false>(part, s_red);
    for (int i = threadIdx.x; i < T; i += NT) s_e[i] = s_e[i] / sum;
  } else {
    float m = -CUDART_INF_F;
    for (int i = threadIdx.x; i < T; i += NT) m = fmaxf(m, s_e[i]);
    m = block_reduce<true>(m, s_red);
    float part = 0.0f;
    for (int i = threadIdx.x; i < T; i += NT) {
      const float x = expf(s_e[i] - m);
      s_e[i] = x;
      part += x;
    }
    const float sum = block_reduce<false>(part, s_red);
    for (int i = threadIdx.x; i < T; i += NT) s_e[i] = s_e[i] / sum;
  }
  __syncthreads();

  if (p.loc)
    for (int i = threadIdx.x; i < T; i += NT) s_cum[i] += s_e[i];
  if (p.fwd) {
    float part = 0.0f;
    for (int i = threadIdx.x; i < T; i += NT) {
      const float shifted = i > 0 ? s_alpha[i - 1] : 0.0f;
      const float a = ((1.0f - u) * s_alpha[i] + u * shifted + 1e-8f) * s_e[i];
      s_e[i] = a;
      part += a;
    }
    const float sum = block_reduce<false>(part, s_red);   // syncs first
    for (int i = threadIdx.x; i < T; i += NT) {
      const float a = s_e[i] / sum;
      s_e[i] = a;
      s_alpha[i] = a;
    }
  }
  __syncthreads();

  if (sl == 0) {
    for (int i = threadIdx.x; i < T; i += NT) {
      const float a = s_e[i];
      p.aw[(size_t)b * T + i] = a;
      p.cum[nxt][(size_t)b * T + i] = s_cum[i];
      p.alpha[nxt][(size_t)b * T + i] = s_alpha[i];
      p.aligns[((size_t)t * p.B + b) * T + i] = a;
    }
  }

  constexpr int CG = 8;            // 32-wide e chunks per pass and lane
  for (int e0 = 0; e0 < W; e0 += 32 * CG) {
    float acc[CG];
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[c] = 0.0f;
    for (int tt = warp; tt < T; tt += NW) {
      const float a = s_e[tt];
      const float* row = p.enc + ((size_t)b * T + tt) * E + e_lo + e0 + lane;
#pragma unroll
      for (int c = 0; c < CG; ++c)
        if (e0 + lane + 32 * c < W) acc[c] = fmaf(a, __ldg(row + 32 * c), acc[c]);
    }
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const int e = e0 + lane + 32 * c;
      if (e < W) s_part[warp * W + e] = acc[c];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < W; e += NT) {
    float acc = 0.0f;
    for (int w = 0; w < NW; ++w) acc += s_part[w * W + e];
    p.ctx[(size_t)b * E + e_lo + e] = acc;
  }
}

// A block's shared memory: the not_finished (B) and mel_lengths (B)
// rows and the alive count, the reduction scratch, the resident
// attention weights, then the phases' working space.
struct Smem {
  int* nf; int* mlen; int* alive;
  float* red; float* wres; float* body;
};

__device__ Smem smem_views(const Params& p, unsigned char* raw) {
  Smem s;
  s.nf = reinterpret_cast<int*>(raw);
  s.mlen = s.nf + p.B;
  s.alive = s.mlen + p.B;
  s.red = reinterpret_cast<float*>(raw + int_header_bytes(p.B));
  s.wres = reinterpret_cast<float*>(raw + header_bytes(p.B));
  s.body = s.wres + resident_floats(p.A, p.F, p.K);
  return s;
}

// Context slices per row: enough to use the grid, at least 32 wide.  A
// slice only moves columns of E between blocks; each column's sum is
// taken in the same order whatever the count, so a row's values do not
// depend on B or on the grid.
__device__ int context_slices(const Params& p) {
  int nslice = (int)gridDim.x / p.B;
  if (nslice > (p.E + 31) / 32) nslice = (p.E + 31) / 32;
  return nslice < 1 ? 1 : nslice;
}

// One decoder step, phases 1-8 and the stop bookkeeping: the body both
// kernels share (the counterpart of pallas_decoder.py::_bind_step).
// ``t`` is the step's index in this launch: it picks the double buffers
// (t & 1 holds the state the step reads) and indexes the prenet masks,
// the outputs and the phase stamps.  Returns the number of rows still
// unfinished, the same in every block.
__device__ int decoder_step(const Params& p, cg::grid_group& grid,
                            const Smem& s, int t, int nslice) {
  const int B = p.B;
  const int cur = t & 1, nxt = cur ^ 1;
  stamp(p, t, 0);

  linear_phase<LIN_PRENET>(p, s.body, s.red, p.P, p.MR, p.w_pre1, p.din,
                           p.MR, nullptr, 0, p.p1, 0, t);
  grid.sync();
  stamp(p, t, 1);
  linear_phase<LIN_PRENET>(p, s.body, s.red, p.P, p.P, p.w_pre2, p.p1, p.P,
                           nullptr, 0, p.p2, 1, t);
  grid.sync();
  stamp(p, t, 2);
  lstm_phase(s.body, s.red, B, p.H, p.w_att, p.b_att,
             p.p2, p.P, p.ctx, p.E, p.ah[cur], p.H,
             p.ac[cur], p.ah[nxt], p.ac[nxt]);
  grid.sync();
  stamp(p, t, 3);
  linear_phase<LIN_QUERY>(p, s.body, s.red, p.A, p.H, p.w_q, p.ah[nxt], p.H,
                          nullptr, 0, p.pq, 0, t);
  grid.sync();
  stamp(p, t, 4);
  energy_phase(p, s.wres, s.body, t > 0, cur);
  grid.sync();
  stamp(p, t, 5);
  for (int item = blockIdx.x; item < B * nslice; item += gridDim.x)
    attention_slice(p, s.body, s.red, item / nslice, item % nslice, nslice,
                    t, cur);
  grid.sync();
  stamp(p, t, 6);
  lstm_phase(s.body, s.red, B, p.Hd, p.w_dec, p.b_dec,
             p.ah[nxt], p.H, p.ctx, p.E, p.dh[cur], p.Hd,
             p.dc[cur], p.dh[nxt], p.dc[nxt]);
  grid.sync();
  stamp(p, t, 7);
  linear_phase<LIN_PROJ>(p, s.body, s.red, p.MR + 1, p.Hd + p.E, p.w_pg,
                         p.dh[nxt], p.Hd, p.ctx, p.E, nullptr, 0, t);
  grid.sync();
  stamp(p, t, 8);

  // a row stops once sigmoid(gate) <= threshold is false; mel_lengths
  // counts the steps after which it is still unfinished
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int b = 0; b < B; ++b) {
      const float g = __ldcg(p.gates + (size_t)t * B + b);
      const int dec = sigmoidf_(g) <= p.gate_threshold ? 1 : 0;
      s.nf[b] *= dec;
      s.mlen[b] += s.nf[b];
      n += s.nf[b];
    }
    *s.alive = n;
  }
  __syncthreads();
  const int alive = *s.alive;
  stamp(p, t, 9);
  return alive;
}

__global__ void __launch_bounds__(NT)
decoder_loop_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem s = smem_views(p, smem_raw);

  const int B = p.B, T = p.T;
  const size_t gtid = (size_t)blockIdx.x * NT + threadIdx.x;
  const size_t gsize = (size_t)gridDim.x * NT;

  // ---- state init (reference: decoder.py:_init_carry, init_attn_state)
  for (size_t i = gtid; i < (size_t)B * p.H; i += gsize) {
    p.ah[0][i] = 0.0f; p.ac[0][i] = 0.0f;
  }
  for (size_t i = gtid; i < (size_t)B * p.Hd; i += gsize) {
    p.dh[0][i] = 0.0f; p.dc[0][i] = 0.0f;
  }
  for (size_t i = gtid; i < (size_t)B * p.E; i += gsize) p.ctx[i] = 0.0f;
  for (size_t i = gtid; i < (size_t)B * T; i += gsize) {
    p.aw[i] = 0.0f;
    p.cum[0][i] = 0.0f;
    p.alpha[0][i] = (i % T) == 0 ? 1.0f : 1e-7f;
  }
  for (size_t i = gtid; i < (size_t)B; i += gsize) p.u[i] = 0.5f;
  for (size_t i = gtid; i < (size_t)B * p.MR; i += gsize) p.din[i] = 0.0f;
  for (int b = threadIdx.x; b < B; b += NT) { s.nf[b] = 1; s.mlen[b] = 0; }
  load_resident(p, s.wres);
  grid.sync();

  const int nslice = context_slices(p);
  int alive = B;
  int t = 0;
  for (; t < p.S; ++t) {
    if (p.early && alive == 0) break;          // identical in every block
    alive = decoder_step(p, grid, s, t, nslice);
  }
  if (blockIdx.x == 0) {
    for (int b = threadIdx.x; b < B; b += NT) p.mel_lengths[b] = s.mlen[b];
    if (threadIdx.x == 0) p.n_steps[0] = t;
  }
}

// ---------------------------------------------------------------------
// Segment kernel (replaces pallas_decoder.py::make_pallas_decoder_segment)
// ---------------------------------------------------------------------

// The carried stream state, in the order of the JAX kernel's st_shapes:
// din (B, MR), ah / ac (B, H), dh / dc (B, Hd), ctx (B, E), aw / cum /
// alpha (B, T), u (B); then not_finished and mel_lengths (B) as ints.
enum SegField {
  S_DIN, S_AH, S_AC, S_DH, S_DC, S_CTX, S_AW, S_CUM, S_ALPHA, S_U,
  N_SEG_F
};
constexpr int N_SEG_PTRS = 2 * N_SEG_F + 4;   // in, out, nf/mlen in, out

struct SegState {
  const float* in[N_SEG_F];
  float* out[N_SEG_F];
  const int* nf_in; const int* mlen_in;
  int* nf_out; int* mlen_out;
};

__device__ size_t seg_field_floats(const Params& p, int f) {
  const size_t B = p.B;
  switch (f) {
    case S_DIN: return B * p.MR;
    case S_AH: case S_AC: return B * p.H;
    case S_DH: case S_DC: return B * p.Hd;
    case S_CTX: return B * p.E;
    case S_U: return B;
    default: return B * p.T;                 // aw, cum, alpha
  }
}

// The scratch buffer that holds field f for the state of double-buffer
// index k (0 at entry, S & 1 after S steps).
__device__ float* seg_field_ptr(const Params& p, int f, int k) {
  switch (f) {
    case S_DIN: return p.din;
    case S_AH: return p.ah[k];
    case S_AC: return p.ac[k];
    case S_DH: return p.dh[k];
    case S_DC: return p.dc[k];
    case S_CTX: return p.ctx;
    case S_AW: return p.aw;
    case S_CUM: return p.cum[k];
    case S_ALPHA: return p.alpha[k];
    default: return p.u;
  }
}

// p.S fixed steps (the segment length) from the carried state, with no
// early exit: rows past their gate keep computing, as in the JAX
// segment kernel.  The carried u is already the agent of the step
// before the segment, so the first step skips the deferred agent
// (decoder_step passes t > 0), and after the last step a tail computes
// that step's agent with the same device function before the state is
// written out — without it the carried u would be one step stale and
// every later segment would drift from the whole-loop kernel.
__global__ void __launch_bounds__(NT)
decoder_segment_kernel(Params p, SegState st) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem s = smem_views(p, smem_raw);
  const size_t gtid = (size_t)blockIdx.x * NT + threadIdx.x;
  const size_t gsize = (size_t)gridDim.x * NT;

  for (int f = 0; f < N_SEG_F; ++f) {
    const size_t n = seg_field_floats(p, f);
    float* dst = seg_field_ptr(p, f, 0);
    for (size_t i = gtid; i < n; i += gsize) dst[i] = __ldg(st.in[f] + i);
  }
  for (int b = threadIdx.x; b < p.B; b += NT) {
    s.nf[b] = __ldg(st.nf_in + b);
    s.mlen[b] = __ldg(st.mlen_in + b);
  }
  load_resident(p, s.wres);
  grid.sync();

  const int nslice = context_slices(p);
  for (int t = 0; t < p.S; ++t) decoder_step(p, grid, s, t, nslice);

  // every phase of the last step has passed its barrier: the state is
  // final in buffer S & 1, and nothing reads the scratch u any more
  const int fin = p.S & 1;
  if (p.fwd && p.tagent) {
    const int worker = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
    for (int b = worker; b < p.B; b += NW * gridDim.x)
      agent_u(p, b, p.ah[fin], st.out[S_U]);
  } else {
    for (size_t i = gtid; i < (size_t)p.B; i += gsize)
      st.out[S_U][i] = __ldcg(p.u + i);
  }
  for (int f = 0; f < S_U; ++f) {
    const size_t n = seg_field_floats(p, f);
    const float* src = seg_field_ptr(p, f, fin);
    for (size_t i = gtid; i < n; i += gsize) st.out[f][i] = __ldcg(src + i);
  }
  if (blockIdx.x == 0) {
    for (int b = threadIdx.x; b < p.B; b += NT) {
      st.nf_out[b] = s.nf[b];
      st.mlen_out[b] = s.mlen[b];
    }
  }
}

// Fill the kernel parameters from the C entry's arrays (see
// decoder_loop_launch) and carve the scratch buffer.
void fill_params(Params& p, const void* const* ptrs, const int* dims,
                 const float* fparams) {
  p.enc = (const float*)ptrs[P_ENC];
  p.pin = (const float*)ptrs[P_PIN];
  p.mask = (const float*)ptrs[P_MASK];
  p.premask = (const float*)ptrs[P_PREMASK];
  p.w_pre1 = (const float*)ptrs[P_W_PRE1];
  p.w_pre2 = (const float*)ptrs[P_W_PRE2];
  p.w_att = (const float*)ptrs[P_W_ATT];
  p.b_att = (const float*)ptrs[P_B_ATT];
  p.w_q = (const float*)ptrs[P_W_Q];
  p.w_loc = (const float*)ptrs[P_W_LOC];
  p.w_locd = (const float*)ptrs[P_W_LOCD];
  p.v_w = (const float*)ptrs[P_V_W];
  p.v_b = (const float*)ptrs[P_V_B];
  p.w_ta = (const float*)ptrs[P_W_TA];
  p.b_ta = (const float*)ptrs[P_B_TA];
  p.w_dec = (const float*)ptrs[P_W_DEC];
  p.b_dec = (const float*)ptrs[P_B_DEC];
  p.w_pg = (const float*)ptrs[P_W_PG];
  p.b_pg = (const float*)ptrs[P_B_PG];
  p.mels = (float*)ptrs[P_MELS];
  p.gates = (float*)ptrs[P_GATES];
  p.aligns = (float*)ptrs[P_ALIGNS];
  p.mel_lengths = (int*)ptrs[P_MLEN];
  p.n_steps = (int*)ptrs[P_NSTEPS];
  p.phase_ns = (unsigned long long*)ptrs[P_PHASE_NS];

  p.B = dims[D_B]; p.T = dims[D_T]; p.E = dims[D_E]; p.H = dims[D_H];
  p.Hd = dims[D_HD]; p.P = dims[D_P]; p.A = dims[D_A]; p.F = dims[D_F];
  p.K = dims[D_K]; p.MR = dims[D_MR]; p.S = dims[D_S];
  p.early = dims[D_EARLY]; p.loc = dims[D_LOC]; p.fwd = dims[D_FWD];
  p.tagent = dims[D_TAGENT]; p.sigmoid_norm = dims[D_SIGMOID];
  p.mask_en = dims[D_MASKEN];
  p.keep = fparams[0];
  p.gate_threshold = fparams[1];

  float* s = (float*)ptrs[P_SCRATCH];
  const size_t B = p.B;
  for (int k = 0; k < 2; ++k) { p.ah[k] = s; s += B * p.H; }
  for (int k = 0; k < 2; ++k) { p.ac[k] = s; s += B * p.H; }
  for (int k = 0; k < 2; ++k) { p.dh[k] = s; s += B * p.Hd; }
  for (int k = 0; k < 2; ++k) { p.dc[k] = s; s += B * p.Hd; }
  p.ctx = s; s += B * p.E;
  p.aw = s; s += B * p.T;
  for (int k = 0; k < 2; ++k) { p.cum[k] = s; s += B * p.T; }
  for (int k = 0; k < 2; ++k) { p.alpha[k] = s; s += B * p.T; }
  p.u = s; s += B;
  p.din = s; s += B * p.MR;
  p.p1 = s; s += B * p.P;
  p.p2 = s; s += B * p.P;
  p.pq = s; s += B * p.A;
  p.e = s; s += B * p.T;
}

// One cooperative launch of ``kernel`` on ``stream``: two blocks an SM
// where they fit, else one.  Returns a cudaError_t code.
int launch_cooperative(const void* kernel, void** args, const int* dims,
                       void* stream) {
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
  const int grid = n_sm * (occ < 2 ? occ : 2);
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(NT), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t decoder_loop_scratch_floats(const int* dims) {
  return scratch_floats(dims);
}

size_t decoder_loop_smem_bytes(const int* dims) { return smem_bytes(dims); }

const char* decoder_loop_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launch the whole decode on ``stream``; returns a cudaError_t code
// (0 = launched).  ``ptrs``: N_PTRS device pointers in Ptr order, the
// last (phase_ns) null unless the caller times the phases;
// ``dims``: N_DIMS ints in Dim order; ``fparams``: {keep, threshold}.
int decoder_loop_launch(const void* const* ptrs, const int* dims,
                        const float* fparams, void* stream) {
  Params p;
  fill_params(p, ptrs, dims, fparams);
  void* args[] = {&p};
  return launch_cooperative((const void*)decoder_loop_kernel, args, dims,
                            stream);
}

// Launch one segment of dims[D_S] steps on ``stream``; returns a
// cudaError_t code.  ``ptrs``: the N_PTRS pointers of
// decoder_loop_launch (mels, gates, aligns and the prenet masks sized by
// the segment; mel_lengths and n_steps unused), then N_SEG_PTRS state
// pointers: the N_SEG_F float fields in, the same out, then
// not_finished in, mel_lengths in, not_finished out, mel_lengths out
// (int32).  In and out must not overlap.
int decoder_segment_launch(const void* const* ptrs, const int* dims,
                           const float* fparams, void* stream) {
  Params p;
  fill_params(p, ptrs, dims, fparams);
  SegState st;
  const void* const* sp = ptrs + N_PTRS;
  for (int f = 0; f < N_SEG_F; ++f) {
    st.in[f] = (const float*)sp[f];
    st.out[f] = (float*)sp[N_SEG_F + f];
  }
  st.nf_in = (const int*)sp[2 * N_SEG_F];
  st.mlen_in = (const int*)sp[2 * N_SEG_F + 1];
  st.nf_out = (int*)sp[2 * N_SEG_F + 2];
  st.mlen_out = (int*)sp[2 * N_SEG_F + 3];
  void* args[] = {&p, &st};
  return launch_cooperative((const void*)decoder_segment_kernel, args, dims,
                            stream);
}

int decoder_segment_n_ptrs(void) { return N_PTRS + N_SEG_PTRS; }

}  // extern "C"
