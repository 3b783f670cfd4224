// Tacotron-2 inference decoder kernels for Hopper (sm_90a).
//
// decoder_loop_kernel replaces
// msa_tts_tpu/models/pallas_decoder.py::make_pallas_decoder_infer (step
// body _bind_step): the whole autoregressive loop, early exit included,
// runs in ONE persistent cooperative launch.  decoder_segment_kernel
// replaces make_pallas_decoder_segment: a fixed number of steps from a
// carried state, no early exit, for streaming; chained segments give
// the whole-loop kernel's bits.  Both run one shared step function
// (decoder_step), with float32 or bfloat16 weights (one template).
//
// What bounds it on an H100.  A step is a chain of products that each
// need the whole result of the one before (prenet, attention LSTM,
// query and energies, attention rows, decoder LSTM, projection), so a
// step is a chain of grid-wide exchanges: a barrier (~1.2 us) and the
// first read of what other SMs just wrote (~1 us) each.  98 % of the
// weights are the two LSTMs' (19.9 M values at the shipped width E =
// 768, H = Hd = 1024, P = 256, A = 128, r = 2): 80 MB in float32, more
// than the 50 MB L2, so a float32 step streams them from HBM (~24 us at
// 3.35 TB/s); 40 MB in bfloat16, more than the SMs' shared memory
// (30 MB) but not than shared memory and L2 together.  What does not
// stay in shared memory comes through the L2 at ~2.8 TB/s over the
// grid.  And the step's code is itself fetched through the L2 every
// step (a step's instructions do not fit the instruction cache), so
// code size is time.
//
// What the design does about it:
//   * one block per SM owns a fixed set of hidden units of both LSTMs;
//     their gate rows are stored unit-major and split by input block
//     (attention LSTM: prenet | context | recurrent; decoder LSTM:
//     attention h | context | recurrent), as the TPU kernel splits them.
//     As many of these segments as fit beside the working space stay in
//     the block's shared memory for the whole launch, the ones that run
//     right after an exchange first; the others are read from the L2
//     (bfloat16: they stay there) or streamed from HBM with an
//     evict-first hint (float32: so that they do not push out what the
//     latency-bound phases read);
//   * each LSTM product starts ahead of its phase where its input is
//     known: the decoder LSTM's recurrent columns beside the prenet, the
//     attention LSTM's context and recurrent columns of step t + 1
//     beside the projection of step t; partial sums stay in the owning
//     block's shared memory, and after an exchange only the columns
//     that depend on it remain.  A unit's sum is taken in an order fixed
//     by the widths, so a row's bits depend neither on B nor on what
//     else is decoded beside it;
//   * fewer and shorter exchanges: both prenet layers run in one phase
//     on the grid's last four blocks, which own no LSTM unit at the
//     shipped width and keep the prenet's weights in their shared memory
//     (every block computing layer 1 itself was slower: 132 copies of
//     its weights through the L2 a step); the blocks that compute a
//     row's energies compute its query projection themselves; the
//     projection's rows are resident, one or two a block.  A step has 6
//     grid barriers (8 before);
//   * bfloat16 products of the LSTMs and the prenet run on the tensor
//     cores (mma.sync.m16n8k16: A a tile of 16 weight rows x 16 columns,
//     packed in the instruction's fragment order so that a warp loads it
//     as 32 consecutive 16-byte words; B the staged inputs of up to 8
//     batch rows; float32 sums): a step at B = 4 costs little more than
//     at B = 1, and B = 1 runs the same instructions, so a row's bits do
//     not depend on B.  float32 products are FMAs on 16-byte loads (rows
//     padded to 8 values), small layers by one warp per row with several
//     rows in flight, or by a few threads per row where rows are short;
//   * staging loads are asked for four at a time before the first is
//     stored: one after the other their trips to the L2 add up;
//   * a launch at B = 1 runs an instantiation of the step without the
//     code for further batch rows.
//
// bfloat16 semantics are the TPU kernel's _dot: the input vector of
// every matrix product (the location dense's and the transition agent's
// too, whose weights are held in float32 here) is rounded to bfloat16,
// sums are float32, the state stays float32.
//
// Phases of a step (a grid barrier after each):
//   1. prenet (both layers, the last blocks) + decoder-LSTM partial
//      [recurrent] (every block)
//   2. attention-LSTM partial [prenet], cell
//   3. query + energies (a few blocks per batch row; one more warp for
//      the previous step's transition agent)
//   4. attention rows: normalise, forward recursion, context slices
//   5. decoder-LSTM partial [attention h | context], cell
//   6. mel projection and gate (one warp per output) + the next step's
//      attention-LSTM partial [context | recurrent]
//   then the finished / mel_lengths bookkeeping, done redundantly by
//   every block from the gates of step t (no barrier), so every block
//   takes the same exit branch.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;            // threads per block
constexpr int NW = NT / 32;        // warps per block
constexpr int NP = NW / 2;         // LSTM units a block works on at once
constexpr int BCH = 4;             // batch rows per staged chunk
constexpr int NPB = 4;             // blocks that compute the prenet
constexpr float MASK_VALUE = -1e30f;
constexpr size_t SMEM_MAX = 232448;   // bytes a Hopper block can use

enum Ptr {
  P_ENC, P_PIN, P_MASK, P_PREMASK,
  P_W_PRE1, P_W_PRE2, P_WA_P, P_WA_C, P_WA_H, P_B_ATT, P_W_Q, P_W_LOC,
  P_W_LOCD, P_V_W, P_V_B, P_W_TA, P_B_TA, P_WD_H, P_WD_C, P_WD_HD, P_B_DEC,
  P_W_PG, P_B_PG,
  P_MELS, P_GATES, P_ALIGNS, P_MLEN, P_NSTEPS, P_SCRATCH, P_PHASE_NS,
  N_PTRS
};

// phase_ns entries per step: the start, then for each phase the time
// the stamping block finished its work (W) and the time it left the
// barrier (B), three more inside phase 1 (the prenet's inputs staged,
// its layers done: a prenet block's times; the other blocks pass them
// at once), one more inside phase 3 (query done), and the end.
enum Stamp {
  T_START, T_PRE0, T_PRE1, T_PRE2, T_P1W, T_P1B, T_P2W, T_P2B, T_PQ, T_P3W,
  T_P3B, T_P4W, T_P4B, T_P5W, T_P5B, T_P6W, T_P6B, T_END, N_STAMPS
};

enum Dim {
  D_B, D_T, D_E, D_H, D_HD, D_P, D_A, D_F, D_K, D_MR, D_S,
  D_EARLY, D_LOC, D_FWD, D_TAGENT, D_SIGMOID, D_MASKEN, D_BF16,
  D_STAMP_BLOCK, N_DIMS
};

// The LSTM weight segments: attention LSTM by [prenet | context | h],
// decoder LSTM by [attention h | context | h].
enum Seg { SA_P, SA_C, SA_H, SD_H, SD_C, SD_HD, N_SEGS };

// Which segments get shared memory first: the ones whose products run
// after an exchange (prenet columns, context columns of the decoder
// LSTM), then the ones started ahead.
constexpr int RES_ORDER[N_SEGS] = {SA_P, SD_C, SD_H, SD_HD, SA_C, SA_H};

struct SegDesc {
  const void* w;     // float32: (N, 4, ld) unit-major gate rows; bfloat16:
                     // (unit tiles, kt, 32 lanes, 8) in mma fragment order
  int ld;            // the segment's input columns rounded up to 8
  int kt;            // and in 16-column tiles
  int res_off;       // byte offset in the block's resident area, or -1
};

struct Params {
  const float* enc;      // (B, T, E)
  const float* pin;      // (B, T, A)
  const float* mask;     // (B, T) 1 = valid
  const float* premask;  // (S, 2, B, P) raw 0/1
  const void* w_pre1;    // (P, ld8(MR)) WT
  const void* w_pre2;    // (P, ld8(P)) WT
  SegDesc seg[N_SEGS];
  const float* b_att;    // (4H)         bias_ih + bias_hh
  const void* w_q;       // (A, ld8(H)) WT
  const float* w_loc;    // (F, 2, K)
  const float* w_locd;   // (A, F)
  const float* v_w;      // (A)
  const float* v_b;      // (1)
  const float* w_ta;     // (E+H)        [context | query]
  const float* b_ta;     // (1)
  const float* b_dec;    // (4Hd)
  const void* w_pg;      // (MR+1, ld8(Hd) + ld8(E)) WT, gate row last
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
  float* din; float* p2; float* e;
  int B, T, E, H, Hd, P, A, F, K, MR, S;
  int early, loc, fwd, tagent, sigmoid_norm, mask_en, stamp_block, bf16;
  float keep, gate_threshold;
  // shared-memory layout (bytes from the start), see make_layout
  int off_red, off_wres, off_psa, off_psd, off_wpg, off_body, off_res;
  int res_bytes;         // the resident LSTM area's size
};

__host__ __device__ inline int ld8(int n) { return (n + 7) & ~7; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
inline size_t smax(size_t a, size_t b) { return a > b ? a : b; }

// Hidden units of an N-unit LSTM that one of G blocks owns: consecutive
// units; with bfloat16 weights whole tiles of 4 units (16 gate rows, the
// tensor-core instruction's A tile).
__host__ __device__ inline int units_per_block(int N, int G, int bf16) {
  return bf16 ? 4 * cdiv(cdiv(N, 4), G) : cdiv(N, G);
}

size_t scratch_floats(const int* d) {
  size_t B = d[D_B];
  return B * (4 * (size_t)d[D_H] + 4 * (size_t)d[D_HD] + d[D_E]
              + 6 * (size_t)d[D_T] + 1 + d[D_MR] + d[D_P]);
}

// Context slices per row: enough to use the grid, at least 32 wide.  A
// slice only moves columns of E between blocks; each column's sum is
// taken in the same order whatever the count, so a row's values do not
// depend on B or on the grid.
__host__ __device__ inline int context_slices(int G, int B, int E) {
  int nslice = G / B;
  if (nslice > (E + 31) / 32) nslice = (E + 31) / 32;
  return nslice < 1 ? 1 : nslice;
}

// The attention's location and energy weights stay in shared memory for
// the whole launch (loaded once, ~24 KB at the shipped width).
__host__ __device__ inline size_t wres_floats(int A, int F, int K) {
  return ((size_t)A * F + 2 * (size_t)F * K + A + 3) & ~(size_t)3;
}

constexpr int RED_FLOATS = 2 * BCH * NW;   // block-reduction scratch

// Shared-memory header: not_finished (B), mel_lengths (B) and the alive
// count as ints, rounded up to 16 bytes.
__host__ __device__ inline size_t int_header_bytes(int B) {
  return ((size_t)(2 * B + 1) * sizeof(int) + 15) / 16 * 16;
}

// Staged inputs of the prenet, per batch row: [din | prenet 1 | the two
// layers' dropout masks], and of phase 6: [decoder h | context | attention h] (the projection
// reads the first two as one row), each rounded up to 8 floats.
struct X1 { int din, p1, m0, m1, ld; };
__host__ __device__ inline X1 x1_layout(int MR, int P) {
  X1 x;
  x.din = 0;
  x.p1 = ld8(MR);
  x.m0 = x.p1 + ld8(P);
  x.m1 = x.m0 + ld8(P);
  x.ld = x.m1 + ld8(P);
  return x;
}
struct X6 { int dh, c, h, ld; };
__host__ __device__ inline X6 x6_layout(int Hd, int E, int H) {
  X6 x;
  x.dh = 0;
  x.c = ld8(Hd);
  x.h = x.c + ld8(E);
  x.ld = x.h + ld8(H);
  return x;
}

// A block's shared memory: the int header, the reduction scratch, the
// resident attention weights, the two LSTMs' partial sums (units of the
// block x 4 gates x B), the block's rows of the projection matrix
// (rows blockIdx, blockIdx + grid, ...), the phases' working space, then
// the resident LSTM segments.  ``res_mask`` bit s: segment s is resident.
struct Layout {
  int grid, res_mask;
  size_t off_red, off_wres, off_psa, off_psd, off_wpg, off_body, off_res,
      total;
  int seg_off[N_SEGS];
};

Layout make_layout(const int* d, int n_sm) {
  Layout L;
  const int B = d[D_B], T = d[D_T], E = d[D_E], H = d[D_H], Hd = d[D_HD];
  const int P = d[D_P], A = d[D_A], F = d[D_F], K = d[D_K], MR = d[D_MR];
  const int G = n_sm;
  const size_t esz = d[D_BF16] ? 2 : 4;
  L.grid = G;
  const int bf16 = d[D_BF16];
  const int upa = units_per_block(H, G, bf16);
  const int upd = units_per_block(Hd, G, bf16);
  L.off_red = int_header_bytes(B);
  // bfloat16: the warps' tensor-core sums (NW x 16 rows x 8 columns) meet
  // in the reduction scratch
  L.off_wres = L.off_red
               + (bf16 ? NW * 128 : RED_FLOATS) * sizeof(float);
  L.off_psa = L.off_wres + wres_floats(A, F, K) * sizeof(float);
  L.off_psd = L.off_psa + (size_t)ld8(upa * 4 * B) * sizeof(float);
  L.off_wpg = L.off_psd + (size_t)ld8(upd * 4 * B) * sizeof(float);
  L.off_body = L.off_wpg
               + (size_t)cdiv(MR + 1, G) * (ld8(Hd) + ld8(E)) * esz;
  const int rows = B < BCH ? B : BCH;
  const int nslice = context_slices(G, B, E);
  size_t body = (size_t)rows * x1_layout(MR, P).ld;
  body = smax(body, (size_t)rows * x6_layout(Hd, E, H).ld);
  body = smax(body, (size_t)ld8(H) + ld8(A) + (size_t)NW * (2 * K + F));
  body = smax(body, 3 * (size_t)T + (size_t)NW * cdiv(E, nslice));
  body = (body + 3) & ~(size_t)3;
  L.off_res = L.off_body + body * sizeof(float);
  const int seg_n[N_SEGS] = {P, E, H, H, E, Hd};
  size_t used = L.off_res;
  L.res_mask = 0;
  for (int s = 0; s < N_SEGS; ++s) L.seg_off[s] = -1;
  for (int k = 0; k < N_SEGS; ++k) {
    const int s = RES_ORDER[k];
    const int up = s <= SA_H ? upa : upd;
    const size_t bytes =
        bf16 ? (size_t)(up / 4) * cdiv(seg_n[s], 16) * 512
             : (size_t)up * 4 * ld8(seg_n[s]) * esz;
    if (used + bytes <= SMEM_MAX) {
      L.seg_off[s] = (int)(used - L.off_res);
      L.res_mask |= 1 << s;
      used += bytes;
    }
  }
  L.total = used;
  return L;
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Opt-in phase timing: with a phase_ns buffer, the block stamp_block (0
// by default; the grid's last blocks compute the prenet) writes the
// device clock (ns) into phase_ns[t * N_STAMPS + k], k a Stamp.  A null
// buffer (the default) skips it.
__device__ __forceinline__ void stamp(const Params& p, int t, int k) {
  if (p.phase_ns != nullptr && (int)blockIdx.x == p.stamp_block
      && threadIdx.x == 0) {
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

// ---------------------------------------------------------------------
// Weight types: 16-byte vectors of 4 floats or 8 bf16 values
// ---------------------------------------------------------------------

template <typename WT> struct Vec;

template <> struct Vec<float> {
  static constexpr int EPV = 4;
  static __device__ __forceinline__ void unpack(const uint4& v,
                                                float (&f)[4]) {
    f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
  }
  // the value a product sees for the input x
  static __device__ __forceinline__ float rnd(float x) { return x; }
  // an LSTM row that is not resident: float32 rows exceed the L2 and
  // are used once a step, so they are marked to leave it first and not
  // to push out what the latency-bound phases read from it
  static __device__ __forceinline__ uint4 stream(const uint4* p) {
    return __ldcs(p);
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int EPV = 8;
  static __device__ __forceinline__ void unpack(const uint4& v,
                                                float (&f)[8]) {
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xffff0000u);
    f[4] = __uint_as_float(v.z << 16);
    f[5] = __uint_as_float(v.z & 0xffff0000u);
    f[6] = __uint_as_float(v.w << 16);
    f[7] = __uint_as_float(v.w & 0xffff0000u);
  }
  static __device__ __forceinline__ float rnd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  // bfloat16 rows that are not resident fit the L2: keep them there
  static __device__ __forceinline__ uint4 stream(const uint4* p) {
    return __ldg(p);
  }
};

// Copy rows [b0, b0 + nb) of the (B, n) buffer ``src`` into the staged
// rows xs[bb * xld + xoff + i], as the product sees them (rounded to
// bf16 for bf16 weights), zero-filling up to ld8(n), through L2.
template <typename WT>
__device__ void stage(float* xs, int xld, int xoff, const float* src, int n,
                      int b0, int nb) {
  // a thread asks for four values before it stores the first: the loads
  // are trips to the L2, and one after the other they would add up
  constexpr int U = 4;
  const int w = ld8(n), total = nb * w;
  for (int base = threadIdx.x; base < total; base += U * NT) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * NT, bb = idx / w, i = idx - bb * w;
      v[u] = idx < total && i < n
                 ? Vec<WT>::rnd(__ldcg(src + (size_t)(b0 + bb) * n + i))
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * NT, bb = idx / w, i = idx - bb * w;
      if (idx < total) xs[bb * xld + xoff + i] = v[u];
    }
  }
}

// acc[g][bb] += W[g, :] · x[bb, :] over the 16-byte vectors lo + lane,
// lo + lane + 32, ... < hi of four consecutive rows of nv vectors each
// (a unit's gate rows), against nb <= NB staged input rows (NB is 1 for
// a launch at B = 1, else BCH: a launch runs one of the two, so that the
// step's code stays small).  RES: the rows are in shared memory.
template <typename WT, int NB, bool RES>
__device__ __forceinline__ void seg_dot(const uint4* w, int nv, int lo,
                                        int hi, int lane, const float* xs,
                                        int xld, int nb,
                                        float (&acc)[4][NB]) {
  constexpr int EPV = Vec<WT>::EPV;
  constexpr int UF = RES ? 1 : 2;  // streamed rows: two rounds in flight
#pragma unroll UF
  for (int i = lo + lane; i < hi; i += 32) {
    float wf[4][EPV];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const uint4 a = RES ? w[g * nv + i] : Vec<WT>::stream(w + g * nv + i);
      Vec<WT>::unpack(a, wf[g]);
    }
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) {
      if (NB == 1 || bb < nb) {
        const float4* x4 =
            reinterpret_cast<const float4*>(xs + bb * xld + i * EPV);
#pragma unroll
        for (int q = 0; q < EPV / 4; ++q) {
          const float4 x = x4[q];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            acc[g][bb] = fmaf(wf[g][4 * q + 0], x.x, acc[g][bb]);
            acc[g][bb] = fmaf(wf[g][4 * q + 1], x.y, acc[g][bb]);
            acc[g][bb] = fmaf(wf[g][4 * q + 2], x.z, acc[g][bb]);
            acc[g][bb] = fmaf(wf[g][4 * q + 3], x.w, acc[g][bb]);
          }
        }
      }
    }
  }
}

// This block's units of an LSTM with N units: for each, the products of
// its four gate rows over the columns of ``nseg`` (1 or 2) weight
// segments against the staged rows xs (segment s's inputs at column
// xoff[s]), stored (first) or added into psum[(slot * 4 + g) * B + b].
// Two warps share a unit, each taking half of every segment's vectors;
// the second hands its sums to the first through ``red``.  Every thread
// of the block calls this.
template <typename WT, int NB>
__device__ __forceinline__ void lstm_partial_fma(
    const SegDesc* sg, const int* xoff, int nseg,
    const unsigned char* s_res, int N, const float* xs, int xld, int b0,
    int nb, float* psum, int B, float* red, bool first) {
  constexpr int EPV = Vec<WT>::EPV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pair = warp >> 1, side = warp & 1;
  const int upb = cdiv(N, (int)gridDim.x), u0 = blockIdx.x * upb;
  if (u0 >= N) return;                           // the same in every thread
  float* my_red = red + pair * 4 * BCH;
  for (int slot0 = 0; slot0 < upb; slot0 += NP) {
    const int slot = slot0 + pair, u = u0 + slot;
    const bool valid = slot < upb && u < N;
    float acc[4][NB];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) acc[g][bb] = 0.0f;
    if (valid) {
      for (int s = 0; s < nseg; ++s) {
        const int nv = sg[s].ld / EPV, half = (nv + 1) / 2;
        const int lo = side ? half : 0, hi = side ? nv : half;
        if (sg[s].res_off >= 0) {
          const uint4* w = reinterpret_cast<const uint4*>(
              s_res + sg[s].res_off) + (size_t)slot * 4 * nv;
          seg_dot<WT, NB, true>(w, nv, lo, hi, lane, xs + xoff[s], xld, nb,
                                acc);
        } else {
          const uint4* w = reinterpret_cast<const uint4*>(sg[s].w)
                           + (size_t)u * 4 * nv;
          seg_dot<WT, NB, false>(w, nv, lo, hi, lane, xs + xoff[s], xld, nb,
                                 acc);
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int bb = 0; bb < NB; ++bb)
          if (NB == 1 || bb < nb) acc[g][bb] = warp_sum(acc[g][bb]);
      if (side == 1 && lane == 0) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int bb = 0; bb < NB; ++bb) my_red[g * BCH + bb] = acc[g][bb];
      }
    }
    __syncthreads();
    if (valid && side == 0) {      // lane bb finishes batch row b0 + bb
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float a = acc[g][0];
#pragma unroll
        for (int bb = 1; bb < NB; ++bb) a = lane == bb ? acc[g][bb] : a;
        if (lane < nb) {
          const float v = a + my_red[g * BCH + lane];
          float* o = psum + (size_t)(slot * 4 + g) * B + b0 + lane;
          *o = first ? v : *o + v;
        }
      }
    }
    __syncthreads();               // red is reused by the next slot
  }
}

// D = A (16 x 16 bf16, row) * B (16 x 8 bf16, col) + D, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Two staged inputs (bfloat16 values held as floats) as one bf16 pair.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The same partial product for bfloat16 weights, on the tensor cores.  A
// block owns whole tiles of 4 units (16 gate rows); a segment's weights
// are packed per (unit tile, 16-column tile) in the fragment order of
// mma.sync.m16n8k16, so a warp loads a tile as 32 consecutive 16-byte
// words.  A is a weight tile, B the staged inputs of up to 8 batch rows
// (here nb <= BCH of them; the other columns are zero), sums float32.
// Warp w takes unit tile w % tpp of a pass and the column tiles
// w / tpp, w / tpp + nks, ...; the nks warps of a unit tile add their
// sums in ``mred`` (NW x 128 floats) in a fixed order.  A unit's sum is
// taken in an order fixed by the widths and the grid, and the batch rows
// are columns of the same instruction: a row's bits do not depend on B.
__device__ __forceinline__ void lstm_partial_mma(
    const SegDesc* sg, const int* xoff, int nseg,
    const unsigned char* s_res, int N, const float* xs, int xld, int b0,
    int nb, float* psum, int B, float* mred, bool first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = gridDim.x, UT = cdiv(N, 4), tpb = cdiv(UT, G);
  const int t0 = blockIdx.x * tpb;
  if (t0 >= UT) return;                          // the same in every thread
  const int tpp = imin(tpb, NW), nks = NW / tpp;
  const int wt = warp % tpp, ks = warp / tpp;
  const int n = lane >> 2, c0 = (lane & 3) * 2;  // B column, first B row
  for (int tile0 = 0; tile0 < tpb; tile0 += tpp) {
    const int tile = tile0 + wt;                 // in the block
    const bool valid = tile < tpb && t0 + tile < UT && ks < nks;
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (valid) {
      for (int s = 0; s < nseg; ++s) {
        const int KT = sg[s].kt, ld = sg[s].ld;
        const bool res = sg[s].res_off >= 0;
        const uint4* w =
            res ? reinterpret_cast<const uint4*>(s_res + sg[s].res_off)
                      + (size_t)tile * KT * 32 + lane
                : reinterpret_cast<const uint4*>(sg[s].w)
                      + (size_t)(t0 + tile) * KT * 32 + lane;
        const float* x = xs + xoff[s] + n * xld + c0;
#pragma unroll 4
        for (int kt = ks; kt < KT; kt += nks) {
          const uint4 a = res ? w[kt * 32] : __ldg(w + kt * 32);
          uint32_t bl = 0u, bh = 0u;
          if (n < nb) {
            const int k0 = kt * 16;
            const float2 lo = *reinterpret_cast<const float2*>(x + k0);
            bl = pack_bf16(lo.x, lo.y);
            if (k0 + 8 < ld) {                   // the staged row ends at ld
              const float2 hi = *reinterpret_cast<const float2*>(x + k0 + 8);
              bh = pack_bf16(hi.x, hi.y);
            }
          }
          mma_bf16(c, a, bl, bh);
        }
      }
    }
    __syncthreads();               // mred may still be read (previous pass)
    if (valid) {                   // c0, c1: row n; c2, c3: row n + 8
      float* m = mred + warp * 128 + n * 8 + c0;
      m[0] = c[0]; m[1] = c[1]; m[64] = c[2]; m[65] = c[3];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tpp * 16 * nb; i += NT) {
      const int tl = i / (16 * nb), r = (i / nb) % 16, bn = i % nb;
      const int tl_abs = tile0 + tl;
      if (tl_abs >= tpb || t0 + tl_abs >= UT) continue;
      float v = 0.0f;
      for (int k = 0; k < nks; ++k)
        v += mred[(k * tpp + tl) * 128 + r * 8 + bn];
      float* o = psum + (size_t)((tl_abs * 4 + r / 4) * 4 + (r & 3)) * B
                 + b0 + bn;
      *o = first ? v : *o + v;
    }
  }
  __syncthreads();                 // mred is reused by the next call
}

// The partial product at the weights' type.
template <typename WT, int NB>
__device__ __forceinline__ void lstm_partial(
    const SegDesc* sg, const int* xoff, int nseg,
    const unsigned char* s_res, int N, const float* xs, int xld, int b0,
    int nb, float* psum, int B, float* red, bool first) {
  if constexpr (sizeof(WT) == 2)
    lstm_partial_mma(sg, xoff, nseg, s_res, N, xs, xld, b0, nb, psum, B, red,
                     first);
  else
    lstm_partial_fma<WT, NB>(sg, xoff, nseg, s_res, N, xs, xld, b0, nb, psum,
                             B, red, first);
}

// The LSTM cell of this block's units from their finished sums.
__device__ void lstm_gates(int N, int B, int bf16, const float* psum,
                           const float* bias, const float* c_in,
                           float* h_out, float* c_out) {
  const int upb = units_per_block(N, gridDim.x, bf16), u0 = blockIdx.x * upb;
  for (int i = threadIdx.x; i < upb * B; i += NT) {
    const int slot = i / B, b = i - slot * B, u = u0 + slot;
    if (u >= N) continue;
    const float* ps = psum + (size_t)slot * 4 * B + b;
    const float gi = ps[0] + __ldg(bias + u);
    const float gf = ps[B] + __ldg(bias + N + u);
    const float gg = ps[2 * B] + __ldg(bias + 2 * N + u);
    const float go = ps[3 * B] + __ldg(bias + 3 * N + u);
    const size_t o = (size_t)b * N + u;
    const float c = sigmoidf_(gf) * __ldcg(c_in + o)
                    + sigmoidf_(gi) * tanhf(gg);
    c_out[o] = c;
    h_out[o] = sigmoidf_(go) * tanhf(c);
  }
}

// One warp: acc[r][bb] = W[r, :] · x[bb, :] for R consecutive rows of nv
// 16-byte vectors each (rows at or past nrows are skipped; RES: the rows
// are in shared memory, else in global memory), against MB staged input
// rows of which nb are live; every lane gets the sums.  The R rows'
// loads are in flight together.
template <typename WT, int R, int MB, bool RES>
__device__ __forceinline__ void rows_dot(const uint4* w, int nv, int nrows,
                                         int lane, const float* xs, int xld,
                                         int nb, float (&acc)[R][MB]) {
  constexpr int EPV = Vec<WT>::EPV;
  constexpr int UF = R >= 8 ? 1 : (R >= 4 ? 2 : 4);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int bb = 0; bb < MB; ++bb) acc[r][bb] = 0.0f;
#pragma unroll UF
  for (int i = lane; i < nv; i += 32) {
    uint4 a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nrows) a[r] = RES ? w[(size_t)r * nv + i]
                                : __ldg(w + (size_t)r * nv + i);
      else a[r] = make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int bb = 0; bb < MB; ++bb) {
      if (bb < nb) {
        float xf[EPV];
        const float4* x4 =
            reinterpret_cast<const float4*>(xs + bb * xld + i * EPV);
#pragma unroll
        for (int q = 0; q < EPV / 4; ++q) {
          const float4 x = x4[q];
          xf[4 * q] = x.x; xf[4 * q + 1] = x.y;
          xf[4 * q + 2] = x.z; xf[4 * q + 3] = x.w;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float wf[EPV];
          Vec<WT>::unpack(a[r], wf);
#pragma unroll
          for (int k = 0; k < EPV; ++k)
            acc[r][bb] = fmaf(wf[k], xf[k], acc[r][bb]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int bb = 0; bb < MB; ++bb)
      if (bb < nb) acc[r][bb] = warp_sum(acc[r][bb]);
}

// acc[lane][bb] for lane < R (every lane holds all sums): a select
// chain, so that the rows' epilogues run side by side on lanes 0..R-1
// and not one after another.
template <int R, int MB>
__device__ __forceinline__ float lane_row(const float (&acc)[R][MB], int bb,
                                          int lane) {
  float y = acc[0][bb];
#pragma unroll
  for (int r = 1; r < R; ++r) y = lane == r ? acc[r][bb] : y;
  return y;
}

// A prenet layer's rows [j0, j1) of W (P, ld8(kx)) against the staged
// rows xs: out = relu(W x) / keep * mask.  A group of TPR threads (a
// power of two, as many as keep all rows in one pass where they fit)
// takes a row, thread ``sub`` of the group the row's 16-byte vectors
// sub, sub + TPR, ..., and the group's sums meet by xor shuffles: few
// instructions per row and no warp-wide reduction, because here one
// block computes many short rows.  The order of a row's sum is fixed by
// the widths.  to_smem: written, as the next product sees it, to the
// staged rows dst[bb * dld + j]; else to the global buffer dst (B, P).
// ``W`` holds the rows from row ``jw`` on, in shared memory when ``res``;
// ``ms`` the layer's staged masks, ms[bb * xld + j].
template <typename WT, int NB>
__device__ __forceinline__ void prenet_layer(
    const Params& p, const void* W, int jw, bool res, int kx, int j0, int j1,
    const float* xs, const float* ms, int xld, int b0, int nb, bool to_smem,
    float* dst, int dld) {
  constexpr int EPV = Vec<WT>::EPV;
  const int n = j1 - j0;
  if (n <= 0) return;
  const int nv = ld8(kx) / EPV;
  int tpr = 32;                    // at least 4: 64 contiguous bytes a row
  while (tpr > 4 && NT / tpr < n) tpr >>= 1;
  const int sub = threadIdx.x & (tpr - 1), rpp = NT / tpr;
  for (int base = j0; base < j1; base += rpp) {  // the same in every thread
    const int j = base + threadIdx.x / tpr;
    const bool live = j < j1;
    float acc[NB];
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) acc[bb] = 0.0f;
    if (live) {
      const uint4* w = reinterpret_cast<const uint4*>(W)
                       + (size_t)(j - jw) * nv;
      constexpr int NL = 5;        // loads in flight per thread
      for (int v0 = sub; v0 < nv; v0 += NL * tpr) {
        uint4 a[NL];
#pragma unroll
        for (int k = 0; k < NL; ++k)
          a[k] = v0 + k * tpr >= nv ? make_uint4(0u, 0u, 0u, 0u)
                 : res ? w[v0 + k * tpr] : __ldg(w + v0 + k * tpr);
#pragma unroll
        for (int k = 0; k < NL; ++k) {
          const int v = v0 + k * tpr;
          if (v < nv) {
            float wf[EPV];
            Vec<WT>::unpack(a[k], wf);
#pragma unroll
            for (int bb = 0; bb < NB; ++bb) {
              if (NB == 1 || bb < nb) {
                const float4* x4 =
                    reinterpret_cast<const float4*>(xs + bb * xld + v * EPV);
#pragma unroll
                for (int q = 0; q < EPV / 4; ++q) {
                  const float4 x = x4[q];
                  acc[bb] = fmaf(wf[4 * q + 0], x.x, acc[bb]);
                  acc[bb] = fmaf(wf[4 * q + 1], x.y, acc[bb]);
                  acc[bb] = fmaf(wf[4 * q + 2], x.z, acc[bb]);
                  acc[bb] = fmaf(wf[4 * q + 3], x.w, acc[bb]);
                }
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int bb = 0; bb < NB; ++bb)
      if (NB == 1 || bb < nb)
        for (int o = tpr >> 1; o > 0; o >>= 1)
          acc[bb] += __shfl_xor_sync(0xffffffffu, acc[bb], o);
    if (live && sub == 0) {
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
        if (NB == 1 || bb < nb) {
          const float y = fmaxf(acc[bb], 0.0f) / p.keep * ms[bb * xld + j];
          if (to_smem) dst[bb * dld + j] = Vec<WT>::rnd(y);
          else dst[(size_t)(b0 + bb) * p.P + j] = y;
        }
      }
    }
  }
}

// The same layer for bfloat16 weights, on the tensor cores: W is packed
// in tiles of 16 rows x 16 columns in the fragment order of
// mma.sync.m16n8k16 (``W`` holds the tiles from row tile jw / 16 on);
// warp w takes the row tiles w, w + NW, ... of [j0, j1) whole, so no
// sums cross warps; the staged inputs of the nb batch rows are the B
// columns.
__device__ __forceinline__ void prenet_mma(
    const Params& p, const void* W, int jw, bool res, int kx, int j0, int j1,
    const float* xs, const float* ms, int xld, int b0, int nb, bool to_smem,
    float* dst, int dld) {
  if (j0 >= j1) return;            // an empty share (j0 is P, not a tile's)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int KT = cdiv(kx, 16), ld = ld8(kx);
  const int n = lane >> 2, c0 = (lane & 3) * 2;
  const float* x = xs + n * xld + c0;
  for (int jt = j0 / 16 + warp; jt * 16 < j1; jt += NW) {
    const uint4* w = reinterpret_cast<const uint4*>(W)
                     + (size_t)(jt - jw / 16) * KT * 32 + lane;
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
    for (int kt = 0; kt < KT; ++kt) {
      const uint4 a = res ? w[kt * 32] : __ldg(w + kt * 32);
      uint32_t bl = 0u, bh = 0u;
      if (n < nb) {
        const int k0 = kt * 16;
        const float2 lo = *reinterpret_cast<const float2*>(x + k0);
        bl = pack_bf16(lo.x, lo.y);
        if (k0 + 8 < ld) {
          const float2 hi = *reinterpret_cast<const float2*>(x + k0 + 8);
          bh = pack_bf16(hi.x, hi.y);
        }
      }
      mma_bf16(c, a, bl, bh);
    }
    // c[0], c[1]: row jt * 16 + n, batch rows c0, c0 + 1; c[2], c[3]: row + 8
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = jt * 16 + n + 8 * (e >> 1), bb = c0 + (e & 1);
      if (j < j1 && bb < nb) {
        const float y = fmaxf(c[e], 0.0f) / p.keep * ms[bb * xld + j];
        if (to_smem) dst[bb * dld + j] = Vec<__nv_bfloat16>::rnd(y);
        else dst[(size_t)(b0 + bb) * p.P + j] = y;
      }
    }
  }
}

// A prenet layer at the weights' type.
template <typename WT, int NB>
__device__ __forceinline__ void prenet(
    const Params& p, const void* W, int jw, bool res, int kx, int j0, int j1,
    const float* xs, const float* ms, int xld, int b0, int nb, bool to_smem,
    float* dst, int dld) {
  if constexpr (sizeof(WT) == 2)
    prenet_mma(p, W, jw, res, kx, j0, j1, xs, ms, xld, b0, nb, to_smem, dst,
               dld);
  else
    prenet_layer<WT, NB>(p, W, jw, res, kx, j0, j1, xs, ms, xld, b0, nb,
                         to_smem, dst, dld);
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
}

// The gate rows of this block's units, for every resident segment, from
// global into shared memory: once per launch.
template <typename WT>
__device__ void load_lstm_resident(const Params& p, unsigned char* s_res) {
  const int G = gridDim.x;
  for (int s = 0; s < N_SEGS; ++s) {
    const SegDesc& d = p.seg[s];
    if (d.res_off < 0) continue;
    const int N = s <= SA_H ? p.H : p.Hd;
    const int upb = units_per_block(N, G, p.bf16), u0 = blockIdx.x * upb;
    if (u0 >= N) continue;
    // 16-byte words per unit: its 4 gate rows, or a quarter of a unit
    // tile's fragments (whole tiles: upb and u0 are multiples of 4)
    const int per_unit = p.bf16 ? d.kt * 8 : d.ld / Vec<WT>::EPV * 4;
    const int units = p.bf16 ? imin(upb, 4 * cdiv(N, 4) - u0)
                             : imin(upb, N - u0);
    const uint4* src = reinterpret_cast<const uint4*>(d.w)
                       + (size_t)u0 * per_unit;
    uint4* dst = reinterpret_cast<uint4*>(s_res + d.res_off);
    for (int i = threadIdx.x; i < units * per_unit; i += NT)
      dst[i] = __ldg(src + i);
  }
}

// The transition agent of row b, by one warp:
// u[b] = sigmoid(w_ta · [ctx, attention h] + b_ta), written by lane 0.
// The energy phase of step t computes step t-1's agent with it, and the
// segment kernel its last step's, so both give the same bits.  With
// bfloat16 weights the product sees ctx and h rounded, as every other.
template <typename WT>
__device__ void agent_u(const Params& p, int b, const float* ah,
                        float* u_out) {
  const int lane = threadIdx.x & 31;
  const float* ctx = p.ctx + (size_t)b * p.E;
  const float* h = ah + (size_t)b * p.H;
  float z = 0.0f;
  for (int i = lane; i < p.E; i += 32)
    z = fmaf(Vec<WT>::rnd(__ldcg(ctx + i)), __ldg(p.w_ta + i), z);
  for (int i = lane; i < p.H; i += 32)
    z = fmaf(Vec<WT>::rnd(__ldcg(h + i)), __ldg(p.w_ta + p.E + i), z);
  z = warp_sum(z);
  if (lane == 0) u_out[b] = sigmoidf_(z + __ldg(p.b_ta));
}

// Phase 3, one (row b, part) item per block: the block first projects
// the row's new attention h to the query pq = W_q h (every warp RB
// outputs), then each warp takes one encoder position tt = part * NW +
// warp: e = v · tanh(pq + loc[tt] + pin[b, tt]) + v_b, masked to -1e30
// where asked.  loc[tt, f] is the K-tap conv over the previous and the
// cumulative attention weights, zero-padded (K-1)/2 per side, followed
// (in the dense) by the F -> A projection.  With ``agent`` (every step
// of a launch but its first: the carried u is already current there),
// the last warp of the row's last part computes the transition agent of
// the previous step: ctx and the previous h are still intact here, and
// phase 4 is the first to read u.
template <typename WT>
__device__ void energy_block(const Params& p, const float* s_wres,
                             float* body, int b, int part, int parts,
                             bool agent, int cur, int t) {
  const int T = p.T, A = p.A, F = p.F, K = p.K, H = p.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* s_h = body;                              // ld8(H)
  float* s_pq = s_h + ld8(H);                     // ld8(A)
  float* s_win = s_pq + ld8(A) + warp * (2 * K + F);   // this warp's window
  float* s_loc = s_win + 2 * K;                   // and its loc[f]
  const float* s_wd = s_wres;                     // see load_resident
  const float* s_wl = s_wd + A * F;
  const float* s_v = s_wl + 2 * F * K;

  __syncthreads();                 // body may still be in use
  stage<WT>(s_h, 0, 0, p.ah[cur ^ 1], H, b, 1);
  __syncthreads();
  {
    const int nv = ld8(H) / Vec<WT>::EPV;
    constexpr int RB = 8;          // query rows a warp keeps in flight
    for (int j = warp * RB; j < A; j += NW * RB) {
      float acc[RB][1];
      rows_dot<WT, RB, 1, false>(
          reinterpret_cast<const uint4*>(p.w_q) + (size_t)j * nv, nv, A - j,
          lane, s_h, 0, 1, acc);
      const float y = lane_row<RB, 1>(acc, 0, lane);
      if (lane < RB && j + lane < A) s_pq[j + lane] = y;
    }
  }
  __syncthreads();
  stamp(p, t, T_PQ);

  const int tt = part * NW + warp;
  if (tt < T) {
    const float v_b = __ldg(p.v_b);
    const int pad = (K - 1) / 2;
    const float* cum = p.cum[cur];
    const float* pin = p.pin + ((size_t)b * T + tt) * A;
    float q[4];                    // the first 128 of A, loaded early
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = lane + 32 * j;
      q[j] = a < A ? s_pq[a] + __ldg(pin + a) : 0.0f;
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
        s_loc[f] = Vec<WT>::rnd(acc);    // the dense product's input
      }
      __syncwarp();
    }
    float part_sum = 0.0f;
    for (int a0 = 0; a0 < A; a0 += 128) {     // 4 independent chains a lane
      float pl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (a0 > 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int a = a0 + lane + 32 * j;
          q[j] = a < A ? s_pq[a] + __ldg(pin + a) : 0.0f;
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
        if (a < A) part_sum = fmaf(s_v[a], tanhf(q[j] + pl[j]), part_sum);
      }
    }
    float e = warp_sum(part_sum) + v_b;
    if (p.mask_en && __ldg(p.mask + (size_t)b * T + tt) <= 0.0f) e = MASK_VALUE;
    if (lane == 0) p.e[(size_t)b * T + tt] = e;
  }
  if (agent && part == parts - 1 && warp == NW - 1)
    agent_u<WT>(p, b, p.ah[cur], p.u);
}

// Phase 4, one (row b, slice s of nslice) item per block: normalise the
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

// A block's shared memory, see make_layout.
struct Smem {
  int* nf; int* mlen; int* alive;
  float* red; float* wres; float* psa; float* psd; float* body;
  unsigned char* wpg; unsigned char* res;
  // a prenet block that owns no LSTM unit keeps the prenet's weights in
  // its (otherwise unused) resident area: byte offsets there, or -1
  int w1_res, w2_res;
};

// The prenet's share of the grid: its last NPB blocks; block q of them
// computes layer 2's rows [j0, j1).
struct PrenetShare { int q, j0, j1; };
__device__ PrenetShare prenet_share(const Params& p) {
  const int G = gridDim.x, npb = imin(NPB, G);
  PrenetShare ps;
  ps.q = (int)blockIdx.x - (G - npb);
  // bfloat16: whole tiles of 16 rows (the tensor-core instruction's)
  const int rp = p.bf16 ? 16 * cdiv(cdiv(p.P, 16), npb) : cdiv(p.P, npb);
  ps.j0 = ps.q < 0 ? 0 : imin(p.P, ps.q * rp);
  ps.j1 = ps.q < 0 ? 0 : imin(p.P, ps.j0 + rp);
  return ps;
}

// Bytes of ``rows`` rows (from a multiple of 16 on) of a prenet matrix
// with kx columns as it is packed: float32 rows of ld8(kx) values,
// bfloat16 tiles of 16 rows x 16 columns in fragment order.
__device__ inline int prenet_bytes(const Params& p, int rows, int kx) {
  return p.bf16 ? cdiv(rows, 16) * cdiv(kx, 16) * 512 : rows * ld8(kx) * 4;
}

__device__ Smem smem_views(const Params& p, unsigned char* raw) {
  Smem s;
  s.nf = reinterpret_cast<int*>(raw);
  s.mlen = s.nf + p.B;
  s.alive = s.mlen + p.B;
  s.red = reinterpret_cast<float*>(raw + p.off_red);
  s.wres = reinterpret_cast<float*>(raw + p.off_wres);
  s.psa = reinterpret_cast<float*>(raw + p.off_psa);
  s.psd = reinterpret_cast<float*>(raw + p.off_psd);
  s.wpg = raw + p.off_wpg;
  s.body = reinterpret_cast<float*>(raw + p.off_body);
  s.res = raw + p.off_res;
  s.w1_res = s.w2_res = -1;
  const PrenetShare ps = prenet_share(p);
  const int G = gridDim.x;
  const bool owns =
      (int)blockIdx.x * units_per_block(p.H, G, p.bf16) < p.H
      || (int)blockIdx.x * units_per_block(p.Hd, G, p.bf16) < p.Hd;
  if (ps.q >= 0 && !owns) {
    const int b1 = prenet_bytes(p, p.P, p.MR);
    const int b2 = prenet_bytes(p, ps.j1 - ps.j0, p.P);
    int off = 0;
    if (off + b1 <= p.res_bytes) { s.w1_res = off; off += b1; }
    if (off + b2 <= p.res_bytes) s.w2_res = off;
  }
  return s;
}

// Copy the prenet weights this block keeps (see Smem) into its shared
// memory: once per launch.
__device__ void load_prenet_resident(const Params& p, const Smem& s) {
  const PrenetShare ps = prenet_share(p);
  if (s.w1_res >= 0) {
    const uint4* src = reinterpret_cast<const uint4*>(p.w_pre1);
    uint4* dst = reinterpret_cast<uint4*>(s.res + s.w1_res);
    const int n = prenet_bytes(p, p.P, p.MR) / 16;
    for (int i = threadIdx.x; i < n; i += NT) dst[i] = __ldg(src + i);
  }
  if (s.w2_res >= 0) {
    const uint4* src = reinterpret_cast<const uint4*>(p.w_pre2)
                       + prenet_bytes(p, ps.j0, p.P) / 16;
    uint4* dst = reinterpret_cast<uint4*>(s.res + s.w2_res);
    const int n = prenet_bytes(p, ps.j1 - ps.j0, p.P) / 16;
    for (int i = threadIdx.x; i < n; i += NT) dst[i] = __ldg(src + i);
  }
}

// This block's rows of the projection matrix W_pg (MR + 1, ld8(Hd) +
// ld8(E)): rows blockIdx, blockIdx + grid, ..., copied into shared memory
// once per launch.
template <typename WT>
__device__ void load_proj_resident(const Params& p, unsigned char* s_wpg) {
  const int nv = (ld8(p.Hd) + ld8(p.E)) / Vec<WT>::EPV;
  uint4* dst = reinterpret_cast<uint4*>(s_wpg);
  int r = 0;
  for (int j = blockIdx.x; j < p.MR + 1; j += gridDim.x, ++r) {
    const uint4* src = reinterpret_cast<const uint4*>(p.w_pg) + (size_t)j * nv;
    for (int i = threadIdx.x; i < nv; i += NT) dst[(size_t)r * nv + i] = __ldg(src + i);
  }
}

// Phase 6 and the start of the next step.  From the state in buffers
// ``k`` (the one a step has just written, or a launch's entry state):
//   * with ``proj``, the mel projection and the gate of step t, one
//     warp per resident row of W_pg (the block's r-th row is output
//     blockIdx + r * grid) against the staged [decoder h | context];
//   * the next step's product that waits for nothing else: the
//     attention LSTM over [context | attention h], stored as that
//     step's first partial sums.  A step that never runs leaves them
//     unused: nothing but the block's own partial sums is written.
template <typename WT, int NB>
__device__ void phase6(const Params& p, const Smem& s, int t, int k,
                       bool proj) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const X6 x6 = x6_layout(p.Hd, p.E, p.H);
  float* xs = s.body;
  const int nv = x6.h / Vec<WT>::EPV;            // [decoder h | context]
  const SegDesc sa[2] = {p.seg[SA_C], p.seg[SA_H]};
  const int xa[2] = {x6.c, x6.h};
  for (int b0 = 0; b0 < p.B; b0 += BCH) {
    const int nb = imin(BCH, p.B - b0);
    __syncthreads();
    stage<WT>(xs, x6.ld, x6.dh, p.dh[k], p.Hd, b0, nb);
    stage<WT>(xs, x6.ld, x6.c, p.ctx, p.E, b0, nb);
    stage<WT>(xs, x6.ld, x6.h, p.ah[k], p.H, b0, nb);
    __syncthreads();
    for (int r = warp; proj && (int)blockIdx.x + r * (int)gridDim.x < p.MR + 1;
         r += NW) {                              // the block's r-th row
      const int j = blockIdx.x + r * gridDim.x;
      float acc[1][NB];
      rows_dot<WT, 1, NB, true>(
          reinterpret_cast<const uint4*>(s.wpg) + (size_t)r * nv, nv, 1,
          lane, xs, x6.ld, nb, acc);
      float v = acc[0][0];
#pragma unroll
      for (int bb = 1; bb < NB; ++bb) v = lane == bb ? acc[0][bb] : v;
      v += __ldg(p.b_pg + j);
      if (lane < nb) {                           // lane bb: batch row b0 + bb
        const int b = b0 + lane;
        if (j < p.MR) {
          p.mels[((size_t)t * p.B + b) * p.MR + j] = v;
          p.din[(size_t)b * p.MR + j] = v;
        } else {
          p.gates[(size_t)t * p.B + b] = v;
        }
      }
    }
    lstm_partial<WT, NB>(sa, xa, 2, s.res, p.H, xs, x6.ld, b0, nb, s.psa, p.B,
                     s.red, true);
  }
}

// One decoder step, phases 1-6 and the stop bookkeeping: the body both
// kernels share (the counterpart of pallas_decoder.py::_bind_step).
// ``t`` is the step's index in this launch: it picks the double buffers
// (t & 1 holds the state the step reads) and indexes the prenet masks,
// the outputs and the phase stamps.  The attention LSTM's partial sums
// over [context | h] are already in shared memory: phase 6 of the step
// before, or the launch's entry, put them there.  Returns the number of
// rows still unfinished, the same in every block.  Every block passes
// every grid.sync(): no barrier sits inside divergent work.
template <typename WT, int NB>
__device__ int decoder_step(const Params& p, cg::grid_group& grid,
                            const Smem& s, int t, int nslice) {
  const int B = p.B, G = gridDim.x;
  const int cur = t & 1, nxt = cur ^ 1;
  const int xo0[1] = {0};
  float* xs = s.body;
  stamp(p, t, T_START);

  // ---- 1: the prenet, both layers, on the grid's last NPB blocks (each
  // computes layer 1 whole and its share of layer 2's rows: W1 is read
  // NPB times, not once per block); on every block the decoder LSTM over
  // its own h of step t - 1, which waits for nothing
  {
    const PrenetShare ps = prenet_share(p);
    const int q = ps.q;
    if (q >= 0) {
      const X1 x1 = x1_layout(p.MR, p.P);
      const bool r1 = s.w1_res >= 0, r2 = s.w2_res >= 0;
      const void* w1 = r1 ? (const void*)(s.res + s.w1_res) : p.w_pre1;
      const void* w2 = r2 ? (const void*)(s.res + s.w2_res) : p.w_pre2;
      for (int b0 = 0; b0 < B; b0 += BCH) {
        const int nb = imin(BCH, B - b0);
        __syncthreads();
        stage<WT>(xs, x1.ld, x1.din, p.din, p.MR, b0, nb);
        for (int i = p.P + threadIdx.x; i < ld8(p.P); i += NT)
          for (int bb = 0; bb < nb; ++bb)      // the rows' zero padding
            xs[bb * x1.ld + x1.p1 + i] = 0.0f;
        // both layers' masks in the same trip (raw 0/1, never rounded):
        // layer 0's P values and layer 1's [j0, j1) of every row
        {
          const int n1 = ps.j1 - ps.j0, per = p.P + n1;
          const float* m0 = p.premask + ((size_t)t * 2 * B + b0) * p.P;
          constexpr int U = 4;     // loads in flight, as in stage()
          for (int base = threadIdx.x; base < nb * per; base += U * NT) {
            float v[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int idx = base + u * NT, bb = idx / per;
              const int i = idx - bb * per;
              v[u] = idx >= nb * per ? 0.0f
                     : i < p.P ? __ldg(m0 + (size_t)bb * p.P + i)
                               : __ldg(m0 + (size_t)(B + bb) * p.P + ps.j0
                                       + i - p.P);
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int idx = base + u * NT, bb = idx / per;
              const int i = idx - bb * per;
              if (idx < nb * per)
                xs[bb * x1.ld + (i < p.P ? x1.m0 + i
                                         : x1.m1 + ps.j0 + i - p.P)] = v[u];
            }
          }
        }
        __syncthreads();
        if (b0 + BCH >= B) stamp(p, t, T_PRE0);
        prenet<WT, NB>(p, w1, 0, r1, p.MR, 0, p.P, xs + x1.din, xs + x1.m0,
                       x1.ld, b0, nb, true, xs + x1.p1, x1.ld);
        __syncthreads();
        if (b0 + BCH >= B) stamp(p, t, T_PRE1);
        prenet<WT, NB>(p, w2, r2 ? ps.j0 : 0, r2, p.P, ps.j0, ps.j1,
                       xs + x1.p1, xs + x1.m1, x1.ld, b0, nb, false, p.p2, 0);
      }
      stamp(p, t, T_PRE2);
      // the next step's masks (never read before) on their way to the L2
      if (q == 0 && t + 1 < p.S) {
        const char* nm = reinterpret_cast<const char*>(
            p.premask + (size_t)(t + 1) * 2 * B * p.P);
        const int bytes = 2 * B * p.P * (int)sizeof(float);
        for (int i = threadIdx.x * 128; i < bytes; i += NT * 128)
          asm volatile("prefetch.global.L2 [%0];" :: "l"(nm + i));
      }
    } else {
      stamp(p, t, T_PRE0);
      stamp(p, t, T_PRE1);
      stamp(p, t, T_PRE2);
    }
    for (int b0 = 0; b0 < B; b0 += BCH) {
      const int nb = imin(BCH, B - b0);
      __syncthreads();
      stage<WT>(xs, ld8(p.Hd), 0, p.dh[cur], p.Hd, b0, nb);
      __syncthreads();
      lstm_partial<WT, NB>(&p.seg[SD_HD], xo0, 1, s.res, p.Hd, xs, ld8(p.Hd), b0,
                       nb, s.psd, B, s.red, true);
    }
  }
  stamp(p, t, T_P1W);
  grid.sync();
  stamp(p, t, T_P1B);

  // ---- 2: the prenet columns of the attention LSTM, then the cell
  for (int b0 = 0; b0 < B; b0 += BCH) {
    const int nb = imin(BCH, B - b0);
    __syncthreads();
    stage<WT>(xs, ld8(p.P), 0, p.p2, p.P, b0, nb);
    __syncthreads();
    lstm_partial<WT, NB>(&p.seg[SA_P], xo0, 1, s.res, p.H, xs, ld8(p.P), b0, nb,
                     s.psa, B, s.red, false);
  }
  __syncthreads();
  lstm_gates(p.H, B, p.bf16, s.psa, p.b_att, p.ac[cur], p.ah[nxt], p.ac[nxt]);
  stamp(p, t, T_P2W);
  grid.sync();
  stamp(p, t, T_P2B);

  // ---- 3: query + energies
  {
    const int parts = cdiv(p.T, NW);
    const bool agent = t > 0 && p.fwd && p.tagent;
    for (int item = blockIdx.x; item < B * parts; item += G)
      energy_block<WT>(p, s.wres, s.body, item / parts, item % parts, parts,
                       agent, cur, t);
  }
  stamp(p, t, T_P3W);
  grid.sync();
  stamp(p, t, T_P3B);

  // ---- 4: attention rows
  for (int item = blockIdx.x; item < B * nslice; item += G)
    attention_slice(p, s.body, s.red, item / nslice, item % nslice, nslice,
                    t, cur);
  stamp(p, t, T_P4W);
  grid.sync();
  stamp(p, t, T_P4B);

  // ---- 5: the [attention h | context] columns of the decoder LSTM, then
  // the cell
  {
    const SegDesc sd[2] = {p.seg[SD_H], p.seg[SD_C]};
    const int xd[2] = {0, ld8(p.H)};
    const int xld = ld8(p.H) + ld8(p.E);
    for (int b0 = 0; b0 < B; b0 += BCH) {
      const int nb = imin(BCH, B - b0);
      __syncthreads();
      stage<WT>(xs, xld, 0, p.ah[nxt], p.H, b0, nb);
      stage<WT>(xs, xld, ld8(p.H), p.ctx, p.E, b0, nb);
      __syncthreads();
      lstm_partial<WT, NB>(sd, xd, 2, s.res, p.Hd, xs, xld, b0, nb, s.psd, B,
                       s.red, false);
    }
    __syncthreads();
    lstm_gates(p.Hd, B, p.bf16, s.psd, p.b_dec, p.dc[cur], p.dh[nxt], p.dc[nxt]);
  }
  stamp(p, t, T_P5W);
  grid.sync();
  stamp(p, t, T_P5B);

  // ---- 6: mel projection and gate; the next step's first partial sums
  phase6<WT, NB>(p, s, t, nxt, true);
  stamp(p, t, T_P6W);
  grid.sync();
  stamp(p, t, T_P6B);

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
  stamp(p, t, T_END);
  return alive;
}

// A launch's steps: the first partial sums of step 0 from the entry
// state, then up to S steps, stopping early (whole-loop kernel) once no
// row is unfinished.  NB is 1 for a launch at B = 1, else BCH: a launch
// runs one of the two instantiations, each with code only for the batch
// rows it can meet (a step's code is fetched again every step, so its
// size is part of its time).  Returns the steps run.
template <typename WT, int NB>
__device__ int run_steps(const Params& p, cg::grid_group& grid,
                         const Smem& s) {
  phase6<WT, NB>(p, s, 0, 0, false);
  const int nslice = context_slices(gridDim.x, p.B, p.E);
  int alive = p.B;
  int t = 0;
#pragma unroll 1
  for (; t < p.S; ++t) {
    if (p.early && alive == 0) break;          // identical in every block
    alive = decoder_step<WT, NB>(p, grid, s, t, nslice);
  }
  return t;
}

template <typename WT>
__global__ void __launch_bounds__(NT, 1)
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
  load_lstm_resident<WT>(p, s.res);
  load_proj_resident<WT>(p, s.wpg);
  load_prenet_resident(p, s);
  grid.sync();
  const int t = B == 1 ? run_steps<WT, 1>(p, grid, s)
                       : run_steps<WT, BCH>(p, grid, s);
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
// every later segment would drift from the whole-loop kernel.  The
// partial sums that a step's phase 6 starts for the step after it are
// recomputed from the carried state at a launch's entry, with the same
// function, so a segment carries nothing but the state, and the last
// step's are simply left unused.
template <typename WT>
__global__ void __launch_bounds__(NT, 1)
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
  load_lstm_resident<WT>(p, s.res);
  load_proj_resident<WT>(p, s.wpg);
  load_prenet_resident(p, s);
  grid.sync();
  if (p.B == 1) run_steps<WT, 1>(p, grid, s);
  else run_steps<WT, BCH>(p, grid, s);

  // every phase of the last step has passed its barrier: the state is
  // final in buffer S & 1, and nothing reads the scratch u any more
  const int fin = p.S & 1;
  if (p.fwd && p.tagent) {
    const int worker = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
    for (int b = worker; b < p.B; b += NW * gridDim.x)
      agent_u<WT>(p, b, p.ah[fin], st.out[S_U]);
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

int device_sms(int* n_sm) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
}

// Fill the kernel parameters from the C entry's arrays (see
// decoder_loop_launch), carve the scratch buffer and lay out the shared
// memory.
void fill_params(Params& p, const Layout& L, const void* const* ptrs,
                 const int* dims, const float* fparams) {
  p.enc = (const float*)ptrs[P_ENC];
  p.pin = (const float*)ptrs[P_PIN];
  p.mask = (const float*)ptrs[P_MASK];
  p.premask = (const float*)ptrs[P_PREMASK];
  p.w_pre1 = ptrs[P_W_PRE1];
  p.w_pre2 = ptrs[P_W_PRE2];
  p.b_att = (const float*)ptrs[P_B_ATT];
  p.w_q = ptrs[P_W_Q];
  p.w_loc = (const float*)ptrs[P_W_LOC];
  p.w_locd = (const float*)ptrs[P_W_LOCD];
  p.v_w = (const float*)ptrs[P_V_W];
  p.v_b = (const float*)ptrs[P_V_B];
  p.w_ta = (const float*)ptrs[P_W_TA];
  p.b_ta = (const float*)ptrs[P_B_TA];
  p.b_dec = (const float*)ptrs[P_B_DEC];
  p.w_pg = ptrs[P_W_PG];
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
  p.bf16 = dims[D_BF16];
  p.stamp_block = dims[D_STAMP_BLOCK] < 0 ? L.grid + dims[D_STAMP_BLOCK]
                                          : dims[D_STAMP_BLOCK];
  p.keep = fparams[0];
  p.gate_threshold = fparams[1];

  const int seg_ptr[N_SEGS] = {P_WA_P, P_WA_C, P_WA_H,
                               P_WD_H, P_WD_C, P_WD_HD};
  const int seg_n[N_SEGS] = {p.P, p.E, p.H, p.H, p.E, p.Hd};
  for (int s = 0; s < N_SEGS; ++s) {
    p.seg[s].w = ptrs[seg_ptr[s]];
    p.seg[s].ld = ld8(seg_n[s]);
    p.seg[s].kt = cdiv(seg_n[s], 16);
    p.seg[s].res_off = L.seg_off[s];
  }
  p.off_red = (int)L.off_red; p.off_wres = (int)L.off_wres;
  p.off_psa = (int)L.off_psa; p.off_psd = (int)L.off_psd;
  p.off_wpg = (int)L.off_wpg;
  p.off_body = (int)L.off_body; p.off_res = (int)L.off_res;
  p.res_bytes = (int)(L.total - L.off_res);

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
  p.p2 = s; s += B * p.P;
  p.e = s; s += B * p.T;
}

// One cooperative launch of ``kernel`` on ``stream``, one block per SM.
// Returns a cudaError_t code.
int launch_cooperative(const void* kernel, void** args, const Layout& L,
                       void* stream) {
  if (L.total > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, coop = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)) != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, kernel, NT, L.total)) != cudaSuccess)
    return (int)e;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(kernel, dim3(L.grid), dim3(NT), args,
                                  L.total, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t decoder_loop_scratch_floats(const int* dims) {
  return scratch_floats(dims);
}

// The launch's plan for ``dims`` on the current device: out[0] the grid,
// out[1] the bytes of shared memory a block needs, out[2] the mask of
// resident LSTM segments (bit s of Seg).  Returns a cudaError_t code.
int decoder_loop_plan(const int* dims, long long* out) {
  int n_sm = 0;
  const int rc = device_sms(&n_sm);
  if (rc != 0) return rc;
  const Layout L = make_layout(dims, n_sm);
  out[0] = L.grid;
  out[1] = (long long)L.total;
  out[2] = L.res_mask;
  return 0;
}

const char* decoder_loop_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launch the whole decode on ``stream``; returns a cudaError_t code
// (0 = launched).  ``ptrs``: N_PTRS device pointers in Ptr order, the
// last (phase_ns) null unless the caller times the phases;
// ``dims``: N_DIMS ints in Dim order (D_BF16 picks the weight type of
// the matrices); ``fparams``: {keep, threshold}.
int decoder_loop_launch(const void* const* ptrs, const int* dims,
                        const float* fparams, void* stream) {
  int n_sm = 0;
  const int rc = device_sms(&n_sm);
  if (rc != 0) return rc;
  const Layout L = make_layout(dims, n_sm);
  Params p;
  fill_params(p, L, ptrs, dims, fparams);
  void* args[] = {&p};
  const void* kernel =
      dims[D_BF16] ? (const void*)decoder_loop_kernel<__nv_bfloat16>
                   : (const void*)decoder_loop_kernel<float>;
  return launch_cooperative(kernel, args, L, stream);
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
  int n_sm = 0;
  const int rc = device_sms(&n_sm);
  if (rc != 0) return rc;
  const Layout L = make_layout(dims, n_sm);
  Params p;
  fill_params(p, L, ptrs, dims, fparams);
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
  const void* kernel =
      dims[D_BF16] ? (const void*)decoder_segment_kernel<__nv_bfloat16>
                   : (const void*)decoder_segment_kernel<float>;
  return launch_cooperative(kernel, args, L, stream);
}

int decoder_loop_n_ptrs(void) { return N_PTRS; }

int decoder_segment_n_ptrs(void) { return N_PTRS + N_SEG_PTRS; }

int decoder_loop_n_dims(void) { return N_DIMS; }

}  // extern "C"
