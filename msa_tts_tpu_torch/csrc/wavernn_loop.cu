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
//      noise); the sample's owner also writes z of step t + 1
//
// each phase ending at a grid-wide barrier, because each reads all of
// the previous one's output.  The five matrix products are computed
// here, in the kernel's own loops; no library is called.
//
// What bounds it on an H100: neither bytes nor arithmetic (3.77 M
// weights, 2 * 3.77 M * B operations a step: a microsecond or less) but
// the latency of five dependent exchanges a step (a grid barrier, a trip
// to L2, a short product, gate math on a few threads) and, at many rows,
// the all-to-all staging: every block needs every row's activations in
// every phase, 6.4 KB a row and step in bf16, 8 MB a block and step at
// 1,248 rows.  Not L2's bandwidth: 132 blocks copying the same rows with
// cp.async drew 9.5 TB/s from it.  A block's own intake is the bound, and
// per chunk it pays a fixed cost (a wait, a block barrier, the issue of
// the next copies, the products' latency chain), so it grows with the
// rows a chunk holds; the Tensor Memory Accelerator's bulk copies, and
// their multicast to a cluster (which halves the reads from L2), drew
// less than cp.async at every chunk size.  What the design does about it:
//
//   - Output units go round-robin over the blocks (unit u of a layer
//     belongs to block u % G).  A block's rows of all five layers, in
//     bf16 laid out in the fragment order of mma.sync.m16n8k16 (a warp
//     loads one 16 x 16 weight tile as 32 consecutive 16-byte words), f32
//     as padded rows, are packed as one slice.  bf16 below a row count
//     the wrapper picks (the card's crossover) keeps the whole slice in
//     shared memory for the launch (114 KB at the default width on 132
//     blocks).  f32, and bf16 above it, keep one phase's rows: a block
//     copies its rows of the coming phase from L2 into one buffer
//     (cp.async, started when the previous phase's products are done, so
//     it runs under that phase's gate math and barrier), which leaves
//     bf16 83 KB more for staging.  The bf16 products run on the tensor
//     cores: A = 16 weight rows (a GRU tile holds 5 units x 3 gates, an
//     fc tile 8 outputs and skips the upper half), B = 16 inputs x 8 batch
//     rows, f32 sums.  In f32 a lane owns a whole weight row and up to 4
//     batch rows of one K slice (an fc layer's few rows: 2 batch rows)
//     and sums with fmaf in ascending k; there is no shuffle reduction in
//     either type.
//   - Activations are exchanged once, in the type the next product
//     reads (bf16-rounded for bf16 weights), beside the f32 state that
//     only the owning block needs for its gate update.  The exchange
//     buffers keep, in global memory already, the row pitch the products
//     want in shared memory (rows padded so the B-fragment loads hit 32
//     banks, K padded to whole k-steps with zeros, the concat-input
//     layers' aux columns after their z columns, written a step ahead
//     by the row's owner), so a chunk of rows is one contiguous piece
//     and staging is a flat cp.async copy (16 bytes a thread, L2 only)
//     into two buffers: the next chunk's loads run under a chunk's
//     products.  The plan gives a GRU chunk the most rows of input and
//     hidden state that fit (24 beside the resident bf16 slice, 40 beside
//     one phase's), and an fc chunk, whose rows hold no hidden state,
//     more rows in the same bytes (72).  Blocks take the chunks in
//     rotated orders, so that the grid does not ask L2 for the same rows
//     at once.  With bf16 weights a chunk's gate math runs on the
//     block's last warps, out of a second partial-sum buffer, while the
//     first warps are at the next chunk's products: one block barrier a
//     chunk.
//   - With bf16 weights by phase the last four warps (six in an fc
//     phase) issue the copies and hold no product task, so that no warp's
//     products wait behind its copies; where a chunk's tasks of one 8-row
//     batch tile would outnumber the warps left, a task takes two batch
//     tiles and loads each weight fragment once for both.
//   - K is split over warps in a way fixed by the widths alone (2
//     halves on the tensor cores, 8 slices in f32); partial sums meet in
//     shared memory and are added in slice order.  A row's sums thus
//     never depend on B, the grid, the chunk, the task or where the
//     weights live: a batch row equals its solo run, bit for bit.
//   - The sample phase takes groups of 8 rows, or up to 10 where that
//     gives every block one group and none two.
//   - The step barrier is cooperative_groups' grid.sync(): 1.0 us on
//     132 blocks, what a hand-written one (a release add on a monotone
//     counter per block, an acquire spin) measured too.
//   - The streams of step t + 1 (i_static, a_rest, noise) are
//     prefetched into L2 during step t.
//
// bf16 weights: the stored matrices are bf16, every product's input is
// rounded to bf16 (round to nearest even) by its producer, products are
// exact and sums f32, biases and gate math f32: the contraction of
// wavernn._mm.  State that one phase writes while other blocks still
// read it (h1, h2) is double-buffered; cross-block state is read from
// L2 (cp.async.cg, __ldcg), never from a possibly stale L1 line.
//
// With a stamp buffer the kernel writes %globaltimer four times per
// phase of block 0: the last chunk's inputs staged, its products done,
// arrived at the barrier, left it.
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
constexpr int SMEM_MAX = 232448;   // bytes a Hopper block can use
constexpr int GRU_PER_TILE = 5;    // units (3 gate rows each) per 16-row tile
constexpr int FC_PER_TILE = 8;     // fc outputs per (half) tile
constexpr int KSPLIT_BF16 = 2;     // K halves per tile on the tensor cores
constexpr int KSPLIT_F32 = 8;      // K slices per weight row in f32
constexpr int NB = 2;              // staging buffers
constexpr int COPY_NT = 128;       // threads that copy, where not all
constexpr int COPY_NT_FC = 192;    // the same in an fc phase
constexpr int N_STAMPS = 20;       // 4 stamps x 5 phases a step
constexpr int GR_MAX = 10;         // most rows of a sample group
constexpr int N_SECTIONS = 7;      // weight sections of a block's slice
constexpr float LOG_SCALE_MIN = -32.23619130191664f;   // log(1e-14)
constexpr float LOG_STD_MIN = -7.0f;

enum Ptr {
  P_ISTATIC, P_AREST, P_N1, P_N2,
  // every block's slice of the seven matrices: bf16 in fragment order,
  // f32 as padded rows
  P_PACKED,
  P_RNN1_BIH, P_RNN1_BHH, P_RNN2_BIH, P_RNN2_BHH, P_FC1_B, P_FC2_B,
  P_FC3_B, P_W_X,
  P_OUT, P_SCRATCH, P_STAMPS, N_PTRS
};

enum Dim {
  D_T, D_B, D_R, D_F, D_D, D_NC, D_K, D_GAUSS, D_BF16, D_G, D_BY_PHASE,
  N_DIMS
};

enum PlanField {
  PL_SLG, PL_SLF, PL_TG, PL_TF, PL_T3, PL_KS_R, PL_KS_RD, PL_KS_F,
  PL_KS_FD, PL_W_BYTES, PL_BY_PHASE, PL_W_SMEM, PL_M_ROWS, PL_KSPLIT, PL_CH,
  PL_PS, PL_CH_FC, PL_PS_FC,
  PL_P_R, PL_P_RD, PL_P_F, PL_P_FD, PL_STRIDE_A, PL_STRIDE_H, PL_OFF_STAGE, PL_OFF_PART, PL_OFF_MISC, PL_TOTAL,
  N_PLAN
};

// The shared-memory layout and tile counts, from the widths and the
// grid (cuda_gen.py::smem_plan mirrors it).
struct Plan {
  int slg, slf;                 // most GRU units / fc outputs of a block
  int tg, tf, t3;               // m-tiles: per GRU matrix, per fc, fc3
  int ks_r, ks_rd, ks_f, ks_fd; // 16-wide k-steps of R, R + D, F, F + D
  int w_off[N_SECTIONS + 1];    // a block's slice: rnn1 ih, hh, rnn2 ih,
                                // hh, fc1, fc2, fc3 (byte offsets)
  int by_phase;                 // 1: one phase's weights in shared
                                // memory at a time, copied in phase by
                                // phase (always in f32); 0: the slice
  int w_smem;                   // shared memory for weights: the
                                // slice or its largest phase
  int m_rows;                   // rows of the partial-sum buffer
  int ksplit;
  int ch;                       // rows staged at a time (0: none fits)
  int ps;                       // partial-sum row pitch, floats
  int ch_fc, ps_fc;             // the same for an fc phase, which stages
                                // no hidden state: more rows
  int p_r, p_rd, p_f, p_fd;     // row pitch of an exchange buffer whose
                                // rows hold R, R + D, F, F + D values
  int stride_a, stride_h;       // room per staged row: A part, H part
  int off_stage, off_part, off_misc, total;
};

int cdiv(int a, int b) { return (a + b - 1) / b; }
int imax(int a, int b) { return a > b ? a : b; }
int round16(int a) { return (a + 15) & ~15; }

// Partial-sum pitch for ch staged rows: >= ch and 8 or 24 mod 32 floats,
// so a half-warp's 8-byte fragment stores hit 32 different banks.
int part_pitch(int ch) { return (ch + 7) / 16 * 16 + 8; }

bool make_plan(const int* d, Plan& pl) {
  const int R = d[D_R], F = d[D_F], D = d[D_D], NC = d[D_NC], K = d[D_K];
  const int G = d[D_G];
  const bool bf = d[D_BF16] != 0;
  pl.slg = cdiv(R, G);
  pl.slf = cdiv(F, G);
  pl.tg = cdiv(pl.slg, GRU_PER_TILE);
  pl.tf = cdiv(pl.slf, FC_PER_TILE);
  pl.t3 = cdiv(NC, 16);
  pl.ks_r = cdiv(R, 16);
  pl.ks_rd = cdiv(R + D, 16);
  pl.ks_f = cdiv(F, 16);
  pl.ks_fd = cdiv(F + D, 16);
  // bf16: tiles of 16 (fc: 8) rows x 16 columns in fragment order;
  // f32: a block's rows one after another (3 per GRU unit, gate inside
  // unit), each K + 4 floats long so that lanes on different rows hit
  // different banks
  const int bf_sizes[N_SECTIONS] = {
      pl.tg * pl.ks_r * 512, pl.tg * pl.ks_r * 512, pl.tg * pl.ks_rd * 512,
      pl.tg * pl.ks_r * 512, pl.tf * pl.ks_rd * 256, pl.tf * pl.ks_fd * 256,
      pl.t3 * pl.ks_f * 512};
  const int f32_sizes[N_SECTIONS] = {
      3 * pl.slg * (R + 4) * 4, 3 * pl.slg * (R + 4) * 4,
      3 * pl.slg * (R + D + 4) * 4, 3 * pl.slg * (R + 4) * 4,
      pl.slf * (R + D + 4) * 4, pl.slf * (F + D + 4) * 4, NC * (F + 4) * 4};
  int off = 0;
  for (int i = 0; i < N_SECTIONS; ++i) {
    pl.w_off[i] = off;
    off += bf ? bf_sizes[i] : f32_sizes[i];
  }
  pl.w_off[N_SECTIONS] = off;
  pl.by_phase = !bf || d[D_BY_PHASE] != 0;
  if (pl.by_phase) {
    pl.w_smem = imax(pl.w_off[2], pl.w_off[4] - pl.w_off[2]);
    for (int i = 4; i < N_SECTIONS; ++i)
      pl.w_smem = imax(pl.w_smem, pl.w_off[i + 1] - pl.w_off[i]);
  } else {
    pl.w_smem = off;
  }
  pl.m_rows = 16 * imax(2 * pl.tg, imax(pl.tf, pl.t3));
  pl.ksplit = bf ? KSPLIT_BF16 : KSPLIT_F32;
  if (bf) {
    // whole k-steps, and a pitch in 4-byte words that is 4 mod 8: the 8
    // rows x 4 words of a B-fragment load fall into 32 different banks
    pl.p_r = 32 * pl.ks_r + 16;
    pl.p_rd = 32 * pl.ks_rd + 16;
    pl.p_f = 32 * pl.ks_f + 16;
    pl.p_fd = 32 * pl.ks_fd + 16;
  } else {
    pl.p_r = 4 * R;
    pl.p_rd = 4 * (R + D);
    pl.p_f = 4 * F;
    pl.p_fd = 4 * (F + D);
  }
  pl.stride_a = imax(imax(pl.p_r, pl.p_rd), imax(pl.p_f, pl.p_fd));
  pl.stride_h = pl.p_r;
  // a sample group's samples and their noise
  const int misc = round16(4 * GR_MAX + GR_MAX * (K + 1) * 4);
  pl.off_stage = pl.w_smem;
  pl.ch = 0;
  for (int ch = 40; ch >= 8; ch -= 8) {
    pl.ps = part_pitch(ch);
    const int stage = NB * ch * (pl.stride_a + pl.stride_h);
    // bf16, two: a chunk's sums are finished while the next chunk's are
    // made
    const int part = (bf ? 2 : 1) * pl.ksplit * pl.m_rows * pl.ps * 4;
    pl.off_part = pl.off_stage + stage;
    pl.off_misc = pl.off_part + part;
    pl.total = pl.off_misc + misc;
    if (pl.total <= SMEM_MAX) {
      pl.ch = ch;
      // an fc phase, with weights by phase: the most rows (of 8 more at
      // a time) whose input alone fits the two buffers, and whose
      // partial sums fit theirs
      pl.ch_fc = ch;
      pl.ps_fc = pl.ps;
      for (int c = ch + 8; pl.by_phase && NB * c * pl.stride_a <= stage;
           c += 8) {
        if (16 * pl.tf * part_pitch(c) > pl.m_rows * pl.ps) break;
        pl.ch_fc = c;
        pl.ps_fc = part_pitch(c);
      }
      return true;
    }
  }
  pl.ch_fc = pl.ps_fc = 0;
  return false;                 // total holds the need at 8 rows
}

void plan_fields(const Plan& pl, int* out) {
  out[PL_SLG] = pl.slg; out[PL_SLF] = pl.slf; out[PL_TG] = pl.tg;
  out[PL_TF] = pl.tf; out[PL_T3] = pl.t3; out[PL_KS_R] = pl.ks_r;
  out[PL_KS_RD] = pl.ks_rd; out[PL_KS_F] = pl.ks_f;
  out[PL_KS_FD] = pl.ks_fd; out[PL_W_BYTES] = pl.w_off[N_SECTIONS];
  out[PL_BY_PHASE] = pl.by_phase;
  out[PL_W_SMEM] = pl.w_smem; out[PL_M_ROWS] = pl.m_rows; out[PL_KSPLIT] = pl.ksplit;
  out[PL_CH] = pl.ch; out[PL_PS] = pl.ps; out[PL_CH_FC] = pl.ch_fc;
  out[PL_PS_FC] = pl.ps_fc; out[PL_P_R] = pl.p_r;
  out[PL_P_RD] = pl.p_rd; out[PL_P_F] = pl.p_f; out[PL_P_FD] = pl.p_fd;
  out[PL_STRIDE_A] = pl.stride_a;
  out[PL_STRIDE_H] = pl.stride_h; out[PL_OFF_STAGE] = pl.off_stage;
  out[PL_OFF_PART] = pl.off_part; out[PL_OFF_MISC] = pl.off_misc;
  out[PL_TOTAL] = pl.total;
}

// Scratch, zeroed by the caller: f32 state that only a unit's owner reads (h1, h2, z1, z: B x R each),
// then the exchanged activations in the product's input type, B rows at
// the plan's pitches: z, h1 x 2, h2 x 2 (p_r), z1, z2 (p_rd), f1 (p_fd),
// f2 (p_f).
size_t scratch_bytes(const int* d) {
  Plan pl;
  make_plan(d, pl);
  const size_t B = d[D_B], R = d[D_R];
  const size_t rows_r = (B * R + 7) & ~(size_t)7;
  return 4 * rows_r * 4
      + B * (5 * (size_t)pl.p_r + 2 * (size_t)pl.p_rd + pl.p_fd + pl.p_f);
}

struct Params {
  const float* i_static;   // (T, B, R)
  const float* a_rest;     // (T, B, 3 D) or null when D == 0
  const float* n1;         // (T, B, K) mixture noise (MOL) or null
  const float* n2;         // (T, B) sample noise
  const unsigned char* packed;   // the blocks' slices, (G, w_bytes)
  const float* b1i; const float* b1h;     // (3R)
  const float* b2i; const float* b2h;
  const float* bf1; const float* bf2;     // (F)
  const float* b3;         // (NC)
  const float* w_x;        // (R)
  float* out;              // (B, T)
  float* hf1; float* hf2;  // f32 hidden state, owner only
  float* z1f; float* zf;   // f32 z1 and z, owner only
  void* zx; void* h1x[2]; void* z1x; void* h2x[2]; void* z2x;
  void* f1x; void* f2x;    // exchanged activations
  long long* stamps;       // (T, N_STAMPS) or null
  int T, B, R, F, D, NC, K, gauss;
  Plan pl;
};

// The five phases of a step, as the f32 weight buffer names them.
enum Phase { PH_GRU1, PH_GRU2, PH_FC1, PH_FC2, PH_SAMPLE, N_PHASES };

template <bool BF> struct XT_ { typedef float T; };
template <> struct XT_<true> { typedef uint16_t T; };

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// float -> bf16 bits, round to nearest even (what a cast does).
__device__ __forceinline__ uint16_t bf16_bits(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (uint16_t)((u >> 16) | 0x40u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}

__device__ __forceinline__ void store_x(float* p, size_t i, float v) {
  __stcg(p + i, v);
}
__device__ __forceinline__ void store_x(uint16_t* p, size_t i, float v) {
  __stcg(p + i, (unsigned short)bf16_bits(v));
}

__device__ __forceinline__ float dot4(float4 w, float4 x, float acc) {
  acc = fmaf(w.x, x.x, acc);
  acc = fmaf(w.y, x.y, acc);
  acc = fmaf(w.z, x.z, acc);
  return fmaf(w.w, x.w, acc);
}

__device__ __forceinline__ long long globaltimer() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return (long long)ns;
}

__device__ __forceinline__ void cp_async16(void* dst_smem, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst_smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

// Block 0's clock stamp k of the current phase (s null elsewhere).
__device__ __forceinline__ void stamp(long long* s, int k) {
  if (s != nullptr && threadIdx.x == 0) s[k] = globaltimer();
}

// The grid-wide barrier that ends a phase.  ``s`` (block 0 only, or null)
// gets the clock when the block has arrived (2) and when it leaves (3).
__device__ __forceinline__ void grid_barrier(cg::grid_group& grid,
                                             long long* s) {
  __syncthreads();
  stamp(s, 2);
  grid.sync();
  stamp(s, 3);
}

// D = A (16 x 16 bf16, row) * B (16 x 8 bf16, col) + D, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// This lane's B fragment of one k-step (two words 16 bytes apart), and
// of two consecutive k-steps.
__device__ __forceinline__ uint2 ld_bfrag(const unsigned char* x) {
  return make_uint2(*reinterpret_cast<const uint32_t*>(x),
                    *reinterpret_cast<const uint32_t*>(x + 16));
}
__device__ __forceinline__ uint4 ld_bfrag2(const unsigned char* x) {
  return make_uint4(*reinterpret_cast<const uint32_t*>(x),
                    *reinterpret_cast<const uint32_t*>(x + 16),
                    *reinterpret_cast<const uint32_t*>(x + 32),
                    *reinterpret_cast<const uint32_t*>(x + 48));
}

// The output rows of one phase in this block.  Rows come in tiles of 16
// partial-sum rows: nI tiles contract the A buffer, nH tiles the H
// buffer (the GRUs' recurrent halves; partial rows from mH on).
// kind 0: a GRU tile holds units ti*5 .. ti*5 + 4, row (unit % 5) * 3 +
// gate; 1: an fc tile holds outputs ti*8 .. ti*8 + 7 in its lower half;
// 2: fc3, row ti*16 + r of the matrix, the same in every block.
struct Rows {
  int kind, nI, nH, mH;
  int slots;               // this block's units / outputs
  // the two matrices in shared memory: bf16 tiles with their k-steps, or
  // f32 rows (3 per unit, or one per output), their count and length
  const unsigned char* tI; const unsigned char* tH;
  int ksI, ksH;
  int rI, rH;
  int kI, kH;
  int pA, pH;              // row pitch of the staged A and H inputs, bytes
  int mr, ps;              // partial sums: rows of a K slice, row pitch
  int pw;                  // warps that multiply (bf16 tasks)
};

// One phase's products for ``rows`` staged rows on the tensor cores.
// A task is (tile, 8 batch rows, half of the k-steps); its 16 x 8 sums
// go to part[half][tile row][batch row].  PAIR: a task takes two 8-row
// batch tiles (the second may be absent) and loads each weight fragment
// once for both.  A batch tile's sums are taken in the same order either
// way.
template <bool PAIR>
__device__ __forceinline__ void product_bf16_tiles(
    const Rows& rw, const unsigned char* bufA, const unsigned char* bufH,
    int rows, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int ntl = (rows + 7) >> 3;
  const int nb = PAIR ? (ntl + 1) >> 1 : ntl;     // batch tasks a tile
  const int ntask = (rw.nI + rw.nH) * nb * KSPLIT_BF16;
  const bool half = rw.kind == 1;
  for (int task = warp; task < ntask; task += NW) {
    const int kh = task & 1, rest = task >> 1;
    const int nt = (PAIR ? 2 : 1) * (rest % nb), tt = rest / nb;
    const bool two = PAIR && nt + 1 < ntl;
    const bool isH = tt >= rw.nI;
    const int ti = isH ? tt - rw.nI : tt;
    const int ks = isH ? rw.ksH : rw.ksI;
    const int pitch = isH ? rw.pH : rw.pA;
    const unsigned char* wt = (isH ? rw.tH : rw.tI)
        + (size_t)ti * ks * (half ? 256 : 512);
    const unsigned char* xb = (isH ? bufH : bufA)
        + (nt * 8 + g) * pitch + tig * 4;
    const unsigned char* xc = xb + 8 * pitch;     // the second batch tile
    const int kper = (ks + 1) >> 1;
    const int k0 = kh * kper;
    const int k1 = (k0 + kper < ks) ? k0 + kper : ks;
    float c0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float c1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (half) {
      const uint2* a = reinterpret_cast<const uint2*>(wt) + lane;
      int k = k0;
#pragma unroll 2
      for (; k + 1 < k1; k += 2) {
        const uint2 av = a[k * 32], aw = a[k * 32 + 32];
        const uint4 bv = ld_bfrag2(xb + k * 32);
        mma_bf16(c0, av.x, 0u, av.y, 0u, bv.x, bv.y);
        mma_bf16(c1, aw.x, 0u, aw.y, 0u, bv.z, bv.w);
        if (two) {
          const uint4 bu = ld_bfrag2(xc + k * 32);
          mma_bf16(d0, av.x, 0u, av.y, 0u, bu.x, bu.y);
          mma_bf16(d1, aw.x, 0u, aw.y, 0u, bu.z, bu.w);
        }
      }
      if (k < k1) {
        const uint2 av = a[k * 32];
        const uint2 bv = ld_bfrag(xb + k * 32);
        mma_bf16(c0, av.x, 0u, av.y, 0u, bv.x, bv.y);
        if (two) {
          const uint2 bu = ld_bfrag(xc + k * 32);
          mma_bf16(d0, av.x, 0u, av.y, 0u, bu.x, bu.y);
        }
      }
    } else {
      const uint4* a = reinterpret_cast<const uint4*>(wt) + lane;
      int k = k0;
#pragma unroll 2
      for (; k + 1 < k1; k += 2) {
        const uint4 av = a[k * 32], aw = a[k * 32 + 32];
        const uint4 bv = ld_bfrag2(xb + k * 32);
        mma_bf16(c0, av.x, av.y, av.z, av.w, bv.x, bv.y);
        mma_bf16(c1, aw.x, aw.y, aw.z, aw.w, bv.z, bv.w);
        if (two) {
          const uint4 bu = ld_bfrag2(xc + k * 32);
          mma_bf16(d0, av.x, av.y, av.z, av.w, bu.x, bu.y);
          mma_bf16(d1, aw.x, aw.y, aw.z, aw.w, bu.z, bu.w);
        }
      }
      if (k < k1) {
        const uint4 av = a[k * 32];
        const uint2 bv = ld_bfrag(xb + k * 32);
        mma_bf16(c0, av.x, av.y, av.z, av.w, bv.x, bv.y);
        if (two) {
          const uint2 bu = ld_bfrag(xc + k * 32);
          mma_bf16(d0, av.x, av.y, av.z, av.w, bu.x, bu.y);
        }
      }
    }
    const int m0 = (isH ? rw.mH : 0) + ti * 16 + g;
    float* o = part + ((size_t)kh * rw.mr + m0) * rw.ps + nt * 8
        + 2 * tig;
    *reinterpret_cast<float2*>(o) = make_float2(c0[0] + c1[0], c0[1] + c1[1]);
    if (!half)
      *reinterpret_cast<float2*>(o + 8 * rw.ps) =
          make_float2(c0[2] + c1[2], c0[3] + c1[3]);
    if (two) {
      *reinterpret_cast<float2*>(o + 8) =
          make_float2(d0[0] + d1[0], d0[1] + d1[1]);
      if (!half)
        *reinterpret_cast<float2*>(o + 8 + 8 * rw.ps) =
            make_float2(d0[2] + d1[2], d0[3] + d1[3]);
    }
  }
}

// With bf16 weights by phase, whose last warps copy: tasks of two batch
// tiles where tasks of one would outnumber the warps that multiply
// (``pw``); two instantiations of one loop.
__device__ void product_bf16(const Rows& rw, const unsigned char* bufA,
                             const unsigned char* bufH, int rows,
                             float* part) {
  if ((rw.nI + rw.nH) * ((rows + 7) >> 3) * KSPLIT_BF16 > rw.pw)
    product_bf16_tiles<true>(rw, bufA, bufH, rows, part);
  else
    product_bf16_tiles<false>(rw, bufA, bufH, rows, part);
}

// One weight row's slice (n float4 at wp) against up to NV staged rows
// (nv of them valid), summed with fmaf in ascending k.
template <int NV>
__device__ __forceinline__ void f32_rows(const float4* wp,
                                         const unsigned char* xb, int pitch,
                                         int n, int nv, float* o) {
  float acc[NV];
#pragma unroll
  for (int q = 0; q < NV; ++q) acc[q] = 0.0f;
#pragma unroll 2
  for (int i = 0; i < n; ++i) {
    const float4 wv = wp[i];
#pragma unroll
    for (int q = 0; q < NV; ++q)
      if (NV <= 2 || q < nv)
        acc[q] = dot4(wv, *reinterpret_cast<const float4*>(
                              xb + q * pitch + i * 16), acc[q]);
  }
#pragma unroll
  for (int q = 0; q < NV; ++q)
    if (NV <= 2 || q < nv) o[q] = acc[q];
}

// The same products with f32 weights, from the phase's rows in shared
// memory, K in KSPLIT_F32 slices summed in ascending k.  A GRU's or
// fc3's many rows: a task is (32 weight rows = 32 lanes, 4 batch rows,
// a K slice), a lane owns one weight row.  An fc layer's few rows: a
// task is (8 weight rows, 8 batch rows, a K slice), lane 8 q + j owns
// weight row j and batch rows 2 q, 2 q + 1.
__device__ void product_f32(const Rows& rw, const unsigned char* bufA,
                            const unsigned char* bufH, int rows,
                            float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (rw.kind == 1) {
    const int ntl = (rows + 7) >> 3;
    const int groups = (rw.rI + 7) >> 3;
    const int ntask = groups * ntl * KSPLIT_F32;
    const int k4 = rw.kI >> 2, kper = (k4 + KSPLIT_F32 - 1) / KSPLIT_F32;
    for (int task = warp; task < ntask; task += NW) {
      const int kq = task % KSPLIT_F32, rest = task / KSPLIT_F32;
      const int nt = rest % ntl, jj = (rest / ntl) * 8 + (lane & 7);
      const int b = nt * 8 + (lane >> 3) * 2;      // first of two rows
      if (jj >= rw.slots || b >= rows) continue;
      const int k0 = kq * kper;
      const int n = (k0 + kper < k4 ? k0 + kper : k4) - k0;
      const float4* wp = reinterpret_cast<const float4*>(
          rw.tI + (size_t)jj * (rw.kI + 4) * 4) + k0;
      const unsigned char* xb = bufA + b * rw.pA + k0 * 16;
      float* o = part + ((size_t)kq * rw.mr
                         + (jj / FC_PER_TILE) * 16 + jj % FC_PER_TILE) * rw.ps
          + b;
      if (b + 1 < rows) f32_rows<2>(wp, xb, rw.pA, n, 2, o);
      else f32_rows<1>(wp, xb, rw.pA, n, 1, o);
    }
    return;
  }
  const int ntl = (rows + 3) >> 2;
  const int groups = (rw.rI + rw.rH + 31) >> 5;
  const int ntask = groups * ntl * KSPLIT_F32;
  for (int task = warp; task < ntask; task += NW) {
    const int kq = task % KSPLIT_F32, rest = task / KSPLIT_F32;
    const int nt = rest % ntl, j = (rest / ntl) * 32 + lane;
    const bool isH = j >= rw.rI;
    const int jj = isH ? j - rw.rI : j;
    int m = -1;                         // this lane's partial-sum row
    if (j < rw.rI + rw.rH) {
      if (rw.kind == 0) {
        const int s = jj / 3;
        if (s < rw.slots)
          m = (s / GRU_PER_TILE) * 16 + (s % GRU_PER_TILE) * 3 + jj % 3;
      } else {
        m = jj;
      }
    }
    if (m < 0) continue;
    if (isH) m += rw.mH;
    const int kk = isH ? rw.kH : rw.kI;
    const int k4 = kk >> 2, kper = (k4 + KSPLIT_F32 - 1) / KSPLIT_F32;
    const int k0 = kq * kper;
    const int n = (k0 + kper < k4 ? k0 + kper : k4) - k0;
    const float4* wp = reinterpret_cast<const float4*>(
        (isH ? rw.tH : rw.tI) + (size_t)jj * (kk + 4) * 4) + k0;
    const int pitch = isH ? rw.pH : rw.pA;
    const unsigned char* xb = (isH ? bufH : bufA) + (nt * 4) * pitch
        + k0 * 16;
    const int nv = rows - nt * 4;       // valid rows of this group
    float* o = part + ((size_t)kq * rw.mr + m) * rw.ps + nt * 4;
    if (nv == 1) f32_rows<1>(wp, xb, pitch, n, nv, o);
    else if (nv == 2) f32_rows<2>(wp, xb, pitch, n, nv, o);
    else f32_rows<4>(wp, xb, pitch, n, nv, o);
  }
}

// Rows of a sample group: 8, or where 8-row groups would give some
// blocks two, up to GR_MAX, so that each block takes one (rows past 8 need
// partial-sum rows of 16 columns).
__device__ __forceinline__ int group_rows(const Params& p) {
  const int gr = (p.B + (int)gridDim.x - 1) / (int)gridDim.x;
  if (gr <= 8 || p.pl.ps < 16) return 8;
  return gr < GR_MAX ? gr : GR_MAX;
}

// Which phases this block has rows in, the next such phase after q, and
// the copy of a phase's weight rows into the buffer.
__device__ __forceinline__ bool has_rows(const Params& p, int q) {
  const int bid = blockIdx.x;
  if (q <= PH_GRU2) return bid < p.R;
  if (q <= PH_FC2) return bid < p.F;
  return bid * group_rows(p) < p.B;
}
__device__ __forceinline__ void load_weights(const Params& p,
                                             unsigned char* smem, int q) {
  const Plan& pl = p.pl;
  const int first = q <= PH_GRU2 ? 2 * q : q + 2;
  const int last = q <= PH_GRU2 ? first + 2 : first + 1;
  const unsigned char* src = p.packed
      + (size_t)blockIdx.x * pl.w_off[N_SECTIONS] + pl.w_off[first];
  const int n = pl.w_off[last] - pl.w_off[first];
  for (int c = threadIdx.x * 16; c < n; c += NT * 16)
    cp_async16(smem + c, src + c);
  cp_async_commit();
}
// Before phase q's first staging: its rows, unless already on their way.
__device__ __forceinline__ void want_weights(const Params& p,
                                             unsigned char* smem, int q,
                                             int& held) {
  if (held != q) load_weights(p, smem, q);
  held = q;
}
// After phase q's last products: the rows of the block's next phase.
__device__ __forceinline__ void next_weights(const Params& p,
                                             unsigned char* smem, int q,
                                             int& held) {
  int nq = q;
  do { nq = nq + 1 == N_PHASES ? 0 : nq + 1; } while (!has_rows(p, nq));
  if (nq != q) load_weights(p, smem, nq);
  held = nq;
}

// Partial row m, batch row bl: the K slices added in slice order.
template <bool BF>
__device__ __forceinline__ float psum(const float* part, const Rows& rw,
                                      int m, int bl) {
  constexpr int KS = BF ? KSPLIT_BF16 : KSPLIT_F32;
  const float* q = part + m * rw.ps + bl;
  const int step = rw.mr * rw.ps;
  float s = q[0];
#pragma unroll
  for (int k = 1; k < KS; ++k) s += q[k * step];
  return s;
}

// The address of ring buffer ``buf``.
__device__ __forceinline__ unsigned char* ring_buf(unsigned char* smem,
                                                   const Plan& pl, int buf) {
  return smem + pl.off_stage + buf * pl.ch * (pl.stride_a + pl.stride_h);
}

// Start the copy of ``bytes`` contiguous bytes (a multiple of 16) from
// global src to shared dst, 16 bytes a thread at a time, on the block's
// last n threads.
__device__ __forceinline__ void stage_flat(unsigned char* dst,
                                           const unsigned char* src,
                                           int bytes, int n = NT) {
  const int t = (int)threadIdx.x - (NT - n);
  if (t < 0) return;
  for (int i = t * 16; i < bytes; i += n * 16)
    cp_async16(dst + i, src + i);
}

// The threads that copy a GRU or fc phase's chunks: with bf16 weights
// copied in by phase (many rows, large chunks) the last four warps (an fc
// phase's larger input chunks: six), which then hold no product task, so
// that no warp's products wait behind its copies; else all.  And the
// warps that multiply.
__device__ __forceinline__ int copy_threads(const Plan& pl, bool bf,
                                            bool fc = false) {
  return bf && pl.by_phase ? (fc ? COPY_NT_FC : COPY_NT) : NT;
}
__device__ __forceinline__ int product_warps(int copy_nt) {
  return copy_nt == NT ? NW : NW - copy_nt / 32;
}

template <bool BF>
__device__ __forceinline__ void product(const Rows& rw,
                                        const unsigned char* bufA,
                                        const unsigned char* bufH, int rows,
                                        float* part) {
  if (BF) product_bf16(rw, bufA, bufH, rows, part);
  else product_f32(rw, bufA, bufH, rows, part);
}

// One GRU layer for every row (torch gate order r, z, n).  layer 0:
// input z (from the previous sample's owner), output z1 = z + h1;
// layer 1: input [z1, aux slice 0], output z2 = z1 + h2.
template <bool BF>
__device__ void gru_phase(const Params& p, unsigned char* smem, int layer,
                          int cur, long long* st, int& held) {
  typedef typename XT_<BF>::T XT;
  const Plan& pl = p.pl;
  const int R = p.R, B = p.B, G = gridDim.x, bid = blockIdx.x;
  const int slots = bid < R ? (R - 1 - bid) / G + 1 : 0;
  if (slots == 0) return;
  const int es = sizeof(XT);
  const int k_in = R + (layer ? p.D : 0);
  Rows rw;
  rw.kind = 0;
  rw.nI = rw.nH = (slots + GRU_PER_TILE - 1) / GRU_PER_TILE;
  rw.mH = 16 * pl.tg;
  rw.slots = slots;
  rw.tI = smem + (pl.by_phase ? 0 : pl.w_off[2 * layer]);
  rw.tH = rw.tI + pl.w_off[2 * layer + 1] - pl.w_off[2 * layer];
  rw.ksI = layer ? pl.ks_rd : pl.ks_r;
  rw.ksH = pl.ks_r;
  rw.rI = rw.rH = 3 * pl.slg;
  rw.kI = k_in;
  rw.kH = R;
  rw.pA = layer ? pl.p_rd : pl.p_r;
  rw.pH = pl.p_r;
  rw.mr = pl.m_rows;
  rw.ps = pl.ps;
  const int copy_nt = copy_threads(pl, BF);
  rw.pw = product_warps(copy_nt);
  const int ea = rw.pA / es, eh = rw.pH / es;   // pitches in elements
  const XT* zin_x = static_cast<const XT*>(layer ? p.z1x : p.zx);
  const float* zin_f = layer ? p.z1f : p.zf;
  const XT* h_in = static_cast<const XT*>(layer ? p.h2x[cur] : p.h1x[cur]);
  XT* h_out = static_cast<XT*>(layer ? p.h2x[cur ^ 1] : p.h1x[cur ^ 1]);
  float* hf = layer ? p.hf2 : p.hf1;
  XT* z_out = static_cast<XT*>(layer ? p.z2x : p.z1x);
  const float* b_ih = layer ? p.b2i : p.b1i;
  const float* b_hh = layer ? p.b2h : p.b1h;
  float* part = reinterpret_cast<float*>(smem + pl.off_part);
  const int eo = pl.p_rd / es;                   // z1 and z2 rows

  // chunks in an order rotated by the block, so that the grid does not
  // ask L2 for the same rows at the same time
  const int nch = (B + pl.ch - 1) / pl.ch;
  const int c_first = bid % nch;
  auto chunk_b0 = [&](int c) {
    const int cc = c + c_first;
    return (cc < nch ? cc : cc - nch) * pl.ch;
  };
  auto stage = [&](int c) {
    if (c < nch) {
      const int b0 = chunk_b0(c);
      const int rows = B - b0 < pl.ch ? B - b0 : pl.ch;
      unsigned char* bufA = ring_buf(smem, pl, c & 1);
      stage_flat(bufA, reinterpret_cast<const unsigned char*>(
                     zin_x + (size_t)b0 * ea), rows * rw.pA, copy_nt);
      stage_flat(bufA + pl.ch * pl.stride_a,
                 reinterpret_cast<const unsigned char*>(
                     h_in + (size_t)b0 * eh), rows * rw.pH, copy_nt);
    }
    cp_async_commit();
  };

  // bf16: the gate math of a chunk runs on the block's last threads
  // while its first warps are at the next chunk's products, out of a
  // second partial-sum buffer: item e of a chunk (unit e / rows, row
  // e % rows) belongs to thread NT - 1 - e.  f32 (every warp has
  // products, the second buffer does not fit) and a single chunk: the
  // gate math follows its chunk's products, item e on thread e.  The
  // old state and biases of the last chunk's items are loaded ahead,
  // under its staging.
  const bool lap = BF && nch > 1;
  const int e0 = lap ? NT - 1 - (int)threadIdx.x : (int)threadIdx.x;
  const int part_n = pl.ksplit * rw.mr * rw.ps;
  // the last chunk's first item of this thread: old h, z, the six biases
  float a_hp = 0.0f, a_zi = 0.0f, a_ir = 0.0f, a_iz = 0.0f, a_in = 0.0f;
  float a_hr = 0.0f, a_hz = 0.0f, a_hn = 0.0f;
  auto gates = [&](int c, bool pre) {
    const int b0 = chunk_b0(c);
    const int rows = B - b0 < pl.ch ? B - b0 : pl.ch;
    const float* pc = part + (lap ? c & 1 : 0) * part_n;
    for (int it = e0; it < slots * rows; it += NT) {
      const int s = it / rows, bl = it - s * rows;
      const int u = bid + s * G;
      const int mI = (s / GRU_PER_TILE) * 16 + (s % GRU_PER_TILE) * 3;
      const int mH = rw.mH + mI;
      const size_t o = (size_t)(b0 + bl) * R + u;
      const bool got = pre && it == e0;
      const float hp = got ? a_hp : __ldcg(hf + o);
      const float zi = got ? a_zi : __ldcg(zin_f + o);
      const float i_r = psum<BF>(pc, rw, mI, bl)
          + (got ? a_ir : __ldg(b_ih + u));
      const float i_z = psum<BF>(pc, rw, mI + 1, bl)
          + (got ? a_iz : __ldg(b_ih + R + u));
      const float i_n = psum<BF>(pc, rw, mI + 2, bl)
          + (got ? a_in : __ldg(b_ih + 2 * R + u));
      const float h_r = psum<BF>(pc, rw, mH, bl)
          + (got ? a_hr : __ldg(b_hh + u));
      const float h_z = psum<BF>(pc, rw, mH + 1, bl)
          + (got ? a_hz : __ldg(b_hh + R + u));
      const float h_n = psum<BF>(pc, rw, mH + 2, bl)
          + (got ? a_hn : __ldg(b_hh + 2 * R + u));
      const float r = sigmoidf_(i_r + h_r);
      const float zg = sigmoidf_(i_z + h_z);
      const float n = tanhf(i_n + r * h_n);
      const float h = (1.0f - zg) * n + zg * hp;
      __stcg(hf + o, h);
      store_x(h_out, (size_t)(b0 + bl) * eh + u, h);
      const float zo = zi + h;
      if (layer == 0) __stcg(p.z1f + o, zo);
      store_x(z_out, (size_t)(b0 + bl) * eo + u, zo);
    }
  };

  if (pl.by_phase) want_weights(p, smem, layer, held);
  stage(0);
  for (int c = 0; c < nch; ++c) {
    const int b0 = chunk_b0(c);
    const int rows = B - b0 < pl.ch ? B - b0 : pl.ch;
    if (c + 1 == nch && e0 < slots * rows) {
      const int s = e0 / rows, u = bid + s * G;
      const size_t o = (size_t)(b0 + e0 - s * rows) * R + u;
      a_hp = __ldcg(hf + o);
      a_zi = __ldcg(zin_f + o);
      a_ir = __ldg(b_ih + u);
      a_iz = __ldg(b_ih + R + u);
      a_in = __ldg(b_ih + 2 * R + u);
      a_hr = __ldg(b_hh + u);
      a_hz = __ldg(b_hh + R + u);
      a_hn = __ldg(b_hh + 2 * R + u);
    }
    cp_async_wait<0>();
    __syncthreads();               // chunk c has landed; chunk c - 1's
                                   // products are done and its buffer free
    stage(c + 1);
    if (c + 1 == nch) stamp(st, 0);
    const unsigned char* bufA = ring_buf(smem, pl, c & 1);
    product<BF>(rw, bufA, bufA + pl.ch * pl.stride_a, rows,
                part + (lap ? c & 1 : 0) * part_n);
    if (lap) {
      if (c > 0) gates(c - 1, false);
      if (c + 1 < nch) continue;
    }
    __syncthreads();
    if (c + 1 == nch) {
      stamp(st, 1);
      if (pl.by_phase) next_weights(p, smem, layer, held);
    }
    gates(c, c + 1 == nch);
  }
}

// One fully connected layer with ReLU for every row:
// out[b, j] = relu(w[j] . [in[b], aux slice] + bias[j]).
// which 0: fc1 on [z2, aux slice 1]; 1: fc2 on [f1, aux slice 2].
template <bool BF>
__device__ void fc_phase(const Params& p, unsigned char* smem, int which,
                         long long* st, int& held) {
  typedef typename XT_<BF>::T XT;
  const Plan& pl = p.pl;
  const int B = p.B, F = p.F, G = gridDim.x, bid = blockIdx.x;
  const int slots = bid < F ? (F - 1 - bid) / G + 1 : 0;
  if (slots == 0) return;
  const int es = sizeof(XT);
  const int n_in = which ? p.F : p.R;
  const int k_in = n_in + p.D;
  Rows rw;
  rw.kind = 1;
  rw.nI = (slots + FC_PER_TILE - 1) / FC_PER_TILE;
  rw.nH = 0;
  rw.mH = 0;
  rw.slots = slots;
  rw.tI = smem + (pl.by_phase ? 0 : pl.w_off[4 + which]);
  rw.tH = nullptr;
  rw.ksI = which ? pl.ks_fd : pl.ks_rd;
  rw.ksH = 0;
  rw.rI = pl.slf;
  rw.rH = 0;
  rw.kI = k_in;
  rw.kH = 0;
  rw.pA = which ? pl.p_fd : pl.p_rd;
  rw.pH = 0;
  rw.mr = 16 * pl.tf;
  rw.ps = pl.ps_fc;
  const int copy_nt = copy_threads(pl, BF, true);
  rw.pw = product_warps(copy_nt);
  const int ea = rw.pA / es;                       // pitches in elements
  const int eo = (which ? pl.p_f : pl.p_fd) / es;  // f2 and f1 rows
  const XT* in = static_cast<const XT*>(which ? p.f1x : p.z2x);
  XT* out = static_cast<XT*>(which ? p.f2x : p.f1x);
  const float* bias = which ? p.bf2 : p.bf1;
  float* part = reinterpret_cast<float*>(smem + pl.off_part);

  // chunks of ch_fc input rows, in two buffers in the GRUs' bytes
  const int ch = pl.ch_fc;
  const int nch = (B + ch - 1) / ch;
  const int c_first = bid % nch;
  auto chunk_b0 = [&](int c) {
    const int cc = c + c_first;
    return (cc < nch ? cc : cc - nch) * ch;
  };
  auto stage = [&](int c) {
    if (c < nch) {
      const int b0 = chunk_b0(c);
      const int rows = B - b0 < ch ? B - b0 : ch;
      stage_flat(smem + pl.off_stage + (c & 1) * ch * pl.stride_a,
                 reinterpret_cast<const unsigned char*>(
                     in + (size_t)b0 * ea), rows * rw.pA, copy_nt);
    }
    cp_async_commit();
  };
  // bias and ReLU of a chunk, on the threads a GRU's gate math takes
  const bool lap = BF && nch > 1;
  const int e0 = lap ? NT - 1 - (int)threadIdx.x : (int)threadIdx.x;
  const int part_n = pl.ksplit * rw.mr * rw.ps;
  auto relu = [&](int c) {
    const int b0 = chunk_b0(c);
    const int rows = B - b0 < ch ? B - b0 : ch;
    const float* pc = part + (lap ? c & 1 : 0) * part_n;
    for (int it = e0; it < slots * rows; it += NT) {
      const int s = it / rows, bl = it - s * rows;
      const int j = bid + s * G;
      const int m = (s / FC_PER_TILE) * 16 + s % FC_PER_TILE;
      store_x(out, (size_t)(b0 + bl) * eo + j,
              fmaxf(psum<BF>(pc, rw, m, bl) + __ldg(bias + j), 0.0f));
    }
  };

  if (pl.by_phase) want_weights(p, smem, PH_FC1 + which, held);
  stage(0);
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<0>();
    __syncthreads();
    stage(c + 1);
    const int b0 = chunk_b0(c);
    const int rows = B - b0 < ch ? B - b0 : ch;
    if (c + 1 == nch) stamp(st, 0);
    const unsigned char* bufA = smem + pl.off_stage + (c & 1) * ch * pl.stride_a;
    product<BF>(rw, bufA, bufA, rows,
                part + (lap ? c & 1 : 0) * part_n);
    if (lap) {
      if (c > 0) relu(c - 1);
      if (c + 1 < nch) continue;
    }
    __syncthreads();
    if (c + 1 == nch) {
      stamp(st, 1);
      if (pl.by_phase) next_weights(p, smem, PH_FC1 + which, held);
    }
    relu(c);
  }
}

// z[b, i] = i_static[t, b, i] + x[b] * w_x[i], the product rounded
// before the sum as the plain version's two operations are.
__device__ __forceinline__ float z_sum(float is, float x, float wx) {
  return __fadd_rn(is, __fmul_rn(x, wx));
}

// Four columns of z of step tn for row b: the f32 copy for GRU 1's
// owner and the copy GRU 1's product reads.
template <typename XT>
__device__ __forceinline__ void emit_z(const Params& p, int b, int c4,
                                       float4 is, float x) {
  const float4 wx = __ldg(reinterpret_cast<const float4*>(p.w_x) + c4);
  const float4 z = make_float4(z_sum(is.x, x, wx.x), z_sum(is.y, x, wx.y),
                               z_sum(is.z, x, wx.z), z_sum(is.w, x, wx.w));
  __stcg(reinterpret_cast<float4*>(p.zf + (size_t)b * p.R + 4 * c4), z);
  const size_t o = (size_t)b * (p.pl.p_r / sizeof(XT)) + 4 * c4;
  if (sizeof(XT) == 2) {
    const uint2 v = make_uint2(
        (uint32_t)bf16_bits(z.x) | ((uint32_t)bf16_bits(z.y) << 16),
        (uint32_t)bf16_bits(z.z) | ((uint32_t)bf16_bits(z.w) << 16));
    __stcg(reinterpret_cast<uint2*>(static_cast<uint16_t*>(p.zx) + o), v);
  } else {
    __stcg(reinterpret_cast<float4*>(static_cast<float*>(p.zx) + o), z);
  }
}

__device__ __forceinline__ float4 ld_istatic(const Params& p, int tn, int b,
                                             int c4) {
  return __ldg(reinterpret_cast<const float4*>(
      p.i_static + ((size_t)tn * p.B + b) * p.R) + c4);
}

// fc3 and the sample.  A block owns groups of gr rows (group_rows: 8 to
// GR_MAX; group n belongs to block n % G): logits = w3 . f2[b] + b3, then
// by one warp per row the
// mixture-of-logistics sample (first argmax of logits[:K] + gumbel, the
// selected mean and log-scale clamped at log 1e-14) or the Gaussian
// sample (log-std clamped at -7), clipped to [-1, 1]; then the whole
// block writes the rows' z of step t + 1.  It also writes the rows' three
// aux slices of step t + 1 behind the columns of z1, z2 and f1, whose
// readers of step t are done.  t < 0: only z (from a zero sample) and
// the aux slices of step 0.
template <bool BF>
__device__ void sample_phase(const Params& p, unsigned char* smem, int t,
                             long long* st, int& held) {
  typedef typename XT_<BF>::T XT;
  const Plan& pl = p.pl;
  const int B = p.B, F = p.F, NC = p.NC, K = p.K, G = gridDim.x;
  const int tid = threadIdx.x;
  const int es = sizeof(XT);
  Rows rw;
  rw.kind = 2;
  rw.nI = pl.t3;
  rw.nH = 0;
  rw.mH = 0;
  rw.slots = 0;
  rw.tI = smem + (pl.by_phase ? 0 : pl.w_off[6]);
  rw.tH = nullptr;
  rw.ksI = pl.ks_f;
  rw.ksH = 0;
  rw.rI = NC;
  rw.rH = 0;
  rw.kI = F;
  rw.kH = 0;
  rw.pA = pl.p_f;
  rw.pH = 0;
  rw.mr = pl.m_rows;
  rw.ps = pl.ps;
  rw.pw = NW;
  unsigned char* bufA = smem + pl.off_stage;
  float* part = reinterpret_cast<float*>(smem + pl.off_part);
  float* xs = reinterpret_cast<float*>(smem + pl.off_misc);
  float* noise = xs + GR_MAX;
  const bool next = t + 1 < p.T;
  const int r4 = p.R >> 2;
  const int gr = group_rows(p);
  for (int grp = blockIdx.x; grp * gr < B; grp += G) {
    const int b0 = grp * gr;
    const int rows = B - b0 < gr ? B - b0 : gr;
    const int nz = next ? rows * r4 : 0;
    if (t >= 0) {
      __syncthreads();             // the previous group is done with smem
      if (pl.by_phase) want_weights(p, smem, PH_SAMPLE, held);
      stage_flat(bufA, static_cast<const unsigned char*>(p.f2x)
                     + (size_t)b0 * pl.p_f, rows * pl.p_f);
      cp_async_commit();
      for (int i = tid; i < rows * (K + 1); i += NT) {
        const int r = i / (K + 1), k = i - r * (K + 1);
        const size_t row = (size_t)t * B + b0 + r;
        noise[i] = k < K ? __ldg(p.n1 + row * K + k) : __ldg(p.n2 + row);
      }
    }
    if (next && p.D > 0) {         // a row a warp: its aux slices
      const int lane = tid & 31, D = p.D;
      for (int r = tid >> 5; r < rows; r += NW) {
        const size_t b = b0 + r;
        const float* a = p.a_rest + ((size_t)(t + 1) * B + b) * 3 * D;
        XT* d0 = static_cast<XT*>(p.z1x) + b * (pl.p_rd / es) + p.R;
        XT* d1 = static_cast<XT*>(p.z2x) + b * (pl.p_rd / es) + p.R;
        XT* d2 = static_cast<XT*>(p.f1x) + b * (pl.p_fd / es) + F;
        for (int l = lane; l < 3 * D; l += 32) {
          const int sl = l / D;
          store_x(sl == 0 ? d0 : (sl == 1 ? d1 : d2), l - sl * D,
                  __ldg(a + l));
        }
      }
    }
    // the first of this thread's columns of i_static[t + 1], loaded
    // under the product
    float4 pre0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), pre1 = pre0;
    if (tid < nz) pre0 = ld_istatic(p, t + 1, b0 + tid / r4, tid % r4);
    if (tid + NT < nz)
      pre1 = ld_istatic(p, t + 1, b0 + (tid + NT) / r4, (tid + NT) % r4);
    if (t >= 0) {
      cp_async_wait<0>();
      __syncthreads();
      stamp(st, 0);
      product<BF>(rw, bufA, bufA, rows, part);
      __syncthreads();
      stamp(st, 1);
      if (pl.by_phase && (grp + G) * gr >= B)
        next_weights(p, smem, PH_SAMPLE, held);
      if ((tid >> 5) < rows) {     // one warp a row, a lane a mixture
        const int bl = tid >> 5, lane = tid & 31;
        const float* nz_row = noise + bl * (K + 1);
        float mean, log_scale;
        if (p.gauss) {
          mean = psum<BF>(part, rw, 0, bl) + __ldg(p.b3);
          log_scale = fmaxf(psum<BF>(part, rw, 1, bl) + __ldg(p.b3 + 1),
                            LOG_STD_MIN);
        } else {
          // the first maximum of logits[:K] + gumbel: ties keep the
          // lowest k, inside a lane and between lanes
          int sel = 0x7fffffff;
          float best = -INFINITY;
          for (int k = lane; k < K; k += 32) {
            const float v = (psum<BF>(part, rw, k, bl) + __ldg(p.b3 + k))
                + nz_row[k];
            if (v > best || sel > K) { best = v; sel = k; }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const float ob = __shfl_xor_sync(0xffffffffu, best, o);
            const int os = __shfl_xor_sync(0xffffffffu, sel, o);
            if (ob > best || (ob == best && os < sel)) { best = ob; sel = os; }
          }
          sel = __shfl_sync(0xffffffffu, sel, 0);
          sel = sel < K ? sel : K - 1;
          mean = psum<BF>(part, rw, K + sel, bl) + __ldg(p.b3 + K + sel);
          log_scale = fmaxf(psum<BF>(part, rw, 2 * K + sel, bl)
                            + __ldg(p.b3 + 2 * K + sel), LOG_SCALE_MIN);
        }
        const float s = fminf(fmaxf(__fadd_rn(
            mean, __fmul_rn(expf(log_scale), nz_row[K])), -1.0f), 1.0f);
        if (lane == 0) {
          xs[bl] = s;
          p.out[(size_t)(b0 + bl) * p.T + t] = s;
        }
      }
      __syncthreads();
    }
    if (tid < nz)
      emit_z<XT>(p, b0 + tid / r4, tid % r4, pre0, t >= 0 ? xs[tid / r4] : 0.0f);
    if (tid + NT < nz)
      emit_z<XT>(p, b0 + (tid + NT) / r4, (tid + NT) % r4, pre1,
                 t >= 0 ? xs[(tid + NT) / r4] : 0.0f);
    for (int i = tid + 2 * NT; i < nz; i += NT)
      emit_z<XT>(p, b0 + i / r4, i % r4,
                 ld_istatic(p, t + 1, b0 + i / r4, i % r4),
                 t >= 0 ? xs[i / r4] : 0.0f);
  }
}

// Ask L2 for step tn's rows of the input streams, spread over the grid.
__device__ __forceinline__ void prefetch_step(const Params& p, int tn) {
  const size_t gtid = (size_t)blockIdx.x * NT + threadIdx.x;
  const size_t gsize = (size_t)gridDim.x * NT;
  const size_t B = p.B;
  const float* base[4] = {p.i_static + (size_t)tn * B * p.R,
                          p.D ? p.a_rest + (size_t)tn * B * 3 * p.D : nullptr,
                          p.K ? p.n1 + (size_t)tn * B * p.K : nullptr,
                          p.n2 + (size_t)tn * B};
  const size_t len[4] = {B * p.R, B * 3 * p.D, B * p.K, B};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (base[k] == nullptr) continue;
    for (size_t i = gtid * 32; i < len[k]; i += gsize * 32)
      prefetch_l2(base[k] + i);
  }
}

template <bool BF>
__global__ void __launch_bounds__(NT, 1) wavernn_loop_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& pl = p.pl;
  if (!pl.by_phase) {             // bf16: the whole slice, for the launch
    const int n16 = pl.w_off[N_SECTIONS] >> 4;
    const uint4* src = reinterpret_cast<const uint4*>(p.packed)
        + (size_t)blockIdx.x * n16;
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < n16; i += NT) dst[i] = __ldg(src + i);
  }
  int held = -1;                  // by phase: the phase whose rows are in
                                  // smem
  long long* st = (p.stamps != nullptr && blockIdx.x == 0) ? p.stamps
                                                           : nullptr;
  sample_phase<BF>(p, smem, -1, nullptr, held);   // z of step 0
  grid_barrier(grid, nullptr);

  for (int t = 0; t < p.T; ++t) {
    const int cur = t & 1;
    long long* s = st ? st + (size_t)t * N_STAMPS : nullptr;
    if (t + 1 < p.T) prefetch_step(p, t + 1);
    gru_phase<BF>(p, smem, 0, cur, s, held);
    grid_barrier(grid, s);
    if (s) s += 4;
    gru_phase<BF>(p, smem, 1, cur, s, held);
    grid_barrier(grid, s);
    if (s) s += 4;
    fc_phase<BF>(p, smem, 0, s, held);
    grid_barrier(grid, s);
    if (s) s += 4;
    fc_phase<BF>(p, smem, 1, s, held);
    grid_barrier(grid, s);
    if (s) s += 4;
    sample_phase<BF>(p, smem, t, s, held);
    grid_barrier(grid, s);
  }
}

// n barriers and nothing else, on the loop kernel's grid: what one
// barrier costs.
__global__ void __launch_bounds__(NT, 1) barrier_bench_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid_barrier(grid, nullptr);
}

void fill_params(Params& p, const void* const* ptrs, const int* d,
                 const Plan& pl) {
  p.i_static = (const float*)ptrs[P_ISTATIC];
  p.a_rest = (const float*)ptrs[P_AREST];
  p.n1 = (const float*)ptrs[P_N1];
  p.n2 = (const float*)ptrs[P_N2];
  p.packed = (const unsigned char*)ptrs[P_PACKED];
  p.b1i = (const float*)ptrs[P_RNN1_BIH];
  p.b1h = (const float*)ptrs[P_RNN1_BHH];
  p.b2i = (const float*)ptrs[P_RNN2_BIH];
  p.b2h = (const float*)ptrs[P_RNN2_BHH];
  p.bf1 = (const float*)ptrs[P_FC1_B];
  p.bf2 = (const float*)ptrs[P_FC2_B];
  p.b3 = (const float*)ptrs[P_FC3_B];
  p.w_x = (const float*)ptrs[P_W_X];
  p.out = (float*)ptrs[P_OUT];
  p.stamps = (long long*)ptrs[P_STAMPS];
  p.T = d[D_T]; p.B = d[D_B]; p.R = d[D_R]; p.F = d[D_F]; p.D = d[D_D];
  p.NC = d[D_NC]; p.K = d[D_K]; p.gauss = d[D_GAUSS];
  p.pl = pl;

  unsigned char* s = (unsigned char*)ptrs[P_SCRATCH];
  const size_t B = p.B;
  const size_t rows_r = (B * p.R + 7) & ~(size_t)7;
  p.hf1 = (float*)s; s += rows_r * 4;
  p.hf2 = (float*)s; s += rows_r * 4;
  p.z1f = (float*)s; s += rows_r * 4;
  p.zf = (float*)s; s += rows_r * 4;
  p.zx = s; s += B * pl.p_r;
  for (int k = 0; k < 2; ++k) { p.h1x[k] = s; s += B * pl.p_r; }
  for (int k = 0; k < 2; ++k) { p.h2x[k] = s; s += B * pl.p_r; }
  p.z1x = s; s += B * pl.p_rd;
  p.z2x = s; s += B * pl.p_rd;
  p.f1x = s; s += B * pl.p_fd;
  p.f2x = s; s += B * pl.p_f;
}

// The grid must be co-resident: one block an SM, at most the SM count.
cudaError_t check_grid(const void* kernel, int n_blocks, size_t smem) {
  cudaError_t e;
  int dev = 0, n_sm = 0, coop = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)) != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, kernel, NT, smem)) != cudaSuccess) return e;
  if (occ < 1 || n_blocks < 1 || n_blocks > n_sm * occ)
    return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

// One cooperative launch on ``stream``.  Returns a cudaError_t code.
template <bool BF>
int launch(const void* const* ptrs, const int* dims, void* stream) {
  Plan pl;
  if (!make_plan(dims, pl)) return (int)cudaErrorInvalidValue;
  Params p;
  fill_params(p, ptrs, dims, pl);
  const void* kernel = (const void*)wavernn_loop_kernel<BF>;
  const size_t smem = pl.total;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if ((e = check_grid(kernel, dims[D_G], smem)) != cudaSuccess)
    return (int)e;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(kernel, dim3(dims[D_G]), dim3(NT), args,
                                  smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t wavernn_loop_scratch_bytes(const int* dims) {
  return scratch_bytes(dims);
}

// Fills ``out`` (N_PLAN ints, PlanField order); returns 1 when the
// layout fits a block's shared memory, else 0 with PL_TOTAL the bytes
// needed at the smallest chunk.
int wavernn_loop_plan(const int* dims, int* out) {
  Plan pl;
  const bool ok = make_plan(dims, pl);
  plan_fields(pl, out);
  return ok ? 1 : 0;
}

const char* wavernn_loop_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int wavernn_loop_n_ptrs(void) { return N_PTRS; }
int wavernn_loop_n_dims(void) { return N_DIMS; }
int wavernn_loop_n_plan(void) { return N_PLAN; }
int wavernn_loop_n_stamps(void) { return N_STAMPS; }

// Launch the whole sample loop on ``stream``; returns a cudaError_t code
// (0 = launched).  ``ptrs``: N_PTRS device pointers in Ptr order (a_rest
// null when dims[D_D] == 0, n1 null in Gaussian mode, stamps null or
// zeroed (T, N_STAMPS) int64); the scratch is zeroed by the caller.  ``dims``: N_DIMS ints in
// Dim order.
int wavernn_loop_launch(const void* const* ptrs, const int* dims,
                        void* stream) {
  return dims[D_BF16] ? launch<true>(ptrs, dims, stream)
                      : launch<false>(ptrs, dims, stream);
}

// ``n`` grid barriers on ``n_blocks`` blocks of the loop kernel's size.
int wavernn_loop_barrier_bench(int n, int n_blocks, void* stream) {
  const void* kernel = (const void*)barrier_bench_kernel;
  cudaError_t e = check_grid(kernel, n_blocks, 0);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&n};
  e = cudaLaunchCooperativeKernel(kernel, dim3(n_blocks), dim3(NT), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
