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
// with the recurrent product computed in the kernel, so the (B, 4H) gate
// pre-activations never reach device memory.  With bf16 weights h is
// rounded to bf16 and the sums are f32.
//
// What bounds it on an H100: a step reads all of w_hh_t once (16.8 MB in
// f32 at H = 1024, 8.4 MB in bf16) for 8 H^2 B operations, so it is
// bound by bytes: 5.16 us (f32) and 2.66 us (bf16) from HBM at B = 16,
// less when a scan finds the weights still in the 50 MB L2.  Below that,
// a step is a chain: h comes from the step before, and the sums of all
// of K meet before a gate is applied.  What the design does about it:
//
// - Packed weights (experimental/cuda_lstm_cell.py::pack_weights, made
//   once per weight tensor and cached).  A cluster of KSPLIT = 2 blocks
//   owns UNITS = 8 hidden units (their 32 gate columns), each block one
//   half of the input dimension K, so a block reads half of h; the grid
//   is 2 H / 8 blocks (256 at H = 1024, two resident per SM).  f32: for
//   each group of 4 inputs, a unit's four gates are one float4 per
//   input.  bf16: 16-input k-steps in the B-fragment order of
//   mma.sync.m16n8k16 (columns 4 u + gate of two units per n8 tile, four
//   tiles), 32 bytes per lane per k-step.  Every copy a warp makes reads
//   contiguous 128-512 byte runs.
// - Weights in flight before h.  Each lane streams its own slice through
//   a ring of shared memory with cp.async (bf16: 4 k-steps of 32 bytes,
//   f32: 3 groups of 64 bytes per lane; 32 and 48 KB per block), started
//   first; h follows, a copy group per k-step (bf16: the lane's own A
//   fragment as f32 pairs, rounded when used; f32: the warp's 16 rows of
//   the group, shared by its lanes), and x_proj and c are loaded for the
//   epilogue before the products.  A lane reads back only the weight
//   slots it filled itself, so the ring needs no barrier, only
//   cp.async.wait_group.
// - Chained launches (programmatic dependent launch), a scan's steps
//   after the first only: a launch lets the next one start at once, and
//   waits for the previous one (griddepcontrol.wait) after starting its
//   weight copies and x_proj loads and before it reads h or c, so a
//   step's weights fly while the step before finishes.
// - bf16 on the tensor cores: B = 16 rows fill the 16 rows of the A
//   operand (fewer rows are zero), f32 accumulators; up to 64 rows
//   (four m16 tiles) use each weight fragment once; only further rows
//   take another pass over the weights (from the L2).
// - f32 stays exact FMA (no TF32): a lane holds one unit's four gates
//   for 16 rows, takes 4 inputs a step as a float4 of h from shared
//   memory (broadcast to the 8 lanes of a unit row) and four float4
//   weights.  Rows beyond 16 take further passes.
// - Sums in a fixed order, no atomics: within a warp by a
//   reduce-scatter of shuffles (f32) or inside the mma (bf16), across
//   the warps in shared memory in warp order, across the cluster's two
//   blocks through distributed shared memory (rank 0's half first), each
//   block finishing four of the eight units: a block writes the sums of
//   the peer's units into the peer's shared memory, so one cluster
//   barrier a pass suffices.  The same inputs give the same bits.
//
// Tried and dropped: the first design staged all of h (64 KB at
// B = 16) in every block before its first weight load, with scalar 4- or
// 2-byte weight loads and bf16 widened to f32 FMAs, 128 blocks of 256
// threads; it read 47 us cold in bf16.  Three bf16 blocks an SM (80
// registers, so that more of the next step's blocks are resident) was
// slower in a scan than two.  Clusters of four blocks over 16 units
// (each block reads a quarter of h) were slower in a scan, 8.0 against
// 5.8 us in bf16 and 10.8 against 7.6 in f32.  Two cluster barriers a
// pass (the peer's sums read remotely, then a barrier before exit) cost
// 0.6-0.8 us more a step than one.  An L2 access-policy window was not
// tried.
//
// The C entry point takes plain pointers and returns a cudaError_t code,
// so the library is loaded with ctypes and needs no PyTorch headers.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int UNITS = 8;            // hidden units per cluster
constexpr int KSPLIT = 2;           // blocks per cluster, one K share each
constexpr int COLS = 4 * UNITS;     // gate columns per cluster
constexpr int NT = 256;             // threads per block
constexpr int NW = NT / 32;         // warps per block
constexpr int ROWS = 16;            // batch rows of one m16 tile
constexpr int MT_MAX = 4;           // bf16: m16 tiles per pass
constexpr int RING_BF16 = 4;        // k-steps of 32 bytes per lane
constexpr int RING_F32 = 3;         // groups of 64 bytes per lane
constexpr int KQ = 32 / UNITS;      // f32: lanes of a warp along K

struct Params {
  const float* x_proj;   // (B, 4H)
  const float* h;        // (B, H)
  const float* c;        // (B, H)
  const void* w;         // packed w_hh_t
  float* h_out;          // (B, H)
  float* c_out;          // (B, H)
  int B, H;
};

// Byte offsets of the shared-memory regions of one block: the weight
// ring, one region per warp (its staged h, then its partial sums), the
// block's sum.
struct Layout {
  size_t ring, work, warp_bytes, part, total;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// bf16: k-steps of 16 inputs (K padded with zeros); f32: groups of 4.
__host__ __device__ __forceinline__ int k_chunks(int H, bool bf16) {
  return bf16 ? cdiv(H, 16) : H / 4;
}

// How many chunks a warp takes at most (one block holds a KSPLIT share).
__host__ __device__ __forceinline__ int warp_chunks(int H, bool bf16) {
  const int per_block = cdiv(k_chunks(H, bf16), KSPLIT);
  return bf16 ? cdiv(per_block, NW) : cdiv(per_block, NW * KQ);
}

__host__ __device__ __forceinline__ Layout layout(int H, int MT, bool bf16) {
  Layout L;
  const size_t n = warp_chunks(H, bf16);
  // staged h: bf16, the lane's four f32 pairs of its A fragment per
  // k-step and m16 tile; f32, 16 rows x KQ float4 per group row
  const size_t hs = bf16 ? n * MT * 32 * 32 : n * ROWS * KQ * 16;
  const size_t red = (size_t)ROWS * MT * COLS * 4;
  L.ring = 0;
  L.work = (size_t)NW * 32 * (bf16 ? RING_BF16 * 32 : RING_F32 * 64);
  L.warp_bytes = hs > red ? hs : red;
  L.part = L.work + NW * L.warp_bytes;
  L.total = L.part + red;
  return L;
}

__host__ __device__ __forceinline__ int bf16_tiles(int B) {
  return B > ROWS * (MT_MAX - 1) ? MT_MAX : cdiv(B, ROWS);
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// cp.async of 16 (L2 only) or 8 bytes; ``n`` bytes of ``src`` are read
// and the rest of the destination is zero (n = 0: zeros, nothing read).
__device__ __forceinline__ void cp_async16(void* dst_smem, const void* src,
                                           int n = 16) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst_smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst_smem, const void* src,
                                          int n) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst_smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(d), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// D = A (16 x 16 bf16, row) * B (16 x 8 bf16, col) + D, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Two f32 as a bf16 pair, rounded to nearest even (x in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  __nv_bfloat162 b = __float22bfloat162_rn(v);
  return *reinterpret_cast<uint32_t*>(&b);
}

// Programmatic dependent launch: let the next launch of the stream start
// (its blocks take the places ours leave), and wait until the previous
// launch has finished and its writes are visible.  Without the launch
// attribute both are no-ops.
__device__ __forceinline__ void allow_next_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_previous_launch() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// What the epilogue thread of a pass needs from device memory, loaded
// before the products so that its latency hides behind theirs: x_proj
// before the wait for the previous launch (no launch of a scan writes
// it), c after.
struct Epi {
  float x[4], c;
  int b, unit;
};

__device__ __forceinline__ Epi epi_load(const Params& p, int b0, int rows,
                                        int rank, int j) {
  constexpr int HALF = UNITS / KSPLIT;
  Epi e;
  const int row = threadIdx.x / HALF;
  e.b = row < rows ? b0 + row : p.B;
  e.unit = j * UNITS + rank * HALF + threadIdx.x % HALF;
  if (e.b < p.B) {
    const float* xp = p.x_proj + (size_t)e.b * 4 * p.H + e.unit;
#pragma unroll
    for (int g = 0; g < 4; ++g) e.x[g] = __ldg(xp + (size_t)g * p.H);
  }
  return e;
}

__device__ __forceinline__ void epi_state(const Params& p, Epi& e) {
  if (e.b < p.B) e.c = p.c[(size_t)e.b * p.H + e.unit];
}

// bf16 products of rows b0 .. b0 + 16 MT: this warp's k-steps into its
// partial sums (rows x COLS, column 4 u + gate).  Copy groups: the
// first RING_BF16 k-steps' weights, one group each, started before the
// wait for the previous launch; then h of those k-steps, one group each;
// then, as a k-step is used, the weights and h of the k-step RING_BF16
// later, one group.  So k-step i's weights and h have landed once at
// most RING_BF16 - 1 groups are pending.
template <int MT>
__device__ __forceinline__ void bf16_products(const Params& p, int b0,
                                              int rank, int j,
                                              unsigned char* smem,
                                              const Layout& L, Epi& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int KS = k_chunks(p.H, true), per = cdiv(KS, KSPLIT);
  const int s0 = rank * per + warp, s_end = min(rank * per + per, KS);
  const int n = s0 < s_end ? cdiv(s_end - s0, NW) : 0;
  unsigned char* own = smem + L.work + warp * L.warp_bytes;
  uint4* ring = reinterpret_cast<uint4*>(smem + L.ring)
                + (size_t)warp * RING_BF16 * 64;
  float2* hs = reinterpret_cast<float2*>(own);
  const uint4* wsrc = reinterpret_cast<const uint4*>(p.w)
                      + (size_t)j * KS * 64 + lane;
  const int g = lane >> 2, t = lane & 3;

  auto weights = [&](int i) {
    if (i < n) {
      const uint4* src = wsrc + (size_t)(s0 + NW * i) * 64;
      uint4* dst = ring + (i % RING_BF16) * 64 + lane;
      cp_async16(dst, src);
      cp_async16(dst + 32, src + 32);
    }
  };
  // h as this lane's A fragments, f32 pairs: rows g, g + 8, inputs 2t,
  // 2t + 8 of the k-step (rounded to bf16 when used)
  auto h_frags = [&](int i) {
    if (i < n) {
      const int k = 16 * (s0 + NW * i) + 2 * t;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int part = 0; part < 4; ++part) {
          const int r = b0 + ROWS * mt + g + 8 * (part & 1);
          const int kk = k + 8 * (part >> 1);
          const bool in = r < p.B && kk < p.H;
          cp_async8(hs + ((i * MT + mt) * 4 + part) * 32 + lane,
                    in ? p.h + (size_t)r * p.H + kk : p.h, in ? 8 : 0);
        }
    }
  };
#pragma unroll
  for (int i = 0; i < RING_BF16; ++i) {
    weights(i);
    cp_async_commit();
  }
  wait_previous_launch();
  epi_state(p, epi);
#pragma unroll
  for (int i = 0; i < RING_BF16; ++i) {
    h_frags(i);
    cp_async_commit();
  }

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int tt = 0; tt < 4; ++tt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][tt][e] = 0.0f;
  for (int i = 0; i < n; ++i) {
    cp_async_wait<RING_BF16 - 1>();
    const uint4* slot = ring + (i % RING_BF16) * 64 + lane;
    const uint4 wa = slot[0], wb = slot[32];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float2* f = hs + (i * MT + mt) * 4 * 32 + lane;
      const uint4 a = make_uint4(pack_bf16(f[0]), pack_bf16(f[32]),
                                 pack_bf16(f[64]), pack_bf16(f[96]));
      mma_bf16(acc[mt][0], a, wa.x, wa.y);
      mma_bf16(acc[mt][1], a, wa.z, wa.w);
      mma_bf16(acc[mt][2], a, wb.x, wb.y);
      mma_bf16(acc[mt][3], a, wb.z, wb.w);
    }
    weights(i + RING_BF16);
    h_frags(i + RING_BF16);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // accumulator (row g / g + 8, column 8 tt + 2t, + 1) = sum column; the
  // sums take the place of the warp's staged h, which every lane has read
  __syncwarp();
  float* red = reinterpret_cast<float*>(own);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      float* o = red + (ROWS * mt + g) * COLS + 8 * tt + 2 * t;
      *reinterpret_cast<float2*>(o) =
          make_float2(acc[mt][tt][0], acc[mt][tt][1]);
      *reinterpret_cast<float2*>(o + 8 * COLS) =
          make_float2(acc[mt][tt][2], acc[mt][tt][3]);
    }
}

// f32 products of rows b0 .. b0 + 16: lane (kq, u) takes groups of 4
// inputs q = q0 + kq + 32 i for unit u, all four gates.  Copy groups as
// for bf16, a group of 4 inputs for a k-step; h of a group is staged
// once for the warp (16 rows x KQ float4), shared by its lanes.
__device__ __forceinline__ void f32_products(const Params& p, int b0,
                                             int rank, int j,
                                             unsigned char* smem,
                                             const Layout& L, Epi& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kq = lane / UNITS, u = lane % UNITS;
  const int QG = k_chunks(p.H, false), per = cdiv(QG, KSPLIT);
  const int q0 = rank * per + warp * KQ, q_end = min(rank * per + per, QG);
  const int n = q0 < q_end ? cdiv(q_end - q0, NW * KQ) : 0;
  unsigned char* own = smem + L.work + warp * L.warp_bytes;
  float4* ring = reinterpret_cast<float4*>(smem + L.ring)
                 + (size_t)warp * RING_F32 * 4 * 32;
  float4* hs = reinterpret_cast<float4*>(own);
  const float4* wsrc = reinterpret_cast<const float4*>(p.w)
                       + (size_t)j * QG * 4 * UNITS + u;

  auto weights = [&](int i) {
    const int q = q0 + kq + NW * KQ * i;
    if (i < n && q < q_end) {
      float4* dst = ring + (i % RING_F32) * 4 * 32 + lane;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        cp_async16(dst + 32 * k, wsrc + ((size_t)q * 4 + k) * UNITS);
    }
  };
  auto h_rows = [&](int i) {
    if (i < n) {
#pragma unroll
      for (int e = 0; e < ROWS * KQ / 32; ++e) {
        const int idx = lane + 32 * e, row = idx / KQ, qq = idx % KQ;
        const int q = q0 + qq + NW * KQ * i, r = b0 + row;
        const bool in = r < p.B && q < q_end;
        cp_async16(hs + (i * ROWS + row) * KQ + qq,
                   in ? p.h + (size_t)r * p.H + 4 * q : p.h, in ? 16 : 0);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < RING_F32; ++i) {
    weights(i);
    cp_async_commit();
  }
  wait_previous_launch();
  epi_state(p, epi);
#pragma unroll
  for (int i = 0; i < RING_F32; ++i) {
    h_rows(i);
    cp_async_commit();
  }

  float acc[4 * ROWS];   // [gate][row]
#pragma unroll
  for (int e = 0; e < 4 * ROWS; ++e) acc[e] = 0.0f;
  for (int i = 0; i < n; ++i) {
    cp_async_wait<RING_F32 - 1>();
    __syncwarp();                  // the other lanes' copies of h
    const bool on = q0 + kq + NW * KQ * i < q_end;
    const float4* slot = ring + (i % RING_F32) * 4 * 32 + lane;
    float4 w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = on ? slot[32 * k] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int row = 0; row < ROWS; ++row) {
      const float4 x = hs[(i * ROWS + row) * KQ + kq];
      const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[0 * ROWS + row] = fmaf(w[k].x, xv[k], acc[0 * ROWS + row]);
        acc[1 * ROWS + row] = fmaf(w[k].y, xv[k], acc[1 * ROWS + row]);
        acc[2 * ROWS + row] = fmaf(w[k].z, xv[k], acc[2 * ROWS + row]);
        acc[3 * ROWS + row] = fmaf(w[k].w, xv[k], acc[3 * ROWS + row]);
      }
    }
    weights(i + RING_F32);
    h_rows(i + RING_F32);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // reduce-scatter over the KQ = 4 lanes of a unit (lane bits 4, 3):
  // afterwards lane (kq, u) holds gate kq of unit u for the 16 rows
  const bool hi4 = (lane >> 4) & 1, hi3 = (lane >> 3) & 1;
#pragma unroll
  for (int e = 0; e < 2 * ROWS; ++e) {
    const float lo = acc[e], up = acc[e + 2 * ROWS];
    const float mine = hi4 ? up : lo, send = hi4 ? lo : up;
    acc[e] = mine + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int e = 0; e < ROWS; ++e) {
    const float lo = acc[e], up = acc[e + ROWS];
    const float mine = hi3 ? up : lo, send = hi3 ? lo : up;
    acc[e] = mine + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  __syncwarp();          // every lane is done with the staged h
  const int gate = 2 * hi4 + hi3;
  float* red = reinterpret_cast<float*>(own);
#pragma unroll
  for (int row = 0; row < ROWS; ++row)
    red[row * COLS + 4 * u + gate] = acc[row];
}

// Split cluster barrier without memory ordering: a block says it is
// done reading what the peer wrote, and waits for the peer to say so.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The warps' partial sums, then the cluster's two halves of K, then the
// gates and the state of this block's UNITS / KSPLIT units.  Each block
// sums its warps and writes each unit's sums into the shared memory of
// the block that finishes the unit (part[source rank][row][unit][gate]),
// so after one cluster barrier every read is local and a block may
// leave; only a further pass over more rows waits until the peer has
// read this one's sums.
__device__ __forceinline__ void finish(const Params& p, int rows,
                                       int rank, bool first, bool more,
                                       const Epi& e, unsigned char* smem,
                                       const Layout& L,
                                       cg::cluster_group& cluster) {
  constexpr int HALF = UNITS / KSPLIT;
  const size_t stride = L.warp_bytes / 4;
  const float* red = reinterpret_cast<const float*>(smem + L.work);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* peer = cluster.map_shared_rank(part, rank ^ 1);
  __syncthreads();
  if (!first) cluster_wait();
  for (int idx = threadIdx.x; idx < rows * COLS; idx += NT) {
    float s = red[idx];
#pragma unroll
    for (int w = 1; w < NW; ++w) s += red[w * stride + idx];
    const int row = idx / COLS, u = (idx % COLS) / 4, gate = idx % 4;
    float* dst = u / HALF == rank ? part : peer;
    dst[((rank * rows + row) * HALF + u % HALF) * 4 + gate] = s;
  }
  cluster.sync();
  if (e.b < p.B) {
    const float4* sums = reinterpret_cast<const float4*>(part);
    const float4 s0 = sums[threadIdx.x];
    const float4 s1 = sums[rows * HALF + threadIdx.x];
    const float gi = e.x[0] + (s0.x + s1.x), gf = e.x[1] + (s0.y + s1.y);
    const float gg = e.x[2] + (s0.z + s1.z), go = e.x[3] + (s0.w + s1.w);
    const size_t o = (size_t)e.b * p.H + e.unit;
    const float cn = sigmoidf_(gf) * e.c + sigmoidf_(gi) * tanhf(gg);
    p.c_out[o] = cn;
    p.h_out[o] = sigmoidf_(go) * tanhf(cn);
  }
  if (more) cluster_arrive_relaxed();
}

template <int MT, bool BF16>
__global__ void __cluster_dims__(KSPLIT, 1, 1)
__launch_bounds__(NT, MT <= 2 ? 2 : 1)
lstm_cell_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int j = blockIdx.x / KSPLIT;
  const Layout L = layout(p.H, MT, BF16);
  constexpr int RP = ROWS * MT;
  allow_next_launch();
  for (int b0 = 0; b0 < p.B; b0 += RP) {
    Epi e = epi_load(p, b0, RP, rank, j);
    if constexpr (BF16)
      bf16_products<MT>(p, b0, rank, j, smem, L, e);
    else
      f32_products(p, b0, rank, j, smem, L, e);
    finish(p, RP, rank, b0 == 0, b0 + RP < p.B, e, smem, L, cluster);
  }
}

template <int MT, bool BF16>
int launch_t(const Params& p, bool chained, cudaStream_t stream) {
  const void* kernel = (const void*)lstm_cell_kernel<MT, BF16>;
  const size_t smem = layout(p.H, MT, BF16).total;
  static size_t allowed[16] = {};    // per device: the attribute set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 16 || smem > allowed[dev]) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 16) allowed[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.H / UNITS) * KSPLIT);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = chained ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, lstm_cell_kernel<MT, BF16>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lstm_cell_units(void) { return UNITS; }

int lstm_cell_ksplit(void) { return KSPLIT; }

// Dynamic shared memory of one block for a launch at (B, H).
size_t lstm_cell_smem_bytes(int B, int H, int bf16) {
  return layout(H, bf16 ? bf16_tiles(B) : 1, bf16 != 0).total;
}

const char* lstm_cell_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launch one LSTM step on ``stream``; returns a cudaError_t code (0 =
// launched).  ``ptrs``: x_proj, h, c, the packed w_hh_t, h_out, c_out
// (device pointers, 16-byte aligned; the outputs must not overlap the
// inputs); ``bf16`` != 0 for bf16 weights.  H must be a multiple of
// lstm_cell_units().  ``chained`` != 0 only where the stream's previous
// launch is this kernel's and wrote at most h and c of this one (a
// scan's next step): the launch then starts as that one ends
// (programmatic dependent launch), fetching its weights and x_proj
// before it waits for the previous launch's h and c.
int lstm_cell_launch(const void* const* ptrs, int B, int H, int bf16,
                     int chained, void* stream) {
  const Params p{(const float*)ptrs[0], (const float*)ptrs[1],
                 (const float*)ptrs[2], ptrs[3],
                 (float*)ptrs[4],       (float*)ptrs[5], B, H};
  cudaStream_t s = (cudaStream_t)stream;
  const bool ch = chained != 0;
  if (!bf16) return launch_t<1, false>(p, ch, s);
  switch (bf16_tiles(B)) {
    case 1: return launch_t<1, true>(p, ch, s);
    case 2: return launch_t<2, true>(p, ch, s);
    case 3: return launch_t<3, true>(p, ch, s);
    default: return launch_t<4, true>(p, ch, s);
  }
}

}  // extern "C"
