// Flash-attention backward for Hopper (sm_90a), written by hand.
//
// Replaces: the Pallas TPU kernels `_fa_bwd_dq_kernel` (:309) and
// `_fa_bwd_dkv_kernel` (:336) of mlcomp_tpu/ops/flash_attention.py,
// launched by `flash_attention_backward` (:368; calls at :403 and :425),
// with their shared numerics `_recompute_p_ds` (:278).
//
// Computes, for each (b, h), from q, k, v, dO of shape [B, T, H, D] (read
// through their strides), the forward's row logsumexp lse [B, H, T] and
// delta = rowsum(dO * O) [B, H, T] (both f32, contiguous):
//   P  = exp(scale * Q K^T - lse)      (0 where the causal mask or the
//                                        ragged end hides a pair)
//   dS = P * (dO V^T - delta)
//   dQ = dS K * scale,  dK = dS^T Q * scale,  dV = P^T dO
// written as fresh contiguous [B, T, H, D] tensors in the input dtype.
// Numerics follow the TPU kernels: both score products accumulate in f32,
// P is rebuilt from the lse with one FFMA and one ex2, P and dS are
// rounded to the input dtype before the gradient products (f32
// accumulation), and the scale is applied after the dQ and dK products,
// once, to the f32 sums.
//
// Two kernels, as on the TPU, so that no two blocks write one output row
// and no atomics are needed (the gradients are deterministic, bit for
// bit from run to run):
// - dq: a block owns 128 query rows and loops over the 64-key K/V tiles
//   up to the last one the causal mask leaves live (`_last_live_k`, :147);
// - dkv: a block owns 128 keys and loops over the Q/dO tiles (64
//   queries; 32 for D = 128) from the first live one (`_first_live_q`,
//   :156) to the end.
//
// Bound on the card (H100 SXM): five products of 2*D FLOPs for every live
// (query, key) pair (S and dP in both kernels would be seven; the least
// work recomputes S once: S, dP, dQ, dK, dV), against 989 TFLOP/s in
// bf16/fp16; bytes of q, k, v, O, dO, lse, delta read and dq, dk, dv
// written, against 3.35 TB/s. At the flagship's training shape (B=1,
// T=8192, H=16, D=64, causal, bf16) that is 3.4e11 FLOPs against
// 1.3e8 bytes: the tensor cores bound it. This design recomputes S and
// dP in both kernels (7 products per pair instead of 5), the price of
// needing no atomics.
//
// What the design does about that bound: every product is a warpgroup
// wgmma (the only way to the tensor cores' full rate on Hopper), and the
// [T, T] P and dS tiles never leave registers. A block is three
// warpgroups: two consumers of 64 rows each and one producer, whose one
// thread (and, in dkv, one warp) only loads; setmaxnreg moves registers
// from the producer to the consumers. The tiles arrive by TMA into
// swizzled shared memory (128-byte swizzle for D = 64, two such column
// blocks a row for D = 128, 64-byte swizzle for D = 32), zero-filled past
// T, so any T works. The block's own rows (Q and dO for dq, K and V for
// dkv) stay resident; the streamed tiles pass through a ring of three
// stages, each with a full and an empty mbarrier, so a consumer waits
// only for its next tile, never for the other warpgroup. S = Q K^T and
// dP = dO V^T (dq), S^T = K Q^T and dP^T = V dO^T (dkv) read both
// operands from shared memory, K-major. P and dS are rebuilt in the
// accumulator registers, rounded to the input dtype and repacked as the
// register A operand of the gradient products: dQ += dS K, dV += P^T dO
// and dK += dS^T Q read their B operand (K, dO, Q) MN-major from the same
// tiles, with wgmma's transpose bit. In dkv the lse and delta rows of a Q
// tile come by cp.async into the same stage, on the same full barrier. A
// warpgroup skips the products of a tile that is causally dead for all
// its rows, applies the causal and ragged-end mask in a pass of its own
// only on the tiles that need it, and issues the next tile's S and dP
// products before it releases the current stage; blocks start
// heavy-first (the longest loops first).
//
// What holds it back (H100 80GB HBM3 at 700 W: chip_smoke.py and
// testing/kernel_variants.py, recorded in PERF.md): at the
// flagship shape dq runs at ~40% and dkv at ~35% of the tensor-core peak
// for their own products. ptxas reports no spills at D = 32 and 64, but
// serializes the dkv kernel's wgmmas (C7515 at D <= 64, C7512 with the
// gradient products waited on): its dK and dV accumulators, S^T, dP^T
// and the repacked P and dS do not leave the wgmma pipeline registers
// enough. The variants that avoid it (32-query tiles, the gradient
// products waited on) measured slower. At D = 128 both kernels spill a
// little (not on a main path).
//
// A plain SIMT path serves f32 inputs: the same two kernels with 32-row
// blocks, 8-row streamed tiles and f32 FMAs outside the tensor cores.
//
// C interface (bound with ctypes): flash_attention_bwd_dq(...) and
// flash_attention_bwd_dkv(...) each launch one kernel and return its
// cudaError_t as an int; 0 means launched. Like the forward they take a
// positive scale for the scores; `dq_scale` multiplies the dQ sums (the
// wrapper passes the caller's own scale there, which undoes its moving a
// negative scale's sign onto q). For bf16 and fp16 they encode the TMA
// descriptors of q, k, v and dO on the host, for each call, with the
// CUDA cuTensorMapEncodeTiled, fetched through the runtime
// (cudaGetDriverEntryPoint), so the library links the runtime only. TMA
// needs each operand's base 16-byte aligned and its strides multiples of
// 16 bytes; the wrapper copies an operand that is not.

#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, T]
  const float* delta;  // [B, H, T]
  void* dq;            // [B, T, H, D], contiguous
  void* dk;
  void* dv;
  int B, T, H;
  int64_t q_sb, q_st, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t do_sb, do_st, do_sh;
  float scale;
  float dq_scale;
  int causal;
};

// ---------------------------------------------------------------- wgmma path
// The tensor maps of q, k, v and dO, each over [B, T, H, D] as dims
// (D, H, T, B), innermost first; a box is one column block of `rows` rows
// of one (b, h). Passed as a __grid_constant__ kernel parameter, so TMA
// reads them from parameter space.
struct TmaParams {
  CUtensorMap q, k, v, dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, T, H;
  float scale;
  float dq_scale;
  int causal;
};

constexpr int STAGES = 3;        // ring of streamed tiles
constexpr int CONSUMERS = 2;     // consumer warpgroups, 64 rows each
constexpr int WG = 128;          // threads of a warpgroup
constexpr int OWN_ROWS = CONSUMERS * 64;   // rows a block owns
constexpr int TMA_THREADS = (CONSUMERS + 1) * WG;
// 128 x 40 + 256 x 232 registers fit the SM's 65,536
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int DQ_BLOCK_N = 64;   // keys of a streamed K/V tile (dq)

// queries of a streamed Q/dO tile (dkv): 32 for D = 128 keeps its dK and
// dV accumulators (2 x 64 registers a thread) and the S^T/dP^T tiles
// inside the consumers' registers
template <int D>
__host__ __device__ constexpr int dkv_block_m() { return D == 128 ? 32 : 64; }

// A tile of `rows` rows x D in shared memory, as TMA writes it: column
// blocks of CB elements (one swizzle row of ROW_BYTES), each `rows` rows
// x ROW_BYTES, swizzled in groups of 8 rows.
template <int D>
struct Tile {
  static constexpr int CB = D >= 64 ? 64 : 32;
  static constexpr int NCB = D / CB;
  static constexpr int ROW_BYTES = CB * 2;
  static constexpr uint32_t SWIZZLE = CB == 64 ? 1 : 2;  // 128B / 64B
  static constexpr uint32_t GROUP_BYTES = 8 * ROW_BYTES;
  __host__ __device__ static constexpr int bytes(int rows) {
    return rows * D * 2;
  }

  // the 64 rows from row0 (or the whole tile as B), columns 16 kk ..
  // 16 kk + 15, read K-major (the rows' D values contiguous)
  static __device__ __forceinline__ uint64_t k_major(const unsigned char* t,
                                                     int rows, int row0,
                                                     int kk) {
    const int col = kk * 16;
    return smem_desc(t + (col / CB) * rows * ROW_BYTES + row0 * ROW_BYTES +
                         (col % CB) * 2,
                     16, GROUP_BYTES, SWIZZLE);
  }

  // rows 16 kk .. 16 kk + 15 as the K of a B operand read MN-major (its N
  // = D contiguous): the leading offset steps column blocks, the stride
  // offset 8-row groups
  static __device__ __forceinline__ uint64_t mn_major(const unsigned char* t,
                                                      int rows, int kk) {
    return smem_desc(t + kk * 16 * ROW_BYTES, rows * ROW_BYTES, GROUP_BYTES,
                     SWIZZLE);
  }

  // TMA: rows t0 .. t0 + rows - 1 of head h, batch b into t
  static __device__ __forceinline__ void load(unsigned char* t,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int rows,
                                              int t0, int h, int b) {
#pragma unroll
    for (int c = 0; c < NCB; ++c)
      tma_load_4d(t + c * rows * ROW_BYTES, map, bar, c * CB, h, t0, b);
  }
};

template <int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  // Q and dO resident, STAGES of K and V, the barriers, the alignment
  return 2 * Tile<D>::bytes(OWN_ROWS) +
         2 * STAGES * Tile<D>::bytes(DQ_BLOCK_N) + 8 * (2 * STAGES + 1) +
         1024;
}

template <int D>
__host__ __device__ constexpr int dkv_smem_bytes() {
  // K and V resident, STAGES of Q, dO and their lse and delta rows
  return 2 * Tile<D>::bytes(OWN_ROWS) +
         2 * STAGES * Tile<D>::bytes(dkv_block_m<D>()) +
         2 * STAGES * dkv_block_m<D>() * 4 + 8 * (2 * STAGES + 1) + 1024;
}

// S = A B^T and dP = A2 B2^T for the 64 rows of A and A2 (resident
// OWN_ROWS-row tiles) from row0 and the N rows of the streamed tiles B and
// B2, over D; both operands K-major from shared memory, one commit group
template <typename T, int D, int N>
__device__ __forceinline__ void score_products(
    float (&sc)[N / 2], float (&dp)[N / 2], const unsigned char* a,
    const unsigned char* a2, int row0, const unsigned char* b,
    const unsigned char* b2) {
  using Tl = Tile<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<T, N>::ss(sc, Tl::k_major(a, OWN_ROWS, row0, kk),
                    Tl::k_major(b, N, 0, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<T, N>::ss(dp, Tl::k_major(a2, OWN_ROWS, row0, kk),
                    Tl::k_major(b2, N, 0, kk), kk > 0);
  wgmma_commit();
}

// dQ for 128 query rows of one (b, h)
template <typename T, int D>
__global__ void __launch_bounds__(TMA_THREADS, 1)
    fa_bwd_dq_wgmma_kernel(const __grid_constant__ TmaParams p) {
  using Tl = Tile<D>;
  constexpr int BLOCK_N = DQ_BLOCK_N;
  constexpr int N_TILES = BLOCK_N / 8;  // n8 column blocks of S
  constexpr int RES = Tl::bytes(OWN_ROWS);
  constexpr int KV = Tl::bytes(BLOCK_N);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align_1024(smem_raw);
  unsigned char* dOs = Qs + RES;
  unsigned char* Ks = dOs + RES;            // [STAGES]
  unsigned char* Vs = Ks + STAGES * KV;     // [STAGES]
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + STAGES * KV);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = empty + STAGES;

  // causal q-tiles late in the sequence carry the most k-tiles: start
  // them first so the short ones fill the tail of the grid
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = q_tile * OWN_ROWS;
  const int kv_end = p.causal ? min(p.T, q0 + OWN_ROWS) : p.T;
  const int n_k_tiles = (kv_end + BLOCK_N - 1) / BLOCK_N;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * WG);
    }
    mbar_init(resident, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == CONSUMERS) {
    // producer: one thread issues every copy
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * WG) {
      mbar_arrive_expect_tx(resident, 2 * RES);
      Tl::load(Qs, &p.q, resident, OWN_ROWS, q0, h, b);
      Tl::load(dOs, &p.dout, resident, OWN_ROWS, q0, h, b);
      for (int kt = 0; kt < n_k_tiles; ++kt) {
        const int s = kt % STAGES;
        // the stage's last tile released by both consumers
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * KV);
        Tl::load(Ks + s * KV, &p.k, &full[s], BLOCK_N, kt * BLOCK_N, h, b);
        Tl::load(Vs + s * KV, &p.v, &full[s], BLOCK_N, kt * BLOCK_N, h, b);
      }
    }
  } else {
    regs_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;   // accumulator row group
    const int tq = lane % 4;  // thread within the group
    const int row0 = wg * 64;                 // the warpgroup's rows
    const int wrow0 = q0 + row0 + warp * 16;  // the warp's first query
    const int last_row = q0 + row0 + 63;      // the warpgroup's last
    const int64_t row_stats = (static_cast<int64_t>(b) * p.H + h) * p.T;

    // this thread's rows (g and g + 8 of the warp's 16): their lse in
    // log2 units, and delta (rows past T read 0; they are never written)
    int rows[2];
    float lse_r[2], dl_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wrow0 + g + 8 * i;
      rows[i] = r;
      lse_r[i] = r < p.T ? p.lse[row_stats + r] * LOG2E : 0.f;
      dl_r[i] = r < p.T ? p.delta[row_stats + r] : 0.f;
    }
    const float scale_log2 = p.scale * LOG2E;

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    // tile kt + 1's S and dP products are issued before tile kt's stage
    // is released, so the tensor cores start on them at once
    float sc[BLOCK_N / 2], dp[BLOCK_N / 2];
    mbar_wait(resident, 0);
    mbar_wait(&full[0], 0);
    score_products<T, D, BLOCK_N>(sc, dp, Qs, dOs, row0, Ks, Vs);
    for (int kt = 0; kt < n_k_tiles; ++kt) {
      const int s = kt % STAGES;
      const int k0 = kt * BLOCK_N;
      wgmma_wait<0>();  // S and dP of tile kt
      fence_regs(sc);
      fence_regs(dp);
      fence_regs(dq);
      // tile kt - 1's stage is free: its dQ product read K there and is
      // done
      if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
      // causal: a warpgroup whose rows all precede this tile has nothing
      // live in it (the other may); its products were never issued
      if (!p.causal || k0 <= last_row) {
        // P = exp(scale * S - lse), one FFMA and one ex2 per score;
        // dS = P (dP - delta), into sc
#pragma unroll
        for (int n = 0; n < N_TILES; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e / 2;  // row g or g + 8
            const float pe =
                fast_exp2(fmaf(sc[4 * n + e], scale_log2, -lse_r[i]));
            sc[4 * n + e] = pe * (dp[4 * n + e] - dl_r[i]);
          }
        }
        // 0 on the causal triangle and past T (P = 0 there), a pass of
        // its own on the tiles that hold such pairs
        if ((k0 + BLOCK_N > p.T) || (p.causal && k0 + BLOCK_N - 1 > wrow0)) {
#pragma unroll
          for (int n = 0; n < N_TILES; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kc = k0 + n * 8 + tq * 2 + (e & 1);
              if (kc >= p.T || (p.causal && kc > rows[e / 2]))
                sc[4 * n + e] = 0.f;
            }
          }
        }

        // dQ += dS K: dS rounded to the input dtype, repacked from the
        // accumulator layout as the register A operand (16 keys a step);
        // K read MN-major from the same tile
        uint32_t a[BLOCK_N / 16][4];
#pragma unroll
        for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
          a[kk][0] = Mma<T>::pack(sc[8 * kk + 0], sc[8 * kk + 1]);
          a[kk][1] = Mma<T>::pack(sc[8 * kk + 2], sc[8 * kk + 3]);
          a[kk][2] = Mma<T>::pack(sc[8 * kk + 4], sc[8 * kk + 5]);
          a[kk][3] = Mma<T>::pack(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
        const unsigned char* Kc = Ks + s * KV;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
          Wgmma<T, D>::template rs<1>(dq, a[kk], Tl::mn_major(Kc, BLOCK_N, kk));
        }
        wgmma_commit();
        // overlapping it with the next tile's S and dP products makes
        // ptxas serialize every wgmma of the kernel (C7515): measured
        // slower
        wgmma_wait<0>();
      }
      if (kt + 1 < n_k_tiles) {
        const int s1 = (kt + 1) % STAGES;
        mbar_wait(&full[s1], ((kt + 1) / STAGES) & 1);
        if (!p.causal || k0 + BLOCK_N <= last_row)
          score_products<T, D, BLOCK_N>(sc, dp, Qs, dOs, row0, Ks + s1 * KV,
                                        Vs + s1 * KV);
      }
    }
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(&empty[(n_k_tiles - 1) % STAGES]);

    const int64_t o_st = static_cast<int64_t>(p.H) * D;
    T* dqg = static_cast<T*>(p.dq) + b * p.T * o_st + h * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + tq * 2;
      if (rows[0] < p.T)
        *reinterpret_cast<uint32_t*>(dqg + rows[0] * o_st + col) =
            Mma<T>::pack(dq[4 * n] * p.dq_scale, dq[4 * n + 1] * p.dq_scale);
      if (rows[1] < p.T)
        *reinterpret_cast<uint32_t*>(dqg + rows[1] * o_st + col) =
            Mma<T>::pack(dq[4 * n + 2] * p.dq_scale,
                         dq[4 * n + 3] * p.dq_scale);
    }
  }
}

// dK and dV for 128 keys of one (b, h)
template <typename T, int D>
__global__ void __launch_bounds__(TMA_THREADS, 1)
    fa_bwd_dkv_wgmma_kernel(const __grid_constant__ TmaParams p) {
  using Tl = Tile<D>;
  constexpr int BLOCK_M = dkv_block_m<D>();  // queries of a streamed tile
  constexpr int N_TILES = BLOCK_M / 8;       // n8 column blocks of S^T
  constexpr int RES = Tl::bytes(OWN_ROWS);
  constexpr int QT = Tl::bytes(BLOCK_M);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align_1024(smem_raw);
  unsigned char* Vs = Ks + RES;
  unsigned char* Qs = Vs + RES;              // [STAGES]
  unsigned char* dOs = Qs + STAGES * QT;     // [STAGES]
  float* lse_s = reinterpret_cast<float*>(dOs + STAGES * QT);  // [STAGES][BLOCK_M]
  float* dl_s = lse_s + STAGES * BLOCK_M;                      // [STAGES][BLOCK_M]
  uint64_t* full = reinterpret_cast<uint64_t*>(dl_s + STAGES * BLOCK_M);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = empty + STAGES;

  // causal: early key tiles meet the most q-tiles; they come first
  const int k_tile = blockIdx.x;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int k0 = k_tile * OWN_ROWS;
  const int64_t row_stats = (static_cast<int64_t>(b) * p.H + h) * p.T;
  // the q-tile holding the block's first key: no earlier query sees any
  // of its keys
  const int first_qt = p.causal ? k0 / BLOCK_M : 0;
  const int n_q_tiles = (p.T + BLOCK_M - 1) / BLOCK_M;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      // the producer's TMA arrival and its warp's 32 cp.async arrivals
      mbar_init(&full[s], 1 + 32);
      mbar_init(&empty[s], CONSUMERS * WG);
    }
    mbar_init(resident, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == CONSUMERS) {
    // producer: one warp; its lane 0 issues the TMA copies, every lane
    // copies lse and delta rows
    regs_dec<PRODUCER_REGS>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < CONSUMERS * WG + 32) {
      if (lane == 0) {
        mbar_arrive_expect_tx(resident, 2 * RES);
        Tl::load(Ks, &p.k, resident, OWN_ROWS, k0, h, b);
        Tl::load(Vs, &p.v, resident, OWN_ROWS, k0, h, b);
      }
      const float* lse_g = p.lse + row_stats;
      const float* dl_g = p.delta + row_stats;
      for (int qt = first_qt; qt < n_q_tiles; ++qt) {
        const int i = qt - first_qt;
        const int s = i % STAGES;
        const int qs = qt * BLOCK_M;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * QT);
          Tl::load(Qs + s * QT, &p.q, &full[s], BLOCK_M, qs, h, b);
          Tl::load(dOs + s * QT, &p.dout, &full[s], BLOCK_M, qs, h, b);
        }
        for (int j = lane; j < BLOCK_M; j += 32) {
          const int t = qs + j;
          const bool valid = t < p.T;  // zero-filled past T
          cp_async4(lse_s + s * BLOCK_M + j, valid ? lse_g + t : lse_g, valid);
          cp_async4(dl_s + s * BLOCK_M + j, valid ? dl_g + t : dl_g, valid);
        }
        mbar_arrive_cp_async(&full[s]);
      }
    }
  } else {
    regs_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int tq = lane % 4;
    const int row0 = wg * 64;                // the warpgroup's keys
    const int wk0 = k0 + row0 + warp * 16;   // the warp's first key
    const int keys[2] = {wk0 + g, wk0 + g + 8};  // this thread's keys
    const float scale_log2 = p.scale * LOG2E;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    // causal: a warpgroup whose keys all follow a tile's queries has
    // nothing live in it (the other may); its products are not issued.
    // Tile i + 1's S^T and dP^T products are issued right behind tile i's
    // dV and dK products, so the tensor cores drain once a tile
    float sc[BLOCK_M / 2], dp[BLOCK_M / 2];
    mbar_wait(resident, 0);
    mbar_wait(&full[0], 0);
    if (!p.causal || k0 + row0 <= first_qt * BLOCK_M + BLOCK_M - 1)
      score_products<T, D, BLOCK_M>(sc, dp, Ks, Vs, row0, Qs, dOs);
    for (int qt = first_qt; qt < n_q_tiles; ++qt) {
      const int i = qt - first_qt;
      const int s = i % STAGES;
      const int qs = qt * BLOCK_M;
      wgmma_wait<0>();  // S^T and dP^T of tile i, dV and dK of tile i - 1
      fence_regs(sc);
      fence_regs(dp);
      fence_regs(dk);
      fence_regs(dv);
      // tile i - 1's stage is free: its dV and dK products read dO and Q
      if (i > 0) mbar_arrive(&empty[(i - 1) % STAGES]);
      if (!p.causal || k0 + row0 <= qs + BLOCK_M - 1) {
        const float* lse_c = lse_s + s * BLOCK_M;
        const float* dl_c = dl_s + s * BLOCK_M;
        // P^T into sc, dS^T into dp: rows are this warpgroup's keys,
        // columns the tile's queries
#pragma unroll
        for (int n = 0; n < N_TILES; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = n * 8 + tq * 2 + (e & 1);
            const float pe = fast_exp2(
                fmaf(sc[4 * n + e], scale_log2, -lse_c[qi] * LOG2E));
            sc[4 * n + e] = pe;
            dp[4 * n + e] = pe * (dp[4 * n + e] - dl_c[qi]);
          }
        }
        // 0 where the query precedes the key (causal) or lies past T, a
        // pass of its own on the tiles that hold such pairs
        if ((qs + BLOCK_M > p.T) || (p.causal && wk0 + 15 > qs)) {
#pragma unroll
          for (int n = 0; n < N_TILES; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qc = qs + n * 8 + tq * 2 + (e & 1);
              const int key = keys[e / 2];
              if (qc >= p.T || (p.causal && key > qc))
                sc[4 * n + e] = dp[4 * n + e] = 0.f;
            }
          }
        }

        // dV += P^T dO and dK += dS^T Q: P and dS rounded to the input
        // dtype, repacked as register A operands (16 queries a step); dO
        // and Q read MN-major from the same stage. Issuing dV alone first,
        // to run while dS is computed, measured slower
        uint32_t pa[BLOCK_M / 16][4], sa[BLOCK_M / 16][4];
#pragma unroll
        for (int kk = 0; kk < BLOCK_M / 16; ++kk) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            pa[kk][j] = Mma<T>::pack(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
            sa[kk][j] = Mma<T>::pack(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);
          }
        }
        const unsigned char* Qc = Qs + s * QT;
        const unsigned char* dOc = dOs + s * QT;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BLOCK_M / 16; ++kk) {
          Wgmma<T, D>::template rs<1>(dv, pa[kk], Tl::mn_major(dOc, BLOCK_M, kk));
          Wgmma<T, D>::template rs<1>(dk, sa[kk], Tl::mn_major(Qc, BLOCK_M, kk));
        }
        wgmma_commit();
      }
      if (qt + 1 < n_q_tiles) {
        const int s1 = (i + 1) % STAGES;
        mbar_wait(&full[s1], ((i + 1) / STAGES) & 1);
        if (!p.causal || k0 + row0 <= qs + 2 * BLOCK_M - 1)
          score_products<T, D, BLOCK_M>(sc, dp, Ks, Vs, row0, Qs + s1 * QT,
                                        dOs + s1 * QT);
      }
    }
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    mbar_arrive(&empty[(n_q_tiles - 1 - first_qt) % STAGES]);

    const int64_t o_st = static_cast<int64_t>(p.H) * D;
    T* dkg = static_cast<T*>(p.dk) + b * p.T * o_st + h * D;
    T* dvg = static_cast<T*>(p.dv) + b * p.T * o_st + h * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + tq * 2;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (keys[i] < p.T) {
          *reinterpret_cast<uint32_t*>(dkg + keys[i] * o_st + col) =
              Mma<T>::pack(dk[4 * n + 2 * i] * p.scale,
                           dk[4 * n + 2 * i + 1] * p.scale);
          *reinterpret_cast<uint32_t*>(dvg + keys[i] * o_st + col) =
              Mma<T>::pack(dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
        }
      }
    }
  }
}

// ----------------------------------------------------------------- f32 path
constexpr int F32_ROWS = 32;  // rows a block owns
constexpr int F32_COLS = 8;   // rows of a streamed tile (static smem < 48 KB)
constexpr int F32_THREADS = 128;

// thread layout: row r = threadIdx.x / 4 of the block's rows, and the
// streamed rows qd and qd + 4 (qd = threadIdx.x % 4) of each tile; the
// gradient columns qd + 4c
template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    fa_bwd_dq_f32_kernel(const Params p) {
  constexpr int LD = D + 1;  // odd stride: row-wise reads hit distinct banks
  constexpr int COLS = D / 4;
  __shared__ float Qs[F32_ROWS][LD];
  __shared__ float dOs[F32_ROWS][LD];
  __shared__ float Ks[F32_COLS][LD];
  __shared__ float Vs[F32_COLS][LD];
  __shared__ float dSs[F32_ROWS][F32_COLS + 1];

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = q_tile * F32_ROWS;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int64_t row_stats = (static_cast<int64_t>(b) * p.H + h) * p.T;
  const int64_t o_st = static_cast<int64_t>(p.H) * D;
  float* dqg = static_cast<float*>(p.dq) + b * p.T * o_st + h * D;

  const int r = threadIdx.x / 4;
  const int qd = threadIdx.x % 4;
  const int row = q0 + r;

  for (int i = threadIdx.x; i < F32_ROWS * D; i += F32_THREADS) {
    const int rr = i / D, c = i % D;
    const int t = q0 + rr;
    Qs[rr][c] = t < p.T ? qg[t * p.q_st + c] : 0.f;
    dOs[rr][c] = t < p.T ? dog[t * p.do_st + c] : 0.f;
  }
  const float lse_r = row < p.T ? p.lse[row_stats + row] : 0.f;
  const float dl_r = row < p.T ? p.delta[row_stats + row] : 0.f;

  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;

  const int kv_end = p.causal ? min(p.T, q0 + F32_ROWS) : p.T;
  for (int k0 = 0; k0 < kv_end; k0 += F32_COLS) {
    __syncthreads();
    for (int i = threadIdx.x; i < F32_COLS * D; i += F32_THREADS) {
      const int rr = i / D, c = i % D;
      const int t = k0 + rr;
      Ks[rr][c] = t < p.T ? kg[t * p.k_st + c] : 0.f;
      Vs[rr][c] = t < p.T ? vg[t * p.v_st + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < F32_COLS / 4; ++i) {
      const int j = qd + 4 * i;
      float dot = 0.f, dpv = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        dot = fmaf(Qs[r][c], Ks[j][c], dot);
        dpv = fmaf(dOs[r][c], Vs[j][c], dpv);
      }
      const int kc = k0 + j;
      const float pe = (kc >= p.T || (p.causal && kc > row))
                           ? 0.f : expf(dot * p.scale - lse_r);
      dSs[r][j] = pe * (dpv - dl_r);
    }
    __syncwarp();  // the row's four threads share dSs[r]
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < F32_COLS; ++j)
        sum = fmaf(dSs[r][j], Ks[j][qd + 4 * c], sum);
      acc[c] += sum;
    }
    __syncwarp();
  }

  if (row < p.T) {
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      dqg[row * o_st + qd + 4 * c] = acc[c] * p.dq_scale;
  }
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    fa_bwd_dkv_f32_kernel(const Params p) {
  constexpr int LD = D + 1;
  constexpr int COLS = D / 4;
  __shared__ float Ks[F32_ROWS][LD];
  __shared__ float Vs[F32_ROWS][LD];
  __shared__ float Qs[F32_COLS][LD];
  __shared__ float dOs[F32_COLS][LD];
  __shared__ float Ps[F32_ROWS][F32_COLS + 1];
  __shared__ float dSs[F32_ROWS][F32_COLS + 1];
  __shared__ float lse_s[F32_COLS];
  __shared__ float dl_s[F32_COLS];

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int k0 = blockIdx.x * F32_ROWS;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int64_t row_stats = (static_cast<int64_t>(b) * p.H + h) * p.T;
  const int64_t o_st = static_cast<int64_t>(p.H) * D;
  float* dkg = static_cast<float*>(p.dk) + b * p.T * o_st + h * D;
  float* dvg = static_cast<float*>(p.dv) + b * p.T * o_st + h * D;

  const int r = threadIdx.x / 4;
  const int qd = threadIdx.x % 4;
  const int key = k0 + r;

  for (int i = threadIdx.x; i < F32_ROWS * D; i += F32_THREADS) {
    const int rr = i / D, c = i % D;
    const int t = k0 + rr;
    Ks[rr][c] = t < p.T ? kg[t * p.k_st + c] : 0.f;
    Vs[rr][c] = t < p.T ? vg[t * p.v_st + c] : 0.f;
  }

  float acc_k[COLS], acc_v[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc_k[c] = acc_v[c] = 0.f;

  // causal: queries before the block's first key see none of its keys
  for (int q0 = p.causal ? k0 : 0; q0 < p.T; q0 += F32_COLS) {
    __syncthreads();
    for (int i = threadIdx.x; i < F32_COLS * D; i += F32_THREADS) {
      const int rr = i / D, c = i % D;
      const int t = q0 + rr;
      Qs[rr][c] = t < p.T ? qg[t * p.q_st + c] : 0.f;
      dOs[rr][c] = t < p.T ? dog[t * p.do_st + c] : 0.f;
    }
    if (threadIdx.x < F32_COLS) {
      const int t = q0 + threadIdx.x;
      lse_s[threadIdx.x] = t < p.T ? p.lse[row_stats + t] : 0.f;
      dl_s[threadIdx.x] = t < p.T ? p.delta[row_stats + t] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < F32_COLS / 4; ++i) {
      const int j = qd + 4 * i;
      float dot = 0.f, dpv = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        dot = fmaf(Ks[r][c], Qs[j][c], dot);
        dpv = fmaf(Vs[r][c], dOs[j][c], dpv);
      }
      const int qc = q0 + j;
      const float pe = (qc >= p.T || (p.causal && key > qc))
                           ? 0.f : expf(dot * p.scale - lse_s[j]);
      Ps[r][j] = pe;
      dSs[r][j] = pe * (dpv - dl_s[j]);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      float sk = 0.f, sv = 0.f;
#pragma unroll
      for (int j = 0; j < F32_COLS; ++j) {
        sv = fmaf(Ps[r][j], dOs[j][qd + 4 * c], sv);
        sk = fmaf(dSs[r][j], Qs[j][qd + 4 * c], sk);
      }
      acc_v[c] += sv;
      acc_k[c] += sk;
    }
    __syncwarp();
  }

  if (key < p.T) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      dkg[key * o_st + qd + 4 * c] = acc_k[c] * p.scale;
      dvg[key * o_st + qd + 4 * c] = acc_v[c];
    }
  }
}


// ------------------------------------------------------------------ launch
// cuTensorMapEncodeTiled, fetched once through the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled* fn) {
  static std::atomic<EncodeTiled> cached{nullptr};
  EncodeTiled f = cached.load(std::memory_order_acquire);
  if (f == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr)
      return cudaErrorNotSupported;
    f = reinterpret_cast<EncodeTiled>(ptr);
    cached.store(f, std::memory_order_release);
  }
  *fn = f;
  return cudaSuccess;
}

// The tensor map of one [B, T, H, D] operand (strides in elements) for
// boxes of `rows` rows of one column block: dims (D, H, T, B), the
// column blocks swizzled as Tile<D> reads them; out-of-bounds rows read 0.
template <typename T, int D>
cudaError_t tensor_map(CUtensorMap* map, const void* base, int B, int T_len,
                       int H, int64_t sb, int64_t st, int64_t sh, int rows) {
  EncodeTiled encode;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  using Tl = Tile<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T_len),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * sizeof(T),
                                 static_cast<cuuint64_t>(st) * sizeof(T),
                                 static_cast<cuuint64_t>(sb) * sizeof(T)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Tl::CB), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      Tl::CB == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int D, bool DQ>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  TmaParams tp;
  // dq streams K/V tiles past resident Q/dO rows, dkv the other way
  const int q_rows = DQ ? OWN_ROWS : dkv_block_m<D>();
  const int kv_rows = DQ ? DQ_BLOCK_N : OWN_ROWS;
  cudaError_t err;
  if ((err = tensor_map<T, D>(&tp.q, p.q, p.B, p.T, p.H, p.q_sb, p.q_st,
                              p.q_sh, q_rows)) != cudaSuccess ||
      (err = tensor_map<T, D>(&tp.dout, p.dout, p.B, p.T, p.H, p.do_sb,
                              p.do_st, p.do_sh, q_rows)) != cudaSuccess ||
      (err = tensor_map<T, D>(&tp.k, p.k, p.B, p.T, p.H, p.k_sb, p.k_st,
                              p.k_sh, kv_rows)) != cudaSuccess ||
      (err = tensor_map<T, D>(&tp.v, p.v, p.B, p.T, p.H, p.v_sb, p.v_st,
                              p.v_sh, kv_rows)) != cudaSuccess)
    return err;
  tp.lse = p.lse;
  tp.delta = p.delta;
  tp.dq = p.dq;
  tp.dk = p.dk;
  tp.dv = p.dv;
  tp.B = p.B;
  tp.T = p.T;
  tp.H = p.H;
  tp.scale = p.scale;
  tp.dq_scale = p.dq_scale;
  tp.causal = p.causal;
  constexpr int smem = DQ ? dq_smem_bytes<D>() : dkv_smem_bytes<D>();
  static std::atomic<unsigned long long> opted_in{0};
  err = DQ ? opt_in_smem(fa_bwd_dq_wgmma_kernel<T, D>, smem, opted_in)
           : opt_in_smem(fa_bwd_dkv_wgmma_kernel<T, D>, smem, opted_in);
  if (err != cudaSuccess) return err;
  dim3 grid((p.T + OWN_ROWS - 1) / OWN_ROWS, p.B * p.H);
  if (DQ)
    fa_bwd_dq_wgmma_kernel<T, D><<<grid, TMA_THREADS, smem, stream>>>(tp);
  else
    fa_bwd_dkv_wgmma_kernel<T, D><<<grid, TMA_THREADS, smem, stream>>>(tp);
  return cudaGetLastError();
}

template <int D, bool DQ>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  dim3 grid((p.T + F32_ROWS - 1) / F32_ROWS, p.B * p.H);
  if (DQ)
    fa_bwd_dq_f32_kernel<D><<<grid, F32_THREADS, 0, stream>>>(p);
  else
    fa_bwd_dkv_f32_kernel<D><<<grid, F32_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool DQ>
cudaError_t dispatch_dtype(const Params& p, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_f32<D, DQ>(p, stream);
    case 1: return launch_wgmma<__nv_bfloat16, D, DQ>(p, stream);
    case 2: return launch_wgmma<__half, D, DQ>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DQ>
int launch(const Params& p, int D, int dtype, void* stream) {
  if (p.B <= 0 || p.T <= 0 || p.H <= 0 || p.B * p.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = dispatch_dtype<32, DQ>(p, dtype, s); break;
    case 64: err = dispatch_dtype<64, DQ>(p, dtype, s); break;
    case 128: err = dispatch_dtype<128, DQ>(p, dtype, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Strides in elements;
// the head_dim stride must be 1 (and, for the 16-bit types, the base
// 16-byte aligned and the other strides multiples of 8 elements: TMA's
// rule). lse and delta: contiguous [B, H, T] f32.
// dq (dk, dv): contiguous [B, T, H, D] outputs in the input dtype.
// Returns the cudaError_t of the launch.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dq,
                           int B, int T, int H, int D, int dtype,
                           long long q_sb, long long q_st, long long q_sh,
                           long long k_sb, long long k_st, long long k_sh,
                           long long v_sb, long long v_st, long long v_sh,
                           long long do_sb, long long do_st, long long do_sh,
                           float scale, float dq_scale, int causal,
                           void* stream) {
  Params p{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, T, H,
           q_sb, q_st, q_sh, k_sb, k_st, k_sh,
           v_sb, v_st, v_sh, do_sb, do_st, do_sh,
           scale, dq_scale, causal};
  return launch<true>(p, D, dtype, stream);
}

int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv,
                            int B, int T, int H, int D, int dtype,
                            long long q_sb, long long q_st, long long q_sh,
                            long long k_sb, long long k_st, long long k_sh,
                            long long v_sb, long long v_st, long long v_sh,
                            long long do_sb, long long do_st, long long do_sh,
                            float scale, int causal, void* stream) {
  Params p{q, k, v, dout, lse, delta, nullptr, dk, dv, B, T, H,
           q_sb, q_st, q_sh, k_sb, k_st, k_sh,
           v_sb, v_st, v_sh, do_sb, do_st, do_sh,
           scale, scale, causal};
  return launch<false>(p, D, dtype, stream);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
