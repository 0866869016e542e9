// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces: the Pallas TPU kernel `_fa_kernel` of
// mlcomp_tpu/ops/flash_attention.py (kernel at :83, launched by
// `flash_attention_forward` at :250), with and without its lse output.
//
// Computes, for each (b, h): out = softmax(scale * Q K^T, causal mask) V
// over q, k, v of shape [B, T, H, D], read through their strides (no
// [B*H, T, D] fold), out written as a fresh contiguous [B, T, H, D]; and,
// when the lse pointer is not null (training), the per-row logsumexp of
// the scaled scores, lse = m + log(l) in natural-log units, as a
// contiguous [B, H, T] f32 (the backward rebuilds P from it).
// Numerics follow the TPU kernel: scores accumulate in f32, masked
// scores take the finite NEG_INF = -1e30, the softmax is online with a
// running max and sum in f32, P is rounded to V's dtype before the PV
// product, and the output is divided by max(l, 1e-30) and written in
// Q's dtype.
//
// Bound on the card (H100 SXM): 4*B*H*T^2*D FLOPs, halved when causal,
// against 989 TFLOP/s in bf16/fp16; bytes of Q, K, V and O against
// 3.35 TB/s. At the flagship's serving shape (B=4, T=8192, H=16, D=64,
// causal, bf16) that is 5.5e11 FLOPs against 2.7e8 bytes, about 2000
// FLOPs a byte against the card's 295: the tensor cores bound it. Every
// K/V tile is read again by each q-tile that needs it, from L2, which
// the bound does not count.
//
// What the design does about that bound: both products are warpgroup
// wgmma (the only way to the tensor cores' full rate on Hopper), and the
// [T, T] scores never leave registers. A block is four warpgroups: three
// consumers of 64 query rows each and one producer, whose one thread
// only issues TMA loads; setmaxnreg moves registers from the producer to
// the consumers. The block's 192 query rows of one (b, h) arrive once and
// stay resident; the K and V tiles (128 keys; 64 for D = 128) stream
// through a ring of four stages, each with a full and an empty mbarrier,
// so a consumer waits only for its own next tile. The tiles land by TMA
// in swizzled shared memory (128-byte swizzle for D = 64, two such column
// blocks a row for D = 128, 64-byte swizzle for D = 32), zero-filled past
// T, so any T works. S = Q K^T reads both operands K-major from shared
// memory; the causal and ragged-end mask runs as a pass of its own, only
// on the tiles that need it, and a consumer skips the products of the
// tiles dead for all its 64 rows. The online softmax runs in the
// accumulator registers (each thread holds two rows: four partial
// maxima and sums, then quad shuffles), one FFMA and one ex2 a score; P
// is rounded and repacked in registers as the A operand of O += P V,
// which reads V MN-major from the same tile through wgmma's transpose
// bit. Each consumer issues tile kt's S product and tile kt - 1's PV
// product back to back and runs tile kt's softmax while that PV product
// is still on the tensor cores (FA3's intra-warpgroup overlap); the
// consumers take turns issuing (named barriers), so one's softmax runs
// under the others' products. No product is in flight across the loop's
// back edge, and O and P are fenced into their registers before the
// products that read them: otherwise ptxas serializes the wgmmas (C7515)
// or injects waits (C7517). Blocks take their (b, h, q-tile) heavy-first
// within a head (the longest causal loops first), heads in order, so the
// blocks in flight share K/V tiles through L2.
//
// What holds it back (H100 80GB HBM3 at 700 W: chip_smoke.py and
// testing/kernel_variants.py, recorded in PERF.md): at the serving shape
// it runs at ~45% of the tensor-core peak, level with
// scaled_dot_product_attention. Its cost probes take about as long
// without either product (the loads and the softmax, which at D = 64
// needs as many ex2 a tile as the MUFU units take in the products' time)
// as without the ex2 (the loads and the products): neither unit is kept
// busy while the other works. ptxas reports no spill and no wgmma
// advisory for the 16-bit kernels.
//
// A plain SIMT path serves f32 inputs (f32 exports): 32-row Q tiles,
// 16-row K/V tiles and f32 FMAs outside the tensor cores.
//
// C interface (bound with ctypes): flash_attention_fwd(...) returns the
// cudaError_t of the launch as an int; 0 means launched. It takes a
// positive scale: the row max is found on unscaled scores, so the
// wrapper moves a negative scale's sign onto q. For bf16 and fp16 it
// encodes the TMA descriptors of q, k and v on the host, for each call
// (flash_tma.cuh); TMA needs each operand's base 16-byte aligned and its
// strides multiples of 16 bytes, and the wrapper copies an operand that
// is not.

#include "flash_tma.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, T] or null
  int B, T, H;
  int64_t q_sb, q_st, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_st, o_sh;
  float scale;
  int causal;
};

// ---------------------------------------------------------------- wgmma path
// The tensor maps of q, k and v, each over [B, T, H, D] as dims (D, H, T,
// B), innermost first (flash_tma.cuh); passed as a __grid_constant__
// kernel parameter, so TMA reads them from parameter space.
struct TmaParams {
  CUtensorMap q, k, v;
  void* o;
  float* lse;
  int B, T, H;
  int64_t o_sb, o_st, o_sh;
  float scale;
  int causal;
};

// consumer warpgroups of 64 query rows; a block owns ROWS rows and runs
// one more warpgroup, the producer. setmaxnreg: 128 x 40 + 256 x 232 or
// 128 x 24 + 384 x 160 registers fit the SM's 65,536
constexpr int CONSUMERS = 3;
constexpr int ROWS = CONSUMERS * 64;
constexpr int THREADS = (CONSUMERS + 1) * WG;
constexpr int PRODUCER_REGS = CONSUMERS == 2 ? 40 : 24;
constexpr int CONSUMER_REGS = CONSUMERS == 2 ? 232 : 160;
constexpr int STAGES = 4;  // ring of K/V tiles

// the consumers take turns issuing their products (named barriers
// TURN_BAR + wg), so one's softmax runs under the others' products
constexpr int TURN_BAR = 1;

__device__ __forceinline__ void wait_turn(int wg) {
  named_bar_sync(TURN_BAR + wg, 2 * WG);
}

__device__ __forceinline__ void pass_turn(int wg) {
  named_bar_arrive(TURN_BAR + wg, 2 * WG);
}

// keys of a streamed K/V tile: 64 at D = 128 keeps O (64 registers a
// thread), S and the packed P inside the consumers' registers
template <int D>
__host__ __device__ constexpr int fwd_block_n() { return D == 128 ? 64 : 128; }

template <int D>
__host__ __device__ constexpr int fwd_smem_bytes() {
  // Q resident, STAGES of K and V, the barriers, the alignment
  return Tile<D>::bytes(ROWS) +
         2 * STAGES * Tile<D>::bytes(fwd_block_n<D>()) +
         8 * (2 * STAGES + 1) + 1024;
}

// The block's tile number `tile` as (b, h, first query row): heads in
// order, each head's q-tiles from the last (the longest causal loop)
struct TileCoord {
  int b, h, q0;
};

__device__ __forceinline__ TileCoord tile_coord(int tile, int n_q_tiles,
                                                int H) {
  const int bh = tile / n_q_tiles;
  return {bh / H, bh % H, (n_q_tiles - 1 - tile % n_q_tiles) * ROWS};
}

// K/V tiles a block of ROWS query rows from q0 reads
template <int BLOCK_N>
__device__ __forceinline__ int block_k_tiles(int q0, int T, int causal) {
  const int kv_end = causal ? min(T, q0 + ROWS) : T;
  return (kv_end + BLOCK_N - 1) / BLOCK_N;
}

// S = Q K^T for the 64 query rows of Q from row0 and the N keys of the K
// tile, over D; both operands K-major from shared memory, one commit group
template <typename T, int D, int N>
__device__ __forceinline__ void score_product(float (&sc)[N / 2],
                                              const unsigned char* q,
                                              int row0,
                                              const unsigned char* k) {
  using Tl = Tile<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<T, N>::ss(sc, Tl::k_major(q, ROWS, row0, kk),
                    Tl::k_major(k, N, 0, kk), kk > 0);
  wgmma_commit();
  fence_regs(sc);
}

// The max (MAX) or sum of this thread's values of each of its two rows
// (accumulator e / 2) in a tile of N_TILES n8 column blocks, over four
// partial results: one chain would put 2 N_TILES dependent steps on every
// tile's critical path
template <int N_TILES, bool MAX>
__device__ __forceinline__ void row_reduce(const float (&sc)[N_TILES * 4],
                                           float (&out)[2]) {
  static_assert(N_TILES % 4 == 0, "four partial results");
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t[4];
#pragma unroll
    for (int n = 0; n < N_TILES; ++n) {
      const float a = sc[4 * n + 2 * i], b = sc[4 * n + 2 * i + 1];
      const float v = MAX ? fmaxf(a, b) : a + b;
      t[n % 4] = n < 4 ? v : (MAX ? fmaxf(t[n % 4], v) : t[n % 4] + v);
    }
    out[i] = MAX ? fmaxf(fmaxf(t[0], t[1]), fmaxf(t[2], t[3]))
                 : (t[0] + t[1]) + (t[2] + t[3]);
  }
}

// O += P V for the 64 rows' P (registers, 16 keys a step) and the
// BLOCK_N keys of the V tile, read MN-major (wgmma's transpose bit); O
// and P fenced first, so their math stays ahead of the product
template <typename T, int D, int BLOCK_N>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           uint32_t (&pa)[BLOCK_N / 16][4],
                                           const unsigned char* v) {
  using Tl = Tile<D>;
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BLOCK_N / 16; ++kk)
    Wgmma<T, D>::template rs<1>(o, pa[kk], Tl::mn_major(v, BLOCK_N, kk));
  wgmma_commit();
  fence_regs(o);
}

// O takes each row's new running max
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * n + e] *= corr[e / 2];
  }
}

// out for the ROWS query rows of one (b, h) that tile_coord gives the block
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    fa_fwd_wgmma_kernel(const __grid_constant__ TmaParams p) {
  using Tl = Tile<D>;
  constexpr int BLOCK_N = fwd_block_n<D>();
  constexpr int N_TILES = BLOCK_N / 8;  // n8 column blocks of S
  constexpr int RES = Tl::bytes(ROWS);
  constexpr int KV = Tl::bytes(BLOCK_N);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align_1024(smem_raw);
  unsigned char* Ks = Qs + RES;          // [STAGES]
  unsigned char* Vs = Ks + STAGES * KV;  // [STAGES]
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + STAGES * KV);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  const int n_q_tiles = (p.T + ROWS - 1) / ROWS;
  const TileCoord tc = tile_coord(blockIdx.x, n_q_tiles, p.H);
  const int n_k = block_k_tiles<BLOCK_N>(tc.q0, p.T, p.causal);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * WG);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == CONSUMERS) {
    // producer: one thread issues every copy
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * WG) {
      mbar_arrive_expect_tx(q_full, RES);
      Tl::load(Qs, &p.q, q_full, ROWS, tc.q0, tc.h, tc.b);
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % STAGES;
        // the stage's last tile released by every consumer
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * KV);
        Tl::load(Ks + s * KV, &p.k, &full[s], BLOCK_N, kt * BLOCK_N, tc.h,
                 tc.b);
        Tl::load(Vs + s * KV, &p.v, &full[s], BLOCK_N, kt * BLOCK_N, tc.h,
                 tc.b);
      }
    }
  } else {
    regs_inc<CONSUMER_REGS>();
    // The grid has one block a tile, so no block returns here; but the
    // consumers' code needs a branch after setmaxnreg: without one, ptxas
    // reports too few registers and serializes every wgmma (C7512;
    // testing/kernel_variants.py's fwd_no_branch_after_setmaxnreg)
    if (blockIdx.x >= n_q_tiles * p.B * p.H) return;
    const int tid = threadIdx.x % WG;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;   // accumulator row group
    const int tq = lane % 4;  // thread within the group
    const int row0 = wg * 64;  // the warpgroup's rows in the block
    // the turns go round the consumers: this one's, then the next one's
    // (the last one hands on only while warpgroup 0 has turns left: each
    // has n_k + 1)
    const int next = (wg + 1) % CONSUMERS;
    const float scale_log2 = p.scale * LOG2E;
    const int wrow0 = tc.q0 + row0 + warp * 16;  // the warp's first query
    // this thread's rows: g and g + 8 of the warp's 16
    const int rows[2] = {wrow0 + g, wrow0 + g + 8};
    // causal: the tiles live for some row of this warpgroup (the later
    // ones are dead for all 64; another warpgroup may need them)
    const int n_live =
        p.causal ? (min(p.T, tc.q0 + row0 + 64) + BLOCK_N - 1) / BLOCK_N
                 : n_k;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // per row, in log2 units of the scaled scores; l: this thread's
    // share of the row sum
    float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
    float sc[BLOCK_N / 2];
    uint32_t pa[BLOCK_N / 16][4];

    if (wg == CONSUMERS - 1) pass_turn(0);  // warpgroup 0 goes first
    mbar_wait(q_full, 0);
    // Tile kt issues its S product, then (O rescaled) the PV product of
    // tile kt - 1, and runs its softmax while that PV product is on the
    // tensor cores; no product is in flight across the loop's back edge.
    // Tile 0's PV product is of a zero P (over tile 0's V): one loop body
    // for every tile, which ptxas pipelines
    float corr[2] = {1.f, 1.f};
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kk][j] = 0u;
    for (int kt = 0; kt < n_live; ++kt) {
      const int k0 = kt * BLOCK_N;
      mbar_wait(&full[kt % STAGES], (kt / STAGES) & 1);
      wait_turn(wg);
      // O rescaled before the S product is issued: done after it, ptxas
      // injects a wait for S
      rescale(o, corr);
      fence_regs(o);
      score_product<T, D, BLOCK_N>(sc, Qs, row0, Ks + (kt % STAGES) * KV);
      pv_product<T, D, BLOCK_N>(o, pa,
                                Vs + ((kt > 0 ? kt - 1 : 0) % STAGES) * KV);
      pass_turn(next);
      // S of tile kt (the PV product may still run)
      wgmma_wait<1>();
      fence_regs(sc);

      // mask the causal diagonal and the ragged end of the sequence (on
      // the unscaled scores), a pass of its own on the tiles that need it
      if (k0 + BLOCK_N > p.T || (p.causal && k0 + BLOCK_N - 1 > wrow0)) {
#pragma unroll
        for (int n = 0; n < N_TILES; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kc = k0 + n * 8 + tq * 2 + (e & 1);
            if (kc >= p.T || (p.causal && kc > rows[e / 2]))
              sc[4 * n + e] = NEG_INF;
          }
        }
      }

      // online softmax in log2 units: the max is taken on the unscaled
      // scores (the scale is positive, so it keeps their order), then one
      // FFMA and one ex2 per score; masked scores come out 0
      float mx[2], rs[2];
      row_reduce<N_TILES, true>(sc, mx);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        mx[i] = fmaxf(m_r[i], mx[i] * scale_log2);
        corr[i] = fast_exp2(m_r[i] - mx[i]);
        m_r[i] = mx[i];
      }
#pragma unroll
      for (int n = 0; n < N_TILES; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * n + e] =
              fast_exp2(fmaf(sc[4 * n + e], scale_log2, -mx[e / 2]));
      }
      row_reduce<N_TILES, false>(sc, rs);
#pragma unroll
      for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + rs[i];

      // the PV product of tile kt - 1 is done: its stage is free, and so
      // are the A registers
      wgmma_wait<0>();
      fence_regs(o);
      if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
      // P rounded to V's dtype, repacked from the accumulator layout as
      // the register A operand (16 keys a step)
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = Mma<T>::pack(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
      }
      // packed here, not sunk past the next S product, where ptxas would
      // inject a wait for it
      fence_regs(pa);
    }
    // the last live tile's PV product
    wait_turn(wg);
    rescale(o, corr);
    pv_product<T, D, BLOCK_N>(o, pa, Vs + ((n_live - 1) % STAGES) * KV);
    if (wg < CONSUMERS - 1 || n_live < n_k) pass_turn(next);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[(n_live - 1) % STAGES]);
    // tiles dead for all of this warpgroup's rows: released as they come
    for (int kt = n_live; kt < n_k; ++kt) {
      mbar_wait(&full[kt % STAGES], (kt / STAGES) & 1);
      mbar_arrive(&empty[kt % STAGES]);
      wait_turn(wg);
      if (wg < CONSUMERS - 1 || kt + 1 < n_k) pass_turn(next);
    }

    // finalise: whole-row sums, divide, write in the input dtype
    float norm[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
      l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
      norm[i] = fmaxf(l_r[i], 1e-30f);
    }
    if (p.lse != nullptr && tq == 0) {
      // m is in log2 units of the scaled scores: lse = (m + log2 l) ln 2
      float* lg = p.lse + (static_cast<int64_t>(tc.b) * p.H + tc.h) * p.T;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (rows[i] < p.T)
          lg[rows[i]] = (m_r[i] + log2f(norm[i])) * LN2;
    }
    T* og = static_cast<T*>(p.o) + tc.b * p.o_sb + tc.h * p.o_sh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + tq * 2;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (rows[i] < p.T)
          *reinterpret_cast<uint32_t*>(og + rows[i] * p.o_st + col) =
              Mma<T>::pack(o[4 * n + 2 * i] / norm[i],
                           o[4 * n + 2 * i + 1] / norm[i]);
    }
  }
}

// ----------------------------------------------------------------- f32 path
constexpr int F32_BLOCK_M = 32;  // query rows per block
constexpr int F32_BLOCK_N = 16;  // key rows per tile (static smem < 48 KB)
constexpr int F32_THREADS = 128;

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    fa_fwd_f32_kernel(const Params p) {
  constexpr int LD = D + 1;  // odd stride: row-wise reads hit distinct banks
  constexpr int COLS = D / 4;
  __shared__ float Qs[F32_BLOCK_M][LD];
  __shared__ float Ks[F32_BLOCK_N][LD];
  __shared__ float Vs[F32_BLOCK_N][D];
  __shared__ float Ps[F32_BLOCK_M][F32_BLOCK_N + 1];

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = q_tile * F32_BLOCK_M;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  // thread owns query row r of the tile, keys qd + 4i, columns qd + 4i
  const int r = threadIdx.x / 4;
  const int qd = threadIdx.x % 4;
  const int row = q0 + r;

  for (int i = threadIdx.x; i < F32_BLOCK_M * D; i += F32_THREADS) {
    const int rr = i / D, c = i % D;
    const int t = q0 + rr;
    Qs[rr][c] = t < p.T ? qg[t * p.q_st + c] : 0.f;
  }

  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;
  float m = NEG_INF, l = 0.f;

  const int kv_end = p.causal ? min(p.T, q0 + F32_BLOCK_M) : p.T;
  for (int k0 = 0; k0 < kv_end; k0 += F32_BLOCK_N) {
    __syncthreads();
    for (int i = threadIdx.x; i < F32_BLOCK_N * D; i += F32_THREADS) {
      const int rr = i / D, c = i % D;
      const int t = k0 + rr;
      Ks[rr][c] = t < p.T ? kg[t * p.k_st + c] : 0.f;
      Vs[rr][c] = t < p.T ? vg[t * p.v_st + c] : 0.f;
    }
    __syncthreads();

    float s[F32_BLOCK_N / 4];
    float mx = m;
#pragma unroll
    for (int i = 0; i < F32_BLOCK_N / 4; ++i) {
      const int j = qd + 4 * i;
      float dot = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) dot = fmaf(Qs[r][c], Ks[j][c], dot);
      float x = dot * p.scale;
      const int kc = k0 + j;
      if (kc >= p.T || (p.causal && kc > row)) x = NEG_INF;
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = expf(m - mx);
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < F32_BLOCK_N / 4; ++i) {
      const float e = expf(s[i] - mx);
      Ps[r][qd + 4 * i] = e;
      rs += e;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l = l * corr + rs;
    m = mx;
    __syncwarp();  // the row's four threads share Ps[r]
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      float sum = 0.f;
#pragma unroll 8
      for (int j = 0; j < F32_BLOCK_N; ++j)
        sum = fmaf(Ps[r][j], Vs[j][qd + 4 * c], sum);
      acc[c] = acc[c] * corr + sum;
    }
    __syncwarp();
  }

  if (row < p.T) {
    const float norm = fmaxf(l, 1e-30f);
    if (p.lse != nullptr && qd == 0)
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.T + row] = m + logf(norm);
#pragma unroll
    for (int c = 0; c < COLS; ++c) og[row * p.o_st + qd + 4 * c] = acc[c] / norm;
  }
}

template <typename T, int D>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  TmaParams tp;
  cudaError_t err;
  if ((err = tensor_map<T, D>(&tp.q, p.q, p.B, p.T, p.H, p.q_sb, p.q_st,
                              p.q_sh, ROWS)) != cudaSuccess ||
      (err = tensor_map<T, D>(&tp.k, p.k, p.B, p.T, p.H, p.k_sb, p.k_st,
                              p.k_sh, fwd_block_n<D>())) != cudaSuccess ||
      (err = tensor_map<T, D>(&tp.v, p.v, p.B, p.T, p.H, p.v_sb, p.v_st,
                              p.v_sh, fwd_block_n<D>())) != cudaSuccess)
    return err;
  tp.o = p.o;
  tp.lse = p.lse;
  tp.B = p.B;
  tp.T = p.T;
  tp.H = p.H;
  tp.o_sb = p.o_sb;
  tp.o_st = p.o_st;
  tp.o_sh = p.o_sh;
  tp.scale = p.scale;
  tp.causal = p.causal;
  constexpr int smem = fwd_smem_bytes<D>();
  static std::atomic<unsigned long long> opted_in{0};
  err = opt_in_smem(fa_fwd_wgmma_kernel<T, D>, smem, opted_in);
  if (err != cudaSuccess) return err;
  const long long tiles =
      static_cast<long long>((p.T + ROWS - 1) / ROWS) * p.B * p.H;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles);
  fa_fwd_wgmma_kernel<T, D><<<grid, THREADS, smem, stream>>>(tp);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  dim3 grid((p.T + F32_BLOCK_M - 1) / F32_BLOCK_M, p.B * p.H);
  fa_fwd_f32_kernel<D><<<grid, F32_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_dtype(const Params& p, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_f32<D>(p, stream);
    case 1: return launch_wgmma<__nv_bfloat16, D>(p, stream);
    case 2: return launch_wgmma<__half, D>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Strides in elements;
// the head_dim stride must be 1 (and, for the 16-bit types, the bases
// 16-byte aligned and the other strides multiples of 8 elements: TMA's
// rule). lse: a contiguous [B, H, T] f32 output, or null for none.
// Returns the cudaError_t of the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int T, int H, int D, int dtype,
                        long long q_sb, long long q_st, long long q_sh,
                        long long k_sb, long long k_st, long long k_sh,
                        long long v_sb, long long v_st, long long v_sh,
                        long long o_sb, long long o_st, long long o_sh,
                        float scale, int causal, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, lse, B, T, H,
           q_sb, q_st, q_sh, k_sb, k_st, k_sh,
           v_sb, v_st, v_sh, o_sb, o_st, o_sh,
           scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = dispatch_dtype<32>(p, dtype, s); break;
    case 64: err = dispatch_dtype<64>(p, dtype, s); break;
    case 128: err = dispatch_dtype<128>(p, dtype, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
