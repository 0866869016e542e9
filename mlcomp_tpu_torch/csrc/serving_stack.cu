// The fused multi-layer serving stack for Hopper (sm_90a), written by
// hand: all L layers in one launch.
//
// Replaces: the Pallas TPU kernel `_stack_kernel` of
// mlcomp_tpu/ops/serving_stack.py (kernel at :67, launched by
// `serving_stack` at :110).
//
// Computes the chain y_l = x_l @ dequant(W_l)^T * s_l for l = 0..L-1 over
// stacked weights W [L, N, K] (int8 or bf16, N == K) and scales s [L, N]
// (or none), with x_0 the bf16 input [M, K] and, between layers, the
// feed x_{l+1} = bf16(y_l / (max|y_l| + FEED_EPS)) — the max over the
// layer's whole [M, N] — or bf16(y_l) without the feed. Writes the last
// layer's f32 y (before any feed) to out [M, N]. Products accumulate in
// f32 on the tensor cores; the feed rounds as the plain version does (an
// IEEE f32 division, then round to nearest even).
//
// Bound on the card (H100 SXM): the weight bytes, L*N*K, at 3.35 TB/s —
// 0.160 ms for 8 int8 layers of 8192^2 (0.320 ms in bf16) at M = 64,
// where the products are 8x fewer seconds on the tensor cores.
//
// What the design does about that bound: the TPU runs one sequential
// program with the activation resident in VMEM. Here one persistent
// cooperative launch of thread-block clusters keeps every SM the
// occupancy allows streaming weights (15 clusters of 8 CTAs, 120 of the
// H100's 132 SMs: an 8-CTA cluster lives in one GPC), each layer's
// product on the tile of int8_gemm.cuh: warpgroup wgmma with the weight
// rows as the A operand (int8 converted in registers, bf16 from shared
// memory), the weight tiles (128 rows of 128 bytes) streamed by TMA
// through a 64 KB ring of full/empty mbarrier stages. A CTA is three
// warpgroups: two consumers of 64 channels, and one whose first warp's
// thread issues the TMA loads and whose other three warps are reducers.
// A cluster splits K: CTA rank r owns the columns [r K/8, (r+1) K/8) and
// keeps that slice of the 64 tokens' x resident in shared memory (128 KB
// at K = 8192), loaded by TMA once per layer (no block reads the whole
// activation from L2 per layer, as the first version's did). The
// clusters take the layer's 128-channel chunks in turn; for each chunk
// every CTA streams only its [128, K/8] slab of weight, and the eight
// partial [64, 128] sums meet through distributed shared memory: each
// CTA's consumers write their partial to its shared memory and go on
// with the next chunk, while the reducers of rank r add the eight
// partials of channels [16 r, 16 r + 16) in rank order, scale them and
// write y (mbarriers every CTA of the cluster arrives on remotely:
// "ready" when a partial is written, "freed" when it has been read).
// Deterministic: no float atomics. At a layer's end:
//   1. the block's max|y| (the reducers') to its slot (two sets, by the
//      layer's parity); grid barrier; every block reads all the slots
//      and takes their max (exact in any order, so every block gets the
//      same value);
//   2. each CTA feeds the y it reduced, y / (max + FEED_EPS) (or not),
//      rounded to bf16, into x_buf; grid barrier;
//   3. the next layer's x slices load from x_buf by TMA.
// The producer streams the next chunks' and layers' weights meanwhile,
// as far as the ring goes. The grid barrier is the kernel's own, on a
// counter in device memory that the C entry zeroes before the launch:
// co-residency is what the cooperative launch guarantees (its grid is
// what cudaOccupancyMaxActiveClusters allows), and a barrier or mbarrier
// that waits more than 10 s traps instead of hanging the card.
//
// What holds it back (H100 80GB HBM3 at 700 W: chip_smoke.py and
// testing/kernel_variants.py, recorded in PERF.md): not its products
// (stack_no_products takes 0.48 of its 0.52 ms at 8 x 8192^2, whose
// weight bytes take 0.16 ms), but each chunk's cluster reduce, each
// layer's boundary (the last reduce, two grid barriers, the feed, the x
// slices' load) and the chunks' imbalance (64 over 15 clusters).
//
// C interface (bound with ctypes): serving_stack_slots(N) sizes the f32
// scratch (two sets of block maxima, then one word for the barrier);
// serving_stack_grid(K, wdtype) gives the CTAs a launch takes;
// serving_stack(...) returns the cudaError_t of the launch as an int,
// 0 if launched. The tensor maps of W, x_in and x_buf are encoded for
// each call (int8_gemm.cuh).

#include "int8_gemm.cuh"

namespace {

using namespace wq;

constexpr float FEED_EPS = 1e-6f;
constexpr unsigned long long BARRIER_TIMEOUT_NS = 10000000000ull;
constexpr int CS = 8;                     // CTAs of a cluster: the K split
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * WG;
// the third warpgroup: a producer warp (one thread issues the TMA loads)
// and three reducer warps
constexpr int REDUCERS = 3 * 32;
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;
constexpr int CHUNK = CONSUMERS * 64;     // channels of a chunk
constexpr int SHARE = CHUNK / CS;         // of them a rank reduces
constexpr int MT = 64;                    // tokens of an m tile (wgmma N)
constexpr int KP_MAX = 1024;              // x columns resident at a time
constexpr int X_BYTES = MT * KP_MAX * 2;  // 64 rows of 128 bytes a block
constexpr int RING_BYTES = 64 * 1024;
constexpr int LDP = CHUNK + 4;            // partial row, floats
constexpr int PART_BYTES = MT * LDP * 4;
constexpr int BAR = 1;                    // the consumers' named barrier
constexpr int REDUCE_BAR = 2;             // the reducers'
constexpr int LAYER_BAR = 3;              // both, at a layer's end

// a stage: the chunk's 128 rows of 128 bytes (128 int8 or 64 bf16
// columns), 128-byte swizzle
template <typename WT>
struct Ring {
  static constexpr int W_BK = 128 / sizeof(WT);
  static constexpr int STAGE = CHUNK * 128;
  static constexpr int STAGES = RING_BYTES / STAGE;
  static constexpr int SMEM =
      X_BYTES + RING_BYTES + PART_BYTES + (2 * STAGES + 3) * 8 + 1024;
};

struct Params {
  CUtensorMap w_map;     // W [L, N, K], boxes of 128 bytes x CHUNK rows
  CUtensorMap x_map;     // x_in [M, K] bf16, boxes of 64 columns x MT rows
  CUtensorMap xb_map;    // x_buf, the same
  bf16* x_buf;           // [M, K]: the fed activation of layers 1..L-1
  float* out;            // [M, N]: each layer's y; the last one's stays
  const float* scales;   // [L, N] or null
  float* slots;          // [2, gridDim.x] block maxima
  unsigned* bar;         // barrier counter, zero at launch
  int L, M, K;
  int feed;
  int n_chunks;          // ceil(N / CHUNK)
  int kpiece, pieces;    // a rank's K: `pieces` resident pieces of kpiece
                         // (a multiple of 128)
};

// -------------------------------------------------------------- cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// p's address in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ float4 load_cluster(const float* p, int rank) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(cluster_addr(p, rank)));
  return v;
}

// one arrival on the barrier `bar` of every CTA of the cluster,
// releasing at cluster scope what this CTA wrote before it (ordered
// before it by the caller's CTA barrier or mbarrier)
__device__ __forceinline__ void arrive_cluster(uint64_t* bar) {
#pragma unroll
  for (int q = 0; q < CS; ++q)
    asm volatile(
        "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
        ::"r"(cluster_addr(bar, q)) : "memory");
}

// a phase of a barrier the cluster arrives on, acquiring at cluster
// scope; a wait of more than 10 s traps rather than hang the card
__device__ __forceinline__ void wait_cluster(uint64_t* bar,
                                             uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  unsigned long long t0 = 0;
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if ((n & 1023) == 1023) {
      const unsigned long long now = global_ns();
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > MBAR_TIMEOUT_NS)
        __trap();
    }
  }
}

// ----------------------------------------------------------------- grid
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The consumers of every block of the grid wait here until all blocks
// have arrived: arrival number `target` of the counter (one per block
// per barrier, the counter monotone within the launch).
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned target,
                                             int ctid) {
  named_bar_sync(BAR, CONSUMERS * WG);
  if (ctid == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const unsigned long long t0 = global_ns();
    while (load_acquire(bar) < target) {
      __nanosleep(32);
      if (global_ns() - t0 > BARRIER_TIMEOUT_NS) __trap();
    }
    __threadfence();
  }
  named_bar_sync(BAR, CONSUMERS * WG);
}

// the max of v over the consumers, to every one of them
__device__ __forceinline__ float consumers_max(float v, float* warp_maxima,
                                               int ctid) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (ctid % 32 == 0) warp_maxima[ctid / 32] = v;
  named_bar_sync(BAR, CONSUMERS * WG);
  float b = 0.f;
#pragma unroll
  for (int i = 0; i < CONSUMERS * 4; ++i) b = fmaxf(b, warp_maxima[i]);
  named_bar_sync(BAR, CONSUMERS * WG);
  return b;
}

// ---------------------------------------------------------------- tiles
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
             << 16;
}

// the generic proxy's global writes ordered with TMA's (the async
// proxy's) reads of them
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The x columns [k0, k0 + kpiece) of m tile mt into the resident tile by
// TMA (column blocks of 64, each MT rows of 128 bytes, 128-byte swizzle:
// the layout of the B operand), from x_in (layer 0) or x_buf; rows past
// M and columns past K arrive as zeros, blocks wholly past K are not
// loaded (their products are skipped). One thread issues the copies.
__device__ __forceinline__ void load_x(unsigned char* xs,
                                       const CUtensorMap* map,
                                       uint64_t* bar, const Params& p,
                                       int mt, int k0) {
  int blocks = 0;
  for (int b = 0; b < p.kpiece / BK && k0 + b * BK < p.K; ++b) ++blocks;
  fence_proxy_async_global();
  mbar_arrive_expect_tx(bar, blocks * MT * 128);
  for (int b = 0; b < blocks; ++b)
    tma_load_2d(xs + b * (MT * 128), map, bar, k0 + b * BK, mt * MT);
}

// Between layers: this CTA's shares of the layer's y (the channels its
// reducers summed) fed, y / denom (or not), rounded to bf16 into x_buf,
// four a thread at a time
__device__ __forceinline__ void feed_shares(const Params& p, float denom,
                                            int cluster, int clusters,
                                            int rank, int ctid) {
  const int N = p.K;
  const int m_tiles = (p.M + MT - 1) / MT;
  for (int mt = 0; mt < m_tiles; ++mt)
    for (int j = cluster; j < p.n_chunks; j += clusters)
      for (int i = ctid; i < MT * (SHARE / 4); i += CONSUMERS * WG) {
        const int m = mt * MT + i / (SHARE / 4);
        const int n = j * CHUNK + SHARE * rank + 4 * (i % (SHARE / 4));
        if (m >= p.M || n >= N) continue;
        const int64_t at = static_cast<int64_t>(m) * N + n;
        const float4 y = __ldcg(reinterpret_cast<const float4*>(p.out + at));
        float f[4] = {y.x, y.y, y.z, y.w};
        if (p.feed) {
#pragma unroll
          for (int e = 0; e < 4; ++e) f[e] = f[e] / denom;
        }
        *reinterpret_cast<uint2*>(p.x_buf + at) =
            make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
      }
  fence_proxy_async_global();
}

// acc += W[64 rows of this consumer, a stage's columns] . x[64 tokens,
// the same columns]^T for one ring stage (xt: the first of its x column
// blocks): 128 int8 columns as register A fragments, or 64 bf16 columns
// from shared memory
__device__ __forceinline__ void stage_product(float (&acc)[32],
                                              const unsigned char* ws,
                                              const unsigned char* xt,
                                              int row, int t, int8_t) {
  uint32_t a[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    a_fragment<128>(a[kk], reinterpret_cast<const int8_t*>(ws), row, kk, t);
  fence_regs(a);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    Wgmma<bf16, 64>::template rs<0>(
        acc, a[kk], k_major_desc(xt + (kk / 4) * (MT * 128), 0, kk % 4));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

__device__ __forceinline__ void stage_product(float (&acc)[32],
                                              const unsigned char* ws,
                                              const unsigned char* xt,
                                              int row, int, bf16) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    Wgmma<bf16, 64>::ss(acc, k_major_desc(ws, row & ~63, kk),
                        k_major_desc(xt, 0, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// rank r's share of chunk j of m tile mt: channels [SHARE r, SHARE (r +
// 1)) of the chunk, the sum of the cluster's eight partials in rank order,
// scaled, to dst; four channels of one token a thread (the reducer warps)
__device__ __forceinline__ float reduce_share(const Params& p,
                                             const float* part, float* dst,
                                             const float* s_l, int rank,
                                             int mt, int j, int rtid) {
  const int N = p.K;
  float mx = 0.f;
  for (int i = rtid; i < MT * (SHARE / 4); i += REDUCERS) {
    const int tok = i / (SHARE / 4);
    const int c = SHARE * rank + 4 * (i % (SHARE / 4));
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int h = 0; h < CS; h += 4) {
      float4 s4[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        s4[q] = load_cluster(part + tok * LDP + c, h + q);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[0] += s4[q].x;
        v[1] += s4[q].y;
        v[2] += s4[q].z;
        v[3] += s4[q].w;
      }
    }
    const int m = mt * MT + tok, n = j * CHUNK + c;
    if (m < p.M && n < N) {
      if (s_l != nullptr) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = __fmul_rn(v[e], s_l[n + e]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) mx = fmaxf(mx, fabsf(v[e]));
      *reinterpret_cast<float4*>(dst + static_cast<int64_t>(m) * N + n) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  return mx;
}

template <typename WT>
__global__ void __launch_bounds__(THREADS, 1)
    stack_wgmma_kernel(const __grid_constant__ Params p) {
  using R = Ring<WT>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float warp_maxima[CONSUMERS * 4];
  __shared__ float reducer_maxima[REDUCERS / 32];
  unsigned char* xs = align_1024(smem_raw);
  unsigned char* ring = xs + X_BYTES;
  float* part = reinterpret_cast<float*>(ring + RING_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING_BYTES +
                                               PART_BYTES);
  uint64_t* empty = full + R::STAGES;
  uint64_t* ready = empty + R::STAGES;  // every CTA's partial written
  uint64_t* freed = ready + 1;          // every CTA done reading them
  uint64_t* x_full = freed + 1;         // the resident x tile loaded

  const int N = p.K;
  const int rank = blockIdx.x % CS;
  const int cluster = blockIdx.x / CS, clusters = gridDim.x / CS;
  const int m_tiles = (p.M + MT - 1) / MT;
  const int kslice = p.kpiece * p.pieces;
  const int k_tiles = p.kpiece / R::W_BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * WG);
    }
    mbar_init(ready, CS);
    mbar_init(freed, CS);
    mbar_init(x_full, 1);
    mbar_init_fence();
  }
  // the resident tile starts as zeros: columns it never loads (past K)
  // meet zero weights only in products that are skipped, but stay finite
  for (int i = threadIdx.x; i < X_BYTES / 16; i += THREADS)
    reinterpret_cast<uint4*>(xs)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  // every CTA's barriers initialised before any remote arrival
  cluster_sync();

  const int wg = threadIdx.x / WG;
  if (wg == CONSUMERS) {
    regs_dec<PRODUCER_REGS>();
    const int rtid = threadIdx.x - CONSUMERS * WG - 32;
    if (rtid < 0) {
      // producer: one thread issues every copy, in the consumers' order;
      // a tile wholly past K is not loaded (its stage is only signalled)
      if (rtid != -32) return;
      int it = 0;
      for (int l = 0; l < p.L; ++l)
        for (int mt = 0; mt < m_tiles; ++mt)
          for (int j = cluster; j < p.n_chunks; j += clusters)
            for (int pc = 0; pc < p.pieces; ++pc)
              for (int kt = 0; kt < k_tiles; ++kt, ++it) {
                const int s = it % R::STAGES;
                if (it >= R::STAGES)
                  mbar_wait(&empty[s], ((it / R::STAGES) - 1) & 1);
                const int k0 =
                    rank * kslice + pc * p.kpiece + kt * R::W_BK;
                if (k0 < p.K) {
                  mbar_arrive_expect_tx(&full[s], R::STAGE);
                  tma_load_3d(ring + s * R::STAGE, &p.w_map, &full[s], k0,
                              j * CHUNK, l);
                } else {
                  mbar_arrive(&full[s]);
                }
              }
      return;
    }
    // reducers: each chunk's cluster sum, once every CTA has written its
    // partial, while the consumers go on with the next chunk; the layer's
    // max to the consumers at its end
    int chunks_done = 0;
    for (int l = 0; l < p.L; ++l) {
      float* dst = p.out;
      const float* s_l =
          p.scales ? p.scales + static_cast<int64_t>(l) * N : nullptr;
      float mx = 0.f;
      for (int mt = 0; mt < m_tiles; ++mt)
        for (int j = cluster; j < p.n_chunks; j += clusters) {
          wait_cluster(ready, chunks_done & 1);
          mx = fmaxf(mx, reduce_share(p, part, dst, s_l, rank, mt, j, rtid));
          named_bar_sync(REDUCE_BAR, REDUCERS);
          if (rtid == 0) arrive_cluster(freed);
          ++chunks_done;
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (rtid % 32 == 0) reducer_maxima[rtid / 32] = mx;
      named_bar_sync(LAYER_BAR, CONSUMERS * WG + REDUCERS);
    }
    return;
  }
  regs_inc<CONSUMER_REGS>();
  // never taken; the consumers' code needs a branch after setmaxnreg, or
  // ptxas serializes the wgmmas for register resources (C7512)
  if (p.L <= 0) return;
  const int ctid = threadIdx.x;
  const int tid = ctid % WG;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = 64 * wg + 16 * warp + g;  // the thread's A rows in a chunk

  int it = 0, chunks_done = 0, fills = 0;
  unsigned arrivals = 0;
  for (int l = 0; l < p.L; ++l) {
    for (int mt = 0; mt < m_tiles; ++mt) {
      for (int j = cluster; j < p.n_chunks; j += clusters) {
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        for (int pc = 0; pc < p.pieces; ++pc) {
          const int k0 = rank * kslice + pc * p.kpiece;
          if (p.pieces > 1 || j == cluster) {
            // both consumers' products on the old tile done, then the
            // new tile loaded
            named_bar_sync(BAR, CONSUMERS * WG);
            if (ctid == 0)
              load_x(xs, l == 0 ? &p.x_map : &p.xb_map, x_full, p, mt, k0);
            mbar_wait(x_full, fills++ & 1);
          }
          for (int kt = 0; kt < k_tiles; ++kt, ++it) {
            const int s = it % R::STAGES;
            mbar_wait(&full[s], (it / R::STAGES) & 1);
            if (k0 + kt * R::W_BK < p.K)
              stage_product(acc, ring + s * R::STAGE,
                            xs + kt * (R::W_BK / BK) * (MT * 128), row, t,
                            WT());
            mbar_arrive(&empty[s]);
          }
        }

        // this CTA's partial, written once every CTA of the cluster has
        // read the last one; every CTA's reducers are told
        if (chunks_done > 0) wait_cluster(freed, (chunks_done - 1) & 1);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            part[(8 * i + 2 * t + (e & 1)) * LDP + row + 8 * (e >> 1)] =
                acc[4 * i + e];
        named_bar_sync(BAR, CONSUMERS * WG);
        if (ctid == 0) arrive_cluster(ready);
        ++chunks_done;
      }
    }
    // the layer's y written (the reducers' last sum done)
    named_bar_sync(LAYER_BAR, CONSUMERS * WG + REDUCERS);
    if (l == p.L - 1) break;

    // the block's max to its slot of this layer's set, then the grid's
    // from all of them: every thread reads its share at once (a max is
    // exact in any order, so every block gets the same value)
    float* slots = p.slots + (l % 2) * gridDim.x;
    if (ctid == 0) {
      float mine = 0.f;
#pragma unroll
      for (int i = 0; i < REDUCERS / 32; ++i)
        mine = fmaxf(mine, reducer_maxima[i]);
      slots[blockIdx.x] = mine;
    }
    grid_barrier(p.bar, ++arrivals * gridDim.x, ctid);
    float gm = 0.f;
    for (int i = ctid; i < static_cast<int>(gridDim.x); i += CONSUMERS * WG)
      gm = fmaxf(gm, __ldcg(slots + i));
    const float denom = consumers_max(gm, warp_maxima, ctid) + FEED_EPS;
    // the next layer's x: each share fed once, then read by TMA
    feed_shares(p, denom, cluster, clusters, rank, ctid);
    grid_barrier(p.bar, ++arrivals * gridDim.x, ctid);
  }
  // no CTA of the cluster reads this CTA's shared memory any more
  if (chunks_done > 0) wait_cluster(freed, (chunks_done - 1) & 1);
}

// The launch configuration for width N: every cluster the card holds at
// once (at most one for each chunk); the cooperative attribute is added
// by the caller
template <typename WT>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attrs,
                      int n_chunks) {
  using R = Ring<WT>;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = opt_in_smem(stack_wgmma_kernel<WT>, R::SMEM, opted_in);
  if (err != cudaSuccess) return err;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = CS;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(CS);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = R::SMEM;
  cfg->attrs = attrs;
  cfg->numAttrs = 1;
  // the clusters one card holds at once, queried once per device
  static std::atomic<int> held[64];
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  int clusters = dev < 64 ? held[dev].load(std::memory_order_relaxed) : 0;
  if (clusters <= 0) {
    err = cudaOccupancyMaxActiveClusters(&clusters, stack_wgmma_kernel<WT>,
                                         cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorCooperativeLaunchTooLarge;
    if (dev < 64) held[dev].store(clusters, std::memory_order_relaxed);
  }
  if (clusters > n_chunks) clusters = n_chunks;
  if (clusters * CS > sm_count()) clusters = sm_count() / CS;
  cfg->gridDim = dim3(clusters * CS);
  return cudaSuccess;
}

template <typename WT>
cudaError_t launch(Params p, const void* x_in, const void* w,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  cudaError_t err = configure<WT>(&cfg, attrs, p.n_chunks);
  if (err != cudaSuccess) return err;
  if ((err = row_major_map<WT, 3, Ring<WT>::W_BK>(&p.w_map, w, p.K, p.K,
                                                   p.L, CHUNK)) !=
          cudaSuccess ||
      (err = row_major_map<bf16>(&p.x_map, x_in, p.K, p.M, 1, MT)) !=
          cudaSuccess ||
      (err = row_major_map<bf16>(&p.xb_map, p.x_buf, p.K, p.M, 1, MT)) !=
          cudaSuccess)
    return err;
  cfg.stream = stream;
  cfg.numAttrs = 2;
  err = cudaMemsetAsync(p.bar, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, stack_wgmma_kernel<WT>, p);
}

}  // namespace

extern "C" {

// f32 elements of the scratch serving_stack takes for width N: two sets
// of slots for the blocks' maxima (at most one block an SM), then one
// word the barrier counts in.
int serving_stack_slots(int N) { return N <= 0 ? 0 : 2 * sm_count() + 1; }

// x_in: [M, K] bf16; x_buf: [M, K] bf16 scratch; w: [L, K, K] in wdtype
// (0 = int8, 1 = bfloat16); scales: [L, K] f32 or null; out: [M, K] f32;
// scratch: serving_stack_slots(K) f32. All contiguous, K a multiple of
// 16, x_in, x_buf, w and out 16-byte aligned. Returns the cudaError_t of
// the launch.
int serving_stack(const void* x_in, void* x_buf, const void* w,
                  const float* scales, float* out, float* scratch, int L,
                  int M, int K, int wdtype, int feed, void* stream) {
  if (L <= 0 || M <= 0 || K <= 0 || !tma_ok(x_in, w, K) ||
      !tma_ok(x_buf, out, K))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x_buf = static_cast<bf16*>(x_buf);
  p.out = out;
  p.scales = scales;
  p.slots = scratch;
  p.bar = reinterpret_cast<unsigned*>(scratch + serving_stack_slots(K) - 1);
  p.L = L;
  p.M = M;
  p.K = K;
  p.feed = feed;
  p.n_chunks = (K + CHUNK - 1) / CHUNK;
  p.pieces = (K + CS * KP_MAX - 1) / (CS * KP_MAX);
  const int per_rank = (K + CS * p.pieces - 1) / (CS * p.pieces);
  p.kpiece = (per_rank + 127) / 128 * 128;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (wdtype) {
    case 0: err = launch<int8_t>(p, x_in, w, st); break;
    case 1: err = launch<bf16>(p, x_in, w, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The CTAs serving_stack launches for width K (wdtype as there), or the
// negated cudaError_t of the occupancy query.
int serving_stack_grid(int K, int wdtype) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  const int n_chunks = (K + CHUNK - 1) / CHUNK;
  const cudaError_t err = wdtype == 0
                              ? configure<int8_t>(&cfg, attrs, n_chunks)
                              : configure<bf16>(&cfg, attrs, n_chunks);
  return err == cudaSuccess ? static_cast<int>(cfg.gridDim.x)
                            : -static_cast<int>(err);
}

const char* serving_stack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
