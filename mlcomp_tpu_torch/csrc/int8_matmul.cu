// Weight-only int8 matrix product for Hopper (sm_90a), written by hand.
//
// Replaces: the Pallas TPU kernel `_kernel` of
// mlcomp_tpu/ops/int8_matmul.py (kernel at :87, launched by
// `_pallas_int8_matmul` at :106).
//
// Computes out[M, N] = (x[M, K] @ dequant(w_qt[N, K])^T) * scale[N]: x
// bf16 row-major, w_qt int8 row-major (quantize_int8's transposed
// layout), scale f32 per output channel. The int8 values convert to bf16
// exactly, products accumulate in f32 on the tensor cores, and the
// per-channel scale is applied once to the f32 sum, as on the TPU
// (post-scaling). Optionally (Int8Dense's epilogue) a bias f32 [N] is
// added and the result written in bf16 or fp16: ((acc * scale) + bias)
// rounded to the output type, each step rounded on its own (__fmul_rn,
// __fadd_rn: never an FMA), so it is bit for bit the unfused formula.
// Any M, N >= 1; K >= 1 a multiple of 16 with 16-byte aligned x and w
// (TMA's rule: the wrapper pads K with zeros where it is not).
//
// Bound on the card (H100 SXM): two shape classes.
//  - Large M (the served LM at batch 4, M = 32768): 2*M*N*K operations
//    at 989 TFLOP/s bf16 bound it (0.28 ms for a d_ff projection, 2.2 ms
//    for the LM head, whose 4.3 GB f32 output alone takes 1.3 ms of
//    bytes at 3.35 TB/s).
//  - Small M (the bench's M = 64, K = N = 8192): 67 MB of int8 weight
//    against 8.6 GFLOP, 0.021 ms of bytes against 0.009 ms of
//    operations: the weight stream bounds it, and every SM has to be
//    streaming.
//
// What the design does about that: the tile product of int8_gemm.cuh on
// warpgroup wgmma (the only way to the tensor cores' full rate), the
// transposed tile y^T[channels, tokens] = W . x^T with the weight rows
// as the register A operand, converted from int8 in registers, and the
// x tile as the shared-memory B operand. A block is three warpgroups:
// two consumers of 64 output channels each (64 per row group) and a
// producer whose one thread issues the TMA loads of the x and w tiles
// into a ring of full/empty mbarrier stages; setmaxnreg moves registers
// from the producer to the consumers. Each consumer waits for a stage,
// converts its A fragments, issues the stage's products, waits for them
// and frees the stage; the two consumers' products interleave on the
// tensor cores, one converting while the other's products run.
//  - Large M: 128 channels by 256 tokens a block (m64n256k16), a 5-stage
//    ring of 40 KB stages. Blocks walk the channel tiles of one token
//    tile first, so the blocks in flight share their x tiles in L2.
//  - Small M (M <= 64): 128 channels by 64 tokens a block (m64n64k16),
//    an 8-stage ring of 16 KB stages. Too few tiles fill 132 SMs, so K
//    is split too (grid.y), as far as one block an SM goes; each split
//    writes its f32 partial sums to the caller's scratch ([splits,
//    M_pad, N_pad]) and int8_reduce_kernel adds the splits in a fixed
//    order, then scales: deterministic, no atomics.
// The epilogue stages the f32 accumulators through shared memory (the
// ring, free by then) as [tokens][channels], so each warp's stores to
// out [M, N] are whole rows of 16-byte (f32) or 8-byte (16-bit) vectors.
// No promotion: wgmma's f32 sums run the whole K of a block (the check
// shapes include K = 8192 at large M against INT8_ROW_TOL: 3.2e-6 of a
// row measured on the H100).
//
// What holds it back (H100 80GB HBM3 at 700 W: chip_smoke.py and
// testing/kernel_variants.py, recorded in PERF.md): at large M it runs at
// 420-640 TFLOP/s; without its products it still takes two thirds of
// its time (the loads, the epilogue and each block's start: without
// the int8 conversion it is barely faster). One block a tile; a
// persistent grid that starts the next tile's loads under the epilogue
// is later work.
//
// C interface (bound with ctypes): int8_matmul_workspace(M, N, K) gives
// the f32 scratch elements int8_matmul needs for that shape (0: no
// split); int8_matmul(...) returns the cudaError_t of its launches as an
// int, 0 if launched. The tensor maps of x and w are encoded for each
// call (int8_gemm.cuh).

#include "int8_gemm.cuh"

namespace {

using namespace wq;

constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * WG;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int SMALL_M = 64;  // M up to this takes the Small configuration
constexpr int MAX_SPLITS = 32;
constexpr int REDUCE_THREADS = 256;
constexpr int BAR = 1;  // the consumers' named barrier

// RG row groups of 64 channels a consumer; BN tokens a tile
template <int RG_, int BN_, int STAGES_>
struct Config {
  static constexpr int RG = RG_, BN = BN_, STAGES = STAGES_;
  static constexpr int CH = CONSUMERS * 64 * RG;  // channels a block
  static constexpr int X_BYTES = BN * BK * 2;
  static constexpr int W_BYTES = CH * BK;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int LDS = CH + 4;  // staged row, floats (bank offset)
  static constexpr int STAGING = BN * LDS * 4;
  static constexpr int DATA = RING > STAGING ? RING : STAGING;
  static constexpr int SMEM = DATA + 2 * STAGES * 8 + 1024;
  static_assert(X_BYTES % 1024 == 0 && W_BYTES % 1024 == 0, "alignment");
};
using Large = Config<1, 256, 5>;
using Small = Config<1, 64, 8>;

enum OutType { OUT_F32 = 0, OUT_BF16 = 1, OUT_F16 = 2 };

struct Params {
  CUtensorMap x_map;  // x [M, K] bf16, boxes of 64 columns x BN rows
  CUtensorMap w_map;  // w [N, K] int8, boxes of 64 columns x CH rows
  const float* scale;
  const float* bias;  // [N] or null
  void* out;          // [M, N] in out_type
  float* partial;     // [splits, m_pad, n_pad] f32 when splits > 1
  int M, N, K;
  int out_type;
  int n_tiles;
  int kt_per_split, splits;
  int m_pad, n_pad;
  int vec;  // out's rows take whole vectors (N % 4 == 0, base aligned)
};

// four outputs of row m from column c: (v * scale) + bias in f32, each
// rounded on its own, stored in the output type; masked to N
__device__ __forceinline__ void store4(const Params& p, int m, int c,
                                       const float (&v)[4]) {
  float y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = c + j < p.N ? c + j : p.N - 1;
    y[j] = __fmul_rn(v[j], p.scale[n]);
    if (p.bias != nullptr) y[j] = __fadd_rn(y[j], p.bias[n]);
  }
  const int64_t at = static_cast<int64_t>(m) * p.N + c;
  const bool whole = p.vec && c + 3 < p.N;
  if (p.out_type == OUT_F32) {
    float* o = static_cast<float*>(p.out) + at;
    if (whole) {
      *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
      return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < p.N) o[j] = y[j];
    return;
  }
  unsigned short h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    h[j] = p.out_type == OUT_BF16
               ? __bfloat16_as_ushort(__float2bfloat16_rn(y[j]))
               : __half_as_ushort(__float2half_rn(y[j]));
  unsigned short* o = static_cast<unsigned short*>(p.out) + at;
  if (whole) {
    *reinterpret_cast<uint2*>(o) =
        make_uint2(h[0] | static_cast<uint32_t>(h[1]) << 16,
                   h[2] | static_cast<uint32_t>(h[3]) << 16);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < p.N) o[j] = h[j];
}

// Block (channel tile, token tile; K split): its tile's sums over its K
// range, into out (one split) or raw into the split's partial scratch.
template <class C>
__global__ void __launch_bounds__(THREADS, 1)
    int8_wgmma_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::DATA);
  uint64_t* empty = full + C::STAGES;

  const int n0 = (blockIdx.x % p.n_tiles) * C::CH;
  const int m0 = (blockIdx.x / p.n_tiles) * C::BN;
  const int n_kt = (p.K + BK - 1) / BK;
  const int kt0 = blockIdx.y * p.kt_per_split;
  const int n_k = min(n_kt, kt0 + p.kt_per_split) - kt0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * WG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == CONSUMERS) {
    // producer: one thread issues every copy
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * WG) {
      for (int i = 0; i < n_k; ++i) {
        const int s = i % C::STAGES;
        // the stage's last tiles released by both consumers
        if (i >= C::STAGES) mbar_wait(&empty[s], ((i / C::STAGES) - 1) & 1);
        unsigned char* st = ring + s * C::STAGE_BYTES;
        const int k0 = (kt0 + i) * BK;
        mbar_arrive_expect_tx(&full[s], C::STAGE_BYTES);
        tma_load_2d(st, &p.x_map, &full[s], k0, m0);
        tma_load_2d(st + C::X_BYTES, &p.w_map, &full[s], k0, n0);
      }
    }
    return;
  }
  regs_inc<CONSUMER_REGS>();
  // never taken (the plan gives every block a K tile); the consumers'
  // code needs a branch after setmaxnreg, or ptxas serializes the wgmmas
  // for register resources (C7512; PERF.md)
  if (n_k <= 0) return;
  const int tid = threadIdx.x % WG;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  float acc[C::RG][C::BN / 2];
#pragma unroll
  for (int rg = 0; rg < C::RG; ++rg)
#pragma unroll
    for (int i = 0; i < C::BN / 2; ++i) acc[rg][i] = 0.f;

  for (int i = 0; i < n_k; ++i) {
    const int s = i % C::STAGES;
    mbar_wait(&full[s], (i / C::STAGES) & 1);
    const unsigned char* xs = ring + s * C::STAGE_BYTES;
    const int8_t* ws = reinterpret_cast<const int8_t*>(xs + C::X_BYTES);
    uint32_t a[C::RG][BK / 16][4];
#pragma unroll
    for (int rg = 0; rg < C::RG; ++rg)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        a_fragment(a[rg][kk], ws, 64 * (wg * C::RG + rg) + 16 * warp + g,
                   kk, t);
#pragma unroll
    for (int rg = 0; rg < C::RG; ++rg) {
      fence_regs(a[rg]);
      fence_regs(acc[rg]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int rg = 0; rg < C::RG; ++rg)
        Wgmma<bf16, C::BN>::template rs<0>(acc[rg], a[rg][kk],
                                           k_major_desc(xs, 0, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int rg = 0; rg < C::RG; ++rg) fence_regs(acc[rg]);
    mbar_arrive(&empty[s]);
  }

  // the accumulators through shared memory as [token][channel], once
  // both consumers' products are done with the ring
  named_bar_sync(BAR, CONSUMERS * WG);
  float* staged = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int rg = 0; rg < C::RG; ++rg)
#pragma unroll
    for (int i = 0; i < C::BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        staged[(8 * i + 2 * t + (e & 1)) * C::LDS + 64 * (wg * C::RG + rg) +
               16 * warp + g + 8 * (e >> 1)] = acc[rg][4 * i + e];
  named_bar_sync(BAR, CONSUMERS * WG);

  // each thread: four channels, every (threads / groups)-th token
  constexpr int GROUPS = C::CH / 4;
  constexpr int STEP = CONSUMERS * WG / GROUPS;
  const int ctid = threadIdx.x;
  const int c4 = 4 * (ctid % GROUPS);
  for (int r = ctid / GROUPS; r < C::BN && m0 + r < p.M; r += STEP) {
    const float4 v4 =
        *reinterpret_cast<const float4*>(staged + r * C::LDS + c4);
    if (p.splits == 1) {
      if (n0 + c4 < p.N) {
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
        store4(p, m0 + r, n0 + c4, v);
      }
    } else {
      float* part = p.partial +
                    (static_cast<int64_t>(blockIdx.y) * p.m_pad + m0 + r) *
                        p.n_pad +
                    n0 + c4;
      *reinterpret_cast<float4*>(part) = v4;
    }
  }
}

// out[m, n] from the sum over the splits in order of partial[s, m, n],
// four columns a thread
__global__ void __launch_bounds__(REDUCE_THREADS)
    int8_reduce_kernel(const Params p) {
  const int groups = (p.N + 3) / 4;
  const int64_t total = static_cast<int64_t>(p.M) * groups;
  const int64_t split_stride = static_cast<int64_t>(p.m_pad) * p.n_pad;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * REDUCE_THREADS +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * REDUCE_THREADS) {
    const int m = static_cast<int>(i / groups);
    const int c = 4 * static_cast<int>(i % groups);
    const float* src = p.partial + static_cast<int64_t>(m) * p.n_pad + c;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < p.splits; ++j) {
      const float4 s4 =
          *reinterpret_cast<const float4*>(src + j * split_stride);
      sum.x += s4.x;
      sum.y += s4.y;
      sum.z += s4.z;
      sum.w += s4.w;
    }
    const float v[4] = {sum.x, sum.y, sum.z, sum.w};
    store4(p, m, c, v);
  }
}

// Above 48 KB of dynamic shared memory: the opt-in, once per device.
template <class C>
cudaError_t opt_in() {
  static std::atomic<unsigned long long> opted_in{0};
  return opt_in_smem(int8_wgmma_kernel<C>, C::SMEM, opted_in);
}

// The launch plan for [M, K] @ [N, K]^T: configuration and K split.
struct Plan {
  bool small;
  int bn, ch;
  int m_tiles, n_tiles;
  int kt_per_split, splits;
  long long workspace;  // f32 elements of the split scratch
};

// Fewer tiles than SMs (one block an SM): split K so that the blocks
// fill one wave (splits = SMs / tiles, at most the K tiles there are);
// otherwise no split.
Plan plan(int M, int N, int K) {
  Plan p;
  p.small = M <= SMALL_M;
  p.bn = p.small ? Small::BN : Large::BN;
  p.ch = p.small ? Small::CH : Large::CH;
  p.m_tiles = (M + p.bn - 1) / p.bn;
  p.n_tiles = (N + p.ch - 1) / p.ch;
  const int n_kt = (K + BK - 1) / BK;
  const long long tiles = static_cast<long long>(p.m_tiles) * p.n_tiles;
  const long long wave = sm_count();
  int splits = 1;
  if (tiles < wave) {
    const long long fit = wave / tiles;
    splits = static_cast<int>(fit < n_kt ? fit : n_kt);
    if (splits > MAX_SPLITS) splits = MAX_SPLITS;
  }
  p.kt_per_split = (n_kt + splits - 1) / splits;
  p.splits = (n_kt + p.kt_per_split - 1) / p.kt_per_split;
  p.workspace = p.splits > 1 ? static_cast<long long>(p.splits) *
                                   p.m_tiles * p.bn * p.n_tiles * p.ch
                             : 0;
  return p;
}

template <class C>
cudaError_t launch(Params& p, const void* x, const void* w, const Plan& pl,
                   cudaStream_t stream) {
  cudaError_t err = opt_in<C>();
  if (err != cudaSuccess) return err;
  if ((err = row_major_map<bf16>(&p.x_map, x, p.K, p.M, 1, C::BN)) !=
          cudaSuccess ||
      (err = row_major_map<int8_t>(&p.w_map, w, p.K, p.N, 1, C::CH)) !=
          cudaSuccess)
    return err;
  const dim3 grid(pl.m_tiles * pl.n_tiles, pl.splits);
  int8_wgmma_kernel<C><<<grid, THREADS, C::SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || pl.splits == 1) return err;
  const long long total = static_cast<long long>(p.M) * ((p.N + 3) / 4);
  long long blocks = (total + REDUCE_THREADS - 1) / REDUCE_THREADS;
  if (blocks > 8L * sm_count()) blocks = 8L * sm_count();
  int8_reduce_kernel<<<static_cast<int>(blocks), REDUCE_THREADS, 0,
                       stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 elements of the scratch int8_matmul takes for [M, K] @ [N, K]^T:
// the K splits' partial sums, 0 when it does not split K.
long long int8_matmul_workspace(int M, int N, int K) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  return plan(M, N, K).workspace;
}

// x: [M, K] bf16, w: [N, K] int8, scale: [N] f32, bias: [N] f32 or null,
// out: [M, N] in out_type (0 f32, 1 bf16, 2 fp16), all contiguous; K a
// multiple of 16, x and w 16-byte aligned; partial:
// int8_matmul_workspace(M, N, K) f32 elements on the same device (may be
// null when that is 0). Returns the cudaError_t of the launches.
int int8_matmul(const void* x, const void* w, const float* scale,
                const float* bias, void* out, int out_type, float* partial,
                int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || !tma_ok(x, w, K) || out_type < 0 ||
      out_type > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan(M, N, K);
  if (static_cast<long long>(pl.m_tiles) * pl.n_tiles > 0x7fffffffLL ||
      pl.splits > 65535 || (pl.splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = out_type == OUT_F32 ? 16 : 8;
  Params p;
  p.scale = scale;
  p.bias = bias;
  p.out = out;
  p.partial = partial;
  p.M = M;
  p.N = N;
  p.K = K;
  p.out_type = out_type;
  p.n_tiles = pl.n_tiles;
  p.kt_per_split = pl.kt_per_split;
  p.splits = pl.splits;
  p.m_pad = pl.m_tiles * pl.bn;
  p.n_pad = pl.n_tiles * pl.ch;
  p.vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % align == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = pl.small ? launch<Small>(p, x, w, pl, st)
                                   : launch<Large>(p, x, w, pl, st);
  return static_cast<int>(err);
}

const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
