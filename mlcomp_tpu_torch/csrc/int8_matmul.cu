// Weight-only int8 matrix product for Hopper (sm_90a), written by hand.
//
// Replaces: the Pallas TPU kernel `_kernel` of
// mlcomp_tpu/ops/int8_matmul.py (kernel at :87, launched by
// `_pallas_int8_matmul` at :106).
//
// Computes out[M, N] = (x[M, K] @ dequant(w_qt[N, K])^T) * scale[N] in
// f32: x bf16 row-major, w_qt int8 row-major (quantize_int8's transposed
// layout), scale f32 per output channel. The int8 values convert to bf16
// exactly on the tile, products accumulate in f32 on the tensor cores,
// and the per-channel scale is applied once to the f32 sum, as on the
// TPU (post-scaling). Any M, N, K >= 1.
//
// Bound on the card (H100 SXM): two shape classes.
//  - Small M (the bench's M = 64, K = N = 8192): 67 MB of int8 weight
//    against 8.6 GFLOP, 0.021 ms of bytes at 3.35 TB/s against 0.009 ms
//    of operations at 989 TFLOP/s bf16: the weight stream bounds it, and
//    every SM has to be streaming.
//  - Large M (the served LM at batch 4, M = 32768): 2*M*N*K operations
//    bound it (0.28 ms for a d_ff projection, 2.2 ms for the LM head,
//    whose 4.3 GB f32 output alone takes 1.3 ms).
//
// What the design does about that, first version: one tile product
// (int8_gemm.cuh) in two configurations. Large M: 128 x 128 output tiles
// of 8 warps (64 x 32 each), a 3-stage cp.async ring of 64-deep K tiles.
// Small M (M <= 64): 64 x 128 tiles; there are too few tiles over N to
// fill 132 SMs, so K is split too (grid.z), as far as the blocks fill one
// wave of what the SMs hold at once. Each split writes its f32 partial
// sums to a scratch of the caller's ([splits, M_pad, N_pad]); a second
// kernel adds the splits in a fixed order and scales: deterministic, no
// atomics. wgmma, TMA and a persistent schedule are later work.
//
// C interface (bound with ctypes): int8_matmul_workspace(M, N, K) gives
// the f32 scratch elements int8_matmul needs for that shape (0: no
// split); int8_matmul(...) returns the cudaError_t of its launches as an
// int, 0 if launched.

#include "int8_gemm.cuh"

namespace {

using namespace wq;

using SmallTile = Tile<int8_t, 64, 128, 64, 2, 4, 4>;
// the large tile's 64 sums a thread leave no registers for a second set:
// no promotion (its K in the served LM is at most 4096)
using LargeTile = Tile<int8_t, 128, 128, 64, 2, 4, 3, false>;
constexpr int SMALL_M = 64;  // M up to this takes SmallTile
constexpr int MAX_SPLITS = 32;
constexpr int REDUCE_THREADS = 256;

struct Params {
  const bf16* x;
  const int8_t* w;
  const float* scale;
  float* out;
  float* partial;  // [splits, m_pad, n_pad] f32 when splits > 1
  int M, N, K;
  int kt_per_split, splits;
  int m_pad, n_pad;
  int vec;
};

// Block (n tile, m tile, K split): its tile's sum over its K range,
// scaled into out (one split) or raw into the split's partial scratch.
template <class T>
__global__ void __launch_bounds__(T::THREADS) int8_matmul_kernel(Params p) {
  extern __shared__ __align__(16) char smem[];
  const int n0 = blockIdx.x * T::TILE_N;
  const int m0 = blockIdx.y * T::TILE_M;
  const int k0 = blockIdx.z * p.kt_per_split * T::TILE_K;
  const int k1 = min(p.K, k0 + p.kt_per_split * T::TILE_K);
  typename T::Acc acc;
  T::zero(acc);
  T::run(p.x, p.w, p.M, p.N, p.K, m0, n0, k0, k1, p.vec, smem, acc);
  if (p.splits == 1) {
    const bool pair = p.N % 2 == 0;
    T::for_each(acc, m0, n0, [&](int row, int col, float v0, float v1) {
      const float s0 = col < p.N ? p.scale[col] : 0.f;
      const float s1 = col + 1 < p.N ? p.scale[col + 1] : 0.f;
      store_pair(p.out, p.N, p.M, p.N, row, col, v0 * s0, v1 * s1, pair);
    });
  } else {
    float* part = p.partial + static_cast<int64_t>(blockIdx.z) * p.m_pad *
                                  p.n_pad;
    T::for_each(acc, m0, n0, [&](int row, int col, float v0, float v1) {
      store_pair(part, p.n_pad, p.M, p.N, row, col, v0, v1, true);
    });
  }
}

// out[m, n] = scale[n] * sum over the splits in order of partial[s, m, n]
__global__ void __launch_bounds__(REDUCE_THREADS) splitk_reduce_kernel(
    Params p) {
  const int64_t total = static_cast<int64_t>(p.M) * p.N;
  const int64_t split_stride = static_cast<int64_t>(p.m_pad) * p.n_pad;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * REDUCE_THREADS +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * REDUCE_THREADS) {
    const int m = static_cast<int>(i / p.N), n = static_cast<int>(i % p.N);
    const float* src = p.partial + static_cast<int64_t>(m) * p.n_pad + n;
    float s = 0.f;
    for (int j = 0; j < p.splits; ++j) s += src[j * split_stride];
    p.out[i] = s * p.scale[n];
  }
}

// Above 48 KB of dynamic shared memory: the opt-in, once per device.
template <class T>
cudaError_t opt_in() {
  static std::atomic<unsigned long long> opted_in{0};
  return opt_in_smem(int8_matmul_kernel<T>, T::SMEM_BYTES, opted_in);
}

// blocks of the T configuration one SM holds at once, read once per
// device (as sm_count is): plan() runs on every call
template <class T>
int resident_blocks() {
  static std::atomic<int> counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  int n = counts[dev].load(std::memory_order_relaxed);
  if (n > 0) return n;
  if (opt_in<T>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, int8_matmul_kernel<T>, T::THREADS, T::SMEM_BYTES) !=
          cudaSuccess ||
      n < 1)
    return 1;
  counts[dev].store(n, std::memory_order_relaxed);
  return n;
}

// The launch plan for [M, K] @ [N, K]^T: tile configuration and K split.
struct Plan {
  bool small;
  int bm, bn, bk;
  int m_tiles, n_tiles;
  int kt_per_split, splits;
  long long workspace;  // f32 elements of the split scratch
};

// Fewer output tiles than the card holds blocks at once: split K so that
// the blocks fill one wave (splits = resident blocks / tiles, at most
// the K tiles there are); otherwise no split.
Plan plan(int M, int N, int K) {
  Plan p;
  p.small = M <= SMALL_M;
  p.bm = p.small ? SmallTile::TILE_M : LargeTile::TILE_M;
  p.bn = p.small ? SmallTile::TILE_N : LargeTile::TILE_N;
  p.bk = p.small ? SmallTile::TILE_K : LargeTile::TILE_K;
  p.m_tiles = (M + p.bm - 1) / p.bm;
  p.n_tiles = (N + p.bn - 1) / p.bn;
  const int n_kt = (K + p.bk - 1) / p.bk;
  const long long tiles = static_cast<long long>(p.m_tiles) * p.n_tiles;
  const long long wave =
      static_cast<long long>(sm_count()) *
      (p.small ? resident_blocks<SmallTile>() : resident_blocks<LargeTile>());
  int splits = 1;
  if (tiles < wave) {
    const long long fit = wave / tiles;
    splits = static_cast<int>(fit < n_kt ? fit : n_kt);
    if (splits > MAX_SPLITS) splits = MAX_SPLITS;
  }
  p.kt_per_split = (n_kt + splits - 1) / splits;
  p.splits = (n_kt + p.kt_per_split - 1) / p.kt_per_split;
  p.workspace = p.splits > 1 ? static_cast<long long>(p.splits) *
                                   p.m_tiles * p.bm * p.n_tiles * p.bn
                             : 0;
  return p;
}

template <class T>
cudaError_t launch(const Params& p, const Plan& plan, cudaStream_t stream) {
  cudaError_t err = opt_in<T>();
  if (err != cudaSuccess) return err;
  const dim3 grid(plan.n_tiles, plan.m_tiles, plan.splits);
  int8_matmul_kernel<T><<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.splits == 1) return err;
  const long long total = static_cast<long long>(p.M) * p.N;
  long long blocks = (total + REDUCE_THREADS - 1) / REDUCE_THREADS;
  if (blocks > 8L * sm_count()) blocks = 8L * sm_count();
  splitk_reduce_kernel<<<static_cast<int>(blocks), REDUCE_THREADS, 0,
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

// x: [M, K] bf16, w: [N, K] int8, scale: [N] f32, out: [M, N] f32, all
// contiguous, out 8-byte aligned (float2 stores); partial:
// int8_matmul_workspace(M, N, K) f32 elements on the same device (may be
// null when that is 0). Returns the cudaError_t of the launches.
int int8_matmul(const void* x, const void* w, const float* scale,
                float* out, float* partial, int M, int N, int K,
                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan(M, N, K);
  if (pl.m_tiles > 65535 || (pl.splits > 1 && partial == nullptr) ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const bf16*>(x), static_cast<const int8_t*>(w),
           scale, out, partial, M, N, K, pl.kt_per_split, pl.splits,
           pl.m_tiles * pl.bm, pl.n_tiles * pl.bn,
           vec_ok<int8_t>(x, w, K) ? 1 : 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = pl.small ? launch<SmallTile>(p, pl, st)
                                   : launch<LargeTile>(p, pl, st);
  return static_cast<int>(err);
}

const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
