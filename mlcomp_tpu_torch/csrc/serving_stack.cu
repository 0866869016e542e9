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
// What the design does about that bound, first version: the TPU runs
// one sequential program with the activation resident in VMEM. The
// activation here is 1 MB at M = 64, K = 8192: more than a block's
// shared memory, far less than the 50 MB L2. So one persistent
// cooperative launch (cudaLaunchCooperativeKernel, grid sized from
// occupancy, at most one block per 64-column tile of y) keeps every SM
// streaming weights, and the activation lives in device memory, read
// through L2. Per layer each block:
//   1. streams its tiles' weight rows (int8_gemm.cuh, a 4-stage
//      cp.async ring of 128-deep K tiles) against all of x from L2;
//   2. scales its f32 sums and writes its tiles of y into out, keeping
//      the block's max|y|;
//   3. writes that max to its slot; grid barrier;
//   4. reads all the slots at once, one a thread, and takes their max
//      (exact in any order, so every block gets the same value; no
//      float atomics), then writes its columns of the next x in bf16;
//      grid barrier.
// The barrier is the kernel's own, on a counter in device memory that
// the C entry zeroes before the launch: co-residency is what the
// cooperative launch guarantees, and a barrier that waits more than 10 s
// traps instead of hanging the card. Every block reads x through L2
// (cp.async.cg / ld.global.cg), never a stale L1 line.
//
// C interface (bound with ctypes): serving_stack_slots(N) sizes the f32
// scratch (the block maxima, then one word for the barrier);
// serving_stack(...) returns the cudaError_t of the launch as an int,
// 0 if launched.

#include "int8_gemm.cuh"

namespace {

using namespace wq;

constexpr float FEED_EPS = 1e-6f;
constexpr int STACK_BN = 64;
constexpr unsigned long long BARRIER_TIMEOUT_NS = 10000000000ull;

template <typename WT>
using StackTile = Tile<WT, 64, STACK_BN, 128, 2, 4, 4>;

struct Params {
  const bf16* x_in;     // [M, K], layer 0's input
  bf16* x_buf;          // [M, K], the fed activation of later layers
  const void* w;        // [L, N, K]
  const float* scales;  // [L, N] or null
  float* out;           // [M, N]: each layer's y; the last one's stays
  float* slots;         // [gridDim.x] block maxima
  unsigned* bar;        // barrier counter, zero at launch
  int L, M, K;
  int feed;
  int vec;
};

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Every block of the grid waits here until all have arrived: arrival
// number `target` of the counter (one per block per barrier, the
// counter monotone within the launch).
__device__ __forceinline__ void grid_barrier(unsigned* bar,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const unsigned long long t0 = global_ns();
    while (load_acquire(bar) < target) {
      __nanosleep(32);
      if (global_ns() - t0 > BARRIER_TIMEOUT_NS) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the max of v over the block, to every thread; `warp_maxima` is free
// again when it returns
template <int WARPS>
__device__ __forceinline__ float block_max_of(float v, float* warp_maxima) {
  v = warp_max(v);
  if (threadIdx.x % 32 == 0) warp_maxima[threadIdx.x / 32] = v;
  __syncthreads();
  float b = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) b = fmaxf(b, warp_maxima[i]);
  __syncthreads();
  return b;
}

template <typename WT>
__global__ void __launch_bounds__(StackTile<WT>::THREADS)
    serving_stack_kernel(Params p) {
  using T = StackTile<WT>;
  extern __shared__ __align__(16) char smem[];
  __shared__ float warp_maxima[T::THREADS / 32];
  const int N = p.K;
  const int n_tiles = (N + STACK_BN - 1) / STACK_BN;
  const bool pair = N % 2 == 0;
  const WT* w_all = static_cast<const WT*>(p.w);
  unsigned arrivals = 0;
  for (int l = 0; l < p.L; ++l) {
    const bf16* x = l == 0 ? p.x_in : p.x_buf;
    const WT* w = w_all + static_cast<int64_t>(l) * N * p.K;
    const float* s =
        p.scales ? p.scales + static_cast<int64_t>(l) * N : nullptr;
    float block_max = 0.f;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int n0 = t * STACK_BN;
      for (int m0 = 0; m0 < p.M; m0 += T::TILE_M) {
        typename T::Acc acc;
        T::zero(acc);
        T::run(x, w, p.M, N, p.K, m0, n0, 0, p.K, p.vec, smem, acc);
        T::for_each(acc, m0, n0, [&](int row, int col, float v0, float v1) {
          if (s) {
            v0 *= col < N ? s[col] : 0.f;
            v1 *= col + 1 < N ? s[col + 1] : 0.f;
          }
          if (row < p.M) {
            if (col < N) block_max = fmaxf(block_max, fabsf(v0));
            if (col + 1 < N) block_max = fmaxf(block_max, fabsf(v1));
          }
          store_pair(p.out, N, p.M, N, row, col, v0, v1, pair);
        });
      }
    }
    if (l == p.L - 1) break;

    // the block's max to its slot, then the grid's from all slots: every
    // thread reads its share of them at once (a max is exact in any
    // order, so every block gets the same value)
    const float mine = block_max_of<T::THREADS / 32>(block_max, warp_maxima);
    if (threadIdx.x == 0) p.slots[blockIdx.x] = mine;
    grid_barrier(p.bar, ++arrivals * gridDim.x);
    float g = 0.f;
    for (int i = threadIdx.x; i < static_cast<int>(gridDim.x);
         i += T::THREADS)
      g = fmaxf(g, __ldcg(p.slots + i));
    const float denom =
        block_max_of<T::THREADS / 32>(g, warp_maxima) + FEED_EPS;

    // the feed: this block's columns of y into the next x
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int n0 = t * STACK_BN;
      const int cols = min(STACK_BN, N - n0);
      for (int i = threadIdx.x; i < p.M * cols; i += T::THREADS) {
        const int64_t at = static_cast<int64_t>(i / cols) * N + n0 + i % cols;
        const float y = __ldcg(p.out + at);
        p.x_buf[at] = __float2bfloat16_rn(p.feed ? y / denom : y);
      }
    }
    grid_barrier(p.bar, ++arrivals * gridDim.x);
  }
}

template <typename WT>
cudaError_t launch(Params p, int N, cudaStream_t stream) {
  using T = StackTile<WT>;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err =
      opt_in_smem(serving_stack_kernel<WT>, T::SMEM_BYTES, opted_in);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, serving_stack_kernel<WT>, T::THREADS, T::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int n_tiles = (N + STACK_BN - 1) / STACK_BN;
  const int grid = n_tiles < per_sm * sm_count() ? n_tiles
                                                 : per_sm * sm_count();
  p.vec = vec_ok<WT>(p.x_in, p.w, p.K) && vec_ok<WT>(p.x_buf, p.w, p.K);
  err = cudaMemsetAsync(p.bar, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(serving_stack_kernel<WT>), dim3(grid),
      dim3(T::THREADS), args, T::SMEM_BYTES, stream);
}

}  // namespace

extern "C" {

// f32 elements of the scratch serving_stack takes for width N: a slot
// for each block's max (at most one block per 64 columns), then one
// word the barrier counts in.
int serving_stack_slots(int N) {
  return N <= 0 ? 0 : (N + STACK_BN - 1) / STACK_BN + 1;
}

// x_in, x_buf: [M, K] bf16; w: [L, K, K] in wdtype (0 = int8,
// 1 = bfloat16); scales: [L, K] f32 or null; out: [M, K] f32; scratch:
// serving_stack_slots(K) f32. All contiguous. Returns the cudaError_t
// of the launch.
int serving_stack(const void* x_in, void* x_buf, const void* w,
                  const float* scales, float* out, float* scratch, int L,
                  int M, int K, int wdtype, int feed, void* stream) {
  if (L <= 0 || M <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slots = serving_stack_slots(K) - 1;
  Params p{static_cast<const bf16*>(x_in), static_cast<bf16*>(x_buf), w,
           scales, out, scratch, reinterpret_cast<unsigned*>(scratch + slots),
           L, M, K, feed, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (wdtype) {
    case 0: err = launch<int8_t>(p, K, st); break;
    case 1: err = launch<bf16>(p, K, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* serving_stack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
