// Train-mode batch norm with the ReLU folded in, for Hopper (sm_90a),
// written by hand.
//
// Replaces: the Pallas TPU kernel `_norm_kernel` of
// mlcomp_tpu/ops/fused_norm.py (kernel at :83, launched by
// `_pallas_norm_act` at :121).
//
// Computes, over x viewed as [R, C] (R = N*H*W rows of a channels_last
// activation, C channels; bf16, fp16 or f32): per channel mean and the
// biased variance E[x^2] - mean^2, clipped at 0, and
// y = act(gamma * (x - mean) * rsqrt(var + eps) + beta) in x's dtype,
// with gamma, beta, mean and var f32 [C]. Sums accumulate in f32 per
// thread and block, and in double across blocks. They are sums of
// x - k and (x - k)^2 with k the channel's first row: E[x^2] - mean^2
// then cancels over the spread of x and not over its mean, so a channel
// whose mean is large against its spread keeps its variance (the f32
// sums of x and x^2 lost ~1e-5 of y at R = 8).
//
// Bound on the card (H100 SXM): bytes. Per element it reads x and
// writes y and does ~5 flops, far below the 295 flops a byte at which
// the tensor cores, let alone the FP32 units, would be the limit. At the
// CIFAR ResNet-18's largest site (R = 524,288, C = 64, bf16) one read
// and one write are 134 MB, 40 us at 3.35 TB/s.
//
// What the design does about that bound: one cooperative launch of a
// persistent grid (one block an SM, the card's whole shared memory each;
// norm_common.cuh) in three phases, so that x is read from device memory
// about once and the site costs one launch:
//   1. statistics: each block's rows split evenly; as many as fit in its
//      227 KB of shared memory are stored there by the threads as they
//      load them (evict_first in L2), the rest streamed with an
//      evict_last hint so that L2 keeps them for phase 3. Each thread
//      sums 8 channels of its rows, the block sums its lanes in a fixed
//      order and writes one partial sum and sum of squares per channel.
//      (Bulk asynchronous copies into shared memory measured slower at
//      the two large sites and level at the small ones:
//      testing/kernel_variants.py's `norm_resident_by_bulk_copies`.)
//   2. after a grid barrier, one warp per channel sums the blocks'
//      partials in double in a fixed order and writes mean and var;
//      after a second barrier each block stages its channels' values in
//      shared memory once (every thread reading them from L2 queued on
//      the few lines of [C]).
//   3. normalize: the streamed rows are read again, the last read first
//      (most likely still in L2), then the resident rows from shared
//      memory; y is written with streaming stores that do not evict the
//      rows still to be read.
// No float atomics, so two runs are bitwise equal. Channel counts that
// are not a multiple of 8 (or unaligned rows) take scalar loads with the
// tail masked and keep no row resident, so any R >= 1 and C >= 1 run.
// The L2 hints are per instruction; no device-wide L2 setting changes.
//
// C interface (bound with ctypes): fused_norm_scratch_floats(R, C) sizes
// the caller's f32 scratch; fused_norm_act(...) sizes the grid to what
// the card holds at once and returns the cudaError_t of the launch as
// an int, 0 if launched (a refused cooperative launch is an error, never
// a smaller fallback).

#include "norm_common.cuh"

namespace {

using namespace bnorm;

struct Params {
  const void* x;
  void* y;
  const float* gamma;
  const float* beta;
  float* mean;
  float* var;
  float* partial;  // [2, C, grid]: the blocks' sums, then squares
  unsigned* bar;   // the grid barrier's word
  int R, C;
  float eps;
  int act;
};

__device__ __forceinline__ void add_shifted(const float (&f)[VEC],
                                            const float (&k)[VEC],
                                            float (&s)[VEC],
                                            float (&q)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float d = f[i] - k[i];
    s[i] += d;
    q[i] = fmaf(d, d, q[i]);
  }
}

// y = act((x - mean) * scale + beta), scale = rsqrt(var + eps) * gamma
__device__ __forceinline__ void apply8(float (&f)[VEC], const float (&m)[VEC],
                                       const float (&sc)[VEC],
                                       const float (&b)[VEC], int act) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    float v = fmaf(f[i] - m[i], sc[i], b[i]);
    if (act) v = fmaxf(v, 0.f);
    f[i] = v;
  }
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS, 1)
    fused_norm_fwd_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* scratch = reinterpret_cast<float*>(smem);
  T* tile = reinterpret_cast<T*>(smem + SCRATCH_BYTES);
  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);
  const int C = p.C;
  const Rows rows = block_rows(p.R, C * static_cast<int>(sizeof(T)), VECTOR);
  const Lanes ln = lanes_for(C);
  const int tx = threadIdx.x % ln.gpb, ty = threadIdx.x / ln.gpb;
  const int lanes = ln.lanes;
  const uint64_t keep = evict_last_policy();
  const uint64_t drop = evict_first_policy();
  constexpr int U = 4;  // rows whose loads are in flight at once
  using Row = Row8<T, VECTOR>;

  // 1. statistics: the resident rows (stored to shared memory as they
  // are summed), then the streamed ones (kept in L2)
  for (int g0 = 0; g0 < ln.groups; g0 += ln.gpb) {
    const int c0 = (g0 + tx) * VEC;
    const bool on = ty < lanes && c0 < C;
    const int n = on ? min(VEC, C - c0) : 0;
    float s[VEC], q[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;
    if (on) {
      float k[VEC];  // the shift: row 0 of these channels, in every block
      unpack(load_row<T, VECTOR>(x + c0, n, keep), k);
      const auto add = [&](const Row& raw) {
        float f[VEC];
        unpack(raw, f);
        add_shifted(f, k, s, q);
      };
      if constexpr (VECTOR)
        sweep<U>(ty, rows.res, lanes, [&](int rr) {
          return load_row<T, VECTOR>(
              x + static_cast<size_t>(rows.r0 + rr) * C + c0, n, drop);
        }, [&](int rr, const Row& raw) {
          store_tile(tile + static_cast<size_t>(rr) * C + c0, raw);
          add(raw);
        });
      sweep<U>(rows.r0 + rows.res + ty, rows.r1, lanes, [&](int r) {
        return load_row<T, VECTOR>(x + static_cast<size_t>(r) * C + c0, n,
                                   keep);
      }, [&](int, const Row& raw) { add(raw); });
    }
    block_sum_store(scratch, s, tx, ty, ln, p.partial, C, g0 * VEC, 0);
    block_sum_store(scratch, q, tx, ty, ln, p.partial, C, g0 * VEC, 1);
  }
  grid_sync(p.bar);

  // 2. per channel, one warp: the blocks' partials in double, in a fixed
  // order (lane l takes blocks l, l + 32, ..., then the warp's butterfly)
  {
    const int G = gridDim.x;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int c = blockIdx.x * WARPS + warp; c < C; c += G * WARPS) {
      const float* ps = p.partial + static_cast<size_t>(c) * G;
      const float* pq = p.partial + static_cast<size_t>(C + c) * G;
      double s = 0.0, q = 0.0;
      for (int b = lane; b < G; b += 32) {
        s += __ldcg(ps + b);
        q += __ldcg(pq + b);
      }
      s = warp_sum(s);
      q = warp_sum(q);
      if (lane == 0) {
        const double shift = to_f(x[c]);
        const double d = s / p.R;  // mean of x - k
        double var = q / p.R - d * d;
        if (var < 0.0) var = 0.0;
        p.mean[c] = static_cast<float>(shift + d);
        p.var[c] = static_cast<float>(var);
      }
    }
  }
  grid_sync(p.bar);

  // 3. normalize: the streamed rows again, the last read first, then the
  // resident rows from shared memory
  for (int g0 = 0; g0 < ln.groups; g0 += ln.gpb) {
    const int c0 = (g0 + tx) * VEC;
    float ch[3][VEC];  // mean, scale = rsqrt(var + eps) * gamma, beta
    stage_channels(scratch, C, g0 * VEC, tx, ch, [&](int c, float (&v)[3]) {
      v[0] = __ldcg(p.mean + c);
      v[1] = rsqrtf(__ldcg(p.var + c) + p.eps) * p.gamma[c];
      v[2] = p.beta[c];
    });
    if (ty >= lanes || c0 >= C) continue;
    const int n = min(VEC, C - c0);
    const auto apply = [&](int r, const Row& raw) {
      float f[VEC];
      unpack(raw, f);
      apply8(f, ch[0], ch[1], ch[2], p.act);
      store_row<T, VECTOR>(y + static_cast<size_t>(r) * C + c0, n, f);
    };
    sweep_back<U>(rows.r0 + rows.res + ty, rows.r1, lanes, [&](int r) {
      return load_row<T, VECTOR>(x + static_cast<size_t>(r) * C + c0, n,
                                 drop);
    }, apply);
    if constexpr (VECTOR)
      sweep<1>(ty, rows.res, lanes, [&](int rr) {
        return load_tile(tile + static_cast<size_t>(rr) * C + c0);
      }, [&](int rr, const Row& raw) { apply(rows.r0 + rr, raw); });
  }
}

template <typename T, bool VECTOR>
cudaError_t launch(Params p, cudaStream_t stream) {
  static std::atomic<int> held[64];
  int grid = 0;
  cudaError_t err =
      coresident_grid(fused_norm_fwd_kernel<T, VECTOR>, held, p.R, &grid);
  if (err != cudaSuccess) return err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_norm_fwd_kernel<T, VECTOR>),
      dim3(grid), dim3(THREADS), args, SMEM_BYTES, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_vector(const Params& p, bool vector,
                            cudaStream_t stream) {
  return vector ? launch<T, true>(p, stream) : launch<T, false>(p, stream);
}

}  // namespace

extern "C" {

// f32 elements of the scratch fused_norm_act takes for [R, C]: the
// blocks' sums and sums of squares, 2 * C * blocks; 0 for R or C below 1.
int fused_norm_scratch_floats(int R, int C) {
  if (R <= 0 || C <= 0) return 0;
  return 2 * C * max_blocks(R);
}

// x, y: [R, C] contiguous in dtype (0 = float32, 1 = bfloat16,
// 2 = float16); gamma, beta, mean, var: [C] f32; scratch: an f32 scratch
// of fused_norm_scratch_floats(R, C); bar: the grid barrier's word, zero
// before the first launch on a stream (every launch leaves its low bits
// as it found them). Returns the
// cudaError_t of the launch.
int fused_norm_act(const void* x, const float* gamma, const float* beta,
                   void* y, float* mean, float* var, float* scratch,
                   unsigned* bar, int R, int C, int dtype, float eps, int act,
                   void* stream) {
  if (R <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, y, gamma, beta, mean, var, scratch, bar, R, C, eps, act};
  const bool vector = vector_ok(C, x, y, x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = dispatch_vector<float>(p, vector, st); break;
    case 1: err = dispatch_vector<__nv_bfloat16>(p, vector, st); break;
    case 2: err = dispatch_vector<__half>(p, vector, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* fused_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
