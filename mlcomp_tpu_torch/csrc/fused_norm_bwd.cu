// The backward of train-mode batch norm with the ReLU folded in, for
// Hopper (sm_90a), written by hand.
//
// Replaces: the plain passes of `norm_act_backward`
// (mlcomp_tpu_torch/ops/fused_norm.py), the port of the JAX package's
// `_fused_bwd` (mlcomp_tpu/ops/fused_norm.py:211), which is jnp: no TPU
// kernel, so this is the port's own kernel for the norm's backward.
//
// Computes, over x and dy viewed as [R, C] (bf16, fp16 or f32, dy in x's
// dtype) with gamma, beta, mean, var f32 [C], as `_fused_bwd` does:
//   inv = rsqrt(var + eps); xhat = x * inv + (-mean * inv);
//   pre = xhat * gamma + beta (both fused multiply-adds, the order of
//   the plain version's torch.addcmul); dy' = act ? dy * [pre > 0] : dy;
//   dbeta = sum dy', dgamma = sum dy' * xhat, per channel, f32 out;
//   dx = (xhat * (-dgamma / R) + dy' - dbeta / R) * (inv * gamma) in x's
//   dtype. The sums accumulate in f32 per thread and block and in double
//   across blocks, in a fixed order.
//
// Bound on the card (H100 SXM): bytes. It reads x and dy and writes dx,
// ~10 flops an element. At the CIFAR ResNet-18's largest site (R =
// 524,288, C = 64, bf16) that is 201 MB, 60 us at 3.35 TB/s.
//
// What the design does about that bound: the forward's skeleton
// (fused_norm.cu, norm_common.cuh), one cooperative launch of a
// persistent grid in three phases:
//   1. each block's rows of x and dy, as many as fit in its 227 KB of
//      shared memory (twice the forward's bytes a row), are stored there
//      by the threads as they load them, the rest streamed with an L2
//      evict_last hint; each thread recomputes xhat and the mask and sums
//      dy' and dy' * xhat for 8 channels; the block sums its lanes in a
//      fixed order and writes one partial each per channel.
//   2. after a grid barrier, one warp per channel sums the partials in
//      double in a fixed order and writes dgamma and dbeta; after a
//      second barrier each block stages its channels' values in shared
//      memory once.
//   3. the streamed rows of x and dy are read again (the last read
//      first), then the resident rows from shared memory, and dx is
//      written with streaming stores.
// No float atomics, so two runs are bitwise equal. Channel counts that
// are not a multiple of 8 (or unaligned rows) take scalar loads with the
// tail masked and keep no row resident.
//
// C interface (bound with ctypes): fused_norm_bwd_scratch_floats(R, C)
// sizes the caller's f32 scratch; fused_norm_act_backward(...) returns
// the cudaError_t of the launch as an int, 0 if launched.

#include "norm_common.cuh"

namespace {

using namespace bnorm;

struct Params {
  const void* x;
  const void* dy;
  const float* gamma;
  const float* beta;
  const float* mean;
  const float* var;
  void* dx;
  float* dgamma;
  float* dbeta;
  float* partial;  // [2, C, grid]: the blocks' sums of dy', then dy' xhat
  unsigned* bar;   // the grid barrier's word
  int R, C;
  float eps;
  int act;
};

// the staged per-channel values: inv = rsqrt(var + eps), nb = -mean *
// inv, gamma, beta; in phase 3 also a = -dgamma / R and b = dbeta / R
enum { INV, NB, GAMMA, BETA, A, B };

template <int N>
__device__ __forceinline__ void stage_inputs(const Params& p, float* scratch,
                                             int c_base, int tx,
                                             float (&ch)[N][VEC]) {
  stage_channels(scratch, p.C, c_base, tx, ch, [&](int c, float (&v)[N]) {
    v[INV] = rsqrtf(p.var[c] + p.eps);
    v[NB] = -p.mean[c] * v[INV];
    v[GAMMA] = p.gamma[c];
    v[BETA] = p.beta[c];
    if constexpr (N > B) {
      v[A] = -__ldcg(p.dgamma + c) / static_cast<float>(p.R);
      v[B] = __ldcg(p.dbeta + c) / static_cast<float>(p.R);
    }
  });
}

// xhat of 8 channels, and dy masked where the ReLU was off
template <int N>
__device__ __forceinline__ void mask8(const float (&xv)[VEC],
                                      float (&d)[VEC], float (&xh)[VEC],
                                      const float (&ch)[N][VEC], int act) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    xh[i] = fmaf(xv[i], ch[INV][i], ch[NB][i]);
    if (act) {
      const float pre = fmaf(xh[i], ch[GAMMA][i], ch[BETA][i]);
      if (!(pre > 0.f)) d[i] = 0.f;
    }
  }
}

// phase 1 for one row: s += dy', q += dy' * xhat
__device__ __forceinline__ void grads8(const float (&xv)[VEC],
                                       float (&d)[VEC],
                                       const float (&ch)[4][VEC], int act,
                                       float (&s)[VEC], float (&q)[VEC]) {
  float xh[VEC];
  mask8(xv, d, xh, ch, act);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s[i] += d[i];
    q[i] = fmaf(d[i], xh[i], q[i]);
  }
}

// phase 3 for one row: d becomes dx = (xhat * a + dy' - b) * sc
__device__ __forceinline__ void dx8(const float (&xv)[VEC], float (&d)[VEC],
                                    const float (&ch)[6][VEC],
                                    const float (&sc)[VEC], int act) {
  float xh[VEC];
  mask8(xv, d, xh, ch, act);
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    d[i] = (fmaf(xh[i], ch[A][i], d[i]) - ch[B][i]) * sc[i];
}

// a row's 8 values of x and of dy, as loaded
template <typename T, bool VECTOR>
struct Pair {
  Row8<T, VECTOR> x, d;
};

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS, 1)
    fused_norm_bwd_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* scratch = reinterpret_cast<float*>(smem);
  T* tile_x = reinterpret_cast<T*>(smem + SCRATCH_BYTES);
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  T* dx = static_cast<T*>(p.dx);
  const int C = p.C;
  const Rows rows = block_rows(p.R, 2 * C * static_cast<int>(sizeof(T)),
                               VECTOR);
  T* tile_dy = tile_x + static_cast<size_t>(rows.res) * C;
  const Lanes ln = lanes_for(C);
  const int tx = threadIdx.x % ln.gpb, ty = threadIdx.x / ln.gpb;
  const int lanes = ln.lanes;
  const uint64_t keep = evict_last_policy();
  const uint64_t drop = evict_first_policy();
  constexpr int U = 2;  // rows whose loads (x and dy) are in flight
  using Two = Pair<T, VECTOR>;
  const auto load_pair = [&](int r, int c0, int n, uint64_t policy) {
    const size_t off = static_cast<size_t>(r) * C + c0;
    return Two{load_row<T, VECTOR>(x + off, n, policy),
               load_row<T, VECTOR>(dy + off, n, policy)};
  };

  // 1. the sums: the resident rows (stored to shared memory as they are
  // summed), then the streamed ones (kept in L2)
  for (int g0 = 0; g0 < ln.groups; g0 += ln.gpb) {
    const int c0 = (g0 + tx) * VEC;
    const bool on = ty < lanes && c0 < C;
    const int n = on ? min(VEC, C - c0) : 0;
    float ch[4][VEC];
    stage_inputs(p, scratch, g0 * VEC, tx, ch);
    float s[VEC], q[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;
    if (on) {
      const auto add = [&](const Two& raw) {
        float xv[VEC], d[VEC];
        unpack(raw.x, xv);
        unpack(raw.d, d);
        grads8(xv, d, ch, p.act, s, q);
      };
      if constexpr (VECTOR)
        sweep<U>(ty, rows.res, lanes, [&](int rr) {
          return load_pair(rows.r0 + rr, c0, n, drop);
        }, [&](int rr, const Two& raw) {
          const size_t off = static_cast<size_t>(rr) * C + c0;
          store_tile(tile_x + off, raw.x);
          store_tile(tile_dy + off, raw.d);
          add(raw);
        });
      sweep<U>(rows.r0 + rows.res + ty, rows.r1, lanes, [&](int r) {
        return load_pair(r, c0, n, keep);
      }, [&](int, const Two& raw) { add(raw); });
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
        p.dbeta[c] = static_cast<float>(s);
        p.dgamma[c] = static_cast<float>(q);
      }
    }
  }
  grid_sync(p.bar);

  // 3. dx: the streamed rows again, the last read first, then the
  // resident rows from shared memory
  for (int g0 = 0; g0 < ln.groups; g0 += ln.gpb) {
    const int c0 = (g0 + tx) * VEC;
    float ch[6][VEC];
    stage_inputs(p, scratch, g0 * VEC, tx, ch);
    if (ty >= lanes || c0 >= C) continue;
    const int n = min(VEC, C - c0);
    float sc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) sc[i] = ch[INV][i] * ch[GAMMA][i];
    const auto dx_row = [&](int r, const Two& raw) {
      float xv[VEC], d[VEC];
      unpack(raw.x, xv);
      unpack(raw.d, d);
      dx8(xv, d, ch, sc, p.act);
      store_row<T, VECTOR>(dx + static_cast<size_t>(r) * C + c0, n, d);
    };
    sweep_back<U>(rows.r0 + rows.res + ty, rows.r1, lanes, [&](int r) {
      return load_pair(r, c0, n, drop);
    }, dx_row);
    if constexpr (VECTOR)
      sweep<1>(ty, rows.res, lanes, [&](int rr) {
        const size_t off = static_cast<size_t>(rr) * C + c0;
        return Two{load_tile(tile_x + off), load_tile(tile_dy + off)};
      }, [&](int rr, const Two& raw) { dx_row(rows.r0 + rr, raw); });
  }
}

template <typename T, bool VECTOR>
cudaError_t launch(Params p, cudaStream_t stream) {
  static std::atomic<int> held[64];
  int grid = 0;
  cudaError_t err =
      coresident_grid(fused_norm_bwd_kernel<T, VECTOR>, held, p.R, &grid);
  if (err != cudaSuccess) return err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_norm_bwd_kernel<T, VECTOR>),
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

// f32 elements of the scratch fused_norm_act_backward takes for [R, C]:
// the blocks' two partial sums, 2 * C * blocks; 0 for R or C below 1.
int fused_norm_bwd_scratch_floats(int R, int C) {
  if (R <= 0 || C <= 0) return 0;
  return 2 * C * max_blocks(R);
}

// x, dy, dx: [R, C] contiguous in dtype (0 = float32, 1 = bfloat16,
// 2 = float16); gamma, beta, mean, var, dgamma, dbeta: [C] f32; scratch:
// an f32 scratch of fused_norm_bwd_scratch_floats(R, C); bar: the grid
// barrier's word, zero before the first launch on a stream (every launch
// leaves its low bits as it found them). Returns the cudaError_t of the
// launch.
int fused_norm_act_backward(const void* x, const void* dy,
                            const float* gamma, const float* beta,
                            const float* mean, const float* var, void* dx,
                            float* dgamma, float* dbeta, float* scratch,
                            unsigned* bar, int R, int C, int dtype,
                            float eps, int act, void* stream) {
  if (R <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, dy, gamma, beta, mean, var, dx, dgamma, dbeta, scratch, bar,
           R, C, eps, act};
  const bool vector = vector_ok(C, x, dy, dx);
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

const char* fused_norm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
