// Blocked softmax cross-entropy, forward and backward, for Hopper
// (sm_90a), written by hand.
//
// Replaces: the Pallas TPU kernels `_ce_fwd_kernel` of
// mlcomp_tpu/ops/fused_ce.py (kernel at :79, launched by
// `_pallas_ce_fwd` at :140) and `_ce_bwd_kernel` (kernel at :124,
// launched by `_pallas_ce_bwd` at :174).
//
// Computes, over logits x [N, V] (row r at x + r * ld, ld >= V; bf16,
// fp16 or f32) and labels y [N] (int32, clamped to [0, V) here too), with
// z the z-loss weight and e the label smoothing:
//   forward:  (m, s) the row's running max and sum of exp(x - m) in f32,
//             lse  = m + log(max(s, 1e-30)),
//             loss = lse - (1 - e) * x[y] - (e / V) * sum(x) + z * lse^2,
//             both f32 [N] (fused_ce.py:109-120, term for term);
//   backward: dx = (p * (1 + 2 z lse) - ((1 - e) * [j == y] + e / V)) * g
//             with p = exp(x - lse) and g the loss's gradient [N] f32;
//             dx [N, V] contiguous in x's dtype.
//
// Bound on the card (H100 SXM): bytes. The forward reads x once and
// does ~5 f32 operations an element (max, an exp as one FFMA and ex2,
// the add, the smoothing sum); the backward reads x and writes dx with
// ~6. Both are far below the 295 operations a byte at which the tensor
// cores, let alone the FP32 units, would bound them. At the wide LM's
// training step (N = 8191 = B(T-1) at B = 1, T = 8192; V = 32768; bf16)
// the forward's 536.8 MB take 0.160 ms at 3.35 TB/s, the backward's
// 1.074 GB 0.320 ms.
//
// What the design does about that bound, first version. The TPU
// streams vocab blocks through VMEM in a sequential grid axis and
// carries (max, sumexp, picked, sum) in scratch between them. Here one
// block of 256 threads owns a row and the sequential axis becomes a
// loop inside each thread: x is read once, 16 bytes a thread a load (8
// bf16/fp16 or 4 f32 values) where the row's address allows it, each
// thread keeping its own online (max, sumexp) and sum(x) in registers;
// the block combines them with warp shuffles and shared memory in a
// fixed order, so the result does not depend on scheduling. The label's
// logit is read once, by one thread, at the clamped label. A row whose
// start is not 16-byte aligned (an odd V, or a view into wider rows)
// takes scalar loads up to the first aligned element, then 16-byte
// loads, then a scalar tail, so any N >= 1, V >= 1 and stride run. The
// backward is one elementwise pass with the row's lse, g and label read
// once a row; it takes 16-byte loads and stores where x's row and dx's
// row have the same alignment, scalar ones otherwise. Exponentials are
// ex2.approx on x * log2(e) - m * log2(e) (one FFMA).
//
// C interface (bound with ctypes): fused_ce_forward(...) and
// fused_ce_backward(...) launch on the caller's stream and return the
// cudaError_t of the launch as an int, 0 if launched.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // threads of a block; one block a row
constexpr int WARPS = THREADS / 32;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* x;
  const int* y;
  float* loss;       // forward: [N]
  float* lse;        // forward: written; backward: read [N]
  const float* g;    // backward: [N]
  void* dx;          // backward: [N, V] contiguous
  long long ld;      // x's row stride, in elements
  int N, V;
  float one_minus_eps;  // 1 - e
  float eps_per_v;      // e / V
  float z;              // z
  float two_z;          // 2 z
  int smooth;           // e != 0: keep sum(x)
};

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// values of T in one 16-byte load
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* p,
                                         float (&f)[Vec<T>::N]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) f[i] = to_f(h[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p,
                                          const float (&f)[Vec<T>::N]) {
  uint4 u;
  T* h = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) h[i] = from_f<T>(f[i]);
  *reinterpret_cast<uint4*>(p) = u;
}

// The split of a row of V values of T at address `row` into a scalar
// head up to the first 16-byte boundary, `nvec` 16-byte vectors and a
// scalar tail. `phase`: another address whose alignment must match the
// row's for the vectors (the backward's dx row; the row itself in the
// forward); a mismatch, or a row not aligned to sizeof(T), makes the
// whole row the head.
struct RowSplit {
  int head, nvec;
};

template <typename T>
__device__ __forceinline__ RowSplit split_row(const void* row,
                                              const void* phase, int V) {
  constexpr int VEC = Vec<T>::N;
  const uintptr_t a = reinterpret_cast<uintptr_t>(row);
  const uintptr_t b = reinterpret_cast<uintptr_t>(phase);
  RowSplit s;
  if (a % sizeof(T) != 0 || (a - b) % 16 != 0) {
    s.head = V;
    s.nvec = 0;
    return s;
  }
  s.head = min(V, static_cast<int>(((16 - a % 16) % 16) / sizeof(T)));
  s.nvec = (V - s.head) / VEC;
  return s;
}

// The online update of a thread's (m, s) and sum(x) t with K values.
template <int K>
__device__ __forceinline__ void online(const float (&f)[K], float& m,
                                       float& s, float& t, bool smooth) {
  float cm = f[0];
#pragma unroll
  for (int i = 1; i < K; ++i) cm = fmaxf(cm, f[i]);
  if (cm > m) {
    s *= exp2f((m - cm) * LOG2E);  // rescale the sum to the new max
    m = cm;
  }
  const float mb = m * LOG2E;
#pragma unroll
  for (int i = 0; i < K; ++i) s += exp2f(fmaf(f[i], LOG2E, -mb));
  if (smooth) {
#pragma unroll
    for (int i = 0; i < K; ++i) t += f[i];
  }
}

// (m, s) <- the pair for the union of (m, s) and (m2, s2); a side whose
// max is the union's keeps its sum as it is (both may be -inf: a thread
// that saw no value).
__device__ __forceinline__ void combine(float& m, float& s, float m2,
                                        float s2) {
  const float mn = fmaxf(m, m2);
  const float a = m == mn ? s : s * exp2f((m - mn) * LOG2E);
  const float b = m2 == mn ? s2 : s2 * exp2f((m2 - mn) * LOG2E);
  m = mn;
  s = a + b;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ce_fwd_kernel(Params p) {
  constexpr int VEC = Vec<T>::N;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const T* xr = static_cast<const T*>(p.x) + static_cast<size_t>(r) * p.ld;
  const bool smooth = p.smooth != 0;
  const RowSplit sp = split_row<T>(xr, xr, p.V);
  float m = -INFINITY, s = 0.f, t = 0.f;
  for (int j = tid; j < sp.head; j += THREADS) {
    const float f[1] = {to_f(xr[j])};
    online<1>(f, m, s, t, smooth);
  }
  const T* body = xr + sp.head;
#pragma unroll 4
  for (int i = tid; i < sp.nvec; i += THREADS) {
    float f[VEC];
    load_vec<T>(body + static_cast<size_t>(i) * VEC, f);
    online<VEC>(f, m, s, t, smooth);
  }
  for (int j = sp.head + sp.nvec * VEC + tid; j < p.V; j += THREADS) {
    const float f[1] = {to_f(xr[j])};
    online<1>(f, m, s, t, smooth);
  }
  // the block's pair: lanes by butterfly, then the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    const float t2 = __shfl_xor_sync(0xffffffffu, t, off);
    combine(m, s, m2, s2);
    t += t2;
  }
  __shared__ float sh_m[WARPS], sh_s[WARPS], sh_t[WARPS];
  if ((tid & 31) == 0) {
    sh_m[tid >> 5] = m;
    sh_s[tid >> 5] = s;
    sh_t[tid >> 5] = t;
  }
  __syncthreads();
  if (tid != 0) return;
  m = sh_m[0];
  s = sh_s[0];
  t = sh_t[0];
  for (int w = 1; w < WARPS; ++w) {
    combine(m, s, sh_m[w], sh_s[w]);
    t += sh_t[w];
  }
  const int lab = min(max(p.y[r], 0), p.V - 1);
  const float picked = to_f(xr[lab]);
  const float lse = m + logf(fmaxf(s, 1e-30f));
  float loss = smooth ? lse - p.one_minus_eps * picked - p.eps_per_v * t
                      : lse - picked;
  if (p.z != 0.f) loss += p.z * lse * lse;
  p.lse[r] = lse;
  p.loss[r] = loss;
}

// dx of one value v at column j of a row with label lab, lse * log2(e)
// lb, p's factor c1 = 1 + 2 z lse and loss gradient g.
__device__ __forceinline__ float ce_grad(float v, int j, int lab, float lb,
                                         float c1, float g, const Params& p) {
  const float pe = exp2f(fmaf(v, LOG2E, -lb));
  const float target = (j == lab ? p.one_minus_eps : 0.f) + p.eps_per_v;
  return (pe * c1 - target) * g;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ce_bwd_kernel(Params p) {
  constexpr int VEC = Vec<T>::N;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const T* xr = static_cast<const T*>(p.x) + static_cast<size_t>(r) * p.ld;
  T* dr = static_cast<T*>(p.dx) + static_cast<size_t>(r) * p.V;
  const float lse = p.lse[r];
  const float g = p.g[r];
  const int lab = min(max(p.y[r], 0), p.V - 1);
  const float lb = lse * LOG2E;
  const float c1 = 1.f + p.two_z * lse;
  const RowSplit sp = split_row<T>(xr, dr, p.V);
  for (int j = tid; j < sp.head; j += THREADS)
    dr[j] = from_f<T>(ce_grad(to_f(xr[j]), j, lab, lb, c1, g, p));
  const T* xb = xr + sp.head;
  T* db = dr + sp.head;
#pragma unroll 4
  for (int i = tid; i < sp.nvec; i += THREADS) {
    float f[VEC];
    load_vec<T>(xb + static_cast<size_t>(i) * VEC, f);
    const int j0 = sp.head + i * VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      f[k] = ce_grad(f[k], j0 + k, lab, lb, c1, g, p);
    store_vec<T>(db + static_cast<size_t>(i) * VEC, f);
  }
  for (int j = sp.head + sp.nvec * VEC + tid; j < p.V; j += THREADS)
    dr[j] = from_f<T>(ce_grad(to_f(xr[j]), j, lab, lb, c1, g, p));
}

// The constants of both passes, from the caller's doubles as the JAX
// package rounds them (Python floats, f32 where they meet the arrays).
Params make_params(const void* x, const int* y, int N, int V,
                   long long ld, double z, double eps) {
  Params p{};
  p.x = x;
  p.y = y;
  p.ld = ld;
  p.N = N;
  p.V = V;
  p.one_minus_eps = static_cast<float>(1.0 - eps);
  p.eps_per_v = static_cast<float>(eps / V);
  p.z = static_cast<float>(z);
  p.two_z = static_cast<float>(2.0 * z);
  p.smooth = eps != 0.0;
  return p;
}

template <typename T>
cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
  ce_fwd_kernel<T><<<p.N, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const Params& p, cudaStream_t stream) {
  ce_bwd_kernel<T><<<p.N, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

bool valid(int N, int V, long long ld) {
  return N >= 1 && V >= 1 && ld >= V;
}

}  // namespace

extern "C" {

// x: [N, V] at row stride ld (elements) in dtype (0 = float32,
// 1 = bfloat16, 2 = float16); y: [N] int32; loss, lse: [N] f32. Returns
// the cudaError_t of the launch.
int fused_ce_forward(const void* x, const int* y, float* loss, float* lse,
                     int N, int V, long long ld, int dtype, double z,
                     double eps, void* stream) {
  if (!valid(N, V, ld)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(x, y, N, V, ld, z, eps);
  p.loss = loss;
  p.lse = lse;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_fwd<float>(p, st));
    case 1: return static_cast<int>(launch_fwd<__nv_bfloat16>(p, st));
    case 2: return static_cast<int>(launch_fwd<__half>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, y, dtype as for the forward; lse, g: [N] f32; dx: [N, V] contiguous
// in x's dtype. Returns the cudaError_t of the launch.
int fused_ce_backward(const void* x, const int* y, const float* lse,
                      const float* g, void* dx, int N, int V, long long ld,
                      int dtype, double z, double eps, void* stream) {
  if (!valid(N, V, ld)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(x, y, N, V, ld, z, eps);
  p.lse = const_cast<float*>(lse);
  p.g = g;
  p.dx = dx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_bwd<float>(p, st));
    case 1: return static_cast<int>(launch_bwd<__nv_bfloat16>(p, st));
    case 2: return static_cast<int>(launch_bwd<__half>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fused_ce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
