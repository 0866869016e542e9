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
// What the design does about that bound, first version: the TPU runs
// one program with two sequential passes over row blocks and the sums
// in VMEM scratch. Blocks on Hopper run in no order, so the statistics
// need a reduction across blocks, done without float atomics so that
// the result does not depend on the order blocks finish:
//   1. stats: a grid of row blocks x channel chunks. Each thread owns 8
//      consecutive channels (one 16-byte load of bf16/fp16, two of f32)
//      and sweeps its block's rows; the block sums its rows in shared
//      memory in a fixed order and writes one partial sum and sum of
//      squares per channel: [row_blocks, C] each.
//   2. finalize: per channel, the partials summed in double in a fixed
//      order; mean and var written.
//   3. normalize: the grid of pass 1 reads x again and writes
//      y = act((x - mean) * rsqrt(var + eps) * gamma + beta).
// So x is read twice (2 reads + 1 write, as on the TPU); keeping it in
// shared memory or L2 between the passes is later work. Channel counts
// that are not a multiple of 8 (or unaligned rows) take scalar loads
// with the tail masked, so any R >= 1 and C >= 1 run.
//
// C interface (bound with ctypes): fused_norm_scratch_rows(R, C) sizes
// the caller's f32 scratch; fused_norm_act(...) chooses the grid itself
// and returns the cudaError_t of the launches as an int, 0 if launched.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // threads of a stats / normalize block
constexpr int VEC = 8;        // consecutive channels per thread
constexpr int FIN_C = 32;     // channels of a finalize block
constexpr int FIN_B = 32;     // row-block lanes of a finalize block
// blocks the statistics pass aims to have in flight (4 per SM of the
// H100's 132), split over row blocks and channel chunks
constexpr int TARGET_BLOCKS = 528;

struct Params {
  const void* x;
  void* y;
  const float* gamma;
  const float* beta;
  float* mean;
  float* var;
  float* partial;  // [2 * row_blocks + 1, C]: sums, squares, shift k
  int R, C;
  int row_blocks, rows_per_block;
  int tx_log2;  // channel groups of a block: 1 << tx_log2
  float eps;
  int act;
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

// f[i] = p[i] for i < n (0 past it). VECTOR: n == 8 and p 16-byte
// aligned, one 16-byte load (two for f32).
template <typename T, bool VECTOR>
__device__ __forceinline__ void load8(const T* p, int n, float (&f)[VEC]) {
  if constexpr (VECTOR) {
    if constexpr (sizeof(T) == 2) {
      uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = to_f(h[i]);
    } else {
      const float4* q = reinterpret_cast<const float4*>(p);
      float4 a = __ldg(q), b = __ldg(q + 1);
      f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
      f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = i < n ? to_f(p[i]) : 0.f;
  }
}

template <typename T, bool VECTOR>
__device__ __forceinline__ void store8(T* p, int n, const float (&f)[VEC]) {
  if constexpr (VECTOR) {
    if constexpr (sizeof(T) == 2) {
      uint4 u;
      T* h = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int i = 0; i < VEC; ++i) h[i] = from_f<T>(f[i]);
      *reinterpret_cast<uint4*>(p) = u;
    } else {
      float4* q = reinterpret_cast<float4*>(p);
      q[0] = make_float4(f[0], f[1], f[2], f[3]);
      q[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (i < n) p[i] = from_f<T>(f[i]);
  }
}

// Pass 1: block (row block bx, channel chunk by) writes its partial sum
// and sum of squares of each of its channels.
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS) norm_stats_kernel(Params p) {
  __shared__ float sh_s[THREADS * VEC];
  __shared__ float sh_q[THREADS * VEC];
  const int tx_n = 1 << p.tx_log2;
  const int ty_n = THREADS >> p.tx_log2;
  const int tx = threadIdx.x & (tx_n - 1);
  const int ty = threadIdx.x >> p.tx_log2;
  const int c0 = (blockIdx.y * tx_n + tx) * VEC;
  const int r0 = blockIdx.x * p.rows_per_block;
  const int r1 = min(p.R, r0 + p.rows_per_block);
  const T* x = static_cast<const T*>(p.x);
  float s[VEC], q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;
  if (c0 < p.C) {
    const int n = min(VEC, p.C - c0);
    float k[VEC];  // the shift: row 0 of these channels, in every block
    load8<T, VECTOR>(x + c0, n, k);
    if (blockIdx.x == 0 && ty == 0) {
      for (int i = 0; i < n; ++i)
        p.partial[static_cast<size_t>(2 * p.row_blocks) * p.C + c0 + i] =
            k[i];
    }
    for (int r = r0 + ty; r < r1; r += ty_n) {
      float f[VEC];
      load8<T, VECTOR>(x + static_cast<size_t>(r) * p.C + c0, n, f);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = f[i] - k[i];
        s[i] += d;
        q[i] = fmaf(d, d, q[i]);
      }
    }
  }
  // [ty][tx][i] in shared memory, then each column summed over ty in
  // order by one thread
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sh_s[threadIdx.x * VEC + i] = s[i];
    sh_q[threadIdx.x * VEC + i] = q[i];
  }
  __syncthreads();
  const int cols = tx_n * VEC;
  for (int t = threadIdx.x; t < cols; t += THREADS) {
    float a = 0.f, b = 0.f;
    for (int yy = 0; yy < ty_n; ++yy) {
      a += sh_s[yy * cols + t];
      b += sh_q[yy * cols + t];
    }
    const int c = blockIdx.y * cols + t;
    if (c < p.C) {
      p.partial[static_cast<size_t>(blockIdx.x) * p.C + c] = a;
      p.partial[static_cast<size_t>(p.row_blocks + blockIdx.x) * p.C + c] =
          b;
    }
  }
}

// Pass 2: per channel, the row blocks' partials summed in double in a
// fixed order (FIN_B lanes, then the lanes in order); mean and var
// written.
__global__ void __launch_bounds__(FIN_C * FIN_B) norm_finalize_kernel(
    Params p) {
  __shared__ double sh_s[FIN_B][FIN_C];
  __shared__ double sh_q[FIN_B][FIN_C];
  const int c = blockIdx.x * FIN_C + threadIdx.x;
  double s = 0.0, q = 0.0;
  if (c < p.C) {
#pragma unroll 4
    for (int b = threadIdx.y; b < p.row_blocks; b += FIN_B) {
      s += p.partial[static_cast<size_t>(b) * p.C + c];
      q += p.partial[static_cast<size_t>(p.row_blocks + b) * p.C + c];
    }
  }
  sh_s[threadIdx.y][threadIdx.x] = s;
  sh_q[threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y != 0 || c >= p.C) return;
  s = q = 0.0;
  for (int l = 0; l < FIN_B; ++l) {
    s += sh_s[l][threadIdx.x];
    q += sh_q[l][threadIdx.x];
  }
  const double shift = p.partial[static_cast<size_t>(2 * p.row_blocks) * p.C
                                 + c];
  const double d = s / p.R;  // mean of x - k
  double var = q / p.R - d * d;
  if (var < 0.0) var = 0.0;
  p.mean[c] = static_cast<float>(shift + d);
  p.var[c] = static_cast<float>(var);
}

// Pass 3: y = act((x - mean) * scale + beta) with
// scale = rsqrt(var + eps) * gamma, the grid of pass 1.
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS) norm_apply_kernel(Params p) {
  const int tx_n = 1 << p.tx_log2;
  const int ty_n = THREADS >> p.tx_log2;
  const int tx = threadIdx.x & (tx_n - 1);
  const int ty = threadIdx.x >> p.tx_log2;
  const int c0 = (blockIdx.y * tx_n + tx) * VEC;
  if (c0 >= p.C) return;
  const int n = min(VEC, p.C - c0);
  float m[VEC], sc[VEC], b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const bool in = i < n;
    m[i] = in ? p.mean[c0 + i] : 0.f;
    sc[i] = in ? rsqrtf(p.var[c0 + i] + p.eps) * p.gamma[c0 + i] : 0.f;
    b[i] = in ? p.beta[c0 + i] : 0.f;
  }
  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);
  const int r0 = blockIdx.x * p.rows_per_block;
  const int r1 = min(p.R, r0 + p.rows_per_block);
  for (int r = r0 + ty; r < r1; r += ty_n) {
    const size_t off = static_cast<size_t>(r) * p.C + c0;
    float f[VEC];
    load8<T, VECTOR>(x + off, n, f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float v = fmaf(f[i] - m[i], sc[i], b[i]);
      if (p.act) v = fmaxf(v, 0.f);
      f[i] = v;
    }
    store8<T, VECTOR>(y + off, n, f);
  }
}

// The grid of the statistics and normalize passes for [R, C]: a block
// holds 1 << tx_log2 channel groups of VEC (up to 32 groups, 256
// channels) by THREADS >> tx_log2 rows a sweep, and `chunks` blocks side
// by side cover C; the rows are split in whole sweeps so that about
// TARGET_BLOCKS blocks run.
struct Split {
  int tx_log2, chunks, row_blocks, rows_per_block;
};

Split split(int R, int C) {
  Split s;
  const int groups = (C + VEC - 1) / VEC;
  s.tx_log2 = 0;
  while ((1 << s.tx_log2) < groups && (1 << s.tx_log2) < 32) ++s.tx_log2;
  s.chunks = (groups + (1 << s.tx_log2) - 1) >> s.tx_log2;
  const long long sweep = THREADS >> s.tx_log2;
  const long long want = s.chunks < TARGET_BLOCKS ? TARGET_BLOCKS / s.chunks
                                                  : 1;
  long long rows = (R + want - 1) / want;
  rows = (rows + sweep - 1) / sweep * sweep;
  s.rows_per_block = static_cast<int>(rows);
  s.row_blocks = static_cast<int>((R + rows - 1) / rows);
  return s;
}

template <typename T, bool VECTOR>
cudaError_t launch(const Params& p, int chunks, cudaStream_t stream) {
  dim3 grid(p.row_blocks, chunks);
  norm_stats_kernel<T, VECTOR><<<grid, THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 fin_grid((p.C + FIN_C - 1) / FIN_C);
  norm_finalize_kernel<<<fin_grid, dim3(FIN_C, FIN_B), 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  norm_apply_kernel<T, VECTOR><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_vector(const Params& p, int chunks, bool vector,
                            cudaStream_t stream) {
  return vector ? launch<T, true>(p, chunks, stream)
                : launch<T, false>(p, chunks, stream);
}

}  // namespace

extern "C" {

// Rows of the f32 scratch that fused_norm_act takes for [R, C]: the row
// blocks' sums and sums of squares, then the shift row,
// 2 * row_blocks + 1; 0 for R or C below 1.
int fused_norm_scratch_rows(int R, int C) {
  if (R <= 0 || C <= 0) return 0;
  return 2 * split(R, C).row_blocks + 1;
}

// x, y: [R, C] contiguous in dtype (0 = float32, 1 = bfloat16,
// 2 = float16); gamma, beta, mean, var: [C] f32; partial: an f32 scratch
// of fused_norm_scratch_rows(R, C) rows of C. Returns the cudaError_t of
// the launches.
int fused_norm_act(const void* x, const float* gamma, const float* beta,
                   void* y, float* mean, float* var, float* partial, int R,
                   int C, int dtype, float eps, int act, void* stream) {
  if (R <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Split s = split(R, C);
  if (s.chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, y, gamma, beta, mean, var, partial, R, C,
           s.row_blocks, s.rows_per_block, s.tx_log2, eps, act};
  const bool vector = C % VEC == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = dispatch_vector<float>(p, s.chunks, vector, st); break;
    case 1:
      err = dispatch_vector<__nv_bfloat16>(p, s.chunks, vector, st);
      break;
    case 2: err = dispatch_vector<__half>(p, s.chunks, vector, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* fused_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
