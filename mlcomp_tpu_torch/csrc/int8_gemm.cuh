// The weight-only tile product shared by int8_matmul.cu and
// serving_stack.cu: acc += x[m0:m0+BM, k0:k1] @ w[n0:n0+BN, k0:k1]^T with
// x bf16 [M, K] row-major and w [N, K] row-major in int8 (the transposed
// layout of quantize_int8) or bf16.
//
// x and w tiles arrive by 16-byte cp.async into a ring of STAGES shared
// memory stages; w's [N, K] rows are already the "col" B operand of
// mma.sync m16n8k16.row.col, so a thread reads its two consecutive K
// values of one output channel straight from shared memory and, for
// int8, converts them to bf16 there, exactly (|v| <= 127 needs 7 bits of
// bf16's 8), by byte permutes and one add (b_pair). Products run on the
// tensor cores in bf16 with f32 accumulation. Rows past M or N and
// columns past k1 are zero-filled, so any M, N, K >= 1 work: with K a
// multiple of 16 (8 for bf16 weights) and 16-byte aligned bases the
// copies are whole 16-byte chunks ("vec"), otherwise a scalar path loads
// element by element through L2.
#pragma once

#include "flash_common.cuh"

namespace wq {

using namespace flash;
using bf16 = __nv_bfloat16;

// (w[n][k], w[n][k + 1]) as the bf16x2 of a B fragment register, without
// the conversion unit (I2F runs at a quarter of the ALU rate): each byte,
// biased by 128, goes into the mantissa of 2^23 (f32 2^23 + b + 128), one
// FADD takes 2^23 + 128 off (exact: b itself), and as |b| <= 128 has at
// most 8 significant bits, the f32's top 16 bits are its bf16.
constexpr float INT8_MAGIC = 8388736.f;  // 2^23 + 128
__device__ __forceinline__ uint32_t b_pair(const int8_t* p) {
  const uint32_t u =
      static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) ^ 0x8080u;
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) -
                   INT8_MAGIC;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) -
                   INT8_MAGIC;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ uint32_t b_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// one element through L2 (no L1: a grid barrier's other blocks may have
// written it since this SM last read the line)
__device__ __forceinline__ bf16 load_l2(const bf16* p) {
  const unsigned short u =
      __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __ushort_as_bfloat16(u);
}

__device__ __forceinline__ int8_t load_l2(const int8_t* p) {
  return __ldcg(reinterpret_cast<const signed char*>(p));
}

template <typename WT>
__device__ __forceinline__ WT zero_of();
template <>
__device__ __forceinline__ bf16 zero_of<bf16>() {
  return __float2bfloat16_rn(0.f);
}
template <>
__device__ __forceinline__ int8_t zero_of<int8_t>() {
  return 0;
}

// Store the column pair (col, col + 1) of one output row, masked to
// [M, N]; `ld` is the row stride in floats. `pair` = both columns may go
// as one 8-byte store (an even ld).
__device__ __forceinline__ void store_pair(float* out, int64_t ld, int M,
                                           int N, int row, int col, float v0,
                                           float v1, bool pair) {
  if (row >= M) return;
  float* p = out + row * ld + col;
  if (pair && col + 1 < N) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    return;
  }
  if (col < N) p[0] = v0;
  if (col + 1 < N) p[1] = v1;
}

// PROMOTE: each K tile's products accumulate from zero and are then
// added to the f32 sums with ordinary (round-to-nearest) adds. The tensor
// cores' own f32 accumulation drops low bits at each step, an error that
// grows with K (about 3e-6 of a row at K = 8192 when it runs the whole
// sum); the promotion costs a second accumulator's registers.
template <typename WT, int BM, int BN, int BK, int WARPS_M, int WARPS_N,
          int STAGES, bool PROMOTE = true>
struct Tile {
  static constexpr int TILE_M = BM, TILE_N = BN, TILE_K = BK;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M;  // rows of a warp
  static constexpr int WN = BN / WARPS_N;  // columns of a warp
  static constexpr int MT = WM / 16;       // m16 tiles of a warp
  static constexpr int NT = WN / 8;        // n8 tiles of a warp
  static constexpr int LDX = BK + SMEM_PAD;            // bf16 per x row
  static constexpr int W_VEC = 16 / sizeof(WT);        // WT per 16 bytes
  static constexpr int LDW = BK + W_VEC;               // WT per w row
  static constexpr int X_STAGE = BM * LDX;
  static constexpr int W_STAGE = BN * LDW;
  static constexpr int SMEM_BYTES =
      STAGES * (X_STAGE * static_cast<int>(sizeof(bf16)) +
                W_STAGE * static_cast<int>(sizeof(WT)));
  static constexpr int X_CHUNKS = BK / 8;      // 16-byte chunks per x row
  static constexpr int W_CHUNKS = BK / W_VEC;  // 16-byte chunks per w row
  static_assert(WM % 16 == 0 && WN % 8 == 0 && BK % 16 == 0, "tile shape");

  using Acc = float[MT][NT][4];

  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }

  // the x and w tiles of K offset k into one stage; columns at or past
  // kend (and rows past M or N) are zeros
  __device__ static void load(bf16* xs, WT* ws, const bf16* x, const WT* w,
                              int M, int N, int K, int m0, int n0, int k,
                              int kend, bool vec) {
    if (vec) {
      for (int c = threadIdx.x; c < BM * X_CHUNKS; c += THREADS) {
        const int r = c / X_CHUNKS, kc = (c % X_CHUNKS) * 8;
        const int row = m0 + r, col = k + kc;
        const bool valid = row < M && col < kend;
        cp_async16(xs + r * LDX + kc,
                   valid ? x + static_cast<int64_t>(row) * K + col : x,
                   valid);
      }
      for (int c = threadIdx.x; c < BN * W_CHUNKS; c += THREADS) {
        const int r = c / W_CHUNKS, kc = (c % W_CHUNKS) * W_VEC;
        const int n = n0 + r, col = k + kc;
        const bool valid = n < N && col < kend;
        cp_async16(ws + r * LDW + kc,
                   valid ? w + static_cast<int64_t>(n) * K + col : w, valid);
      }
      return;
    }
    for (int c = threadIdx.x; c < BM * BK; c += THREADS) {
      const int r = c / BK, kc = c % BK;
      const int row = m0 + r, col = k + kc;
      xs[r * LDX + kc] = row < M && col < kend
                             ? load_l2(x + static_cast<int64_t>(row) * K + col)
                             : zero_of<bf16>();
    }
    for (int c = threadIdx.x; c < BN * BK; c += THREADS) {
      const int r = c / BK, kc = c % BK;
      const int n = n0 + r, col = k + kc;
      ws[r * LDW + kc] = n < N && col < kend
                             ? load_l2(w + static_cast<int64_t>(n) * K + col)
                             : zero_of<WT>();
    }
  }

  // the warp's products over one stage
  __device__ static void compute(const bf16* xs, const WT* ws, Acc& acc,
                                 int wm, int wn, int lane) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], xs + (wm * WM + mt * 16 + (lane % 16)) * LDX +
                               kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const WT* wr = ws + (wn * WN + nt * 8 + lane / 4) * LDW + kk * 16 +
                       (lane % 4) * 2;
        const uint32_t b0 = b_pair(wr), b1 = b_pair(wr + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          Mma<bf16>::run(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }

  // acc += x[m0:, k0:k1] @ w[n0:, k0:k1]^T over the whole block; the
  // shared memory is free again when it returns
  __device__ static void run(const bf16* x, const WT* w, int M, int N, int K,
                             int m0, int n0, int k0, int k1, bool vec,
                             char* smem, Acc& acc) {
    bf16* xs = reinterpret_cast<bf16*>(smem);
    WT* ws = reinterpret_cast<WT*>(smem + STAGES * X_STAGE * sizeof(bf16));
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
    const int n_k = (k1 - k0 + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_k)
        load(xs + s * X_STAGE, ws + s * W_STAGE, x, w, M, N, K, m0, n0,
             k0 + s * BK, k1, vec);
      cp_async_commit();
    }
    for (int kt = 0; kt < n_k; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int next = kt + STAGES - 1;
      if (next < n_k) {
        const int st = next % STAGES;
        load(xs + st * X_STAGE, ws + st * W_STAGE, x, w, M, N, K, m0, n0,
             k0 + next * BK, k1, vec);
      }
      cp_async_commit();
      const int st = kt % STAGES;
      if constexpr (PROMOTE) {
        Acc part;
        zero(part);
        compute(xs + st * X_STAGE, ws + st * W_STAGE, part, wm, wn, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
      } else {
        compute(xs + st * X_STAGE, ws + st * W_STAGE, acc, wm, wn, lane);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // f(row, col, v0, v1) for each accumulator pair: columns col, col + 1
  // of one row
  template <typename F>
  __device__ static void for_each(const Acc& acc, int m0, int n0, F f) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          f(m0 + wm * WM + mt * 16 + lane / 4 + h * 8,
            n0 + wn * WN + nt * 8 + (lane % 4) * 2, acc[mt][nt][2 * h],
            acc[mt][nt][2 * h + 1]);
  }
};

// whole 16-byte chunks: K a multiple of the weight's 16-byte chunk (and
// of x's 8 bf16) and both bases 16-byte aligned
template <typename WT>
inline bool vec_ok(const void* x, const void* w, int K) {
  return K % (16 / sizeof(WT)) == 0 && K % 8 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

// streaming multiprocessors of the current device, read once per device
inline int sm_count() {
  static std::atomic<int> counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  int n = counts[dev].load(std::memory_order_relaxed);
  if (n <= 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        n <= 0)
      n = 132;
    counts[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

}  // namespace wq
