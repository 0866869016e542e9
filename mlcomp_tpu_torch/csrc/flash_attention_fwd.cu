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
// What the design does about that bound: the [T, T] scores never leave
// registers. One block of 4 warps owns 128 query rows of one (b, h) (64
// for D = 128) and loops over 64-row K/V tiles in shared memory,
// stopping at the last tile the causal mask leaves live (the TPU's
// pl.when skip and clamped index maps become a loop bound; a warp skips
// a tile that is dead for all its rows). Both products run on the
// tensor cores with mma.sync m16n8k16 (bf16 or fp16 in, f32
// accumulate); each warp holds 32 query rows (16 for D = 128), so each
// K/V fragment it reads from shared memory feeds two MMAs. The S
// accumulator fragments are re-packed in registers as the A operand of
// the PV product, so P never touches shared memory. K/V tiles arrive by
// cp.async into two stages, the next tile's copy overlapping this
// tile's math, zero-filled past T, so any T works (no T % 128 rule).
// wgmma/TMA and warp specialisation are later work.
//
// A plain SIMT path serves f32 inputs (f32 exports): the same tiling
// idea with 32-row Q tiles, 16-row K/V tiles and f32 FMAs outside the
// tensor cores.
//
// C interface (bound with ctypes): flash_attention_fwd(...) returns the
// cudaError_t of the launch as an int; 0 means launched. It takes a
// positive scale: the row max is found on unscaled scores, so the
// wrapper moves a negative scale's sign onto q. The helpers it shares
// with the backward live in flash_common.cuh.

#include "flash_common.cuh"

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

// ------------------------------------------------------------------ MMA path
constexpr int MMA_BLOCK_N = 64;  // key rows per K/V tile
constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = MMA_WARPS * 32;

// m16 row tiles per warp: two for D <= 64, so every K/V fragment read
// from shared memory feeds two MMAs (one would leave ldmatrix traffic
// capping the tensor cores near half rate); one for D = 128, where two
// would not fit the registers
template <int D>
__host__ __device__ constexpr int m_tiles() { return D <= 64 ? 2 : 1; }

template <int D>
__host__ __device__ constexpr int block_m() {
  return MMA_WARPS * 16 * m_tiles<D>();
}

template <int D>
__host__ __device__ constexpr int mma_smem_bytes(int elem) {
  // Q tile + two stages of K and V
  return (block_m<D>() + 4 * MMA_BLOCK_N) * (D + SMEM_PAD) * elem;
}

template <typename T, int D>
__global__ void __launch_bounds__(MMA_THREADS)
    fa_fwd_mma_kernel(const Params p) {
  constexpr int MT = m_tiles<D>();
  constexpr int BLOCK_M = block_m<D>();
  constexpr int LD = D + SMEM_PAD;
  constexpr int TILE = MMA_BLOCK_N * LD;    // elements of one K or V stage
  constexpr int N_TILES = MMA_BLOCK_N / 8;  // n8 tiles of S per m16 tile
  constexpr int D_TILES = D / 8;            // n8 tiles of O per m16 tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BLOCK_M * LD;  // [2][TILE]
  T* Vs = Ks + 2 * TILE;      // [2][TILE]

  // causal q-tiles late in the sequence carry the most k-tiles: start
  // them first so the short ones fill the tail of the grid
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = q_tile * BLOCK_M;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row group
  const int tq = lane % 4;  // thread within the group
  const int wrow0 = q0 + warp * 16 * MT;  // the warp's first query row

  const int kv_end = p.causal ? min(p.T, q0 + BLOCK_M) : p.T;
  const int n_k_tiles = (kv_end + MMA_BLOCK_N - 1) / MMA_BLOCK_N;

  // copy groups in flight: Q, then K/V tile 0 (stage 0)
  load_rows<T, D, BLOCK_M, MMA_THREADS>(Qs, qg, p.q_st, q0, p.T);
  cp_async_commit();
  load_rows<T, D, MMA_BLOCK_N, MMA_THREADS>(Ks, kg, p.k_st, 0, p.T);
  load_rows<T, D, MMA_BLOCK_N, MMA_THREADS>(Vs, vg, p.v_st, 0, p.T);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // this warp's 16 * MT query rows as A fragments, kept in registers
  uint32_t qf[MT][D / 16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldmatrix_x4(qf[mt][kk], Qs + (warp * 16 * MT + mt * 16 + (lane % 16)) * LD +
                                  kk * 16 + (lane / 16) * 8);

  float o[MT][D_TILES][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < D_TILES; ++n)
      o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  // per m16 tile, rows g and g + 8; m in log2 units
  float m_r[MT][2], l_r[MT][2];  // l: this thread's share of the row sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_r[mt][0] = m_r[mt][1] = NEG_INF;
    l_r[mt][0] = l_r[mt][1] = 0.f;
  }
  const float scale_log2 = p.scale * LOG2E;

  for (int kt = 0; kt < n_k_tiles; ++kt) {
    const int k0 = kt * MMA_BLOCK_N;
    const T* Kc = Ks + (kt & 1) * TILE;
    const T* Vc = Vs + (kt & 1) * TILE;
    // prefetch the next K/V tile into the other stage while this one
    // is used (that stage was freed by the barrier ending iteration
    // kt - 1)
    if (kt + 1 < n_k_tiles) {
      load_rows<T, D, MMA_BLOCK_N, MMA_THREADS>(Ks + ((kt + 1) & 1) * TILE, kg, p.k_st,
                                   k0 + MMA_BLOCK_N, p.T);
      load_rows<T, D, MMA_BLOCK_N, MMA_THREADS>(Vs + ((kt + 1) & 1) * TILE, vg, p.v_st,
                                   k0 + MMA_BLOCK_N, p.T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // causal: a warp whose rows all precede this tile has nothing live
    // in it (its other warps may)
    if (!p.causal || k0 <= wrow0 + 16 * MT - 1) {
      // S = Q K^T, f32 accumulators; each K fragment feeds MT tiles
      float s[MT][N_TILES][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < N_TILES; ++n)
          s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < N_TILES / 2; ++np) {
          uint32_t bfrag[4];
          ldmatrix_x4(bfrag, Kc + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD +
                                 kk * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            Mma<T>::run(s[mt][2 * np], qf[mt][kk], bfrag[0], bfrag[1]);
            Mma<T>::run(s[mt][2 * np + 1], qf[mt][kk], bfrag[2], bfrag[3]);
          }
        }
      }

      // mask the causal diagonal and the ragged end of the sequence
      // (on the unscaled scores)
      const bool need_mask =
          (k0 + MMA_BLOCK_N > p.T) ||
          (p.causal && k0 + MMA_BLOCK_N - 1 > wrow0);
      if (need_mask) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int row0 = wrow0 + mt * 16 + g;
#pragma unroll
          for (int n = 0; n < N_TILES; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kc = k0 + n * 8 + tq * 2 + (e & 1);
              const int qr = e < 2 ? row0 : row0 + 8;
              if (kc >= p.T || (p.causal && kc > qr)) s[mt][n][e] = NEG_INF;
            }
          }
        }
      }

      // online softmax in log2 units: the max is taken on the unscaled
      // scores (the scale is positive, so it keeps their order), then
      // one FFMA and one ex2 per score; masked scores come out 0
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int n = 0; n < N_TILES; ++n) {
          mx[0] = fmaxf(mx[0], fmaxf(s[mt][n][0], s[mt][n][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[mt][n][2], s[mt][n][3]));
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          mx[i] = fmaxf(m_r[mt][i], mx[i] * scale_log2);
        }
        const float corr[2] = {fast_exp2(m_r[mt][0] - mx[0]),
                               fast_exp2(m_r[mt][1] - mx[1])};
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < N_TILES; ++n) {
          s[mt][n][0] = fast_exp2(fmaf(s[mt][n][0], scale_log2, -mx[0]));
          s[mt][n][1] = fast_exp2(fmaf(s[mt][n][1], scale_log2, -mx[0]));
          s[mt][n][2] = fast_exp2(fmaf(s[mt][n][2], scale_log2, -mx[1]));
          s[mt][n][3] = fast_exp2(fmaf(s[mt][n][3], scale_log2, -mx[1]));
          rs[0] += s[mt][n][0] + s[mt][n][1];
          rs[1] += s[mt][n][2] + s[mt][n][3];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l_r[mt][i] = l_r[mt][i] * corr[i] + rs[i];
          m_r[mt][i] = mx[i];
        }
#pragma unroll
        for (int n = 0; n < D_TILES; ++n) {
          o[mt][n][0] *= corr[0];
          o[mt][n][1] *= corr[0];
          o[mt][n][2] *= corr[1];
          o[mt][n][3] *= corr[1];
        }
      }

      // O += P V: P rounded to V's dtype, straight from the S fragments;
      // each V fragment feeds MT tiles
#pragma unroll
      for (int kk = 0; kk < MMA_BLOCK_N / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          a[mt][0] = Mma<T>::pack(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          a[mt][1] = Mma<T>::pack(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          a[mt][2] = Mma<T>::pack(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          a[mt][3] = Mma<T>::pack(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < D_TILES / 2; ++dp) {
          uint32_t bfrag[4];
          ldmatrix_x4_trans(bfrag,
                            Vc + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD +
                                dp * 16 + (lane / 16) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            Mma<T>::run(o[mt][2 * dp], a[mt], bfrag[0], bfrag[1]);
            Mma<T>::run(o[mt][2 * dp + 1], a[mt], bfrag[2], bfrag[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

  // finalise: whole-row sums, divide, write in the input dtype
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_r[mt][i] += __shfl_xor_sync(0xffffffffu, l_r[mt][i], 1);
      l_r[mt][i] += __shfl_xor_sync(0xffffffffu, l_r[mt][i], 2);
    }
    const float norm0 = fmaxf(l_r[mt][0], 1e-30f);
    const float norm1 = fmaxf(l_r[mt][1], 1e-30f);
    const int row0 = wrow0 + mt * 16 + g;
    const int row1 = row0 + 8;
    if (p.lse != nullptr && tq == 0) {
      // m is in log2 units of the scaled scores: lse = (m + log2 l) ln 2
      float* lg = p.lse + (static_cast<int64_t>(b) * p.H + h) * p.T;
      if (row0 < p.T) lg[row0] = (m_r[mt][0] + log2f(norm0)) * LN2;
      if (row1 < p.T) lg[row1] = (m_r[mt][1] + log2f(norm1)) * LN2;
    }
#pragma unroll
    for (int n = 0; n < D_TILES; ++n) {
      const int col = n * 8 + tq * 2;
      if (row0 < p.T)
        *reinterpret_cast<uint32_t*>(og + row0 * p.o_st + col) =
            Mma<T>::pack(o[mt][n][0] / norm0, o[mt][n][1] / norm0);
      if (row1 < p.T)
        *reinterpret_cast<uint32_t*>(og + row1 * p.o_st + col) =
            Mma<T>::pack(o[mt][n][2] / norm1, o[mt][n][3] / norm1);
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
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>(sizeof(T));
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = opt_in_smem(fa_fwd_mma_kernel<T, D>, smem, opted_in);
  if (err != cudaSuccess) return err;
  dim3 grid((p.T + block_m<D>() - 1) / block_m<D>(), p.B * p.H);
  fa_fwd_mma_kernel<T, D><<<grid, MMA_THREADS, smem, stream>>>(p);
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
    case 1: return launch_mma<__nv_bfloat16, D>(p, stream);
    case 2: return launch_mma<__half, D>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Strides in elements;
// the head_dim stride must be 1. lse: a contiguous [B, H, T] f32 output,
// or null for none. Returns the cudaError_t of the launch.
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
