// Flash-attention backward for Hopper (sm_90a), written by hand.
//
// Replaces: the Pallas TPU kernels `_fa_bwd_dq_kernel` (:309) and
// `_fa_bwd_dkv_kernel` (:336) of mlcomp_tpu/ops/flash_attention.py,
// launched by `flash_attention_backward` (:368; calls at :403 and :425),
// with their shared numerics `_recompute_p_ds` (:278).
//
// Computes, for each (b, h), from q, k, v, dO of shape [B, T, H, D] (read
// through their strides), the forward's row logsumexp lse [B, H, T] and
// delta = rowsum(dO * O) [B, H, T] (both f32, contiguous):
//   P  = exp(scale * Q K^T - lse)      (0 where the causal mask or the
//                                        ragged end hides a pair)
//   dS = P * (dO V^T - delta)
//   dQ = dS K * scale,  dK = dS^T Q * scale,  dV = P^T dO
// written as fresh contiguous [B, T, H, D] tensors in the input dtype.
// Numerics follow the TPU kernels: both score products accumulate in f32,
// P and dS are rounded to the input dtype before the gradient products
// (f32 accumulation), and the scale is applied after the dQ and dK
// products, once, to the f32 sums.
//
// Two kernels, as on the TPU, so that no two blocks write one output row
// and no atomics are needed (the gradients are deterministic):
// - dq: a block owns 128 query rows (64 for D = 128) and loops over the
//   64-row K/V tiles up to the last one the causal mask leaves live
//   (`_last_live_k`, :147);
// - dkv: a block owns 128 key rows (64 for D = 128) and loops over the
//   64-row Q/dO tiles from the first live one (`_first_live_q`, :156) to
//   the end.
//
// Bound on the card (H100 SXM): five products of 2*D FLOPs for every live
// (query, key) pair (S and dP in both kernels would be seven; the least
// work recomputes S once: S, dP, dQ, dK, dV), against 989 TFLOP/s in
// bf16/fp16; bytes of q, k, v, O, dO, lse, delta read and dq, dk, dv
// written, against 3.35 TB/s. At the flagship's training shape (B=1,
// T=8192, H=16, D=64, causal, bf16) that is 3.4e11 FLOPs against
// 1.3e8 bytes: the tensor cores bound it. This design recomputes S and
// dP in both kernels (7 products per pair instead of 5), the price of
// needing no atomics.
//
// What the design does about that bound: the [T, T] P and dS tiles never
// leave registers. Each warp owns 32 rows (16 for D = 128: registers),
// so each fragment of the streamed tile feeds two MMAs; all five
// products run on the tensor cores with mma.sync m16n8k16 (bf16 or fp16
// in, f32 accumulate),
// and the S/dP accumulator fragments are re-packed in registers as the A
// operand of the gradient products, rounded to the input dtype there. The
// streamed tiles (K/V for dq, Q/dO with their lse/delta rows for dkv)
// arrive by cp.async into two stages, the next tile's copy overlapping
// this tile's math, zero-filled past T, so any T works. A warp skips a
// tile (or pass) that is dead for all its rows. wgmma/TMA and
// warp specialisation are later work.
//
// A plain SIMT path serves f32 inputs: the same two kernels with 32-row
// blocks, 8-row streamed tiles and f32 FMAs outside the tensor cores.
//
// C interface (bound with ctypes): flash_attention_bwd_dq(...) and
// flash_attention_bwd_dkv(...) each launch one kernel and return its
// cudaError_t as an int; 0 means launched. Like the forward they take a
// positive scale for the scores; `dq_scale` multiplies the dQ sums (the
// wrapper passes the caller's own scale there, which undoes its moving a
// negative scale's sign onto q).

#include "flash_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, T]
  const float* delta;  // [B, H, T]
  void* dq;            // [B, T, H, D], contiguous
  void* dk;
  void* dv;
  int B, T, H;
  int64_t q_sb, q_st, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t do_sb, do_st, do_sh;
  float scale;
  float dq_scale;
  int causal;
};

// ------------------------------------------------------------------ MMA path
constexpr int BLOCK = 64;  // rows of a streamed tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// m16 row tiles per warp: two for D <= 64, so every K and V fragment
// (dq) or Q and dO fragment (dk/dv) read from shared memory feeds two
// MMAs; one for D = 128, where two would not fit the registers. The
// dk/dv kernel walks each 64-query tile in MT passes, which keeps its
// S^T and dP^T accumulators at one tile's size.
template <int D>
__host__ __device__ constexpr int dq_m_tiles() { return D <= 64 ? 2 : 1; }

template <int D>
__host__ __device__ constexpr int dkv_m_tiles() { return D <= 64 ? 2 : 1; }

template <int D>
__host__ __device__ constexpr int dq_block_m() {
  return WARPS * 16 * dq_m_tiles<D>();
}

template <int D>
__host__ __device__ constexpr int dkv_block_n() {
  return WARPS * 16 * dkv_m_tiles<D>();
}

template <int D>
__host__ __device__ constexpr int dq_smem_bytes(int elem) {
  // Q and dO tiles, two stages of K and V
  return (2 * dq_block_m<D>() + 4 * BLOCK) * (D + SMEM_PAD) * elem;
}

template <int D>
__host__ __device__ constexpr int dkv_smem_bytes(int elem) {
  // K and V, two stages of Q and dO, two stages of their lse and delta
  return (2 * dkv_block_n<D>() + 4 * BLOCK) * (D + SMEM_PAD) * elem +
         4 * BLOCK * 4;
}

// dQ for dq_block_m<D>() query rows of one (b, h)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    fa_bwd_dq_mma_kernel(const Params p) {
  constexpr int MT = dq_m_tiles<D>();
  constexpr int BLOCK_M = dq_block_m<D>();
  constexpr int LD = D + SMEM_PAD;
  constexpr int TILE = BLOCK * LD;    // elements of one K or V stage
  constexpr int N_TILES = BLOCK / 8;  // n8 tiles of S per m16 tile
  constexpr int D_TILES = D / 8;      // n8 tiles of dQ per m16 tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + BLOCK_M * LD;
  T* Ks = dOs + BLOCK_M * LD;  // [2][TILE]
  T* Vs = Ks + 2 * TILE;       // [2][TILE]

  // causal q-tiles late in the sequence carry the most k-tiles: start
  // them first so the short ones fill the tail of the grid
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = q_tile * BLOCK_M;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int64_t row_stats = (static_cast<int64_t>(b) * p.H + h) * p.T;
  const int64_t o_st = static_cast<int64_t>(p.H) * D;
  T* dqg = static_cast<T*>(p.dq) + b * p.T * o_st + h * D;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row group
  const int tq = lane % 4;  // thread within the group
  const int wrow0 = q0 + warp * 16 * MT;  // the warp's first query row

  const int kv_end = p.causal ? min(p.T, q0 + BLOCK_M) : p.T;
  const int n_k_tiles = (kv_end + BLOCK - 1) / BLOCK;

  // copy groups in flight: Q and dO, then K/V tile 0 (stage 0)
  load_rows<T, D, BLOCK_M, THREADS>(Qs, qg, p.q_st, q0, p.T);
  load_rows<T, D, BLOCK_M, THREADS>(dOs, dog, p.do_st, q0, p.T);
  cp_async_commit();
  load_rows<T, D, BLOCK, THREADS>(Ks, kg, p.k_st, 0, p.T);
  load_rows<T, D, BLOCK, THREADS>(Vs, vg, p.v_st, 0, p.T);
  cp_async_commit();

  // this thread's rows (g and g + 8 of each m16 tile): their lse in log2
  // units, and delta (rows past T read 0; they are never written)
  int rows[MT][2];
  float lse_r[MT][2], dl_r[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wrow0 + mt * 16 + g + 8 * i;
      rows[mt][i] = r;
      lse_r[mt][i] = r < p.T ? p.lse[row_stats + r] * LOG2E : 0.f;
      dl_r[mt][i] = r < p.T ? p.delta[row_stats + r] : 0.f;
    }
  }
  const float scale_log2 = p.scale * LOG2E;

  float dq[MT][D_TILES][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < D_TILES; ++n)
      dq[mt][n][0] = dq[mt][n][1] = dq[mt][n][2] = dq[mt][n][3] = 0.f;

  for (int kt = 0; kt < n_k_tiles; ++kt) {
    const int k0 = kt * BLOCK;
    const T* Kc = Ks + (kt & 1) * TILE;
    const T* Vc = Vs + (kt & 1) * TILE;
    // prefetch the next K/V tile into the other stage (freed by the
    // barrier that ended iteration kt - 1)
    if (kt + 1 < n_k_tiles) {
      load_rows<T, D, BLOCK, THREADS>(Ks + ((kt + 1) & 1) * TILE, kg, p.k_st,
                                      k0 + BLOCK, p.T);
      load_rows<T, D, BLOCK, THREADS>(Vs + ((kt + 1) & 1) * TILE, vg, p.v_st,
                                      k0 + BLOCK, p.T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // causal: a warp whose rows all precede this tile has nothing live
    // in it (its other warps may)
    if (!p.causal || k0 <= wrow0 + 16 * MT - 1) {
      // S = Q K^T and dP = dO V^T, f32 accumulators; each K and V
      // fragment feeds MT tiles
      float s[MT][N_TILES][4], dp[MT][N_TILES][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < N_TILES; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] = dp[mt][n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[MT][4], da[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int a_off = (warp * 16 * MT + mt * 16 + (lane % 16)) * LD +
                            kk * 16 + (lane / 16) * 8;
          ldmatrix_x4(qa[mt], Qs + a_off);
          ldmatrix_x4(da[mt], dOs + a_off);
        }
#pragma unroll
        for (int np = 0; np < N_TILES / 2; ++np) {
          const int b_off = (np * 16 + (lane % 8) + (lane / 16) * 8) * LD +
                            kk * 16 + ((lane / 8) % 2) * 8;
          uint32_t kb[4], vb[4];
          ldmatrix_x4(kb, Kc + b_off);
          ldmatrix_x4(vb, Vc + b_off);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            Mma<T>::run(s[mt][2 * np], qa[mt], kb[0], kb[1]);
            Mma<T>::run(s[mt][2 * np + 1], qa[mt], kb[2], kb[3]);
            Mma<T>::run(dp[mt][2 * np], da[mt], vb[0], vb[1]);
            Mma<T>::run(dp[mt][2 * np + 1], da[mt], vb[2], vb[3]);
          }
        }
      }

      // P = exp(scale * S - lse), one FFMA and one ex2 per score; 0 on
      // the causal triangle and past T; dS = P (dP - delta), into s
      const bool need_mask =
          (k0 + BLOCK > p.T) || (p.causal && k0 + BLOCK - 1 > wrow0);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < N_TILES; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e / 2;  // row g or g + 8
            float pe = fast_exp2(fmaf(s[mt][n][e], scale_log2, -lse_r[mt][i]));
            const int kc = k0 + n * 8 + tq * 2 + (e & 1);
            if (need_mask && (kc >= p.T || (p.causal && kc > rows[mt][i])))
              pe = 0.f;
            s[mt][n][e] = pe * (dp[mt][n][e] - dl_r[mt][i]);
          }
        }
      }

      // dQ += dS K: dS rounded to the input dtype straight from the
      // accumulator fragments; K read transposed as the B operand, each
      // fragment feeding MT tiles
#pragma unroll
      for (int kk = 0; kk < BLOCK / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          a[mt][0] = Mma<T>::pack(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          a[mt][1] = Mma<T>::pack(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          a[mt][2] = Mma<T>::pack(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          a[mt][3] = Mma<T>::pack(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int dc = 0; dc < D / 16; ++dc) {
          uint32_t kb[4];
          ldmatrix_x4_trans(kb, Kc + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD +
                                    dc * 16 + (lane / 16) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            Mma<T>::run(dq[mt][2 * dc], a[mt], kb[0], kb[1]);
            Mma<T>::run(dq[mt][2 * dc + 1], a[mt], kb[2], kb[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < D_TILES; ++n) {
      const int col = n * 8 + tq * 2;
      if (rows[mt][0] < p.T)
        *reinterpret_cast<uint32_t*>(dqg + rows[mt][0] * o_st + col) =
            Mma<T>::pack(dq[mt][n][0] * p.dq_scale, dq[mt][n][1] * p.dq_scale);
      if (rows[mt][1] < p.T)
        *reinterpret_cast<uint32_t*>(dqg + rows[mt][1] * o_st + col) =
            Mma<T>::pack(dq[mt][n][2] * p.dq_scale, dq[mt][n][3] * p.dq_scale);
    }
  }
}

// dK and dV for dkv_block_n<D>() key rows of one (b, h)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    fa_bwd_dkv_mma_kernel(const Params p) {
  constexpr int MT = dkv_m_tiles<D>();
  constexpr int BLOCK_N = dkv_block_n<D>();
  constexpr int QW = BLOCK / MT;        // queries of one pass over a tile
  constexpr int LD = D + SMEM_PAD;
  constexpr int TILE = BLOCK * LD;      // elements of one Q or dO stage
  constexpr int N_TILES = QW / 8;       // n8 tiles of S^T per m16 tile
  constexpr int D_TILES = D / 8;        // n8 tiles of dK, dV per m16 tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BLOCK_N * LD;
  T* Qs = Vs + BLOCK_N * LD;  // [2][TILE]
  T* dOs = Qs + 2 * TILE;     // [2][TILE]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * TILE);  // [2][BLOCK]
  float* dl_s = lse_s + 2 * BLOCK;                          // [2][BLOCK]

  // causal: early key tiles meet the most q-tiles; they come first
  const int k_tile = blockIdx.x;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int k0 = k_tile * BLOCK_N;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int64_t row_stats = (static_cast<int64_t>(b) * p.H + h) * p.T;
  const float* lse_g = p.lse + row_stats;
  const float* dl_g = p.delta + row_stats;
  const int64_t o_st = static_cast<int64_t>(p.H) * D;
  T* dkg = static_cast<T*>(p.dk) + b * p.T * o_st + h * D;
  T* dvg = static_cast<T*>(p.dv) + b * p.T * o_st + h * D;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int wk0 = k0 + warp * 16 * MT;  // the warp's first key row
  int keys[MT][2];                        // this thread's key rows
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    keys[mt][0] = wk0 + mt * 16 + g;
    keys[mt][1] = keys[mt][0] + 8;
  }

  // the q-tile holding the block's first key: no earlier query sees any
  // of its keys
  const int first_qt = p.causal ? k0 / BLOCK : 0;
  const int n_q_tiles = (p.T + BLOCK - 1) / BLOCK;

  // copy groups in flight: K and V, then the first Q/dO tile (stage 0)
  load_rows<T, D, BLOCK_N, THREADS>(Ks, kg, p.k_st, k0, p.T);
  load_rows<T, D, BLOCK_N, THREADS>(Vs, vg, p.v_st, k0, p.T);
  cp_async_commit();
  load_rows<T, D, BLOCK, THREADS>(Qs, qg, p.q_st, first_qt * BLOCK, p.T);
  load_rows<T, D, BLOCK, THREADS>(dOs, dog, p.do_st, first_qt * BLOCK, p.T);
  load_floats<BLOCK, THREADS>(lse_s, lse_g, first_qt * BLOCK, p.T);
  load_floats<BLOCK, THREADS>(dl_s, dl_g, first_qt * BLOCK, p.T);
  cp_async_commit();

  const float scale_log2 = p.scale * LOG2E;
  float dk[MT][D_TILES][4], dv[MT][D_TILES][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < D_TILES; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[mt][n][e] = dv[mt][n][e] = 0.f;

  for (int qt = first_qt; qt < n_q_tiles; ++qt) {
    const int stage = (qt - first_qt) & 1;
    const T* Qc = Qs + stage * TILE;
    const T* dOc = dOs + stage * TILE;
    const float* lse_c = lse_s + stage * BLOCK;
    const float* dl_c = dl_s + stage * BLOCK;
    if (qt + 1 < n_q_tiles) {
      const int nxt = stage ^ 1;
      const int q1 = (qt + 1) * BLOCK;
      load_rows<T, D, BLOCK, THREADS>(Qs + nxt * TILE, qg, p.q_st, q1, p.T);
      load_rows<T, D, BLOCK, THREADS>(dOs + nxt * TILE, dog, p.do_st, q1, p.T);
      load_floats<BLOCK, THREADS>(lse_s + nxt * BLOCK, lse_g, q1, p.T);
      load_floats<BLOCK, THREADS>(dl_s + nxt * BLOCK, dl_g, q1, p.T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // the tile in passes of QW queries
#pragma unroll
    for (int pass = 0; pass < MT; ++pass) {
      const int c0 = pass * QW;        // the pass's first query in the tile
      const int q0 = qt * BLOCK + c0;
      // causal: a warp whose keys all follow these queries has nothing
      // live in them (its other warps may)
      if (p.causal && wk0 > q0 + QW - 1) continue;

      // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys,
      // columns the pass's queries; each Q and dO fragment feeds MT tiles
      float s[MT][N_TILES][4], dp[MT][N_TILES][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < N_TILES; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] = dp[mt][n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[MT][4], va[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int a_off = (warp * 16 * MT + mt * 16 + (lane % 16)) * LD +
                            kk * 16 + (lane / 16) * 8;
          ldmatrix_x4(ka[mt], Ks + a_off);
          ldmatrix_x4(va[mt], Vs + a_off);
        }
#pragma unroll
        for (int np = 0; np < N_TILES / 2; ++np) {
          const int b_off = (c0 + np * 16 + (lane % 8) + (lane / 16) * 8) * LD +
                            kk * 16 + ((lane / 8) % 2) * 8;
          uint32_t qb[4], ob[4];
          ldmatrix_x4(qb, Qc + b_off);
          ldmatrix_x4(ob, dOc + b_off);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            Mma<T>::run(s[mt][2 * np], ka[mt], qb[0], qb[1]);
            Mma<T>::run(s[mt][2 * np + 1], ka[mt], qb[2], qb[3]);
            Mma<T>::run(dp[mt][2 * np], va[mt], ob[0], ob[1]);
            Mma<T>::run(dp[mt][2 * np + 1], va[mt], ob[2], ob[3]);
          }
        }
      }

      // P^T into s, dS^T into dp; 0 where the query precedes the key
      // (causal) or lies past T
      const bool need_mask =
          (q0 + QW > p.T) || (p.causal && wk0 + 16 * MT - 1 > q0);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < N_TILES; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = c0 + n * 8 + tq * 2 + (e & 1);
            float pe = fast_exp2(fmaf(s[mt][n][e], scale_log2, -lse_c[qi] * LOG2E));
            const int qc = qt * BLOCK + qi;
            const int key = keys[mt][e / 2];
            if (need_mask && (qc >= p.T || (p.causal && key > qc)))
              pe = 0.f;
            s[mt][n][e] = pe;
            dp[mt][n][e] = pe * (dp[mt][n][e] - dl_c[qi]);
          }
        }
      }

      // dV += P^T dO and dK += dS^T Q: P and dS rounded to the input
      // dtype straight from the accumulator fragments; dO and Q read
      // transposed, each fragment feeding MT tiles
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk) {
        uint32_t pa[MT][4], sa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pa[mt][0] = Mma<T>::pack(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pa[mt][1] = Mma<T>::pack(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pa[mt][2] = Mma<T>::pack(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pa[mt][3] = Mma<T>::pack(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
          sa[mt][0] = Mma<T>::pack(dp[mt][2 * kk][0], dp[mt][2 * kk][1]);
          sa[mt][1] = Mma<T>::pack(dp[mt][2 * kk][2], dp[mt][2 * kk][3]);
          sa[mt][2] = Mma<T>::pack(dp[mt][2 * kk + 1][0], dp[mt][2 * kk + 1][1]);
          sa[mt][3] = Mma<T>::pack(dp[mt][2 * kk + 1][2], dp[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int dc = 0; dc < D / 16; ++dc) {
          const int t_off = (c0 + kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD +
                            dc * 16 + (lane / 16) * 8;
          uint32_t ob[4], qb[4];
          ldmatrix_x4_trans(ob, dOc + t_off);
          ldmatrix_x4_trans(qb, Qc + t_off);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            Mma<T>::run(dv[mt][2 * dc], pa[mt], ob[0], ob[1]);
            Mma<T>::run(dv[mt][2 * dc + 1], pa[mt], ob[2], ob[3]);
            Mma<T>::run(dk[mt][2 * dc], sa[mt], qb[0], qb[1]);
            Mma<T>::run(dk[mt][2 * dc + 1], sa[mt], qb[2], qb[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int key0 = keys[mt][0];
    const int key1 = keys[mt][1];
#pragma unroll
    for (int n = 0; n < D_TILES; ++n) {
      const int col = n * 8 + tq * 2;
      if (key0 < p.T) {
        *reinterpret_cast<uint32_t*>(dkg + key0 * o_st + col) =
            Mma<T>::pack(dk[mt][n][0] * p.scale, dk[mt][n][1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvg + key0 * o_st + col) =
            Mma<T>::pack(dv[mt][n][0], dv[mt][n][1]);
      }
      if (key1 < p.T) {
        *reinterpret_cast<uint32_t*>(dkg + key1 * o_st + col) =
            Mma<T>::pack(dk[mt][n][2] * p.scale, dk[mt][n][3] * p.scale);
        *reinterpret_cast<uint32_t*>(dvg + key1 * o_st + col) =
            Mma<T>::pack(dv[mt][n][2], dv[mt][n][3]);
      }
    }
  }
}

// ----------------------------------------------------------------- f32 path
constexpr int F32_ROWS = 32;  // rows a block owns
constexpr int F32_COLS = 8;   // rows of a streamed tile (static smem < 48 KB)
constexpr int F32_THREADS = 128;

// thread layout: row r = threadIdx.x / 4 of the block's rows, and the
// streamed rows qd and qd + 4 (qd = threadIdx.x % 4) of each tile; the
// gradient columns qd + 4c
template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    fa_bwd_dq_f32_kernel(const Params p) {
  constexpr int LD = D + 1;  // odd stride: row-wise reads hit distinct banks
  constexpr int COLS = D / 4;
  __shared__ float Qs[F32_ROWS][LD];
  __shared__ float dOs[F32_ROWS][LD];
  __shared__ float Ks[F32_COLS][LD];
  __shared__ float Vs[F32_COLS][LD];
  __shared__ float dSs[F32_ROWS][F32_COLS + 1];

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = q_tile * F32_ROWS;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int64_t row_stats = (static_cast<int64_t>(b) * p.H + h) * p.T;
  const int64_t o_st = static_cast<int64_t>(p.H) * D;
  float* dqg = static_cast<float*>(p.dq) + b * p.T * o_st + h * D;

  const int r = threadIdx.x / 4;
  const int qd = threadIdx.x % 4;
  const int row = q0 + r;

  for (int i = threadIdx.x; i < F32_ROWS * D; i += F32_THREADS) {
    const int rr = i / D, c = i % D;
    const int t = q0 + rr;
    Qs[rr][c] = t < p.T ? qg[t * p.q_st + c] : 0.f;
    dOs[rr][c] = t < p.T ? dog[t * p.do_st + c] : 0.f;
  }
  const float lse_r = row < p.T ? p.lse[row_stats + row] : 0.f;
  const float dl_r = row < p.T ? p.delta[row_stats + row] : 0.f;

  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;

  const int kv_end = p.causal ? min(p.T, q0 + F32_ROWS) : p.T;
  for (int k0 = 0; k0 < kv_end; k0 += F32_COLS) {
    __syncthreads();
    for (int i = threadIdx.x; i < F32_COLS * D; i += F32_THREADS) {
      const int rr = i / D, c = i % D;
      const int t = k0 + rr;
      Ks[rr][c] = t < p.T ? kg[t * p.k_st + c] : 0.f;
      Vs[rr][c] = t < p.T ? vg[t * p.v_st + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < F32_COLS / 4; ++i) {
      const int j = qd + 4 * i;
      float dot = 0.f, dpv = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        dot = fmaf(Qs[r][c], Ks[j][c], dot);
        dpv = fmaf(dOs[r][c], Vs[j][c], dpv);
      }
      const int kc = k0 + j;
      const float pe = (kc >= p.T || (p.causal && kc > row))
                           ? 0.f : expf(dot * p.scale - lse_r);
      dSs[r][j] = pe * (dpv - dl_r);
    }
    __syncwarp();  // the row's four threads share dSs[r]
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < F32_COLS; ++j)
        sum = fmaf(dSs[r][j], Ks[j][qd + 4 * c], sum);
      acc[c] += sum;
    }
    __syncwarp();
  }

  if (row < p.T) {
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      dqg[row * o_st + qd + 4 * c] = acc[c] * p.dq_scale;
  }
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    fa_bwd_dkv_f32_kernel(const Params p) {
  constexpr int LD = D + 1;
  constexpr int COLS = D / 4;
  __shared__ float Ks[F32_ROWS][LD];
  __shared__ float Vs[F32_ROWS][LD];
  __shared__ float Qs[F32_COLS][LD];
  __shared__ float dOs[F32_COLS][LD];
  __shared__ float Ps[F32_ROWS][F32_COLS + 1];
  __shared__ float dSs[F32_ROWS][F32_COLS + 1];
  __shared__ float lse_s[F32_COLS];
  __shared__ float dl_s[F32_COLS];

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int k0 = blockIdx.x * F32_ROWS;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int64_t row_stats = (static_cast<int64_t>(b) * p.H + h) * p.T;
  const int64_t o_st = static_cast<int64_t>(p.H) * D;
  float* dkg = static_cast<float*>(p.dk) + b * p.T * o_st + h * D;
  float* dvg = static_cast<float*>(p.dv) + b * p.T * o_st + h * D;

  const int r = threadIdx.x / 4;
  const int qd = threadIdx.x % 4;
  const int key = k0 + r;

  for (int i = threadIdx.x; i < F32_ROWS * D; i += F32_THREADS) {
    const int rr = i / D, c = i % D;
    const int t = k0 + rr;
    Ks[rr][c] = t < p.T ? kg[t * p.k_st + c] : 0.f;
    Vs[rr][c] = t < p.T ? vg[t * p.v_st + c] : 0.f;
  }

  float acc_k[COLS], acc_v[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc_k[c] = acc_v[c] = 0.f;

  // causal: queries before the block's first key see none of its keys
  for (int q0 = p.causal ? k0 : 0; q0 < p.T; q0 += F32_COLS) {
    __syncthreads();
    for (int i = threadIdx.x; i < F32_COLS * D; i += F32_THREADS) {
      const int rr = i / D, c = i % D;
      const int t = q0 + rr;
      Qs[rr][c] = t < p.T ? qg[t * p.q_st + c] : 0.f;
      dOs[rr][c] = t < p.T ? dog[t * p.do_st + c] : 0.f;
    }
    if (threadIdx.x < F32_COLS) {
      const int t = q0 + threadIdx.x;
      lse_s[threadIdx.x] = t < p.T ? p.lse[row_stats + t] : 0.f;
      dl_s[threadIdx.x] = t < p.T ? p.delta[row_stats + t] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < F32_COLS / 4; ++i) {
      const int j = qd + 4 * i;
      float dot = 0.f, dpv = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        dot = fmaf(Ks[r][c], Qs[j][c], dot);
        dpv = fmaf(Vs[r][c], dOs[j][c], dpv);
      }
      const int qc = q0 + j;
      const float pe = (qc >= p.T || (p.causal && key > qc))
                           ? 0.f : expf(dot * p.scale - lse_s[j]);
      Ps[r][j] = pe;
      dSs[r][j] = pe * (dpv - dl_s[j]);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      float sk = 0.f, sv = 0.f;
#pragma unroll
      for (int j = 0; j < F32_COLS; ++j) {
        sv = fmaf(Ps[r][j], dOs[j][qd + 4 * c], sv);
        sk = fmaf(dSs[r][j], Qs[j][qd + 4 * c], sk);
      }
      acc_v[c] += sv;
      acc_k[c] += sk;
    }
    __syncwarp();
  }

  if (key < p.T) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      dkg[key * o_st + qd + 4 * c] = acc_k[c] * p.scale;
      dvg[key * o_st + qd + 4 * c] = acc_v[c];
    }
  }
}

// ------------------------------------------------------------------ launch
template <typename T, int D, bool DQ>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  constexpr int smem = DQ ? dq_smem_bytes<D>(sizeof(T))
                          : dkv_smem_bytes<D>(sizeof(T));
  constexpr int rows = DQ ? dq_block_m<D>() : dkv_block_n<D>();
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = DQ
      ? opt_in_smem(fa_bwd_dq_mma_kernel<T, D>, smem, opted_in)
      : opt_in_smem(fa_bwd_dkv_mma_kernel<T, D>, smem, opted_in);
  if (err != cudaSuccess) return err;
  dim3 grid((p.T + rows - 1) / rows, p.B * p.H);
  if (DQ)
    fa_bwd_dq_mma_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  else
    fa_bwd_dkv_mma_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool DQ>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  dim3 grid((p.T + F32_ROWS - 1) / F32_ROWS, p.B * p.H);
  if (DQ)
    fa_bwd_dq_f32_kernel<D><<<grid, F32_THREADS, 0, stream>>>(p);
  else
    fa_bwd_dkv_f32_kernel<D><<<grid, F32_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool DQ>
cudaError_t dispatch_dtype(const Params& p, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_f32<D, DQ>(p, stream);
    case 1: return launch_mma<__nv_bfloat16, D, DQ>(p, stream);
    case 2: return launch_mma<__half, D, DQ>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DQ>
int launch(const Params& p, int D, int dtype, void* stream) {
  if (p.B <= 0 || p.T <= 0 || p.H <= 0 || p.B * p.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = dispatch_dtype<32, DQ>(p, dtype, s); break;
    case 64: err = dispatch_dtype<64, DQ>(p, dtype, s); break;
    case 128: err = dispatch_dtype<128, DQ>(p, dtype, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Strides in elements;
// the head_dim stride must be 1. lse and delta: contiguous [B, H, T] f32.
// dq (dk, dv): contiguous [B, T, H, D] outputs in the input dtype.
// Returns the cudaError_t of the launch.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dq,
                           int B, int T, int H, int D, int dtype,
                           long long q_sb, long long q_st, long long q_sh,
                           long long k_sb, long long k_st, long long k_sh,
                           long long v_sb, long long v_st, long long v_sh,
                           long long do_sb, long long do_st, long long do_sh,
                           float scale, float dq_scale, int causal,
                           void* stream) {
  Params p{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, T, H,
           q_sb, q_st, q_sh, k_sb, k_st, k_sh,
           v_sb, v_st, v_sh, do_sb, do_st, do_sh,
           scale, dq_scale, causal};
  return launch<true>(p, D, dtype, stream);
}

int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv,
                            int B, int T, int H, int D, int dtype,
                            long long q_sb, long long q_st, long long q_sh,
                            long long k_sb, long long k_st, long long k_sh,
                            long long v_sb, long long v_st, long long v_sh,
                            long long do_sb, long long do_st, long long do_sh,
                            float scale, int causal, void* stream) {
  Params p{q, k, v, dout, lse, delta, nullptr, dk, dv, B, T, H,
           q_sb, q_st, q_sh, k_sb, k_st, k_sh,
           v_sb, v_st, v_sh, do_sb, do_st, do_sh,
           scale, scale, causal};
  return launch<false>(p, D, dtype, stream);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
