// What the fused batch-norm's two kernels (fused_norm.cu, the forward;
// fused_norm_bwd.cu, the backward) share: one persistent cooperative
// grid over the rows of [R, C], each block's rows kept in shared memory
// (as many as fit) between the two passes over them while the rest
// stream from device memory with an L2 evict_last hint, a per-block sum
// in a fixed order, a grid barrier that needs no reset, and the
// per-element loads and stores of eight channels.
//
// The plan of a block: its rows [r0, r1) of R split evenly over the
// grid; the first `res` of them resident (RESIDENT_BYTES of shared
// memory over the bytes a row takes): the threads store them there as
// they load them in the first pass (with an evict_first hint: they are
// not read from L2 again); the rest streamed. Its threads: groups of 8
// consecutive channels (one 16-byte load of bf16/fp16, two of f32), gpb
// groups side by side (at most 64), `lanes` rows a sweep; channel counts
// past 512 take several passes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"

namespace bnorm {

using flash::global_ns;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 8;  // consecutive channels of a thread
// the most dynamic shared memory a block can take (227 KB): one block an
// SM, all of it for the block's rows but the scratch of its sums and
// staged per-channel values
constexpr int SMEM_BYTES = 232448;
constexpr int SCRATCH_BYTES = THREADS * VEC * 4;
constexpr int RESIDENT_BYTES = SMEM_BYTES - SCRATCH_BYTES;
constexpr unsigned long long BARRIER_TIMEOUT_NS = 10000000000ull;  // 10 s

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

// --------------------------------------------------------- L2 policies
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// one 16-byte load from device memory under an L2 policy
__device__ __forceinline__ uint4 ld_hint(const void* p, uint64_t policy) {
  uint4 v;
  asm volatile("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(reinterpret_cast<uint64_t>(p)), "l"(policy));
  return v;
}

// one 16-byte store that is not read again (streaming: evicted first)
__device__ __forceinline__ void st_stream(void* p, uint4 v) {
  __stcs(static_cast<uint4*>(p), v);
}

// --------------------------------------------------- 8 channels a load
// VECTOR: the 16-byte words as loaded (one of bf16/fp16, two of f32);
// else the values, the tail past n masked to 0
template <typename T, bool VECTOR>
struct Row8 {
  uint4 w[sizeof(T) / 2];
};
template <typename T>
struct Row8<T, false> {
  float f[VEC];
};

__device__ __forceinline__ float2 pair_to_f(uint32_t w, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}
__device__ __forceinline__ float2 pair_to_f(uint32_t w, __half) {
  return __half22float2(*reinterpret_cast<__half2*>(&w));
}
__device__ __forceinline__ uint32_t f_to_pair(float lo, float hi,
                                              __nv_bfloat16) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t f_to_pair(float lo, float hi, __half) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T, bool VECTOR>
__device__ __forceinline__ Row8<T, VECTOR> load_row(const T* p, int n,
                                                    uint64_t policy) {
  Row8<T, VECTOR> r;
  if constexpr (VECTOR) {
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(T)) / 2; ++i)
      r.w[i] = ld_hint(p + i * (16 / sizeof(T)), policy);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) r.f[i] = i < n ? to_f(p[i]) : 0.f;
  }
  return r;
}

// a resident row's 8 values from or to shared memory (VECTOR only)
template <typename T>
__device__ __forceinline__ Row8<T, true> load_tile(const T* p) {
  Row8<T, true> r;
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T)) / 2; ++i)
    r.w[i] = reinterpret_cast<const uint4*>(p)[i];
  return r;
}

template <typename T>
__device__ __forceinline__ void store_tile(T* p, const Row8<T, true>& r) {
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T)) / 2; ++i)
    reinterpret_cast<uint4*>(p)[i] = r.w[i];
}

template <typename T, bool VECTOR>
__device__ __forceinline__ void unpack(const Row8<T, VECTOR>& r,
                                       float (&f)[VEC]) {
  if constexpr (!VECTOR) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = r.f[i];
  } else if constexpr (sizeof(T) == 4) {
    const uint32_t u[VEC] = {r.w[0].x, r.w[0].y, r.w[0].z, r.w[0].w,
                             r.w[1].x, r.w[1].y, r.w[1].z, r.w[1].w};
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = __uint_as_float(u[i]);
  } else {
    const uint32_t u[4] = {r.w[0].x, r.w[0].y, r.w[0].z, r.w[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = pair_to_f(u[i], T());
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
}

// p[i] = f[i] for i < n; VECTOR: streaming 16-byte stores
template <typename T, bool VECTOR>
__device__ __forceinline__ void store_row(T* p, int n,
                                          const float (&f)[VEC]) {
  if constexpr (!VECTOR) {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (i < n) p[i] = from_f<T>(f[i]);
  } else if constexpr (sizeof(T) == 4) {
    st_stream(p, make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                            __float_as_uint(f[2]), __float_as_uint(f[3])));
    st_stream(p + 4,
              make_uint4(__float_as_uint(f[4]), __float_as_uint(f[5]),
                         __float_as_uint(f[6]), __float_as_uint(f[7])));
  } else {
    st_stream(p, make_uint4(f_to_pair(f[0], f[1], T()),
                            f_to_pair(f[2], f[3], T()),
                            f_to_pair(f[4], f[5], T()),
                            f_to_pair(f[6], f[7], T())));
  }
}

// ------------------------------------------------------------ the plan
// at most this many channel groups side by side: a pass's channels
// (512) then fit STAGED per-channel arrays in the block's scratch
constexpr int MAX_GROUPS = 64;
constexpr int PASS_COLS = MAX_GROUPS * VEC;
constexpr int STAGED = SCRATCH_BYTES / 4 / PASS_COLS;

struct Lanes {
  int groups, gpb, lanes;
};

__device__ __forceinline__ Lanes lanes_for(int C) {
  Lanes l;
  l.groups = (C + VEC - 1) / VEC;
  l.gpb = l.groups < MAX_GROUPS ? l.groups : MAX_GROUPS;
  l.lanes = THREADS / l.gpb;
  return l;
}

// A pass's per-channel values, read once per block: fill(c, v) gives
// the N values of channel c (c < C), which land in scratch[k * PASS_COLS
// + t] for the pass's channel c_base + t; then each thread takes its 8
// channels' values from there into out[k][i]. (Every thread of the grid
// reading its channels straight from L2 queued on the few lines of the
// [C] arrays: ~10 us a launch.)
template <int N, typename Fill>
__device__ __forceinline__ void stage_channels(float* scratch, int C,
                                               int c_base, int tx,
                                               float (&out)[N][VEC],
                                               Fill fill) {
  static_assert(N <= STAGED, "the staged arrays must fit the scratch");
  __syncthreads();  // the scratch's last readers are done
  for (int t = threadIdx.x; t < PASS_COLS; t += THREADS) {
    const int c = c_base + t;
    float v[N];
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = 0.f;
    if (c < C) fill(c, v);
#pragma unroll
    for (int k = 0; k < N; ++k) scratch[k * PASS_COLS + t] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      out[k][i] = scratch[k * PASS_COLS + tx * VEC + i];
  __syncthreads();  // before the scratch is written again
}

struct Rows {
  int r0, r1, res;
};

// this block's rows; `row_bytes` what one resident row takes in shared
// memory (0 rows resident unless `resident`)
__device__ __forceinline__ Rows block_rows(int R, int row_bytes,
                                           bool resident) {
  Rows s;
  s.r0 = static_cast<int>(static_cast<long long>(blockIdx.x) * R /
                          gridDim.x);
  s.r1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * R /
                          gridDim.x);
  s.res = resident ? min(s.r1 - s.r0, RESIDENT_BYTES / row_bytes) : 0;
  return s;
}

// A thread's sweep over rows first, first + lanes, ... below last:
// load(r) for U rows at a time (their loads in flight together), then
// use(r, loaded) for each.
template <int U, typename Load, typename Use>
__device__ __forceinline__ void sweep(int first, int last, int lanes,
                                      Load load, Use use) {
  int r = first;
  for (; r + (U - 1) * lanes < last; r += U * lanes) {
    decltype(load(r)) got[U];
#pragma unroll
    for (int u = 0; u < U; ++u) got[u] = load(r + u * lanes);
#pragma unroll
    for (int u = 0; u < U; ++u) use(r + u * lanes, got[u]);
  }
  for (; r < last; r += lanes) use(r, load(r));
}

// the same rows from the last down (the most recently read first)
template <int U, typename Load, typename Use>
__device__ __forceinline__ void sweep_back(int first, int last, int lanes,
                                           Load load, Use use) {
  if (first >= last) return;
  int r = first + (last - 1 - first) / lanes * lanes;
  for (; r - (U - 1) * lanes >= first; r -= U * lanes) {
    decltype(load(r)) got[U];
#pragma unroll
    for (int u = 0; u < U; ++u) got[u] = load(r - u * lanes);
#pragma unroll
    for (int u = 0; u < U; ++u) use(r - u * lanes, got[u]);
  }
  for (; r >= first; r -= lanes) use(r, load(r));
}

// --------------------------------------------------------- the reduces
// The block's sum of v over its lanes, each channel's in lane order, to
// partial[(which * C + c) * gridDim.x + blockIdx.x] for the pass's
// channels from c_base.
__device__ __forceinline__ void block_sum_store(float* scratch,
                                                const float (&v)[VEC],
                                                int tx, int ty,
                                                const Lanes& ln,
                                                float* partial, int C,
                                                int c_base, int which) {
  const int cols = ln.gpb * VEC;
  if (ty < ln.lanes) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) scratch[ty * cols + tx * VEC + i] = v[i];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < cols; t += THREADS) {
    float a = 0.f;
    for (int l = 0; l < ln.lanes; ++l) a += scratch[l * cols + t];
    const int c = c_base + t;
    if (c < C)
      partial[(static_cast<size_t>(which) * C + c) * gridDim.x +
              blockIdx.x] = a;
  }
  __syncthreads();
}

// the sum over the warp, the same value in every lane (a butterfly:
// both lanes of each pair add the same two values)
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(reinterpret_cast<uint64_t>(p))
               : "memory");
  return v;
}

// Every block of the (co-resident) grid waits here until all have
// arrived. Each block's thread 0 adds to the word `bar` with release
// semantics: block 0 adds 2^31 - (blocks - 1), the others 1, so the
// last arrival flips its top bit and leaves its low bits as they were;
// each waits (acquire) for the flip. So the word serves every barrier
// of every launch on one stream without a reset. A wait of more than
// 10 s traps rather than hang the card.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    unsigned old;
    asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;\n"
                 : "=r"(old)
                 : "l"(reinterpret_cast<uint64_t>(bar)), "r"(add)
                 : "memory");
    unsigned long long t0 = 0;
    for (unsigned n = 0; ((old ^ load_acquire(bar)) & 0x80000000u) == 0;
         ++n) {
      if ((n & 1023) == 1023) {
        const unsigned long long now = global_ns();
        if (t0 == 0)
          t0 = now;
        else if (now - t0 > BARRIER_TIMEOUT_NS)
          __trap();
      }
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------- host
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

// blocks in the partial sums' scratch for R rows: the most the grid can
// have (at most two blocks an SM, at most one a row)
inline int max_blocks(int R) {
  const int cap = 2 * sm_count();
  return R < cap ? R : cap;
}

// The blocks of `kernel` the card holds at once with SMEM_BYTES each,
// queried once per device (`cache`), capped by max_blocks(R); a
// cooperative launch of more would be refused.
template <typename Kernel>
cudaError_t coresident_grid(Kernel kernel, std::atomic<int> (&cache)[64],
                            int R, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n = dev < 64 ? cache[dev].load(std::memory_order_relaxed) : 0;
  if (n <= 0) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    n = per_sm * sm_count();
    if (n < 1) return cudaErrorCooperativeLaunchTooLarge;
    if (dev < 64) cache[dev].store(n, std::memory_order_relaxed);
  }
  const int cap = max_blocks(R);
  *grid = n < cap ? n : cap;
  return cudaSuccess;
}

// a 16-byte vector path: every channel group whole and every row base
// 16-byte aligned
inline bool vector_ok(int C, const void* a, const void* b, const void* c) {
  return C % VEC == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(c) % 16 == 0;
}

}  // namespace bnorm
