// The TMA plumbing both Hopper attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu) share: the tile of `rows` x D elements in shared
// memory as TMA writes it and wgmma reads it (Tile<D>), and the host-side
// encoding of a [B, T, H, D] operand's tensor map (tensor_map), with
// cuTensorMapEncodeTiled fetched through the runtime
// (cudaGetDriverEntryPoint), so a kernel library links the runtime only.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked

#include <type_traits>

#include "flash_common.cuh"

namespace flash {

constexpr int WG = 128;  // threads of a warpgroup

// A tile of `rows` rows x D in shared memory, as TMA writes it: column
// blocks of CB elements (one swizzle row of ROW_BYTES), each `rows` rows
// x ROW_BYTES, swizzled in groups of 8 rows.
template <int D>
struct Tile {
  static constexpr int CB = D >= 64 ? 64 : 32;
  static constexpr int NCB = D / CB;
  static constexpr int ROW_BYTES = CB * 2;
  static constexpr uint32_t SWIZZLE = CB == 64 ? 1 : 2;  // 128B / 64B
  static constexpr uint32_t GROUP_BYTES = 8 * ROW_BYTES;
  __host__ __device__ static constexpr int bytes(int rows) {
    return rows * D * 2;
  }

  // the 64 rows from row0 (or the whole tile as B), columns 16 kk ..
  // 16 kk + 15, read K-major (the rows' D values contiguous)
  static __device__ __forceinline__ uint64_t k_major(const unsigned char* t,
                                                     int rows, int row0,
                                                     int kk) {
    const int col = kk * 16;
    return smem_desc(t + (col / CB) * rows * ROW_BYTES + row0 * ROW_BYTES +
                         (col % CB) * 2,
                     16, GROUP_BYTES, SWIZZLE);
  }

  // rows 16 kk .. 16 kk + 15 as the K of a B operand read MN-major (its N
  // = D contiguous): the leading offset steps column blocks, the stride
  // offset 8-row groups
  static __device__ __forceinline__ uint64_t mn_major(const unsigned char* t,
                                                      int rows, int kk) {
    return smem_desc(t + kk * 16 * ROW_BYTES, rows * ROW_BYTES, GROUP_BYTES,
                     SWIZZLE);
  }

  // TMA: rows t0 .. t0 + rows - 1 of head h, batch b into t
  static __device__ __forceinline__ void load(unsigned char* t,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int rows,
                                              int t0, int h, int b) {
#pragma unroll
    for (int c = 0; c < NCB; ++c)
      tma_load_4d(t + c * rows * ROW_BYTES, map, bar, c * CB, h, t0, b);
  }
};

// cuTensorMapEncodeTiled, fetched once through the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline cudaError_t encode_tiled(EncodeTiled* fn) {
  static std::atomic<EncodeTiled> cached{nullptr};
  EncodeTiled f = cached.load(std::memory_order_acquire);
  if (f == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr)
      return cudaErrorNotSupported;
    f = reinterpret_cast<EncodeTiled>(ptr);
    cached.store(f, std::memory_order_release);
  }
  *fn = f;
  return cudaSuccess;
}

// The tensor map of one [B, T, H, D] operand (strides in elements) for
// boxes of `rows` rows of one column block: dims (D, H, T, B), the
// column blocks swizzled as Tile<D> reads them; out-of-bounds rows read 0.
template <typename T, int D>
cudaError_t tensor_map(CUtensorMap* map, const void* base, int B, int T_len,
                       int H, int64_t sb, int64_t st, int64_t sh, int rows) {
  EncodeTiled encode;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  using Tl = Tile<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T_len),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * sizeof(T),
                                 static_cast<cuuint64_t>(st) * sizeof(T),
                                 static_cast<cuuint64_t>(sb) * sizeof(T)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Tl::CB), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      Tl::CB == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace flash
