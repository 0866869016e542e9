// The weight-only tile product shared by int8_matmul.cu and
// serving_stack.cu, for Hopper (sm_90a): the transposed tile
//
//     acc[channels, tokens] += W[channels, k] . x[tokens, k]^T
//
// on warpgroup wgmma. wgmma takes its B operand only from shared memory,
// as 16-bit values for a bf16 product, and its A operand from registers:
// so the weight rows are the A operand, converted from int8 to bf16 in
// registers, and the activation tile is B, read K-major from shared
// memory as it lies in x [M, K] (row-major). The accumulator of a
// consumer warpgroup is 64 output channels by the tile's tokens.
//
// Both operands arrive by TMA (tensor maps encoded on the host for each
// call): the x tile as rows of 64 bf16 (128 bytes, 128-byte swizzle, as
// flash_tma.cuh's Tile<64>), the int8 weight tile as rows of 64 or 128
// bytes (64- or 128-byte swizzle). A consumer thread reads its A
// fragment (the mma.sync m16n8k16 A layout of its warp's 16 rows) from
// the weight tile
// two bytes at a time and converts each pair exactly to a bf16x2
// (b_pair: |v| <= 127 needs 7 of bf16's 8 significant bits). bf16
// weights (the stack's other type) take wgmma's shared-memory A operand
// instead, rows of 128 bytes with the 128-byte swizzle. Rows past M or N
// and columns past K arrive as zeros (TMA's out-of-bounds fill), so any
// M and N work; TMA needs K a multiple of 16 and 16-byte aligned bases,
// which the Python wrappers provide (they pad K with zeros where it is
// not).
#pragma once

#include "flash_tma.cuh"

namespace wq {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr int BK = 64;  // K of a stage: 128 bytes of x, 64 of int8 w

// (w[n][k], w[n][k + 1]) as the bf16x2 of an A fragment register,
// without the conversion unit (I2F runs at a quarter of the ALU rate):
// each byte, biased by 128, goes into the mantissa of 2^23 (f32 2^23 + b
// + 128), one FADD takes 2^23 + 128 off (exact: b itself), and as |b| <=
// 128 has at most 8 significant bits, the f32's top 16 bits are its bf16.
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

// The A fragment of k step kk (16 columns) for the rows `row` and row + 8
// of an int8 tile of ROW-byte rows in TMA's ROW-byte swizzle (the 16-byte
// chunk c of row r lies at chunk c ^ ((r / 2) % 4) for 64-byte rows, c ^
// (r % 8) for 128-byte rows; rows r and r + 8 share it): a[0] (row, k
// 2t..2t+1), a[1] (row + 8, the same k), a[2] and a[3] the same rows at
// k + 8, for thread t of the row's quad.
template <int ROW = 64>
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4],
                                           const int8_t* tile, int row,
                                           int kk, int t) {
  static_assert(ROW == 64 || ROW == 128, "a 64- or 128-byte swizzle");
  const int swz = ROW == 64 ? (row >> 1) & 3 : row & 7;
  const int at = row * ROW + ((kk ^ swz) << 4) + 2 * t;
  a[0] = b_pair(tile + at);
  a[1] = b_pair(tile + at + 8 * ROW);
  a[2] = b_pair(tile + at + 8);
  a[3] = b_pair(tile + at + 8 * ROW + 8);
}

// wgmma's descriptor of k step kk of a K-major tile of rows of 64 bf16
// (128 bytes, 128-byte swizzle: 8-row groups 1024 bytes apart) from row
// row0; `tile` 1024-byte aligned
__device__ __forceinline__ uint64_t k_major_desc(const unsigned char* tile,
                                                 int row0, int kk) {
  return smem_desc(tile + row0 * 128 + kk * 32, 16, 1024, 1);
}

// shared-memory writes of the generic proxy made visible to wgmma and
// TMA (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one TMA copy of a box of a 2-D or 3-D tensor map into shared memory;
// its bytes land on `bar`'s transaction count
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
        "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
        "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// The tensor map of a row-major [rows, K] operand, or of `outer` of them
// stacked ([outer, rows, K], RANK 3), dims innermost first, for boxes of
// BOX_K columns (128 bytes of bf16 or int8, 128-byte swizzle; 64 bytes of
// int8, 64-byte swizzle) by box_rows rows (by one of the outer dim);
// out-of-bounds elements read 0. K must be a multiple of 16 and base
// 16-byte aligned (TMA's rule).
template <typename T, int RANK = 2, int BOX_K = BK>
cudaError_t row_major_map(CUtensorMap* map, const void* base, int K,
                          int rows, int outer, int box_rows) {
  EncodeTiled encode;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  constexpr bool is_bf16 = sizeof(T) == 2;
  constexpr int row_bytes = BOX_K * static_cast<int>(sizeof(T));
  static_assert(row_bytes == 64 || row_bytes == 128, "a swizzle row");
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(K) * sizeof(T),
      static_cast<cuuint64_t>(K) * rows * sizeof(T)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(BOX_K),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
              : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      RANK, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// TMA's operands: K a multiple of 16 (16-byte rows of int8), 16-byte
// aligned bases
inline bool tma_ok(const void* x, const void* w, int K) {
  return K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
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
