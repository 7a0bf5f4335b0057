// Tensor-core and asynchronous-copy primitives of the bf16 kernels (sm_80+
// PTX, run here on sm_90a): cp.async with zero fill, ldmatrix (plain and
// transposed) and mma.sync m16n8k16 with bf16 operands and fp32 sums.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, q = lane % 4):
//   A 16x16 row-major, 4 regs: a0 (g, 2q..2q+1), a1 (g+8, 2q..), a2 (g, 2q+8..),
//     a3 (g+8, 2q+8..)  -- ldsm_x4 with lane l addressing row (l & 15),
//     column 8 * (l >> 4) of the tile gives exactly a0..a3.
//   B 16x8 (k x n), 2 regs: b0 (k 2q..2q+1, n g), b1 (k 2q+8.., n g). A tile
//     stored n-major (row n holds k contiguous) is read by plain ldmatrix;
//     one stored k-major (row k holds n contiguous) by ldmatrix.trans.
//   C 16x8 fp32, 4 regs: c0, c1 (g, 2q..2q+1), c2, c3 (g+8, 2q..).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ditto {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy in flight; with pred false the 16 bytes are
// zero-filled and nothing is read (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b on the tensor cores: bf16 operands, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace ditto
