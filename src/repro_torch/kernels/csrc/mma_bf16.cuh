// bf16 helpers for kernels that multiply tiles from shared memory on the
// tensor cores' synchronous form: ldmatrix, plain and transposed, and
// mma.sync m16n8k16 (bf16 operands, fp32 accumulators).  Included by
// ragged_dot/csrc/ragged_dot.cu and ragged_dot/csrc/ragged_dot_bwd.cu
// (the routes for shapes TMA cannot take).

#pragma once

#include <stdint.h>

// Four 8 x 8 b16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; each thread gets its fragment of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// d (16 x 8, fp32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16,
// column-major).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
