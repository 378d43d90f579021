// Helpers shared by the fp32 kernels (flash_attention/csrc/flash_attention.cu
// and flash_attention_bwd.cu, ssd/csrc/ssd.cu and ssd_bwd.cu,
// ragged_dot/csrc/ragged_tf32.cuh), whose
// products run on the TF32 tensor cores in a 3xTF32 split: each fp32
// operand x as hi = tf32(x), lo = tf32(x - hi),
// and each product as hi hi + (hi lo + lo hi), hi hi and the small terms in
// separate fp32 accumulators (the grouped product's: in one, a 32-deep
// stage at a time, small terms first).  mma.sync.m16n8k8 takes operands from
// registers; wgmma.m64nNk8 takes B (and A, or A from registers) from
// shared memory, K-major under the 128-byte swizzle, the only layout its
// TF32 form accepts.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

// TF32 products per fp32 product: hi hi, hi lo, lo hi.
constexpr int kPasses = 3;

// x as hi + lo, each a TF32 value (low 13 bits zero) in a 32-bit register.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}
// v split into TF32 hi and lo, stored as 16 bytes each at base + off and
// base + off + lo_off (shared memory).
__device__ __forceinline__ void store_split(uint8_t* base, uint32_t off,
                                            uint32_t lo_off, float4 v) {
  uint4 hi, lo;
  split(v.x, hi.x, lo.x);
  split(v.y, hi.y, lo.y);
  split(v.z, hi.z, lo.z);
  split(v.w, hi.w, lo.w);
  *reinterpret_cast<uint4*>(base + off) = hi;
  *reinterpret_cast<uint4*>(base + off + lo_off) = lo;
}

// Four 8 x 4 fp32 tiles of shared memory as mma.m16n8k8 fragments, one
// ldmatrix (its b16 form: a row of 8 b16 is a row of 4 fp32): lane l gives
// the address of row l % 8 of tile l / 8 (16-byte aligned), and r[i]
// receives element (lane / 4, lane % 4) of tile i.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// The A fragment (16 x 8) of [m][k] storage at t = (m0, k0), and the B
// fragments (8 x 8) of two 8-row blocks of [n][k] storage at t = (n0,
// k0) (b[0], b[1] of rows n0.., b[2], b[3] of rows n0 + 8..), each by one
// ldmatrix; rows 16-byte aligned, pitch ld floats.
__device__ __forceinline__ void ldsm_a(uint32_t (&r)[4], const float* t,
                                       int ld, int lane) {
  ldsm4(r, t + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 4);
}
__device__ __forceinline__ void ldsm_b2(uint32_t (&r)[4], const float* t,
                                        int ld, int lane) {
  ldsm4(r, t + ((lane & 7) + ((lane >> 4) & 1) * 8) * ld +
               ((lane >> 3) & 1) * 4);
}

// c (16 x 8, fp32) += a (16 x 8, tf32) b (8 x 8, tf32).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The 3xTF32 product: big += a_hi b_hi, small += a_hi b_lo + a_lo b_hi.
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  static_assert(kPasses == 3, "mma3 issues three TF32 products");
  mma(small, ah, bl0, bl1);
  mma(small, al, bh0, bh1);
  mma(big, ah, bh0, bh1);
}

// wgmma descriptor of a K-major TF32 panel under the 128-byte swizzle,
// 8-row groups 1024 bytes apart.  A step of 8 along K is 32 bytes on;
// the next 32 columns are the next panel.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return desc(addr, 16, 1024);
}
// Keeps A fragments live (unreused) until this point: wgmma reads them
// until its wait.
__device__ __forceinline__ void pin(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int i = 0; i < 32; ++i)
    asm volatile("" : "+r"(a[i >> 2][i & 3])::"memory");
}

#define TF32_D32                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define TF32_R32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

#define TF32_D16                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define TF32_R16                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (64 x 32, fp32) (+)= A (64 x 8 tf32, smem) B^T (32 x 8 tf32, smem).
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " TF32_R16
      ", %16, %17, p, 1, 1;\n}\n"
      : TF32_D16
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 64, fp32) (+)= A (64 x 8 tf32, smem) B^T (64 x 8 tf32, smem).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " TF32_R32
      ", %32, %33, p, 1, 1;\n}\n"
      : TF32_D32
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 64, fp32) (+)= A (64 x 8 tf32, registers) B^T (64 x 8, smem).
// A's fragment is mma.sync.m16n8k8's, one warp a 16-row slice.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " TF32_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : TF32_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#define TF32_D64                                                           \
  TF32_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),            \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),     \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),     \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),     \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),     \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),     \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define TF32_R64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128, fp32) (+)= A (64 x 8 tf32, registers) B^T (128 x 8, smem),
// A's fragment as wgmma_rs's (the grouped product's fp32 kernels).
__device__ __forceinline__ void wgmma_rs128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " TF32_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : TF32_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
