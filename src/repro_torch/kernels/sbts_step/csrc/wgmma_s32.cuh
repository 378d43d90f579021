// Helpers shared by selection_counts.cu and mma_probe.cu: the two
// integer wgmma shapes (64 x 256 outputs, s32 accumulators in 128
// registers a thread, both operands from shared memory, K-major under
// the 128-byte swizzle: a 128-byte row of depth is four wgmmas of 32
// bytes, 32 int8 values or 256 bits each).  Addresses, cp.async, fences
// and descriptors come from csrc/sm90.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/sm90.cuh"

// Orders the compiler's accesses of an accumulator around wgmma.
__device__ __forceinline__ void wgmma_fence_regs(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define WGMMA_D8(i)                                                \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),     \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define WGMMA_D128                                                        \
  WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24), WGMMA_D8(32),     \
      WGMMA_D8(40), WGMMA_D8(48), WGMMA_D8(56), WGMMA_D8(64),             \
      WGMMA_D8(72), WGMMA_D8(80), WGMMA_D8(88), WGMMA_D8(96),             \
      WGMMA_D8(104), WGMMA_D8(112), WGMMA_D8(120)
#define WGMMA_REGS128 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, " \
  "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
  "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, " \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, " \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, " \
  "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

// d (64 x 256, s32) (+)= A (64 x 32 int8, smem) B^T (256 x 32 int8, smem).
__device__ __forceinline__ void wgmma_s8_m64n256(int (&d)[128], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      WGMMA_REGS128 "}, %128, %129, p;\n}\n"
      : WGMMA_D128
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 256, s32) (+)= popcount(A AND B) over 256 bits: A 64 x 32
// bytes, B 256 x 32 bytes, both in shared memory.
__device__ __forceinline__ void wgmma_b1_m64n256(int (&d)[128], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k256.s32.b1.b1.and.popc {"
      WGMMA_REGS128 "}, %128, %129, p;\n}\n"
      : WGMMA_D128
      : "l"(da), "l"(db), "r"(accumulate));
}
