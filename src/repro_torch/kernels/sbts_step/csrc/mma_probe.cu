// Peak-rate probes of the tensor-core instructions that can compute
// selection_counts (an AND-popcount product over packed words), and of
// the two TF32 forms that can carry the fp32 kernels' split products
// (flash_attention.cu, ssd.cu), so that the choice of unit rests on this
// card's own rates.  Each probe keeps every SM busy with one instruction
// on operands that stay put, and the caller times it with CUDA events:
//
//   0  mma.sync m16n8k256 .b1 .and.popc   (registers)
//   1  mma.sync m16n8k32  .s8             (registers)
//   2  wgmma    m64n256k32  .s8           (shared memory, 128-byte swizzle)
//   3  wgmma    m64n256k256 .b1 .and.popc (shared memory, 128-byte swizzle)
//   4  mma.sync m16n8k8   .tf32           (registers, fp32 accumulators)
//   5  wgmma    m64n256k8   .tf32         (shared memory, 128-byte swizzle)
//
// Operations per instruction are 2 m n k (k in elements: bits for .b1),
// so the first four rates compare as rates of the same 0/1 product, the
// last two as FLOP/s.  The results are summed into `out` so that no
// instruction is dead code; their values are not checked here (the
// kernels' are).

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_s32.cuh"

namespace {

constexpr int kChains = 8;   // independent accumulators per warp (mma.sync)

__global__ void __launch_bounds__(256)
mma_sync_probe(int* out, int iters, int b1) {
  const uint32_t s = threadIdx.x * 2654435761u + blockIdx.x;
  uint32_t a[4] = {s, s ^ 0x5555u, s * 3u, s + 7u};
  uint32_t b[2] = {s ^ 0xF0F0u, s * 5u};
  int c[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      if (b1) {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      }
    }
  }
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kChains; ++j) sum += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  atomicAdd(out, sum);
}

// The TF32 form: operands of about 2^-10, so 8 chains of `iters` sums
// stay far from overflow.
__global__ void __launch_bounds__(256)
mma_sync_tf32_probe(int* out, int iters) {
  const uint32_t s = threadIdx.x * 2654435761u + blockIdx.x;
  const uint32_t one = __float_as_uint(9.765625e-4f) & ~0x1FFFu;
  uint32_t a[4] = {one | (s & 0x1E000u), one, one | 0x2000u, one};
  uint32_t b[2] = {one | ((s >> 4) & 0x1E000u), one};
  float c[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kChains; ++j) sum += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  atomicAdd(out, static_cast<int>(sum));
}

#define WGMMA_F8(i)                                                \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),     \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WGMMA_F128                                                        \
  WGMMA_F8(0), WGMMA_F8(8), WGMMA_F8(16), WGMMA_F8(24), WGMMA_F8(32),     \
      WGMMA_F8(40), WGMMA_F8(48), WGMMA_F8(56), WGMMA_F8(64),             \
      WGMMA_F8(72), WGMMA_F8(80), WGMMA_F8(88), WGMMA_F8(96),             \
      WGMMA_F8(104), WGMMA_F8(112), WGMMA_F8(120)

// d (64 x 256, fp32) (+)= A (64 x 8 tf32, smem) B^T (256 x 8 tf32, smem),
// both K-major (the only layout wgmma takes for TF32).
__device__ __forceinline__ void wgmma_tf32_m64n256(float (&d)[128],
                                                   uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      WGMMA_REGS128 "}, %128, %129, p, 1, 1;\n}\n"
      : WGMMA_F128
      : "l"(da), "l"(db), "r"(accumulate));
}

// Two warpgroups per block, each with its own 64-row A panel and one
// shared 256-row B panel (128-byte rows, zeroed), four wgmmas (one
// 128-byte row of depth) per commit.
constexpr int kWgmmaSmem = 1024 + 2 * 64 * 128 + 256 * 128;

__global__ void __launch_bounds__(256)
wgmma_probe(int* out, int iters, int b1) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  for (int i = threadIdx.x; i < (kWgmmaSmem - 1024) / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  const uint64_t da = desc(smem_u32(smem + wg * 64 * 128), 16, 1024);
  const uint64_t db = desc(smem_u32(smem + 2 * 64 * 128), 16, 1024);
  int d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;
  for (int it = 0; it < iters; ++it) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (b1)
        wgmma_b1_m64n256(d, da + 2 * kk, db + 2 * kk, 1);
      else
        wgmma_s8_m64n256(d, da + 2 * kk, db + 2 * kk, 1);
    }
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 128; ++i) sum += d[i];
  atomicAdd(out, sum);
}

// The TF32 wgmma on the same zeroed panels (32 bytes of depth an
// instruction, as for .s8).
__global__ void __launch_bounds__(256)
wgmma_tf32_probe(int* out, int iters) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  for (int i = threadIdx.x; i < (kWgmmaSmem - 1024) / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  const uint64_t da = desc(smem_u32(smem + wg * 64 * 128), 16, 1024);
  const uint64_t db = desc(smem_u32(smem + 2 * 64 * 128), 16, 1024);
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_tf32_m64n256(d, da + 2 * kk, db + 2 * kk, 1);
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 128; ++i) sum += d[i];
  atomicAdd(out, static_cast<int>(sum));
}

}  // namespace

// which: 0-5 as in the header; out: one int32 on the device, added to.
// Launches `blocks` blocks of 256 threads that each run `iters`
// iterations (mma.sync: 8 instructions per warp and iteration; wgmma: 4
// per warpgroup and iteration).  Returns the launch's cudaError_t.
extern "C" int mma_probe_launch(int which, void* out, int iters, int blocks,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (which == 0 || which == 1) {
    mma_sync_probe<<<blocks, 256, 0, s>>>(o, iters, which == 0);
  } else if (which == 2 || which == 3) {
    cudaError_t err = cudaFuncSetAttribute(
        wgmma_probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kWgmmaSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    wgmma_probe<<<blocks, 256, kWgmmaSmem, s>>>(o, iters, which == 3);
  } else if (which == 4) {
    mma_sync_tf32_probe<<<blocks, 256, 0, s>>>(o, iters);
  } else if (which == 5) {
    cudaError_t err = cudaFuncSetAttribute(
        wgmma_tf32_probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kWgmmaSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    wgmma_tf32_probe<<<blocks, 256, kWgmmaSmem, s>>>(o, iters);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
