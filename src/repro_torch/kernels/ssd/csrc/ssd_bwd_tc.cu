// The backward of the Mamba2 SSD chunked scan (one group) on bf16 inputs,
// with every product on the bf16 tensor cores: the gradients of y and the
// final state with respect to x, dt, a_log, B and C.  fp32 inputs take
// ssd_bwd.cu.
//
// Reference.  The JAX package has no backward kernel: jax.grad
// differentiates the plain repro/kernels/ssd/ref.py:35 ssd_chunked, and
// ssd_pallas (repro/kernels/ssd/kernel.py:80) has no custom_vjp.  This
// kernel is held to ref.py::ssd_chunked_bwd (autograd through the port's
// plain scan) on fp32 copies of its inputs.
//
// Maths, the head fold and the padding past S: ssd_bwd_common.cuh,
// which also holds stages 2 and 5, shared with the fp32 route.
//
// Bound (chip_smoke.py ssd_bwd_bound).  Per chunk of l steps: C B^T,
// sum_h Q B and sum_h Q C (l (l + 1) N each, once a chunk: the head fold),
// and per head dy x^T and G dy (l (l + 1) P each) and five (P x l)(l x N)
// products (S, R and the state terms of dx, dB, dC).  At zamba2's
// training shape (2, 2048, 64, 64), N = 64, L = 256 that is 1.96e10
// FLOP (2.81e10 with Q times B and C per head), 0.020 ms at 989e12 bf16
// FLOP/s, against 0.031 ms for its ~104 MB of bf16 in and out: bytes
// bind.
//
// Split terms.  C B^T and dy x^T have bf16 operands: one pass gives exact
// products.  Every fp32 operand is split into bf16 terms hi + lo (the
// kTerms* constants below): w B and exp(cum) C in S and R, H_z and dS_z
// in the state terms, sum_h Q in dB and dC, G in dx.  Two terms each meet
// the tolerances (2^-8 |ref| + 1e-5 max |ref|, d_a_log 1e-3 max |ref|)
// and one term of any of them misses them (tests/test_torch_ssd.py, a
// plain-torch model of this decomposition against jax.vjp of the
// reference).  Each fp32 operand is scaled per row in fp32 where it can:
// the state terms are formed per head as dy H and x dS (or B dS^T) and
// scaled by exp(cum_i) or w_j in the accumulator, which also gives V, U
// and ddt's state term as row dots of the same tile.
//
// Stages, one kernel each, launched by one call on one stream (five
// launches):
// 1. ssd_bwd_states, one block per (chunk, head, 64 columns of P, S or
//    R, batch): cum by one thread in order with dt A rounded before the
//    sum (no FMA), bit-equal to the forward's; then S_z or R_z as (P x
//    L)(L x N) products on mma.sync, the weighted B or C in two terms.
//    Writes cum and dt as fp32 rows of each (chunk, head), which the
//    later stages copy with cp.async (a plain load of dt, strided by H,
//    stalled their warps every head), and zeroes stage 5's counters.
// 2. ssd_bwd_scan, one thread per (batch, head, p, n): the reverse scan
//    writes dS_z (fp32, over R_z, and as two bf16 terms), the forward
//    scan H_z as two bf16 terms, and each warp's part of <dS_z, H_z>.
// 3. ssd_bwd_rc, the row and column passes, one block per (64 positions
//    of a chunk, chunk, group of kGroup heads, batch) each: the state
//    terms per head first (dy_i H or x_j dS, scaled per row; V, U and
//    ddt's state term from their row dots), then for each tile of the
//    causal half C B^T once for the group and, per head, dy x^T, the
//    elementwise Q, W's row or column sums (and ddt's direct term), Q
//    summed over the group; then the summed Q, split, times B_j (dC) or
//    C_i (dB).  C B^T and dy x^T are formed twice in all (row and column
//    pass), not three times, and C B^T once a group, not once a head.
// 4. ssd_bwd_dx, one block per (64 positions, 64 columns of P, chunk,
//    head, batch): w_j B_j dS^T, then for each later tile B_j C_i^T, the
//    gate G^T in the scores' registers, split, times dy_i: the forward's
//    stage 3 transposed.  dx sums over i, which the row-and-column
//    blocks could hold only as one accumulator per head, so it keeps a
//    block per head and forms C B^T there once more.
// 5. ssd_bwd_finish, one block per (chunk, head, batch): dcum, its
//    reverse cumsum (one thread, in order), ddt and the chunk's part of
//    d_a_log; the last block of a head (a counter, then a fixed-order
//    sum) writes d_a_log.  Further blocks sum the dB and dC partials
//    over the head groups.
// Every sum runs in a fixed order (the counter only picks which block
// sums), so two calls on the same inputs give the same bits.
// Tiles are 64 x 64 with K of 64 (or N), copied with 16-byte cp.async
// where P, N and the bases allow it (plain loads otherwise), pitched 72
// (or N + 8) bf16 so ldmatrix's rows hit distinct banks.  Products are
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with ldmatrix operands,
// not wgmma: the Q and G operands are formed in each warp's registers
// from a score fragment, and 64 x 64 tiles of depth 64 are too small for
// wgmma's asynchronous pipeline to pay for (as in ssd_tc.cu).  Offsets
// are 64-bit.
//
// The launcher is a plain C function (no PyTorch headers) that returns
// cudaGetLastError, so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_bwd_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPitchP = kT + 8;
// bf16 terms of each fp32 operand (tests/test_torch_ssd.py reads these).
constexpr int kTermsS = 2;      // w_j B_j in S_z
constexpr int kTermsR = 2;      // exp(cum_i) C_i in R_z
constexpr int kTermsH = 2;      // H_z in dC's state term and V
constexpr int kTermsDS = 2;     // dS_z in dB's and dx's state terms and U
constexpr int kTermsQ = 2;      // sum_h Q in dB's and dC's products
constexpr int kTermsG = 2;      // G in dx's product with dy
static_assert(kTermsS == kTermsR, "stage 1 stages one weighted operand");
constexpr int kPlanes = kTermsH > kTermsDS ? kTermsH : kTermsDS;

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16) b (16 x 8, bf16).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment addresses for one lane (the PTX ISA's ldmatrix and
// mma.m16n8k16 layouts); ld is the tile's pitch in elements.
// A (16 x 16) from [m][k] storage.
__device__ __forceinline__ const bf16* a_addr(const bf16* t, int ld, int m0,
                                              int k0, int lane) {
  return t + (m0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3);
}
// A (16 x 16) from [k][m] storage (with ldsm_x4_t).
__device__ __forceinline__ const bf16* at_addr(const bf16* t, int ld, int m0,
                                               int k0, int lane) {
  return t + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
         (((lane >> 3) & 1) << 3);
}
// B for two n8 tiles (16 x 16) from [n][k] storage: r0, r1 are tile 0's
// b0, b1 and r2, r3 tile 1's.
__device__ __forceinline__ const bf16* b_addr(const bf16* t, int ld, int n0,
                                              int k0, int lane) {
  return t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
         (((lane >> 3) & 1) << 3);
}
// The same from [k][n] storage (with ldsm_x4_t).
__device__ __forceinline__ const bf16* bt_addr(const bf16* t, int ld, int n0,
                                               int k0, int lane) {
  return t + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 +
         ((lane >> 4) << 3);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Starts copying R rows x W columns of a bf16 matrix (row stride ld)
// into a tile with pitch `pitch`, zero past (nrows, ncols): by cp.async
// where vec (ncols % 8 == 0, 16-byte aligned rows), else by plain loads.
template <int R, int W>
__device__ __forceinline__ void load_tile(bf16* dst, int pitch,
                                          const bf16* src, int64_t ld,
                                          int nrows, int ncols, bool vec) {
  constexpr int kChunks = R * W / 8;
  if (vec) {
#pragma unroll
    for (int i = 0; i < kChunks / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (W / 8), c = (idx % (W / 8)) * 8;
      const bool ok = (r < nrows) & (c < ncols);
      cp_async16(smem_u32(dst + r * pitch + c),
                 ok ? src + static_cast<int64_t>(r) * ld + c : src, ok);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kChunks; idx += kThreads) {
    const int r = idx / (W / 8), c = (idx % (W / 8)) * 8;
    bf16* dp = dst + r * pitch + c;
    const bf16* sp = src + static_cast<int64_t>(r) * ld + c;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dp[e] = (r < nrows && c + e < ncols) ? sp[e] : __float2bfloat16(0.f);
  }
}

// v as T bf16 terms (hi, then the bf16 of each remainder) at t[0],
// t[stride], ...
template <int T>
__device__ __forceinline__ void split_to(float v, bf16* t, int64_t stride) {
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const bf16 q = __float2bfloat16(v);
    t[k * stride] = q;
    v -= f32(q);
  }
}

// Stage 2's store of H_z and dS_z for this route: kTermsH and kTermsDS
// bf16 planes (hsp, dsp, each (kPlanes, B, nC, H, P, N) apart by plane).
struct StatesSplit {
  bf16* hsp;
  bf16* dsp;
  int64_t plane;
  __device__ __forceinline__ void h(float*, int64_t o, float v) const {
    split_to<kTermsH>(v, hsp + o, plane);
  }
  __device__ __forceinline__ void ds(int64_t o, float v) const {
    split_to<kTermsDS>(v, dsp + o, plane);
  }
};

// A 16 x 64 accumulator tile (rows g, g + 8; columns nt * 8 + 2 tq, + 1)
// as T bf16 terms laid out as A fragments over its 64 columns (K).
template <int T>
__device__ __forceinline__ void to_frags(const float (&v)[kT / 8][4],
                                         uint32_t (&f)[T][kT / 16][4]) {
#pragma unroll
  for (int nt = 0; nt < kT / 8; ++nt) {
    float r[4] = {v[nt][0], v[nt][1], v[nt][2], v[nt][3]};
    const int kk = nt >> 1, half = (nt & 1) * 2;
#pragma unroll
    for (int term = 0; term < T; ++term) {
      bf16 q[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        q[e] = __float2bfloat16(r[e]);
        r[e] -= f32(q[e]);
      }
      f[term][kk][half] = pack(q[0], q[1]);
      f[term][kk][half + 1] = pack(q[2], q[3]);
    }
  }
}

// acc (this warp's 16 rows x NCOL) += A (16 x K, from [m][k] storage at
// row m0) times the sum of T B operands (K x NCOL, `bstride` apart), each
// from [k][n] storage when BT, else from [n][k] storage.
template <int NCOL, int K, bool BT, int T>
__device__ __forceinline__ void mma_smem(float (&acc)[NCOL / 8][4],
                                         const bf16* a, int lda,
                                         const bf16* b, int ldb, int bstride,
                                         int m0, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a_addr(a, lda, m0, kk * 16, lane));
#pragma unroll
    for (int term = 0; term < T; ++term)
#pragma unroll
      for (int np = 0; np < NCOL / 16; ++np) {
        uint32_t bf[4];
        const bf16* bb = b + term * bstride;
        if (BT)
          ldsm_x4_t(bf, bt_addr(bb, ldb, np * 16, kk * 16, lane));
        else
          ldsm_x4(bf, b_addr(bb, ldb, np * 16, kk * 16, lane));
        mma(acc[2 * np], af, bf[0], bf[1]);
        mma(acc[2 * np + 1], af, bf[2], bf[3]);
      }
  }
}

// acc (16 rows x NCOL) += the sum of T A operands in fragments (16 x 64)
// times B (64 x NCOL) from [k][n] storage.
template <int NCOL, int T>
__device__ __forceinline__ void mma_frags(float (&acc)[NCOL / 8][4],
                                          const uint32_t (&f)[T][kT / 16][4],
                                          const bf16* b, int ldb, int lane) {
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
    for (int np = 0; np < NCOL / 16; ++np) {
      uint32_t bf[4];
      ldsm_x4_t(bf, bt_addr(b, ldb, np * 16, kk * 16, lane));
#pragma unroll
      for (int term = 0; term < T; ++term) {
        mma(acc[2 * np], f[term][kk], bf[0], bf[1]);
        mma(acc[2 * np + 1], f[term][kk], bf[2], bf[3]);
      }
    }
}

// Stage 1.  NP: N padded to 64 or 128.  Grid (nC, H * n_pt * 2, B):
// which 0 writes S_z to sr's first plane, which 1 R_z to its second.
template <int NP>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states(const bf16* __restrict__ x, const bf16* __restrict__ dt,
               const float* __restrict__ a_log, const bf16* __restrict__ bm,
               const bf16* __restrict__ cm, const bf16* __restrict__ dy,
               float* __restrict__ cum_out, float* __restrict__ dtc,
               float* __restrict__ sr, int* __restrict__ cnt, int s, int h,
               int p, int n, int chunk, int n_pt, int vec) {
  constexpr int kPitchN = NP + 8;
  extern __shared__ float4 smem4[];
  const int cpad = (chunk + 3) & ~3;
  float* sCum = reinterpret_cast<float*>(smem4);     // [chunk]
  float* sW = sCum + cpad;                           // [chunk]
  bf16* sU = reinterpret_cast<bf16*>(sW + cpad);     // 2 x [kT][kPitchP]
  bf16* sV = sU + 2 * kT * kPitchP;                  // 2 x [kT][kPitchN]
  bf16* sWV = sV + 2 * kT * kPitchN;                 // kTermsS x [kT][kPitchN]

  const int z = blockIdx.x, which = blockIdx.y & 1;
  const int rest = blockIdx.y >> 1, hh = rest / n_pt;
  const int p0 = (rest - hh * n_pt) * kT, bb = blockIdx.z;
  const int nc = gridDim.x;
  const int64_t t0 = static_cast<int64_t>(z) * chunk;
  const int len = steps_in(s, t0, chunk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    for (int i = threadIdx.x; i < h; i += kThreads) cnt[i] = 0;
  const float a = -expf(a_log[hh]);
  const int64_t base = static_cast<int64_t>(bb) * s + t0;
  const bf16* dtb = dt + base * h + hh;
  const int64_t x_row = static_cast<int64_t>(h) * p;
  const bf16* ub = (which ? dy : x) + base * x_row +
                   static_cast<int64_t>(hh) * p + p0;
  const bf16* vb = (which ? cm : bm) + base * n;
  auto issue = [&](int t) {   // tile t of x or dy and B or C into stage t % 2
    const int j0 = t * kT, rows = min(kT, len - j0);
    load_tile<kT, kT>(sU + (t & 1) * kT * kPitchP, kPitchP, ub + j0 * x_row,
                      x_row, rows, p - p0, vec);
    load_tile<kT, NP>(sV + (t & 1) * kT * kPitchN, kPitchN,
                      vb + static_cast<int64_t>(j0) * n, n, rows, n, vec);
    cp_async_commit();
  };
  issue(0);

  for (int l = threadIdx.x; l < chunk; l += kThreads)
    sW[l] = l < len ? f32(dtb[static_cast<int64_t>(l) * h]) : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {   // in order; 16 loads at a time ahead of the sums
    float run = 0.f;
    for (int l0 = 0; l0 < chunk; l0 += 16) {
      float v[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = l0 + e < chunk ? sW[l0 + e] : 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (l0 + e < chunk) {
          run = __fadd_rn(run, __fmul_rn(v[e], a));
          sCum[l0 + e] = run;
        }
    }
  }
  __syncthreads();
  const float total = sCum[chunk - 1];
  const int64_t row = ((static_cast<int64_t>(bb) * nc + z) * h + hh) * chunk;
  for (int l = threadIdx.x; l < chunk; l += kThreads) {
    if (which == 0 && p0 == 0) {
      cum_out[row + l] = sCum[l];
      dtc[row + l] = sW[l];
    }
    sW[l] = which ? (l < len ? expf(sCum[l]) : 0.f)        // exp(cum_l)
                  : __fmul_rn(sW[l], expf(total - sCum[l]));   // w_l
  }
  cp_async_wait<0>();
  __syncthreads();

  float acc[NP / 8][4] = {};
  const int n_tiles = (len + kT - 1) / kT;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) issue(t + 1);
    const int j0 = t * kT, rows = min(kT, len - j0);
    const bf16* tU = sU + (t & 1) * kT * kPitchP;
    const bf16* tV = sV + (t & 1) * kT * kPitchN;
    // The weighted B or C, split into kTermsS bf16 terms, 8 columns a
    // thread.
#pragma unroll
    for (int i = 0; i < kT * NP / 8 / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (NP / 8), c = (idx % (NP / 8)) * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(tV + r * kPitchN + c);
      const bf16* rb = reinterpret_cast<const bf16*>(&raw);
      const float w = r < rows ? sW[j0 + r] : 0.f;
      uint4 out[kTermsS];
      bf16* ob = reinterpret_cast<bf16*>(out);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        split_to<kTermsS>(__fmul_rn(f32(rb[e]), w), ob + e, 8);
#pragma unroll
      for (int term = 0; term < kTermsS; ++term)
        *reinterpret_cast<uint4*>(sWV + term * kT * kPitchN + r * kPitchN +
                                  c) = out[term];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4_t(af, at_addr(tU, kPitchP, warp * 16, kk * 16, lane));
#pragma unroll
      for (int term = 0; term < kTermsS; ++term)
#pragma unroll
        for (int np = 0; np < NP / 16; ++np) {
          uint32_t bf[4];
          ldsm_x4_t(bf, bt_addr(sWV + term * kT * kPitchN, kPitchN, np * 16,
                                kk * 16, lane));
          mma(acc[2 * np], af, bf[0], bf[1]);
          mma(acc[2 * np + 1], af, bf[2], bf[3]);
        }
    }
    cp_async_wait<0>();   // the next tile has landed
    __syncthreads();       // and this one's readers are done
  }

  const int64_t plane = static_cast<int64_t>(gridDim.z) * nc * h * p * n;
  float* st = sr + which * plane +
              ((static_cast<int64_t>(bb) * nc + z) * h + hh) *
                  static_cast<int64_t>(p) * n;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = p0 + warp * 16 + g + 8 * (e >> 1);
      const int nn = nt * 8 + 2 * tq + (e & 1);
      if (pp < p && nn < n) st[static_cast<int64_t>(pp) * n + nn] =
          acc[nt][e];
    }
}

// Stage 3, the row pass (ROLE 0: dC, W's row sums + V) and the column
// pass (ROLE 1: dB, W's column sums, U, ddt's direct terms), one block
// each of ssd_bwd_rc.  The block's own 64 positions are the rows of every
// tile it forms; it walks the other tiles of its causal half (earlier
// ones for the row pass, later ones for the column pass), and in each
// the slices of its heads, copying the next slice while it multiplies
// this one.  sc (4, B, nC, H, L): 0 = row sums of W + V, 1 = column sums
// of W, 2 = U, 3 = ddt's direct terms.  dbp, dcp (B, S, ng, N).
template <int NP, int ROLE>
__device__ __forceinline__ void rc_block(
    const bf16* __restrict__ x, const bf16* __restrict__ bm,
    const bf16* __restrict__ cm, const bf16* __restrict__ dy,
    const float* __restrict__ cum, const float* __restrict__ dtc,
    const bf16* __restrict__ hsp, const bf16* __restrict__ dsp,
    float* __restrict__ sc, float* __restrict__ dbp, float* __restrict__ dcp,
    int bsz, int s, int h, int p, int n, int nc, int chunk, int ng, int vec,
    int t, int z, int gi, int bb) {
  constexpr int kPitchN = NP + 8;
  constexpr int NB = NP / 8;
  constexpr int kSlice = kT * kPitchP;
  extern __shared__ float4 smem4[];
  bf16* sOwn = reinterpret_cast<bf16*>(smem4);  // [kT][kPitchN]: C_i or B_j
  bf16* sOth = sOwn + kT * kPitchN;             // the other tile's B or C
  bf16* sX = sOth + kT * kPitchN;               // 2 x the other x or dy slice
  bf16* sA = sX + 2 * kSlice;                   // 2 x the own dy or x slice
  bf16* sS = sOth;   // kPlanes x [kT][kPitchN], over sOth and sX (states)
  float* fOwnCum = reinterpret_cast<float*>(sA + 2 * kSlice);  // 2 x [kT]
  float* fOwnDt = fOwnCum + 2 * kT;
  float* fOthCum = fOwnDt + 2 * kT;
  float* fOthDt = fOthCum + 2 * kT;
  float* fSum = fOthDt + 2 * kT;                // 3 x [kGroup][kT]
  static_assert(kPlanes * kT * kPitchN <= kT * kPitchN + 2 * kSlice,
                "the state planes fit over sOth and sX");

  const int64_t t0 = static_cast<int64_t>(z) * chunk;
  const int len = steps_in(s, t0, chunk);
  const int l0 = t * kT;
  if (l0 >= len) return;
  const int lend = min(len, l0 + kT);
  const int h0 = gi * kGroup, hn = min(kGroup, h - h0);
  const int nps = (p + kT - 1) / kT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16 + g;   // this thread's rows: r0, r0 + 8
  const int64_t xrow = static_cast<int64_t>(h) * p;
  const int64_t base = static_cast<int64_t>(bb) * s + t0;
  const bf16* own_bc = ROLE == 0 ? cm : bm;
  const bf16* oth_bc = ROLE == 0 ? bm : cm;
  const bf16* own_xp = ROLE == 0 ? dy : x;
  const bf16* oth_xp = ROLE == 0 ? x : dy;
  const bf16* planes = ROLE == 0 ? hsp : dsp;
  constexpr int kTermsSt = ROLE == 0 ? kTermsH : kTermsDS;
  const int64_t plane = static_cast<int64_t>(bsz) * nc * h * p * n;
  auto head_row = [&](int hh) {   // the head's row of cum and dtc
    return ((static_cast<int64_t>(bb) * nc + z) * h + hh) * chunk;
  };

  load_tile<kT, NP>(sOwn, kPitchN, own_bc + (base + l0) * n, n, lend - l0,
                    n, vec);
  cp_async_commit();
  for (int i = threadIdx.x; i < 3 * kGroup * kT; i += kThreads) fSum[i] = 0.f;

  // ---- the state terms, per head: dy_i H (rows) or x_j dS (columns),
  // scaled per row by exp(cum_i) or w_j into acc; their row dots with
  // C_i or B_j give V, or U and ddt's state term.
  float acc[NB][4] = {};
  for (int hl = 0; hl < hn; ++hl) {
    const int hh = h0 + hl;
    float tmp[NB][4] = {};
    for (int q0 = 0; q0 < p; q0 += kT) {
      __syncthreads();   // the last readers of sA, sS and the scalars
      load_tile<kT, kT>(sA, kPitchP, own_xp + (base + l0) * xrow +
                                         static_cast<int64_t>(hh) * p + q0,
                        xrow, lend - l0, p - q0, vec);
      const bf16* pv = planes + ((static_cast<int64_t>(bb) * nc + z) * h +
                                 hh) * static_cast<int64_t>(p) * n +
                       static_cast<int64_t>(q0) * n;
#pragma unroll
      for (int term = 0; term < kTermsSt; ++term)
        load_tile<kT, NP>(sS + term * kT * kPitchN, kPitchN,
                          pv + term * plane, n, min(kT, p - q0), n, vec);
      if (q0 == 0)
        load_scalars(fOwnCum, fOwnDt, cum + head_row(hh), dtc + head_row(hh),
                     l0, len);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      mma_smem<NP, kT, true, kTermsSt>(tmp, sA, kPitchP, sS, kPitchN,
                                       kT * kPitchN, warp * 16, lane);
    }
    const float total = cum[head_row(hh) + chunk - 1];
    float dot[2] = {0.f, 0.f}, scale[2], ex[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + 8 * rr;
      const bool ok = l0 + r < lend;
      ex[rr] = ok ? expf(ROLE == 0 ? fOwnCum[r] : total - fOwnCum[r]) : 0.f;
      scale[rr] = ROLE == 0 ? ex[rr] : ex[rr] * fOwnDt[r];   // exp(cum), w
    }
#pragma unroll
    for (int nt = 0; nt < NB; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1, c = nt * 8 + 2 * tq + (e & 1);
        dot[rr] = fmaf(tmp[nt][e], f32(sOwn[(r0 + 8 * rr) * kPitchN + c]),
                       dot[rr]);
        acc[nt][e] = fmaf(scale[rr], tmp[nt][e], acc[nt][e]);
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float d = quad_sum(dot[rr]);
      if (tq == 0) {
        const int r = r0 + 8 * rr;
        if (ROLE == 0) {
          fSum[hl * kT + r] += scale[rr] * d;                 // V
        } else {
          fSum[(kGroup + hl) * kT + r] = scale[rr] * d;       // U
          fSum[(2 * kGroup + hl) * kT + r] = ex[rr] * d;      // ddt's
        }
      }
    }
  }

  // ---- the causal half: the row pass over tiles u <= t, the column pass
  // over u >= t.  Tiles are formed with the block's own positions as rows:
  // C_i B_j^T and dy_i x_j^T (row pass), B_j C_i^T and x_j dy_i^T (column
  // pass).  Step k of a tile is slice k % nps of head k / nps; the copy of
  // step k + 1 (and its head's scalars, double-buffered by head) runs
  // while step k multiplies.
  const int steps = hn * nps;
  auto issue = [&](int k, int m0, int mend) {
    const int hl = k / nps, q0 = (k - hl * nps) * kT, hh = h0 + hl;
    const int64_t col = static_cast<int64_t>(hh) * p + q0;
    load_tile<kT, kT>(sA + (k & 1) * kSlice, kPitchP,
                      own_xp + (base + l0) * xrow + col, xrow, lend - l0,
                      p - q0, vec);
    load_tile<kT, kT>(sX + (k & 1) * kSlice, kPitchP,
                      oth_xp + (base + m0) * xrow + col, xrow, mend - m0,
                      p - q0, vec);
    if (q0 == 0) {
      const int sb = (hl & 1) * kT;
      const float* cz = cum + head_row(hh);
      const float* dz = dtc + head_row(hh);
      load_scalars(fOwnCum + sb, fOwnDt + sb, cz, dz, l0, len);
      load_scalars(fOthCum + sb, fOthDt + sb, cz, dz, m0, len);
    }
    cp_async_commit();
  };
  const int u_lo = ROLE == 0 ? 0 : t;
  const int u_hi = ROLE == 0 ? t : (len - 1) / kT;
  for (int u = u_lo; u <= u_hi; ++u) {
    const int m0 = u * kT, mend = min(len, m0 + kT);
    __syncthreads();   // the fold's and the last head's readers are done
    load_tile<kT, NP>(sOth, kPitchN, oth_bc + (base + m0) * n, n, mend - m0,
                      n, vec);
    issue(0, m0, mend);   // commits sOth's copy too
    cp_async_wait<0>();
    __syncthreads();
    float cb[kT / 8][4] = {};
    mma_smem<kT, NP, false, 1>(cb, sOwn, kPitchN, sOth, kPitchN, 0,
                               warp * 16, lane);
    float qs[kT / 8][4] = {};    // Q (or Q^T) summed over the group
    float dxy[kT / 8][4] = {};
    for (int k = 0; k < steps; ++k) {
      if (k + 1 < steps) issue(k + 1, m0, mend);
      mma_smem<kT, kT, false, 1>(dxy, sA + (k & 1) * kSlice, kPitchP,
                                 sX + (k & 1) * kSlice, kPitchP, 0,
                                 warp * 16, lane);
      if ((k + 1) % nps == 0) {   // the head's last slice: its Q and W
        const int hl = k / nps, sb = (hl & 1) * kT;
        const float* oc = fOwnCum + sb;
        const float* od = fOwnDt + sb;
        const float* xc = fOthCum + sb;
        const float* xd = fOthDt + sb;
        float part[2] = {0.f, 0.f}, dpart[2] = {0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = e >> 1, r = r0 + 8 * rr;
            const int c = nt * 8 + 2 * tq + (e & 1);
            const int lo = l0 + r, lx = m0 + c;
            // Row pass: i = lo, j = lx; column pass: j = lo, i = lx.
            const bool ok = ROLE == 0
                                ? (lx <= lo) & (lo < lend)
                                : (lx >= lo) & (lx < mend) & (lo < lend);
            const float arg = ROLE == 0 ? oc[r] - xc[c] : xc[c] - oc[r];
            const float dtj = ROLE == 0 ? xd[c] : od[r];
            const float ev = expf(ok ? arg : -INFINITY);
            const float qv = ok ? ev * dtj * dxy[nt][e] : 0.f;
            part[rr] = fmaf(qv, cb[nt][e], part[rr]);         // W
            if (ROLE == 1)
              dpart[rr] = fmaf(ev * cb[nt][e], dxy[nt][e], dpart[rr]);
            qs[nt][e] += qv;
            dxy[nt][e] = 0.f;
          }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float w = quad_sum(part[rr]);
          const float d = ROLE == 1 ? quad_sum(dpart[rr]) : 0.f;
          if (tq == 0) {
            const int r = r0 + 8 * rr;
            fSum[hl * kT + r] += w;
            if (ROLE == 1) fSum[(2 * kGroup + hl) * kT + r] += d;
          }
        }
      }
      cp_async_wait<0>();   // step k + 1 has landed
      __syncthreads();       // and step k's readers are done
    }
    // The group's Q, split, times B_j (dC) or C_i (dB).
    uint32_t qf[kTermsQ][kT / 16][4];
    to_frags<kTermsQ>(qs, qf);
    mma_frags<NP, kTermsQ>(acc, qf, sOth, kPitchN, lane);
  }

  // ---- write the group's partial dC or dB, then the per-head sums.
  float* part = ROLE == 0 ? dcp : dbp;
#pragma unroll
  for (int nt = 0; nt < NB; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e >> 1), c = nt * 8 + 2 * tq + (e & 1);
      if (l0 + r < lend && c < n)
        part[((base + l0 + r) * ng + gi) * n + c] = acc[nt][e];
    }
  __syncthreads();
  const int64_t scp = static_cast<int64_t>(bsz) * nc * h * chunk;
  for (int i = threadIdx.x; i < hn * kT; i += kThreads) {
    const int hl = i / kT, r = i % kT;
    if (l0 + r >= lend) continue;
    float* row = sc + ((static_cast<int64_t>(bb) * nc + z) * h + h0 + hl) *
                          chunk + l0 + r;
    if (ROLE == 0) {
      row[0] = fSum[hl * kT + r];
    } else {
      row[scp] = fSum[hl * kT + r];
      row[2 * scp] = fSum[(kGroup + hl) * kT + r];
      row[3 * scp] = fSum[(2 * kGroup + hl) * kT + r];
    }
  }
}

// Grid 2 * tiles * nC * ng * B: odd blocks the column pass, even ones the
// row pass, heavy blocks (more tiles to walk) first.
template <int NP>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_rc(const bf16* __restrict__ x, const bf16* __restrict__ bm,
           const bf16* __restrict__ cm, const bf16* __restrict__ dy,
           const float* __restrict__ cum, const float* __restrict__ dtc,
           const bf16* __restrict__ hsp, const bf16* __restrict__ dsp,
           float* __restrict__ sc, float* __restrict__ dbp,
           float* __restrict__ dcp, int bsz, int s, int h, int p, int n,
           int nc, int chunk, int ng, int vec) {
  const int tiles = (chunk + kT - 1) / kT;
  int idx = blockIdx.x;
  const int role = idx & 1;
  idx >>= 1;
  const int per = nc * ng * bsz;
  const int rank = idx / per;
  idx -= rank * per;
  const int z = idx % nc;
  idx /= nc;
  const int gi = idx % ng, bb = idx / ng;
  if (role == 0)
    rc_block<NP, 0>(x, bm, cm, dy, cum, dtc, hsp, dsp, sc, dbp, dcp,
                    bsz, s, h, p, n, nc, chunk, ng, vec, tiles - 1 - rank, z,
                    gi, bb);
  else
    rc_block<NP, 1>(x, bm, cm, dy, cum, dtc, hsp, dsp, sc, dbp, dcp,
                    bsz, s, h, p, n, nc, chunk, ng, vec, rank, z, gi, bb);
}

// Stage 4: dx.  Grid tiles * n_pt * nC * H * B, heavy blocks first.  The
// next tile's C and dy slice are copied while this one multiplies.
template <int NP>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dx(const float* __restrict__ dtc, const bf16* __restrict__ bm,
           const bf16* __restrict__ cm, const bf16* __restrict__ dy,
           const float* __restrict__ cum, const bf16* __restrict__ dsp,
           bf16* __restrict__ dx, int bsz, int s, int h, int p, int n,
           int nc, int chunk, int n_pt, int vec) {
  constexpr int kPitchN = NP + 8;
  extern __shared__ float4 smem4[];
  bf16* sOwn = reinterpret_cast<bf16*>(smem4);  // [kT][kPitchN]: B_j
  bf16* sOth = sOwn + kT * kPitchN;             // 2 x [kT][kPitchN]: C_i
  bf16* sY = sOth + 2 * kT * kPitchN;           // 2 x [kT][kPitchP]: dy_i
  bf16* sS = sY + 2 * kT * kPitchP;             // kTermsDS x [kT][kPitchN]
  float* fOwnCum = reinterpret_cast<float*>(sS + kTermsDS * kT * kPitchN);
  float* fOwnDt = fOwnCum + kT;
  float* fOthCum = fOwnDt + kT;                 // 2 x [kT]
  float* fOthDt = fOthCum + 2 * kT;             // 2 x [kT]

  int idx = blockIdx.x;
  const int per = n_pt * nc * h * bsz;
  const int jt = idx / per;   // heavy (early) tiles first
  idx -= jt * per;
  const int pt = idx % n_pt;
  idx /= n_pt;
  const int z = idx % nc;
  idx /= nc;
  const int hh = idx % h, bb = idx / h;
  const int64_t t0 = static_cast<int64_t>(z) * chunk;
  const int len = steps_in(s, t0, chunk);
  const int j0 = jt * kT, p0 = pt * kT;
  if (j0 >= len) return;
  const int jend = min(len, j0 + kT);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16 + g;
  const int64_t xrow = static_cast<int64_t>(h) * p;
  const int64_t base = static_cast<int64_t>(bb) * s + t0;
  const int64_t row = ((static_cast<int64_t>(bb) * nc + z) * h + hh) * chunk;
  const float* cz = cum + row;
  const float* dz = dtc + row;
  const int64_t plane = static_cast<int64_t>(bsz) * nc * h * p * n;
  auto issue = [&](int u, int buf) {   // tile u's C and dy slice, scalars
    const int m0 = u * kT, rows = min(len, m0 + kT) - m0;
    load_tile<kT, NP>(sOth + buf * kT * kPitchN, kPitchN,
                      cm + (base + m0) * n, n, rows, n, vec);
    load_tile<kT, kT>(sY + buf * kT * kPitchP, kPitchP,
                      dy + (base + m0) * xrow + static_cast<int64_t>(hh) * p +
                          p0,
                      xrow, rows, p - p0, vec);
    load_scalars(fOthCum + buf * kT, fOthDt + buf * kT, cz, dz, m0, len);
    cp_async_commit();
  };

  load_tile<kT, NP>(sOwn, kPitchN, bm + (base + j0) * n, n, jend - j0, n,
                    vec);
  const bf16* pv = dsp + ((static_cast<int64_t>(bb) * nc + z) * h + hh) *
                             static_cast<int64_t>(p) * n +
                   static_cast<int64_t>(p0) * n;
#pragma unroll
  for (int term = 0; term < kTermsDS; ++term)
    load_tile<kT, NP>(sS + term * kT * kPitchN, kPitchN, pv + term * plane,
                      n, min(kT, p - p0), n, vec);
  load_scalars(fOwnCum, fOwnDt, cz, dz, j0, len);
  issue(jt, 0);   // commits the copies above too
  cp_async_wait<0>();
  __syncthreads();

  // The state term w_j (B_j . dS^T), columns p0 .. p0 + 63.
  float acc[kT / 8][4] = {};
  mma_smem<kT, NP, false, kTermsDS>(acc, sOwn, kPitchN, sS, kPitchN,
                                    kT * kPitchN, warp * 16, lane);
  const float total = cz[chunk - 1];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 8 * rr;
    const float w = j0 + r < jend ? expf(total - fOwnCum[r]) * fOwnDt[r]
                                  : 0.f;
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt) {
      acc[nt][2 * rr] *= w;
      acc[nt][2 * rr + 1] *= w;
    }
  }

  const int u_hi = (len - 1) / kT;
  for (int u = jt; u <= u_hi; ++u) {
    const int m0 = u * kT, mend = min(len, m0 + kT);
    const int buf = (u - jt) & 1;
    if (u < u_hi) issue(u + 1, buf ^ 1);
    const bf16* tC = sOth + buf * kT * kPitchN;
    const float* xc = fOthCum + buf * kT;
    float cb[kT / 8][4] = {};    // B_j . C_i
    mma_smem<kT, NP, false, 1>(cb, sOwn, kPitchN, tC, kPitchN, 0,
                               warp * 16, lane);
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 8 * (e >> 1), c = nt * 8 + 2 * tq + (e & 1);
        const int lo = j0 + r, lx = m0 + c;
        const bool ok = (lx >= lo) & (lx < mend) & (lo < jend);
        const float gv = cb[nt][e] *
                         expf(ok ? xc[c] - fOwnCum[r] : -INFINITY) *
                         fOwnDt[r];
        cb[nt][e] = ok ? gv : 0.f;                 // G^T
      }
    uint32_t gf[kTermsG][kT / 16][4];
    to_frags<kTermsG>(cb, gf);
    mma_frags<kT, kTermsG>(acc, gf, sY + buf * kT * kPitchP, kPitchP, lane);
    cp_async_wait<0>();   // tile u + 1 has landed
    __syncthreads();       // and tile u's readers are done
  }

#pragma unroll
  for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e >> 1), c = p0 + nt * 8 + 2 * tq + (e & 1);
      if (j0 + r < jend && c < p)
        dx[(base + j0 + r) * xrow + static_cast<int64_t>(hh) * p + c] =
            __float2bfloat16(acc[nt][e]);
    }
}

template <int NP>
int launch(const bf16* x, const bf16* dt, const float* a_log, const bf16* b,
           const bf16* c, const bf16* dy, const float* dfin, bf16* dx,
           bf16* ddt, float* da, bf16* db, bf16* dc, float* cum, float* dtc,
           float* sr,
           bf16* hsp, bf16* dsp, float* dhp, float* sc, float* dbp,
           float* dcp, float* dap, int* cnt, int bsz, int s, int h, int p,
           int n, int chunk, int vec, cudaStream_t stm) {
  constexpr int kPitchN = NP + 8;
  const int nc = (s + chunk - 1) / chunk, n_pt = (p + kT - 1) / kT;
  const int tiles = (chunk + kT - 1) / kT, ng = (h + kGroup - 1) / kGroup;
  const int cpad = (chunk + 3) & ~3;
  cudaError_t err;
  const int bytes1 = 2 * cpad * 4 +
                     (2 * kT * kPitchP + (2 + kTermsS) * kT * kPitchN) * 2;
  err = cudaFuncSetAttribute(ssd_bwd_states<NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes1);
  if (err != cudaSuccess) return err;
  ssd_bwd_states<NP><<<dim3(nc, h * n_pt * 2, bsz), kThreads, bytes1, stm>>>(
      x, dt, a_log, b, c, dy, cum, dtc, sr, cnt, s, h, p, n, chunk, n_pt,
      vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  err = launch_scan(cum, dfin, sr,
                    StatesSplit{hsp, dsp,
                                static_cast<int64_t>(bsz) * nc * h * p * n},
                    dhp, bsz, h, p, n, nc, chunk, stm);
  if (err != cudaSuccess) return err;

  const int bytes3 = (2 * kT * kPitchN + 4 * kT * kPitchP) * 2 +
                     (8 * kT + 3 * kGroup * kT) * 4;
  err = cudaFuncSetAttribute(ssd_bwd_rc<NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes3);
  if (err != cudaSuccess) return err;
  ssd_bwd_rc<NP><<<2 * tiles * nc * ng * bsz, kThreads, bytes3, stm>>>(
      x, b, c, dy, cum, dtc, hsp, dsp, sc, dbp, dcp, bsz, s, h, p, n, nc,
      chunk, ng, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int bytes4 = ((3 + kTermsDS) * kT * kPitchN + 2 * kT * kPitchP) * 2 +
                     6 * kT * 4;
  err = cudaFuncSetAttribute(ssd_bwd_dx<NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes4);
  if (err != cudaSuccess) return err;
  ssd_bwd_dx<NP><<<tiles * n_pt * nc * h * bsz, kThreads, bytes4, stm>>>(
      dtc, b, c, dy, cum, dsp, dx, bsz, s, h, p, n, nc, chunk, n_pt, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  return launch_finish(dtc, a_log, cum, sc, dhp, dbp, dcp, ddt, db, dc, dap,
                       da, cnt, bsz, s, h, p, n, nc, chunk, ng, stm);
}

}  // namespace

// x (B, S, H, P), dt (B, S, H), b and c (B, S, 1, N), dy (B, S, H, P)
// bf16; a_log (H,) and d_final (B, H, P, N; may be null) fp32.  Outputs
// dx, ddt, db, dc bf16 and d_a_log fp32.  Scratch, with nC = ceil(S /
// chunk), ng = ceil(H / 8) and nw = 8 ceil(P N / 256): cum and dtc (B,
// nC, H, chunk), sr (2, B, nC, H, P, N), dhp (B, H, nC, nw), sc (4, B,
// nC, H, chunk), dbp and dcp (B, S, ng, N), dap (B, nC, H) fp32; hsp and
// dsp (2, B, nC, H, P, N) bf16; cnt (H,) int32.  All contiguous; 1 <= N
// <= 128, 1 <= chunk <= 1024; vec != 0 when P % 8 == 0, N % 8 == 0 and
// x, b, c, dy and the scratch are 16-byte aligned.
extern "C" int ssd_bwd_tc_launch(
    const void* x, const void* dt, const void* a_log, const void* b,
    const void* c, const void* dy, const void* dfin, void* dx, void* ddt,
    void* da, void* db, void* dc, void* cum, void* dtc, void* sr, void* hsp,
    void* dsp, void* dhp, void* sc, void* dbp, void* dcp, void* dap,
    void* cnt, int bsz, int s, int h, int p, int n, int chunk, int vec,
    void* stream) {
  if (bsz <= 0 || h <= 0 || p <= 0 || s <= 0) return 0;
  if (n <= 0 || n > 128 || chunk <= 0 || chunk > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  auto B = [](const void* q) { return static_cast<const bf16*>(q); };
  auto O = [](void* q) { return static_cast<bf16*>(q); };
  auto F = [](void* q) { return static_cast<float*>(q); };
  const float* aa = static_cast<const float*>(a_log);
  const float* ff = static_cast<const float*>(dfin);
  int* ct = static_cast<int*>(cnt);
  return n <= 64
             ? launch<64>(B(x), B(dt), aa, B(b), B(c), B(dy), ff, O(dx),
                          O(ddt), F(da), O(db), O(dc), F(cum), F(dtc), F(sr),
                          O(hsp), O(dsp), F(dhp), F(sc), F(dbp), F(dcp),
                          F(dap), ct, bsz, s, h, p, n, chunk, vec, stm)
             : launch<128>(B(x), B(dt), aa, B(b), B(c), B(dy), ff, O(dx),
                           O(ddt), F(da), O(db), O(dc), F(cum), F(dtc),
                           F(sr), O(hsp), O(dsp), F(dhp), F(sc), F(dbp),
                           F(dcp), F(dap), ct, bsz, s, h, p, n, chunk, vec,
                           stm);
}
