// The Mamba2 SSD chunked scan (one group) on bf16 inputs, in three
// chunk-parallel stages with the products on the bf16 tensor cores;
// returns y and the fp32 final state.
//
// Replaces repro/kernels/ssd/kernel.py::ssd_pallas (body _ssd_kernel) for
// bf16 inputs; fp32 inputs take ssd.cu.  It computes what the plain
// version (ref.py::ssd_chunked) computes, per batch b and head h with
// A = -exp(a_log[h]), over chunks of L steps:
//
//   cum_i   = sum_{l <= i} dt_l A                    (inclusive, in order)
//   y_i     = exp(cum_i) (C_i . state)                       inter-chunk
//           + sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   state   = state exp(cum_{L-1})
//           + sum_j x_j (B_j dt_j exp(cum_{L-1} - cum_j))
//
// x (B, S, H, P), dt (B, S, H), b and c (B, S, 1, N) bf16, a_log (H,)
// float32 -> y (B, S, H, P) bf16, state (B, H, P, N) float32.  S need not
// be a multiple of L: the steps past S act as the plain version's padding
// (dt = 0, x = B = C = 0).
//
// Bound.  Every product can run on the bf16 tensor cores: the scores
// C B^T in one pass (bf16 operands, exact products), and each product
// with an fp32 operand (the gate, B dt exp(..) for the chunk states, the
// carried state for the inter-chunk term) in two, as two bf16 terms: the
// fewest that meet the bf16 tolerances (tests/test_torch_ssd.py).  At the
// path's shape (1, 8192, 64, 64), N = 64, L = 256 that is
// 2 x (8.6e9 + 4.3e9 + 4.3e9) + 1.4e8 FLOP at 989e12 FLOP/s, 0.035 ms,
// against 0.041 ms for its ~138 MB of bf16 in and out: bytes bind.
// This kernel takes three terms for the chunk states and the inter-chunk
// term (below).  (The fp32 scratch between the stages, about 100 MB of
// traffic at that shape, is the design's, not the function's.)
//
// Design: the plain version's decomposition, one kernel a stage, all
// launched by one call on one stream with scratch from the wrapper.
// 1. ssd_states, one block per (chunk, head, 64 columns of P, batch):
//    cum by one thread in order, with dt A rounded before the sum (no
//    FMA), so the decays equal the plain version's bit for bit; then the
//    chunk state x^T (B dt exp(total - cum)), (P x L)(L x N), with the
//    weighted B split into three bf16 terms.  It writes cum and the
//    state to scratch: (B, nC, H, L) and (B, nC, H, P, N) float32.
// 2. ssd_scan, one thread per (batch, head, p, n): the sequential scan
//    over chunks, state_c = state_{c-1} exp(total_c) + S_c, rounding as
//    the plain version does.  The state before each chunk is written as
//    its three bf16 terms, (3, B, nC, H, P, N), the operand stage 3
//    copies as it is; the last state is the final state.
// 3. ssd_out, one block per (64 rows of a chunk, chunk, head, 64
//    columns of P, batch), heaviest row tiles first: y = exp(cum_i)
//    (C_i . state_prev) over the state's three terms, plus, for each
//    column tile up to the diagonal, the scores C B^T, the gate
//    (scores exp(cum_i - cum_j)) dt_j formed in the scores' registers,
//    and its product with x from those registers, split into two terms.
// At the long shape stage 3 runs 8,192 blocks and stage 1 2,048, where
// the single-kernel design ran 64.  Stages 1 and 3 copy their tiles
// with 16-byte cp.async into two stages, the next tile loading while
// this one is multiplied (plain loads where P or N % 8 != 0); stage 3
// reuses the state's shared memory for its second stage once the
// inter-chunk term has read it.  Loops of global loads issue their loads
// in batches ahead of the arithmetic: a load a step left them latency-
// bound.
// Products are mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with
// operands from ldmatrix, not wgmma: the gate is an A operand formed in
// each warp's registers from the score fragment (16 rows a warp), the
// split terms multiply each fragment two or three times, and a stage's
// tiles are 64 x 64 with K of 64, too small for wgmma's asynchronous
// pipeline to pay for its 128-thread fragment.  Tiles are staged with
// a pitch of 72 bf16 (144 bytes), so ldmatrix's 8 rows hit distinct
// banks.  Offsets are 64-bit.
//
// The launcher is a plain C function (no PyTorch headers) that returns
// cudaGetLastError, so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;         // tile edge: rows, steps, columns of P
constexpr int kThreads = 128;  // 4 warps, 16 rows each
constexpr int kPitchP = kT + 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// Fragment addresses for one lane (see the PTX ISA's ldmatrix and
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

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
      cp_async16(dst + r * pitch + c,
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

// v as three bf16 terms hi + mid + lo (about fp32's 24 bits), stored at
// t[0], t[stride], t[2 stride].
__device__ __forceinline__ void split3(float v, bf16* t, int64_t stride) {
  const bf16 hi = __float2bfloat16(v);
  const float r = v - __bfloat162float(hi);
  const bf16 mid = __float2bfloat16(r);
  t[0] = hi;
  t[stride] = mid;
  t[2 * stride] = __float2bfloat16(r - __bfloat162float(mid));
}

// Stage 1.  NP: the state's N padded to 64 or 128.
template <int NP>
__global__ void __launch_bounds__(kThreads)
ssd_states(const bf16* __restrict__ x, const bf16* __restrict__ dt,
           const float* __restrict__ a_log, const bf16* __restrict__ bm,
           float* __restrict__ cum_out, float* __restrict__ st_out, int s,
           int h, int p, int n, int chunk, int n_pt, int vec) {
  constexpr int kPitchN = NP + 8;
  extern __shared__ float4 smem4[];
  const int cpad = (chunk + 3) & ~3;
  float* sCum = reinterpret_cast<float*>(smem4);     // [chunk]
  float* sW = sCum + cpad;                           // [chunk]
  bf16* sX = reinterpret_cast<bf16*>(sW + cpad);     // 2 x [kT][kPitchP]
  bf16* sB = sX + 2 * kT * kPitchP;                  // 2 x [kT][kPitchN]
  bf16* sWB = sB + 2 * kT * kPitchN;                 // 3 x [kT][kPitchN]

  const int z = blockIdx.x, hh = blockIdx.y / n_pt;
  const int p0 = (blockIdx.y - hh * n_pt) * kT, bb = blockIdx.z;
  const int nc = gridDim.x, t0 = z * chunk, len = min(chunk, s - t0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float a = -expf(a_log[hh]);
  const bf16* dtb = dt + (static_cast<int64_t>(bb) * s + t0) * h + hh;
  const int64_t x_row = static_cast<int64_t>(h) * p;
  const bf16* xb = x + (static_cast<int64_t>(bb) * s + t0) * x_row +
                   static_cast<int64_t>(hh) * p + p0;
  const bf16* bb_m = bm + (static_cast<int64_t>(bb) * s + t0) * n;
  auto issue = [&](int t) {   // tile t of x and B into stage t % 2
    const int j0 = t * kT, rows = min(kT, len - j0);
    load_tile<kT, kT>(sX + (t & 1) * kT * kPitchP, kPitchP, xb + j0 * x_row,
                      x_row, rows, p - p0, vec);
    load_tile<kT, NP>(sB + (t & 1) * kT * kPitchN, kPitchN,
                      bb_m + static_cast<int64_t>(j0) * n, n, rows, n, vec);
    cp_async_commit();
  };
  issue(0);

  for (int l = threadIdx.x; l < len; l += kThreads)
    sW[l] = __bfloat162float(dtb[static_cast<int64_t>(l) * h]);
  __syncthreads();
  if (threadIdx.x == 0) {   // in order; 16 loads at a time ahead of the sums
    float run = 0.f;
    for (int l0 = 0; l0 < len; l0 += 16) {
      float v[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = l0 + e < len ? sW[l0 + e] : 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (l0 + e < len) {
          run = __fadd_rn(run, __fmul_rn(v[e], a));
          sCum[l0 + e] = run;
        }
    }
  }
  __syncthreads();
  const float total = sCum[len - 1];
  float* cum_b = cum_out + ((static_cast<int64_t>(bb) * nc + z) * h + hh) *
                               chunk;
  for (int l = threadIdx.x; l < len; l += kThreads) {
    if (p0 == 0) cum_b[l] = sCum[l];
    sW[l] = __fmul_rn(sW[l], expf(total - sCum[l]));   // dt_l decay_l
  }
  cp_async_wait_all();
  __syncthreads();

  float acc[NP / 8][4] = {};
  const int n_tiles = (len + kT - 1) / kT;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) issue(t + 1);
    const int j0 = t * kT, rows = min(kT, len - j0);
    const bf16* tX = sX + (t & 1) * kT * kPitchP;
    const bf16* tB = sB + (t & 1) * kT * kPitchN;
    // The weighted B, split into three bf16 terms, 8 columns a thread.
#pragma unroll
    for (int i = 0; i < kT * NP / 8 / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (NP / 8), c = (idx % (NP / 8)) * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(tB + r * kPitchN + c);
      const bf16* rb = reinterpret_cast<const bf16*>(&raw);
      const float w = r < rows ? sW[j0 + r] : 0.f;
      uint4 out[3];
      bf16* ob = reinterpret_cast<bf16*>(out);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        split3(__fmul_rn(__bfloat162float(rb[e]), w), ob + e, 8);
#pragma unroll
      for (int term = 0; term < 3; ++term)
        *reinterpret_cast<uint4*>(sWB + term * kT * kPitchN + r * kPitchN +
                                  c) = out[term];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4_t(af, at_addr(tX, kPitchP, warp * 16, kk * 16, lane));
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int np = 0; np < NP / 16; ++np) {
          uint32_t bf[4];
          ldsm_x4_t(bf, bt_addr(sWB + term * kT * kPitchN, kPitchN, np * 16,
                                kk * 16, lane));
          mma(acc[2 * np], af, bf[0], bf[1]);
          mma(acc[2 * np + 1], af, bf[2], bf[3]);
        }
    }
    cp_async_wait_all();   // the next tile has landed
    __syncthreads();       // and this one's readers are done
  }

  float* st = st_out + ((static_cast<int64_t>(bb) * nc + z) * h + hh) *
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

// Stage 2: one thread per (batch, head, p, n) element of the state; the
// loads of 8 chunks are issued before their sums.  The state before each
// chunk goes to prev as three bf16 terms (planes of B nC H P N values),
// the operand of stage 3's inter-chunk product.
__global__ void ssd_scan(const float* __restrict__ cum,
                         const float* __restrict__ st, bf16* __restrict__ prev,
                         float* __restrict__ fin, int bsz, int s, int h,
                         int pn, int chunk, int nc) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t hpn = static_cast<int64_t>(h) * pn;
  if (e >= bsz * hpn) return;
  const int64_t bb = e / hpn, rest = e - bb * hpn;
  const int hh = static_cast<int>(rest / pn);
  const int64_t plane = bsz * nc * hpn;
  float carry = 0.f;
  for (int z0 = 0; z0 < nc; z0 += 8) {
    float total[8] = {}, upd[8] = {};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int z = z0 + k;
      if (z < nc) {
        const int len = min(chunk, s - z * chunk);
        total[k] = cum[((bb * nc + z) * h + hh) * chunk + len - 1];
        upd[k] = st[(bb * nc + z) * hpn + rest];
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (z0 + k < nc) {
        split3(carry, prev + (bb * nc + z0 + k) * hpn + rest, plane);
        carry = __fadd_rn(__fmul_rn(carry, expf(total[k])), upd[k]);
      }
  }
  fin[e] = carry;
}

// Stage 3.
template <int NP>
__global__ void __launch_bounds__(kThreads)
ssd_out(const bf16* __restrict__ x, const bf16* __restrict__ dt,
        const bf16* __restrict__ bm, const bf16* __restrict__ cm,
        const float* __restrict__ cum, const bf16* __restrict__ prev,
        bf16* __restrict__ y, int s, int h, int p, int n, int chunk,
        int nc, int n_pt, int vec) {
  constexpr int kPitchN = NP + 8;
  extern __shared__ float4 smem4[];
  const int cpad = (chunk + 3) & ~3;
  float* sCum = reinterpret_cast<float*>(smem4);     // [chunk]
  float* sDt = sCum + cpad;                          // [chunk]
  bf16* sC = reinterpret_cast<bf16*>(sDt + cpad);    // [kT][kPitchN]
  bf16* sS = sC + kT * kPitchN;                      // 3 x [kT][kPitchN]
  // Two stages of (B [kT][kPitchN], x [kT][kPitchP]); the second takes
  // the state's space once the inter-chunk term has read it.
  bf16* sB0 = sS + 3 * kT * kPitchN;
  bf16* sX0 = sB0 + kT * kPitchN;
  bf16* sB1 = sS;
  bf16* sX1 = sS + kT * kPitchN;

  const int n_rt = (chunk + kT - 1) / kT;
  const int it = n_rt - 1 - static_cast<int>(blockIdx.x) / nc;   // heavy first
  const int z = blockIdx.x % nc;
  const int hh = blockIdx.y / n_pt, p0 = (blockIdx.y - hh * n_pt) * kT;
  const int bb = blockIdx.z;
  const int t0 = z * chunk, len = min(chunk, s - t0), i0 = it * kT;
  if (i0 >= len) return;
  const int i_end = min(len, i0 + kT);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;

  const int64_t x_row = static_cast<int64_t>(h) * p;
  const bf16* xb = x + (static_cast<int64_t>(bb) * s + t0) * x_row +
                   static_cast<int64_t>(hh) * p + p0;
  const bf16* cb = cm + (static_cast<int64_t>(bb) * s + t0) * n;
  const bf16* bb_m = bm + (static_cast<int64_t>(bb) * s + t0) * n;
  auto issue = [&](int jt) {   // column tile jt of B and x into stage jt % 2
    const int j0 = jt * kT, rows = min(kT, len - j0);
    load_tile<kT, NP>(jt & 1 ? sB1 : sB0, kPitchN,
                      bb_m + static_cast<int64_t>(j0) * n, n, rows, n, vec);
    load_tile<kT, kT>(jt & 1 ? sX1 : sX0, kPitchP, xb + j0 * x_row, x_row,
                      rows, p - p0, vec);
  };
  load_tile<kT, NP>(sC, kPitchN, cb + static_cast<int64_t>(i0) * n, n,
                    i_end - i0, n, vec);
  // The state before this chunk, rows p0.., as its three bf16 terms.
  const int64_t plane = static_cast<int64_t>(gridDim.z) * nc * h * p * n;
  const bf16* pv = prev + ((static_cast<int64_t>(bb) * nc + z) * h + hh) *
                              static_cast<int64_t>(p) * n +
                   static_cast<int64_t>(p0) * n;
#pragma unroll
  for (int term = 0; term < 3; ++term)
    load_tile<kT, NP>(sS + term * kT * kPitchN, kPitchN, pv + term * plane, n,
                      p - p0, n, vec);
  issue(0);
  cp_async_commit();

  const float* cum_b = cum + ((static_cast<int64_t>(bb) * nc + z) * h + hh) *
                                 chunk;
  const bf16* dtb = dt + (static_cast<int64_t>(bb) * s + t0) * h + hh;
  for (int l = threadIdx.x; l < i_end; l += kThreads) {
    sCum[l] = cum_b[l];
    sDt[l] = __bfloat162float(dtb[static_cast<int64_t>(l) * h]);
  }
  cp_async_wait_all();
  __syncthreads();

  uint32_t cf[NP / 16][4];   // this warp's 16 rows of C, as A fragments
#pragma unroll
  for (int kk = 0; kk < NP / 16; ++kk)
    ldsm_x4(cf[kk], a_addr(sC, kPitchN, warp * 16, kk * 16, lane));

  // Inter-chunk term: exp(cum_i) (C_i . state_prev).
  float acc[kT / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk < NP / 16; ++kk)
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int np = 0; np < kT / 16; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, b_addr(sS + term * kT * kPitchN, kPitchN, np * 16,
                           kk * 16, lane));
        mma(acc[2 * np], cf[kk], bf[0], bf[1]);
        mma(acc[2 * np + 1], cf[kk], bf[2], bf[3]);
      }
  const int il = i0 + warp * 16 + g;   // this thread's rows: il, il + 8
  float ecum[2], cum_i[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = il + 8 * r;
    cum_i[r] = i < i_end ? sCum[i] : 0.f;
    ecum[r] = i < i_end ? expf(cum_i[r]) : 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] *= ecum[e >> 1];
  __syncthreads();   // the state's space becomes stage 1

  for (int jt = 0; jt <= it; ++jt) {
    if (jt < it) {
      issue(jt + 1);
      cp_async_commit();
    }
    const int j0 = jt * kT;
    const bf16* tB = jt & 1 ? sB1 : sB0;
    const bf16* tX = jt & 1 ? sX1 : sX0;
    float sc[kT / 8][4] = {};   // scores C_i . B_j
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk)
#pragma unroll
      for (int np = 0; np < kT / 16; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, b_addr(tB, kPitchN, np * 16, kk * 16, lane));
        mma(sc[2 * np], cf[kk], bf[0], bf[1]);
        mma(sc[2 * np + 1], cf[kk], bf[2], bf[3]);
      }
    // The gate, (scores exp(cum_i - cum_j)) dt_j for j <= i, split into
    // two bf16 terms laid out as A fragments over j.
    uint32_t ghi[kT / 16][4], glo[kT / 16][4];
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt) {
      bf16 hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = il + 8 * (e >> 1);
        const int j = j0 + nt * 8 + 2 * tq + (e & 1);
        // Branch-free (a branch per element costs more than the gate):
        // the exp's argument and the result are selected, not guarded.
        const bool ok = (j <= i) & (i < i_end);
        float gv = __fmul_rn(
            __fmul_rn(sc[nt][e],
                      expf(ok ? __fsub_rn(cum_i[e >> 1], sCum[j]) : -INFINITY)),
            sDt[j]);
        gv = ok ? gv : 0.f;
        hi[e] = __float2bfloat16(gv);
        lo[e] = __float2bfloat16(gv - __bfloat162float(hi[e]));
      }
      const int kk = nt >> 1, half = (nt & 1) * 2;
      ghi[kk][half] = pack(hi[0], hi[1]);
      ghi[kk][half + 1] = pack(hi[2], hi[3]);
      glo[kk][half] = pack(lo[0], lo[1]);
      glo[kk][half + 1] = pack(lo[2], lo[3]);
    }
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
      for (int np = 0; np < kT / 16; ++np) {
        uint32_t bf[4];
        ldsm_x4_t(bf, bt_addr(tX, kPitchP, np * 16, kk * 16, lane));
        mma(acc[2 * np], ghi[kk], bf[0], bf[1]);
        mma(acc[2 * np + 1], ghi[kk], bf[2], bf[3]);
        mma(acc[2 * np], glo[kk], bf[0], bf[1]);
        mma(acc[2 * np + 1], glo[kk], bf[2], bf[3]);
      }
    cp_async_wait_all();   // the next tile has landed
    __syncthreads();       // and this one's readers are done
  }

  bf16* yb = y + (static_cast<int64_t>(bb) * s + t0) * x_row +
             static_cast<int64_t>(hh) * p;
#pragma unroll
  for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = il + 8 * (e >> 1);
      const int pp = p0 + nt * 8 + 2 * tq + (e & 1);
      if (i < i_end && pp < p)
        yb[static_cast<int64_t>(i) * x_row + pp] =
            __float2bfloat16(acc[nt][e]);
    }
}

template <int NP>
int launch(const void* x, const void* dt, const void* a_log, const void* b,
           const void* c, void* y, void* fin, void* cum, void* st,
           void* prev, int bsz,
           int s, int h, int p, int n, int chunk, int vec,
           cudaStream_t stream) {
  const int nc = (s + chunk - 1) / chunk, n_pt = (p + kT - 1) / kT;
  const int pitch_n = NP + 8, cpad = (chunk + 3) & ~3;
  const auto* xx = static_cast<const bf16*>(x);
  const auto* dd = static_cast<const bf16*>(dt);
  const auto* bb = static_cast<const bf16*>(b);
  const auto* cc = static_cast<const bf16*>(c);
  auto* cu = static_cast<float*>(cum);
  auto* stp = static_cast<float*>(st);
  cudaError_t err;
  if (nc > 0) {
    const int bytes1 = 2 * cpad * 4 +
                       (2 * kT * kPitchP + 5 * kT * pitch_n) * 2;
    err = cudaFuncSetAttribute(ssd_states<NP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes1);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_states<NP><<<dim3(nc, h * n_pt, bsz), kThreads, bytes1, stream>>>(
        xx, dd, static_cast<const float*>(a_log), bb, cu, stp, s, h, p, n,
        chunk, n_pt, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t elems = static_cast<int64_t>(bsz) * h * p * n;
  ssd_scan<<<static_cast<unsigned>((elems + 255) / 256), 256, 0, stream>>>(
      cu, stp, static_cast<bf16*>(prev), static_cast<float*>(fin), bsz, s, h,
      p * n, chunk, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess || nc == 0) return static_cast<int>(err);
  const int bytes3 = 2 * cpad * 4 +
                     (5 * kT * pitch_n + kT * kPitchP) * 2;
  err = cudaFuncSetAttribute(ssd_out<NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes3);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_rt = (chunk + kT - 1) / kT;
  ssd_out<NP><<<dim3(nc * n_rt, h * n_pt, bsz), kThreads, bytes3, stream>>>(
      xx, dd, bb, cc, cu, static_cast<const bf16*>(prev),
      static_cast<bf16*>(y), s, h, p, n, chunk, nc, n_pt, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, S, H, P); dt: (B, S, H); a_log: (H,) float32; b, c: (B, S, 1,
// N); y: (B, S, H, P), all bfloat16 but a_log; fin: (B, H, P, N)
// float32.  Scratch, float32: cum (B, nC, H, chunk) and st (B, nC, H, P,
// N), nC = ceil(S / chunk).  All contiguous; 1 <= N <= 128,
// 1 <= chunk <= 1024; vec != 0 when P % 8 == 0, N % 8 == 0 and every
// pointer is 16-byte aligned.
extern "C" int ssd_tc_launch(const void* x, const void* dt, const void* a_log,
                             const void* b, const void* c, void* y, void* fin,
                             void* cum, void* st, void* prev, int bsz, int s,
                             int h, int p, int n, int chunk, int vec,
                             void* stream) {
  if (bsz <= 0 || h <= 0 || p <= 0) return 0;
  if (n <= 0 || n > 128 || chunk <= 0 || chunk > 1024 || s < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  return n <= 64 ? launch<64>(x, dt, a_log, b, c, y, fin, cum, st, prev,
                              bsz, s, h, p, n, chunk, vec, stm)
                 : launch<128>(x, dt, a_log, b, c, y, fin, cum, st, prev,
                               bsz, s, h, p, n, chunk, vec, stm);
}
