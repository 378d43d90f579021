// The backward of the Mamba2 SSD chunked scan (one group) on fp32 inputs,
// with every product on the TF32 tensor cores: the gradients of y and the
// final state with respect to x, dt, a_log, B and C.  bf16 inputs take
// ssd_bwd_tc.cu, whose five-kernel structure this file shares.
//
// Reference.  The JAX package has no backward kernel: jax.grad
// differentiates the plain repro/kernels/ssd/ref.py:35 ssd_chunked, and
// ssd_pallas (repro/kernels/ssd/kernel.py:80) has no custom_vjp.  This
// kernel is held to ref.py::ssd_chunked_bwd (autograd through the port's
// plain scan).
//
// Maths, the head fold and the padding past S: ssd_bwd_common.cuh,
// which also holds stages 2 and 5, shared with the bf16 route.
//
// Products: mma.sync.m16n8k8 .tf32 in the 3xTF32 split of
// csrc/tf32_mma.cuh, every operand split into hi = tf32(x) and lo =
// tf32(x - hi) in registers as its fragment loads, each product hi hi +
// (hi lo + lo hi) with hi hi and the small terms in separate
// accumulators: kPasses = 3 TF32 products per fp32 product.  A weighted
// operand (w_j B_j, exp(cum_i) C_i) is weighted in fp32 as it loads, as
// the plain version weights it.  Tensor-core sums round toward zero, so
// every sum over positions (the chunk states over a chunk, the gate's
// products over the causal half) is formed afresh per 64-step tile and
// added in fp32.  tests/test_torch_ssd.py emulates this arithmetic and
// finds it as close to jax.vjp as an exact fp32 evaluation of the same
// stages (within 1e-5 max |ref|, d_a_log 1e-3); one or two passes miss
// by 29-48x.
//
// Stages, one kernel each, launched by one call on one stream (five
// launches; the first, CUDA-core design took nine):
// 1. ssd_bwd_states, one block per (chunk, head, 64 columns of P, 64 of
//    N, S or R, batch): cum by one thread in order with dt A rounded
//    before the sum (no FMA), bit-equal to the forward's; then S_z or R_z
//    as (P x L)(L x N) products.  Writes cum and dt as fp32 rows of each
//    (chunk, head), which the later stages copy with cp.async, and zeroes
//    stage 5's counters.
// 2. ssd_bwd_scan, one thread per (batch, head, p, n): the reverse scan
//    writes dS_z over R_z, the forward scan H_z over S_z, and each warp's
//    part of <dS_z, H_z>.
// 3. ssd_bwd_rc, the row and column passes, one block per (64 positions
//    of a chunk, chunk, group of kGroup heads, batch) each: the state
//    terms per head first (dy_i H or x_j dS, scaled per row; V, U and
//    ddt's state term from their row dots), then for each tile of the
//    causal half C B^T once for the group and, per head, dy x^T, the
//    elementwise Q, W's row or column sums (and ddt's direct term), Q
//    summed over the group; then the summed Q times B_j (dC) or C_i (dB).
// 4. ssd_bwd_dx, one block per (64 positions, 64 columns of P, chunk,
//    head, batch): w_j B_j dS^T, then for each later tile B_j C_i^T, the
//    gate G^T in the scores' registers, times dy_i.
// 5. ssd_bwd_finish, one block per (chunk, head, batch): dcum, its
//    reverse cumsum (one thread, in order), ddt and the chunk's part of
//    d_a_log; the last block of a head (a counter, then a fixed-order
//    sum) writes d_a_log.  Further blocks sum the dB and dC partials
//    over the head groups.
// Every sum runs in a fixed order (the counter only picks which block
// sums), so two calls on the same inputs give the same bits.
// Tiles are 64 x 64 (or 64 x N) fp32, 4 warps a block of 16 rows each,
// copied with 16-byte cp.async where P, N and the bases allow it (plain
// loads otherwise).  Each tile's pitch puts the fragment loads it serves
// on 32 distinct banks: 4 mod 32 floats for tiles read row by row
// ([m][k], [n][k]; by ldmatrix, four fp32 a lane an instruction) or in
// MMA-slot order, 8 mod 32 for tiles read down their columns ([k][m],
// [k][n]).  Offsets are 64-bit.
//
// Bound (chip_smoke.py ssd_bwd_bound): C B^T, sum_h Q B and sum_h Q C
// (l (l + 1) N each a chunk), per head dy x^T and G dy (l (l + 1) P each)
// and five (P x l)(l x N) products, three TF32 passes each.  At zamba2's
// training shape (2, 2048, 64, 64), N = 64, L = 256: 0.1188 ms at the
// card's 494e12 TF32 FLOP/s; operations bind.
//
// The launcher is a plain C function (no PyTorch headers) that returns
// cudaGetLastError, so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/tf32_mma.cuh"
#include "ssd_bwd_common.cuh"

namespace {

constexpr int kPitchR = kT + 4;   // position x 64 tiles read by rows
constexpr int kPitchC = kT + 8;   // stage 1's tiles, read down columns
static_assert(kPasses == 3, "mma3 issues hi lo, lo hi, hi hi");

// Fragments of mma.m16n8k8 (the PTX ISA's layouts), each value split as
// it loads.  A (16 x 8) from [m][k] storage at t = (m0, k0), by ldmatrix:
__device__ __forceinline__ void frag_a(const float* t, int ld, int lane,
                                       uint32_t (&h)[4], uint32_t (&l)[4]) {
  uint32_t r[4];
  ldsm_a(r, t, ld, lane);
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), h[i], l[i]);
}
// A from [k][m] storage at t = (k0, m0).
__device__ __forceinline__ void frag_at(const float* t, int ld, int g,
                                        int tq, uint32_t (&h)[4],
                                        uint32_t (&l)[4]) {
  const float* p = t + tq * ld + g;
  split(p[0], h[0], l[0]);
  split(p[8], h[1], l[1]);
  split(p[4 * ld], h[2], l[2]);
  split(p[4 * ld + 8], h[3], l[3]);
}
// B of two 8-column tiles (8 x 16) from [n][k] storage at t = (n0, k0),
// by ldmatrix: h[0], h[1] the first tile's, h[2], h[3] the second's.
__device__ __forceinline__ void frag_b2(const float* t, int ld, int lane,
                                        uint32_t (&h)[4], uint32_t (&l)[4]) {
  uint32_t r[4];
  ldsm_b2(r, t, ld, lane);
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), h[i], l[i]);
}
// B from [k][n] storage at t = (k0, n0), row k times w[k] (w at k0)
// where kW.
template <bool kW>
__device__ __forceinline__ void frag_bt(const float* t, int ld, int g,
                                        int tq, const float* w,
                                        uint32_t (&h)[2], uint32_t (&l)[2]) {
  const float v0 = t[tq * ld + g], v1 = t[(tq + 4) * ld + g];
  split(kW ? __fmul_rn(v0, w[tq]) : v0, h[0], l[0]);
  split(kW ? __fmul_rn(v1, w[tq + 4]) : v1, h[1], l[1]);
}
// B from [k][n] storage in MMA-slot order (slot t is row 2t of each 8,
// slot t + 4 row 2t + 1): the rows that to_frags' A fragments pair with.
__device__ __forceinline__ void frag_bp(const float* t, int ld, int g,
                                        int tq, uint32_t (&h)[2],
                                        uint32_t (&l)[2]) {
  split(t[2 * tq * ld + g], h[0], l[0]);
  split(t[(2 * tq + 1) * ld + g], h[1], l[1]);
}

// A 16 x 64 accumulator tile (rows g, g + 8; columns nt * 8 + 2 tq, + 1)
// as split A fragments over its 64 columns (K), slot t of each 8 taking
// column 2t and slot t + 4 column 2t + 1.
__device__ __forceinline__ void to_frags(const float (&v)[kT / 8][4],
                                         uint32_t (&fh)[kT / 8][4],
                                         uint32_t (&fl)[kT / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kT / 8; ++kk) {
    split(v[kk][0], fh[kk][0], fl[kk][0]);
    split(v[kk][2], fh[kk][1], fl[kk][1]);
    split(v[kk][1], fh[kk][2], fl[kk][2]);
    split(v[kk][3], fh[kk][3], fl[kk][3]);
  }
}

template <int C>
__device__ __forceinline__ void zero(float (&v)[C][4]) {
#pragma unroll
  for (int i = 0; i < C; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[i][e] = 0.f;
}

// big, sm (this warp's 16 rows x 64 columns) += A B over K: A from [m][k]
// storage at a (the warp's first row), B from [n][k] storage at b.
template <int K>
__device__ __forceinline__ void mma_nk(float (&big)[kT / 8][4],
                                       float (&sm)[kT / 8][4], const float* a,
                                       int lda, const float* b, int ldb,
                                       int g, int tq) {
  const int lane = 4 * g + tq;
#pragma unroll 1
  for (int kk = 0; kk < K / 8; ++kk) {
    uint32_t ah[4], al[4];
    frag_a(a + 8 * kk, lda, lane, ah, al);
#pragma unroll
    for (int nt = 0; nt < kT / 8; nt += 2) {
      uint32_t bh[4], bl[4];
      frag_b2(b + 8 * nt * ldb + 8 * kk, ldb, lane, bh, bl);
      mma3(big[nt], sm[nt], ah, al, bh[0], bh[1], bl[0], bl[1]);
      mma3(big[nt + 1], sm[nt + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
    }
  }
}
// The same with B from [k][n] storage at b, its rows weighted by w where
// kW, and A from [k][m] storage where kAT.
template <int K, bool kAT, bool kW>
__device__ __forceinline__ void mma_kn(float (&big)[kT / 8][4],
                                       float (&sm)[kT / 8][4], const float* a,
                                       int lda, const float* b, int ldb,
                                       const float* w, int g, int tq) {
#pragma unroll 1
  for (int kk = 0; kk < K / 8; ++kk) {
    uint32_t ah[4], al[4];
    if (kAT)
      frag_at(a + 8 * kk * lda, lda, g, tq, ah, al);
    else
      frag_a(a + 8 * kk, lda, 4 * g + tq, ah, al);
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt) {
      uint32_t bh[2], bl[2];
      frag_bt<kW>(b + 8 * kk * ldb + 8 * nt, ldb, g, tq, w + 8 * kk, bh,
                  bl);
      mma3(big[nt], sm[nt], ah, al, bh[0], bh[1], bl[0], bl[1]);
    }
  }
}
// big, sm (16 x 64) += F B: F the fragments of to_frags (16 x 64), B 64
// rows of [k][n] storage at b, read in slot order.
__device__ __forceinline__ void mma_frags(float (&big)[kT / 8][4],
                                          float (&sm)[kT / 8][4],
                                          const uint32_t (&fh)[kT / 8][4],
                                          const uint32_t (&fl)[kT / 8][4],
                                          const float* b, int ldb, int g,
                                          int tq) {
#pragma unroll 1
  for (int kk = 0; kk < kT / 8; ++kk)
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt) {
      uint32_t bh[2], bl[2];
      frag_bp(b + 8 * kk * ldb + 8 * nt, ldb, g, tq, bh, bl);
      mma3(big[nt], sm[nt], fh[kk], fl[kk], bh[0], bh[1], bl[0], bl[1]);
    }
}

// Starts copying R rows x W columns of an fp32 matrix (row stride ld)
// into a tile with pitch `pitch`, zero past (nrows, ncols): by cp.async
// where vec (ncols % 4 == 0, 16-byte aligned rows), else by plain loads.
template <int R, int W>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const float* src, int64_t ld,
                                          int nrows, int ncols, bool vec) {
  constexpr int kChunks = R * W / 4;
  if (vec) {
#pragma unroll
    for (int i = 0; i < kChunks / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (W / 4), c = (idx % (W / 4)) * 4;
      const bool ok = (r < nrows) & (c < ncols);
      cp_async16(smem_u32(dst + r * pitch + c),
                 ok ? src + static_cast<int64_t>(r) * ld + c : src, ok);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kChunks; idx += kThreads) {
    const int r = idx / (W / 4), c = (idx % (W / 4)) * 4;
    float* dp = dst + r * pitch + c;
    const float* sp = src + static_cast<int64_t>(r) * ld + c;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[e] = (r < nrows && c + e < ncols) ? sp[e] : 0.f;
  }
}

// Stage 1.  Grid (nC, H * n_pt * n_nt * 2, B): which 0 writes S_z to
// sr's first plane, which 1 R_z to its second; 64 columns of P by 64 of N
// a block.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a_log, const float* __restrict__ bm,
               const float* __restrict__ cm, const float* __restrict__ dy,
               float* __restrict__ cum_out, float* __restrict__ dtc,
               float* __restrict__ sr, int* __restrict__ cnt, int s, int h,
               int p, int n, int chunk, int n_pt, int n_nt, int vec) {
  extern __shared__ float4 smem4[];
  const int cpad = (chunk + kT - 1) / kT * kT;       // whole tiles
  float* sCum = reinterpret_cast<float*>(smem4);     // [cpad]
  float* sW = sCum + cpad;                           // [cpad]
  float* sU = sW + cpad;                             // 2 x [kT][kPitchC]
  float* sV = sU + 2 * kT * kPitchC;                 // 2 x [kT][kPitchC]

  const int z = blockIdx.x, which = blockIdx.y & 1;
  int rest = blockIdx.y >> 1;
  const int n0 = (rest % n_nt) * kT;
  rest /= n_nt;
  const int p0 = (rest % n_pt) * kT, hh = rest / n_pt, bb = blockIdx.z;
  const int nc = gridDim.x;
  const int64_t t0 = static_cast<int64_t>(z) * chunk;
  const int len = steps_in(s, t0, chunk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    for (int i = threadIdx.x; i < h; i += kThreads) cnt[i] = 0;
  const float a = -expf(a_log[hh]);
  const int64_t base = static_cast<int64_t>(bb) * s + t0;
  const float* dtb = dt + base * h + hh;
  const int64_t x_row = static_cast<int64_t>(h) * p;
  const float* ub = (which ? dy : x) + base * x_row +
                    static_cast<int64_t>(hh) * p + p0;
  const float* vb = (which ? cm : bm) + base * n + n0;
  auto issue = [&](int t) {   // tile t of x or dy and B or C into stage t % 2
    const int j0 = t * kT, rows = min(kT, len - j0);
    load_tile<kT, kT>(sU + (t & 1) * kT * kPitchC, kPitchC, ub + j0 * x_row,
                      x_row, rows, p - p0, vec);
    load_tile<kT, kT>(sV + (t & 1) * kT * kPitchC, kPitchC,
                      vb + static_cast<int64_t>(j0) * n, n, rows, n - n0,
                      vec);
    cp_async_commit();
  };
  issue(0);

  for (int l = threadIdx.x; l < cpad; l += kThreads)
    sW[l] = l < len ? dtb[static_cast<int64_t>(l) * h] : 0.f;
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
  for (int l = threadIdx.x; l < cpad; l += kThreads) {
    if (which == 0 && p0 == 0 && n0 == 0 && l < chunk) {
      cum_out[row + l] = sCum[l];
      dtc[row + l] = sW[l];
    }
    sW[l] = l >= len ? 0.f
            : which  ? expf(sCum[l])                          // exp(cum_l)
                     : __fmul_rn(sW[l], expf(total - sCum[l]));   // w_l
  }
  cp_async_wait<0>();
  __syncthreads();

  // The state (this warp's 16 rows of P x 64 of N): each tile's product
  // formed afresh and added in fp32.
  float acc[kT / 8][4], big[kT / 8][4], sm[kT / 8][4];
  zero(acc);
  const int n_tiles = (len + kT - 1) / kT;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) issue(t + 1);
    zero(big);
    zero(sm);
    mma_kn<kT, true, true>(big, sm, sU + (t & 1) * kT * kPitchC + warp * 16,
                           kPitchC, sV + (t & 1) * kT * kPitchC, kPitchC,
                           sW + t * kT, g, tq);
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += big[nt][e] + sm[nt][e];
    cp_async_wait<0>();   // the next tile has landed
    __syncthreads();      // and this one's readers are done
  }

  const int64_t plane = static_cast<int64_t>(gridDim.z) * nc * h * p * n;
  float* st = sr + which * plane +
              ((static_cast<int64_t>(bb) * nc + z) * h + hh) *
                  static_cast<int64_t>(p) * n;
#pragma unroll
  for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = p0 + warp * 16 + g + 8 * (e >> 1);
      const int nn = n0 + nt * 8 + 2 * tq + (e & 1);
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
// this one.  hst, dst: H_z and dS_z (B, nC, H, P, N).  sc (4, B, nC, H,
// L): 0 = row sums of W + V, 1 = column sums of W, 2 = U, 3 = ddt's
// direct terms.  dbp, dcp (B, S, ng, N).
template <int NP, int ROLE>
__device__ __forceinline__ void rc_block(
    const float* __restrict__ x, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ dy,
    const float* __restrict__ cum, const float* __restrict__ dtc,
    const float* __restrict__ hst, const float* __restrict__ dst,
    float* __restrict__ sc, float* __restrict__ dbp, float* __restrict__ dcp,
    int bsz, int s, int h, int p, int n, int nc, int chunk, int ng, int vec,
    int t, int z, int gi, int bb) {
  constexpr int kPitchN = NP + 4;   // sOwn, sOth: by rows, slot order
  constexpr int kPitchS = NP + 8;   // the state slice: down its columns
  constexpr int NH = NP / kT;       // 64-column halves of N
  constexpr int kSlice = kT * kPitchR;
  extern __shared__ float4 smem4[];
  float* sOwn = reinterpret_cast<float*>(smem4);  // [kT][kPitchN]: C_i or B_j
  float* sOth = sOwn + kT * kPitchN;              // the other tile's B or C
  float* sX = sOth + kT * kPitchN;                // 2 x the other x or dy slice
  float* sA = sX + 2 * kSlice;                    // 2 x the own dy or x slice
  float* sS = sOth;   // [kT][kPitchS] state slice, over sOth and sX
  float* fOwnCum = sA + 2 * kSlice;               // 2 x [kT]
  float* fOwnDt = fOwnCum + 2 * kT;
  float* fOthCum = fOwnDt + 2 * kT;
  float* fOthDt = fOthCum + 2 * kT;
  float* fSum = fOthDt + 2 * kT;                  // 3 x [kGroup][kT]
  static_assert(kT * kPitchS <= kT * kPitchN + 2 * kSlice,
                "the state slice fits over sOth and sX");

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
  const float* own_bc = ROLE == 0 ? cm : bm;
  const float* oth_bc = ROLE == 0 ? bm : cm;
  const float* own_xp = ROLE == 0 ? dy : x;
  const float* oth_xp = ROLE == 0 ? x : dy;
  const float* state = ROLE == 0 ? hst : dst;
  auto head_row = [&](int hh) {   // the head's row of cum and dtc
    return ((static_cast<int64_t>(bb) * nc + z) * h + hh) * chunk;
  };

  load_tile<kT, NP>(sOwn, kPitchN, own_bc + (base + l0) * n, n, lend - l0,
                    n, vec);
  cp_async_commit();
  for (int i = threadIdx.x; i < 3 * kGroup * kT; i += kThreads) fSum[i] = 0.f;

  // ---- the state terms, per head: dy_i H (rows) or x_j dS (columns),
  // 64 columns of N at a time, scaled per row by exp(cum_i) or w_j into
  // acc; their row dots with C_i or B_j give V, or U and ddt's state term.
  float acc[NP / 8][4];
#pragma unroll
  for (int i = 0; i < NP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  for (int hl = 0; hl < hn; ++hl) {
    const int hh = h0 + hl;
    const float total = cum[head_row(hh) + chunk - 1];
    float dot[2] = {0.f, 0.f}, scale[2], ex[2];
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) {
      float big[kT / 8][4], sm[kT / 8][4];
      zero(big);
      zero(sm);
      for (int q0 = 0; q0 < p; q0 += kT) {
        if (nh == 0 || nps > 1) {   // one slice stays for both halves
          __syncthreads();   // the last readers of sA, sS and the scalars
          load_tile<kT, kT>(sA, kPitchR,
                            own_xp + (base + l0) * xrow +
                                static_cast<int64_t>(hh) * p + q0,
                            xrow, lend - l0, p - q0, vec);
          load_tile<kT, NP>(sS, kPitchS,
                            state + ((static_cast<int64_t>(bb) * nc + z) *
                                         h + hh) * static_cast<int64_t>(p) *
                                        n + static_cast<int64_t>(q0) * n,
                            n, min(kT, p - q0), n, vec);
          if (q0 == 0 && nh == 0)
            load_scalars(fOwnCum, fOwnDt, cum + head_row(hh),
                         dtc + head_row(hh), l0, len);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
        }
        mma_kn<kT, false, false>(big, sm, sA + warp * 16 * kPitchR,
                                 kPitchR, sS + nh * kT, kPitchS, nullptr, g,
                                 tq);
      }
      if (nh == 0) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = r0 + 8 * rr;
          const bool ok = l0 + r < lend;
          ex[rr] = ok ? expf(ROLE == 0 ? fOwnCum[r] : total - fOwnCum[r])
                      : 0.f;
          scale[rr] = ROLE == 0 ? ex[rr] : ex[rr] * fOwnDt[r];  // exp(cum), w
        }
      }
#pragma unroll
      for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = e >> 1, c = nh * kT + nt * 8 + 2 * tq + (e & 1);
          const float tv = big[nt][e] + sm[nt][e];
          dot[rr] = fmaf(tv, sOwn[(r0 + 8 * rr) * kPitchN + c], dot[rr]);
          acc[nh * 8 + nt][e] = fmaf(scale[rr], tv, acc[nh * 8 + nt][e]);
        }
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
    load_tile<kT, kT>(sA + (k & 1) * kSlice, kPitchR,
                      own_xp + (base + l0) * xrow + col, xrow, lend - l0,
                      p - q0, vec);
    load_tile<kT, kT>(sX + (k & 1) * kSlice, kPitchR,
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
    float cb[kT / 8][4];
    {
      float big[kT / 8][4], sm[kT / 8][4];
      zero(big);
      zero(sm);
      mma_nk<NP>(big, sm, sOwn + warp * 16 * kPitchN, kPitchN, sOth,
                 kPitchN, g, tq);
#pragma unroll
      for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) cb[nt][e] = big[nt][e] + sm[nt][e];
    }
    float qs[kT / 8][4];    // Q (or Q^T) summed over the group
    float db_[kT / 8][4], ds_[kT / 8][4];   // dy x^T, hi hi and small terms
    zero(qs);
    zero(db_);
    zero(ds_);
    for (int k = 0; k < steps; ++k) {
      if (k + 1 < steps) issue(k + 1, m0, mend);
      mma_nk<kT>(db_, ds_, sA + (k & 1) * kSlice + warp * 16 * kPitchR,
                 kPitchR, sX + (k & 1) * kSlice, kPitchR, g, tq);
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
            const float dxy = db_[nt][e] + ds_[nt][e];
            const float ev = expf(ok ? arg : -INFINITY);
            const float qv = ok ? ev * dtj * dxy : 0.f;
            part[rr] = fmaf(qv, cb[nt][e], part[rr]);         // W
            if (ROLE == 1)
              dpart[rr] = fmaf(ev * cb[nt][e], dxy, dpart[rr]);
            qs[nt][e] += qv;
            db_[nt][e] = ds_[nt][e] = 0.f;
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
      __syncthreads();      // and step k's readers are done
    }
    // The group's Q times B_j (dC) or C_i (dB), 64 columns of N at a
    // time, formed afresh and added to acc in fp32.
    uint32_t qh[kT / 8][4], ql[kT / 8][4];
    to_frags(qs, qh, ql);
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) {
      float big[kT / 8][4], sm[kT / 8][4];
      zero(big);
      zero(sm);
      mma_frags(big, sm, qh, ql, sOth + nh * kT, kPitchN, g, tq);
#pragma unroll
      for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[nh * 8 + nt][e] += big[nt][e] + sm[nt][e];
    }
  }

  // ---- write the group's partial dC or dB, then the per-head sums.
  float* part = ROLE == 0 ? dcp : dbp;
#pragma unroll
  for (int nt = 0; nt < NP / 8; ++nt)
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
ssd_bwd_rc(const float* __restrict__ x, const float* __restrict__ bm,
           const float* __restrict__ cm, const float* __restrict__ dy,
           const float* __restrict__ cum, const float* __restrict__ dtc,
           const float* __restrict__ hst, const float* __restrict__ dst,
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
    rc_block<NP, 0>(x, bm, cm, dy, cum, dtc, hst, dst, sc, dbp, dcp, bsz, s,
                    h, p, n, nc, chunk, ng, vec, tiles - 1 - rank, z, gi, bb);
  else
    rc_block<NP, 1>(x, bm, cm, dy, cum, dtc, hst, dst, sc, dbp, dcp, bsz, s,
                    h, p, n, nc, chunk, ng, vec, rank, z, gi, bb);
}

// Stage 4: dx.  Grid tiles * n_pt * nC * H * B, heavy blocks first.  The
// next tile's C and dy slice are copied while this one multiplies.
template <int NP>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dx(const float* __restrict__ dtc, const float* __restrict__ bm,
           const float* __restrict__ cm, const float* __restrict__ dy,
           const float* __restrict__ cum, const float* __restrict__ dst,
           float* __restrict__ dx, int bsz, int s, int h, int p, int n,
           int nc, int chunk, int n_pt, int vec) {
  constexpr int kPitchN = NP + 4;
  extern __shared__ float4 smem4[];
  float* sOwn = reinterpret_cast<float*>(smem4);  // [kT][kPitchN]: B_j
  float* sOth = sOwn + kT * kPitchN;              // 2 x [kT][kPitchN]: C_i
  float* sY = sOth + 2 * kT * kPitchN;            // 2 x [kT][kPitchR]: dy_i
  float* sS = sY + 2 * kT * kPitchR;              // [kT][kPitchN]: dS rows
  float* fOwnCum = sS + kT * kPitchN;
  float* fOwnDt = fOwnCum + kT;
  float* fOthCum = fOwnDt + kT;                   // 2 x [kT]
  float* fOthDt = fOthCum + 2 * kT;               // 2 x [kT]

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
  auto issue = [&](int u, int buf) {   // tile u's C and dy slice, scalars
    const int m0 = u * kT, rows = min(len, m0 + kT) - m0;
    load_tile<kT, NP>(sOth + buf * kT * kPitchN, kPitchN,
                      cm + (base + m0) * n, n, rows, n, vec);
    load_tile<kT, kT>(sY + buf * kT * kPitchR, kPitchR,
                      dy + (base + m0) * xrow + static_cast<int64_t>(hh) * p +
                          p0,
                      xrow, rows, p - p0, vec);
    load_scalars(fOthCum + buf * kT, fOthDt + buf * kT, cz, dz, m0, len);
    cp_async_commit();
  };

  load_tile<kT, NP>(sOwn, kPitchN, bm + (base + j0) * n, n, jend - j0, n,
                    vec);
  load_tile<kT, NP>(sS, kPitchN,
                    dst + ((static_cast<int64_t>(bb) * nc + z) * h + hh) *
                              static_cast<int64_t>(p) * n +
                        static_cast<int64_t>(p0) * n,
                    n, min(kT, p - p0), n, vec);
  load_scalars(fOwnCum, fOwnDt, cz, dz, j0, len);
  issue(jt, 0);   // commits the copies above too
  cp_async_wait<0>();
  __syncthreads();

  // The state term w_j (B_j . dS^T), columns p0 .. p0 + 63.
  float acc[kT / 8][4];
  {
    float big[kT / 8][4], sm[kT / 8][4];
    zero(big);
    zero(sm);
    mma_nk<NP>(big, sm, sOwn + warp * 16 * kPitchN, kPitchN, sS, kPitchN, g,
               tq);
    const float total = cz[chunk - 1];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + 8 * rr;
      const float w = j0 + r < jend ? expf(total - fOwnCum[r]) * fOwnDt[r]
                                    : 0.f;
#pragma unroll
      for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc[nt][2 * rr + e] = (big[nt][2 * rr + e] + sm[nt][2 * rr + e]) *
                                w;
    }
  }

  const int u_hi = (len - 1) / kT;
  for (int u = jt; u <= u_hi; ++u) {
    const int m0 = u * kT, mend = min(len, m0 + kT);
    const int buf = (u - jt) & 1;
    if (u < u_hi) issue(u + 1, buf ^ 1);
    const float* tC = sOth + buf * kT * kPitchN;
    const float* xc = fOthCum + buf * kT;
    float cb[kT / 8][4];    // B_j . C_i, then G^T
    {
      float big[kT / 8][4], sm[kT / 8][4];
      zero(big);
      zero(sm);
      mma_nk<NP>(big, sm, sOwn + warp * 16 * kPitchN, kPitchN, tC, kPitchN,
                 g, tq);
#pragma unroll
      for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + 8 * (e >> 1), c = nt * 8 + 2 * tq + (e & 1);
          const int lo = j0 + r, lx = m0 + c;
          const bool ok = (lx >= lo) & (lx < mend) & (lo < jend);
          const float gv = (big[nt][e] + sm[nt][e]) *
                           expf(ok ? xc[c] - fOwnCum[r] : -INFINITY) *
                           fOwnDt[r];
          cb[nt][e] = ok ? gv : 0.f;
        }
    }
    uint32_t gh[kT / 8][4], gl[kT / 8][4];
    to_frags(cb, gh, gl);
    float big[kT / 8][4], sm[kT / 8][4];
    zero(big);
    zero(sm);
    mma_frags(big, sm, gh, gl, sY + buf * kT * kPitchR, kPitchR, g, tq);
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += big[nt][e] + sm[nt][e];
    cp_async_wait<0>();   // tile u + 1 has landed
    __syncthreads();      // and tile u's readers are done
  }

#pragma unroll
  for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e >> 1), c = p0 + nt * 8 + 2 * tq + (e & 1);
      if (j0 + r < jend && c < p)
        dx[(base + j0 + r) * xrow + static_cast<int64_t>(hh) * p + c] =
            acc[nt][e];
    }
}

template <int NP>
int launch(const float* x, const float* dt, const float* a_log,
           const float* b, const float* c, const float* dy,
           const float* dfin, float* dx, float* ddt, float* da, float* db,
           float* dc, float* cum, float* dtc, float* sr, float* dhp,
           float* sc, float* dbp, float* dcp, float* dap, int* cnt, int bsz,
           int s, int h, int p, int n, int chunk, int vec,
           cudaStream_t stm) {
  constexpr int kPitchN = NP + 4;
  const int nc = (s + chunk - 1) / chunk, n_pt = (p + kT - 1) / kT;
  const int n_nt = (n + kT - 1) / kT;
  const int tiles = (chunk + kT - 1) / kT, ng = (h + kGroup - 1) / kGroup;
  const int cpad = tiles * kT;
  const int64_t plane = static_cast<int64_t>(bsz) * nc * h * p * n;
  cudaError_t err;
  const int bytes1 = (2 * cpad + 4 * kT * kPitchC) * 4;
  err = cudaFuncSetAttribute(ssd_bwd_states,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes1);
  if (err != cudaSuccess) return err;
  ssd_bwd_states<<<dim3(nc, h * n_pt * n_nt * 2, bsz), kThreads, bytes1,
                   stm>>>(x, dt, a_log, b, c, dy, cum, dtc, sr, cnt, s, h, p,
                          n, chunk, n_pt, n_nt, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  err = launch_scan(cum, dfin, sr, StatesInPlace{}, dhp, bsz, h, p, n, nc,
                    chunk, stm);
  if (err != cudaSuccess) return err;

  const int bytes3 = (2 * kT * kPitchN + 4 * kT * kPitchR) * 4 +
                     (8 * kT + 3 * kGroup * kT) * 4;
  err = cudaFuncSetAttribute(ssd_bwd_rc<NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes3);
  if (err != cudaSuccess) return err;
  ssd_bwd_rc<NP><<<2 * tiles * nc * ng * bsz, kThreads, bytes3, stm>>>(
      x, b, c, dy, cum, dtc, sr, sr + plane, sc, dbp, dcp, bsz, s, h, p, n,
      nc, chunk, ng, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int bytes4 = (4 * kT * kPitchN + 2 * kT * kPitchR) * 4 + 6 * kT * 4;
  err = cudaFuncSetAttribute(ssd_bwd_dx<NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes4);
  if (err != cudaSuccess) return err;
  ssd_bwd_dx<NP><<<tiles * n_pt * nc * h * bsz, kThreads, bytes4, stm>>>(
      dtc, b, c, dy, cum, sr + plane, dx, bsz, s, h, p, n, nc, chunk, n_pt,
      vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  return launch_finish(dtc, a_log, cum, sc, dhp, dbp, dcp, ddt, db, dc, dap,
                       da, cnt, bsz, s, h, p, n, nc, chunk, ng, stm);
}

}  // namespace

// x (B, S, H, P), dt (B, S, H), b and c (B, S, 1, N), dy (B, S, H, P),
// a_log (H,) and d_final (B, H, P, N; may be null), all fp32.  Outputs
// dx, ddt, db, dc and d_a_log fp32.  Scratch (fp32 but cnt), with nC =
// ceil(S / chunk), ng = ceil(H / 8) and nw = 8 ceil(P N / 256): cum and
// dtc (B, nC, H, chunk), sr (2, B, nC, H, P, N: S_z then H_z, R_z then
// dS_z), dhp (B, H, nC, nw), sc (4, B, nC, H, chunk), dbp and dcp (B, S,
// ng, N), dap (B, nC, H); cnt (H,) int32.  All contiguous; 1 <= N <= 128,
// 1 <= chunk <= 1024; vec != 0 when P % 4 == 0, N % 4 == 0 and x, b, c,
// dy and the scratch are 16-byte aligned.
extern "C" int ssd_bwd_launch(const void* x, const void* dt,
                              const void* a_log, const void* b, const void* c,
                              const void* dy, const void* dfin, void* dx,
                              void* ddt, void* da, void* db, void* dc,
                              void* cum, void* dtc, void* sr, void* dhp,
                              void* sc, void* dbp, void* dcp, void* dap,
                              void* cnt, int bsz, int s, int h, int p, int n,
                              int chunk, int vec, void* stream) {
  if (bsz <= 0 || h <= 0 || p <= 0 || s <= 0) return 0;
  if (n <= 0 || n > 128 || chunk <= 0 || chunk > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  auto I = [](const void* q) { return static_cast<const float*>(q); };
  auto F = [](void* q) { return static_cast<float*>(q); };
  int* ct = static_cast<int*>(cnt);
  return n <= 64
             ? launch<64>(I(x), I(dt), I(a_log), I(b), I(c), I(dy), I(dfin),
                          F(dx), F(ddt), F(da), F(db), F(dc), F(cum), F(dtc),
                          F(sr), F(dhp), F(sc), F(dbp), F(dcp), F(dap), ct,
                          bsz, s, h, p, n, chunk, vec, stm)
             : launch<128>(I(x), I(dt), I(a_log), I(b), I(c), I(dy), I(dfin),
                           F(dx), F(ddt), F(da), F(db), F(dc), F(cum),
                           F(dtc), F(sr), F(dhp), F(sc), F(dbp), F(dcp),
                           F(dap), ct, bsz, s, h, p, n, chunk, vec, stm);
}
