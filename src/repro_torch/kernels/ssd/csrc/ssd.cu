// The Mamba2 SSD chunked scan (one group) on fp32 inputs, in three
// chunk-parallel stages with every product on Hopper's TF32 tensor cores
// in a 3xTF32 split; returns y and the fp32 final state.
//
// Replaces repro/kernels/ssd/kernel.py::ssd_pallas (body _ssd_kernel) for
// fp32 inputs; bf16 inputs take ssd_tc.cu.  It computes what the plain
// version (ref.py::ssd_chunked) computes, per batch b and head h with
// A = -exp(a_log[h]), over chunks of L steps:
//
//   cum_i   = sum_{l <= i} dt_l A                    (inclusive, in order)
//   y_i     = exp(cum_i) (C_i . state)                       inter-chunk
//           + sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   state   = state exp(cum_{L-1})
//           + sum_j x_j (B_j dt_j exp(cum_{L-1} - cum_j))
//
// x (B, S, H, P), dt (B, S, H), b and c (B, S, 1, N) and a_log (H,)
// float32 -> y (B, S, H, P), state (B, H, P, N) float32.  S need not
// be a multiple of L: the steps past S act as the plain version's
// padding (dt = 0, x = B = C = 0), which leaves y and the state
// unchanged.
//
// Products.  Each fp32 operand x is split as hi = tf32(x),
// lo = tf32(x - hi) (cvt.rna), and each product as hi hi + (hi lo + lo hi):
// kPasses = 3 TF32 products per fp32 product (exact in fp32), hi hi and
// the small terms in separate accumulators, added last.  One TF32 product,
// or two, misses the fp32 tolerances (1e-4 + 1e-5 |y|, the same for the
// state) by over 10x; three meet them at under a quarter of them
// (tests/test_torch_ssd.py emulates each).
// Tensor-core sums round toward zero, so each product over a chunk's steps
// is accumulated afresh per tile of 64 steps and added up in fp32.
//
// Bound.  Per chunk of l steps the products are the scores C B^T of the
// one group (l (l + 1) N with the causal half), and per head the gate's
// product with x (l (l + 1) P), the inter-chunk term and the chunk state
// (2 l P N each), each three times: at (1, 8192, 64, 64), N = 64,
// L = 256, 5.2e10 FLOP, 0.105 ms at the card's 494e12 TF32 FLOP/s, against
// 0.082 ms for its ~273 MB of fp32 in and out: operations bind.  (The
// scratch between the stages, about 130 MB of traffic at that shape, and
// the scores recomputed per head are the design's, not the function's.)
//
// Design: ssd_tc.cu's three stages on fp32 tiles, one kernel a stage,
// all launched by one call on one stream with scratch from the wrapper.
// 1. ssd_states, one block per (chunk, head, 64 columns of P, batch):
//    cum by one thread in order, with dt A rounded before the sum (no
//    FMA), so the decays equal the plain version's bit for bit; then the
//    chunk state x^T (B dt exp(total - cum)), (P x L)(L x N), with the
//    weighted B formed and split into shared memory once a tile.  It
//    writes cum and the state to scratch: (B, nC, H, L) and
//    (B, nC, H, P, N) float32.
// 2. ssd_scan, one thread per (batch, head, p, n): the sequential scan
//    over chunks, state_c = state_{c-1} exp(total_c) + S_c, rounding as
//    the plain version does.  The state before each chunk is written as
//    its TF32 hi and lo, (2, B, nC, H, P, N), the operand stage 3 reads
//    as it is; the last state is the final state.
// 3. ssd_out_wg, one block per (64 rows of a chunk, chunk, head, 64
//    columns of P, batch), heaviest row tiles first: y = exp(cum_i)
//    (C_i . state_prev), plus, for each column tile up to the diagonal,
//    the scores C B^T, the gate (scores exp(cum_i - cum_j)) dt_j formed
//    in the scores' registers, and its product with x from those
//    registers.
// Stage 1 takes mma.sync.m16n8k8 .tf32 with operands gathered by each
// lane from shared memory (64 x 64 tiles with K of 64, 16 rows a warp),
// copied with 16-byte cp.async into two stages, the next tile loading
// while this one is multiplied (plain loads where P or N % 4 != 0 or an
// address is misaligned); x and the weighted B have their K axis (steps)
// along their rows, so MMA slot t takes step 2t and slot t + 4 step
// 2t + 1 of each 8-step block, in both operands, and with rows padded to 4 mod 32 floats every
// gather hits 32 distinct banks.  Stage 3 takes wgmma.m64n64k8 .tf32: C,
// the state, B and x^T are split once into swizzled K-major hi and lo
// tiles in shared memory (N padded to 64 or 128, its K extent: 101 KB, two
// blocks an SM, or 169 KB), each pass issuing all its loads before its
// stores, and the gate is the A operand from registers, its steps in the
// slot order above, which x^T's rows follow.  (A wgmma form of stage 1,
// x^T and the weighted B^T split per tile, was slower than this one on
// the card, so it was not kept.)  Offsets are 64-bit.
//
// The launcher is a plain C function (no PyTorch headers) that returns
// cudaGetLastError, so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/tf32_mma.cuh"

namespace {

constexpr int kT = 64;         // tile edge: rows, steps, columns of P
constexpr int kThreads = 128;  // 4 warps, 16 rows each
constexpr int kLdX = kT + 4;   // pitch of the x tiles, floats

// Starts copying R rows x W columns of an fp32 matrix (row stride ld)
// into a tile with pitch LD, zero past (nrows, ncols): by cp.async where
// vec (ncols % 4 == 0, 16-byte aligned rows), else by plain loads.
template <int R, int W, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t ld, int nrows, int ncols,
                                          bool vec) {
  if (vec) {
    constexpr int kChunks = R * W / 4;
#pragma unroll
    for (int i = 0; i < kChunks / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (W / 4), c = (idx % (W / 4)) * 4;
      const bool ok = (r < nrows) & (c < ncols);
      cp_async16(smem_u32(dst + r * LD + c),
                 ok ? src + static_cast<int64_t>(r) * ld + c : src, ok);
    }
    return;
  }
#pragma unroll 4
  for (int idx = threadIdx.x; idx < R * W; idx += kThreads) {
    const int r = idx / W, c = idx % W;
    dst[r * LD + c] = (r < nrows && c < ncols)
                          ? src[static_cast<int64_t>(r) * ld + c]
                          : 0.f;
  }
}

// Stage 1.  NP: the state's N padded to 64 or 128.
template <int NP>
__global__ void __launch_bounds__(kThreads)
ssd_states(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const float* __restrict__ bm,
           float* __restrict__ cum_out, float* __restrict__ st_out, int s,
           int h, int p, int n, int chunk, int n_pt, int vec) {
  constexpr int kLdN = NP + 4;
  extern __shared__ float4 smem4[];
  const int cpad = (chunk + 3) & ~3;
  float* sCum = reinterpret_cast<float*>(smem4);   // [chunk]
  float* sW = sCum + cpad;                         // [chunk]
  float* sX = sW + cpad;                           // 2 x [kT][kLdX]
  float* sB = sX + 2 * kT * kLdX;                  // 2 x [kT][kLdN]
  float* sWh = sB + 2 * kT * kLdN;                 // [kT][kLdN]
  float* sWl = sWh + kT * kLdN;                    // [kT][kLdN]

  const int z = blockIdx.x, hh = blockIdx.y / n_pt;
  const int p0 = (blockIdx.y - hh * n_pt) * kT, bb = blockIdx.z;
  const int nc = gridDim.x, t0 = z * chunk, len = min(chunk, s - t0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const float a = -expf(a_log[hh]);
  const float* dtb = dt + (static_cast<int64_t>(bb) * s + t0) * h + hh;
  const int64_t x_row = static_cast<int64_t>(h) * p;
  const float* xb = x + (static_cast<int64_t>(bb) * s + t0) * x_row +
                    static_cast<int64_t>(hh) * p + p0;
  const float* bb_m = bm + (static_cast<int64_t>(bb) * s + t0) * n;
  auto issue = [&](int t) {   // tile t of x and B into stage t % 2
    const int j0 = t * kT, rows = min(kT, len - j0);
    load_tile<kT, kT, kLdX>(sX + (t & 1) * kT * kLdX, xb + j0 * x_row, x_row,
                            rows, p - p0, vec);
    load_tile<kT, NP, kLdN>(sB + (t & 1) * kT * kLdN,
                            bb_m + static_cast<int64_t>(j0) * n, n, rows, n,
                            vec);
    cp_async_commit();
  };
  issue(0);

  for (int l = threadIdx.x; l < len; l += kThreads)
    sW[l] = dtb[static_cast<int64_t>(l) * h];
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
  cp_async_wait<0>();
  __syncthreads();

  float acc[NP / 8][4] = {};
  const float* xa = sX + (2 * tq) * kLdX + warp * 16 + g;
  const int n_tiles = (len + kT - 1) / kT;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) issue(t + 1);
    const int j0 = t * kT, rows = min(kT, len - j0);
    const float* tX = xa + (t & 1) * kT * kLdX;
    const float* tB = sB + (t & 1) * kT * kLdN;
    // The weighted B of the tile, B_j (dt_j decay_j), split once.
    for (int idx = threadIdx.x; idx < kT * NP; idx += kThreads) {
      const int r = idx / NP, c = idx % NP;
      const float w = r < rows ? sW[j0 + r] : 0.f;
      uint32_t hi, lo;
      split(__fmul_rn(tB[r * kLdN + c], w), hi, lo);
      sWh[r * kLdN + c] = __uint_as_float(hi);
      sWl[r * kLdN + c] = __uint_as_float(lo);
    }
    __syncthreads();
    // acc (this warp's 16 rows of P x N) += x^T (B dt decay) over the tile.
    float big[NP / 8][4] = {}, small[NP / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kT / 8; ++kk) {
      uint32_t ah[4], al[4];
      const float* xk = tX + 8 * kk * kLdX;
      split(xk[0], ah[0], al[0]);
      split(xk[8], ah[1], al[1]);
      split(xk[kLdX], ah[2], al[2]);
      split(xk[kLdX + 8], ah[3], al[3]);
      const int wr = (8 * kk + 2 * tq) * kLdN + g;
#pragma unroll
      for (int nt = 0; nt < NP / 8; ++nt) {
        const int o = wr + 8 * nt;
        mma3(big[nt], small[nt], ah, al,
             __float_as_uint(sWh[o]), __float_as_uint(sWh[o + kLdN]),
             __float_as_uint(sWl[o]), __float_as_uint(sWl[o + kLdN]));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += big[nt][e] + small[nt][e];
    cp_async_wait<0>();   // the next tile has landed
    __syncthreads();       // and this one's readers are done
  }

  float* st = st_out + ((static_cast<int64_t>(bb) * nc + z) * h + hh) *
                           static_cast<int64_t>(p) * n;
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
// chunk goes to prev as its TF32 hi and lo (planes of B nC H P N values),
// the operand of stage 3's inter-chunk product.
__global__ void ssd_scan(const float* __restrict__ cum,
                         const float* __restrict__ st,
                         float* __restrict__ prev, float* __restrict__ fin,
                         int bsz, int s, int h, int pn, int chunk, int nc) {
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
        uint32_t hi, lo;
        split(carry, hi, lo);
        float* pv = prev + (bb * nc + z0 + k) * hpn + rest;
        pv[0] = __uint_as_float(hi);
        pv[plane] = __uint_as_float(lo);
        carry = __fadd_rn(__fmul_rn(carry, expf(total[k])), upd[k]);
      }
  }
  fin[e] = carry;
}

// Stage 3 on wgmma: its operands split once into swizzled K-major TF32 hi
// and lo tiles in shared memory.  NP, the state's N padded to 64 or 128,
// is the K extent of C.state and C.B^T only: the accumulators (64 x 64)
// are the same at either.

// 4 floats of row r at column c of an fp32 matrix (row stride ld), zero
// past (nrows, ncols): one 16-byte load where vec.
__device__ __forceinline__ float4 load4(const float* src, int64_t ld, int r,
                                        int c, int nrows, int ncols,
                                        bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r < nrows) {
    const float* sp = src + r * ld + c;
    if (vec) {
      if (c < ncols) v = *reinterpret_cast<const float4*>(sp);
    } else {
      v.x = c < ncols ? sp[0] : 0.f;
      v.y = c + 1 < ncols ? sp[1] : 0.f;
      v.z = c + 2 < ncols ? sp[2] : 0.f;
      v.w = c + 3 < ncols ? sp[3] : 0.f;
    }
  }
  return v;
}

template <int NP>
struct Out3 {
  static constexpr int kPanel = kT * 128;  // 64 rows x 32 TF32 values
  static constexpr int kNP = NP / 32;      // panels over N
  // Bytes from a 1024-byte aligned base: C hi and lo, the state hi and lo
  // (whose space then holds B hi and lo), kNP panels each; x^T hi and lo,
  // two panels each (64 steps); then cum and dt of the chunk's rows.
  // 101 KB at NP = 64 (two blocks an SM), 169 KB at NP = 128.
  static constexpr int kC = 0, kS = 2 * kNP * kPanel, kX = 4 * kNP * kPanel,
                       kArr = kX + 4 * kPanel;
};

template <int NP>
__global__ void __launch_bounds__(kThreads)
ssd_out_wg(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ bm, const float* __restrict__ cm,
           const float* __restrict__ cum, const float* __restrict__ prev,
           float* __restrict__ y, int s, int h, int p, int n, int chunk,
           int nc, int n_pt, int vec) {
  using L = Out3<NP>;
  constexpr int kPanel = L::kPanel, kNLo = L::kNP * kPanel;
  static_assert(kPasses == 3, "three wgmma a step: hi lo, lo hi, hi hi");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const int cpad = (chunk + 3) & ~3;
  float* sCum = reinterpret_cast<float*>(smem + L::kArr);   // [chunk]
  float* sDt = sCum + cpad;                                 // [chunk]

  const int n_rt = (chunk + kT - 1) / kT;
  const int it = n_rt - 1 - static_cast<int>(blockIdx.x) / nc;   // heavy first
  const int z = blockIdx.x % nc;
  const int hh = blockIdx.y / n_pt, p0 = (blockIdx.y - hh * n_pt) * kT;
  const int bb = blockIdx.z;
  const int t0 = z * chunk, len = min(chunk, s - t0), i0 = it * kT;
  if (i0 >= len) return;
  const int i_end = min(len, i0 + kT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;

  const int64_t x_row = static_cast<int64_t>(h) * p;
  const float* xb = x + (static_cast<int64_t>(bb) * s + t0) * x_row +
                    static_cast<int64_t>(hh) * p + p0;
  const float* cb = cm + (static_cast<int64_t>(bb) * s + t0 + i0) * n;
  const float* bb_m = bm + (static_cast<int64_t>(bb) * s + t0) * n;
  // C of the row tile, and the state before this chunk (rows p0.., its
  // TF32 hi and lo from the scan), as K-major panels over N, 64 columns
  // at a time.
  const int64_t plane = static_cast<int64_t>(gridDim.z) * nc * h * p * n;
  const float* pv = prev + ((static_cast<int64_t>(bb) * nc + z) * h + hh) *
                               static_cast<int64_t>(p) * n +
                    static_cast<int64_t>(p0) * n;
  // (Each pass issues all its loads before its stores: a store between
  // two loads would make each load wait for the one before.)
  constexpr int kPer = kT * 16 / kThreads;   // 16-byte pieces a thread
#pragma unroll
  for (int blk = 0; blk < NP / 64; ++blk) {
    float4 cv[kPer], hv[kPer], lv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 4;
      const int c = 64 * blk + 4 * (idx & 15);
      cv[i] = load4(cb, n, r, c, i_end - i0, n, vec);
      hv[i] = load4(pv, n, r, c, p - p0, n, vec);
      lv[i] = load4(pv + plane, n, r, c, p - p0, n, vec);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 4, c16 = idx & 15;
      const uint32_t off =
          (2 * blk + (c16 >> 3)) * kPanel + swz(r, c16 & 7);
      store_split(smem, L::kC + off, kNLo, cv[i]);
      *reinterpret_cast<float4*>(smem + L::kS + off) = hv[i];
      *reinterpret_cast<float4*>(smem + L::kS + kNLo + off) = lv[i];
    }
  }
  const float* cum_b = cum + ((static_cast<int64_t>(bb) * nc + z) * h + hh) *
                                 chunk;
  const float* dtb = dt + (static_cast<int64_t>(bb) * s + t0) * h + hh;
  for (int l = tid; l < i_end; l += kThreads) {
    sCum[l] = cum_b[l];
    sDt[l] = dtb[static_cast<int64_t>(l) * h];
  }
  fence_proxy_async();   // the stores above, visible to wgmma
  __syncthreads();

  const uint32_t ch = base + L::kC, cl = ch + kNLo;
  const uint32_t sh = base + L::kS, sl = sh + kNLo;
  const uint32_t xh = base + L::kX, xl = xh + 2 * kPanel;
  const int il = i0 + warp * 16 + g;   // this thread's rows: il, il + 8

  // Inter-chunk term: exp(cum_i) (C_i . state_prev); y's sum starts from
  // it.  Columns of N past n are zero.
  float acc[32], bg[32], sm[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) bg[i] = sm[i] = 0.f;
  fence_regs(bg);
  fence_regs(sm);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < NP / 8; ++kk) {
    const uint32_t o = (kk >> 2) * kPanel + (kk & 3) * 32;
    wgmma_ss(sm, desc(ch + o), desc(sl + o), kk > 0);
    wgmma_ss(sm, desc(cl + o), desc(sh + o), 1);
    wgmma_ss(bg, desc(ch + o), desc(sh + o), kk > 0);
  }
  wg_commit();
  wg_wait<0>();
  fence_regs(bg);
  fence_regs(sm);
  float cum_i[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = il + 8 * r;
    cum_i[r] = i < i_end ? sCum[i] : 0.f;
    const float ecum = i < i_end ? expf(cum_i[r]) : 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        acc[4 * nt + 2 * r + e] =
            (bg[4 * nt + 2 * r + e] + sm[4 * nt + 2 * r + e]) * ecum;
  }

  for (int jt = 0; jt <= it; ++jt) {
    __syncthreads();   // the last reads of the state, B and x^T are done
    const int j0 = jt * kT, rows = min(kT, len - j0);
    // B of the column tile as K-major panels over N (in the state's
    // space), and x^T (rows: columns of P) with its steps in MMA slot
    // order: slot s of each 8 steps holds step 2s for s < 4, 2 (s - 4) + 1
    // after.
#pragma unroll
    for (int blk = 0; blk < NP / 64; ++blk) {
      float4 bv[kPer], xv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = tid + i * kThreads;
        bv[i] = load4(bb_m + static_cast<int64_t>(j0) * n, n, idx >> 4,
                      64 * blk + 4 * (idx & 15), rows, n, vec);
        if (blk == 0) {
          const int pp = idx & 63, cg = idx >> 6;
          const int k0 = 8 * (cg >> 1) + (cg & 1);   // steps k0, +2, +4, +6
          const float* xp = xb + (j0 + k0) * x_row + pp;
          const bool col = p0 + pp < p;
          xv[i].x = col && k0 < rows ? xp[0] : 0.f;
          xv[i].y = col && k0 + 2 < rows ? xp[2 * x_row] : 0.f;
          xv[i].z = col && k0 + 4 < rows ? xp[4 * x_row] : 0.f;
          xv[i].w = col && k0 + 6 < rows ? xp[6 * x_row] : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = tid + i * kThreads, r = idx >> 4, c16 = idx & 15;
        store_split(smem,
                    L::kS + (2 * blk + (c16 >> 3)) * kPanel + swz(r, c16 & 7),
                    kNLo, bv[i]);
        if (blk == 0) {
          const int pp = idx & 63, cg = idx >> 6;
          store_split(smem, L::kX + (cg >> 3) * kPanel + swz(pp, cg & 7),
                      2 * kPanel, xv[i]);
        }
      }
    }
    fence_proxy_async();
    __syncthreads();

    // The scores C_i . B_j.
    fence_regs(bg);
    fence_regs(sm);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 8; ++kk) {
      const uint32_t o = (kk >> 2) * kPanel + (kk & 3) * 32;
      wgmma_ss(sm, desc(ch + o), desc(sl + o), kk > 0);
      wgmma_ss(sm, desc(cl + o), desc(sh + o), 1);
      wgmma_ss(bg, desc(ch + o), desc(sh + o), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(bg);
    fence_regs(sm);
    // The gate, (scores exp(cum_i - cum_j)) dt_j for j <= i, as A
    // fragments over j: slot t is step 2t, slot t + 4 step 2t + 1.
    // Branch-free: the exp's argument and the result are selected.
    float gate[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int i = il + 8 * ((q >> 1) & 1);
      const int j = j0 + 8 * (q >> 2) + 2 * tq + (q & 1);
      const bool ok = (j <= i) & (i < i_end);
      const int jc = ok ? j : 0;
      const float gv = __fmul_rn(
          __fmul_rn(bg[q] + sm[q],
                    expf(ok ? __fsub_rn(cum_i[(q >> 1) & 1], sCum[jc])
                            : -INFINITY)),
          sDt[jc]);
      gate[q] = ok ? gv : 0.f;
    }
    uint32_t gh[8][4], gl[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      split(gate[4 * kk + 0], gh[kk][0], gl[kk][0]);
      split(gate[4 * kk + 2], gh[kk][1], gl[kk][1]);
      split(gate[4 * kk + 1], gh[kk][2], gl[kk][2]);
      split(gate[4 * kk + 3], gh[kk][3], gl[kk][3]);
    }
    // y += gate x over the tile.
    fence_regs(bg);
    fence_regs(sm);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t o = (kk >> 2) * kPanel + (kk & 3) * 32;
      wgmma_rs(sm, gh[kk], desc(xl + o), kk > 0);
      wgmma_rs(sm, gl[kk], desc(xh + o), 1);
      wgmma_rs(bg, gh[kk], desc(xh + o), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    pin(gh);
    pin(gl);
    fence_regs(bg);
    fence_regs(sm);
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[q] += bg[q] + sm[q];
  }

  float* yb = y + (static_cast<int64_t>(bb) * s + t0) * x_row +
              static_cast<int64_t>(hh) * p;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const int i = il + 8 * ((q >> 1) & 1);
    const int pp = p0 + 8 * (q >> 2) + 2 * tq + (q & 1);
    if (i < i_end && pp < p) yb[static_cast<int64_t>(i) * x_row + pp] = acc[q];
  }
}

template <int NP>
int launch(const float* x, const float* dt, const float* a_log,
           const float* b, const float* c, float* y, float* fin, float* cum,
           float* st, float* prev, int bsz, int s, int h, int p, int n,
           int chunk, int vec, cudaStream_t stream) {
  const int nc = (s + chunk - 1) / chunk, n_pt = (p + kT - 1) / kT;
  const int ld_n = NP + 4, cpad = (chunk + 3) & ~3;
  if (static_cast<int64_t>(h) * n_pt > 65535 || bsz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (nc > 0) {
    const int bytes1 = (2 * cpad + 2 * kT * kLdX + 4 * kT * ld_n) * 4;
    err = cudaFuncSetAttribute(ssd_states<NP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes1);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_states<NP><<<dim3(nc, h * n_pt, bsz), kThreads, bytes1, stream>>>(
        x, dt, a_log, b, cum, st, s, h, p, n, chunk, n_pt, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t elems = static_cast<int64_t>(bsz) * h * p * n;
  ssd_scan<<<static_cast<unsigned>((elems + 255) / 256), 256, 0, stream>>>(
      cum, st, prev, fin, bsz, s, h, p * n, chunk, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess || nc == 0) return static_cast<int>(err);
  const int n_rt = (chunk + kT - 1) / kT;
  const int bytes3 = 1024 + Out3<NP>::kArr + 2 * cpad * 4;
  err = cudaFuncSetAttribute(ssd_out_wg<NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes3);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_out_wg<NP><<<dim3(nc * n_rt, h * n_pt, bsz), kThreads, bytes3,
                   stream>>>(x, dt, b, c, cum, prev, y, s, h, p, n, chunk, nc,
                             n_pt, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, S, H, P); dt: (B, S, H); a_log: (H,); b, c: (B, S, 1, N);
// y: (B, S, H, P); fin: (B, H, P, N).  Scratch: cum (B, nC, H, chunk),
// st (B, nC, H, P, N) and prev (2, B, nC, H, P, N), nC = ceil(S / chunk).
// All float32 and contiguous; 1 <= N <= 128, 1 <= chunk <= 1024; vec != 0
// when P % 4 == 0, N % 4 == 0 and every pointer is 16-byte aligned.
extern "C" int ssd_launch(const void* x, const void* dt, const void* a_log,
                          const void* b, const void* c, void* y, void* fin,
                          void* cum, void* st, void* prev, int bsz, int s,
                          int h, int p, int n, int chunk, int vec,
                          void* stream) {
  if (bsz <= 0 || h <= 0 || p <= 0) return 0;
  if (n <= 0 || n > 128 || chunk <= 0 || chunk > 1024 || s < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const auto* xx = static_cast<const float*>(x);
  const auto* dd = static_cast<const float*>(dt);
  const auto* aa = static_cast<const float*>(a_log);
  const auto* bb = static_cast<const float*>(b);
  const auto* cc = static_cast<const float*>(c);
  auto* yy = static_cast<float*>(y);
  auto* ff = static_cast<float*>(fin);
  auto* cu = static_cast<float*>(cum);
  auto* sp = static_cast<float*>(st);
  auto* pv = static_cast<float*>(prev);
  return n <= 64 ? launch<64>(xx, dd, aa, bb, cc, yy, ff, cu, sp, pv, bsz, s,
                              h, p, n, chunk, vec, stm)
                 : launch<128>(xx, dd, aa, bb, cc, yy, ff, cu, sp, pv, bsz, s,
                               h, p, n, chunk, vec, stm);
}
