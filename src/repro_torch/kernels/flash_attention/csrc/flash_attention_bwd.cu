// The backward of flash attention: dQ, dK and dV of the forward
// (flash_attention_tc.cu for bf16, flash_attention.cu for fp32) from q,
// k, v, the forward's output O, its row log-sum-exp LSE and dO; GQA,
// causal from q_offset, optional sliding window.
//
// It replaces no TPU kernel: the JAX package trains attention past
// 4096^2 (query, key) pairs through jax.grad of its plain chunked
// attention (repro/kernels/flash_attention/ref.py), the path the
// reference sends such shapes on (repro/kernels/flash_attention/ops.py:
// flash_attention_pallas has no custom_vjp).  The port's forward is a
// hand-written kernel, so its autograd needs these two:
//
//   delta_i = sum_d dO_id O_id                       (fp32)
//   P_ij    = exp(scale q_i . k_j - LSE_i)           (visible pairs, else 0)
//   dS_ij   = P_ij (dO_i . v_j - delta_i)
//   dQ_i    = scale sum_j dS_ij k_j
//   dK_j    = scale sum_i dS_ij q_i,  dV_j = sum_i P_ij dO_i
//
// with the sums over i running over the g = Hq / Hkv query heads of
// key head j's group too.  A row with no visible key (LSE = -inf) has
// P = 0 and zero gradients.
//
// Two kernels a call, on one stream:
// - fa_bwd_dq: grid (query block, Hq, B x column chunks).  Computes
//   delta of its rows (written to scratch for the second kernel), walks
//   only the key tiles visible from its rows (causal from q_offset, the
//   window's edge), and for each: S = Q K^T and dP = dO V^T, then P and
//   dS, then dQ += dS K; dQ is rounded once at the end.
// - fa_bwd_dkdv: grid (key block, Hkv, B x column chunks).  Walks the g
//   query heads of its group and, for each, the query tiles that see its
//   keys, in a fixed order, accumulating dV += P^T dO and dK += dS^T Q:
//   GQA's sum over heads is this loop, with no atomics, so two calls give
//   the same bits.  Each kernel recomputes S and dP (7 products where
//   the least is 5): the price of writing no fp32 dS and no dQ partials
//   to device memory.
//
// Bound.  Five products of 2 D FLOP each per visible pair: 10 D FLOP a
// pair (dq's own three, 6 D, and dkdv's four, 8 D, taken alone) at the
// bf16 tensor-core rate.  gemma3's global layer at (1, 8192, 8, 256)
// is 3.4e8 pairs, 8.6e11 FLOP, 0.87 ms at 989e12 FLOP/s, against ~0.2 GB
// of bytes: operations bind.
//
// bf16 (every operand bf16, fp32 sums): mma.sync m16n8k16, 4 warps a
// block, each warp 16 rows (dq: queries, dkdv: keys) of 64.  All
// operands come from shared memory through ldmatrix (non-transposed for
// S = Q K^T, where K's rows are mma's column-major B; .trans for the
// products whose B is stored row by row: dQ += dS K, dV += P^T dO,
// dK += dS^T Q), with rows padded by 16 bytes so that the 8 row
// addresses of each ldmatrix hit distinct banks.  P and dS go from the
// accumulators' registers to the next product's A operand directly (an
// m16n8 accumulator pair is an m16k16 A fragment), each rounded to one
// bf16 term: tests/test_torch_flash_bwd.py emulates these roundings and
// finds them within 1e-2 max |ref| of every gradient at the repository's
// shapes, where the SSD backward needed two terms.  D is zero-padded in
// shared memory to a multiple of 64; the gradient's columns are split
// into chunks of at most 128 (grid z), so that a warp's accumulators,
// 16 rows x 128 columns (x2 in dkdv), stay in registers up to D = 256,
// at the cost of computing S and dP once per chunk past D = 128.  K and
// V tiles (dq) and Q and dO tiles (dkdv) stream through a two-stage
// cp.async ring (plain loads where D % 8 != 0 or a base is off 16
// bytes).  Query blocks of dq are issued heaviest first.  P = exp2(S c -
// LSE log2 e) with c = scale log2 e, one FMA and one exp2 a score.
//
// fp32: the CUDA cores, blocks of 256 threads each holding one row
// (query or key) and every fourth column of its gradients, fp32 FMAs from
// tiles in shared memory in the plain version's order over D; Q scaled by
// D^-0.5 in fp32 as the plain version scales it, exp (not exp2).  It is
// what the fp32 compute mode needs to hold the plain version's fp32 sums,
// not a fast route.
//
// Offsets are 64-bit.  The launcher is a plain C function (no PyTorch
// headers) that returns cudaGetLastError, so a refused launch is
// reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/mma_bf16.cuh"
#include "../../csrc/sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {   // 2^x; 0 at -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Whether the query at position qp sees the key at position key < sk.
__device__ __forceinline__ bool sees(int qp, int key, int sk, int window) {
  return (key < sk) & (key <= qp) & ((window <= 0) | (qp - key < window));
}

// ------------------------------------------------------------------ bf16
constexpr int kThreads = 128;   // 4 warps, 16 rows each
constexpr int kBQ = 64;         // dq: query rows a block
constexpr int kBK = 64;         // dq: keys a tile
constexpr int kBKV = 64;        // dkdv: keys a block
constexpr int kBQT = 32;        // dkdv: queries a tile

// NP 64-column panels of the padded head dim (D <= 64 NP).
template <int NP>
struct Cfg {
  static constexpr int kP = 64 * NP + 8;   // shared row pitch, bf16
  // Gradient columns a block computes (a multiple of 16), and the chunks.
  static constexpr int kDC = NP <= 2 ? 64 * NP : 32 * NP;
  static constexpr int kNC = 64 * NP / kDC;
  static constexpr int kDqSmem = (2 * kBQ + 4 * kBK) * kP * 2 + 2 * kBQ * 4;
  static constexpr int kDkdvSmem =
      (2 * kBKV + 4 * kBQT) * kP * 2 + 4 * kBQT * 4;
};

// Rows [r0, r0 + R) of a (rows, d) bf16 matrix with row stride ld into
// dst [R][kP]; rows >= nrows and columns >= d read as 0.  vec: 16-byte
// cp.async (d % 8 == 0, 16-byte aligned bases), else plain loads.
template <int R, int NP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int64_t ld, int r0, int nrows,
                                          int d, bool vec, int tid) {
  constexpr int kP = Cfg<NP>::kP, kChunks = R * NP * 8;
  for (int idx = tid; idx < kChunks; idx += kThreads) {
    const int r = idx / (NP * 8), c = (idx - r * (NP * 8)) * 8;
    const int row = r0 + r;
    bf16* dp = dst + r * kP + c;
    const bool in = row < nrows;
    if (vec) {
      const bool ok = in && c < d;
      cp_async16(smem_u32(dp),
                 ok ? src + static_cast<int64_t>(row) * ld + c : src, ok);
    } else {
      __align__(16) bf16 t[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        t[e] = in && c + e < d ? src[static_cast<int64_t>(row) * ld + c + e]
                               : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(dp) = *reinterpret_cast<const uint4*>(t);
    }
  }
}

// An m16n8 accumulator pair (keys or queries 16 kk .. 16 kk + 15) as an
// m16k16 bf16 A fragment.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 2][4],
                                     const float (&c)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 2; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// c (16 x 8 NT, fp32) += A (16 rows of a at row0, all 64 NP columns) B^T,
// with B's 8 NT rows at b (row-major, contiguous columns): S = Q K^T.
template <int NP, int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const bf16* a,
                                        const bf16* b, int lane) {
  constexpr int kP = Cfg<NP>::kP;
  const int mi = lane >> 3;
#pragma unroll
  for (int kd = 0; kd < 64 * NP; kd += 16) {
    uint32_t af[4];
    ldsm_x4(af, smem_u32(a + (lane & 15) * kP + kd + (lane >> 4) * 8));
#pragma unroll
    for (int j2 = 0; j2 < NT / 2; ++j2) {
      uint32_t bf[4];
      ldsm_x4(bf, smem_u32(b + (j2 * 16 + (mi >> 1) * 8 + (lane & 7)) * kP +
                           kd + (mi & 1) * 8));
      mma16816(c[2 * j2], af, bf[0], bf[1]);
      mma16816(c[2 * j2 + 1], af, bf[2], bf[3]);
    }
  }
}

// c (16 x DC, fp32) += A (16 x 16 KK, fragments) B, with B's 16 KK rows
// at b (row-major, columns [c0, c0 + DC)): dQ += dS K, dV += P^T dO.
template <int NP, int KK, int DC>
__device__ __forceinline__ void mma_ab(float (&c)[DC / 8][4],
                                       const uint32_t (&a)[KK][4],
                                       const bf16* b, int c0, int lane) {
  constexpr int kP = Cfg<NP>::kP;
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int pr = 0; pr < DC / 16; ++pr) {
      uint32_t bf[4];
      ldsm_x4_t(bf, smem_u32(b + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * kP +
                             c0 + pr * 16 + (mi >> 1) * 8));
      mma16816(c[2 * pr], a[kk], bf[0], bf[1]);
      mma16816(c[2 * pr + 1], a[kk], bf[2], bf[3]);
    }
}

template <int NP>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ o,
                 const float* __restrict__ lse, const bf16* __restrict__ dout,
                 bf16* __restrict__ dq, float* __restrict__ delta, int sq,
                 int sk, int hq, int hkv, int d, int q_offset, int window,
                 float scale, float scale_log2, int vec) {
  using C = Cfg<NP>;
  constexpr int kP = C::kP, kDC = C::kDC;
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);   // [kBQ][kP]
  bf16* sdO = sQ + kBQ * kP;                   // [kBQ][kP]
  bf16* sKV = sdO + kBQ * kP;                  // 2 stages x (K, V) [kBK][kP]
  float* sLse = reinterpret_cast<float*>(sKV + 4 * kBK * kP);   // x log2(e)
  float* sDelta = sLse + kBQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z / C::kNC;
  const int chunk = blockIdx.z % C::kNC, c0 = chunk * kDC;
  const int hk = h / (hq / hkv);
  const int64_t q_row = static_cast<int64_t>(hq) * d;
  const int64_t k_row = static_cast<int64_t>(hkv) * d;
  const int64_t q_base = static_cast<int64_t>(b) * sq * q_row +
                         static_cast<int64_t>(h) * d;
  const int64_t k_base = static_cast<int64_t>(b) * sk * k_row +
                         static_cast<int64_t>(hk) * d;
  const int64_t r_base = (static_cast<int64_t>(b) * hq + h) * sq;

  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, sq) - 1;
  const int k_end = min(sk, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  auto load_kv = [&](int t) {
    bf16* st = sKV + (t & 1) * 2 * kBK * kP;
    const int j0 = k_begin + t * kBK;
    load_rows<kBK, NP>(st, k + k_base, k_row, j0, sk, d, vec, tid);
    load_rows<kBK, NP>(st + kBK * kP, v + k_base, k_row, j0, sk, d, vec, tid);
  };
  load_rows<kBQ, NP>(sQ, q + q_base, q_row, q0, sq, d, vec, tid);
  load_rows<kBQ, NP>(sdO, dout + q_base, q_row, q0, sq, d, vec, tid);
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  // delta and LSE of the block's rows, 8 lanes a row, 4 rows a pass.
#pragma unroll
  for (int pass = 0; pass < 4; ++pass) {
    const int r = warp * 16 + pass * 4 + (lane >> 3), qi = q0 + r;
    float acc = 0.f;
    if (qi < sq) {
      const bf16* orow = o + q_base + static_cast<int64_t>(qi) * q_row;
      const bf16* drow = dout + q_base + static_cast<int64_t>(qi) * q_row;
      for (int c = lane & 7; c < d; c += 8)
        acc = fmaf(__bfloat162float(orow[c]), __bfloat162float(drow[c]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    if ((lane & 7) == 0) {
      sDelta[r] = acc;
      // Rows past Sq: P = 2^(s c - inf) = 0.
      sLse[r] = qi < sq ? lse[r_base + qi] * kLog2e : INFINITY;
      if (chunk == 0 && qi < sq) delta[r_base + qi] = acc;
    }
  }

  const int qp_lo = q_offset + q0 + warp * 16 + g;   // rows g and g + 8
  const int w_first = q_offset + q0 + warp * 16, w_last = w_first + 15;
  float acc[kDC / 8][4];
#pragma unroll
  for (int i = 0; i < kDC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();   // tile t has landed
    __syncthreads();      // and every warp is done with tile t - 1
    if (t + 1 < n_tiles) load_kv(t + 1);
    cp_async_commit();
    const int j0 = k_begin + t * kBK;
    if (j0 > w_last || (window > 0 && w_first - (j0 + kBK - 1) >= window))
      continue;   // no row of this warp sees a key of the tile
    const bf16* tK = sKV + (t & 1) * 2 * kBK * kP;
    const bf16* tV = tK + kBK * kP;
    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    mma_abt<NP>(s, sQ + warp * 16 * kP, tK, lane);
    mma_abt<NP>(dp, sdO + warp * 16 * kP, tV, lane);

    const float lse2[2] = {sLse[warp * 16 + g], sLse[warp * 16 + g + 8]};
    const float dl[2] = {sDelta[warp * 16 + g], sDelta[warp * 16 + g + 8]};
    const bool full = j0 + kBK <= sk && j0 + kBK - 1 <= w_first &&
                      (window <= 0 || w_last - j0 < window);
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + 8 * nt + 2 * tq + (e & 1);
        const bool ok = full || sees(qp_lo + 8 * (e >> 1), key, sk, window);
        const float p =
            ok ? ex2(fmaf(s[nt][e], scale_log2, -lse2[e >> 1])) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dl[e >> 1]);   // dS
      }
    uint32_t ds[kBK / 16][4];
    to_a<kBK / 8>(ds, s);
    mma_ab<NP, kBK / 16, kDC>(acc, ds, tK, c0, lane);
  }
  cp_async_wait<0>();

  bf16* dqb = dq + q_base;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= sq) continue;
    bf16* row = dqb + static_cast<int64_t>(qi) * q_row;
#pragma unroll
    for (int nt = 0; nt < kDC / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * nt + 2 * tq + e;
        if (col < d) row[col] = __float2bfloat16_rn(acc[nt][2 * r + e] * scale);
      }
  }
}

template <int NP>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ lse,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int sq, int sk, int hq, int hkv,
                   int d, int q_offset, int window, float scale,
                   float scale_log2, int vec) {
  using C = Cfg<NP>;
  constexpr int kP = C::kP, kDC = C::kDC;
  extern __shared__ float4 smem4[];
  bf16* sK = reinterpret_cast<bf16*>(smem4);   // [kBKV][kP]
  bf16* sV = sK + kBKV * kP;                   // [kBKV][kP]
  bf16* sQD = sV + kBKV * kP;                  // 2 stages x (Q, dO) [kBQT][kP]
  float* sLse = reinterpret_cast<float*>(sQD + 4 * kBQT * kP);   // [2][kBQT]
  float* sDelta = sLse + 2 * kBQT;                               // [2][kBQT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int kb0 = blockIdx.x * kBKV;
  const int hk = blockIdx.y, b = blockIdx.z / C::kNC;
  const int chunk = blockIdx.z % C::kNC, c0 = chunk * kDC;
  const int heads = hq / hkv;
  const int64_t q_row = static_cast<int64_t>(hq) * d;
  const int64_t k_row = static_cast<int64_t>(hkv) * d;
  const int64_t k_base = static_cast<int64_t>(b) * sk * k_row +
                         static_cast<int64_t>(hk) * d;

  load_rows<kBKV, NP>(sK, k + k_base, k_row, kb0, sk, d, vec, tid);
  load_rows<kBKV, NP>(sV, v + k_base, k_row, kb0, sk, d, vec, tid);
  cp_async_commit();

  // The queries that see a key of the block: [q_lo, q_hi).
  const int kb_last = min(kb0 + kBKV, sk) - 1;
  const int q_lo = max(0, kb0 - q_offset);
  const int q_hi = window > 0 ? static_cast<int>(max(0LL, min(
                                   static_cast<long long>(sq),
                                   static_cast<long long>(kb_last) + window -
                                       q_offset)))
                             : sq;
  const int n_qt = q_hi > q_lo ? (q_hi - q_lo + kBQT - 1) / kBQT : 0;
  const int n_it = heads * n_qt;

  // Iteration it: head hk heads + it / n_qt, query tile it % n_qt.
  auto load_q = [&](int it) {
    const int h = hk * heads + it / n_qt, qq0 = q_lo + (it % n_qt) * kBQT;
    const int st = it & 1;
    const int64_t q_base = static_cast<int64_t>(b) * sq * q_row +
                           static_cast<int64_t>(h) * d;
    const int64_t r_base = (static_cast<int64_t>(b) * hq + h) * sq;
    bf16* tQ = sQD + st * 2 * kBQT * kP;
    load_rows<kBQT, NP>(tQ, q + q_base, q_row, qq0, sq, d, vec, tid);
    load_rows<kBQT, NP>(tQ + kBQT * kP, dout + q_base, q_row, qq0, sq, d, vec,
                        tid);
    for (int i = tid; i < kBQT; i += kThreads) {
      const int qi = qq0 + i;
      sLse[st * kBQT + i] = qi < sq ? lse[r_base + qi] * kLog2e : INFINITY;
      sDelta[st * kBQT + i] = qi < sq ? delta[r_base + qi] : 0.f;
    }
  };
  if (n_it > 0) load_q(0);
  cp_async_commit();

  const int key_lo = kb0 + warp * 16 + g;   // keys g and g + 8
  const int wk_first = kb0 + warp * 16, wk_last = wk_first + 15;
  float ak[kDC / 8][4], av[kDC / 8][4];
#pragma unroll
  for (int i = 0; i < kDC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[i][e] = av[i][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();   // tile it has landed
    __syncthreads();      // and every warp is done with tile it - 1
    if (it + 1 < n_it) load_q(it + 1);
    cp_async_commit();
    const int qq0 = q_lo + (it % n_qt) * kBQT, qp0 = q_offset + qq0;
    if (wk_first > qp0 + kBQT - 1 ||
        (window > 0 && qp0 - wk_last >= window))
      continue;   // no key of this warp is seen by a query of the tile
    const int st = it & 1;
    const bf16* tQ = sQD + st * 2 * kBQT * kP;
    const bf16* tD = tQ + kBQT * kP;
    const float* tl = sLse + st * kBQT;
    const float* td = sDelta + st * kBQT;
    float s[kBQT / 8][4], dp[kBQT / 8][4];
#pragma unroll
    for (int i = 0; i < kBQT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    mma_abt<NP>(s, sK + warp * 16 * kP, tQ, lane);    // S^T = K Q^T
    mma_abt<NP>(dp, sV + warp * 16 * kP, tD, lane);   // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < kBQT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * nt + 2 * tq + (e & 1), qi = qq0 + qc;
        const bool ok = (qi < sq) &
                        sees(q_offset + qi, key_lo + 8 * (e >> 1), sk, window);
        const float p = ok ? ex2(fmaf(s[nt][e], scale_log2, -tl[qc])) : 0.f;
        s[nt][e] = p;                          // P^T
        dp[nt][e] = p * (dp[nt][e] - td[qc]);  // dS^T
      }
    uint32_t pa[kBQT / 16][4], da[kBQT / 16][4];
    to_a<kBQT / 8>(pa, s);
    to_a<kBQT / 8>(da, dp);
    mma_ab<NP, kBQT / 16, kDC>(av, pa, tD, c0, lane);   // dV += P^T dO
    mma_ab<NP, kBQT / 16, kDC>(ak, da, tQ, c0, lane);   // dK += dS^T Q
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + 8 * r;
    if (key >= sk) continue;
    const int64_t off = k_base + static_cast<int64_t>(key) * k_row;
#pragma unroll
    for (int nt = 0; nt < kDC / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * nt + 2 * tq + e;
        if (col < d) {
          dk[off + col] = __float2bfloat16_rn(ak[nt][2 * r + e] * scale);
          dv[off + col] = __float2bfloat16_rn(av[nt][2 * r + e]);
        }
      }
  }
}

// ------------------------------------------------------------------ fp32
// In their own namespace: its constants hide the bf16 kernels' names.
namespace f32 {
constexpr int kThreads = 256;   // one row and every fourth column a thread
constexpr int kBQ = 64;         // dq: query rows a block
constexpr int kBK = 32;         // dq: keys a tile
constexpr int kBKV = 64;        // dkdv: keys a block
constexpr int kBQT = 32;        // dkdv: queries a tile
// Shared row pitch (floats) for NP panels: odd, so that the 8 rows a
// warp reads at one column fall in distinct banks.
template <int NP>
__host__ __device__ constexpr int pitch() { return 64 * NP + 1; }
template <int NP>
constexpr int dq_smem() {
  return ((2 * kBQ + 2 * kBK) * pitch<NP>() + kBQ * (kBK + 1) + 2 * kBQ) * 4;
}
template <int NP>
constexpr int dkdv_smem() {
  return ((2 * kBKV + 2 * kBQT) * pitch<NP>() + 2 * kBKV * (kBQT + 1) +
          2 * kBQT) * 4;
}

// Rows [r0, r0 + R) of a (rows, d) fp32 matrix (row stride ld) times
// mul into dst [R][pitch], zero past nrows and past d up to 64 NP.
template <int R, int NP>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t ld, int r0, int nrows,
                                          int d, float mul, int tid) {
  for (int idx = tid; idx < R * 64 * NP; idx += kThreads) {
    const int r = idx / (64 * NP), c = idx - r * (64 * NP), row = r0 + r;
    dst[r * pitch<NP>() + c] =
        row < nrows && c < d ? src[static_cast<int64_t>(row) * ld + c] * mul
                             : 0.f;
  }
}

template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ o,
                     const float* __restrict__ lse,
                     const float* __restrict__ dout, float* __restrict__ dq,
                     float* __restrict__ delta, int sq, int sk, int hq,
                     int hkv, int d, int q_offset, int window, float scale) {
  constexpr int kLd = pitch<NP>(), kS = kBK + 1;
  extern __shared__ float smf[];
  float* sQ = smf;                   // [kBQ][kLd], q D^-0.5
  float* sdO = sQ + kBQ * kLd;       // [kBQ][kLd]
  float* sK = sdO + kBQ * kLd;       // [kBK][kLd]
  float* sV = sK + kBK * kLd;        // [kBK][kLd]
  float* sDS = sV + kBK * kLd;       // [kBQ][kS]
  float* sLse = sDS + kBQ * kS;      // [kBQ]
  float* sDelta = sLse + kBQ;        // [kBQ]

  const int tid = threadIdx.x, r = tid >> 2, part = tid & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int64_t q_row = static_cast<int64_t>(hq) * d;
  const int64_t k_row = static_cast<int64_t>(hkv) * d;
  const int64_t q_base = static_cast<int64_t>(b) * sq * q_row +
                         static_cast<int64_t>(h) * d;
  const int64_t k_base = static_cast<int64_t>(b) * sk * k_row +
                         static_cast<int64_t>(hk) * d;
  const int64_t r_base = (static_cast<int64_t>(b) * hq + h) * sq;

  load_rows<kBQ, NP>(sQ, q + q_base, q_row, q0, sq, d, scale, tid);
  load_rows<kBQ, NP>(sdO, dout + q_base, q_row, q0, sq, d, 1.f, tid);
  __syncthreads();
  const int qi = q0 + r, qp = q_offset + qi;
  {
    float dl = 0.f;
    if (qi < sq) {
      const float* orow = o + q_base + static_cast<int64_t>(qi) * q_row;
      for (int c = part; c < d; c += 4)
        dl = fmaf(orow[c], sdO[r * kLd + c], dl);
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    dl += __shfl_xor_sync(0xffffffffu, dl, 2);
    if (part == 0) {
      sDelta[r] = dl;
      sLse[r] = qi < sq ? lse[r_base + qi] : INFINITY;
      if (qi < sq) delta[r_base + qi] = dl;
    }
  }

  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, sq) - 1;
  const int k_end = min(sk, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  float acc[16 * NP];
#pragma unroll
  for (int j = 0; j < 16 * NP; ++j) acc[j] = 0.f;
  for (int j0 = k_begin; j0 < k_end; j0 += kBK) {
    __syncthreads();   // the last tile's products are done
    load_rows<kBK, NP>(sK, k + k_base, k_row, j0, sk, d, 1.f, tid);
    load_rows<kBK, NP>(sV, v + k_base, k_row, j0, sk, d, 1.f, tid);
    __syncthreads();
    float s[8] = {}, dp[8] = {};
    for (int c = 0; c < d; ++c) {
      const float a = sQ[r * kLd + c], a2 = sdO[r * kLd + c];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i] = fmaf(a, sK[(part + 4 * i) * kLd + c], s[i]);
        dp[i] = fmaf(a2, sV[(part + 4 * i) * kLd + c], dp[i]);
      }
    }
    const float lr = sLse[r], dr = sDelta[r];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int key = j0 + part + 4 * i;
      const float p = sees(qp, key, sk, window) ? expf(s[i] - lr) : 0.f;
      sDS[r * kS + part + 4 * i] = p * (dp[i] - dr);
    }
    __syncthreads();
    for (int kk = 0; kk < kBK; ++kk) {
      const float ds = sDS[r * kS + kk];
      const float* kr = sK + kk * kLd + part;
#pragma unroll
      for (int j = 0; j < 16 * NP; ++j) acc[j] = fmaf(ds, kr[4 * j], acc[j]);
    }
  }
  if (qi < sq) {
    float* row = dq + q_base + static_cast<int64_t>(qi) * q_row;
#pragma unroll
    for (int j = 0; j < 16 * NP; ++j) {
      const int col = part + 4 * j;
      if (col < d) row[col] = acc[j] * scale;
    }
  }
}

template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ lse,
                       const float* __restrict__ dout,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int sq,
                       int sk, int hq, int hkv, int d, int q_offset,
                       int window, float scale) {
  constexpr int kLd = pitch<NP>(), kS = kBQT + 1;
  extern __shared__ float smf[];
  float* sK = smf;                   // [kBKV][kLd]
  float* sV = sK + kBKV * kLd;       // [kBKV][kLd]
  float* sQ = sV + kBKV * kLd;       // [kBQT][kLd], q D^-0.5
  float* sdO = sQ + kBQT * kLd;      // [kBQT][kLd]
  float* sP = sdO + kBQT * kLd;      // [kBKV][kS]
  float* sDS = sP + kBKV * kS;       // [kBKV][kS]
  float* sLse = sDS + kBKV * kS;     // [kBQT]
  float* sDelta = sLse + kBQT;       // [kBQT]

  const int tid = threadIdx.x, r = tid >> 2, part = tid & 3;
  const int kb0 = blockIdx.x * kBKV;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int heads = hq / hkv;
  const int64_t q_row = static_cast<int64_t>(hq) * d;
  const int64_t k_row = static_cast<int64_t>(hkv) * d;
  const int64_t k_base = static_cast<int64_t>(b) * sk * k_row +
                         static_cast<int64_t>(hk) * d;
  load_rows<kBKV, NP>(sK, k + k_base, k_row, kb0, sk, d, 1.f, tid);
  load_rows<kBKV, NP>(sV, v + k_base, k_row, kb0, sk, d, 1.f, tid);

  const int kb_last = min(kb0 + kBKV, sk) - 1;
  const int q_lo = max(0, kb0 - q_offset);
  const int q_hi = window > 0 ? static_cast<int>(max(0LL, min(
                                   static_cast<long long>(sq),
                                   static_cast<long long>(kb_last) + window -
                                       q_offset)))
                             : sq;
  const int key = kb0 + r;
  float ak[16 * NP], av[16 * NP];
#pragma unroll
  for (int j = 0; j < 16 * NP; ++j) ak[j] = av[j] = 0.f;
  for (int hh = 0; hh < heads; ++hh) {
    const int h = hk * heads + hh;
    const int64_t q_base = static_cast<int64_t>(b) * sq * q_row +
                           static_cast<int64_t>(h) * d;
    const int64_t r_base = (static_cast<int64_t>(b) * hq + h) * sq;
    for (int qq0 = q_lo; qq0 < q_hi; qq0 += kBQT) {
      __syncthreads();   // the last tile's products are done
      load_rows<kBQT, NP>(sQ, q + q_base, q_row, qq0, sq, d, scale, tid);
      load_rows<kBQT, NP>(sdO, dout + q_base, q_row, qq0, sq, d, 1.f, tid);
      if (tid < kBQT) {
        const int qi = qq0 + tid;
        sLse[tid] = qi < sq ? lse[r_base + qi] : INFINITY;
        sDelta[tid] = qi < sq ? delta[r_base + qi] : 0.f;
      }
      __syncthreads();
      float s[8] = {}, dp[8] = {};
      for (int c = 0; c < d; ++c) {
        const float a = sK[r * kLd + c], a2 = sV[r * kLd + c];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i] = fmaf(a, sQ[(part + 4 * i) * kLd + c], s[i]);
          dp[i] = fmaf(a2, sdO[(part + 4 * i) * kLd + c], dp[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qc = part + 4 * i, qi = qq0 + qc;
        const float p = qi < sq && sees(q_offset + qi, key, sk, window)
                            ? expf(s[i] - sLse[qc])
                            : 0.f;
        sP[r * kS + qc] = p;
        sDS[r * kS + qc] = p * (dp[i] - sDelta[qc]);
      }
      __syncthreads();
      for (int qq = 0; qq < kBQT; ++qq) {
        const float pp = sP[r * kS + qq], ds = sDS[r * kS + qq];
        const float* dr = sdO + qq * kLd + part;
        const float* qr = sQ + qq * kLd + part;
#pragma unroll
        for (int j = 0; j < 16 * NP; ++j) {
          av[j] = fmaf(pp, dr[4 * j], av[j]);
          ak[j] = fmaf(ds, qr[4 * j], ak[j]);
        }
      }
    }
  }
  if (key < sk) {
    const int64_t off = k_base + static_cast<int64_t>(key) * k_row;
#pragma unroll
    for (int j = 0; j < 16 * NP; ++j) {
      const int col = part + 4 * j;
      if (col < d) {
        dk[off + col] = ak[j];
        dv[off + col] = av[j];
      }
    }
  }
}

}  // namespace f32

struct Args {
  const void *q, *k, *v, *o, *lse, *dout;
  void *dq, *dk, *dv, *delta;
  int b, sq, sk, hq, hkv, d, q_offset, window;
  float scale;
  int vec, parts;
};

namespace f32 {

template <int NP>
int launch_f32(const Args& a, cudaStream_t s) {
  using f32::dkdv_smem;
  using f32::dq_smem;
  using f32::kBKV;
  using f32::kBQ;
  using f32::kThreads;
  if (a.parts & 1) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dq_f32_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        dq_smem<NP>());
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.sq + kBQ - 1) / kBQ, a.hq, a.b);
    fa_bwd_dq_f32_kernel<NP><<<grid, kThreads, dq_smem<NP>(), s>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.o),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.dout),
        static_cast<float*>(a.dq), static_cast<float*>(a.delta), a.sq, a.sk,
        a.hq, a.hkv, a.d, a.q_offset, a.window, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((a.parts & 2) && a.sk > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dkdv_f32_kernel<NP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem<NP>());
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.sk + kBKV - 1) / kBKV, a.hkv, a.b);
    fa_bwd_dkdv_f32_kernel<NP><<<grid, kThreads, dkdv_smem<NP>(), s>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.dout), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.sq, a.sk,
        a.hq, a.hkv, a.d, a.q_offset, a.window, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

template <int NP>
int launch_bf16(const Args& a, cudaStream_t s) {
  using C = Cfg<NP>;
  const float scale_log2 = a.scale * kLog2e;
  if (a.parts & 1) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dq_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kDqSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.sq + kBQ - 1) / kBQ, a.hq, a.b * C::kNC);
    fa_bwd_dq_kernel<NP><<<grid, kThreads, C::kDqSmem, s>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.o),
        static_cast<const float*>(a.lse), static_cast<const bf16*>(a.dout),
        static_cast<bf16*>(a.dq), static_cast<float*>(a.delta), a.sq, a.sk,
        a.hq, a.hkv, a.d, a.q_offset, a.window, a.scale, scale_log2, a.vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((a.parts & 2) && a.sk > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dkdv_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kDkdvSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.sk + kBKV - 1) / kBKV, a.hkv, a.b * C::kNC);
    fa_bwd_dkdv_kernel<NP><<<grid, kThreads, C::kDkdvSmem, s>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const float*>(a.lse),
        static_cast<const bf16*>(a.dout), static_cast<const float*>(a.delta),
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.sq, a.sk, a.hq,
        a.hkv, a.d, a.q_offset, a.window, a.scale, scale_log2, a.vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq: (B, Sq, Hq, D); k, v, dk, dv: (B, Sk, Hkv, D), all
// contiguous, bfloat16 (fp32 == 0) or float32; lse, delta: (B, Hq, Sq)
// float32 (lse the forward's, natural log; delta scratch, written by the
// first kernel, read by the second).  1 <= D <= 256, Hq % Hkv == 0,
// window <= 0 means none; scale = D^-0.5; vec != 0 (bf16 only) when
// D % 8 == 0 and every pointer is 16-byte aligned.  parts: 1 launches
// the dQ kernel (and writes delta), 2 the dK/dV kernel (reading delta),
// 3 both in that order.  Returns the first launch's CUDA error.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int b, int sq, int sk, int hq, int hkv, int d, int q_offset,
    int window, float scale, int fp32, int vec, int parts, void* stream) {
  if (b <= 0 || sq <= 0 || hq <= 0) return 0;
  if (d <= 0 || d > 256 || hkv <= 0 || hq % hkv != 0 || sk < 0 || b > 16384)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  k,  v,  o,        lse,    dout,  dq,   dk,  dv, delta,
               b,  sq, sk, hq,       hkv,    d,     q_offset,
               window <= 0 ? 0 : window, scale, vec, parts};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 63) / 64) {
    case 1:
      return fp32 ? f32::launch_f32<1>(a, s) : launch_bf16<1>(a, s);
    case 2:
      return fp32 ? f32::launch_f32<2>(a, s) : launch_bf16<2>(a, s);
    case 3:
      return fp32 ? f32::launch_f32<3>(a, s) : launch_bf16<3>(a, s);
    default:
      return fp32 ? f32::launch_f32<4>(a, s) : launch_bf16<4>(a, s);
  }
}
