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
// Two kernels a call, on one stream: dq, then dk/dv, rather than one
// fused kernel that sums dQ partials across key blocks.  Each is
// deterministic by construction, every gradient summed by one warpgroup
// in a fixed order, with no atomics, no fp32 dQ partials in device memory
// and no ordering between blocks; the price is S and dP computed in both
// kernels, 7 products where the least is 5.
// - fa_bwd_dq: grid (query block of 128, Hq, B), heaviest blocks first.
//   Computes delta of its rows (written to scratch for the second
//   kernel), walks only the key tiles visible from its rows (causal from
//   q_offset, the window's edge), and for each: S = Q K^T and dP = dO V^T,
//   then P and dS, then dQ += dS K; dQ is rounded once at the end.
// - fa_bwd_dkdv: grid (key block, Hkv, B).  Walks the g query heads of
//   its group and, for each, the query tiles of 64 that see its keys, in
//   a fixed order, accumulating dV += P^T dO and dK += dS^T Q: GQA's sum
//   over heads is this loop, so two calls give the same bits.
//
// Bound.  Five products of 2 D FLOP each per visible pair: 10 D FLOP a
// pair (dq's own three, 6 D, and dkdv's four, 8 D, taken alone) at the
// bf16 tensor-core rate.  gemma3's global layer at (1, 8192, 8, 256)
// is 3.4e8 pairs, 8.6e11 FLOP, 0.87 ms at 989e12 FLOP/s, against ~0.2 GB
// of bytes: operations bind.
//
// bf16 (every operand bf16, fp32 sums): wgmma, two warpgroups (256
// threads) a block, S and dP computed once per (key tile, query tile)
// pair and block at every D up to 256.
// - Operands live in shared memory as 64-column panels of 128-byte rows
//   under the 128-byte swizzle (D zero-padded to a multiple of 64), the
//   layout wgmma's descriptors name: a tile is K-major B for S = Q K^T
//   and dP = dO V^T (and K-major A for Q, dO, K or V) and MN-major B for
//   the products that sum over its rows (dQ += dS K, dV += P^T dO,
//   dK += dS^T Q).  S and dP come from wgmma with both operands in shared
//   memory; P and dS go from the accumulator's registers to the next
//   product's A operand (an accumulator of 64 x 16 columns is an A
//   fragment), each rounded to one bf16 term: tests/test_torch_flash_bwd.py
//   emulates these roundings and finds them within 1e-2 max |ref| of
//   every gradient at the repository's shapes.
// - dq: each warpgroup owns 64 query rows of the block and all D columns
//   of their dQ (32 NP fp32 registers a thread); key tiles of 128 up to
//   D = 64, 64 up to D = 128 and 32 past it, as many as S and dP fit
//   beside the accumulator.
// - dk/dv up to D = 128 (fa_bwd_dkdv_wide_kernel): 128 keys a block,
//   each warpgroup computing every product for its own 64 keys.  A Q and
//   dO tile, which every key block of the head streams from L2, then
//   serves 128 keys.  Past D = 128 both gradients of 64 keys do not fit
//   one warpgroup's registers (fa_bwd_dkdv_kernel): 64 keys a block,
//   warpgroup 0 computes S^T, P^T and dV with all D columns, warpgroup 1
//   dP^T, dS^T and dK, and P^T (fp32) goes from 0 to 1 through two
//   shared-memory buffers on mbarriers, so that warpgroup 0 runs on into
//   the next tile.
// - The streamed tiles (K and V for dq; Q, dO and their rows' LSE and
//   delta for dk/dv) go through a ring of up to four stages, as many as
//   fit beside the resident tiles (two at D = 256 in dk/dv), with a full
//   and an empty mbarrier a stage: every thread issues its share of a
//   tile's 16-byte cp.async and arrives on the full barrier when they
//   land (cp.async.mbarrier.arrive), so the warpgroups run at their own
//   pace and a stage is refilled once both are done with it.  Where
//   D % 8 != 0 or a base is off 16 bytes the same ring is filled by plain
//   loads, so every shape takes this route.
// - P = exp2(S c - LSE log2 e) with c = scale log2 e, one FMA and one
//   exp2 a score, masked element by element only in tiles that cross Sk,
//   Sq, the causal edge or the window's edge.
// - What holds it back: every key block streams all its heads' Q and dO
//   tiles, and every query block its K and V tiles, from L2 (the
//   shared-memory budget caps the reuse: 128 keys a block up to D = 128,
//   64 past it); exp2 on the MUFU units, one per score in each kernel;
//   and a warpgroup's products wait for its scores, with only the other
//   warpgroup to overlap them.
//
// fp32: the same two kernels on the TF32 tensor cores in the 3xTF32 split
// of csrc/tf32_mma.cuh (each operand x as hi = tf32(x) and lo = tf32(x -
// hi), each product hi hi + (hi lo + lo hi), hi hi and the small terms in
// separate accumulators): kPasses = 3 products per fp32 product, for S and
// dP too at every D.  tests/test_torch_flash_bwd.py emulates the design
// in these kernels' tiles and order and finds it within 2.9e-6 of each
// gradient's max |ref| against jax.vjp (1e-5 is the tolerance; one pass
// misses it by 93x, two by 58x); at D = 256 a split S is within 2x of S
// summed in the plain version's order, which the forward needs for its
// 2e-6 on the output, not the backward.
// Q is scaled by D^-0.5 in fp32 before it is split, as the plain version
// scales it, and P = exp(S - LSE) (exp, not exp2).  Tensor-core sums round
// toward zero: S and dP are one tile's sum over D, and each gradient
// product is formed afresh per key or query tile and added to the running
// gradient in fp32.  A score accumulator becomes the next product's A
// operand in place: MMA slot t takes column 2t of each 8 and slot t + 4
// column 2t + 1, and the other operand's rows are stored or read in that
// order.
// - D <= 64 (zamba2's heads): wgmma, every operand split once into hi and
//   lo panels in shared memory (the wg kernels below).
// - 64 < D <= 256: mma.sync.m16n8k8, tiles in shared memory as one fp32
//   copy pitched 64 NP + 4 floats (every fragment load hits 32 banks; S's
//   and dP's by ldmatrix), each operand split in registers as its
//   fragment loads.  dq: 16 query
//   rows a warp with all D columns of their dQ (8 warps up to D = 128, 4
//   past it), key tiles of 32 (16 past D = 192) through a cp.async ring
//   of two.  dk/dv: 16 keys a warp pair, 4 pairs a block, queries in
//   tiles of 32 (16 past D = 192): the role-0 warp computes S^T, P^T and
//   dV += P^T dO, the role-1 warp dP^T, dS^T from P^T (handed over in
//   shared memory between two barriers) and dK += dS^T (q D^-0.5), each
//   with all D columns of its gradient, 8-column panels at a time.
// Both walk the group's heads and their query tiles in a fixed order, so
// two calls give the same bits.
//
// Offsets are 64-bit.  The launcher is a plain C function (no PyTorch
// headers) that returns cudaGetLastError, so a refused launch is
// reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/sm90.cuh"
#include "../../csrc/tf32_mma.cuh"
#include "../../csrc/wgmma_bf16.cuh"

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
constexpr int kThreads = 256;   // two warpgroups
constexpr int kBQ = 128;        // dq: query rows a block, 64 a warpgroup
constexpr int kBKV = 64;        // dkdv: keys a block
constexpr int kBQT = 64;        // dkdv: queries a tile
constexpr int kWideNP = 2;      // dkdv: up to NP = 2 panels,
constexpr int kBKW = 128;       // 128 keys a block (fa_bwd_dkdv_wide)
constexpr int kMaxStages = 4;
constexpr int kSmemBudget = 232448 - 1024 - 256;   // less alignment, barriers

// The ring's stages: as many as fit beside `fixed` bytes, up to
// kMaxStages.
constexpr int ring_stages(int fixed, int stage) {
  return (kSmemBudget - fixed) / stage < kMaxStages
             ? (kSmemBudget - fixed) / stage
             : kMaxStages;
}

// NP 64-column panels of the padded head dim (D <= 64 NP).  A panel is
// R rows of 128 bytes under the 128-byte swizzle, the layout wgmma's
// descriptors name; a tile is NP such panels.
template <int NP>
struct Cfg {
  // dq: keys a tile, as many as S and dP (kBK / 2 registers each) fit
  // beside the dQ accumulator (32 NP): 128 at NP = 1, 64 at 2, 32 past
  // D = 128.
  static constexpr int kBK = NP == 1 ? 128 : NP == 2 ? 64 : 32;
  static constexpr int kQPanel = kBQ * 128, kKPanel = kBK * 128;
  static constexpr int kVPanel = kBKV * 128, kTPanel = kBQT * 128;
  // dq: Q, dO, LSE and delta, then the stages of K and V.
  static constexpr int kDqFixed = 2 * NP * kQPanel + 2 * kBQ * 4;
  static constexpr int kDqStage = 2 * NP * kKPanel;
  static constexpr int kDqStages = ring_stages(kDqFixed, kDqStage);
  static constexpr int kDqSmem = 1024 + kDqFixed + kDqStages * kDqStage;
  // dkdv: K, V and two buffers of the handed-over P^T, then the stages of
  // Q and dO (with their rows' LSE and delta).
  static constexpr int kDkdvFixed = 2 * NP * kVPanel + 2 * kBKV * kBQT * 4;
  static constexpr int kDkdvStage = 2 * NP * kTPanel + 2 * kBQT * 4;
  static constexpr int kDkdvStages = ring_stages(kDkdvFixed, kDkdvStage);
  static constexpr int kDkdvSmem =
      1024 + kDkdvFixed + kDkdvStages * kDkdvStage;
  // The wide dk/dv kernel: K and V of 128 keys, then the same stages.
  static constexpr int kWPanel = kBKW * 128;
  static constexpr int kWideFixed = 2 * NP * kWPanel;
  static constexpr int kWideStages = ring_stages(kWideFixed, kDkdvStage);
  static constexpr int kWideSmem =
      1024 + kWideFixed + kWideStages * kDkdvStage;
  static_assert(kDqStages >= 2 && kDkdvStages >= 2, "a ring of two");
};

// 4 bytes by cp.async (its L1-allocating form, the only one that takes
// 4), zeros where !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
// Arrives on the mbarrier once every cp.async this thread issued so far
// has landed (an arrival the barrier's count includes).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// Rows [r0, r0 + R) of a (rows, d) bf16 matrix with row stride ld into NP
// swizzled panels of R rows at dst (panel p: columns 64 p .. 64 p + 63),
// by the T threads t = 0 .. T - 1; rows >= nrows and columns >= d read
// as 0.  vec: 16-byte cp.async (d % 8 == 0, 16-byte aligned bases), else
// plain loads.
template <int R, int NP, int T>
__device__ __forceinline__ void load_tile(uint8_t* dst, const bf16* src,
                                          int64_t ld, int r0, int nrows,
                                          int d, bool vec, int t) {
  constexpr int kChunks = R * NP * 8;
#pragma unroll 4
  for (int idx = t; idx < kChunks; idx += T) {
    const int r = idx / (NP * 8), c = idx - r * (NP * 8);
    uint8_t* dp = dst + (c >> 3) * (R * 128) + swz(r, c & 7);
    const int row = r0 + r, col = c * 8;
    const bool in_row = row < nrows;
    if (vec) {
      const bool ok = in_row && col < d;
      cp_async16(smem_u32(dp),
                 ok ? src + static_cast<int64_t>(row) * ld + col : src, ok);
    } else {
      __align__(16) bf16 tmp[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        tmp[e] = in_row && col + e < d
                     ? src[static_cast<int64_t>(row) * ld + col + e]
                     : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(dp) = *reinterpret_cast<const uint4*>(tmp);
    }
  }
}

// A thread's end of filling a stage: its copies complete `full`, whose
// count is every thread: with vec, once the thread's cp.async have
// landed; else (plain stores, and any cp.async) at once, fenced for the
// async proxy.
__device__ __forceinline__ void stage_filled(uint32_t full, bool vec) {
  if (vec) {
    cp_async_arrive(full);
  } else {
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    mbar_arrive(full);
  }
}

// A wgmma accumulator of 64 rows x 16 KK columns as KK A fragments of
// bf16 (the fragment's layout is the accumulator's).
template <int KK>
__device__ __forceinline__ void to_frags(uint32_t (&a)[KK][4],
                                         const float (&c)[8 * KK]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(c[8 * kk + 2 * e], c[8 * kk + 2 * e + 1]);
}

template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ o,
                 const float* __restrict__ lse, const bf16* __restrict__ dout,
                 bf16* __restrict__ dq, float* __restrict__ delta, int sq,
                 int sk, int hq, int hkv, int d, int q_offset, int window,
                 float scale, float scale_log2, int vec) {
  using C = Cfg<NP>;
  constexpr int kBK = C::kBK, kQPanel = C::kQPanel, kKPanel = C::kKPanel;
  constexpr int kStage = C::kDqStage, kStages = C::kDqStages;   // K, then V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;                         // NP panels of kBQ rows
  uint8_t* sdO = sQ + NP * kQPanel;           // NP panels of kBQ rows
  uint8_t* sKV = sdO + NP * kQPanel;          // kStages stages
  float* sLse = reinterpret_cast<float*>(sKV + kStages * kStage);  // x log2 e
  float* sDelta = sLse + kBQ;
  __shared__ uint64_t bars[2 * kStages];      // full, then empty

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, quad = lane & 3;
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

  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, sq) - 1;
  const int k_end = min(sk, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&bars[s]), kThreads);
      mbar_init(smem_u32(&bars[kStages + s]), kThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // Tile t's K and V into its stage, every thread its share, once every
  // thread is done with the tile the stage held (t - kStages).
  auto load_kv = [&](int t) {
    const int s = t % kStages;
    mbar_wait(smem_u32(&bars[kStages + s]), ((t / kStages) & 1) ^ 1);
    uint8_t* st = sKV + s * kStage;
    const int j0 = k_begin + t * kBK;
    load_tile<kBK, NP, kThreads>(st, k + k_base, k_row, j0, sk, d, vec, tid);
    load_tile<kBK, NP, kThreads>(st + NP * kKPanel, v + k_base, k_row, j0,
                                 sk, d, vec, tid);
    stage_filled(smem_u32(&bars[s]), vec);
  };
  load_tile<kBQ, NP, kThreads>(sQ, q + q_base, q_row, q0, sq, d, vec, tid);
  load_tile<kBQ, NP, kThreads>(sdO, dout + q_base, q_row, q0, sq, d, vec,
                               tid);
  cp_async_commit();
  for (int t = 0; t < kStages - 1 && t < n_tiles; ++t) load_kv(t);

  // delta and LSE of the block's rows, 8 lanes a row, 4 rows a pass.
#pragma unroll
  for (int pass = 0; pass < 4; ++pass) {
    const int r = (tid >> 5) * 16 + pass * 4 + (lane >> 3), qi = q0 + r;
    float acc = 0.f;
    if (qi < sq) {
      const bf16* orow = o + q_base + static_cast<int64_t>(qi) * q_row;
      const bf16* drow = dout + q_base + static_cast<int64_t>(qi) * q_row;
      for (int c = lane & 7; c < d; c += 8)
        acc = fmaf(__bfloat162float(orow[c]), __bfloat162float(drow[c]),
                   acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    if ((lane & 7) == 0) {
      sDelta[r] = acc;
      // Rows past Sq: P = 2^(s c - inf) = 0.
      sLse[r] = qi < sq ? lse[r_base + qi] * kLog2e : INFINITY;
      if (qi < sq) delta[r_base + qi] = acc;
    }
  }
  cp_async_wait<0>();   // Q and dO have landed (the tiles complete on
  __syncthreads();      // their barriers); so have LSE and delta

  // This thread's rows of its warpgroup's 64: r and r + 8.
  const int r_lo = wg * 64 + warp * 16 + g;
  const int qp_lo = q_offset + q0 + r_lo;
  const int wg_first = q_offset + q0 + wg * 64, wg_last = wg_first + 63;
  const bool wg_rows = q0 + wg * 64 < sq;   // a row of the warpgroup is real
  const float lse2[2] = {sLse[r_lo], sLse[r_lo + 8]};
  const float dl[2] = {sDelta[r_lo], sDelta[r_lo + 8]};
  const uint32_t sKV_u = smem_u32(sKV);
  // A: this warpgroup's 64 rows of Q and dO (K-major); B: K and V (K-major
  // for S and dP, MN-major for dQ += dS K).
  const uint64_t q_desc = desc(smem_u32(sQ) + wg * 64 * 128, 16, 1024);
  const uint64_t do_desc = desc(smem_u32(sdO) + wg * 64 * 128, 16, 1024);
  const uint64_t kv_desc = desc(sKV_u, 16, 1024);
  const uint64_t kt_desc = desc(sKV_u, kKPanel, 1024);
  float acc[NP][32], s[kBK / 2], dp[kBK / 2];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = dp[i] = 0.f;

  // Each warpgroup walks the tiles at its own pace: a stage is refilled
  // once both are done with it.
  for (int t = 0; t < n_tiles; ++t) {
    if (t + kStages - 1 < n_tiles) load_kv(t + kStages - 1);
    const int stage = t % kStages;
    mbar_wait(smem_u32(&bars[stage]), (t / kStages) & 1);   // tile t landed
    fence_proxy_async();
    const int j0 = k_begin + t * kBK;
    const uint32_t st = stage * kStage;
    const bool work = wg_rows && j0 <= wg_last &&
                      (window <= 0 || wg_first - (j0 + kBK - 1) < window);
    if (work) {
      fence_acc(s);
      fence_acc(dp);
      wg_fence();
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t a = p * kQPanel + kk * 32;
          const uint32_t bo = st + p * kKPanel + kk * 32;
          const uint64_t bk = kv_desc + (bo >> 4);
          const uint64_t bv = kv_desc + ((bo + NP * kKPanel) >> 4);
          Wgmma<kBK>::template ss<0, 0>(s, q_desc + (a >> 4), bk,
                                        (p | kk) != 0);
          Wgmma<kBK>::template ss<0, 0>(dp, do_desc + (a >> 4), bv,
                                        (p | kk) != 0);
        }
      wg_commit();
    }
    if (work) {
      wg_wait<0>();
      fence_acc(s);
      fence_acc(dp);

      // Every key of the tile is visible from every row of the warpgroup
      // unless the tile crosses Sk, the causal edge or the window's edge.
      const bool full = j0 + kBK <= sk && j0 + kBK - 1 <= wg_first &&
                        (window <= 0 || wg_last - j0 < window);
      if (full) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i)
          s[i] = ex2(fmaf(s[i], scale_log2, -lse2[(i >> 1) & 1])) *
                 (dp[i] - dl[(i >> 1) & 1]);   // dS
      } else {
#pragma unroll
        for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j0 + 8 * i + 2 * quad + (e & 1);
            const bool ok = sees(qp_lo + 8 * (e >> 1), key, sk, window);
            const float pv =
                ok ? ex2(fmaf(s[4 * i + e], scale_log2, -lse2[e >> 1])) : 0.f;
            s[4 * i + e] = pv * (dp[4 * i + e] - dl[e >> 1]);   // dS
          }
      }
      uint32_t ds[kBK / 16][4];
      to_frags<kBK / 16>(ds, s);
      pin_frags(ds);
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_acc(acc[p]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          Wgmma<64>::template rs<1>(
              acc[p], ds[kk],
              kt_desc + ((st + p * kKPanel + kk * 16 * 128) >> 4), 1);
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_acc(acc[p]);
    }
    mbar_arrive(smem_u32(&bars[kStages + stage]));
  }
  cp_async_wait<0>();

  bf16* dqb = dq + q_base;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r_lo + 8 * r;
    if (qi >= sq) continue;
    bf16* row = dqb + static_cast<int64_t>(qi) * q_row;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 64 * p + 8 * i + 2 * quad + e;
          if (col < d)
            row[col] = __float2bfloat16_rn(acc[p][4 * i + 2 * r + e] * scale);
        }
  }
}

template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ lse,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int sq, int sk, int hq, int hkv,
                   int d, int q_offset, int window, float scale,
                   float scale_log2, int vec) {
  using C = Cfg<NP>;
  constexpr int kVPanel = C::kVPanel, kTPanel = C::kTPanel;
  constexpr int kStage = 2 * NP * kTPanel;   // Q, then dO
  constexpr int kStages = C::kDkdvStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem;                         // NP panels of kBKV rows
  uint8_t* sV = sK + NP * kVPanel;            // NP panels of kBKV rows
  uint8_t* sQD = sV + NP * kVPanel;           // kStages stages
  // Two buffers of P^T, [8][128] float4 each.
  float4* sP = reinterpret_cast<float4*>(sQD + kStages * kStage);
  // The rows' LSE (natural log) and delta, [kStages][kBQT] each.
  float* sLse = reinterpret_cast<float*>(sP + 2 * kBKV * kBQT / 4);
  float* sDelta = sLse + kStages * kBQT;
  // Stages full, stages empty, P^T buffers full, P^T buffers empty.
  __shared__ uint64_t bars[2 * kStages + 4];

  const int tid = threadIdx.x, role = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, quad = lane & 3;
  const int kb0 = blockIdx.x * kBKV;   // the first blocks see most queries
  const int hk = blockIdx.y, b = blockIdx.z;
  const int heads = hq / hkv;
  const int64_t q_row = static_cast<int64_t>(hq) * d;
  const int64_t k_row = static_cast<int64_t>(hkv) * d;
  const int64_t k_base = static_cast<int64_t>(b) * sk * k_row +
                         static_cast<int64_t>(hk) * d;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&bars[s]), kThreads);
      mbar_init(smem_u32(&bars[kStages + s]), kThreads);
    }
    for (int i = 0; i < 4; ++i)
      mbar_init(smem_u32(&bars[2 * kStages + i]), 128);
    mbar_fence_init();
  }
  load_tile<kBKV, NP, kThreads>(sK, k + k_base, k_row, kb0, sk, d, vec, tid);
  load_tile<kBKV, NP, kThreads>(sV, v + k_base, k_row, kb0, sk, d, vec, tid);
  cp_async_commit();
  cp_async_wait<0>();   // K and V have landed
  fence_proxy_async();
  __syncthreads();

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

  // Iteration it's Q and dO tiles (head hk heads + it / n_qt, query tile
  // it % n_qt) with their rows' LSE and delta into its stage, every thread
  // its share, once every thread is done with the tile the stage held.
  auto load_q = [&](int it) {
    const int st = it % kStages;
    mbar_wait(smem_u32(&bars[kStages + st]), ((it / kStages) & 1) ^ 1);
    const int h = hk * heads + it / n_qt, qq0 = q_lo + (it % n_qt) * kBQT;
    const int64_t q_base = static_cast<int64_t>(b) * sq * q_row +
                           static_cast<int64_t>(h) * d;
    const int64_t r_base = (static_cast<int64_t>(b) * hq + h) * sq;
    uint8_t* tQ = sQD + st * kStage;
    load_tile<kBQT, NP, kThreads>(tQ, q + q_base, q_row, qq0, sq, d, vec,
                                  tid);
    load_tile<kBQT, NP, kThreads>(tQ + NP * kTPanel, dout + q_base, q_row,
                                  qq0, sq, d, vec, tid);
    // Rows past Sq read as 0: the mask sets their P to 0.
    if (tid < 2 * kBQT) {
      const int i = tid & (kBQT - 1), qi = qq0 + i;
      const int64_t src = r_base + (qi < sq ? qi : 0);
      cp_async4(smem_u32((tid < kBQT ? sLse : sDelta) + st * kBQT + i),
                (tid < kBQT ? lse : delta) + src, qi < sq);
    }
    stage_filled(smem_u32(&bars[st]), vec);
  };
  for (int it = 0; it < kStages - 1 && it < n_it; ++it) load_q(it);

  // Warpgroup 0 computes S^T = K Q^T, P^T, and dV += P^T dO; warpgroup 1
  // dP^T = V dO^T, dS^T = P^T (dP^T - delta) from warpgroup 0's P^T, and
  // dK += dS^T Q.  Both hold all D columns of their gradient.
  const int key_lo = kb0 + warp * 16 + g;   // keys key_lo and key_lo + 8
  const uint64_t a_desc = desc(smem_u32(role == 0 ? sK : sV), 16, 1024);
  const uint32_t sQD_u = smem_u32(sQD);
  const uint64_t t_desc = desc(sQD_u, 16, 1024);        // K-major B
  const uint64_t tt_desc = desc(sQD_u, kTPanel, 1024);  // MN-major B
  const uint32_t first_b = role == 0 ? 0 : NP * kTPanel;    // Q or dO
  const uint32_t second_b = role == 0 ? NP * kTPanel : 0;   // dO or Q
  const uint32_t p_full = smem_u32(&bars[2 * kStages]);
  const uint32_t p_empty = smem_u32(&bars[2 * kStages + 2]);
  float acc[NP][32], s[32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it + kStages - 1 < n_it) load_q(it + kStages - 1);
    const int stage = it % kStages;
    mbar_wait(smem_u32(&bars[stage]), (it / kStages) & 1);   // tile landed
    fence_proxy_async();
    const int qq0 = q_lo + (it % n_qt) * kBQT;
    const uint32_t st = stage * kStage;
    const float* tl = sLse + stage * kBQT;
    const float* td = sDelta + stage * kBQT;
    fence_acc(s);
    wg_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t b =
            t_desc + ((st + first_b + p * kTPanel + kk * 32) >> 4);
        Wgmma<64>::template ss<0, 0>(
            s, a_desc + ((p * kVPanel + kk * 32) >> 4), b, (p | kk) != 0);
      }
    wg_commit();
    wg_wait<0>();
    fence_acc(s);
    // P^T goes to warpgroup 1 through one of two buffers: buffer pb of
    // iteration it, used for the (it / 2)-th time.
    const int pb = it & 1;
    const uint32_t pph = (it >> 1) & 1;
    float4* buf = sP + pb * (kBKV * kBQT / 4);
    if (role == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * quad + (e & 1), qi = qq0 + qc;
          const bool ok = (qi < sq) & sees(q_offset + qi, key_lo + 8 * (e >> 1),
                                           sk, window);
          s[4 * j + e] = ok ? ex2(fmaf(s[4 * j + e], scale_log2,
                                       -(tl[qc] * kLog2e)))
                            : 0.f;   // P^T
        }
      mbar_wait(p_empty + 8 * pb, pph ^ 1);   // warpgroup 1 has read it
#pragma unroll
      for (int j = 0; j < 8; ++j)
        buf[j * 128 + tid] =
            make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      mbar_arrive(p_full + 8 * pb);
    } else {
      mbar_wait(p_full + 8 * pb, pph);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 pv = buf[j * 128 + tid - 128];
        const float pe[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * quad + (e & 1);
          s[4 * j + e] = pe[e] * (s[4 * j + e] - td[qc]);   // dS^T
        }
      }
      mbar_arrive(p_empty + 8 * pb);
    }
    uint32_t fr[4][4];
    to_frags<4>(fr, s);
    pin_frags(fr);
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_acc(acc[p]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        Wgmma<64>::template rs<1>(
            acc[p], fr[kk],
            tt_desc + ((st + second_b + p * kTPanel + kk * 16 * 128) >> 4), 1);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_acc(acc[p]);
    mbar_arrive(smem_u32(&bars[kStages + stage]));
  }
  cp_async_wait<0>();

  bf16* out = role == 0 ? dv : dk;
  const float mul = role == 0 ? 1.f : scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + 8 * r;
    if (key >= sk) continue;
    bf16* row = out + k_base + static_cast<int64_t>(key) * k_row;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 64 * p + 8 * i + 2 * quad + e;
          if (col < d)
            row[col] = __float2bfloat16_rn(acc[p][4 * i + 2 * r + e] * mul);
        }
  }
}

// dk/dv for NP <= kWideNP: 128 keys a block, each warpgroup computing
// every product for its own 64 (S^T, dP^T, P^T, dS^T, dV and dK), so a
// Q and dO tile serves twice the keys of fa_bwd_dkdv_kernel's 64 and no
// P^T is handed over.  Its registers (S^T, dP^T and both gradients of
// 64 rows) stop at NP = 2.
template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_wide_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ lse,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int sq,
                        int sk, int hq, int hkv, int d, int q_offset,
                        int window, float scale, float scale_log2, int vec) {
  using C = Cfg<NP>;
  constexpr int kWPanel = C::kWPanel, kTPanel = C::kTPanel;
  constexpr int kStage = 2 * NP * kTPanel;   // Q, then dO
  constexpr int kStages = C::kWideStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem;                         // NP panels of kBKW rows
  uint8_t* sV = sK + NP * kWPanel;            // NP panels of kBKW rows
  uint8_t* sQD = sV + NP * kWPanel;           // kStages stages
  // The rows' LSE (natural log) and delta, [kStages][kBQT] each.
  float* sLse = reinterpret_cast<float*>(sQD + kStages * kStage);
  float* sDelta = sLse + kStages * kBQT;
  __shared__ uint64_t bars[2 * kStages];      // full, then empty

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, quad = lane & 3;
  const int kb0 = blockIdx.x * kBKW;   // the first blocks see most queries
  const int hk = blockIdx.y, b = blockIdx.z;
  const int heads = hq / hkv;
  const int64_t q_row = static_cast<int64_t>(hq) * d;
  const int64_t k_row = static_cast<int64_t>(hkv) * d;
  const int64_t k_base = static_cast<int64_t>(b) * sk * k_row +
                         static_cast<int64_t>(hk) * d;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&bars[s]), kThreads);
      mbar_init(smem_u32(&bars[kStages + s]), kThreads);
    }
    mbar_fence_init();
  }
  load_tile<kBKW, NP, kThreads>(sK, k + k_base, k_row, kb0, sk, d, vec, tid);
  load_tile<kBKW, NP, kThreads>(sV, v + k_base, k_row, kb0, sk, d, vec, tid);
  cp_async_commit();
  cp_async_wait<0>();   // K and V have landed
  fence_proxy_async();
  __syncthreads();

  // The queries that see a key of the block: [q_lo, q_hi).
  const int kb_last = min(kb0 + kBKW, sk) - 1;
  const int q_lo = max(0, kb0 - q_offset);
  const int q_hi = window > 0 ? static_cast<int>(max(0LL, min(
                                   static_cast<long long>(sq),
                                   static_cast<long long>(kb_last) + window -
                                       q_offset)))
                             : sq;
  const int n_qt = q_hi > q_lo ? (q_hi - q_lo + kBQT - 1) / kBQT : 0;
  const int n_it = heads * n_qt;

  // Iteration it's Q and dO tiles (head hk heads + it / n_qt, query tile
  // it % n_qt) with their rows' LSE and delta into its stage, every thread
  // its share, once every thread is done with the tile the stage held.
  auto load_q = [&](int it) {
    const int st = it % kStages;
    mbar_wait(smem_u32(&bars[kStages + st]), ((it / kStages) & 1) ^ 1);
    const int h = hk * heads + it / n_qt, qq0 = q_lo + (it % n_qt) * kBQT;
    const int64_t q_base = static_cast<int64_t>(b) * sq * q_row +
                           static_cast<int64_t>(h) * d;
    const int64_t r_base = (static_cast<int64_t>(b) * hq + h) * sq;
    uint8_t* tQ = sQD + st * kStage;
    load_tile<kBQT, NP, kThreads>(tQ, q + q_base, q_row, qq0, sq, d, vec,
                                  tid);
    load_tile<kBQT, NP, kThreads>(tQ + NP * kTPanel, dout + q_base, q_row,
                                  qq0, sq, d, vec, tid);
    // Rows past Sq read as 0: the mask sets their P to 0.
    if (tid < 2 * kBQT) {
      const int i = tid & (kBQT - 1), qi = qq0 + i;
      const int64_t src = r_base + (qi < sq ? qi : 0);
      cp_async4(smem_u32((tid < kBQT ? sLse : sDelta) + st * kBQT + i),
                (tid < kBQT ? lse : delta) + src, qi < sq);
    }
    stage_filled(smem_u32(&bars[st]), vec);
  };
  for (int it = 0; it < kStages - 1 && it < n_it; ++it) load_q(it);

  const int kw0 = kb0 + wg * 64;               // the warpgroup's first key
  const int key_lo = kw0 + warp * 16 + g;      // keys key_lo and key_lo + 8
  const uint32_t sQD_u = smem_u32(sQD);
  const uint64_t k_desc = desc(smem_u32(sK) + wg * 64 * 128, 16, 1024);
  const uint64_t v_desc = desc(smem_u32(sV) + wg * 64 * 128, 16, 1024);
  const uint64_t t_desc = desc(sQD_u, 16, 1024);        // K-major B
  const uint64_t tt_desc = desc(sQD_u, kTPanel, 1024);  // MN-major B
  float ak[NP][32], av[NP][32], s[32], dp[32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) ak[p][i] = av[p][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it + kStages - 1 < n_it) load_q(it + kStages - 1);
    const int stage = it % kStages;
    mbar_wait(smem_u32(&bars[stage]), (it / kStages) & 1);   // tile landed
    fence_proxy_async();
    const int qq0 = q_lo + (it % n_qt) * kBQT, qp0 = q_offset + qq0;
    const uint32_t st = stage * kStage;
    const bool work = kw0 < sk && kw0 <= qp0 + kBQT - 1 &&
                      (window <= 0 || qp0 - (kw0 + 63) < window);
    if (work) {
      fence_acc(s);
      fence_acc(dp);
      wg_fence();
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t a = (p * kWPanel + kk * 32) >> 4;
          const uint32_t bo = st + p * kTPanel + kk * 32;
          Wgmma<64>::template ss<0, 0>(s, k_desc + a, t_desc + (bo >> 4),
                                       (p | kk) != 0);
          Wgmma<64>::template ss<0, 0>(
              dp, v_desc + a, t_desc + ((bo + NP * kTPanel) >> 4),
              (p | kk) != 0);
        }
      wg_commit();
    }
    if (work) {
      const float* tl = sLse + stage * kBQT;
      const float* td = sDelta + stage * kBQT;
      wg_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      // Every (key, query) pair of the tile is visible unless it crosses
      // Sq, Sk, the causal edge or the window's edge.
      const bool full = qq0 + kBQT <= sq && kw0 + 64 <= sk &&
                        kw0 + 63 <= qp0 &&
                        (window <= 0 || qp0 + kBQT - 1 - kw0 < window);
      float l2[8][2], dl[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          l2[j][c] = tl[8 * j + 2 * quad + c] * kLog2e;
          dl[j][c] = td[8 * j + 2 * quad + c];
        }
      if (full) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pv = ex2(fmaf(s[4 * j + e], scale_log2, -l2[j][e & 1]));
            s[4 * j + e] = pv;                                      // P^T
            dp[4 * j + e] = pv * (dp[4 * j + e] - dl[j][e & 1]);    // dS^T
          }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = qq0 + 8 * j + 2 * quad + (e & 1);
            const bool ok = (qi < sq) & sees(q_offset + qi,
                                             key_lo + 8 * (e >> 1), sk,
                                             window);
            const float pv =
                ok ? ex2(fmaf(s[4 * j + e], scale_log2, -l2[j][e & 1]))
                   : 0.f;
            s[4 * j + e] = pv;
            dp[4 * j + e] = pv * (dp[4 * j + e] - dl[j][e & 1]);
          }
      }
      uint32_t pf[4][4], df[4][4];
      to_frags<4>(pf, s);
      to_frags<4>(df, dp);
      pin_frags(pf);
      pin_frags(df);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        fence_acc(av[p]);
        fence_acc(ak[p]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const uint32_t bo = st + p * kTPanel + kk * 16 * 128;
          Wgmma<64>::template rs<1>(av[p], pf[kk],
                                    tt_desc + ((bo + NP * kTPanel) >> 4), 1);
          Wgmma<64>::template rs<1>(ak[p], df[kk], tt_desc + (bo >> 4), 1);
        }
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        fence_acc(av[p]);
        fence_acc(ak[p]);
      }
    }
    mbar_arrive(smem_u32(&bars[kStages + stage]));
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + 8 * r;
    if (key >= sk) continue;
    const int64_t off = k_base + static_cast<int64_t>(key) * k_row;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 64 * p + 8 * i + 2 * quad + e;
          if (col < d) {
            dk[off + col] =
                __float2bfloat16_rn(ak[p][4 * i + 2 * r + e] * scale);
            dv[off + col] = __float2bfloat16_rn(av[p][4 * i + 2 * r + e]);
          }
        }
  }
}

// ------------------------------------------------------------------ fp32
struct Args {
  const void *q, *k, *v, *o, *lse, *dout;
  void *dq, *dk, *dv, *delta;
  int b, sq, sk, hq, hkv, d, q_offset, window;
  float scale;
  int vec, parts;
};

// In their own namespace: its constants hide the bf16 kernels' names.
namespace f32 {

// The mma.sync kernels' tiles for NP = 2-4 64-column panels of the padded
// head dim (64 < D <= 64 NP).  Every tile's rows are pitched kLd = 64 NP +
// 4 floats, which puts each fragment load below on 32 distinct banks.  dq:
// kDqWarps warps of 16 query rows, key tiles of kBK; dk/dv: kKG groups of
// 16 keys, two warps a group (one a role), query tiles of kBQT.  Both keep
// a ring of two stages within the 227 KB a block may hold.
template <int NP>
struct Cfg {
  static_assert(NP >= 2 && NP <= 4, "D <= 64 takes the wgmma kernels");
  static constexpr int kLd = 64 * NP + 4;
  static constexpr int kDqWarps = NP == 2 ? 8 : 4;
  static constexpr int kBQ = 16 * kDqWarps;
  static constexpr int kBK = NP <= 3 ? 32 : 16;
  // Q, dO, two stages of K and V, the rows' LSE and delta.
  static constexpr int kDqSmem = ((2 * kBQ + 4 * kBK) * kLd + 2 * kBQ) * 4;
  static constexpr int kKG = 4;
  static constexpr int kBKV = 16 * kKG;
  static constexpr int kBQT = NP == 4 ? 16 : 32;
  // K, V, two stages of Q and dO, the handed-over P^T, two stages of the
  // rows' LSE and delta.
  static constexpr int kDkdvSmem =
      ((2 * kBKV + 4 * kBQT) * kLd + kBKV * kBQT + 4 * kBQT) * 4;
  // 8-column tiles of D a pass of the gradient products takes (registers:
  // 8 a tile beside the gradient's 4 NP x 8).
  static constexpr int kPanel = 4;
  static_assert(kDqSmem <= 232448 && kDkdvSmem <= 232448, "227 KB");
};

// Rows [r0, r0 + R) of a (rows, d) fp32 matrix with row stride ld into
// dst [R][64 NP + 4], zero past nrows and past d, by the T threads
// t = 0 .. T - 1: 16-byte cp.async where vec (d % 4 == 0, 16-byte
// aligned rows), else plain loads.
template <int R, int NP, int T>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t ld, int r0, int nrows,
                                          int d, bool vec, int t) {
  constexpr int kLd = 64 * NP + 4;
  if (vec) {
#pragma unroll 4
    for (int idx = t; idx < R * NP * 16; idx += T) {
      const int r = idx / (NP * 16), c = (idx - r * (NP * 16)) * 4;
      const int row = r0 + r;
      const bool ok = row < nrows && c < d;
      cp_async16(smem_u32(dst + r * kLd + c),
                 ok ? src + static_cast<int64_t>(row) * ld + c : src, ok);
    }
  } else {
    for (int idx = t; idx < R * NP * 64; idx += T) {
      const int r = idx / (NP * 64), c = idx - r * (NP * 64), row = r0 + r;
      dst[r * kLd + c] = row < nrows && c < d
                             ? src[static_cast<int64_t>(row) * ld + c]
                             : 0.f;
    }
  }
}

// This warp's 16 x 8 KT tile A B^T: A its 16 rows of [row][col] storage
// at a, B the 8 KT rows of [row][col] storage at bt (times mul, in fp32,
// as each is loaded, where kMul), summed over the kd 8-column steps that
// hold data; every operand split as it is loaded, hi hi and the small
// terms in separate accumulators, added last.
template <int KT, int NP, bool kMul>
__device__ __forceinline__ void product_nt(float (&out)[KT][4],
                                           const float* a, const float* bt,
                                           int kd, int g, int tq,
                                           float mul) {
  constexpr int kLd = 64 * NP + 4;
  float big[KT][4], sm[KT][4];
#pragma unroll
  for (int nt = 0; nt < KT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) big[nt][e] = sm[nt][e] = 0.f;
  static_assert(KT % 2 == 0, "B fragments load two 8-row blocks at once");
  const int lane = 4 * g + tq;
#pragma unroll 2
  for (int kk = 0; kk < kd; ++kk) {
    uint32_t r[4], ah[4], al[4];
    ldsm_a(r, a + 8 * kk, kLd, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), ah[i], al[i]);
#pragma unroll
    for (int nt = 0; nt < KT; nt += 2) {
      uint32_t bh[4], bl[4];
      ldsm_b2(r, bt + 8 * nt * kLd + 8 * kk, kLd, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = __uint_as_float(r[i]);
        split(kMul ? x * mul : x, bh[i], bl[i]);
      }
      mma3(big[nt], sm[nt], ah, al, bh[0], bh[1], bl[0], bl[1]);
      mma3(big[nt + 1], sm[nt + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < KT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[nt][e] = big[nt][e] + sm[nt][e];
}

// A 16 x 8 KT accumulator tile as split A fragments over its columns:
// MMA slot t takes column 2t of each 8 and slot t + 4 column 2t + 1 (the
// sum runs over them in any order), so no shuffle is needed.
template <int KT>
__device__ __forceinline__ void to_frags(const float (&s)[KT][4],
                                         uint32_t (&fh)[KT][4],
                                         uint32_t (&fl)[KT][4]) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    split(s[kk][0], fh[kk][0], fl[kk][0]);
    split(s[kk][2], fh[kk][1], fl[kk][1]);
    split(s[kk][1], fh[kk][2], fl[kk][2]);
    split(s[kk][3], fh[kk][3], fl[kk][3]);
  }
}

// acc (this warp's 16 rows x 64 NP columns) += F B: F the 16 x 8 KT
// fragments of to_frags, B its 8 KT rows of [row][col] storage at b (times
// mul as loaded, where kMul), in slot order.  kPanel 8-column tiles at a
// time (those past the kd that hold data are skipped), each tile's
// product formed afresh and added to acc in fp32: tensor-core sums round
// toward zero, so the truncation acts on one tile's sum, never on the
// running gradient.
template <int KT, int NP, int kPanel, bool kMul>
__device__ __forceinline__ void accumulate(float (&acc)[NP * 8][4],
                                           const uint32_t (&fh)[KT][4],
                                           const uint32_t (&fl)[KT][4],
                                           const float* b, int kd, int g,
                                           int tq, float mul) {
  constexpr int kLd = 64 * NP + 4;
#pragma unroll
  for (int p0 = 0; p0 < NP * 8; p0 += kPanel) {
    if (p0 >= kd) break;
    float big[kPanel][4], sm[kPanel][4];
#pragma unroll
    for (int j = 0; j < kPanel; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[j][e] = sm[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const float* bp = b + (8 * kk + 2 * tq) * kLd + 8 * p0 + g;
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        const float v0 = bp[8 * j], v1 = bp[kLd + 8 * j];
        split(kMul ? v0 * mul : v0, bh0, bl0);
        split(kMul ? v1 * mul : v1, bh1, bl1);
        mma3(big[j], sm[j], fh[kk], fl[kk], bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int j = 0; j < kPanel; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p0 + j][e] += big[j][e] + sm[j][e];
  }
}

template <int NP>
__global__ void __launch_bounds__(32 * Cfg<NP>::kDqWarps, 1)
fa_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ o,
                     const float* __restrict__ lse,
                     const float* __restrict__ dout, float* __restrict__ dq,
                     float* __restrict__ delta, int sq, int sk, int hq,
                     int hkv, int d, int q_offset, int window, float scale,
                     int vec) {
  using C = Cfg<NP>;
  constexpr int kLd = C::kLd, kBQ = C::kBQ, kBK = C::kBK;
  constexpr int kThreads = 32 * C::kDqWarps;
  constexpr int kKT = kBK / 8;   // 8-key blocks a tile
  constexpr int kNT = NP * 8;    // 8-column tiles of the padded D
  static_assert(kPasses == 3, "mma3: hi hi, hi lo, lo hi");
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // [kBQ][kLd], q D^-0.5
  float* sdO = sQ + kBQ * kLd;                   // [kBQ][kLd]
  float* sKV = sdO + kBQ * kLd;                  // 2 x (K, V), [kBK][kLd]
  float* sLse = sKV + 4 * kBK * kLd;             // [kBQ]
  float* sDelta = sLse + kBQ;                    // [kBQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
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

  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, sq) - 1;
  const int k_end = min(sk, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  auto load_kv = [&](int t) {   // tile t into stage t % 2
    float* st = sKV + (t & 1) * 2 * kBK * kLd;
    const int j0 = k_begin + t * kBK;
    load_rows<kBK, NP, kThreads>(st, k + k_base, k_row, j0, sk, d, vec, tid);
    load_rows<kBK, NP, kThreads>(st + kBK * kLd, v + k_base, k_row, j0, sk,
                                 d, vec, tid);
  };
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();
  // Q scaled in fp32 as the plain version scales it, and dO.
  for (int idx = tid; idx < kBQ * NP * 64; idx += kThreads) {
    const int r = idx / (NP * 64), c = idx - r * (NP * 64), qi = q0 + r;
    const bool ok = qi < sq && c < d;
    const int64_t off = q_base + static_cast<int64_t>(qi) * q_row + c;
    sQ[r * kLd + c] = ok ? q[off] * scale : 0.f;
    sdO[r * kLd + c] = ok ? dout[off] : 0.f;
  }
  __syncthreads();
  {   // delta = rowsum(dO O) and the LSE of the warp's rows, two lanes a row
    const int r = warp * 16 + (lane >> 1), qi = q0 + r;
    float acc = 0.f;
    if (qi < sq) {
      const float* orow = o + q_base + static_cast<int64_t>(qi) * q_row;
      for (int c = lane & 1; c < d; c += 2)
        acc = fmaf(orow[c], sdO[r * kLd + c], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((lane & 1) == 0) {
      sDelta[r] = acc;
      // Rows past Sq: P = exp(s - inf) = 0.
      sLse[r] = qi < sq ? lse[r_base + qi] : INFINITY;
      if (qi < sq) delta[r_base + qi] = acc;
    }
  }
  __syncwarp();   // a warp reads only its own rows' LSE and delta

  const int r0 = warp * 16;
  const int qp_lo = q_offset + q0 + r0 + g;   // this thread's rows: +0, +8
  const int w_first = q_offset + q0 + r0, w_last = w_first + 15;
  const bool w_rows = q0 + r0 < sq;   // a row of the warp is real
  const float lr[2] = {sLse[r0 + g], sLse[r0 + g + 8]};
  const float dr[2] = {sDelta[r0 + g], sDelta[r0 + g + 8]};
  const int kd = (d + 7) >> 3;        // 8-column steps of D holding data
  float acc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();   // tile t has landed
    __syncthreads();      // and every warp is done with tile t - 1
    if (t + 1 < n_tiles) load_kv(t + 1);
    cp_async_commit();
    const int j0 = k_begin + t * kBK;
    if (!w_rows || j0 > w_last ||
        (window > 0 && w_first - (j0 + kBK - 1) >= window))
      continue;   // no row of this warp sees a key of the tile
    const float* tK = sKV + (t & 1) * 2 * kBK * kLd;
    const float* tV = tK + kBK * kLd;
    float s[kKT][4], dp[kKT][4];
    product_nt<kKT, NP, false>(s, sQ + r0 * kLd, tK, kd, g, tq, 1.f);
    product_nt<kKT, NP, false>(dp, sdO + r0 * kLd, tV, kd, g, tq, 1.f);
    // Every key of the tile is visible from every row of the warp unless
    // the tile crosses Sk, the causal edge or the window's edge.
    const bool full = j0 + kBK <= sk && j0 + kBK - 1 <= w_first &&
                      (window <= 0 || w_last - j0 < window);
#pragma unroll
    for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok =
            full || sees(qp_lo + 8 * r, j0 + 8 * nt + 2 * tq + (e & 1), sk,
                         window);
        const float pv = ok ? expf(s[nt][e] - lr[r]) : 0.f;
        s[nt][e] = pv * (dp[nt][e] - dr[r]);   // dS
      }
    uint32_t fh[kKT][4], fl[kKT][4];
    to_frags<kKT>(s, fh, fl);
    accumulate<kKT, NP, C::kPanel, false>(acc, fh, fl, tK, kd, g, tq, 1.f);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= sq) continue;
    float* row = dq + q_base + static_cast<int64_t>(qi) * q_row;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * nt + 2 * tq + e;
        if (col < d) row[col] = acc[nt][2 * r + e] * scale;
      }
  }
}

template <int NP>
__global__ void __launch_bounds__(64 * Cfg<NP>::kKG, 1)
fa_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ lse,
                       const float* __restrict__ dout,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int sq,
                       int sk, int hq, int hkv, int d, int q_offset,
                       int window, float scale, int vec) {
  using C = Cfg<NP>;
  constexpr int kLd = C::kLd, kBKV = C::kBKV, kBQT = C::kBQT, kKG = C::kKG;
  constexpr int kThreads = 64 * kKG;
  constexpr int kQT = kBQT / 8;   // 8-query blocks a tile
  constexpr int kNT = NP * 8;
  static_assert(kPasses == 3, "mma3: hi hi, hi lo, lo hi");
  static_assert(kThreads >= 2 * kBQT, "a thread a row's LSE or delta");
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);   // [kBKV][kLd]
  float* sV = sK + kBKV * kLd;                   // [kBKV][kLd]
  float* sQD = sV + kBKV * kLd;                  // 2 x (Q, dO), [kBQT][kLd]
  // P^T, handed from each key group's role-0 warp to its role-1 warp in
  // the accumulator's layout: [kKG][kQT][32 lanes] float4.
  float4* sP = reinterpret_cast<float4*>(sQD + 4 * kBQT * kLd);
  float* sLse = reinterpret_cast<float*>(sP + kKG * kQT * 32);   // 2 x [kBQT]
  float* sDelta = sLse + 2 * kBQT;                               // 2 x [kBQT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int kg = warp % kKG, role = warp / kKG;
  const int kb0 = blockIdx.x * kBKV;   // the first blocks see most queries
  const int hk = blockIdx.y, b = blockIdx.z;
  const int heads = hq / hkv;
  const int64_t q_row = static_cast<int64_t>(hq) * d;
  const int64_t k_row = static_cast<int64_t>(hkv) * d;
  const int64_t k_base = static_cast<int64_t>(b) * sk * k_row +
                         static_cast<int64_t>(hk) * d;
  load_rows<kBKV, NP, kThreads>(sK, k + k_base, k_row, kb0, sk, d, vec, tid);
  load_rows<kBKV, NP, kThreads>(sV, v + k_base, k_row, kb0, sk, d, vec, tid);

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

  // Iteration it's Q and dO tiles (head hk heads + it / n_qt, query tile
  // it % n_qt) and their rows' LSE and delta into stage it % 2.  Rows past
  // Sq read as 0: the mask sets their P to 0.
  auto load_q = [&](int it) {
    const int st = it & 1;
    const int h = hk * heads + it / n_qt, qq0 = q_lo + (it % n_qt) * kBQT;
    const int64_t q_base = static_cast<int64_t>(b) * sq * q_row +
                           static_cast<int64_t>(h) * d;
    const int64_t r_base = (static_cast<int64_t>(b) * hq + h) * sq;
    float* tQ = sQD + st * 2 * kBQT * kLd;
    load_rows<kBQT, NP, kThreads>(tQ, q + q_base, q_row, qq0, sq, d, vec,
                                  tid);
    load_rows<kBQT, NP, kThreads>(tQ + kBQT * kLd, dout + q_base, q_row, qq0,
                                  sq, d, vec, tid);
    if (tid < 2 * kBQT) {
      const int i = tid % kBQT, qi = qq0 + i;
      const int64_t src = r_base + (qi < sq ? qi : 0);
      cp_async4(smem_u32((tid < kBQT ? sLse : sDelta) + st * kBQT + i),
                (tid < kBQT ? lse : delta) + src, qi < sq);
    }
  };
  if (n_it > 0) load_q(0);
  cp_async_commit();

  // Role 0 computes S^T = K (q D^-0.5)^T, P^T and dV += P^T dO; role 1
  // dP^T = V dO^T, dS^T = P^T (dP^T - delta) from role 0's P^T, and
  // dK += dS^T (q D^-0.5).  Each holds all D columns of its gradient for
  // its group's 16 keys.
  const int kw0 = kb0 + 16 * kg;   // the warp's first key
  const int key_lo = kw0 + g;      // this thread's keys: +0, +8
  const float* ka = (role == 0 ? sK : sV) + 16 * kg * kLd;
  float4* pbuf = sP + kg * kQT * 32;
  const int kd = (d + 7) >> 3;
  float acc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();   // tile it has landed
    __syncthreads();      // and every warp is done with tile it - 1
    if (it + 1 < n_it) load_q(it + 1);
    cp_async_commit();
    const int st = it & 1;
    const int qq0 = q_lo + (it % n_qt) * kBQT, qp0 = q_offset + qq0;
    const float* tQ = sQD + st * 2 * kBQT * kLd;
    const float* tD = tQ + kBQT * kLd;
    const float* tl = sLse + st * kBQT;
    const float* td = sDelta + st * kBQT;
    // A pair of the warp's keys and the tile's queries is visible
    // (work), and every pair is (full: no mask).
    const bool work = kw0 < sk && kw0 <= qp0 + kBQT - 1 &&
                      (window <= 0 || qp0 - (kw0 + 15) < window);
    const bool full = qq0 + kBQT <= sq && kw0 + 16 <= sk &&
                      kw0 + 15 <= qp0 &&
                      (window <= 0 || qp0 + kBQT - 1 - kw0 < window);
    float s[kQT][4];
    if (work) {
      if (role == 0) {
        product_nt<kQT, NP, true>(s, ka, tQ, kd, g, tq, scale);
#pragma unroll
        for (int j = 0; j < kQT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = 8 * j + 2 * tq + (e & 1), qi = qq0 + qc;
            const bool ok = full || ((qi < sq) &
                                     sees(q_offset + qi,
                                          key_lo + 8 * (e >> 1), sk, window));
            s[j][e] = ok ? expf(s[j][e] - tl[qc]) : 0.f;   // P^T
          }
#pragma unroll
        for (int j = 0; j < kQT; ++j)
          pbuf[j * 32 + lane] = make_float4(s[j][0], s[j][1], s[j][2],
                                            s[j][3]);
      } else {
        product_nt<kQT, NP, false>(s, ka, tD, kd, g, tq, 1.f);   // dP^T
      }
    }
    __syncthreads();   // P^T is in shared memory
    if (work) {
      if (role == 1) {
#pragma unroll
        for (int j = 0; j < kQT; ++j) {
          const float4 pv = pbuf[j * 32 + lane];
          const float pe[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = pe[e] * (s[j][e] - td[8 * j + 2 * tq + (e & 1)]);
        }
      }
      uint32_t fh[kQT][4], fl[kQT][4];
      to_frags<kQT>(s, fh, fl);
      if (role == 0)   // dV += P^T dO
        accumulate<kQT, NP, C::kPanel, false>(acc, fh, fl, tD, kd, g, tq,
                                              1.f);
      else             // dK += dS^T (q D^-0.5)
        accumulate<kQT, NP, C::kPanel, true>(acc, fh, fl, tQ, kd, g, tq,
                                             scale);
    }
  }
  cp_async_wait<0>();

  float* out = role == 0 ? dv : dk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + 8 * r;
    if (key >= sk) continue;
    float* row = out + k_base + static_cast<int64_t>(key) * k_row;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * nt + 2 * tq + e;
        if (col < d) row[col] = acc[nt][2 * r + e];
      }
  }
}

// D <= 64 (zamba2's heads): both kernels on wgmma.m64n32k8 and m64n64k8
// TF32, as fa_wgmma_kernel (flash_attention.cu) takes the forward: every
// operand split once into hi and lo in shared memory, K-major under the
// 128-byte swizzle (the only layout TF32 wgmma takes), products three
// wgmma a step (hi lo, lo hi, hi hi; hi hi and the small terms in their
// own accumulators), score accumulators turned into register A operands
// in MMA-slot order.  Two warpgroups a block, 64 rows of their own each.
// - dq: 128 query rows a block; per key tile of 32, raw K and V land
//   through a cp.async ring of two and one pass of the block splits K and
//   V (rows of keys) and K^T (rows of D, keys in slot order); S = Q K^T
//   and dP = dO V^T (m64n32k8, Q and dO split once a block), then dQ's
//   tile = dS K (m64n64k8, dS from registers), added to dQ in fp32.
// - dk/dv: 128 keys a block, K and V split once; per query tile of 32 of
//   each head of the group, Q (scaled) and dO split as rows and as
//   transposes, S^T = K Q^T and dP^T = V dO^T, then dV's tile = P^T dO
//   and dK's = dS^T Q, each added to its gradient in fp32.
// 210 and 226 KB of shared memory.
namespace wg {
constexpr int kThreads = 256;            // two warpgroups
constexpr int kBQ = 128;                 // dq: query rows a block
constexpr int kBK = 32;                  // dq: keys a tile
constexpr int kBKV = 128;                // dk/dv: keys a block
constexpr int kBQT = 32;                 // dk/dv: queries a tile
constexpr int kTPanel = 64 * 128;        // 64 rows of D x 32 TF32, swizzled
constexpr int kRawTile = 32 * 64 * 4;    // 32 rows x 64 floats
// dq, bytes from a 1024-byte aligned base: Q and dO hi and lo (two
// 32-column panels of 128 rows each), the tile's K and V hi and lo (two
// panels of 32 rows), K^T hi and lo, the ring of raw K and V, the rows'
// LSE and delta.
constexpr int kRowPanel = kBQ * 128;
constexpr int kTilePanel = kBK * 128;
constexpr int kQ = 0, kdO = kQ + 4 * kRowPanel, kK = kdO + 4 * kRowPanel;
constexpr int kV = kK + 4 * kTilePanel, kKt = kV + 4 * kTilePanel;
constexpr int kRaw = kKt + 2 * kTPanel;
constexpr int kDqRows = kRaw + 4 * kRawTile;
constexpr int kDqSmem = 1024 + kDqRows + 2 * kBQ * 4;
// dk/dv: K and V hi and lo (two panels of 128 rows), the tile's Q and dO
// hi and lo (two panels of 32 rows), Q^T and dO^T hi and lo, the ring of
// raw Q and dO, the ring of the rows' LSE and delta.
constexpr int kKeyPanel = kBKV * 128;
constexpr int kQPanel = kBQT * 128;
constexpr int kKk = 0, kVv = kKk + 4 * kKeyPanel, kQq = kVv + 4 * kKeyPanel;
constexpr int kDd = kQq + 4 * kQPanel, kQt = kDd + 4 * kQPanel;
constexpr int kDt = kQt + 2 * kTPanel, kRawQ = kDt + 2 * kTPanel;
constexpr int kRing = kRawQ + 4 * kRawTile;
constexpr int kDkdvSmem = 1024 + kRing + 4 * kBQT * 4;
static_assert(kDqSmem <= 232448 && kDkdvSmem <= 232448, "227 KB");
}  // namespace wg

// 32 rows x 64 floats of a (rows, d) matrix (row stride ld, rows from r0)
// into raw [32][64], zero past nrows and past d, by the 256 threads.
__device__ __forceinline__ void load_raw(float* dst, const float* src,
                                         int64_t ld, int r0, int nrows,
                                         int d, bool vec, int tid) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < 32 * 16 / wg::kThreads; ++i) {
      const int idx = tid + i * wg::kThreads, r = idx >> 4;
      const int c = 4 * (idx & 15), row = r0 + r;
      const bool ok = row < nrows && c < d;
      cp_async16(smem_u32(dst + r * 64 + c),
                 ok ? src + static_cast<int64_t>(row) * ld + c : src, ok);
    }
  } else {
    for (int idx = tid; idx < 32 * 64; idx += wg::kThreads) {
      const int r = idx >> 6, c = idx & 63, row = r0 + r;
      dst[idx] = row < nrows && c < d
                     ? src[static_cast<int64_t>(row) * ld + c]
                     : 0.f;
    }
  }
}
// Row r's 4 floats from column c of a (rows, d) matrix, zero past d.
__device__ __forceinline__ float4 load4(const float* row, int c, int d,
                                        bool vec) {
  if (vec) return c < d ? *reinterpret_cast<const float4*>(row + c)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(c < d ? row[c] : 0.f, c + 1 < d ? row[c + 1] : 0.f,
                     c + 2 < d ? row[c + 2] : 0.f,
                     c + 3 < d ? row[c + 3] : 0.f);
}
__device__ __forceinline__ float4 mul4(float4 v, float m) {
  return make_float4(v.x * m, v.y * m, v.z * m, v.w * m);
}
// A raw [32][64] tile (times mul) split into the K-major panels of its 32
// rows at `at` (hi; lo 2 panel bytes on), 2 chunks a thread.
__device__ __forceinline__ void split_rows(uint8_t* smem, uint32_t at,
                                           uint32_t panel, const float* raw,
                                           float mul, int tid) {
#pragma unroll
  for (int i = 0; i < 32 * 16 / wg::kThreads; ++i) {
    const int idx = tid + i * wg::kThreads, r = idx >> 4, c16 = idx & 15;
    store_split(smem, at + (c16 >> 3) * panel + swz(r, c16 & 7), 2 * panel,
                mul4(*reinterpret_cast<const float4*>(raw + r * 64 + 4 * c16),
                     mul));
  }
}
// The same tile (times mul) transposed into one panel of 64 rows of D at
// `at` (hi; lo kTPanel on), its 32 rows in MMA-slot order: slot s of each
// 8 holds row 2s for s < 4 and 2 (s - 4) + 1 after, the order an
// accumulator turned A operand pairs with.
__device__ __forceinline__ void split_cols(uint8_t* smem, uint32_t at,
                                           const float* raw, float mul,
                                           int tid) {
#pragma unroll
  for (int i = 0; i < 64 * 8 / wg::kThreads; ++i) {
    const int idx = tid + i * wg::kThreads;
    const int dd = idx & 63, cg = idx >> 6;   // column of D, slot group
    const int k0 = 8 * (cg >> 1) + (cg & 1);  // rows k0, + 2, + 4, + 6
    store_split(smem, at + swz(dd, cg), wg::kTPanel,
                make_float4(raw[k0 * 64 + dd] * mul,
                            raw[(k0 + 2) * 64 + dd] * mul,
                            raw[(k0 + 4) * 64 + dd] * mul,
                            raw[(k0 + 6) * 64 + dd] * mul));
  }
}
// A 64 x 32 score accumulator (per warp rows g, g + 8 by columns 8 i + 2 t
// + {0, 1}) as split A fragments over its columns, in slot order.
__device__ __forceinline__ void frags32(const float (&s)[16],
                                        uint32_t (&fh)[4][4],
                                        uint32_t (&fl)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split(s[4 * kk + 0], fh[kk][0], fl[kk][0]);
    split(s[4 * kk + 2], fh[kk][1], fl[kk][1]);
    split(s[4 * kk + 1], fh[kk][2], fl[kk][2]);
    split(s[4 * kk + 3], fh[kk][3], fl[kk][3]);
  }
}
// t (64 x 64) = F B over 32 columns: F the fragments of frags32, B one
// panel of 64 rows of D at bh (hi) and bl (lo); three wgmma a step,
// formed afresh (the first step overwrites) and added to acc in fp32.
__device__ __forceinline__ void grad_tile(float (&acc)[32], float (&tb)[32],
                                          float (&ts)[32],
                                          uint32_t (&fh)[4][4],
                                          uint32_t (&fl)[4][4], uint32_t bh,
                                          uint32_t bl) {
#pragma unroll
  for (int i = 0; i < 32; ++i) tb[i] = ts[i] = 0.f;   // live only here
  fence_acc(tb);
  fence_acc(ts);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs(ts, fh[kk], desc(bl + kk * 32), kk > 0);
    wgmma_rs(ts, fl[kk], desc(bh + kk * 32), 1);
    wgmma_rs(tb, fh[kk], desc(bh + kk * 32), kk > 0);
  }
  wg_commit();
  wg_wait<0>();
  pin_frags(fh);
  pin_frags(fl);
  fence_acc(tb);
  fence_acc(ts);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += tb[i] + ts[i];
}

__global__ void __launch_bounds__(wg::kThreads, 1)
fa_bwd_dq_wg_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ lse,
                    const float* __restrict__ dout, float* __restrict__ dq,
                    float* __restrict__ delta, int sq, int sk, int hq,
                    int hkv, int d, int q_offset, int window, float scale,
                    int vec) {
  using namespace wg;
  static_assert(kPasses == 3, "three wgmma a step: hi lo, lo hi, hi hi");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* raw = reinterpret_cast<float*>(smem + kRaw);   // [stage][K|V]
  float* sLse = reinterpret_cast<float*>(smem + kDqRows);
  float* sDelta = sLse + kBQ;
  const uint32_t base = smem_u32(smem);

  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, tq = lane & 3;
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

  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, sq) - 1;
  const int k_end = min(sk, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  auto load_kv = [&](int t) {   // raw K and V of tile t into stage t % 2
    float* st = raw + (t & 1) * 2 * kBK * 64;
    const int j0 = k_begin + t * kBK;
    load_raw(st, k + k_base, k_row, j0, sk, d, vec, tid);
    load_raw(st + kBK * 64, v + k_base, k_row, j0, sk, d, vec, tid);
  };
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  // Q (scaled in fp32, as the plain version scales it) and dO, split once
  // into their K-major panels (all loads before the stores).
  {
    constexpr int kPer = kBQ * 16 / kThreads;
    float4 qv[kPer], ov[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 4, c = 4 * (idx & 15);
      const int64_t off = q_base + static_cast<int64_t>(q0 + r) * q_row;
      const bool in = q0 + r < sq;
      qv[i] = in ? load4(q + off, c, d, vec) : make_float4(0.f, 0.f, 0.f, 0.f);
      ov[i] = in ? load4(dout + off, c, d, vec)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 4, c16 = idx & 15;
      const uint32_t at = (c16 >> 3) * kRowPanel + swz(r, c16 & 7);
      store_split(smem, kQ + at, 2 * kRowPanel, mul4(qv[i], scale));
      store_split(smem, kdO + at, 2 * kRowPanel, ov[i]);
    }
  }
  {   // delta = rowsum(dO O) and the LSE of the block's rows, 2 threads a row
    const int r = tid >> 1, qi = q0 + r;
    float acc = 0.f;
    if (qi < sq) {
      const float* orow = o + q_base + static_cast<int64_t>(qi) * q_row;
      const float* drow = dout + q_base + static_cast<int64_t>(qi) * q_row;
      for (int c = tid & 1; c < d; c += 2) acc = fmaf(orow[c], drow[c], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      sDelta[r] = acc;
      // Rows past Sq: P = exp(s - inf) = 0.
      sLse[r] = qi < sq ? lse[r_base + qi] : INFINITY;
      if (qi < sq) delta[r_base + qi] = acc;
    }
  }
  __syncthreads();

  const int r_lo = wgi * 64 + warp * 16 + g;   // this thread's rows: +0, +8
  const int qp_lo = q_offset + q0 + r_lo;
  const int wg_first = q_offset + q0 + wgi * 64;   // the warpgroup's
  const int w_first = wg_first + warp * 16;        // and the warp's
  const bool wg_rows = q0 + wgi * 64 < sq;
  const float lr[2] = {sLse[r_lo], sLse[r_lo + 8]};
  const float dr[2] = {sDelta[r_lo], sDelta[r_lo + 8]};
  const uint32_t qh = base + kQ + wgi * 64 * 128, ql = qh + 2 * kRowPanel;
  const uint32_t oh = base + kdO + wgi * 64 * 128, ol = oh + 2 * kRowPanel;
  const uint32_t kh = base + kK, kl = kh + 2 * kTilePanel;
  const uint32_t vh = base + kV, vl = vh + 2 * kTilePanel;
  const uint32_t th = base + kKt, tl = th + kTPanel;
  // The running dQ; the wgmma accumulators, zeroed where each is used.
  float acc[32], tb[32], ts[32], sb[16], ss[16], pb[16], ps[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();   // raw tile t has landed
    __syncthreads();      // every warpgroup is done with tile t - 1
    if (t + 1 < n_tiles) load_kv(t + 1);
    cp_async_commit();
    const float* rk = raw + (t & 1) * 2 * kBK * 64;
    split_rows(smem, kK, kTilePanel, rk, 1.f, tid);
    split_rows(smem, kV, kTilePanel, rk + kBK * 64, 1.f, tid);
    split_cols(smem, kKt, rk, 1.f, tid);
    fence_proxy_async();   // the stores above, visible to wgmma
    __syncthreads();

    const int j0 = k_begin + t * kBK;
    if (!wg_rows || j0 > wg_first + 63 ||
        (window > 0 && wg_first - (j0 + kBK - 1) >= window))
      continue;   // no row of this warpgroup sees a key of the tile

    // S = (q scale) K^T and dP = dO V^T, one commit group.
#pragma unroll
    for (int i = 0; i < 16; ++i) sb[i] = ss[i] = pb[i] = ps[i] = 0.f;
    fence_acc(sb);
    fence_acc(ss);
    fence_acc(pb);
    fence_acc(ps);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t ao = (kk >> 2) * kRowPanel + (kk & 3) * 32;
      const uint32_t bo = (kk >> 2) * kTilePanel + (kk & 3) * 32;
      wgmma_ss32(ss, desc(qh + ao), desc(kl + bo), kk > 0);
      wgmma_ss32(ss, desc(ql + ao), desc(kh + bo), 1);
      wgmma_ss32(sb, desc(qh + ao), desc(kh + bo), kk > 0);
      wgmma_ss32(ps, desc(oh + ao), desc(vl + bo), kk > 0);
      wgmma_ss32(ps, desc(ol + ao), desc(vh + bo), 1);
      wgmma_ss32(pb, desc(oh + ao), desc(vh + bo), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_acc(sb);
    fence_acc(ss);
    fence_acc(pb);
    fence_acc(ps);

    // Every key of the tile is visible from every row of the warp unless
    // the tile crosses Sk, the causal edge or the window's edge.
    const bool full = j0 + kBK <= sk && j0 + kBK - 1 <= w_first &&
                      (window <= 0 || w_first + 15 - j0 < window);
    float s[16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * i + e, r = e >> 1;
        const bool ok = full || sees(qp_lo + 8 * r,
                                     j0 + 8 * i + 2 * tq + (e & 1), sk,
                                     window);
        const float pv = ok ? expf(sb[x] + ss[x] - lr[r]) : 0.f;
        s[x] = pv * (pb[x] + ps[x] - dr[r]);   // dS
      }
    uint32_t fh[4][4], fl[4][4];
    frags32(s, fh, fl);
    grad_tile(acc, tb, ts, fh, fl, th, tl);   // dQ += dS K
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r_lo + 8 * r;
    if (qi >= sq) continue;
    float* row = dq + q_base + static_cast<int64_t>(qi) * q_row;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * tq + e;
        if (col < d) row[col] = acc[4 * i + 2 * r + e] * scale;
      }
  }
}

__global__ void __launch_bounds__(wg::kThreads, 1)
fa_bwd_dkdv_wg_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ lse,
                      const float* __restrict__ dout,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int sq,
                      int sk, int hq, int hkv, int d, int q_offset,
                      int window, float scale, int vec) {
  using namespace wg;
  static_assert(kPasses == 3, "three wgmma a step: hi lo, lo hi, hi hi");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* raw = reinterpret_cast<float*>(smem + kRawQ);   // [stage][Q|dO]
  float* sRing = reinterpret_cast<float*>(smem + kRing);  // [stage][LSE|delta]
  const uint32_t base = smem_u32(smem);

  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int kb0 = blockIdx.x * kBKV;   // the first blocks see most queries
  const int hk = blockIdx.y, b = blockIdx.z;
  const int heads = hq / hkv;
  const int64_t q_row = static_cast<int64_t>(hq) * d;
  const int64_t k_row = static_cast<int64_t>(hkv) * d;
  const int64_t k_base = static_cast<int64_t>(b) * sk * k_row +
                         static_cast<int64_t>(hk) * d;

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

  // Iteration it's raw Q and dO (head hk heads + it / n_qt, query tile it
  // % n_qt) and their rows' LSE and delta into stage it % 2.  Rows past Sq
  // read as 0: the mask sets their P to 0.
  auto load_q = [&](int it) {
    const int st = it & 1;
    const int h = hk * heads + it / n_qt, qq0 = q_lo + (it % n_qt) * kBQT;
    const int64_t q_base = static_cast<int64_t>(b) * sq * q_row +
                           static_cast<int64_t>(h) * d;
    const int64_t r_base = (static_cast<int64_t>(b) * hq + h) * sq;
    float* rq = raw + st * 2 * kBQT * 64;
    load_raw(rq, q + q_base, q_row, qq0, sq, d, vec, tid);
    load_raw(rq + kBQT * 64, dout + q_base, q_row, qq0, sq, d, vec, tid);
    if (tid < 2 * kBQT) {
      const int i = tid % kBQT, qi = qq0 + i;
      const int64_t src = r_base + (qi < sq ? qi : 0);
      cp_async4(smem_u32(sRing + (2 * st + tid / kBQT) * kBQT + i),
                (tid < kBQT ? lse : delta) + src, qi < sq);
    }
  };
  if (n_it > 0) load_q(0);
  cp_async_commit();

  // K and V of the block's 128 keys, split once into their K-major panels.
  {
    constexpr int kPer = kBKV * 16 / kThreads;
    float4 kv4[kPer], vv4[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 4, c = 4 * (idx & 15);
      const int64_t off = k_base + static_cast<int64_t>(kb0 + r) * k_row;
      const bool in = kb0 + r < sk;
      kv4[i] = in ? load4(k + off, c, d, vec)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      vv4[i] = in ? load4(v + off, c, d, vec)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 4, c16 = idx & 15;
      const uint32_t at = (c16 >> 3) * kKeyPanel + swz(r, c16 & 7);
      store_split(smem, kKk + at, 2 * kKeyPanel, kv4[i]);
      store_split(smem, kVv + at, 2 * kKeyPanel, vv4[i]);
    }
  }

  const int kw0 = kb0 + wgi * 64;              // the warpgroup's first key
  const int kw = kw0 + warp * 16;              // the warp's
  const int key_lo = kw + g;                   // this thread's: +0, +8
  const uint32_t kah = base + kKk + wgi * 64 * 128, kal = kah + 2 * kKeyPanel;
  const uint32_t vah = base + kVv + wgi * 64 * 128, val = vah + 2 * kKeyPanel;
  const uint32_t qh = base + kQq, ql = qh + 2 * kQPanel;
  const uint32_t oh = base + kDd, ol = oh + 2 * kQPanel;
  const uint32_t qth = base + kQt, qtl = qth + kTPanel;
  const uint32_t oth = base + kDt, otl = oth + kTPanel;
  // The running dV and dK; the wgmma accumulators, zeroed where each is
  // used.
  float av[32], ak[32], tb[32], ts[32], sb[16], ss[16], pb[16], ps[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) av[i] = ak[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();   // raw tile it has landed
    __syncthreads();      // every warpgroup is done with tile it - 1
    if (it + 1 < n_it) load_q(it + 1);
    cp_async_commit();
    const int st = it & 1;
    const float* rq = raw + st * 2 * kBQT * 64;
    const float* rd = rq + kBQT * 64;
    split_rows(smem, kQq, kQPanel, rq, scale, tid);
    split_rows(smem, kDd, kQPanel, rd, 1.f, tid);
    split_cols(smem, kQt, rq, scale, tid);
    split_cols(smem, kDt, rd, 1.f, tid);
    fence_proxy_async();   // the stores above, visible to wgmma
    __syncthreads();

    const int qq0 = q_lo + (it % n_qt) * kBQT, qp0 = q_offset + qq0;
    if (kw0 >= sk || kw0 > qp0 + kBQT - 1 ||
        (window > 0 && qp0 - (kw0 + 63) >= window))
      continue;   // no key of this warpgroup is seen from the tile

    // S^T = K (q scale)^T and dP^T = V dO^T, one commit group.
#pragma unroll
    for (int i = 0; i < 16; ++i) sb[i] = ss[i] = pb[i] = ps[i] = 0.f;
    fence_acc(sb);
    fence_acc(ss);
    fence_acc(pb);
    fence_acc(ps);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t ao = (kk >> 2) * kKeyPanel + (kk & 3) * 32;
      const uint32_t bo = (kk >> 2) * kQPanel + (kk & 3) * 32;
      wgmma_ss32(ss, desc(kah + ao), desc(ql + bo), kk > 0);
      wgmma_ss32(ss, desc(kal + ao), desc(qh + bo), 1);
      wgmma_ss32(sb, desc(kah + ao), desc(qh + bo), kk > 0);
      wgmma_ss32(ps, desc(vah + ao), desc(ol + bo), kk > 0);
      wgmma_ss32(ps, desc(val + ao), desc(oh + bo), 1);
      wgmma_ss32(pb, desc(vah + ao), desc(oh + bo), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_acc(sb);
    fence_acc(ss);
    fence_acc(pb);
    fence_acc(ps);

    // P^T and dS^T: every pair of the warp's keys and the tile's queries
    // is visible unless the tile crosses Sq, Sk, the causal edge or the
    // window's edge.
    const float* tl_ = sRing + 2 * st * kBQT;
    const float* td = tl_ + kBQT;
    const bool full = qq0 + kBQT <= sq && kw + 16 <= sk && kw + 15 <= qp0 &&
                      (window <= 0 || qp0 + kBQT - 1 - kw < window);
    float p[16], ds[16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * i + e, qc = 8 * i + 2 * tq + (e & 1);
        const int qi = qq0 + qc;
        const bool ok = full || ((qi < sq) &
                                 sees(q_offset + qi, key_lo + 8 * (e >> 1),
                                      sk, window));
        p[x] = ok ? expf(sb[x] + ss[x] - tl_[qc]) : 0.f;
        ds[x] = p[x] * (pb[x] + ps[x] - td[qc]);
      }
    uint32_t fh[4][4], fl[4][4];
    frags32(p, fh, fl);
    grad_tile(av, tb, ts, fh, fl, oth, otl);    // dV += P^T dO
    frags32(ds, fh, fl);
    grad_tile(ak, tb, ts, fh, fl, qth, qtl);    // dK += dS^T (q scale)
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + 8 * r;
    if (key >= sk) continue;
    const int64_t off = k_base + static_cast<int64_t>(key) * k_row;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * tq + e;
        if (col < d) {
          dk[off + col] = ak[4 * i + 2 * r + e];
          dv[off + col] = av[4 * i + 2 * r + e];
        }
      }
  }
}

int launch_wg(const Args& a, cudaStream_t s) {
  using namespace wg;
  if (a.parts & 1) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dq_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kDqSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.sq + kBQ - 1) / kBQ, a.hq, a.b);
    fa_bwd_dq_wg_kernel<<<grid, kThreads, kDqSmem, s>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.o),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.dout),
        static_cast<float*>(a.dq), static_cast<float*>(a.delta), a.sq, a.sk,
        a.hq, a.hkv, a.d, a.q_offset, a.window, a.scale, a.vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((a.parts & 2) && a.sk > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dkdv_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kDkdvSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.sk + kBKV - 1) / kBKV, a.hkv, a.b);
    fa_bwd_dkdv_wg_kernel<<<grid, kThreads, kDkdvSmem, s>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.dout), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.sq, a.sk,
        a.hq, a.hkv, a.d, a.q_offset, a.window, a.scale, a.vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int NP>
int launch_f32(const Args& a, cudaStream_t s) {
  if constexpr (NP == 1) {
    return launch_wg(a, s);
  } else {
  using C = Cfg<NP>;
  if (a.parts & 1) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dq_f32_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kDqSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.sq + C::kBQ - 1) / C::kBQ, a.hq, a.b);
    fa_bwd_dq_f32_kernel<NP><<<grid, 32 * C::kDqWarps, C::kDqSmem, s>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.o),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.dout),
        static_cast<float*>(a.dq), static_cast<float*>(a.delta), a.sq, a.sk,
        a.hq, a.hkv, a.d, a.q_offset, a.window, a.scale, a.vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((a.parts & 2) && a.sk > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dkdv_f32_kernel<NP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDkdvSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.sk + C::kBKV - 1) / C::kBKV, a.hkv, a.b);
    fa_bwd_dkdv_f32_kernel<NP><<<grid, 64 * C::kKG, C::kDkdvSmem, s>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.dout), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.sq, a.sk,
        a.hq, a.hkv, a.d, a.q_offset, a.window, a.scale, a.vec);
  }
  return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace f32

using DkdvKernel = void (*)(const bf16*, const bf16*, const bf16*,
                           const float*, const bf16*, const float*, bf16*,
                           bf16*, int, int, int, int, int, int, int, float,
                           float, int);

template <int kKeys, int kSmem>
int launch_dkdv(DkdvKernel kernel, const Args& a, float scale_log2,
                cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sk + kKeys - 1) / kKeys, a.hkv, a.b);
  kernel<<<grid, kThreads, kSmem, s>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const float*>(a.lse),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.sq, a.sk, a.hq,
      a.hkv, a.d, a.q_offset, a.window, a.scale, scale_log2, a.vec);
  return static_cast<int>(cudaGetLastError());
}

template <int NP>
int launch_bf16(const Args& a, cudaStream_t s) {
  using C = Cfg<NP>;
  const float scale_log2 = a.scale * kLog2e;
  if (a.parts & 1) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dq_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kDqSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.sq + kBQ - 1) / kBQ, a.hq, a.b);
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
    if constexpr (NP <= kWideNP)
      return launch_dkdv<kBKW, C::kWideSmem>(fa_bwd_dkdv_wide_kernel<NP>, a,
                                             scale_log2, s);
    else
      return launch_dkdv<kBKV, C::kDkdvSmem>(fa_bwd_dkdv_kernel<NP>, a,
                                             scale_log2, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq: (B, Sq, Hq, D); k, v, dk, dv: (B, Sk, Hkv, D), all
// contiguous, bfloat16 (fp32 == 0) or float32; lse, delta: (B, Hq, Sq)
// float32 (lse the forward's, natural log; delta scratch, written by the
// first kernel, read by the second).  1 <= D <= 256, Hq % Hkv == 0,
// window <= 0 means none; scale = D^-0.5; vec != 0 when D % 8 == 0
// (bf16) or D % 4 == 0 (fp32) and every pointer is 16-byte aligned.  parts: 1 launches
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
