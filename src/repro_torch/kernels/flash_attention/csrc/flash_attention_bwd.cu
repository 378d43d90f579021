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

#include "../../csrc/sm90.cuh"
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
