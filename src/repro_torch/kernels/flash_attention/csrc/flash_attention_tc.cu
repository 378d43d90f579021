// Forward flash attention on bf16 inputs, with both products on Hopper's
// bf16 tensor cores (wgmma): GQA, causal from q_offset, optional sliding
// window, fp32 online softmax.
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _fa_kernel) for bf16 inputs; fp32 inputs take flash_attention.cu.
// It computes what _fa_kernel and the plain version
// (ref.py::flash_attention_ref) compute:
//
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / g])
//                  * v[b, j, h / g]
//
// over the keys j visible from the query's absolute position
// qp = q_offset + i: j < sk, j <= qp and, with window > 0,
// qp - j < window; g = Hq / Hkv and scale = D^-0.5.  A row with no
// visible key gives 0.  With a non-null lse (B, Hq, Sq) it also writes
// each row's log-sum-exp of its scaled logits (natural log; -inf for a
// row with no visible key), which the backward (flash_attention_bwd.cu)
// reads; the output is the same either way, bit for bit.
//
// Bound.  At the path's shape (1, 8192, 32, 64), causal, the products
// are 4 D FLOP per visible (query, key) pair, 2.75e11 FLOP: 0.28 ms at
// the card's 989e12 bf16 tensor-core FLOP/s.  The bytes (q, k, v read,
// out written) are 134 MB, 0.04 ms, so operations bind.
//
// Design.
// - One block of two consumer warpgroups (256 threads) per (query tile
//   of 128 rows, query head, batch); each warpgroup owns 64 rows.  Query
//   tiles are issued last tile first (blockIdx.x counts down), so the
//   tiles with the most visible keys start first and causal imbalance
//   does not leave SMs idle at the end.
// - The block walks key tiles of 64 only from the window's edge to the
//   causal edge of its last row (the TPU kernel's `visible` test); a
//   tile is masked element by element, branch-free, only where it
//   crosses an edge.
// - S = Q K^T: wgmma.m64n64k16 with Q in registers (A fragments read
//   once from shared memory, which halves the shared-memory traffic of
//   the product) and K from shared memory (K-major, 128-byte swizzle);
//   D is zero-padded in shared memory to a multiple of 64 (one to four
//   64-column panels: D up to 256, the largest head dim of the
//   repository's configs).  Q is loaded as it is (bf16, exact) and the
//   scale, times log2(e), is applied to the fp32 scores inside exp2's
//   argument: folding D^-0.5 into bf16 Q would round Q again for every D
//   that is not a power of 4.
// - O += P V: wgmma.m64n64k16 with P, rounded to bf16, taken from the
//   score accumulator's registers as the A operand (the accumulator's
//   fragment is the A fragment's layout), and V from shared memory as a
//   transposed (MN-major) B operand, one wgmma per 64 columns of D.
// - Softmax state stays in registers: each thread holds two rows of the
//   fragment; a row's max is reduced across the 4 threads sharing it
//   with xor shuffles, its sum only once at the end.  p = exp2(s c - m c)
//   with c = D^-0.5 log2(e), one FMA and one exp2 per score.
// - A tile's S = Q K^T and the previous tile's P V are issued together;
//   the softmax runs while P V is on the tensor cores (two P buffers in
//   registers), and O is rescaled once P V is done.
// - K and V tiles are copied with 16-byte cp.async into a ring of four
//   stages, two tiles ahead of the one multiplied, up to D = 128.  For
//   D <= 256 four stages would not fit in a block's shared memory, so
//   the ring has two (148 KB at D = 192, 198 KB at 256): step t loads
//   K of tile t + 1 and V of tile t, and waits for all of them at step
//   t + 1.  The O accumulator alone takes 128 registers a thread at
//   D = 256, so ptxas spills there (84 bytes at D = 192, 272 at 256).
//   cp.async, not TMA: the ragged edges (any Sk, any D <= 256 padded to
//   a multiple of 64 columns, rows past Sk) are zero-filled by
//   cp.async's source size, where TMA would need a tensor map encoded
//   per call (cuTensorMapEncodeTiled).
//   Where D % 8 != 0 or a pointer is not 16-byte aligned, the same ring
//   is filled by plain loads.  After the copies land, a proxy fence
//   makes them visible to wgmma; the next copies are issued after it,
//   since the fence waits for copies in flight.
// - Integer work is the part of the loop that is easy to lose: each
//   thread finds its chunks' offsets once, and a tile's wgmma
//   descriptors are a base plus a constant, so a tile costs a few
//   integer operations beyond the products and the softmax.
// - Offsets are 64-bit.
//
// The launcher is a plain C function (no PyTorch headers) that returns
// cudaGetLastError, so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWG = 2;         // consumer warpgroups, 64 rows each
constexpr int kBQ = 64 * kWG;  // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128 * kWG;

// K/V ring depth (a power of 2) for NP 64-column panels of D: four
// stages, two tiles ahead of the one multiplied, up to D = 128; two
// stages, one tile ahead, for D <= 256, where four would take more
// shared memory than a block may (1024 + NP (128 + 8 64) 128 bytes is
// 246 KB at NP = 3).
__host__ __device__ constexpr int ring_stages(int np) { return np <= 2 ? 4 : 2; }

// Ties P's registers to this point: their values are computed before it
// and the registers are not reused before it.
__device__ __forceinline__ void pin(uint32_t (&p)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    asm volatile("" : "+r"(p[i >> 2][i & 3])::"memory");
}

// d (64 x 64, fp32) (+)= A (64 x 16, registers) * B (16 x 64, smem):
// B is K-major for kTransB = 0, MN-major (the transposed operand) for 1.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(kTransB));
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; 0 at -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copies rows [r0, r0 + R) of a (rows, d) bf16 matrix with row stride ld
// into NP swizzled panels of R rows x 64 columns at dst (panel p holds
// columns 64 p .. 64 p + 63); rows >= nrows and columns >= d read as 0.
template <int R, int NP>
__device__ __forceinline__ void load_tile(uint8_t* dst, const bf16* src,
                                          int64_t ld, int r0, int nrows,
                                          int d, bool vec, int tid) {
  constexpr int kChunks = R * NP * 8;
#pragma unroll
  for (int idx = tid; idx < kChunks; idx += kThreads) {
    const int r = idx / (NP * 8), c = idx - r * (NP * 8);
    uint8_t* dp = dst + (c >> 3) * (R * 128) + swz(r, c & 7);
    const int row = r0 + r, col = c * 8;
    const bool in_row = row < nrows;
    if (vec) {
      const bool ok = in_row && col < d;
      const bf16* sp = ok ? src + static_cast<int64_t>(row) * ld + col : src;
      cp_async16(smem_u32(dp), sp, ok);
    } else {
      __align__(16) bf16 tmp[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        tmp[e] = (in_row && col + e < d)
                     ? src[static_cast<int64_t>(row) * ld + col + e]
                     : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(dp) = *reinterpret_cast<const uint4*>(tmp);
    }
  }
}

// NP: 64-column panels of the padded head dim (D <= 64 NP, up to 4).
template <int NP>
__global__ void __launch_bounds__(kThreads, NP == 1 && kWG == 2 ? 2 : 1)
fa_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ lse, int sq, int sk, int hq, int hkv, int d,
             int q_offset, int window, float scale_log2, int vec) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int kStages = ring_stages(NP);
  constexpr int kAhead = kStages == 4 ? 2 : 1;
  constexpr int kQPanel = kBQ * 128, kKVPanel = kBK * 128;
  constexpr int kKVStage = NP * kKVPanel;
  uint8_t* sQ = smem;                         // NP panels of kBQ rows
  uint8_t* sK = sQ + NP * kQPanel;            // kStages x NP panels
  uint8_t* sV = sK + kStages * kKVStage;      // kStages x NP panels

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, quad = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // last tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int64_t q_row = static_cast<int64_t>(hq) * d;
  const int64_t k_row = static_cast<int64_t>(hkv) * d;
  const bf16* qb = q + static_cast<int64_t>(b) * sq * q_row +
                   static_cast<int64_t>(h) * d;
  const bf16* kb = k + static_cast<int64_t>(b) * sk * k_row +
                   static_cast<int64_t>(hk) * d;
  const bf16* vb = v + static_cast<int64_t>(b) * sk * k_row +
                   static_cast<int64_t>(hk) * d;
  bf16* ob = o + static_cast<int64_t>(b) * sq * q_row +
             static_cast<int64_t>(h) * d;

  // Visible keys of this block: [k_begin, k_end).
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, sq) - 1;
  const int k_end = min(sk, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  // This thread's 16-byte chunks of a K or V tile, found once: offsets
  // in a stage and from the tile's first key row (32-bit: the wrapper
  // holds 64 Hkv D below 2^31), and the first tile start j0 at which the
  // chunk's key row passes Sk (below every j0 if its columns pass D).
  constexpr int kMine = kBK * NP * 8 / kThreads;
  uint32_t my_smem[kMine];
  int my_gmem[kMine], my_lim[kMine];
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    const int idx = tid + i * kThreads, r = idx / (NP * 8), c = idx % (NP * 8);
    my_smem[i] = (c >> 3) * kKVPanel + swz(r, c & 7);
    my_gmem[i] = r * static_cast<int>(k_row) + c * 8;
    my_lim[i] = c * 8 < d ? sk - r : INT_MIN;
  }
  const uint32_t sK_u = smem_u32(sK), sV_u = smem_u32(sV);
  // Tile t's K (with_k) and V (with_v) into stage t of the ring.
  auto load_kv = [&](int t, bool with_k, bool with_v) {
    const int j0 = k_begin + t * kBK;
    const uint32_t st = (t & (kStages - 1)) * kKVStage;
    if (vec) {
      const int64_t off = j0 * k_row;
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        const bool ok = j0 < my_lim[i];
        if (with_k)
          cp_async16(sK_u + st + my_smem[i], ok ? kb + off + my_gmem[i] : kb,
                     ok);
        if (with_v)
          cp_async16(sV_u + st + my_smem[i], ok ? vb + off + my_gmem[i] : vb,
                     ok);
      }
    } else {
      if (with_k) load_tile<kBK, NP>(sK + st, kb, k_row, j0, sk, d, false, tid);
      if (with_v) load_tile<kBK, NP>(sV + st, vb, k_row, j0, sk, d, false, tid);
    }
  };
  // Descriptors of stage 0, panel 0; a tile's add the byte offset / 16.
  const uint64_t k_desc = desc(sK_u, 16, 1024);
  const uint64_t v_desc = desc(sV_u, kKVPanel, 1024);
  load_tile<kBQ, NP>(sQ, qb, q_row, q0, sq, d, vec, tid);
  // Four stages: tiles 0 and 1, K and V.  Two stages: K of tile 0; a
  // tile's V then loads one step after its K (step t loads K of t + 1
  // and V of t), since P V of tile t - 1 reads the other V stage while
  // step t runs.
  for (int t = 0; t < kAhead; ++t) {
    if (t < n_tiles) load_kv(t, true, kStages == 4);
    cp_async_commit();
  }

  // This thread's rows of the warpgroup's 64: r_lo and r_lo + 8.
  const int row_lo = q0 + wg * 64 + warp * 16 + (lane >> 2);
  const int qp_lo = q_offset + row_lo;
  const int wg_first = q_offset + q0 + wg * 64;   // first row's position
  float oacc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[p][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  // This thread's Q as wgmma A fragments (rows r_lo, r_lo + 8; per 16
  // columns kk, columns 2 quad + {0, 1} and 8 more), read once from the
  // swizzled tile.
  uint32_t qa[NP][4][4];
  if (n_tiles > 0) {
    cp_async_wait<kAhead - 1>();   // Q (with tile 0) has landed
    __syncthreads();
    const int r0 = wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + 8 * (e & 1), c = 2 * kk + (e >> 1);
          qa[p][kk][e] = *reinterpret_cast<const uint32_t*>(
              sQ + p * kQPanel + swz(r, c) + 4 * quad);
        }
  }

  // Tile t.  S = Q K_t^T and, from the registers of the previous tile's
  // P, O += P V_{t-1} are issued together; the softmax of tile t runs
  // while P V is on the tensor cores, and O is rescaled once P V is done.
  auto step = [&](uint32_t (&p_prev)[4][4], uint32_t (&p_cur)[4][4], int t) {
    cp_async_wait<kAhead - 1>();   // tile t has landed
    fence_proxy_async();           // before the new copies: it waits for them
    __syncthreads();               // and every thread is done with step t - 1
    if (kStages == 4) {
      if (t + kAhead < n_tiles) load_kv(t + kAhead, true, true);  // over t - 2
    } else {
      if (t + 1 < n_tiles) load_kv(t + 1, true, false);   // over K of t - 1
      load_kv(t, false, true);                            // over V of t - 2
    }
    cp_async_commit();
    const uint32_t st = (t & (kStages - 1)) * kKVStage;
    fence_regs(s);
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(oacc[p]);
    wg_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<0>(s, qa[p][kk],
                    k_desc + ((st + p * kKVPanel + kk * 32) >> 4),
                    (p | kk) != 0);
    wg_commit();
    if (t > 0) {
      const uint32_t sv = ((t - 1) & (kStages - 1)) * kKVStage;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          wgmma_rs<1>(oacc[p], p_prev[kk],
                      v_desc + ((sv + p * kKVPanel + kk * 16 * 128) >> 4), 1);
      wg_commit();
      wg_wait<1>();   // S is done; P V may still run
    } else {
      wg_wait<0>();
    }
    fence_regs(s);

    const int j0 = k_begin + t * kBK;
    // Every key of the tile is visible from every row of the warpgroup
    // unless the tile crosses Sk, the causal edge or the window's edge.
    const bool full = j0 + kBK <= sk && j0 + kBK - 1 <= wg_first &&
                      (window <= 0 || wg_first + 63 - j0 < window);
    if (!full) {   // branch-free: a branch per score costs more than the mask
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + 8 * i + 2 * quad + (e & 1);
          const int qp = qp_lo + 8 * (e >> 1);
          const bool ok = (key < sk) & (key <= qp) &
                          ((window <= 0) | (qp - key < window));
          s[4 * i + e] = ok ? s[4 * i + e] : -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * i + e]);
    // Scores stay unscaled; exp2 takes (s - m) scale log2(e) as one FMA.
    float corr[2], neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = ex2((m[r] - m_safe) * scale_log2);   // 0 while m is -inf
      m[r] = m_new;
      neg_m[r] = -m_safe * scale_log2;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = ex2(fmaf(s[4 * i + e], scale_log2, neg_m[e >> 1]));
        s[4 * i + e] = pv;
        l[e >> 1] += pv;
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      p_cur[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      p_cur[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p_cur[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p_cur[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    // Pin P and l here: without it the compiler sinks the exp2s past the
    // wait below, and the softmax no longer overlaps P V.
    pin(p_cur);
    asm volatile("" : "+f"(l[0]), "+f"(l[1])::"memory");
    wg_wait<0>();   // P V of tile t - 1 is done
    // Keep P of tile t - 1 live to here: P V reads it until the wait, and
    // a register reused before then would stall the softmax behind P V.
    pin(p_prev);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      fence_regs(oacc[p]);
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[p][i] *= corr[(i >> 1) & 1];
    }
  };

  // P V of the last tile.
  auto last_pv = [&](uint32_t (&p_last)[4][4]) {
    if (kStages == 2) {   // V of the last tile was loaded in its own step
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
    }
    const uint32_t sv = ((n_tiles - 1) & (kStages - 1)) * kKVStage;
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(oacc[p]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        wgmma_rs<1>(oacc[p], p_last[kk],
                    v_desc + ((sv + p * kKVPanel + kk * 16 * 128) >> 4), 1);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(oacc[p]);
  };
  uint32_t pa[4][4], pb[4][4];
  for (int t = 0; t < n_tiles; t += 2) {
    step(pb, pa, t);
    if (t + 1 == n_tiles) {
      last_pv(pa);
      break;
    }
    step(pa, pb, t + 1);
    if (t + 2 == n_tiles) last_pv(pb);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    // LSE = ln sum exp(s scale) = (m c + log2 l) ln 2, c = scale log2(e).
    const int qi = row_lo + 8 * r;
    if (lse != nullptr && quad == 0 && qi < sq)
      lse[(static_cast<int64_t>(b) * hq + h) * sq + qi] =
          l[r] > 0.f ? (m[r] * scale_log2 + log2f(l[r])) * 0.69314718f
                     : -INFINITY;
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_lo + 8 * r;
    if (qi >= sq) continue;
    bf16* orow = ob + static_cast<int64_t>(qi) * q_row;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 64 * p + 8 * i + 2 * quad + e;
          if (col < d)
            orow[col] = __float2bfloat16(oacc[p][4 * i + 2 * r + e] * l[r]);
        }
  }
}

template <int NP>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int sq, int sk, int hq, int hkv, int d, int q_offset,
           int window, float scale_log2, int vec, cudaStream_t stream) {
  const int bytes = 1024 + NP * (kBQ + 2 * ring_stages(NP) * kBK) * 128;
  cudaError_t err = cudaFuncSetAttribute(
      fa_tc_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  fa_tc_kernel<NP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), sq, sk, hq, hkv, d, q_offset, window,
      scale_log2, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); o: (B, Sq, Hq, D), all
// contiguous bfloat16; lse: (B, Hq, Sq) float32, or null to write none;
// 1 <= D <= 256, Hq % Hkv == 0, window <= 0 means none;
// scale_log2 = D^-0.5 log2(e); vec != 0 when D % 8 == 0 and every
// pointer is 16-byte aligned (the cp.async route).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o,
                                         void* lse, int b, int sq, int sk,
                                         int hq, int hkv, int d,
                                         int q_offset, int window,
                                         float scale_log2, int vec,
                                         void* stream) {
  if (b <= 0 || sq <= 0 || hq <= 0) return 0;
  if (d <= 0 || d > 256 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 63) / 64) {
    case 1:
      return launch<1>(q, k, v, o, lse, b, sq, sk, hq, hkv, d,
                       q_offset, window, scale_log2, vec, s);
    case 2:
      return launch<2>(q, k, v, o, lse, b, sq, sk, hq, hkv, d,
                       q_offset, window, scale_log2, vec, s);
    case 3:
      return launch<3>(q, k, v, o, lse, b, sq, sk, hq, hkv, d,
                       q_offset, window, scale_log2, vec, s);
    default:
      return launch<4>(q, k, v, o, lse, b, sq, sk, hq, hkv, d,
                       q_offset, window, scale_log2, vec, s);
  }
}
