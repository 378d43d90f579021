// Forward flash attention on fp32 inputs, its products on Hopper's TF32
// tensor cores in a 3xTF32 split (past D = 64, P V only): GQA, causal
// from q_offset, optional sliding window, fp32 online softmax.
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _fa_kernel) for fp32 inputs; bf16 inputs take the tensor-core
// kernel, flash_attention_tc.cu.  It computes what _fa_kernel and the
// plain version (ref.py::flash_attention_ref) compute:
//
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / g])
//                  * v[b, j, h / g]
//
// over the keys j visible from the query's absolute position
// qp = q_offset + i: j < sk, j <= qp and, with window > 0,
// qp - j < window; g = Hq / Hkv and scale = D^-0.5.  A row with no
// visible key gives 0, as the plain version's guards give.  With a
// non-null lse (B, Hq, Sq) it also writes each row's log-sum-exp of its
// scaled logits (-inf for a row with no visible key), which the backward
// (flash_attention_bwd.cu) reads; the output is the same either way, bit
// for bit.
//
// Products.  A TF32 value keeps 10 explicit mantissa bits, so the product
// of two is exact in fp32.  Each fp32 operand x is split as hi = tf32(x),
// lo = tf32(x - hi) (cvt.rna), and each product as hi hi + (hi lo + lo hi):
// kPasses = 3 TF32 products per fp32 product, dropping lo lo; hi + lo
// holds x to 2^-23.  hi hi and the small terms go to separate fp32
// accumulators, added last.  One TF32 product, or two, misses the 2e-6
// tolerance by over 100x (tests/test_torch_flash_attention.py emulates
// each).  Tensor-core sums round toward zero, not to nearest, so P V is
// accumulated afresh for each key tile and added to the running output in
// fp32 (out = out corr + tile): the truncation acts on one tile's sum,
// never on a row's.
//
// Bound.  At the path's shape (1, 8192, 32, 64), causal, the products
// are 4 D FLOP per visible (query, key) pair, 2.75e11 FLOP, three times
// over: 1.67 ms at the card's 494e12 dense TF32 FLOP/s (4.1 ms at the
// 67e12 fp32 rate of the CUDA cores).  The bytes (q, k, v read, out
// written) are 268 MB, 0.08 ms, so operations bind.
//
// Two designs, by head dim:
//
// D <= 64 (the path's heads): fa_wgmma_kernel, both products on wgmma.
// - One block of two warpgroups (256 threads, 64 query rows each) per
//   (query tile of 128 rows, head, batch).  Q is scaled (in fp32, as the
//   plain version scales it) and split once into hi and lo tiles.  Per
//   key tile of 64, K and V land raw through a two-stage cp.async ring
//   (16-byte copies; plain loads when D % 4 != 0 or an address is
//   misaligned); one pass of the block splits them, K as is and V
//   transposed.  wgmma's TF32 form takes both operands K-major from
//   shared memory, so every split tile is stored K-major under the
//   128-byte swizzle (Q, K: rows of D; V^T: rows of keys).
// - S = Q K^T: three wgmma.m64n64k8 a step from shared memory.  P V: P
//   from the score accumulator's registers as the A operand.  The
//   accumulator holds keys 2t and 2t + 1 of each 8-key block in lane t of
//   a quad, where the A fragment wants keys t and t + 4; since the sum
//   runs over keys in any order, MMA slot t takes key 2t and slot t + 4
//   key 2t + 1, and the split pass writes V^T's keys in that order.  No
//   shuffle.  197 KB of shared memory, 246 registers, no spills.
//
// 64 < D <= 256: fa_kernel<NP>, P V on mma.sync.m16n8k8 .tf32 with
// operands gathered from shared memory by each lane (NP = 2-4 64-column
// panels; the wgmma form's accumulators for 128-256 columns do not fit
// beside S and P).  Its scores are fp32 FMA chains over D, in the order in
// which the plain version's product sums: at D = 256 the plain fp32
// version is itself about 1e-6 from a float64 result and a 3xTF32 S
// about as far, so the two part by more than the 2e-6 tolerance on some
// inputs, while S summed in the same order keeps them within it
// (tests/test_torch_flash_attention.py::test_wide_heads_sum_s_in_the_plain_order
// emulates both; on the card a 3xTF32 S missed at (1, 200, 260, 4, 1, 256)).
// D = 65-128 takes the same route by choice, so that one kernel serves
// every D > 64: no miss of a 3xTF32 S was measured there.
// 8 warps (128 query rows) and 64-key tiles for D <= 128, 4 and 32
// beyond; a two-stage cp.async ring.
//
// Both: query tiles are issued heaviest first across all heads (grid z
// counts them from the last); a block walks key tiles only from the
// window's edge to the causal edge of its last row; a warp (a warpgroup
// under wgmma) skips a tile that none of its rows sees and masks only a
// tile that crosses an edge; one barrier a tile where the next copies are
// issued (two in the wgmma design, around the split pass), none between
// S and P V.  The
// softmax is the plain version's: fp32 online, expf (not exp2), the same
// guards and a final division by the row sum.  Offsets are 64-bit.
//
// The launcher is a plain C function (no PyTorch headers) that returns
// cudaGetLastError, so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/tf32_mma.cuh"

namespace {

// The mma.sync kernel's configuration, for NP = 2-4 64-column panels of
// the padded head dim (64 < D <= 256).
template <int NP>
struct Cfg {
  static_assert(NP >= 2 && NP <= 4, "D <= 64 takes fa_wgmma_kernel");
  static constexpr int kWarps = NP == 2 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;          // query rows a block
  static constexpr int kBK = NP == 2 ? 64 : 32;    // keys a tile
  static constexpr int kStages = 2;                // K/V ring depth
  static constexpr int kLd = 64 * NP + 4;          // row pitch, floats
  // 8-column tiles of D per pass of P V (registers: the output takes
  // 4 NP x 8 a thread, each pass 8 x this).
  static constexpr int kPanel = NP == 2 ? 4 : 2;
  static constexpr int kSmemBytes = (kBQ + 2 * kStages * kBK) * kLd * 4;
};

// Rows [r0, r0 + R) of a (rows, d) fp32 matrix with row stride ld into
// dst [R][kLd]; rows >= nrows and columns >= d read as 0.  vec: 16-byte
// cp.async (d % 4 == 0, 16-byte aligned rows), else plain loads.
template <int R, int NP, int kThreads>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t ld, int r0, int nrows,
                                          int d, bool vec, int tid) {
  constexpr int kLd = Cfg<NP>::kLd;
  if (vec) {
    constexpr int kChunks = R * NP * 16;
#pragma unroll 4
    for (int idx = tid; idx < kChunks; idx += kThreads) {
      const int r = idx / (NP * 16), c = (idx - r * (NP * 16)) * 4;
      const int row = r0 + r;
      const bool ok = row < nrows && c < d;
      cp_async16(smem_u32(dst + r * kLd + c),
                 ok ? src + static_cast<int64_t>(row) * ld + c : src, ok);
    }
  } else {
    constexpr int kElems = R * NP * 64;
#pragma unroll 4
    for (int idx = tid; idx < kElems; idx += kThreads) {
      const int r = idx / (NP * 64), c = idx - r * (NP * 64);
      const int row = r0 + r;
      dst[r * kLd + c] = (row < nrows && c < d)
                             ? src[static_cast<int64_t>(row) * ld + c]
                             : 0.f;
    }
  }
}

template <int NP>
__global__ void __launch_bounds__(Cfg<NP>::kThreads, 1)
fa_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, int sq, int sk, int hq, int hkv, int d,
          int q_offset, int window, float scale, int vec) {
  using C = Cfg<NP>;
  constexpr int kBK = C::kBK, kLd = C::kLd, kStages = C::kStages;
  constexpr int kThreads = C::kThreads, kBQ = C::kBQ;
  constexpr int kKT = kBK / 8;   // 8-key blocks a tile
  constexpr int kNT = NP * 8;    // 8-column tiles of the padded D
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // [kBQ][kLd]
  float* sKV = sQ + kBQ * kLd;                   // kStages x (K, V) tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // heaviest first
  const int hk = h / (hq / hkv);
  const int64_t q_row = static_cast<int64_t>(hq) * d;    // q/o row stride
  const int64_t k_row = static_cast<int64_t>(hkv) * d;   // k/v row stride
  const float* qb = q + static_cast<int64_t>(b) * sq * q_row +
                    static_cast<int64_t>(h) * d;
  const float* kb = k + static_cast<int64_t>(b) * sk * k_row +
                    static_cast<int64_t>(hk) * d;
  const float* vb = v + static_cast<int64_t>(b) * sk * k_row +
                    static_cast<int64_t>(hk) * d;
  float* ob = o + static_cast<int64_t>(b) * sq * q_row +
              static_cast<int64_t>(h) * d;

  // Visible keys of this block: [k_begin, k_end).
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, sq) - 1;
  const int k_end = min(sk, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  auto load_kv = [&](int t) {   // tile t into stage t % kStages
    float* st = sKV + (t % kStages) * 2 * kBK * kLd;
    const int j0 = k_begin + t * kBK;
    load_rows<kBK, NP, kThreads>(st, kb, k_row, j0, sk, d, vec, tid);
    load_rows<kBK, NP, kThreads>(st + kBK * kLd, vb, k_row, j0, sk, d, vec,
                                 tid);
  };
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }
  // Q, scaled in fp32 as the plain version scales it (the first barrier
  // of the loop makes it visible).
  for (int idx = tid; idx < kBQ * NP * 64; idx += kThreads) {
    const int r = idx / (NP * 64), c = idx - r * (NP * 64), qi = q0 + r;
    sQ[r * kLd + c] =
        qi < sq && c < d ? qb[static_cast<int64_t>(qi) * q_row + c] * scale
                         : 0.f;
  }

  const int row_lo = q0 + warp * 16 + g;   // this thread's rows: +0, +8
  const int qp_lo = q_offset + row_lo;
  const int w_first = q_offset + q0 + warp * 16;   // the warp's positions
  const int w_last = w_first + 15;
  const float* qa = sQ + (warp * 16 + g) * kLd;   // rows g and g + 8

  float oacc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[nt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();   // tile t has landed
    __syncthreads();                // and every warp is done with t - 1
    if (t + kStages - 1 < n_tiles) load_kv(t + kStages - 1);   // over t - 1
    cp_async_commit();
    const int j0 = k_begin + t * kBK;
    if (j0 > w_last || (window > 0 && w_first - (j0 + kBK - 1) >= window))
      continue;   // no row of this warp sees a key of the tile
    const float* tK = sKV + (t % kStages) * 2 * kBK * kLd;
    const float* tV = tK + kBK * kLd;

    // S = (q scale) K^T on the CUDA cores: each score one fp32 FMA chain
    // over D in order, the order in which the plain version's product
    // sums (split TF32 products miss the 2e-6 tolerance at D = 256, where
    // two fp32 orders of S differ by as much).  This thread's scores:
    // rows g, g + 8 by keys 8 nt + 2 tq + {0, 1}, the layout P V takes.
    float s[kKT][4];
#pragma unroll
    for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    const float* kr = tK + 2 * tq * kLd;
#pragma unroll 2
    for (int c = 0; c < NP * 64; c += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(qa + c);
      const float4 a1 = *reinterpret_cast<const float4*>(qa + 8 * kLd + c);
#pragma unroll
      for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 kv =
              *reinterpret_cast<const float4*>(kr + (8 * nt + e) * kLd + c);
          float& lo = s[nt][e];
          float& hi = s[nt][2 + e];
          lo = fmaf(a0.x, kv.x, lo);
          hi = fmaf(a1.x, kv.x, hi);
          lo = fmaf(a0.y, kv.y, lo);
          hi = fmaf(a1.y, kv.y, hi);
          lo = fmaf(a0.z, kv.z, lo);
          hi = fmaf(a1.z, kv.z, hi);
          lo = fmaf(a0.w, kv.w, lo);
          hi = fmaf(a1.w, kv.w, hi);
        }
    }

    // Every key of the tile is visible from every row of the warp unless
    // the tile crosses Sk, the causal edge or the window's edge.
    const bool full = j0 + kBK <= sk && j0 + kBK - 1 <= w_first &&
                      (window <= 0 || w_last - j0 < window);
    if (!full) {
#pragma unroll
      for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + 8 * nt + 2 * tq + (e & 1);
          const int qp = qp_lo + 8 * (e >> 1);
          const bool ok = (key < sk) & (key <= qp) &
                          ((window <= 0) | (qp - key < window));
          s[nt][e] = ok ? s[nt][e] : -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    float corr[2], m_safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_safe[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = expf(m[r] - m_safe[r]);   // 0 while m is -inf
      m[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m_safe[e >> 1]);   // 0 where masked
        psum[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];

    // P as A fragments over keys: slot t is key 2t, slot t + 4 key 2t + 1.
    uint32_t ph[kKT][4], pl[kKT][4];
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      split(s[kk][0], ph[kk][0], pl[kk][0]);
      split(s[kk][2], ph[kk][1], pl[kk][1]);
      split(s[kk][1], ph[kk][2], pl[kk][2]);
      split(s[kk][3], ph[kk][3], pl[kk][3]);
    }
    // out = out corr + P V, kPanel 8-column tiles of D at a time.
#pragma unroll
    for (int p0 = 0; p0 < kNT; p0 += C::kPanel) {
      float vbg[C::kPanel][4], vsm[C::kPanel][4];
#pragma unroll
      for (int j = 0; j < C::kPanel; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) vbg[j][e] = vsm[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        const float* vp = tV + (8 * kk + 2 * tq) * kLd + g;
#pragma unroll
        for (int j = 0; j < C::kPanel; ++j) {
          uint32_t bh0, bl0, bh1, bl1;
          split(vp[8 * (p0 + j)], bh0, bl0);
          split(vp[8 * (p0 + j) + kLd], bh1, bl1);
          mma3(vbg[j], vsm[j], ph[kk], pl[kk], bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int j = 0; j < C::kPanel; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          oacc[p0 + j][e] =
              oacc[p0 + j][e] * corr[e >> 1] + (vbg[j][e] + vsm[j][e]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = row_lo + 8 * r;
    if (lse != nullptr && tq == 0 && qi < sq)
      lse[(static_cast<int64_t>(b) * hq + h) * sq + qi] =
          l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_lo + 8 * r;
    if (qi >= sq) continue;
    float* orow = ob + static_cast<int64_t>(qi) * q_row;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * nt + 2 * tq + e;
        if (col < d) orow[col] = oacc[nt][2 * r + e] / l[r];
      }
  }
}

// D <= 64 (the path's heads): wgmma, both operands' splits staged in
// shared memory once.

namespace wg {
constexpr int kWG = 2;                 // warpgroups, 64 query rows each
constexpr int kThreads = 128 * kWG;
constexpr int kBQ = 64 * kWG;          // query rows a block
constexpr int kBK = 64;                // keys a tile
constexpr int kPanel = kBK * 128;      // 64 rows x 32 TF32 values, swizzled
// Shared memory, in bytes from a 1024-byte aligned base: Q hi and lo
// (two 32-column panels of 128 rows each), K hi and lo, V^T hi and lo
// (two panels of 64 rows each), then the ring of raw K and V tiles.
constexpr int kQ = 0;
constexpr int kQPanel = kBQ * 128;
constexpr int kK = kQ + 4 * kQPanel;
constexpr int kVt = kK + 4 * kPanel;
constexpr int kRaw = kVt + 4 * kPanel;
constexpr int kRawTile = kBK * 64 * 4;       // 64 keys x 64 floats
constexpr int kStages = 2;
constexpr int kSmemBytes = 1024 + kRaw + kStages * 2 * kRawTile;
}  // namespace wg

__global__ void __launch_bounds__(wg::kThreads, 1)
fa_wgmma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                float* __restrict__ lse, int sq, int sk, int hq, int hkv,
                int d, int q_offset, int window, float scale, int vec) {
  using namespace wg;
  static_assert(kPasses == 3, "three wgmma a step: hi lo, lo hi, hi hi");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* raw = reinterpret_cast<float*>(smem + kRaw);   // [stage][K|V][64][64]
  const uint32_t base = smem_u32(smem);

  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // heaviest first
  const int hk = h / (hq / hkv);
  const int64_t q_row = static_cast<int64_t>(hq) * d;
  const int64_t k_row = static_cast<int64_t>(hkv) * d;
  const float* qb = q + static_cast<int64_t>(b) * sq * q_row +
                    static_cast<int64_t>(h) * d;
  const float* kb = k + static_cast<int64_t>(b) * sk * k_row +
                    static_cast<int64_t>(hk) * d;
  const float* vb = v + static_cast<int64_t>(b) * sk * k_row +
                    static_cast<int64_t>(hk) * d;
  float* ob = o + static_cast<int64_t>(b) * sq * q_row +
              static_cast<int64_t>(h) * d;

  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, sq) - 1;
  const int k_end = min(sk, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  // Raw K and V of tile t into ring stage t % kStages, [key][64 floats].
  auto load_kv = [&](int t) {
    float* st = raw + (t % kStages) * 2 * kBK * 64;
    const int j0 = k_begin + t * kBK;
    if (vec) {
#pragma unroll
      for (int i = 0; i < kBK * 16 / kThreads; ++i) {
        const int idx = tid + i * kThreads, r = idx >> 4, c = (idx & 15) * 4;
        const bool ok = j0 + r < sk && c < d;
        const int64_t off = static_cast<int64_t>(j0 + r) * k_row + c;
        cp_async16(smem_u32(st + r * 64 + c), ok ? kb + off : kb, ok);
        cp_async16(smem_u32(st + kBK * 64 + r * 64 + c), ok ? vb + off : vb,
                   ok);
      }
    } else {
      for (int idx = tid; idx < kBK * 64; idx += kThreads) {
        const int r = idx >> 6, c = idx & 63;
        const bool ok = j0 + r < sk && c < d;
        const int64_t off = static_cast<int64_t>(j0 + r) * k_row + c;
        st[idx] = ok ? kb[off] : 0.f;
        st[kBK * 64 + idx] = ok ? vb[off] : 0.f;
      }
    }
  };
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  // Q, scaled in fp32 as the plain version scales it, split once into
  // swizzled K-major hi and lo panels (all loads before the stores).
  {
    constexpr int kPer = kBQ * 16 / kThreads;
    float4 qv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 4, c = 4 * (idx & 15);
      const int qi = q0 + r;
      const float* src = qb + static_cast<int64_t>(qi) * q_row + c;
      qv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (qi < sq) {
        if (vec) {
          if (c < d) qv[i] = *reinterpret_cast<const float4*>(src);
        } else {
          qv[i].x = c < d ? src[0] : 0.f;
          qv[i].y = c + 1 < d ? src[1] : 0.f;
          qv[i].z = c + 2 < d ? src[2] : 0.f;
          qv[i].w = c + 3 < d ? src[3] : 0.f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 4, c16 = idx & 15;
      store_split(smem, kQ + (c16 >> 3) * kQPanel + swz(r, c16 & 7),
                  2 * kQPanel,
                  make_float4(qv[i].x * scale, qv[i].y * scale,
                              qv[i].z * scale, qv[i].w * scale));
    }
  }

  const int row_lo = q0 + wgi * 64 + warp * 16 + g;   // rows +0, +8
  const int qp_lo = q_offset + row_lo;
  const int wg_first = q_offset + q0 + wgi * 64;   // the warpgroup's
  const int w_first = wg_first + warp * 16;        // and the warp's
  const uint32_t qh = base + kQ + wgi * 64 * 128, ql = qh + 2 * kQPanel;
  const uint32_t kh = base + kK, kl = kh + 2 * kPanel;
  const uint32_t vh = base + kVt, vl = vh + 2 * kPanel;

  // The output, and the wgmma accumulators (each product's first step
  // overwrites its accumulator).
  float oacc[32], sb[32], ss[32], vbg[32], vsm[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = sb[i] = ss[i] = vbg[i] = vsm[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();   // raw tile t has landed
    __syncthreads();      // every warp is done with tile t - 1
    if (t + 1 < n_tiles) load_kv(t + 1);
    cp_async_commit();
    // Split tile t: K as K-major hi and lo panels (row = key), V as V^T
    // (row = column of D) with its keys in MMA slot order: slot s of each
    // 8 keys holds key 2s for s < 4 and 2 (s - 4) + 1 after.
    const float* rk = raw + (t % kStages) * 2 * kBK * 64;
    const float* rv = rk + kBK * 64;
#pragma unroll
    for (int i = 0; i < kBK * 16 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx >> 4, c16 = idx & 15;
      store_split(smem, kK + (c16 >> 3) * kPanel + swz(r, c16 & 7),
                  2 * kPanel,
                  *reinterpret_cast<const float4*>(rk + r * 64 + 4 * c16));
    }
#pragma unroll
    for (int i = 0; i < 64 * 16 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int dd = idx & 63, cg = idx >> 6;   // column of D, slot group
      const int k0 = 8 * (cg >> 1) + (cg & 1);  // keys k0, k0 + 2, + 4, + 6
      float4 x;
      x.x = rv[k0 * 64 + dd];
      x.y = rv[(k0 + 2) * 64 + dd];
      x.z = rv[(k0 + 4) * 64 + dd];
      x.w = rv[(k0 + 6) * 64 + dd];
      store_split(smem, kVt + (cg >> 3) * kPanel + swz(dd, cg & 7),
                  2 * kPanel, x);
    }
    fence_proxy_async();   // the stores above, visible to wgmma
    __syncthreads();

    const int j0 = k_begin + t * kBK;
    if (j0 > wg_first + 63 ||
        (window > 0 && wg_first - (j0 + kBK - 1) >= window))
      continue;   // no row of this warpgroup sees a key of the tile

    // S = (q scale) K^T: small terms and hi hi in separate accumulators.
    fence_regs(sb);
    fence_regs(ss);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t qo = (kk >> 2) * kQPanel + (kk & 3) * 32;
      const uint32_t ko = (kk >> 2) * kPanel + (kk & 3) * 32;
      wgmma_ss(ss, desc(qh + qo), desc(kl + ko), kk > 0);
      wgmma_ss(ss, desc(ql + qo), desc(kh + ko), 1);
      wgmma_ss(sb, desc(qh + qo), desc(kh + ko), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(sb);
    fence_regs(ss);
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = sb[i] + ss[i];

    const bool full = j0 + kBK <= sk && j0 + kBK - 1 <= w_first &&
                      (window <= 0 || w_first + 15 - j0 < window);
    if (!full) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + 8 * i + 2 * tq + (e & 1);
          const int qp = qp_lo + 8 * (e >> 1);
          const bool ok = (key < sk) & (key <= qp) &
                          ((window <= 0) | (qp - key < window));
          s[4 * i + e] = ok ? s[4 * i + e] : -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float corr[2], m_safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_safe[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = expf(m[r] - m_safe[r]);   // 0 while m is -inf
      m[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = expf(s[i] - m_safe[(i >> 1) & 1]);   // 0 where masked
      psum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];

    // P as A fragments over keys: slot t is key 2t, slot t + 4 key 2t + 1.
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      split(s[4 * kk + 0], ph[kk][0], pl[kk][0]);
      split(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
      split(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
      split(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
    }
    fence_regs(vbg);
    fence_regs(vsm);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t vo = (kk >> 2) * kPanel + (kk & 3) * 32;
      wgmma_rs(vsm, ph[kk], desc(vl + vo), kk > 0);
      wgmma_rs(vsm, pl[kk], desc(vh + vo), 1);
      wgmma_rs(vbg, ph[kk], desc(vh + vo), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    pin(ph);
    pin(pl);
    fence_regs(vbg);
    fence_regs(vsm);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      oacc[i] = oacc[i] * corr[(i >> 1) & 1] + (vbg[i] + vsm[i]);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = row_lo + 8 * r;
    if (lse != nullptr && tq == 0 && qi < sq)
      lse[(static_cast<int64_t>(b) * hq + h) * sq + qi] =
          l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_lo + 8 * r;
    if (qi >= sq) continue;
    float* orow = ob + static_cast<int64_t>(qi) * q_row;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * tq + e;
        if (col < d) orow[col] = oacc[4 * i + 2 * r + e] / l[r];
      }
  }
}

int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* lse, int b, int sq, int sk, int hq, int hkv, int d,
                 int q_offset, int window, float scale, int vec,
                 cudaStream_t stream) {
  const int n_qt = (sq + wg::kBQ - 1) / wg::kBQ;
  if (b > 65535 || n_qt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fa_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wg::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_wgmma_kernel<<<dim3(hq, b, n_qt), wg::kThreads, wg::kSmemBytes,
                    stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), sq, sk, hq, hkv, d, q_offset, window, scale,
      vec);
  return static_cast<int>(cudaGetLastError());
}

template <int NP>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int sq, int sk, int hq, int hkv, int d, int q_offset,
           int window, float scale, int vec, cudaStream_t stream) {
  using C = Cfg<NP>;
  const int n_qt = (sq + C::kBQ - 1) / C::kBQ;
  if (b > 65535 || n_qt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_kernel<NP><<<dim3(hq, b, n_qt), C::kThreads, C::kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), sq, sk, hq, hkv, d, q_offset, window, scale,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); o: (B, Sq, Hq, D), all
// contiguous float32; lse: (B, Hq, Sq) float32, or null to write none;
// 1 <= D <= 256, Hq % Hkv == 0, window <= 0 means none; scale = D^-0.5;
// vec != 0 when D % 4 == 0 and every pointer is 16-byte aligned (the
// cp.async route).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int b, int sq, int sk, int hq,
                                      int hkv, int d, int q_offset,
                                      int window, float scale, int vec,
                                      void* stream) {
  if (b <= 0 || sq <= 0 || hq <= 0) return 0;
  if (d <= 0 || d > 256 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 63) / 64) {   // 64-column panels of D
    case 1:
      return launch_wgmma(q, k, v, o, lse, b, sq, sk, hq, hkv, d, q_offset,
                          window, scale, vec, s);
    case 2:
      return launch<2>(q, k, v, o, lse, b, sq, sk, hq, hkv, d,
                       q_offset, window, scale, vec, s);
    case 3:
      return launch<3>(q, k, v, o, lse, b, sq, sk, hq, hkv, d,
                       q_offset, window, scale, vec, s);
    default:
      return launch<4>(q, k, v, o, lse, b, sq, sk, hq, hkv, d,
                       q_offset, window, scale, vec, s);
  }
}
