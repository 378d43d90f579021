// The backward of the Mamba2 SSD chunked scan (one group): the gradients
// of y and the final state with respect to x, dt, a_log, B and C, on the
// CUDA cores in fp32, for fp32 inputs.  bf16 inputs take ssd_bwd_tc.cu,
// the tensor-core design; this file's bf16 instantiation, which only
// they reached, is gone.
//
// The JAX package has no backward kernel: jax.grad differentiates the
// plain ref.ssd_chunked (repro/kernels/ssd/ref.py), and ssd_pallas
// (repro/kernels/ssd/kernel.py:80) has no custom_vjp.  This kernel is the
// port's own, added so that training on the card differentiates the SSD
// scan without the plain version; ref.py::ssd_chunked_bwd (autograd
// through ssd_chunked) is what it is held to.
//
// Per batch b, head h (A = -exp(a_log[h])) and chunk z of L steps, with
// cum the inclusive in-order cumsum of dt A over the chunk, total =
// cum[L-1], w_j = exp(total - cum_j) dt_j, H_z the state before the chunk
// and S_z the chunk's own state (H_{z+1} = exp(total_z) H_z + S_z):
//
//   dS_z  = dH_{z+1} (dH_nc = d_final),
//   dH_z  = exp(total_z) dH_{z+1} + sum_i exp(cum_i) dy_i (x) C_i,
//   G_ij  = (C_i . B_j) exp(cum_i - cum_j) dt_j,  Q_ij = exp(cum_i - cum_j)
//           dt_j (dy_i . x_j),  W_ij = G_ij (dy_i . x_j), for i >= j,
//   dx_j  = sum_i G_ij dy_i + w_j dS_z B_j,
//   dC_i  = sum_j Q_ij B_j + exp(cum_i) dy_i H_z,
//   dB_j  = sum_i Q_ij C_i + w_j dS_z^T x_j,
//   ddt_j = sum_i exp(cum_i - cum_j) (C_i . B_j) (dy_i . x_j)
//           + exp(total - cum_j) (x_j dS_z) . B_j + A rev_j,
//   rev_j = sum_{k >= j} dcum_k,  dcum_k = sum_j W_kj - sum_i W_ik + V_k
//           - U_k (+ sum_j U_j + exp(total) <dS_z, H_z> at k = L-1),
//   V_i   = exp(cum_i) (dy_i H_z) . C_i,  U_j = w_j (x_j dS_z) . B_j,
//   d_a_log = A sum dt rev,
//
// and dB, dC summed over the heads (one group).  S need not be a multiple
// of L: the steps past S are the plain version's padding (dt = x = B = C
// = dy = 0), which only the reverse cumsum of dcum reaches.
//
// Stages, one kernel each, all launched by one call on one stream, with
// fp32 scratch from the wrapper:
// 0. ssd_bwd_cum: cum per (chunk, head), one thread in order with dt A
//    rounded before the sum, as the forward kernels and the plain version
//    compute it.
// 1. ssd_bwd_states: S_z (x weighted by w) and sum_i exp(cum_i) dy_i (x)
//    C_i, each a (P x L)(L x N) product, one block per 64 columns of P.
// 2. ssd_bwd_scan: one thread per (batch, head, p, n): the forward scan
//    writes H_z over S_z, then the reverse scan writes dS_z over the
//    other product.
// 3. ssd_bwd_chunk<MODE>: one block per 64 positions of a chunk and head:
//    dC (MODE 0, with the row sums of W and V), dB (MODE 1, with the
//    column sums of W, U and ddt's direct terms) and dx (MODE 2, one
//    block per 64 columns of P too).  Each block walks the other tiles
//    of its causal half, forms the 64 x 64 tiles C B^T and dy x^T in
//    registers, the gate in shared memory, and adds its product with the
//    other operand to its own rows.
// 4. ssd_bwd_finish: dcum, its reverse cumsum, ddt, and each chunk's part
//    of d_a_log.
// 5. ssd_bwd_heads: dB and dC summed over the heads, d_a_log over the
//    batch and chunks.
// Every sum runs in a fixed order (no atomics), so a call is
// deterministic: two calls on the same inputs give the same bits.
//
// Bound.  The products per chunk of l steps: C B^T and dy x^T (l^2 (N +
// P) each way, recomputed by the three modes), the gate's products with
// dy, B and C (l^2 (P + 2N) / 2 each), and four (P x l)(l x N) products
// per head: at zamba2's training shape (2, 2048, 64, 64), N = 64, L =
// 256 about 6e10 FLOP, so on the CUDA cores (67e12 FLOP/s fp32) the
// operations bind.  Every product stays on the CUDA cores; the bf16
// route's redesign for the tensor cores is ssd_bwd_tc.cu.
//
// The launcher is a plain C function (no PyTorch headers) that returns
// cudaGetLastError, so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // positions a tile, columns of P a tile
constexpr int kPad = kT + 1;    // pitch of the 64-wide tiles, floats
constexpr int kK = 32;          // steps a slice of stage 1
constexpr int kThreads = 256;   // 16 x 16 threads, each 4 rows by 4+ cols

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
// The real steps of a chunk that starts at step t0.
__device__ __forceinline__ int steps_in(int s, int64_t t0, int chunk) {
  return s - t0 < chunk ? static_cast<int>(s - t0) : chunk;
}

// Copies rows [0, R) by columns [0, W) of a matrix with row stride ld
// into a tile of pitch LD as fp32, zero past (nrows, ncols); each row is
// scaled by scale[r] where scale is given.
template <typename T, int R, int W, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t ld_, int nrows, int ncols,
                                          const float* scale = nullptr) {
  for (int idx = threadIdx.x; idx < R * W; idx += kThreads) {
    const int r = idx / W, c = idx % W;
    float v = 0.f;
    if (r < nrows && c < ncols) {
      v = ld(src + static_cast<int64_t>(r) * ld_ + c);
      if (scale != nullptr) v *= scale[r];
    }
    dst[r * LD + c] = v;
  }
}

// Stage 0: cum, (B, nC, H, L).
template <typename T>
__global__ void ssd_bwd_cum(const T* __restrict__ dt,
                            const float* __restrict__ a_log,
                            float* __restrict__ cum, int s, int h, int nc,
                            int chunk) {
  extern __shared__ float dta[];
  const int z = blockIdx.x, bh = blockIdx.y;
  const int b = bh / h, hh = bh % h;
  const float a = -expf(a_log[hh]);
  const int64_t t0 = static_cast<int64_t>(z) * chunk;
  for (int l = threadIdx.x; l < chunk; l += blockDim.x) {
    const int64_t t = t0 + l;
    dta[l] = t < s ? __fmul_rn(ld(dt + (b * static_cast<int64_t>(s) + t) * h
                                   + hh), a)
                   : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float* out = cum + ((static_cast<int64_t>(b) * nc + z) * h + hh) * chunk;
    float run = 0.f;
    for (int l = 0; l < chunk; ++l) {
      run = __fadd_rn(run, dta[l]);
      out[l] = run;
    }
  }
}

// Stage 1: which 0 writes S_z = sum_j (w_j x_j) (x) B_j to st, which 1
// writes R_z = sum_i (exp(cum_i) dy_i) (x) C_i to rt; both (B, nC, H, P,
// N).  Grid (2 * ceil(P / 64), nC, B * H).
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states(const T* __restrict__ x, const T* __restrict__ dt,
               const T* __restrict__ bm, const T* __restrict__ cm,
               const T* __restrict__ dy, const float* __restrict__ cum,
               float* __restrict__ st_, float* __restrict__ rt, int s, int h,
               int p, int n, int nc, int chunk) {
  constexpr int NB = NP / 16;
  __shared__ float us[kK * kPad];
  __shared__ float vs[kK * (NP + 1)];
  __shared__ float wgt[kK];
  const int which = blockIdx.x & 1, pt = blockIdx.x >> 1;
  const int z = blockIdx.y, bh = blockIdx.z;
  const int b = bh / h, hh = bh % h;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* cz = cum + ((static_cast<int64_t>(b) * nc + z) * h + hh) *
                              chunk;
  const float total = cz[chunk - 1];
  const int64_t t0 = static_cast<int64_t>(z) * chunk;
  const int lim = steps_in(s, t0, chunk);
  const T* u_src = (which ? dy : x) +
                   ((b * static_cast<int64_t>(s) + t0) * h + hh) * p +
                   pt * kT;
  const T* v_src = (which ? cm : bm) + (b * static_cast<int64_t>(s) + t0) * n;
  float acc[4][NB] = {};
  for (int k0 = 0; k0 < lim; k0 += kK) {
    const int kn = min(kK, lim - k0);
    if (threadIdx.x < kK) {
      const int l = k0 + threadIdx.x;
      float wv = 0.f;
      if (threadIdx.x < kn)
        wv = which ? expf(cz[l])
                   : expf(total - cz[l]) *
                         ld(dt + (b * static_cast<int64_t>(s) + t0 + l) * h +
                            hh);
      wgt[threadIdx.x] = wv;
    }
    __syncthreads();
    load_tile<T, kK, kT, kPad>(us, u_src + static_cast<int64_t>(k0) * h * p,
                               static_cast<int64_t>(h) * p, kn,
                               min(kT, p - pt * kT), wgt);
    load_tile<T, kK, NP, NP + 1>(vs, v_src + static_cast<int64_t>(k0) * n, n,
                                 kn, n);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kK; ++k) {
      float u[4], v[NB];
#pragma unroll
      for (int a = 0; a < 4; ++a) u[a] = us[k * kPad + ty + 16 * a];
#pragma unroll
      for (int j = 0; j < NB; ++j) v[j] = vs[k * (NP + 1) + tx + 16 * j];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < NB; ++j) acc[a][j] = fmaf(u[a], v[j], acc[a][j]);
    }
    __syncthreads();
  }
  float* out = (which ? rt : st_) +
               (((static_cast<int64_t>(b) * nc + z) * h + hh) * p) * n;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int pp = pt * kT + ty + 16 * a;
    if (pp >= p) continue;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int nn = tx + 16 * j;
      if (nn < n) out[static_cast<int64_t>(pp) * n + nn] = acc[a][j];
    }
  }
}

// Stage 2: the state before each chunk over st (in place), and dS_z over
// rt (in place), one thread per (b, h, p, n).
__global__ void ssd_bwd_scan(const float* __restrict__ cum,
                             const float* __restrict__ dfin,
                             float* __restrict__ st_, float* __restrict__ rt,
                             int bsz, int h, int p, int n, int nc,
                             int chunk) {
  const int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
  const int64_t pn = static_cast<int64_t>(p) * n;
  if (idx >= bsz * h * pn) return;
  const int64_t e = idx % pn;
  const int64_t bh = idx / pn;
  const int b = static_cast<int>(bh / h), hh = static_cast<int>(bh % h);
  auto off = [&](int z) {
    return ((static_cast<int64_t>(b) * nc + z) * h + hh) * pn + e;
  };
  auto decay = [&](int z) {
    return expf(cum[((static_cast<int64_t>(b) * nc + z) * h + hh) * chunk +
                    chunk - 1]);
  };
  float carry = 0.f;
  for (int z = 0; z < nc; ++z) {
    const float sz = st_[off(z)];
    st_[off(z)] = carry;
    carry = __fadd_rn(__fmul_rn(carry, decay(z)), sz);
  }
  float d = dfin != nullptr ? dfin[bh * pn + e] : 0.f;
  for (int z = nc - 1; z >= 0; --z) {
    const float r = rt[off(z)];
    rt[off(z)] = d;
    d = __fadd_rn(__fmul_rn(d, decay(z)), r);
  }
}

constexpr int kDC = 0, kDB = 1, kDX = 2;

// Stage 3.  The block's own 64 positions of chunk z are rows; it walks
// the other tiles of its causal half (earlier tiles for dC, later ones
// for dB and dx).  sc: (4, B, nC, H, L) fp32 per-position sums: 0 = row
// sums of W + V (dC), 1 = column sums of W, 2 = U, 3 = ddt's direct
// terms (dB).  Grid (tiles a chunk [x ceil(P / 64) for dx], nC, B * H).
template <typename T, int NP, int MODE>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk(const T* __restrict__ x, const T* __restrict__ dt,
              const T* __restrict__ bm, const T* __restrict__ cm,
              const T* __restrict__ dy, const float* __restrict__ cum,
              const float* __restrict__ hst, const float* __restrict__ dst_,
              T* __restrict__ dx, float* __restrict__ dbcp,
              float* __restrict__ sc, int s, int h, int p, int n, int nc,
              int chunk) {
  constexpr int NPP = NP + 1;
  constexpr int NB = MODE == kDX ? 4 : NP / 16;  // output cols / 16
  extern __shared__ float smem[];
  float* own = smem;                   // [64][NPP]: C (dC) or B (dB, dx)
  float* oth = own + kT * NPP;         // [64][NPP]: the other tile's B or C
  float* so = oth + kT * NPP;          // [64][kPad]: own dy or x slice
  float* sx = so + kT * kPad;          // [64][kPad]: other x or dy slice
  float* qs = sx + kT * kPad;          // [64][kPad]: the gate
  float* cumo = qs + kT * kPad;        // [64] each
  float* dto = cumo + kT;
  float* cumx = dto + kT;
  float* dtx = cumx + kT;

  const int tiles = (chunk + kT - 1) / kT;
  const int t = MODE == kDX ? blockIdx.x % tiles : blockIdx.x;
  const int pt = MODE == kDX ? blockIdx.x / tiles : 0;
  const int z = blockIdx.y, bh = blockIdx.z;
  const int b = bh / h, hh = bh % h;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t bs = static_cast<int64_t>(b) * s;
  const int64_t t0 = static_cast<int64_t>(z) * chunk;
  const int lim = steps_in(s, t0, chunk);
  const int64_t zh = (static_cast<int64_t>(b) * nc + z) * h + hh;
  const float* cz = cum + zh * chunk;
  const float total = cz[chunk - 1];
  const int64_t hp = static_cast<int64_t>(h) * p;
  const int own0 = t * kT;
  const int own_n = max(0, min(kT, lim - own0));  // real rows of own tile

  auto load_scalars = [&](float* cs, float* ds, int l0) {
    for (int r = threadIdx.x; r < kT; r += kThreads) {
      const int l = l0 + r;
      cs[r] = l < chunk ? cz[l] : 0.f;
      ds[r] = l < lim ? ld(dt + (bs + t0 + l) * h + hh) : 0.f;
    }
  };
  // Rows of tile u of B or C (full N) into dst.
  auto load_bc = [&](float* dst, const T* src, int u) {
    const int l0 = u * kT;
    load_tile<T, kT, NP, NPP>(dst, src + (bs + t0 + l0) * n, n,
                              max(0, min(kT, lim - l0)), n);
  };
  // Rows of tile u of x or dy, columns [q0, q0 + 64) into dst.
  auto load_xp = [&](float* dst, const T* src, int u, int q0) {
    const int l0 = u * kT;
    load_tile<T, kT, kT, kPad>(dst, src + ((bs + t0 + l0) * h + hh) * p + q0,
                               hp, max(0, min(kT, lim - l0)),
                               min(kT, p - q0));
  };

  const T* own_bc = MODE == kDC ? cm : bm;
  const T* oth_bc = MODE == kDC ? bm : cm;
  const T* own_xp = MODE == kDC ? dy : x;
  const T* oth_xp = MODE == kDC ? x : dy;

  load_scalars(cumo, dto, own0);
  load_bc(own, own_bc, t);

  float acc[4][NB] = {};
  float rsum[4] = {}, dsum[4] = {};   // per-row partial sums
  const float* state = (MODE == kDC ? hst : dst_) + zh * p * n;

  // ---- the state terms: dC_i = exp(cum_i) dy_i H, V_i; dB_j = w_j x_j
  // dS, U_j, ddt; dx_j = w_j dS B_j.
  if constexpr (MODE == kDX) {
    // acc[j][q] = sum_n B_j[n] dS[q][n], q in this block's 64 columns.
    load_tile<float, kT, NP, NPP>(oth, state + static_cast<int64_t>(pt) *
                                               kT * n,
                                  n, min(kT, p - pt * kT), n);
    __syncthreads();
    for (int k = 0; k < NP; ++k) {
      float u[4], v[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) u[a] = own[(ty + 16 * a) * NPP + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = oth[(tx + 16 * j) * NPP + k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[a][j] = fmaf(u[a], v[j], acc[a][j]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const float wj = expf(total - cumo[r]) * dto[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][j] *= wj;
    }
  } else {
    // acc[r][n] = sum_q own_xp[r][q] state[q][n], over slices of 64 q.
    for (int q0 = 0; q0 < p; q0 += kT) {
      __syncthreads();
      load_xp(so, own_xp, t, q0);
      load_tile<float, kT, NP, NPP>(oth, state + static_cast<int64_t>(q0) * n,
                                    n, min(kT, p - q0), n);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kT; ++k) {
        float u[4], v[NB];
#pragma unroll
        for (int a = 0; a < 4; ++a) u[a] = so[(ty + 16 * a) * kPad + k];
#pragma unroll
        for (int j = 0; j < NB; ++j) v[j] = oth[k * NPP + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < NB; ++j) acc[a][j] = fmaf(u[a], v[j], acc[a][j]);
      }
    }
    // dot of each row with own (C_i for dC, B_j for dB), then scale.
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j)
        dot = fmaf(acc[a][j], own[r * NPP + tx + 16 * j], dot);
      float scale;
      if constexpr (MODE == kDC) {
        scale = expf(cumo[r]);            // V_i = scale * dot
        rsum[a] = scale * dot;
      } else {
        const float e = expf(total - cumo[r]);
        scale = e * dto[r];               // w_j
        dsum[a] = e * dot;                // ddt's state term
        rsum[a] = scale * dot;            // U_j (kept apart below)
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) acc[a][j] *= scale;
    }
  }
  float usum[4] = {rsum[0], rsum[1], rsum[2], rsum[3]};
  if constexpr (MODE == kDB) {
#pragma unroll
    for (int a = 0; a < 4; ++a) rsum[a] = 0.f;
  }

  // ---- the causal half: dC over tiles u <= t, dB and dx over u >= t.
  const int u_lo = MODE == kDC ? 0 : t;
  const int u_hi = MODE == kDC ? t : tiles - 1;
  for (int u = u_lo; u <= u_hi; ++u) {
    if (u * kT >= lim) break;
    __syncthreads();
    load_scalars(cumx, dtx, u * kT);
    load_bc(oth, oth_bc, u);
    __syncthreads();
    // cb[a][j] = own_bc[row] . oth_bc[col]
    float cb[4][4] = {}, dxy[4][4] = {};
    for (int k = 0; k < NP; ++k) {
      float o[4], v[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) o[a] = own[(ty + 16 * a) * NPP + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = oth[(tx + 16 * j) * NPP + k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) cb[a][j] = fmaf(o[a], v[j], cb[a][j]);
    }
    if constexpr (MODE != kDX) {
      // dxy[a][j] = own_xp[row] . oth_xp[col], over slices of 64 of P.
      for (int q0 = 0; q0 < p; q0 += kT) {
        __syncthreads();
        load_xp(so, own_xp, t, q0);
        load_xp(sx, oth_xp, u, q0);
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < kT; ++k) {
          float o[4], v[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) o[a] = so[(ty + 16 * a) * kPad + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = sx[(tx + 16 * j) * kPad + k];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              dxy[a][j] = fmaf(o[a], v[j], dxy[a][j]);
        }
      }
    }
    // The gate: rows own, columns other.  dC: i = own, j = other; dB and
    // dx: j = own, i = other.
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a, lr = own0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, lc = u * kT + c;
        const bool causal = MODE == kDC ? lr >= lc : lc >= lr;
        float g = 0.f;
        if (causal && lr < chunk && lc < chunk) {
          const float e = MODE == kDC ? expf(cumo[r] - cumx[c])
                                      : expf(cumx[c] - cumo[r]);
          const float dtj = MODE == kDC ? dtx[c] : dto[r];
          if constexpr (MODE == kDX) {
            g = cb[a][j] * e * dtj;                    // G_ij
          } else {
            g = e * dtj * dxy[a][j];                   // Q_ij
            rsum[a] += g * cb[a][j];                   // W_ij
            if constexpr (MODE == kDB) dsum[a] += e * cb[a][j] * dxy[a][j];
          }
        }
        qs[r * kPad + c] = g;
      }
    }
    if constexpr (MODE == kDX) {
      __syncthreads();
      load_xp(sx, dy, u, pt * kT);
    }
    __syncthreads();
    // acc[r][col] += sum_c qs[r][c] V[c][col], V = oth (B or C) or the
    // other tile's dy slice (dx).
    const float* vv = MODE == kDX ? sx : oth;
    constexpr int LDV = MODE == kDX ? kPad : NPP;
#pragma unroll 4
    for (int c = 0; c < kT; ++c) {
      float g[4], v[NB];
#pragma unroll
      for (int a = 0; a < 4; ++a) g[a] = qs[(ty + 16 * a) * kPad + c];
#pragma unroll
      for (int j = 0; j < NB; ++j) v[j] = vv[c * LDV + tx + 16 * j];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < NB; ++j) acc[a][j] = fmaf(g[a], v[j], acc[a][j]);
    }
  }

  // ---- write: the rows' outputs, and the per-position sums reduced over
  // the 16 threads of a row (lanes of one half-warp, fixed order).
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (r >= own_n) continue;
    const int64_t pos = bs + t0 + own0 + r;
    if constexpr (MODE == kDX) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = pt * kT + tx + 16 * j;
        if (q < p) st(dx + (pos * h + hh) * p + q, acc[a][j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int nn = tx + 16 * j;
        if (nn < n) dbcp[(pos * h + hh) * n + nn] = acc[a][j];
      }
    }
  }
  if constexpr (MODE != kDX) {
    const int64_t plane = static_cast<int64_t>(gridDim.z / h) * nc * h *
                          chunk;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float rs = rsum[a], us = usum[a], ds = dsum[a];
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) {
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
        if constexpr (MODE == kDB) {
          us += __shfl_xor_sync(0xffffffffu, us, o);
          ds += __shfl_xor_sync(0xffffffffu, ds, o);
        }
      }
      const int l = own0 + ty + 16 * a;
      if (tx == 0 && l < chunk) {
        float* row = sc + zh * chunk + l;
        if constexpr (MODE == kDC) {
          row[0] = rs;                     // W row sums + V
        } else {
          row[plane] = rs;                 // W column sums
          row[2 * plane] = us;             // U
          row[3 * plane] = ds;             // ddt's direct terms
        }
      }
    }
  }
}

// Stage 4: dcum, its reverse cumsum, ddt and each chunk's part of
// d_a_log (dap, (B, nC, H)).  Grid (nC, B * H).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_finish(const T* __restrict__ dt, const float* __restrict__ a_log,
               const float* __restrict__ cum, const float* __restrict__ hst,
               const float* __restrict__ dst_, const float* __restrict__ sc,
               T* __restrict__ ddt, float* __restrict__ dap, int bsz, int s,
               int h, int p, int n, int nc, int chunk) {
  extern __shared__ float sm[];
  float* rev = sm;                 // [chunk]
  float* dts = rev + chunk;        // [chunk]
  float* us = dts + chunk;         // [chunk]
  float* red = us + chunk;         // [kThreads]
  const int z = blockIdx.x, bh = blockIdx.y;
  const int b = bh / h, hh = bh % h;
  const int64_t zh = (static_cast<int64_t>(b) * nc + z) * h + hh;
  const int64_t plane = static_cast<int64_t>(bsz) * nc * h * chunk;
  const int64_t t0 = static_cast<int64_t>(z) * chunk;
  const int lim = steps_in(s, t0, chunk);
  const float a = -expf(a_log[hh]);
  const float* row = sc + zh * chunk;
  const float total = cum[zh * chunk + chunk - 1];
  // exp(total) <dS_z, H_z>, a fixed tree over the block.
  const int64_t pn = static_cast<int64_t>(p) * n;
  float part = 0.f;
  for (int64_t e = threadIdx.x; e < pn; e += kThreads)
    part = fmaf(dst_[zh * pn + e], hst[zh * pn + e], part);
  red[threadIdx.x] = part;
  for (int l = threadIdx.x; l < chunk; l += kThreads) {
    us[l] = row[2 * plane + l];
    rev[l] = row[l] - row[plane + l] - us[l];
    dts[l] = l < lim ? ld(dt + (b * static_cast<int64_t>(s) + t0 + l) * h +
                          hh)
                     : 0.f;
  }
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float usum = 0.f;
    for (int l = 0; l < chunk; ++l) usum += us[l];
    float run = 0.f, pa = 0.f;
    for (int l = chunk - 1; l >= 0; --l) {
      float d = rev[l];
      if (l == chunk - 1) d += usum + expf(total) * red[0];
      run += d;
      rev[l] = run;
      pa = fmaf(dts[l], run, pa);
    }
    dap[zh] = pa;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < lim; l += kThreads)
    st(ddt + (b * static_cast<int64_t>(s) + t0 + l) * h + hh,
       row[3 * plane + l] + a * rev[l]);
}

// Stage 5: dB and dC over the heads (one thread per (b, s, n) of each),
// then d_a_log = A sum over (b, z) of dap.
template <typename T>
__global__ void ssd_bwd_heads(const float* __restrict__ dbp,
                              const float* __restrict__ dcp,
                              T* __restrict__ db, T* __restrict__ dc,
                              int64_t rows, int h, int n) {
  const int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
  if (idx >= 2 * rows * n) return;
  const bool is_c = idx >= rows * n;
  const int64_t e = is_c ? idx - rows * n : idx;
  const int64_t r = e / n, nn = e % n;
  const float* src = (is_c ? dcp : dbp) + r * h * n + nn;
  float sum = 0.f;
  for (int k = 0; k < h; ++k) sum += src[static_cast<int64_t>(k) * n];
  st((is_c ? dc : db) + e, sum);
}

__global__ void ssd_bwd_alog(const float* __restrict__ a_log,
                             const float* __restrict__ dap,
                             float* __restrict__ da, int bsz, int h,
                             int nc) {
  const int hh = blockIdx.x * blockDim.x + threadIdx.x;
  if (hh >= h) return;
  float sum = 0.f;
  for (int bz = 0; bz < bsz * nc; ++bz)
    sum += dap[static_cast<int64_t>(bz) * h + hh];
  da[hh] = -expf(a_log[hh]) * sum;
}

template <int NP, int MODE, typename T>
cudaError_t chunk_stage(const T* x, const T* dt, const T* b, const T* c,
                        const T* dy, const float* cum, const float* hst,
                        const float* dst_, T* dx, float* dbcp, float* sc,
                        int bsz, int s, int h, int p, int n, int nc,
                        int chunk, cudaStream_t stm) {
  const size_t smem = (2 * kT * (NP + 1) + 3 * kT * kPad + 4 * kT) *
                      sizeof(float);
  auto kern = ssd_bwd_chunk<T, NP, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (chunk + kT - 1) / kT;
  const int gx = MODE == kDX ? tiles * ((p + kT - 1) / kT) : tiles;
  kern<<<dim3(gx, nc, bsz * h), kThreads, smem, stm>>>(
      x, dt, b, c, dy, cum, hst, dst_, dx, dbcp, sc, s, h, p, n, nc, chunk);
  return cudaGetLastError();
}

template <int NP, typename T>
int launch(const T* x, const T* dt, const float* a_log, const T* b,
           const T* c, const T* dy, const float* dfin, T* dx, T* ddt,
           float* da, T* db, T* dc, float* cum, float* hst, float* dst_,
           float* dbp, float* dcp, float* sc, float* dap, int bsz, int s,
           int h, int p, int n, int chunk, cudaStream_t stm) {
  const int nc = (s + chunk - 1) / chunk;
  cudaError_t err;
  ssd_bwd_cum<T><<<dim3(nc, bsz * h), 128, chunk * sizeof(float), stm>>>(
      dt, a_log, cum, s, h, nc, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int ptiles = (p + kT - 1) / kT;
  ssd_bwd_states<T, NP><<<dim3(2 * ptiles, nc, bsz * h), kThreads, 0, stm>>>(
      x, dt, b, c, dy, cum, hst, dst_, s, h, p, n, nc, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t lanes = static_cast<int64_t>(bsz) * h * p * n;
  ssd_bwd_scan<<<static_cast<unsigned>((lanes + 255) / 256), 256, 0, stm>>>(
      cum, dfin, hst, dst_, bsz, h, p, n, nc, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = chunk_stage<NP, kDC>(x, dt, b, c, dy, cum, hst, dst_, dx, dcp,
                                  sc, bsz, s, h, p, n, nc, chunk, stm)))
    return err;
  if ((err = chunk_stage<NP, kDB>(x, dt, b, c, dy, cum, hst, dst_, dx, dbp,
                                  sc, bsz, s, h, p, n, nc, chunk, stm)))
    return err;
  if ((err = chunk_stage<NP, kDX>(x, dt, b, c, dy, cum, hst, dst_, dx,
                                  nullptr, sc, bsz, s, h, p, n, nc, chunk,
                                  stm)))
    return err;
  const size_t fsmem = (3 * chunk + kThreads) * sizeof(float);
  ssd_bwd_finish<T><<<dim3(nc, bsz * h), kThreads, fsmem, stm>>>(
      dt, a_log, cum, hst, dst_, sc, ddt, dap, bsz, s, h, p, n, nc, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(bsz) * s;
  if (rows * n > 0) {
    ssd_bwd_heads<T><<<static_cast<unsigned>((2 * rows * n + 255) / 256), 256,
                       0, stm>>>(dbp, dcp, db, dc, rows, h, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  ssd_bwd_alog<<<(h + 127) / 128, 128, 0, stm>>>(a_log, dap, da, bsz, h, nc);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* a_log, const void* b,
             const void* c, const void* dy, const void* dfin, void* dx,
             void* ddt, void* da, void* db, void* dc, void* cum, void* hst,
             void* dst_, void* dbp, void* dcp, void* sc, void* dap, int bsz,
             int s, int h, int p, int n, int chunk, cudaStream_t stm) {
  auto f = [](void* q) { return static_cast<float*>(q); };
  const T* xx = static_cast<const T*>(x);
  const T* dd = static_cast<const T*>(dt);
  const T* bb = static_cast<const T*>(b);
  const T* cc = static_cast<const T*>(c);
  const T* yy = static_cast<const T*>(dy);
  const float* aa = static_cast<const float*>(a_log);
  const float* ff = static_cast<const float*>(dfin);
  T* ox = static_cast<T*>(dx);
  T* ot = static_cast<T*>(ddt);
  T* ob = static_cast<T*>(db);
  T* oc = static_cast<T*>(dc);
  return n <= 64 ? launch<64>(xx, dd, aa, bb, cc, yy, ff, ox, ot, f(da), ob,
                              oc, f(cum), f(hst), f(dst_), f(dbp), f(dcp),
                              f(sc), f(dap), bsz, s, h, p, n, chunk, stm)
                 : launch<128>(xx, dd, aa, bb, cc, yy, ff, ox, ot, f(da), ob,
                               oc, f(cum), f(hst), f(dst_), f(dbp), f(dcp),
                               f(sc), f(dap), bsz, s, h, p, n, chunk, stm);
}

}  // namespace

// x, dt, b, c, dy fp32, a_log and d_final (may be null) fp32.  Outputs
// dx, ddt, db, dc and d_a_log fp32.  Scratch (fp32): cum (B, nC, H, L),
// the four per-position sums sc (4, B, nC, H, L), hst and dst (B, nC, H,
// P, N), dbp and dcp (B, S, H, N), dap (B, nC, H).
extern "C" int ssd_bwd_launch(const void* x, const void* dt,
                              const void* a_log, const void* b, const void* c,
                              const void* dy, const void* dfin, void* dx,
                              void* ddt, void* da, void* db, void* dc,
                              void* cum, void* hst, void* dst_, void* dbp,
                              void* dcp, void* sc, void* dap, int bsz, int s,
                              int h, int p, int n, int chunk, void* stream) {
  if (bsz <= 0 || h <= 0 || p <= 0 || s <= 0) return 0;
  if (n <= 0 || n > 128 || chunk <= 0 || chunk > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  return dispatch<float>(x, dt, a_log, b, c, dy, dfin, dx, ddt, da, db, dc,
                         cum, hst, dst_, dbp, dcp, sc, dap, bsz, s, h, p, n,
                         chunk, stm);
}
