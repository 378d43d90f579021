// The shared pieces of the SSD scan's two backward kernels, ssd_bwd.cu
// (fp32 inputs, 3xTF32 products) and ssd_bwd_tc.cu (bf16 inputs, bf16
// products): the maths, the tile constants and the head group, the scalar
// loads, and the two stages that take no products, the chunk scan
// (stage 2) and the finish (stage 5), with their launches.  The two
// routes differ only in how they take their products (stages 1, 3 and
// 4), in where stage 2 keeps H_z and dS_z for them, and in the type of
// the gradients stage 5 writes.
//
// Maths.  Per batch b, head h (A = -exp(a_log[h])) and chunk z of L
// steps, with cum the inclusive in-order cumsum of dt A, total =
// cum[L-1], w_j = exp(total - cum_j) dt_j, H_z the state before the
// chunk, S_z = sum_j (w_j x_j) (x) B_j and R_z = sum_i (exp(cum_i) dy_i)
// (x) C_i:
//
//   dS_z  = dH_{z+1} (dH_nc = d_final),  dH_z = exp(total_z) dS_z + R_z,
//   G_ij  = (C_i . B_j) exp(cum_i - cum_j) dt_j,  Q_ij = exp(cum_i - cum_j)
//           dt_j (dy_i . x_j),  W_ij = G_ij (dy_i . x_j), for i >= j,
//   dx_j  = sum_i G_ij dy_i + w_j dS_z B_j,
//   dC_i  = sum_j (sum_h Q^h_ij) B_j + sum_(h,p) (exp(cum^h_i) dy^h_ip) H^h_p,
//   dB_j  = sum_i (sum_h Q^h_ij) C_i + sum_(h,p) (w^h_j x^h_jp) dS^h_p,
//   ddt_j = sum_i exp(cum_i - cum_j) (C_i . B_j) (dy_i . x_j)
//           + exp(total - cum_j) (x_j dS_z) . B_j + A rev_j,
//   rev_j = sum_{k >= j} dcum_k,  dcum_k = sum_j W_kj - sum_i W_ik + V_k
//           - U_k (+ sum_j U_j + exp(total) <dS_z, H_z> at k = L-1),
//   V_i   = exp(cum_i) (dy_i H_z) . C_i,  U_j = w_j (x_j dS_z) . B_j,
//   d_a_log = A sum dt rev.
//
// One group shares B and C across the heads, so dB and dC fold the head
// sum before their N-wide products: a block of the row or column pass
// walks kGroup heads in order, sums their Q tiles in registers and
// multiplies the sum once, writing partials of (B, S, H / kGroup, N),
// which stage 5 sums.  S need not be a multiple of L: the steps past S
// are the plain version's padding (dt = x = B = C = dy = 0), which only
// the reverse cumsum of dcum reaches.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/sm90.cuh"

namespace {

constexpr int kT = 64;          // tile edge: positions, columns of P or N
constexpr int kThreads = 128;   // 4 warps, 16 rows of a tile each
constexpr int kGroup = 8;       // heads a block of the row and column passes

// The real steps of a chunk that starts at step t0.
__device__ __forceinline__ int steps_in(int s, int64_t t0, int chunk) {
  return s - t0 < chunk ? static_cast<int>(s - t0) : chunk;
}

// The sum of v over the four lanes of a quad (one row of a fragment).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Starts copying cum and dt of positions l0 .. l0 + 63 of one head and
// chunk (cz, dz: rows of the fp32 scratch cum and dtc) into fc and fd,
// zero past the chunk's real steps.  Part of the caller's next cp.async
// group: a plain load here would stall its warps for the load's latency.
__device__ __forceinline__ void load_scalars(float* fc, float* fd,
                                             const float* cz,
                                             const float* dz, int l0,
                                             int len) {
  static_assert(kThreads == 2 * kT, "a thread a scalar");
  const int r = threadIdx.x & (kT - 1);
  const bool ok = l0 + r < len;
  if (threadIdx.x < kT)
    cp_async4(fc + r, ok ? cz + l0 + r : cz, ok);
  else
    cp_async4(fd + r, ok ? dz + l0 + r : dz, ok);
}

// Stage 2's store of H_z and dS_z for the fp32 route: H_z over S_z in sr's
// first plane (dS_z is always written over R_z in its second).
struct StatesInPlace {
  __device__ __forceinline__ void h(float* st, int64_t o, float v) const {
    st[o] = v;
  }
  __device__ __forceinline__ void ds(int64_t, float) const {}
};

// Stage 2.  Grid (ceil(P N / 256), B * H), one thread per (p, n): the
// reverse scan writes dS_z over R_z (and hands it to store.ds), the
// forward scan hands H_z to store.h (with the S_z plane, which it may
// overwrite), and each warp's sum of dS_z H_z goes to dhp (B * H, nC,
// nw).  Each loop issues the loads of 8 chunks before their sums.
template <class Store>
__global__ void __launch_bounds__(256)
ssd_bwd_scan(const float* __restrict__ cum, const float* __restrict__ dfin,
             float* __restrict__ sr, Store store, float* __restrict__ dhp,
             int bsz, int h, int pn, int nc, int chunk) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const bool valid = e < pn;
  const int bh = blockIdx.y, b = bh / h, hh = bh % h;
  const int64_t plane = static_cast<int64_t>(bsz) * nc * h * pn;
  float* st = sr;
  float* rt = sr + plane;
  auto off = [&](int z) {
    return ((static_cast<int64_t>(b) * nc + z) * h + hh) * pn + e;
  };
  auto total = [&](int z) {
    return cum[((static_cast<int64_t>(b) * nc + z) * h + hh) * chunk +
               chunk - 1];
  };
  float d = valid && dfin != nullptr ? dfin[bh * static_cast<int64_t>(pn) +
                                            e]
                                     : 0.f;
  for (int z1 = nc - 1; z1 >= 0; z1 -= 8) {
    float r[8], dec[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int z = z1 - k;
      dec[k] = z >= 0 ? total(z) : 0.f;
      r[k] = z >= 0 && valid ? rt[off(z)] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int z = z1 - k;
      if (z < 0) break;
      if (valid) {
        rt[off(z)] = d;
        store.ds(off(z), d);
      }
      d = __fadd_rn(__fmul_rn(d, expf(dec[k])), r[k]);
    }
  }
  const int nw = gridDim.x * (blockDim.x / 32);
  const int wg = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  float carry = 0.f;
  for (int z0 = 0; z0 < nc; z0 += 8) {
    float sz[8], ds[8], dec[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int z = z0 + k;
      const bool ok = z < nc && valid;
      dec[k] = z < nc ? total(z) : 0.f;
      sz[k] = ok ? st[off(z)] : 0.f;
      ds[k] = ok ? rt[off(z)] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int z = z0 + k;
      if (z >= nc) break;
      if (valid) store.h(st, off(z), carry);
      float prod = carry * ds[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        prod += __shfl_xor_sync(0xffffffffu, prod, o);
      if ((threadIdx.x & 31) == 0)
        dhp[(static_cast<int64_t>(bh) * nc + z) * nw + wg] = prod;
      carry = __fadd_rn(__fmul_rn(carry, expf(dec[k])), sz[k]);
    }
  }
}

// The warps of stage 2's grid: the last dimension of dhp.
inline int scan_warps(int p, int n) { return (p * n + 255) / 256 * 8; }

template <class Store>
cudaError_t launch_scan(const float* cum, const float* dfin, float* sr,
                        Store store, float* dhp, int bsz, int h, int p, int n,
                        int nc, int chunk, cudaStream_t stm) {
  const int pn = p * n;
  ssd_bwd_scan<Store><<<dim3((pn + 255) / 256, bsz * h), 256, 0, stm>>>(
      cum, dfin, sr, store, dhp, bsz, h, pn, nc, chunk);
  return cudaGetLastError();
}

// A gradient in the route's output type.
template <class T>
__device__ __forceinline__ T out_as(float v);
template <>
__device__ __forceinline__ float out_as<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 out_as<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Stage 5.  Blocks [0, nC B H): one a (chunk, head, batch), dcum, its
// reverse cumsum, ddt and the chunk's part of d_a_log (dap, (B, nC, H));
// the last block of a head sums its parts into d_a_log.  The blocks past
// them sum dB and dC over the ng head groups, one thread an (b, s, n).
// sc (4, B, nC, H, L): 0 = row sums of W + V, 1 = column sums of W, 2 =
// U, 3 = ddt's direct terms.  ddt, dB and dC are written as T, d_a_log
// as fp32.
template <class T>
__global__ void __launch_bounds__(256)
ssd_bwd_finish(const float* __restrict__ dtc,
               const float* __restrict__ a_log, const float* __restrict__ cum,
               const float* __restrict__ sc, const float* __restrict__ dhp,
               const float* __restrict__ dbp, const float* __restrict__ dcp,
               T* __restrict__ ddt, T* __restrict__ db, T* __restrict__ dc,
               float* __restrict__ dap, float* __restrict__ da,
               int* __restrict__ cnt, int bsz, int s, int h, int n, int nc,
               int chunk, int ng, int nw) {
  const int64_t nchunks = static_cast<int64_t>(nc) * bsz * h;
  if (blockIdx.x >= nchunks) {
    const int64_t rows = static_cast<int64_t>(bsz) * s;
    const int64_t i = (blockIdx.x - nchunks) * static_cast<int64_t>(
                          blockDim.x) + threadIdx.x;
    if (i >= 2 * rows * n) return;
    const bool is_c = i >= rows * n;
    const int64_t e = is_c ? i - rows * n : i;
    const int64_t r = e / n, nn = e % n;
    const float* src = (is_c ? dcp : dbp) + r * ng * n + nn;
    float sum = 0.f;
    for (int k = 0; k < ng; ++k) sum += src[static_cast<int64_t>(k) * n];
    (is_c ? dc : db)[e] = out_as<T>(sum);
    return;
  }
  extern __shared__ float sm[];
  float* rev = sm;                 // [chunk]
  float* dts = rev + chunk;        // [chunk]
  float* us = dts + chunk;         // [chunk]
  const int z = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / h, hh = bh % h;
  const int64_t zh = (static_cast<int64_t>(b) * nc + z) * h + hh;
  const int64_t plane = static_cast<int64_t>(bsz) * nc * h * chunk;
  const int64_t t0 = static_cast<int64_t>(z) * chunk;
  const int len = steps_in(s, t0, chunk);
  const float a = -expf(a_log[hh]);
  const float* row = sc + zh * chunk;
  const float total = cum[zh * chunk + chunk - 1];
  for (int l = threadIdx.x; l < chunk; l += blockDim.x) {
    const bool ok = l < len;
    us[l] = ok ? row[2 * plane + l] : 0.f;
    rev[l] = ok ? row[l] - row[plane + l] - us[l] : 0.f;
    dts[l] = ok ? dtc[zh * chunk + l] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float* dh = dhp + (static_cast<int64_t>(bh) * nc + z) * nw;
    float dot = 0.f;
    for (int w = 0; w < nw; ++w) dot += dh[w];
    float usum = 0.f;
    for (int l = 0; l < chunk; ++l) usum += us[l];
    float run = 0.f, pa = 0.f;
    for (int l = chunk - 1; l >= 0; --l) {
      float d = rev[l];
      if (l == chunk - 1) d += usum + expf(total) * dot;
      run += d;
      rev[l] = run;
      pa = fmaf(dts[l], run, pa);
    }
    dap[zh] = pa;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < len; l += blockDim.x)
    ddt[(static_cast<int64_t>(b) * s + t0 + l) * h + hh] =
        out_as<T>(row[3 * plane + l] + a * rev[l]);
  if (threadIdx.x == 0) {
    __threadfence();   // dap[zh] before the count
    if (atomicAdd(cnt + hh, 1) == bsz * nc - 1) {
      __threadfence();
      float sum = 0.f;
      for (int bz = 0; bz < bsz * nc; ++bz)
        sum += __ldcg(dap + static_cast<int64_t>(bz) * h + hh);
      da[hh] = a * sum;
    }
  }
}

template <class T>
cudaError_t launch_finish(const float* dtc, const float* a_log,
                          const float* cum, const float* sc,
                          const float* dhp, const float* dbp,
                          const float* dcp, T* ddt, T* db, T* dc, float* dap,
                          float* da, int* cnt, int bsz, int s, int h, int p,
                          int n, int nc, int chunk, int ng,
                          cudaStream_t stm) {
  const int64_t sums = 2 * static_cast<int64_t>(bsz) * s * n;
  const int64_t blocks = static_cast<int64_t>(nc) * bsz * h +
                         (sums + 255) / 256;
  ssd_bwd_finish<T><<<static_cast<unsigned>(blocks), 256, 3 * chunk * 4,
                      stm>>>(dtc, a_log, cum, sc, dhp, dbp, dcp, ddt, db, dc,
                             dap, da, cnt, bsz, s, h, n, nc, chunk, ng,
                             scan_warps(p, n));
  return cudaGetLastError();
}

}  // namespace
