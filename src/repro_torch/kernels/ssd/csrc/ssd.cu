// The Mamba2 SSD chunked scan (one group) on fp32 inputs, with the fp32
// state carried across chunks; returns y and the final state.
//
// Replaces repro/kernels/ssd/kernel.py::ssd_pallas (body _ssd_kernel) for
// fp32 inputs; bf16 inputs take the tensor-core stages, ssd_tc.cu.
// It computes what the plain version (ref.py::ssd_chunked) computes, per
// batch b and head h with A = -exp(a_log[h]), over chunks of L steps:
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
// Bound.  fp32 SSD lies on no timed path of the port.  Per chunk the
// products are the scores C_i . B_j of the one group (L (L + 1) N with
// the causal half), and per head the gate's product with x
// (L (L + 1) P), the inter-chunk term and the state update (2 L P N
// each); at fp32 inputs held to 1e-5 relative they run at the fp32
// rate, 0.26 ms at (1, 8192, 64, 64), N = 64, L = 256.
//
// Design (simple and right; no tensor cores):
// - One block of 256 threads per (64 columns of P, head, batch); it
//   walks the chunks in order, with its (N, 64) slice of the state in
//   shared memory (16 KB at N = 64).  The scores C_i . B_j are
//   recomputed per head (the one group is shared), which adds 2 L^2 N
//   per chunk and head to the count above.
// - The gate is never held whole: the TPU kernel's L x L tile is 256 KB
//   at L = 256, over the 227 KB a block can have.  Rows go 64 at a
//   time; for each row tile the column tiles up to the diagonal are
//   staged (B^T, x), their 64 x 64 gate tile is formed in shared memory
//   and multiplied by x at once.  The last row tile visits every column
//   tile, so the state update is accumulated there, in registers.
// - Products are register-tiled: each thread owns a 4 x 4 block of a
//   64 x 64 output, 16 FMAs per 4 scalar and one 16-byte shared-memory
//   load; pitches of N + 4 and 68 floats keep a warp's two row groups
//   on different banks.
// - cum is summed by one thread in sequence, with the product dt A
//   rounded before the sum (no FMA), as the plain version's cumsum over
//   the chunk axis does on the card.
// - Offsets are 64-bit.
//
// The launcher is a plain C function (no PyTorch headers) that returns
// cudaGetLastError, so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;         // tile edge: rows, columns of P, steps
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLd = kT + 4;    // pitch of the B^T, x, gate and state tiles

// acc[r][c] += sum_k A[(4 ty + r) * lda + k] * B[k * ldb + 4 tx + c].
__device__ __forceinline__ void mm4x4(float (&acc)[4][4], const float* A,
                                      int lda, const float* B, int ldb,
                                      int kdim, int ty, int tx) {
  const float* a0 = A + (4 * ty) * lda;
  const float* b0 = B + 4 * tx;
#pragma unroll 4
  for (int k = 0; k < kdim; ++k) {
    const float4 bv = *reinterpret_cast<const float4*>(b0 + k * ldb);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = a0[r * lda + k];
      acc[r][0] += a * bv.x;
      acc[r][1] += a * bv.y;
      acc[r][2] += a * bv.z;
      acc[r][3] += a * bv.w;
    }
  }
}

// NG: groups of 64 rows of the state's N axis (1 for N <= 64, 2 <= 128).
template <int NG>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const float* __restrict__ bm,
           const float* __restrict__ cm, float* __restrict__ y,
           float* __restrict__ fin, int s, int h, int p, int n, int chunk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldc = n + 4;
  float* sC = smem;               // [kT][ldc]  C rows of the row tile
  float* sBT = sC + kT * ldc;     // [n][kLd]   B^T of the column tile
  float* sX = sBT + n * kLd;      // [kT][kLd]  x of the column tile
  float* sG = sX + kT * kLd;      // [kT][kLd]  gate tile
  float* sS = sG + kT * kLd;      // [n][kLd]   state^T slice
  float* sCum = sS + n * kLd;     // [chunk]
  float* sDt = sCum + chunk;      // [chunk]
  float* sW = sDt + chunk;        // [chunk]   dt_j exp(total - cum_j)

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int p0 = blockIdx.x * kT, hh = blockIdx.y, bb = blockIdx.z;
  const float a = -expf(a_log[hh]);
  const int64_t x_row = static_cast<int64_t>(h) * p;   // x/y step stride
  const float* xb = x + static_cast<int64_t>(bb) * s * x_row +
                static_cast<int64_t>(hh) * p + p0;
  float* yb = y + static_cast<int64_t>(bb) * s * x_row +
          static_cast<int64_t>(hh) * p + p0;
  const float* dtb = dt + static_cast<int64_t>(bb) * s * h + hh;
  const float* bbm = bm + static_cast<int64_t>(bb) * s * n;
  const float* cbm = cm + static_cast<int64_t>(bb) * s * n;

  for (int idx = tid; idx < n * kLd; idx += kThreads) sS[idx] = 0.f;

  const int n_tiles = (chunk + kT - 1) / kT;
  for (int t0 = 0; t0 < s; t0 += chunk) {
    __syncthreads();   // the previous chunk's readers are done
    for (int l = tid; l < chunk; l += kThreads)
      sDt[l] = t0 + l < s ? dtb[static_cast<int64_t>(t0 + l) * h]
                          : 0.f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int l = 0; l < chunk; ++l) {
        run = __fadd_rn(run, __fmul_rn(sDt[l], a));
        sCum[l] = run;
      }
    }
    __syncthreads();
    const float total = sCum[chunk - 1];
    for (int l = tid; l < chunk; l += kThreads)
      sW[l] = sDt[l] * expf(total - sCum[l]);

    float upd[NG][4][4] = {};
    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kT;
      __syncthreads();
      for (int idx = tid; idx < kT * n; idx += kThreads) {
        const int i = idx / n, nn = idx - i * n;
        const int l = i0 + i;
        sC[i * ldc + nn] = (l < chunk && t0 + l < s)
            ? cbm[static_cast<int64_t>(t0 + l) * n + nn] : 0.f;
      }
      __syncthreads();

      // Inter-chunk term: exp(cum_i) (C_i . state).
      float acc[4][4] = {};
      mm4x4(acc, sC, ldc, sS, kLd, n, ty, tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int l = i0 + 4 * ty + r;
        const float e = l < chunk ? expf(sCum[l]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= e;
      }

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        __syncthreads();
        for (int idx = tid; idx < kT * n; idx += kThreads) {
          const int j = idx / n, nn = idx - j * n;
          const int l = j0 + j;
          sBT[nn * kLd + j] = (l < chunk && t0 + l < s)
              ? bbm[static_cast<int64_t>(t0 + l) * n + nn] : 0.f;
        }
        for (int idx = tid; idx < kT * kT; idx += kThreads) {
          const int j = idx / kT, pp = idx - j * kT;
          const int l = j0 + j;
          sX[j * kLd + pp] = (l < chunk && t0 + l < s && p0 + pp < p)
              ? xb[static_cast<int64_t>(t0 + l) * x_row + pp] : 0.f;
        }
        __syncthreads();

        // Gate tile: (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i.
        float g[4][4] = {};
        mm4x4(g, sC, ldc, sBT, kLd, n, ty, tx);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int li = i0 + 4 * ty + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int lj = j0 + 4 * tx + c;
            sG[(4 * ty + r) * kLd + 4 * tx + c] =
                (li < chunk && lj <= li)
                    ? g[r][c] * expf(sCum[li] - sCum[lj]) * sDt[lj]
                    : 0.f;
          }
        }
        __syncthreads();
        mm4x4(acc, sG, kLd, sX, kLd, kT, ty, tx);   // intra-chunk term

        if (it == n_tiles - 1) {
          // State update: upd[n][p] += sum_j B_j[n] w_j x_j[p].
#pragma unroll
          for (int ng = 0; ng < NG; ++ng) {
            const int nrow = ng * kT + 4 * ty;
#pragma unroll 4
            for (int k = 0; k < kT; ++k) {
              const float4 xv =
                  *reinterpret_cast<const float4*>(sX + k * kLd + 4 * tx);
              const float w = j0 + k < chunk ? sW[j0 + k] : 0.f;
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const float bw =
                    nrow + r < n ? sBT[(nrow + r) * kLd + k] * w : 0.f;
                upd[ng][r][0] += bw * xv.x;
                upd[ng][r][1] += bw * xv.y;
                upd[ng][r][2] += bw * xv.z;
                upd[ng][r][3] += bw * xv.w;
              }
            }
          }
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int l = i0 + 4 * ty + r;
        if (l >= chunk || t0 + l >= s) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int pp = 4 * tx + c;
          if (p0 + pp < p)
            yb[static_cast<int64_t>(t0 + l) * x_row + pp] = acc[r][c];
        }
      }
    }

    __syncthreads();   // every read of the old state is done
    const float et = expf(total);
#pragma unroll
    for (int ng = 0; ng < NG; ++ng)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int nn = ng * kT + 4 * ty + r;
        if (nn >= n) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* st = sS + nn * kLd + 4 * tx + c;
          *st = __fadd_rn(__fmul_rn(*st, et), upd[ng][r][c]);
        }
      }
  }

  __syncthreads();
  float* fb = fin + (static_cast<int64_t>(bb) * h + hh) * p * n;
  for (int idx = tid; idx < kT * n; idx += kThreads) {
    const int pp = idx / n, nn = idx - pp * n;
    if (p0 + pp < p)
      fb[static_cast<int64_t>(p0 + pp) * n + nn] = sS[nn * kLd + pp];
  }
}

template <int NG>
int launch(const void* x, const void* dt, const void* a_log, const void* b,
           const void* c, void* y, void* fin, int bsz, int s, int h, int p,
           int n, int chunk, cudaStream_t stream) {
  const size_t floats = static_cast<size_t>(kT) * (n + 4) +
                        2 * static_cast<size_t>(n) * kLd +
                        2 * static_cast<size_t>(kT) * kLd +
                        3 * static_cast<size_t>(chunk);
  const int bytes = static_cast<int>(floats * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p + kT - 1) / kT, h, bsz);
  ssd_kernel<NG><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(y),
      static_cast<float*>(fin),
      s, h, p, n, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, S, H, P); dt: (B, S, H); a_log: (H,); b, c: (B, S, 1, N);
// y: (B, S, H, P); fin: (B, H, P, N), all float32 and contiguous;
// 1 <= N <= 128, 1 <= chunk <= 1024.
extern "C" int ssd_launch(const void* x, const void* dt, const void* a_log,
                          const void* b, const void* c, void* y, void* fin,
                          int bsz, int s, int h, int p, int n, int chunk,
                          void* stream) {
  if (bsz <= 0 || h <= 0 || p <= 0) return 0;
  if (n <= 0 || n > 128 || chunk <= 0 || chunk > 1024 || s < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return n <= 64 ? launch<1>(x, dt, a_log, b, c, y, fin, bsz, s, h, p, n,
                             chunk, st)
                 : launch<2>(x, dt, a_log, b, c, y, fin, bsz, s, h, p, n,
                             chunk, st);
}
