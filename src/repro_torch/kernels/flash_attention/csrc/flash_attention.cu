// Forward flash attention on fp32 inputs: GQA, causal from q_offset,
// optional sliding window, fp32 online softmax.
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
// visible key gives 0, as the plain version's guards give.
//
// Bound.  fp32 attention lies on no path of the port (the no-cache
// forward runs in bf16).  Its 2e-6 tolerance rules out bf16 and TF32
// products, so it is bound by the fp32 rate: at (1, 8192, 32, 64),
// causal, 2.75e11 FLOP take 4.1 ms at 67e12 FLOP/s.
//
// Design (simple and right; no tensor cores):
// - One block of 256 threads per (query tile of 64 rows, query head,
//   batch).  It loops over key tiles of 64 only from the window's edge
//   to the causal edge of its last row (the TPU kernel's `visible`
//   test), and masks element by element inside a tile.
// - q (scaled), k^T and v tiles are staged in shared memory as fp32.
//   Each thread owns a 4 x 4 block of the 64 x 64 score tile and a
//   4 x 4 block (per 64 columns of D) of the output: S = Q K^T and
//   acc += P V are register-tiled products, 16 FMAs per 4 scalar and
//   one 16-byte shared-memory load.  Row pitches of D + 4 and 68 floats
//   keep the two row groups of a warp on different banks.
// - m, l and acc stay in registers across key tiles; a row's max and
//   sum over the tile are reduced across the 16 threads that share the
//   row with xor shuffles.
// - Offsets are 64-bit: B * S * H * D passes 2^31 at long contexts.
// - D up to 256, the largest head dim of the repository's configs: the
//   output's column groups of 64 are a template argument (CG = 1-4).  At
//   D = 256 a block takes 220,160 bytes of shared memory, one block an
//   SM.
//
// The launcher is a plain C function (no PyTorch headers) that returns
// cudaGetLastError, so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLdT = kBK + 4;  // pitch of the k^T and P tiles

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

// CG: column groups of 64 in D (D <= 64 CG, up to 4 for D <= 256).
template <int CG>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int sq, int sk,
          int hq, int hkv, int d, int q_offset, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldq = d + 4;
  const int ldv = CG * 64 + 4;
  float* sQ = smem;                 // [kBQ][ldq]   q * scale
  float* sK = sQ + kBQ * ldq;       // [d][kLdT]    k^T
  float* sV = sK + d * kLdT;        // [kBK][ldv]   v, zero past d
  float* sP = sV + kBK * ldv;       // [kBQ][kLdT]  probabilities

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
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

  for (int idx = tid; idx < kBQ * d; idx += kThreads) {
    const int i = idx / d, dd = idx - i * d;
    const int qi = q0 + i;
    sQ[i * ldq + dd] = qi < sq ? qb[qi * q_row + dd] * scale : 0.f;
  }

  float m[4], l[4], acc[CG][4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int g = 0; g < CG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][r][c] = 0.f;
  }

  // Visible keys of this tile: [k_begin, k_end).
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, sq) - 1;
  const int k_end = min(sk, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;

  for (int j0 = k_begin; j0 < k_end; j0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < kBK * d; idx += kThreads) {
      const int j = idx / d, dd = idx - j * d;
      const int kj = j0 + j;
      sK[dd * kLdT + j] = kj < sk ? kb[kj * k_row + dd] : 0.f;
    }
    for (int idx = tid; idx < kBK * CG * 64; idx += kThreads) {
      const int j = idx / (CG * 64), dd = idx - j * (CG * 64);
      const int kj = j0 + j;
      sV[j * ldv + dd] =
          (kj < sk && dd < d) ? vb[kj * k_row + dd] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {};
    mm4x4(s, sQ, ldq, sK, kLdT, d, ty, tx);

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + 4 * ty + r;
      const int qp = q_offset + qi;
      bool ok[4];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = j0 + 4 * tx + c;
        ok[c] = qi < sq && kp < sk && qp >= kp &&
                (window <= 0 || qp - kp < window);
        if (ok[c]) mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_safe) : 0.f;
        sP[(4 * ty + r) * kLdT + 4 * tx + c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = m[r] == -INFINITY ? 0.f : expf(m[r] - m_safe);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int g = 0; g < CG; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[g][r][c] *= corr;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < CG; ++g)
      mm4x4(acc[g], sP, kLdT, sV + g * 64, ldv, kBK, ty, tx);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + 4 * ty + r;
    if (qi >= sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int g = 0; g < CG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int dd = g * 64 + 4 * tx + c;
        if (dd < d) ob[qi * q_row + dd] = acc[g][r][c] / den;
      }
  }
}

template <int CG>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int sk, int hq, int hkv, int d, int q_offset, int window,
           float scale, cudaStream_t stream) {
  const size_t floats = static_cast<size_t>(kBQ) * (d + 4) +
                        static_cast<size_t>(d) * kLdT +
                        static_cast<size_t>(kBK) * (CG * 64 + 4) +
                        static_cast<size_t>(kBQ) * kLdT;
  const int bytes = static_cast<int>(floats * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<CG>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  fa_kernel<CG><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, hq, hkv, d,
      q_offset, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); o: (B, Sq, Hq, D), all
// contiguous float32; 1 <= D <= 256, Hq % Hkv == 0, window <= 0 means
// none.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      int b, int sq, int sk, int hq,
                                      int hkv, int d, int q_offset,
                                      int window, float scale,
                                      void* stream) {
  if (b <= 0 || sq <= 0 || hq <= 0) return 0;
  if (d <= 0 || d > 256 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 63) / 64) {
    case 1:
      return launch<1>(q, k, v, o, b, sq, sk, hq, hkv, d, q_offset, window,
                       scale, s);
    case 2:
      return launch<2>(q, k, v, o, b, sq, sk, hq, hkv, d, q_offset, window,
                       scale, s);
    case 3:
      return launch<3>(q, k, v, o, b, sq, sk, hq, hkv, d, q_offset, window,
                       scale, s);
    default:
      return launch<4>(q, k, v, o, b, sq, sk, hq, hkv, d, q_offset, window,
                       scale, s);
  }
}
