// The shared pieces of the grouped product's TMA + wgmma kernels
// (ragged_dot.cu's forward, ragged_dot_bwd.cu's dx and dw): the group
// edges and the persistent grid's work items, read from the offsets on
// the card; weight pairs as bf16 registers of wgmma's A fragments; and the
// host's SM count and tensor-map encoder (the fp32 kernels' too:
// ragged_tf32.cuh).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tc {

constexpr int kBW = 128;          // output columns of an item: 64 a warpgroup
constexpr int kMaxGroups = 1024;  // the group edges a block keeps in smem

// Two weights (lower index first) as one register of bf16 pairs; fp32
// rounds to nearest even.
__device__ __forceinline__ uint32_t pack2(const float* p0, const float* p1) {
  __nv_bfloat162 v = __floats2bfloat162_rn(*p0, *p1);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(const __nv_bfloat16* p0,
                                          const __nv_bfloat16* p1) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p0)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p1))
          << 16);
}

// With edge[j] = offsets[j] for j <= groups, one warp turns them into
// min(max(0, offsets[0..j]), m): group g is then the rows
// [edge[g], edge[g + 1]), as the plain version clamps them; segment 0 is
// [0, edge[0]) and segment groups + 1 is [edge[groups], m).
__device__ __forceinline__ void scan_edges(int* edge, int groups, int m,
                                           int lane) {
  int carry = 0;
  for (int base = 0; base <= groups; base += 32) {
    const int j = base + lane;
    int v = j <= groups ? edge[j] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v = max(v, u);
    }
    v = max(v, carry);
    if (j <= groups) edge[j] = min(v, m);
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
  __syncwarp();
}

// After scan_edges, one warp writes cum[s] = the items before segment s
// (segment s: its rows in tiles of BX, times col_tiles column tiles).
template <int BX>
__device__ __forceinline__ void count_items(const int* edge, int* cum,
                                            int groups, int m, int col_tiles,
                                            int lane) {
  int total = 0;
  for (int base = 0; base < groups + 2; base += 32) {
    const int s = base + lane;
    int c = 0;
    if (s < groups + 2) {
      const int lo = s == 0 ? 0 : edge[s - 1];
      const int hi = s <= groups ? edge[s] : m;
      c = (hi - lo + BX - 1) / BX * col_tiles;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, c, o);
      if (lane >= o) c += u;
    }
    if (s < groups + 2) cum[s + 1] = total + c;
    total += __shfl_sync(0xffffffffu, c, 31);
  }
  if (lane == 0) cum[0] = 0;
}

struct Item {
  int seg, r0, r_end, n0;   // segment, rows [r0, r_end), columns n0..+127
};

// Item i: the segment s with cum[s] <= i < cum[s + 1] (binary search;
// segment s is the rows [start(s), end(s)) above), then the column tile
// and the row tile of BX rows, row tile fastest.
template <int BX>
__device__ __forceinline__ Item item_at(int i, const int* cum,
                                        const int* edge, int groups, int m) {
  int lo = 0, hi = groups + 2;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] <= i) lo = mid;
    else hi = mid;
  }
  const int start = lo == 0 ? 0 : edge[lo - 1];
  const int end = lo <= groups ? edge[lo] : m;
  const int row_tiles = (end - start + BX - 1) / BX;
  const int local = i - cum[lo];
  const int ct = local / row_tiles, rt = local - ct * row_tiles;
  Item it;
  it.seg = lo;
  it.r0 = start + rt * BX;
  it.r_end = min(it.r0 + BX, end);
  it.n0 = ct * kBW;
  return it;
}

// The current device's SM count into sms; 0 or the CUDA error.
inline int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint (the
// library does not link libcuda), or null.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 2-D (cols, rows) or 3-D (cols, rows, mats) tensor map with 128-byte
// swizzled boxes (box_cols of 128 bytes a row); 0 or the CUresult.
inline int encode(CUtensorMap* map, const void* base, bool fp32, int rank,
                  const cuuint64_t* dims, const cuuint64_t* strides,
                  const cuuint32_t* box) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint32_t ones[3] = {1, 1, 1};
  return static_cast<int>(enc(
      map,
      fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      rank, const_cast<void*>(base), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

}  // namespace tc
}  // namespace
