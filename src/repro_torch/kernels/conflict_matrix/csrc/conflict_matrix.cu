// The conflict-matrix kernels: the occupancy/clique predicate of the
// conflict graph over every vertex pair (i, j), from the int32 [n, 8]
// feature rows that kernels/conflict_matrix/ref.py::encode builds:
//
//   conflict(i, j) = i != j && (op_i == op_j
//                    || (kind_i == kind_j && m_i == m_j
//                        && ((kind_i is TIN or TOUT) && port_i == port_j
//                            || kind_i is QUAD && pe_i == pe_j)))
//
// which is ref.py::conflict_matrix_ref's "same op, or both TIN / both
// TOUT with the same port and slot, or both QUAD with the same PE and
// slot", regrouped so that the kind tests on i are made once per row.
// Columns 6-7 (mode, drive) are never read.
//
// - conflict_matrix_packed_kernel replaces
//   repro/kernels/conflict_matrix/kernel.py::conflict_matrix_packed_pallas
//   (body _cm_packed_kernel): int32 [n, w32] words, bit j % 32 of word
//   j / 32 is column j (little-endian), so the host views word pairs as
//   the uint64 rows of BitsetGraph.  The wrapper passes w32 = 2 *
//   ceil(n / 64); columns j >= n are zero.
// - conflict_matrix_dense_kernel replaces
//   repro/kernels/conflict_matrix/kernel.py::conflict_matrix_pallas
//   (body _cm_kernel): int8 [n, n], 1 where the pair conflicts.
//
// Bound.  The function's floor is its traffic: the features read once
// (32 bytes a vertex) and the output written once, n^2 bytes dense and
// n * 2 * ceil(n / 64) * 4 bytes packed (277 MB and 35 MB at n = 16656).
// The predicate needs few operations: it is the union of three
// equivalence relations (same op; same kind, slot and port for TIN and
// TOUT; same slot and PE for QUAD), so each output word is the OR of at
// most three group masks with the diagonal cleared, a few operations
// per 32-bit word, and bytes bind both kernels.  These kernels evaluate
// the pair predicate instead (about 13 operations a pair), which is
// what keeps the packed one far above its bound.
// Design (simple and right first; no tuning yet):
// - packed: a block of 8 warps owns 64 rows and 32 output words (1024
//   columns).  It stages the tile's columns' six fields in shared
//   memory, one array per field, so lane l of a warp reads column
//   32 w + l without bank conflicts; each warp keeps its 8 rows'
//   fields in registers.  For word w, the warp evaluates 32 columns,
//   one per lane, and __ballot_sync gives exactly the word; lane w
//   keeps it, and after the 32 words every lane stores one word of
//   each row: 128 contiguous bytes per row and warp, each word written
//   once.
// - dense: a block of 64 x 4 threads owns 16 rows and 1024 columns.
//   The output has a pitch of n rounded up to 16 bytes (the wrapper
//   hands back the [n, n] slice), so every run of 16 columns of a row
//   is 16-byte aligned and is stored as one uint4; columns j >= n of
//   the last run are zero.  The staged columns are held with one spare
//   word after every 16, so the lanes' stride of 16 columns falls on
//   distinct banks.
// - Output offsets are 64-bit (i * n overflows int32 past n = 46340).
// The launchers run on the caller's stream, launch nothing for n = 0,
// and return cudaGetLastError so that a refused launch is reported.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTin = 0;
constexpr int kTout = 1;
constexpr int kQuad = 2;
constexpr int kFeatures = 8;   // int32 fields per vertex row
constexpr int kFields = 6;     // kind, op, m, port, pe_r, pe_c

// The fields of row i that the predicate reads, with its kind tests.
struct Row {
  int kind, op, m, port, pe_r, pe_c;
  bool port_kind, quad_kind;
};

__device__ __forceinline__ Row load_row(const int32_t* __restrict__ feat,
                                        int i) {
  const int32_t* f = feat + static_cast<size_t>(i) * kFeatures;
  Row r;
  r.kind = f[0];
  r.op = f[1];
  r.m = f[2];
  r.port = f[3];
  r.pe_r = f[4];
  r.pe_c = f[5];
  r.port_kind = r.kind == kTin || r.kind == kTout;
  r.quad_kind = r.kind == kQuad;
  return r;
}

// The predicate without the i != j and j < n masks.
__device__ __forceinline__ bool conflicts(const Row& a, int kind, int op,
                                          int m, int port, int pe_r,
                                          int pe_c) {
  const bool same_place = (a.port_kind & (a.port == port)) |
                          (a.quad_kind & (a.pe_r == pe_r) & (a.pe_c == pe_c));
  return (a.op == op) | ((a.kind == kind) & (a.m == m) & same_place);
}

// ------------------------------------------------------------ packed
constexpr int kPackedWarps = 8;
constexpr int kPackedRowsPerWarp = 8;
constexpr int kPackedRows = kPackedWarps * kPackedRowsPerWarp;  // 64
constexpr int kPackedWords = 32;                                // per tile
constexpr int kPackedCols = kPackedWords * 32;                  // 1024

__global__ void __launch_bounds__(kPackedWarps * 32)
conflict_matrix_packed_kernel(const int32_t* __restrict__ feat,
                              uint32_t* __restrict__ out, int n, int w32) {
  __shared__ int32_t cols[kFields][kPackedCols];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i0 = blockIdx.x * kPackedRows + warp * kPackedRowsPerWarp;
  const int word0 = blockIdx.y * kPackedWords;
  const int j0 = word0 * 32;

  for (int t = threadIdx.x; t < kPackedCols; t += blockDim.x) {
    const int j = j0 + t;
    const int32_t* f = feat + static_cast<size_t>(j < n ? j : 0) * kFeatures;
#pragma unroll
    for (int c = 0; c < kFields; ++c) cols[c][t] = j < n ? f[c] : 0;
  }
  // Rows past n are evaluated (so that every lane of the warp takes
  // part in each ballot) on row n - 1's fields, and never stored.
  Row rows[kPackedRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kPackedRowsPerWarp; ++r)
    rows[r] = load_row(feat, min(i0 + r, n - 1));
  __syncthreads();

  uint32_t mine[kPackedRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kPackedRowsPerWarp; ++r) mine[r] = 0u;

#pragma unroll 1
  for (int w = 0; w < kPackedWords; ++w) {
    const int t = w * 32 + lane;
    const int j = j0 + t;
    const int kind = cols[0][t], op = cols[1][t], m = cols[2][t];
    const int port = cols[3][t], pe_r = cols[4][t], pe_c = cols[5][t];
    const bool in_range = j < n;
#pragma unroll
    for (int r = 0; r < kPackedRowsPerWarp; ++r) {
      const bool bit = in_range & (i0 + r != j) &
                       conflicts(rows[r], kind, op, m, port, pe_r, pe_c);
      const uint32_t word = __ballot_sync(0xffffffffu, bit);
      if (lane == w) mine[r] = word;
    }
  }

  const int word = word0 + lane;
#pragma unroll
  for (int r = 0; r < kPackedRowsPerWarp; ++r) {
    const int i = i0 + r;
    if (i < n && word < w32)
      out[static_cast<size_t>(i) * w32 + word] = mine[r];
  }
}

// ------------------------------------------------------------- dense
constexpr int kDenseRuns = 64;       // threads along a row (x)
constexpr int kDenseRowsY = 4;       // threads across rows (y)
constexpr int kDenseRowSteps = 4;    // rows per thread
constexpr int kDenseRows = kDenseRowsY * kDenseRowSteps;   // 16
constexpr int kRun = 16;             // bytes (columns) per run
constexpr int kDenseCols = kDenseRuns * kRun;              // 1024
constexpr int kDenseStage = kDenseCols + kDenseCols / kRun;

__device__ __forceinline__ int staged(int t) { return t + t / kRun; }

__global__ void __launch_bounds__(kDenseRuns * kDenseRowsY)
conflict_matrix_dense_kernel(const int32_t* __restrict__ feat,
                             int8_t* __restrict__ out, int n, int pitch) {
  __shared__ int32_t cols[kFields][kDenseStage];

  const int tid = threadIdx.y * kDenseRuns + threadIdx.x;
  const int j0 = blockIdx.y * kDenseCols;

  for (int t = tid; t < kDenseCols; t += kDenseRuns * kDenseRowsY) {
    const int j = j0 + t;
    const int32_t* f = feat + static_cast<size_t>(j < n ? j : 0) * kFeatures;
#pragma unroll
    for (int c = 0; c < kFields; ++c) cols[c][staged(t)] = j < n ? f[c] : 0;
  }
  __syncthreads();

  const int jstart = j0 + threadIdx.x * kRun;
  if (jstart >= n) return;
#pragma unroll 1
  for (int s = 0; s < kDenseRowSteps; ++s) {
    const int i = blockIdx.x * kDenseRows + s * kDenseRowsY + threadIdx.y;
    if (i >= n) break;
    const Row a = load_row(feat, i);
    uint32_t v[kRun / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int j = jstart + k;
      const int t = staged(threadIdx.x * kRun + k);
      const bool bit =
          (j < n) & (i != j) &
          conflicts(a, cols[0][t], cols[1][t], cols[2][t], cols[3][t],
                    cols[4][t], cols[5][t]);
      v[k / 4] |= static_cast<uint32_t>(bit) << (8 * (k % 4));
    }
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(i) * pitch +
                              jstart) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace

// feat: int32 [n, 8], out: uint32 [n, w32] (w32 >= ceil(n / 32)), both
// contiguous on the device; stream: the caller's cudaStream_t.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int conflict_matrix_packed_launch(const void* feat, void* out,
                                             int n, int w32, void* stream) {
  if (n <= 0 || w32 <= 0) return 0;
  const dim3 grid((n + kPackedRows - 1) / kPackedRows,
                  (w32 + kPackedWords - 1) / kPackedWords);
  conflict_matrix_packed_kernel<<<grid, kPackedWarps * 32, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(feat), static_cast<uint32_t*>(out), n,
      w32);
  return static_cast<int>(cudaGetLastError());
}

// feat: int32 [n, 8], out: int8 [n, pitch] with pitch a multiple of 16
// and pitch >= n, both contiguous on the device, out 16-byte aligned.
extern "C" int conflict_matrix_launch(const void* feat, void* out, int n,
                                      int pitch, void* stream) {
  if (n <= 0) return 0;
  if (pitch < n || pitch % kRun != 0 ||
      reinterpret_cast<uintptr_t>(out) % kRun != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid((n + kDenseRows - 1) / kDenseRows,
                  (pitch + kDenseCols - 1) / kDenseCols);
  const dim3 block(kDenseRuns, kDenseRowsY);
  conflict_matrix_dense_kernel<<<grid, block, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(feat), static_cast<int8_t*>(out), n,
      pitch);
  return static_cast<int>(cudaGetLastError());
}
