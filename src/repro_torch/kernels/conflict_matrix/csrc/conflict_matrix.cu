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
// slot".  Columns 6-7 (mode, drive) are never read.
//
// - The packed kernels replace
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
// The predicate is the union of two equivalence relations: same op; and
// same place (the same kind, slot and port for TIN and TOUT, the same
// slot and PE for QUAD; other kinds have none).  So each output word is
// the OR of at most two group masks with the diagonal cleared, a few
// operations per 32-bit word, and bytes bind both kernels.
//
// Design of the packed kernels (the OR of group masks; no pair is
// evaluated):
// - the wrapper gives each vertex an op id and a place id (-1: none),
//   rows of one mask table of (groups x w32) words that it has zeroed:
//   either ids it sorted, or the mixed-radix plan of ref.py::radix_plan,
//   from which conflict_groups_scatter_kernel computes them itself;
// - conflict_groups_scatter_kernel: one thread per vertex j.  The 32
//   lanes of a warp hold the vertices of one word; __match_any_sync
//   finds the lanes that share a group, and one of them ORs their lane
//   mask (their bits of that word) into the group's row: one atomicOr
//   per group present in the word;
// - conflict_groups_or_kernel: out[i, w] = M[op(i), w] | M[place(i), w]
//   with bit i cleared, two 32-bit words at a time, threads along w so
//   that loads and stores are coalesced.  The table (1-4 MB at 16x16)
//   stays in L2.
//   Measured (chip_smoke.py's times phase, H100 80GB HBM3 at 700 W):
//   0.026 ms of device time at n = 16656 (the OR kernel 0.020 ms, 1.9x
//   the bytes bound), where the pair predicate took 0.287 ms.  A
//   wrapper call takes ~0.14 ms: the plan's aminmax is read back to
//   size the table, and its four launches are host-bound.
// Design of the dense kernel (simple and right first; no tuning yet): it
// evaluates the pair predicate, a formulation independent of the
// packed kernels', so each checks the other.
// - a block of 64 x 4 threads owns 16 rows and 1024 columns.
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
// ref.py::radix_plan, in its order.
struct Plan {
  int lo_op, lo_m, lo_port, lo_pe_r, lo_pe_c;
  int r_op, r_m, r_port, r_pe_r, r_pe_c;
};

constexpr int kScatterThreads = 256;

// ids: int32 [2, n], op ids then place ids; computed from feat by the
// plan (radix != 0) or read as the wrapper wrote them.
__global__ void __launch_bounds__(kScatterThreads)
conflict_groups_scatter_kernel(const int32_t* __restrict__ feat,
                               int32_t* __restrict__ ids,
                               uint32_t* __restrict__ table, int n, int w32,
                               Plan pl, int radix) {
  const int j = blockIdx.x * kScatterThreads + threadIdx.x;
  int g[2] = {-1, -1};
  if (j < n) {
    if (radix) {
      const int32_t* f = feat + static_cast<size_t>(j) * kFeatures;
      const int kind = f[0];
      const int64_t dm = static_cast<int64_t>(f[2]) - pl.lo_m;
      g[0] = static_cast<int>(static_cast<int64_t>(f[1]) - pl.lo_op);
      if (kind == kTin || kind == kTout)
        g[1] = static_cast<int>(
            pl.r_op + (kind * pl.r_m + dm) * pl.r_port +
            (static_cast<int64_t>(f[3]) - pl.lo_port));
      else if (kind == kQuad)
        g[1] = static_cast<int>(
            pl.r_op + 2ll * pl.r_m * pl.r_port +
            (dm * pl.r_pe_r + (static_cast<int64_t>(f[4]) - pl.lo_pe_r)) *
                pl.r_pe_c +
            (static_cast<int64_t>(f[5]) - pl.lo_pe_c));
      ids[j] = g[0];
      ids[n + j] = g[1];
    } else {
      g[0] = ids[j];
      g[1] = ids[n + j];
    }
  }
  // The warp's 32 vertices are the bits of word j / 32 (a block starts
  // at a multiple of 32); lanes past n hold -1 and set nothing.
  const int lane = threadIdx.x & 31;
  const int word = j >> 5;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const uint32_t peers = __match_any_sync(0xffffffffu, g[r]);
    if (g[r] >= 0 && lane == __ffs(peers) - 1)
      atomicOr(table + static_cast<size_t>(g[r]) * w32 + word, peers);
  }
}

constexpr int kOrX = 64;   // threads along a row's words (pairs)
constexpr int kOrY = 4;    // rows per block and pass

// out[i, :] = table[op(i), :] | table[place(i), :] with bit i cleared,
// as uint2 (w64 = w32 / 2 word pairs a row).
__global__ void __launch_bounds__(kOrX * kOrY)
conflict_groups_or_kernel(const int32_t* __restrict__ ids,
                          const uint2* __restrict__ table,
                          uint2* __restrict__ out, int n, int w64) {
  const int w = blockIdx.x * kOrX + threadIdx.x;
  if (w >= w64) return;
  for (int i = blockIdx.y * kOrY + threadIdx.y; i < n;
       i += gridDim.y * kOrY) {
    const int a = ids[i], b = ids[n + i];
    uint2 v = table[static_cast<size_t>(a) * w64 + w];
    if (b >= 0) {
      const uint2 t = table[static_cast<size_t>(b) * w64 + w];
      v.x |= t.x;
      v.y |= t.y;
    }
    if (w == (i >> 6)) {
      const uint32_t clear = ~(1u << (i & 31));
      if (i & 32)
        v.y &= clear;
      else
        v.x &= clear;
    }
    out[static_cast<size_t>(i) * w64 + w] = v;
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

// feat: int32 [n, 8]; ids: int32 [2, n] (written here when radix != 0,
// else the op and place ids, place -1 for none); table: uint32
// [rows, w32], zeroed, with rows above every id; out: uint32 [n, w32]
// with w32 even and w32 >= ceil(n / 32); all contiguous on the device,
// table and out 8-byte aligned; the ten ints are ref.py::radix_plan's
// (unread when radix == 0).  Launches the scatter, then the OR, on the
// caller's stream.  Returns the cudaError_t of the launches.
extern "C" int conflict_matrix_packed_launch(
    const void* feat, void* ids, void* table, void* out, int n, int w32,
    int radix, int lo_op, int lo_m, int lo_port, int lo_pe_r, int lo_pe_c,
    int r_op, int r_m, int r_port, int r_pe_r, int r_pe_c, void* stream) {
  if (n <= 0 || w32 <= 0) return 0;
  if (w32 % 2 != 0 || reinterpret_cast<uintptr_t>(table) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan pl{lo_op, lo_m, lo_port, lo_pe_r, lo_pe_c,
                r_op, r_m, r_port, r_pe_r, r_pe_c};
  conflict_groups_scatter_kernel<<<(n + kScatterThreads - 1) /
                                       kScatterThreads,
                                   kScatterThreads, 0, s>>>(
      static_cast<const int32_t*>(feat), static_cast<int32_t*>(ids),
      static_cast<uint32_t*>(table), n, w32, pl, radix);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int w64 = w32 / 2;
  const int row_blocks = (n + kOrY - 1) / kOrY;
  const dim3 grid((w64 + kOrX - 1) / kOrX,
                  row_blocks < 65535 ? row_blocks : 65535);
  conflict_groups_or_kernel<<<grid, dim3(kOrX, kOrY), 0, s>>>(
      static_cast<const int32_t*>(ids), static_cast<const uint2*>(table),
      static_cast<uint2*>(out), n, w64);
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
