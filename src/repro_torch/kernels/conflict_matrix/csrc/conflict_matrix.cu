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
//   0.045 ms of device time a call at n = 16656 (the OR kernel 0.020
//   ms, 1.9x the bytes bound; the plan's aminmax 0.017), where the pair
//   predicate took 0.287 ms.  A wrapper call takes 0.14-0.18 ms: the
//   plan's aminmax is read back to size the table, and its four
//   launches are host-bound.
// Design of the dense kernel: it evaluates the pair predicate, a
// formulation independent of the packed kernels' (no mask table, no
// group ids), so each checks the other.  Its 277 MB of stores at
// n = 16656 bind it, so the design keeps everything else off their way:
// - Each lane owns 16 columns of a 512-column strip and holds them in
//   registers for a block's whole sweep as two folded words: the op,
//   and a place word that equals another vertex's iff both have the
//   same place:
//     TIN/TOUT  kind << 30 | (m & 0x3fff) << 16 | (port & 0xffff)
//     QUAD      2 << 30 | (m & 0x3fff) << 16 | (pe_r & 0xff) << 8
//               | (pe_c & 0xff)
//     no place  3 << 30 | the vertex's index (equal to no other vertex)
//   exact while m fits 14 signed bits, port 16 and pe_r, pe_c 8 (and the
//   index 30 unsigned bits).  A pair then costs two compares into one
//   predicate and a select into its byte (`pair_bit`): conflict =
//   op_i == op_j || place_i == place_j, the diagonal cleared at the
//   store.  A block stages its strip once (coalesced uint4 loads of the
//   32-byte feature rows into shared memory), folds each column once,
//   and its 8 warps load the same 16 folded columns a lane.
// - A tile is 32 rows of the strip.  Its rows are loaded one tile ahead
//   (uint4 halves joined by a shuffle), folded into shared memory
//   (double-buffered) and reach a warp's lanes as one broadcast load a
//   row.  The tile's one barrier also ANDs the range test over its rows
//   and the strip's columns: a tile whose fields all fit takes the
//   folded loop, any other the general loop, which compares the fields
//   themselves (`conflicts`).  Both are exact device code; the host
//   reads nothing back to choose.
// - Banded schedule: block b keeps strip b % strips and takes row tiles
//   b / strips, + bands, + 2 bands, ..., with bands = resident blocks /
//   strips, so that at any time the blocks write one band of rows across
//   the full width.  Stores spread over the whole matrix at once (each
//   block on its own run of rows) wrote markedly slower than one band
//   at a time; the stores' own pattern still holds the kernel above a
//   contiguous write of the same bytes (chip_smoke.py's write floor).
// - A warp writes a row's 512 columns as one contiguous run of 16-byte
//   streaming stores (st.global.cs: the output is five times the L2).
//   The output has a pitch of n rounded up to 16 bytes (the wrapper
//   hands back the [n, n] slice), so every run is 16-byte aligned;
//   columns j >= n are zero up to the pitch.
// - Output offsets are 64-bit (i * n overflows int32 past n = 46340).
//   Measured (chip_smoke.py's times phase, H100 80GB HBM3 at 700 W):
//   0.110 ms of device time at n = 16656, 1.3x the bytes bound, where
//   the first design (a block of 16 rows, six shared loads a pair) took
//   0.398 ms.
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

// The predicate on two feature rows, each as its two uint4 halves
// (kind, op, m, port) and (pe_r, pe_c, mode, drive), without the i != j
// and j < n masks.
__device__ __forceinline__ bool conflicts(uint4 ra, uint4 rb, uint4 ca,
                                          uint4 cb) {
  const int kind = static_cast<int>(ra.x);
  const bool port_kind = kind == kTin || kind == kTout;
  const bool quad_kind = kind == kQuad;
  const bool same_place = (port_kind & (ra.w == ca.w)) |
                          (quad_kind & (rb.x == cb.x) & (rb.y == cb.y));
  return (ra.y == ca.y) | ((ra.x == ca.x) & (ra.z == ca.z) & same_place);
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
constexpr int kDenseThreads = 256;
constexpr int kDenseWarps = kDenseThreads / 32;          // 8
constexpr int kRun = 16;               // columns (bytes) a lane: one uint4
constexpr int kStrip = 32 * kRun;                        // 512 columns
constexpr int kTileRows = 32;
constexpr int kWarpRows = kTileRows / kDenseWarps;       // 4 a tile
// Signed bit widths of the slot, the TIN/TOUT port and each PE coordinate
// in the place word (ref.py's M_BITS, PORT_BITS, PE_BITS): bits 30-31 the
// kind, 16-29 the slot, 0-15 the port or the two PE coordinates.
constexpr int kMBits = 14;
constexpr int kPortBits = 16;
constexpr int kPeBits = 8;
static_assert(kMBits + 16 == 30 && kPortBits == 16 && 2 * kPeBits == 16,
              "the place word's fields must tile bits 0-29");
// A tile's rows are staged by whole warps (their halves meet by shuffle).
static_assert(kTileRows % kDenseWarps == 0 && (2 * kTileRows) % 32 == 0 &&
                  2 * kTileRows <= kDenseThreads,
              "a tile's rows must be staged by whole warps");
// The strip's features in shared memory: two uint4 a column, one spare
// uint4 after every 16 columns.
constexpr int kStage = 2 * kStrip + kStrip / kRun;
// The strip's folded words, (op, place) a column, two spare after every
// 16 columns so that lanes reading 16-byte pairs fall on distinct banks.
constexpr int kKeys = kStrip + 2 * (kStrip / kRun);

__device__ __forceinline__ int staged(int c, int half) {
  return 2 * c + half + c / kRun;
}

__device__ __forceinline__ int keyed(int c) { return c + 2 * (c / kRun); }

// x lies in [-2^(bits-1), 2^(bits-1)), so its low bits determine it.
__device__ __forceinline__ bool fits(uint32_t x, int bits) {
  return x + (1u << (bits - 1)) < (1u << bits);
}

// Vertex j's folded words (ref.py::fold_keys): its op, and a place word
// that two vertices share iff they have the same place.  Returns whether
// the fields fit the fold, which is then exact.
__device__ __forceinline__ bool fold(uint4 a, uint32_t pe_r, uint32_t pe_c,
                                     uint32_t j, uint32_t& op,
                                     uint32_t& place) {
  const int kind = static_cast<int>(a.x);
  const uint32_t m = a.z, port = a.w;
  op = a.y;
  if (kind == kTin || kind == kTout) {
    place = static_cast<uint32_t>(kind) << 30 |
            (m & ((1u << kMBits) - 1)) << 16 |
            (port & ((1u << kPortBits) - 1));
    return fits(m, kMBits) & fits(port, kPortBits);
  }
  if (kind == kQuad) {
    place = 2u << 30 | (m & ((1u << kMBits) - 1)) << 16 |
            (pe_r & ((1u << kPeBits) - 1)) << kPeBits |
            (pe_c & ((1u << kPeBits) - 1));
    return fits(m, kMBits) & fits(pe_r, kPeBits) & fits(pe_c, kPeBits);
  }
  place = 3u << 30 | j;
  return j < (1u << 30);
}

// kBit where the folded pair conflicts (op_i == op_j or place_i ==
// place_j), else 0: two compares into one predicate and a select, which
// the compiler would otherwise spend five instructions on.
template <uint32_t kBit>
__device__ __forceinline__ uint32_t pair_bit(uint32_t op_i, uint32_t place_i,
                                             uint32_t op_j,
                                             uint32_t place_j) {
  uint32_t r;
  asm("{\n\t.reg .pred p;\n\t"
      "setp.eq.u32 p, %1, %2;\n\t"
      "setp.eq.or.u32 p, %3, %4, p;\n\t"
      "selp.b32 %0, %5, 0, p;\n\t}"
      : "=r"(r)
      : "r"(op_i), "r"(op_j), "r"(place_i), "r"(place_j), "n"(kBit));
  return r;
}

// The uint4 that thread tid stages of the rows of the tile at r0: half
// tid % 2 of row r0 + tid / 2 (zero past n).
__device__ __forceinline__ uint4 load_half(const uint4* __restrict__ feat,
                                           int r0, int n, int tid) {
  if (tid >= 2 * kTileRows || r0 + tid / 2 >= n)
    return make_uint4(0, 0, 0, 0);
  return feat[2ll * r0 + tid];
}

// feat: the [n, 8] rows as 2n uint4.  Block b sweeps strip b % strips
// over row tiles b / strips, + bands, + 2 bands, ...: at any time the
// blocks write one band of rows across the full width, so that the
// stores stay close together in memory.
__global__ void __launch_bounds__(kDenseThreads, 2)
conflict_matrix_dense_kernel(const uint4* __restrict__ feat,
                             int8_t* __restrict__ out, int n, int pitch,
                             int strips, int bands) {
  __shared__ uint4 cols[kStage];
  __shared__ __align__(16) uint2 col_keys[kKeys];
  __shared__ uint4 rows_raw[2][2 * kTileRows];
  __shared__ uint2 row_keys[2][kTileRows];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = static_cast<int>(blockIdx.x % strips) * kStrip;
  const int first = static_cast<int>(blockIdx.x / strips);
  const int row_tiles = (n + kTileRows - 1) / kTileRows;
  const int cb = j0 + kRun * lane;       // this lane's first column

  // Thread tid < 2 kTileRows loads its half of a tile's rows one tile
  // ahead, so that the load overlaps the tile before.
  uint4 ahead = load_half(feat, first * kTileRows, n, tid);

  // Stage the strip, fold each column once, and load this lane's 16
  // folded columns into registers for the whole sweep.
  for (int u = tid; u < 2 * kStrip; u += kDenseThreads)
    cols[u + u / (2 * kRun)] =
        j0 + u / 2 < n ? feat[2ll * j0 + u] : make_uint4(0, 0, 0, 0);
  __syncthreads();
  bool cols_fit = true;
  for (int c = tid; c < kStrip; c += kDenseThreads) {
    const uint4 b = cols[staged(c, 1)];
    uint2 key;
    cols_fit &= fold(cols[staged(c, 0)], b.x, b.y, j0 + c, key.x, key.y);
    col_keys[keyed(c)] = key;
  }
  cols_fit = __syncthreads_and(cols_fit);
  uint32_t cop[kRun], cplace[kRun];
#pragma unroll
  for (int k = 0; k < kRun; k += 2) {
    const uint4 two = *reinterpret_cast<const uint4*>(
        &col_keys[keyed(kRun * lane + k)]);
    cop[k] = two.x;
    cplace[k] = two.y;
    cop[k + 1] = two.z;
    cplace[k + 1] = two.w;
  }

#pragma unroll 1
  for (int rt = first, buf = 0; rt < row_tiles; rt += bands, buf ^= 1) {
    // The tile's rows: lanes 2r and 2r + 1 hold row r0 + r's halves;
    // the buffers alternate, so one barrier a tile orders them.
    const int r0 = rt * kTileRows;
    bool fit = cols_fit;
    if (tid < 2 * kTileRows) {
      const uint4 u = ahead;
      rows_raw[buf][tid] = u;
      const uint32_t pe_r = __shfl_down_sync(0xffffffffu, u.x, 1);
      const uint32_t pe_c = __shfl_down_sync(0xffffffffu, u.y, 1);
      if ((tid & 1) == 0) {
        uint2 key;
        fit &= fold(u, pe_r, pe_c, r0 + tid / 2, key.x, key.y);
        row_keys[buf][tid / 2] = key;
      }
    }
    const bool folded = __syncthreads_and(fit);
    if (rt + bands < row_tiles)
      ahead = load_half(feat, (rt + bands) * kTileRows, n, tid);
    if (cb >= pitch) continue;

#pragma unroll 1
    for (int q = 0; q < kWarpRows; ++q) {
      const int r = warp + kDenseWarps * q;
      const int i = r0 + r;
      if (i >= n) break;
      uint32_t v[4];
      if (folded) {
        const uint2 key = row_keys[buf][r];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int k = 4 * w;
          v[w] = pair_bit<1u>(key.x, key.y, cop[k], cplace[k]) |
                 pair_bit<1u << 8>(key.x, key.y, cop[k + 1],
                                   cplace[k + 1]) |
                 pair_bit<1u << 16>(key.x, key.y, cop[k + 2],
                                    cplace[k + 2]) |
                 pair_bit<1u << 24>(key.x, key.y, cop[k + 3],
                                    cplace[k + 3]);
        }
      } else {
        // Four columns at a time (the words rotate through v), so that
        // the 32 folded words stay in registers beside the fields.
        const uint4 ra = rows_raw[buf][2 * r], rb = rows_raw[buf][2 * r + 1];
        v[0] = v[1] = v[2] = v[3] = 0u;
#pragma unroll 1
        for (int w = 0; w < 4; ++w) {
          uint32_t x = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int c = kRun * lane + 4 * w + b;
            x |= static_cast<uint32_t>(conflicts(
                     ra, rb, cols[staged(c, 0)], cols[staged(c, 1)]))
                 << (8 * b);
          }
          v[0] = v[1];
          v[1] = v[2];
          v[2] = v[3];
          v[3] = x;
        }
      }
      // Bytes past n and the diagonal cleared, then one streaming 16-byte
      // store.
      const int valid = n - cb;
      const unsigned diag = static_cast<unsigned>(i - cb);
      if (valid < kRun || diag < kRun) {
#pragma unroll
        for (int c = 0; c < kRun; ++c)
          if (c >= valid || static_cast<unsigned>(c) == diag)
            v[c / 4] &= ~(0xffu << (8 * (c % 4)));
      }
      __stcs(reinterpret_cast<uint4*>(out + static_cast<size_t>(i) * pitch +
                                      cb),
             make_uint4(v[0], v[1], v[2], v[3]));
    }
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
// and pitch >= n, both contiguous on the device and 16-byte aligned.
// Columns n..pitch-1 are written as zero.
extern "C" int conflict_matrix_launch(const void* feat, void* out, int n,
                                      int pitch, void* stream) {
  if (n <= 0) return 0;
  if (pitch < n || pitch % kRun != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(feat) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conflict_matrix_dense_kernel, kDenseThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  // As many bands (blocks a strip) as fill the resident blocks, at least
  // one and at most one a row tile.
  const int row_tiles = (n + kTileRows - 1) / kTileRows;
  const int strips = (pitch + kStrip - 1) / kStrip;
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  long long bands = resident / strips;
  if (bands < 1) bands = 1;
  if (bands > row_tiles) bands = row_tiles;
  const long long grid = bands * strips;
  if (grid > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  conflict_matrix_dense_kernel<<<static_cast<unsigned>(grid), kDenseThreads,
                                 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(feat), static_cast<int8_t*>(out), n, pitch,
      strips, static_cast<int>(bands));
  return static_cast<int>(cudaGetLastError());
}
