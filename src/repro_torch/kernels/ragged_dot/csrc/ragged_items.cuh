// The work items of the grouped product's row-tiled kernels
// (ragged_dot.cu's mma.sync and fp32 routes, ragged_dot_bwd.cu's dx
// kernels), read from the group offsets on the card.

#pragma once

// This block's work item, the blockIdx.y-th (segment, row tile) pair in
// row order, into item = {segment, tile's first row, lo, hi}; false when
// there is none (the grid counts the most there can be).  Segment 0 is
// the rows before offsets[0], segment s in [1, groups] group s - 1,
// segment groups + 1 the rows past offsets[groups]; the first and last
// are written as zeros.  Each segment starts where the one before it
// ended (offsets that go down make empty groups), so every row belongs
// to exactly one.  Thread 0 walks the offsets; the block reads item.
template <int TILE>
__device__ __forceinline__ bool find_item(const int* __restrict__ offsets,
                                          int m, int groups, int (&item)[4]) {
  if (threadIdx.x == 0) {
    int left = blockIdx.y, found = -1, prev = 0;
    for (int sg = 0; sg <= groups + 1 && found < 0; ++sg) {
      int lo = sg == 0 ? 0 : offsets[sg - 1];
      int hi = sg == 0 ? offsets[0] : sg <= groups ? offsets[sg] : m;
      lo = min(max(lo, prev), m);
      hi = min(max(hi, lo), m);
      prev = hi;
      if (lo >= hi) continue;
      const int t0 = lo / TILE, count = (hi - 1) / TILE - t0 + 1;
      if (left < count) {
        found = sg;
        item[1] = (t0 + left) * TILE;
        item[2] = max(lo, item[1]);
        item[3] = min(hi, item[1] + TILE);
      }
      left -= count;
    }
    item[0] = found;
  }
  __syncthreads();
  return item[0] >= 0;
}
