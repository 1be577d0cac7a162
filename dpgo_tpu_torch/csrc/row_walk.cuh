// The row-packed CSR walk shared by segsum.cu and edge_matvec.cu.
//
// Both kernels reduce, for each output row, a contiguous range of
// destination-sorted edges, [row_ptr[row], row_ptr[row + 1]), and both are
// latency-bound at the sizes the solver sends (about one edge per row): the
// chain row_ptr -> (index ->) edge data is a few dependent loads for a
// handful of flops. So they share one mapping of lanes onto rows:
//
//  * a row takes g lanes (g = w floats for the segment sum, g = r rows of
//    the r x dh block for the edge matvec): a warp holds floor(32 / g) rows
//    side by side, or one row and a loop over passes of 32 lanes when
//    g > 32;
//  * each warp takes K slots of such rows (template parameter), so one
//    thread has K independent chains in flight;
//  * a slot's rpw + 1 row pointers come in one coalesced load by lanes
//    0..rpw and reach each row's lanes by __shfl_sync.
//
// Rows past n read row_ptr[n] and so get an empty range; lanes past the
// packed rows (sub >= rpw) get an empty range too.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dpgo {

constexpr int kWarpSize = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpSize * kWarpsPerBlock;

// Rows of g lanes that share one warp in a slot. At most 31, so that a
// slot's rpw + 1 row pointers fit in one warp-wide load.
__host__ __device__ inline int rows_per_warp(int g) {
  return g <= kWarpSize ? (kWarpSize / g < kWarpSize - 1 ? kWarpSize / g
                                                         : kWarpSize - 1)
                        : 1;
}

// Blocks of kThreads for n rows of g lanes at K slots per warp.
inline int grid_blocks(int n, int g, int slots) {
  const int64_t rows_per_block =
      static_cast<int64_t>(rows_per_warp(g)) * slots * kWarpsPerBlock;
  return static_cast<int>((n + rows_per_block - 1) / rows_per_block);
}

// Where this lane sits: row `sub` of its slot (idle when sub >= rpw), its
// place `col` in the row, `passes` passes of 32 lanes (g > 32), and `lead`,
// the first lane of its row.
struct Lane {
  int lane, rpw, sub, col, passes, lead;
  __device__ Lane(int g) {
    lane = threadIdx.x % kWarpSize;
    rpw = rows_per_warp(g);
    if (g <= kWarpSize) {
      sub = lane / g;
      col = lane % g;
      passes = 1;
      lead = sub < rpw ? sub * g : 0;
    } else {
      sub = 0;
      col = lane;
      passes = (g + kWarpSize - 1) / kWarpSize;
      lead = 0;
    }
  }
  // First row of this warp; every slot holds rpw rows.
  template <int K>
  __device__ int64_t warp_base() const {
    const int64_t warp =
        (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) /
        kWarpSize;
    return warp * rpw * K;
  }
};

// [begin, end) of this lane's row in the slot whose first row is `first`.
// Every lane of the warp must call it (it shuffles).
__device__ __forceinline__ void row_range(const int32_t* __restrict__ row_ptr,
                                          int64_t first, int n, const Lane& l,
                                          int& begin, int& end) {
  int p = 0;
  if (l.lane <= l.rpw) {
    const int64_t r = first + l.lane;
    p = __ldg(row_ptr + (r < n ? r : n));
  }
  const int s = l.sub < l.rpw ? l.sub : l.rpw;
  begin = __shfl_sync(kFullMask, p, s);
  end = __shfl_sync(kFullMask, p, l.sub < l.rpw ? s + 1 : s);
}

}  // namespace dpgo
