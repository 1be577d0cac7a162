// CSR segment sum over destination-sorted rows, for Hopper (sm_90a).
//
//   out[r, c] = sum_{e in [row_ptr[r], row_ptr[r+1])} contrib[e, c]
//
// Replaces dpgo_tpu/ops/pallas_segsum.py::segment_sum_csr, a one-hot matmul
// per 1024-row output tile fed by DMA'd edge chunks; on this card that is
// wasted work, so this is a plain segmented reduction. The solver's matvec
// now runs the fused gather-multiply-reduce of edge_matvec.cu instead; this
// kernel stays the standalone counterpart of the TPU kernel.
//
// Bound by bytes: at the centralized 100k slice (n = 100,000 rows,
// m = 92,595 edges, w = 15 floats) one call reads 5.56 MB of contributions
// and 0.40 MB of row pointers and writes 6.00 MB: 3.57 us at 3.35 TB/s. With
// about one edge per row it is latency-bound instead: the walk of
// row_walk.cuh packs floor(32 / w) rows into each warp, loads a slot's row
// pointers in one coalesced load, and gives each thread kSlots rows so
// that their loads overlap (4 was the fastest of 1, 2 and 4 at w = 15;
// PERF.md). Each thread sums column c of its rows' contiguous edge ranges
// in edge order and writes out[r, c] once; empty rows get 0.
// No atomics and a fixed order, so two runs give identical bits.
//
// Plain C interface, bound from Python with ctypes (ops/segsum.py): raw
// pointers, sizes and the stream in, cudaGetLastError() out.

#include "row_walk.cuh"

namespace {

using namespace dpgo;

// Rows each thread walks (see the header comment).
constexpr int kSlots = 4;

template <int K>
__global__ void __launch_bounds__(kThreads)
segsum_csr_f32_kernel(const float* __restrict__ contrib,
                      const int32_t* __restrict__ row_ptr,
                      float* __restrict__ out, int n, int w) {
  const Lane l(w);
  const int64_t base = l.warp_base<K>();
  if (base >= n) return;  // uniform over the warp
  int begin[K], end[K];
  int most = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    row_range(row_ptr, base + k * l.rpw, n, l, begin[k], end[k]);
    most = max(most, end[k] - begin[k]);
  }
  for (int q = 0; q < l.passes; ++q) {
    const int c = l.col + q * kWarpSize;
    if (c >= w) break;
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;
    for (int t = 0; t < most; ++t) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = begin[k] + t;
        if (e < end[k])
          acc[k] += __ldg(contrib + static_cast<int64_t>(e) * w + c);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t row = base + k * l.rpw + l.sub;
      if (l.sub < l.rpw && row < n) out[row * w + c] = acc[k];
    }
  }
}

int launch(const void* contrib, const void* row_ptr, void* out, int n, int w,
           void* stream) {
  segsum_csr_f32_kernel<kSlots><<<grid_blocks(n, w, kSlots), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(contrib), static_cast<const int32_t*>(row_ptr),
      static_cast<float*>(out), n, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dpgo_segsum_csr_f32(const void* contrib, const void* row_ptr,
                                   void* out, int n, int w, void* stream) {
  if (n <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(contrib, row_ptr, out, n, w, stream);
}
