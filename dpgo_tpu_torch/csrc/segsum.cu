// CSR segment sum over destination-sorted rows, for Hopper (sm_90a).
//
//   out[r, c] = sum_{e in [row_ptr[r], row_ptr[r+1])} contrib[e, c]
//
// Replaces dpgo_tpu/ops/pallas_segsum.py::segment_sum_csr, the scatter-add
// half of the gather-path Hessian matvec (quadratic.q_matvec). The TPU
// kernel is a one-hot matmul per 1024-row output tile fed by DMA'd edge
// chunks; on this card that is wasted work, so this is a plain segmented
// reduction instead: one warp per output row, lane c sums column c of the
// row's contiguous edge range in edge order (columns in steps of 32 when
// w > 32) and writes out[r, c] once. Rows with no edges get 0. There are no
// atomics and the summation order is fixed, so two runs give identical bits
// (index_add_ on CUDA uses atomics and does not).
//
// Bound by bytes: at the centralized 100k slice (n = 100,000 rows,
// m = 92,595 edges, w = 15 floats) one call reads 5.6 MB of contributions
// and 0.4 MB of row pointers and writes 6 MB, about 12 MB, so about 4 us at
// the card's 3.35 TB/s. At that size the call is launch-bound. A later step
// fuses the row gather and the per-edge (r x dh)(dh x dh) product into this
// kernel, so the whole edge path becomes one gather-multiply-reduce.
//
// Plain C interface, bound from Python with ctypes (ops/segsum.py): raw
// pointers, sizes and the stream in, cudaGetLastError() out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpSize = 32;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpSize * kWarpsPerBlock)
segsum_csr_f32_kernel(const float* __restrict__ contrib,
                      const int32_t* __restrict__ row_ptr,
                      float* __restrict__ out, int n, int w) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarpSize;
  const int lane = threadIdx.x % kWarpSize;
  if (row >= n) return;
  const int64_t begin = row_ptr[row];
  const int64_t end = row_ptr[row + 1];
  for (int c = lane; c < w; c += kWarpSize) {
    float acc = 0.0f;
    for (int64_t e = begin; e < end; ++e) acc += contrib[e * w + c];
    out[static_cast<int64_t>(row) * w + c] = acc;
  }
}

}  // namespace

extern "C" int dpgo_segsum_csr_f32(const void* contrib, const void* row_ptr,
                                   void* out, int n, int w, void* stream) {
  if (n <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segsum_csr_f32_kernel<<<blocks, kWarpSize * kWarpsPerBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(contrib), static_cast<const int32_t*>(row_ptr),
      static_cast<float*>(out), n, w);
  return static_cast<int>(cudaGetLastError());
}
