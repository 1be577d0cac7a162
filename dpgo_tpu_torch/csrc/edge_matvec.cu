// The gather-path edge terms of the Hessian matvec V Q as one
// gather-multiply-reduce, for Hopper (sm_90a):
//
//   out[j] -= sum_{e in plan_j row j} V[src_by_j[e]] @ E_by_j[e]      (->j)
//   out[i] -= sum_{e in plan_i row i} V[dst_by_i[e]] @ E_by_i[e]^T    (->i)
//
// with V and out (n, r, dh) float32 rows of w = r * dh, E (m, dh, dh), the
// edges sorted by destination (quadratic.CSRPlans). On the main path it
// replaces dpgo_tpu/ops/pallas_segsum.py::segment_sum_csr together with
// what surrounded it in dpgo_tpu/quadratic.py:597-612: two row gathers,
// two batched (r x dh)(dh x dh) products and two segment sums, six
// (m or n, w) intermediates in device memory and eight launches. Here the
// V rows and E blocks go straight into registers and each output row is
// read and written once, in place.
//
// Bound by bytes: at the centralized 100k slice (n = 100,000, m = 92,595,
// w = 15, dh = 3) one call reads V (6.00 MB), both E copies (6.67 MB), the
// int64 indices (1.48 MB) and both row_ptr (0.80 MB), and reads and writes
// out (12.00 MB): 26.9 MB, 8.0 us at 3.35 TB/s; the 16.7 MFLOP take 0.25 us
// at 67 TFLOP/s. With about one edge per row and direction, the chain
// row_ptr -> index -> V row makes it latency-bound, so the design is about
// rows in flight:
//  * one thread per (row, a), a = 0..r-1, holding all dh columns of row a
//    of the r x dh block: floor(32 / r) rows per warp (6 at r = 5), a
//    column loop for r > 32. (A thread per output element (a, b), 2 rows
//    per warp at w = 15, was slower on the H100: a third of the rows in
//    flight.)
//  * the row walk of row_walk.cuh: a slot's row pointers in one coalesced
//    load, shuffled to each row's lanes; kSlots rows per thread with both
//    directions' chains interleaved. 2 was the fastest of 1, 2 and 4 at
//    w = 15 (PERF.md): 4 costs more registers, and so occupancy, than it
//    gains in loads in flight. Re-measure when the widths change.
//  * the r lanes of a row load up to r of its gather indices at once, one
//    each, and the row takes each index from the lane that holds it with
//    __shfl_sync, so the index load is paid once per r edges;
//  * the edge's dh x dh block is loaded before the shuffle, V[src, a, 0:dh]
//    after it, both through the read-only path; all lanes of a row read
//    the same block, one broadcast.
//
// Order: each direction sums its edges in edge order; then
// out = (out - acc_j) - acc_i, the order of the JAX code. No atomics, so
// two runs give identical bits.
//
// Plain C interface, bound from Python with ctypes (ops/edge_matvec.py).

#include "row_walk.cuh"

namespace {

using namespace dpgo;

// Rows each thread walks (see the header comment).
constexpr int kSlots = 2;

// acc[b] += V[src, a, :] . E[:, b] (->j) or . E[b, :] (->i), each dot
// product summed in k order and then added, so every output element sees
// the same rounding in every mapping of threads.
template <int DH, bool kTranspose>
__device__ __forceinline__ void add_edge(const float* __restrict__ v,
                                         const float (&e)[DH * DH],
                                         float (&acc)[DH]) {
  float x[DH];
#pragma unroll
  for (int k = 0; k < DH; ++k) x[k] = __ldg(v + k);
#pragma unroll
  for (int b = 0; b < DH; ++b) {
    float s = x[0] * e[kTranspose ? b * DH : b];
#pragma unroll
    for (int k = 1; k < DH; ++k)
      s = fmaf(x[k], e[kTranspose ? b * DH + k : k * DH + b], s);
    acc[b] += s;
  }
}

template <int DH>
__device__ __forceinline__ void load_block(const float* __restrict__ E,
                                           int64_t e, float (&blk)[DH * DH]) {
#pragma unroll
  for (int k = 0; k < DH * DH; ++k) blk[k] = __ldg(E + e * DH * DH + k);
}

template <int DH, int K>
__global__ void __launch_bounds__(kThreads)
edge_matvec_f32_kernel(const float* __restrict__ V,
                       const int64_t* __restrict__ src_by_j,
                       const float* __restrict__ E_by_j,
                       const int32_t* __restrict__ ptr_j,
                       const int64_t* __restrict__ dst_by_i,
                       const float* __restrict__ E_by_i,
                       const int32_t* __restrict__ ptr_i,
                       float* __restrict__ out, int n, int r) {
  const int w = r * DH;
  const Lane l(r);  // r lanes to a row
  const int64_t base = l.warp_base<K>();
  if (base >= n) return;  // uniform over the warp
  int bj[K], ej[K], bi[K], ei[K];
  int most = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    row_range(ptr_j, base + k * l.rpw, n, l, bj[k], ej[k]);
    row_range(ptr_i, base + k * l.rpw, n, l, bi[k], ei[k]);
    most = max(most, max(ej[k] - bj[k], ei[k] - bi[k]));
  }
  // the shuffles below need every lane, so the edge loop runs to the
  // warp's longest row
  most = __reduce_max_sync(kFullMask, most);
  const int group = r < kWarpSize ? r : kWarpSize;  // lanes of one row
  const int pos = l.lane - l.lead;                  // this lane's place in it
  const bool in_row = l.sub < l.rpw;
  for (int q = 0; q < l.passes; ++q) {
    const int a = l.col + q * kWarpSize;
    const bool a_ok = a < r;
    float o[K][DH], acc_j[K][DH], acc_i[K][DH];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t row = base + k * l.rpw + l.sub;
      const bool ok = a_ok && in_row && row < n;
#pragma unroll
      for (int b = 0; b < DH; ++b) {
        o[k][b] = ok ? out[row * w + a * DH + b] : 0.0f;
        acc_j[k][b] = 0.0f;
        acc_i[k][b] = 0.0f;
      }
    }
    // edges in chunks of `group`: each lane of a row loads one edge's
    // gather index per direction, then the row walks the chunk, taking
    // each index from the lane that holds it
    for (int c0 = 0; c0 < most; c0 += group) {
      int64_t own_j[K], own_i[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e_j = bj[k] + c0 + pos, e_i = bi[k] + c0 + pos;
        own_j[k] = in_row && e_j < ej[k] ? __ldg(src_by_j + e_j) : 0;
        own_i[k] = in_row && e_i < ei[k] ? __ldg(dst_by_i + e_i) : 0;
      }
      const int steps = min(group, most - c0);
      for (int t = 0; t < steps; ++t) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int e_j = bj[k] + c0 + t, e_i = bi[k] + c0 + t;
          const bool on_j = a_ok && e_j < ej[k], on_i = a_ok && e_i < ei[k];
          float blk_j[DH * DH], blk_i[DH * DH];
          if (on_j) load_block<DH>(E_by_j, e_j, blk_j);
          if (on_i) load_block<DH>(E_by_i, e_i, blk_i);
          const int64_t s_j = __shfl_sync(kFullMask, own_j[k], l.lead + t);
          const int64_t s_i = __shfl_sync(kFullMask, own_i[k], l.lead + t);
          if (on_j) add_edge<DH, false>(V + s_j * w + a * DH, blk_j, acc_j[k]);
          if (on_i) add_edge<DH, true>(V + s_i * w + a * DH, blk_i, acc_i[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t row = base + k * l.rpw + l.sub;
      if (a_ok && in_row && row < n) {
#pragma unroll
        for (int b = 0; b < DH; ++b)
          out[row * w + a * DH + b] = (o[k][b] - acc_j[k][b]) - acc_i[k][b];
      }
    }
  }
}

template <int DH>
int launch(const void* V, const void* src_by_j, const void* E_by_j,
           const void* ptr_j, const void* dst_by_i, const void* E_by_i,
           const void* ptr_i, void* out, int n, int r, void* stream) {
  edge_matvec_f32_kernel<DH, kSlots><<<grid_blocks(n, r, kSlots), kThreads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(V), static_cast<const int64_t*>(src_by_j),
      static_cast<const float*>(E_by_j), static_cast<const int32_t*>(ptr_j),
      static_cast<const int64_t*>(dst_by_i), static_cast<const float*>(E_by_i),
      static_cast<const int32_t*>(ptr_i), static_cast<float*>(out), n, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// V, out: (n, r * dh) float32; src_by_j, dst_by_i: (m,) int64; E_by_j,
// E_by_i: (m, dh, dh) float32; ptr_j, ptr_i: (n + 1,) int32. dh is 3 or 4.
extern "C" int dpgo_edge_matvec_f32(const void* V, const void* src_by_j,
                                    const void* E_by_j, const void* ptr_j,
                                    const void* dst_by_i, const void* E_by_i,
                                    const void* ptr_i, void* out, int n, int r,
                                    int dh, void* stream) {
  if (n <= 0 || r <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dh == 3)
    return launch<3>(V, src_by_j, E_by_j, ptr_j, dst_by_i, E_by_i, ptr_i, out,
                     n, r, stream);
  if (dh == 4)
    return launch<4>(V, src_by_j, E_by_j, ptr_j, dst_by_i, E_by_i, ptr_i, out,
                     n, r, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
