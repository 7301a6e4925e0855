// Deterministic CSR segment sum for the sparse ALS half-sweeps:
//
//     out[s, :] = sum over e in [offsets[s], offsets[s + 1]) of mat[gidx[e], :]
//
// It replaces the reference's `_sparse_accumulate`
// (kmlserver_tpu/mining/als.py:158-178), an XLA scatter-add over chunks of
// the nnz events. The events arrive as CSR: int64 `offsets` (n_out + 1) and
// int32 `gidx`, stably sorted by segment, so each row's events keep their
// original order.
//
// Design: one warp per output row, lanes over the rank R (in chunks of 32
// columns for R > 32). A warp loads 32 event indices at once (one per lane,
// coalesced), broadcasts each with a shuffle, issues the 32 gathers of its
// column before adding any of them (memory-level parallelism), then adds
// them in event order with plain fp32 adds. There are no atomics, so the
// result does not change from run to run, and each (row, column) sum takes
// its terms in the same order as the plain PyTorch version (`index_add_`
// over the events in their original order, on the CPU): the two agree bit
// for bit. Rows with no events come out zero.
//
// Bound on this card: bytes. The gathered rows are nnz * R * 4 bytes, read
// once; the indices and the output are small beside them. A row's sum is a
// serial chain of adds, so a row with millions of events (the head of a
// Zipf track axis) runs on one warp for its whole length: the kernel's time
// follows its longest row, not the bytes. Spreading a long row over several
// warps while keeping the order is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kBatch = 32;  // events staged per step: one index per lane
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segsum_kernel(const float* __restrict__ mat, const int64_t* __restrict__ offsets,
              const int32_t* __restrict__ gidx, float* __restrict__ out,
              long long n_out, int rank) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_out) return;  // whole warps leave together
  const long long begin = offsets[row];
  const long long end = offsets[row + 1];
  for (int c0 = 0; c0 < rank; c0 += 32) {
    const int col = c0 + lane;
    const bool active = col < rank;
    float acc = 0.0f;
    for (long long e0 = begin; e0 < end; e0 += kBatch) {
      const long long left = end - e0;
      const int n = left < kBatch ? static_cast<int>(left) : kBatch;
      const int my_idx = lane < n ? gidx[e0 + lane] : 0;
      float v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int g = __shfl_sync(kFull, my_idx, j);
        v[j] = (active && j < n)
                   ? __ldg(mat + static_cast<long long>(g) * rank + col)
                   : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (j < n) acc += v[j];
      }
    }
    if (active) out[row * rank + col] = acc;
  }
}

}  // namespace

// out (n_out, rank) f32 <- segment sums of mat (n_in, rank) f32 over the CSR
// (offsets int64 (n_out + 1), gidx int32 (nnz)). The caller guarantees
// 0 <= gidx < n_in and monotone offsets. Returns the CUDA error code.
extern "C" int kmls_segsum(const void* mat, const void* offsets, const void* gidx,
                           void* out, long long n_out, int rank, void* stream) {
  if (n_out < 0 || rank <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n_out + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  segsum_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mat), static_cast<const int64_t*>(offsets),
      static_cast<const int32_t*>(gidx), static_cast<float*>(out), n_out, rank);
  return static_cast<int>(cudaGetLastError());
}
