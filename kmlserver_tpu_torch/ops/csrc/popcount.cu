// Pair-support counts over bit-packed baskets, written by hand for Hopper
// (sm_90a):
//
//     C[i, j] = sum_w popcount(Bt[i, w] & Bt[j, w])
//
// where Bt (V_pad, W_pad) holds track i's playlist membership as 32-bit
// words and C (V_pad, V_pad) int32 is the pair co-occurrence matrix.
//
// Replaces the Pallas TPU kernel in kmlserver_tpu/ops/popcount.py:
// _popcount_padded_jit (the pallas_call, grid (V_pad/TI, V_pad/TJ,
// W_pad/WK)) with its bodies _kernel_bcast (default) and _kernel_row. Both
// Pallas variants compute the same contract; both map to this one kernel.
//
// Design (simple and right first):
//   - one thread block per (TI, TJ) output tile; a loop over word stages
//     inside the block takes the place of the TPU grid's sequential third
//     axis, so the sum lives in int32 registers — no zero-init pass, no
//     cross-block reduction (counts <= P < 2^31, so int32 is exact);
//   - each stage copies the A (TI, 32) and B (TJ, 32) word slabs from device
//     memory with coalesced 16-byte loads into shared memory, stored k-major
//     with one padding word per row so neither the transposing stores nor
//     the compute reads hit bank conflicts;
//   - each thread owns a 4 x 4 register tile: per word it reads 4 A words
//     (a warp-wide broadcast) and 4 B words and does 16 AND + popcount + add;
//   - SWAR = true swaps __popc for a shift-add popcount (the reference's
//     swar=True cross-check path, Hacker's Delight fig. 5-2).
//
// What bounds it on an H100: integer issue, not memory. The work is
// V_pad^2 * W_pad word pairs, each an AND, a popcount and an add, while the
// bitset is read once per output tile row/column band (V_pad * W_pad * 4
// bytes, a few hundred MB at the largest shapes, mostly served from L2).
// __popc issues at 16 lanes per clock per SM against 64 for AND/add, so the
// popcount is the binding unit; the 4 x 4 register tile keeps shared-memory
// traffic at 8 loads per 16 popcounts so it never is. Making it fast
// (C = C^T halves the work, carry-save popcount trees, TMA staging) is
// later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMicro = 4;        // each thread owns a kMicro x kMicro tile
constexpr int kStageWords = 32;  // words of each row staged per iteration
constexpr int kQuads = kStageWords / 4;  // 16-byte loads per row per stage

__device__ __forceinline__ uint32_t popcount_swar(uint32_t x) {
  x = x - ((x >> 1) & 0x55555555u);
  x = (x & 0x33333333u) + ((x >> 2) & 0x33333333u);
  x = (x + (x >> 4)) & 0x0F0F0F0Fu;
  x = x + (x >> 16);
  x = x + (x >> 8);
  return x & 0x3Fu;
}

template <bool kSwar>
__device__ __forceinline__ int popcount_word(uint32_t x) {
  if constexpr (kSwar) {
    return static_cast<int>(popcount_swar(x));
  } else {
    return __popc(x);
  }
}

template <bool kSwar>
__global__ void __launch_bounds__(1024) popcount_pairs_kernel(
    const uint32_t* __restrict__ bt, int32_t* __restrict__ out, int v_pad,
    int w_pad, int tile_i, int tile_j, int vec4) {
  extern __shared__ uint32_t smem[];
  const int a_stride = tile_i + 1;
  const int b_stride = tile_j + 1;
  uint32_t* a_s = smem;                           // [kStageWords][tile_i + 1]
  uint32_t* b_s = smem + kStageWords * a_stride;  // [kStageWords][tile_j + 1]

  const int i0 = blockIdx.y * tile_i;
  const int j0 = blockIdx.x * tile_j;
  const int tid = threadIdx.x;
  const int cols_per = tile_j / kMicro;  // threads along j
  const int tx = tid % cols_per;
  const int ty = tid / cols_per;
  const int loads = (tile_i + tile_j) * kQuads;

  int acc[kMicro][kMicro];
#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
#pragma unroll
    for (int c = 0; c < kMicro; ++c) acc[r][c] = 0;
  }

  for (int k0 = 0; k0 < w_pad; k0 += kStageWords) {
    // stage: rows [0, tile_i) of the A band, then rows of the B band
    for (int l = tid; l < loads; l += blockDim.x) {
      int r = l / kQuads;
      const int q = l % kQuads;
      uint32_t* dst = a_s;
      int stride = a_stride;
      int grow = i0 + r;
      if (r >= tile_i) {
        r -= tile_i;
        dst = b_s;
        stride = b_stride;
        grow = j0 + r;
      }
      const int w = k0 + q * 4;
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (grow < v_pad) {
        const uint32_t* src = bt + static_cast<size_t>(grow) * w_pad + w;
        if (vec4 && w + 3 < w_pad) {
          const uint4 x = __ldg(reinterpret_cast<const uint4*>(src));
          v[0] = x.x;
          v[1] = x.y;
          v[2] = x.z;
          v[3] = x.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (w + e < w_pad) v[e] = src[e];
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[(q * 4 + e) * stride + r] = v[e];
    }
    __syncthreads();

#pragma unroll 8
    for (int k = 0; k < kStageWords; ++k) {
      uint32_t a[kMicro];
      uint32_t b[kMicro];
#pragma unroll
      for (int r = 0; r < kMicro; ++r) a[r] = a_s[k * a_stride + ty * kMicro + r];
#pragma unroll
      for (int c = 0; c < kMicro; ++c) b[c] = b_s[k * b_stride + tx + c * cols_per];
#pragma unroll
      for (int r = 0; r < kMicro; ++r) {
#pragma unroll
        for (int c = 0; c < kMicro; ++c) {
          acc[r][c] += popcount_word<kSwar>(a[r] & b[c]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    const int row = i0 + ty * kMicro + r;
    if (row >= v_pad) continue;
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      const int col = j0 + tx + c * cols_per;
      if (col < v_pad) out[static_cast<size_t>(row) * v_pad + col] = acc[r][c];
    }
  }
}

}  // namespace

// Plain C interface (bound with ctypes). bt: int32/uint32 (v_pad, w_pad)
// contiguous on the device; out: int32 (v_pad, v_pad) contiguous. The block
// tile (tile_i, tile_j) must be multiples of 4 with at most 1024 threads and
// 48 KB of staging; the grid masks a ragged edge. Launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int kmls_popcount_pair_counts(const void* bt, void* out, int v_pad,
                                         int w_pad, int tile_i, int tile_j,
                                         int swar, void* stream) {
  if (v_pad <= 0 || w_pad <= 0 || tile_i <= 0 || tile_j <= 0 ||
      tile_i % kMicro != 0 || tile_j % kMicro != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (tile_i / kMicro) * (tile_j / kMicro);
  const size_t smem =
      sizeof(uint32_t) * kStageWords * static_cast<size_t>(tile_i + tile_j + 2);
  if (threads > 1024 || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((v_pad + tile_j - 1) / tile_j, (v_pad + tile_i - 1) / tile_i);
  const int vec4 =
      (w_pad % 4 == 0) && (reinterpret_cast<uintptr_t>(bt) % 16 == 0);
  const auto* src = static_cast<const uint32_t*>(bt);
  auto* dst = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (swar) {
    popcount_pairs_kernel<true><<<grid, threads, smem, s>>>(
        src, dst, v_pad, w_pad, tile_i, tile_j, vec4);
  } else {
    popcount_pairs_kernel<false><<<grid, threads, smem, s>>>(
        src, dst, v_pad, w_pad, tile_i, tile_j, vec4);
  }
  return static_cast<int>(cudaGetLastError());
}
