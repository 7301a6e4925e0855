// The embedding lookup, written by hand for Hopper (sm_90a):
//
//     score[b, j] = max over the valid seeds s of row b of dot(F[s], F[j]),
//                   NEG where j is one of the row's seeds or the row has none
//     out[b]      = the k best (score, j) of row b: score descending, then j
//                   ascending; -1 / 0.0 past the row's valid scores
//
// It replaces the reference's `_embed_topk_impl`
// (kmlserver_tpu/ops/embed.py:46-87), which XLA lowers to a scan over the
// seed slots: per slot a (B, R) x (R, V) product, a running max and, at the
// end, a seed mask and a top-k. The port's plain version
// (ops/embed.py::embed_topk_plain) does the same in torch ops: per slot
// about five launches, and each slot reads the whole factor matrix and
// rewrites the (B, V) running max, padding slots included.
//
// What bounds it on an H100: float32 operations. Each valid seed scores
// every item, 2 * V * R operations (R multiply-adds an item), on the CUDA
// cores, never the tensor cores (TF32 would move the similarities by about
// 1e-3). At V = 1M, R = 32 and ~225 valid seeds a batch that is 14.4
// GFLOP, ~0.21 ms at 67 TFLOP/s; the factors read once take 0.04 ms.
//
// Design:
// - The scoring pass: a block owns a tile of kThreads * ipt items, one row
//   of R floats each per thread and item, held in registers (16-byte loads
//   where R % 4 == 0 and the factors are 16-byte aligned; columns up to the
//   rank rounded up to RP are zeros). Blocks walk the tiles grid-stride, at
//   most kMaxLists blocks.
// - For each batch row, the row's valid seed ids (0 <= id < V) are gathered
//   from its slots into shared memory, kSeeds vectors a pass, and every
//   thread takes each staged vector as a broadcast: per seed and item R
//   fused multiply-adds in column order, then a running max. A -1 slot
//   never enters the loop, so padding costs nothing. The staged seeds that
//   fall in the tile set bits of a shared bitmap; those items score NEG.
//   The (B, V) scores never reach device memory on this route.
// - The selection: each item's (score, index) becomes one 64-bit key,
//   the score's order-preserving bits above the complement of the index, so
//   keys are distinct and key order is the result's order (ties lowest
//   index first, as jax.lax.top_k and a stable sort give). A warp keeps
//   only keys at least its k-th largest lane maximum (k <= 32: k lanes hold
//   k items at least that good) and at least the block's running k-th; the
//   survivors and the block's running list go into a shared buffer, and
//   each survivor's rank is the count of greater keys there. The k best,
//   in order, are the block's list for the row, in device memory.
// - The merge pass: one block a row walks the lists' heads, k rounds of a
//   block-wide max: the winner is written out and its list advances. A row
//   with fewer than k valid scores (no valid seed, k > V - seeds) runs out
//   of keys and pads with -1 / 0.0.
// - The sort route (k above kCapacity): the scoring pass writes the masked
//   (B, V) scores instead, and the wrapper selects them with a stable sort.
//   -0.0 becomes +0.0 on both routes, so equal scores have equal keys.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;          // scoring pass: threads a block
constexpr int kMinBlocksPerSm = 3;
constexpr int kMaxLists = 1024;        // scoring blocks = lists the merge walks
constexpr int kCapacity = 128;         // largest k of the fused selection
constexpr int kSeedBytes = 16384;      // staged seed vectors a pass
constexpr long long kMaxItems = 1LL << 30;  // item indices and tile ends stay in int
constexpr float kNeg = -3.0e38f;       // ops/embed.py NEG
constexpr float kValid = -1.5e38f;     // NEG / 2: scores above it are valid
constexpr unsigned kFull = 0xffffffffu;

template <int RP>
struct Geometry {
  static constexpr int kIpt = RP <= 32 ? 4 : 128 / RP;  // items a thread
  static constexpr int kTile = kThreads * kIpt;
  static constexpr int kQuads = RP / 4;
  static constexpr int kSeeds = kSeedBytes / (RP * 4) < 256 ? kSeedBytes / (RP * 4) : 256;
};

__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// the key of a valid score; 0 is no key (an empty list entry)
__device__ __forceinline__ unsigned long long key_of(float score, int item) {
  return (static_cast<unsigned long long>(ordered_bits(score)) << 32) |
         (0xffffffffu - static_cast<uint32_t>(item));
}

__device__ __forceinline__ unsigned long long max_key(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

__device__ __forceinline__ float4 load_quad(const float* row, int q, int r, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(row) + q);
  const int c = 4 * q;
  return make_float4(c < r ? __ldg(row + c) : 0.0f, c + 1 < r ? __ldg(row + c + 1) : 0.0f,
                     c + 2 < r ? __ldg(row + c + 2) : 0.0f,
                     c + 3 < r ? __ldg(row + c + 3) : 0.0f);
}

// factors (v, r) f32, seeds (b_rows, len) i32 -> per row and block, the
// block's k best keys in order, cand[(row * gridDim.x + block) * k + i]
// (0 past its valid keys); or, with `scores`, the masked (b_rows, v) scores.
template <int RP>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
embed_score_kernel(const float* __restrict__ factors, const int32_t* __restrict__ seeds,
                   unsigned long long* cand, float* __restrict__ scores, int v, int r,
                   int b_rows, int len, int k, bool vec) {
  using G = Geometry<RP>;
  constexpr int kIpt = G::kIpt, kTile = G::kTile, kQuads = G::kQuads, kSeeds = G::kSeeds;
  __shared__ float4 s_vec[kSeeds * kQuads];
  __shared__ int s_id[kSeeds];
  __shared__ uint32_t s_mask[kTile / 32];
  __shared__ unsigned long long s_buf[kTile + kCapacity];
  __shared__ int s_count;

  const int tid = threadIdx.x, lane = tid & 31;
  const int tiles = (v - 1) / kTile + 1;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == static_cast<int>(blockIdx.x);
    const int lo = tile * kTile;
    float x[kIpt][RP];
#pragma unroll
    for (int i = 0; i < kIpt; ++i) {
      const int item = lo + i * kThreads + tid;
#pragma unroll
      for (int c = 0; c < RP; ++c) x[i][c] = 0.0f;
      if (item < v) {
        const float* row = factors + static_cast<size_t>(item) * r;
#pragma unroll
        for (int q = 0; q < kQuads; ++q) {
          if (4 * q < r) {
            const float4 f = vec ? __ldcs(reinterpret_cast<const float4*>(row) + q)
                                 : load_quad(row, q, r, false);
            x[i][4 * q] = f.x;
            x[i][4 * q + 1] = f.y;
            x[i][4 * q + 2] = f.z;
            x[i][4 * q + 3] = f.w;
          }
        }
      }
    }

    for (int b = 0; b < b_rows; ++b) {
      float best[kIpt];
#pragma unroll
      for (int i = 0; i < kIpt; ++i) best[i] = kNeg;
      for (int w = tid; w < kTile / 32; w += kThreads) s_mask[w] = 0u;
      int total = 0;
      for (int c0 = 0; c0 < len; c0 += kSeeds) {
        const int chunk = len - c0 < kSeeds ? len - c0 : kSeeds;
        if (tid == 0) s_count = 0;
        __syncthreads();
        for (int t = tid; t < chunk; t += kThreads) {
          const int id = seeds[static_cast<size_t>(b) * len + c0 + t];
          if (id >= 0 && id < v) {
            s_id[atomicAdd(&s_count, 1)] = id;
            if (id >= lo && id - lo < kTile) {
              atomicOr(&s_mask[(id - lo) >> 5], 1u << ((id - lo) & 31));
            }
          }
        }
        __syncthreads();
        const int n = s_count;
        for (int e = tid; e < n * kQuads; e += kThreads) {
          const int j = e / kQuads, q = e - j * kQuads;
          s_vec[e] = 4 * q < r ? load_quad(factors + static_cast<size_t>(s_id[j]) * r, q, r, vec)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        __syncthreads();
        for (int j = 0; j < n; ++j) {
          float acc[kIpt];
#pragma unroll
          for (int i = 0; i < kIpt; ++i) acc[i] = 0.0f;
#pragma unroll
          for (int q = 0; q < kQuads; ++q) {
            const float4 s = s_vec[j * kQuads + q];
#pragma unroll
            for (int i = 0; i < kIpt; ++i) {
              acc[i] = fmaf(s.x, x[i][4 * q], acc[i]);
              acc[i] = fmaf(s.y, x[i][4 * q + 1], acc[i]);
              acc[i] = fmaf(s.z, x[i][4 * q + 2], acc[i]);
              acc[i] = fmaf(s.w, x[i][4 * q + 3], acc[i]);
            }
          }
#pragma unroll
          for (int i = 0; i < kIpt; ++i) best[i] = fmaxf(best[i], acc[i]);
        }
        total += n;
      }

      // the row's scores: NEG for its seeds, past V, or with no valid seed;
      // + 0.0f turns -0.0 into +0.0
      float score[kIpt];
#pragma unroll
      for (int i = 0; i < kIpt; ++i) {
        const int local = i * kThreads + tid;
        const bool masked = total == 0 || lo + local >= v ||
                            ((s_mask[local >> 5] >> (local & 31)) & 1u);
        score[i] = masked ? kNeg : best[i] + 0.0f;
      }

      if (scores != nullptr) {
#pragma unroll
        for (int i = 0; i < kIpt; ++i) {
          const int item = lo + i * kThreads + tid;
          if (item < v) scores[static_cast<size_t>(b) * v + item] = score[i];
        }
        __syncthreads();  // the mask is read before the next row clears it
        continue;
      }

      unsigned long long* list = cand + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * k;
      unsigned long long key[kIpt];
      unsigned long long lane_max = 0ull;
#pragma unroll
      for (int i = 0; i < kIpt; ++i) {
        key[i] = score[i] > kValid ? key_of(score[i], lo + i * kThreads + tid) : 0ull;
        lane_max = max_key(lane_max, key[i]);
      }
      // keep keys >= thr (and nonzero): the warp's k-th largest lane maximum,
      // and the block's running k-th from its earlier tiles
      unsigned long long thr = 1ull;
      if (k <= 32) {
        int rank = 0;
        for (int l = 0; l < 32; ++l) {
          const unsigned long long o = __shfl_sync(kFull, lane_max, l);
          rank += (o > lane_max) || (o == lane_max && l < lane);
        }
        const unsigned at = __ballot_sync(kFull, rank == k - 1);
        thr = max_key(thr, __shfl_sync(kFull, lane_max, __ffs(at) - 1));
      }
      if (!first) thr = max_key(thr, list[k - 1]);
      if (tid == 0) s_count = 0;
      __syncthreads();  // every thread has read the mask and s_count's seeds
      if (!first) {
        for (int t = tid; t < k; t += kThreads) {
          const unsigned long long kept = list[t];
          if (kept != 0ull) s_buf[atomicAdd(&s_count, 1)] = kept;
        }
      }
#pragma unroll
      for (int i = 0; i < kIpt; ++i) {
        if (key[i] >= thr) s_buf[atomicAdd(&s_count, 1)] = key[i];
      }
      __syncthreads();
      const int n = s_count;
      for (int c = tid; c < n; c += kThreads) {
        const unsigned long long mine = s_buf[c];
        int rank = 0;
        for (int j = 0; j < n; ++j) rank += s_buf[j] > mine;
        if (rank < k) list[rank] = mine;
      }
      for (int t = n + tid; t < k; t += kThreads) list[t] = 0ull;
      __syncthreads();  // the buffer is free, the list written for the next tile
    }
  }
}

// one block a row: k_out rounds over the heads of `lists` sorted lists of k
// keys each -> out_ids (b_rows, k_out) i32 (-1 past the valid keys) and
// out_sims (b_rows, k_out) f32 (0.0 there)
__global__ void __launch_bounds__(kMaxLists)
embed_merge_kernel(const unsigned long long* __restrict__ cand, int lists, int k,
                   int32_t* __restrict__ out_ids, float* __restrict__ out_sims) {
  __shared__ unsigned long long s_warp[kMaxLists / 32];
  __shared__ unsigned long long s_max;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x / 32;
  const unsigned long long* list = cand + (static_cast<size_t>(b) * lists + tid) * k;
  // the head and, loaded ahead, the entry after it
  int pos = 0;
  unsigned long long head = tid < lists ? list[0] : 0ull;
  unsigned long long next = tid < lists && k > 1 ? list[1] : 0ull;
  for (int round = 0; round < k; ++round) {
    unsigned long long m = head;
    for (int off = 16; off > 0; off >>= 1) m = max_key(m, __shfl_xor_sync(kFull, m, off));
    if (lane == 0) s_warp[warp] = m;
    __syncthreads();
    if (warp == 0) {
      m = lane < warps ? s_warp[lane] : 0ull;
      for (int off = 16; off > 0; off >>= 1) m = max_key(m, __shfl_xor_sync(kFull, m, off));
      if (lane == 0) s_max = m;
    }
    __syncthreads();
    m = s_max;
    const size_t at = static_cast<size_t>(b) * k;
    if (m == 0ull) {
      for (int t = round + tid; t < k; t += blockDim.x) {
        out_ids[at + t] = -1;
        out_sims[at + t] = 0.0f;
      }
      break;
    }
    if (tid == 0) {
      out_ids[at + round] = static_cast<int32_t>(0xffffffffu - static_cast<uint32_t>(m));
      out_sims[at + round] = float_of(static_cast<uint32_t>(m >> 32));
    }
    if (head == m) {
      ++pos;
      head = next;
      next = pos + 1 < k ? list[pos + 1] : 0ull;
    }
  }
}

int padded_rank(int r) {
  for (int rp = 4; rp <= 128; rp *= 2) {
    if (r <= rp) return rp;
  }
  return 0;
}

int tile_of(int rp) {
  switch (rp) {
    case 4: return Geometry<4>::kTile;
    case 8: return Geometry<8>::kTile;
    case 16: return Geometry<16>::kTile;
    case 32: return Geometry<32>::kTile;
    case 64: return Geometry<64>::kTile;
    case 128: return Geometry<128>::kTile;
    default: return 0;
  }
}

template <int RP>
void launch_score(int grid, cudaStream_t stream, const float* factors, const int32_t* seeds,
                  unsigned long long* cand, float* scores, int v, int r, int b_rows, int len,
                  int k, bool vec) {
  embed_score_kernel<RP><<<grid, kThreads, 0, stream>>>(factors, seeds, cand, scores, v, r,
                                                        b_rows, len, k, vec);
}

}  // namespace

// plan = {padded rank, items a tile, scoring blocks (= merge lists), largest
// fused k} for v items of rank r; returns cudaErrorInvalidValue for a rank
// outside [1, 128] or v outside [1, 2^30].
extern "C" int kmls_embed_topk_plan(long long v, int r, int* plan) {
  const int rp = r >= 1 ? padded_rank(r) : 0;
  if (rp == 0 || v < 1 || v > kMaxItems) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (v + tile_of(rp) - 1) / tile_of(rp);
  plan[0] = rp;
  plan[1] = tile_of(rp);
  plan[2] = static_cast<int>(tiles < kMaxLists ? tiles : kMaxLists);
  plan[3] = kCapacity;
  return static_cast<int>(cudaSuccess);
}

// The fused route (scores null): cand (b_rows, lists, k) u64 scratch,
// out_ids (b_rows, k) i32, out_sims (b_rows, k) f32, 1 <= k <= kCapacity.
// The sort route (scores (b_rows, v) f32 non-null): cand and the outputs
// unused. `lists` is plan[2]. Launches on `stream`, does not synchronise,
// and returns the CUDA error code.
extern "C" int kmls_embed_topk(const void* factors, const void* seeds, void* cand, void* scores,
                               void* out_ids, void* out_sims, long long v, int r, int b_rows,
                               int len, int k, int lists, void* stream) {
  const int rp = r >= 1 ? padded_rank(r) : 0;
  if (rp == 0 || v < 1 || v > kMaxItems || b_rows < 1 || len < 1 || lists < 1 ||
      lists > kMaxLists || (scores == nullptr && (k < 1 || k > kCapacity))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = r % 4 == 0 && reinterpret_cast<uintptr_t>(factors) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(factors);
  const int32_t* s = static_cast<const int32_t*>(seeds);
  unsigned long long* c = static_cast<unsigned long long*>(cand);
  float* sc = static_cast<float*>(scores);
  const int vi = static_cast<int>(v);
  switch (rp) {
    case 4: launch_score<4>(lists, st, f, s, c, sc, vi, r, b_rows, len, k, vec); break;
    case 8: launch_score<8>(lists, st, f, s, c, sc, vi, r, b_rows, len, k, vec); break;
    case 16: launch_score<16>(lists, st, f, s, c, sc, vi, r, b_rows, len, k, vec); break;
    case 32: launch_score<32>(lists, st, f, s, c, sc, vi, r, b_rows, len, k, vec); break;
    case 64: launch_score<64>(lists, st, f, s, c, sc, vi, r, b_rows, len, k, vec); break;
    default: launch_score<128>(lists, st, f, s, c, sc, vi, r, b_rows, len, k, vec); break;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || scores != nullptr) return static_cast<int>(err);
  const int threads = (lists + 31) / 32 * 32;
  embed_merge_kernel<<<b_rows, threads, 0, st>>>(c, lists, k, static_cast<int32_t*>(out_ids),
                                                 static_cast<float*>(out_sims));
  return static_cast<int>(cudaGetLastError());
}
