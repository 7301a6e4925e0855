// Deterministic CSR segment sum for the sparse ALS half-sweeps:
//
//     out[s, :] = sum over e in [offsets[s], offsets[s + 1]) of mat[gidx[e], :]
//
// It replaces the reference's `_sparse_accumulate`
// (kmlserver_tpu/mining/als.py:158-178), an XLA scatter-add over chunks of
// the nnz events. The events arrive as CSR: int64 `offsets` (n_out + 1) and
// int32 `gidx`, stably sorted by segment, so each row keeps its events in
// their original order; with them the schedule, an int32 `order` of the
// rows (lengths descending, ties by row index) and the count `n_long` of
// long rows at its head (at least LONG_ROW_EVENTS events, ops/segsum.py).
//
// The contract: each (row, column) is the sequential fp32 sum of the row's
// events in CSR order, starting from 0.0. Those are the additions that
// `index_add_` makes on the CPU (the plain version), so the two agree bit
// for bit, and every run gives the same bits. The manifest sha256, the
// embed phase's resume and the two-training check rely on that. So no row
// is split into partial sums (that would change the bits), and nothing is
// added with atomics.
//
// What bounds it: bytes (nnz gathered rows of R * 4 bytes, read once) or
// the longest row's chain of dependent adds, whichever is longer. Each
// column's sum is one chain, an add per event. At ~4 cycles per add, a Zipf
// head row of 646,923 events needs ~1.3 ms on one SM however the loads are
// spread; a schedule can only start that chain first and keep it fed.
//
// Design:
// - One persistent launch: blocks-per-SM x SMs blocks take work items from
//   an int32 counter that the wrapper zeroes on every call. The items are,
//   in this order, the n_long long rows (one per item, for the whole block)
//   and then groups of kShortRowsPerItem short rows. So the longest row
//   starts at t = 0, and the rest fill in around it, longest first. The
//   counter decides who sums a row, never the order of that row's adds.
// - A long row runs through a ring of kStages stages in shared memory, each
//   stage the gathered rows of up to stage_events(w) consecutive events.
//   Producer warps fill whole stages round robin: a lane loads the indices
//   of its events one stage ahead into registers, and the warp copies the
//   gathered rows with cp.async, 16 bytes a lane, each row's index shuffled
//   from the lane that holds it (4-byte copies where R % 4 != 0 or `mat` is
//   not 16-byte aligned). Every lane's copies complete on the stage's `full`
//   mbarrier. One consumer warp per 32 columns waits on `full`, adds the
//   stage's rows in event order (one lane per column; a full stage at R =
//   32, 64 or 128 unrolled at fixed shared-memory offsets), and releases the
//   stage on its `empty` mbarrier. So the loads of several stages are in
//   flight while the chain runs. Columns past kPassCols take another pass.
// - A short row runs on one warp: lanes over the columns, 32 indices staged
//   per step, 32 gathers issued before any is added, then added in event
//   order. The next step's indices, and the next row's first ones, load
//   while a step sums.
//
// On an H100 (PERF.md, phase 11 (c)) the consumer's adds run at ~8 cycles
// an event, fed from shared memory, which is twice the chain's 4; the 16-byte
// copies keep ahead of it. The ring's depth and the blocks per SM were
// chosen by measurement: deeper rings feed the long rows faster, and more
// blocks per SM feed the short rows faster.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMinBlocksPerSm = 3;
constexpr int kStages = 8;                // ring depth
constexpr int kStageBytes = 8192;         // gathered rows per stage
constexpr int kStageFloats = kStageBytes / 4;
constexpr int kMaxStageEvents = 128;      // events per stage at narrow R
constexpr int kIdxRegs = kMaxStageEvents / 32;
constexpr int kPassCols = 128;            // columns per pass: 4 consumer warps
constexpr int kRowsPerWarp = 8;           // short rows per warp per work item
constexpr int kShortRowsPerItem = kRowsPerWarp * kWarps;
constexpr int kBatch = 32;                // short path: events per step
constexpr int kUnroll = 16;               // consumer: reads ahead of the chain
constexpr unsigned kFull = 0xffffffffu;

// dynamic shared memory: the ring | each warp's index scratch | the barriers
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kIdxBytes = kWarps * kMaxStageEvents * 4;
constexpr int kSmemBytes = kRingBytes + kIdxBytes + 2 * kStages * 8;

// the blocks fit an SM: 228 KB of shared memory, 1 KB of it reserved per block
static_assert(kMinBlocksPerSm * (kSmemBytes + 1024 + 16) <= 228 * 1024, "occupancy");
static_assert(kStageBytes / (4 * kPassCols) >= 1, "a stage holds one row");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// the barrier's pending count drops by one once every cp.async this thread
// issued before has landed (the barrier counts 32 such arrivals a stage)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

// lane l's indices of ring stage t: events l, l + 32, ... of the stage (0
// past the row's end)
__device__ __forceinline__ void load_indices(int (&idx)[kIdxRegs], const int32_t* row_gidx,
                                             long long t, int ev_per_stage, long long len,
                                             int lane) {
#pragma unroll
  for (int j = 0; j < kIdxRegs; ++j) {
    const int i = 32 * j + lane;
    const long long e = t * ev_per_stage + i;
    idx[j] = (i < ev_per_stage && e < len) ? row_gidx[e] : 0;
  }
}

// events per ring stage at pass width w
__host__ __device__ constexpr int stage_events(int w) {
  return kStageBytes / (4 * w) < kMaxStageEvents ? kStageBytes / (4 * w) : kMaxStageEvents;
}

// one warp's copies of a stage's n gathered rows at a width known here (a
// multiple of 4 that divides 128), 16 bytes a lane: lane l copies bytes
// [16 q, 16 q + 16) of event kEvPerCopy i + sub, its index shuffled from the
// lane that loaded it; unrolled, every copy independent of the others
template <int kW>
__device__ __forceinline__ void fill_stage(uint32_t dst0, const float* src0, int rank,
                                           const int (&idx)[kIdxRegs], int n, int lane) {
  constexpr int kCpe = kW / 4;               // copies per event
  constexpr int kEvPerCopy = 32 / kCpe;      // events per warp-wide copy
  constexpr int kN = stage_events(kW);
  static_assert(kN % 32 == 0 || 32 % kN == 0, "a stage's indices fill whole registers");
  const int q = lane % kCpe;
  const int sub = lane / kCpe;
#pragma unroll
  for (int i = 0; i < kN / kEvPerCopy; ++i) {
    const int e = i * kEvPerCopy + sub;
    const int g = __shfl_sync(kFull, idx[(i * kEvPerCopy) / 32], e & 31);
    if (e < n) {
      cp_async16(dst0 + 4u * (e * kW + 4 * q), src0 + static_cast<long long>(g) * rank + 4 * q);
    }
  }
}

// acc + st[0] + st[kW] + ... + st[(kN - 1) kW], left to right: a full stage
// at a width known here, unrolled, every read one shared-memory load at a
// fixed offset that the compiler issues ahead of the chain of adds
template <int kW>
__device__ __forceinline__ float add_full_stage(const float* st, float acc) {
#pragma unroll
  for (int e = 0; e < stage_events(kW); ++e) acc += st[e * kW];
  return acc;
}

// acc + st[0] + st[w] + ... + st[(n - 1) w], left to right; each group's
// reads are issued before the previous group's adds
__device__ __forceinline__ float add_stage(const float* st, int w, int n, float acc) {
  int e = 0;
  if (n >= kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) v[j] = st[j * w];
    for (e = kUnroll; e + kUnroll <= n; e += kUnroll) {
      float nx[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) nx[j] = st[(e + j) * w];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) acc += v[j];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) v[j] = nx[j];
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) acc += v[j];
  }
  for (; e < n; ++e) acc += st[e * w];
  return acc;
}

// one short row, events [begin, end), on one warp, lanes over the columns;
// `first` is lane l's index of event begin + l (0 past the end)
__device__ __forceinline__ void short_row(const float* __restrict__ mat,
                                          const int32_t* __restrict__ gidx,
                                          float* __restrict__ out, int row, long long begin,
                                          long long end, int first, int rank, int lane) {
  for (int c0 = 0; c0 < rank; c0 += 32) {
    const int col = c0 + lane;
    const bool active = col < rank;
    float acc = 0.0f;
    int my_idx = c0 == 0 ? first : (begin + lane < end ? gidx[begin + lane] : 0);
    for (long long e0 = begin; e0 < end; e0 += kBatch) {
      const long long left = end - e0;
      const int n = left < kBatch ? static_cast<int>(left) : kBatch;
      const int next_idx = e0 + kBatch + lane < end ? gidx[e0 + kBatch + lane] : 0;
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
      my_idx = next_idx;
    }
    if (active) out[static_cast<long long>(row) * rank + col] = acc;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
segsum_kernel(const float* __restrict__ mat, const int64_t* __restrict__ offsets,
              const int32_t* __restrict__ gidx, const int32_t* __restrict__ order,
              float* __restrict__ out, int* __restrict__ counter, int n_out,
              int n_long, int rank) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int item_s;
  float* ring = reinterpret_cast<float*>(smem);
  int* idx_scratch = reinterpret_cast<int*>(smem + kRingBytes);
  const uint32_t ring0 = smem_u32(ring);
  const uint32_t full0 = smem_u32(smem + kRingBytes + kIdxBytes);
  const uint32_t empty0 = full0 + 8 * kStages;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // long-row roles: warps [0, nc) add, warps [nc, nc + np) fill stages; a
  // producer warp never fills more than one stage past a use it has waited
  // for, so np <= kStages keeps every parity wait unambiguous
  const int nc = min((rank + 31) / 32, kPassCols / 32);
  const int np = min(kWarps - nc, kStages);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 32);  // every lane of the filling warp
      mbar_init(empty0 + 8 * s, nc);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int n_items = n_long + (n_out - n_long + kShortRowsPerItem - 1) / kShortRowsPerItem;
  long long seq = 0;  // ring stages used so far; the same in every thread
  for (;;) {
    if (threadIdx.x == 0) item_s = atomicAdd(counter, 1);
    __syncthreads();
    const int item = item_s;
    if (item >= n_items) break;

    if (item >= n_long) {
      // ---- short rows, one warp each: this warp's rows r0 + kWarps i; lane
      // i holds the id and bounds of row i, and each row's first indices
      // load while the row before it sums
      const long long r0 =
          n_long + static_cast<long long>(item - n_long) * kShortRowsPerItem + warp;
      int my_row = -1;
      long long my_begin = 0, my_end = 0;
      if (lane < kRowsPerWarp && r0 + kWarps * lane < n_out) {
        my_row = order[r0 + kWarps * lane];
        my_begin = offsets[my_row];
        my_end = offsets[my_row + 1];
      }
      long long begin = __shfl_sync(kFull, my_begin, 0);
      long long end = __shfl_sync(kFull, my_end, 0);
      int first = begin + lane < end ? gidx[begin + lane] : 0;
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int row = __shfl_sync(kFull, my_row, i);
        if (row < 0) break;
        const int k = i + 1 < kRowsPerWarp ? i + 1 : i;
        const long long next_begin = __shfl_sync(kFull, my_begin, k);
        const long long next_end = i + 1 < kRowsPerWarp ? __shfl_sync(kFull, my_end, k) : 0;
        const int next_first =
            next_begin + lane < next_end ? gidx[next_begin + lane] : 0;
        short_row(mat, gidx, out, row, begin, end, first, rank, lane);
        begin = next_begin;
        end = next_end;
        first = next_first;
      }
      __syncthreads();
      continue;
    }

    // ---- one long row, the whole block through the ring
    const int row = order[item];
    const long long begin = offsets[row];
    const long long len = offsets[row + 1] - begin;
    for (int c0 = 0; c0 < rank; c0 += kPassCols) {
      const int w = min(kPassCols, rank - c0);
      const int ev_per_stage = stage_events(w);
      const long long n_stages = (len + ev_per_stage - 1) / ev_per_stage;
      // the ring position of this pass's first stage
      const int slot0 = static_cast<int>(seq % kStages);
      const uint32_t parity0 = static_cast<uint32_t>((seq / kStages) & 1);
      if (warp < nc) {
        // consumer: lane `col` of this warp's 32 columns
        const int col = 32 * warp + lane;
        const bool active = col < w;
        const float* base = ring + (active ? col : 0);
        const bool full_width = w == 32 || w == 64 || w == 128;
        float acc = 0.0f;
        int slot = slot0;
        uint32_t parity = parity0;
        for (long long t = 0; t < n_stages; ++t) {
          mbar_wait(full0 + 8 * slot, parity);
          const long long left = len - t * ev_per_stage;
          const int n = left < ev_per_stage ? static_cast<int>(left) : ev_per_stage;
          const float* st = base + slot * kStageFloats;
          if (full_width && n == ev_per_stage) {
            acc = w == 32   ? add_full_stage<32>(st, acc)
                  : w == 64 ? add_full_stage<64>(st, acc)
                            : add_full_stage<128>(st, acc);
          } else {
            acc = add_stage(st, w, n, acc);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * slot);
          if (++slot == kStages) {
            slot = 0;
            parity ^= 1;
          }
        }
        if (active) out[static_cast<long long>(row) * rank + c0 + col] = acc;
      } else if (warp - nc < np) {
        // producer: stages p, p + np, p + 2 np, ... of this pass; lane l
        // copies events l, l + 32, ... of a stage, their indices loaded while
        // this warp's previous stage filled
        const int p = warp - nc;
        const float* src0 = mat + c0;
        const int32_t* row_gidx = gidx + begin;
        const bool wide = kVec && (w == 32 || w == 64 || w == 128);
        int* idx_s = idx_scratch + warp * kMaxStageEvents;
        int idx[kIdxRegs];
        load_indices(idx, row_gidx, p, ev_per_stage, len, lane);
        int slot = slot0 + p;
        uint32_t parity = parity0;
        if (slot >= kStages) {
          slot -= kStages;
          parity ^= 1;
        }
        for (long long t = p; t < n_stages; t += np) {
          const long long left = len - t * ev_per_stage;
          const int n = left < ev_per_stage ? static_cast<int>(left) : ev_per_stage;
          const uint32_t dst0 = ring0 + 4u * slot * kStageFloats;
          if (!wide) {
            // other widths: the indices go through shared memory
#pragma unroll
            for (int j = 0; j < kIdxRegs; ++j) {
              if (32 * j + lane < n) idx_s[32 * j + lane] = idx[j];
            }
            __syncwarp();
          }
          mbar_wait(empty0 + 8 * slot, parity ^ 1);
          if (w == 32 && wide) {
            fill_stage<32>(dst0, src0, rank, idx, n, lane);
          } else if (w == 64 && wide) {
            fill_stage<64>(dst0, src0, rank, idx, n, lane);
          } else if (w == 128 && wide) {
            fill_stage<128>(dst0, src0, rank, idx, n, lane);
          } else {
            // one 4-byte copy per value, event-major as the stage lays them
            for (int k = lane; k < n * w; k += 32) {
              const int e = k / w;
              cp_async4(dst0 + 4u * k,
                        src0 + static_cast<long long>(idx_s[e]) * rank + (k - e * w));
            }
          }
          cp_async_arrive(full0 + 8 * slot);
          __syncwarp();  // idx_s is read before the next stage rewrites it
          load_indices(idx, row_gidx, t + np, ev_per_stage, len, lane);
          slot += np;  // np <= kStages: at most one wrap
          if (slot >= kStages) {
            slot -= kStages;
            parity ^= 1;
          }
        }
      }
      seq += n_stages;
      __syncthreads();
    }
  }
}

template <bool kVec>
cudaError_t plan_for(int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      segsum_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, segsum_kernel<kVec>,
                                                       kThreads, kSmemBytes);
}

}  // namespace

// The launch plan at rank `rank` on the current device, into plan[0..6]:
// events per ring stage (first pass), ring stages, dynamic shared memory
// bytes per block, blocks per SM, SMs, consumer warps, producer warps.
// Returns the CUDA error code.
extern "C" int kmls_segsum_plan(int rank, int* plan) {
  if (rank <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = plan_for<true>(&per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int w = rank < kPassCols ? rank : kPassCols;
  const int nc = (w + 31) / 32;
  plan[0] = stage_events(w);
  plan[1] = kStages;
  plan[2] = kSmemBytes;
  plan[3] = per_sm;
  plan[4] = sms;
  plan[5] = nc;
  plan[6] = kWarps - nc < kStages ? kWarps - nc : kStages;
  return static_cast<int>(cudaSuccess);
}

// out (n_out, rank) f32 <- segment sums of mat (n_in, rank) f32 over the CSR
// (offsets int64 (n_out + 1), gidx int32 (nnz)), rows taken in `order`
// (int32 (n_out,), a permutation, the first n_long summed through the ring).
// `counter` is one int32 on the device, zero at the launch. The caller
// guarantees 0 <= gidx < n_in and monotone offsets. Launches on `stream`,
// does not synchronise, and returns the CUDA error code.
extern "C" int kmls_segsum(const void* mat, const void* offsets, const void* gidx,
                           const void* order, void* out, void* counter, long long n_out,
                           long long n_long, int rank, void* stream) {
  if (n_out < 0 || n_out > 0x7fffffffLL || n_long < 0 || n_long > n_out || rank <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = rank % 4 == 0 && reinterpret_cast<uintptr_t>(mat) % 16 == 0;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = vec ? plan_for<true>(&per_sm) : plan_for<false>(&per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long items =
      n_long + (n_out - n_long + kShortRowsPerItem - 1) / kShortRowsPerItem;
  const long long grid = items < 1LL * per_sm * sms ? items : 1LL * per_sm * sms;
  void (*kernel)(const float*, const int64_t*, const int32_t*, const int32_t*, float*,
                 int*, int, int, int) = vec ? &segsum_kernel<true> : &segsum_kernel<false>;
  kernel<<<static_cast<unsigned>(grid), kThreads, kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mat), static_cast<const int64_t*>(offsets),
      static_cast<const int32_t*>(gidx), static_cast<const int32_t*>(order),
      static_cast<float*>(out), static_cast<int*>(counter), static_cast<int>(n_out),
      static_cast<int>(n_long), rank);
  return static_cast<int>(cudaGetLastError());
}
