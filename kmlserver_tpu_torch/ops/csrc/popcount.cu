// Pair-support counts over bit-packed baskets, written by hand for Hopper
// (sm_90a):
//
//     C[i, j] = sum_w popcount(Bt[i, w] & Bt[j, w]) = sum_k U[i, k] * U[j, k]
//
// where Bt (V_pad, W_pad) holds track i's playlist membership as 32-bit
// words, U = unpack_bits(Bt) in {0, 1} holds one int8 per bit, and
// C (V_pad, V_pad) int32 is the pair co-occurrence matrix.
//
// Replaces the Pallas TPU kernel in kmlserver_tpu/ops/popcount.py:245-287,
// _popcount_padded_jit (the pallas_call) with its bodies _kernel_bcast
// (default) and _kernel_row; both variants map to this one kernel. It is
// also the counterpart of the reference's XLA route _mxu_padded_jit
// (:318-346), which computes the same C as an int8 product of unpacked
// word slabs.
//
// What bounds it on an H100: int8 tensor-core operations. One triangle of
// C is V_pad (V_pad + 1) / 2 * 32 W_pad multiply-adds: at 8,192 x 31,744
// words 6.8e13 int8 operations, 34 ms at the published 1,979 TOP/s, while
// the bitset read once and C written once take 0.4 ms at 3.35 TB/s.
//
// Design:
//   - one triangle: the grid holds only the 128 x 128 output tiles with
//     bj >= bi. An off-diagonal tile writes its block and the transposed
//     block, both staged through shared memory so both stores are
//     coalesced; a diagonal tile computes and writes its whole square.
//     Every cell of C is written once: no zero-init pass, no atomics. The
//     K loop stays inside the block and sums in int32 registers (counts
//     are at most 32 W_pad < 2^31).
//   - int8 tensor cores: two consumer warpgroups each issue wgmma
//     m64n128k32 (s8 x s8 -> s32) for 64 rows of the tile.
//   - the unpack is fused into the operand load; the unpacked operand never
//     exists in device memory. One 32-bit word of a row is exactly the 32
//     int8 values of one k32 step. A (the tile's rows) stays packed in
//     shared memory and each consumer thread expands its fragment in
//     registers, (w >> j) & 0x01010101 giving 4 bytes of 0/1. B (the tile's
//     columns) is expanded by a producer warpgroup into shared memory in
//     the canonical K-major layout with the 128-byte swizzle. Both sides
//     put bit j + 8e of word q at k = 32q + 4(j mod 4) + 16(j / 4) + e, so
//     the two operands agree on k (a mismatch would still give a symmetric
//     C, wrong on any bitset with unequal rows).
//   - a ring of kStages shared-memory stages (4 words of every row each)
//     with full/empty mbarriers: the producer fills stages ahead while the
//     consumers multiply, and keeps the global loads of the next kAhead
//     stage pairs in flight in registers, one 32-byte sector of each row
//     per pair. A consumer warpgroup waits for its own products before it
//     writes the next stage's A fragments (see the consumer loop); the
//     other warpgroup's products fill that gap.
//   - the block tile is a compile-time constant; the KMLS_POPCOUNT_TILE_I/J
//     knobs only set the padding unit of V. Ragged edges are masked: rows
//     past V_pad and words past W_pad load as zero, and where rows are not
//     16-byte aligned (W_pad not a multiple of 4, or a base pointer off a
//     16-byte boundary) the kernel is built with 4-byte loads.
//
// The SWAR kernel at the end is the reference's swar=True path
// (_popcount_words, popcount.py:160-171: a shift-add popcount, no popcount
// primitive), a SIMT kernel whose block tile follows the knobs at run time.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// ------------------------------------------------------------ tensor cores

constexpr int kTile = 128;          // square output tile of one block
constexpr int kStageWords = 4;      // words of every row per stage (k = 128)
constexpr int kStages = 6;          // shared-memory ring depth
constexpr int kAhead = 4;           // stage pairs of global loads in flight
constexpr int kThreads = 384;       // warpgroup 0 produces, 1 and 2 consume
constexpr int kBStageBytes = kTile * kStageWords * 32;  // unpacked B: 16 KB
constexpr int kAStageBytes = kTile * kStageWords * 4;   // packed A: 2 KB
constexpr int kRingBytes = kStages * (kBStageBytes + kAStageBytes);
constexpr int kOutStride = kTile + 1;  // int32 per staged output row
constexpr int kSmemBytes = 1024 + kRingBytes + 2 * kStages * 8;
constexpr uint32_t kByteOnes = 0x01010101u;

static_assert(kTile * kOutStride * 4 <= kStages * kBStageBytes,
              "the output staging overlays the B ring");

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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// keeps the compiler from moving or reusing registers that an in-flight
// wgmma reads or writes
template <int kN>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// K-major B tile, 128-byte swizzle: 8-row atoms of 128-byte rows, atoms
// 1024 bytes apart (the stride byte offset); the leading byte offset is not
// read in this mode
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// D (64 x 128, s32) += A (64 x 32, s8, registers) * B (128 x 32, s8, shared)^T
__device__ __forceinline__ void wgmma_m64n128k32(uint32_t (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n\t}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// bits j, j + 8, j + 16, j + 24 of w as four 0/1 bytes
__device__ __forceinline__ uint32_t spread(uint32_t w, int j) {
  return (w >> j) & kByteOnes;
}

// words [w0, w0 + 8) of a row (one 32-byte sector when wide); zeros past
// w_pad and for a row past V_pad
template <bool kWide>
__device__ __forceinline__ void load_words(const uint32_t* row, bool ok, int w0,
                                           int w_pad, uint32_t (&v)[8]) {
  if constexpr (kWide) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (ok && w0 + 4 * h < w_pad) {
        x = __ldg(reinterpret_cast<const uint4*>(row + w0 + 4 * h));
      }
      v[4 * h] = x.x;
      v[4 * h + 1] = x.y;
      v[4 * h + 2] = x.z;
      v[4 * h + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = (ok && w0 + e < w_pad) ? __ldg(row + w0 + e) : 0u;
    }
  }
}

// linear block index -> tile (bi, bj), bi <= bj, column by column
__device__ __forceinline__ void triangle_tile(int t, int& bi, int& bj) {
  long long j = static_cast<long long>((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  while ((j + 1) * (j + 2) / 2 <= t) ++j;
  while (j * (j + 1) / 2 > t) --j;
  bj = static_cast<int>(j);
  bi = static_cast<int>(t - j * (j + 1) / 2);
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
    popcount_pairs_tc_kernel(const uint32_t* __restrict__ bt,
                             int32_t* __restrict__ out, int v_pad, int w_pad) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* b_ring = smem;                            // [kStages][16 atoms][8][128 B]
  uint8_t* a_ring = smem + kStages * kBStageBytes;   // [kStages][kTile][4 words]
  const uint32_t full0 = smem_u32(smem + kRingBytes);
  const uint32_t empty0 = full0 + 8 * kStages;

  int bi, bj;
  triangle_tile(blockIdx.x, bi, bj);
  const int i0 = bi * kTile;
  const int j0 = bj * kTile;
  const int n_stages = (w_pad + kStageWords - 1) / kStageWords;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 128);  // every producer thread
      mbar_init(empty0 + 8 * s, 8);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  uint32_t acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0u;

  if (wg == 0) {
    // ---- producer: thread p owns row p of the A band and of the B band
    const int p = threadIdx.x;
    const bool a_ok = i0 + p < v_pad;
    const bool b_ok = j0 + p < v_pad;
    const uint32_t* row_a = bt + static_cast<size_t>(a_ok ? i0 + p : 0) * w_pad;
    const uint32_t* row_b = bt + static_cast<size_t>(b_ok ? j0 + p : 0) * w_pad;
    uint8_t* b_row = b_ring + (p >> 3) * 1024 + (p & 7) * 128;
    const int swz = p & 7;
    const int n_pairs = (n_stages + 1) / 2;
    uint32_t wa[kAhead][8], wb[kAhead][8];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      load_words<kWide>(row_a, a_ok, 8 * j, w_pad, wa[j]);
      load_words<kWide>(row_b, b_ok, 8 * j, w_pad, wb[j]);
    }
    int slot = 0;
    uint32_t phase = 0;
    for (int u0 = 0; u0 < n_pairs; u0 += kAhead) {
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const int u = u0 + j;
        if (u >= n_pairs) break;
        // fill the pair's stages (two, or one at an odd end), then one
        // proxy fence for both: wgmma reads them through the async proxy
        const int n_fill = min(2, n_stages - 2 * u);
        int filled[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h == n_fill) break;
          mbar_wait(empty0 + 8 * slot, phase ^ 1);
          *reinterpret_cast<uint4*>(a_ring + slot * kAStageBytes + p * 16) =
              make_uint4(wa[j][4 * h], wa[j][4 * h + 1], wa[j][4 * h + 2],
                         wa[j][4 * h + 3]);
          uint8_t* dst = b_row + slot * kBStageBytes;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t w = wb[j][4 * h + q];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              // 16-byte chunk 2q + half holds k = 32q + 16 half + [0, 16):
              // its 4-byte lane l is bits 4 half + l + 8e of w
              const int chunk = 2 * q + half;
              *reinterpret_cast<uint4*>(dst + ((chunk ^ swz) << 4)) =
                  make_uint4(spread(w, 4 * half), spread(w, 4 * half + 1),
                             spread(w, 4 * half + 2), spread(w, 4 * half + 3));
            }
          }
          filled[h] = slot;
          if (++slot == kStages) {
            slot = 0;
            phase ^= 1;
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h < n_fill) mbar_arrive(full0 + 8 * filled[h]);
        }
        load_words<kWide>(row_a, a_ok, 8 * (u + kAhead), w_pad, wa[j]);
        load_words<kWide>(row_b, b_ok, 8 * (u + kAhead), w_pad, wb[j]);
      }
    }
  } else {
    // ---- consumers: warpgroup c multiplies rows [64c, 64c + 64) of the tile
    const int warp = (threadIdx.x / 32) % 4;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int ra = 64 * (wg - 1) + 16 * warp + g;  // rows ra and ra + 8
    int slot = 0;
    uint32_t phase = 0;
    for (int s = 0; s < n_stages; ++s) {
      mbar_wait(full0 + 8 * slot, phase);
      const uint8_t* a_stage = a_ring + slot * kAStageBytes;
      const uint4 x0 = *reinterpret_cast<const uint4*>(a_stage + ra * 16);
      const uint4 x1 = *reinterpret_cast<const uint4*>(a_stage + (ra + 8) * 16);
      const uint32_t w0[4] = {x0.x, x0.y, x0.z, x0.w};
      const uint32_t w1[4] = {x1.x, x1.y, x1.z, x1.w};
      // the A fragment of a k32 step: bytes k = 4t + [0, 4) and
      // 16 + 4t + [0, 4) of rows ra and ra + 8
      uint32_t af[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        af[q][0] = spread(w0[q], t);
        af[q][1] = spread(w1[q], t);
        af[q][2] = spread(w0[q], t + 4);
        af[q][3] = spread(w1[q], t + 4);
      }
      const uint32_t b0 = smem_u32(b_ring + slot * kBStageBytes);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q) wgmma_m64n128k32(acc, af[q], b_desc(b0 + 32 * q));
      wgmma_commit();
      // wait for this stage's products before the next stage's fragments
      // are written: a wgmma in flight while registers it reads are
      // redefined makes ptxas serialise every wgmma (its warning C7513),
      // and the other consumer warpgroup keeps the tensor cores busy here
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty0 + 8 * slot);
      if (++slot == kStages) {
        slot = 0;
        phase ^= 1;
      }
    }
    fence_regs(acc);
  }
  __syncthreads();

  // ---- epilogue: stage the tile (over the B ring), then coalesced stores
  int32_t* tile = reinterpret_cast<int32_t*>(smem);
  if (wg > 0) {
    const int warp = (threadIdx.x / 32) % 4;
    const int r0 = 64 * (wg - 1) + 16 * warp + (lane >> 2);
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int n8 = 0; n8 < 16; ++n8) {
      const int col = 8 * n8 + c0;
      tile[r0 * kOutStride + col] = static_cast<int32_t>(acc[4 * n8]);
      tile[r0 * kOutStride + col + 1] = static_cast<int32_t>(acc[4 * n8 + 1]);
      tile[(r0 + 8) * kOutStride + col] = static_cast<int32_t>(acc[4 * n8 + 2]);
      tile[(r0 + 8) * kOutStride + col + 1] = static_cast<int32_t>(acc[4 * n8 + 3]);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
    const int r = idx / kTile;
    const int c = idx % kTile;
    if (i0 + r < v_pad && j0 + c < v_pad) {
      out[static_cast<size_t>(i0 + r) * v_pad + j0 + c] = tile[r * kOutStride + c];
    }
  }
  if (bi != bj) {
    for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
      const int c = idx / kTile;  // output row j0 + c
      const int r = idx % kTile;  // output column i0 + r
      if (j0 + c < v_pad && i0 + r < v_pad) {
        out[static_cast<size_t>(j0 + c) * v_pad + i0 + r] = tile[r * kOutStride + c];
      }
    }
  }
}

// ------------------------------------------------------------------ SWAR

constexpr int kMicro = 4;        // each thread owns a kMicro x kMicro tile
constexpr int kSwarWords = 32;   // words of each row staged per iteration
constexpr int kQuads = kSwarWords / 4;  // 16-byte loads per row per stage

__device__ __forceinline__ int popcount_swar(uint32_t x) {
  x = x - ((x >> 1) & 0x55555555u);
  x = (x & 0x33333333u) + ((x >> 2) & 0x33333333u);
  x = (x + (x >> 4)) & 0x0F0F0F0Fu;
  x = x + (x >> 16);
  x = x + (x >> 8);
  return static_cast<int>(x & 0x3Fu);
}

// one (tile_i, tile_j) output tile per block, both triangles; words staged
// k-major with one padding word per row, a 4 x 4 register tile per thread
__global__ void __launch_bounds__(1024) popcount_pairs_swar_kernel(
    const uint32_t* __restrict__ bt, int32_t* __restrict__ out, int v_pad,
    int w_pad, int tile_i, int tile_j, int vec4) {
  extern __shared__ uint32_t swar_smem[];
  const int a_stride = tile_i + 1;
  const int b_stride = tile_j + 1;
  uint32_t* a_s = swar_smem;                          // [kSwarWords][tile_i + 1]
  uint32_t* b_s = swar_smem + kSwarWords * a_stride;  // [kSwarWords][tile_j + 1]

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

  for (int k0 = 0; k0 < w_pad; k0 += kSwarWords) {
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
    for (int k = 0; k < kSwarWords; ++k) {
      uint32_t a[kMicro];
      uint32_t b[kMicro];
#pragma unroll
      for (int r = 0; r < kMicro; ++r) a[r] = a_s[k * a_stride + ty * kMicro + r];
#pragma unroll
      for (int c = 0; c < kMicro; ++c) b[c] = b_s[k * b_stride + tx + c * cols_per];
#pragma unroll
      for (int r = 0; r < kMicro; ++r) {
#pragma unroll
        for (int c = 0; c < kMicro; ++c) acc[r][c] += popcount_swar(a[r] & b[c]);
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
// contiguous on the device, any 4-byte-aligned base; out: int32
// (v_pad, v_pad) contiguous. Launches on `stream`, does not synchronise,
// and returns the CUDA error code (0 on success).

// The tensor-core kernel: any v_pad >= 1 and 1 <= w_pad < 2^26.
extern "C" int kmls_popcount_pair_counts(const void* bt, void* out, int v_pad,
                                         int w_pad, void* stream) {
  if (v_pad <= 0 || w_pad <= 0 || w_pad > INT32_MAX / 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long bands = (v_pad + kTile - 1) / kTile;
  const long long tiles = bands * (bands + 1) / 2;
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = (w_pad % 4 == 0) && (reinterpret_cast<uintptr_t>(bt) % 16 == 0);
  void (*kernel)(const uint32_t*, int32_t*, int, int) =
      wide ? &popcount_pairs_tc_kernel<true> : &popcount_pairs_tc_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(tiles), kThreads, kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bt), static_cast<int32_t*>(out), v_pad, w_pad);
  return static_cast<int>(cudaGetLastError());
}

// The SWAR kernel: the block tile (tile_i, tile_j) must be multiples of 4
// with at most 1024 threads and 48 KB of staging; the grid masks a ragged
// edge.
extern "C" int kmls_popcount_pair_counts_swar(const void* bt, void* out, int v_pad,
                                              int w_pad, int tile_i, int tile_j,
                                              void* stream) {
  if (v_pad <= 0 || w_pad <= 0 || tile_i <= 0 || tile_j <= 0 ||
      tile_i % kMicro != 0 || tile_j % kMicro != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (tile_i / kMicro) * (tile_j / kMicro);
  const size_t smem =
      sizeof(uint32_t) * kSwarWords * static_cast<size_t>(tile_i + tile_j + 2);
  if (threads > 1024 || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((v_pad + tile_j - 1) / tile_j, (v_pad + tile_i - 1) / tile_i);
  const int vec4 =
      (w_pad % 4 == 0) && (reinterpret_cast<uintptr_t>(bt) % 16 == 0);
  popcount_pairs_swar_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bt), static_cast<int32_t*>(out), v_pad, w_pad,
      tile_i, tile_j, vec4);
  return static_cast<int>(cudaGetLastError());
}
