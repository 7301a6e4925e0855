// The event list of the device-born catalog, written by hand for Hopper
// (sm_90a): every (playlist, track) membership of config 4's Bernoulli-Zipf
// model as two int32 columns, ordered by (track, playlist), with no host
// array at all. Two kernels, each a count pass and a write pass; the
// wrapper (ops/events.py) turns the counts into each unit's first output
// slot with one cumulative sum, allocates the list once and launches the
// writes.
//
// bitset_events: the set bits of the candidate head's (rows, w_width)
// bitset (ops/csrc/bernoulli_bits.cu's output). One warp takes a tile of
// kTileWords consecutive words of one row: lane L reads word
// w0 + 32 s + L at step s, so the warp's loads are one 128-byte line. The
// count pass sums the tile's popcounts. The write pass scans each step's
// 32 popcounts across the warp (the order of the words) and each lane
// writes its word's set bits, lowest first: playlist 32 w + b, track row.
// Tiles run in row-major order, so the list comes out ordered by (track,
// playlist). What bounds it: the bitset read twice (9.8 GB at config 4)
// and the events written once.
//
// tail_events: the tracks past the head, which the bitset does not draw.
// Track t's memberships are drawn by geometric gaps, one thread a track:
// draw j is threefry2x32(key, (t, j)) -> (y0, y1); its 53 bits
// n = (y0 >> 11) * 2^32 + y1 give the uniform u = (n + 1) * 2^-53 of
// (0, 1]; the gap is g = floor(log(u) / log(1 - q_t)), and the next
// playlist is pos + 1 + g (pos starts at -1); the track ends at the first
// draw whose playlist would reach n_playlists. Every float operation is
// one IEEE-rounded float64 add, multiply or divide (the intrinsics
// forbid fused multiply-adds) and the logarithm is log_basic below, built
// of those alone: so a plain version anywhere (ops/events.py, the
// benchmark's reference) gives the same gaps bit for bit. What bounds it:
// integer issue (a threefry2x32 per draw) and the events written once;
// the longest track's chain of draws (~4,400 at config 4) runs on one lane.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileSteps = 32;
constexpr int kTileWords = 32 * kTileSteps;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kKeyParity = 0x1BD11BDAu;

// log_basic's constants: sqrt(2), ln(2) and 1 / (2k + 1), k = 0..10, each
// the float64 nearest the real number (Python's float.hex of them)
constexpr double kSqrt2 = 0x1.6a09e667f3bcdp+0;
constexpr double kLn2 = 0x1.62e42fefa39efp-1;
constexpr int kTerms = 11;
__constant__ double kInvOdd[kTerms] = {
    0x1.0000000000000p+0, 0x1.5555555555555p-2, 0x1.999999999999ap-3,
    0x1.2492492492492p-3, 0x1.c71c71c71c71cp-4, 0x1.745d1745d1746p-4,
    0x1.3b13b13b13b14p-4, 0x1.1111111111111p-4, 0x1.e1e1e1e1e1e1ep-5,
    0x1.af286bca1af28p-5, 0x1.8618618618618p-5};

// the tile's row, its first word, and this lane
struct Tile {
  int64_t row, w0;
};

__device__ __forceinline__ Tile tile_of(int64_t tile, int64_t tiles_per_row) {
  const int64_t row = tile / tiles_per_row;
  return {row, (tile - row * tiles_per_row) * kTileWords};
}

__global__ void __launch_bounds__(kThreads)
bitset_events_count(const uint32_t* __restrict__ bits, int64_t w_width, int64_t words,
                    int64_t tiles_per_row, int64_t n_tiles, int32_t* __restrict__ counts) {
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (tile >= n_tiles) return;
  const int lane = threadIdx.x & 31;
  const Tile t = tile_of(tile, tiles_per_row);
  const uint32_t* src = bits + t.row * w_width;
  int c = 0;
#pragma unroll 8
  for (int s = 0; s < kTileSteps; ++s) {
    const int64_t w = t.w0 + s * 32 + lane;
    if (w < words) c += __popc(__ldg(src + w));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
  if (lane == 0) counts[tile] = c;
}

__global__ void __launch_bounds__(kThreads)
bitset_events_write(const uint32_t* __restrict__ bits, int64_t w_width, int64_t words,
                    int64_t tiles_per_row, int64_t n_tiles, const int64_t* __restrict__ starts,
                    int32_t* __restrict__ playlists, int32_t* __restrict__ tracks) {
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (tile >= n_tiles) return;
  const int lane = threadIdx.x & 31;
  const Tile t = tile_of(tile, tiles_per_row);
  const uint32_t* src = bits + t.row * w_width;
  const int32_t track = static_cast<int32_t>(t.row);
  int64_t base = starts[tile];
  for (int s = 0; s < kTileSteps; ++s) {
    const int64_t w = t.w0 + s * 32 + lane;
    uint32_t word = w < words ? __ldg(src + w) : 0u;
    const int c = __popc(word);
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += up;
    }
    int64_t at = base + incl - c;
    const int32_t first = static_cast<int32_t>(w * 32);
    while (word) {
      playlists[at] = first + (__ffs(word) - 1);
      tracks[at] = track;
      ++at;
      word &= word - 1u;
    }
    base += __shfl_sync(kFull, incl, 31);
  }
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// threefry2x32 of the counter (x0, x1) under the key (k0, k1): 20 rounds,
// a key injection after every four
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0,
                                              uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kKeyParity};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t a = x0 + ks[0], b = x1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a += b;
      b = rotl(b, kRot[i % 2][r]) ^ a;
    }
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(a, b);
}

// log(x) for x of (0, 1] from IEEE-rounded adds, multiplies and divides
// alone: x = m 2^e with m of [sqrt(1/2), sqrt(2)), s = (m - 1) / (m + 1),
// log m = 2 s (1 + s^2/3 + ... + s^20/21) by Horner (|s| <= 0.1716, so the
// series' rest is below 2^-53), plus e ln 2. Zero gives -1023 ln 2.
__device__ __forceinline__ double log_basic(double x) {
  const long long bits = __double_as_longlong(x);
  int e = static_cast<int>((bits >> 52) & 0x7ff) - 1023;
  double m = __longlong_as_double((bits & 0xFFFFFFFFFFFFFLL) | 0x3FF0000000000000LL);
  if (m > kSqrt2) {
    m = __dmul_rn(m, 0.5);
    e += 1;
  }
  const double s = __ddiv_rn(__dsub_rn(m, 1.0), __dadd_rn(m, 1.0));
  const double z = __dmul_rn(s, s);
  double p = kInvOdd[kTerms - 1];
#pragma unroll
  for (int k = kTerms - 2; k >= 0; --k) p = __dadd_rn(__dmul_rn(p, z), kInvOdd[k]);
  return __dadd_rn(__dmul_rn(static_cast<double>(e), kLn2), __dmul_rn(__dadd_rn(s, s), p));
}

// walk track `track`'s draws: with out == nullptr count them, else write
// them from slot `at` on
__device__ __forceinline__ int64_t walk_track(double q, uint32_t track, int64_t n_playlists,
                                              uint32_t k0, uint32_t k1, int64_t at,
                                              int32_t* __restrict__ playlists,
                                              int32_t* __restrict__ tracks) {
  if (!(q > 0.0)) return 0;
  const double log_keep = log_basic(__dsub_rn(1.0, q));
  int64_t pos = -1, n = 0;
  for (uint32_t j = 0;; ++j) {
    const uint2 y = threefry2x32(k0, k1, track, j);
    const uint64_t m = (static_cast<uint64_t>(y.x >> 11) << 32) | y.y;
    const double u = __dmul_rn(static_cast<double>(m + 1u), 0x1p-53);
    const double g = floor(__ddiv_rn(log_basic(u), log_keep));
    if (!(g < static_cast<double>(n_playlists - 1 - pos))) break;
    pos += 1 + static_cast<int64_t>(g);
    if (playlists != nullptr) {
      playlists[at + n] = static_cast<int32_t>(pos);
      tracks[at + n] = static_cast<int32_t>(track);
    }
    ++n;
  }
  return n;
}

__global__ void __launch_bounds__(kThreads)
tail_events_count(const double* __restrict__ q, int64_t n_tracks, int64_t first_track,
                  int64_t n_playlists, uint32_t k0, uint32_t k1, int32_t* __restrict__ counts) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_tracks) return;
  counts[i] = static_cast<int32_t>(walk_track(q[i], static_cast<uint32_t>(first_track + i),
                                              n_playlists, k0, k1, 0, nullptr, nullptr));
}

__global__ void __launch_bounds__(kThreads)
tail_events_write(const double* __restrict__ q, int64_t n_tracks, int64_t first_track,
                  int64_t n_playlists, uint32_t k0, uint32_t k1,
                  const int64_t* __restrict__ starts, int32_t* __restrict__ playlists,
                  int32_t* __restrict__ tracks) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_tracks) return;
  walk_track(q[i], static_cast<uint32_t>(first_track + i), n_playlists, k0, k1, starts[i],
             playlists, tracks);
}

bool grid_of(long long units, long long per_block, unsigned* grid) {
  const long long g = (units + per_block - 1) / per_block;
  if (g <= 0 || g > 0x7FFFFFFFLL) return false;
  *grid = static_cast<unsigned>(g);
  return true;
}

}  // namespace

// bits: (rows, w_width) uint32, of which the first `words` words of each
// row are read; counts: (rows * tiles_per_row,) int32, tiles_per_row =
// ceil(words / 1024).
extern "C" int kmls_bitset_events_count(const void* bits, long long rows, long long w_width,
                                        long long words, void* counts, void* stream) {
  if (rows <= 0 || words <= 0 || words > w_width || words > (1LL << 26)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles_per_row = (words + kTileWords - 1) / kTileWords;
  unsigned grid;
  if (!grid_of(rows * tiles_per_row, kWarps, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  bitset_events_count<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), w_width, words, tiles_per_row, rows * tiles_per_row,
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// starts: (rows * tiles_per_row,) int64, each tile's first slot in the
// list; playlists, tracks: the list's int32 columns.
extern "C" int kmls_bitset_events_write(const void* bits, long long rows, long long w_width,
                                        long long words, const void* starts, void* playlists,
                                        void* tracks, void* stream) {
  if (rows <= 0 || words <= 0 || words > w_width || words > (1LL << 26)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles_per_row = (words + kTileWords - 1) / kTileWords;
  unsigned grid;
  if (!grid_of(rows * tiles_per_row, kWarps, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  bitset_events_write<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), w_width, words, tiles_per_row, rows * tiles_per_row,
      static_cast<const int64_t*>(starts), static_cast<int32_t*>(playlists),
      static_cast<int32_t*>(tracks));
  return static_cast<int>(cudaGetLastError());
}

// q: (n_tracks,) float64, the membership probability of tracks
// first_track .. first_track + n_tracks - 1; key: the tail's threefry key;
// counts: (n_tracks,) int32.
extern "C" int kmls_tail_events_count(const void* q, long long n_tracks, long long first_track,
                                      long long n_playlists, unsigned k0, unsigned k1,
                                      void* counts, void* stream) {
  if (n_tracks <= 0 || first_track < 0 || first_track + n_tracks > 0x7FFFFFFFLL ||
      n_playlists <= 0 || n_playlists > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned grid;
  if (!grid_of(n_tracks, kThreads, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  tail_events_count<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(q), n_tracks, first_track, n_playlists, k0, k1,
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// starts: (n_tracks,) int64, each track's first slot in the list.
extern "C" int kmls_tail_events_write(const void* q, long long n_tracks, long long first_track,
                                      long long n_playlists, unsigned k0, unsigned k1,
                                      const void* starts, void* playlists, void* tracks,
                                      void* stream) {
  if (n_tracks <= 0 || first_track < 0 || first_track + n_tracks > 0x7FFFFFFFLL ||
      n_playlists <= 0 || n_playlists > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned grid;
  if (!grid_of(n_tracks, kThreads, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  tail_events_write<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(q), n_tracks, first_track, n_playlists, k0, k1,
      static_cast<const int64_t*>(starts), static_cast<int32_t*>(playlists),
      static_cast<int32_t*>(tracks));
  return static_cast<int>(cudaGetLastError());
}
