// kmls_popcount — native CPU pair-support counters.
//
// A copy of the reference package's counter (native/kmls_popcount.cpp),
// ABI unchanged; kmlserver_tpu_torch/ops/cpu_popcount.py binds it. It is
// the miner's count route when the caller asks for the CPU: the same XᵀX
// the card's popcount kernel (ops/csrc/popcount.cu) and the int8 product
// (ops/support.py pair_counts) give — symmetric int32, singleton supports
// on the diagonal. Two exact strategies; the Python binding picks by cost
// model:
//
//  - BITSET: C[i][j] = sum_w popcount(bt[i][w] & bt[j][w]) over row-major
//    bitsets bt (v rows, w64 uint64 words per row), i-rows tiled into L2.
//    Cost ~ v²/2 · w64 word-ops regardless of density — wins when the
//    matrix is small or dense.
//  - SPARSE: group memberships by playlist (counting sort), then for each
//    playlist scatter-add every unordered track pair. Cost ~
//    sum_p C(k_p, 2) scatter-adds — wins at large, sparse shapes.
//
// Threaded with a strided partition (bitset path only; the sparse
// scatter's writes collide across playlists). C ABI only, consumed via
// ctypes; the caller owns all buffers. PRECONDITION (both): (playlist,
// track) pairs are deduplicated — the Baskets contract
// (kmlserver_tpu_torch/mining/vocab.py build_baskets) — matching the
// one-hot encoder's boolean set semantics; a duplicate row would
// double-count.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr int32_t kAbiVersion = 4;

// Rows per i-block: IB rows stay L2-resident while each j-row streams
// through ONCE per block, cutting DRAM traffic from V²·row_bytes to
// (V/IB)·V·row_bytes.
constexpr int32_t kIBlock = 16;

// target_clones (x86 only — the names are x86 ISA levels and break the
// build elsewhere): runtime-dispatched variants so one portable .so still
// uses newer ISA where the RUNNING cpu has it. The baseline remains the
// build's -mpopcnt (utils/nativelib.py)
// (POPCNT ships on every x86-64 since 2008).
#if defined(__x86_64__) || defined(__i386__)
__attribute__((target_clones("avx2", "popcnt", "default")))
#endif
void count_blocks_strided(const uint64_t* bt, int32_t v, int64_t w64,
                          int32_t* out, int32_t start_block, int32_t stride) {
  const int32_t n_blocks = (v + kIBlock - 1) / kIBlock;
  for (int32_t b = start_block; b < n_blocks; b += stride) {
    const int32_t i0 = b * kIBlock;
    const int32_t i_hi = i0 + kIBlock < v ? i0 + kIBlock : v;
    for (int32_t j = i0; j < v; ++j) {
      const uint64_t* row_j = bt + static_cast<int64_t>(j) * w64;
      const int32_t i_end = j + 1 < i_hi ? j + 1 : i_hi;
      for (int32_t i = i0; i < i_end; ++i) {
        const uint64_t* row_i = bt + static_cast<int64_t>(i) * w64;
        int64_t acc = 0;
        for (int64_t w = 0; w < w64; ++w) {
          acc += __builtin_popcountll(row_i[w] & row_j[w]);
        }
        const int32_t c = static_cast<int32_t>(acc);
        out[static_cast<int64_t>(i) * v + j] = c;
        out[static_cast<int64_t>(j) * v + i] = c;
      }
    }
  }
}

}  // namespace

extern "C" {

int32_t kmls_popcount_abi_version() { return kAbiVersion; }

// Scatter membership rows into (v, w64) row-major uint64 bitsets: bit
// (p & 63) of word bt[t][p >> 6] set for each (p, t) pair. bt must be
// zeroed by the caller. Single-threaded on purpose: the |= is not atomic,
// and one linear pass at ~4 ns/row beats any numpy route by ~50x (a
// python-side np.bitwise_or.at took 13 s for 50M rows; this takes ~0.2 s).
// Duplicate membership rows OR idempotently.
void kmls_bitpack_rows(const int64_t* playlist_rows, const int32_t* track_ids,
                       int64_t n_rows, int64_t w64, uint64_t* bt) {
  for (int64_t r = 0; r < n_rows; ++r) {
    bt[static_cast<int64_t>(track_ids[r]) * w64 + (playlist_rows[r] >> 6)] |=
        1ull << (playlist_rows[r] & 63);
  }
}

// SPARSE pair counting: counting-sort memberships by playlist, then for
// each playlist scatter-add all C(k, 2) unordered track pairs into the
// upper triangle, finally mirror. out: (v, v) int32, caller-zeroed.
// Single-threaded: scatter targets collide across playlists.
void kmls_pair_counts_sparse(const int64_t* playlist_rows,
                             const int32_t* track_ids, int64_t n_rows,
                             int64_t n_playlists, int32_t v, int32_t* out) {
  if (v <= 0 || n_rows <= 0) return;
  // counting sort by playlist (rows arrive in arbitrary order)
  std::vector<int64_t> offs(n_playlists + 1, 0);
  for (int64_t r = 0; r < n_rows; ++r) offs[playlist_rows[r] + 1]++;
  for (int64_t p = 0; p < n_playlists; ++p) offs[p + 1] += offs[p];
  std::vector<int32_t> grouped(n_rows);
  {
    std::vector<int64_t> cursor(offs.begin(), offs.end() - 1);
    for (int64_t r = 0; r < n_rows; ++r)
      grouped[cursor[playlist_rows[r]]++] = track_ids[r];
  }
  for (int64_t p = 0; p < n_playlists; ++p) {
    const int32_t* t = grouped.data() + offs[p];
    const int64_t k = offs[p + 1] - offs[p];
    for (int64_t a = 0; a < k; ++a) {
      const int32_t ta = t[a];
      out[static_cast<int64_t>(ta) * v + ta] += 1;  // singleton support
      for (int64_t b = a + 1; b < k; ++b) {
        const int32_t tb = t[b];
        if (ta < tb) {
          out[static_cast<int64_t>(ta) * v + tb] += 1;
        } else {
          out[static_cast<int64_t>(tb) * v + ta] += 1;
        }
      }
    }
  }
  for (int32_t i = 0; i < v; ++i) {
    for (int32_t j = i + 1; j < v; ++j) {
      out[static_cast<int64_t>(j) * v + i] =
          out[static_cast<int64_t>(i) * v + j];
    }
  }
}

// Rule emission: per-row top-k of the count matrix by (count desc, column
// asc) — EXACTLY lax.top_k's tie order (ops/rules.py emit_rule_tensors) —
// over valid entries (off-diagonal, count >= min_count). For each row:
// out_ids (v, k) int32 consequent columns (-1 padded), out_counts (v, k)
// int32 (0 padded), out_row_valid (v) int32 = TRUE valid count (may
// exceed k; truncation-overflow detection happens in Python). A bounded
// ascending scan with a composite int64 key (count·v + (v-1-j), strictly
// totally ordered) and a min-heap of size k replaces a (V, V) numpy
// argpartition pass.
void kmls_emit_topk(const int32_t* counts, int32_t v, int32_t min_count,
                    int32_t k, int32_t* out_ids, int32_t* out_counts,
                    int32_t* out_row_valid) {
  std::vector<int64_t> heap;  // min-heap on the composite key
  heap.reserve(k > 0 ? k : 1);
  const auto key_of = [v](int32_t count, int32_t j) {
    return static_cast<int64_t>(count) * v + (v - 1 - j);
  };
  for (int32_t i = 0; i < v; ++i) {
    const int32_t* row = counts + static_cast<int64_t>(i) * v;
    heap.clear();
    int32_t n_valid = 0;
    for (int32_t j = 0; j < v; ++j) {
      const int32_t c = row[j];
      if (c < min_count || j == i) continue;
      ++n_valid;
      // the twins drop count-0 entries even when min_count <= 0
      // (emit_rule_tensors' `keep = top_counts > 0`) — match exactly
      if (k <= 0 || c <= 0) continue;
      const int64_t key = key_of(c, j);
      if (static_cast<int32_t>(heap.size()) < k) {
        heap.push_back(key);
        std::push_heap(heap.begin(), heap.end(), std::greater<int64_t>());
      } else if (key > heap.front()) {
        std::pop_heap(heap.begin(), heap.end(), std::greater<int64_t>());
        heap.back() = key;
        std::push_heap(heap.begin(), heap.end(), std::greater<int64_t>());
      }
    }
    out_row_valid[i] = n_valid;
    // sort_heap with greater<> leaves the keys in DESCENDING order —
    // exactly the emit order (highest count first, ties by smaller j)
    std::sort_heap(heap.begin(), heap.end(), std::greater<int64_t>());
    int32_t* ids_row = out_ids + static_cast<int64_t>(i) * k;
    int32_t* cnt_row = out_counts + static_cast<int64_t>(i) * k;
    const int32_t filled = static_cast<int32_t>(heap.size());
    for (int32_t s = 0; s < filled; ++s) {
      const int64_t key = heap[s];
      ids_row[s] = static_cast<int32_t>(v - 1 - (key % v));
      cnt_row[s] = static_cast<int32_t>(key / v);
    }
    for (int32_t s = filled; s < k; ++s) {
      ids_row[s] = -1;
      cnt_row[s] = 0;
    }
  }
}

// bt: (v, w64) row-major uint64 bitsets; out: (v, v) int32 (fully written).
// n_threads <= 0 means hardware concurrency (capped at 16).
void kmls_pair_counts(const uint64_t* bt, int32_t v, int64_t w64,
                      int32_t* out, int32_t n_threads) {
  if (v <= 0) return;
  if (n_threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    n_threads = static_cast<int32_t>(hc ? (hc > 16 ? 16 : hc) : 4);
  }
  if (n_threads == 1 || v < 2 * n_threads) {
    count_blocks_strided(bt, v, w64, out, 0, 1);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int32_t t = 0; t < n_threads; ++t) {
    threads.emplace_back(count_blocks_strided, bt, v, w64, out, t, n_threads);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
