// Native CPU serving kernel: batched rule lookup = gather + scatter-max +
// top-k, the exact work of kmlserver_tpu_torch/ops/serve.py's
// recommend_batch. A copy of the reference package's kernel
// (native/kmls_serve.cpp), ABI unchanged; serving/native_serve.py binds it
// and the engine serves through it when it runs on the CPU: a straight
// C++ loop over the (B, L, K) updates instead of a (B, V) scatter-max and
// a full sort per row. Exact, CPU-only, loaded via ctypes.
//
// Semantics parity with ops/serve.py recommend_batch:
// - seeds < 0 are padding; rule rows are -1-padded AFTER their valid
//   prefix (emit order: descending, then -1 fill), so the inner loop may
//   break at the first -1;
// - merge is max over per-seed confidences; only conf > 0 entries can
//   surface (top_ids -1 where top_confs <= 0);
// - top-k tie order: higher conf first, equal confs by LOWER consequent
//   id first (recommend_batch's stable descending sort).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t kAbiVersion = 1;

struct Entry {
  float conf;
  int32_t id;
};

// min-heap comparator: a is "better" than b when it has higher conf, or
// equal conf and LOWER id — the heap keeps the worst entry on top
inline bool better(const Entry& a, const Entry& b) {
  return a.conf > b.conf || (a.conf == b.conf && a.id < b.id);
}
struct WorstOnTop {
  bool operator()(const Entry& a, const Entry& b) const {
    return better(a, b);  // std::*_heap with this puts the WORST first
  }
};

}  // namespace

extern "C" {

int32_t kmls_serve_abi_version() { return kAbiVersion; }

// rule_ids: (v, kmax) int32, -1 padded (trailing); rule_confs: (v, kmax)
// float32; seed_ids: (b, l) int32, -1 padded. Outputs: out_ids (b,
// k_best) int32 with -1 padding, out_confs (b, k_best) float32 with 0.
void kmls_serve_topk(const int32_t* rule_ids, const float* rule_confs,
                     const int32_t* seed_ids, int32_t v, int32_t kmax,
                     int32_t b, int32_t l, int32_t k_best, int32_t* out_ids,
                     float* out_confs) {
  std::vector<float> scores(static_cast<size_t>(v));
  std::vector<int32_t> touched;
  touched.reserve(static_cast<size_t>(l) * kmax);
  std::vector<Entry> heap;
  heap.reserve(k_best > 0 ? k_best : 1);
  for (int32_t r = 0; r < b; ++r) {
    // reset only the slots the previous row touched: a row touches at
    // most l*kmax ids, typically far fewer than v
    for (const int32_t t : touched) scores[t] = 0.0f;
    touched.clear();
    const int32_t* seeds = seed_ids + static_cast<int64_t>(r) * l;
    for (int32_t s = 0; s < l; ++s) {
      const int32_t seed = seeds[s];
      if (seed < 0 || seed >= v) continue;
      const int32_t* ids = rule_ids + static_cast<int64_t>(seed) * kmax;
      const float* confs = rule_confs + static_cast<int64_t>(seed) * kmax;
      for (int32_t k = 0; k < kmax; ++k) {
        const int32_t tid = ids[k];
        if (tid < 0) break;  // trailing padding — rest of the row is empty
        const float c = confs[k];
        if (c > scores[tid]) {
          if (scores[tid] == 0.0f) touched.push_back(tid);
          scores[tid] = c;
        }
      }
    }
    heap.clear();
    for (const int32_t t : touched) {
      const Entry e{scores[t], t};
      if (e.conf <= 0.0f) continue;
      if (static_cast<int32_t>(heap.size()) < k_best) {
        heap.push_back(e);
        std::push_heap(heap.begin(), heap.end(), WorstOnTop{});
      } else if (k_best > 0 && better(e, heap.front())) {
        std::pop_heap(heap.begin(), heap.end(), WorstOnTop{});
        heap.back() = e;
        std::push_heap(heap.begin(), heap.end(), WorstOnTop{});
      }
    }
    // sort_heap leaves best-first (the comparator inverts as in sort)
    std::sort_heap(heap.begin(), heap.end(), WorstOnTop{});
    int32_t* ids_row = out_ids + static_cast<int64_t>(r) * k_best;
    float* conf_row = out_confs + static_cast<int64_t>(r) * k_best;
    const int32_t filled = static_cast<int32_t>(heap.size());
    for (int32_t s = 0; s < filled; ++s) {
      ids_row[s] = heap[s].id;
      conf_row[s] = heap[s].conf;
    }
    for (int32_t s = filled; s < k_best; ++s) {
      ids_row[s] = -1;
      conf_row[s] = 0.0f;
    }
  }
}

}  // extern "C"
