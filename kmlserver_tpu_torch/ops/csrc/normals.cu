// The ALS init's standard normals on the card, written by hand for Hopper
// (sm_90a): the exact float64 values numpy's Generator(PCG64(seed))
// .standard_normal draws on the host, one stream, rounded to the init's
// float32 rows. The wrapper (ops/normals.py) seeds the stream on the host,
// launches the count pass, turns the counts into each chunk's first output
// slot with one cumulative sum, launches the write pass, and computes the
// rare tail values whose logarithm must be the host's own.
//
// The stream. PCG64: a 128-bit LCG, state <- state * kMult + inc, whose
// output is the XSL-RR of the new state; raw t is the output of step t + 1.
// numpy's ziggurat (random_standard_normal) makes one attempt from raw t:
// idx = r & 255, sign = bit 8, rabs = the next 52 bits, x = rabs * wi[idx]
// (negated by the sign). rabs < ki[idx] accepts x from one raw. Otherwise
// layer 0 is the tail: pairs of uniforms u1, u2 (53-bit doubles of the next
// raws) until 2 * (-log1p(-u2)) > xx^2, xx = -log1p(-u1) / r, and the value
// is +-(r + xx), the sign bit 8 of rabs; any other layer is the wedge: one
// uniform u accepts x when (fi[idx-1] - fi[idx]) * u + fi[idx] <
// exp(-x * x / 2), and a rejection starts a fresh attempt at the next raw.
// So every attempt at raw t uses a fixed number of raws, used(t): 1, 2 (a
// wedge, accepted or not) or 1 + 2k (a tail of k pairs), and the attempts
// the stream makes are the chain t -> t + used(t) from raw 0.
//
// One thread a chunk of `chunk` raws. The chain is cut at barriers: raw s is
// a barrier when no raw t in [s - window, s) has t + used(t) > s, so every
// chain that passes below s lands on s. A thread finds the first barrier at
// or past its chunk's start and the first at or past the next chunk's
// start (the next thread finds the same one), and walks the chain between
// them. That holds while no attempt on the chain uses more than `window`
// raws (at 32, a tail of 16 pairs or more); one that does, or a comparison whose two sides
// lie closer than kSlack (this card's exp and log1p are not glibc's), sets
// a status bit, and the wrapper draws on the host instead. The count pass
// counts each chunk's values and tails; the write pass writes each value,
// rounded as the init rounds it, into its slot: float32, over sqrt(rank)
// in float64 (or float32, where numpy's promotion says so), float32 again.
// A tail's slot gets 0 and its record (slot, sign, u1) goes to a list the
// host finishes with its own log1p.
//
// What bounds it: integer issue (a 128-bit multiply-add and the output
// permutation a raw), over each chunk's raws and its two barrier windows,
// twice (count, then write); the values written once.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLayers = 256;
constexpr uint64_t kMultHi = 0x2360ED051FC65DA4ULL;
constexpr uint64_t kMultLo = 0x4385DF649FCCF645ULL;
constexpr uint64_t kMantissa = 0x000fffffffffffffULL;
// -ziggurat_nor_inv_r of numpy's ziggurat
constexpr double kNegNorInvR = -0x1.183aa6c20e8c1p-2;
constexpr double kTwoM53 = 0x1.0p-53;
// two sides of a comparison closer than this (relative) are not trusted:
// ~45 ulps, where this card's exp and log1p and glibc's each lie within 1
// ulp of the true value (at 1e-12, about one draw in 270 at config 4 met
// a wedge this close and went to the host)
constexpr double kSlack = 1e-14;
// raws past a chunk's start a barrier search gives up after (it ends within
// a few raws but for a run of long attempts no stream makes)
constexpr uint64_t kSearch = 4096;

constexpr int kStatusUnsure = 1;  // an attempt on the chain unsure, or past the window
constexpr int kStatusMissed = 2;  // a chain that did not land on its barrier, or no barrier

struct U128 {
  uint64_t hi, lo;
};

__device__ __forceinline__ U128 mul(U128 a, U128 b) {
  return {__umul64hi(a.lo, b.lo) + a.lo * b.hi + a.hi * b.lo, a.lo * b.lo};
}

__device__ __forceinline__ U128 add(U128 a, U128 b) {
  uint64_t lo = a.lo + b.lo;
  return {a.hi + b.hi + (lo < a.lo ? 1 : 0), lo};
}

struct Pcg {
  U128 state, inc;

  __device__ __forceinline__ uint64_t next() {
    state = add(mul(state, U128{kMultHi, kMultLo}), inc);
    uint64_t x = state.hi ^ state.lo;
    unsigned rot = static_cast<unsigned>(state.hi >> 58);
    return (x >> rot) | (x << ((64u - rot) & 63u));
  }
};

// the state after `delta` steps (Brown's jump of an LCG)
__device__ U128 advance(U128 state, U128 inc, uint64_t delta) {
  U128 acc_mult{0, 1}, acc_plus{0, 0}, cur_mult{kMultHi, kMultLo}, cur_plus = inc;
  while (delta != 0) {
    if (delta & 1) {
      acc_mult = mul(acc_mult, cur_mult);
      acc_plus = add(mul(acc_plus, cur_mult), cur_plus);
    }
    cur_plus = mul(add(cur_mult, U128{0, 1}), cur_plus);
    cur_mult = mul(cur_mult, cur_mult);
    delta >>= 1;
  }
  return add(mul(acc_mult, state), acc_plus);
}

__device__ __forceinline__ double uniform(uint64_t raw) {
  return __dmul_rn(__ull2double_rn(raw >> 11), kTwoM53);
}

struct Tables {
  uint64_t ki[kLayers];
  double wi[kLayers];
  double fi[kLayers];
};

struct Attempt {
  int used;          // raws the attempt reads
  bool emit;         // it gives a value
  bool tail;         // the value is a tail's (the host finishes it)
  bool unsure_used;  // `used` rests on a comparison within kSlack, or passed the cap
  bool unsure_emit;  // `emit` rests on a comparison within kSlack
  int sign;          // a tail's sign
  double x;          // the value, but for a tail
  double u1;         // a tail's accepted u1
};

__device__ __forceinline__ bool near(double a, double b) {
  return fabs(a - b) <= kSlack * fmax(fabs(a), fabs(b));
}

// one attempt from the raw `g` yields next; `g` ends past the raws it used
__device__ Attempt attempt(Pcg& g, const Tables& t, int cap) {
  Attempt a{};
  uint64_t r = g.next();
  int idx = static_cast<int>(r & 0xff);
  r >>= 8;
  int sign = static_cast<int>(r & 1);
  uint64_t rabs = (r >> 1) & kMantissa;
  double x = __dmul_rn(__ull2double_rn(rabs), t.wi[idx]);
  if (sign) x = -x;
  a.used = 1;
  a.x = x;
  if (rabs < t.ki[idx]) {
    a.emit = true;
    return a;
  }
  if (idx == 0) {
    a.tail = true;
    a.sign = static_cast<int>((rabs >> 8) & 1);
    for (;;) {
      if (a.used + 2 > cap) {
        a.unsure_used = true;
        return a;
      }
      double u1 = uniform(g.next());
      double u2 = uniform(g.next());
      a.used += 2;
      double xx = __dmul_rn(kNegNorInvR, log1p(-u1));
      double yy = -log1p(-u2);
      double lhs = __dadd_rn(yy, yy), rhs = __dmul_rn(xx, xx);
      if (near(lhs, rhs)) a.unsure_used = true;
      if (lhs > rhs) {
        a.emit = true;
        a.u1 = u1;
        return a;
      }
    }
  }
  double u = uniform(g.next());
  a.used = 2;
  double lhs = __dadd_rn(__dmul_rn(__dsub_rn(t.fi[idx - 1], t.fi[idx]), u), t.fi[idx]);
  double e = exp(__dmul_rn(__dmul_rn(-0.5, x), x));
  a.unsure_emit = near(lhs, e);
  a.emit = lhs < e;
  return a;
}

// the first barrier at or past raw `lo`; `at` gets the stream there, and
// `found` turns false where the search gave up
__device__ uint64_t barrier(uint64_t lo, U128 state0, U128 inc, int window, const Tables& t,
                            Pcg& at, bool& found) {
  uint64_t s = lo >= static_cast<uint64_t>(window) ? lo - window : 0;
  Pcg g{advance(state0, inc, s), inc};
  uint64_t reach = 0;  // the furthest raw an attempt below s lands on
  for (;;) {
    if (s >= lo && (reach <= s || s - lo >= kSearch)) {
      found = found && reach <= s;
      at = g;
      return s;
    }
    Pcg probe = g;
    Attempt a = attempt(probe, t, window);
    uint64_t end = s + static_cast<uint64_t>(a.unsure_used ? window : a.used);
    reach = end > reach ? end : reach;
    g.next();
    ++s;
  }
}

__device__ void load_tables(Tables& t, const uint64_t* ki, const double* wi,
                            const double* fi) {
  for (int i = threadIdx.x; i < kLayers; i += blockDim.x) {
    t.ki[i] = ki[i];
    t.wi[i] = wi[i];
    t.fi[i] = fi[i];
  }
  __syncthreads();
}

struct Stream {
  uint64_t state_hi, state_lo, inc_hi, inc_lo;
  int64_t chunks;
  int chunk, window;
};

__device__ __forceinline__ U128 start_state(const Stream& st) { return {st.state_hi, st.state_lo}; }
__device__ __forceinline__ U128 increment(const Stream& st) { return {st.inc_hi, st.inc_lo}; }

__global__ void __launch_bounds__(kThreads)
    normals_count(Stream st, const uint64_t* ki, const double* wi, const double* fi,
                  int64_t* counts, int64_t* tails, int* status) {
  __shared__ Tables t;
  load_tables(t, ki, wi, fi);
  int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= st.chunks) return;
  U128 s0 = start_state(st), inc = increment(st);
  Pcg g{}, end_at{};
  bool found = true;
  uint64_t s = barrier(static_cast<uint64_t>(j) * st.chunk, s0, inc, st.window, t, g, found);
  uint64_t stop =
      barrier(static_cast<uint64_t>(j + 1) * st.chunk, s0, inc, st.window, t, end_at, found);
  int64_t n = 0, n_tail = 0;
  int bad = found ? 0 : kStatusMissed;
  while (s < stop) {
    Attempt a = attempt(g, t, st.window);
    if (a.unsure_used || a.unsure_emit) bad |= kStatusUnsure;
    n += a.emit;
    n_tail += a.emit && a.tail;
    s += a.used;
  }
  if (s != stop) bad |= kStatusMissed;
  counts[j] = n;
  tails[j] = n_tail;
  if (bad) atomicOr(status, bad);
}

__global__ void __launch_bounds__(kThreads)
    normals_write(Stream st, const uint64_t* ki, const double* wi, const double* fi,
                  const int64_t* first, const int64_t* tail_first, int64_t n_out,
                  int64_t n_split, float* out0, float* out1, int div64, double scale,
                  float scale32, int64_t* tail_slot, double* tail_u1) {
  __shared__ Tables t;
  load_tables(t, ki, wi, fi);
  int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= st.chunks) return;
  int64_t k = first[j];
  if (k >= n_out) return;  // its tail records stay the wrapper's -1
  U128 s0 = start_state(st), inc = increment(st);
  Pcg g{}, end_at{};
  bool found = true;  // the count pass reported a search that gave up
  uint64_t s = barrier(static_cast<uint64_t>(j) * st.chunk, s0, inc, st.window, t, g, found);
  uint64_t stop =
      barrier(static_cast<uint64_t>(j + 1) * st.chunk, s0, inc, st.window, t, end_at, found);
  int64_t k_tail = tail_first[j];
  while (s < stop) {  // to the end, so the chunk's tail records all get a slot
    Attempt a = attempt(g, t, st.window);
    s += a.used;
    if (!a.emit) continue;
    float y = 0.0f;
    if (a.tail) {
      tail_slot[k_tail] = k | (static_cast<int64_t>(a.sign) << 62);
      tail_u1[k_tail] = a.u1;
      ++k_tail;
    } else {
      float f = __double2float_rn(a.x);
      y = div64 ? __double2float_rn(__ddiv_rn(static_cast<double>(f), scale))
                : __fdiv_rn(f, scale32);
    }
    if (k < n_split) {
      out0[k] = y;
    } else if (k < n_out) {
      out1[k - n_split] = y;
    }
    ++k;
  }
}

unsigned blocks_for(int64_t chunks) {
  return static_cast<unsigned>((chunks + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int kmls_normals_count(uint64_t state_hi, uint64_t state_lo, uint64_t inc_hi, uint64_t inc_lo,
                       int64_t chunks, int chunk, int window, const void* ki, const void* wi,
                       const void* fi, void* counts, void* tails, void* status, void* stream) {
  Stream st{state_hi, state_lo, inc_hi, inc_lo, chunks, chunk, window};
  normals_count<<<blocks_for(chunks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      st, static_cast<const uint64_t*>(ki), static_cast<const double*>(wi),
      static_cast<const double*>(fi), static_cast<int64_t*>(counts),
      static_cast<int64_t*>(tails), static_cast<int*>(status));
  return static_cast<int>(cudaGetLastError());
}

int kmls_normals_write(uint64_t state_hi, uint64_t state_lo, uint64_t inc_hi, uint64_t inc_lo,
                       int64_t chunks, int chunk, int window, const void* ki, const void* wi,
                       const void* fi, const void* first, const void* tail_first,
                       int64_t n_out, int64_t n_split, void* out0, void* out1, int div64,
                       double scale, float scale32, void* tail_slot, void* tail_u1,
                       void* stream) {
  Stream st{state_hi, state_lo, inc_hi, inc_lo, chunks, chunk, window};
  normals_write<<<blocks_for(chunks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      st, static_cast<const uint64_t*>(ki), static_cast<const double*>(wi),
      static_cast<const double*>(fi), static_cast<const int64_t*>(first),
      static_cast<const int64_t*>(tail_first), n_out, n_split, static_cast<float*>(out0),
      static_cast<float*>(out1), div64, scale, scale32, static_cast<int64_t*>(tail_slot),
      static_cast<double*>(tail_u1));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
