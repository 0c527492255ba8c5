// Fused summed-delta training step of a Tsetlin Machine on Hopper.
//
// Replaces repro/kernels/tm_train/kernel.py:fused_train_batch, which is
// fused XLA and not Pallas: the TPU's hardware generator cannot give the
// threefry2x32 bits of the seeding contract (repro/core/train.py).  Here
// threefry2x32 is integer code in registers, so the kernel draws the
// reference's streams exactly.  Given the batch's training clause words
// (clause_eval's AND with all ones for empty clauses) and packed literals
// it computes, for the packed int8 state s = state - (N + 1),
//
//     out[m, c, l] = clip(s + sum_i clip(s + delta_i, -N, N-1) - s, -N, N-1)
//
// where delta_i in {-1, 0, 1} is sample i's Type I/II feedback on the TA
// when m is the sample's target or its sampled negative class.
//
// Launch 1 (prologue), a block of four warps per sample: warp r derives
// the sample key fold_in(call, i) and its split into (k_neg, k_tgt,
// k_not), the negative class by randint(k_neg, 0, M-1), moved past the
// label, and for touched row r (target, negative) the clipped class vote
// v over the clause words, p_sel = (T -/+ v) / 2T (IEEE float32 division:
// no fast math) and the row's Type I streams k1, k2.  Then the block
// draws the row's selection uniform of every clause once, from k_sel, and
// stores it as a bit per clause: 24 bytes per (sample, row), its class
// row alone, and ceil(C / 32) words of selection bits.
//
// Launch 2 (update), a block per (tile of literals, clause, class), each
// thread kIpt = 7 TAs of the clause (the paper's 1,568 literals: one tile
// of 224 threads, no idle slot; other widths only idle some lanes), their
// deltas in registers, no atomics on global memory.  Per round of samples the block lists in shared memory those
// whose target or negative is its class and whose selection bit for its
// clause is set; every thread then walks the list, drawing only the
// uniforms its branch reads: the kIpt of a Type I entry together (their
// chains interleave), none for a Type II push.  Draws of clauses that are
// not selected are skipped: the stream is counter-based, so skipping
// costs nothing in exactness.  Integer sums commute, so the list's order
// is free and the result is deterministic.
//
// A uniform is compared as an integer: u = (bits >> 9) * 2^-23 exactly,
// so u < p iff bits <= (ceil(p * 2^23) << 9) - 1 (never when the
// threshold is 0, always when it is 2^23); the thresholds of p_sel,
// strengthen and weaken are computed once, exactly, from the same
// float32 p.
//
// What bounds it on an H100: integer issue.  A step at the paper's MNIST
// width needs ~20M draws against ~6 MB of state moved; each draw is a
// 20-round hash (add, funnel-shift rotate, XOR per round; the key
// schedule is built once per list entry), ~75 SASS instructions, and the
// update's time tracks that count as if every one of them (IADD3,
// IMAD.IADD, LOP3, SHF) took one of the SM's 64 INT32 lanes (PERF.md
// holds the SASS counts and times).  The draws stay in registers (the
// plain version writes each one to device memory).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPrologueThreads = 128;  // a sample per block, warp r: row r
constexpr int kThreads = 256;          // update: at most, per block
constexpr int kIpt = 7;                // update: TAs per thread
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kUnit = 1u << 23;   // the uniform's 23 random bits

struct Key {
  uint32_t a, b;
};

struct Row {     // one (sample, touched class row): 24 bytes
  int32_t m;     // the class row, -1 where the update does not land
  uint32_t sel;  // ceil(p_sel * 2^23): the selection threshold
  Key k1, k2;    // Type I streams: clause fired, clause not fired
};

// u < p for a uniform drawn as bits, given t = ceil(p * 2^23) in [0, 2^23]:
// bits <= lim, never when t is 0
struct Below {
  uint32_t lim;
  bool never;
};

__device__ __forceinline__ Below below_of(uint32_t t) {
  return Below{t >= kUnit ? kFull : (t << 9) - 1u, t == 0};
}

__device__ __forceinline__ bool below(uint32_t bits, Below b) {
  return !b.never && bits <= b.lim;
}

// ceil(p * 2^23) clipped into [0, 2^23]; p * 2^23 is exact in float32
__device__ __forceinline__ uint32_t threshold_of(float p) {
  return p >= 1.0f ? kUnit : p > 0.0f ? (uint32_t)ceilf(p * 8388608.0f) : 0u;
}

enum { kFired = 0, kUnfired = 1, kPush = 2 };

struct Entry {   // one selected (sample, row) of the block's clause
  int32_t i;
  int32_t kind;
  Key k;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// A key's schedule for threefry2x32: the words its five injections add
// (jax/_src/prng.py:_threefry2x32_lowering), built once for every hash
// under the key
struct Sched {
  uint32_t a, b, k2, a2, b3, k4, a5, k1;
};

__device__ __forceinline__ Sched schedule(Key k) {
  const uint32_t k2 = k.a ^ k.b ^ 0x1BD11BDAu;
  return Sched{k.a, k.b, k2, k.a + 2u, k.b + 3u, k2 + 4u, k.a + 5u, k2 + 1u};
}

// n independent threefry lanes, round by round, so their chains interleave
template <int N>
__device__ __forceinline__ void tf_rounds(uint32_t (&x0)[N], uint32_t (&x1)[N],
                                          int r0, int r1, int r2, int r3) {
  const int r[4] = {r0, r1, r2, r3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int q = 0; q < N; ++q) {
      x0[q] += x1[q];
      x1[q] = rotl(x1[q], r[i]) ^ x0[q];
    }
  }
}

template <int N>
__device__ __forceinline__ void tf_inject(uint32_t (&x0)[N], uint32_t (&x1)[N],
                                          uint32_t a, uint32_t b) {
#pragma unroll
  for (int q = 0; q < N; ++q) x0[q] += a, x1[q] += b;
}

// threefry2x32 (20 rounds) of the counters (0, idx[q]) under schedule s
template <int N>
__device__ __forceinline__ void threefry(const Sched& s, const uint32_t (&idx)[N],
                                         uint32_t (&x0)[N], uint32_t (&x1)[N]) {
#pragma unroll
  for (int q = 0; q < N; ++q) x0[q] = s.a, x1[q] = idx[q] + s.b;
  tf_rounds(x0, x1, 13, 15, 26, 6);
  tf_inject(x0, x1, s.b, s.k1);
  tf_rounds(x0, x1, 17, 29, 16, 24);
  tf_inject(x0, x1, s.k2, s.a2);
  tf_rounds(x0, x1, 13, 15, 26, 6);
  tf_inject(x0, x1, s.a, s.b3);
  tf_rounds(x0, x1, 17, 29, 16, 24);
  tf_inject(x0, x1, s.b, s.k4);
  tf_rounds(x0, x1, 13, 15, 26, 6);
  tf_inject(x0, x1, s.k2, s.a5);
}

// the 32 random bits at flat indices idx[q] < 2^32 of any shape; a
// uniform in [0, 1) is (bits >> 9) * 2^-23
template <int N>
__device__ __forceinline__ void random_bits(const Sched& s,
                                            const uint32_t (&idx)[N],
                                            uint32_t (&bits)[N]) {
  uint32_t x0[N], x1[N];
  threefry(s, idx, x0, x1);
#pragma unroll
  for (int q = 0; q < N; ++q) bits[q] = x0[q] ^ x1[q];
}

__device__ __forceinline__ uint32_t random_bits(Key k, uint32_t idx) {
  const uint32_t in[1] = {idx};
  uint32_t out[1];
  random_bits(schedule(k), in, out);
  return out[0];
}

__device__ __forceinline__ Key fold_in(Key k, uint32_t d) {
  const uint32_t in[1] = {d};
  uint32_t x0[1], x1[1];
  threefry(schedule(k), in, x0, x1);
  return Key{x0[0], x1[0]};
}

// randint(k, (), 0, span) in uint32 arithmetic (jax/_src/random.py)
__device__ __forceinline__ uint32_t randint(Key k, uint32_t span) {
  const uint32_t hi = random_bits(fold_in(k, 0u), 0u);
  const uint32_t lo = random_bits(fold_in(k, 1u), 0u);
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  return ((hi % span) * mult + lo % span) % span;
}

__global__ void __launch_bounds__(kPrologueThreads)
prologue_kernel(const int32_t* __restrict__ labels,
                const uint32_t* __restrict__ cw, int n_classes, int n_clauses,
                int w_words, Key call, int threshold, Row* __restrict__ rows,
                int32_t* __restrict__ row_m, uint32_t* __restrict__ sel) {
  __shared__ int s_m[2];
  __shared__ Below s_p[2];
  __shared__ Key s_key[2];
  const int i = blockIdx.x;
  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;
  const int sel_words = (n_clauses + 31) / 32;
  if (r < 2) {
    // every lane of warps 0 and 1 derives the keys: no broadcast needed
    const Key ki = fold_in(call, (uint32_t)i);
    // labels index as the reference's int32 indices: a negative one counts
    // from the end, a read clamps into [0, M), and a target still outside
    // drops its update; the negative is drawn against the label as given
    const int label = labels[i];
    int m;
    bool lands = true;
    if (r == 0) {
      const int y_idx = label < 0 ? label + n_classes : label;
      lands = y_idx >= 0 && y_idx < n_classes;
      m = min(max(y_idx, 0), n_classes - 1);
    } else {
      m = (int)randint(fold_in(ki, 0u), (uint32_t)(n_classes - 1));
      if (m >= label) m += 1;
    }
    const uint32_t* col = cw + (size_t)m * n_clauses * w_words + (i >> 5);
    const int bit = i & 31;
    int sum = 0;  // the class vote: +1 even clauses, -1 odd ones
    for (int c = lane; c < n_clauses; c += 32) {
      const int sat = (int)((col[(size_t)c * w_words] >> bit) & 1u);
      sum += (c & 1) ? -sat : sat;
    }
    sum = __reduce_add_sync(kFull, sum);
    const int v = min(max(sum, -threshold), threshold);
    const int num = r == 0 ? threshold - v : threshold + v;
    if (lane == 0) {
      const Key kk = fold_in(ki, r == 0 ? 1u : 2u);  // k_tgt, k_not
      const Key k_t1 = fold_in(kk, 1u);
      const uint32_t t = threshold_of((float)num / (float)(2 * threshold));
      const int mr = lands ? m : -1;
      rows[2 * i + r] = Row{mr, t, fold_in(k_t1, 0u), fold_in(k_t1, 1u)};
      row_m[2 * i + r] = mr;
      s_m[r] = mr;
      s_p[r] = below_of(t);
      s_key[r] = fold_in(kk, 0u);
    }
  }
  __syncthreads();
  // the selection bits: clause c of row r is selected iff its uniform of
  // the row's stream k_sel is below p_sel; a warp writes whole words
  for (int q = r; q < 2 * sel_words; q += kPrologueThreads / 32) {
    const int rr = q / sel_words, c = (q % sel_words) * 32 + lane;
    const bool hit = s_m[rr] >= 0 && c < n_clauses &&
                     below(random_bits(s_key[rr], (uint32_t)c), s_p[rr]);
    const unsigned word = __ballot_sync(kFull, hit);
    if (lane == 0) sel[(size_t)(2 * i + rr) * sel_words + q % sel_words] = word;
  }
}

// The update of the kIpt literals l0 + q * blockDim.x (q < kIpt) of clause
// c of class m, one thread each
__global__ void __launch_bounds__(kThreads)
update_kernel(const int8_t* __restrict__ state, const uint32_t* __restrict__ cw,
              const uint32_t* __restrict__ lits, const Row* __restrict__ rows,
              const int32_t* __restrict__ row_m,
              const uint32_t* __restrict__ sel, int n_clauses, int n_literals,
              int w_words, int batch, int n_states, uint32_t strengthen,
              uint32_t weaken, int8_t* __restrict__ out) {
  __shared__ Entry s_list[2 * kThreads];  // both rows of a sample may be m
  __shared__ int s_count;
  const int t = threadIdx.x, threads = blockDim.x;
  const int l0 = blockIdx.x * kIpt * threads + t;
  const int c = blockIdx.y, m = blockIdx.z;
  const size_t row0 = ((size_t)m * n_clauses + c) * n_literals;
  const bool positive = (c & 1) == 0;
  const uint32_t* cw_row = cw + ((size_t)m * n_clauses + c) * w_words;
  const int sel_words = (n_clauses + 31) / 32;
  const uint32_t* sel_col = sel + c / 32;
  const Below p_strengthen = below_of(strengthen), p_weaken = below_of(weaken);
  // per TA: its pre-batch state, the draw index of its uniform, whether a
  // -1 or a +1 survives the clip against the pre-batch state, and its sum
  int st[kIpt], total[kIpt];
  uint32_t idx[kIpt];
  bool can_dec[kIpt], can_inc[kIpt];
#pragma unroll
  for (int q = 0; q < kIpt; ++q) {
    const int l = l0 + q * threads;
    st[q] = l < n_literals ? (int)state[row0 + l] : 0;
    idx[q] = (uint32_t)c * (uint32_t)n_literals + (uint32_t)l;
    can_dec[q] = st[q] > -n_states;
    can_inc[q] = st[q] < n_states - 1;
    total[q] = 0;
  }
  for (int i0 = 0; i0 < batch; i0 += threads) {
    if (t == 0) s_count = 0;
    __syncthreads();
    const int i = i0 + t;
    if (i < batch) {
      for (int r = 0; r < 2; ++r) {
        const int j = 2 * i + r;
        if (row_m[j] != m || !(sel_col[(size_t)j * sel_words] >> (c & 31) & 1u)) {
          continue;
        }
        const bool sat = (cw_row[i >> 5] >> (i & 31)) & 1u;
        Entry e{i, kPush, Key{0u, 0u}};
        if ((r == 0) == positive) {  // Type I
          e.kind = sat ? kFired : kUnfired;
          e.k = sat ? rows[j].k1 : rows[j].k2;
        } else if (!sat) {  // Type II acts only where the clause fired
          continue;
        }
        s_list[atomicAdd(&s_count, 1)] = e;
      }
    }
    __syncthreads();
    const int n = s_count;
    for (int j = 0; j < n; ++j) {
      const Entry e = s_list[j];
      if (e.kind == kUnfired) {  // the common case: every literal weakens
        if (p_weaken.never) continue;
        uint32_t bits[kIpt];
        random_bits(schedule(e.k), idx, bits);
#pragma unroll
        for (int q = 0; q < kIpt; ++q) {
          if (can_dec[q] && bits[q] <= p_weaken.lim) --total[q];
        }
        continue;
      }
      bool lit[kIpt];
#pragma unroll
      for (int q = 0; q < kIpt; ++q) {
        const int l = min(l0 + q * threads, n_literals - 1);
        lit[q] = (__ldg(lits + (size_t)l * w_words + (e.i >> 5)) >> (e.i & 31)) & 1u;
      }
      if (e.kind == kPush) {  // Type II: exclude -> include where the literal is 0
#pragma unroll
        for (int q = 0; q < kIpt; ++q) {
          if (!lit[q] && st[q] < 0) ++total[q];
        }
      } else {  // Type I, the clause fired: a literal of 1 strengthens
        uint32_t bits[kIpt];
        random_bits(schedule(e.k), idx, bits);
#pragma unroll
        for (int q = 0; q < kIpt; ++q) {
          if (lit[q]) {
            if (can_inc[q] && below(bits[q], p_strengthen)) ++total[q];
          } else if (can_dec[q] && below(bits[q], p_weaken)) {
            --total[q];
          }
        }
      }
    }
    __syncthreads();  // the next round rewrites s_list and s_count
  }
#pragma unroll
  for (int q = 0; q < kIpt; ++q) {
    const int l = l0 + q * threads;
    if (l < n_literals) {
      out[row0 + l] = (int8_t)min(max(st[q] + total[q], -n_states), n_states - 1);
    }
  }
}

}  // namespace

extern "C" {

// state, out: int8[n_classes][n_clauses][n_literals] (packed, centred);
// cw: uint32[n_classes * n_clauses][w_words] training clause words;
// lits: uint32[n_literals][w_words]; labels: int32[batch]; strengthen,
// weaken: ceil(p * 2^23) of the float32 probabilities, in [0, 2^23];
// scratch: int32[batch * 2 * (7 + ceil(n_clauses / 32))], per (sample,
// row) a 24-byte record, then the class rows, then the selection bits.
int tm_train_launch(const int8_t* state, const uint32_t* cw,
                    const uint32_t* lits, const int32_t* labels, int n_classes,
                    int n_clauses, int n_literals, int w_words, int batch,
                    uint32_t key0, uint32_t key1, int n_states, int threshold,
                    uint32_t strengthen, uint32_t weaken, int32_t* scratch,
                    int8_t* out, void* stream) {
  if (n_classes < 2 || n_clauses <= 0 || n_literals <= 0 || w_words <= 0 ||
      batch <= 0 || batch > 32 * w_words || n_classes > 65535 ||
      n_clauses > 65535 || strengthen > kUnit || weaken > kUnit) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  Row* rows = reinterpret_cast<Row*>(scratch);
  int32_t* row_m = scratch + 2 * (size_t)batch * (sizeof(Row) / 4);
  uint32_t* sel = reinterpret_cast<uint32_t*>(row_m + 2 * (size_t)batch);
  prologue_kernel<<<batch, kPrologueThreads, 0, s>>>(
      labels, cw, n_classes, n_clauses, w_words, Key{key0, key1}, threshold,
      rows, row_m, sel);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // kIpt literals per thread, a multiple of 32 threads, at most kThreads
  const int threads = min(kThreads, ((n_literals + kIpt - 1) / kIpt + 31) / 32 * 32);
  const int tiles = (n_literals + kIpt * threads - 1) / (kIpt * threads);
  update_kernel<<<dim3(tiles, n_clauses, n_classes), threads, 0, s>>>(
      state, cw, lits, rows, row_m, sel, n_clauses, n_literals, w_words, batch,
      n_states, strengthen, weaken, out);
  return (int)cudaGetLastError();
}

// which: 0 the prologue, 1 the update
int tm_train_attributes(int which, int* regs, int* local_bytes,
                        int* shared_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (which == 0) {
    err = cudaFuncGetAttributes(&attr, prologue_kernel);
  } else if (which == 1) {
    err = cudaFuncGetAttributes(&attr, update_kernel);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  return 0;
}

const char* tm_train_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
