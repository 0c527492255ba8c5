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
// Launch 1 (prologue), one warp per sample: the sample key fold_in(call,
// i) and its split into (k_neg, k_tgt, k_not); the negative class by
// randint(k_neg, 0, M-1), moved past the label; per touched row the
// clipped class vote v over the clause words and p_sel = (T -/+ v) / 2T
// (IEEE float32 division: no fast math); and the row's streams k_sel,
// k1, k2.  One 32-byte record per (sample, row).
//
// Launch 2 (update), a block per (literal tile of 256, clause, class),
// one thread per TA, its delta in a register, no atomics on global
// memory.  Per 256 samples the block picks out the samples whose target
// or negative is its class, draws each one's selection uniform for its
// clause once, and lists the selected ones in shared memory; every
// thread then walks the list, drawing only the one uniform its branch
// reads (none for a Type II push, none for a fired literal of 1 when
// boost_true_positive makes that increment certain).  Draws of clauses
// that are not selected are skipped: the stream is counter-based, so
// skipping costs nothing in exactness.  Integer sums commute, so the
// list's order is free and the result is deterministic.
//
// What bounds it on an H100: operations.  Each draw is a 20-round hash
// (~80 integer operations); a step at the paper's MNIST width needs ~10M
// of them against ~7 MB of state moved.  The design keeps the draws in
// registers (the plain version writes each one to device memory) and
// computes only the draws the selected clauses read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPrologueThreads = 128;  // one warp per sample
constexpr int kThreads = 256;          // update: one literal per thread
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Key {
  uint32_t a, b;
};

struct Row {     // one (sample, touched class row): 32 bytes
  int32_t m;     // the class row, -1 where the update does not land
  float p;       // the selection probability p_sel
  Key sel;       // selection stream (one uniform per clause)
  Key k1, k2;    // Type I streams: clause fired, clause not fired
};

enum { kFired = 0, kUnfired = 1, kPush = 2 };

struct Entry {   // one selected (sample, row) of the block's clause
  int32_t i;
  int32_t kind;
  Key k;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;

// threefry2x32, 20 rounds (jax/_src/prng.py:_threefry2x32_lowering)
__device__ __forceinline__ void threefry(Key k, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k.a ^ k.b ^ 0x1BD11BDAu;
  x0 += k.a;
  x1 += k.b;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k.b;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k.a + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k.a;
  x1 += k.b + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k.b;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k.a + 5u;
}

#undef TF_ROUND

__device__ __forceinline__ Key fold_in(Key k, uint32_t d) {
  uint32_t x0 = 0u, x1 = d;
  threefry(k, x0, x1);
  return Key{x0, x1};
}

// 32 random bits at flat index idx < 2^32 of any shape
__device__ __forceinline__ uint32_t random_bits(Key k, uint32_t idx) {
  uint32_t x0 = 0u, x1 = idx;
  threefry(k, x0, x1);
  return x0 ^ x1;
}

__device__ __forceinline__ float uniform(Key k, uint32_t idx) {
  return __uint_as_float((random_bits(k, idx) >> 9) | 0x3F800000u) - 1.0f;
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
                int w_words, int batch, Key call, int threshold,
                Row* __restrict__ rows) {
  const int i = (blockIdx.x * kPrologueThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= batch) return;  // the whole warp leaves together
  // every lane derives the keys: no broadcast needed
  const Key ki = fold_in(call, (uint32_t)i);
  const Key k_neg = fold_in(ki, 0u), k_tgt = fold_in(ki, 1u),
            k_not = fold_in(ki, 2u);
  // labels index as the reference's int32 indices: a negative one counts
  // from the end, a read clamps into [0, M), and a target still outside
  // drops its update; the negative is drawn against the label as given
  const int label = labels[i];
  const int y_idx = label < 0 ? label + n_classes : label;
  const bool lands = y_idx >= 0 && y_idx < n_classes;
  const int y = min(max(y_idx, 0), n_classes - 1);
  int neg = (int)randint(k_neg, (uint32_t)(n_classes - 1));
  if (neg >= label) neg += 1;
  const int bit = i & 31;
  for (int r = 0; r < 2; ++r) {
    const int m = r == 0 ? y : neg;
    const uint32_t* col = cw + (size_t)m * n_clauses * w_words + (i >> 5);
    int sum = 0;  // the class vote: +1 even clauses, -1 odd ones
    for (int c = lane; c < n_clauses; c += 32) {
      const int sat = (int)((col[(size_t)c * w_words] >> bit) & 1u);
      sum += (c & 1) ? -sat : sat;
    }
    sum = __reduce_add_sync(kFull, sum);
    const int v = min(max(sum, -threshold), threshold);
    const int num = r == 0 ? threshold - v : threshold + v;
    if (lane == 0) {
      const Key kk = r == 0 ? k_tgt : k_not;
      const Key k_t1 = fold_in(kk, 1u);
      rows[2 * i + r] = Row{r == 0 && !lands ? -1 : m,
                            (float)num / (float)(2 * threshold),
                            fold_in(kk, 0u), fold_in(k_t1, 0u),
                            fold_in(k_t1, 1u)};
    }
  }
}

__global__ void __launch_bounds__(kThreads)
update_kernel(const int8_t* __restrict__ state, const uint32_t* __restrict__ cw,
              const uint32_t* __restrict__ lits, const Row* __restrict__ rows,
              int n_clauses, int n_literals, int w_words, int batch,
              int n_states, float strengthen, float weaken,
              int8_t* __restrict__ out) {
  __shared__ Entry s_list[2 * kThreads];  // both rows of a sample may be m
  __shared__ int s_count;
  const int t = threadIdx.x;
  const int l = blockIdx.x * kThreads + t;
  const int c = blockIdx.y, m = blockIdx.z;
  const bool active = l < n_literals;
  const size_t ta = ((size_t)m * n_clauses + c) * n_literals + l;
  const int s = active ? (int)state[ta] : 0;
  const bool include = s >= 0;  // the pre-batch action
  const bool positive = (c & 1) == 0;
  const uint32_t* cw_row = cw + ((size_t)m * n_clauses + c) * w_words;
  const uint32_t* lit_row = lits + (size_t)(active ? l : 0) * w_words;
  const uint32_t draw = (uint32_t)c * (uint32_t)n_literals + (uint32_t)l;
  const bool certain = strengthen >= 1.0f;  // every uniform is < 1
  int total = 0;
  for (int i0 = 0; i0 < batch; i0 += kThreads) {
    if (t == 0) s_count = 0;
    __syncthreads();
    const int i = i0 + t;
    if (i < batch) {
      for (int r = 0; r < 2; ++r) {
        const Row row = rows[2 * i + r];
        if (row.m != m || !(uniform(row.sel, (uint32_t)c) < row.p)) continue;
        const bool sat = (cw_row[i >> 5] >> (i & 31)) & 1u;
        Entry e{i, kPush, row.k1};
        if ((r == 0) == positive) {  // Type I
          e.kind = sat ? kFired : kUnfired;
          e.k = sat ? row.k1 : row.k2;
        } else if (!sat) {  // Type II acts only where the clause fired
          continue;
        }
        s_list[atomicAdd(&s_count, 1)] = e;
      }
    }
    __syncthreads();
    const int n = s_count;
    if (active) {
      for (int j = 0; j < n; ++j) {
        const Entry e = s_list[j];
        int d;
        if (e.kind == kUnfired) {
          d = -(int)(uniform(e.k, draw) < weaken);
        } else {
          const bool lit = (__ldg(lit_row + (e.i >> 5)) >> (e.i & 31)) & 1u;
          if (e.kind == kPush) {
            d = (!lit && !include) ? 1 : 0;
          } else if (lit) {
            d = (certain || uniform(e.k, draw) < strengthen) ? 1 : 0;
          } else {
            d = -(int)(uniform(e.k, draw) < weaken);
          }
        }
        // each sample's delta is clipped against the pre-batch state
        total += min(max(s + d, -n_states), n_states - 1) - s;
      }
    }
    __syncthreads();  // the next round rewrites s_list and s_count
  }
  if (active) out[ta] = (int8_t)min(max(s + total, -n_states), n_states - 1);
}

}  // namespace

extern "C" {

// state, out: int8[n_classes][n_clauses][n_literals] (packed, centred);
// cw: uint32[n_classes * n_clauses][w_words] training clause words;
// lits: uint32[n_literals][w_words]; labels: int32[batch];
// rows: 32 bytes of scratch per (sample, row), 64 * batch bytes.
int tm_train_launch(const int8_t* state, const uint32_t* cw,
                    const uint32_t* lits, const int32_t* labels, int n_classes,
                    int n_clauses, int n_literals, int w_words, int batch,
                    uint32_t key0, uint32_t key1, int n_states, int threshold,
                    float strengthen, float weaken, int32_t* rows, int8_t* out,
                    void* stream) {
  if (n_classes < 2 || n_clauses <= 0 || n_literals <= 0 || w_words <= 0 ||
      batch <= 0 || batch > 32 * w_words || n_classes > 65535 ||
      n_clauses > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  Row* r = reinterpret_cast<Row*>(rows);
  constexpr int kSamplesPerBlock = kPrologueThreads / 32;
  prologue_kernel<<<(batch + kSamplesPerBlock - 1) / kSamplesPerBlock,
                    kPrologueThreads, 0, s>>>(labels, cw, n_classes, n_clauses,
                                              w_words, batch, Key{key0, key1},
                                              threshold, r);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_literals + kThreads - 1) / kThreads, n_clauses, n_classes);
  update_kernel<<<grid, kThreads, 0, s>>>(state, cw, lits, r, n_clauses,
                                          n_literals, w_words, batch, n_states,
                                          strengthen, weaken, out);
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
