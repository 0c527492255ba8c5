// Popcount-bitplane inference of a compressed Tsetlin Machine on Hopper.
//
// Replaces repro/kernels/tm_popcount/kernel.py:_tm_popcount_kernel, the
// Pallas TPU kernel (driven by tm_popcount, helpers bit_transpose32 and
// popcount_reduce).  Same function: for every clause, AND the packed
// literal words of its includes; route each finished clause word to its
// class with the polarity-bank bitplanes; class sums are
//     sums[m, 32w+b] = sum_p (popc(T & pos[p,m,c]) - popc(T & neg[p,m,c])) << p
// over 32x32 bit-transposed tiles T of the clause words.
//
// What bounds it on an H100: operations, not bytes.  The inputs are a few
// MB (packed literals, include list, masks) and stay in L2; the work is
// one 32-ballot transpose per (batch word, 32-instruction chunk) and two
// popcounts per (plane, class, chunk, datapoint).  The TPU kernel walks
// the instructions in order inside a grid over batch-word blocks, which
// here would leave only W-way parallelism, and carries sums across grid
// steps, which blocks on a GPU cannot.  So the work is split in two
// launches, with no atomics (deterministic):
//
//   A  tm_popcount_clause_words: one thread per (clause k, batch word w)
//      ANDs its include range (ends[k-1], ends[k]] and writes the clause
//      word at row ends[k] of a word-major emit buffer [W][I_pad].  Threads
//      of a warp share k and read adjacent words of one literal row.
//   B  tm_popcount_reduce: one block per (batch word, 16-class tile),
//      16 warps splitting the chunks.  A warp loads 32 emit words (one
//      coalesced 128-byte line), transposes them with 32 __ballot_sync,
//      and lane b adds the popcounts of datapoint 32w+b into 16 per-class
//      registers.  Chunks that emit nothing and masks that are zero are
//      skipped warp-uniformly: the stream is class-major, so a chunk
//      touches one or two classes.  Masks are staged in shared memory in
//      chunk tiles of at most 96 KB; partial sums of the 16 warps are
//      added in shared memory in a fixed order.
//
// Rows of the emit buffer that no clause ends on are never written: B
// ignores them through a ballot on last_flag, so the buffer needs no
// memset.  Literal rows are clamped to the feature memory (the host
// validates them; the clamp only keeps a malformed call in bounds).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kClauseThreads = 256;
constexpr int kReduceWarps = 16;
constexpr int kClassTile = 16;
constexpr int kMaskSmemBytes = 96 * 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kClauseThreads)
clause_words_kernel(const int32_t* __restrict__ lit_idx,
                    const int32_t* __restrict__ clause_end, int n_clauses,
                    const uint32_t* __restrict__ lits, int l2, int w_words,
                    int i_pad, uint32_t* __restrict__ emit) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n_clauses * w_words) return;
  const int k = (int)(idx / w_words);
  const int w = (int)(idx % w_words);
  const int end = clause_end[k];
  const int start = k ? clause_end[k - 1] + 1 : 0;
  uint32_t acc = kFull;
  for (int t = start; t <= end; ++t) {
    int row = lit_idx[t];
    row = row < 0 ? 0 : (row >= l2 ? l2 - 1 : row);
    acc &= __ldg(lits + (size_t)row * w_words + w);
  }
  emit[(size_t)w * i_pad + end] = acc;
}

__global__ void __launch_bounds__(kReduceWarps * 32, 2)
reduce_kernel(const uint32_t* __restrict__ emit,
              const int32_t* __restrict__ last, int i_cap,
              const uint32_t* __restrict__ mask_pos,
              const uint32_t* __restrict__ mask_neg, int planes, int m_cap,
              int n_chunks, int w_words, int chunk_tile,
              int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int w = blockIdx.x;
  const int m0 = blockIdx.y * kClassTile;
  const int mt = min(kClassTile, m_cap - m0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint32_t* s_pos = smem;
  uint32_t* s_neg = smem + planes * mt * chunk_tile;
  const uint32_t* emit_w = emit + (size_t)w * n_chunks * 32;

  int acc[kClassTile];
#pragma unroll
  for (int m = 0; m < kClassTile; ++m) acc[m] = 0;

  for (int c0 = 0; c0 < n_chunks; c0 += chunk_tile) {
    const int ct = min(chunk_tile, n_chunks - c0);
    __syncthreads();  // every warp is done with the previous mask tile
    for (int i = threadIdx.x; i < planes * mt * ct; i += blockDim.x) {
      const int c = i % ct;
      const int pm = i / ct;
      const int m = pm % mt;
      const int p = pm / mt;
      const size_t g = ((size_t)p * m_cap + m0 + m) * n_chunks + c0 + c;
      const int s = (p * mt + m) * chunk_tile + c;
      s_pos[s] = mask_pos[g];
      s_neg[s] = mask_neg[g];
    }
    __syncthreads();
    for (int c = c0 + warp; c < c0 + ct; c += kReduceWarps) {
      const int t = c * 32 + lane;
      const bool emits = t < i_cap && last[t] == 1;
      if (__ballot_sync(kFull, emits) == 0) continue;  // warp-uniform
      const uint32_t e = emits ? emit_w[t] : 0u;
      // lane b gets T: bit j = bit b (datapoint 32w+b) of instruction 32c+j
      uint32_t T = 0;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const uint32_t v = __ballot_sync(kFull, (e >> b) & 1u);
        if (lane == b) T = v;
      }
      const int cl = c - c0;
      for (int p = 0; p < planes; ++p) {
#pragma unroll
        for (int m = 0; m < kClassTile; ++m) {
          if (m < mt) {
            const int s = (p * mt + m) * chunk_tile + cl;
            const uint32_t pos = s_pos[s];
            const uint32_t neg = s_neg[s];
            if (pos | neg) {
              acc[m] += (__popc(T & pos) - __popc(T & neg)) * (1 << p);
            }
          }
        }
      }
    }
  }

  __syncthreads();  // the mask tiles are dead; reuse smem for the sums
  int* red = reinterpret_cast<int*>(smem);  // [kReduceWarps][kClassTile][32]
#pragma unroll
  for (int m = 0; m < kClassTile; ++m) {
    red[(warp * kClassTile + m) * 32 + lane] = acc[m];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < mt * 32; i += blockDim.x) {
    const int m = i >> 5;
    const int b = i & 31;
    int s = 0;
    for (int k = 0; k < kReduceWarps; ++k) {
      s += red[(k * kClassTile + m) * 32 + b];
    }
    out[(size_t)(m0 + m) * 32 * w_words + 32 * w + b] = s;
  }
}

}  // namespace

extern "C" {

// Launch A.  emit: uint32[w_words][i_pad], rows written at clause ends.
int tm_popcount_clause_words(const int32_t* lit_idx, const int32_t* clause_end,
                             int n_clauses, const uint32_t* lits, int l2,
                             int w_words, int i_pad, uint32_t* emit,
                             void* stream) {
  const long long threads = (long long)n_clauses * w_words;
  if (threads <= 0 || l2 <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks =
      (unsigned)((threads + kClauseThreads - 1) / kClauseThreads);
  clause_words_kernel<<<blocks, kClauseThreads, 0, (cudaStream_t)stream>>>(
      lit_idx, clause_end, n_clauses, lits, l2, w_words, i_pad, emit);
  return (int)cudaGetLastError();
}

// Launch B.  masks: uint32[planes][m_cap][n_chunks]; out: int32[m_cap][32 w].
int tm_popcount_reduce(const uint32_t* emit, const int32_t* last, int i_cap,
                       const uint32_t* mask_pos, const uint32_t* mask_neg,
                       int planes, int m_cap, int n_chunks, int w_words,
                       int32_t* out, void* stream) {
  if (planes <= 0 || m_cap <= 0 || n_chunks <= 0 || w_words <= 0 ||
      i_cap <= 0 || i_cap > n_chunks * 32) {
    return (int)cudaErrorInvalidValue;
  }
  const int mt = m_cap < kClassTile ? m_cap : kClassTile;
  int chunk_tile = kMaskSmemBytes / (2 * planes * mt * 4);
  if (chunk_tile < 1) chunk_tile = 1;
  if (chunk_tile > n_chunks) chunk_tile = n_chunks;
  size_t smem = (size_t)2 * planes * mt * chunk_tile * 4;
  const size_t red = (size_t)kReduceWarps * kClassTile * 32 * 4;
  if (smem < red) smem = red;
  cudaError_t err = cudaFuncSetAttribute(
      reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(w_words, (m_cap + kClassTile - 1) / kClassTile);
  reduce_kernel<<<grid, kReduceWarps * 32, smem, (cudaStream_t)stream>>>(
      emit, last, i_cap, mask_pos, mask_neg, planes, m_cap, n_chunks, w_words,
      chunk_tile, out);
  return (int)cudaGetLastError();
}

const char* tm_popcount_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
