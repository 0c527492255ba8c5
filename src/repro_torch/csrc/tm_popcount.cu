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
// one AND per include and batch word, then one 32-ballot transpose per
// (class, batch word, 32-clause chunk of the class's range) and two
// popcounts per (plane, class, chunk, datapoint).  The TPU kernel walks the instructions in order
// inside a grid over batch-word blocks, which here would leave only W-way
// parallelism, and carries sums across grid steps, which blocks on a GPU
// cannot.  So the work is split in two launches, with no atomics
// (deterministic):
//
//   A  clause_words_kernel: a block takes 8 clauses x 32 batch
//      words.  A thread ANDs the include range (ends[k-1], ends[k]] of its
//      clause k for its word (threads of a warp share k and read adjacent
//      words of one literal row), the 8 x 32 tile is transposed through
//      shared memory, and the block writes clause k's word at the compact
//      row k of a word-major emit buffer [W][K_pad] in 32-byte sectors.
//      K_pad is n_clauses rounded up to 32; the rows past n_clauses are
//      written 0.
//   B  reduce_kernel: one warp per (class m, batch word w), which
//      walks only the clause chunks [lo_m, hi_m) where some plane of m's
//      masks is non-zero (the class range, an int32[m_cap][2] program
//      operand).  Per chunk it loads 32 clause words (one 128-byte line,
//      two more chunks' in flight) and transposes them with 32 ballots:
//      lane 0 stores the ballots in the warp's slot of shared memory and
//      lane b reads ballot b back, so no lane selects its word out of 32.
//      Lane b then adds the popcounts of datapoint 32w+b against m's
//      masks of every plane.  The masks are in clause space:
//      bit k of cpos[p][m][k >> 5] is the bit of instruction ends[k] in
//      the instruction-space mask, so a clause chunk holds 32 clauses
//      where an instruction chunk holds ~4 at the paper's width.  The
//      stream is class-major, so a range is the class's own chunks and
//      the one or two it shares at a border: sum_m (hi_m - lo_m) is
//      1.01-1.11 times the chunk count for the served machines, and m
//      times it only when every class has a clause in every chunk.  A
//      block takes up to 8 batch words of one class and stages that
//      class's (pos, neg) pairs over its range in shared memory, in
//      tiles of 8 KB, the first before it waits for A (programmatic
//      dependent launch), so the staging overlaps A.  The staging reads
//      planes x range words a block, a small part of what one warp's
//      walk over the same range executes, so a block's words follow from
//      W alone.  Each output element is written once, by its warp: no
//      cross-warp reduction, no atomics, no memset.  What bounds B is
//      the instruction rate: a chunk's 32 ballots with ~12 more
//      instructions, and two popcounts (a quarter-rate pipe) and ~5
//      instructions a plane.
//
// Literal rows are clamped to the feature memory and include indices to
// [0, I_cap) (the host validates both; the clamps only keep a malformed
// call in bounds).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileK = 8;                 // launch A: clauses per block
constexpr int kTileW = 32;                // launch A: batch words per block
constexpr int kClauseThreads = kTileK * kTileW;
constexpr int kReduceWarps = 8;           // launch B: batch words per block, at most
constexpr int kMaskSmemBytes = 8 * 1024;  // launch B: one tile of a class's masks
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kClauseThreads)
clause_words_kernel(const int32_t* __restrict__ lit_idx, int i_cap,
                    const int32_t* __restrict__ clause_end, int n_clauses,
                    const uint32_t* __restrict__ lits, int l2, int w_words,
                    int k_pad, uint32_t* __restrict__ emit) {
  // launch B may stage its masks once every block here has begun
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ uint32_t tile[kTileK][kTileW + 1];  // [clause][word]
  const int w0 = blockIdx.x * kTileW, k0 = blockIdx.y * kTileK;
  const int lane = threadIdx.x & 31, kl = threadIdx.x >> 5;
  const int k = k0 + kl, w = w0 + lane;
  uint32_t acc = 0;
  if (k < n_clauses && w < w_words) {  // warp-uniform in k
    const int end = min(clause_end[k], i_cap - 1);
    const int start = k ? max(clause_end[k - 1] + 1, 0) : 0;
    acc = kFull;
    for (int t = start; t <= end; ++t) {
      int r = lit_idx[t];
      r = r < 0 ? 0 : (r >= l2 ? l2 - 1 : r);
      acc &= __ldg(lits + (size_t)r * w_words + w);
    }
  }
  tile[kl][lane] = acc;
  __syncthreads();
  // eight threads write the eight clause rows of one word: 32-byte sectors
  const int kw = threadIdx.x % kTileK, wr = threadIdx.x / kTileK;
  if (w0 + wr < w_words) {
    emit[(size_t)(w0 + wr) * k_pad + k0 + kw] = tile[kw][wr];
  }
}

// The ballot of bit `bit` of every lane's e.  Written in PTX so that the
// AND-and-test reaches ptxas as it is: it then sets seven predicates at
// once (R2P) for seven ballots, where the C form ((e >> b) & 1) compiles
// to a shift, an AND and a compare for each.
__device__ __forceinline__ uint32_t ballot_bit(uint32_t e, uint32_t bit) {
  uint32_t v;
  asm volatile(
      "{\n\t.reg .pred p;\n\t.reg .b32 t;\n\t"
      "and.b32 t, %1, %2;\n\tsetp.ne.u32 p, t, 0;\n\t"
      "vote.sync.ballot.b32 %0, p, 0xffffffff;\n\t}"
      : "=r"(v) : "r"(e), "r"(bit));
  return v;
}

__global__ void __launch_bounds__(kReduceWarps * 32)
reduce_kernel(const uint32_t* __restrict__ emit, int k_pad,
              const uint32_t* __restrict__ cpos,
              const uint32_t* __restrict__ cneg,
              const int32_t* __restrict__ ranges, int planes, int m_cap,
              int n_chunks, int kc_stride, int w_words, int chunk_tile,
              int32_t* __restrict__ out) {
  extern __shared__ uint2 s_mask[];  // [planes][tile]: (pos, neg) of class m
  // per warp, two slots of 32 ballots: a chunk's transposed tile
  __shared__ __align__(16) uint32_t s_tile[kReduceWarps][2][32];
  const int m = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const bool live = w < w_words;  // warp-uniform
  // the class range, clamped to the clause chunks (the host builds it in
  // range; the clamps only keep a malformed call in bounds)
  const int lo = min(max(ranges[2 * m], 0), n_chunks);
  const int hi = max(min(ranges[2 * m + 1], n_chunks), lo);
  const uint32_t* emit_w = emit + (size_t)(live ? w : 0) * k_pad + lane;

  auto stage = [&](int t0, int ct) {
    for (int i = threadIdx.x; i < planes * ct; i += blockDim.x) {
      const int p = i / ct;
      const size_t g = ((size_t)p * m_cap + m) * kc_stride + t0 + i - p * ct;
      s_mask[i] = make_uint2(cpos[g], cneg[g]);
    }
  };

  int t0 = lo;
  int ct = min(chunk_tile, hi - t0);
  stage(t0, ct);
  // the masks are program data; the clause words (and, with no clause,
  // the grid before this one's use of out) are launch A's: wait here
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __syncthreads();
  int acc = 0;
  while (ct > 0) {  // block-uniform: one class a block
    if (live) {
      const uint32_t* src = emit_w + (size_t)t0 * 32;
      uint32_t e1 = src[0];
      uint32_t e2 = ct > 1 ? src[32] : 0u;
#pragma unroll 2
      for (int c = 0; c < ct; ++c) {
        const uint32_t e = e1;  // and the next two chunks' words in flight
        e1 = e2;
        if (c + 2 < ct) e2 = src[(c + 2) * 32];
        // ballot b: bit j = bit b (datapoint 32w+b) of clause 32c+j; lane 0
        // stores them four at a time, lane b reads ballot b back as T
        // (the slots alternate, so one __syncwarp a chunk orders them)
        uint32_t* slot = s_tile[threadIdx.x >> 5][c & 1];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const uint4 v = make_uint4(
              ballot_bit(e, 1u << (4 * q)), ballot_bit(e, 1u << (4 * q + 1)),
              ballot_bit(e, 1u << (4 * q + 2)), ballot_bit(e, 1u << (4 * q + 3)));
          if (lane == 0) reinterpret_cast<uint4*>(slot)[q] = v;
        }
        __syncwarp();
        const uint32_t T = slot[lane];
        int h = 0;  // sum_p d_p << p, from the top plane down
        for (int p = planes - 1; p >= 0; --p) {
          const uint2 mk = s_mask[p * ct + c];
          h = 2 * h + __popc(T & mk.x) - __popc(T & mk.y);
        }
        acc += h;
      }
    }
    t0 += ct;
    ct = min(chunk_tile, hi - t0);
    if (ct > 0) {
      __syncthreads();  // every warp is done with the previous tile
      stage(t0, ct);
      __syncthreads();
    }
  }
  if (live) out[(size_t)m * 32 * w_words + 32 * w + lane] = acc;
}

}  // namespace

extern "C" {

// Launch A (when there are clauses), then launch B.  emit: scratch
// uint32[w_words][k_pad], clause k's word at row k, rows n_clauses..k_pad-1
// zero, with k_pad = 32 ceil(n_clauses / 32) (at least 32); masks:
// uint32[planes][m_cap][kc_stride] in clause space, of which the first
// k_pad / 32 words of each row are read; ranges: int32[m_cap][2], class m's
// half-open range of clause chunks holding every non-zero word of its masks
// (lo == hi for a class with none); out: int32[m_cap][32 w_words].
int tm_popcount_launch(const int32_t* lit_idx, int i_cap,
                       const int32_t* clause_end, int n_clauses,
                       const uint32_t* lits, int l2, int w_words,
                       const uint32_t* cpos, const uint32_t* cneg,
                       const int32_t* ranges, int planes, int m_cap,
                       int kc_stride, uint32_t* emit, int k_pad, int32_t* out,
                       void* stream) {
  const int n_chunks = (n_clauses + 31) / 32;
  if (n_clauses < 0 || i_cap <= 0 || l2 <= 0 || w_words <= 0 ||
      planes <= 0 || planes > 31 || m_cap <= 0 || m_cap > 65535 ||
      kc_stride < n_chunks || k_pad % 32 || k_pad < 32 * n_chunks ||
      k_pad / kTileK > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (n_clauses > 0) {
    const dim3 grid((w_words + kTileW - 1) / kTileW, 32 * n_chunks / kTileK);
    clause_words_kernel<<<grid, kClauseThreads, 0, s>>>(
        lit_idx, i_cap, clause_end, n_clauses, lits, l2, w_words, k_pad, emit);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int per_chunk = 8 * planes;  // bytes: (pos, neg) of every plane
  int chunk_tile = kMaskSmemBytes / per_chunk;
  if (chunk_tile > n_chunks) chunk_tile = n_chunks;
  if (chunk_tile < 1) chunk_tile = 1;
  const int warps = w_words < kReduceWarps ? w_words : kReduceWarps;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3((w_words + warps - 1) / warps, m_cap);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = (size_t)per_chunk * chunk_tile;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, reduce_kernel, (const uint32_t*)emit,
                                 k_pad, cpos, cneg, ranges, planes, m_cap,
                                 n_chunks, kc_stride, w_words, chunk_tile,
                                 out);
}

// Registers per thread, local (spill) bytes per thread and static shared
// bytes of kernel `which` (0 clause words, 1 reduce).
int tm_popcount_attributes(int which, int* regs, int* local_bytes,
                           int* shared_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, which ? (const void*)reduce_kernel : (const void*)clause_words_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  return 0;
}

const char* tm_popcount_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
