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
// (batch word, 32-clause chunk) and two popcounts per (plane, class,
// chunk, datapoint).  The TPU kernel walks the instructions in order
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
//   B  reduce_kernel: one block per (batch word, 16-class tile), 16
//      warps splitting the ceil(n_clauses / 32) clause chunks.  A warp
//      loads 32 clause words (one 128-byte line, the next chunk's in
//      flight), transposes them with 32 __ballot_sync, and lane b adds the
//      popcounts of datapoint 32w+b into 16 per-class registers.  The
//      masks are in clause space: bit k of cpos[p][m][k >> 5] is the bit
//      of instruction ends[k] in the instruction-space mask, so a clause
//      chunk holds 32 clauses where an instruction chunk holds ~4 at the
//      paper's width.  The block stages its classes' masks in shared
//      memory (15 KB at three planes and 10 classes, one tile; larger sets
//      are walked in tiles of 32 KB) and lists, per chunk, the classes any
//      plane selects: the stream is class-major, so a chunk touches one or
//      two of them, and the warp skips the rest uniformly.  Partial sums
//      of the 16 warps are added in shared memory in a fixed order.  B is
//      launched early (programmatic dependent launch): it stages its masks
//      while A finishes and waits for A only before the clause words.
//
// Literal rows are clamped to the feature memory and include indices to
// [0, I_cap) (the host validates both; the clamps only keep a malformed
// call in bounds).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileK = 8;             // launch A: clauses per block
constexpr int kTileW = 32;            // launch A: batch words per block
constexpr int kClauseThreads = kTileK * kTileW;
constexpr int kReduceWarps = 16;
constexpr int kClassTile = 16;
constexpr int kMaskSmemBytes = 32 * 1024;
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

__global__ void __launch_bounds__(kReduceWarps * 32)
reduce_kernel(const uint32_t* __restrict__ emit, int k_pad,
              const uint32_t* __restrict__ cpos,
              const uint32_t* __restrict__ cneg, int planes, int m_cap,
              int n_chunks, int kc_stride, int w_words, int chunk_tile,
              int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int w = blockIdx.x;
  const int m0 = blockIdx.y * kClassTile;
  const int mt = min(kClassTile, m_cap - m0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows = planes * mt;  // row p * mt + m: plane p, class m0 + m
  uint32_t* s_pos = smem;
  uint32_t* s_neg = smem + rows * chunk_tile;
  uint32_t* s_nz = s_neg + rows * chunk_tile;  // classes selected per chunk
  const uint32_t* emit_w = emit + (size_t)w * k_pad;

  int acc[kClassTile];
#pragma unroll
  for (int m = 0; m < kClassTile; ++m) acc[m] = 0;

  for (int c0 = 0; c0 < n_chunks; c0 += chunk_tile) {
    const int ct = min(chunk_tile, n_chunks - c0);
    __syncthreads();  // every warp is done with the previous mask tile
    for (int p = 0; p < planes; ++p) {
      for (int m = warp; m < mt; m += kReduceWarps) {
        const size_t g = ((size_t)p * m_cap + m0 + m) * kc_stride + c0;
        const int s = (p * mt + m) * chunk_tile;
        for (int c = lane; c < ct; c += 32) {
          s_pos[s + c] = cpos[g + c];
          s_neg[s + c] = cneg[g + c];
        }
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < ct; c += blockDim.x) {
      uint32_t nz = 0;
      for (int m = 0; m < mt; ++m) {
        uint32_t any = 0;
        for (int p = 0; p < planes; ++p) {
          const int s = (p * mt + m) * chunk_tile + c;
          any |= s_pos[s] | s_neg[s];
        }
        nz |= (uint32_t)(any != 0) << m;
      }
      s_nz[c] = nz;
    }
    // the masks are program data; the clause words are launch A's: this
    // grid is launched early (programmatic dependent launch) and waits
    // for A only here
    if (c0 == 0) asm volatile("griddepcontrol.wait;\n" ::: "memory");
    uint32_t e_next = warp < ct ? emit_w[(c0 + warp) * 32 + lane] : 0u;
    __syncthreads();
    for (int c = warp; c < ct; c += kReduceWarps) {
      const uint32_t e = e_next;  // and the next chunk's words in flight
      if (c + kReduceWarps < ct) {
        e_next = emit_w[(c0 + c + kReduceWarps) * 32 + lane];
      }
      const uint32_t nz = s_nz[c];
      if (nz == 0) continue;  // warp-uniform
      // lane b gets T: bit j = bit b (datapoint 32w+b) of clause 32c+j
      uint32_t T = 0;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const uint32_t v = __ballot_sync(kFull, (e >> b) & 1u);
        if (lane == b) T = v;
      }
#pragma unroll
      for (int m = 0; m < kClassTile; ++m) {
        if ((nz >> m) & 1u) {
          for (int p = 0; p < planes; ++p) {
            const int s = (p * mt + m) * chunk_tile + c;
            acc[m] += (__popc(T & s_pos[s]) - __popc(T & s_neg[s])) * (1 << p);
          }
        }
      }
    }
  }

  // (with no clause chunk the wait above never ran: writes to out, too,
  // come after the grid before this one)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
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

// Launch A (when there are clauses), then launch B.  emit: scratch
// uint32[w_words][k_pad], clause k's word at row k, rows n_clauses..k_pad-1
// zero, with k_pad = 32 ceil(n_clauses / 32) (at least 32); masks:
// uint32[planes][m_cap][kc_stride] in clause space, of which the first
// k_pad / 32 words of each row are read; out: int32[m_cap][32 w_words].
int tm_popcount_launch(const int32_t* lit_idx, int i_cap,
                       const int32_t* clause_end, int n_clauses,
                       const uint32_t* lits, int l2, int w_words,
                       const uint32_t* cpos, const uint32_t* cneg, int planes,
                       int m_cap, int kc_stride, uint32_t* emit, int k_pad,
                       int32_t* out, void* stream) {
  const int n_chunks = (n_clauses + 31) / 32;
  if (n_clauses < 0 || i_cap <= 0 || l2 <= 0 || w_words <= 0 ||
      planes <= 0 || planes > 31 || m_cap <= 0 || kc_stride < n_chunks ||
      k_pad % 32 || k_pad < 32 * n_chunks || k_pad / kTileK > 65535 ||
      (m_cap + kClassTile - 1) / kClassTile > 65535) {
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
  const int mt = m_cap < kClassTile ? m_cap : kClassTile;
  const int per_chunk = (2 * planes * mt + 1) * 4;  // bytes of one chunk
  int chunk_tile = kMaskSmemBytes / per_chunk;
  if (chunk_tile < 1) chunk_tile = 1;
  if (chunk_tile > n_chunks) chunk_tile = n_chunks > 0 ? n_chunks : 1;
  size_t smem = (size_t)per_chunk * chunk_tile;
  const size_t red = (size_t)kReduceWarps * kClassTile * 32 * 4;
  if (smem < red) smem = red;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3(w_words, (m_cap + kClassTile - 1) / kClassTile);
  cfg.blockDim = dim3(kReduceWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, reduce_kernel, (const uint32_t*)emit,
                                 k_pad, cpos, cneg, planes, m_cap, n_chunks,
                                 kc_stride, w_words, chunk_tile, out);
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
