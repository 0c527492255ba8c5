// Compressed Tsetlin Machine inference from the decoded plan, as the
// eFPGA instruction pipeline runs it, on Hopper.
//
// Replaces repro/kernels/tm_interp/kernel.py:_tm_interp_kernel, the Pallas
// TPU kernel driven by tm_interp.  Same function: per instruction t,
// acc &= lits[lit_idx[t]]; where last_flag[t] == 1 the packed clause word
// acc is expanded to bits, pol[t] * bits is added to class-sum row
// clip(cls[t], 0, m_cap - 1), and acc resets to all ones.  Out is
// int32[m_cap][32 W]: datapoint 32w + b is bit b of batch word w.
//
// What bounds it on an H100: bytes, and at the paper's MNIST width only
// barely (2.2 MB of operands, literals and sums, 0.66 us at 3.35 TB/s,
// against 21M ANDs and bit adds, 0.3 us at the integer rate).  What a
// kernel pays in practice is the chain of dependent loads (clause table
// -> instruction -> literal row), the 17 MB of literal words that the
// includes read again from L2, and the instructions spent per include and
// batch word.  The TPU kernel walks the instructions in order and carries
// acc and the sum bank in VMEM across instruction blocks; a GPU has no
// order between blocks and no carry.  Clauses are independent, so the
// walk is split by class and batch tile:
//
//   table  clause_end[k] is the k-th emitting instruction: clause k covers
//          (clause_end[k-1], clause_end[k]], built on the host with the
//          operands;
//   grid   (8-word batch tiles) x (class): a block owns the output tile of
//          its class and 256 datapoints and writes it with plain stores,
//          zeros where the class has no clauses: no zero fill and no
//          global atomics;
//   stage  the block scans the clause table 2048 clauses at a time, every
//          load of a level issued before any is used: the ends (each
//          clause's start from its predecessor's end, by shuffle), then
//          cls at each end; a warp ballot compacts the clauses whose
//          clamped class is the block's into shared memory (the order is
//          free: integer adds commute);
//   walk   a group of 8 lanes (lane = batch word) carries one clause, four
//          per warp.  Lane j loads lit_idx[start + j] and [start + 8 + j]
//          (one coalesced load each) and turns each into a 32-bit byte
//          offset of its literal row, clamped into [0, L2), once; the 16
//          offsets are broadcast by shuffle and their 16 literal loads
//          issued back to back, predicated on the clause's end, with no
//          early exit, then ANDed.  A longer clause takes further runs of
//          16.  The next clause's first run of offsets and its polarity
//          are loaded before this one's literal loads;
//   sums   a lane adds pol into the block's shared bank entry (word, bit)
//          for each set bit of its clause word with a shared atomic
//          (integer adds commute, so the sums are exact and
//          deterministic); the block stores the bank.
//
// Instructions after the last clause end (the padded tail) never emit and
// are not walked.  Literal rows are clamped into [0, L2) as the TPU
// kernel's dynamic index clamps them.  A table entry outside [0, I_cap)
// is not walked and a run starts at 0 at the earliest, so no table makes
// the kernel read outside its operands.  Limits: m_cap <= 65535 (grid.y)
// and L2 * W < 2^30 words (32-bit byte offsets of literal rows).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 8;  // batch words per block: lanes of a group
constexpr int kGroups = kThreads / kTileW;  // clauses walked at once
constexpr int kRun = 2 * kTileW;  // includes per run: two lit_idx per lane
constexpr int kChunk = 2048;  // clauses scanned per round
constexpr int kPerThread = kChunk / kThreads;
constexpr int kBankRow = 33;  // bank entries per word: 32 bits + pad
constexpr unsigned kFull = 0xFFFFFFFFu;

// Byte offset of the literal row named by lit_idx[t], clamped into
// [0, L2), where t <= end (t >= 0); else 0
__device__ __forceinline__ unsigned row_offset(
    const int32_t* __restrict__ lit_idx, int t, int end, int l2,
    unsigned row_bytes) {
  if (t > end) return 0u;
  return (unsigned)min(max(__ldg(lit_idx + t), 0), l2 - 1) * row_bytes;
}

// AND into acc the literal words of the includes t .. t + kRun - 1 (up to
// end) whose row offsets lane sub of the group holds for t + sub and
// t + 8 + sub
__device__ __forceinline__ uint32_t and_run(uint32_t acc, unsigned a,
                                            unsigned b, int t, int end,
                                            bool live, const char* lane_lits) {
  uint32_t x[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const unsigned off =
        __shfl_sync(kFull, i < kTileW ? a : b, i % kTileW, kTileW);
    x[i] = live && t + i <= end
               ? __ldg(reinterpret_cast<const uint32_t*>(lane_lits + off))
               : kFull;
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) acc &= x[i];
  return acc;
}

__global__ void __launch_bounds__(kThreads)
tm_interp_kernel(const int32_t* __restrict__ lit_idx, int i_cap,
                 const int32_t* __restrict__ clause_end, int n_clauses,
                 const int32_t* __restrict__ pol,
                 const int32_t* __restrict__ cls,
                 const uint32_t* __restrict__ lits, int l2, int w_words,
                 int m_cap, int32_t* __restrict__ out) {
  __shared__ int s_start[kChunk], s_end[kChunk];
  __shared__ int s_bank[kTileW * kBankRow];
  __shared__ int s_count;
  const int w0 = blockIdx.x * kTileW;
  const int m = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int sub = t % kTileW, g = t / kTileW;
  const int w = w0 + sub;
  const bool live = w < w_words;
  const unsigned row_bytes = 4u * (unsigned)w_words;
  const char* lane_lits = reinterpret_cast<const char*>(lits + w);
  int* bank = s_bank + sub * kBankRow;
  for (int i = t; i < kTileW * kBankRow; i += kThreads) s_bank[i] = 0;

  for (int c0 = 0; c0 < n_clauses; c0 += kChunk) {
    if (t == 0) s_count = 0;
    // stage: the round's clause ends, then the class at each end, each
    // level issued before use; lane 0 loads its predecessor's end
    int end[kPerThread], prev[kPerThread], c[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int k = c0 + i * kThreads + t;
      end[i] = k < n_clauses ? __ldg(clause_end + k) : -1;
      prev[i] = lane == 0 && k > 0 && k <= n_clauses
                    ? __ldg(clause_end + k - 1) : -1;
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int up = __shfl_up_sync(kFull, end[i], 1);
      if (lane > 0) prev[i] = up;
      const bool ok = end[i] >= 0 && end[i] < i_cap;
      c[i] = ok ? min(max(__ldg(cls + end[i]), 0), m_cap - 1) : -1;
    }
    __syncthreads();  // s_count is reset
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const bool mine = c[i] == m;
      const unsigned sel = __ballot_sync(kFull, mine);
      int slot = 0;
      if (lane == 0 && sel) slot = atomicAdd(&s_count, __popc(sel));
      slot = __shfl_sync(kFull, slot, 0) + __popc(sel & ((1u << lane) - 1u));
      if (mine) {
        const int e = end[i];
        s_end[slot] = e;
        s_start[slot] = prev[i] < 0 ? 0 : (prev[i] >= e ? e + 1 : prev[i] + 1);
      }
    }
    __syncthreads();
    const int nc = s_count;

    // walk: group g takes clauses g, g + kGroups, ... of the round
    const int rounds = (nc + kGroups - 1) / kGroups;
    int j = g, st = 0, en = -1;
    if (j < nc) st = s_start[j], en = s_end[j];
    int pj = en >= 0 ? __ldg(pol + en) : 0;
    unsigned r0 = row_offset(lit_idx, st + sub, en, l2, row_bytes);
    unsigned r1 = row_offset(lit_idx, st + kTileW + sub, en, l2, row_bytes);
    for (int r = 0; r < rounds; ++r) {
      const int jn = j + kGroups;
      int nst = 0, nen = -1;
      if (jn < nc) nst = s_start[jn], nen = s_end[jn];
      const int np = nen >= 0 ? __ldg(pol + nen) : 0;
      const unsigned n0 = row_offset(lit_idx, nst + sub, nen, l2, row_bytes);
      const unsigned n1 =
          row_offset(lit_idx, nst + kTileW + sub, nen, l2, row_bytes);
      uint32_t acc = en >= 0 ? kFull : 0u;
      acc = and_run(acc, r0, r1, st, en, live, lane_lits);
      // the rest of the clauses longer than one run
      for (int d = kRun; __any_sync(kFull, en >= 0 && st + d <= en);
           d += kRun) {
        const int tt = st + d;
        const unsigned a0 = row_offset(lit_idx, tt + sub, en, l2, row_bytes);
        const unsigned a1 =
            row_offset(lit_idx, tt + kTileW + sub, en, l2, row_bytes);
        acc = and_run(acc, a0, a1, tt, en, live, lane_lits);
      }
      if (live) {
        for (uint32_t word = acc; word; word &= word - 1) {
          atomicAdd(bank + __ffs(word) - 1, pj);
        }
      }
      j = jn, st = nst, en = nen, pj = np, r0 = n0, r1 = n1;
    }
    __syncthreads();  // the next round rewrites the staged clauses
  }

  // datapoint 32 w + b of the tile is bank entry (w, b)
  __syncthreads();
  int32_t* dst = out + (size_t)m * 32 * w_words + 32 * (size_t)w0;
  const int n_out = 32 * min(kTileW, w_words - w0);
  for (int o = t; o < n_out; o += kThreads) {
    dst[o] = s_bank[(o >> 5) * kBankRow + (o & 31)];
  }
}

}  // namespace

extern "C" {

// lit_idx, pol, cls: int32[i_cap]; clause_end: int32[n_clauses], the
// emitting instructions in order; out: int32[m_cap][32 w_words], every
// element written.
int tm_interp_launch(const int32_t* lit_idx, int i_cap,
                     const int32_t* clause_end, int n_clauses,
                     const int32_t* pol, const int32_t* cls,
                     const uint32_t* lits, int l2, int w_words, int m_cap,
                     int32_t* out, void* stream) {
  if (i_cap <= 0 || n_clauses < 0 || l2 <= 0 || w_words <= 0 || m_cap <= 0 ||
      m_cap > 65535 ||                         // grid.y
      (long long)l2 * w_words >= (1LL << 30)) {  // byte offsets fit 32 bits
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = (w_words + kTileW - 1) / kTileW;
  tm_interp_kernel<<<dim3(tiles, m_cap), kThreads, 0, (cudaStream_t)stream>>>(
      lit_idx, i_cap, clause_end, n_clauses, pol, cls, lits, l2, w_words,
      m_cap, out);
  return (int)cudaGetLastError();
}

int tm_interp_attributes(int which, int* regs, int* local_bytes,
                         int* shared_bytes) {
  if (which != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, tm_interp_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  return 0;
}

const char* tm_interp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
