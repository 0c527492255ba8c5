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
// against 21M ANDs and bit adds, 0.3 us at the integer rate); in practice
// latency and the scatter of the sums.  The TPU kernel walks the
// instructions in order, carries acc and the sum bank in VMEM across
// instruction blocks and expands acc to int32[B] bits on every
// instruction; a GPU has no order between blocks and no carry.  Clauses
// are independent, so the walk is split by clause (the clause-end table,
// the indices where last_flag == 1, is built on the host at program time):
//
//   grid  (32-word batch tiles) x (clause ranges) x (16-class tiles);
//   warp  one clause at a time; lane = batch word, so the literal loads
//         of a clause are coalesced and its pol and cls are broadcasts;
//   bank  the block's class sums for its 32 words in shared memory,
//         [class][bit][word] with rows padded to 33 words: a lane adds
//         pol into (class, bit, its word) for each set bit of its clause
//         word with a shared atomic add (lanes on the same bit hit
//         distinct banks; lanes on different bits may share one, as the
//         bits are data), and the flush reads conflict-free;
//   flush each nonzero bank entry is added into the zeroed output with
//         one global atomic add; threads walk bits fastest, so the adds
//         of a warp hit 32 consecutive words of one sum row.
//
// Integer addition commutes, so the atomics give the same sums in any
// order: the result is exact and deterministic.  Instructions after the
// last clause end (the padded tail) never emit and are not walked.
// Literal rows are clamped into [0, L2) as the TPU kernel's dynamic index
// clamps them.  The clause table comes from the host (clause_ends); an
// entry outside [0, I_cap) is skipped and a run starts at 0 at the
// earliest, so no table makes the kernel read outside its operands.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, one clause each at a time
constexpr int kWarps = kThreads / 32;
constexpr int kWordTile = 32;  // batch words per block: one per lane
constexpr int kClassTile = 16;
constexpr int kBankRow = 33;   // words per (class, bit) row of the bank
constexpr int kTargetBlocks = 528;  // four blocks for each of 132 SMs
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
tm_interp_kernel(const int32_t* __restrict__ lit_idx, int i_cap,
                 const int32_t* __restrict__ clause_end, int n_clauses,
                 const int32_t* __restrict__ pol,
                 const int32_t* __restrict__ cls,
                 const uint32_t* __restrict__ lits, int l2, int w_words,
                 int m_cap, int clauses_per_block, int32_t* __restrict__ out) {
  extern __shared__ int bank[];  // [mt][32 bits][kBankRow]
  const int w0 = blockIdx.x * kWordTile;
  const int k0 = blockIdx.y * clauses_per_block;
  const int k1 = min(n_clauses, k0 + clauses_per_block);
  const int m0 = blockIdx.z * kClassTile;
  const int mt = min(kClassTile, m_cap - m0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = w0 + lane;
  const int bank_size = mt * 32 * kBankRow;
  for (int i = threadIdx.x; i < bank_size; i += kThreads) bank[i] = 0;
  __syncthreads();

  for (int k = k0 + warp; k < k1; k += kWarps) {
    const int end = clause_end[k];
    if (end < 0 || end >= i_cap) continue;  // warp-uniform: a bad entry
    const int c = min(max(cls[end], 0), m_cap - 1) - m0;
    if (c < 0 || c >= mt) continue;  // warp-uniform: another class tile
    const int p = pol[end];
    const int start = k ? max(clause_end[k - 1] + 1, 0) : 0;
    uint32_t acc = w < w_words ? kFull : 0u;
    for (int t = start; t <= end && acc; ++t) {
      const int row = min(max(lit_idx[t], 0), l2 - 1);
      acc &= __ldg(lits + (size_t)row * w_words + w);
    }
    int* dst = bank + c * 32 * kBankRow + lane;
    while (acc) {
      const int bit = __ffs(acc) - 1;
      atomicAdd(dst + bit * kBankRow, p);
      acc &= acc - 1;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < mt * 32 * 32; i += kThreads) {
    const int bit = i & 31, word = (i >> 5) & 31, m = i >> 10;
    const int v = bank[(m * 32 + bit) * kBankRow + word];
    if (v != 0 && w0 + word < w_words) {
      atomicAdd(out + (size_t)(m0 + m) * 32 * w_words + 32 * (w0 + word) + bit,
                v);
    }
  }
}

}  // namespace

extern "C" {

// lit_idx, pol, cls: int32[i_cap]; clause_end: int32[n_clauses], the
// emitting instructions in order; out: int32[m_cap][32 w_words], zeroed
// by the caller.
int tm_interp_launch(const int32_t* lit_idx, int i_cap,
                     const int32_t* clause_end, int n_clauses,
                     const int32_t* pol, const int32_t* cls,
                     const uint32_t* lits, int l2, int w_words, int m_cap,
                     int32_t* out, void* stream) {
  if (i_cap <= 0 || n_clauses <= 0 || l2 <= 0 || w_words <= 0 || m_cap <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = (w_words + kWordTile - 1) / kWordTile;
  const int class_tiles = (m_cap + kClassTile - 1) / kClassTile;
  const int splits = (kTargetBlocks + tiles * class_tiles - 1) /
                     (tiles * class_tiles);
  int per_block = (n_clauses + splits - 1) / splits;
  if (per_block < kWarps) per_block = kWarps;
  if (per_block < (n_clauses + 65534) / 65535) {
    per_block = (n_clauses + 65534) / 65535;  // grid.y is at most 65535
  }
  const int mt = m_cap < kClassTile ? m_cap : kClassTile;
  const int smem = mt * 32 * kBankRow * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      tm_interp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles, (n_clauses + per_block - 1) / per_block, class_tiles);
  tm_interp_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      lit_idx, i_cap, clause_end, n_clauses, pol, cls, lits, l2, w_words,
      m_cap, per_block, out);
  return (int)cudaGetLastError();
}

const char* tm_interp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
