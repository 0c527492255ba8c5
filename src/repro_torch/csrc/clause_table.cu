// Class sums of a clause-major include table on Hopper.
//
// Replaces repro/dist/tm_sharded.py:_local_plan_executor_clausemajor, the
// function the reference's sharded executor computes on every (class,
// batch) tile with XLA (jnp.take + lax.reduce, not Pallas).  Same
// function, for the class-major table of one tile: with clause rows
// k = m * n_clauses + c of class m,
//     word[k, w] = AND over j < lc of packed1[idx[k, j], w]
//     out[m, 32 w + b] = sum over the rows k of class m of
//                        bit b of word[k, w] * pol[k]
// An index in [-n_rows, 0) counts from the end and one outside
// [-n_rows, n_rows) reads as all ones, as the reference's take does; an
// empty row (lc = 0) is all ones.  Polarities are weighted (weight x
// polarity, up to +-7 for a pruned model): they are added, not assumed +-1.
//
// What bounds it on an H100: the gathers.  Reading the inputs once is a
// few microseconds at the memory's rate (tm-xl: 43 MB of tables, 34 MB of
// packed literals), but the plain algorithm gathers one literal word per
// include and batch word, which at tm-xl is 5.4M includes x 1,024 words
// (22 GB of L2 traffic).  The reference's XLA form materializes the
// gathered [rows, lc, words] block (44 GB at tm-xl); this kernel never
// does.  A simple design, right first:
//
//   * one block owns a (class, 32-word tile) of the output, so no two
//     blocks write one element and the result needs no global atomics;
//   * its 16 warps walk the class's clause rows (warp i takes rows i,
//     i + 16, ...), skipping rows whose polarity is 0 (padding);
//   * a row's indices come in 32 at a time, one coalesced load, and are
//     broadcast lane to lane (__shfl_sync); each lane owns one batch word,
//     so the literal word loads of a warp are coalesced (128 bytes), eight
//     issued before any is used;
//   * a warp stops a row once the AND is zero in all its lanes (AND keeps
//     a zero), which is where most rows of real and random data end;
//   * 32 bit sums per lane stay in registers; at the end the warps add
//     them into a [32 words x 32 bits] shared tile (shared atomics on
//     integers: the sums do not depend on the order) that the block
//     writes out coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 8;  // literal word loads issued together
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
clause_table_kernel(const int32_t* __restrict__ idx,
                    const int32_t* __restrict__ pol, int n_clauses, int lc,
                    const uint32_t* __restrict__ packed1, int n_rows,
                    int w_words, int32_t* __restrict__ out) {
  __shared__ int s_sum[32][33];  // [word of the tile][bit], padded
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = blockIdx.y;
  const int w0 = blockIdx.x * 32;
  const int w = w0 + lane;
  const bool live = w < w_words;
  for (int i = threadIdx.x; i < 32 * 33; i += kThreads) {
    (&s_sum[0][0])[i] = 0;
  }
  int cnt[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) cnt[b] = 0;
  const uint32_t* col = packed1 + w;
  for (int c = warp; c < n_clauses; c += kWarps) {
    const size_t row = (size_t)m * n_clauses + c;
    const int p = __ldg(pol + row);  // the same in every lane
    if (p == 0) continue;            // contributes nothing
    const int32_t* ri = idx + row * lc;
    uint32_t acc = live ? kFull : 0u;
    for (int j0 = 0; j0 < lc; j0 += 32) {
      const int n = min(32, lc - j0);
      int mine = lane < n ? __ldg(ri + j0 + lane) : 0;
      if (mine < 0) mine += n_rows;
      // -1 marks an index that reads as all ones
      mine = (lane < n && (unsigned)mine < (unsigned)n_rows) ? mine : -1;
      bool zero = false;
      for (int t = 0; t < n; t += kBatch) {
        uint32_t x[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = __shfl_sync(kFull, mine, (t + u) & 31);
          x[u] = (t + u < n && i >= 0 && live)
                     ? __ldg(col + (size_t)i * w_words)
                     : kFull;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) acc &= x[u];
        zero = !__any_sync(kFull, acc);
        if (zero) break;
      }
      if (zero) break;
    }
    if (__any_sync(kFull, acc)) {
#pragma unroll
      for (int b = 0; b < 32; ++b) cnt[b] += ((acc >> b) & 1u) ? p : 0;
    }
  }
  __syncthreads();  // the shared tile is zeroed
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    if (cnt[b]) atomicAdd(&s_sum[lane][b], cnt[b]);
  }
  __syncthreads();
  const int n_out = min(32, w_words - w0) * 32;
  int32_t* o = out + ((size_t)m * w_words + w0) * 32;
  for (int e = threadIdx.x; e < n_out; e += kThreads) {
    o[e] = s_sum[e >> 5][e & 31];
  }
}

}  // namespace

extern "C" {

// idx: int32[n_classes][n_clauses][lc]; pol: int32[n_classes][n_clauses];
// packed1: uint32[n_rows][w_words]; out: int32[n_classes][w_words * 32].
int clause_table_launch(const int32_t* idx, const int32_t* pol, int n_classes,
                        int n_clauses, int lc, const uint32_t* packed1,
                        int n_rows, int w_words, int32_t* out, void* stream) {
  if (n_classes <= 0 || n_classes > 65535 || n_clauses < 0 || lc < 0 ||
      n_rows <= 0 || w_words <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((w_words + 31) / 32, n_classes);
  clause_table_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      idx, pol, n_clauses, lc, packed1, n_rows, w_words, out);
  return (int)cudaGetLastError();
}

int clause_table_attributes(int which, int* regs, int* local_bytes,
                            int* shared_bytes) {
  if (which != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, clause_table_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  return 0;
}

const char* clause_table_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
