// Dense bitpacked clause evaluation of a Tsetlin Machine on Hopper.
//
// Replaces repro/kernels/clause_eval/kernel.py:_clause_eval_kernel, the
// Pallas TPU kernel driven by clause_eval.  Same function: for clause k
// and batch word w
//     out[k, w] = AND over {l : actions[k, l] == 1} of lits[l, w]
// (all ones when no action is 1), and out[k, w] = 0 when the actions of
// clause k sum to 0 or less (an empty clause outputs 0 at inference).
//
// What bounds it on an H100: bytes.  The work that the data needs is one
// AND per include and batch word (4.3M at the paper's MNIST width, well
// under a microsecond at the integer rate), but the int32 include mask is
// 12.5 MB.  The TPU kernel masks every (literal, word) pair on the VPU
// out of VMEM; here that dense count (803M masked ANDs) would cost more
// than reading the mask.  So a block of 256 threads owns one clause and
// 256 batch words, and does two things per round of up to 4096 literals:
//
//   1  the whole block reads the clause's action row once, coalesced, and
//      compacts the literals whose action is 1 into a list in shared
//      memory (one __ballot_sync per warp and one shared atomic per warp
//      for the warp's slots: AND commutes, so list order is free);
//   2  each thread ANDs the listed literal rows of its batch word: the
//      list entry is a broadcast and the literal load is coalesced across
//      the warp's neighbouring words.
//
// The action sum for the empty-clause test is a warp reduction plus one
// shared atomic per warp.  No global atomics: results are deterministic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kListChunk = 4096;  // literals compacted per round (16 KB)
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
clause_eval_kernel(const int32_t* __restrict__ actions,
                   const uint32_t* __restrict__ lits, int l2, int w_words,
                   uint32_t* __restrict__ out) {
  __shared__ int s_list[kListChunk];
  __shared__ int s_count;
  __shared__ int s_sum;
  const int k = blockIdx.x;
  const int w = blockIdx.y * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int32_t* row = actions + (size_t)k * l2;
  uint32_t acc = kFull;
  int sum = 0;
  if (threadIdx.x == 0) s_sum = 0;
  for (int c0 = 0; c0 < l2; c0 += kListChunk) {
    const int c1 = min(l2, c0 + kListChunk);
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();
    // every thread runs the same trip count, so the ballots see full warps
    for (int base = c0; base < c1; base += kThreads) {
      const int l = base + threadIdx.x;
      const int a = l < c1 ? row[l] : 0;
      sum += a;
      const unsigned inc = __ballot_sync(kFull, a == 1);
      int slot = 0;
      if (lane == 0 && inc) slot = atomicAdd(&s_count, __popc(inc));
      slot = __shfl_sync(kFull, slot, 0);
      if (a == 1) s_list[slot + __popc(inc & ((1u << lane) - 1u))] = l;
    }
    __syncthreads();
    const int n = s_count;
    if (w < w_words) {
      for (int j = 0; j < n; ++j) {
        acc &= __ldg(lits + (size_t)s_list[j] * w_words + w);
      }
    }
    __syncthreads();  // the next round rewrites s_list and s_count
  }
  sum = __reduce_add_sync(kFull, sum);
  if (lane == 0) atomicAdd(&s_sum, sum);
  __syncthreads();
  if (w < w_words) out[(size_t)k * w_words + w] = s_sum > 0 ? acc : 0u;
}

}  // namespace

extern "C" {

// actions: int32[nc][l2]; lits: uint32[l2][w_words]; out: uint32[nc][w_words].
int clause_eval_launch(const int32_t* actions, const uint32_t* lits, int nc,
                       int l2, int w_words, uint32_t* out, void* stream) {
  if (nc <= 0 || l2 <= 0 || w_words <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(nc, (w_words + kThreads - 1) / kThreads);
  clause_eval_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      actions, lits, l2, w_words, out);
  return (int)cudaGetLastError();
}

const char* clause_eval_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
