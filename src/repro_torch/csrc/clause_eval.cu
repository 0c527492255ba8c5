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
// 12.5 MB read once from device memory.  The TPU kernel masks every
// (literal, word) pair on the VPU out of VMEM; here that dense count (803M
// masked ANDs) would cost more than reading the mask.  Reading the mask
// at the memory's rate takes ~2.5 MB in flight across the card (Little's
// law at ~0.7 us of DRAM latency), so a block of 64 threads owns one
// clause and 256 batch words and does three things per round of up to
// 2048 literals:
//
//   stage    the threads copy the round's action row into shared memory
//            with cp.async, 16 bytes at a time where the row lies on the
//            16-byte grain (4 bytes where it does not), every copy issued
//            before any is waited for: the copies hold no registers, so a
//            whole row is in flight per block;
//   compact  the block reads the row back and compacts the literals whose
//            action is 1 into a list (one __ballot_sync and one shared
//            atomic per warp and 32 literals: AND commutes, so list order
//            is free), summing the actions for the empty-clause test;
//   AND      each thread ANDs the listed literal rows of its four batch
//            words, the list entry a broadcast and the literal load
//            coalesced across the warp (the literal panel stays in L2), in
//            batches of 4 entries whose 16 loads are issued together: a
//            batch past the end of the list repeats one of its includes
//            (AND is idempotent), so no load waits for another.
//
// Small blocks with four words per thread let every block of the paper's
// MNIST width (2000 clauses) be resident at once: one wave, whose row
// copies are all in flight together.  No global atomics: results are
// deterministic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kWords = 4;  // batch words per thread
constexpr int kTile = kThreads * kWords;  // batch words per block
constexpr int kChunk = 2048;  // literals staged per round (8 KB)
constexpr int kBatch = 4;  // list entries whose loads are issued together
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void cp_async(int32_t* dst, const int32_t* src,
                                         bool wide) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (wide) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  }
}

__global__ void __launch_bounds__(kThreads)
clause_eval_kernel(const int32_t* __restrict__ actions,
                   const uint32_t* __restrict__ lits, int l2, int w_words,
                   uint32_t* __restrict__ out) {
  __shared__ __align__(16) int32_t s_row[kChunk];
  __shared__ uint16_t s_list[kChunk];
  __shared__ int s_count;
  __shared__ int s_sum;
  const int t = threadIdx.x, lane = t & 31;
  const int k = blockIdx.x;
  const int w0 = blockIdx.y * kTile + t;
  const int32_t* row = actions + (size_t)k * l2;
  uint32_t acc[kWords];
#pragma unroll
  for (int q = 0; q < kWords; ++q) acc[q] = kFull;
  int sum = 0;
  if (t == 0) s_sum = 0;
  for (int c0 = 0; c0 < l2; c0 += kChunk) {
    const int n = min(kChunk, l2 - c0);
    const int32_t* src = row + c0;
    // stage: 16-byte copies where the row allows, the rest 4 bytes each
    const int n_vec =
        (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? n / 4 : 0;
    for (int i = t; i < n_vec; i += kThreads) {
      cp_async(s_row + 4 * i, src + 4 * i, true);
    }
    for (int l = 4 * n_vec + t; l < n; l += kThreads) {
      cp_async(s_row + l, src + l, false);
    }
    if (t == 0) s_count = 0;
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
    __syncthreads();
    // compact; every thread runs the same trip count, so the ballots see
    // full warps
    for (int base = 0; base < n; base += kThreads) {
      const int l = base + t;
      const int a = l < n ? s_row[l] : 0;
      sum += a;
      const unsigned inc = __ballot_sync(kFull, a == 1);
      int slot = 0;
      if (lane == 0 && inc) slot = atomicAdd(&s_count, __popc(inc));
      slot = __shfl_sync(kFull, slot, 0);
      if (a == 1) s_list[slot + __popc(inc & ((1u << lane) - 1u))] = l;
    }
    __syncthreads();
    const int cnt = s_count;
    const uint32_t* col = lits + (size_t)c0 * w_words + w0;
    for (int j = 0; j < cnt; j += kBatch) {
      uint32_t x[kBatch][kWords];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        // past the list the batch repeats include j: AND is idempotent
        const uint32_t* r =
            col + (size_t)s_list[j + u < cnt ? j + u : j] * w_words;
#pragma unroll
        for (int q = 0; q < kWords; ++q) {
          x[u][q] = w0 + q * kThreads < w_words ? __ldg(r + q * kThreads)
                                                : kFull;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int q = 0; q < kWords; ++q) acc[q] &= x[u][q];
      }
    }
    __syncthreads();  // the next round rewrites s_row, s_list and s_count
  }
  sum = __reduce_add_sync(kFull, sum);
  if (lane == 0) atomicAdd(&s_sum, sum);
  __syncthreads();
  const bool nonempty = s_sum > 0;
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const int w = w0 + q * kThreads;
    if (w < w_words) out[(size_t)k * w_words + w] = nonempty ? acc[q] : 0u;
  }
}

}  // namespace

extern "C" {

// actions: int32[nc][l2]; lits: uint32[l2][w_words]; out: uint32[nc][w_words].
int clause_eval_launch(const int32_t* actions, const uint32_t* lits, int nc,
                       int l2, int w_words, uint32_t* out, void* stream) {
  if (nc <= 0 || l2 <= 0 || w_words <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(nc, (w_words + kTile - 1) / kTile);
  clause_eval_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      actions, lits, l2, w_words, out);
  return (int)cudaGetLastError();
}

int clause_eval_attributes(int which, int* regs, int* local_bytes,
                           int* shared_bytes) {
  if (which != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, clause_eval_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  return 0;
}

const char* clause_eval_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
