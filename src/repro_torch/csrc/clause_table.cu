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
// What bounds it on an H100: the gathers, and the chain of dependent
// loads behind each row.  Reading the inputs once is a few microseconds at
// the memory's rate (tm-xl: 43 MB of tables, 34 MB of packed literals),
// but the function gathers one literal word per slot and batch word.  The
// plain algorithm at tm-xl (5.4M includes x 1,024 words) would move 22 GB
// through L2; a walk that leaves a row once its AND is zero moved ~3.5 GB
// there on phase 3f's planted inputs when it loaded every pad slot, and
// less once repeated slots are collapsed (both figures are estimates from
// the shapes and the inputs' densities, not measurements).  The reference's XLA form materializes the gathered
// [rows, lc, words] block (44 GB at tm-xl); this kernel never does.
//
//   * A block owns a (class, 32 * VEC-word tile) of the output; each lane
//     owns VEC batch words, so a warp's literal load of one slot is one
//     contiguous 128 * VEC-byte span.  VEC = 4 (one 16-byte load per lane
//     and slot, a quarter of the load instructions) needs rows of packed1
//     aligned to 16 bytes; the wrapper takes it when 32-word tiles would
//     not fill the card and 128-word ones, split, still give every SM a
//     block (kernels/clause_table/kernel.py:clause_table_shape).
//   * When the tiles leave SMs idle, `split` blocks of a thread-block
//     cluster share a tile.  Block r of the cluster takes the class's rows
//     r*16 + warp, stepping by split*16; at the end each block sums a
//     1/split share of the tile over the cluster's shared tiles
//     (distributed shared memory) and stores it, so every output element
//     is stored once and no global atomics are needed.
//   * Repeated slots are collapsed.  AND is idempotent, so a slot whose
//     row (after a negative index is wrapped) equals the slot before it
//     adds nothing: after each coalesced load of 32 indices a ballot marks
//     the slots whose row differs from the previous slot's (the last row
//     is carried across chunks), and slots that read as all ones are not
//     marked.  The warp gathers only the marked slots, BATCH loads in
//     flight.  The pads that fill_clause_tables puts after a row's
//     includes name one row, so a planted row loads its includes and one
//     pad, whatever that row holds: nothing here assumes pads read as ones.
//   * Every load is unconditional.  A load whose result is selected at
//     once (a lane without a slot, a batch past the marked slots) stalls
//     the warp until it arrives, since a warp issues in order; so idle
//     lanes read a clamped address and a short batch loads its first
//     row again.  The chain is overlapped: a warp loads the next row's
//     polarity and first 32 indices, and within a row the next 32
//     indices, before it consumes the current gathers.
//   * A warp leaves a row once its AND is zero in all lanes (checked after
//     each batch); rows of polarity 0 (padding) are skipped.  A row that
//     ends nonzero adds its polarity to the shared tile's bits with shared
//     atomics (integers: the sums do not depend on the order).
//   * The literals are not staged in shared memory.  At paper width a
//     128-word tile of packed1 takes 803 KB, over the 227 KB a block may
//     hold; a 32-word tile (200 KB) fits one block per SM, but a block
//     split over a cluster gathers about as many bytes as that tile holds;
//     at tm-xl a 32-word tile takes 1 MB.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplit = 8;   // the portable cluster size
constexpr unsigned kFull = 0xFFFFFFFFu;

// VEC batch words per lane; BATCH slot loads in flight per warp.
template <int VEC>
struct Words {
  uint32_t v[VEC];
};

template <int VEC>
__device__ __forceinline__ Words<VEC> load_words(const uint32_t* p) {
  Words<VEC> r;
  if constexpr (VEC == 4) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    r.v[0] = q.x, r.v[1] = q.y, r.v[2] = q.z, r.v[3] = q.w;
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

template <int VEC, int BATCH>
__global__ void __launch_bounds__(kThreads, 2)
clause_table_kernel(const int32_t* __restrict__ idx,
                    const int32_t* __restrict__ pol, int n_clauses, int lc,
                    const uint32_t* __restrict__ packed1, int n_rows,
                    int w_words, int32_t* __restrict__ out) {
  constexpr int kTile = 32 * VEC;      // batch words of a block's tile
  __shared__ int s_sum[kTile][33];     // [word of the tile][bit], padded
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int part = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = blockIdx.y;
  const int w0 = (blockIdx.x / split) * kTile;
  const bool live = w0 + lane * VEC < w_words;  // whole: VEC divides W
  const uint32_t* col = packed1 + (live ? w0 + lane * VEC : 0);
  const int32_t* pol_m = pol + (size_t)m * n_clauses;
  const int32_t* idx_m = idx + (size_t)m * n_clauses * lc;
  const int n0 = min(32, lc);
  const int stride = split * kWarps;
  int c = part * kWarps + warp;
  const int lane0 = min(lane, n0 - 1);
  int p_next = 0, raw_next = 0;  // the next row's polarity, first indices
  if (c < n_clauses) {
    p_next = __ldg(pol_m + c);
    if (lc > 0) raw_next = __ldg(idx_m + (size_t)c * lc + lane0);
  }
  for (int i = threadIdx.x; i < kTile * 33; i += kThreads) {
    (&s_sum[0][0])[i] = 0;
  }
  __syncthreads();
  for (; c < n_clauses; c += stride) {
    const int p = p_next;
    int raw = raw_next;
    const int32_t* ri = idx_m + (size_t)c * lc;
    if (c + stride < n_clauses) {
      p_next = __ldg(pol_m + c + stride);
      if (lc > 0) raw_next = __ldg(ri + (size_t)stride * lc + lane0);
    }
    if (p == 0) continue;  // contributes nothing
    Words<VEC> acc;
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc.v[k] = live ? kFull : 0u;
    int last = -1;  // the previous slot's row; -1: none, or all ones
    bool zero = false;
    for (int j0 = 0; j0 < lc && !zero; j0 += 32) {
      const int n = min(32, lc - j0);
      int raw_more = 0;  // the next chunk's indices
      if (j0 + 32 < lc) raw_more = __ldg(ri + j0 + 32 + min(lane, lc - j0 - 33));
      int mine = raw < 0 ? raw + n_rows : raw;
      // -1 marks a slot that reads as all ones
      mine = (lane < n && (unsigned)mine < (unsigned)n_rows) ? mine : -1;
      int before = __shfl_up_sync(kFull, mine, 1);
      if (lane == 0) before = last;
      unsigned todo = __ballot_sync(kFull, mine >= 0 && mine != before);
      last = __shfl_sync(kFull, mine, n - 1);
      while (todo) {
        // a batch past the marked slots loads the first slot's row again
        // (AND is idempotent), so every load is unconditional
        const int first = __ffs(todo) - 1;
        Words<VEC> x[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int i = __shfl_sync(kFull, mine, todo ? __ffs(todo) - 1 : first);
          x[u] = load_words<VEC>(col + (size_t)i * w_words);
          todo &= todo - 1;
        }
        uint32_t any = 0;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
#pragma unroll
          for (int u = 0; u < BATCH; ++u) acc.v[k] &= x[u].v[k];
          any |= acc.v[k];
        }
        if (!__any_sync(kFull, any)) {
          zero = true;
          break;
        }
      }
      raw = raw_more;
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      for (uint32_t a = acc.v[k]; a; a &= a - 1) {
        atomicAdd(&s_sum[lane * VEC + k][__ffs(a) - 1], p);
      }
    }
  }
  if (split > 1) {
    cluster.sync();  // every block's tile is complete and visible
  } else {
    __syncthreads();
  }
  // block `part` stores a 1/split share of the tile, summed over the
  // cluster's tiles
  const int n_out = min(kTile, w_words - w0) * 32;
  const int share = ((n_out + split - 1) / split + 31) & ~31;
  const int e1 = min(n_out, (part + 1) * share);
  int32_t* o = out + ((size_t)m * w_words + w0) * 32;
  for (int e = part * share + threadIdx.x; e < e1; e += kThreads) {
    const int at = (e >> 5) * 33 + (e & 31);
    int s = 0;
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q) {
      if (q < split) s += cluster.map_shared_rank(&s_sum[0][0], q)[at];
    }
    o[e] = s;
  }
  if (split > 1) {
    // no block leaves while its tile is being read; the stores above need
    // not be visible to the cluster, so the arrive is relaxed
    asm volatile(
        "barrier.cluster.arrive.relaxed.aligned;\n"
        "barrier.cluster.wait.aligned;\n" ::: "memory");
  }
}

using Kernel = void (*)(const int32_t*, const int32_t*, int, int,
                        const uint32_t*, int, int, int32_t*);

// The two forms: 1 or 4 batch words per lane.
Kernel kernel_for(int vec) {
  return vec == 4 ? clause_table_kernel<4, 8> : clause_table_kernel<1, 16>;
}

}  // namespace

extern "C" {

// idx: int32[n_classes][n_clauses][lc]; pol: int32[n_classes][n_clauses];
// packed1: uint32[n_rows][w_words]; out: int32[n_classes][w_words * 32];
// vec: batch words per lane, 1 or 4 (4 needs w_words % 4 == 0 and a
// 16-byte aligned packed1); split: blocks (one cluster) per (class,
// 32 * vec-word tile), 1 to 8.
int clause_table_launch(const int32_t* idx, const int32_t* pol, int n_classes,
                        int n_clauses, int lc, const uint32_t* packed1,
                        int n_rows, int w_words, int vec, int split,
                        int32_t* out, void* stream) {
  if (n_classes <= 0 || n_classes > 65535 || n_clauses < 0 || lc < 0 ||
      n_rows <= 0 || w_words <= 0 || split < 1 || split > kMaxSplit ||
      !(vec == 1 || (vec == 4 && w_words % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(packed1) % 16 == 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const int tile = 32 * vec;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)((w_words + tile - 1) / tile * split), n_classes);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel_for(vec), idx, pol, n_clauses,
                                 lc, packed1, n_rows, w_words, out);
}

// Clusters of `split` blocks of the form with `vec` words per lane that
// the card keeps resident at once (cudaOccupancyMaxActiveClusters).
int clause_table_max_clusters(int vec, int split, int* clusters) {
  if (!(vec == 1 || vec == 4) || split < 1 || split > kMaxSplit) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(split);
  cfg.blockDim = dim3(kThreads);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel_for(vec), &cfg);
}

// which: 0 for the form with one batch word per lane, 1 for four.
int clause_table_attributes(int which, int* regs, int* local_bytes,
                            int* shared_bytes) {
  if (which != 0 && which != 1) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, kernel_for(which == 1 ? 4 : 1));
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
