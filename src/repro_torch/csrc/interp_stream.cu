// The paper's stream interpreter (Fig 4.4-4.6) on Hopper.
//
// Replaces repro/core/interp.py:interpret_stream, a lax.scan over the
// instruction memory (not a Pallas kernel: the reference leaves it to
// XLA).  Same function: from imem (uint16 instructions held as int32),
// n_active live instructions, the packed feature memory feats[F_cap][W]
// (bit b of word w = datapoint 32w + b) and an optional weight memory
// wmem, the class sums out[m_cap][32 W].  A boundary (E or CC differs from
// the previous live instruction's) finalizes the open clause if it ANDed a
// literal: pol * wmem[clip(ordinal)] is added to each datapoint whose bit
// is set, in row cls (cls in [0, m_cap)), row cls + m_cap (cls in
// [-m_cap, 0): the scatter wraps) or nowhere; then the class advances iff
// E toggled, the pointer resets and P sets the polarity.  Every live
// instruction adds its offset field to the pointer (EXTEND = 0x0FFF is its
// own 4095 slots); a non-EXTEND ANDs feature row clip(ptr >> 1, 0,
// F_cap - 1), complemented under L, into the clause word.  The last open
// clause is finalized into row clip(cls, 0, m_cap - 1).
//
// What bounds it on an H100: neither bytes nor operations but the chain.
// The pointer, the class, the polarity and the clause word of each
// instruction depend on every instruction before it, so the work that the
// data needs (one AND per include and word, ~4.4M at the paper's MNIST
// width, and 1.2 MB of operands) is far under a microsecond, while the walk
// is 17k instructions long.  The design parallelizes over batch words and
// over windows of 32 instructions:
//
//   a warp owns one batch word (32 datapoints), so the grid is W blocks of
//   one warp, and stages the word's feature column (F_cap words) and its
//   class-sum bank (m_cap x 32 sums) in shared memory; no atomics;
//   per window, lane j decodes instruction j; the boundaries, the class,
//   the polarity and whether a clause is non-empty come from ballots of
//   the 32 decoded fields (bit tricks, no loop); the pointer is a prefix
//   sum that restarts at boundaries and the clause word a prefix AND that
//   restarts at boundaries, each five shuffles (Hillis-Steele), carried
//   from window to window in registers;
//   each finalized clause of the window is then broadcast, and lane b adds
//   its vote to datapoint b's column: a lane owns its column, so the bank
//   takes no conflicts and needs no synchronization.
//
// The windows of one word run in order: at the paper's width the grid is
// 256 one-warp blocks, under 2 per SM, each walking 536 windows.  Splitting
// the stream across blocks needs each segment's starting class and
// ordinal, which the decoded plan has; that is a later design.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kExtend = 0x0FFFu;

// index of the highest set bit, -1 for none
__device__ __forceinline__ int top_bit(unsigned m) {
  return m ? 31 - __clz(m) : -1;
}

__device__ __forceinline__ int weight_at(const int32_t* wmem, int n_weights,
                                         int ordinal) {
  return wmem ? __ldg(wmem + min(max(ordinal, 0), n_weights - 1)) : 1;
}

__global__ void __launch_bounds__(32)
interp_stream_kernel(const int32_t* __restrict__ imem, int n_active,
                     const uint32_t* __restrict__ feats, int f_cap, int w_words,
                     const int32_t* __restrict__ wmem, int n_weights, int m_cap,
                     int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_feat = smem;                               // [f_cap]
  unsigned* s_sums = smem + f_cap;                       // [m_cap][32]
  const int lane = threadIdx.x;
  const int w = blockIdx.x;
  for (int r = lane; r < f_cap; r += 32) {
    s_feat[r] = __ldg(feats + (size_t)r * w_words + w);
  }
  for (int m = 0; m < m_cap; ++m) s_sums[m * 32 + lane] = 0u;  // own column
  __syncwarp();

  const unsigned le = (2u << lane) - 1u;  // lanes <= this one
  const unsigned lt = (1u << lane) - 1u;  // lanes below this one
  // the carry: the state after the last live instruction of the windows so far
  unsigned ptr = 0u, acc = kFull, prev_e = 0u, prev_cc = 0u;
  int cls = -1, pol = 1, ordinal = 0;
  bool nonempty = false;
  // the window's instructions are loaded one window ahead, so the load's
  // latency overlaps the walk of the window before
  unsigned ahead = lane < n_active ? (unsigned)__ldg(imem + lane) : 0u;
  for (int base = 0; base < n_active; base += 32) {
    const bool live = base + lane < n_active;
    const unsigned ins = ahead & 0xFFFFu;  // 0 when not live
    const int next = base + 32 + lane;
    ahead = next < n_active ? (unsigned)__ldg(imem + next) : 0u;
    const unsigned e = ins >> 15 & 1u, cc = ins >> 14 & 1u;
    const unsigned off = ins & 0x0FFFu;
    const unsigned e_mask = __ballot_sync(kFull, live && e);
    const unsigned cc_mask = __ballot_sync(kFull, live && cc);
    // the previous live instruction is the lane below (live lanes are a
    // prefix of the window), or the carry for lane 0
    const unsigned pe = lane ? e_mask >> (lane - 1) & 1u : prev_e;
    const unsigned pcc = lane ? cc_mask >> (lane - 1) & 1u : prev_cc;
    const bool toggle_e = live && e != pe;
    const bool boundary = toggle_e || (live && cc != pcc);
    const bool include = live && off != kExtend;
    const unsigned b_mask = __ballot_sync(kFull, boundary);
    const unsigned t_mask = __ballot_sync(kFull, toggle_e);
    const unsigned p_mask = __ballot_sync(kFull, boundary && (ins >> 13 & 1u));
    const unsigned i_mask = __ballot_sync(kFull, include);
    const int head = top_bit(b_mask & le);   // where this lane's clause opened
    const int head_before = top_bit(b_mask & lt);  // ... the clause before it

    // the literal pointer: offsets summed from the clause's head (unsigned:
    // it wraps as the reference's int32 does)
    const unsigned add = live ? off : 0u;
    unsigned sum = add;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned t = __shfl_up_sync(kFull, sum, d);
      if (lane >= d) sum += t;
    }
    const unsigned below_head = __shfl_sync(kFull, sum - add, head < 0 ? 0 : head);
    const int p = (int)(head < 0 ? ptr + sum : sum - below_head);
    unsigned lit = kFull;
    if (include) {
      lit = s_feat[min(max(p >> 1, 0), f_cap - 1)] ^ ((ins >> 12 & 1u) ? kFull : 0u);
    }
    // the clause word: literals ANDed from the clause's head
    unsigned a = lit;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned t = __shfl_up_sync(kFull, a, d);
      if (lane >= d && lane - d >= head) a &= t;
    }
    if (head < 0) a &= acc;

    // what a boundary on this lane finalizes: the state before it
    unsigned a_before = __shfl_up_sync(kFull, a, 1);
    if (lane == 0) a_before = acc;
    const bool ne_before = head_before >= 0
        ? (i_mask & lt & (kFull << head_before)) != 0u
        : nonempty || (i_mask & lt) != 0u;
    const bool fin = boundary && ne_before;
    const unsigned f_mask = __ballot_sync(kFull, fin);
    const int pol_before = head_before >= 0
        ? ((p_mask >> head_before & 1u) ? 1 : -1) : pol;
    const int cls_before = cls + __popc(t_mask & lt);
    unsigned vote = 0u;
    if (fin) {
      vote = (unsigned)pol_before *
             (unsigned)weight_at(wmem, n_weights, ordinal + __popc(f_mask & lt));
    }
    // scatter the window's finished clauses: lane b adds to datapoint b
    for (unsigned m = f_mask; m; m &= m - 1u) {
      const int j = __ffs(m) - 1;
      const unsigned word = __shfl_sync(kFull, a_before, j);
      const unsigned v = __shfl_sync(kFull, vote, j);
      int row = __shfl_sync(kFull, cls_before, j);
      row = row < 0 ? row + m_cap : row;
      if (row >= 0 && row < m_cap && (word >> lane & 1u)) {
        s_sums[row * 32 + lane] += v;
      }
    }

    // carry the state after the window's last live instruction
    const int head_last = top_bit(b_mask);
    ptr = __shfl_sync(kFull, (unsigned)p, 31);
    acc = __shfl_sync(kFull, a, 31);
    nonempty = head_last >= 0 ? (i_mask & (kFull << head_last)) != 0u
                              : nonempty || i_mask != 0u;
    if (head_last >= 0) pol = (p_mask >> head_last & 1u) ? 1 : -1;
    cls += __popc(t_mask);
    ordinal += __popc(f_mask);
    const int last = min(31, n_active - 1 - base);
    prev_e = e_mask >> last & 1u;
    prev_cc = cc_mask >> last & 1u;
  }
  if (nonempty && (acc >> lane & 1u)) {
    const int row = min(max(cls, 0), m_cap - 1);
    s_sums[row * 32 + lane] +=
        (unsigned)pol * (unsigned)weight_at(wmem, n_weights, ordinal);
  }
  const size_t row_words = (size_t)w_words * 32;
  for (int m = 0; m < m_cap; ++m) {
    out[m * row_words + (size_t)w * 32 + lane] = (int32_t)s_sums[m * 32 + lane];
  }
}

}  // namespace

extern "C" {

// imem: int32[>= n_active]; feats: uint32[f_cap][w_words]; wmem: int32
// [n_weights] or null (weight 1); out: int32[m_cap][32 w_words].
int interp_stream_launch(const int32_t* imem, int n_active,
                         const uint32_t* feats, int f_cap, int w_words,
                         const int32_t* wmem, int n_weights, int m_cap,
                         int32_t* out, void* stream) {
  if (n_active < 0 || f_cap <= 0 || w_words <= 0 || m_cap <= 0 ||
      (wmem && n_weights <= 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t shared = 4 * ((size_t)f_cap + 32 * (size_t)m_cap);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        interp_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  interp_stream_kernel<<<w_words, 32, shared, (cudaStream_t)stream>>>(
      imem, n_active, feats, f_cap, w_words, wmem, n_weights, m_cap, out);
  return (int)cudaGetLastError();
}

int interp_stream_attributes(int which, int* regs, int* local_bytes,
                             int* shared_bytes) {
  if (which != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, interp_stream_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  return 0;
}

const char* interp_stream_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
