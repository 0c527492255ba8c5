// The paper's stream interpreter (Fig 4.4-4.6) on Hopper.
//
// Replaces repro/core/interp.py:interpret_stream, a lax.scan over the
// instruction memory (not a Pallas kernel: the reference leaves it to
// XLA).  Same function: from imem (uint16 instructions held as int32),
// n_active live instructions, the packed feature memory feats[F_cap][W]
// (bit b of word w = datapoint 32w + b) and an optional weight memory
// wmem, the class sums out[m_cap][32 W].  A boundary (E or CC differs from
// the previous live instruction's; the first compares against 0, 0)
// finalizes the open clause if it ANDed a literal: pol * wmem[clip(ordinal)]
// is added to each datapoint whose bit is set, in row cls (cls in
// [0, m_cap)), row cls + m_cap (cls in [-m_cap, 0): the scatter wraps) or
// nowhere; then the class advances iff E toggled, the pointer resets and P
// sets the polarity.  Every live instruction adds its offset field to the
// pointer (an int32 that wraps; EXTEND = 0x0FFF is its own 4095 slots); a
// non-EXTEND ANDs feature row clip(ptr >> 1, 0, F_cap - 1), complemented
// under L, into the clause word.  The last open clause is finalized into
// row clip(cls, 0, m_cap - 1).
//
// What bounds it on an H100: bytes (1.2 MB of operands and sums at the
// paper's MNIST width, 0.36 us at 3.35 TB/s, against 21M ANDs and adds).
// The chain through the stream (each instruction's class, pointer,
// polarity and clause depend on all before it) does not depend on the
// data, so the work splits in two launches on the caller's stream:
//
//   decode (independent of W): a block of 128 threads per tile of 1,024
//     instructions, 8 consecutive ones per thread (17 blocks at the
//     paper's width; on an H100 tiles of 2,048 and 4,096 took longer: a
//     block's time is mostly latency, not work).  Each thread folds its 8
//     into one associative summary of what they do to the interpreter's state
//     (toggles, includes, the offsets and includes since their last
//     boundary and its P bit, the includes before their first boundary,
//     the clauses they open and the class of the last); a block-wide scan
//     gives every thread the state before its first instruction within
//     the tile, and a decoupled look-back over the tiles before (their
//     published aggregates and prefixes, read 32 at a time) the state
//     before the tile: class, include index, pointer, polarity, the open
//     clause's literals, clause count.  The thread then walks its 8 again
//     and stages, per include, its feature row, complement mask and clause
//     and, per clause it opens, its first include, class and P bit in
//     shared memory, from where the block writes the tile's tables in
//     order (coalesced): per non-empty clause in emission order its first
//     include, the end of the clause before it, its vote and row_first[r],
//     the first clause whose class is at least r (classes only advance);
//     the boundary that finalizes a clause writes its row.
//   evaluate (grid: 8-word batch tiles x class rows, 320 blocks at the
//     paper's width): a block owns the output tile of its row and walks
//     that row's clauses, at most three ranges of the clause table (its
//     own class; on the last row the wrapped class -1; the clipped last
//     clause).  A group of 8 lanes (lane = batch word) carries one clause,
//     four per warp: the 16 includes of a run are loaded by the group at
//     once, turned into byte offsets of their feature rows with the
//     complement in bit 0, broadcast by shuffle, loaded and ANDed; each
//     set bit of the clause word adds the vote to the block's shared bank
//     (integer adds commute: exact and deterministic).  The block stores
//     its tile once, zeros where no clause lands: no zero fill and no
//     atomics on global memory.
//
// Limits: m_cap <= 65535 (grid.y), F_cap * W < 2^30 words (32-bit byte
// offsets of feature rows); any n_active up to the whole memory.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kExtend = 0x0FFFu;

// -- launch A: decode -------------------------------------------------------

constexpr int kDecodeThreads = 128;
constexpr int kItems = 8;  // consecutive instructions per thread
constexpr int kTile = kDecodeThreads * kItems;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kLookWords = 1 + 2 * 8;  // per tile: status, aggregate, prefix
// dynamic shared memory of the decode (21 KB): the tile's instructions,
// and its tables staged for writes in order (per include its row with the
// mask in bit 31 and its clause; per clause its first include, class and
// P bit)
constexpr size_t kDecodeShared = (size_t)kTile * (5 * 4 + 1);

// Launch A's tables in one scratch buffer of int32 words: a header
// (includes, clauses, clauses finalized at a boundary, 0), row_first
// [m_cap + 1], seven vectors of max(n_active, 1) words, then the tiles'
// look-back words (a tile counter, and per tile a status, its aggregate
// and its inclusive prefix), zeroed before each decode
struct Tables {
  int32_t *meta, *row_first, *inc_row, *inc_mask, *inc_clause, *cl_start,
      *cl_end, *cl_row, *cl_vote, *look;
};

__host__ __device__ inline int tiles_of(int n_active) {
  return (n_active + kTile - 1) / kTile;
}

__host__ __device__ inline Tables tables_of(int32_t* s, int n_active,
                                            int m_cap) {
  const size_t n = n_active > 0 ? (size_t)n_active : 1;
  int32_t* v = s + 4 + m_cap + 1;
  return Tables{s, s + 4, v, v + n, v + 2 * n, v + 3 * n, v + 4 * n,
                v + 5 * n, v + 6 * n, v + 7 * n};
}

__host__ __device__ inline size_t scratch_words(int n_active, int m_cap) {
  const size_t n = n_active > 0 ? (size_t)n_active : 1;
  return 4 + (size_t)m_cap + 1 + 7 * n + 1 + (size_t)kLookWords * tiles_of(n_active);
}

// What a run of instructions does to the interpreter's state, as one
// associative summary (so a block scan composes the runs of its threads):
// E toggles; includes; whether it holds a boundary (head_p >= 0, the P bit
// of its last one); the offsets (wrapping) and includes since its last
// boundary, or all of them; the includes before its first boundary, or
// all; the clauses it opens (first includes of segments headed inside
// it); and the toggles before the last of those.  Seeded with the state
// before the run (a "boundary" carrying the class, include count, pointer,
// polarity, open clause's includes, clause count and last clause's class),
// the same fields read as that state after it.
struct State {
  int tog, inc;
  unsigned off;
  int seg_inc, head_p, pre_inc, cnt, last_tog;
};

__device__ __forceinline__ State identity() {
  return State{0, 0, 0u, 0, -1, 0, 0, INT_MIN};
}

__device__ __forceinline__ State combine(const State& a, const State& b) {
  const bool a_head = a.head_p >= 0, b_head = b.head_p >= 0;
  // a clause that b's prefix opens: the segment a's last boundary heads
  // had no literal yet
  const bool opens = a_head && a.seg_inc == 0 && b.pre_inc > 0;
  return State{a.tog + b.tog,
               a.inc + b.inc,
               b_head ? b.off : a.off + b.off,
               b_head ? b.seg_inc : a.seg_inc + b.seg_inc,
               b_head ? b.head_p : a.head_p,
               a_head ? a.pre_inc : a.inc + b.pre_inc,
               a.cnt + opens + b.cnt,
               b.cnt ? a.tog + b.last_tog : opens ? a.tog : a.last_tog};
}

__device__ __forceinline__ State shfl_up(const State& s, int d) {
  return State{__shfl_up_sync(kFull, s.tog, d),
               __shfl_up_sync(kFull, s.inc, d),
               __shfl_up_sync(kFull, s.off, d),
               __shfl_up_sync(kFull, s.seg_inc, d),
               __shfl_up_sync(kFull, s.head_p, d),
               __shfl_up_sync(kFull, s.pre_inc, d),
               __shfl_up_sync(kFull, s.cnt, d),
               __shfl_up_sync(kFull, s.last_tog, d)};
}

// Block-wide exclusive scan of v seeded with carry: returns carry combined
// with the values of the threads before this one, and sets total to carry
// combined with every thread's.  s_warp holds kDecodeWarps + 1 values.
__device__ State block_scan(const State& v, const State& carry, State* s_warp,
                            State& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  State inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const State t = shfl_up(inc, d);
    if (lane >= d) inc = combine(t, inc);
  }
  State exc = shfl_up(inc, 1);
  if (lane == 0) exc = identity();
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    State w = lane < kDecodeWarps ? s_warp[lane] : identity();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const State t = shfl_up(w, d);
      if (lane >= d) w = combine(t, w);
    }
    State before = shfl_up(w, 1);  // the warps before this one
    if (lane == 0) before = identity();
    __syncwarp();
    if (lane < kDecodeWarps) s_warp[lane] = combine(carry, before);
    if (lane == kDecodeWarps - 1) s_warp[kDecodeWarps] = combine(carry, w);
  }
  __syncthreads();
  const State out = combine(s_warp[warp], exc);
  total = s_warp[kDecodeWarps];
  return out;
}

// One decoded instruction
struct Ins {
  bool toggle, boundary, include;
  unsigned off;
  int p, l;
};

__device__ __forceinline__ Ins decode_one(unsigned ins, bool live,
                                          unsigned& pe, unsigned& pcc) {
  Ins d{};
  if (!live) return d;
  ins &= 0xFFFFu;
  const unsigned e = ins >> 15 & 1u, cc = ins >> 14 & 1u;
  d.toggle = e != pe;
  d.boundary = d.toggle || cc != pcc;
  d.off = ins & 0x0FFFu;
  d.include = d.off != kExtend;
  d.p = (int)(ins >> 13 & 1u);
  d.l = (int)(ins >> 12 & 1u);
  pe = e;
  pcc = cc;
  return d;
}

__device__ __forceinline__ void store_state(volatile int32_t* dst, const State& v) {
  dst[0] = v.tog, dst[1] = v.inc, dst[2] = (int32_t)v.off, dst[3] = v.seg_inc;
  dst[4] = v.head_p, dst[5] = v.pre_inc, dst[6] = v.cnt, dst[7] = v.last_tog;
}

__device__ __forceinline__ State load_state(const volatile int32_t* src) {
  return State{src[0], src[1], (unsigned)src[2], src[3],
               src[4], src[5], src[6], src[7]};
}

__device__ __forceinline__ State shfl_down(const State& s, int d) {
  return State{__shfl_down_sync(kFull, s.tog, d),
               __shfl_down_sync(kFull, s.inc, d),
               __shfl_down_sync(kFull, s.off, d),
               __shfl_down_sync(kFull, s.seg_inc, d),
               __shfl_down_sync(kFull, s.head_p, d),
               __shfl_down_sync(kFull, s.pre_inc, d),
               __shfl_down_sync(kFull, s.cnt, d),
               __shfl_down_sync(kFull, s.last_tog, d)};
}

// The state before tile `tile`, by decoupled look-back (warp 0): publish
// the tile's aggregate, then read the 32 tiles before it at once and fold,
// oldest first, the aggregates back to the nearest tile whose inclusive
// prefix is out (or the stream's start), 32 tiles a round; then publish
// this tile's prefix.  Tiles are numbered in the order their blocks start,
// so a block waits only on blocks already running.
__device__ State look_back(int32_t* look, int tile, const State& agg,
                           const State& start) {
  const int lane = threadIdx.x & 31;
  auto slot = [&](int j) { return (volatile int32_t*)look + 1 + (size_t)kLookWords * j; };
  if (lane == 0 && tile > 0) {
    store_state(slot(tile) + 1, agg);
    __threadfence();
    slot(tile)[0] = 1;  // the aggregate is out
  }
  State carry = identity();  // the tiles folded so far
  for (int hi = tile - 1;; hi -= 32) {
    const int j = hi - lane;  // lane l reads tile hi - l
    int status = 2;           // before the first tile: the start, "inclusive"
    if (j >= 0) {
      while ((status = slot(j)[0]) == 0) {
      }
    }
    __threadfence();
    const unsigned done = __ballot_sync(kFull, status == 2);
    const int stop = done ? __ffs(done) - 1 : 32;
    State v = identity();
    if (lane <= stop) {
      v = j < 0 ? start : load_state(slot(j) + (status == 2 ? 9 : 1));
    }
    // lane 0 gathers v[stop] (oldest) .. v[0]
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const State t = shfl_down(v, d);
      if (lane + d < 32) v = combine(t, v);
    }
    carry = combine(v, carry);
    if (stop < 32) break;
  }
  carry = State{__shfl_sync(kFull, carry.tog, 0), __shfl_sync(kFull, carry.inc, 0),
                __shfl_sync(kFull, carry.off, 0), __shfl_sync(kFull, carry.seg_inc, 0),
                __shfl_sync(kFull, carry.head_p, 0), __shfl_sync(kFull, carry.pre_inc, 0),
                __shfl_sync(kFull, carry.cnt, 0), __shfl_sync(kFull, carry.last_tog, 0)};
  if (lane == 0) {
    store_state(slot(tile) + 9, combine(carry, agg));
    __threadfence();
    slot(tile)[0] = 2;  // the inclusive prefix is out
  }
  return carry;
}

__global__ void __launch_bounds__(kDecodeThreads)
decode_kernel(const int32_t* __restrict__ imem, int n_active, int f_cap,
              int m_cap, const int32_t* __restrict__ wmem, int n_weights,
              int32_t* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* s_ins = smem;                 // [kTile] the tile's instructions
  int* s_row = (int*)smem + kTile;        // [kTile] include: row | mask << 31
  int* s_k = s_row + kTile;               // [kTile] include: its clause
  int* s_start = s_k + kTile;             // [kTile] clause: first include
  int* s_cls = s_start + kTile;           // [kTile] clause: class
  unsigned char* s_pb = (unsigned char*)(s_cls + kTile);  // clause: P bit
  __shared__ State s_warp[kDecodeWarps + 1];
  __shared__ int s_tile;
  __shared__ State s_carry;
  const Tables tb = tables_of(scratch, n_active, m_cap);
  const int t = threadIdx.x;
  const int n_tiles = tiles_of(n_active);
  // the state before the stream: class -1, polarity +1 (P = 1), no clause
  // yet (the last one's class -1)
  const State start{-1, 0, 0u, 0, 1, 0, 0, -1};
  if (t == 0) s_tile = atomicAdd(tb.look, 1);
  __syncthreads();
  const int tile = s_tile, base = tile * kTile;
  State carry = start, tile_end = start;
  if (tile < n_tiles) {
#pragma unroll
    for (int k = t; k < kTile; k += kDecodeThreads) {
      s_ins[k] = base + k < n_active ? (unsigned)__ldg(imem + base + k) : 0u;
    }
    __syncthreads();
    const int first = base + t * kItems;
    const uint4* my_ins = reinterpret_cast<const uint4*>(s_ins + t * kItems);
    // the live instruction before this thread's first (the first of the
    // stream compares against E = 0, CC = 0)
    const unsigned before =
        t ? s_ins[t * kItems - 1] : base ? (unsigned)__ldg(imem + base - 1) : 0u;
    const unsigned e0 = before >> 15 & 1u, cc0 = before >> 14 & 1u;

    // 1. the summary of this thread's instructions
    State mine = identity();
    {
      const uint4 lo = my_ins[0], hi = my_ins[1];
      const unsigned words[kItems] = {lo.x, lo.y, lo.z, lo.w,
                                      hi.x, hi.y, hi.z, hi.w};
      unsigned pe = e0, pcc = cc0;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const Ins d = decode_one(words[j], first + j < n_active, pe, pcc);
        if (d.boundary) mine.off = 0u, mine.seg_inc = 0, mine.head_p = d.p;
        mine.tog += d.toggle;
        mine.off += d.off;  // 0 when not live
        if (d.include) {
          if (mine.head_p < 0) {
            ++mine.pre_inc;
          } else if (mine.seg_inc == 0) {
            ++mine.cnt;
            mine.last_tog = mine.tog;
          }
          ++mine.inc;
          ++mine.seg_inc;
        }
      }
    }
    // 2. the state before this thread's first instruction: the scan within
    // the tile, then the state before the tile from the tiles before it
    State agg;
    const State local = block_scan(mine, identity(), s_warp, agg);
    if (t < 32) {
      const State before_tile = look_back(tb.look, tile, agg, start);
      if (t == 0) s_carry = before_tile;
    }
    __syncthreads();
    carry = s_carry;
    tile_end = combine(carry, agg);
    const State in = combine(carry, local);

    // 3. the tables, staged by include and clause index within the tile;
    // a boundary that closes a clause with a literal gives it its row
    {
      const uint4 lo = my_ins[0], hi = my_ins[1];
      const unsigned words[kItems] = {lo.x, lo.y, lo.z, lo.w,
                                      hi.x, hi.y, hi.z, hi.w};
      unsigned pe = e0, pcc = cc0, ptr = in.off;
      int cls = in.tog, seg_inc = in.seg_inc, pbit = in.head_p;
      int g = in.inc - carry.inc, k = in.cnt - carry.cnt;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const Ins d = decode_one(words[j], first + j < n_active, pe, pcc);
        if (d.boundary) {
          if (seg_inc > 0) {  // clause carry.cnt + k - 1 is finalized here
            tb.cl_row[carry.cnt + k - 1] = cls >= 0 && cls < m_cap ? cls
                                           : cls < 0 && cls >= -m_cap ? cls + m_cap
                                                                      : -1;
          }
          cls += d.toggle, seg_inc = 0, ptr = 0u, pbit = d.p;
        }
        ptr += d.off;
        if (!d.include) continue;
        if (seg_inc == 0) {  // the first include of a clause: it opens k
          s_start[k] = carry.inc + g;
          s_cls[k] = cls;
          s_pb[k] = (unsigned char)pbit;
          ++k;
        }
        ++seg_inc;
        s_row[g] = min(max((int)ptr >> 1, 0), f_cap - 1) | (d.l << 31);
        s_k[g] = carry.cnt + k - 1;
        ++g;
      }
    }
    __syncthreads();
    // 4. the tile's tables, written out in order
    const int n_inc = agg.inc, n_cl = tile_end.cnt - carry.cnt;
    for (int i = t; i < n_inc; i += kDecodeThreads) {
      const int v = s_row[i], at = carry.inc + i;
      tb.inc_row[at] = v & 0x7FFFFFFF;
      tb.inc_mask[at] = v >> 31;  // 0, or -1 for a complemented literal
      tb.inc_clause[at] = s_k[i];
    }
    for (int i = t; i < n_cl; i += kDecodeThreads) {
      const int k = carry.cnt + i, cls = s_cls[i];
      tb.cl_start[k] = s_start[i];
      if (k > 0) tb.cl_end[k - 1] = s_start[i];
      const int w = wmem ? __ldg(wmem + min(k, n_weights - 1)) : 1;
      tb.cl_vote[k] = (int)((s_pb[i] ? 1u : kFull) * (unsigned)w);
      // the rows whose first clause this is: classes (the last one's, cls]
      const int c_prev = i ? s_cls[i - 1] : carry.last_tog;
      for (int r = max(c_prev + 1, 0); r <= min(cls, m_cap); ++r) {
        tb.row_first[r] = k;
      }
    }
  }
  if (tile != max(n_tiles, 1) - 1) return;
  // the last tile: a clause still open with a literal is finalized by the
  // end of the stream, in row clip(cls, 0, m_cap - 1); the rows past the
  // last clause's class start after the clauses a boundary finalized
  const int n_cl = tile_end.cnt;
  const int n_mid = n_cl - (tile_end.seg_inc > 0);
  if (t == 0) {
    if (tile_end.seg_inc > 0) {
      tb.cl_row[n_cl - 1] = min(max(tile_end.tog, 0), m_cap - 1);
    }
    if (n_cl > 0) tb.cl_end[n_cl - 1] = tile_end.inc;
    tb.meta[0] = tile_end.inc;
    tb.meta[1] = n_cl;
    tb.meta[2] = n_mid;
    tb.meta[3] = 0;
  }
  for (int r = max(tile_end.last_tog + 1, 0) + t; r <= m_cap; r += kDecodeThreads) {
    tb.row_first[r] = n_mid;
  }
}

// -- launch B: evaluate -----------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTileW = 8;  // batch words per block: lanes of a group
constexpr int kGroups = kThreads / kTileW;  // clauses walked at once
constexpr int kRun = 2 * kTileW;  // includes per run: two per lane
constexpr int kBankRow = 33;  // bank entries per word: 32 bits + pad
constexpr unsigned kNone = 2u;  // no include: bit 1 is never set otherwise

// include t's feature row as a byte offset, its complement in bit 0, or
// kNone past the clause's end
__device__ __forceinline__ unsigned include_at(const Tables& tb, int t,
                                               int end, unsigned row_bytes) {
  if (t >= end) return kNone;
  return (unsigned)__ldg(tb.inc_row + t) * row_bytes |
         ((unsigned)__ldg(tb.inc_mask + t) & 1u);
}

// AND into acc the feature words of the run whose entries lane sub of the
// group holds for t + sub (a) and t + 8 + sub (b)
__device__ __forceinline__ uint32_t and_run(uint32_t acc, unsigned a,
                                            unsigned b, bool live,
                                            const char* lane_feats) {
  uint32_t x[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const unsigned e =
        __shfl_sync(kFull, i < kTileW ? a : b, i % kTileW, kTileW);
    x[i] = live && e != kNone
               ? __ldg(reinterpret_cast<const uint32_t*>(lane_feats + (e & ~3u))) ^
                     (0u - (e & 1u))
               : kFull;
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) acc &= x[i];
  return acc;
}

__global__ void __launch_bounds__(kThreads)
evaluate_kernel(const int32_t* __restrict__ scratch, int n_active,
                const uint32_t* __restrict__ feats, int w_words, int m_cap,
                int32_t* __restrict__ out) {
  __shared__ int s_bank[kTileW * kBankRow];
  const Tables tb = tables_of(const_cast<int32_t*>(scratch), n_active, m_cap);
  const int w0 = blockIdx.x * kTileW;
  const int m = blockIdx.y;
  const int t = threadIdx.x;
  const int sub = t % kTileW, g = t / kTileW;
  const bool live = w0 + sub < w_words;
  const unsigned row_bytes = 4u * (unsigned)w_words;
  const char* lane_feats = reinterpret_cast<const char*>(feats + w0 + sub);
  int* bank = s_bank + sub * kBankRow;
  for (int i = t; i < kTileW * kBankRow; i += kThreads) s_bank[i] = 0;

  // the row's clauses: its own class, [row_first[m], row_first[m + 1]);
  // on the last row the class -1, [0, row_first[0]); the last clause when
  // the end of the stream finalized it into this row
  const int n_cl = __ldg(tb.meta + 1), n_mid = __ldg(tb.meta + 2);
  const int a0 = __ldg(tb.row_first + m);
  const int n_a = __ldg(tb.row_first + m + 1) - a0;
  const int n_b = m == m_cap - 1 ? __ldg(tb.row_first) : 0;
  const int n_c = n_cl > n_mid && __ldg(tb.cl_row + n_cl - 1) == m;
  const int nc = n_a + n_b + n_c;
  __syncthreads();  // the bank is zeroed

  auto clause = [&](int j, int& st, int& en, int& v) {
    st = 0, en = 0, v = 0;
    if (j >= nc) return;
    const int k = j < n_a ? a0 + j : j < n_a + n_b ? j - n_a : n_mid;
    st = __ldg(tb.cl_start + k), en = __ldg(tb.cl_end + k);
    v = __ldg(tb.cl_vote + k);
  };
  const int rounds = (nc + kGroups - 1) / kGroups;
  int j = g, st, en, v;
  clause(j, st, en, v);
  unsigned r0 = include_at(tb, st + sub, en, row_bytes);
  unsigned r1 = include_at(tb, st + kTileW + sub, en, row_bytes);
  for (int r = 0; r < rounds; ++r) {
    // the next clause's record and first run, loaded ahead
    const int jn = j + kGroups;
    int nst, nen, nv;
    clause(jn, nst, nen, nv);
    const unsigned n0 = include_at(tb, nst + sub, nen, row_bytes);
    const unsigned n1 = include_at(tb, nst + kTileW + sub, nen, row_bytes);
    uint32_t acc = en > st ? kFull : 0u;
    acc = and_run(acc, r0, r1, live, lane_feats);
    for (int d = kRun; __any_sync(kFull, st + d < en); d += kRun) {
      const unsigned a0r = include_at(tb, st + d + sub, en, row_bytes);
      const unsigned a1r = include_at(tb, st + d + kTileW + sub, en, row_bytes);
      acc = and_run(acc, a0r, a1r, live, lane_feats);
    }
    if (live) {
      for (uint32_t word = acc; word; word &= word - 1) {
        atomicAdd(bank + __ffs(word) - 1, v);
      }
    }
    j = jn, st = nst, en = nen, v = nv, r0 = n0, r1 = n1;
  }
  __syncthreads();
  // datapoint 32 w + b of the tile is bank entry (w, b)
  int32_t* dst = out + (size_t)m * 32 * w_words + 32 * (size_t)w0;
  const int n_out = 32 * min(kTileW, w_words - w0);
  for (int o = t; o < n_out; o += kThreads) {
    dst[o] = s_bank[(o >> 5) * kBankRow + (o & 31)];
  }
}

bool bad_sizes(int n_active, int f_cap, int m_cap, const int32_t* wmem,
               int n_weights) {
  return n_active < 0 || f_cap <= 0 || m_cap <= 0 || m_cap > 65535 ||
         (wmem && n_weights <= 0);
}

int decode(const int32_t* imem, int n_active, int f_cap, int m_cap,
           const int32_t* wmem, int n_weights, int32_t* scratch,
           cudaStream_t stream) {
  // the look-back words start at zero: no tile taken, none published
  const Tables tb = tables_of(scratch, n_active, m_cap);
  const cudaError_t zeroed = cudaMemsetAsync(
      tb.look, 0, 4 * (1 + (size_t)kLookWords * tiles_of(n_active)), stream);
  if (zeroed != cudaSuccess) return (int)zeroed;
  decode_kernel<<<max(tiles_of(n_active), 1), kDecodeThreads, kDecodeShared,
                  stream>>>(imem, n_active, f_cap, m_cap, wmem, n_weights,
                            scratch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the int32 words of scratch that a decode of n_active instructions needs
long long interp_stream_scratch_words(int n_active, int m_cap) {
  return (long long)scratch_words(n_active, m_cap);
}

// imem: int32[>= n_active]; wmem: int32[n_weights] or null (weight 1);
// scratch: int32[interp_stream_scratch_words(n_active, m_cap)], launch A's
// tables.
int interp_stream_decode(const int32_t* imem, int n_active, int f_cap,
                         int m_cap, const int32_t* wmem, int n_weights,
                         int32_t* scratch, void* stream) {
  if (bad_sizes(n_active, f_cap, m_cap, wmem, n_weights)) {
    return (int)cudaErrorInvalidValue;
  }
  return decode(imem, n_active, f_cap, m_cap, wmem, n_weights, scratch,
                (cudaStream_t)stream);
}

// both launches: decode into scratch, then evaluate into out, int32
// [m_cap][32 w_words] (every element written); feats: uint32
// [f_cap][w_words]
int interp_stream_launch(const int32_t* imem, int n_active,
                         const uint32_t* feats, int f_cap, int w_words,
                         const int32_t* wmem, int n_weights, int m_cap,
                         int32_t* scratch, int32_t* out, void* stream) {
  if (bad_sizes(n_active, f_cap, m_cap, wmem, n_weights) || w_words <= 0 ||
      (long long)f_cap * w_words >= (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = decode(imem, n_active, f_cap, m_cap, wmem, n_weights,
                         scratch, s);
  if (err != (int)cudaSuccess) return err;
  const dim3 grid((w_words + kTileW - 1) / kTileW, m_cap);
  evaluate_kernel<<<grid, kThreads, 0, s>>>(scratch, n_active, feats, w_words,
                                            m_cap, out);
  return (int)cudaGetLastError();
}

// which: 0 the decode, 1 the evaluation
int interp_stream_attributes(int which, int* regs, int* local_bytes,
                             int* shared_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (which == 0) {
    err = cudaFuncGetAttributes(&attr, decode_kernel);
  } else if (which == 1) {
    err = cudaFuncGetAttributes(&attr, evaluate_kernel);
  } else {
    return (int)cudaErrorInvalidValue;
  }
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
