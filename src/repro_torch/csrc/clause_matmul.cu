// Clause evaluation of a Tsetlin Machine as an int8 tensor-core product on
// Hopper.
//
// Replaces repro/kernels/clause_matmul/kernel.py:_clause_matmul_kernel,
// the Pallas TPU kernel driven by clause_matmul.  Same function: a clause
// fires on a datapoint iff none of its included literals is 0, so
//     viol[c, b]  = sum_k A[c, k] * (1 - L[k, b])
//     fired[c, b] = (viol[c, b] == 0) & (sum_k A[c, k] > 0)
// for {0,1} actions A[NC, L2] and literals L[L2, B], out int32[NC, B].
//
// What bounds it on an H100: bytes.  At the paper's MNIST width the int32
// operands and the int32 output are 129 MB (39 us at 3.35 TB/s) against
// 51.4 G multiply-adds (26 us at the int8 tensor-core rate).  The TPU
// kernel runs the product in bf16 with an fp32 accumulator on the MXU;
// here it is wgmma.m64n256k32 with int8 {0,1} operands and an s32
// accumulator, exact for any depth below 2^31.  Inside the product the
// limit is L2: every 128 x 256 tile reads its A and B panels out of L2
// (218 MB at that width with B shared by a cluster of two) while 65.5 MB
// of output pass through it to memory.
//
// Two launches:
//
//   1  narrow: the int32 -> int8 pass, which TMA cannot do (it copies
//      bytes).  Its blocks take one of two roles.  Action blocks give one
//      warp to each clause, which narrows its row to int8 (a != 0) in a
//      scratch [NC][L2p] and writes nonempty[c] = (sum_k a > 0).  Literal
//      blocks read 64 literals x 128 datapoints of L in 16-byte streaming
//      loads (they need not stay in L2), turn each 4 x 4 block into four
//      words of (1 - L) bytes, and transpose them through shared memory
//      into a scratch int8 [B][L2p].  L2p is L2 rounded up to 64 with a
//      zero tail, so both scratch operands hold the literal axis
//      contiguous (K-major, the only layout int8 wgmma takes) with rows
//      on 16-byte strides, as TMA needs.
//   2  product: a persistent, warp-specialised kernel, one block per SM
//      walking 128 x 256 output tiles, blocks paired in clusters of two
//      that share each tile's datapoints.  In warpgroup 0, one thread
//      issues cp.async.bulk.tensor (TMA) loads of 128-byte-wide K slices
//      into a 4-stage ring in shared memory, 128-byte swizzled, each stage
//      guarded by a full/empty mbarrier pair: its own A tile, and half of
//      the B tile multicast into both blocks of the cluster.  Warpgroups
//      1 and 2 are the consumers: each owns 64 clauses x 256 datapoints
//      of the tile, runs four wgmma per stage from shared-memory
//      descriptors with one wgmma group in flight, and keeps its 128 s32
//      accumulators in registers (setmaxnreg moves registers from
//      warpgroup 0 to them).  At the end of a tile they write (acc == 0)
//      & nonempty as bytes into shared memory and go on to the next tile;
//      warps 1-3 of warpgroup 0 widen the bytes to int32 and store them,
//      a warp per row in 1 KB lines, under the next tile's MMAs.  The
//      product is launched early (programmatic dependent launch) and
//      waits for the narrowing pass only before its first reads.
//
// The ragged edges are TMA's: clauses, datapoints and literals past the
// edge of a box are zero-filled in shared memory (a zero literal of
// (1 - L) or action adds no violation) and never stored.  Only the
// private scratch rows are rounded up, to 64 bytes, with zeros.  The
// tensor maps are encoded on the host at every call (the scratch pointers
// change) through cuTensorMapEncodeTiled, reached with
// cudaGetDriverEntryPoint(ByVersion), so the library needs no -lcuda.
//
// A wait on an mbarrier that does not complete within ~2^32 cycles traps
// (the launch fails) rather than hanging the card.

#include <cstdint>
#include <cstdio>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;            // clauses per output tile
constexpr int kBN = 256;            // datapoints per output tile
constexpr int kBK = 128;            // literal bytes per stage: one swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 384;       // producer + two consumer warpgroups
constexpr int kATileBytes = kBM * kBK;
constexpr int kBTileBytes = kBN * kBK;
constexpr int kStageBytes = kATileBytes + kBTileBytes;
constexpr int kFiredBytes = kBM * kBN;  // the output tile, one byte each
constexpr int kSmemBytes =
    kStages * kStageBytes + kFiredBytes + 1024;  // + alignment slack
constexpr int kConsumerWarps = 8;   // each arrives once on an empty barrier
constexpr int kCluster = 2;         // product CTAs sharing one B tile
constexpr int kStoreWarps = 3;      // producer warpgroup warps 1-3
constexpr int kLitK = 64;           // narrow: literals per tile (and L2p's grain)
constexpr int kLitN = 128;          // narrow: datapoints per tile
constexpr int kPitch = kLitK / 4 + 1;  // tile words per datapoint, + 1 pad
constexpr int kNarrowThreads = 256;
constexpr int kRowsPerBlock = kNarrowThreads / 32;  // narrow: clause rows
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kEncodeError = 100000;  // + CUresult of a refused tensor map

__global__ void __launch_bounds__(kNarrowThreads)
narrow(const int32_t* __restrict__ actions, const int32_t* __restrict__ lits,
       int nc, int l2, int nb, int l2p, int lit_tiles_x, int act_blocks,
       int8_t* __restrict__ a8, int8_t* __restrict__ nlt,
       int32_t* __restrict__ nonempty) {
  // the product may start its prologue once every block here has begun
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // literal tile [datapoint][literal quad]: words of four int8 literals
  __shared__ uint32_t tile[kLitN * kPitch];
  const int lit = (int)blockIdx.x - act_blocks;
  if (lit >= 0) {  // literal role: one 64 x 128 tile
    const int n0 = (lit % lit_tiles_x) * kLitN;
    const int k0 = (lit / lit_tiles_x) * kLitK;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // a lane reads four datapoints of four literal rows: eight lanes
    // cover a 128-byte line of a row, and the words land in 32 banks
    const int nq = (warp & 3) * 8 + (lane & 7);
    const int n = n0 + 4 * nq;
    const bool vec = (nb & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(lits) & 15) == 0 && n + 3 < nb;
    int v[2][4][4];  // [half][literal][datapoint]; past the edge L = 1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kq = (warp >> 2) * 8 + 4 * h + (lane >> 3);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + 4 * kq + i;
        const int32_t* src = lits + (size_t)k * nb + n;
        if (k < l2 && vec) {
          const int4 x = __ldcs(reinterpret_cast<const int4*>(src));
          v[h][i][0] = x.x, v[h][i][1] = x.y, v[h][i][2] = x.z, v[h][i][3] = x.w;
        } else {
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            v[h][i][d] = k < l2 && n + d < nb ? src[d] : 1;
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kq = (warp >> 2) * 8 + 4 * h + (lane >> 3);
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) word |= (uint32_t)(v[h][i][d] == 0) << (8 * i);
        tile[(4 * nq + d) * kPitch + kq] = word;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kLitN * 4; i += kNarrowThreads) {
      const int r = i >> 2, q = i & 3;  // 16 literals of datapoint n0 + r
      if (n0 + r < nb) {
        const uint32_t* t = tile + r * kPitch + 4 * q;
        *reinterpret_cast<uint4*>(nlt + (size_t)(n0 + r) * l2p + k0 + 16 * q) =
            make_uint4(t[0], t[1], t[2], t[3]);
      }
    }
    return;
  }
  // action role: one warp per clause row, four literals per lane and step
  const int lane = threadIdx.x & 31;
  const int m = (int)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (m >= nc) return;
  const int32_t* row = actions + (size_t)m * l2;
  uint32_t* dst = reinterpret_cast<uint32_t*>(a8 + (size_t)m * l2p);
  const bool vec =
      (l2 & 3) == 0 && (reinterpret_cast<uintptr_t>(actions) & 15) == 0;
  int sum = 0;
#pragma unroll 4
  for (int q = lane; q < l2p / 4; q += 32) {
    int a[4];
    if (vec && 4 * q < l2) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(row) + q);
      a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = 4 * q + j < l2 ? row[4 * q + j] : 0;
    }
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sum += a[j];
      word |= (uint32_t)(a[j] != 0) << (8 * j);
    }
    dst[q] = word;
  }
  sum = __reduce_add_sync(kFull, sum);
  if (lane == 0) nonempty[m] = sum > 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes) : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = -1;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 < 0) t0 = now;
    else if (now - t0 > (1LL << 32)) __trap();  // a phase that never comes
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The same box written at the same offset of every CTA of the cluster in
// `ctas` (a bit mask of ranks), signalling each one's barrier at `bar`.
__device__ __forceinline__ void tma_load_2d_multicast(
    uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
    uint16_t ctas) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "h"(ctas)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Arrive on the barrier at the same offset in the CTA of rank `rank`.  The
// default CTA-scope release: a cluster-scope one would first wait for
// this thread's global stores of the previous tile.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
      ::"r"(bar), "r"(rank) : "memory");
}

// Wait until the grid launched before this one on the stream (the
// narrowing pass) has finished and its writes are visible.  This grid is
// launched early (programmatic dependent launch), so its prologue runs
// under the other's tail.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Every thread of every CTA of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte rows,
// 128-byte swizzle (layout 1 at bits 62-63), 8-row groups 1024 bytes
// apart (stride byte offset, bits 32-45); the leading byte offset is
// unused for swizzled K-major tiles (1 by convention).  Addresses are in
// 16-byte units, so the k-th 32-byte step inside a row adds 2 k.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin the accumulators in program order against the asynchronous wgmma:
// the compiler must not move a read of them across a wait.
__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 256] (+)= A[64 x 32] * B[256 x 32]^T, s8 x s8 -> s32; d is
// overwritten when scale_d is 0.
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// A cluster of kCluster CTAs on neighbouring SMs takes kCluster output
// tiles that share their datapoints (consecutive clause tiles, one
// column of tiles).  Each CTA loads its own A tile and 1/kCluster of the
// shared B tile, multicast into every CTA of the cluster, so the B panel
// crosses from L2 once per cluster instead of once per tile.  A stage is
// then written by every CTA's producer: its empty barrier counts the
// consumer warps of the whole cluster, each of which arrives on the
// barrier of every CTA.
//
// The output leaves through a fired-byte tile in shared memory: the
// consumers write (acc == 0) & nonempty as one byte per entry and go on
// to the next tile's MMAs, while the three spare warps of the producer
// warpgroup widen the bytes to int32 and store them.  Stored by the
// consumers themselves, every CTA's 128 KB of output would leave at the
// same moment and the tensor cores would idle behind the burst.
__global__ void __launch_bounds__(kThreads, 1)
product(const __grid_constant__ CUtensorMap map_a,
        const __grid_constant__ CUtensorMap map_b,
        const int32_t* __restrict__ nonempty, int nc, int nb, int k_tiles,
        int m_tiles, int n_tiles, int32_t* __restrict__ out) {
  constexpr int kSliceRows = kBN / kCluster;  // B rows this CTA loads
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  __shared__ __align__(8) uint64_t out_full, out_empty;  // the fired tile
  // 128-byte swizzle repeats every 1024 bytes: tiles start on that grain
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t tiles = (raw + 1023) & ~1023u;  // stage s: A then B
  // fired[128][256] bytes after the ring; 8-byte chunk j of row r sits at
  // chunk j ^ (r % 8), so that neither side's accesses collide in banks
  uint8_t* fired = smem_raw + (tiles - raw) + kStages * kStageBytes;
  const uint32_t rank = cluster_rank();
  const int cluster = blockIdx.x / kCluster, n_clusters = gridDim.x / kCluster;
  const int m_groups = (m_tiles + kCluster - 1) / kCluster;
  const int n_work = m_groups * n_tiles;  // units of work of a cluster

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(&full_bar[s]), 1);
      mbar_init(smem_addr(&empty_bar[s]), kConsumerWarps * kCluster);
    }
    mbar_init(smem_addr(&out_full), kConsumerWarps);
    mbar_init(smem_addr(&out_empty), kStoreWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every CTA's barriers exist before any peer uses them

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  if (wg == 0) {  // producer warpgroup: warp 0 loads, warps 1-3 store
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {  // one thread issues every load
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_a)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_b)) : "memory");
      grid_dependency_wait();  // the narrowed operands are written
      int it = 0;
      for (int u = cluster; u < n_work; u += n_clusters) {
        const int m0 = ((u % m_groups) * kCluster + rank) * kBM;
        const int n0 = (u / m_groups) * kBN;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % kStages;
          const uint32_t phase = (it / kStages) & 1;
          // free in every CTA of the cluster: the peers write it too
          mbar_wait(smem_addr(&empty_bar[s]), phase ^ 1);
          const uint32_t full = smem_addr(&full_bar[s]);
          const uint32_t a = tiles + s * kStageBytes;
          // whole boxes, zero fill included; the peers' slices of B
          // arrive on this barrier too
          mbar_expect_tx(full, kStageBytes);
          tma_load_2d(a, &map_a, full, kt * kBK, m0);
          tma_load_2d_multicast(a + kATileBytes + rank * kSliceRows * kBK,
                                &map_b, full, kt * kBK, n0 + rank * kSliceRows,
                                (uint16_t)((1u << kCluster) - 1));
        }
      }
      // stay until every consumer of the cluster has released every stage:
      // their last arrivals land on this CTA's barriers
      for (int i = 0; i < kStages; ++i, ++it) {
        mbar_wait(smem_addr(&empty_bar[it % kStages]), ((it / kStages) & 1) ^ 1);
      }
    } else if (warp > 0) {  // store warps: lane j widens 8-column chunk j
      const bool vec = (nb & 3) == 0;  // 16-byte aligned rows
      int tile = 0;
      for (int u = cluster; u < n_work; u += n_clusters, ++tile) {
        const int m0 = ((u % m_groups) * kCluster + rank) * kBM;
        const int n0 = (u / m_groups) * kBN;
        const int col = n0 + 8 * lane;
        mbar_wait(smem_addr(&out_full), tile & 1);
        for (int r = warp - 1; r < kBM && m0 + r < nc; r += kStoreWarps) {
          const uint2 f = *reinterpret_cast<const uint2*>(
              fired + r * kBN + 8 * (lane ^ (r & 7)));
          int v[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[i] = (f.x >> (8 * i)) & 0xFF;
            v[4 + i] = (f.y >> (8 * i)) & 0xFF;
          }
          int32_t* dst = out + (size_t)(m0 + r) * nb + col;
          if (vec && col + 7 < nb) {
            __stcs(reinterpret_cast<int4*>(dst), make_int4(v[0], v[1], v[2], v[3]));
            __stcs(reinterpret_cast<int4*>(dst) + 1, make_int4(v[4], v[5], v[6], v[7]));
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              if (col + i < nb) dst[i] = v[i];
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_addr(&out_empty));
      }
    }
  } else {  // consumer warpgroups 1 and 2: clauses 64 (wg - 1) + [0, 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const uint32_t a_off = (wg - 1) * 64 * kBK;
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    grid_dependency_wait();  // nonempty is written
    // lane r < kCluster releases a stage in the CTA of rank r
    auto release = [&](int s) {
      if (lane < kCluster) mbar_arrive_cluster(smem_addr(&empty_bar[s]), lane);
    };
    // accumulator layout of m64nNk32: warp w holds rows 16 w + lane / 4
    // (+ 8 for the odd pair), columns 8 j + 2 (lane % 4) + {0, 1}
    const int row = (wg - 1) * 64 + 16 * warp + (lane >> 2);  // in the tile
    int it = 0, tile = 0;
    for (int u = cluster; u < n_work; u += n_clusters, ++tile) {
      const int m0 = ((u % m_groups) * kCluster + rank) * kBM;
      // the nonempty flags, loaded while the tile's MMAs run
      bool ne[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + row + 8 * h;
        ne[h] = m < nc && nonempty[m] != 0;
      }
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(smem_addr(&full_bar[s]), (it / kStages) & 1);
        const uint32_t a = tiles + s * kStageBytes;
        const uint64_t da = smem_desc(a + a_off);
        const uint64_t db = smem_desc(a + kATileBytes);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) {
          wgmma_s8(acc, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
        }
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();  // the previous stage's group is done: free it
        fence_acc(acc);
        if (kt > 0) release((it + kStages - 1) % kStages);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      release((it + kStages - 1) % kStages);
      // the store warps are done with the previous tile's bytes
      mbar_wait(smem_addr(&out_empty), (tile & 1) ^ 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        uint8_t* frow = fired + r * kBN + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int v0 = ne[h] && acc[4 * j + 2 * h] == 0;
          const int v1 = ne[h] && acc[4 * j + 2 * h + 1] == 0;
          *reinterpret_cast<uint16_t*>(frow + 8 * (j ^ (r & 7))) =
              (uint16_t)(v0 | v1 << 8);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&out_full));
    }
  }
}

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A uint8 matrix [rows][cols] (cols contiguous, a multiple of 16) read in
// boxes of box_rows x kBK bytes, 128-byte swizzled, zero outside.
int encode_operand(CUtensorMap* map, const void* base, int rows, int cols,
                   int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// Clusters of kCluster product CTAs that fit on the card at once (0 on
// error), asked once per device; the shared-memory limit is raised then.
int max_clusters(cudaError_t* err) {
  static int cached[64] = {};
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess || dev >= 64) return 0;
  if (cached[dev] == 0) {
    *err = cudaFuncSetAttribute(
        product, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (*err != cudaSuccess) return 0;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmemBytes;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    *err = cudaOccupancyMaxActiveClusters(&cached[dev], product, &cfg);
    if (*err != cudaSuccess) return 0;
  }
  return cached[dev];
}

// A persistent grid: as many clusters as fit, or as there is work.
cudaError_t launch_product(const CUtensorMap& map_a, const CUtensorMap& map_b,
                           const int32_t* nonempty, int nc, int nb, int l2p,
                           int32_t* out, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  const int fit = max_clusters(&err);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  const int m_tiles = (nc + kBM - 1) / kBM, n_tiles = (nb + kBN - 1) / kBN;
  const long long work =
      (long long)((m_tiles + kCluster - 1) / kCluster) * n_tiles;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3((unsigned)(kCluster * (work < fit ? work : fit)));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, product, map_a, map_b, nonempty, nc, nb,
                            (l2p + kBK - 1) / kBK, m_tiles, n_tiles, out);
}

}  // namespace

extern "C" {

// The literal axis of the scratch rows is rounded up to this many bytes.
int clause_matmul_k_step() { return kLitK; }

// actions: int32[nc][l2]; lits: int32[l2][nb]; scratch a8: int8[nc][l2p],
// nlt: int8[nb][l2p], nonempty: int32[nc]; out: int32[nc][nb].  Launches
// narrow, then product.
int clause_matmul_launch(const int32_t* actions, const int32_t* lits, int nc,
                         int l2, int nb, int l2p, int8_t* a8, int8_t* nlt,
                         int32_t* nonempty, int32_t* out, void* stream) {
  // the action blocks first: their rows are latency-bound walks that
  // should overlap the bandwidth-bound literal tiles, not trail them
  const long long tiles_x = (nb + kLitN - 1) / kLitN;
  const long long act_blocks = (nc + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long blocks = act_blocks + tiles_x * (l2p / kLitK);
  if (nc <= 0 || l2 <= 0 || nb <= 0 || l2p < l2 || l2p % kLitK ||
      blocks > 0x7FFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  narrow<<<(unsigned)blocks, kNarrowThreads, 0, s>>>(
      actions, lits, nc, l2, nb, l2p, (int)tiles_x, (int)act_blocks, a8, nlt,
      nonempty);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_a, map_b;
  int rc = encode_operand(&map_a, a8, nc, l2p, kBM);
  if (rc) return rc;
  rc = encode_operand(&map_b, nlt, nb, l2p, kBN / kCluster);
  if (rc) return rc;
  return (int)launch_product(map_a, map_b, nonempty, nc, nb, l2p, out, s);
}

// Registers per thread, local (spill) bytes per thread and static shared
// bytes of kernel `which` (0 narrow, 1 product), from cudaFuncGetAttributes.
int clause_matmul_attributes(int which, int* regs, int* local_bytes,
                             int* shared_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, which ? (const void*)product : (const void*)narrow);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  return 0;
}

const char* clause_matmul_error_string(int err) {
  static char text[96];
  if (err >= kEncodeError) {
    snprintf(text, sizeof text,
             "cuTensorMapEncodeTiled refused a tensor map (CUresult %d)",
             err - kEncodeError);
    return text;
  }
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
