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
// here it is mma.sync.m16n8k32 with int8 {0,1} operands and an s32
// accumulator, exact for any depth below 2^31.
//
// Three launches:
//
//   1  narrow_actions: one block per clause narrows its action row to
//      int8 (a != 0) in a scratch [NC][L2p] (L2p: L2 rounded up to 64,
//      the tail zero) and writes nonempty[c] = (sum_k a > 0);
//   2  narrow_literals: 64 x 64 tiles of L are transposed through shared
//      memory into a scratch (1 - L) as int8 [B][L2p], so that both
//      operands of the product hold the literal axis contiguous;
//   3  product: a block of 8 warps owns a 128 x 128 output tile and walks
//      the literal axis 64 bytes at a time through a 3-stage cp.async
//      ring in shared memory.  Rows are padded to 80 bytes, so fragment
//      loads (32-bit words of four consecutive literals) hit 32 distinct
//      banks.  Each warp runs 4 x 4 mma tiles (64 clauses x 32
//      datapoints); the epilogue stores (viol == 0) & nonempty.
//
// Narrowing first cuts what the product re-reads from L2 (every tile of a
// row or column of tiles reads the same operand panel) from ~1.6 GB of
// int32 to ~0.4 GB of int8 at the paper's width, for one extra pass over
// the inputs.  The ragged edges are masked, not padded: the copies of
// clauses and datapoints past the edge are zero-filled by cp.async and
// never stored; only the private scratch rows are rounded up to 64 bytes,
// with zeros (no violation).  No TMA or wgmma yet.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;       // clauses per block tile
constexpr int kBN = 128;       // datapoints per block tile
constexpr int kBK = 64;        // literals (int8 bytes) per pipeline stage
constexpr int kStages = 3;
constexpr int kThreads = 256;  // 8 warps: 2 along clauses x 4 along datapoints
constexpr int kRowBytes = kBK + 16;  // shared row: 64 bytes + 16 pad
constexpr int kRowWords = kRowBytes / 4;
constexpr int kTileBytes = kBM * kRowBytes;  // one operand tile (kBM == kBN)
constexpr int kSmemBytes = kStages * 2 * kTileBytes;
constexpr int kT = 64;  // narrow_literals tile: 64 literals x 64 datapoints

__global__ void __launch_bounds__(kThreads)
narrow_actions(const int32_t* __restrict__ actions, int l2, int l2p,
               int8_t* __restrict__ a8, int32_t* __restrict__ nonempty) {
  __shared__ int s_sum;
  const int m = blockIdx.x;
  const int32_t* row = actions + (size_t)m * l2;
  if (threadIdx.x == 0) s_sum = 0;
  __syncthreads();
  int sum = 0;
  for (int k = threadIdx.x; k < l2p; k += kThreads) {
    const int a = k < l2 ? row[k] : 0;
    sum += a;
    a8[(size_t)m * l2p + k] = a != 0;
  }
  sum = __reduce_add_sync(0xFFFFFFFFu, sum);
  if ((threadIdx.x & 31) == 0) atomicAdd(&s_sum, sum);
  __syncthreads();
  if (threadIdx.x == 0) nonempty[m] = s_sum > 0;
}

__global__ void __launch_bounds__(kThreads)
narrow_literals(const int32_t* __restrict__ lits, int l2, int nb, int l2p,
                int8_t* __restrict__ nlt) {
  __shared__ __align__(16) int8_t tile[kT * (kT + 16)];  // [datapoint][literal]
  const int n0 = blockIdx.x * kT;
  const int k0 = blockIdx.y * kT;
  const int nl = threadIdx.x % kT;
  const int n = n0 + nl;
#pragma unroll
  for (int i = 0; i < kT / (kThreads / kT); ++i) {
    const int kl = threadIdx.x / kT + (kThreads / kT) * i;
    const int k = k0 + kl;
    tile[nl * (kT + 16) + kl] =
        (k < l2 && n < nb) ? lits[(size_t)k * nb + n] == 0 : 0;
  }
  __syncthreads();
  const int row = threadIdx.x / 4, q = threadIdx.x % 4;  // 16 bytes each
  if (n0 + row < nb) {
    *reinterpret_cast<uint4*>(nlt + (size_t)(n0 + row) * l2p + k0 + 16 * q) =
        *reinterpret_cast<const uint4*>(tile + row * (kT + 16) + 16 * q);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
product(const int8_t* __restrict__ a8, const int8_t* __restrict__ nlt,
        const int32_t* __restrict__ nonempty, int nc, int nb, int l2p,
        int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma group and thread in group
  const int wm = (warp >> 2) * 64;        // warp tile origin in the block
  const int wn = (warp & 3) * 32;
  const int k_tiles = l2p / kBK;

  // stage s holds A at smem + 2 s kTileBytes and B right after it; each
  // thread copies two 16-byte pieces of each operand tile
  auto load = [&](int stage, int kt) {
    unsigned char* sa = smem + stage * 2 * kTileBytes;
    unsigned char* sb = sa + kTileBytes;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + kThreads * i;
      const int row = c >> 2, q = c & 3;
      const bool ma = m0 + row < nc, nbok = n0 + row < nb;
      cp_async16(sa + row * kRowBytes + 16 * q,
                 a8 + (size_t)(ma ? m0 + row : 0) * l2p + k0 + 16 * q, ma);
      cp_async16(sb + row * kRowBytes + 16 * q,
                 nlt + (size_t)(nbok ? n0 + row : 0) * l2p + k0 + 16 * q, nbok);
    }
  };

  int acc[4][4][4] = {};  // [16-clause tile][8-datapoint tile][fragment]
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait_prior();  // tile kt has landed for this thread
    __syncthreads();        // ... for every thread; stage kt-1 is free
    const int next = kt + kStages - 1;
    if (next < k_tiles) load(next % kStages, next);
    cp_async_commit();  // an empty group keeps the wait count uniform
    const uint32_t* sa =
        reinterpret_cast<const uint32_t*>(smem + (kt % kStages) * 2 * kTileBytes);
    const uint32_t* sb = sa + kTileBytes / 4;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (wm + 16 * i + g) * kRowWords + 8 * kk;
        af[i][0] = sa[r + t];
        af[i][1] = sa[r + 8 * kRowWords + t];
        af[i][2] = sa[r + 4 + t];
        af[i][3] = sa[r + 8 * kRowWords + 4 + t];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = (wn + 8 * j + g) * kRowWords + 8 * kk;
        bf[j][0] = sb[c + t];
        bf[j][1] = sb[c + 4 + t];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
      }
    }
  }

  const bool pairs = (nb & 1) == 0;  // 8-byte aligned column pairs
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= nc) continue;
      const bool ne = nonempty[m] != 0;
      int32_t* orow = out + (size_t)m * nb;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + 8 * j + 2 * t;
        const int v0 = ne && acc[i][j][2 * h] == 0;
        const int v1 = ne && acc[i][j][2 * h + 1] == 0;
        if (pairs && col + 1 < nb) {
          *reinterpret_cast<int2*>(orow + col) = make_int2(v0, v1);
        } else {
          if (col < nb) orow[col] = v0;
          if (col + 1 < nb) orow[col + 1] = v1;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// The literal axis of the scratch rows is rounded up to this many bytes.
int clause_matmul_k_step() { return kBK; }

// actions: int32[nc][l2]; lits: int32[l2][nb]; scratch a8: int8[nc][l2p],
// nlt: int8[nb][l2p], nonempty: int32[nc]; out: int32[nc][nb].  Launches
// narrow_actions, narrow_literals and product in that order.
int clause_matmul_launch(const int32_t* actions, const int32_t* lits, int nc,
                         int l2, int nb, int l2p, int8_t* a8, int8_t* nlt,
                         int32_t* nonempty, int32_t* out, void* stream) {
  if (nc <= 0 || l2 <= 0 || nb <= 0 || l2p < l2 || l2p % kBK ||
      (nc + kBM - 1) / kBM > 65535 || l2p / kT > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  narrow_actions<<<nc, kThreads, 0, s>>>(actions, l2, l2p, a8, nonempty);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  narrow_literals<<<dim3((nb + kT - 1) / kT, l2p / kT), kThreads, 0, s>>>(
      lits, l2, nb, l2p, nlt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(product, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nb + kBN - 1) / kBN, (nc + kBM - 1) / kBM);
  product<<<grid, kThreads, kSmemBytes, s>>>(a8, nlt, nonempty, nc, nb, l2p, out);
  return (int)cudaGetLastError();
}

const char* clause_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
