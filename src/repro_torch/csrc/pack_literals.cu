// Literal packing of a feature block on Hopper: 32 datapoints per word.
//
// Replaces no Pallas kernel: the reference's pack_literals
// (repro/core/tm.py:159) is jnp code that XLA fuses into one pass.  The
// port's plain twin (repro_torch/core/tm.py:160) is eager PyTorch: a bool
// cast, a stack with the complement, an int64 cast, a transposed copy,
// shifts and an int64 sum, some ten device operations over an int64
// tensor 16 times the input's size.  This is the same function in one
// launch.  It reads x, uint8 [B][F] row-major with B % 32 == 0, and writes
// uint32 [2F][B / 32]:
//     bit b of out[2k][w] = (x[32w + b][k] != 0)
//     out[2k + 1][w]      = ~out[2k][w]
//
// What bounds it on an H100: bytes.  F bytes read and F / 4 written per
// row (784 and 196 at MNIST's width); a ballot and a few integer
// instructions per feature byte and 32 rows.  Design:
//   - a block takes 32 batch words (1,024 rows) by 32 features, eight
//     warps; consecutive blocks take consecutive feature chunks of the
//     same rows, so a row's bytes are read by blocks in flight together;
//   - a warp takes one word at a time, lane b row 32w + b: 32 bytes of
//     the row as two 16-byte loads when every row is 16-byte aligned
//     (F % 16 == 0 and x aligned), byte by byte otherwise.  All four of a
//     warp's words are loaded before the first ballot;
//   - feature byte j of the 32 lanes becomes its word with one
//     __ballot_sync; lane j keeps feature j's word;
//   - the block transposes its 32 x 32 words through shared memory, so
//     that each output row 2k / 2k + 1 is stored as 32 consecutive words
//     (128 bytes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 32;     // batch words per block (1,024 rows)
constexpr int kFeatures = 32;  // features per block
constexpr int kWarps = 8;
constexpr int kWordsPerWarp = kWords / kWarps;
constexpr unsigned kFull = 0xFFFFFFFFu;

// The first nf (<= 32) feature bytes of one row as eight little-endian
// words; bytes past nf read as 0 and are not loaded.
template <bool kVec16>
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ row,
                                         int nf, uint32_t (&v)[8]) {
  if (kVec16) {  // nf is 16 or 32: F % 16 == 0
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(row));
    const uint4 b = nf > 16 ? __ldg(reinterpret_cast<const uint4*>(row + 16))
                            : make_uint4(0u, 0u, 0u, 0u);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0u;
#pragma unroll
    for (int j = 0; j < kFeatures; ++j) {
      if (j < nf) v[j >> 2] |= (uint32_t)__ldg(row + j) << (8 * (j & 3));
    }
  }
}

template <bool kVec16>
__global__ void __launch_bounds__(kWarps * 32)
pack_literals_kernel(const uint8_t* __restrict__ x, int f, int w_words,
                     uint32_t* __restrict__ out) {
  __shared__ uint32_t tile[kFeatures][kWords + 1];  // [feature][word]
  const int f0 = blockIdx.x * kFeatures, w0 = blockIdx.y * kWords;
  const int nf = min(kFeatures, f - f0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  uint32_t v[kWordsPerWarp][8];
#pragma unroll
  for (int i = 0; i < kWordsPerWarp; ++i) {
    const int w = w0 + warp + kWarps * i;  // warp-uniform
    if (w < w_words) {
      load_row<kVec16>(x + ((size_t)w * 32 + lane) * f + f0, nf, v[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[i][j] = 0u;
    }
  }
#pragma unroll
  for (int i = 0; i < kWordsPerWarp; ++i) {
    uint32_t mine = 0u;  // lane j: the word of feature f0 + j
#pragma unroll
    for (int j = 0; j < kFeatures; ++j) {
      const uint32_t bits =
          __ballot_sync(kFull, (v[i][j >> 2] >> (8 * (j & 3))) & 0xFFu);
      if (lane == j) mine = bits;
    }
    tile[lane][warp + kWarps * i] = mine;
  }
  __syncthreads();

  const int w = w0 + lane;
  if (w < w_words) {
    for (int k = warp; k < nf; k += kWarps) {
      const uint32_t word = tile[k][lane];
      const size_t at = (size_t)2 * (f0 + k) * w_words + w;
      out[at] = word;
      out[at + w_words] = ~word;
    }
  }
}

}  // namespace

extern "C" {

// x: uint8 [b][f] row-major, b % 32 == 0; out: uint32 [2f][b / 32].
int pack_literals_launch(const uint8_t* x, int b, int f, uint32_t* out,
                         void* stream) {
  const int w_words = b / 32;
  if (b <= 0 || b % 32 || f <= 0 ||
      (w_words + kWords - 1) / kWords > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((f + kFeatures - 1) / kFeatures,
                  (w_words + kWords - 1) / kWords);
  cudaStream_t s = (cudaStream_t)stream;
  if (f % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    pack_literals_kernel<true><<<grid, kWarps * 32, 0, s>>>(x, f, w_words, out);
  } else {
    pack_literals_kernel<false><<<grid, kWarps * 32, 0, s>>>(x, f, w_words, out);
  }
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill) bytes per thread and static shared
// bytes of kernel `which` (0 the 16-byte loads, 1 the byte loads).
int pack_literals_attributes(int which, int* regs, int* local_bytes,
                             int* shared_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, which ? (const void*)pack_literals_kernel<false>
                   : (const void*)pack_literals_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  return 0;
}

const char* pack_literals_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
