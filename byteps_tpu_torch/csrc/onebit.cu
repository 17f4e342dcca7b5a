// Onebit pack and unpack for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of byteps_tpu/ops/compression/
// pallas_kernels.py: _onebit_pack_kernel (onebit_pack) and
// _onebit_unpack_kernel (onebit_unpack).
//
// Layout. The TPU kernel folds 32 sublane rows into one word, because
// Mosaic cannot reshape the 128-wide lane dimension, and that layout is
// not the wire format. Here the kernel writes the portable layout of
// OnebitCodec's plain path (codecs.py:93-96) directly: word w, bit j holds
// the sign of element 32w + j, and elements at index n or beyond count as
// 0, which gives bit 1. A warp reads 32 consecutive floats and
// __ballot_sync(x >= 0) is the word, so the payload is already what the
// parameter server reads.
//
// Bound. Both kernels move bytes and do almost no arithmetic: pack reads
// 4n bytes and writes n/8, unpack reads n/8 and writes 4n, against the
// card's 3.35 TB/s. Each thread touches one element, neighbouring threads
// neighbouring addresses, so every load and store is coalesced; a
// grid-stride loop over whole warps keeps the ballot's participants
// uniform.
//
// Words travel as int32 on the Python side (a bit-identical view of
// uint32: torch has little uint32 support).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void onebit_pack_kernel(const float* __restrict__ x,
                                   uint32_t* __restrict__ words,
                                   long long n, long long n_words) {
  const long long total = n_words * 32;  // whole warps: ballot is uniform
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const float v = i < n ? x[i] : 0.0f;
    const unsigned word = __ballot_sync(0xffffffffu, v >= 0.0f);
    if ((threadIdx.x & 31) == 0) words[i >> 5] = word;
  }
}

// rows of words [rows, n_words] with one scale per row -> [rows, n];
// blockIdx.y is the row
__global__ void onebit_unpack_kernel(const uint32_t* __restrict__ words,
                                     const float* __restrict__ scale,
                                     float* __restrict__ out, long long n,
                                     long long n_words) {
  const uint32_t* w_row = words + blockIdx.y * n_words;
  float* o_row = out + blockIdx.y * n;
  const float s = scale[blockIdx.y];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    o_row[i] = ((w_row[i >> 5] >> (i & 31)) & 1u) ? s : -s;
  }
}

int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  // enough blocks to fill 132 SMs many times over; the loop covers the rest
  const long long cap = 132LL * 32;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" {

const char* bps_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int bps_onebit_pack(const void* x, void* words, long long n,
                    long long n_words, void* stream) {
  if (n_words > 0) {
    onebit_pack_kernel<<<grid_for(n_words * 32), kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const float*)x, (uint32_t*)words, n, n_words);
  }
  return (int)cudaGetLastError();
}

int bps_onebit_unpack(const void* words, const void* scale, void* out,
                      long long n, long long n_words, long long rows,
                      void* stream) {
  if (n > 0 && rows > 0) {
    dim3 grid(grid_for(n), (unsigned)rows);
    onebit_unpack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, (const float*)scale, (float*)out, n,
        n_words);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
