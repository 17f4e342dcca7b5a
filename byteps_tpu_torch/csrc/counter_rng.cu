// Dithering levels and randomk indices for Hopper (sm_90a): the two
// kernels of the counter-based random stream.
//
// Replaces the Pallas TPU kernels of byteps_tpu/ops/compression/
// pallas_kernels.py: _dither_linear_kernel and _dither_natural_kernel
// (dithering_levels), and _randomk_hash_kernel (randomk_indices).
//
// The stream. Element i draws from the counter i * 0x9E3779B1 + base in
// uint32 arithmetic, through the murmur3 finalizer; a uniform is the top
// 24 bits over 2^24 (exact in f32), an index is the whole hash modulo the
// tensor size. The C++ server re-draws randomk's indices from the same
// stream (native/ps.cc), so both must stay bit-identical to the numpy
// golden (ops/compression/rng.py). The TPU kernel leaves the modulo to
// XLA because Mosaic lacks a uint32 remainder; here it is one instruction
// sequence inside the kernel.
//
// Bit-exactness. The server sums the levels, so the levels must equal the
// plain PyTorch twin's (ops/compression/kernels.py), which runs every
// operation as its own rounded f32 step. The quantizer therefore uses the
// _rn intrinsics for its own arithmetic: nvcc would otherwise contract
// (|x| / norm) * s - floor into an FMA and change frac. log2f and exp2f
// are the same library calls PyTorch's CUDA kernels make, built with the
// same default flags; exp2f of an integer is exact.
//
// Bound. Dithering reads 4n bytes and writes n; randomk writes 4k and
// reads nothing. Both are bound by bytes, against the card's 3.35 TB/s;
// at the training path's sizes (n ~ 1M, k ~ 10K) the launch itself is
// most of the time. One thread per element, neighbouring threads on
// neighbouring addresses, so every load and store is coalesced. norm and
// base are read from device memory, so the caller never waits on them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kGolden = 0x9E3779B1u;

__device__ __forceinline__ uint32_t mm3_finalize(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t counter_hash(long long i, uint32_t base) {
  return mm3_finalize((uint32_t)i * kGolden + base);
}

// partition: 0 = linear (levels 0..s), 1 = natural (level j+1 = 2^-j)
template <int kNatural>
__global__ void dither_kernel(const float* __restrict__ x,
                              const float* __restrict__ norm_p,
                              const long long* __restrict__ base_p, float s,
                              int8_t* __restrict__ out, long long n) {
  const float norm = *norm_p;
  const uint32_t base = (uint32_t)(*base_p);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float u =
        __fmul_rn((float)(counter_hash(i, base) >> 8), 5.9604644775390625e-8f);
    const float xv = x[i];
    const float scaled = __fdiv_rn(fabsf(xv), norm);
    float level;
    if (kNatural == 0) {
      const float pos = __fmul_rn(scaled, s);
      const float fl = floorf(pos);
      const float frac = __fsub_rn(pos, fl);
      level = fminf(__fadd_rn(fl, u < frac ? 1.0f : 0.0f), s);
    } else {
      const float safe = fmaxf(scaled, 1e-30f);
      const float j = fminf(fmaxf(floorf(-log2f(safe)), 0.0f), 30.0f);
      const float low = exp2f(__fsub_rn(-j, 1.0f));
      const float high = exp2f(-j);
      const float frac =
          __fdiv_rn(__fsub_rn(scaled, low), __fsub_rn(high, low));
      const float e = u < frac ? j : __fadd_rn(j, 1.0f);
      // 2^-31: below the finest level, a magnitude quantizes to zero
      level = scaled < 4.656612873077393e-10f ? 0.0f : __fadd_rn(e, 1.0f);
      level = fminf(fmaxf(level, 0.0f), 126.0f);
    }
    const float sign = xv > 0.0f ? 1.0f : (xv < 0.0f ? -1.0f : 0.0f);
    out[i] = (int8_t)(int)(sign * level);
  }
}

__global__ void randomk_kernel(const long long* __restrict__ base_p,
                               uint32_t size, int32_t* __restrict__ out,
                               long long k) {
  const uint32_t base = (uint32_t)(*base_p);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < k; i += stride) {
    out[i] = (int32_t)(counter_hash(i, base) % size);
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

int bps_dithering_levels(const void* x, const void* norm, const void* base,
                         float s, int natural, void* out, long long n,
                         void* stream) {
  if (n > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (natural) {
      dither_kernel<1><<<grid_for(n), kThreads, 0, st>>>(
          (const float*)x, (const float*)norm, (const long long*)base, s,
          (int8_t*)out, n);
    } else {
      dither_kernel<0><<<grid_for(n), kThreads, 0, st>>>(
          (const float*)x, (const float*)norm, (const long long*)base, s,
          (int8_t*)out, n);
    }
  }
  return (int)cudaGetLastError();
}

int bps_randomk_indices(const void* base, unsigned int size, void* out,
                        long long k, void* stream) {
  if (k > 0) {
    randomk_kernel<<<grid_for(k), kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)base, (uint32_t)size, (int32_t*)out, k);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
