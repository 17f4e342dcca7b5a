// Dithering levels and randomk indices for Hopper (sm_90a): the two
// kernels of the counter-based random stream, each run as one launch over
// a whole round of partitions; and beside them the dequantization of a
// dithering round (dither_apply_kernel, below).
//
// Replaces the Pallas TPU kernels of byteps_tpu/ops/compression/
// pallas_kernels.py: _dither_linear_kernel and _dither_natural_kernel
// (dithering_levels), and _randomk_hash_kernel (randomk_indices).
// dither_apply_kernel replaces no TPU kernel but the XLA fusion of the
// JAX DeviceCompressor's dithering decompress and error-feedback
// residual, whose rounding it reproduces: XLA folds |lv| / s into
// |lv| * (1/s) and contracts the residual x - dec * norm into one FMA.
// It reads 1 byte of levels and (residual) reads and writes 4 bytes of
// f32 per element, bound by bytes; the _rn intrinsics keep nvcc from
// rounding differently.
//
// The stream. Element i of a partition draws from the counter
// i * 0x9E3779B1 + base in uint32 arithmetic, through the murmur3
// finalizer; a uniform is the top 24 bits over 2^24 (exact in f32), an
// index is the whole hash modulo the partition's size. The C++ server
// re-draws randomk's indices from the same stream (native/ps.cc), so both
// must stay bit-identical to the numpy golden (ops/compression/rng.py).
// The TPU kernel leaves the modulo to XLA because Mosaic lacks a uint32
// remainder; here it is one instruction sequence inside the kernel.
//
// Bit-exactness. The server sums the levels, so the levels must equal the
// plain PyTorch twin's (ops/compression/kernels.py), which runs every
// operation as its own rounded f32 step. The quantizer therefore uses the
// _rn intrinsics for its own arithmetic: nvcc would otherwise contract
// (|x| / norm) * s - floor into an FMA and change frac. log2f and exp2f
// are the same library calls PyTorch's CUDA kernels make, built with the
// same default flags; exp2f of an integer is exact.
//
// Rounds. The JAX package compresses the whole gradient tree inside one
// jitted program; the card's counterpart is one launch per parameter-server
// round. Each kernel reads a descriptor table with one row per partition
// (where its input starts, its length, where its output slot starts in the
// round's packed buffer, and for dithering which norm it takes) and a
// prefix table of tile starts: block b runs tile b - tile_start[p] of the
// partition p found by a binary search. Sizes and offsets do not change
// between steps, so the caller uploads both tables once. The stream base
// is the same for every partition of a round and comes by value (or, for
// a one-partition call, from a device scalar). A one-partition call passes
// no table and is the round of one row {0, n, 0, 0}.
//
// Bound. Dithering reads 4 bytes and writes 1 per element; randomk writes
// 4 bytes per index and reads nothing. Both are bound by bytes against the
// card's 3.35 TB/s. A dithering thread takes 16 consecutive elements: four
// 16-byte read-only loads and one 16-byte store of levels, so a warp moves
// 2 KB in and 512 bytes out per step. A randomk thread writes 4 indices as
// one 16-byte store. A scalar path takes each partition's head (up to the
// first 16-byte boundary of its output slot) and tail (the last partial
// vector), so any length and any offset work; the input is read with
// vector loads only where it too lies on 16 bytes, else element by
// element.
//
// Two more kernels stand for XLA fusions of the JAX compressor stacks, not
// for TPU kernels, and reproduce how XLA on the CPU rounds them (the
// reference the tests hold the port to):
// - fma_scalar_kernel: out = fma(a, b, c) with one scalar a. XLA contracts
//   the Nesterov momentum (mu * m + x, then x + mu * m') and the error
//   feedback's LR rescale (x + error * scale) into FMAs; __fmaf_rn rounds
//   once as they do. It moves 12 bytes per element, bound by bytes.
// - window_sum_kernel: one level of XLA's tree reduction of a 1-D f32 sum.
//   XLA's CPU backend rewrites a sum of n > 32 elements into reduce-windows
//   of 32 with stride 32, padded by (pad / 2, pad - pad / 2) zeros to a
//   multiple of 32, repeated while more than 32 partial sums remain, then
//   one reduce of the rest; each window and the last reduce add in order
//   from 0. A thread sums one window, staged in shared memory by the
//   block's coalesced loads; a sum takes ceil(log32 n) launches.
//   With square = 1 (a fused reduce of at most 32 elements, the L2 norm's
//   sum of squares) each step is fma(v, v, acc), as XLA contracts it. It
//   reads 4 bytes per element, bound by bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDitherVec = 16;                                 // elements
constexpr long long kDitherTile = (long long)kThreads * kDitherVec;
constexpr int kIndexVec = 4;                                   // indices
constexpr long long kIndexTile = (long long)kThreads * kIndexVec;
constexpr uint32_t kGolden = 0x9E3779B1u;

// One row of a dithering round (four int64, as the host writes them).
struct DitherPart {
  long long x_off;     // the partition's first element in x
  long long n;         // its elements
  long long out_off;   // its first level in out
  long long norm_idx;  // its norm in norms[]
};

// One row of a randomk round.
struct RandomkPart {
  long long size;      // the modulus: the partition's element count
  long long k;         // indices to draw
  long long out_off;   // its first index in out
  long long unused;
};

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

__device__ __forceinline__ long long min_ll(long long a, long long b) {
  return a < b ? a : b;
}

// The partition p whose tiles [tile_start[p], tile_start[p + 1]) hold
// tile t: the last p with tile_start[p] <= t, which skips empty rows.
__device__ __forceinline__ int find_part(const long long* __restrict__ ts,
                                         int n_parts, long long t) {
  int lo = 0, hi = n_parts;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ts + mid) <= t) lo = mid; else hi = mid;
  }
  return lo;
}

// Element i of a partition: 0 = linear (levels 0..s), 1 = natural (level
// j+1 = 2^-j).
template <int kNatural>
__device__ __forceinline__ int8_t dither_one(float xv, long long i,
                                             uint32_t base, float norm,
                                             float s) {
  const float u =
      __fmul_rn((float)(counter_hash(i, base) >> 8), 5.9604644775390625e-8f);
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
  return (int8_t)(int)(sign * level);
}

__device__ __forceinline__ uint32_t byte4(int8_t a, int8_t b, int8_t c,
                                          int8_t d) {
  return (uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8) |
         ((uint32_t)(uint8_t)c << 16) | ((uint32_t)(uint8_t)d << 24);
}

template <int kNatural>
__global__ void __launch_bounds__(kThreads) dither_round_kernel(
    const float* __restrict__ x, const float* __restrict__ norms,
    const DitherPart* __restrict__ parts,
    const long long* __restrict__ tile_start, int n_parts, DitherPart one,
    const long long* __restrict__ base_p, uint32_t base_v, float s,
    int8_t* __restrict__ out) {
  long long t = blockIdx.x;
  DitherPart r = one;
  if (parts != nullptr) {
    const int p = find_part(tile_start, n_parts, t);
    r = parts[p];
    t -= __ldg(tile_start + p);
  }
  const uint32_t base = base_p != nullptr ? (uint32_t)(*base_p) : base_v;
  const float norm = __ldg(norms + r.norm_idx);
  const float* xp = x + r.x_off;
  int8_t* op = out + r.out_off;
  const long long head = min_ll(r.n, (16 - ((uintptr_t)op & 15)) & 15);
  const long long chunks = (r.n - head) / kDitherVec;
  const long long c = t * kThreads + threadIdx.x;
  if (c < chunks) {
    const long long e0 = head + c * kDitherVec;
    float v[kDitherVec];
    if (((uintptr_t)(xp + e0) & 15) == 0) {  // the same for the partition
      const float4* src = reinterpret_cast<const float4*>(xp + e0);
#pragma unroll
      for (int j = 0; j < kDitherVec / 4; ++j) {
        const float4 q = __ldg(src + j);
        v[4 * j] = q.x;
        v[4 * j + 1] = q.y;
        v[4 * j + 2] = q.z;
        v[4 * j + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kDitherVec; ++j) v[j] = __ldg(xp + e0 + j);
    }
    int8_t lv[kDitherVec];
#pragma unroll
    for (int j = 0; j < kDitherVec; ++j)
      lv[j] = dither_one<kNatural>(v[j], e0 + j, base, norm, s);
    *reinterpret_cast<uint4*>(op + e0) =
        make_uint4(byte4(lv[0], lv[1], lv[2], lv[3]),
                   byte4(lv[4], lv[5], lv[6], lv[7]),
                   byte4(lv[8], lv[9], lv[10], lv[11]),
                   byte4(lv[12], lv[13], lv[14], lv[15]));
  }
  if (t == 0) {
    // the scalar head (threads 0..15) and tail (threads 16..31)
    const int tid = threadIdx.x;
    const long long tail = r.n - head - chunks * kDitherVec;
    long long e = -1;
    if (tid < head)
      e = tid;
    else if (tid >= 16 && tid - 16 < tail)
      e = head + chunks * kDitherVec + tid - 16;
    if (e >= 0) op[e] = dither_one<kNatural>(__ldg(xp + e), e, base, norm, s);
  }
}

__global__ void __launch_bounds__(kThreads) randomk_round_kernel(
    const RandomkPart* __restrict__ parts,
    const long long* __restrict__ tile_start, int n_parts, RandomkPart one,
    const long long* __restrict__ base_p, uint32_t base_v,
    int32_t* __restrict__ out) {
  long long t = blockIdx.x;
  RandomkPart r = one;
  if (parts != nullptr) {
    const int p = find_part(tile_start, n_parts, t);
    r = parts[p];
    t -= __ldg(tile_start + p);
  }
  const uint32_t base = base_p != nullptr ? (uint32_t)(*base_p) : base_v;
  const uint32_t size = (uint32_t)r.size;
  int32_t* op = out + r.out_off;
  const long long head =
      min_ll(r.k, ((16 - ((uintptr_t)op & 15)) & 15) >> 2);
  const long long chunks = (r.k - head) / kIndexVec;
  const long long c = t * kThreads + threadIdx.x;
  if (c < chunks) {
    const long long j0 = head + c * kIndexVec;
    *reinterpret_cast<int4*>(op + j0) =
        make_int4((int32_t)(counter_hash(j0, base) % size),
                  (int32_t)(counter_hash(j0 + 1, base) % size),
                  (int32_t)(counter_hash(j0 + 2, base) % size),
                  (int32_t)(counter_hash(j0 + 3, base) % size));
  }
  if (t == 0) {
    // the scalar head (threads 0..3) and tail (threads 4..7)
    const int tid = threadIdx.x;
    const long long tail = r.k - head - chunks * kIndexVec;
    long long j = -1;
    if (tid < head)
      j = tid;
    else if (tid >= 4 && tid - 4 < tail)
      j = head + chunks * kIndexVec + tid - 4;
    if (j >= 0) op[j] = (int32_t)(counter_hash(j, base) % size);
  }
}

// The dequantized level of a dithering partition, sign(lv) * mag, with
// mag = |lv| * (1/s) (linear; recip is 1/s rounded to f32 once, the
// constant XLA folds the JAX codec's |lv| / s into) or 2^-(|lv| - 1)
// built from its exponent bits (natural; exact, where exp2f may not be).
template <int kNatural>
__device__ __forceinline__ float dequant_one(int8_t lv, float recip) {
  const int a = lv < 0 ? -(int)lv : (int)lv;
  float mag;
  if (kNatural == 0)
    mag = __fmul_rn((float)a, recip);
  else
    mag = a == 0 ? 0.0f : __int_as_float((128 - a) << 23);
  return lv > 0 ? mag : (lv < 0 ? -mag : 0.0f);
}

// Element i of a partition: kResidual = 1 makes x[i] the error-feedback
// residual x[i] - dec * norm in one rounding (the FMA XLA contracts the
// JAX package's residual into); kResidual = 0 writes the aggregate's
// dequantization dec * norm into x[i].
template <int kNatural, int kResidual>
__device__ __forceinline__ float apply_one(int8_t lv, float norm, float recip,
                                           float xv) {
  const float dec = dequant_one<kNatural>(lv, recip);
  return kResidual ? __fmaf_rn(-dec, norm, xv) : __fmul_rn(dec, norm);
}

// The levels of a dithering round turned back into f32: the rows are
// B4's (x_off is where the f32 side of a partition lives, out_off where
// its levels live, norm_idx its norm). A block takes 4096 elements as
// four passes over 1024 consecutive ones, 4 a thread: one 4-byte load of
// levels and (residual) one 16-byte load and one 16-byte store of f32
// where x lies on 16 bytes, else element by element, so a warp's
// accesses are contiguous; a scalar head (up to the levels' first
// 16-byte boundary) and tail (the last partial 16) in tile 0.
template <int kNatural, int kResidual>
__global__ void __launch_bounds__(kThreads) dither_apply_kernel(
    const int8_t* __restrict__ levels, const float* __restrict__ norms,
    const DitherPart* __restrict__ parts,
    const long long* __restrict__ tile_start, int n_parts, DitherPart one,
    float recip, float* __restrict__ x) {
  long long t = blockIdx.x;
  DitherPart r = one;
  if (parts != nullptr) {
    const int p = find_part(tile_start, n_parts, t);
    r = parts[p];
    t -= __ldg(tile_start + p);
  }
  const float norm = __ldg(norms + r.norm_idx);
  float* xp = x + r.x_off;
  const int8_t* lp = levels + r.out_off;
  const long long head = min_ll(r.n, (16 - ((uintptr_t)lp & 15)) & 15);
  const long long n_vec = (r.n - head) / kDitherVec * kDitherVec;
  const bool vec = ((uintptr_t)(xp + head) & 15) == 0;  // per partition
  const long long e_first = t * kDitherTile + 4 * threadIdx.x;
#pragma unroll
  for (int j = 0; j < kDitherVec / 4; ++j) {
    const long long e = head + e_first + j * (4 * kThreads);
    if (e - head < n_vec) {
      const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(lp + e));
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (kResidual) {
        if (vec) {
          const float4 f = *reinterpret_cast<const float4*>(xp + e);
          v[0] = f.x;
          v[1] = f.y;
          v[2] = f.z;
          v[3] = f.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] = xp[e + k];
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = apply_one<kNatural, kResidual>(
            (int8_t)((w >> (8 * k)) & 0xFF), norm, recip, v[k]);
      if (vec) {
        *reinterpret_cast<float4*>(xp + e) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) xp[e + k] = v[k];
      }
    }
  }
  if (t == 0) {
    // the scalar head (threads 0..15) and tail (threads 16..31)
    const int tid = threadIdx.x;
    const long long tail = r.n - head - n_vec;
    long long e = -1;
    if (tid < head)
      e = tid;
    else if (tid >= 16 && tid - 16 < tail)
      e = head + n_vec + tid - 16;
    if (e >= 0)
      xp[e] = apply_one<kNatural, kResidual>(lp[e], norm, recip,
                                             kResidual ? xp[e] : 0.0f);
  }
}

__global__ void __launch_bounds__(kThreads) fma_scalar_kernel(
    const float* __restrict__ b, const float* __restrict__ c,
    float* __restrict__ out, long long n, const float* __restrict__ a_p,
    float a_v) {
  const float a = a_p != nullptr ? *a_p : a_v;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = __fmaf_rn(a, b[i], c[i]);
}

// A block sums kThreads windows: its kThreads * 32 inputs are staged in
// shared memory by coalesced loads (element e of the block at e + e / 32,
// so that neither the stores nor a thread's reads of its own window
// conflict on a bank), then each thread adds its window in order. A
// padding element reads as +0, which leaves a sum that starts at +0 as it
// was (it never becomes -0 in round-to-nearest).
__global__ void __launch_bounds__(kThreads) window_sum_kernel(
    const float* __restrict__ in, long long n, float* __restrict__ out,
    long long m, long long lo, int square) {
  __shared__ float tile[kThreads * 33];
  const long long first = (long long)blockIdx.x * kThreads * 32 - lo;
#pragma unroll 4
  for (int k = 0; k < 32; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const long long i = first + e;
    tile[e + e / 32] = (i >= 0 && i < n) ? __ldg(in + i) : 0.0f;
  }
  __syncthreads();
  const long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (w >= m) return;
  const float* win = tile + threadIdx.x * 33;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < 32; ++j)
    acc = square ? __fmaf_rn(win[j], win[j], acc) : __fadd_rn(acc, win[j]);
  out[w] = acc;
}

long long tiles(long long work, long long tile) {
  return (work + tile - 1) / tile;
}

}  // namespace

extern "C" {

const char* bps_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// B4 over a round. parts: n_parts rows of DitherPart on the device and
// tile_start: n_parts + 1 prefix sums of ceil(n / 4096), n_tiles the last;
// or parts = NULL for one partition of one_n elements at offset 0 with
// norms[0]. base_p: a device int64 scalar, or NULL to take base_v.
int bps_dithering_levels(const void* x, const void* norms, const void* parts,
                         const void* tile_start, int n_parts,
                         long long n_tiles, long long one_n,
                         const void* base_p, unsigned int base_v, float s,
                         int natural, void* out, void* stream) {
  const DitherPart one = {0, one_n, 0, 0};
  const long long grid =
      parts != nullptr ? n_tiles : tiles(one_n, kDitherTile);
  if (grid > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const auto* pp = (const DitherPart*)parts;
    const auto* ts = (const long long*)tile_start;
    const auto* bp = (const long long*)base_p;
    if (natural) {
      dither_round_kernel<1><<<(unsigned)grid, kThreads, 0, st>>>(
          (const float*)x, (const float*)norms, pp, ts, n_parts, one, bp,
          (uint32_t)base_v, s, (int8_t*)out);
    } else {
      dither_round_kernel<0><<<(unsigned)grid, kThreads, 0, st>>>(
          (const float*)x, (const float*)norms, pp, ts, n_parts, one, bp,
          (uint32_t)base_v, s, (int8_t*)out);
    }
  }
  return (int)cudaGetLastError();
}

// The dequantization of a dithering round (the rows, tile prefix and
// one-partition form of bps_dithering_levels): x[x_off + i] =
// fma(-dec, norm, x[x_off + i]) with residual = 1, dec * norm with
// residual = 0, dec from the levels at out_off + i.
int bps_dithering_dequantize(const void* levels, const void* norms,
                             const void* parts, const void* tile_start,
                             int n_parts, long long n_tiles, long long one_n,
                             float recip, int natural, int residual, void* x,
                             void* stream) {
  const DitherPart one = {0, one_n, 0, 0};
  const long long grid =
      parts != nullptr ? n_tiles : tiles(one_n, kDitherTile);
  if (grid > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const auto* lv = (const int8_t*)levels;
    const auto* nm = (const float*)norms;
    const auto* pp = (const DitherPart*)parts;
    const auto* ts = (const long long*)tile_start;
    auto* xp = (float*)x;
    const unsigned g = (unsigned)grid;
    if (natural && residual)
      dither_apply_kernel<1, 1><<<g, kThreads, 0, st>>>(lv, nm, pp, ts,
                                                        n_parts, one, recip,
                                                        xp);
    else if (natural)
      dither_apply_kernel<1, 0><<<g, kThreads, 0, st>>>(lv, nm, pp, ts,
                                                        n_parts, one, recip,
                                                        xp);
    else if (residual)
      dither_apply_kernel<0, 1><<<g, kThreads, 0, st>>>(lv, nm, pp, ts,
                                                        n_parts, one, recip,
                                                        xp);
    else
      dither_apply_kernel<0, 0><<<g, kThreads, 0, st>>>(lv, nm, pp, ts,
                                                        n_parts, one, recip,
                                                        xp);
  }
  return (int)cudaGetLastError();
}

// B5 over a round: parts as RandomkPart rows and tile_start as prefix sums
// of ceil(k / 1024); or parts = NULL for one partition (one_size, one_k)
// at offset 0.
int bps_randomk_indices(const void* parts, const void* tile_start,
                        int n_parts, long long n_tiles, long long one_size,
                        long long one_k, const void* base_p,
                        unsigned int base_v, void* out, void* stream) {
  const RandomkPart one = {one_size, one_k, 0, 0};
  const long long grid =
      parts != nullptr ? n_tiles : tiles(one_k, kIndexTile);
  if (grid > 0) {
    randomk_round_kernel<<<(unsigned)grid, kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const RandomkPart*)parts, (const long long*)tile_start, n_parts,
        one, (const long long*)base_p, (uint32_t)base_v, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

// out[i] = fma(a, b[i], c[i]) for i < n; a = *a_p (a device f32
// scalar), or a_v where a_p is NULL. out may be b or c.
int bps_fma_scalar(const void* b, const void* c, void* out, long long n,
                   const void* a_p, float a_v, void* stream) {
  if (n > 0) {
    const long long grid = tiles(n, kThreads);
    fma_scalar_kernel<<<(unsigned)(grid < 65536 ? grid : 65536), kThreads,
                        0, (cudaStream_t)stream>>>(
        (const float*)b, (const float*)c, (float*)out, n,
        (const float*)a_p, a_v);
  }
  return (int)cudaGetLastError();
}

// One level of XLA's tree sum: out[w] = the in-order sum of
// in[32 w - lo .. 32 w - lo + 31] (indices outside [0, n) skipped), w < m.
int bps_window_sum(const void* in, long long n, void* out, long long m,
                   long long lo, int square, void* stream) {
  if (m > 0)
    window_sum_kernel<<<(unsigned)tiles(m, kThreads), kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const float*)in, n, (float*)out, m, lo, square);
  return (int)cudaGetLastError();
}

}  // extern "C"
