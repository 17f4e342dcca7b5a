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
// reference the tests hold the port to). Their first forms, a loop of
// 4-byte accesses and one launch per tree level, lost to the PyTorch call
// for the same function; these are their redesigns:
// - fma_scalar_kernel: out = fma(a, b, c) with one scalar a. XLA contracts
//   the Nesterov momentum (mu * m + x, then x + mu * m') and the error
//   feedback's LR rescale (x + error * scale) into FMAs; __fmaf_rn rounds
//   once as they do. It moves 12 bytes per element, bound by bytes: the
//   embedding's 24,576,000 elements (295 MB, six times the 50 MB L2) take
//   at least 0.0880 ms at 3.35 TB/s. The body moves 16-byte vectors,
//   kFmaVecs of b and of c in flight per thread before any store, over
//   kFmaBlocksPerSm blocks per SM in a grid-stride loop, with the
//   streaming cache hints (ld.global.cs, st.global.cs) for data touched
//   once. A scalar head (up to out's first 16-byte boundary) and tail (the
//   last partial vector) take any offset and length; where b or c lies on
//   another 16-byte phase than out, every element goes scalar.
//   Aliasing: out may be b or c (the round's momentum writes x in place),
//   so no pointer is __restrict__ and no load is the read-only (.nc) kind;
//   every element (or vector) is read and then written by one thread only.
// - xla_sum_kernel: XLA's tree reduction of a 1-D f32 sum, in one launch.
//   XLA's CPU backend rewrites a sum of n > 32 elements into reduce-windows
//   of 32 with stride 32, padded by (pad / 2, pad - pad / 2) zeros to a
//   multiple of 32, repeated while more than 32 partial sums remain, then
//   one reduce of the rest; each window and the last reduce add in order
//   from +0, each addition rounded once. It reads 4 bytes per element,
//   bound by bytes (the embedding: 0.0293 ms).
//   . Levels 1 and 2 in one pass: a stage is 8 whole level-2 windows,
//     1,024 inputs each (8 warps: a thread sums one level-1 window, lane 0
//     of each warp then adds its warp's 32 sums in lane order, from shared
//     memory, which costs the load pipe less than 32 shuffles). Block b of
//     G takes stages b, b + G, ..., so that the grid reads one front of x
//     (faster on the H100 than a contiguous run per block). The cover is
//     shifted by the left pads of both levels; inputs outside [0, n) read
//     as +0 (a sum from +0 never becomes -0, so a padding zero changes no
//     bit).
//   . The inputs stream through a shared-memory ring of kSumStages stages
//     by 16-byte cp.async (L2 only), the next stages in flight while one is
//     added, one barrier a stage. A stage lays each level-1 window out as a
//     row of 36 floats (32 and a 16-byte pad), so a thread reads its window
//     as 16-byte vectors with no bank conflict (a 33-float row would do
//     that for 4-byte reads, but a 16-byte copy needs a 16-byte aligned
//     target). The copy starts at the 16-byte boundary at or below the
//     first input: delta (0..3) floats in, the same for every window of
//     the sum, and a window then spans 9 vectors instead of 8. A vector
//     that crosses 0 or n (any base address, any length) is read element
//     by element. TMA's bulk copies (one a stage into a plain layout read
//     rotated, or one a row) and a producer warp feeding the ring through
//     mbarriers measured slower.
//   . |x| (absolute) and x * x (square, __fmul_rn and then the add, as
//     XLA rounds a separate square) are taken as the window adds its
//     inputs; a square of at most 32 elements is XLA's fused reduce, one
//     fma(v, v, acc) per element.
//   . Only level-2 sums leave the block, into a workspace. The block that
//     takes the last ticket (each block: __threadfence, then atomicAdd)
//     sums the upper levels with the same stage code over the workspace
//     while more than 32 sums remain, then the last reduce in one warp, in
//     the windows' order, so the result never depends on which block ends
//     first, and writes the 0-dim result (times 1/n for a mean). It then
//     zeroes the ticket, so that the next call on the stream, or the next
//     replay of a captured graph, starts from 0.
//   . The workspace (the ticket and the level sums) is the wrapper's: one
//     per (card, stream, graph capture), made with the ticket zeroed.
//     Calls on one stream are ordered by the stream, so they share it;
//     two streams (the PS steps' threads) never do. 16 bytes and 1/1024 of
//     the input (96 KB at the embedding), kept for the process.

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDitherVec = 16;                                 // elements
constexpr long long kDitherTile = (long long)kThreads * kDitherVec;
constexpr int kIndexVec = 4;                                   // indices
constexpr long long kIndexTile = (long long)kThreads * kIndexVec;
constexpr uint32_t kGolden = 0x9E3779B1u;

// fma_scalar: vectors of b and of c in flight per thread, blocks per SM
constexpr int kFmaVecs = 4;
constexpr int kFmaBlocksPerSm = 8;

// xla_sum: kSumWarps warps, a stage of as many level-2 windows (1,024
// inputs each) in a row of 36 floats per thread plus the next row's first
// vector; the ring's stages
constexpr int kSumWarps = 8;
constexpr int kSumThreads = 32 * kSumWarps;
constexpr int kSumRow = 36;
constexpr int kSumStageFloats = kSumThreads * kSumRow + 4;
constexpr int kSumStages = 3;
// the ring, then the level-1 sums of a stage
constexpr int kSumSmemBytes = (kSumStages * kSumStageFloats + kSumThreads) * 4;
// xla_sum's elementwise op at load (kSumSquareFma: a square of <= 32)
constexpr int kSumPlain = 0, kSumAbs = 1, kSumSquare = 2, kSumSquareFma = 3;

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

__host__ __device__ __forceinline__ long long min_ll(long long a,
                                                    long long b) {
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

// The vector body: vector i of out, b and c is elements head + 4i ..
// head + 4i + 3. A thread loads kFmaVecs vectors of b and of c (a block's
// loads are kThreads vectors apart, so a warp reads 512 contiguous bytes)
// before it stores any. Block 0 also takes the scalar head and tail.
__global__ void __launch_bounds__(kThreads) fma_scalar_kernel(
    const float* b, const float* c, float* out, long long n, long long head,
    int vec, const float* a_p, float a_v) {
  const float a = a_p != nullptr ? *a_p : a_v;
  if (!vec) {
    const long long stride = (long long)gridDim.x * kThreads;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
         i += stride)
      __stcs(out + i, __fmaf_rn(a, __ldcs(b + i), __ldcs(c + i)));
    return;
  }
  const long long nv = (n - head) >> 2;
  const float4* b4 = reinterpret_cast<const float4*>(b + head);
  const float4* c4 = reinterpret_cast<const float4*>(c + head);
  float4* o4 = reinterpret_cast<float4*>(out + head);
  const long long step = (long long)gridDim.x * kThreads * kFmaVecs;
  for (long long i0 = (long long)blockIdx.x * kThreads * kFmaVecs +
                      threadIdx.x;
       i0 < nv; i0 += step) {
    float4 bv[kFmaVecs], cv[kFmaVecs];
#pragma unroll
    for (int u = 0; u < kFmaVecs; ++u) {
      const long long i = i0 + (long long)u * kThreads;
      if (i < nv) {
        bv[u] = __ldcs(b4 + i);
        cv[u] = __ldcs(c4 + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kFmaVecs; ++u) {
      const long long i = i0 + (long long)u * kThreads;
      if (i < nv)
        __stcs(o4 + i, make_float4(__fmaf_rn(a, bv[u].x, cv[u].x),
                                   __fmaf_rn(a, bv[u].y, cv[u].y),
                                   __fmaf_rn(a, bv[u].z, cv[u].z),
                                   __fmaf_rn(a, bv[u].w, cv[u].w)));
    }
  }
  if (blockIdx.x == 0) {
    // the scalar head (threads 0..3) and tail (threads 4..7)
    const int tid = threadIdx.x;
    const long long tail = n - head - 4 * nv;
    long long e = -1;
    if (tid < head)
      e = tid;
    else if (tid >= 4 && tid - 4 < tail)
      e = head + 4 * nv + tid - 4;
    if (e >= 0) out[e] = __fmaf_rn(a, __ldcs(b + e), __ldcs(c + e));
  }
}

// ---- xla_sum: levels 1 and 2 of the windows of 32 per stage ----------

// The first two levels of XLA's tree over n elements: level 1 (A) makes
// mA window sums of the input with left pad loA, level 2 (B) mB sums of
// those with left pad loB. A sum of at most 32 is one window (mA = 1); a
// level of at most 32 sums is the last reduce, one window (mB = 1), whose
// pad only moves zeros. Level-B window v covers the inputs from
// 1024 v - shift, shift = 32 loB + loA, on.
struct SumPlan {
  long long mA, loA, mB, loB;
};

__host__ __device__ inline SumPlan sum_plan(long long n) {
  SumPlan p;
  p.mA = n <= 32 ? 1 : (n + 31) / 32;
  p.loA = n <= 32 ? 0 : (p.mA * 32 - n) / 2;
  p.mB = p.mA <= 32 ? 1 : (p.mA + 31) / 32;
  p.loB = p.mA <= 32 ? 0 : (p.mB * 32 - p.mA) / 2;
  return p;
}

__host__ __device__ inline long long round4(long long v) {
  return (v + 3) & ~3LL;
}

// floats of the workspace of a sum of n: the ticket's 4, the level-B sums
// of the input, and (past 32 of them) the next level-B sums: the upper
// levels ping-pong between the two
__host__ __device__ inline long long sum_workspace(long long n) {
  const SumPlan p = sum_plan(n);
  return 4 + round4(p.mB) + (p.mB > 32 ? round4(sum_plan(p.mB).mB) : 0);
}

// a 16-byte copy to shared memory through L2 only, L2 fetching the whole
// 128-byte line
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copy `chunks` 16-byte vectors of src, from element `first` (on a 16-byte
// boundary; it may be negative) on, into a stage: vector q at row q / 8,
// column q % 8 of 36-float rows. A vector inside [0, n) goes by cp.async;
// one that crosses 0 or n is read element by element, +0 outside.
__device__ __forceinline__ void sum_issue(float* stage, const float* src,
                                          long long n, long long first,
                                          int chunks) {
  for (int q = threadIdx.x; q < chunks; q += kSumThreads) {
    float* d = stage + kSumRow * (q >> 3) + 4 * (q & 7);
    const long long g = first + 4LL * q;
    if (g >= 0 && g + 4 <= n) {
      cp_async16(d, src + g);
    } else {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (g + e >= 0 && g + e < n) ? __ldcg(src + g + e) : 0.0f;
      *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int kMode>
__device__ __forceinline__ float sum_step(float acc, float v) {
  if (kMode == kSumAbs) return __fadd_rn(acc, fabsf(v));
  if (kMode == kSumSquare) return __fadd_rn(acc, __fmul_rn(v, v));
  if (kMode == kSumSquareFma) return __fmaf_rn(v, v, acc);
  return __fadd_rn(acc, v);
}

// A level-1 window: v[kDelta .. kDelta + 31], in order from +0.
template <int kMode, int kDelta>
__device__ __forceinline__ float window_sum(const float (&v)[36]) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < 32; ++j) acc = sum_step<kMode>(acc, v[kDelta + j]);
  return acc;
}

// Add a landed stage: thread t sums level-1 window t (row t from column
// delta, into row t + 1 where delta > 0) into sums[t], then lane 0 of warp
// w adds its warp's 32 sums in lane order into level-2 window w, out[w].
// Warps at or past nw have no window.
template <int kMode>
__device__ __forceinline__ void sum_stage(const float* stage, int delta,
                                          int nw, float* sums, float* out) {
  const int warp = threadIdx.x >> 5;
  if (warp >= nw) return;
  const float* row = stage + kSumRow * threadIdx.x;
  float v[36];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (k < 8)
      q = *reinterpret_cast<const float4*>(row + 4 * k);
    else if (delta != 0)
      q = *reinterpret_cast<const float4*>(row + kSumRow);
    v[4 * k] = q.x;
    v[4 * k + 1] = q.y;
    v[4 * k + 2] = q.z;
    v[4 * k + 3] = q.w;
  }
  float a;
  switch (delta) {
    case 0: a = window_sum<kMode, 0>(v); break;
    case 1: a = window_sum<kMode, 1>(v); break;
    case 2: a = window_sum<kMode, 2>(v); break;
    default: a = window_sum<kMode, 3>(v); break;
  }
  sums[threadIdx.x] = a;
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    const float4* w4 = reinterpret_cast<const float4*>(sums + threadIdx.x);
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 q = w4[k];
      s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, q.x), q.y), q.z), q.w);
    }
    out[warp] = s;
  }
}

// Stages st0, st0 + step, ... (n_st of them) of a sum of src[0, n) under
// plan p, stage k being level-B windows [8k, 8k + 8) clipped to mB, into
// out at the same windows, through the ring of kSumStages stages.
template <int kMode>
__device__ void sum_windows(float* smem, const float* src, long long n,
                            const SumPlan& p, long long st0, long long step,
                            long long n_st, float* out) {
  const long long shift = 32 * p.loB + p.loA;
  const int delta =
      (int)(((long long)((uintptr_t)src >> 2) - shift) & 3);
  auto issue = [&](long long k) {
    if (k < n_st) {
      const long long v0 = kSumWarps * (st0 + k * step);
      const int nw = (int)min_ll(kSumWarps, p.mB - v0);
      sum_issue(smem + (k % kSumStages) * kSumStageFloats, src, n,
                1024 * v0 - shift - delta, 256 * nw + (delta != 0));
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  for (int k = 0; k < kSumStages - 1; ++k) issue(k);
  for (long long k = 0; k < n_st; ++k) {
    cp_async_wait<kSumStages - 2>();  // this thread's part of stage k
    // every part of stage k has landed, and every thread is done with
    // stage k - 1, whose slot the next issue fills
    __syncthreads();
    issue(k + kSumStages - 1);
    const long long v0 = kSumWarps * (st0 + k * step);
    sum_stage<kMode>(smem + (k % kSumStages) * kSumStageFloats, delta,
                     (int)min_ll(kSumWarps, p.mB - v0),
                     smem + kSumStages * kSumStageFloats, out + v0);
  }
  __syncthreads();  // the ring is free for the next call
}

// One launch for the whole sum: block b takes stages of x (8 level-B
// windows each) into ws_a; the last block to arrive sums the upper levels,
// from ws_a through ws_b and back while more than 32 sums remain, then the
// last reduce in one warp, and writes out[0] (times scale where
// has_scale).
template <int kMode>
__global__ void __launch_bounds__(kSumThreads, 2) xla_sum_kernel(
    const float* __restrict__ x, long long n, float* ws_a, float* ws_b,
    unsigned int* ticket, int has_scale, float scale, float* out) {
  extern __shared__ float4 sum_smem[];
  float* smem = reinterpret_cast<float*>(sum_smem);
  __shared__ int last;
  const SumPlan p = sum_plan(n);
  const long long G = gridDim.x, b = blockIdx.x;
  const long long n_st = (p.mB + kSumWarps - 1) / kSumWarps;
  // block b takes stages b, b + G, ...: the grid reads one front of x
  sum_windows<kMode>(smem, x, n, p, b, G, (n_st - b + G - 1) / G, ws_a);
  __threadfence();  // this block's level-B sums, before its ticket
  __syncthreads();
  if (G > 1) {
    if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == (unsigned)(G - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (threadIdx.x == 0) atomicExch(ticket, 0u);
  }
  const float* src = ws_a;
  float* dst = ws_b;
  long long m = p.mB;
  while (m > 32) {
    const SumPlan q = sum_plan(m);
    sum_windows<kSumPlain>(smem, src, m, q, 0, 1,
                           (q.mB + kSumWarps - 1) / kSumWarps, dst);
    __threadfence();
    __syncthreads();
    src = dst;
    dst = dst == ws_b ? ws_a : ws_b;
    m = q.mB;
  }
  // the last reduce, of at most 32 sums: warp 0, lane order from +0
  if (threadIdx.x < 32) {
    const float v = threadIdx.x < m ? __ldcg(src + threadIdx.x) : 0.0f;
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      s = __fadd_rn(s, __shfl_sync(0xFFFFFFFFu, v, j));
    if (threadIdx.x == 0) out[0] = has_scale ? __fmul_rn(s, scale) : s;
  }
}

// Blocks of a kernel that fit on one SM of the calling thread's card with
// `smem` bytes of dynamic shared memory, and that card's SMs; looked up
// once per card and kernel (the opt-in to more than 48 KB set there too).
struct Fit {
  int blocks, sms;
};

template <typename K>
Fit fit(K kernel, int slot, int threads, int smem) {
  static Fit cache[8][64];
  static std::mutex mu;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mu);
  Fit& f = cache[slot][dev & 63];
  if (f.sms == 0) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int blocks = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                  threads, smem);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    f.blocks = blocks > 0 ? blocks : 1;
    f.sms = sms > 0 ? sms : 1;
  }
  return f;
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
    const uintptr_t ob = (uintptr_t)out;
    const long long head = min_ll(n, (long long)((16 - (ob & 15)) & 15) / 4);
    const int vec = (((uintptr_t)b ^ ob) & 15) == 0 &&
                    (((uintptr_t)c ^ ob) & 15) == 0 && (ob & 3) == 0;
    const Fit f = fit(fma_scalar_kernel, 4, kThreads, 0);
    const long long work = vec ? tiles((n - head) / 4, kThreads * kFmaVecs)
                               : tiles(n, kThreads);
    long long grid = (long long)f.sms * kFmaBlocksPerSm;
    grid = work < grid ? work : grid;
    fma_scalar_kernel<<<(unsigned)(grid > 0 ? grid : 1), kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const float*)b, (const float*)c, (float*)out, n, head, vec,
        (const float*)a_p, a_v);
  }
  return (int)cudaGetLastError();
}

// Floats of the workspace bps_xla_sum needs for n inputs.
long long bps_xla_sum_workspace(long long n) {
  return n > 0 ? sum_workspace(n) : 0;
}

// The id of the graph capture under way on the stream, 0 if none.
unsigned long long bps_capture_id(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, &id) !=
          cudaSuccess ||
      status != cudaStreamCaptureStatusActive)
    return 0;
  return id;
}

// out[0] = XLA's CPU sum of f(x[i]), i < n (f: 0 the value, 1 |v|, 2 v * v
// rounded, its add apart; with n <= 32 one fma per element), times scale
// where has_scale; one launch. ws: ws_floats floats, the first 4 the
// ticket (zero between calls), see bps_xla_sum_workspace.
int bps_xla_sum(const void* x, long long n, int mode, int has_scale,
                float scale, void* ws, long long ws_floats, void* out,
                void* stream) {
  if (n <= 0 || mode < kSumPlain || mode > kSumSquare ||
      ws_floats < sum_workspace(n) || ((uintptr_t)x & 3) != 0 ||
      ((uintptr_t)ws & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (mode == kSumSquare && n <= 32) mode = kSumSquareFma;
  void (*const kernels[4])(const float*, long long, float*, float*,
                           unsigned int*, int, float, float*) = {
      xla_sum_kernel<kSumPlain>, xla_sum_kernel<kSumAbs>,
      xla_sum_kernel<kSumSquare>, xla_sum_kernel<kSumSquareFma>};
  const Fit f = fit(kernels[mode], mode, kSumThreads, kSumSmemBytes);
  const SumPlan p = sum_plan(n);
  long long grid = (long long)f.sms * f.blocks;
  grid = tiles(p.mB, kSumWarps) < grid ? tiles(p.mB, kSumWarps) : grid;
  float* ws_a = (float*)ws + 4;
  kernels[mode]<<<(unsigned)grid, kSumThreads, kSumSmemBytes,
                  (cudaStream_t)stream>>>(
      (const float*)x, n, ws_a, ws_a + round4(p.mB), (unsigned int*)ws,
      has_scale, scale, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
