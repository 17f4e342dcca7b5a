// Causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_fwd_kernel of
// byteps_tpu/ops/flash_attention.py (launched by _flash_fwd). Same
// function: out = softmax(q k^T / sqrt(D), causal) v with the online
// softmax (running max and denominator in fp32), kv head = h / groups,
// masked score = -1e30, out = acc / max(l, 1e-30), in q's dtype. q, k and
// v are read as [B, S, H, D] through their strides (head dim contiguous),
// so the caller transposes nothing; out is [B, S, H, D], contiguous.
//
// Bound. At the training path's shape (B=4, S=2048, H=6, Hkv=2, D=128,
// causal) the function is 2*B*H*S^2*D = 2.58e10 FLOPs (QK^T and PV over
// the causal half) against 34 MB of q, k, v and o: 0.026 ms at the bf16
// tensor cores' 989 TFLOP/s, 0.010 ms at 3.35 TB/s. The tensor cores bound
// it, so both products run on them, as wgmma.
//
// bf16 (flash_fwd_bf16). One block per (b, h, 128-row query tile), 384
// threads: two consumer warpgroups own 64 query rows each, a third
// warpgroup is the producer (setmaxnreg hands its registers over).
// - Loads: one producer thread keeps TMA copies in flight. Each of q, k
//   and v has a 4-D tensor map over (D, heads, S, B) built from its
//   strides, so strided views are read in place and rows past S read as
//   zeros. Tiles land as 64-column regions with the 128-byte swizzle; K
//   and V tiles of 64 keys cycle through a 2-stage ring guarded by
//   mbarriers (full: bytes landed; empty: all 8 consumer warps done).
// - S = Q K^T: wgmma m64n64k16, both operands from shared memory (K
//   row-major is the K-major B operand). S stays in the accumulators; a
//   row's max reduces across its quad with __shfl_xor_sync, its sum stays
//   per lane until the end. p = 2^(s * scale * log2 e - m) in one FFMA and
//   one ex2.
// - O += P V: wgmma m64nDk16 with P from registers (re-packed from the
//   accumulator layout, no shared-memory round trip) and V from shared
//   memory through the transpose bit. The TPU kernel multiplies fp32 P by
//   V, and the card holds this kernel to one bf16 step of that result.
//   One bf16 P errs by about 2^-9 p |v| per term, two bf16 terms (16
//   bits) by about 2^-17: near-zero outputs of rows with few keys then land two bf16
//   steps away (tests/test_torch_port_flash_numerics.py). So P is split
//   into three bf16 terms, hi = p's top 16 bits, mid and lo the rounded
//   rest (2^-25 of p), and three products go into one fp32 accumulator:
//   P V costs 3 wgmma, 2x the tensor work of the function in all. The row
//   sum adds the fp32 p.
// - Causal: the KV loop stops at the tile holding the block's last query,
//   a warpgroup skips the tiles past its own rows (and releases them), and
//   only tiles that cross a warp's diagonal are masked. The grid's slowest
//   axis is the query tile, heaviest (last) tiles first. The output goes
//   through the warp's own rows of the (by then unused) Q tile in shared
//   memory, so every global store is 16 bytes.
// 99,384 bytes of shared memory at D = 128; one block per SM. ptxas
// compiles every thread for 168 registers whatever setmaxnreg asks, and
// the overlapped schedules tried (the next tile's QK^T in flight during
// this tile's P V) ran slower (PERF.md), so each tile's products and its
// softmax run back to back; the two warpgroups overlap each other.
//
// f32 (flash_fwd_f32, the small fp32 model only; no bf16 input reaches
// it): 64-row query and key tiles, 256 threads, scalar fp32 FMAs on the
// CUDA cores, K transposed into shared memory, P through shared memory.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------------ bf16

constexpr int kBM = 128;                 // query rows per block
constexpr int kBN = 64;                  // keys per KV tile
constexpr int kStages = 2;               // the K/V ring
constexpr int kConsumers = 2;            // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr int kRow = 128;                // bytes of a 64-column swizzled row

// shared memory: every tile is kept as D/64 column regions of [rows][64]
// bf16 with TMA's 128-byte swizzle, each region 1024-byte aligned
template <int D> struct Smem {
  static constexpr int kRegions = D / 64;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kQRegion = kBM * kRow;
  static constexpr uint32_t kKVRegion = kBN * kRow;
  static constexpr uint32_t kStage = kRegions * kKVRegion;
  static constexpr uint32_t kK = kQ + kRegions * kQRegion;
  static constexpr uint32_t kV = kK + kStages * kStage;
  static constexpr uint32_t kBar = kV + kStages * kStage;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr size_t kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// p (two fp32, the lower column first) -> three bf16 pairs whose sum is p
// to 2^-25 of p: hi keeps p's top 16 bits (a byte permute), mid and lo
// round what is left; every difference is exact in fp32
__device__ __forceinline__ void split3(float p0, float p1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const uint32_t b0 = __float_as_uint(p0), b1 = __float_as_uint(p1);
  hi = __byte_perm(b0, b1, 0x7632);
  const float r0 = p0 - __uint_as_float(b0 & 0xffff0000u);
  const float r1 = p1 - __uint_as_float(b1 & 0xffff0000u);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one [rows][64] box of a 4-D (D, heads, S, B) tensor map into shared
// memory; completion is counted in bytes on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d),
         "r"(h), "r"(s), "r"(b) : "memory");
}

// wgmma shared-memory descriptors for the 128-byte swizzle (layout 1):
// start >> 4, leading byte offset >> 4, stride byte offset >> 4
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major (Q as A, K as B): 8-row atoms 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return desc(addr, 16, 1024);
}
// MN-major (V as B): 64-column regions lbo apart, 8-row atoms 1024 apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t lbo) {
  return desc(addr, lbo, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the accumulators of an async product: the compiler must not move their
// reads or writes across the product's wait
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (+)= A B, m64n64k16: A [64 x 16] and B [64 x 16] K-major in shared
// memory (descriptors); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, m64n64k16: A [64 x 16] in registers (mma.sync's A layout per
// warp), B [16 x 64] MN-major in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64n128k16: A [64 x 16] in registers (mma.sync's A layout per
// warp), B [16 x 128] MN-major in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <> __device__ __forceinline__ void wgmma_pv<64>(
    float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <> __device__ __forceinline__ void wgmma_pv<128>(
    float (&o)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

// byte offset of (row r, 16-byte chunk c) in a swizzled 64-column region
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return static_cast<uint32_t>(r * kRow + ((c ^ (r & 7)) << 4));
}

// S = Q K^T of one KV tile for the warpgroup's 64 rows (async)
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kBN / 2], uint32_t qb,
                                         uint32_t kb) {
  using L = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, desc_k(qb + (kk / 4) * L::kQRegion + (kk % 4) * 32),
                 desc_k(kb + (kk / 4) * L::kKVRegion + (kk % 4) * 32),
                 kk > 0);
}

// O += P V for one KV tile, P as three bf16 terms (async)
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&p)[kBN / 16][3][4],
                                         uint32_t vb) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t dv = desc_mn(vb + kk * 16 * kRow, Smem<D>::kKVRegion);
#pragma unroll
    for (int t = 0; t < 3; ++t) wgmma_pv<D>(acc, p[kk][t], dv);
  }
}

// 2^x, flushing results below 2^-126 to zero (a weight that small moves
// no output)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the online softmax of one score tile in place: s (raw scores) becomes p,
// the row max m (log2 units) and sum l advance, c gets the factor the old
// acc must take (exactly 1 where the max held)
__device__ __forceinline__ void softmax(float (&s)[kBN / 2], int k0, int w0,
                                        int lane, float scale_log2,
                                        bool causal, float (&m)[2],
                                        float (&l)[2], float (&c)[2]) {
  const bool diag = causal && k0 + kBN - 1 > w0;
  const int row = w0 + (lane >> 2);  // this lane's rows: row, row + 8
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    const int hf = (i >> 1) & 1;
    if (diag && k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1) > row + 8 * hf)
      s[i] = kNegInf;
    mx[hf] = fmaxf(mx[hf], s[i]);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
    // every row holds a key in every tile it sees, so mx is a score
    const float mn = fmaxf(m[hf], mx[hf] * scale_log2);
    c[hf] = mn == m[hf] ? 1.f : ex2(m[hf] - mn);
    m[hf] = mn;
  }
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    const int hf = (i >> 1) & 1;
    s[i] = ex2(fmaf(s[i], scale_log2, -m[hf]));
    sum[hf] += s[i];
  }
  l[0] = l[0] * c[0] + sum[0];
  l[1] = l[1] * c[1] + sum[1];
}

// p (accumulator layout) -> A fragments of the three bf16 terms
__device__ __forceinline__ void to_frags(const float (&s)[kBN / 2],
                                         uint32_t (&p)[kBN / 16][3][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split3(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], p[kk][0][r],
             p[kk][1][r], p[kk][2][r]);
}

// a consumer warpgroup: its 64 query rows (q0 + r0 on) against every KV
// tile they see; each tile's stage is released once both products are done
template <int D>
__device__ __forceinline__ void consume(
    unsigned char* smem, uint32_t base, uint32_t q_full, uint32_t k_full,
    uint32_t v_full, uint32_t empty, __nv_bfloat16* __restrict__ o, int q0,
    int r0, int warp, int lane, int n_kv, int S, int H, int b, int h,
    float scale_log2, int causal) {
  using L = Smem<D>;
  const int rows = q0 + r0, w0 = rows + 16 * warp;
  // tiles up to the one that holds the warpgroup's last row
  const int n_mine = rows >= S ? 0
                     : causal  ? min(n_kv, (rows + 64) / kBN)
                               : n_kv;
  const uint32_t qb = base + L::kQ + r0 * kRow;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, c[2];
  uint32_t p[kBN / 16][3][4];
  mbar_wait(q_full, 0);
  for (int j = 0, st = 0, ph = 0; j < n_kv; ++j) {
    mbar_wait(k_full + 8 * st, ph);
    mbar_wait(v_full + 8 * st, ph);
    if (j < n_mine) {
      float s[kBN / 2];
      wg_fence();
      issue_qk<D>(s, qb, base + L::kK + st * L::kStage);
      wg_commit();
      wg_wait();
      fence_regs(s);
      softmax(s, j * kBN, w0, lane, scale_log2, causal, m, l, c);
      if (__any_sync(0xffffffffu, c[0] != 1.f || c[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= c[(i >> 1) & 1];
      }
      to_frags(s, p);
      wg_fence();
      issue_pv<D>(acc, p, base + L::kV + st * L::kStage);
      wg_commit();
      wg_wait();
      fence_regs(acc);
    }
    // the tiles past the warpgroup's rows are released all the same
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
    if (++st == kStages) {
      st = 0;
      ph ^= 1;
    }
  }
  if (rows >= S) return;

  float d[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    d[hf] = fmaxf(l[hf], 1e-30f);
  }
  // the warp's own 16 rows of the Q tile take the output, then leave in
  // 16-byte stores
  const int t0 = r0 + 16 * warp;             // the warp's first row in the tile
  const int ta = t0 + (lane >> 2);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    unsigned char* reg = smem + L::kQ + (n / 8) * L::kQRegion;
    const uint32_t off = (lane & 3) * 4;
    *reinterpret_cast<__nv_bfloat162*>(reg + swz128(ta, n % 8) + off) =
        __floats2bfloat162_rn(acc[4 * n] / d[0], acc[4 * n + 1] / d[0]);
    *reinterpret_cast<__nv_bfloat162*>(reg + swz128(ta + 8, n % 8) + off) =
        __floats2bfloat162_rn(acc[4 * n + 2] / d[1], acc[4 * n + 3] / d[1]);
  }
  __syncwarp();
  const long long os = (long long)H * D;
  __nv_bfloat16* ob = o + ((long long)b * S + q0 + t0) * os + (long long)h * D;
#pragma unroll
  for (int e = lane; e < 16 * (D / 8); e += 32) {
    const int r = e / (D / 8), cc = e % (D / 8);
    *reinterpret_cast<uint4*>(ob + r * os + cc * 8) =
        *reinterpret_cast<const uint4*>(smem + L::kQ + (cc / 8) * L::kQRegion +
                                        swz128(t0 + r, cc % 8));
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, int S, int H, int groups,
               float scale_log2, int causal) {
  using L = Smem<D>;
  constexpr int kR = L::kRegions;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest tiles first
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / groups;
  const int q0 = qt * kBM;
  const int n_kv = causal ? min(q0 + kBM, S) / kBN : S / kBN;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, 4 * kConsumers);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread keeps the ring's TMA loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(q_full, kBM * D * 2);
#pragma unroll
      for (int r = 0; r < kR; ++r)
        tma_load(base + L::kQ + r * L::kQRegion, &tq, q_full, 64 * r, h, q0,
                 b);
      for (int j = 0, st = 0, ph = 0; j < n_kv; ++j) {
        // stage st's previous tile (round ph ^ 1) must be released first
        if (j >= kStages) mbar_wait(empty + 8 * st, ph ^ 1);
        const uint32_t kb = base + L::kK + st * L::kStage;
        const uint32_t vb = base + L::kV + st * L::kStage;
        mbar_expect_tx(k_full + 8 * st, kBN * D * 2);
#pragma unroll
        for (int r = 0; r < kR; ++r)
          tma_load(kb + r * L::kKVRegion, &tk, k_full + 8 * st, 64 * r, hk,
                   j * kBN, b);
        mbar_expect_tx(v_full + 8 * st, kBN * D * 2);
#pragma unroll
        for (int r = 0; r < kR; ++r)
          tma_load(vb + r * L::kKVRegion, &tv, v_full + 8 * st, 64 * r, hk,
                   j * kBN, b);
        if (++st == kStages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consume<D>(smem, base, q_full, k_full, v_full, empty, o, q0, 64 * wg,
               warp, lane, n_kv, S, H, b, h, scale_log2, causal);
  }
}

using EncodeFn = PFN_cuTensorMapEncodeTiled_v12000;

EncodeFn encoder() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled",
                                     reinterpret_cast<void**>(&fn), 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                            reinterpret_cast<void**>(&fn), cudaEnableDefault,
                            &found);
#endif
    if (found != cudaDriverEntryPointSuccess) fn = nullptr;
  }
  return fn;
}

// a 4-D (D, heads, S, B) map over a [B, S, heads, D] view with element
// strides st = (batch, seq, head), boxes of [rows][64] with the 128-byte
// swizzle; rows past S read as zeros
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
             int D, const long long* st, int rows) {
  const EncodeFn encode = encoder();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                           (cuuint64_t)st[0] * 2};
  cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int Hkv, const long long* st, float scale,
                int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, S, H, D, st, kBM);
  if (err == 0) err = make_map(&tk, k, B, S, Hkv, D, st + 3, kBN);
  if (err == 0) err = make_map(&tv, v, B, S, Hkv, D, st + 6, kBN);
  if (err != 0) return err;
  constexpr size_t smem = Smem<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (S + kBM - 1) / kBM);
  flash_fwd_bf16<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, S, H, H / Hkv, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------------- f32

constexpr int kF32Tile = 64;      // query rows per block = key rows per tile
constexpr int kF32Threads = 256;  // 16 x 16: ty owns 4 rows, tx 4 columns

// padded row strides (elements) keep the shared-memory reads of
// neighbouring rows in different banks
template <int D> struct F32Layout {
  static constexpr int kQStride = D + 2;          // sQ  [64][D + 2]
  static constexpr int kKtStride = kF32Tile + 2;  // sKt [D][64 + 2]
  static constexpr int kPStride = kF32Tile + 1;   // sP  [64][64 + 1]
  static constexpr size_t bytes =
      sizeof(float) * (kF32Tile * kQStride + D * kKtStride +
                       kF32Tile * D + kF32Tile * kPStride);
};

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S,
              int H, int groups, long long qsb, long long qss, long long qsh,
              long long ksb, long long kss, long long ksh, long long vsb,
              long long vss, long long vsh, float scale, int causal) {
  using L = F32Layout<D>;
  constexpr int kBQ = kF32Tile, kBK = kF32Tile;
  constexpr int kDC = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* sQ = reinterpret_cast<float*>(smem_f32);
  float* sKt = sQ + kBQ * L::kQStride;
  float* sV = sKt + D * L::kKtStride;
  float* sP = sV + kBK * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // heaviest causal tiles (the last queries) first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / groups;
  const int q0 = qt * kBQ;

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

  for (int e = tid; e < kBQ * D; e += kF32Threads) {
    const int r = e / D, d = e - (e / D) * D;
    sQ[r * L::kQStride + d] = qb[(long long)(q0 + r) * qss + d];
  }

  float m[4], l[4], acc[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  }

  const int n_kv = causal ? qt + 1 : S / kBK;  // kBQ == kBK
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * D; e += kF32Threads) {
      const int c = e / D, d = e - (e / D) * D;
      sKt[d * L::kKtStride + c] = kb[(long long)(k0 + c) * kss + d];
      sV[c * D + d] = vb[(long long)(k0 + c) * vss + d];
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * L::kQStride + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = sKt[d * L::kKtStride + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float x = s[i][jj] * scale;
        if (causal && row < k0 + tx + 16 * jj) x = kNegInf;
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 threads of one row are lanes [0,16) or [16,32) of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        sum += p;
        sP[(ty * 4 + i) * L::kPStride + tx + 16 * jj] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * L::kPStride + c];
#pragma unroll
      for (int dc = 0; dc < kDC; ++dc) {
        const float vv = sV[c * D + tx + 16 * dc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][dc] = fmaf(pv[i], vv, acc[i][dc]);
      }
    }
  }

  // out [B, S, H, D], contiguous
  const long long os = (long long)H * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = fmaxf(l[i], 1e-30f);
    float* orow = o + ((long long)b * S + q0 + ty * 4 + i) * os + (long long)h * D;
#pragma unroll
    for (int dc = 0; dc < kDC; ++dc) orow[tx + 16 * dc] = acc[i][dc] / li;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int Hkv, const long long* st, float scale,
               int causal, cudaStream_t stream) {
  constexpr size_t smem = F32Layout<D>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / kF32Tile, H, B);
  flash_fwd_f32<D><<<grid, kF32Threads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, H,
      H / Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* bps_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = bf16, 1 = f32. strides: 9 element strides, (batch, seq,
// head) of q, k and v; the head dim is contiguous (bf16: every row 16-byte
// aligned, which the wrapper checks). Returns a CUDA error code, or
// cudaErrorInvalidValue for a shape the kernel does not take.
int bps_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  int dtype, int B, int S, int H, int Hkv, int D,
                  const long long* strides, float scale, int causal,
                  void* stream) {
  if (S % kBN != 0 || Hkv <= 0 || H % Hkv != 0 || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return D == 128
        ? launch_bf16<128>(q, k, v, o, B, S, H, Hkv, strides, scale, causal, s)
        : launch_bf16<64>(q, k, v, o, B, S, H, Hkv, strides, scale, causal, s);
  }
  if (dtype == 1) {
    return D == 128
        ? launch_f32<128>(q, k, v, o, B, S, H, Hkv, strides, scale, causal, s)
        : launch_f32<64>(q, k, v, o, B, S, H, Hkv, strides, scale, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
