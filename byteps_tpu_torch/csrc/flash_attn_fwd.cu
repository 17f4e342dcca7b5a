// Causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_fwd_kernel of
// byteps_tpu/ops/flash_attention.py (launched by _flash_fwd). Same
// function: out = softmax(q k^T / sqrt(D), causal) v with the online
// softmax (running max and denominator in fp32), kv head = h / groups,
// masked score = -1e30, out = acc / max(l, 1e-30), in q's dtype.
//
// Design. One block of 256 threads per (b, h, 64-row query tile); a loop
// over 64-row KV tiles inside the block takes the place of the TPU's
// sequential nk grid axis, and under causal masking it stops at the tile
// that holds the tile's last query. Q, K (transposed) and V tiles are
// staged in shared memory in the input dtype; scores, the running max and
// denominator and the output accumulator stay in fp32 registers. Each
// thread owns 4 query rows by 4 key columns of the score tile and 4 rows
// by D/16 columns of the output; a row's max and sum are reduced across
// the 16 threads that share it with warp shuffles. The probabilities pass
// through shared memory (fp32) to the P.V product. q, k and v are read as
// [B, S, H, D] through their strides, so the caller transposes nothing.
// The largest tiles (bf16, D = 128) take 66,560 bytes of shared memory,
// above the 48 KB static limit, so the kernel raises its dynamic limit
// with cudaFuncSetAttribute before each launch.
//
// Bound. At the model's shape (B=4, S=2048, H=6, D=128) the work is
// 2*B*H*S^2*D FLOPs (QK^T and PV over the causal half) against 34 MB of
// q, k, v and o, so the tensor cores' 989 TFLOP/s bound it, not memory.
// This first kernel multiplies on the CUDA cores in fp32 (no mma.sync,
// wgmma or TMA yet), so it runs well above that bound; PERF.md has its
// time.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per KV tile
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 rows, tx 4 columns
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// padded row strides (elements) keep the shared-memory reads of
// neighbouring rows in different banks
template <int D> struct Layout {
  static constexpr int kQStride = D + 2;     // sQ  [kBQ][D + 2]
  static constexpr int kKtStride = kBK + 2;  // sKt [D][kBK + 2]
  static constexpr int kPStride = kBK + 1;   // sP  [kBQ][kBK + 1] fp32
  template <typename T> static constexpr size_t bytes() {
    return sizeof(T) * (kBQ * kQStride + D * kKtStride + kBK * D) +
           sizeof(float) * kBQ * kPStride;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int groups, long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh, long long vsb,
                 long long vss, long long vsh, float scale, int causal) {
  using L = Layout<D>;
  constexpr int kDC = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sKt = sQ + kBQ * L::kQStride;
  T* sV = sKt + D * L::kKtStride;
  float* sP = reinterpret_cast<float*>(sV + kBK * D);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // heaviest causal tiles (the last queries) first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / groups;
  const int q0 = qt * kBQ;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int e = tid; e < kBQ * D; e += kThreads) {
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
    for (int e = tid; e < kBK * D; e += kThreads) {
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
      for (int i = 0; i < 4; ++i) qv[i] = to_f(sQ[(ty * 4 + i) * L::kQStride + d]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = to_f(sKt[d * L::kKtStride + tx + 16 * jj]);
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
        const float vv = to_f(sV[c * D + tx + 16 * dc]);
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
    T* orow = o + ((long long)b * S + q0 + ty * 4 + i) * os + (long long)h * D;
#pragma unroll
    for (int dc = 0; dc < kDC; ++dc) orow[tx + 16 * dc] = from_f<T>(acc[i][dc] / li);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hkv, const long long* st, float scale,
           int causal, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::template bytes<T>();
  // per launch, not cached: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, H / Hkv, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* bps_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = bf16, 1 = f32. strides: 9 element strides, (batch, seq,
// head) of q, k and v; the head dim is contiguous. Returns a CUDA error
// code, or cudaErrorInvalidValue for a shape the kernel does not take.
int bps_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  int dtype, int B, int S, int H, int Hkv, int D,
                  const long long* strides, float scale, int causal,
                  void* stream) {
  if (S % kBQ != 0 || Hkv <= 0 || H % Hkv != 0 || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return D == 128
        ? launch<__nv_bfloat16, 128>(q, k, v, o, B, S, H, Hkv, strides, scale, causal, s)
        : launch<__nv_bfloat16, 64>(q, k, v, o, B, S, H, Hkv, strides, scale, causal, s);
  }
  if (dtype == 1) {
    return D == 128
        ? launch<float, 128>(q, k, v, o, B, S, H, Hkv, strides, scale, causal, s)
        : launch<float, 64>(q, k, v, o, B, S, H, Hkv, strides, scale, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
