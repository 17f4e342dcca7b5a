// The fused Adam update of one leaf for Hopper (sm_90a).
//
// Stands for the XLA fusion of byteps_tpu/jax/optim.py:36-79
// (fused_adam_step): one elementwise pass per leaf that reads the
// parameter, its gradient and both moments and writes the parameter and
// the moments back, in place. No TPU kernel stands behind it (XLA fuses
// that code); eager PyTorch would take about 12 launches per leaf.
//
// Arithmetic. The order is the JAX function's, with the two FMAs that
// XLA's CPU backend contracts (measured against the jitted step: its
// machine code holds them, and both are needed for the parameters to
// agree bit for bit):
//   m2  = fma(1 - b1, g, b1 * m)
//   v2  = fma(b2, v, ((1 - b2) * g) * g)
//   new = p - ((m2 / bc1) * lr) / (sqrt(v2 / bc2) + eps)
// Every other operation is one IEEE rounding, spelled with the _rn
// intrinsics, so nvcc contracts nothing further (NVCC_FLAGS has no
// --fmad=false). m is stored with __float2bfloat16_rn, the plain twin's
// round to nearest even. The host computes bc1 and bc2 once a step and
// passes every scalar by value.
//
// Bound. 24 bytes an element (read p, g, v as f32 and m as bf16; write p,
// v and m): bound by bytes. Each thread takes 4 consecutive elements with
// one vector load of each array (16 bytes of p, g and v, 8 of m) in a
// grid-stride loop of kBlocksPerSm blocks per SM; where a pointer is not
// aligned to its vector, every element goes scalar. Block 0 takes the last
// n % 4 elements.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, bc1, bc2;
};

// four consecutive elements, loaded and stored as one vector
template <typename T>
struct alignas(4 * sizeof(T)) Quad {
  T e[4];
};

__device__ __forceinline__ void adam_one(float& p, float g,
                                         __nv_bfloat16& m, float& v,
                                         const Hyper& h) {
  const float m2 =
      __fmaf_rn(h.omb1, g, __fmul_rn(h.b1, __bfloat162float(m)));
  const float v2 = __fmaf_rn(h.b2, v, __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float num = __fmul_rn(__fdiv_rn(m2, h.bc1), h.lr);
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, h.bc2)), h.eps);
  p = __fsub_rn(p, __fdiv_rn(num, den));
  m = __float2bfloat16_rn(m2);
  v = v2;
}

__global__ void __launch_bounds__(kThreads)
    fused_adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                      __nv_bfloat16* __restrict__ m, float* __restrict__ v,
                      long long n, int vec, Hyper h) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (!vec) {
    for (long long i = first; i < n; i += stride) {
      float pi = p[i], vi = v[i];
      __nv_bfloat16 mi = m[i];
      adam_one(pi, g[i], mi, vi, h);
      p[i] = pi;
      m[i] = mi;
      v[i] = vi;
    }
    return;
  }
  const long long nq = n >> 2;
  auto* p4 = reinterpret_cast<Quad<float>*>(p);
  auto* g4 = reinterpret_cast<const Quad<float>*>(g);
  auto* m4 = reinterpret_cast<Quad<__nv_bfloat16>*>(m);
  auto* v4 = reinterpret_cast<Quad<float>*>(v);
  for (long long q = first; q < nq; q += stride) {
    Quad<float> pq = p4[q], vq = v4[q];
    const Quad<float> gq = g4[q];
    Quad<__nv_bfloat16> mq = m4[q];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      adam_one(pq.e[e], gq.e[e], mq.e[e], vq.e[e], h);
    p4[q] = pq;
    m4[q] = mq;
    v4[q] = vq;
  }
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) {
    const long long i = 4 * nq + threadIdx.x;
    float pi = p[i], vi = v[i];
    __nv_bfloat16 mi = m[i];
    adam_one(pi, g[i], mi, vi, h);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

extern "C" {

const char* bps_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One Adam update of n elements in place: p, g and v f32, m bf16;
// omb1 = 1 - b1 and omb2 = 1 - b2 as f32, bc1 and bc2 the step's bias
// corrections.
int bps_fused_adam(void* p, const void* g, void* m, void* v, long long n,
                   float lr, float b1, float omb1, float b2, float omb2,
                   float eps, float bc1, float bc2, void* stream) {
  if (n > 0) {
    const uintptr_t pp = (uintptr_t)p, gp = (uintptr_t)g,
                    mp = (uintptr_t)m, vp = (uintptr_t)v;
    const int vec = (pp % 16 == 0) && (gp % 16 == 0) && (vp % 16 == 0) &&
                    (mp % 8 == 0);
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long work = vec ? (n >> 2) : n;
    const long long cap = (long long)(sms > 0 ? sms : 1) * kBlocksPerSm;
    long long grid = (work + kThreads - 1) / kThreads;
    grid = grid < cap ? grid : cap;
    const Hyper h = {lr, b1, omb1, b2, omb2, eps, bc1, bc2};
    fused_adam_kernel<<<(unsigned)(grid > 0 ? grid : 1), kThreads, 0,
                        (cudaStream_t)stream>>>(
        (float*)p, (const float*)g, (__nv_bfloat16*)m, (float*)v, n, vec, h);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
