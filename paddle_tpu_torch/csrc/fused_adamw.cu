// One-pass AdamW parameter update, in place, for Hopper (sm_90a):
//     m' = b1 m + (1 - b1) g              v' = b2 v + (1 - b2) g g
//     lr_t = lr sqrt(1 - b2^t) / (1 - b1^t)
//     p' = p - (lr_t m' / (sqrt(v') + eps) + lr wd p)
// param p and grad g fp32 or bf16 (both of one type), moments m, v fp32,
// all math fp32; p, m and v are overwritten.
//
// Replaces _adamw_kernel of paddle_tpu/ops/pallas/fused_adam.py (:22,
// launched at :85). The TPU kernel pads the flattened tensors to rows of 128
// lanes and returns new arrays; here a grid-stride loop takes any length and
// writes in place (the counterpart of XLA's buffer donation).
//
// What bounds it on the H100: 12 flops against 22 bytes an element for a
// bf16 parameter (28 for fp32): bound by bytes. One pass over p, g, m, v is
// the least traffic the update can have; the design's one contribution is
// to read lr, b1^t and b2^t from device memory, so that a training step's
// one launch per parameter never waits for the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
adamw_kernel(T* __restrict__ p, const T* __restrict__ g,
             float* __restrict__ m, float* __restrict__ v,
             const float* __restrict__ lr_p, const float* __restrict__ b1p_p,
             const float* __restrict__ b2p_p, long long n, float b1,
             float omb1, float b2, float omb2, float eps, float wd) {
  const float lr = *lr_p;
  const float bp1 = 1.f - *b1p_p;
  const float bp2 = 1.f - *b2p_p;
  const float lr_t = lr * sqrtf(bp2) / bp1;
  const float lr_wd = lr * wd;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const float pf = to_float(p[i]);
    const float gf = to_float(g[i]);
    const float mn = b1 * m[i] + omb1 * gf;
    const float vn = b2 * v[i] + omb2 * gf * gf;
    const float upd = lr_t * mn / (sqrtf(vn) + eps) + lr_wd * pf;
    from_float(p + i, pf - upd);
    m[i] = mn;
    v[i] = vn;
  }
}

template <typename T>
int launch(void* p, const void* g, float* m, float* v, const float* lr,
           const float* b1p, const float* b2p, long long n, float b1,
           float omb1, float b2, float omb2, float eps, float wd,
           cudaStream_t stream) {
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  adamw_kernel<T><<<(int)blocks, THREADS, 0, stream>>>(
      static_cast<T*>(p), static_cast<const T*>(g), m, v, lr, b1p, b2p, n, b1,
      omb1, b2, omb2, eps, wd);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success), or
// cudaErrorInvalidValue for a dtype without a template instance. dtype (of
// p and g): 0 = fp32, 1 = bf16. omb1 = 1 - b1 and omb2 = 1 - b2 are taken in
// double on the host. lr, b1p (b1^t) and b2p (b2^t) point to one fp32 value
// each on the device.
extern "C" int pt_fused_adamw(void* p, const void* g, float* m, float* v,
                              const float* lr, const float* b1p,
                              const float* b2p, long long n, float b1,
                              float omb1, float b2, float omb2, float eps,
                              float wd, int dtype, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (dtype == 0)
    return launch<float>(p, g, m, v, lr, b1p, b2p, n, b1, omb1, b2, omb2, eps,
                         wd, stream);
  if (dtype == 1)
    return launch<bf16>(p, g, m, v, lr, b1p, b2p, n, b1, omb1, b2, omb2, eps,
                        wd, stream);
  return (int)cudaErrorInvalidValue;
}
