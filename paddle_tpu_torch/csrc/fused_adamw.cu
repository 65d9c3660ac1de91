// One-pass AdamW parameter update, in place, for Hopper (sm_90a):
//     m' = b1 m + (1 - b1) g              v' = b2 v + (1 - b2) g g
//     lr_t = lr sqrt(1 - b2^t) / (1 - b1^t)
//     p' = p - (lr_t m' / (sqrt(v') + eps) + lr wd p)
// param p and grad g fp32 or bf16 (both of one type), moments m, v fp32,
// all math fp32; p, m and v are overwritten. The same launch also advances
// the beta powers: b1^t <- b1^t b1, b2^t <- b2^t b2 (one fp32 multiply
// each), so an optimizer op is one kernel.
//
// Replaces _adamw_kernel of paddle_tpu/ops/pallas/fused_adam.py (:22,
// launched at :85). The TPU kernel pads the flattened tensors to rows of 128
// lanes and returns new arrays; here the kernel takes any length and writes
// in place (the counterpart of XLA's buffer donation).
//
// What bounds it on the H100: 12 flops against 22 bytes an element for a
// bf16 parameter (28 for fp32): bound by bytes, so the design is about
// keeping enough bytes in flight (~3 MB across the card by Little's law at
// 3.35 TB/s):
//  * 16-byte accesses: a thread takes one vector of VEC elements, 8 for
//    bf16 (one 16-byte load of p and of g, two of m and of v), 4 for fp32,
//    and issues all of its loads before it uses any (one vector a thread
//    measured faster than two or four, tools/profile_stream_kernels.py);
//  * evict-first (streaming) loads and stores;
//  * one pass: a block for every THREADS vectors;
//  * a scalar head up to the first 16-byte boundary of p and a scalar tail
//    past the last whole vector, from the wrapper's split
//    (kernels/fused_adam.py, split), which also sends a view whose streams
//    are not aligned alike down the scalar loop whole.
// lr, b1^t and b2^t are read from device memory, so a training step never
// waits for the host; each thread reads them beside its data, so a small
// tensor's launch waits for memory once. Each block takes a ticket once all
// its threads have read b1^t and b2^t; the block that takes the last one
// writes the new powers and resets the ticket, so no block can read a
// power already advanced (a grid of one block writes them after its
// barrier, without the ticket: a third of a training step's parameters are
// biases and norms of one block).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;

struct Hyper {
  float b1, omb1, b2, omb2, eps, lr_t, lr_wd;
};

__device__ __forceinline__ void adam(float& p, float g, float& m, float& v,
                                     const Hyper& h) {
  m = h.b1 * m + h.omb1 * g;
  v = h.b2 * v + h.omb2 * g * g;
  p = p - (h.lr_t * m / (sqrtf(v) + h.eps) + h.lr_wd * p);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ void scalar(T* p, const T* g, float* m, float* v,
                                       long long i, const Hyper& h) {
  float pf = to_float(p[i]), mf = m[i], vf = v[i];
  adam(pf, to_float(g[i]), mf, vf, h);
  from_float(p + i, pf);
  m[i] = mf;
  v[i] = vf;
}

// A vector of VEC elements: one 16-byte word of p and of g, MW of m and
// of v.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int VEC = 4, MW = 1;
  static __device__ __forceinline__ void unpack(const uint4* w, float* f) {
    const float4 x = *reinterpret_cast<const float4*>(w);
    f[0] = x.x;
    f[1] = x.y;
    f[2] = x.z;
    f[3] = x.w;
  }
  static __device__ __forceinline__ void pack(const float* f, uint4* w) {
    *reinterpret_cast<float4*>(w) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<bf16> {
  static constexpr int VEC = 8, MW = 2;
  static __device__ __forceinline__ void unpack(const uint4* w, float* f) {
    const uint32_t u[4] = {w->x, w->y, w->z, w->w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(u[j] << 16);
      f[2 * j + 1] = __uint_as_float(u[j] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ void pack(const float* f, uint4* w) {
    uint32_t u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 pr = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
      u[j] = *reinterpret_cast<const uint32_t*>(&pr);
    }
    *w = make_uint4(u[0], u[1], u[2], u[3]);
  }
};

// evict-first (streaming) 16-byte accesses: every byte is touched once
// (2-5 % faster than plain ones, tools/profile_stream_kernels.py)
__device__ __forceinline__ uint4 ld16(const uint4* p) { return __ldcs(p); }
__device__ __forceinline__ void st16(uint4* p, uint4 v) { __stcs(p, v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
adamw_kernel(T* __restrict__ p, const T* __restrict__ g,
             float* __restrict__ m, float* __restrict__ v,
             const float* __restrict__ lr_p, float* __restrict__ b1p_p,
             float* __restrict__ b2p_p, unsigned* __restrict__ ticket,
             long long head, long long nvec, long long n, float b1,
             float omb1, float b2, float omb2, float eps, float wd) {
  using V = Vec<T>;
  // every thread reads lr and the powers itself, in flight with its data
  const float lr = *lr_p, pow1 = *b1p_p, pow2 = *b2p_p;
  Hyper h;
  h.b1 = b1;
  h.omb1 = omb1;
  h.b2 = b2;
  h.omb2 = omb2;
  h.eps = eps;
  h.lr_t = lr * sqrtf(1.f - pow2) / (1.f - pow1);
  h.lr_wd = lr * wd;

  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * THREADS;
  // scalar head [0, head) and tail [head + nvec * VEC, n)
  for (long long i = tid; i < head; i += nthreads) scalar(p, g, m, v, i, h);
  for (long long i = head + nvec * V::VEC + tid; i < n; i += nthreads)
    scalar(p, g, m, v, i, h);

  // the aligned body: vector k holds elements head + VEC k ..
  uint4* pw = reinterpret_cast<uint4*>(p + head);
  const uint4* gw = reinterpret_cast<const uint4*>(g + head);
  uint4* mw = reinterpret_cast<uint4*>(m + head);
  uint4* vw = reinterpret_cast<uint4*>(v + head);
  for (long long k = tid; k < nvec; k += nthreads) {
    uint4 wp = ld16(pw + k), wg = ld16(gw + k), wm[V::MW], wv[V::MW];
#pragma unroll
    for (int j = 0; j < V::MW; ++j) {
      wm[j] = ld16(mw + k * V::MW + j);
      wv[j] = ld16(vw + k * V::MW + j);
    }
    float fp[V::VEC], fg[V::VEC], fm[V::VEC], fv[V::VEC];
    V::unpack(&wp, fp);
    V::unpack(&wg, fg);
#pragma unroll
    for (int j = 0; j < V::MW; ++j) {
      Vec<float>::unpack(&wm[j], fm + 4 * j);
      Vec<float>::unpack(&wv[j], fv + 4 * j);
    }
#pragma unroll
    for (int e = 0; e < V::VEC; ++e) adam(fp[e], fg[e], fm[e], fv[e], h);
    V::pack(fp, &wp);
    st16(pw + k, wp);
#pragma unroll
    for (int j = 0; j < V::MW; ++j) {
      Vec<float>::pack(fm + 4 * j, &wm[j]);
      Vec<float>::pack(fv + 4 * j, &wv[j]);
      st16(mw + k * V::MW + j, wm[j]);
      st16(vw + k * V::MW + j, wv[j]);
    }
  }
  // the powers, once every thread of the block has read them: a grid of
  // one block writes b1^t b1 and b2^t b2 at once; otherwise the last block
  // to take a ticket does, and leaves the ticket 0. No fence: a thread's
  // reads of the powers have returned before it reaches the barrier (every
  // store it made depends on them; a thread with no element never uses
  // them), and no block reads what another block wrote.
  __syncthreads();
  if (threadIdx.x != 0) return;
  if (gridDim.x > 1) {
    if (atomicAdd(ticket, 1u) != gridDim.x - 1) return;
    *ticket = 0u;
  }
  *b1p_p = __fmul_rn(pow1, b1);
  *b2p_p = __fmul_rn(pow2, b2);
}

template <typename T>
int launch(void* p, const void* g, float* m, float* v, const float* lr,
           float* b1p, float* b2p, unsigned* ticket, long long n,
           long long head, long long nvec, float b1, float omb1, float b2,
           float omb2, float eps, float wd, cudaStream_t stream) {
  // a block for every THREADS vectors (or THREADS scalars of the head and
  // tail, where they are more): one pass each, which measured faster than
  // a persistent grid of SMs x resident blocks
  // (tools/profile_stream_kernels.py, variant persistent)
  const long long rest = n - nvec * Vec<T>::VEC;
  long long blocks = (nvec + THREADS - 1) / THREADS;
  const long long scal = (rest + THREADS - 1) / THREADS;
  if (scal > blocks) blocks = scal;
  if (blocks < 1) blocks = 1;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  adamw_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<T*>(p), static_cast<const T*>(g), m, v, lr, b1p, b2p,
      ticket, head, nvec, n, b1, omb1, b2, omb2, eps, wd);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success), or
// cudaErrorInvalidValue for a dtype without a template instance, a null
// ticket or a split the body cannot read. dtype (of p and g): 0 = fp32, 1 = bf16. Elements
// [0, head) and [head + nvec * VEC, n) take the scalar loop; the nvec
// vectors between them (VEC = 4 for fp32, 8 for bf16) must start 16-byte
// aligned in p, g, m and v. omb1 = 1 - b1 and omb2 = 1 - b2 are taken in
// double on the host. lr, b1p (b1^t) and b2p (b2^t) point to one fp32
// value each on the device; the launch advances b1p and b2p by one
// multiply by b1 and b2 after every block has read them. ticket points to
// one unsigned int, 0, that the launch leaves 0.
extern "C" int pt_fused_adamw(void* p, const void* g, float* m, float* v,
                              const float* lr, float* b1p, float* b2p,
                              unsigned* ticket, long long n, long long head,
                              long long nvec, float b1, float omb1, float b2,
                              float omb2, float eps, float wd, int dtype,
                              cudaStream_t stream) {
  const int vec = dtype == 0 ? 4 : 8;
  const size_t esz = dtype == 0 ? 4 : 2;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (ticket == nullptr || n < 0 || head < 0 || nvec < 0 ||
      head + nvec * vec > n ||
      (nvec > 0 &&
       ((reinterpret_cast<uintptr_t>(p) + head * esz) |
        (reinterpret_cast<uintptr_t>(g) + head * esz) |
        (reinterpret_cast<uintptr_t>(m) + head * 4) |
        (reinterpret_cast<uintptr_t>(v) + head * 4)) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(p, g, m, v, lr, b1p, b2p, ticket, n, head, nvec, b1,
                         omb1, b2, omb2, eps, wd, stream);
  return launch<bf16>(p, g, m, v, lr, b1p, b2p, ticket, n, head, nvec, b1,
                      omb1, b2, omb2, eps, wd, stream);
}
