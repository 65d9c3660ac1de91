// Layer normalisation over the last axis of a [rows, h] tensor, for
// Hopper (sm_90a):
//     mean = sum(x) / h            var = sum((x - mean)^2) / h
//     rstd = rsqrt(var + eps)      y = (x - mean) * rstd [* scale] [+ bias]
// x and y fp32 or bf16 (one type), scale and bias fp32 [h] or absent, mean
// and rstd fp32 [rows]. All arithmetic in fp32, in the reference's order:
// the mean, then the centred variance, then rsqrt, then the optional scale
// and bias; y is rounded once to its type.
//
// Replaces _ln_kernel of paddle_tpu/ops/pallas/layer_norm.py (:21, launched
// by _ln_pallas :37 at :71). The TPU kernel normalises a VMEM block of up to
// 256 rows a grid step; here one block of 256 threads takes one row and
// keeps it in registers (VPT values a thread, VPT = 1..32, so h <= 8192),
// reduces twice across the block (warp shuffles, then one value a warp in
// shared memory), and writes y from the registers: x is read once and y
// written once.
//
// What bounds it on the H100: 4 reads and 6 flops an element against 4
// bytes (bf16 in and out) or 8 (fp32): bound by bytes. At ERNIE-large's
// [20480, 1024] bf16, 84 MB move, 0.025 ms at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_VPT = 32;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// The sum of v over the block, returned to every thread. red holds one
// partial a warp; the leading barrier lets consecutive calls reuse it.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += red[w];
  return t;
}

template <typename T, int VPT>
__global__ void __launch_bounds__(THREADS)
ln_kernel(const T* __restrict__ x, const float* __restrict__ scale,
          const float* __restrict__ bias, T* __restrict__ y,
          float* __restrict__ mean_out, float* __restrict__ rstd_out, int h,
          float eps) {
  __shared__ float red[WARPS];
  const long long row = blockIdx.x;
  const T* xr = x + row * h;
  T* yr = y + row * h;
  float v[VPT];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = k * THREADS + threadIdx.x;
    v[k] = i < h ? load(xr + i) : 0.f;
    s += v[k];
  }
  const float mean = block_sum(s, red) / (float)h;
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = k * THREADS + threadIdx.x;
    const float c = i < h ? v[k] - mean : 0.f;
    v[k] = c;
    ss = __fadd_rn(ss, __fmul_rn(c, c));
  }
  const float rstd = rsqrtf(block_sum(ss, red) / (float)h + eps);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = k * THREADS + threadIdx.x;
    if (i < h) {
      float o = __fmul_rn(v[k], rstd);
      if (scale != nullptr) o = __fmul_rn(o, scale[i]);
      if (bias != nullptr) o = __fadd_rn(o, bias[i]);
      store(yr + i, o);
    }
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, int VPT>
int launch(const void* x, const float* scale, const float* bias, void* y,
           float* mean, float* rstd, int rows, int h, float eps,
           cudaStream_t stream) {
  ln_kernel<T, VPT><<<rows, THREADS, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), mean, rstd,
      h, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const float* scale, const float* bias, void* y,
             float* mean, float* rstd, int rows, int h, float eps,
             cudaStream_t stream) {
  if (h <= THREADS)
    return launch<T, 1>(x, scale, bias, y, mean, rstd, rows, h, eps, stream);
  if (h <= 2 * THREADS)
    return launch<T, 2>(x, scale, bias, y, mean, rstd, rows, h, eps, stream);
  if (h <= 4 * THREADS)
    return launch<T, 4>(x, scale, bias, y, mean, rstd, rows, h, eps, stream);
  if (h <= 8 * THREADS)
    return launch<T, 8>(x, scale, bias, y, mean, rstd, rows, h, eps, stream);
  if (h <= 16 * THREADS)
    return launch<T, 16>(x, scale, bias, y, mean, rstd, rows, h, eps, stream);
  return launch<T, MAX_VPT>(x, scale, bias, y, mean, rstd, rows, h, eps,
                            stream);
}

}  // namespace

// The largest h the kernel takes.
extern "C" int pt_layer_norm_max_h() { return THREADS * MAX_VPT; }

// Launch on `stream`; returns a CUDA error code (0 on success), or
// cudaErrorInvalidValue for h outside 1..pt_layer_norm_max_h() or a dtype
// without a template instance. dtype (of x and y): 0 = fp32, 1 = bf16.
// scale and bias may be null.
extern "C" int pt_layer_norm(const void* x, const float* scale,
                             const float* bias, void* y, float* mean,
                             float* rstd, int rows, int h, float eps,
                             int dtype, cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (h <= 0 || h > THREADS * MAX_VPT) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(x, scale, bias, y, mean, rstd, rows, h, eps,
                           stream);
  if (dtype == 1)
    return dispatch<bf16>(x, scale, bias, y, mean, rstd, rows, h, eps,
                          stream);
  return (int)cudaErrorInvalidValue;
}
