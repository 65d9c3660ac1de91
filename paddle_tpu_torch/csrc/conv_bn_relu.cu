// 3x3 stride-1 convolution with a fused inference-BN scale/shift and ReLU
// epilogue, for Hopper (sm_90a):
//     out[n, y, x, o] = relu(scale[o] * sum_{ky, kx, c} xp[n, y + ky, x + kx, c]
//                                       * w[ky, kx, c, o] + shift[o])
// xp is the input padded once, NHWC bf16 [N, H+2, W+2, C]; w HWIO bf16
// [3, 3, C, Co]; scale and shift fp32 [Co]; out NHWC bf16 [N, H, W, Co].
// Products and sums in fp32, the epilogue in fp32, out rounded once.
//
// Replaces _conv_kernel of tools/exp_pallas_conv.py (:31, launched by
// pallas_conv_bn_relu :45 at :49), which sums 9 shifted [rows, C] x [C, Co]
// dots over bn images a grid step. Here it is an implicit GEMM: M = N*H*W
// output pixels, N = Co, K = 9*C, walked tap by tap in chunks of 16
// channels. A block of 256 threads owns a 64-pixel x 64-channel output
// tile; each chunk stages a 64 x 16 slice of the shifted input (read
// straight from xp: the padding makes every tap in bounds) and a 16 x 64
// slice of the weight through shared memory as fp32, and each thread
// accumulates a 4 x 4 tile of outputs in registers.
//
// What bounds it on the H100: 2*M*Co*K = 5.92e10 flops at the tool's shape
// (N=256, 14x14, 256 -> 256) against 60 MB moved: bound by operations, 0.060
// ms at the dense bf16 tensor-core peak (989 TFLOP/s). This kernel runs on
// the CUDA cores in fp32, whose peak (67 TFLOP/s) puts its floor at 0.88 ms;
// wgmma on bf16 tiles is the way to the bound, in later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int BM = 64;   // output pixels a block
constexpr int BN = 64;   // output channels a block
constexpr int BK = 16;   // input channels a chunk (one tap)

__device__ __forceinline__ void unpack4(uint2 raw, float* f) {
  const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = __bfloat162float(h[j]);
}

__global__ void __launch_bounds__(THREADS)
conv_bn_relu_kernel(const bf16* __restrict__ xp, const bf16* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift, bf16* __restrict__ out,
                    int n_img, int h, int wd, int c, int co) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int t = threadIdx.x;
  const long long m_total = (long long)n_img * h * wd;
  const long long m0 = (long long)blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;

  // this thread's load slots: input row a_r (a pixel), channels a_k..+3 of
  // the chunk; weight row b_k of the chunk, output channels b_o..+3
  const int a_r = t >> 2, a_k = (t & 3) * 4;
  const int b_k = t >> 4, b_o = (t & 15) * 4;
  const long long a_m = m0 + a_r;
  const bool a_ok = a_m < m_total;
  long long a_base = 0;
  if (a_ok) {
    const long long img = a_m / ((long long)h * wd);
    const int rem = (int)(a_m - img * h * wd);
    const int y = rem / wd, x = rem - (rem / wd) * wd;
    a_base = ((img * (h + 2) + y) * (wd + 2) + x) * c + a_k;
  }
  const bool b_ok = o0 + b_o < co;

  // this thread's outputs: pixels ty*4..+3, channels tx*4..+3 of the tile
  const int tx = t & 15, ty = t >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap - ky * 3;
    const long long a_tap = a_base + ((long long)ky * (wd + 2) + kx) * c;
    for (int c0 = 0; c0 < c; c0 += BK) {
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (a_ok)
        unpack4(*reinterpret_cast<const uint2*>(xp + a_tap + c0), f);
#pragma unroll
      for (int j = 0; j < 4; ++j) As[a_k + j][a_r] = f[j];
      float g[4] = {0.f, 0.f, 0.f, 0.f};
      if (b_ok)
        unpack4(*reinterpret_cast<const uint2*>(
                    w + ((long long)tap * c + c0 + b_k) * co + o0 + b_o),
                g);
      *reinterpret_cast<float4*>(&Bs[b_k][b_o]) =
          make_float4(g[0], g[1], g[2], g[3]);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const int o = o0 + tx * 4;
  if (o >= co) return;   // co % 4 == 0: the 4 channels are in or out together
  float sc[4], sh[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sc[j] = scale[o + j];
    sh[j] = shift[o + j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= m_total) break;
    uint2 raw;
    bf16* hv = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      hv[j] = __float2bfloat16(
          fmaxf(__fadd_rn(__fmul_rn(acc[i][j], sc[j]), sh[j]), 0.f));
    *reinterpret_cast<uint2*>(out + m * co + o) = raw;
  }
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success), or
// cudaErrorInvalidValue when c is not a multiple of 16 or co of 4 (the
// kernel reads 4 bf16 values, 8 bytes, at a time and walks 16 channels a
// chunk). All pointers are to contiguous tensors, 8-byte aligned.
extern "C" int pt_conv_bn_relu(const void* xp, const void* w,
                               const float* scale, const float* shift,
                               void* out, int n_img, int h, int wd, int c,
                               int co, cudaStream_t stream) {
  if (n_img <= 0 || h <= 0 || wd <= 0 || co <= 0) return 0;
  if (c <= 0 || c % BK != 0 || co % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long m_total = (long long)n_img * h * wd;
  const dim3 grid((unsigned)((m_total + BM - 1) / BM), (co + BN - 1) / BN);
  conv_bn_relu_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(xp), static_cast<const bf16*>(w), scale, shift,
      static_cast<bf16*>(out), n_img, h, wd, c, co);
  return (int)cudaGetLastError();
}
