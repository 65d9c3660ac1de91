// 3x3 stride-1 convolution with a fused inference-BN scale/shift and ReLU
// epilogue, for Hopper (sm_90a), on the tensor cores:
//     out[n, y, x, o] = relu(scale[o] * sum_{ky, kx, c} xp[n, y + ky, x + kx, c]
//                                       * w[ky, kx, c, o] + shift[o])
// xp is the input padded once, NHWC bf16 [N, H+2, W+2, C]; w HWIO bf16
// [3, 3, C, ldo] (ldo = Co rounded up to 8 by the wrapper, the extra
// columns zero); scale and shift fp32 [Co]; out NHWC bf16 [N, H, W, Co].
// Products of the bf16 values summed in fp32, the epilogue in fp32
// (__fmul_rn, then __fadd_rn, then ReLU), out rounded once.
//
// Replaces _conv_kernel of tools/exp_pallas_conv.py (:31, launched by
// pallas_conv_bn_relu :45 at :49), which sums 9 shifted [rows, C] x [C, Co]
// dots over bn images a grid step. Here it is an implicit GEMM on wgmma:
// M = N*H*W output pixels, N = Co, K = 9*C, walked tap by tap in chunks of
// 64 channels.
//
// What bounds it on the H100: 2*M*Co*K = 5.92e10 operations at the tool's
// shape (N=256, 14x14, 256 -> 256) against 60 MB moved: bound by
// operations, 0.060 ms at the dense bf16 tensor-core peak (989 TFLOP/s).
//
// Design (right and simple first; wgmma.cuh for the tile layouts):
//  * A block of two warpgroups owns a 128-pixel x 128-channel output tile;
//    each warpgroup the tile's 64 pixels of its own, as one m64n128
//    accumulator in registers.
//  * A tile (K-major): the 128 pixels' shifted input rows for one tap and
//    64 channels, 128 bytes a row in the 128-byte swizzle. Each thread
//    copies one 16-byte chunk of 4 fixed rows, from an xp offset it
//    computes once per row (a tile crosses image rows and images); rows
//    past M and channels past C are zero-filled (cp.async source size 0).
//  * B tile (MN-major, Co contiguous): w[tap, c0:c0+64, o0:o0+128], read
//    by wgmma with the transpose bit, as v is in the flash kernels' p v.
//    Columns past ldo are zero-filled.
//  * Three cp.async stages of 32 KB: the copies of the next two chunks
//    are in flight while the tensor cores take this one; two blocks an SM.
//  * No split of K across blocks and no atomics: one block sums all 9*C
//    products of its outputs in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace tc;

constexpr int THREADS = 256;   // two warpgroups
constexpr int BM = 128;        // output pixels a block
constexpr int BN = 128;        // output channels a block
constexpr int BK = 64;         // input channels a chunk (one tap)
constexpr int STAGES = 3;
constexpr int A_BYTES = BM * BK * 2;   // Geo<64>: one 128-byte slab a row
constexpr int B_BYTES = BK * BN * 2;   // Geo<128>: two slabs of 64 columns
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int SMEM = STAGES * STAGE + 1024;   // + alignment

__global__ void __launch_bounds__(THREADS, 2)
conv_bn_relu_tc(const bf16* __restrict__ xp, const bf16* __restrict__ w,
                const float* __restrict__ scale,
                const float* __restrict__ shift, bf16* __restrict__ out,
                int n_img, int h, int wd, int c, int co, int ldo) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // tiles 1024-aligned
  auto a_tile = [&](int st) { return base + st * STAGE; };
  auto b_tile = [&](int st) { return base + st * STAGE + A_BYTES; };

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  const long long m_total = (long long)n_img * h * wd;
  const int o0 = blockIdx.x * BN;
  const long long m0 = (long long)blockIdx.y * BM;
  const int nch = (c + BK - 1) / BK;   // chunks a tap
  const int kt_total = 9 * nch;

  // this thread's A copies: chunk ac of rows (tid >> 3) + 32 i; the xp
  // offset of each row's pixel at tap (0, 0), or -1 past M
  const int ac = tid & 7;
  long long a_off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + (tid >> 3) + 32 * i;
    a_off[i] = -1;
    if (m < m_total) {
      const long long img = m / ((long long)h * wd);
      const int rem = (int)(m - img * h * wd);
      const int y = rem / wd, x = rem - y * wd;
      a_off[i] = ((img * (h + 2) + y) * (wd + 2) + x) * c;
    }
  }
  // this thread's B copies: chunk bc (8 output channels) of rows
  // (tid >> 4) + 16 i
  const int bc = tid & 15;
  const bool b_col_ok = o0 + 8 * bc < ldo;

  auto load = [&](int kt, int st) {
    const int tap = kt / nch, c0 = (kt - tap * nch) * BK;
    const int ky = tap / 3, kx = tap - 3 * ky;
    const long long tap_off = ((long long)ky * (wd + 2) + kx) * c + c0 +
                              8 * ac;
    const bool a_c_ok = c0 + 8 * ac < c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 3) + 32 * i;
      const bool ok = a_c_ok && a_off[i] >= 0;
      cp_async16(tile_chunk<BK, BM>(a_tile(st), r, ac),
                 ok ? xp + a_off[i] + tap_off : xp, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 4) + 16 * i;
      const bool ok = b_col_ok && c0 + r < c;
      cp_async16(tile_chunk<BN, BK>(b_tile(st), r, bc),
                 ok ? w + ((long long)tap * c + c0 + r) * ldo + o0 + 8 * bc
                    : w,
                 ok ? 16 : 0);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_total) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_total; ++kt) {
    const int st = kt % STAGES;
    cp_async_wait<STAGES - 2>();   // chunk kt has landed (this thread's)
    fence_proxy_async();
    __syncthreads();               // ... and everyone's; chunk kt - 1 is
                                   // done, so its stage is refilled now
    if (kt + STAGES - 1 < kt_total)
      load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();

    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      wgmma_ss_tb_n128(acc, desc_k<BK, BM>(a_tile(st), 64 * wg, j),
                       desc_mn<BN, BK>(b_tile(st), j), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<BN / 2>(acc);
  }
  cp_async_wait<0>();

  // epilogue: columns e, e + 1 are neighbours; co % 4 == 0, so both are
  // in or out together and the pair is 4-byte aligned
#pragma unroll
  for (int e = 0; e < BN / 2; e += 2) {
    const long long m = m0 + 64 * wg + acc_row(lane, warp, e);
    const int o = o0 + acc_col(lane, e);
    if (m >= m_total || o >= co) continue;
    const float v0 = fmaxf(
        __fadd_rn(__fmul_rn(acc[e], __ldg(scale + o)), __ldg(shift + o)),
        0.f);
    const float v1 = fmaxf(__fadd_rn(__fmul_rn(acc[e + 1],
                                               __ldg(scale + o + 1)),
                                     __ldg(shift + o + 1)),
                           0.f);
    *reinterpret_cast<__nv_bfloat162*>(out + m * co + o) =
        __floats2bfloat162_rn(v0, v1);
  }
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success), or
// cudaErrorInvalidValue when c is not a multiple of 16, co not a multiple
// of 4, or ldo (w's row length) not a multiple of 8 at least co. xp and w
// must be 16-byte aligned (16-byte cp.async copies), out 4-byte aligned.
extern "C" int pt_conv_bn_relu(const void* xp, const void* w,
                               const float* scale, const float* shift,
                               void* out, int n_img, int h, int wd, int c,
                               int co, int ldo, cudaStream_t stream) {
  if (n_img <= 0 || h <= 0 || wd <= 0 || co <= 0) return 0;
  if (c <= 0 || c % 16 != 0 || co % 4 != 0 || ldo % 8 != 0 || ldo < co ||
      (reinterpret_cast<uintptr_t>(xp) | reinterpret_cast<uintptr_t>(w)) %
              16 != 0)
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        conv_bn_relu_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (rc != cudaSuccess) return (int)rc;
    attr_set = true;
  }
  const long long m_total = (long long)n_img * h * wd;
  const dim3 grid((co + BN - 1) / BN, (unsigned)((m_total + BM - 1) / BM));
  conv_bn_relu_tc<<<grid, THREADS, SMEM, stream>>>(
      static_cast<const bf16*>(xp), static_cast<const bf16*>(w), scale, shift,
      static_cast<bf16*>(out), n_img, h, wd, c, co, ldo);
  return (int)cudaGetLastError();
}
