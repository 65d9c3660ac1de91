// Weight-only int8 GEMM for Hopper (sm_90a), on the bf16 tensor cores:
//     out[m, n] = act((sum_k x[m, k] * float(w8[k, n])) * scale[n] + bias[n])
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/int8_gemm.py
// _gemm_kernel (with its _epilogue): x fp32 [M, K], w8 int8 [K, N],
// scale / bias fp32 [N], act none or relu; the epilogue multiplies by the
// scale, then adds the bias, then applies relu, each rounded once.
//
// The arithmetic. Every int8 value is exact in bf16. Each activation is
// cut into three bf16 pieces by truncation: hi = the top 16 bits of x,
// mid = the top 16 bits of x - hi, lo = x - hi - mid (at most 8 significant
// bits, so exact in bf16). hi + mid + lo = x exactly for |x| >= 2^-110
// (below, within 2^-133). Each piece times a weight is exact in fp32
// (8 x 8 bits), so three bf16 products into one fp32 accumulator, lo
// first, compute what an fp32 GEMM computes, at the sums' fp32 rounding.
// The weight stays int8 in device memory and becomes bf16 only in shared
// memory: a byte permute puts b + 128 into the mantissa of 2^23, one fp32
// subtract leaves b, and the top halves of two such floats are a bf16
// pair (no I2F).
//
// What bounds the function on the H100: at prefill (M >= 512) its 2MNK
// operations at the dense bf16 rate, 989 TFLOP/s, and its bytes at 3.35
// TB/s, about equal (0.0043 and 0.0044 ms at M = 512, K = 1024, N =
// 4096); at decode (M = 8) the weight's bytes, K * N at 3.35 TB/s
// (0.0013 ms at K = 1024, N = 4096). This design's own floor is three
// times the operations bound, three bf16 products for each fp32 one
// (0.0130 ms at M = 512).
//
// Two instances of one design, chosen by M:
//  * prefill (M > 16): a block of two warpgroups owns a 128 x 128 output
//    tile (one warpgroup a 64 x 64 tile where 128-wide tiles would leave
//    SMs idle); x's fp32 rows and w8's int8 rows come in by cp.async
//    through three stages of 32-deep K slabs. Each slab's w8 is converted
//    into a bf16 MN-major tile in the 128-byte swizzle; each thread builds
//    its register-A fragments from the fp32 x slab and cuts them into the
//    three pieces, and issues three wgmma (register A, B with the transpose
//    bit) per 16-deep step. K stays whole at M >= 512; below, where even
//    64-wide tiles leave SMs idle, it is split as in decode.
//  * decode (M <= 16): the operands swap, out^T = w8^T x^T, so 64 output
//    columns are wgmma's M (w8^T, MN-major, the transpose bit of A) and the
//    M <= 16 rows its N (8 or 16). K is split so that some 256 blocks
//    stream the weight through four-stage cp.async rings.
//  * A split K's slices of one output tile are one thread-block cluster of
//    up to 8 blocks: each block leaves its partial tile in shared memory
//    and the cluster's blocks add them across distributed shared memory in
//    rank order, then apply the epilogue (cluster_reduce_store): one
//    launch, no partial sums in device memory.
//  * In both, every sum runs in a fixed order with no atomics, the tile
//    and split plan is a pure function of (M, N, K) (kernels/int8_gemm.py,
//    plan), and no sum runs across rows: a row's result never depends on
//    the other rows.
//  * Ragged shapes: rows past M, K and the padded N are zero-filled
//    (cp.async source size 0); the wrapper pads x's rows to a multiple of
//    4 floats and w8's to a multiple of 16 bytes (ldx, ldw) where the
//    shape is ragged, so every copy is 16 bytes and aligned.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tc;

// four int8 (one word) -> two bf16 pairs, exactly: 2^23 + (b + 128) by a
// byte permute, minus 2^23 + 128, whose top half is bf16(b)
__device__ __forceinline__ void s8x4_to_bf16(uint32_t v, uint32_t& p01,
                                             uint32_t& p23) {
  const uint32_t u = v ^ 0x80808080u;
  const float magic = 8388736.f;   // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) -
                   magic;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) -
                   magic;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) -
                   magic;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) -
                   magic;
  p01 = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  p23 = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// 16 int8 (16 bytes) -> 16 bf16 (two 16-byte chunks)
__device__ __forceinline__ void s8x16_to_bf16(uint4 v, uint4& c0, uint4& c1) {
  s8x4_to_bf16(v.x, c0.x, c0.y);
  s8x4_to_bf16(v.y, c0.z, c0.w);
  s8x4_to_bf16(v.z, c1.x, c1.y);
  s8x4_to_bf16(v.w, c1.z, c1.w);
}

// x0, x1 as three bf16 pairs, by truncation: hi + mid + lo = x exactly
// for |x| >= 2^-110
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const uint32_t b0 = __float_as_uint(x0), b1 = __float_as_uint(x1);
  hi = __byte_perm(b0, b1, 0x7632);
  const float r0 = __fsub_rn(x0, __uint_as_float(b0 & 0xFFFF0000u));
  const float r1 = __fsub_rn(x1, __uint_as_float(b1 & 0xFFFF0000u));
  const uint32_t c0 = __float_as_uint(r0), c1 = __float_as_uint(r1);
  mid = __byte_perm(c0, c1, 0x7632);
  const float s0 = __fsub_rn(r0, __uint_as_float(c0 & 0xFFFF0000u));
  const float s1 = __fsub_rn(r1, __uint_as_float(c1 & 0xFFFF0000u));
  lo = __byte_perm(__float_as_uint(s0), __float_as_uint(s1), 0x7632);
}

__device__ __forceinline__ float epilogue(float acc, const float* scale,
                                          const float* bias, int n,
                                          int relu) {
  float v = __fmul_rn(acc, __ldg(scale + n));
  if (bias != nullptr) v = __fadd_rn(v, __ldg(bias + n));
  return relu ? fmaxf(v, 0.f) : v;
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The K slices of one output tile lie in the shared memory of a cluster's
// blocks, one [rows][cols] fp32 tile each (part). Every block adds a
// share of the elements over the cluster's ranks in rank order, across
// distributed shared memory, and stores them through the epilogue: tile
// element (r, c) is out[m0 + r, n0 + c], or out[c, n0 + r] where the
// product was taken transposed (TRANS).
template <bool TRANS>
__device__ __forceinline__ void cluster_reduce_store(
    float* part, int rows, int cols, int m0, int n0, int M, int N,
    float* __restrict__ out, const float* scale, const float* bias,
    int relu) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every rank's partials are written
  const int ks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int nt = blockDim.x;
  for (int i = rank * nt + threadIdx.x; i < rows * cols; i += ks * nt) {
    float s = cluster.map_shared_rank(part, 0)[i];
    for (int q = 1; q < ks; ++q) s += cluster.map_shared_rank(part, q)[i];
    const int r = i / cols, c = i - (i / cols) * cols;
    const int m = TRANS ? c : m0 + r, n = n0 + (TRANS ? r : c);
    if (m < M && n < N)
      out[(long long)m * N + n] = epilogue(s, scale, bias, n, relu);
  }
  cluster.sync();   // no block leaves while another reads its partials
}

// ---------------------------------------------------------------------------
// prefill instance, M > 16
// ---------------------------------------------------------------------------

// T x T output tiles: T = 128 (two warpgroups) or 64 (one), whichever
// plan() picks to fill the card
template <int T>
struct PrefillGeo {
  static constexpr int THREADS = 2 * T;
  static constexpr int BM = T, BN = T, BK = 32, STAGES = 3;
  static constexpr int XS = BK + 8;   // floats a staged x row: 160 bytes,
                                      // so fragment loads miss no bank
  static constexpr int XBYTES = BM * XS * 4;
  static constexpr int WBYTES = BK * BN;          // int8, as it came
  static constexpr int WB = BK * BN * 2;          // bf16 B tile, Geo<BN>
  static constexpr int STAGE = XBYTES + WBYTES;
  static constexpr int SMEM = WB + STAGES * STAGE + 1024;   // + alignment
  static_assert(BM * BN * 4 <= STAGES * STAGE, "a K slice's partial tile "
                "reuses the stages");
};

template <int T>
__global__ void __launch_bounds__(2 * T, 256 / T)
int8_gemm_prefill(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int M, int N, int K, int ldx, int ldw, int kc,
                  int relu) {
  using G = PrefillGeo<T>;
  constexpr int P_BM = G::BM, P_BN = G::BN, P_BK = G::BK,
                P_STAGES = G::STAGES, P_XS = G::XS, P_WB = G::WB,
                P_STAGE = G::STAGE, P_XBYTES = G::XBYTES,
                P_THREADS = G::THREADS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t wb = base;   // the bf16 B tile, 32 rows x BN columns
  auto xs_u = [&](int st) { return base + P_WB + st * P_STAGE; };
  auto ws_u = [&](int st) { return xs_u(st) + P_XBYTES; };
  auto xs_p = [&](int st) {
    return reinterpret_cast<const float*>(gbase + P_WB + st * P_STAGE);
  };

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  const int n0 = blockIdx.x * P_BN, m0 = blockIdx.y * P_BM;
  const int kbeg = blockIdx.z * kc;   // this block's K slice
  const int kend = kbeg + kc < K ? kbeg + kc : K;
  const int kt_total = kend > kbeg ? (kend - kbeg + P_BK - 1) / P_BK : 0;
  const int xc = tid & 7;   // x copies: chunk xc of rows tid/8 + NT/8 i
  // w copy: row wr, 16 bytes wc (BN / 16 of them a row: one a thread)
  const int wr = tid / (P_BN / 16), wc = tid % (P_BN / 16);

  auto load = [&](int kt, int st) {
    const int k0 = kbeg + kt * P_BK;
    const bool c_ok = k0 + 4 * xc < ldx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 3) + (P_THREADS / 8) * i;
      const bool ok = c_ok && m0 + r < M;
      cp_async16(xs_u(st) + r * (P_XS * 4) + 16 * xc,
                 ok ? x + (long long)(m0 + r) * ldx + k0 + 4 * xc : x,
                 ok ? 16 : 0);
    }
    const bool ok = k0 + wr < K && n0 + 16 * wc < ldw;
    cp_async16(ws_u(st) + wr * P_BN + 16 * wc,
               ok ? w + (long long)(k0 + wr) * ldw + n0 + 16 * wc : w,
               ok ? 16 : 0);
  };

  float acc[P_BN / 2];
#pragma unroll
  for (int e = 0; e < P_BN / 2; ++e) acc[e] = 0.f;

#pragma unroll
  for (int s = 0; s < P_STAGES - 1; ++s) {
    if (s < kt_total) load(s, s);
    cp_async_commit();
  }
  const int r0 = 64 * wg + 16 * warp + (lane >> 2);   // fragment rows r0,
  const int cq = 2 * (lane & 3);                      // r0 + 8; columns
  for (int kt = 0; kt < kt_total; ++kt) {
    const int st = kt % P_STAGES;
    cp_async_wait<P_STAGES - 2>();
    __syncthreads();   // slab kt landed; everyone is done with kt - 1

    // w8 slab -> bf16 MN-major tile: this thread's 16 bytes of row wr
    {
      uint4 c0, c1;
      s8x16_to_bf16(ld_shared16(ws_u(st) + wr * P_BN + 16 * wc), c0, c1);
      st_shared16(tile_chunk<P_BN, P_BK>(wb, wr, 2 * wc), c0);
      st_shared16(tile_chunk<P_BN, P_BK>(wb, wr, 2 * wc + 1), c1);
    }
    fence_proxy_async();
    __syncthreads();
    if (kt + P_STAGES - 1 < kt_total)
      load(kt + P_STAGES - 1, (kt + P_STAGES - 1) % P_STAGES);
    cp_async_commit();

    // register-A fragments of the fp32 slab, cut into three pieces
    const float* xs = xs_p(st);
    uint32_t hi[P_BK / 16][4], mid[P_BK / 16][4], lo[P_BK / 16][4];
#pragma unroll
    for (int j = 0; j < P_BK / 16; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = r0 + 8 * (q & 1), cc = 16 * j + cq + 8 * (q >> 1);
        const float2 v = *reinterpret_cast<const float2*>(xs + r * P_XS + cc);
        split3(v.x, v.y, hi[j][q], mid[j][q], lo[j][q]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < P_BK / 16; ++j) {
      const uint64_t db = desc_mn<P_BN, P_BK>(wb, j);
      wgmma_rs<P_BN>(acc, lo[j], db);
      wgmma_rs<P_BN>(acc, mid[j], db);
      wgmma_rs<P_BN>(acc, hi[j], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<P_BN / 2>(acc);
    fence_frag<4 * P_BK / 16>(&hi[0][0]);
    fence_frag<4 * P_BK / 16>(&mid[0][0]);
    fence_frag<4 * P_BK / 16>(&lo[0][0]);
  }
  cp_async_wait<0>();

  if (gridDim.z == 1) {   // K whole: the epilogue from the registers
#pragma unroll
    for (int e = 0; e < P_BN / 2; ++e) {
      const int m = m0 + 64 * wg + acc_row(lane, warp, e);
      const int n = n0 + acc_col(lane, e);
      if (m < M && n < N)
        out[(long long)m * N + n] = epilogue(acc[e], scale, bias, n, relu);
    }
    return;
  }
  // K split over the cluster: this slice's tile into the stages' memory
  __syncthreads();   // no thread still reads a stage
  float* part = reinterpret_cast<float*>(gbase + P_WB);
#pragma unroll
  for (int e = 0; e < P_BN / 2; ++e)
    part[(64 * wg + acc_row(lane, warp, e)) * P_BN + acc_col(lane, e)] =
        acc[e];
  cluster_reduce_store<false>(part, P_BM, P_BN, m0, n0, M, N, out, scale,
                              bias, relu);
}

// ---------------------------------------------------------------------------
// decode instance, M <= 16: out^T = w8^T x^T, K split over a cluster
// ---------------------------------------------------------------------------

constexpr int D_THREADS = 128;          // one warpgroup
constexpr int D_BN = 64;                // output columns a block (wgmma M)
constexpr int D_BK = 64, D_STAGES = 4;
constexpr int MAX_CLUSTER = 8;          // the portable cluster size

template <int NW>
struct DecodeSmem {
  static constexpr int A = D_BK * D_BN * 2;        // w8^T bf16, Geo<64>
  static constexpr int PIECE = NW * D_BK * 2;      // one x piece, Geo<64>
  static constexpr int WRAW = D_BK * D_BN;         // int8 as it came
  static constexpr int XRAW = NW * D_BK * 4;       // fp32 as it came
  static constexpr int STAGE = WRAW + XRAW;
  static constexpr int PART = D_BN * NW * 4;       // the partial sums
  static constexpr int bytes = A + 3 * PIECE + D_STAGES * STAGE + PART + 1024;
};

template <int NW>
__global__ void __launch_bounds__(D_THREADS)
int8_gemm_decode(const float* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int M, int N, int K, int ldx, int ldw, int kc, int relu) {
  using SM = DecodeSmem<NW>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t at = base;   // A: 64 rows (k) x 64 columns (n)
  auto piece = [&](int p) { return base + SM::A + p * SM::PIECE; };
  const int stage0 = SM::A + 3 * SM::PIECE;
  auto wraw = [&](int st) { return base + stage0 + st * SM::STAGE; };
  auto xraw = [&](int st) { return wraw(st) + SM::WRAW; };
  float* part = reinterpret_cast<float*>(gbase + stage0 +
                                         D_STAGES * SM::STAGE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * D_BN;
  const int kbeg = blockIdx.y * kc;
  const int kend = kbeg + kc < K ? kbeg + kc : K;
  const int kt_total = kend > kbeg ? (kend - kbeg + D_BK - 1) / D_BK : 0;

  auto load = [&](int kt, int st) {
    const int k0 = kbeg + kt * D_BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // w8: 64 rows x 4 chunks
      const int e = tid + D_THREADS * i, r = e >> 2, c = e & 3;
      const bool ok = k0 + r < K && n0 + 16 * c < ldw;
      cp_async16(wraw(st) + r * D_BN + 16 * c,
                 ok ? w + (long long)(k0 + r) * ldw + n0 + 16 * c : w,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < NW * 16 / D_THREADS; ++i) {   // x: NW rows x 16
      const int e = tid + D_THREADS * i, r = e >> 4, c = e & 15;
      const bool ok = r < M && k0 + 4 * c < ldx;
      cp_async16(xraw(st) + r * (D_BK * 4) + 16 * c,
                 ok ? x + (long long)r * ldx + k0 + 4 * c : x, ok ? 16 : 0);
    }
  };

  float acc[NW / 2];
#pragma unroll
  for (int e = 0; e < NW / 2; ++e) acc[e] = 0.f;

#pragma unroll
  for (int s = 0; s < D_STAGES - 1; ++s) {
    if (s < kt_total) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_total; ++kt) {
    const int st = kt % D_STAGES;
    cp_async_wait<D_STAGES - 2>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // w8 -> bf16 A tile
      const int e = tid + D_THREADS * i, r = e >> 2, c = e & 3;
      uint4 c0, c1;
      s8x16_to_bf16(ld_shared16(wraw(st) + r * D_BN + 16 * c), c0, c1);
      st_shared16(tile_chunk<D_BK, D_BK>(at, r, 2 * c), c0);
      st_shared16(tile_chunk<D_BK, D_BK>(at, r, 2 * c + 1), c1);
    }
    if (tid < NW * 8) {   // x -> three bf16 pieces, 8 values a thread
      const int r = tid >> 3, c = tid & 7;
      const float* src = reinterpret_cast<const float*>(
          gbase + (xraw(st) - base) + r * (D_BK * 4) + 32 * c);
      const float4 a = reinterpret_cast<const float4*>(src)[0];
      const float4 b = reinterpret_cast<const float4*>(src)[1];
      uint4 h, m, l;
      split3(a.x, a.y, h.x, m.x, l.x);
      split3(a.z, a.w, h.y, m.y, l.y);
      split3(b.x, b.y, h.z, m.z, l.z);
      split3(b.z, b.w, h.w, m.w, l.w);
      st_shared16(tile_chunk<D_BK, NW>(piece(0), r, c), l);
      st_shared16(tile_chunk<D_BK, NW>(piece(1), r, c), m);
      st_shared16(tile_chunk<D_BK, NW>(piece(2), r, c), h);
    }
    fence_proxy_async();
    __syncthreads();
    if (kt + D_STAGES - 1 < kt_total)
      load(kt + D_STAGES - 1, (kt + D_STAGES - 1) % D_STAGES);
    cp_async_commit();

    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D_BK / 16; ++j) {
      const uint64_t da = desc_mn<D_BK, D_BK>(at, j);
#pragma unroll
      for (int p = 0; p < 3; ++p)   // lo, mid, hi
        wgmma_ss_ta<NW>(acc, da, desc_k<D_BK, NW>(piece(p), 0, j), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<NW / 2>(acc);
  }
  cp_async_wait<0>();

  // this block's partial sums: row = output column n0 + i, column = row m
#pragma unroll
  for (int e = 0; e < NW / 2; ++e)
    part[acc_row(lane, warp, e) * NW + acc_col(lane, e)] = acc[e];

  // the cluster's K slices, added in rank order, then the epilogue
  cluster_reduce_store<true>(part, D_BN, NW, 0, n0, M, N, out, scale, bias,
                             relu);
}

template <typename F>
int set_smem(F* kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc == cudaSuccess) done = true;
  return (int)rc;
}

// a launch whose K slices (grid dimension `axis`, ksplit of them) form
// one thread-block cluster
template <typename... Args, typename... Act>
int launch_split(void (*kernel)(Args...), dim3 grid, int threads, int smem,
                 int ksplit, int axis, cudaStream_t stream, Act... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = axis == 1 ? ksplit : 1;
  at[0].val.clusterDim.z = axis == 2 ? ksplit : 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int NW>
int launch_decode(const float* x, const int8_t* w, const float* scale,
                  const float* bias, float* out, int M, int N, int K, int ldx,
                  int ldw, int ksplit, int kc, int relu,
                  cudaStream_t stream) {
  static bool attr = false;
  const int smem = DecodeSmem<NW>::bytes;
  if (int rc = set_smem(int8_gemm_decode<NW>, smem, attr)) return rc;
  return launch_split(int8_gemm_decode<NW>,
                      dim3((N + D_BN - 1) / D_BN, ksplit, 1), D_THREADS,
                      smem, ksplit, 1, stream, x, w, scale, bias, out, M, N,
                      K, ldx, ldw, kc, relu);
}

template <int T>
int launch_prefill(const float* x, const int8_t* w, const float* scale,
                   const float* bias, float* out, int M, int N, int K,
                   int ldx, int ldw, int ksplit, int kc, int relu,
                   cudaStream_t stream) {
  using G = PrefillGeo<T>;
  static bool attr = false;
  if (int rc = set_smem(int8_gemm_prefill<T>, G::SMEM, attr)) return rc;
  return launch_split(int8_gemm_prefill<T>,
                      dim3((N + G::BN - 1) / G::BN, (M + G::BM - 1) / G::BM,
                           ksplit),
                      G::THREADS, G::SMEM, ksplit, 2, stream, x, w, scale,
                      bias, out, M, N, K, ldx, ldw, kc, relu);
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success).
// K is split into ksplit slices of kc rows (ksplit <= 8, the slices
// covering K exactly, kc a multiple of the instance's slab). M <= 16 runs
// the decode instance (tile = 64, kc a multiple of 64); M > 16 the
// prefill instance on tile x tile output tiles (tile 64, or 128 with
// ksplit = 1; kc a multiple of 32). ldx (x's row length, a multiple of 4 at
// least K) and ldw (w8's, a multiple of 16 at least N) let the wrapper
// pad ragged shapes; x and w8 16-byte aligned. kernels/int8_gemm.py's
// plan() picks (tile, ksplit, kc).
extern "C" int pt_int8_gemm(const float* x, const int8_t* w,
                            const float* scale, const float* bias,
                            float* out, int M, int N, int K, int ldx,
                            int ldw, int tile, int ksplit, int kc, int relu,
                            cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0 || ldx % 4 != 0 || ldx < K || ldw % 16 != 0 || ldw < N ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) %
              16 != 0)
    return (int)cudaErrorInvalidValue;
  // the slices cover K, none of them empty (K = 0: one slice); a prefill
  // slice is a whole number of 32-deep slabs, a decode one of 64-deep
  const int slab = M > 16 ? 32 : D_BK;
  if (ksplit < 1 || ksplit > MAX_CLUSTER || kc <= 0 || kc % slab != 0 ||
      (long long)ksplit * kc < K ||
      (long long)(ksplit - 1) * kc >= (K > 0 ? K : 1))
    return (int)cudaErrorInvalidValue;
  int rc;
  if (M > 16) {
    if (tile != 64 && !(tile == 128 && ksplit == 1))
      return (int)cudaErrorInvalidValue;
    rc = tile == 128 ? launch_prefill<128>(x, w, scale, bias, out, M, N, K,
                                           ldx, ldw, 1, kc, relu, stream)
                     : launch_prefill<64>(x, w, scale, bias, out, M, N, K,
                                          ldx, ldw, ksplit, kc, relu, stream);
  } else {
    if (tile != D_BN) return (int)cudaErrorInvalidValue;
    rc = M <= 8 ? launch_decode<8>(x, w, scale, bias, out, M, N, K, ldx, ldw,
                                   ksplit, kc, relu, stream)
                : launch_decode<16>(x, w, scale, bias, out, M, N, K, ldx,
                                    ldw, ksplit, kc, relu, stream);
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
