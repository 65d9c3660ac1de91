// Flash-attention backward from the saved forward (out, lse), for Hopper
// (sm_90a). With s = q k^T * scale + bias (causally hidden keys excluded),
// p = exp(s - lse) and the dropout multiplier mask = keep / (1 - rate) (1
// without dropout):
//     delta[b,h,q] = sum_d do * o
//     dv = (p * mask)^T do            dp = (do v^T) * mask
//     ds = p * (dp - delta)           dbias[b,k] = sum over heads and q of ds
//     dq = (ds * scale) k             dk = (ds * scale)^T q
// q/k/v/o/do and dq/dk/dv are fp32 or bf16 in any layout with head_dim
// contiguous, read and written in place through explicit element strides
// per operand, (batch, row, head): the packed [B, S, H*HD] layout is
// (S*H*HD, H*HD, HD), [B, H, S, HD] ("bnsd") is (H*S*HD, HD, S*HD). lse
// [B, H, Sq] and bias [B, Sk] are fp32 and contiguous; dq/dk/dv are
// written in the input type, dbias in fp32. The mask is recomputed from
// (seed, b*H + h, q, k) exactly as the forward computes it
// (flash_attention_fwd.cu), never stored.
//
// Replaces the backward kernels of paddle_tpu/ops/pallas/flash_attention.py,
// which all compute this one function:
//   _packed_bwd_kernel :984   packed single-block route (S <= 512)
//   _fused_bwd_kernel :748    single-block [B*H, S, D], 256 <= S <= 512
//   _fused_bwd_kernel_g :860  the same with g heads a cell, S < 256
//   _dkv_kernel :634          2-pass route at S >= 1024: dk, dv, dbias
//   _dq_kernel :701           2-pass route at S >= 1024: dq
// The TPU's single-block kernels hold whole [S, D] blocks and the S x S
// tile in VMEM and exist only where that fits; above it the TPU splits the
// work into the dk/dv pass and the dq pass. Here the split is the design
// at every length: a dkv pass (the counterpart of _dkv_kernel) and a dq
// pass (of _dq_kernel), both tiled over both sequence axes, reading either
// layout through strides. The long-context step runs them on the packed
// projections in place where the reference transposes to [B, H, S, D]
// first (_packed_to_bnsd :1576). Every output element is written once, by
// the block that owns it, after a sum in a fixed order: no atomics, so
// the result is the same from run to run and the same in either layout on
// the same values. Computing s and dp in both passes (7 products for the
// function's 5) is the price. Each dtype has its own instances; both run
// delta_kernel (one warp per (b, h, q) row) first and dbias_kernel (the
// per-head sums added over heads in order) last.
//
// bf16: tensor cores (dkv_tc, dq_tc). The reference's kernels multiply in
// the input dtype on the MXU with fp32 accumulation, rounding p * mask to
// bf16 before dv (flash_attention.py:678, :787) and ds * scale before dq
// and dk (:689, :740, :796). Here the products are wgmma.mma_async
// m64nNk16 with bf16 operands and fp32 accumulators, and each of those
// two enters its products as two bf16 terms, hi (the reference's operand)
// and lo = bf16(x - hi): hi alone leaves dq, dk and dv up to 2 bf16 ulps
// from the fp32 function (outside the one-ulp gate the kernel is held
// to); hi + lo carries 16 significant bits. dq, dk and dv are rounded to
// bf16 once, at the end.
//  * Bound: the 5 products, 10 * Sq * Sk * HD flops a head, on the tensor
//    cores (989 TFLOP/s dense bf16; 7 products as the two passes compute
//    them, 10 with the lo terms): operations, not bytes. Beside them, per
//    score and in both passes, one MUFU exp2 (log2 e folded into the scale
//    and into lse) and, with dropout, one splitmix32 hash on the integer
//    pipe; as in the forward, that CUDA-core work sets the pace (PERF.md,
//    tools/profile_flash.py).
//  * dkv_tc: one block, one warpgroup (128 threads), per (64-key tile,
//    head, batch). k and v stay resident in shared memory; q, do, lse and
//    delta tiles of BQ rows (64; 32 at HD = 128, for registers) stream
//    through two cp.async stages. Per q tile: s^T = k q^T and dp^T = v
//    do^T (A = k or v, B = q or do, all K-major); p^T = exp2(s^T - lse)
//    on the accumulator fragment; dv += (p^T * mask) do and dk += (ds^T *
//    scale) q with A from registers (the accumulator fragments as bf16 hi
//    and lo) and B = do or q read MN-major with the transpose bit. dk and
//    dv stay in registers over the whole q loop; the per-head dbias of
//    each key is its thread's running row sum of ds^T, added across the
//    quad of lanes at the end, in a fixed order.
//  * dq_tc: one warpgroup a block per (64-row q tile, head, batch); q,
//    do, lse and delta resident, k/v tiles of 64 keys (and their bias)
//    streaming through two stages. s = q k^T, dp = do v^T, p, ds, then dq
//    += (ds * scale) k over hi and lo with k read MN-major. Under the
//    causal mask both passes skip tiles wholly above the diagonal and mask
//    per element only on tiles that cross it or a ragged end.
//  * One warpgroup a block, not two as in the forward: blocks on an SM
//    then drift apart, so one block's exps run under another's products;
//    two warpgroups a block meet at every tile's block barrier, and ran
//    slower on the card (PERF.md).
//
// fp32: CUDA cores (dkv_kernel, dq_kernel). A tensor-core fp32 product
// would be TF32, so fp32 stays on the FMA pipes: one block of 256 threads
// per 64-key (dkv) or 64-row (dq) tile, each thread a 4 x 4 patch of the
// score tile and a 4 x HD/16 patch of its accumulators, p and ds staged in
// shared memory between the products, all in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_tc.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;

// element strides of one operand: batch, row (sequence position), head
struct Layout {
  long long b, r, h;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ unsigned splitmix32(unsigned x) {
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// the per-(b, h) hash key of the dropout mask, seed2 * golden
__device__ __forceinline__ unsigned mask_key(int b, int h, int H,
                                             unsigned seed) {
  return splitmix32((unsigned)(b * H + h) ^ (seed * 0x9E3779B9u)) *
         0x9E3779B9u;
}

// rows [0, BQ) of a tile starting at row r0 (zeros past `rows`) into
// shared memory [BQ][HD + 1]
template <int HD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long rstride, int r0,
                                          int rows) {
  constexpr int V4 = HD / 4;
  for (int e = threadIdx.x; e < BQ * V4; e += THREADS) {
    const int r = e / V4, c = (e % V4) * 4;
    float4 x4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows) x4 = load4(base + (r0 + r) * rstride + c);
    float* d = dst + r * (HD + 1) + c;
    d[0] = x4.x; d[1] = x4.y; d[2] = x4.z; d[3] = x4.w;
  }
}

// delta[b, h, q] = sum_d do[b, h, q, d] * o[b, h, q, d]
template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ dout, const T* __restrict__ out,
             float* __restrict__ delta, Layout ldo, Layout lo, int B, int Sq,
             int H) {
  const int warp = (blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= B * H * Sq) return;
  const int qi = warp % Sq, h = (warp / Sq) % H, b = warp / (Sq * H);
  float acc = 0.f;
  if (lane * 4 < HD) {
    const float4 a = load4(dout + b * ldo.b + qi * ldo.r + h * ldo.h +
                           lane * 4);
    const float4 c = load4(out + b * lo.b + qi * lo.r + h * lo.h + lane * 4);
    acc = a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[((size_t)b * H + h) * Sq + qi] = acc;
}

template <int HD>
struct Smem {
  static constexpr int TILE = BQ * (HD + 1);      // BQ == BK
  static constexpr int SS = BQ * (BK + 1);
  static constexpr size_t dkv =
      sizeof(float) * ((size_t)4 * TILE + 2 * SS + 2 * BQ + 16 * BK);
  static constexpr size_t dq =
      sizeof(float) * ((size_t)4 * TILE + SS + 2 * BQ);
};

// s = q k^T and dp = do v^T on a thread's 4 x 4 patch, rows ty + 16 i of
// (qs, dos), cols tx + 16 j of (ks, vs)
template <int HD>
__device__ __forceinline__ void scores(const float* qs, const float* dos,
                                       const float* ks, const float* vs,
                                       int tx, int ty, float sacc[4][4],
                                       float dpacc[4][4]) {
  constexpr int LD = HD + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sacc[i][j] = dpacc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[4], g[4], bk[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = qs[(ty + 16 * i) * LD + d];
      g[i] = dos[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bk[j] = ks[(tx + 16 * j) * LD + d];
      bv[j] = vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sacc[i][j] = fmaf(a[i], bk[j], sacc[i][j]);
        dpacc[i][j] = fmaf(g[i], bv[j], dpacc[i][j]);
      }
  }
}

// dk, dv and the per-head dbias of one 64-key tile
template <int HD, typename T, bool DROP>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const float* __restrict__ bias, T* __restrict__ dk,
           T* __restrict__ dv, float* __restrict__ dbias_h, Layout lq,
           Layout lk, Layout lv, Layout ldo, Layout ldk, Layout ldv, int Sq,
           int Sk, int H, float scale, int causal, unsigned seed,
           unsigned thresh, float inv_keep) {
  constexpr int DJ = HD / 16;   // head-dim columns per thread
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* ks = smem;                       // [BK][HD + 1]
  float* vs = ks + Smem<HD>::TILE;        // [BK][HD + 1]
  float* qs = vs + Smem<HD>::TILE;        // [BQ][HD + 1]
  float* dos = qs + Smem<HD>::TILE;       // [BQ][HD + 1]
  float* ps = dos + Smem<HD>::TILE;       // [BQ][BK + 1]  p * mask
  float* dss = ps + Smem<HD>::SS;         // [BQ][BK + 1]  ds * scale
  float* lse_s = dss + Smem<HD>::SS;      // [BQ]
  float* dl_s = lse_s + BQ;               // [BQ]
  float* db_s = dl_s + BQ;                // [16][BK] dbias partials

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int shift = Sk - Sq;
  const T* qb = q + b * lq.b + h * lq.h;
  const T* dob = dout + b * ldo.b + h * ldo.h;
  const float* lseb = lse + ((size_t)b * H + h) * Sq;
  const float* deltab = delta + ((size_t)b * H + h) * Sq;
  const unsigned seed2m = DROP ? mask_key(b, h, H, seed) : 0u;

  load_tile<HD>(ks, k + b * lk.b + h * lk.h, lk.r, k0, Sk);
  load_tile<HD>(vs, v + b * lv.b + h * lv.h, lv.r, k0, Sk);

  // key biases of this thread's 4 columns (tx + 16 j)
  float bcol[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gc = k0 + tx + 16 * j;
    bcol[j] = (bias != nullptr && gc < Sk) ? bias[(size_t)b * Sk + gc] : 0.f;
  }

  float dk_acc[4][DJ], dv_acc[4][DJ], db_acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    db_acc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }

  // under the causal mask, rows r < k0 - shift see no key of this tile
  int qstart = 0;
  if (causal && k0 - shift > 0) qstart = ((k0 - shift) / BQ) * BQ;

  for (int q0 = qstart; q0 < Sq; q0 += BQ) {
    __syncthreads();   // previous q tile fully consumed
    load_tile<HD>(qs, qb, lq.r, q0, Sq);
    load_tile<HD>(dos, dob, ldo.r, q0, Sq);
    if (tid < BQ) {
      const bool ok = q0 + tid < Sq;
      lse_s[tid] = ok ? lseb[q0 + tid] : 0.f;
      dl_s[tid] = ok ? deltab[q0 + tid] : 0.f;
    }
    __syncthreads();

    float sacc[4][4], dpacc[4][4];
    scores<HD>(qs, dos, ks, vs, tx, ty, sacc, dpacc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int gr = q0 + row;
      const float lse_r = lse_s[row], dl_r = dl_s[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const int gc = k0 + col;
        const bool ok =
            gr < Sq && gc < Sk && (!causal || gc <= gr + shift);
        const float p =
            ok ? expf(sacc[i][j] * scale + bcol[j] - lse_r) : 0.f;
        float mult = 1.f;
        if (DROP) {
          const unsigned lin = (unsigned)gr * (unsigned)Sk + (unsigned)gc;
          mult = splitmix32(lin ^ seed2m) >= thresh ? inv_keep : 0.f;
        }
        const float ds = p * (dpacc[i][j] * mult - dl_r);
        db_acc[j] += ds;
        ps[row * (BK + 1) + col] = p * mult;
        dss[row * (BK + 1) + col] = ds * scale;
      }
    }
    __syncthreads();

    // dv += (p mask)^T do, dk += (ds scale)^T q : keys ty + 16 i, dims
    // tx + 16 j
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pv[4], dsv[4], dov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[qq * (BK + 1) + ty + 16 * i];
        dsv[i] = dss[qq * (BK + 1) + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dov[j] = dos[qq * LD + tx + 16 * j];
        qv[j] = qs[qq * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
        }
    }
  }

  T* dkb = dk + b * ldk.b + h * ldk.h;
  T* dvb = dv + b * ldv.b + h * ldv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gk = k0 + ty + 16 * i;
    if (gk >= Sk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      store1(dkb + gk * ldk.r + tx + 16 * j, dk_acc[i][j]);
      store1(dvb + gk * ldv.r + tx + 16 * j, dv_acc[i][j]);
    }
  }

  if (dbias_h != nullptr) {
    // this thread's partial sums are of columns tx + 16 j over its rows;
    // add the 16 row groups (ty) in order through shared memory
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) db_s[ty * BK + tx + 16 * j] = db_acc[j];
    __syncthreads();
    if (tid < BK && k0 + tid < Sk) {
      float tot = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) tot += db_s[r * BK + tid];
      dbias_h[((size_t)b * H + h) * Sk + k0 + tid] = tot;
    }
  }
}

// dq of one 64-row q tile
template <int HD, typename T, bool DROP>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const float* __restrict__ bias, T* __restrict__ dq, Layout lq,
          Layout lk, Layout lv, Layout ldo, Layout ldq, int Sq, int Sk, int H,
          float scale, int causal, unsigned seed, unsigned thresh,
          float inv_keep) {
  constexpr int DJ = HD / 16;
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* qs = smem;                       // [BQ][HD + 1]
  float* dos = qs + Smem<HD>::TILE;       // [BQ][HD + 1]
  float* ks = dos + Smem<HD>::TILE;       // [BK][HD + 1]
  float* vs = ks + Smem<HD>::TILE;        // [BK][HD + 1]
  float* dss = vs + Smem<HD>::TILE;       // [BQ][BK + 1]  ds * scale
  float* lse_s = dss + Smem<HD>::SS;      // [BQ]
  float* dl_s = lse_s + BQ;               // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int shift = Sk - Sq;
  const T* kb = k + b * lk.b + h * lk.h;
  const T* vb = v + b * lv.b + h * lv.h;
  const unsigned seed2m = DROP ? mask_key(b, h, H, seed) : 0u;

  load_tile<HD>(qs, q + b * lq.b + h * lq.h, lq.r, q0, Sq);
  load_tile<HD>(dos, dout + b * ldo.b + h * ldo.h, ldo.r, q0, Sq);
  if (tid < BQ) {
    const bool ok = q0 + tid < Sq;
    const size_t row = ((size_t)b * H + h) * Sq + q0 + tid;
    lse_s[tid] = ok ? lse[row] : 0.f;
    dl_s[tid] = ok ? delta[row] : 0.f;
  }

  float dq_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq_acc[i][j] = 0.f;

  // keys [0, kend) are visible to some row of this tile
  const int last_row = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
  int kend = Sk;
  if (causal) {
    const int lim = last_row + shift + 1;
    kend = lim < Sk ? lim : Sk;
  }

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();   // previous key tile and dss fully consumed
    load_tile<HD>(ks, kb, lk.r, k0, Sk);
    load_tile<HD>(vs, vb, lv.r, k0, Sk);
    __syncthreads();

    float bcol[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = k0 + tx + 16 * j;
      bcol[j] = (bias != nullptr && gc < Sk) ? bias[(size_t)b * Sk + gc]
                                             : 0.f;
    }
    float sacc[4][4], dpacc[4][4];
    scores<HD>(qs, dos, ks, vs, tx, ty, sacc, dpacc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int gr = q0 + row;
      const float lse_r = lse_s[row], dl_r = dl_s[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const int gc = k0 + col;
        const bool ok =
            gr < Sq && gc < Sk && (!causal || gc <= gr + shift);
        const float p =
            ok ? expf(sacc[i][j] * scale + bcol[j] - lse_r) : 0.f;
        float mult = 1.f;
        if (DROP) {
          const unsigned lin = (unsigned)gr * (unsigned)Sk + (unsigned)gc;
          mult = splitmix32(lin ^ seed2m) >= thresh ? inv_keep : 0.f;
        }
        dss[row * (BK + 1) + col] = p * (dpacc[i][j] * mult - dl_r) * scale;
      }
    }
    __syncthreads();

    // dq += (ds scale) k : rows ty + 16 i, dims tx + 16 j
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = ks[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j)
          dq_acc[i][j] = fmaf(dsv[i], kv[j], dq_acc[i][j]);
    }
  }

  T* dqb = dq + b * ldq.b + h * ldq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty + 16 * i;
    if (gr >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      store1(dqb + gr * ldq.r + tx + 16 * j, dq_acc[i][j]);
  }
}

// dbias[b, k] = sum over h, in order, of dbias_h[b, h, k]
__global__ void __launch_bounds__(THREADS)
dbias_kernel(const float* __restrict__ dbias_h, float* __restrict__ dbias,
             int B, int Sk, int H) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= B * Sk) return;
  const int b = e / Sk, c = e % Sk;
  float acc = 0.f;
  for (int h = 0; h < H; ++h) acc += dbias_h[((size_t)b * H + h) * Sk + c];
  dbias[e] = acc;
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;   // one warpgroup a block
constexpr int TC_KEYS = 64;    // dkv_tc: keys a block
constexpr int TC_ROWS = 64;    // dq_tc: q rows a block
constexpr int TC_BN = 64;      // dq_tc: keys a streamed tile

template <int HD>
struct TcDkv {
  static constexpr int BQ = HD == 128 ? 32 : 64;  // q rows a streamed tile
  static constexpr int KV = TC_KEYS * HD * 2;     // the k (or v) tile
  static constexpr int T = BQ * HD * 2;           // a q (or do) tile
  // a stage: the q tile, the do tile, lse * log2 e and delta (BQ each)
  static constexpr int STAGE = 2 * T + 1024;
  static constexpr size_t bytes = 1024 + 2 * KV + 2 * STAGE;  // + alignment
};

template <int HD>
struct TcDq {
  static constexpr int Q = TC_ROWS * HD * 2;   // the q (or do) tile
  static constexpr int KV = TC_BN * HD * 2;    // a k (or v) tile
  // a stage: the k tile, the v tile, the tile's key bias (times log2 e)
  static constexpr int STAGE = 2 * KV + 1024;
  static constexpr size_t bytes = 1024 + 2 * Q + 2 * STAGE;
};

// dk, dv and the per-head dbias of one 64-key tile
template <int HD, bool DROP>
__global__ void __launch_bounds__(TC_THREADS, 2)
dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
       const bf16* __restrict__ v, const bf16* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       const float* __restrict__ bias, bf16* __restrict__ dk,
       bf16* __restrict__ dv, float* __restrict__ dbias_h, tc::Strides lq,
       tc::Strides lk, tc::Strides lv, tc::Strides ldo, tc::Strides ldk,
       tc::Strides ldv, int Sq, int Sk, int H, float scale, int causal,
       unsigned seed, unsigned thresh, float inv_keep) {
  using namespace tc;
  using SM = TcDkv<HD>;
  constexpr int BQ = SM::BQ, BK = TC_KEYS, NT = TC_THREADS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // tiles 1024-aligned
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sk = base, sv = base + SM::KV;
  auto sq = [&](int st) { return base + 2 * SM::KV + st * SM::STAGE; };
  auto sdo = [&](int st) { return sq(st) + SM::T; };
  auto slse = [&](int st) {
    return reinterpret_cast<float*>(gbase + 2 * SM::KV + st * SM::STAGE +
                                    2 * SM::T);
  };
  auto sdl = [&](int st) { return slse(st) + BQ; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int shift = Sk - Sq;
  const bf16* qb = q + b * lq.b + h * lq.h;
  const bf16* dob = dout + b * ldo.b + h * ldo.h;
  const float* lseb = lse + ((size_t)b * H + h) * Sq;
  const float* deltab = delta + ((size_t)b * H + h) * Sq;
  const unsigned seed2m = DROP ? tc::mask_key(b, h, H, seed) : 0u;
  // the keys of this thread's accumulator rows, and their bias * log2 e
  const int kr[2] = {k0 + acc_row(lane, warp, 0), k0 + acc_row(lane, warp, 2)};
  float kbias[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    kbias[i] = bias != nullptr && kr[i] < Sk
                   ? bias[(size_t)b * Sk + kr[i]] * LOG2E
                   : 0.f;

  // under the causal mask, rows r < k0 - shift see no key of this tile
  int qstart = 0;
  if (causal && k0 - shift > 0) qstart = ((k0 - shift) / BQ) * BQ;
  const int ntiles = qstart < Sq ? (Sq - qstart + BQ - 1) / BQ : 0;

  auto load_q = [&](int t, int st) {
    const int q0 = qstart + t * BQ;
    tc::load_tile<HD, BQ, NT>(sq(st), qb, lq.r, q0, Sq, tid);
    tc::load_tile<HD, BQ, NT>(sdo(st), dob, ldo.r, q0, Sq, tid);
    if (tid < BQ) {
      const bool ok = q0 + tid < Sq;
      slse(st)[tid] = ok ? lseb[q0 + tid] * LOG2E : 0.f;
      sdl(st)[tid] = ok ? deltab[q0 + tid] : 0.f;
    }
  };

  tc::load_tile<HD, BK, NT>(sk, k + b * lk.b + h * lk.h, lk.r, k0, Sk, tid);
  tc::load_tile<HD, BK, NT>(sv, v + b * lv.b + h * lv.h, lv.r, k0, Sk, tid);
  if (ntiles > 0) load_q(0, 0);
  cp_async_commit();

  float dka[HD / 2], dva[HD / 2], db[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) dka[e] = dva[e] = 0.f;
  const float sl2 = scale * LOG2E;

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1, q0 = qstart + t * BQ;
    if (t + 1 < ntiles) {
      load_q(t + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    // s^T = k q^T and dp^T = v do^T on the block's 64 keys
    float sT[BQ / 2], dpT[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      wgmma_ss<BQ>(sT, desc_k<HD, BK>(sk, 0, j),
                   desc_k<HD, BQ>(sq(st), 0, j), j);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      wgmma_ss<BQ>(dpT, desc_k<HD, BK>(sv, 0, j),
                   desc_k<HD, BQ>(sdo(st), 0, j), j);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<BQ / 2>(sT);
    fence_acc<BQ / 2>(dpT);

    const float* ls = slse(st);
    const float* dl = sdl(st);
    const bool full = q0 + BQ <= Sq && k0 + BK <= Sk &&
                      (!causal || k0 + BK - 1 <= q0 + shift);
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) {
      const int c = acc_col(lane, e), i = (e >> 1) & 1, qi = q0 + c;
      float p = exp2f(fmaf(sT[e], sl2, kbias[i]) - ls[c]);
      if (!full && (qi >= Sq || kr[i] >= Sk || (causal && kr[i] > qi + shift)))
        p = 0.f;
      float mult = 1.f;
      if (DROP) mult = keep(seed2m, qi, kr[i], Sk, thresh) ? inv_keep : 0.f;
      const float ds = p * (dpT[e] * mult - dl[c]);
      db[i] += ds;
      sT[e] = p * mult;
      dpT[e] = ds * scale;
    }
    // bf16 hi + lo A fragments of p mask and ds scale
    uint32_t ph[BQ / 16][4], pl[BQ / 16][4], dh[BQ / 16][4], dlo[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) a_frag2(ph[j], pl[j], sT, j);
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) a_frag2(dh[j], dlo[j], dpT, j);

    // dv += (p mask)^T do, dk += (ds scale)^T q, each over hi and lo
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      wgmma_rs<HD>(dva, ph[j], desc_mn<HD, BQ>(sdo(st), j));
      wgmma_rs<HD>(dva, pl[j], desc_mn<HD, BQ>(sdo(st), j));
    }
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      wgmma_rs<HD>(dka, dh[j], desc_mn<HD, BQ>(sq(st), j));
      wgmma_rs<HD>(dka, dlo[j], desc_mn<HD, BQ>(sq(st), j));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<HD / 2>(dva);
    fence_acc<HD / 2>(dka);
    fence_frag<BQ / 4>(&ph[0][0]);
    fence_frag<BQ / 4>(&pl[0][0]);
    fence_frag<BQ / 4>(&dh[0][0]);
    fence_frag<BQ / 4>(&dlo[0][0]);
    __syncthreads();   // the stage is refilled at the top of the next tile
  }
  cp_async_wait<0>();

  bf16* dkb = dk + b * ldk.b + h * ldk.h;
  bf16* dvb = dv + b * ldv.b + h * ldv.h;
#pragma unroll
  for (int e = 0; e < HD / 2; e += 2) {
    const int i = (e >> 1) & 1, c = acc_col(lane, e);
    if (kr[i] < Sk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + kr[i] * ldk.r + c) =
          __floats2bfloat162_rn(dka[e], dka[e + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + kr[i] * ldv.r + c) =
          __floats2bfloat162_rn(dva[e], dva[e + 1]);
    }
  }
  if (dbias_h != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      db[i] += __shfl_xor_sync(0xffffffffu, db[i], 1);
      db[i] += __shfl_xor_sync(0xffffffffu, db[i], 2);
      if ((lane & 3) == 0 && kr[i] < Sk)
        dbias_h[((size_t)b * H + h) * Sk + kr[i]] = db[i];
    }
  }
}

// dq of one 64-row q tile
template <int HD, bool DROP>
__global__ void __launch_bounds__(TC_THREADS, HD == 128 ? 2 : 3)
dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
      const bf16* __restrict__ v, const bf16* __restrict__ dout,
      const float* __restrict__ lse, const float* __restrict__ delta,
      const float* __restrict__ bias, bf16* __restrict__ dq, tc::Strides lq,
      tc::Strides lk, tc::Strides lv, tc::Strides ldo, tc::Strides ldq,
      int Sq, int Sk, int H, float scale, int causal, unsigned seed,
      unsigned thresh, float inv_keep) {
  using namespace tc;
  using SM = TcDq<HD>;
  constexpr int BM = TC_ROWS, BN = TC_BN, NT = TC_THREADS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sq = base, sdo = base + SM::Q;
  auto sk = [&](int st) { return base + 2 * SM::Q + st * SM::STAGE; };
  auto sv = [&](int st) { return sk(st) + SM::KV; };
  auto sb = [&](int st) {
    return reinterpret_cast<float*>(gbase + 2 * SM::Q + st * SM::STAGE +
                                    2 * SM::KV);
  };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int shift = Sk - Sq;
  const bf16* kb = k + b * lk.b + h * lk.h;
  const bf16* vb = v + b * lv.b + h * lv.h;
  const float* biasb = bias != nullptr ? bias + (size_t)b * Sk : nullptr;
  const unsigned seed2m = DROP ? tc::mask_key(b, h, H, seed) : 0u;
  const int row[2] = {q0 + acc_row(lane, warp, 0), q0 + acc_row(lane, warp, 2)};
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t at = ((size_t)b * H + h) * Sq + row[i];
    lse2[i] = row[i] < Sq ? lse[at] * LOG2E : 0.f;
    dl[i] = row[i] < Sq ? delta[at] : 0.f;
  }

  const int kend = key_end(q0, BM, Sq, Sk, causal);
  const int ntiles = kend > 0 ? (kend + BN - 1) / BN : 0;
  auto load_kv = [&](int t, int st) {
    tc::load_kv<HD, BN, NT>(sk(st), sv(st), sb(st), kb, lk.r, vb, lv.r, biasb,
                            t * BN, Sk, tid);
  };

  tc::load_tile<HD, BM, NT>(sq, q + b * lq.b + h * lq.h, lq.r, q0, Sq, tid);
  tc::load_tile<HD, BM, NT>(sdo, dout + b * ldo.b + h * ldo.h, ldo.r, q0, Sq,
                            tid);
  if (ntiles > 0) load_kv(0, 0);
  cp_async_commit();

  float dqa[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) dqa[e] = 0.f;
  const float sl2 = scale * LOG2E;

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1, k0 = t * BN;
    if (t + 1 < ntiles) {
      load_kv(t + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    // s = q k^T and dp = do v^T on the block's 64 rows
    float s[BN / 2], dp[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      wgmma_ss<BN>(s, desc_k<HD, BM>(sq, 0, j),
                   desc_k<HD, BN>(sk(st), 0, j), j);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      wgmma_ss<BN>(dp, desc_k<HD, BM>(sdo, 0, j),
                   desc_k<HD, BN>(sv(st), 0, j), j);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<BN / 2>(s);
    fence_acc<BN / 2>(dp);

    const float* bt = sb(st);
    const bool full = k0 + BN <= Sk && (!causal || k0 + BN - 1 <= q0 + shift);
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int c = acc_col(lane, e), i = (e >> 1) & 1, kc = k0 + c;
      float p = exp2f(fmaf(s[e], sl2, bt[c]) - lse2[i]);
      if (!full && (kc >= Sk || (causal && kc > row[i] + shift))) p = 0.f;
      float mult = 1.f;
      if (DROP) mult = keep(seed2m, row[i], kc, Sk, thresh) ? inv_keep : 0.f;
      s[e] = p * (dp[e] * mult - dl[i]) * scale;
    }
    uint32_t dh[BN / 16][4], dlo[BN / 16][4];   // ds scale as hi + lo
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) a_frag2(dh[j], dlo[j], s, j);

    // dq += (ds scale) k over hi and lo
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      wgmma_rs<HD>(dqa, dh[j], desc_mn<HD, BN>(sk(st), j));
      wgmma_rs<HD>(dqa, dlo[j], desc_mn<HD, BN>(sk(st), j));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<HD / 2>(dqa);
    fence_frag<BN / 4>(&dh[0][0]);
    fence_frag<BN / 4>(&dlo[0][0]);
    __syncthreads();
  }
  cp_async_wait<0>();

  bf16* dqb = dq + b * ldq.b + h * ldq.h;
#pragma unroll
  for (int e = 0; e < HD / 2; e += 2) {
    const int i = (e >> 1) & 1;
    if (row[i] < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + row[i] * ldq.r +
                                         acc_col(lane, e)) =
          __floats2bfloat162_rn(dqa[e], dqa[e + 1]);
  }
}

// what every instance's launch takes besides the pointers; layouts in
// the order q, k, v, out, dout, dq, dk, dv
struct Args {
  Layout lq, lk, lv, lo, ldo, ldq, ldk, ldv;
  int B, Sq, Sk, H;
  float scale;
  int causal;
  unsigned seed, thresh;
  float inv_keep;
};

template <int HD, typename T, bool DROP>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, const float* bias,
           float* delta, void* dq, void* dk, void* dv, float* dbias_h,
           float* dbias, const Args& a, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long long rows = (long long)a.B * a.H * a.Sq;
  const int dblocks = (int)((rows * 32 + THREADS - 1) / THREADS);
  delta_kernel<HD, T><<<dblocks, THREADS, 0, stream>>>(
      dot, static_cast<const T*>(out), delta, a.ldo, a.lo, a.B, a.Sq, a.H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  e = cudaFuncSetAttribute(dkv_kernel<HD, T, DROP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Smem<HD>::dkv);
  if (e != cudaSuccess) return (int)e;
  dim3 kgrid((a.Sk + BK - 1) / BK, a.H, a.B);
  dkv_kernel<HD, T, DROP><<<kgrid, THREADS, Smem<HD>::dkv, stream>>>(
      qt, kt, vt, dot, lse, delta, bias, static_cast<T*>(dk),
      static_cast<T*>(dv), dbias_h, a.lq, a.lk, a.lv, a.ldo, a.ldk, a.ldv,
      a.Sq, a.Sk, a.H, a.scale, a.causal, a.seed, a.thresh, a.inv_keep);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  e = cudaFuncSetAttribute(dq_kernel<HD, T, DROP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Smem<HD>::dq);
  if (e != cudaSuccess) return (int)e;
  dim3 qgrid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  dq_kernel<HD, T, DROP><<<qgrid, THREADS, Smem<HD>::dq, stream>>>(
      qt, kt, vt, dot, lse, delta, bias, static_cast<T*>(dq), a.lq, a.lk,
      a.lv, a.ldo, a.ldq, a.Sq, a.Sk, a.H, a.scale, a.causal, a.seed,
      a.thresh, a.inv_keep);
  e = cudaGetLastError();
  if (e != cudaSuccess || dbias == nullptr) return (int)e;

  const int bblocks = (a.B * a.Sk + THREADS - 1) / THREADS;
  dbias_kernel<<<bblocks, THREADS, 0, stream>>>(dbias_h, dbias, a.B, a.Sk,
                                                a.H);
  return (int)cudaGetLastError();
}

// the bf16 instance: delta, then the dkv and dq passes on tensor cores,
// then dbias
template <int HD, bool DROP>
int launch_tc(const void* q, const void* k, const void* v, const void* out,
              const void* dout, const float* lse, const float* bias,
              float* delta, void* dq, void* dk, void* dv, float* dbias_h,
              float* dbias, const Args& a, cudaStream_t stream) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  auto st = [](const Layout& l) { return tc::Strides{l.b, l.r, l.h}; };
  const long long rows = (long long)a.B * a.H * a.Sq;
  const int dblocks = (int)((rows * 32 + THREADS - 1) / THREADS);
  delta_kernel<HD, bf16><<<dblocks, THREADS, 0, stream>>>(
      dot, static_cast<const bf16*>(out), delta, a.ldo, a.lo, a.B, a.Sq,
      a.H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  e = cudaFuncSetAttribute(dkv_tc<HD, DROP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)TcDkv<HD>::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 kgrid((a.Sk + TC_KEYS - 1) / TC_KEYS, a.H, a.B);
  dkv_tc<HD, DROP><<<kgrid, TC_THREADS, TcDkv<HD>::bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, bias, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dbias_h, st(a.lq), st(a.lk), st(a.lv),
      st(a.ldo), st(a.ldk), st(a.ldv), a.Sq, a.Sk, a.H, a.scale, a.causal,
      a.seed, a.thresh, a.inv_keep);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  e = cudaFuncSetAttribute(dq_tc<HD, DROP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)TcDq<HD>::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 qgrid((a.Sq + TC_ROWS - 1) / TC_ROWS, a.H, a.B);
  dq_tc<HD, DROP><<<qgrid, TC_THREADS, TcDq<HD>::bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, bias, static_cast<bf16*>(dq), st(a.lq),
      st(a.lk), st(a.lv), st(a.ldo), st(a.ldq), a.Sq, a.Sk, a.H, a.scale,
      a.causal, a.seed, a.thresh, a.inv_keep);
  e = cudaGetLastError();
  if (e != cudaSuccess || dbias == nullptr) return (int)e;

  const int bblocks = (a.B * a.Sk + THREADS - 1) / THREADS;
  dbias_kernel<<<bblocks, THREADS, 0, stream>>>(dbias_h, dbias, a.B, a.Sk,
                                                a.H);
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const float* lse, const float* bias,
             float* delta, void* dq, void* dk, void* dv, float* dbias_h,
             float* dbias, int dtype, const Args& a, cudaStream_t stream) {
  const bool drop = a.thresh != 0u;
#define PT_BWD(T, D)                                                    \
  launch<HD, T, D>(q, k, v, out, dout, lse, bias, delta, dq, dk, dv,    \
                   dbias_h, dbias, a, stream)
  if (dtype == 0) return drop ? PT_BWD(float, true) : PT_BWD(float, false);
#undef PT_BWD
  if (dtype == 1)
    return drop ? launch_tc<HD, true>(q, k, v, out, dout, lse, bias, delta,
                                      dq, dk, dv, dbias_h, dbias, a, stream)
                : launch_tc<HD, false>(q, k, v, out, dout, lse, bias, delta,
                                       dq, dk, dv, dbias_h, dbias, a, stream);
  return (int)cudaErrorInvalidValue;
}
}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success), or
// cudaErrorInvalidValue for a head_dim or dtype without a template
// instance. dtype: 0 = fp32, 1 = bf16 (q/k/v/out/dout/dq/dk/dv). strides:
// 24 element strides, (batch, row, head) of q, k, v, out, dout, dq, dk, dv
// in that order; head_dim is contiguous. fp32: every stride a multiple of
// 4 elements and every pointer 16-byte aligned (float4 loads); bf16:
// strides a multiple of 8 elements, pointers 16-byte aligned (16-byte
// cp.async). delta [B, H, Sq] and, with a bias, dbias_h [B, H, Sk] are
// fp32 scratch; dbias [B, Sk] fp32 (or null without a bias). Every output
// is written in full, so none needs zeroing. thresh == 0 means no dropout.
extern "C" int pt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, const float* bias, float* delta,
    void* dq, void* dk, void* dv, float* dbias_h, float* dbias,
    const long long* strides, int B, int Sq, int Sk, int H, int hd,
    float scale, int causal, int dtype, unsigned seed, unsigned thresh,
    float inv_keep, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  Layout l[8];
  for (int i = 0; i < 8; ++i)
    l[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Args a = {l[0], l[1], l[2], l[3], l[4], l[5], l[6], l[7],
                  B, Sq, Sk, H, scale, causal, seed, thresh, inv_keep};
  if (bias == nullptr) dbias_h = dbias = nullptr;
  switch (hd) {
    case 32:
      return dispatch<32>(q, k, v, out, dout, lse, bias, delta, dq, dk, dv,
                          dbias_h, dbias, dtype, a, stream);
    case 64:
      return dispatch<64>(q, k, v, out, dout, lse, bias, delta, dq, dk, dv,
                          dbias_h, dbias, dtype, a, stream);
    case 128:
      return dispatch<128>(q, k, v, out, dout, lse, bias, delta, dq, dk, dv,
                           dbias_h, dbias, dtype, a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
