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
// at every length: dkv_kernel is the counterpart of _dkv_kernel and
// dq_kernel of _dq_kernel, both tiled over both sequence axes, reading
// either layout through strides. The long-context step runs them on the
// packed projections in place where the reference transposes to [B, H, S,
// D] first (_packed_to_bnsd :1576). The reference rounds p * mask and
// ds * scale to bf16 before their products for bf16 inputs; these kernels
// keep them in fp32.
//
// What bounds it on the H100: the function needs 5 products of 2 * Sq *
// Sk * HD flops a head (7 as computed here: s and dp are formed in both
// passes) against 5 reads and 3 writes of S * HD elements: hundreds of
// flops per byte at S = 512, so it is bound by operations. No S x S
// matrix is written to device memory: p is recomputed tile by tile from
// lse.
//
// Design (simple first, fp32 on CUDA cores, no tensor cores):
//  * delta_kernel: one warp per (b, h, q) row.
//  * dkv_kernel: one block of 256 threads per (64-key tile, head, batch).
//    The k and v tiles stay in shared memory, and the block OWNS dk, dv
//    and the per-head dbias of its keys: it loops over the 64-row q tiles
//    in order, accumulates in registers and writes each value once.
//  * dq_kernel: one block per (64-row q tile, head, batch) owns dq of its
//    rows and loops over the key tiles in order up to its causal limit,
//    recomputing s and dp.
//  * dbias_kernel: dbias[b, k] = the per-head sums added over heads in
//    order.
// Every output element is written once by one thread after a sum in a
// fixed order: no atomics, so the result is the same from run to run and
// the same in either layout on the same values. Computing s and dp twice
// is the price; one pass with dq added by atomics across key tiles would
// save it and give up both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
__device__ __forceinline__ void store1(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

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
  if (dtype == 1) return drop ? PT_BWD(bf16, true) : PT_BWD(bf16, false);
#undef PT_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success), or
// cudaErrorInvalidValue for a head_dim or dtype without a template
// instance. dtype: 0 = fp32, 1 = bf16 (q/k/v/out/dout/dq/dk/dv). strides:
// 24 element strides, (batch, row, head) of q, k, v, out, dout, dq, dk, dv
// in that order; head_dim is contiguous, and every stride and pointer
// keeps the 16-byte (fp32) or 8-byte (bf16) alignment of a 4-element
// vector load. delta [B, H, Sq] and, with a bias, dbias_h [B, H, Sk] are
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
