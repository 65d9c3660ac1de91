// Flash-attention backward over the packed layout, from the saved forward
// (out, lse), for Hopper (sm_90a). With s = q k^T * scale + bias (causally
// hidden keys excluded), p = exp(s - lse) and the dropout multiplier
// mask = keep / (1 - rate) (1 without dropout):
//     delta[b,h,q] = sum_d do * o
//     dv = (p * mask)^T do            dp = (do v^T) * mask
//     ds = p * (dp - delta)           dbias[b,k] = sum over heads and q of ds
//     dq = (ds * scale) k             dk = (ds * scale)^T q
// q/k/v/o/do [B, S, n*HD] fp32 or bf16 read in place, lse [B, n, Sq] and
// bias [B, Sk] fp32. dk and dv are written in the input type, dq and dbias
// accumulate in fp32 buffers that the caller zeroes. The mask is recomputed
// from (seed, b*H + h, q, k) exactly as the forward computes it
// (flash_attention_fwd.cu), never stored.
//
// Replaces _packed_bwd_kernel of paddle_tpu/ops/pallas/flash_attention.py
// (:984, launched at :1115 by _bwd_pallas_packed). The TPU kernel holds a
// whole [S, g*HD] block of every operand in VMEM and is limited to the
// lengths that fit; this one tiles both sequence axes and takes any length.
// The reference rounds p * mask and ds * scale to bf16 before their products
// for bf16 inputs; this kernel keeps them in fp32.
//
// What bounds it on the H100: 5 products of 2 * Sq * Sk * HD flops a head
// against 5 reads and 3 writes of S * HD elements: hundreds of flops per
// byte at S = 512, so it is bound by operations. The design never writes an
// S x S matrix to device memory: p is recomputed tile by tile from lse.
//
// Design (simple first, fp32 on CUDA cores, no tensor cores):
//  * delta_kernel: one warp per (b, h, q) row.
//  * bwd_kernel: one block of 256 threads per (64-key tile, head, batch).
//    The k and v tiles stay in shared memory, and the block OWNS dk and dv
//    of its keys: it loops over the 64-row q tiles, accumulates both in
//    registers and writes them once. No reduction across blocks for dk, dv.
//  * dq of a q tile gets one contribution from every key tile, that is from
//    different blocks: they are added with fp32 atomicAdd into the zeroed dq.
//    The order of those additions depends on scheduling, so dq's last bits
//    can differ from run to run. A second kernel per q tile would make dq
//    deterministic at the price of computing s and dp twice.
//  * dbias sums over query rows inside the block (registers, then shared
//    memory) and over heads across blocks: fp32 atomicAdd again, with the
//    same remark.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;

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

// delta[b, h, q] = sum_d do[b, q, h*HD + d] * o[b, q, h*HD + d]
template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ dout, const T* __restrict__ out,
             float* __restrict__ delta, int B, int Sq, int H) {
  const int warp = (blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= B * H * Sq) return;
  const int qi = warp % Sq, h = (warp / Sq) % H, b = warp / (Sq * H);
  const size_t off = ((size_t)b * Sq + qi) * H * HD + (size_t)h * HD;
  float acc = 0.f;
  if (lane * 4 < HD) {
    const float4 a = load4(dout + off + lane * 4);
    const float4 c = load4(out + off + lane * 4);
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
  static constexpr size_t bytes =
      sizeof(float) * ((size_t)4 * TILE + 2 * SS + 2 * BQ + 16 * BK);
};

template <int HD, typename T, bool DROP>
__global__ void __launch_bounds__(THREADS)
bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const float* __restrict__ bias, float* __restrict__ dq,
           T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dbias,
           int Sq, int Sk, int H, float scale, int causal, unsigned seed,
           unsigned thresh, float inv_keep) {
  constexpr int DJ = HD / 16;   // head-dim columns per thread
  constexpr int V4 = HD / 4;
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
  const int ld = H * HD;
  const int shift = Sk - Sq;
  const size_t hoff = (size_t)h * HD;
  const T* qb = q + (size_t)b * Sq * ld + hoff;
  const T* dob = dout + (size_t)b * Sq * ld + hoff;
  const T* kb = k + (size_t)b * Sk * ld + hoff;
  const T* vb = v + (size_t)b * Sk * ld + hoff;
  float* dqb = dq + (size_t)b * Sq * ld + hoff;
  const float* lseb = lse + ((size_t)b * H + h) * Sq;
  const float* deltab = delta + ((size_t)b * H + h) * Sq;
  unsigned seed2m = 0u;
  if (DROP)
    seed2m = splitmix32((unsigned)(b * H + h) ^ (seed * 0x9E3779B9u)) *
             0x9E3779B9u;

  for (int e = tid; e < BK * V4; e += THREADS) {
    const int r = e / V4, c = (e % V4) * 4;
    float4 k4 = make_float4(0.f, 0.f, 0.f, 0.f), v4 = k4;
    if (k0 + r < Sk) {
      k4 = load4(kb + (size_t)(k0 + r) * ld + c);
      v4 = load4(vb + (size_t)(k0 + r) * ld + c);
    }
    float* kd = ks + r * LD + c;
    kd[0] = k4.x; kd[1] = k4.y; kd[2] = k4.z; kd[3] = k4.w;
    float* vd = vs + r * LD + c;
    vd[0] = v4.x; vd[1] = v4.y; vd[2] = v4.z; vd[3] = v4.w;
  }

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
    for (int e = tid; e < BQ * V4; e += THREADS) {
      const int r = e / V4, c = (e % V4) * 4;
      float4 q4 = make_float4(0.f, 0.f, 0.f, 0.f), d4 = q4;
      if (q0 + r < Sq) {
        q4 = load4(qb + (size_t)(q0 + r) * ld + c);
        d4 = load4(dob + (size_t)(q0 + r) * ld + c);
      }
      float* qd = qs + r * LD + c;
      qd[0] = q4.x; qd[1] = q4.y; qd[2] = q4.z; qd[3] = q4.w;
      float* dd = dos + r * LD + c;
      dd[0] = d4.x; dd[1] = d4.y; dd[2] = d4.z; dd[3] = d4.w;
    }
    if (tid < BQ) {
      const bool ok = q0 + tid < Sq;
      lse_s[tid] = ok ? lseb[q0 + tid] : 0.f;
      dl_s[tid] = ok ? deltab[q0 + tid] : 0.f;
    }
    __syncthreads();

    // s = q k^T and dp = do v^T on the patch rows ty + 16 i, cols tx + 16 j
    float sacc[4][4], dpacc[4][4];
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

    // dq tile = (ds scale) k : rows ty + 16 i, dims tx + 16 j
    float dq_acc[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) dq_acc[i][j] = 0.f;
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
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = q0 + ty + 16 * i;
      if (gr >= Sq) continue;
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        atomicAdd(dqb + (size_t)gr * ld + tx + 16 * j, dq_acc[i][j]);
    }
  }

  T* dkb = dk + (size_t)b * Sk * ld + hoff;
  T* dvb = dv + (size_t)b * Sk * ld + hoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gk = k0 + ty + 16 * i;
    if (gk >= Sk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      store1(dkb + (size_t)gk * ld + tx + 16 * j, dk_acc[i][j]);
      store1(dvb + (size_t)gk * ld + tx + 16 * j, dv_acc[i][j]);
    }
  }

  if (dbias != nullptr) {
    // this thread's partial sums are of columns tx + 16 j over its rows;
    // add the 16 row groups (ty) through shared memory, then one atomic
    // per column into dbias[b, :] (heads are different blocks)
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) db_s[ty * BK + tx + 16 * j] = db_acc[j];
    __syncthreads();
    if (tid < BK && k0 + tid < Sk) {
      float tot = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) tot += db_s[r * BK + tid];
      atomicAdd(dbias + (size_t)b * Sk + k0 + tid, tot);
    }
  }
}

template <int HD, typename T, bool DROP>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, const float* bias,
           float* delta, float* dq, void* dk, void* dv, float* dbias, int B,
           int Sq, int Sk, int H, float scale, int causal, unsigned seed,
           unsigned thresh, float inv_keep, cudaStream_t stream) {
  const long long rows = (long long)B * H * Sq;
  const int dblocks = (int)((rows * 32 + THREADS - 1) / THREADS);
  delta_kernel<HD, T><<<dblocks, THREADS, 0, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(out), delta, B, Sq,
      H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = Smem<HD>::bytes;
  e = cudaFuncSetAttribute(bwd_kernel<HD, T, DROP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sk + BK - 1) / BK, H, B);
  bwd_kernel<HD, T, DROP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, bias,
      dq, static_cast<T*>(dk), static_cast<T*>(dv), dbias, Sq, Sk, H, scale,
      causal, seed, thresh, inv_keep);
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const float* lse, const float* bias,
             float* delta, float* dq, void* dk, void* dv, float* dbias, int B,
             int Sq, int Sk, int H, float scale, int causal, int dtype,
             unsigned seed, unsigned thresh, float inv_keep,
             cudaStream_t stream) {
  const bool drop = thresh != 0u;
#define PT_BWD(T, D)                                                        \
  launch<HD, T, D>(q, k, v, out, dout, lse, bias, delta, dq, dk, dv, dbias, \
                   B, Sq, Sk, H, scale, causal, seed, thresh, inv_keep,     \
                   stream)
  if (dtype == 0) return drop ? PT_BWD(float, true) : PT_BWD(float, false);
  if (dtype == 1) return drop ? PT_BWD(bf16, true) : PT_BWD(bf16, false);
#undef PT_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success), or
// cudaErrorInvalidValue for a head_dim or dtype without a template
// instance. dtype: 0 = fp32, 1 = bf16 (q/k/v/out/dout/dk/dv). delta
// [B, H, Sq] fp32 is scratch; dq [B, Sq, H*hd] fp32 and dbias [B, Sk] fp32
// (or null) must be zero on entry. thresh == 0 means no dropout. Tensors
// must be contiguous and 16-byte aligned.
extern "C" int pt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, const float* bias, float* delta,
    float* dq, void* dk, void* dv, float* dbias, int B, int Sq, int Sk, int H,
    int hd, float scale, int causal, int dtype, unsigned seed,
    unsigned thresh, float inv_keep, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  switch (hd) {
    case 32:
      return dispatch<32>(q, k, v, out, dout, lse, bias, delta, dq, dk, dv,
                          dbias, B, Sq, Sk, H, scale, causal, dtype, seed,
                          thresh, inv_keep, stream);
    case 64:
      return dispatch<64>(q, k, v, out, dout, lse, bias, delta, dq, dk, dv,
                          dbias, B, Sq, Sk, H, scale, causal, dtype, seed,
                          thresh, inv_keep, stream);
    case 128:
      return dispatch<128>(q, k, v, out, dout, lse, bias, delta, dq, dk, dv,
                           dbias, B, Sq, Sk, H, scale, causal, dtype, seed,
                           thresh, inv_keep, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
