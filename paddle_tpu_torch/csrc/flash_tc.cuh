// The flash-specific pieces of the bf16 tensor-core flash kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu) for Hopper, sm_90a:
// the per-(b, h) strides, the dropout lattice, the key-bias stage loader
// and the causal key range. The generic tensor-core pieces (tiles,
// loaders, descriptors, wgmma wrappers, fragment maps) are in wgmma.cuh,
// shared with the conv and int8 GEMM kernels.
//
// What was hard, and how the kernels meet it:
//  * Operand layouts. Both majors come from one tile layout (wgmma.cuh);
//    the four MN-major B operands (v in p v, k in ds k, q in ds^T q, do
//    in p^T do) set the transpose bit. The descriptors and the register-A
//    mapping were checked on the card at single-tile shapes (S = 64,
//    every head_dim) before anything was built on them: lse exercises
//    only q k^T, out and the gradients the register-A products.
//  * Reading through strides. 16-byte cp.async copies, not TMA: each
//    thread computes its chunk's address from the (batch, row, head)
//    strides, so the packed layout's n * hd row stride costs nothing, and
//    a row past the sequence is a zero-fill (source size 0) that never
//    reads the next batch. The copies need every bf16 stride a multiple
//    of 8 elements and 16-byte aligned bases; the wrapper
//    (kernels/flash_attention.py, _stride_array) raises on anything else.
//  * CUDA-core work. One exp2 per score (log2 e folded into the scale and
//    lse) and, with dropout, one splitmix32 hash per score in every pass;
//    these, not the products, set the pace (PERF.md).
//  * Determinism and layouts. No atomics and no split of a reduction
//    across blocks: every sum runs in a fixed order in one thread, then
//    across a quad by fixed shuffles, so runs repeat bit for bit and the
//    packed and bnsd layouts give the same bits.
//  * The dropout lattice. The (q, k) of each accumulator element comes
//    from acc_row / acc_col plus the tile offsets; keep() hashes it with
//    the per-(b, h) key exactly as core/rng.attn_keep does, and the card
//    reads both kernels' masks back bit for bit.
//  * The build hash. kernels/_build.py names each library by a hash of
//    its source and of every csrc/*.cuh, so an edit here rebuilds both.

#pragma once

#include "wgmma.cuh"

namespace tc {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;   // the running max before any key

// element strides of one operand: batch, row (sequence position), head
struct Strides {
  long long b, r, h;
};

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

// keep(q, k) of core/rng.attn_keep: the hash of the (q, k) lattice index
__device__ __forceinline__ bool keep(unsigned seed2m, int qi, int ki,
                                     int Sk, unsigned thresh) {
  return splitmix32(((unsigned)qi * (unsigned)Sk + (unsigned)ki) ^ seed2m) >=
         thresh;
}

// the dropout multiplier of (qi, ki): inv_keep where keep() holds, else
// 0; 1 without dropout
template <bool DROP>
__device__ __forceinline__ float drop_mult(unsigned seed2m, int qi, int ki,
                                           int Sk, unsigned thresh,
                                           float inv_keep) {
  if (!DROP) return 1.f;
  return keep(seed2m, qi, ki, Sk, thresh) ? inv_keep : 0.f;
}

// two adjacent elements of a row as fp32
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Rows that see no key. Under the causal mask (bottom-right aligned) a
// query row r with r + Sk - Sq < 0 sees no key. The reference gives
// masked scores the finite -1e30, so such a row's softmax is uniform over
// all Sk keys: out_r = (1 / Sk) sum_k mask(r, k) v_k, lse_r = -1e30 (the
// fp32 value of -1e30 + log Sk, and of NEG_INF + log 1e-30: the lse the
// kernels write wherever l == 0). Its vjp gives dq_r = 0, nothing to dk,
// and dv_k += (1 / Sk) mask(r, k) do_r. Both key loops skip or mask such
// rows, so the forward adds the mean after its loop (empty_row_mean) and
// the dkv pass adds the dv term after its loop (empty_rows_dv); the
// backward tells them by position, and p = exp(-inf - lse) stays 0 there.

// o (the accumulator of this thread's rows row[0], row[1], the two
// columns of element pair e at acc_col(lane, e)) += the masked sum of v
// over all Sk keys for each row that sees no key; den[i] = Sk for those
template <int HD, bool DROP, typename T>
__device__ __forceinline__ void empty_row_mean(
    float* o, float* den, const int* row, int lane, const T* vb,
    long long vrs, int Sq, int Sk, unsigned seed2m, unsigned thresh,
    float inv_keep) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    den[i] = 1.f;
    if (row[i] >= Sq || row[i] + Sk - Sq >= 0) continue;
    den[i] = (float)Sk;
    for (int kk = 0; kk < Sk; ++kk) {
      const float w = drop_mult<DROP>(seed2m, row[i], kk, Sk, thresh,
                                      inv_keep);
      const T* vr = vb + kk * vrs;
#pragma unroll
      for (int e = 0; e < HD / 2; e += 2) {
        if (((e >> 1) & 1) != i) continue;
        const float2 x = ld2(vr + acc_col(lane, e));
        o[e] = fmaf(w, x.x, o[e]);
        o[e + 1] = fmaf(w, x.y, o[e + 1]);
      }
    }
  }
}

// dv (the accumulator of this thread's keys kr[0], kr[1], as o above) +=
// (1 / Sk) sum over the rows r < Sq - Sk that see no key of mask(r, k) do_r
template <int HD, bool DROP, typename T>
__device__ __forceinline__ void empty_rows_dv(
    float* dv, const int* kr, int lane, const T* dob, long long dors,
    int Sq, int Sk, unsigned seed2m, unsigned thresh, float inv_keep) {
  const float inv_sk = 1.f / (float)Sk;
  for (int r = 0; r < Sq - Sk; ++r) {
    const T* dr = dob + r * dors;
    float w[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      w[i] = kr[i] < Sk ? inv_sk * drop_mult<DROP>(seed2m, r, kr[i], Sk,
                                                   thresh, inv_keep)
                        : 0.f;
#pragma unroll
    for (int e = 0; e < HD / 2; e += 2) {
      const int i = (e >> 1) & 1;
      const float2 x = ld2(dr + acc_col(lane, e));
      dv[e] = fmaf(w[i], x.x, dv[e]);
      dv[e + 1] = fmaf(w[i], x.y, dv[e + 1]);
    }
  }
}

// one stage of a key loop: the k and v tiles of keys [k0, k0 + R) and
// their key bias times log2 e (0 without a bias and past Sk)
template <int HD, int R, int NT>
__device__ __forceinline__ void load_kv(uint32_t sk, uint32_t sv, float* sb,
                                        const bf16* kb, long long krs,
                                        const bf16* vb, long long vrs,
                                        const float* bias, int k0, int Sk,
                                        int tid) {
  load_tile<HD, R, NT>(sk, kb, krs, k0, Sk, tid);
  load_tile<HD, R, NT>(sv, vb, vrs, k0, Sk, tid);
  if (tid < R)
    sb[tid] = bias != nullptr && k0 + tid < Sk ? bias[k0 + tid] * LOG2E : 0.f;
}

// keys [0, key_end) are visible to some row of the q tile [q0, q0 + rows);
// causal masking is bottom-right aligned
__device__ __forceinline__ int key_end(int q0, int rows, int Sq, int Sk,
                                       int causal) {
  if (!causal) return Sk;
  const int lim = (q0 + rows < Sq ? q0 + rows : Sq) + Sk - Sq;
  return lim < Sk ? lim : Sk;
}

}  // namespace tc
