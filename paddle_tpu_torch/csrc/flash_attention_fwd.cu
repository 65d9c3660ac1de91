// Flash-attention forward for Hopper (sm_90a):
//     out[b, h, s, :] = sum_t softmax_t(q . k_t * scale + bias[b, t]) v_t
//     lse[b, h, s]    = m + log(max(l, 1e-30))
// with q [Sq rows], k/v [Sk rows] of B batches and H heads of HD values,
// fp32 or bf16, read in place through explicit element strides per
// operand: (batch, row, head), head_dim contiguous. The packed layout
// [B, S, H*HD] is the strides (S*H*HD, H*HD, HD); the [B, H, S, HD]
// ("bnsd") layout is (H*S*HD, HD, S*HD). out is written through its own
// strides, lse [B, H, Sq] stays contiguous. Optional fp32 key bias [B, Sk]
// and causal masking, bottom-right aligned (query row r sees keys
// t <= r + Sk - Sq). Softmax statistics are fp32 whatever the I/O type;
// out is written in the input type, lse in fp32 (natural log).
//
// Attention-probs dropout (the DROP instances): the probabilities are
// multiplied by keep / (1 - rate) before p v, while the row sum l and lse
// stay unmasked. keep(b, h, q, k) is the reference's stateless hash, all in
// uint32:
//     seed2 = splitmix32((b * H + h) ^ seed * 0x9E3779B9)
//     x     = splitmix32((q * Sk + k) ^ seed2 * 0x9E3779B9)
//     keep  = x >= thresh,   thresh = min(int(rate * 2^32), 2^32 - 1)
// thresh and 1 / (1 - rate) come from the host. With the online softmax
// the mask multiplies the tile's rescaled probabilities, never l.
//
// Replaces the forward kernels of paddle_tpu/ops/pallas/flash_attention.py,
// which all compute this one function (out, lse):
//   _packed_fwd_kernel :948   packed single-block route (prefill buckets up
//                             to 512; the BERT/ERNIE encoder in training)
//   _fwd_kernel :311          2-pass online softmax over [B*H, S, D], for
//                             S >= 1024 (prefill buckets 1024 and 2048,
//                             long-context training after a transpose)
//   _fused_fwd_kernel :377    single-block [B*H, S, D], one (b, h) a cell
//   _fused_fwd_kernel_g :822  the same with g heads a cell
// The TPU needed four because of its VMEM budget: a whole S x S tile fits
// at S <= 512 and not above, and grid cells had to be packed with heads to
// amortise their overhead. Neither holds here: tiles stream any length and
// one block per (q tile, head, batch) fills the card at every shape these
// routes take, so one tiled kernel reading either layout through strides
// serves all four. The long-context step runs it on the packed
// projections in place where the reference transposes them to [B, H, S,
// D] first (_packed_to_bnsd :1576). Each dtype has its own instance:
//
// bf16: tensor cores (flash_fwd_tc). The reference's kernels multiply in
// the input dtype on the MXU with fp32 accumulation and round p to bf16
// before p v (flash_attention.py:359, :406); here the products are
// wgmma.mma_async m64nNk16 with bf16 operands and fp32 accumulators, and
// p enters p v as two bf16 terms, hi = bf16(p) (the reference's operand)
// and lo = bf16(p - hi), two wgmma on the same v tile. hi alone leaves
// outputs up to 2 bf16 ulps from the fp32 function at short rows (one
// bf16 ulp plus 1e-3 is the gate chip_smoke.py and the card tests hold
// the kernel to); hi + lo carries 16 significant bits. out is rounded to
// bf16 once, at the end.
//  * Bound: 4 * HD flops per visible (query, key) pair on the tensor cores
//    (989 TFLOP/s dense bf16; 6 * HD as computed, with the lo term), about
//    7 flops a byte at S = 512 and growing with S: operations, not bytes.
//    Beside them, per score, one MUFU exp2 (log2 e folded into the scale,
//    lse still natural log; 16 a clock per SM make it as long as the
//    tensor-core floor) and, with dropout, one splitmix32 hash (an xor,
//    three shifts, two multiplies on the integer pipe), which costs more
//    than either. The CUDA-core work per score, not the products, sets
//    the pace (PERF.md, tools/profile_flash.py).
//  * Design: one block of two consumer warpgroups (256 threads) per
//    (128-row q tile, head, batch); warpgroup g owns q rows 64 g .. 64 g +
//    63. The q tile is loaded once. k/v tiles of 64 keys and their key
//    bias stream through two shared-memory stages filled by 16-byte
//    cp.async copies (rows past the end zero-filled), so the next tile's
//    copy runs under this tile's math; two blocks share an SM, and one's
//    softmax runs under the other's products. Per tile: s = q k^T as HD /
//    16 wgmma (A = q, B = k, both K-major in the swizzled tile layout of
//    flash_tc.cuh); the online softmax on the accumulator fragment (each
//    thread holds two rows; row max and sum across the quad of lanes by
//    shuffles; the running m and l in fp32, in log2 units); the dropout
//    multiplier after the row sum; p split into its bf16 hi and lo A
//    fragments in registers, then o += p v with A from registers and B =
//    v read MN-major with the transpose bit. Under the causal mask the key
//    loop ends at the tile's last visible key, and only tiles that cross
//    the diagonal or the end of Sk mask per element. The dropout keep bit
//    of each accumulator element comes from its (q, k), the fragment
//    layout plus the tile offsets, hashed with the per-(b, h) key: the
//    same lattice as core/rng.attn_keep, bit for bit.
//
// fp32: tensor cores in split TF32 (flash_fwd_tf32; flash_tf32.cuh). Each
// fp32 operand is two TF32 terms, hi (the low 13 mantissa bits cleared)
// and lo = x - hi, and each product a b is a_lo b_hi + a_hi b_lo + a_hi b_hi
// (wgmma.mma_async m64nNk8 .tf32, fp32 accumulators): about 2^-21 of the
// product from fp32, where one TF32 pass (2^-11) would break the serving
// path's 1e-4 gate against the CPU. The first port kept fp32 on the FMA
// pipes (67 TFLOP/s); the tensor cores' TF32 rate is 495 TFLOP/s dense,
// 165 as three passes.
//  * Bound: 4 * HD flops per visible pair at 165 TFLOP/s (3 passes of 495):
//    operations from S = 128 up.
//  * Design: the bf16 kernel's, at one warpgroup (64 q rows) a block: the
//    q tile is loaded and split once; k/v tiles of BN keys (64 at HD = 32,
//    32 at 64, 16 at 128: 8 KB a tile; 91 KB of shared memory a block at
//    HD = 64, two blocks an SM) land through two cp.async stages,
//    then the block's threads split them: k (its own hi) into a lo tile;
//    v into hi and lo tiles turned over (head_dim rows, keys along
//    the row), since .tf32 operands are K-major only and p v reduces over
//    keys. s = q k^T as 3 HD / 8 wgmma from shared memory; the online
//    softmax and dropout as in bf16, but with the exps in natural units in
//    the plain version's rounding order (s * scale, + bias, - m; see
//    nat_exponent in flash_tf32.cuh); p split into TF32 hi and lo A
//    fragments in registers, then o += p v as 3 BN / 8 wgmma against the
//    turned-over v tiles, whose keys are permuted within each group of 8
//    to match the fragment's column order (flash_tf32.cuh, tperm).
//
// In both, masked keys get weight exactly 0. A row with no visible key
// (causal, Sq > Sk) ends the key loop with l == 0; as in the reference,
// whose mask value is the finite -1e30, its out is the uniform softmax
// over all Sk keys, the mean of the masked v, added after the loop
// (empty_row_mean, flash_tc.cuh), and its lse -1e30. No atomics and no
// reduction across rows, so
// the result does not depend on the layout: the packed and bnsd instances
// give the same bits on the same values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_tc.cuh"
#include "flash_tf32.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// fp32 on tensor cores, split TF32
// ---------------------------------------------------------------------------

constexpr int TF_BM = 64;        // q rows a block: one warpgroup
constexpr int TF_THREADS = 128;

template <int HD>
struct TfSmem {
  using Tile = tc::Tf32Tile<HD, 8192>;   // 64, 32, 16 keys at HD = 32-128
  static constexpr int BN = Tile::N;               // keys a tile
  static constexpr int Q = TF_BM * HD * 4;         // the q tile (hi or lo)
  static constexpr int KV = Tile::SIZE;
  // a stage: the landed k tile (its own hi), the landed v tile, the
  // tile's key bias
  static constexpr int STAGE = 2 * KV + 1024;
  // after both stages, one of each: k lo, v^T hi, v^T lo
  static constexpr int SINGLE = 2 * Q + 2 * STAGE;
  static constexpr size_t bytes = 1024 + SINGLE + 3 * KV;  // + alignment
};

template <int HD, bool DROP>
__global__ void __launch_bounds__(TF_THREADS, HD == 128 ? 1 : 2)
flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bias,
               float* __restrict__ out, float* __restrict__ lse,
               tc::Strides lq, tc::Strides lk, tc::Strides lv, tc::Strides lo,
               int Sq, int Sk, int H, float scale, int causal,
               const unsigned* __restrict__ seed, unsigned thresh,
               float inv_keep) {
  using namespace tc;
  using SM = TfSmem<HD>;
  constexpr int BM = TF_BM, BN = SM::BN, NT = TF_THREADS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // tiles 1024-aligned
  uint8_t* gbase = smem_raw + (base - raw);
  auto gp = [&](uint32_t a) { return gbase + (a - base); };
  const uint32_t sqh = base, sql = base + SM::Q;
  auto sk = [&](int st) { return base + 2 * SM::Q + st * SM::STAGE; };
  auto sv = [&](int st) { return sk(st) + SM::KV; };
  auto sb = [&](int st) {
    return reinterpret_cast<float*>(gp(sk(st) + 2 * SM::KV));
  };
  const uint32_t skl = base + SM::SINGLE, svth = skl + SM::KV,
                 svtl = svth + SM::KV;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int shift = Sk - Sq;
  const float* qb = q + b * lq.b + h * lq.h;
  const float* kb = k + b * lk.b + h * lk.h;
  const float* vb = v + b * lv.b + h * lv.h;
  const float* biasb = bias != nullptr ? bias + (size_t)b * Sk : nullptr;
  const unsigned seed2m = DROP ? mask_key(b, h, H, __ldg(seed)) : 0u;
  const int row[2] = {q0 + acc_row(lane, warp, 0),
                      q0 + acc_row(lane, warp, 2)};

  const int kend = key_end(q0, BM, Sq, Sk, causal);
  const int ntiles = kend > 0 ? (kend + BN - 1) / BN : 0;
  auto load_kv = [&](int t, int st) {
    const int k0 = t * BN;
    load_tile32<HD, BN, NT>(sk(st), kb, lk.r, k0, Sk, tid);
    load_tile32<HD, BN, NT>(sv(st), vb, lv.r, k0, Sk, tid);
    if (tid < BN)
      sb(st)[tid] = biasb != nullptr && k0 + tid < Sk ? biasb[k0 + tid] : 0.f;
  };

  load_tile32<HD, BM, NT>(sqh, qb, lq.r, q0, Sq, tid);
  cp_async_commit();
  if (ntiles > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  split_tile<HD, BM, NT, true, false>(gp(sqh), gp(sql), nullptr,
                                            nullptr, tid);

  float o[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1, k0 = t * BN;
    if (t + 1 < ntiles) {
      load_kv(t + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // k: lo beside the landed hi; v: hi and lo transposed
    split_tile<HD, BN, NT, true, false>(gp(sk(st)), gp(skl), nullptr,
                                              nullptr, tid);
    split_tile<HD, BN, NT, false, true>(gp(sv(st)), nullptr,
                                               gp(svth), gp(svtl), tid);
    fence_proxy_async();
    __syncthreads();

    // s = q k^T over hi and lo
    float s[BN / 2];
    wgmma_fence();
    mma3_ss<HD, BM, BN>(s, sqh, sql, 0, sk(st), skl, false);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<BN / 2>(s);

    const float* bt = sb(st);
    const bool full = k0 + BN <= Sk && (!causal || k0 + BN - 1 <= q0 + shift);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int c = acc_col(lane, e), i = (e >> 1) & 1;
      float x = __fadd_rn(__fmul_rn(s[e], scale), bt[c]);
      if (!full && (k0 + c >= Sk || (causal && k0 + c > row[i] + shift)))
        x = -INFINITY;
      s[e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int i = (e >> 1) & 1;
      float p = expf(s[e] - m[i]);
      ls[i] += p;
      if (DROP)
        p = keep(seed2m, row[i], k0 + acc_col(lane, e), Sk, thresh)
                ? p * inv_keep
                : 0.f;
      s[e] = p;
    }
    uint32_t ph[BN / 8][4], pl[BN / 8][4];   // p as TF32 hi + lo
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) frag32(ph[j], pl[j], s, j);
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

    // o += p v over hi and lo
    wgmma_fence();
    mma3_rs<HD, BN>(o, ph, pl, svth, svtl);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<HD / 2>(o);
    fence_frag<BN / 2>(&ph[0][0]);
    fence_frag<BN / 2>(&pl[0][0]);
    __syncthreads();   // the stage and the single tiles are rewritten next
  }
  cp_async_wait<0>();

  // l summed over the quad's columns; out = o / l, lse = m + log l
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  // rows that see no key: the mean of the masked v (flash_tc.cuh)
  float den0[2] = {1.f, 1.f};
  if (causal && q0 + shift < 0)
    empty_row_mean<HD, DROP>(o, den0, row, lane, vb, lv.r, Sq, Sk, seed2m,
                             thresh, inv_keep);
  float* ob = out + b * lo.b + h * lo.h;
#pragma unroll
  for (int e = 0; e < HD / 2; e += 2) {
    const int i = (e >> 1) & 1;
    if (row[i] < Sq) {
      const float den = l[i] == 0.f ? den0[i] : l[i];
      *reinterpret_cast<float2*>(ob + row[i] * lo.r + acc_col(lane, e)) =
          make_float2(o[e] / den, o[e + 1] / den);
    }
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row[i] < Sq)
        lse[((size_t)b * H + h) * Sq + row[i]] =
            l[i] == 0.f ? NEG_INF + logf(1e-30f) : m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_BM = 128;       // q rows a block: two warpgroups of 64
constexpr int TC_BN = 64;        // keys a tile
constexpr int TC_THREADS = 256;

template <int HD>
struct TcSmem {
  static constexpr int Q = TC_BM * HD * 2;
  static constexpr int KV = TC_BN * HD * 2;
  // a stage: the k tile, the v tile, the tile's key bias (times log2 e)
  static constexpr int STAGE = 2 * KV + 1024;
  static constexpr size_t bytes = 1024 + Q + 2 * STAGE;  // + alignment
};

template <int HD, bool DROP>
__global__ void __launch_bounds__(TC_THREADS, HD == 128 ? 1 : 2)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const float* __restrict__ bias,
             bf16* __restrict__ out, float* __restrict__ lse, tc::Strides lq,
             tc::Strides lk, tc::Strides lv, tc::Strides lo, int Sq, int Sk,
             int H, float scale, int causal,
             const unsigned* __restrict__ seed, unsigned thresh,
             float inv_keep) {
  using namespace tc;
  using SM = TcSmem<HD>;
  constexpr int BM = TC_BM, BN = TC_BN, NT = TC_THREADS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // tiles 1024-aligned
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sq = base;
  auto sk = [&](int st) { return base + SM::Q + st * SM::STAGE; };
  auto sv = [&](int st) { return sk(st) + SM::KV; };
  auto sb = [&](int st) {
    return reinterpret_cast<float*>(gbase + SM::Q + st * SM::STAGE +
                                    2 * SM::KV);
  };

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int shift = Sk - Sq;
  const bf16* qb = q + b * lq.b + h * lq.h;
  const bf16* kb = k + b * lk.b + h * lk.h;
  const bf16* vb = v + b * lv.b + h * lv.h;
  const float* biasb = bias != nullptr ? bias + (size_t)b * Sk : nullptr;
  const unsigned seed2m = DROP ? mask_key(b, h, H, __ldg(seed)) : 0u;
  // the rows of this thread's accumulator elements e: row[(e >> 1) & 1]
  const int row[2] = {q0 + 64 * wg + acc_row(lane, warp, 0),
                      q0 + 64 * wg + acc_row(lane, warp, 2)};

  const int kend = key_end(q0, BM, Sq, Sk, causal);
  const int ntiles = kend > 0 ? (kend + BN - 1) / BN : 0;
  auto load_kv = [&](int t, int st) {
    tc::load_kv<HD, BN, NT>(sk(st), sv(st), sb(st), kb, lk.r, vb, lv.r, biasb,
                            t * BN, Sk, tid);
  };

  tc::load_tile<HD, BM, NT>(sq, qb, lq.r, q0, Sq, tid);
  if (ntiles > 0) load_kv(0, 0);
  cp_async_commit();

  float o[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // log2 units
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

    // s = q k^T on this warpgroup's 64 rows
    float s[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      wgmma_ss<BN>(s, desc_k<HD, BM>(sq, 64 * wg, j),
                   desc_k<HD, BN>(sk(st), 0, j), j);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<BN / 2>(s);

    const float* bt = sb(st);
    const bool full = k0 + BN <= Sk && (!causal || k0 + BN - 1 <= q0 + shift);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int c = acc_col(lane, e), i = (e >> 1) & 1;
      float x = fmaf(s[e], sl2, bt[c]);
      if (!full && (k0 + c >= Sk || (causal && k0 + c > row[i] + shift)))
        x = -INFINITY;
      s[e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int i = (e >> 1) & 1;
      float p = exp2f(s[e] - m[i]);
      ls[i] += p;
      if (DROP)
        p = keep(seed2m, row[i], k0 + acc_col(lane, e), Sk, thresh)
                ? p * inv_keep
                : 0.f;
      s[e] = p;
    }
    uint32_t ph[BN / 16][4], pl[BN / 16][4];   // p as bf16 hi + lo
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) a_frag2(ph[j], pl[j], s, j);
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

    // o += p_hi v + p_lo v
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      wgmma_rs<HD>(o, ph[j], desc_mn<HD, BN>(sv(st), j));
      wgmma_rs<HD>(o, pl[j], desc_mn<HD, BN>(sv(st), j));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<HD / 2>(o);
    fence_frag<BN / 4>(&ph[0][0]);
    fence_frag<BN / 4>(&pl[0][0]);
    __syncthreads();   // the stage is refilled at the top of the next tile
  }
  cp_async_wait<0>();

  // l summed over the quad's columns; out = o / l, lse = m ln 2 + log l
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  // rows that see no key: the mean of the masked v (flash_tc.cuh)
  float den0[2] = {1.f, 1.f};
  if (causal && q0 + shift < 0)
    empty_row_mean<HD, DROP>(o, den0, row, lane, vb, lv.r, Sq, Sk, seed2m,
                             thresh, inv_keep);
  bf16* ob = out + b * lo.b + h * lo.h;
#pragma unroll
  for (int e = 0; e < HD / 2; e += 2) {
    const int i = (e >> 1) & 1;
    if (row[i] < Sq) {
      const float den = l[i] == 0.f ? den0[i] : l[i];
      *reinterpret_cast<__nv_bfloat162*>(ob + row[i] * lo.r +
                                         acc_col(lane, e)) =
          __floats2bfloat162_rn(o[e] / den, o[e + 1] / den);
    }
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row[i] < Sq)
        lse[((size_t)b * H + h) * Sq + row[i]] =
            l[i] == 0.f ? NEG_INF + logf(1e-30f) : m[i] * LN2 + logf(l[i]);
  }
}

// what every instance's launch takes besides the pointers
struct Args {
  tc::Strides lq, lk, lv, lo;
  int B, Sq, Sk, H;
  float scale;
  int causal;
  const unsigned* seed;   // the dropout seed, read on the device
  unsigned thresh;
  float inv_keep;
};

template <int HD, bool DROP>
int launch_tf32(const void* q, const void* k, const void* v,
                const float* bias, void* out, float* lse, const Args& a,
                cudaStream_t stream) {
  const size_t smem = TfSmem<HD>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tf32<HD, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + TF_BM - 1) / TF_BM, a.H, a.B);
  flash_fwd_tf32<HD, DROP><<<grid, TF_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(out), lse,
      a.lq, a.lk, a.lv, a.lo, a.Sq, a.Sk, a.H, a.scale,
      a.causal, a.seed, a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

template <int HD, bool DROP>
int launch_tc(const void* q, const void* k, const void* v, const float* bias,
              void* out, float* lse, const Args& a, cudaStream_t stream) {
  const size_t smem = TcSmem<HD>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc<HD, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + TC_BM - 1) / TC_BM, a.H, a.B);
  flash_fwd_tc<HD, DROP><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, static_cast<bf16*>(out), lse,
      a.lq, a.lk, a.lv, a.lo, a.Sq, a.Sk, a.H, a.scale,
      a.causal, a.seed, a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch(const void* q, const void* k, const void* v, const float* bias,
             void* out, float* lse, int dtype, const Args& a,
             cudaStream_t stream) {
  const bool drop = a.thresh != 0u;
  if (dtype == 0)
    return drop ? launch_tf32<HD, true>(q, k, v, bias, out, lse, a, stream)
                : launch_tf32<HD, false>(q, k, v, bias, out, lse, a, stream);
  if (dtype == 1)
    return drop ? launch_tc<HD, true>(q, k, v, bias, out, lse, a, stream)
                : launch_tc<HD, false>(q, k, v, bias, out, lse, a, stream);
  return (int)cudaErrorInvalidValue;
}
}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success), or
// cudaErrorInvalidValue for a head_dim or dtype without a template
// instance. dtype: 0 = fp32, 1 = bf16 (q/k/v/out; bias and lse are fp32).
// thresh == 0 means no dropout; otherwise seed points to the mask's
// uint32 seed on the device (the low word of an int64 works), which every
// block reads once, so a CUDA graph replays with the seed of the step.
// strides: 12 element strides, (batch, row,
// head) of q, k, v and out in that order; head_dim is contiguous. fp32:
// every stride a multiple of 4 elements and every pointer 16-byte aligned
// (float4 loads); bf16: strides a multiple of 8 elements, pointers 16-byte
// aligned (16-byte cp.async). lse [B, H, Sq] is contiguous.
extern "C" int pt_flash_attention_fwd(
    const void* q, const void* k, const void* v, const float* bias, void* out,
    float* lse, const long long* strides, int B, int Sq, int Sk, int H,
    int hd, float scale, int causal, int dtype, const unsigned* seed,
    unsigned thresh, float inv_keep, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0) return 0;
  const Args a = {{strides[0], strides[1], strides[2]},
                  {strides[3], strides[4], strides[5]},
                  {strides[6], strides[7], strides[8]},
                  {strides[9], strides[10], strides[11]},
                  B, Sq, Sk, H, scale, causal, seed, thresh, inv_keep};
  switch (hd) {
    case 32:
      return dispatch<32>(q, k, v, bias, out, lse, dtype, a, stream);
    case 64:
      return dispatch<64>(q, k, v, bias, out, lse, dtype, a, stream);
    case 128:
      return dispatch<128>(q, k, v, bias, out, lse, dtype, a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
