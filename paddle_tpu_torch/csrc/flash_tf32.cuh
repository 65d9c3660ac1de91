// Split-TF32 ("3xTF32") pieces of the fp32 tensor-core flash kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu) for Hopper, sm_90a:
// fp32 tiles in the wgmma swizzled layouts, their cp.async loader, the
// hi/lo split and the transposed tiles that the split writes, and the
// wgmma.mma_async m64nNk8 .tf32 wrappers. Builds on flash_tc.cuh (the
// descriptor word, cp.async, the wgmma fences, the accumulator layout).
//
// The scheme. An fp32 operand x is carried as two TF32 terms: hi = x with
// its low 13 mantissa bits cleared and lo = x - hi (exact in fp32; the
// tensor core keeps its top 11 significant bits). The tensor core ignores
// the low 13 bits of a .tf32 operand in shared memory: on the H100, the
// kernels fed the landed fp32 tiles as hi gave the same bits as with those
// bits cleared first (PERF.md). So a landed tile is its own hi operand,
// and the split pass writes only lo (and the transposed tiles); register
// fragments clear the bits themselves (frag32). A product a b is taken as
// a_lo b_hi + a_hi b_lo + a_hi b_hi, three wgmma into one fp32
// accumulator, the small terms first; the dropped a_lo b_lo and lo's
// rounding leave about 2^-21 of |a b|: fp32 accuracy at the tensor cores'
// TF32 rate (495 TFLOP/s dense), where one TF32 pass alone (2^-11) misses
// the kernels' 1e-4 gates against the fp32 plain versions.
//
// Tiles. A tile of R rows of RB bytes (RB = 4 HD for an operand tile, 4 R'
// for a transposed one) lies in slabs of ROWB = min(RB, 128) bytes a row,
// the next slab at R * ROWB, with the 128-byte (or 64-byte) swizzle of
// flash_tc.cuh; tiles start on 1024-byte boundaries. Every wgmma operand
// of .tf32 is K-major (the instruction has no transpose bit for 32-bit
// types): the reduction runs along a tile row, the k-th step of 8 values
// 32 k bytes into it.
//
// Transposed tiles. Where the reduction runs over sequence positions (p v
// in the forward, p^T do and ds^T q in the dkv pass, ds k in the dq pass)
// the B operand has to be the position-major tile turned over: head_dim
// rows, positions along the row. The split pass writes it from the landed
// tile, and permutes the positions of each group of 8 on the way (tperm):
// the A fragment of m64nNk8 .tf32 holds reduction columns l % 4 and
// l % 4 + 4 of each step, while the fp32 accumulator that becomes A holds
// columns 2 (l % 4) and 2 (l % 4) + 1. Feeding accumulator column 2 i as
// reduction index i and 2 i + 1 as i + 4 (frag32) makes the product the
// same sum in a known order, provided B's reduction rows are permuted alike.

#pragma once

#include "flash_tc.cuh"

namespace tc {

// a tile of RB-byte rows: slab width, 16-byte chunks a slab, the
// swizzle's row shift and the descriptor's layout mode
template <int RB>
struct GeoB {
  static_assert(RB % 64 == 0, "tf32 tiles: rows of 64 bytes or more");
  static constexpr int ROWB = RB < 128 ? RB : 128;
  static constexpr int CPS = ROWB / 16;
  static constexpr int SHIFT = ROWB == 128 ? 0 : 1;
  static constexpr uint64_t MODE = ROWB == 128 ? 1 : 2;  // 128B / 64B
};

// byte offset of 16-byte chunk c of row r in a tile of R rows of RB bytes
template <int RB, int R>
__device__ __forceinline__ uint32_t chunk_at(int r, int c) {
  using G = GeoB<RB>;
  const int slab = c / G::CPS, cs = c % G::CPS;
  return slab * (R * G::ROWB) + r * G::ROWB +
         ((cs ^ ((r >> G::SHIFT) & (G::CPS - 1))) << 4);
}

// K-major operand: tile rows [row0, row0 + 64 or N), reduction values
// [8 j, 8 j + 8) of each row
template <int RB, int R>
__device__ __forceinline__ uint64_t desc_kb(uint32_t tile, int row0, int j) {
  using G = GeoB<RB>;
  const uint32_t a = tile + (j * 32 / G::ROWB) * (R * G::ROWB) +
                     row0 * G::ROWB + (j * 32) % G::ROWB;
  return desc(a, 16, 8 * G::ROWB, G::MODE);
}

// rows [r0, r0 + R) of an fp32 operand (base at its (b, h), row stride rs
// elements) into the tile at shared address dst; rows past nrows are zeros
template <int HD, int R, int NT>
__device__ __forceinline__ void load_tile32(uint32_t dst, const float* base,
                                            long long rs, int r0, int nrows,
                                            int tid) {
  constexpr int CPR = HD / 4, TOTAL = R * CPR;
#pragma unroll
  for (int i = 0; i < (TOTAL + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (TOTAL % NT != 0 && e >= TOTAL) break;
    const int r = e / CPR, c = e % CPR;
    const bool ok = r0 + r < nrows;
    cp_async16(dst + chunk_at<HD * 4, R>(r, c),
               ok ? base + (long long)(r0 + r) * rs + c * 4 : base,
               ok ? 16 : 0);
  }
}

__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

// the column of position r (0 .. R-1) in a transposed tile: within each
// group of 8, position 2 i goes to column i and 2 i + 1 to column i + 4
__device__ __forceinline__ int tperm(int r) {
  return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
}

// The split pass over a landed tile of R positions x HD fp32 values (the
// cp.async target, generic address `tile`, which stays the hi operand):
// with LO, lo into the tile `lo` (same layout); with T, hi and lo into the
// transposed tiles th and tl (HD rows of R positions, permuted by tperm).
// NT threads share the work,
// neighbouring lanes on neighbouring positions: their transposed stores
// land in one row of the transposed tile, on distinct banks, and their
// 16-byte loads and stores cover each row's swizzled chunks once.
template <int HD, int R, int NT, bool LO, bool T>
__device__ __forceinline__ void split_tile(const uint8_t* tile, uint8_t* lo,
                                           uint8_t* th, uint8_t* tl,
                                           int tid) {
  constexpr int CPR = HD / 4, TOTAL = R * CPR;
  for (int e = tid; e < TOTAL; e += NT) {
    const int r = e % R, c = e / R;
    const uint32_t off = chunk_at<HD * 4, R>(r, c);
    const float4 x = *reinterpret_cast<const float4*>(tile + off);
    const float4 h = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z),
                                 tf32_hi(x.w));
    const float4 l = make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w);
    if (LO) *reinterpret_cast<float4*>(lo + off) = l;
    if (T) {
      const int col = tperm(r);
      const float hv[4] = {h.x, h.y, h.z, h.w}, lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 4 * c + i;
        const uint32_t t = chunk_at<R * 4, HD>(d, col >> 2) + (col & 3) * 4;
        *reinterpret_cast<float*>(th + t) = hv[i];
        *reinterpret_cast<float*>(tl + t) = lv[i];
      }
    }
  }
}

// the A fragments of reduction step j (accumulator columns 8 j .. 8 j + 7
// of d) as hi and lo TF32 terms, reduction index i <- column 2 i, i + 4 <-
// column 2 i + 1 (see tperm)
__device__ __forceinline__ void frag32(uint32_t* hi, uint32_t* lo,
                                       const float* d, int j) {
  const float x[4] = {d[4 * j], d[4 * j + 2], d[4 * j + 1], d[4 * j + 3]};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float h = tf32_hi(x[r]);
    hi[r] = __float_as_uint(h);
    lo[r] = __float_as_uint(x[r] - h);
  }
}

// wgmma.mma_async m64nNk8, tf32 in, fp32 accumulate, both operands K-major.
// ss: A and B from shared memory; acc = 0 overwrites d. rs: A from
// registers, accumulating into d.
#define PT_T4(d, i) \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define PT_T16(d, i) \
  PT_T4(d, i), PT_T4(d, (i) + 4), PT_T4(d, (i) + 8), PT_T4(d, (i) + 12)

template <int N>
__device__ __forceinline__ void wgmma_ss32(float* d, uint64_t da, uint64_t db,
                                           int acc) {
  static_assert(N == 16 || N == 32 || N == 64, "ss32 instances: N = 16-64");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
        : PT_T4(d, 0), PT_T4(d, 4)
        : "l"(da), "l"(db), "r"(acc));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, %16, %17, p, 1, 1;\n}\n"
        : PT_T16(d, 0)
        : "l"(da), "l"(db), "r"(acc));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
        : PT_T16(d, 0), PT_T16(d, 16)
        : "l"(da), "l"(db), "r"(acc));
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs32(float* d, const uint32_t* a,
                                           uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 128, "rs32 instances: N = 32-128");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : PT_T16(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, "
        "1;\n}\n"
        : PT_T16(d, 0), PT_T16(d, 16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : PT_T16(d, 0), PT_T16(d, 16), PT_T16(d, 32), PT_T16(d, 48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

#undef PT_T16
#undef PT_T4

// d (=, or += with acc) A B^T over a reduction of HD fp32 values, A the
// 64 rows of the K-major tiles (a_hi, a_lo) from row a0, B the N rows of
// (b_hi, b_lo): 3 HD / 8 wgmma, per step the two small terms, then hi hi
template <int HD, int RA, int N>
__device__ __forceinline__ void mma3_ss(float* d, uint32_t a_hi, uint32_t a_lo,
                                        int a0, uint32_t b_hi, uint32_t b_lo,
                                        bool acc) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const uint64_t ah = desc_kb<HD * 4, RA>(a_hi, a0, j);
    const uint64_t bh = desc_kb<HD * 4, N>(b_hi, 0, j);
    wgmma_ss32<N>(d, desc_kb<HD * 4, RA>(a_lo, a0, j), bh, acc || j > 0);
    wgmma_ss32<N>(d, ah, desc_kb<HD * 4, N>(b_lo, 0, j), 1);
    wgmma_ss32<N>(d, ah, bh, 1);
  }
}

// d += A B over a reduction of K positions, A as register fragments (hi
// and lo, K / 8 steps of 4 from frag32), B the transposed tiles (bt_hi,
// bt_lo) of HD rows: 3 K / 8 wgmma
template <int HD, int K>
__device__ __forceinline__ void mma3_rs(float* d, uint32_t (*a_hi)[4],
                                        uint32_t (*a_lo)[4],
                                        uint32_t bt_hi, uint32_t bt_lo) {
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    const uint64_t bh = desc_kb<K * 4, HD>(bt_hi, 0, j);
    wgmma_rs32<HD>(d, a_lo[j], bh);
    wgmma_rs32<HD>(d, a_hi[j], desc_kb<K * 4, HD>(bt_lo, 0, j));
    wgmma_rs32<HD>(d, a_hi[j], bh);
  }
}

// The exponent of p = exp(s * scale + bias - lse) in natural units and in
// the plain version's order, each step rounded once (no contraction). Where
// a row's visible keys are all masked by a finite key bias (-1e4), s * scale
// + bias and lse sit near -1e4, whose fp32 ulp is 2^-10: the difference of
// the two keeps that rounding, so the fp32 instances round it where the
// plain version does; the bf16 instances' log2 form (one fma, lse times
// log2 e) moves p by up to 7e-4 there, outside the fp32 gates.
__device__ __forceinline__ float nat_exponent(float acc, float scale,
                                              float bias, float lse) {
  return __fsub_rn(__fadd_rn(__fmul_rn(acc, scale), bias), lse);
}

// the rows (keys or q rows) of a streamed fp32 tile of about BYTES at a
// head_dim, and at least 16 (the smallest N of wgmma_ss32, and 64-byte
// rows in the transposed tiles); the tile's bytes
template <int HD, int BYTES>
struct Tf32Tile {
  static constexpr int N = BYTES / (4 * HD) < 16 ? 16 : BYTES / (4 * HD);
  static constexpr int SIZE = N * HD * 4;
};

}  // namespace tc
