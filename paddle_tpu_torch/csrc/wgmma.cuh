// Hopper (sm_90a) tensor-core building blocks shared by the bf16 wgmma
// kernels of this directory: the flash kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu, through flash_tc.cuh), the conv kernel
// (conv_bn_relu.cu) and the int8 GEMM (int8_gemm.cu). Shared-memory tiles
// in the wgmma swizzled layouts and their cp.async loader, matrix
// descriptors, the wgmma.mma_async wrappers and the accumulator and
// register-A fragment maps. kernels/_build.py hashes every csrc/*.cuh into
// each library's name, so an edit here rebuilds all of them.
//
// Tiles. A tile holds R rows of HD bf16 values, in "slabs" of ROWB bytes a
// row: HD = 32 is one slab of 64-byte rows in the 64-byte swizzle, HD = 64
// one slab of 128-byte rows in the 128-byte swizzle, HD = 128 two such
// slabs (columns 0-63, then 64-127). In a slab, row r lies at r * ROWB and
// its 16-byte chunk c at chunk c ^ ((r * ROWB / 128) mod (ROWB / 16)): the
// XOR of address bits [4, 7) with bits [7, 10) that the hardware applies
// for the 128-byte swizzle (bits [4, 6) with [7, 9) for the 64-byte one).
// Tiles start on 1024-byte boundaries, so every 8-row atom is aligned and
// a descriptor's base-offset field stays 0.
//
// One tile layout serves both operand majors:
//  * K-major (the tile's columns are the reduction, as q and k in q k^T,
//    or the conv's input pixels): 8-row groups at SBO = 8 * ROWB; the k-th
//    16-column step starts 32 * k bytes into the row (the next slab every
//    128 bytes); LBO is unused (1).
//  * MN-major (the tile's columns are the output's M or N, its rows the
//    reduction, as v in p v, the conv's weight or w8^T): the k-th step
//    starts 16 * k rows in, 8-row groups along the reduction at SBO = 8 *
//    ROWB, the next 64 columns (the next slab) at LBO = R * ROWB. wgmma
//    reads it with the operand's transpose bit.
//
// Accumulators. Thread t of a warpgroup (warp w = t / 32, lane l) holds
// element e of an m64nN fp32 accumulator at row 16 w + l / 4 + 8 ((e / 2)
// mod 2) and column 8 (e / 4) + 2 (l mod 4) + (e mod 2). The A operand of
// m64nNk16 from registers has the same row/column pattern for its 16
// columns, two bf16 a register: so the accumulator of one product,
// rounded to bf16 pairs, is the A fragment of the next with no shuffle
// (a_frag2), and a thread builds its A fragment of a row-major tile from
// the same rows and columns.
//
// The descriptors and the register-A map were first checked on the card
// at single-tile shapes under the flash kernels; every later operand
// (transposed A and B from shared memory) reuses them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; n < 16 source bytes zero-fill the rest
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's generic-proxy shared writes (cp.async, st.shared) become
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins the registers of an accumulator after wgmma_wait: no read of them
// may move above the wait
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for A fragments in registers: they must outlive the wgmma
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// x0, x1 as a pair of bf16 terms each: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the A fragments of k-step j, accumulator columns 16 j .. 16 j + 15, as
// two bf16 terms: hi, the value rounded to bf16 (what the reference
// multiplies), and lo, its rounding residual rounded to bf16. hi + lo
// carries 16 significant bits; a product over both is the fp32 product
// to about 2^-17.
__device__ __forceinline__ void a_frag2(uint32_t* hi, uint32_t* lo,
                                        const float* d, int j) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    split2(d[8 * j + 2 * r], d[8 * j + 2 * r + 1], hi[r], lo[r]);
}

// the row (0-63 in the warpgroup's 64) and column of accumulator element e
__device__ __forceinline__ int acc_row(int lane, int warp, int e) {
  return 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int lane, int e) {
  return 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
}

template <int HD>
struct Geo {
  static constexpr int ROWB = HD * 2 < 128 ? HD * 2 : 128;  // bytes a row
  static constexpr int SLABS = HD * 2 / ROWB;
  static constexpr int CPR = HD / 8;         // 16-byte chunks a row
  static constexpr int CPS = ROWB / 16;      // of them in one slab
  static constexpr int SHIFT = ROWB == 128 ? 0 : 1;   // row bits -> xor
  static constexpr uint64_t MODE = ROWB == 128 ? 1 : 2;  // 128B / 64B
};

// the shared address of 16-byte chunk c (columns 8 c .. 8 c + 7) of row r
// in an R-row tile of HD columns: its slab, row and swizzled chunk
template <int HD, int R>
__device__ __forceinline__ uint32_t tile_chunk(uint32_t tile, int r, int c) {
  using G = Geo<HD>;
  const int slab = c / G::CPS, cs = c % G::CPS;
  return tile + slab * (R * G::ROWB) + r * G::ROWB +
         ((cs ^ ((r >> G::SHIFT) & (G::CPS - 1))) << 4);
}

// rows [r0, r0 + R) of an operand (base at its (b, h), row stride rs
// elements) into the tile at shared address dst; rows past nrows are
// zeros. NT threads share the copies, 16 bytes each.
template <int HD, int R, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base,
                                          long long rs, int r0, int nrows,
                                          int tid) {
  using G = Geo<HD>;
  constexpr int TOTAL = R * G::CPR;
#pragma unroll
  for (int i = 0; i < (TOTAL + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (TOTAL % NT != 0 && e >= TOTAL) break;
    const int r = e / G::CPR, c = e % G::CPR;
    const bool ok = r0 + r < nrows;
    cp_async16(tile_chunk<HD, R>(dst, r, c),
               ok ? base + (long long)(r0 + r) * rs + c * 8 : base,
               ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}

// K-major operand: tile rows [row0, row0 + 64 or N) as M or N, head_dim
// columns [16 j, 16 j + 16) as the reduction
template <int HD, int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int j) {
  using G = Geo<HD>;
  const uint32_t a = tile + (j * 32 / G::ROWB) * (R * G::ROWB) +
                     row0 * G::ROWB + (j * 32) % G::ROWB;
  return desc(a, 16, 8 * G::ROWB, G::MODE);
}

// MN-major operand: tile rows [16 j, 16 j + 16) as the reduction, all
// head_dim columns as N
template <int HD, int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int j) {
  using G = Geo<HD>;
  return desc(tile + j * 16 * G::ROWB, R * G::ROWB, 8 * G::ROWB, G::MODE);
}

// wgmma.mma_async m64nNk16, bf16 in, fp32 accumulate. ss: A and B from
// shared memory, both K-major; acc = 0 overwrites d. rs: A from registers,
// B from shared memory MN-major (transpose bit), accumulating into d.
#define PT_A4(d, i) \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define PT_A16(d, i) \
  PT_A4(d, i), PT_A4(d, (i) + 4), PT_A4(d, (i) + 8), PT_A4(d, (i) + 12)
#define PT_ACC16(d) PT_A16(d, 0)
#define PT_ACC32(d) PT_A16(d, 0), PT_A16(d, 16)
#define PT_ACC64(d) PT_A16(d, 0), PT_A16(d, 16), PT_A16(d, 32), PT_A16(d, 48)

__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : PT_ACC16(d)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : PT_ACC32(d)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : PT_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : PT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : PT_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ss with transposed operands: A and B from shared memory, TA / TB the
// transpose bits (1: MN-major, read through desc_mn). The conv kernel
// reads its weight tile (B, Co contiguous) with TB; the int8 GEMM's
// decode instance reads w8^T (A, N contiguous) with TA.
__device__ __forceinline__ void wgmma_ss_tb_n128(float* d, uint64_t da,
                                                 uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : PT_ACC64(d)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_ta_n8(float* d, uint64_t da,
                                               uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 1, 0;\n}\n"
      : PT_A4(d, 0)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_ta_n16(float* d, uint64_t da,
                                                uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 1, 0;\n}\n"
      : PT_A4(d, 0), PT_A4(d, 4)
      : "l"(da), "l"(db), "r"(acc));
}


#undef PT_ACC64
#undef PT_ACC32
#undef PT_ACC16
#undef PT_A16
#undef PT_A4

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int acc) {
  static_assert(N == 32 || N == 64, "ss instances: N = 32, 64");
  if constexpr (N == 32)
    wgmma_ss_n32(d, da, db, acc);
  else
    wgmma_ss_n64(d, da, db, acc);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 128, "rs instances: N = 32-128");
  if constexpr (N == 32)
    wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

// MN-major A (TA): m64nNk16, N = 8 or 16
template <int N>
__device__ __forceinline__ void wgmma_ss_ta(float* d, uint64_t da,
                                            uint64_t db, int acc) {
  static_assert(N == 8 || N == 16, "ss_ta instances: N = 8, 16");
  if constexpr (N == 8)
    wgmma_ss_ta_n8(d, da, db, acc);
  else
    wgmma_ss_ta_n16(d, da, db, acc);
}

}  // namespace tc
