// Paged cached-KV decode attention for Hopper (sm_90a):
//     out[b, h*HD + d] = sum_{t <= pos[b]} softmax_t(q_bh . k_t * scale) v_t[d]
// where token t of row b lives at page table[b, t / P], offset t % P of
// the pools [num_pages, P, kvdim].
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// _pa_kernel: q [B, n*HD] fp32, pools fp32, table [B, MP] int32,
// pos [B] int32 -> [B, n*HD] fp32.
//
// What bounds it on the H100 (device memory 3.35 TB/s; fp32 on CUDA
// cores 67 TFLOP/s data sheet): reading the context's keys and values,
// 2 * (pos + 1) * HD * 4 bytes per (row, head) against 4 flops per
// element read, so it is bound by bytes. The design reads each needed
// k/v element once and nothing else: only pages 0 .. pos / P of the row,
// only positions 0 .. pos. The TPU kernel DMAs all MP pages and masks
// positions past pos to weight exactly 0; not reading them gives the same
// function.
//
// Design: the rows of one call differ in length by up to MP * P tokens,
// so a block per (row, head) leaves the longest row to set the pace. Each
// row's context is cut into fixed chunks of CHUNK tokens instead, one
// block per (chunk, head, row); blocks of chunks past pos exit at once.
//  * Inside a chunk each group of HD/4 lanes takes every G-th token and
//    keeps its own online softmax (running max m, sum l, unnormalised
//    o[HD]); it has the k and v float4s of UNROLL tokens in flight
//    together before it uses any. The groups are combined in group order
//    through shared memory into the chunk's (m, l, o).
//  * A row that fits one chunk writes o / l at once. Otherwise each chunk
//    leaves its (m, l, o) in a workspace and takes a ticket of its
//    (row, head); the block that takes the last one combines every chunk
//    in chunk order, never in arrival order, writes the output and resets
//    the ticket to 0. One launch a call, no partial sums left behind.
//  * CHUNK is a constant of the kernel, so the plan of a row, and the
//    order of every sum in it, is a function of the row's own pos: a row's
//    result never depends on B or on the other rows (the serving gate
//    "continuous = sequential, bit for bit" rests on it).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
// context tokens a block: 128 measured fastest over the serving path's
// own traffic (rows at 5 to 1531 tokens), 256 at chip_smoke's spread of
// lengths (tools/profile_stream_kernels.py, cases serve and chip_smoke)
constexpr int CHUNK = 128;
constexpr int UNROLL = 8;     // tokens a lane group has in flight

template <int HD>
struct Layout {
  static constexpr int LPT = HD / 4;          // lanes a token
  static constexpr int G = THREADS / LPT;     // lane groups a block
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ pool_k,
                       const float* __restrict__ pool_v,
                       const int* __restrict__ table,
                       const int* __restrict__ pos, float* __restrict__ out,
                       float* __restrict__ part, int* __restrict__ tickets,
                       int page, int mp, int kvdim, float scale) {
  constexpr int LPT = Layout<HD>::LPT;
  constexpr int G = Layout<HD>::G;
  __shared__ int pids[CHUNK + 1];     // the chunk's page ids
  __shared__ float gm[G], gl[G];
  __shared__ __align__(16) float go[G * HD];
  __shared__ int last;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ctx = mp * page;
  int len = pos[b] + 1;
  len = len < 1 ? 1 : (len > ctx ? ctx : len);
  const int nchunks = (len + CHUNK - 1) / CHUNK;
  if (c >= nchunks) return;
  const int tid = threadIdx.x, grp = tid / LPT, lig = tid % LPT;
  const int t_begin = c * CHUNK;
  const int t_end = min(t_begin + CHUNK, len);
  const int p_first = t_begin / page;
  const int npg = (t_end - 1) / page - p_first + 1;
  for (int i = tid; i < npg; i += THREADS)
    pids[i] = table[(size_t)b * mp + p_first + i];
  const size_t col = (size_t)h * HD + lig * 4;
  const float4 q4 = ldg4(q + (size_t)b * kvdim + col);
  __syncthreads();

  // lane group grp takes tokens t0 + grp + G * u of each pass
  float m = -INFINITY, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t0 = t_begin; t0 < t_end; t0 += G * UNROLL) {
    float4 k4[UNROLL], v4[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + grp + G * u;
      k4[u] = v4[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < t_end) {
        const size_t off =
            ((size_t)pids[t / page - p_first] * page + t % page) * kvdim +
            col;
        k4[u] = ldg4(pool_k + off);
        v4[u] = ldg4(pool_v + off);
      }
    }
    float s[UNROLL];
    float mx = m;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float d = q4.x * k4[u].x;
      d = fmaf(q4.y, k4[u].y, d);
      d = fmaf(q4.z, k4[u].z, d);
      d = fmaf(q4.w, k4[u].w, d);
#pragma unroll
      for (int o = LPT / 2; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      s[u] = t0 + grp + G * u < t_end ? d * scale : -INFINITY;
      mx = fmaxf(mx, s[u]);
    }
    // positions past t_end (and a pass with none of the group's tokens)
    // get weight exactly 0: exp(-inf) = 0, with no inf - inf
    const float ms = mx == -INFINITY ? 0.f : mx;
    const float corr = expf(m - ms);
    l *= corr;
    acc.x *= corr;
    acc.y *= corr;
    acc.z *= corr;
    acc.w *= corr;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float p = expf(s[u] - ms);
      l += p;
      acc.x = fmaf(p, v4[u].x, acc.x);
      acc.y = fmaf(p, v4[u].y, acc.y);
      acc.z = fmaf(p, v4[u].z, acc.z);
      acc.w = fmaf(p, v4[u].w, acc.w);
    }
    m = mx;
  }
  if (lig == 0) {
    gm[grp] = m;
    gl[grp] = l;
  }
  *reinterpret_cast<float4*>(go + grp * HD + lig * 4) = acc;
  __syncthreads();

  // the groups in group order (group 0 holds the chunk's first token, so
  // its max is finite)
  const size_t row_head = (size_t)b * gridDim.y + h;
  float* mine = part + (row_head * gridDim.x + c) * (HD + 2);
  if (tid < HD) {
    float M = gm[0];
#pragma unroll
    for (int g = 1; g < G; ++g) M = fmaxf(M, gm[g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float w = expf(gm[g] - M);
      L = fmaf(gl[g], w, L);
      O = fmaf(go[g * HD + tid], w, O);
    }
    if (nchunks == 1) {
      out[(size_t)b * kvdim + (size_t)h * HD + tid] = O / L;
    } else {
      mine[2 + tid] = O;
      if (tid == 0) {
        mine[0] = M;
        mine[1] = L;
      }
    }
  }
  if (nchunks == 1) return;

  // the last chunk of (row, head) to arrive combines them all in order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + row_head, 1) == nchunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* first = part + row_head * gridDim.x * (HD + 2);
  if (tid < HD) {
    float M = __ldcg(first);
    for (int k = 1; k < nchunks; ++k)
      M = fmaxf(M, __ldcg(first + (size_t)k * (HD + 2)));
    float L = 0.f, O = 0.f;
    for (int k = 0; k < nchunks; ++k) {
      const float* pk = first + (size_t)k * (HD + 2);
      const float w = expf(__ldcg(pk) - M);
      L = fmaf(__ldcg(pk + 1), w, L);
      O = fmaf(__ldcg(pk + 2 + tid), w, O);
    }
    out[(size_t)b * kvdim + (size_t)h * HD + tid] = O / L;
  }
  if (tid == 0) tickets[row_head] = 0;
}

template <int HD>
int launch(const float* q, const float* pool_k, const float* pool_v,
           const int* table, const int* pos, float* out, float* part,
           int* tickets, int B, int n, int page, int mp, int kvdim,
           float scale, cudaStream_t stream) {
  dim3 grid((mp * page + CHUNK - 1) / CHUNK, n, B);
  paged_attention_kernel<HD><<<grid, THREADS, 0, stream>>>(
      q, pool_k, pool_v, table, pos, out, part, tickets, page, mp, kvdim,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success), or
// cudaErrorInvalidValue for a head_dim without a template instance or q
// and pools not 16-byte aligned. q and the pools must be contiguous. part
// holds B * n * ceil(MP * P / CHUNK) * (hd + 2) floats; tickets B * n
// ints, all 0 (every launch leaves them 0 again).
extern "C" int pt_paged_attention(const float* q, const float* pool_k,
                                  const float* pool_v, const int* table,
                                  const int* pos, float* out, float* part,
                                  int* tickets, int B, int n, int hd,
                                  int page, int mp, int kvdim, float scale,
                                  cudaStream_t stream) {
  if (B <= 0) return 0;
  if (page <= 0 || mp <= 0 ||
      (reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(pool_k) |
       reinterpret_cast<size_t>(pool_v)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return launch<32>(q, pool_k, pool_v, table, pos, out, part, tickets, B,
                        n, page, mp, kvdim, scale, stream);
    case 64:
      return launch<64>(q, pool_k, pool_v, table, pos, out, part, tickets, B,
                        n, page, mp, kvdim, scale, stream);
    case 128:
      return launch<128>(q, pool_k, pool_v, table, pos, out, part, tickets,
                         B, n, page, mp, kvdim, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
