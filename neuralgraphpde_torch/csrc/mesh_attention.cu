// K8: multi-head attention restricted to each node's neighbourhood on a
// mesh, o_i = sum_{j in N(i)} softmax_j(q_i . k_j / sqrt(d)) v_j per head,
// with N(i) given as a block-sparse layout of 64 x 64 tiles of the node
// order: row block b's tiles are cols[row_ptr[b] .. row_ptr[b + 1]), and
// masks[t * 64 + r] holds bit c where node 64 b + r attends to node
// 64 cols[t] + c. The relation is symmetric, so row block b's tiles are
// also column block b's, with the same masks read transposed.
// (kernels/attention_kernels.py builds the layout and says more.)
//
// It replaces no TPU kernel: the JAX package has no attention.
//
// What bounds it on the H100: operations, in true float32 on the CUDA
// cores (67 TFLOP/s). Every product is a register tile of fmaf's:
// - 256 threads a block as 16 x 16; a thread holds a 4 x 4 tile of scores
//   (rows ty + 16 i, columns tx + 16 j), so a warp reads 2 rows of one
//   operand and 16 of the other a step, float4 along the depth from rows
//   padded to d + 4 floats (no bank conflicts), 64 fmaf's for 8 loads;
// - products with a 64-deep sum (probabilities times values) hold 4 rows
//   of d / 16 columns a thread (tx * 4 + 64 h), float4 reads of the
//   values and of the probabilities, which go through shared memory
//   (64 x 80 floats);
// - flash-style forward: one block a (64-query block, head) holds its Q
//   tile, and streams its row's K and V tiles through shared memory while
//   the scores, the online softmax (a running max and sum a row, kept by
//   every thread of the row and combined by half-warp shuffles) and the
//   output stay in registers; it writes O and one log-sum-exp a
//   (node, head), nothing of size pairs. Q, K and V tiles take 101 KB, so
//   two blocks share an SM and one's loads overlap the other's products;
// - the backward recomputes the probabilities from the log-sum-exp in two
//   kernels: bwd_kv, one block a (64-key block, head), walks its row's
//   tiles for dK and dV (the scores transposed: rows are keys), and bwd_q,
//   one block a (64-query block, head), walks its row again for dQ. No
//   atomics: every sum is taken in one order, the same bits on every run.
// Heads of 64 or 128 floats; q, k, v and their gradients are (n, heads *
// d) row-major, head h in columns h d .. (h + 1) d.
#include <math_constants.h>

#include "common.cuh"

namespace {

using ngpde::cp_async16;
using ngpde::cp_async_commit;
using ngpde::cp_async_wait;
using ngpde::ld4;
using ngpde::part;

constexpr int kBlock = 64;    // nodes a block, a tile's side
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPStride = 80;   // row stride of a 64 x 64 tile in shared memory

template <int D>
struct Tiles {
  static constexpr int kStride = D + 4;  // a row of a 64 x D tile
  static constexpr int kTile = kBlock * kStride;
  // a slot of shared memory: a 64 x D tile or a 64 x 64 one
  static constexpr int kSlot =
      kTile > kBlock * kPStride ? kTile : kBlock * kPStride;
  static constexpr int kCols = D / 16;  // output columns a thread
};

// rows row0 .. row0 + 63 of head h of x (n rows of `stride` floats) into
// tile, by cp.async; rows past n are zeros. Needs a commit and a wait.
template <int D>
__device__ __forceinline__ void load_tile(float* tile,
                                          const float* __restrict__ x,
                                          long long row0, int n, int stride,
                                          int h) {
  constexpr int kVec = D / 4;
  for (int f = threadIdx.x; f < kBlock * kVec; f += kThreads) {
    const int r = f / kVec;
    const int c = (f - r * kVec) * 4;
    const long long row = row0 + r;
    const bool live = row < n;
    const float* src = live ? x + row * stride + h * D + c : x;
    cp_async16(tile + r * Tiles<D>::kStride + c, src, live ? 16 : 0);
  }
}

// acc[i][j] += sum_k a[row ty + 16 i][k] * b[row tx + 16 j][k], k < D
template <int D>
__device__ __forceinline__ void mm_nt(float (&acc)[4][4],
                                      const float* __restrict__ a,
                                      const float* __restrict__ b, int ty,
                                      int tx) {
  constexpr int kS = Tiles<D>::kStride;
#pragma unroll 4
  for (int k = 0; k < D; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ld4(a + (ty + 16 * i) * kS + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = ld4(b + (tx + 16 * j) * kS + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// acc[i][4 h + u] += sum_c p[row ty + 16 i][c] * b[c][tx * 4 + 64 h + u],
// c < 64: p a 64 x 64 tile of stride kPStride, b a 64 x D tile
template <int D>
__device__ __forceinline__ void mm_nn(float (&acc)[4][Tiles<D>::kCols],
                                      const float* __restrict__ p,
                                      const float* __restrict__ b, int ty,
                                      int tx) {
  constexpr int kS = Tiles<D>::kStride;
  constexpr int kH = D / 64;
#pragma unroll 2
  for (int c = 0; c < kBlock; c += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = ld4(p + (ty + 16 * i) * kPStride + c);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 bv[kH];
#pragma unroll
      for (int h = 0; h < kH; ++h)
        bv[h] = ld4(b + (c + u) * kS + tx * 4 + 64 * h);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pi = part(pv[i], u);
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          acc[i][4 * h] = fmaf(pi, bv[h].x, acc[i][4 * h]);
          acc[i][4 * h + 1] = fmaf(pi, bv[h].y, acc[i][4 * h + 1]);
          acc[i][4 * h + 2] = fmaf(pi, bv[h].z, acc[i][4 * h + 2]);
          acc[i][4 * h + 3] = fmaf(pi, bv[h].w, acc[i][4 * h + 3]);
        }
      }
    }
  }
}

// s[i][j] into the 64 x 64 tile p (stride kPStride)
__device__ __forceinline__ void store_scores(float* p, const float (&s)[4][4],
                                             int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p[(ty + 16 * i) * kPStride + tx + 16 * j] = s[i][j];
}

// acc * mul into rows row0 + ty + 16 i (< n) of head h of out
template <int D>
__device__ __forceinline__ void store_rows(
    float* __restrict__ out, const float (&acc)[4][Tiles<D>::kCols],
    const float (&mul)[4], long long row0, int n, int stride, int h, int ty,
    int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = row0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      const float4 v = make_float4(acc[i][4 * g] * mul[i],
                                   acc[i][4 * g + 1] * mul[i],
                                   acc[i][4 * g + 2] * mul[i],
                                   acc[i][4 * g + 3] * mul[i]);
      *reinterpret_cast<float4*>(out + row * stride + h * D + tx * 4 +
                                 64 * g) = v;
    }
  }
}

// the sum / max over the 16 threads of a half warp (one row of scores)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ bool attends(long long word, int c) {
  return (word >> c) & 1;
}

// o and lse (n, heads) of one (64-query block, head)
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    attention_fwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse,
                         const int* __restrict__ row_ptr,
                         const int* __restrict__ cols,
                         const long long* __restrict__ masks, int n,
                         int heads, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + Tiles<D>::kSlot;
  float* vs = ks + Tiles<D>::kSlot;
  float* ps = ks;  // the probabilities, once the key tile's scores are taken
  const int b = blockIdx.x, h = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int stride = heads * D;
  const long long row0 = (long long)b * kBlock;
  load_tile<D>(qs, q, row0, n, stride, h);
  float m[4], l[4], acc[4][Tiles<D>::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;  // finite: a tile with no pair for the row keeps alpha 1
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < Tiles<D>::kCols; ++c) acc[i][c] = 0.f;
  }
  const int t1 = row_ptr[b + 1];
  for (int t = row_ptr[b]; t < t1; ++t) {
    const long long key0 = (long long)cols[t] * kBlock;
    load_tile<D>(ks, k, key0, n, stride, h);
    load_tile<D>(vs, v, key0, n, stride, h);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[4][4] = {};
    mm_nt<D>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long word = masks[(long long)t * kBlock + ty + 16 * i];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = attends(word, tx + 16 * j) ? s[i][j] * scale
                                              : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < Tiles<D>::kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every thread has read the key tile
    store_scores(ps, s, ty, tx);
    __syncthreads();
    mm_nn<D>(acc, ps, vs, ty, tx);
    __syncthreads();  // before the next tiles land
  }
  cp_async_wait<0>();  // a row block with no tile (none in a real layout)
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  store_rows<D>(o, acc, inv, row0, n, stride, h, ty, tx);
  if (tx == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = row0 + ty + 16 * i;
      if (row < n)
        lse[row * heads + h] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
    }
}

// dk and dv of one (64-key block, head): the block's row of tiles is its
// column, the masks read with keys as rows and queries as bits
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_kv_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            const int* __restrict__ row_ptr,
                            const int* __restrict__ cols,
                            const long long* __restrict__ masks, int n,
                            int heads, float scale) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + Tiles<D>::kSlot;
  float* qs = vs + Tiles<D>::kSlot;
  float* dos = qs + Tiles<D>::kSlot;
  float* ps = dos + Tiles<D>::kSlot;
  const int b = blockIdx.x, h = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int stride = heads * D;
  const long long key0 = (long long)b * kBlock;
  load_tile<D>(ks, k, key0, n, stride, h);
  load_tile<D>(vs, v, key0, n, stride, h);
  float ak[4][Tiles<D>::kCols], av[4][Tiles<D>::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < Tiles<D>::kCols; ++c) ak[i][c] = av[i][c] = 0.f;
  const int t1 = row_ptr[b + 1];
  for (int t = row_ptr[b]; t < t1; ++t) {
    const long long qrow0 = (long long)cols[t] * kBlock;
    load_tile<D>(qs, q, qrow0, n, stride, h);
    load_tile<D>(dos, dout, qrow0, n, stride, h);
    cp_async_commit();
    float lq[4], dq[4];  // the log-sum-exp and delta of queries tx + 16 j
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long row = qrow0 + tx + 16 * j;
      lq[j] = row < n ? lse[row * heads + h] : 0.f;
      dq[j] = row < n ? delta[row * heads + h] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    float st[4][4] = {}, dpt[4][4] = {};
    mm_nt<D>(st, ks, qs, ty, tx);
    mm_nt<D>(dpt, vs, dos, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long word = masks[(long long)t * kBlock + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = attends(word, tx + 16 * j)
                            ? expf(st[i][j] * scale - lq[j])
                            : 0.f;
        st[i][j] = p;
        dpt[i][j] = p * (dpt[i][j] - dq[j]);
      }
    }
    store_scores(ps, st, ty, tx);
    __syncthreads();
    mm_nn<D>(av, ps, dos, ty, tx);
    __syncthreads();
    store_scores(ps, dpt, ty, tx);
    __syncthreads();
    mm_nn<D>(ak, ps, qs, ty, tx);
    __syncthreads();  // before the next tiles land
  }
  cp_async_wait<0>();
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  const float sc[4] = {scale, scale, scale, scale};
  store_rows<D>(dk, ak, sc, key0, n, stride, h, ty, tx);
  store_rows<D>(dv, av, one, key0, n, stride, h, ty, tx);
}

// dq of one (64-query block, head)
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_q_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq,
                           const int* __restrict__ row_ptr,
                           const int* __restrict__ cols,
                           const long long* __restrict__ masks, int n,
                           int heads, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + Tiles<D>::kSlot;
  float* ks = dos + Tiles<D>::kSlot;
  float* vs = ks + Tiles<D>::kSlot;
  float* ps = vs;  // dS, once the value tile's products are taken
  const int b = blockIdx.x, h = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int stride = heads * D;
  const long long row0 = (long long)b * kBlock;
  load_tile<D>(qs, q, row0, n, stride, h);
  load_tile<D>(dos, dout, row0, n, stride, h);
  float lr[4], dr[4], acc[4][Tiles<D>::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = row0 + ty + 16 * i;
    lr[i] = row < n ? lse[row * heads + h] : 0.f;
    dr[i] = row < n ? delta[row * heads + h] : 0.f;
#pragma unroll
    for (int c = 0; c < Tiles<D>::kCols; ++c) acc[i][c] = 0.f;
  }
  const int t1 = row_ptr[b + 1];
  for (int t = row_ptr[b]; t < t1; ++t) {
    const long long key0 = (long long)cols[t] * kBlock;
    load_tile<D>(ks, k, key0, n, stride, h);
    load_tile<D>(vs, v, key0, n, stride, h);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mm_nt<D>(s, qs, ks, ty, tx);
    mm_nt<D>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long word = masks[(long long)t * kBlock + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = attends(word, tx + 16 * j)
                            ? expf(s[i][j] * scale - lr[i])
                            : 0.f;
        dp[i][j] = p * (dp[i][j] - dr[i]);
      }
    }
    __syncthreads();  // every thread has read the value tile
    store_scores(ps, dp, ty, tx);
    __syncthreads();
    mm_nn<D>(acc, ps, ks, ty, tx);
    __syncthreads();  // before the next tiles land
  }
  cp_async_wait<0>();
  const float sc[4] = {scale, scale, scale, scale};
  store_rows<D>(dq, acc, sc, row0, n, stride, h, ty, tx);
}

// shared floats of each kernel: its slots of a 64 x D tile or a 64 x 64
// one (the forward's and bwd_q's probabilities take a slot of a tile)
template <int D>
constexpr int fwd_floats() { return 3 * Tiles<D>::kSlot; }
template <int D>
constexpr int bwd_kv_floats() { return 5 * Tiles<D>::kSlot; }
template <int D>
constexpr int bwd_q_floats() { return 4 * Tiles<D>::kSlot; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int floats) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              floats * static_cast<int>(sizeof(float)));
}

template <int D>
cudaError_t fwd(const float* q, const float* k, const float* v, float* o,
                float* lse, const int* row_ptr, const int* cols,
                const long long* masks, int n, int blocks, int heads,
                float scale, cudaStream_t stream) {
  cudaError_t err = allow_smem(attention_fwd_kernel<D>, fwd_floats<D>());
  if (err != cudaSuccess) return err;
  attention_fwd_kernel<D><<<dim3(blocks, heads), kThreads,
                            fwd_floats<D>() * sizeof(float), stream>>>(
      q, k, v, o, lse, row_ptr, cols, masks, n, heads, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd(const float* q, const float* k, const float* v,
                const float* dout, const float* lse, const float* delta,
                float* dq, float* dk, float* dv, const int* row_ptr,
                const int* cols, const long long* masks, int n, int blocks,
                int heads, float scale, cudaStream_t stream) {
  cudaError_t err =
      allow_smem(attention_bwd_kv_kernel<D>, bwd_kv_floats<D>());
  if (err != cudaSuccess) return err;
  err = allow_smem(attention_bwd_q_kernel<D>, bwd_q_floats<D>());
  if (err != cudaSuccess) return err;
  attention_bwd_kv_kernel<D><<<dim3(blocks, heads), kThreads,
                               bwd_kv_floats<D>() * sizeof(float), stream>>>(
      q, k, v, dout, lse, delta, dk, dv, row_ptr, cols, masks, n, heads,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_q_kernel<D><<<dim3(blocks, heads), kThreads,
                              bwd_q_floats<D>() * sizeof(float), stream>>>(
      q, k, v, dout, lse, delta, dq, row_ptr, cols, masks, n, heads, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o (n, heads * d) and lse (n, heads) f32, 16-byte aligned; the
// layout's row_ptr (blocks + 1) and cols int32, masks (tiles, 64) int64;
// d 64 or 128. Returns a cudaError_t.
int ngpde_mesh_attention_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const void* row_ptr,
                             const void* cols, const void* masks, int n,
                             int blocks, int heads, int d, double scale,
                             void* stream_ptr) {
  if (n == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* f = static_cast<const float*>(q);
  const auto* kk = static_cast<const float*>(k);
  const auto* vv = static_cast<const float*>(v);
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* cc = static_cast<const int*>(cols);
  const auto* mm = static_cast<const long long*>(masks);
  auto* oo = static_cast<float*>(o);
  auto* ll = static_cast<float*>(lse);
  const float s = static_cast<float>(scale);
  cudaError_t err;
  if (d == 128)
    err = fwd<128>(f, kk, vv, oo, ll, rp, cc, mm, n, blocks, heads, s, stream);
  else if (d == 64)
    err = fwd<64>(f, kk, vv, oo, ll, rp, cc, mm, n, blocks, heads, s, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// the gradients dq, dk, dv (n, heads * d) of the forward above from dout
// (n, heads * d), its lse and delta (n, heads) = rowsum(dout * o) a head:
// bwd_kv then bwd_q on the stream. Returns a cudaError_t.
int ngpde_mesh_attention_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv,
                             const void* row_ptr, const void* cols,
                             const void* masks, int n, int blocks, int heads,
                             int d, double scale, void* stream_ptr) {
  if (n == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* qq = static_cast<const float*>(q);
  const auto* kk = static_cast<const float*>(k);
  const auto* vv = static_cast<const float*>(v);
  const auto* g = static_cast<const float*>(dout);
  const auto* ll = static_cast<const float*>(lse);
  const auto* de = static_cast<const float*>(delta);
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* cc = static_cast<const int*>(cols);
  const auto* mm = static_cast<const long long*>(masks);
  auto* a = static_cast<float*>(dq);
  auto* b = static_cast<float*>(dk);
  auto* c = static_cast<float*>(dv);
  const float s = static_cast<float>(scale);
  cudaError_t err;
  if (d == 128)
    err = bwd<128>(qq, kk, vv, g, ll, de, a, b, c, rp, cc, mm, n, blocks,
                   heads, s, stream);
  else if (d == 64)
    err = bwd<64>(qq, kk, vv, g, ll, de, a, b, c, rp, cc, mm, n, blocks,
                  heads, s, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
