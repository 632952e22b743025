// K5: the GNO kernel-network matvec fused with the receiver sum, over a
// receiver-sorted CSR whose `col` holds edge ids (the `tcsr_edges` layout),
//   out[n, o] = sum_{s in row n} w[s] sum_i h[snd_s, i]
//               * (sum_k ph[e_s, k] Wl[i, k, o] + bl[i, o]),
// with e_s = col[s] and snd_s = senders[e_s], in true f32, and its VJP: dph
// (E, K), the per-edge dh_e (E, IN), dWl (IN, K, OUT) and dbl (IN, OUT).
// Replaces neuralgraphpde/kernels/gno_kernels.py::_fused_gno_fwd and
// ::_fused_gno_bwd_pallas.
//
// Reduce, then contract. With ph' = [ph, 1] and Wl' = [Wl; bl] along k (KB
// = K + 1 columns with a bias, K without), the sum over a receiver's edges
// moves in front of the contraction:
//   S[n, i, k] = sum_{s in row n} w[s] h[snd_s, i] ph'[e_s, k]   (N, IN*KB)
//   out        = S . Wl'                          (N x IN*KB) (IN*KB x OUT)
// At the GNO Darcy widths (K 128, IN = OUT = 64, mean in-degree 18.6) a
// forward is 0.70 G multiply-adds instead of the TPU kernel's per-edge
// E*K*IN*OUT = 10.0 G. For an output cotangent g (N, OUT) the backward is
//   dS   = g . Wl'^T                              (N, IN*KB)
//   dWl' = S^T . g                                (IN*KB, OUT); dbl = k = K
//   dph'[e_s, k] = w[s] sum_i h[snd_s, i] dS[n, i, k]
//   dh_e[e_s, i] = w[s] sum_k ph'[e_s, k] dS[n, i, k]
// S is recomputed in the backward, not kept from the forward. dh_e goes
// onto the senders outside the kernel (index_add_), as the JAX package's
// segment_sum does.
//
// Dtypes, as the TPU kernels take them: ph (with out, g and dph) in TP, h
// in TH, Wl' (with dWl') in TW, each f32 or bf16. Every operand is
// converted to f32 as it is loaded; S, dS, the per-edge dh_e, the products'
// accumulators and split partials stay f32, and each result is rounded to
// its dtype once, when it is stored (dh_e after the sum onto the senders).
// Under the precision policy TW is bf16, and TP and TH are bf16 or f32.
//
// What bounds it on the H100: at those widths the two products (541 M
// multiply-adds each) and the reduce (158 M) are far above the ridge point
// against the 34 MB of S written and read, so the limit is the CUDA cores'
// f32 FMA rate (the tensor cores would round to TF32) and the shared-memory
// traffic that feeds them.
//
// Design:
// - reduce: one block per receiver row. The row's edges, in chunks of 32,
//   are gathered into shared memory (w*h rows and ph' rows); each thread
//   owns 4x4 tiles of (i, k) and adds the chunk's edges in slot order. A
//   later chunk of the same row adds onto the S entries the same thread
//   wrote: no atomics, the same sums on every run.
// - products: one tiled kernel (a 64x64 output tile per block of 256
//   threads, 4x4 per thread, 16-deep shared-memory stages) over strided
//   operands, so S.Wl', g.Wl'^T and S^T.g are the same code. A product with
//   few output tiles is split along its inner dimension into per-split
//   partials that a second kernel adds in split order: deterministic.
// - per-edge backward: one block per receiver row keeps dS[n] in shared
//   memory twice, row-major and transposed, so that both per-chunk products
//   (dph' = hw . dS[n] and dh_e = ph' . dS[n]^T) read it with 16-byte loads
//   across consecutive threads. Every edge id appears once in `col`, so dph
//   and dh_e rows are written directly, with no scatter.
#include "common.cuh"

namespace {

using ngpde::from_f32;
using ngpde::to_f32;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kTE = 32;  // edge slots per chunk
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
// returned by the launchers for widths outside the envelope (cudaError_t
// codes are >= 0)
constexpr int kOutsideEnvelope = -1;
// K, IN and OUT each at most this (keeps the int offsets in range)
constexpr int kMaxWidth = 4096;
constexpr int kMaxSplits = 65535;  // gridDim.z
constexpr int kBM = 64, kBN = 64, kBK = 16;  // product tiles

struct Gno {
  int k;    // ph width
  int kb;   // k + 1 with a bias, else k: the columns of ph' and rows of Wl'
  int in;   // h width
  int out;  // output width
  int kp;   // kb padded to a multiple of 4
  int inp;  // in padded to a multiple of 4
};

__host__ __device__ __forceinline__ int pad4(int d) { return (d + 3) & ~3; }

// floats of dynamic shared memory of the two per-row kernels
__host__ __device__ inline int reduce_smem_floats(const Gno& p) {
  return kTE * (p.inp + p.kp);
}
__host__ __device__ inline int edge_bwd_smem_floats(const Gno& p) {
  return 2 * p.inp * p.kp + kTE * (p.inp + p.kp);
}

// The chunk [c0, c1) of slots: w[s] * h[snd_s] rows into hw (kTE x inp) and
// ph'[e_s] rows into pp (kTE x kp), as f32, zero-padded.
template <typename TP, typename TH>
__device__ void gather_chunk(const Gno& p, const int* __restrict__ col,
                             const float* __restrict__ ew,
                             const int* __restrict__ senders,
                             const TP* __restrict__ ph,
                             const TH* __restrict__ h, int c0, int c1,
                             float* hw, float* pp) {
  for (int idx = threadIdx.x; idx < kTE * p.inp; idx += kThreads) {
    const int e = idx / p.inp, i = idx % p.inp;
    const int s = c0 + e;
    float v = 0.f;
    if (s < c1 && i < p.in)
      v = ew[s] * to_f32(h[(long long)senders[col[s]] * p.in + i]);
    hw[idx] = v;
  }
  for (int idx = threadIdx.x; idx < kTE * p.kp; idx += kThreads) {
    const int e = idx / p.kp, k = idx % p.kp;
    const int s = c0 + e;
    float v = 0.f;
    if (s < c1) {
      if (k < p.k)
        v = to_f32(ph[(long long)col[s] * p.k + k]);
      else if (k < p.kb)
        v = 1.f;  // the bias column of ph'
    }
    pp[idx] = v;
  }
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a,
                                       const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
}

// (a[0][q], a[1][q], a[2][q], a[3][q]): column q of four rows held as
// float4s, so that acc[r][c] += sum_q a[r][q] * b[q][c] is four outer
// products (q is a constant after unrolling)
__device__ __forceinline__ float4 column(const float4 (&a)[4], int q) {
  auto at = [q](const float4 v) {
    return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
  };
  return make_float4(at(a[0]), at(a[1]), at(a[2]), at(a[3]));
}

// S[r, i, k] for one receiver row r per block, stored (N, in, kb) in f32.
template <typename TP, typename TH>
__global__ void __launch_bounds__(kThreads)
    gno_reduce_kernel(Gno p, const int* __restrict__ row_ptr,
                      const int* __restrict__ col,
                      const float* __restrict__ ew,
                      const int* __restrict__ senders,
                      const TP* __restrict__ ph,
                      const TH* __restrict__ h, float* __restrict__ s_out) {
  extern __shared__ float4 sm4[];
  float* hw = reinterpret_cast<float*>(sm4);
  float* pp = hw + kTE * p.inp;
  const int r = blockIdx.x;
  const int e_begin = row_ptr[r], e_end = row_ptr[r + 1];
  const int kt_n = p.kp >> 2;
  const int tiles = (p.inp >> 2) * kt_n;
  float* srow = s_out + (long long)r * p.in * p.kb;
  // one pass per chunk; a row with no edges takes one pass that stores 0
  for (int c0 = e_begin;; c0 += kTE) {
    const int c1 = min(c0 + kTE, e_end);
    gather_chunk(p, col, ew, senders, ph, h, c0, c1, hw, pp);
    __syncthreads();
    const int ne = c1 - c0;
    for (int t = threadIdx.x; t < tiles; t += kThreads) {
      const int i0 = (t / kt_n) << 2, k0 = (t % kt_n) << 2;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = i0 + a, k = k0 + c;
          acc[a][c] = (c0 != e_begin && i < p.in && k < p.kb)
                          ? srow[i * p.kb + k]
                          : 0.f;
        }
      for (int e = 0; e < ne; ++e)
        fma4x4(acc, *reinterpret_cast<const float4*>(hw + e * p.inp + i0),
               *reinterpret_cast<const float4*>(pp + e * p.kp + k0));
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = i0 + a, k = k0 + c;
          if (i < p.in && k < p.kb) srow[i * p.kb + k] = acc[a][c];
        }
    }
    if (c1 >= e_end) break;
    __syncthreads();  // the next chunk overwrites hw and pp
  }
}

// C[m, n] = sum_k A(m, k) B(k, n) with A(m, k) = A[m*am + k*ak] and
// B(k, n) = B[k*bk + n*bn], for m < M, n < N, in f32. Block z of the grid's
// third dimension takes the inner range [z*kc, min((z+1)*kc, K)) and writes
// the (M, N) slab C + z*M*N (zeros for an empty range).
template <typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(int M, int N, int K, int kc, const TA* __restrict__ A,
                long long am, long long ak, const TB* __restrict__ B,
                long long bk, long long bn, TC* __restrict__ C) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN + 4];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int kbeg = blockIdx.z * kc;
  const int kend = min(kbeg + kc, K);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    // neighbouring threads read neighbouring addresses of whichever index
    // has unit stride
    for (int idx = threadIdx.x; idx < kBM * kBK; idx += kThreads) {
      int m, k;
      if (ak == 1) {
        m = idx / kBK;
        k = idx % kBK;
      } else {
        k = idx / kBM;
        m = idx % kBM;
      }
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < kend) ? to_f32(A[gm * am + gk * ak]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < kBK * kBN; idx += kThreads) {
      int k, n;
      if (bn == 1) {
        k = idx / kBN;
        n = idx % kBN;
      } else {
        n = idx / kBK;
        k = idx % kBK;
      }
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < kend && gn < N) ? to_f32(B[gk * bk + gn * bn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k)
      fma4x4(acc, *reinterpret_cast<const float4*>(&As[k][ty * 4]),
             *reinterpret_cast<const float4*>(&Bs[k][tx * 4]));
    __syncthreads();
  }
  TC* c = C + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gm = m0 + ty * 4 + r, gn = n0 + tx * 4 + q;
      if (gm < M && gn < N) c[(long long)gm * N + gn] = from_f32<TC>(acc[r][q]);
    }
}

// out[i] = sum over splits z, in order, of partial[z * n + i], rounded to
// TC once
template <typename TC>
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  TC* __restrict__ out, int splits,
                                  long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = 0.f;
  for (int z = 0; z < splits; ++z) a += partial[z * n + i];
  out[i] = from_f32<TC>(a);
}

// dph' (in TP) and dh_e (f32) of one receiver row per block, from dS
// stored (N, in, kb).
template <typename TP, typename TH>
__global__ void __launch_bounds__(kThreads)
    gno_edge_bwd_kernel(Gno p, const int* __restrict__ row_ptr,
                        const int* __restrict__ col,
                        const float* __restrict__ ew,
                        const int* __restrict__ senders,
                        const TP* __restrict__ ph,
                        const TH* __restrict__ h,
                        const float* __restrict__ ds,
                        TP* __restrict__ dph,
                        float* __restrict__ dh_edge) {
  extern __shared__ float4 sm4[];
  float* dsm = reinterpret_cast<float*>(sm4);  // (inp, kp): dS[r]
  float* dst = dsm + p.inp * p.kp;             // (kp, inp): dS[r]^T
  float* hw = dst + p.kp * p.inp;              // (kTE, inp)
  float* pp = hw + kTE * p.inp;                // (kTE, kp)
  const int r = blockIdx.x;
  const int e_begin = row_ptr[r], e_end = row_ptr[r + 1];
  if (e_begin == e_end) return;  // the same for the whole block
  const float* drow = ds + (long long)r * p.in * p.kb;
  for (int idx = threadIdx.x; idx < p.inp * p.kp; idx += kThreads) {
    const int i = idx / p.kp, k = idx % p.kp;
    const float v = (i < p.in && k < p.kb) ? drow[i * p.kb + k] : 0.f;
    dsm[idx] = v;
    dst[k * p.inp + i] = v;
  }
  const int kt_n = p.kp >> 2, it_n = p.inp >> 2;
  for (int c0 = e_begin; c0 < e_end; c0 += kTE) {
    const int c1 = min(c0 + kTE, e_end);
    gather_chunk(p, col, ew, senders, ph, h, c0, c1, hw, pp);
    __syncthreads();
    const int et_n = (c1 - c0 + 3) >> 2;
    // dph'[e, k] = sum_i hw[e, i] dS[i, k]
    for (int t = threadIdx.x; t < et_n * kt_n; t += kThreads) {
      const int e0 = (t / kt_n) << 2, k0 = (t % kt_n) << 2;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
      for (int i = 0; i < p.inp; i += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q] = *reinterpret_cast<const float4*>(hw + (e0 + q) * p.inp + i);
          b[q] = *reinterpret_cast<const float4*>(dsm + (i + q) * p.kp + k0);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          fma4x4(acc, column(a, q), b[q]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int s = c0 + e0 + a;
        if (s >= c1) continue;
        const long long e = col[s];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (k0 + c < p.k) dph[e * p.k + k0 + c] = from_f32<TP>(acc[a][c]);
      }
    }
    // dh_e[e, i] = w[s] sum_k ph'[e, k] dS[i, k]
    for (int t = threadIdx.x; t < et_n * it_n; t += kThreads) {
      const int e0 = (t / it_n) << 2, i0 = (t % it_n) << 2;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
      for (int k = 0; k < p.kp; k += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q] = *reinterpret_cast<const float4*>(pp + (e0 + q) * p.kp + k);
          b[q] = *reinterpret_cast<const float4*>(dst + (k + q) * p.inp + i0);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          fma4x4(acc, column(a, q), b[q]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int s = c0 + e0 + a;
        if (s >= c1) continue;
        const long long e = col[s];
        const float w = ew[s];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (i0 + c < p.in) dh_edge[e * p.in + i0 + c] = w * acc[a][c];
      }
    }
    __syncthreads();  // the next chunk overwrites hw and pp
  }
}

// host: the widths, or kOutsideEnvelope. K5's envelope: K, IN and OUT
// from 1 to kMaxWidth, and the per-edge backward block (dS[n] twice plus a
// chunk's w*h and ph' rows, the largest of the kernels' blocks) within
// kMaxSmem bytes. Both launchers hold the widths to it, so a forward never
// runs whose backward could not.
int make_gno(int k, int in, int out, int has_bias, Gno* p) {
  if (k < 1 || in < 1 || out < 1 || k > kMaxWidth || in > kMaxWidth ||
      out > kMaxWidth)
    return kOutsideEnvelope;
  p->k = k;
  p->kb = k + (has_bias ? 1 : 0);
  p->in = in;
  p->out = out;
  p->kp = pad4(p->kb);
  p->inp = pad4(in);
  if ((long long)edge_bwd_smem_floats(*p) * (long long)sizeof(float) >
      kMaxSmem)
    return kOutsideEnvelope;
  return 0;
}

// C = A . B as gemm_kernel describes it; with splits > 1 through `partial`
// (splits * M * N floats) and sum_splits_kernel.
template <typename TA, typename TB, typename TC>
cudaError_t launch_gemm(int M, int N, int K, int splits, const TA* A,
                        long long am, long long ak, const TB* B,
                        long long bk, long long bn, TC* C, float* partial,
                        cudaStream_t stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  const int per = (K + splits - 1) / splits;
  const int kc = (per + kBK - 1) / kBK * kBK;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, splits);
  if (splits == 1) {
    gemm_kernel<TA, TB, TC><<<grid, kThreads, 0, stream>>>(
        M, N, K, kc, A, am, ak, B, bk, bn, C);
    return cudaGetLastError();
  }
  gemm_kernel<TA, TB, float><<<grid, kThreads, 0, stream>>>(
      M, N, K, kc, A, am, ak, B, bk, bn, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)M * N;
  sum_splits_kernel<TC><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      partial, C, splits, n);
  return cudaGetLastError();
}

template <typename TP, typename TH>
cudaError_t launch_reduce(const Gno& p, const int* row_ptr, const int* col,
                          const float* ew, const int* senders, const TP* ph,
                          const TH* h, float* s_buf, int n_rows,
                          cudaStream_t stream) {
  const int smem = reduce_smem_floats(p) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gno_reduce_kernel<TP, TH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  gno_reduce_kernel<TP, TH><<<n_rows, kThreads, smem, stream>>>(
      p, row_ptr, col, ew, senders, ph, h, s_buf);
  return cudaGetLastError();
}

// f(TP(), TH(), TW()) for the dtypes the flags pick (bf16 if set, else f32)
template <typename F>
int with_dtypes(int ph_bf16, int h_bf16, int w_bf16, F f) {
  auto pick_w = [&](auto tp, auto th) {
    return w_bf16 ? f(tp, th, bf16()) : f(tp, th, 0.f);
  };
  auto pick_h = [&](auto tp) {
    return h_bf16 ? pick_w(tp, bf16()) : pick_w(tp, 0.f);
  };
  return ph_bf16 ? pick_h(bf16()) : pick_h(0.f);
}

}  // namespace

extern "C" {

// out (n_rows, out_chs) in ph's dtype. ph (E, k); h (nodes, in); wlb (in,
// kb, out_chs) = [Wl; bl] along k (kb = k + has_bias); ph_bf16, h_bf16,
// w_bf16: the dtypes of ph, h and wlb (bf16 if set, else f32); s_buf:
// n_rows * in * kb floats of scratch; partial: splits * n_rows * out_chs
// floats when splits > 1. Returns a cudaError_t, or kOutsideEnvelope (-1).
int ngpde_gno_fwd(const int* row_ptr, const int* col, const float* ew,
                  const int* senders, const void* ph, const void* h,
                  const void* wlb, void* out, float* s_buf, float* partial,
                  int n_rows, int k, int in, int out_chs, int has_bias,
                  int splits, int ph_bf16, int h_bf16, int w_bf16,
                  void* stream_ptr) {
  Gno p;
  const int bad = make_gno(k, in, out_chs, has_bias, &p);
  if (bad != 0) return bad;
  if (splits < 1 || splits > kMaxSplits || n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return with_dtypes(ph_bf16, h_bf16, w_bf16, [&](auto tp, auto th, auto tw) {
    using TP = decltype(tp);
    using TH = decltype(th);
    using TW = decltype(tw);
    cudaError_t err = launch_reduce(
        p, row_ptr, col, ew, senders, static_cast<const TP*>(ph),
        static_cast<const TH*>(h), s_buf, n_rows, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int j = in * p.kb;
    return static_cast<int>(launch_gemm(
        n_rows, out_chs, j, splits, s_buf, j, 1, static_cast<const TW*>(wlb),
        out_chs, 1, static_cast<TP*>(out), partial, stream));
  });
}

// For the cotangent g_out (n_rows, out_chs) in ph's dtype: dph (E, k) in
// ph's dtype and dh_edge (E, in) in f32, one row per edge, written for every
// edge in `col` (the wrapper zeroes them first); dwlb (in, kb, out_chs) =
// [dWl; dbl] in wlb's dtype. s_buf and ds_buf: n_rows * in * kb floats
// each; partial: splits * in * kb * out_chs floats when splits > 1 (the
// split of S^T . g along the receivers); dtype flags as for the forward.
int ngpde_gno_bwd(const int* row_ptr, const int* col, const float* ew,
                  const int* senders, const void* ph, const void* h,
                  const void* wlb, const void* g_out, void* dph,
                  float* dh_edge, void* dwlb, float* s_buf, float* ds_buf,
                  float* partial, int n_rows, int k, int in, int out_chs,
                  int has_bias, int splits, int ph_bf16, int h_bf16,
                  int w_bf16, void* stream_ptr) {
  Gno p;
  const int bad = make_gno(k, in, out_chs, has_bias, &p);
  if (bad != 0) return bad;
  if (splits < 1 || splits > kMaxSplits || n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int j = in * p.kb;
  return with_dtypes(ph_bf16, h_bf16, w_bf16, [&](auto tp, auto th, auto tw) {
    using TP = decltype(tp);
    using TH = decltype(th);
    using TW = decltype(tw);
    const TP* php = static_cast<const TP*>(ph);
    const TH* hp = static_cast<const TH*>(h);
    const TW* wp = static_cast<const TW*>(wlb);
    const TP* gp = static_cast<const TP*>(g_out);
    cudaError_t err;
    if (n_rows > 0) {
      err = launch_reduce(p, row_ptr, col, ew, senders, php, hp, s_buf,
                          n_rows, stream);
      if (err != cudaSuccess) return static_cast<int>(err);
      // dS = g . Wl'^T: B(k = o, n = j) = wlb[j * out + o]
      err = launch_gemm(n_rows, j, out_chs, 1, gp, out_chs, 1, wp, 1,
                        out_chs, ds_buf, nullptr, stream);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    // dWl' = S^T . g: A(m = j, k = n) = S[n * J + j] (zeros without rows)
    err = launch_gemm(j, out_chs, n_rows, splits, s_buf, 1, j, gp, out_chs,
                      1, static_cast<TW*>(dwlb), partial, stream);
    if (err != cudaSuccess || n_rows == 0) return static_cast<int>(err);
    const int smem = edge_bwd_smem_floats(p) * (int)sizeof(float);
    err = cudaFuncSetAttribute(gno_edge_bwd_kernel<TP, TH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    gno_edge_bwd_kernel<TP, TH><<<n_rows, kThreads, smem, stream>>>(
        p, row_ptr, col, ew, senders, php, hp, ds_buf,
        static_cast<TP*>(dph), dh_edge);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
