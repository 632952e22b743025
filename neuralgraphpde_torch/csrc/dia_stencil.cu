// K2: DIA stencil SpMM and the fused GCN right-hand side,
//   acc[i, :] = sum_k vals[i, k] * x[i + offsets[k], :]   (0 <= i+off < n)
//   out       = act(acc @ W + b)   (W, b optional; plain stencil: act = id)
// Replaces neuralgraphpde/kernels/dia_kernels.py::_dia_rhs_fwd.
//
// T is the dtype of vals, x and W (f32 or bf16), TO the output's. Sums are
// f32 fmaf in ascending k, as the plain version's; with bf16 T the
// aggregate is rounded to bf16 before the W product, as the TPU kernel
// does. Neighbours outside [0, n) are masked here (their x reads as zero),
// so x is read unpadded. True f32 throughout: no tensor cores, no fast
// math. Deterministic: every output is written once, by one thread.
//
// What bounds it on the H100. The stencil moves x once, K values a row and
// the output: bytes (0.08 ms at the 512^2 grid, F 128), so it must spend
// few instructions per byte. The fused form adds 2 F O flops a row on the
// CUDA cores, so its product must spend few shared loads per FMA.
//
// The design:
// - stencil_vec, the aggregation both forms call: a thread owns R
//   consecutive rows x one 16-byte feature vector (4 f32 or 8 bf16); R is
//   kStencilRows in the stencil kernel, kFusedRows in the fused one. The
//   sorted offsets come cut into runs of consecutive values (at most kLmax
//   each; the wrapper's offset_runs). For a run the thread loads its
//   R + L - 1 x vectors once into registers and adds vals[i, k] *
//   x[i + o_k] for its R rows from them: on a grid's 9 offsets, 3 (R + 2)
//   16-byte loads for R rows x 9 FMAs a feature. vals come from a tile of
//   the block's rows staged in shared memory by one coalesced copy. Where
//   F is not a multiple of the vector or x is not 16-byte aligned, the same
//   schedule uses plain loads.
// - dia_stencil_kernel: 256 threads, a block of row groups x feature
//   vectors; the epilogue adds b and applies the activation in registers.
//   The fused form with W = None (bias and activation only) is this
//   kernel: the aggregation with no product.
// - dia_gcn_rhs_kernel: persistent (at most the SMs x the blocks that fit
//   on each), 128 threads, 64-row tiles. W is staged once per block into
//   shared memory as f32 (64 KB at 128 x 128) when it fits beside the
//   tile; otherwise it passes through double-buffered k-tiles of kKT rows
//   (cp.async for f32) in the same loop. Per tile: the aggregation into a
//   shared agg tile, then agg @ W register-tiled, 8 x 8 outputs a thread
//   (4 16-byte shared loads for 64 FMAs a k), then b, the activation and
//   the store. Two blocks fit on an SM at F 128, so one block's
//   aggregation runs beside the other's product.
// Indexing is 32-bit wherever n * max(F, O, K) < 2^31, else 64-bit.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

using ngpde::from_f32;
using ngpde::round_to;
using ngpde::to_f32;

constexpr int kMaxDiags = 32;
// consecutive rows a thread aggregates, in the stencil kernel and in the
// fused one (chip runs at the 512^2 grid: scripts/dia_variants.py)
constexpr int kStencilRows = 4;
constexpr int kFusedRows = 8;
constexpr int kLmax = 4;  // longest offset run loaded at once
constexpr int kThreads = 256;       // stencil kernel
constexpr int kMaxGroups = 32;      // row groups in a stencil block
constexpr int kFusedThreads = 128;  // fused kernel: 8 x 16 product threads
constexpr int kTile = 64;           // rows of a fused tile
constexpr int kChunk = 128;         // output columns of a product pass
constexpr int kKT = 32;             // rows of a streamed W k-tile
// dynamic shared memory a fused block may take for two to fit on an SM
constexpr int kTwoBlockSmem = 112 * 1024;

// offset runs: run q covers offsets k0[q] .. k0[q] + len[q] - 1, whose
// values are consecutive
struct Runs {
  int count;
  int k0[kMaxDiags];
  int len[kMaxDiags];
};

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);  // elements in 16 bytes
};

__device__ __forceinline__ unsigned word(const uint4& r, int q) {
  return q == 0 ? r.x : q == 1 ? r.y : q == 2 ? r.z : r.w;
}

// element e of a 16-byte vector of T, as f32 (e is a constant once
// unrolled)
template <typename T>
__device__ __forceinline__ float elem(const uint4& r, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(r, e));
  } else {
    const unsigned w = word(r, e >> 1);
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

template <typename T>
__device__ __forceinline__ unsigned bits(T v) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(v);
  } else {
    return __bfloat16_as_ushort(v);
  }
}

// x[j, f0 .. f0 + N) as raw bytes; zero where j is outside [0, n) or a
// feature is past F. vec: one 16-byte load (F a multiple of N, x aligned).
template <typename T, typename Idx>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ x, int j,
                                          int n, int F, int f0, bool vec) {
  constexpr int N = Vec<T>::N;
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (j < 0 || j >= n) return r;
  const T* p = x + (Idx)j * F + f0;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  unsigned w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (N == 4) {
      w[q] = f0 + q < F ? bits(p[q]) : 0u;
    } else {
      const unsigned lo = f0 + 2 * q < F ? bits(p[2 * q]) : 0u;
      const unsigned hi = f0 + 2 * q + 1 < F ? bits(p[2 * q + 1]) : 0u;
      w[q] = lo | (hi << 16);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// dst[0 .. M) = v as TO, in 8- or 16-byte stores (dst aligned to them)
template <typename TO, int M>
__device__ __forceinline__ void store_vec(TO* __restrict__ dst,
                                          const float* v) {
  if constexpr (sizeof(TO) == 4) {
#pragma unroll
    for (int q = 0; q < M / 4; ++q)
      reinterpret_cast<float4*>(dst)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
    unsigned w[M / 2];
#pragma unroll
    for (int q = 0; q < M / 2; ++q)
      w[q] = bits(from_f32<TO>(v[2 * q])) |
             (bits(from_f32<TO>(v[2 * q + 1])) << 16);
#pragma unroll
    for (int q = 0; q < M / 8; ++q)
      reinterpret_cast<uint4*>(dst)[q] =
          make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
    if constexpr (M % 8 != 0)
      *reinterpret_cast<uint2*>(dst + M - 4) = make_uint2(w[M / 2 - 2],
                                                         w[M / 2 - 1]);
  }
}

__device__ __forceinline__ float activate(int act, float h) {
  switch (act) {
    case ngpde::kTanh: return ngpde::activate<ngpde::kTanh>(h);
    case ngpde::kRelu: return ngpde::activate<ngpde::kRelu>(h);
    case ngpde::kSigmoid: return ngpde::activate<ngpde::kSigmoid>(h);
  }
  return h;
}

// The aggregation of both forms: acc[r][e] = sum_k vals[row0 + r, k] *
// x[row0 + r + offs[k], f0 + e] for R rows and one vector f0 = v * N.
// svals: the block's vals tile in shared memory (K a row), row0 at its row
// rloc0; offs: the offsets in shared memory.
template <typename T, typename Idx, int R>
__device__ __forceinline__ void stencil_vec(
    const float* svals, int K, int rloc0, const Runs& runs, const int* offs,
    const T* __restrict__ x, int n, int F, int row0, int v, bool vec,
    float (&acc)[R][Vec<T>::N]) {
  constexpr int N = Vec<T>::N;
  constexpr int M = R + kLmax - 1;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < N; ++e) acc[r][e] = 0.f;
  for (int q = 0; q < runs.count; ++q) {
    const int k0 = runs.k0[q];
    const int L = runs.len[q];
    const int jb = row0 + offs[k0];
    uint4 xs[M];
#pragma unroll
    for (int m = 0; m < M; ++m)
      xs[m] = m < R + L - 1 ? load_vec<T, Idx>(x, jb + m, n, F, v * N, vec)
                             : make_uint4(0u, 0u, 0u, 0u);
    const float* vr = svals + rloc0 * K + k0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int l = 0; l < kLmax; ++l) {
        if (l < L) {
          const float a = vr[r * K + l];
#pragma unroll
          for (int e = 0; e < N; ++e)
            acc[r][e] = fmaf(a, elem<T>(xs[r + l], e), acc[r][e]);
        }
      }
    }
  }
}

// svals[0 .. rows * K) = vals of rows row_base .., f32, zero past n
template <typename T, typename Idx>
__device__ __forceinline__ void stage_vals(float* svals,
                                           const T* __restrict__ vals, int K,
                                           int row_base, int rows, int n,
                                           int tid, int threads) {
  const int count = max(0, min(rows, n - row_base)) * K;
  const T* src = vals + (Idx)row_base * K;
  for (int idx = tid; idx < rows * K; idx += threads)
    svals[idx] = idx < count ? to_f32(src[idx]) : 0.f;
}

template <typename T, typename TO, typename Idx>
__global__ void __launch_bounds__(kThreads)
    dia_stencil_kernel(const T* __restrict__ vals, int K,
                       const int* __restrict__ offsets, Runs runs,
                       const T* __restrict__ x, const float* __restrict__ b,
                       TO* __restrict__ out, int n, int F, int act,
                       int groups, bool x_vec, bool out_vec) {
  constexpr int N = Vec<T>::N;
  constexpr int R = kStencilRows;
  extern __shared__ float svals[];  // groups * R rows x K
  __shared__ int offs[kMaxDiags];
  const int tid = threadIdx.x;
  const int rows = groups * R;
  const int row_base = blockIdx.x * rows;
  if (tid < K) offs[tid] = offsets[tid];
  stage_vals<T, Idx>(svals, vals, K, row_base, rows, n, tid, kThreads);
  __syncthreads();
  const int FV = (F + N - 1) / N;
  for (int p = tid; p < groups * FV; p += kThreads) {
    const int rg = p / FV;
    const int v = p - rg * FV;
    const int row0 = row_base + rg * R;
    if (row0 >= n) break;
    float acc[R][N];
    stencil_vec<T, Idx, R>(svals, K, rg * R, runs, offs, x, n, F, row0, v,
                           x_vec, acc);
    const int f0 = v * N;
    float bias[N];
#pragma unroll
    for (int e = 0; e < N; ++e)
      bias[e] = b != nullptr && f0 + e < F ? b[f0 + e] : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row0 + r >= n) break;
      float h[N];
#pragma unroll
      for (int e = 0; e < N; ++e) {
        h[e] = acc[r][e];
        if (b != nullptr) h[e] += bias[e];
        h[e] = activate(act, h[e]);
      }
      TO* dst = out + (Idx)(row0 + r) * F + f0;
      if (out_vec) {
        store_vec<TO, N>(dst, h);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e)
          if (f0 + e < F) dst[e] = from_f32<TO>(h[e]);
      }
    }
  }
}

// dst[0 .. rows) x kChunk = W[k0 .., c * kChunk ..) as f32, zero past F
// and O; f32 aligned W by 16-byte cp.async (the caller commits and waits),
// other W by plain loads
template <typename T, typename Idx>
__device__ __forceinline__ void load_w_tile(float* dst,
                                            const T* __restrict__ w, int k0,
                                            int rows, int c, int F, int O,
                                            bool w_async, int tid) {
  constexpr int kUnits = kChunk / 4;
  for (int idx = tid; idx < rows * kUnits; idx += kFusedThreads) {
    const int kr = idx / kUnits;
    const int col = c * kChunk + (idx - kr * kUnits) * 4;
    const int k = k0 + kr;
    float* d = dst + kr * kChunk + (col - c * kChunk);
    if constexpr (sizeof(T) == 4) {
      if (w_async) {
        const bool ok = k < F && col < O;
        ngpde::cp_async16(d, ok ? w + (Idx)k * O + col : w, ok ? 16 : 0);
        continue;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      d[e] = (k < F && col + e < O) ? to_f32(w[(Idx)k * O + col + e]) : 0.f;
  }
}

// acc += agg[tile rows, 0 .. kt) @ wt[0 .. kt, chunk]; thread (ty, tx)
// owns rows ty*4 + i and 32 + ty*4 + i, columns tx*4 + j and 64 + tx*4 + j
__device__ __forceinline__ void tile_product(const float* agg, int lda,
                                             const float* wt, int kt, int ty,
                                             int tx, float (&acc)[8][8]) {
  for (int k = 0; k < kt; k += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(agg + (ty * 4 + i) * lda + k);
      a[4 + i] = *reinterpret_cast<const float4*>(
          agg + (32 + ty * 4 + i) * lda + k);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wr = wt + (k + kk) * kChunk + tx * 4;
      const float4 w0 = *reinterpret_cast<const float4*>(wr);
      const float4 w1 = *reinterpret_cast<const float4*>(wr + 64);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
      }
    }
  }
}

template <typename T, typename TO, typename Idx>
__global__ void __launch_bounds__(kFusedThreads, 2)
    dia_gcn_rhs_kernel(const T* __restrict__ vals, int K,
                       const int* __restrict__ offsets, Runs runs,
                       const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ b, TO* __restrict__ out,
                       int n, int F, int O, int act, int Fp, bool w_whole,
                       bool x_vec, bool out_vec, bool w_async) {
  constexpr int N = Vec<T>::N;
  constexpr int R = kFusedRows;
  extern __shared__ float4 smem4[];
  const int nchunks = (O + kChunk - 1) / kChunk;
  float* wsm = reinterpret_cast<float*>(smem4);  // W, or two k-tiles
  float* agg = wsm + (w_whole ? nchunks * Fp * kChunk : 2 * kKT * kChunk);
  float* svals = agg + kTile * Fp;  // kTile x K
  __shared__ int offs[kMaxDiags];
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  if (tid < K) offs[tid] = offsets[tid];
  if (w_whole) {  // W once per block, each chunk Fp x kChunk
    for (int c = 0; c < nchunks; ++c)
      load_w_tile<T, Idx>(wsm + c * Fp * kChunk, w, 0, Fp, c, F, O, w_async,
                          tid);
    ngpde::cp_async_commit();
    ngpde::cp_async_wait<0>();
  }
  __syncthreads();
  const int FV = Fp / N;
  const int ntiles = (n + kTile - 1) / kTile;
  const int nkt = (Fp + kKT - 1) / kKT;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row_base = tile * kTile;
    stage_vals<T, Idx>(svals, vals, K, row_base, kTile, n, tid,
                       kFusedThreads);
    __syncthreads();
    // 1. the tile's aggregate, rounded through T, zero past n and F
    for (int p = tid; p < (kTile / R) * FV; p += kFusedThreads) {
      const int rg = p / FV;
      const int v = p - rg * FV;
      float acc[R][N];
      stencil_vec<T, Idx, R>(svals, K, rg * R, runs, offs, x, n, F,
                             row_base + rg * R, v, x_vec, acc);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float h[N];
        const bool row_ok = row_base + rg * R + r < n;
#pragma unroll
        for (int e = 0; e < N; ++e)
          h[e] = row_ok && v * N + e < F ? round_to<T>(acc[r][e]) : 0.f;
        store_vec<float, N>(agg + (rg * R + r) * Fp + v * N, h);
      }
    }
    __syncthreads();
    // 2. agg @ W by column chunks, 3. b, activation, store
    for (int c = 0; c < nchunks; ++c) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      if (w_whole) {
        tile_product(agg, Fp, wsm + c * Fp * kChunk, Fp, ty, tx, acc);
      } else {
        load_w_tile<T, Idx>(wsm, w, 0, min(kKT, Fp), c, F, O, w_async, tid);
        ngpde::cp_async_commit();
        for (int t = 0; t < nkt; ++t) {
          if (t + 1 < nkt) {
            const int k1 = (t + 1) * kKT;
            load_w_tile<T, Idx>(wsm + ((t + 1) & 1) * kKT * kChunk, w, k1,
                                min(kKT, Fp - k1), c, F, O, w_async, tid);
            ngpde::cp_async_commit();
            ngpde::cp_async_wait<1>();
          } else {
            ngpde::cp_async_wait<0>();
          }
          __syncthreads();
          tile_product(agg + t * kKT, Fp, wsm + (t & 1) * kKT * kChunk,
                       min(kKT, Fp - t * kKT), ty, tx, acc);
          __syncthreads();
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = row_base + (i < 4 ? ty * 4 + i : 32 + ty * 4 + i - 4);
        if (row >= n) continue;
#pragma unroll
        for (int hc = 0; hc < 2; ++hc) {
          const int col = c * kChunk + hc * 64 + tx * 4;
          if (col >= O) continue;
          float h[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            h[j] = acc[i][hc * 4 + j];
            if (b != nullptr && col + j < O) h[j] += b[col + j];
            h[j] = activate(act, h[j]);
          }
          TO* dst = out + (Idx)row * O + col;
          if (out_vec && col + 4 <= O) {
            store_vec<TO, 4>(dst, h);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (col + j < O) dst[j] = from_f32<TO>(h[j]);
          }
        }
      }
    }
    __syncthreads();  // the next tile rewrites agg and svals
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool wide_index(int n, int F, int O, int K) {
  const long long widest = std::max(std::max(F, O), K);
  return (long long)n * widest >= (1LL << 31);
}

template <typename T, typename TO, typename Idx>
cudaError_t launch_stencil(const void* vals, const int* offsets, int K,
                           const Runs& runs, const void* x, const float* b,
                           void* out, int n, int F, int act,
                           cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const int FV = (F + N - 1) / N;
  const int groups = std::max(1, std::min(kMaxGroups, kThreads / FV));
  const int rows = groups * kStencilRows;
  const size_t smem = sizeof(float) * rows * std::max(K, 1);
  const bool x_vec = F % N == 0 && aligned16(x);
  const bool out_vec = F % N == 0 && aligned16(out);
  dia_stencil_kernel<T, TO, Idx><<<(n + rows - 1) / rows, kThreads, smem,
                                   stream>>>(
      static_cast<const T*>(vals), K, offsets, runs, static_cast<const T*>(x),
      b, static_cast<TO*>(out), n, F, act, groups, x_vec, out_vec);
  return cudaGetLastError();
}

template <typename T, typename TO, typename Idx>
cudaError_t launch_gcn_rhs(const void* vals, const int* offsets, int K,
                           const Runs& runs, const void* x, const void* w,
                           const float* b, void* out, int n, int F, int O,
                           int act, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const int Fp = (F + N - 1) / N * N;
  const int nchunks = (O + kChunk - 1) / kChunk;
  const size_t tile_bytes = sizeof(float) * kTile * (Fp + std::max(K, 1));
  const size_t whole_bytes = sizeof(float) * nchunks * Fp * kChunk;
  const bool w_whole = tile_bytes + whole_bytes <= kTwoBlockSmem;
  const size_t smem =
      tile_bytes + (w_whole ? whole_bytes : sizeof(float) * 2 * kKT * kChunk);
  auto kernel = dia_gcn_rhs_kernel<T, TO, Idx>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kFusedThreads, smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (n + kTile - 1) / kTile;
  const int grid = std::max(1, std::min(ntiles, sms * std::max(per_sm, 1)));
  const bool x_vec = F % N == 0 && aligned16(x);
  const bool out_vec = O % 4 == 0 && aligned16(out);
  const bool w_async = O % 4 == 0 && aligned16(w);
  kernel<<<grid, kFusedThreads, smem, stream>>>(
      static_cast<const T*>(vals), K, offsets, runs, static_cast<const T*>(x),
      static_cast<const T*>(w), b, static_cast<TO*>(out), n, F, O, act, Fp,
      w_whole, x_vec, out_vec, w_async);
  return cudaGetLastError();
}

// the runs from the host's (k0, length) pairs: consecutive, each 1 ..
// kLmax long, covering 0 .. K - 1 once
bool make_runs(const int* pairs, int count, int K, Runs* runs) {
  if (count < 0 || count > K || (K > 0 && pairs == nullptr)) return false;
  int next = 0;
  for (int q = 0; q < count; ++q) {
    const int k0 = pairs[2 * q];
    const int len = pairs[2 * q + 1];
    if (k0 != next || len < 1 || len > kLmax) return false;
    runs->k0[q] = k0;
    runs->len[q] = len;
    next += len;
  }
  runs->count = count;
  return next == K;
}

bool valid(int act, int K) {
  return act >= 0 && act <= 3 && K >= 0 && K <= kMaxDiags;
}

}  // namespace

extern "C" {

// act: 0 identity, 1 tanh, 2 relu, 3 sigmoid; b may be null. runs: host
// array of n_runs (k0, length) pairs, the offset runs (offset_runs in
// kernels/dia_kernels.py).
int ngpde_dia_stencil(const void* vals, const int* offsets, int K,
                      const int* runs, int n_runs, const void* x,
                      const float* b, void* out, int n, int F, int act,
                      int in_bf16, int out_bf16, void* stream_ptr) {
  Runs r{};
  if (!valid(act, K) || !make_runs(runs, n_runs, K, &r))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || F == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  using bf16 = __nv_bfloat16;
  const bool wide = wide_index(n, F, F, K);
  cudaError_t err;
#define NGPDE_STENCIL(T, TO)                                                \
  (wide ? launch_stencil<T, TO, long long>(vals, offsets, K, r, x, b, out,  \
                                           n, F, act, s)                    \
        : launch_stencil<T, TO, int>(vals, offsets, K, r, x, b, out, n, F,  \
                                     act, s))
  if (!in_bf16 && !out_bf16)
    err = NGPDE_STENCIL(float, float);
  else if (!in_bf16)
    err = NGPDE_STENCIL(float, bf16);
  else if (!out_bf16)
    err = NGPDE_STENCIL(bf16, float);
  else
    err = NGPDE_STENCIL(bf16, bf16);
#undef NGPDE_STENCIL
  return static_cast<int>(err);
}

// W is (F, O) row-major in the dtype of vals; b (O,) f32 or null.
int ngpde_dia_gcn_rhs(const void* vals, const int* offsets, int K,
                      const int* runs, int n_runs, const void* x,
                      const void* w, const float* b, void* out, int n, int F,
                      int O, int act, int in_bf16, int out_bf16,
                      void* stream_ptr) {
  Runs r{};
  if (!valid(act, K) || F > 512 || w == nullptr ||
      !make_runs(runs, n_runs, K, &r))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || O == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  using bf16 = __nv_bfloat16;
  const bool wide = wide_index(n, F, O, K);
  cudaError_t err;
#define NGPDE_GCN(T, TO)                                                    \
  (wide ? launch_gcn_rhs<T, TO, long long>(vals, offsets, K, r, x, w, b,    \
                                           out, n, F, O, act, s)            \
        : launch_gcn_rhs<T, TO, int>(vals, offsets, K, r, x, w, b, out, n,  \
                                     F, O, act, s))
  if (!in_bf16 && !out_bf16)
    err = NGPDE_GCN(float, float);
  else if (!in_bf16)
    err = NGPDE_GCN(float, bf16);
  else if (!out_bf16)
    err = NGPDE_GCN(bf16, float);
  else
    err = NGPDE_GCN(bf16, bf16);
#undef NGPDE_GCN
  return static_cast<int>(err);
}

}  // extern "C"
