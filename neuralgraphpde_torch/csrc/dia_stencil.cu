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
// CUDA cores, so its product must spend few shared loads per FMA. The
// backward moves g, y, x and dx once (0.086 ms at the 512^2 grid, F = O =
// 64) and adds 4 F O flops a row (dx and dW).
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
// - dia_gcn_bwd_kernel, the fused form's backward (f32), on C^T:
//   persistent, 128 threads, 64-row tiles. Per tile: its vals and, for
//   dW, x's rows, copied by cp.async while the tile before it ran its
//   products; u = C^T dz by stencil_vec, each neighbour
//   row's g and y loaded and turned into dz = g * act'(y) in registers,
//   into a shared u tile; the tile's own rows' dz added to the thread's db
//   sums; dx = u W^T with 8 rows x 4 columns a thread against W^T staged
//   once per block (or streamed in k-tiles); dW += x^T u, 8 x 4 a thread,
//   held in registers over the block's tiles (F, O <= 64; wider, the
//   wrapper writes u and takes dW as one product).
//   dz and u never go to device memory. ngpde::sum_partials then adds the
//   blocks' dW and db partials in a fixed order: the same bits every run.
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
// the fused backward: consecutive rows a thread aggregates, rows of a db
// batch, columns of dx a product pass computes, and the widest F and O
// whose dW a block keeps in registers (kDwTile, DW_TILE in
// kernels/dia_kernels.py)
constexpr int kBwdRows = 4;
constexpr int kBwdBlocks = 3;  // blocks an SM the registers are held to
constexpr int kDbRows = 8;  // rows whose g and y a db batch loads at once
constexpr int kCols = 64;
constexpr int kDwTile = 64;

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

struct AsLoaded {
  __device__ __forceinline__ uint4 operator()(const uint4& r) const {
    return r;
  }
};

// The aggregation of every form: acc[r][e] = sum_k vals[row0 + r, k] *
// x[row0 + r + offs[k], f0 + e] for R rows and one vector f0 = v * N, where
// conv(load(j)) gives row j's vector as raw bytes (zero outside [0, n)):
// a run's loads are all issued before conv reads any of them. svals: the
// block's vals tile in shared memory (K a row), row0 at its row rloc0;
// offs: the offsets in shared memory.
template <typename T, int R, typename Load, typename Conv = AsLoaded>
__device__ __forceinline__ void stencil_vec(
    const float* svals, int K, int rloc0, const Runs& runs, const int* offs,
    int row0, Load load, float (&acc)[R][Vec<T>::N], Conv conv = Conv()) {
  constexpr int N = Vec<T>::N;
  constexpr int M = R + kLmax - 1;
  using Row = decltype(load(0));
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < N; ++e) acc[r][e] = 0.f;
  for (int q = 0; q < runs.count; ++q) {
    const int k0 = runs.k0[q];
    const int L = runs.len[q];
    const int jb = row0 + offs[k0];
    Row raw[M];
#pragma unroll
    for (int m = 0; m < M; ++m) raw[m] = m < R + L - 1 ? load(jb + m) : Row{};
    uint4 xs[M];
#pragma unroll
    for (int m = 0; m < M; ++m) xs[m] = conv(raw[m]);
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
    stencil_vec<T, R>(svals, K, rg * R, runs, offs, row0,
                      [&](int j) {
                        return load_vec<T, Idx>(x, j, n, F, v * N, x_vec);
                      },
                      acc);
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
      stencil_vec<T, R>(svals, K, rg * R, runs, offs, row_base + rg * R,
                        [&](int j) {
                          return load_vec<T, Idx>(x, j, n, F, v * N, x_vec);
                        },
                        acc);
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

// g * act'(y) with the roundings of the plain version (act_grad_from_y
// in kernels/dia_kernels.py, then the product): nothing contracted into
// an FMA
template <int ACT>
__device__ __forceinline__ float act_grad_mul(float g, float y) {
  if (ACT == ngpde::kTanh)
    return __fmul_rn(g, __fsub_rn(1.f, __fmul_rn(y, y)));
  if (ACT == ngpde::kSigmoid)
    return __fmul_rn(g, __fmul_rn(y, __fsub_rn(1.f, y)));
  if (ACT == ngpde::kRelu) return __fmul_rn(g, y > 0.f ? 1.f : 0.f);
  return g;
}

// g[j, f0 .. f0 + 4) and y[j, f0 .. f0 + 4) as raw bytes; zero where j is
// outside [0, n) or a feature is past O
struct GyRow {
  uint4 g, y;
};

template <typename Idx>
__device__ __forceinline__ GyRow load_gy(const float* __restrict__ g,
                                         const float* __restrict__ y, int j,
                                         int n, int O, int f0, bool vec) {
  if (f0 >= O) return GyRow{};
  return GyRow{load_vec<float, Idx>(g, j, n, O, f0, vec),
               load_vec<float, Idx>(y, j, n, O, f0, vec)};
}

// dz = g * act'(y) of a loaded row, as raw bytes
template <int ACT>
struct DzOf {
  __device__ __forceinline__ uint4 operator()(const GyRow& r) const {
    unsigned d[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      d[q] = __float_as_uint(act_grad_mul<ACT>(
          __uint_as_float(word(r.g, q)), __uint_as_float(word(r.y, q))));
    return make_uint4(d[0], d[1], d[2], d[3]);
  }
};

// dst[0 .. rows) x kCols = W^T[k0 .., c0 ..) = W[c0 + col, k0 + kr] (W
// (F, O) row-major), zero past O rows and F columns of W^T
__device__ __forceinline__ void load_wt_tile(float* dst,
                                             const float* __restrict__ w,
                                             int k0, int rows, int c0, int F,
                                             int O, int tid) {
  for (int idx = tid; idx < rows * kCols; idx += kFusedThreads) {
    const int kr = idx / kCols;
    const int f = c0 + idx - kr * kCols;
    const int k = k0 + kr;
    dst[idx] = k < O && f < F ? w[(long long)f * O + k] : 0.f;
  }
}

// acc += a[tile rows, 0 .. kt) @ b[0 .. kt, kCols), kt a multiple of 4;
// thread (ty, tx) owns rows ty*4 + i and 32 + ty*4 + i, columns tx*4 + j
// (3 16-byte shared loads for 32 FMAs a k)
__device__ __forceinline__ void tile_product_cols(const float* a, int lda,
                                                  const float* b, int kt,
                                                  int ty, int tx,
                                                  float (&acc)[8][4]) {
  for (int k = 0; k < kt; k += 4) {
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = ngpde::ld4(a + (ty * 4 + i) * lda + k);
      av[4 + i] = ngpde::ld4(a + (32 + ty * 4 + i) * lda + k);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 bv = ngpde::ld4(b + (k + kk) * kCols + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float s = ngpde::part(av[i], kk);
        acc[i][0] = fmaf(s, bv.x, acc[i][0]);
        acc[i][1] = fmaf(s, bv.y, acc[i][1]);
        acc[i][2] = fmaf(s, bv.z, acc[i][2]);
        acc[i][3] = fmaf(s, bv.w, acc[i][3]);
      }
    }
  }
}

// acc += xt^T ut over the tile's rows (both kDwTile wide): thread (ty, tx)
// owns features ty*4 + i and 32 + ty*4 + i, outputs tx*4 + j
__device__ __forceinline__ void dw_product(const float* xt, const float* ut,
                                           int ty, int tx,
                                           float (&acc)[8][4]) {
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    const float4 a0 = ngpde::ld4(xt + r * kDwTile + ty * 4);
    const float4 a1 = ngpde::ld4(xt + r * kDwTile + 32 + ty * 4);
    const float4 bv = ngpde::ld4(ut + r * kDwTile + tx * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
      acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
      acc[i][2] = fmaf(av[i], bv.z, acc[i][2]);
      acc[i][3] = fmaf(av[i], bv.w, acc[i][3]);
    }
  }
}

// The fused backward (f32): vals, offsets and runs are C^T's. Per 64-row
// tile: u = C^T dz into a shared tile (Up wide, zero past O), dz formed
// from g and y as the neighbour rows load (and u written out where u is
// given); the tile's own rows' dz added to the thread's db sums; dx = u
// W^T by kCols-column chunks, W^T whole in shared memory or in k-tiles;
// and, where x is given (F, O <= kDwTile, Up = kDwTile), dW += x^T u from
// x's rows staged beside u. The block's dW and db go to its row of
// partial.
template <typename Idx, int ACT>
__global__ void __launch_bounds__(kFusedThreads, kBwdBlocks)
    dia_gcn_bwd_kernel(const float* __restrict__ vals, int K,
                       const int* __restrict__ offsets, Runs runs,
                       const float* __restrict__ g,
                       const float* __restrict__ y,
                       const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ dx,
                       float* __restrict__ u, float* __restrict__ partial,
                       int n, int F, int O, int Up, bool w_whole,
                       bool want_db, bool gy_vec, bool x_vec, bool dx_vec,
                       bool u_vec) {
  constexpr int R = kBwdRows;
  const bool dw = x != nullptr;
  extern __shared__ float4 smem4[];
  const int nchunks = (F + kCols - 1) / kCols;
  float* wsm = reinterpret_cast<float*>(smem4);  // W^T, or one k-tile
  float* ut = wsm + (w == nullptr ? 0
                     : w_whole    ? nchunks * Up * kCols
                                  : kKT * kCols);
  // two buffers of x's rows (for dW) and of the vals: the next tile's
  // are copied while this tile's products run
  float* xts = ut + kTile * Up;
  float* svalss = xts + (dw ? 2 * kTile * kDwTile : 0);  // 2 x kTile x K
  __shared__ int offs[kMaxDiags];
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  if (tid < K) offs[tid] = offsets[tid];
  if (w != nullptr && w_whole)
    for (int c = 0; c < nchunks; ++c)
      load_wt_tile(wsm + c * Up * kCols, w, 0, Up, c * kCols, F, O, tid);
  if (dw)  // x's columns past F stay zero
    for (int idx = tid; idx < 2 * kTile * kDwTile; idx += kFusedThreads)
      xts[idx] = 0.f;
  __syncthreads();
  // db: thread tid sums dz over columns cv*4 .. + 3 of rows rgp, rgp + RG,
  // ... of each tile, in order
  const int UV = Up / 4;
  const int RG = min(kTile, kFusedThreads / UV);
  const int cv = tid % UV;
  const int rgp = tid / UV;
  float db[4] = {0.f, 0.f, 0.f, 0.f};
  float dwacc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dwacc[i][j] = 0.f;
  const int ntiles = (n + kTile - 1) / kTile;
  const int FV = (F + 3) / 4;
  // a tile's vals and x rows into buffer buf, by cp.async
  auto fetch = [&](int tile, int buf) {
    const int row_base = tile * kTile;
    const int count = max(0, min(kTile, n - row_base)) * K;
    float* sv = svalss + buf * kTile * K;
    for (int idx = tid; idx < kTile * K; idx += kFusedThreads)
      ngpde::cp_async4(sv + idx, vals + (Idx)row_base * K + idx,
                       idx < count);
    if (dw)
      for (int idx = tid; idx < kTile * FV; idx += kFusedThreads) {
        const int r = idx / FV;
        const int c4 = idx - r * FV;
        const bool ok = row_base + r < n;
        float* dst = xts + (buf * kTile + r) * kDwTile + c4 * 4;
        if (x_vec) {
          ngpde::cp_async16(dst, ok ? x + (Idx)(row_base + r) * F + c4 * 4
                                    : x, ok ? 16 : 0);
        } else {
          *reinterpret_cast<uint4*>(dst) =
              load_vec<float, Idx>(x, row_base + r, n, F, c4 * 4, false);
        }
      }
    ngpde::cp_async_commit();
  };
  if (blockIdx.x < ntiles) fetch(blockIdx.x, 0);
  for (int tile = blockIdx.x, it = 0; tile < ntiles;
       tile += gridDim.x, ++it) {
    const int row_base = tile * kTile;
    const float* svals = svalss + (it & 1) * kTile * K;
    const float* xt = xts + (it & 1) * kTile * kDwTile;
    ngpde::cp_async_wait<0>();
    __syncthreads();
    // 1. u, and the tile's db terms
    for (int p = tid; p < (kTile / R) * UV; p += kFusedThreads) {
      const int rg = p / UV;
      const int v = p - rg * UV;
      const int row0 = row_base + rg * R;
      float acc[R][4];
      stencil_vec<float, R>(svals, K, rg * R, runs, offs, row0,
                            [&](int j) {
                              return load_gy<Idx>(g, y, j, n, O, v * 4,
                                                  gy_vec);
                            },
                            acc, DzOf<ACT>());
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool row_ok = row0 + r < n;
        float h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h[e] = row_ok && v * 4 + e < O ? acc[r][e] : 0.f;
        store_vec<float, 4>(ut + (rg * R + r) * Up + v * 4, h);
        if (u == nullptr || !row_ok || v * 4 >= O) continue;
        float* dst = u + (Idx)(row0 + r) * O + v * 4;
        if (u_vec) {
          store_vec<float, 4>(dst, h);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (v * 4 + e < O) dst[e] = h[e];
        }
      }
    }
    if (want_db && rgp < RG)
      for (int r0 = rgp; r0 < kTile; r0 += kDbRows * RG) {
        GyRow raw[kDbRows];
#pragma unroll
        for (int q = 0; q < kDbRows; ++q)
          raw[q] = r0 + q * RG < kTile
                       ? load_gy<Idx>(g, y, row_base + r0 + q * RG, n, O,
                                      cv * 4, gy_vec)
                       : GyRow{};
#pragma unroll
        for (int q = 0; q < kDbRows; ++q) {
          const uint4 d = DzOf<ACT>()(raw[q]);
#pragma unroll
          for (int e = 0; e < 4; ++e) db[e] += __uint_as_float(word(d, e));
        }
      }
    __syncthreads();
    if (tile + gridDim.x < ntiles) fetch(tile + gridDim.x, (it + 1) & 1);
    // 2. dx = u W^T by column chunks
    if (w != nullptr) {
      for (int c = 0; c < nchunks; ++c) {
        float acc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        if (w_whole) {
          tile_product_cols(ut, Up, wsm + c * Up * kCols, Up, ty, tx, acc);
        } else {
          for (int k0 = 0; k0 < Up; k0 += kKT) {
            const int kt = min(kKT, Up - k0);
            load_wt_tile(wsm, w, k0, kt, c * kCols, F, O, tid);
            __syncthreads();
            tile_product_cols(ut + k0, Up, wsm, kt, ty, tx, acc);
            __syncthreads();
          }
        }
        const int col = c * kCols + tx * 4;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = row_base + (i < 4 ? ty * 4 + i : 28 + ty * 4 + i);
          if (row >= n || col >= F) continue;
          float* dst = dx + (Idx)row * F + col;
          if (dx_vec && col + 4 <= F) {
            store_vec<float, 4>(dst, acc[i]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (col + j < F) dst[j] = acc[i][j];
          }
        }
      }
    }
    // 3. dW += x^T u
    if (dw) dw_product(xt, ut, ty, tx, dwacc);
    __syncthreads();  // the next tile rewrites ut
  }
  float* part =
      partial + (Idx)blockIdx.x * ((dw ? F * O : 0) + (want_db ? O : 0));
  if (dw) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int f = i < 4 ? ty * 4 + i : 28 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (f < F && tx * 4 + j < O) part[f * O + tx * 4 + j] = dwacc[i][j];
    }
  }
  if (want_db) {  // the threads' sums added in row-group order
    if (rgp < RG) store_vec<float, 4>(ut + rgp * Up + cv * 4, db);
    __syncthreads();
    float* pdb = part + (dw ? F * O : 0);
    for (int o = tid; o < O; o += kFusedThreads) {
      float s = 0.f;
      for (int q = 0; q < RG; ++q) s += ut[q * Up + o];
      pdb[o] = s;
    }
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

// The fused backward's launch for these widths: u's padded width, W^T
// whole in shared memory or streamed, the dynamic shared memory, and the
// grid (persistent: no more blocks than tiles, nor than the SMs hold at
// once), which is also the number of rows of partials it writes.
struct BwdPlan {
  int Up;
  bool w_whole;
  size_t smem;
  int grid;
};

template <typename Idx, int ACT>
cudaError_t plan_gcn_bwd(int K, int n, int F, int O, bool dw, bool has_w,
                         BwdPlan* p) {
  p->Up = dw ? kDwTile : (O + 3) / 4 * 4;
  const int nchunks = (F + kCols - 1) / kCols;
  const size_t base = sizeof(float) *
                      (kTile * p->Up + (dw ? 2 * kTile * kDwTile : 0) +
                       2 * kTile * std::max(K, 1));
  const size_t whole = sizeof(float) * nchunks * p->Up * kCols;
  p->w_whole = has_w && base + whole <= kTwoBlockSmem;
  p->smem = base + (!has_w       ? 0
                    : p->w_whole ? whole
                                 : sizeof(float) * kKT * kCols);
  const int ntiles = (n + kTile - 1) / kTile;
  p->grid = 0;
  if (ntiles == 0) return cudaSuccess;
  auto kernel = dia_gcn_bwd_kernel<Idx, ACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kFusedThreads, p->smem);
  if (err != cudaSuccess) return err;
  p->grid = std::max(1, std::min(ntiles, sms * std::max(per_sm, 1)));
  return cudaSuccess;
}

template <typename Idx, int ACT>
cudaError_t launch_gcn_bwd(const float* vals, const int* offsets, int K,
                           const Runs& runs, const float* g, const float* y,
                           const float* x, const float* w, float* dx,
                           float* u, float* grads, float* partial,
                           int max_blocks, int n, int F, int O, bool want_db,
                           cudaStream_t stream) {
  BwdPlan p;
  cudaError_t err = plan_gcn_bwd<Idx, ACT>(K, n, F, O, x != nullptr,
                                           w != nullptr, &p);
  if (err != cudaSuccess) return err;
  const int n_params = (x != nullptr ? F * O : 0) + (want_db ? O : 0);
  const int grid = n_params > 0 ? std::min(p.grid, max_blocks) : p.grid;
  if (grid > 0) {
    const bool gy_vec = O % 4 == 0 && aligned16(g) && aligned16(y);
    dia_gcn_bwd_kernel<Idx, ACT><<<grid, kFusedThreads, p.smem, stream>>>(
        vals, K, offsets, runs, g, y, x, w, dx, u, partial, n, F, O, p.Up,
        p.w_whole, want_db, gy_vec, F % 4 == 0 && aligned16(x),
        F % 4 == 0 && aligned16(dx), O % 4 == 0 && aligned16(u));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (n_params == 0) return cudaSuccess;
  return ngpde::sum_partials(partial, grads, grid, n_params, stream);
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

// The blocks ngpde_dia_gcn_bwd launches at these widths, and so the rows
// of partial it needs: *blocks. dw: x given (dW from the tiles); has_w: w
// given (dx wanted).
int ngpde_dia_gcn_bwd_blocks(int K, int n, int F, int O, int dw, int has_w,
                             int act, int* blocks) {
  if (!valid(act, K) || n < 0 || F < 1 || O < 1 || blocks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = wide_index(n, F, O, K);
  BwdPlan p;
  cudaError_t err;
#define NGPDE_PLAN(ACT)                                                  \
  (wide ? plan_gcn_bwd<long long, ACT>(K, n, F, O, dw != 0, has_w != 0, \
                                       &p)                               \
        : plan_gcn_bwd<int, ACT>(K, n, F, O, dw != 0, has_w != 0, &p))
  switch (act) {
    case ngpde::kTanh: err = NGPDE_PLAN(ngpde::kTanh); break;
    case ngpde::kRelu: err = NGPDE_PLAN(ngpde::kRelu); break;
    case ngpde::kSigmoid: err = NGPDE_PLAN(ngpde::kSigmoid); break;
    default: err = NGPDE_PLAN(ngpde::kIdentity);
  }
#undef NGPDE_PLAN
  *blocks = p.grid;
  return static_cast<int>(err);
}

// K2's backward in f32, on C^T (vals, offsets and runs of dia_norm_rev):
// dz = g * act'(y) (g, y (n, O)) and u = C^T dz. Writes, each where its
// pointer is not null: dx (n, F) = u W^T (W (F, O) given with dx); u (n,
// O); grads = dW (F, O) = x^T u where x (n, F) is given (F, O <= 64),
// then db (O) = the sum of dz's rows where want_db, each the sum over the
// blocks of their rows of partial in ngpde::sum_partials' fixed order
// (max_blocks rows of as many floats as grads has:
// ngpde_dia_gcn_bwd_blocks gives the rows needed; fewer run as that many
// blocks).
int ngpde_dia_gcn_bwd(const float* vals, const int* offsets, int K,
                      const int* runs, int n_runs, const float* g,
                      const float* y, const float* x, const float* w,
                      float* dx, float* u, float* grads, float* partial,
                      int max_blocks, int n, int F, int O, int act,
                      int want_db, void* stream_ptr) {
  Runs r{};
  const bool sums = x != nullptr || want_db;
  if (!valid(act, K) || F < 1 || F > 512 || O < 1 || O > 512 ||
      (dx == nullptr) != (w == nullptr) ||
      (x != nullptr && (F > kDwTile || O > kDwTile)) ||
      (sums && (grads == nullptr || partial == nullptr || max_blocks < 1)) ||
      !make_runs(runs, n_runs, K, &r))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const bool wide = wide_index(n, F, O, K);
  cudaError_t err;
#define NGPDE_BWD(ACT)                                                      \
  (wide ? launch_gcn_bwd<long long, ACT>(vals, offsets, K, r, g, y, x, w,   \
                                         dx, u, grads, partial, max_blocks, \
                                         n, F, O, want_db != 0, s)          \
        : launch_gcn_bwd<int, ACT>(vals, offsets, K, r, g, y, x, w, dx, u,  \
                                   grads, partial, max_blocks, n, F, O,     \
                                   want_db != 0, s))
  switch (act) {
    case ngpde::kTanh: err = NGPDE_BWD(ngpde::kTanh); break;
    case ngpde::kRelu: err = NGPDE_BWD(ngpde::kRelu); break;
    case ngpde::kSigmoid: err = NGPDE_BWD(ngpde::kSigmoid); break;
    default: err = NGPDE_BWD(ngpde::kIdentity);
  }
#undef NGPDE_BWD
  return static_cast<int>(err);
}

}  // extern "C"
