// K4 / K7: block-band SpMM and the fused GCN right-hand side,
//   agg[i*tbr + r, :] = sum_s sum_c blocks[s, i, r, c] * x[cols[i, s]*tb + c, :]
//   out               = act(agg @ W + b)   (W, b optional; SpMM: act = id)
// Replaces neuralgraphpde/kernels/banded_kernels.py::_banded_spmm_fwd and
// _banded_rhs_fwd (dense block diagonals, K7: tbr = tb, cols[i, k] =
// clip(i + offsets[k])) and _pbanded_spmm_fwd and _pbanded_rhs_fwd (packed
// block bands, K4: 512 x 128 blocks, cols from the row's slot table). The
// TPU kernels differ only in where the x block index comes from, so one
// kernel reads a cols table for both.
//
// What bounds it on the H100: operations. Every stored block value is one
// multiply-add per feature (tbr*tb*F per block), in true f32 on the CUDA
// cores (the tensor cores would round f32 to TF32); the block values are
// read once per 128 features. At the 2^17-point mesh the packed storage
// holds ~490 values per edge, so this is ~30x the gather's work: a simple
// kernel that is right, not the fastest way to this SpMM on this card.
//
// Design: a block of 256 threads owns a 64-row x 128-feature output tile of
// one block-row. For each slot it streams the 64 x tb block slice and the
// slot's x block (tb rows, x rows past n read as zero) through shared
// memory in chunks of 32 columns; each thread accumulates a 4 x 8 register
// tile (4 rows, 8 features) in f32, no atomics, a fixed order: the same
// bits every run. bf16 storage reads bf16 blocks and x and accumulates in
// f32, as the TPU kernel does. The fused kernel keeps the block's 64
// aggregated rows (all F <= 512 features, rounded to W's dtype) in shared
// memory and runs the GCN epilogue of common.cuh, which streams W through a
// shared tile, so the aggregate never goes to device memory.
#include "common.cuh"

namespace {

using ngpde::activate;
using ngpde::round_to;
using ngpde::to_f32;

constexpr int kThreads = 256;
constexpr int kR = 64;              // output rows per block
constexpr int kTF = 128;            // features per tile
constexpr int kKC = 32;             // block columns (x rows) per chunk
constexpr int kAStride = kR + 4;    // As row stride: fewer bank conflicts
constexpr int kMaxF = 512;          // widest fused input
constexpr int kShA = kKC * kAStride;  // floats of the block-slice chunk
constexpr int kShX = kKC * kTF;       // floats of the x chunk

struct Band {
  const int* cols;  // (nb, S)
  int S, nb, tbr, tb, n, F;
};

// acc[a][j]: row ty*4 + a of the tile, feature f0 + tx*4 + (j & 3) +
// 64 * (j >> 2). As, Xs: shared chunks. Ends with all threads in step.
template <typename T>
__device__ __forceinline__ void tile_product(const Band& bd,
                                             const T* __restrict__ blocks,
                                             const T* __restrict__ x, int i,
                                             int r0, int f0, float* As,
                                             float* Xs, float acc[4][8]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[a][j] = 0.f;
  for (int s = 0; s < bd.S; ++s) {
    const long long xrow0 = (long long)bd.cols[(long long)i * bd.S + s] * bd.tb;
    const T* blk = blocks + ((long long)s * bd.nb + i) * bd.tbr * bd.tb;
    for (int c0 = 0; c0 < bd.tb; c0 += kKC) {
      for (int idx = tid; idx < kR * kKC; idx += kThreads) {
        const int c = idx % kKC;
        const int r = idx / kKC;
        float v = 0.f;
        if (r0 + r < bd.tbr && c0 + c < bd.tb)
          v = to_f32(blk[(long long)(r0 + r) * bd.tb + c0 + c]);
        As[c * kAStride + r] = v;
      }
      for (int idx = tid; idx < kKC * kTF; idx += kThreads) {
        const int f = idx % kTF;
        const int c = idx / kTF;
        const long long row = xrow0 + c0 + c;
        float v = 0.f;
        if (c0 + c < bd.tb && row < bd.n && f0 + f < bd.F)
          v = to_f32(x[row * bd.F + f0 + f]);
        Xs[c * kTF + f] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kKC; ++c) {
        const float4 av =
            *reinterpret_cast<const float4*>(&As[c * kAStride + ty * 4]);
        const float4 b0 =
            *reinterpret_cast<const float4*>(&Xs[c * kTF + tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Xs[c * kTF + 64 + tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[a][j] = fmaf(ar[a], br[j], acc[a][j]);
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int feature_of(int f0, int j) {
  return f0 + (threadIdx.x & 15) * 4 + (j & 3) + 64 * (j >> 2);
}

// SpMM, or the fused RHS without W: out = act(agg + b), f32 (N, F).
template <typename T, int ACT, bool HAS_B>
__global__ void __launch_bounds__(kThreads)
    block_spmm_kernel(Band bd, const T* __restrict__ blocks,
                      const T* __restrict__ x, const float* __restrict__ b,
                      float* __restrict__ out) {
  __shared__ __align__(16) float As[kShA];
  __shared__ __align__(16) float Xs[kShX];
  const int tiles = (bd.tbr + kR - 1) / kR;
  const int i = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * kR;
  const int f0 = blockIdx.y * kTF;
  float acc[4][8];
  tile_product<T>(bd, blocks, x, i, r0, f0, As, Xs, acc);
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty * 4 + a;
    const long long row = (long long)i * bd.tbr + r;
    if (r >= bd.tbr || row >= bd.n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = feature_of(f0, j);
      if (f < bd.F) {
        float v = acc[a][j];
        if (HAS_B) v += b[f];
        out[row * bd.F + f] = activate<ACT>(v);
      }
    }
  }
}

// Fused RHS with W: out = act(agg @ W + b), f32 (N, O); F <= kMaxF.
template <typename T, int ACT, bool HAS_B>
__global__ void __launch_bounds__(kThreads)
    block_gcn_rhs_kernel(Band bd, const T* __restrict__ blocks,
                         const T* __restrict__ x, const T* __restrict__ w,
                         const float* __restrict__ b, float* __restrict__ out,
                         int O, int Fp) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                 // kShA
  float* Xs = As + kShA;            // kShX
  float* agg = Xs + kShX;           // kR x Fp
  float* w_tile = agg + kR * Fp;    // kEpiTileF x kEpiTileO
  const int tiles = (bd.tbr + kR - 1) / kR;
  const int i = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * kR;
  const int ty = threadIdx.x >> 4;
  for (int f0 = 0; f0 < Fp; f0 += kTF) {
    float acc[4][8];
    tile_product<T>(bd, blocks, x, i, r0, f0, As, Xs, acc);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        agg[(ty * 4 + a) * Fp + feature_of(f0, j)] = round_to<T>(acc[a][j]);
  }
  __syncthreads();
  const long long row0 = (long long)i * bd.tbr + r0;
  const long long valid = min((long long)min(kR, bd.tbr - r0), bd.n - row0);
  ngpde::gcn_epilogue<T, float, ACT, HAS_B, kR, kThreads>(
      agg, Fp, w_tile, w, b, out, row0, (int)valid, bd.F, O);
}

template <typename T, int ACT, bool HAS_B>
cudaError_t launch_spmm(const Band& bd, const void* blocks, const void* x,
                        const float* b, float* out, cudaStream_t s) {
  const int tiles = (bd.tbr + kR - 1) / kR;
  const dim3 grid((unsigned)bd.nb * tiles, (bd.F + kTF - 1) / kTF);
  block_spmm_kernel<T, ACT, HAS_B><<<grid, kThreads, 0, s>>>(
      bd, static_cast<const T*>(blocks), static_cast<const T*>(x), b, out);
  return cudaGetLastError();
}

template <typename T, int ACT, bool HAS_B>
cudaError_t launch_rhs(const Band& bd, const void* blocks, const void* x,
                       const void* w, const float* b, float* out, int O,
                       cudaStream_t s) {
  const int Fp = (bd.F + kTF - 1) / kTF * kTF;
  const size_t smem = sizeof(float) * ((size_t)kShA + kShX + (size_t)kR * Fp +
                                       ngpde::kEpiTileF * ngpde::kEpiTileO);
  cudaError_t err = cudaFuncSetAttribute(
      block_gcn_rhs_kernel<T, ACT, HAS_B>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (bd.tbr + kR - 1) / kR;
  block_gcn_rhs_kernel<T, ACT, HAS_B>
      <<<(unsigned)bd.nb * tiles, kThreads, smem, s>>>(
          bd, static_cast<const T*>(blocks), static_cast<const T*>(x),
          static_cast<const T*>(w), b, out, O, Fp);
  return cudaGetLastError();
}

// act x has_b -> one instantiation each
template <typename T>
cudaError_t spmm_typed(int act, bool hb, const Band& bd, const void* blocks,
                       const void* x, const float* b, float* out,
                       cudaStream_t s) {
  switch (act * 2 + (hb ? 1 : 0)) {
    case 0: return launch_spmm<T, 0, false>(bd, blocks, x, b, out, s);
    case 1: return launch_spmm<T, 0, true>(bd, blocks, x, b, out, s);
    case 2: return launch_spmm<T, 1, false>(bd, blocks, x, b, out, s);
    case 3: return launch_spmm<T, 1, true>(bd, blocks, x, b, out, s);
    case 4: return launch_spmm<T, 2, false>(bd, blocks, x, b, out, s);
    case 5: return launch_spmm<T, 2, true>(bd, blocks, x, b, out, s);
    case 6: return launch_spmm<T, 3, false>(bd, blocks, x, b, out, s);
    case 7: return launch_spmm<T, 3, true>(bd, blocks, x, b, out, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t rhs_typed(int act, bool hb, const Band& bd, const void* blocks,
                      const void* x, const void* w, const float* b,
                      float* out, int O, cudaStream_t s) {
  switch (act * 2 + (hb ? 1 : 0)) {
    case 0: return launch_rhs<T, 0, false>(bd, blocks, x, w, b, out, O, s);
    case 1: return launch_rhs<T, 0, true>(bd, blocks, x, w, b, out, O, s);
    case 2: return launch_rhs<T, 1, false>(bd, blocks, x, w, b, out, O, s);
    case 3: return launch_rhs<T, 1, true>(bd, blocks, x, w, b, out, O, s);
    case 4: return launch_rhs<T, 2, false>(bd, blocks, x, w, b, out, O, s);
    case 5: return launch_rhs<T, 2, true>(bd, blocks, x, w, b, out, O, s);
    case 6: return launch_rhs<T, 3, false>(bd, blocks, x, w, b, out, O, s);
    case 7: return launch_rhs<T, 3, true>(bd, blocks, x, w, b, out, O, s);
  }
  return cudaErrorInvalidValue;
}

bool valid(int act, int S, int nb, int tbr, int tb, int n, int F) {
  return act >= 0 && act <= 3 && S >= 0 && nb >= 1 && tbr >= 1 && tb >= 1 &&
         n >= 0 && F >= 1 && (long long)nb * tbr >= n &&
         (long long)nb * ((tbr + kR - 1) / kR) < (1LL << 31) &&
         (F + kTF - 1) / kTF < 65536;
}

}  // namespace

extern "C" {

// blocks (S, nb, tbr, tb) and x (n, F) in f32 (bf16 = 0) or bf16; cols
// (nb, S) int32, each < ceil(n / tb); b (F,) f32 or null; out (n, F) f32.
// act: 0 identity, 1 tanh, 2 relu, 3 sigmoid.
int ngpde_block_spmm(const void* blocks, const int* cols, int S, int nb,
                     int tbr, int tb, const void* x, int n, int F,
                     const float* b, float* out, int act, int bf16,
                     void* stream_ptr) {
  if (!valid(act, S, nb, tbr, tb, n, F))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const Band bd{cols, S, nb, tbr, tb, n, F};
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err =
      bf16 ? spmm_typed<__nv_bfloat16>(act, b != nullptr, bd, blocks, x, b,
                                       out, s)
           : spmm_typed<float>(act, b != nullptr, bd, blocks, x, b, out, s);
  return static_cast<int>(err);
}

// As ngpde_block_spmm, then out (n, O) = act(agg @ W + b): W (F, O) in the
// blocks' dtype, b (O,) f32 or null; F <= 512.
int ngpde_block_gcn_rhs(const void* blocks, const int* cols, int S, int nb,
                        int tbr, int tb, const void* x, const void* w,
                        const float* b, float* out, int n, int F, int O,
                        int act, int bf16, void* stream_ptr) {
  if (!valid(act, S, nb, tbr, tb, n, F) || F > kMaxF || O < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const Band bd{cols, S, nb, tbr, tb, n, F};
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err =
      bf16 ? rhs_typed<__nv_bfloat16>(act, b != nullptr, bd, blocks, x, w, b,
                                      out, O, s)
           : rhs_typed<float>(act, b != nullptr, bd, blocks, x, w, b, out, O,
                              s);
  return static_cast<int>(err);
}

}  // extern "C"
