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
// What bounds it on the H100: operations. The stored blocks are mostly
// zeros (the 2^17-point mesh's packed storage holds ~494 values per
// nonzero), and the TPU kernels multiply all of them. This kernel walks a
// list of the occupied 32 x 32 sub-tiles instead (ops/bsr.py,
// SubTileIndex): 9.2% of them at the 2^17-point mesh, 24% at the
// 12,000-point one. Each listed value is still one multiply-add per
// feature, in true f32 on the CUDA cores (the tensor cores would round f32
// to TF32), ~46 per nonzero at the 2^17-point mesh where the function needs
// one: far from the function's bound, but 11x less work than the full walk.
// 32-row tiles beat 64 and 16 rows on the H100 (PERF.md;
// tools/subtile_rows.py builds and times the others).
//
// Design: a block of 128 threads owns a 32-row x 128-feature output tile of
// one block-row, and walks its tile's list entries (slot, 32-column chunk)
// in ascending order. For each it copies the 32 x 32 sub-tile of blocks and
// the 32 x 128 x chunk (x rows past n read as zero) into shared memory with
// 16-byte cp.async copies, double-buffered: the next entry's copy runs under
// this entry's multiply-adds. bf16 storage is copied as bf16 and converted
// as it is read from shared memory; a row not 16-byte aligned is loaded by
// plain loads. Each thread accumulates a 4 x 8 register tile (4 rows, 8
// features) in f32 in list order, no atomics: the same bits every run. A
// tile with no entries reads its two tile_ptr entries and writes act(b) or
// zero. A stored zero times an inf or NaN of x would spread NaN through
// every row of a listed sub-tile: each thread checks the x values it
// copied, and an entry whose chunk holds one (__syncthreads_or) skips the
// zero products, so NaN reaches only the rows with a nonzero on its
// column, as in a CSR product. The fused kernel keeps the block's 32
// aggregated rows (all F <= 512 features, rounded to W's dtype) in shared
// memory and runs the GCN epilogue of common.cuh, which streams W through a
// shared tile, so the aggregate never goes to device memory.
#include <cstdint>

#include "common.cuh"

namespace {

using ngpde::activate;
using ngpde::round_to;

constexpr int kR = 32;      // output rows per tile: the sub-tile's rows
constexpr int kKC = 32;     // the sub-tile's columns: x rows per chunk
constexpr int kTF = 128;    // features per tile
constexpr int kThreads = 4 * kR;  // 16 x (kR / 4) threads, 4 x 8 outputs each
constexpr int kMaxF = 512;  // widest fused input

// One pipeline stage in shared memory, in elements of T: the sub-tile
// (kR rows, padded by 16 bytes against bank conflicts), then the x chunk
// (kKC rows of kTF, contiguous). Two stages.
template <typename T>
struct Smem {
  static constexpr int kVec = 16 / sizeof(T);  // elements of a 16-byte copy
  static constexpr int kAS = kKC + kVec;       // sub-tile row stride
  static constexpr int kA = kR * kAS;
  static constexpr int kStage = kA + kKC * kTF;
  static constexpr size_t kBytes = 2 * kStage * sizeof(T);
};

struct Band {
  const int* cols;      // (nb, S)
  const int* tile_ptr;  // (nb * tiles + 1,): each tile's entries
  const int* tile_ent;  // slot * chunks + chunk, ascending within a tile
  int S, nb, tbr, tb, n, F, tiles, chunks;
  bool vec_a, vec_x;  // rows of blocks / of x are 16-byte aligned
};

template <typename T>
__device__ __forceinline__ T zero() {
  return ngpde::from_f32<T>(0.f);
}

// four consecutive values from shared memory, as f32
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);  // bf16: f32's top half
  v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// whether a 32-bit word of T values holds an inf or NaN
__device__ __forceinline__ bool nonfinite(float, unsigned w) {
  return (w & 0x7f800000u) == 0x7f800000u;
}
__device__ __forceinline__ bool nonfinite(__nv_bfloat16, unsigned w) {
  return (w & 0x7f800000u) == 0x7f800000u || (w & 0x7f80u) == 0x7f80u;
}

// List entry e's sub-tile and x chunk into stage sh, as one cp.async group.
// Thread t copies the 16-byte pieces t, t + kThreads, ... of each.
template <typename T>
__device__ __forceinline__ void copy_entry(const Band& bd,
                                           const T* __restrict__ blocks,
                                           const T* __restrict__ x, int i,
                                           int r0, int f0, int e, T* sh) {
  constexpr int V = Smem<T>::kVec;
  const int ent = bd.tile_ent[e];
  const int s = ent / bd.chunks;
  const int c0 = (ent - s * bd.chunks) * kKC;
  const T* blk = blocks + ((long long)s * bd.nb + i) * bd.tbr * bd.tb;
  for (int v = threadIdx.x; v < kR * kKC / V; v += kThreads) {
    const int r = v / (kKC / V), c = c0 + (v % (kKC / V)) * V;
    const bool row_in = r0 + r < bd.tbr;
    const T* src = blk + (long long)(r0 + r) * bd.tb + c;
    T* dst = sh + r * Smem<T>::kAS + (c - c0);
    if (bd.vec_a) {  // tb % V == 0: a piece is all in or all out
      const bool in = row_in && c < bd.tb;
      ngpde::cp_async16(dst, in ? src : blocks, in ? 16 : 0);
    } else {
      for (int k = 0; k < V; ++k)
        dst[k] = row_in && c + k < bd.tb ? src[k] : zero<T>();
    }
  }
  const long long xrow0 =
      (long long)bd.cols[(long long)i * bd.S + s] * bd.tb + c0;
  T* xs = sh + Smem<T>::kA;
  for (int v = threadIdx.x; v < kKC * kTF / V; v += kThreads) {
    const int c = v / (kTF / V), f = f0 + (v % (kTF / V)) * V;
    const long long row = xrow0 + c;
    const bool row_in = c0 + c < bd.tb && row < bd.n;
    const T* src = x + row * bd.F + f;
    if (bd.vec_x) {  // F % V == 0
      const bool in = row_in && f < bd.F;
      ngpde::cp_async16(xs + v * V, in ? src : x, in ? 16 : 0);
    } else {
      for (int k = 0; k < V; ++k)
        xs[v * V + k] = row_in && f + k < bd.F ? src[k] : zero<T>();
    }
  }
  ngpde::cp_async_commit();
}

// whether the x pieces this thread copied into chunk xs hold an inf or NaN
// (its own copies are complete once it has waited for them)
template <typename T>
__device__ __forceinline__ bool copied_nonfinite(const T* xs) {
  constexpr int V = Smem<T>::kVec;
  bool bad = false;
  for (int v = threadIdx.x; v < kKC * kTF / V; v += kThreads) {
    const uint4 w = *reinterpret_cast<const uint4*>(xs + v * V);
    bad |= nonfinite(T(), w.x) | nonfinite(T(), w.y) | nonfinite(T(), w.z) |
           nonfinite(T(), w.w);
  }
  return bad;
}

// acc += the stage's sub-tile times its x chunk, columns in order. acc[a][j]:
// row ty*4 + a of the tile, feature tx*4 + (j & 3) + 64 * (j >> 2) of the
// feature tile. SKIP: leave out the products of zero block values.
template <typename T, bool SKIP>
__device__ __forceinline__ void stage_product(const T* sh, float acc[4][8]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* as = sh + ty * 4 * Smem<T>::kAS;
  const T* xs = sh + Smem<T>::kA + tx * 4;
#pragma unroll 2
  for (int c4 = 0; c4 < kKC; c4 += 4) {
    float a[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) load4(as + r * Smem<T>::kAS + c4, a[r]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float b[8];
      load4(xs + (c4 + k) * kTF, b);
      load4(xs + (c4 + k) * kTF + 64, b + 4);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (!SKIP || a[r][k] != 0.f)
            acc[r][j] = fmaf(a[r][k], b[j], acc[r][j]);
    }
  }
}

// The tile's aggregate for features [f0, f0 + kTF) into acc, walking its
// list entries through the two stages at sh. Ends with all threads in step.
template <typename T>
__device__ __forceinline__ void tile_product(const Band& bd,
                                             const T* __restrict__ blocks,
                                             const T* __restrict__ x,
                                             int tile, int f0, T* sh,
                                             float acc[4][8]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[a][j] = 0.f;
  const int i = tile / bd.tiles, r0 = (tile - i * bd.tiles) * kR;
  const int e0 = bd.tile_ptr[tile], e1 = bd.tile_ptr[tile + 1];
  if (e0 == e1) return;
  copy_entry<T>(bd, blocks, x, i, r0, f0, e0, sh);
  for (int e = e0; e < e1; ++e) {
    T* cur = sh + ((e - e0) & 1) * Smem<T>::kStage;
    if (e + 1 < e1) {
      copy_entry<T>(bd, blocks, x, i, r0, f0, e + 1,
               sh + ((e + 1 - e0) & 1) * Smem<T>::kStage);
      ngpde::cp_async_wait<1>();  // entry e's copies are done
    } else {
      ngpde::cp_async_wait<0>();
    }
    if (__syncthreads_or(copied_nonfinite<T>(cur + Smem<T>::kA)))
      stage_product<T, true>(cur, acc);
    else
      stage_product<T, false>(cur, acc);
    __syncthreads();  // the stage is free for entry e + 2
  }
}

__device__ __forceinline__ int feature_of(int f0, int j) {
  return f0 + (threadIdx.x & 15) * 4 + (j & 3) + 64 * (j >> 2);
}

// SpMM, or the fused RHS without W: out = act(agg + b), f32 (N, F).
template <typename T, int ACT, bool HAS_B>
__global__ void __launch_bounds__(kThreads, 128 / kR)
    block_spmm_kernel(Band bd, const T* __restrict__ blocks,
                      const T* __restrict__ x, const float* __restrict__ b,
                      float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x;
  const int f0 = blockIdx.y * kTF;
  float acc[4][8];
  tile_product<T>(bd, blocks, x, tile, f0, reinterpret_cast<T*>(smem), acc);
  const int i = tile / bd.tiles, r0 = (tile - i * bd.tiles) * kR;
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
  extern __shared__ __align__(16) unsigned char smem[];
  T* stages = reinterpret_cast<T*>(smem);
  float* agg = reinterpret_cast<float*>(smem + Smem<T>::kBytes);  // kR x Fp
  float* w_tile = agg + kR * Fp;  // kEpiTileF x kEpiTileO
  const int tile = blockIdx.x;
  const int ty = threadIdx.x >> 4;
  for (int f0 = 0; f0 < Fp; f0 += kTF) {
    float acc[4][8];
    tile_product<T>(bd, blocks, x, tile, f0, stages, acc);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        agg[(ty * 4 + a) * Fp + feature_of(f0, j)] = round_to<T>(acc[a][j]);
  }
  __syncthreads();
  const int i = tile / bd.tiles, r0 = (tile - i * bd.tiles) * kR;
  const long long row0 = (long long)i * bd.tbr + r0;
  const long long valid = min((long long)min(kR, bd.tbr - r0), bd.n - row0);
  ngpde::gcn_epilogue<T, float, ACT, HAS_B, kR, kThreads>(
      agg, Fp, w_tile, w, b, out, row0, (int)valid, bd.F, O);
}

// bd with the 16-byte copy flags of these pointers and T
template <typename T>
Band aligned(Band bd, const void* blocks, const void* x) {
  constexpr int V = Smem<T>::kVec;
  bd.vec_a = reinterpret_cast<uintptr_t>(blocks) % 16 == 0 && bd.tb % V == 0;
  bd.vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && bd.F % V == 0;
  return bd;
}

template <typename T, int ACT, bool HAS_B>
cudaError_t launch_spmm(const Band& band, const void* blocks, const void* x,
                        const float* b, float* out, cudaStream_t s) {
  const Band bd = aligned<T>(band, blocks, x);
  auto kernel = block_spmm_kernel<T, ACT, HAS_B>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<T>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)bd.nb * bd.tiles, (bd.F + kTF - 1) / kTF);
  kernel<<<grid, kThreads, Smem<T>::kBytes, s>>>(
      bd, static_cast<const T*>(blocks), static_cast<const T*>(x), b, out);
  return cudaGetLastError();
}

template <typename T, int ACT, bool HAS_B>
cudaError_t launch_rhs(const Band& band, const void* blocks, const void* x,
                       const void* w, const float* b, float* out, int O,
                       cudaStream_t s) {
  const Band bd = aligned<T>(band, blocks, x);
  const int Fp = (bd.F + kTF - 1) / kTF * kTF;
  const size_t smem = Smem<T>::kBytes +
                      sizeof(float) * ((size_t)kR * Fp +
                                       ngpde::kEpiTileF * ngpde::kEpiTileO);
  auto kernel = block_gcn_rhs_kernel<T, ACT, HAS_B>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)bd.nb * bd.tiles, kThreads, smem, s>>>(
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

// The storage's Band, or false when an argument is outside what the kernel
// takes (an index built for other sub-tiles than kR x kKC among them).
bool make_band(Band* bd, const int* cols, const int* tile_ptr,
               const int* tile_ent, int tile_rows, int tile_cols, int act,
               int S, int nb, int tbr, int tb, int n, int F) {
  const int tiles = (tbr + kR - 1) / kR;
  if (tile_ptr == nullptr || tile_rows != kR || tile_cols != kKC ||
      act < 0 || act > 3 || S < 0 ||
      nb < 1 || tbr < 1 || tb < 1 || n < 0 || F < 1 ||
      (long long)nb * tbr < n || (long long)nb * tiles >= (1LL << 31) ||
      (F + kTF - 1) / kTF >= 65536)
    return false;
  *bd = Band{cols, tile_ptr, tile_ent, S, nb, tbr, tb, n, F, tiles,
             (tb + kKC - 1) / kKC, false, false};
  return true;
}

}  // namespace

extern "C" {

// blocks (S, nb, tbr, tb) and x (n, F) in f32 (bf16 = 0) or bf16; cols
// (nb, S) int32, each < ceil(n / tb); the sub-tile index: tile_ptr
// (nb * ceil(tbr / 32) + 1,) and tile_ent (slot * ceil(tb / 32) + chunk,
// ascending within each tile) int32, built for tile_rows x tile_cols =
// 32 x 32 sub-tiles; b (F,) f32 or null; out (n, F) f32.
// act: 0 identity, 1 tanh, 2 relu, 3 sigmoid.
int ngpde_block_spmm(const void* blocks, const int* cols, const int* tile_ptr,
                     const int* tile_ent, int tile_rows, int tile_cols, int S,
                     int nb, int tbr, int tb, const void* x, int n, int F,
                     const float* b, float* out, int act, int bf16,
                     void* stream_ptr) {
  Band bd;
  if (!make_band(&bd, cols, tile_ptr, tile_ent, tile_rows, tile_cols, act, S,
                 nb, tbr, tb, n, F))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err =
      bf16 ? spmm_typed<__nv_bfloat16>(act, b != nullptr, bd, blocks, x, b,
                                       out, s)
           : spmm_typed<float>(act, b != nullptr, bd, blocks, x, b, out, s);
  return static_cast<int>(err);
}

// As ngpde_block_spmm, then out (n, O) = act(agg @ W + b): W (F, O) in the
// blocks' dtype, b (O,) f32 or null; F <= 512.
int ngpde_block_gcn_rhs(const void* blocks, const int* cols,
                        const int* tile_ptr, const int* tile_ent,
                        int tile_rows, int tile_cols, int S, int nb, int tbr,
                        int tb, const void* x, const void* w, const float* b,
                        float* out, int n, int F, int O, int act, int bf16,
                        void* stream_ptr) {
  Band bd;
  if (!make_band(&bd, cols, tile_ptr, tile_ent, tile_rows, tile_cols, act, S,
                 nb, tbr, tb, n, F) ||
      F > kMaxF || O < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err =
      bf16 ? rhs_typed<__nv_bfloat16>(act, b != nullptr, bd, blocks, x, w, b,
                                      out, O, s)
           : rhs_typed<float>(act, b != nullptr, bd, blocks, x, w, b, out, O,
                              s);
  return static_cast<int>(err);
}

}  // extern "C"
