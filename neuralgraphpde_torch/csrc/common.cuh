// Shared helpers for the port's kernels: f32/bf16 conversion, cp.async
// copies, float4 reads, the GCN epilogue activations, the fused GCN
// epilogue that streams W through a shared tile (used by the DIA stencil
// and the block-band kernels), and the fixed-order sum of per-block
// partials (the DIA backward's, K3's and K5's).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ngpde {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// f32 value rounded through T (identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// 16 bytes from device memory into shared memory without passing through
// registers; the bytes past src_bytes (all 16 when it is 0: src is then not
// read) are zero-filled. dst and src 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

// 4 bytes from device memory into shared memory without passing through
// registers; zero-filled where !valid (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes at p (16-byte aligned) as a float4
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// component u (0..3, known at compile time) of v
__device__ __forceinline__ float part(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// GCN epilogue activations: 0 identity, 1 tanh, 2 relu, 3 sigmoid
enum Act { kIdentity = 0, kTanh = 1, kRelu = 2, kSigmoid = 3 };

template <int ACT>
__device__ __forceinline__ float activate(float h) {
  if (ACT == kTanh) return tanhf(h);
  if (ACT == kRelu) return fmaxf(h, 0.f);
  if (ACT == kSigmoid) return 1.f / (1.f + expf(-h));
  return h;
}

constexpr int kEpiTileO = 64;  // output columns per W tile
constexpr int kEpiTileF = 32;  // input features per W tile

// out[i0 + r, :] = act(agg[r, :] @ W + b) for r < rows_valid.
// agg: ROWS x Fp in shared memory (columns F..Fp zero, Fp a multiple of
// kEpiTileF); w_tile: kEpiTileF x kEpiTileO shared floats; W (F, O) row-major
// in T. THREADS / kEpiTileO row groups each hold ROWS / groups rows of one
// output column in registers. Starts and ends with all threads in step.
template <typename T, typename TO, int ACT, bool HAS_B, int ROWS, int THREADS>
__device__ __forceinline__ void gcn_epilogue(
    const float* agg, int Fp, float* w_tile, const T* __restrict__ w,
    const float* __restrict__ b, TO* __restrict__ out, long long i0,
    int rows_valid, int F, int O) {
  constexpr int kGroups = THREADS / kEpiTileO;
  constexpr int kPer = ROWS / kGroups;
  const int tid = threadIdx.x;
  const int oc = tid % kEpiTileO;
  const int rg = tid / kEpiTileO;
  for (int o0 = 0; o0 < O; o0 += kEpiTileO) {
    float h[kPer];
#pragma unroll
    for (int rr = 0; rr < kPer; ++rr) h[rr] = 0.f;
    for (int f0 = 0; f0 < Fp; f0 += kEpiTileF) {
      for (int idx = tid; idx < kEpiTileF * kEpiTileO; idx += THREADS) {
        const int kf = idx / kEpiTileO;
        const int c = idx - kf * kEpiTileO;
        const int f = f0 + kf;
        const int o = o0 + c;
        w_tile[idx] =
            (f < F && o < O) ? to_f32(w[(long long)f * O + o]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kf = 0; kf < kEpiTileF; ++kf) {
        const float wv = w_tile[kf * kEpiTileO + oc];
#pragma unroll
        for (int rr = 0; rr < kPer; ++rr)
          h[rr] = fmaf(agg[(rg + kGroups * rr) * Fp + f0 + kf], wv, h[rr]);
      }
      __syncthreads();
    }
    const int o = o0 + oc;
    if (o < O) {
      const float bias = HAS_B ? b[o] : 0.f;
#pragma unroll
      for (int rr = 0; rr < kPer; ++rr) {
        const int r = rg + kGroups * rr;
        if (r < rows_valid) {
          float v = h[rr];
          if (HAS_B) v += bias;
          out[(i0 + r) * O + o] = from_f32<TO>(activate<ACT>(v));
        }
      }
    }
  }
}

// The sum of per-block partials in a fixed order, so the same inputs give
// the same bits on every run: out[i] = the sum over parts p of
// partial[p * n + i], rounded to TO once. A block takes 32 consecutive i,
// a lane each, with W = min(parts, kSumWarps) warps: warp w adds the parts
// p = w, w + W, ... in order (kSumBatch loads in flight), then the warps'
// sums are added in warp order. With parts <= kSumWarps that is the plain
// sum in part order. Internal to each source that launches it.
namespace {

constexpr int kSumWarps = 8;
constexpr int kSumBatch = 8;

template <typename TO>
__global__ void __launch_bounds__(32 * kSumWarps)
    sum_partials_kernel(const float* __restrict__ partial,
                        TO* __restrict__ out, int parts, long long n) {
  __shared__ float sums[kSumWarps][32];
  const int lane = threadIdx.x % 32;
  const int wp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const long long i = (long long)blockIdx.x * 32 + lane;
  float a = 0.f;
  if (i < n)
    for (int p = wp; p < parts; p += warps * kSumBatch) {
      float v[kSumBatch];
#pragma unroll
      for (int q = 0; q < kSumBatch; ++q) {
        const int pq = p + q * warps;
        v[q] = pq < parts ? partial[(long long)pq * n + i] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kSumBatch; ++q)
        if (p + q * warps < parts) a += v[q];
    }
  sums[wp][lane] = a;
  __syncthreads();
  if (wp == 0 && i < n) {
    float s = 0.f;
    for (int q = 0; q < warps; ++q) s += sums[q][lane];
    out[i] = from_f32<TO>(s);
  }
}

// out (n) = the sum of partial's parts rows of n floats, as above
template <typename TO>
cudaError_t sum_partials(const float* partial, TO* out, int parts,
                         long long n, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const int warps = parts < 1 ? 1 : parts < kSumWarps ? parts : kSumWarps;
  sum_partials_kernel<TO><<<(unsigned)((n + 31) / 32), 32 * warps, 0,
                            stream>>>(partial, out, parts, n);
  return cudaGetLastError();
}

}  // namespace

}  // namespace ngpde
