// K6: receiver segment-max of per-edge messages over the edge-id CSR
// (`tcsr_edges`: receiver-sorted rows whose `col` holds edge ids),
//   out[i, :] = max_{row_ptr[i] <= s < row_ptr[i+1]} m[col[s], :]
// with -inf for a row that has no edge. Replaces
// neuralgraphpde/kernels/segment_kernels.py::_tiled_segment_max_fwd.
//
// Messages and output are f32 or bf16 (one dtype): bf16 messages are read
// as bf16 and compared in f32 (exact: bf16 -> f32 is exact, and a maximum
// is one of its inputs), and the output is written back in bf16, as the
// TPU kernel's f32 output is cast back to the messages' dtype.
//
// What bounds it on the H100: bytes. Each edge's message row is read once
// (F * itemsize bytes) with its id (4 bytes), each output row written once;
// one compare per element. The TPU kernel's segmented max-scan on the VPU
// and its one-hot MXU product only serve to place each run's maximum in a
// sequential grid; here a receiver's row is one warp's:
// - the lanes split the row's F features in 16-byte vectors (4 f32 or 8
//   bf16), so one message row is one coalesced read; rows narrower than 32
//   vectors split the warp into groups that take every `groups`-th edge,
//   and a shuffle tree combines the groups;
// - a running max in registers, one store per row, no atomics. Max is
//   order-free, so the result is exact and the same on every run (the sign
//   of a zero aside).
// A NaN message makes its row's entry NaN, as `scatter_reduce_` amax and
// `jax.ops.segment_max` do (the `xla` paths).
#include <math_constants.h>

#include "common.cuh"

namespace {

using ngpde::from_f32;
using ngpde::to_f32;

constexpr int kThreads = 256;  // 8 rows per block

// max that keeps a NaN: v wins if it is larger or NaN, a NaN in a stays
__device__ __forceinline__ float max_nan(float a, float v) {
  return (v > a || v != v) ? v : a;
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[1]) {
  v[0] = to_f32(*p);
}

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    segment_max_kernel(const int* __restrict__ row_ptr,
                       const int* __restrict__ col,
                       const T* __restrict__ m, T* __restrict__ out,
                       int n_rows, int F, int group) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int row = (int)(tid >> 5);
  if (row >= n_rows) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int g = lane / group;
  const int gl = lane % group;
  const int n_groups = 32 / group;
  const int start = row_ptr[row];
  const int end = row_ptr[row + 1];
  const int f_vec = F / VEC;
  for (int c0 = 0; c0 < f_vec; c0 += group) {
    const int c = c0 + gl;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = -CUDART_INF_F;
    if (c < f_vec) {
      for (int e = start + g; e < end; e += n_groups) {
        float v[VEC];
        load_vec(m + (long long)col[e] * F + (long long)c * VEC, v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = max_nan(acc[j], v[j]);
      }
    }
    // every lane reaches the shuffles: combine the groups' maxima
    for (int off = group; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[j] = max_nan(acc[j], __shfl_xor_sync(0xffffffffu, acc[j], off));
    }
    if (g == 0 && c < f_vec) {
      T* o = out + (long long)row * F + (long long)c * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = from_f32<T>(acc[j]);
    }
  }
}

template <typename T, int VEC>
void launch(const int* row_ptr, const int* col, const void* m, void* out,
            int n_rows, int F, cudaStream_t stream) {
  const int f_vec = F / VEC;
  int group = 1;
  while (group < f_vec && group < 32) group <<= 1;
  const long long blocks = ((long long)n_rows * 32 + kThreads - 1) / kThreads;
  segment_max_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      row_ptr, col, static_cast<const T*>(m), static_cast<T*>(out), n_rows,
      F, group);
}

}  // namespace

extern "C" {

// m (E, F) and out (n_rows, F), both f32 or both bf16 (bf16 != 0); vec is
// 1 or the 16-byte vector width of the dtype, 4 or 8 (the caller checks F %
// vec and 16-byte alignment). Returns a cudaError_t.
int ngpde_segment_max(const int* row_ptr, const int* col, const void* m,
                      void* out, int n_rows, int F, int bf16, int vec,
                      void* stream_ptr) {
  if (n_rows == 0 || F == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  using bf = __nv_bfloat16;
  if (!bf16 && vec == 4)
    launch<float, 4>(row_ptr, col, m, out, n_rows, F, stream);
  else if (!bf16 && vec == 1)
    launch<float, 1>(row_ptr, col, m, out, n_rows, F, stream);
  else if (bf16 && vec == 8)
    launch<bf, 8>(row_ptr, col, m, out, n_rows, F, stream);
  else if (bf16 && vec == 1)
    launch<bf, 1>(row_ptr, col, m, out, n_rows, F, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
