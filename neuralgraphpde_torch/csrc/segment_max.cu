// K6: receiver segment-max of per-edge messages over the edge-id CSR
// (`tcsr_edges`: receiver-sorted rows whose `col` holds edge ids),
//   out[i, :] = max_{row_ptr[i] <= s < row_ptr[i+1]} m[col[s], :]
// with -inf for a row that has no edge. Replaces
// neuralgraphpde/kernels/segment_kernels.py::_tiled_segment_max_fwd.
//
// What bounds it on the H100: bytes. Each edge's message row is read once
// (F * 4 bytes) with its id (4 bytes), each output row written once; one
// compare per element. The TPU kernel's segmented max-scan on the VPU and
// its one-hot MXU product only serve to place each run's maximum in a
// sequential grid; here a receiver's row is one warp's:
// - the lanes split the row's F features in 16-byte vectors (4 f32), so
//   one message row is one coalesced read; rows narrower than 32 vectors
//   split the warp into groups that take every `groups`-th edge, and a
//   shuffle tree combines the groups;
// - a running max in registers, one store per row, no atomics. Max is
//   order-free, so the result is exact and the same on every run (the sign
//   of a zero aside).
// A NaN message makes its row's entry NaN, as `scatter_reduce_` amax and
// `jax.ops.segment_max` do (the `xla` paths).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;  // 8 rows per block

// max that keeps a NaN: v wins if it is larger or NaN, a NaN in a stays
__device__ __forceinline__ float max_nan(float a, float v) {
  return (v > a || v != v) ? v : a;
}

__device__ __forceinline__ void load_vec(const float* p, float (&v)[1]) {
  v[0] = *p;
}

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    segment_max_kernel(const int* __restrict__ row_ptr,
                       const int* __restrict__ col,
                       const float* __restrict__ m, float* __restrict__ out,
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
      float* o = out + (long long)row * F + (long long)c * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = acc[j];
    }
  }
}

template <int VEC>
void launch(const int* row_ptr, const int* col, const float* m, float* out,
            int n_rows, int F, cudaStream_t stream) {
  const int f_vec = F / VEC;
  int group = 1;
  while (group < f_vec && group < 32) group <<= 1;
  const long long blocks = ((long long)n_rows * 32 + kThreads - 1) / kThreads;
  segment_max_kernel<VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      row_ptr, col, m, out, n_rows, F, group);
}

}  // namespace

extern "C" {

// m (E, F) and out (n_rows, F) f32; vec is 4 (the caller checks F % 4 and
// 16-byte alignment) or 1. Returns a cudaError_t.
int ngpde_segment_max(const int* row_ptr, const int* col, const float* m,
                      float* out, int n_rows, int F, int vec,
                      void* stream_ptr) {
  if (n_rows == 0 || F == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (vec == 4)
    launch<4>(row_ptr, col, m, out, n_rows, F, stream);
  else if (vec == 1)
    launch<1>(row_ptr, col, m, out, n_rows, F, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
