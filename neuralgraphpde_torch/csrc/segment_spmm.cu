// K1: receiver segment-SpMM over a receiver-sorted CSR,
//   out[i, :] = sum_{row_ptr[i] <= e < row_ptr[i+1]} w[e] * x[col[e], :]
// Replaces neuralgraphpde/kernels/segment_kernels.py::_tiled_segment_spmm_fwd.
//
// One warp per output row. The row's F features are read as VEC-wide
// vectors (16 bytes: 4 f32 or 8 bf16). A warp splits into groups of
// `group` lanes (a power of two covering the row's vectors, at most 32); the
// groups take interleaved edges of the row, and a shuffle tree adds them.
// f32 accumulation in registers, one store per row, no atomics.
#include "common.cuh"

namespace {

using ngpde::from_f32;
using ngpde::to_f32;

constexpr int kThreads = 256;  // 8 rows per block

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

template <typename TI, typename TO, int VEC>
__global__ void __launch_bounds__(kThreads)
    segment_spmm_kernel(const int* __restrict__ row_ptr,
                        const int* __restrict__ col,
                        const float* __restrict__ w,
                        const TI* __restrict__ x, TO* __restrict__ out,
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
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    if (c < f_vec) {
      for (int e = start + g; e < end; e += n_groups) {
        const long long s = col[e];
        const float we = w[e];
        float v[VEC];
        load_vec(x + s * F + (long long)c * VEC, v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = fmaf(we, v[j], acc[j]);
      }
    }
    // every lane reaches the shuffles: add the groups' partial sums
    for (int off = group; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
    }
    if (g == 0 && c < f_vec) {
      TO* o = out + (long long)row * F + (long long)c * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = from_f32<TO>(acc[j]);
    }
  }
}

template <typename TI, typename TO, int VEC>
void launch(const int* row_ptr, const int* col, const float* w, const void* x,
            void* out, int n_rows, int F, cudaStream_t stream) {
  const int f_vec = F / VEC;
  int group = 1;
  while (group < f_vec && group < 32) group <<= 1;
  const long long blocks = ((long long)n_rows * 32 + kThreads - 1) / kThreads;
  segment_spmm_kernel<TI, TO, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      row_ptr, col, w, static_cast<const TI*>(x), static_cast<TO*>(out),
      n_rows, F, group);
}

}  // namespace

extern "C" {

const char* ngpde_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// in_bf16/out_bf16 pick the dtypes of x and out; vec is 1 or the 16-byte
// vector width of x's dtype (the caller checks alignment and F % vec).
int ngpde_segment_spmm(const int* row_ptr, const int* col, const float* w,
                       const void* x, void* out, int n_rows, int F,
                       int in_bf16, int out_bf16, int vec, void* stream_ptr) {
  if (n_rows == 0 || F == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  using bf16 = __nv_bfloat16;
  if (!in_bf16 && vec == 4) {
    if (out_bf16)
      launch<float, bf16, 4>(row_ptr, col, w, x, out, n_rows, F, stream);
    else
      launch<float, float, 4>(row_ptr, col, w, x, out, n_rows, F, stream);
  } else if (in_bf16 && vec == 8) {
    if (out_bf16)
      launch<bf16, bf16, 8>(row_ptr, col, w, x, out, n_rows, F, stream);
    else
      launch<bf16, float, 8>(row_ptr, col, w, x, out, n_rows, F, stream);
  } else if (vec == 1) {
    if (!in_bf16 && !out_bf16)
      launch<float, float, 1>(row_ptr, col, w, x, out, n_rows, F, stream);
    else if (!in_bf16)
      launch<float, bf16, 1>(row_ptr, col, w, x, out, n_rows, F, stream);
    else if (!out_bf16)
      launch<bf16, float, 1>(row_ptr, col, w, x, out, n_rows, F, stream);
    else
      launch<bf16, bf16, 1>(row_ptr, col, w, x, out, n_rows, F, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
