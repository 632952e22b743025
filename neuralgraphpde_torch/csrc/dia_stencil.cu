// K2: DIA stencil SpMM and the fused GCN right-hand side,
//   acc[i, :] = sum_k vals[i, k] * x[i + offsets[k], :]   (0 <= i+off < n)
//   out       = act(acc @ W + b)   (W, b optional; plain stencil: act = id)
// Replaces neuralgraphpde/kernels/dia_kernels.py::_dia_rhs_fwd.
//
// T is the dtype of vals, x and W (f32 or bf16), TO the output's. The
// accumulator is f32; with bf16 T it is rounded to bf16 before the W
// product, as the TPU kernel does. Neighbours outside [0, n) are masked
// here, so x is read unpadded.
//
// dia_stencil_kernel (no W): one thread per output element, features
// fastest, so a warp reads contiguous x.
// dia_gcn_rhs_kernel (with W): a block owns kRows output rows. Phase 1
// writes the block's aggregated rows to shared memory (width padded to a
// multiple of 32 with zeros). Phase 2 is the shared GCN epilogue of
// common.cuh: it walks the output in 64-wide chunks, streams W through a
// 32 x 64 shared tile, each thread accumulating kRows/4 rows of one output
// column in registers, then adds b, applies the activation and stores.
#include "common.cuh"

namespace {

using ngpde::activate;
using ngpde::from_f32;
using ngpde::round_to;
using ngpde::to_f32;

constexpr int kMaxDiags = 32;
constexpr int kThreads = 256;
constexpr int kRows = 32;  // rows per block in the fused kernel

template <typename T, typename TO, int ACT, bool HAS_B>
__global__ void __launch_bounds__(kThreads)
    dia_stencil_kernel(const T* __restrict__ vals,
                       const int* __restrict__ offsets, int K,
                       const T* __restrict__ x, const float* __restrict__ b,
                       TO* __restrict__ out, int n, int F) {
  __shared__ int offs[kMaxDiags];
  if (threadIdx.x < K) offs[threadIdx.x] = offsets[threadIdx.x];
  __syncthreads();
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * F) return;
  const int i = (int)(idx / F);
  const int f = (int)(idx - (long long)i * F);
  float acc = 0.f;
  for (int k = 0; k < K; ++k) {
    const int j = i + offs[k];
    if (j >= 0 && j < n)
      acc = fmaf(to_f32(vals[(long long)i * K + k]),
                 to_f32(x[(long long)j * F + f]), acc);
  }
  float h = acc;
  if (HAS_B) h += b[f];
  out[idx] = from_f32<TO>(activate<ACT>(h));
}

template <typename T, typename TO, int ACT, bool HAS_B>
__global__ void __launch_bounds__(kThreads)
    dia_gcn_rhs_kernel(const T* __restrict__ vals,
                       const int* __restrict__ offsets, int K,
                       const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ b, TO* __restrict__ out,
                       int n, int F, int O, int Fp) {
  extern __shared__ float smem[];
  float* agg = smem;                  // kRows x Fp
  float* w_tile = smem + kRows * Fp;  // kEpiTileF x kEpiTileO
  __shared__ int offs[kMaxDiags];
  const int tid = threadIdx.x;
  if (tid < K) offs[tid] = offsets[tid];
  __syncthreads();
  const int i0 = blockIdx.x * kRows;

  // phase 1: the block's aggregated rows
  for (int idx = tid; idx < kRows * Fp; idx += kThreads) {
    const int r = idx / Fp;
    const int f = idx - r * Fp;
    const int i = i0 + r;
    float acc = 0.f;
    if (i < n && f < F) {
      for (int k = 0; k < K; ++k) {
        const int j = i + offs[k];
        if (j >= 0 && j < n)
          acc = fmaf(to_f32(vals[(long long)i * K + k]),
                     to_f32(x[(long long)j * F + f]), acc);
      }
    }
    agg[idx] = round_to<T>(acc);
  }
  __syncthreads();

  // phase 2: agg @ W + b, activation, store
  ngpde::gcn_epilogue<T, TO, ACT, HAS_B, kRows, kThreads>(
      agg, Fp, w_tile, w, b, out, i0, min(kRows, n - i0), F, O);
}

template <typename T, typename TO, int ACT, bool HAS_B>
cudaError_t launch_stencil(const void* vals, const int* offsets, int K,
                           const void* x, const float* b, void* out, int n,
                           int F, cudaStream_t stream) {
  const long long total = (long long)n * F;
  const long long blocks = (total + kThreads - 1) / kThreads;
  dia_stencil_kernel<T, TO, ACT, HAS_B><<<(unsigned)blocks, kThreads, 0,
                                          stream>>>(
      static_cast<const T*>(vals), offsets, K, static_cast<const T*>(x), b,
      static_cast<TO*>(out), n, F);
  return cudaGetLastError();
}

template <typename T, typename TO, int ACT, bool HAS_B>
cudaError_t launch_gcn_rhs(const void* vals, const int* offsets, int K,
                           const void* x, const void* w, const float* b,
                           void* out, int n, int F, int O,
                           cudaStream_t stream) {
  constexpr int kTileF = ngpde::kEpiTileF;
  const int Fp = (F + kTileF - 1) / kTileF * kTileF;
  const size_t smem =
      sizeof(float) * ((size_t)kRows * Fp + kTileF * ngpde::kEpiTileO);
  cudaError_t err = cudaFuncSetAttribute(
      dia_gcn_rhs_kernel<T, TO, ACT, HAS_B>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kRows - 1) / kRows;
  dia_gcn_rhs_kernel<T, TO, ACT, HAS_B><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(vals), offsets, K, static_cast<const T*>(x),
      static_cast<const T*>(w), b, static_cast<TO*>(out), n, F, O, Fp);
  return cudaGetLastError();
}

// act x has_b -> one instantiation each
template <typename T, typename TO>
cudaError_t stencil_typed(int act, bool has_b, const void* vals,
                          const int* offsets, int K, const void* x,
                          const float* b, void* out, int n, int F,
                          cudaStream_t s) {
  switch (act * 2 + (has_b ? 1 : 0)) {
    case 0: return launch_stencil<T, TO, 0, false>(vals, offsets, K, x, b, out, n, F, s);
    case 1: return launch_stencil<T, TO, 0, true>(vals, offsets, K, x, b, out, n, F, s);
    case 2: return launch_stencil<T, TO, 1, false>(vals, offsets, K, x, b, out, n, F, s);
    case 3: return launch_stencil<T, TO, 1, true>(vals, offsets, K, x, b, out, n, F, s);
    case 4: return launch_stencil<T, TO, 2, false>(vals, offsets, K, x, b, out, n, F, s);
    case 5: return launch_stencil<T, TO, 2, true>(vals, offsets, K, x, b, out, n, F, s);
    case 6: return launch_stencil<T, TO, 3, false>(vals, offsets, K, x, b, out, n, F, s);
    case 7: return launch_stencil<T, TO, 3, true>(vals, offsets, K, x, b, out, n, F, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename TO>
cudaError_t gcn_rhs_typed(int act, bool has_b, const void* vals,
                          const int* offsets, int K, const void* x,
                          const void* w, const float* b, void* out, int n,
                          int F, int O, cudaStream_t s) {
  switch (act * 2 + (has_b ? 1 : 0)) {
    case 0: return launch_gcn_rhs<T, TO, 0, false>(vals, offsets, K, x, w, b, out, n, F, O, s);
    case 1: return launch_gcn_rhs<T, TO, 0, true>(vals, offsets, K, x, w, b, out, n, F, O, s);
    case 2: return launch_gcn_rhs<T, TO, 1, false>(vals, offsets, K, x, w, b, out, n, F, O, s);
    case 3: return launch_gcn_rhs<T, TO, 1, true>(vals, offsets, K, x, w, b, out, n, F, O, s);
    case 4: return launch_gcn_rhs<T, TO, 2, false>(vals, offsets, K, x, w, b, out, n, F, O, s);
    case 5: return launch_gcn_rhs<T, TO, 2, true>(vals, offsets, K, x, w, b, out, n, F, O, s);
    case 6: return launch_gcn_rhs<T, TO, 3, false>(vals, offsets, K, x, w, b, out, n, F, O, s);
    case 7: return launch_gcn_rhs<T, TO, 3, true>(vals, offsets, K, x, w, b, out, n, F, O, s);
  }
  return cudaErrorInvalidValue;
}

bool valid(int act, int K) {
  return act >= 0 && act <= 3 && K >= 0 && K <= kMaxDiags;
}

}  // namespace

extern "C" {

// act: 0 identity, 1 tanh, 2 relu, 3 sigmoid; b may be null.
int ngpde_dia_stencil(const void* vals, const int* offsets, int K,
                      const void* x, const float* b, void* out, int n, int F,
                      int act, int in_bf16, int out_bf16, void* stream_ptr) {
  if (!valid(act, K)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || F == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  using bf16 = __nv_bfloat16;
  const bool hb = b != nullptr;
  cudaError_t err;
  if (!in_bf16 && !out_bf16)
    err = stencil_typed<float, float>(act, hb, vals, offsets, K, x, b, out, n, F, s);
  else if (!in_bf16)
    err = stencil_typed<float, bf16>(act, hb, vals, offsets, K, x, b, out, n, F, s);
  else if (!out_bf16)
    err = stencil_typed<bf16, float>(act, hb, vals, offsets, K, x, b, out, n, F, s);
  else
    err = stencil_typed<bf16, bf16>(act, hb, vals, offsets, K, x, b, out, n, F, s);
  return static_cast<int>(err);
}

// W is (F, O) row-major in the dtype of vals; b (O,) f32 or null.
int ngpde_dia_gcn_rhs(const void* vals, const int* offsets, int K,
                      const void* x, const void* w, const float* b, void* out,
                      int n, int F, int O, int act, int in_bf16, int out_bf16,
                      void* stream_ptr) {
  if (!valid(act, K) || F > 512) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || O == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  using bf16 = __nv_bfloat16;
  const bool hb = b != nullptr;
  cudaError_t err;
  if (!in_bf16 && !out_bf16)
    err = gcn_rhs_typed<float, float>(act, hb, vals, offsets, K, x, w, b, out, n, F, O, s);
  else if (!in_bf16)
    err = gcn_rhs_typed<float, bf16>(act, hb, vals, offsets, K, x, w, b, out, n, F, O, s);
  else if (!out_bf16)
    err = gcn_rhs_typed<bf16, float>(act, hb, vals, offsets, K, x, w, b, out, n, F, O, s);
  else
    err = gcn_rhs_typed<bf16, bf16>(act, hb, vals, offsets, K, x, w, b, out, n, F, O, s);
  return static_cast<int>(err);
}

}  // extern "C"
