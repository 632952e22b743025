// The Runge-Kutta solver's vector algebra on the state, one pass over memory
// per operation:
//   rk_combine_kernel:  out = [base +] [h *] ([0 +] c0*x0 + c1*x1 + ...)
//                       (a stage input, the new state, a Hermite save)
//   rk_norm_kernel:     the controller's scaled RMS norm of such a
//                       combination, sqrt(mean(q^2)) with
//                       q = e / (atol + rtol * max(|ref0|, |ref1|))
//   rk_scatter_kernel:  the combinations' backward, several outputs from one
//                       read of the cotangents: out_p = sum_m c_pm * [h *] g_m
//   rk_combine_dh_kernel, rk_norm_dh_kernel: the first two with h read from
//                       one double in device memory, so that a captured CUDA
//                       graph of a solver attempt takes a new step size on
//                       every replay; the same code on the same value (the
//                       double the host would pass, rounded to the compute
//                       type alike), so the same bits
//
// Replaces no Pallas kernel. The JAX reference writes this algebra in jnp
// (`y + h * sum(a_ij * k_j)`, the error estimate and its norm, the Hermite
// interpolant) and leaves it to XLA, which fuses each expression into one
// loop over the state. Eager PyTorch runs every product and sum as a kernel
// of its own, one pass over device memory each (a Tsit5 stage input reads
// and writes 5i + 4 states for stage i, the autograd backward of a step
// ~151). These kernels are the port's counterpart of XLA's fusion.
//
// Bound by bytes: one or two flops per element read. Each thread reads
// 16-byte vectors of every input (4 f32, 8 bf16 or 2 f64; a scalar tail and,
// where a pointer is not 16-byte aligned, a scalar loop), all of an
// element's inputs issued before any arithmetic, in a grid-stride loop over
// a grid the wrapper sizes to the card.
//
// Rounding: every product and sum is rounded on its own, in the order of
// the eager composition it replaces (__fmul_rn / __fadd_rn, never contracted
// into an FMA), and for bf16 every intermediate is rounded to bf16, as eager
// rounds each bf16 tensor it makes; so for finite inputs the results are
// bit-identical to the eager composition. The norm's sum of squares is taken
// in double, per thread, then in a fixed tree within a block, then over the
// blocks' partials in a second pass (or in the same block when one block
// covers the state): no atomics, so a rerun gives the same bits, though not
// torch.sum's order.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxIn = 8;    // inputs of one combination
constexpr int kMaxOut = 8;   // outputs of one scatter
constexpr int kThreads = 256;

using bf16 = __nv_bfloat16;

template <typename T>
struct OpT {
  using type = float;  // f32 and bf16 compute in f32, as eager does
};
template <>
struct OpT<double> {
  using type = double;
};
template <typename T>
using Op = typename OpT<T>::type;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float abs_op(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_op(double a) { return fabs(a); }

// v rounded through T: what an eager tensor of dtype T holds
template <typename T>
__device__ __forceinline__ Op<T> rnd(Op<T> v) {
  return v;
}
template <>
__device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_op(float v) { return v; }
__device__ __forceinline__ double to_op(double v) { return v; }
__device__ __forceinline__ float to_op(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_op(Op<T> v);
template <>
__device__ __forceinline__ float from_op<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ double from_op<double>(double v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_op<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive elements at p: one 16-byte load when V * sizeof(T) == 16
// (p then 16-byte aligned), else V scalar loads
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, Op<T> (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const T* t = reinterpret_cast<const T*>(&q);
#pragma unroll
    for (int u = 0; u < V; ++u) v[u] = to_op(t[u]);
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) v[u] = to_op(p[u]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Op<T> (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 q;
    T* t = reinterpret_cast<T*>(&q);
#pragma unroll
    for (int u = 0; u < V; ++u) t[u] = from_op<T>(v[u]);
    *reinterpret_cast<uint4*>(p) = q;
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) p[u] = from_op<T>(v[u]);
  }
}

// [base +] [h *] ([0 +] c0*x0 + c1*x1 + ...): the terms summed left to right
// from 0 (lead_zero, Python's sum) or from the first term. Coefficients are
// held in the compute type O (rounded from the caller's doubles as PyTorch
// rounds a Python scalar), so the kernels read them as operands from the
// parameter bank.
template <typename O>
struct ComboArgs {
  const void* x[kMaxIn];
  O c[kMaxIn];
  const void* base;  // null: none
  O h;
  int n;
  int has_h;
  int lead_zero;
};

// q = e / (atol + rtol * max(|ref0|, |ref1|)) of the combination e
template <typename O>
struct NormArgs {
  const void* ref0;
  const void* ref1;  // null: |ref0| alone
  O atol;
  O rtol;
};

// out_p = sum over m with c[p][m] != 0 of c[p][m] * ([h *] g_m), the terms
// summed left to right from the first
template <typename O>
struct ScatterArgs {
  const void* g[kMaxIn];
  void* out[kMaxOut];
  O c[kMaxOut][kMaxIn];
  int use_h[kMaxOut];
  O h;
  int n_in;
  int n_out;
};

template <typename T, int V>
__device__ __forceinline__ void combo_at(const ComboArgs<Op<T>>& a,
                                         long long e, Op<T> (&acc)[V]) {
  using O = Op<T>;
  O x[kMaxIn][V];
  O b[V];
#pragma unroll
  for (int j = 0; j < kMaxIn; ++j)
    if (j < a.n) load<T, V>(static_cast<const T*>(a.x[j]) + e, x[j]);
  if (a.base) load<T, V>(static_cast<const T*>(a.base) + e, b);
#pragma unroll
  for (int u = 0; u < V; ++u) acc[u] = O(0);
#pragma unroll
  for (int j = 0; j < kMaxIn; ++j) {
    if (j < a.n) {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const O p = rnd<T>(mul_rn(a.c[j], x[j][u]));
        acc[u] = (j == 0 && !a.lead_zero) ? p : rnd<T>(add_rn(acc[u], p));
      }
    }
  }
  if (a.has_h) {
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = rnd<T>(mul_rn(a.h, acc[u]));
  }
  if (a.base) {
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = rnd<T>(add_rn(b[u], acc[u]));
  }
}

// V elements a thread at a time over the first nvec * V elements, then the
// scalar tail
template <typename T, int V>
__device__ __forceinline__ void combine_all(const ComboArgs<Op<T>>& a,
                                            T* __restrict__ out, long long n) {
  using O = Op<T>;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nvec = n / V;
  for (long long i = tid; i < nvec; i += stride) {
    O v[V];
    combo_at<T, V>(a, i * V, v);
    store<T, V>(out + i * V, v);
  }
  for (long long e = nvec * V + tid; e < n; e += stride) {
    O v[1];
    combo_at<T, 1>(a, e, v);
    store<T, 1>(out + e, v);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    rk_combine_kernel(ComboArgs<Op<T>> a, T* __restrict__ out, long long n) {
  combine_all<T, V>(a, out, n);
}

// h from device memory: a.h is replaced by *h, rounded as the host rounds
// the double it passes (the shared loop leaves rk_combine_kernel's and
// rk_norm_kernel's code as it was, instruction for instruction)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    rk_combine_dh_kernel(ComboArgs<Op<T>> a, const double* __restrict__ h,
                         T* __restrict__ out, long long n) {
  a.h = static_cast<Op<T>>(*h);
  combine_all<T, V>(a, out, n);
}

// sum of v over the block, in a fixed order; the result in thread 0
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
  }
  return s;
}

// sqrt(sum / n) with each result rounded to T, as eager's
// sqrt(sum(q * q) / n) on a T tensor
template <typename T>
__device__ __forceinline__ void finish(double sum, long long n, T* out) {
  using O = Op<T>;
  const O s = rnd<T>(static_cast<O>(sum));
  const O mean = rnd<T>(div_rn(s, static_cast<O>(n)));
  out[0] = from_op<T>(sqrt_rn(mean));
}

template <typename T, int V>
__device__ __forceinline__ double norm_terms(const ComboArgs<Op<T>>& a,
                                             const NormArgs<Op<T>>& s,
                                             long long e) {
  using O = Op<T>;
  O v[V], r0[V], r1[V];
  combo_at<T, V>(a, e, v);
  load<T, V>(static_cast<const T*>(s.ref0) + e, r0);
  if (s.ref1) load<T, V>(static_cast<const T*>(s.ref1) + e, r1);
  double acc = 0.0;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    O m = abs_op(r0[u]);
    if (s.ref1) {
      const O m1 = abs_op(r1[u]);
      // torch.maximum: NaN if either is NaN
      m = (m != m || m1 != m1) ? m + m1 : (m1 > m ? m1 : m);
    }
    const O scale = rnd<T>(add_rn(s.atol, rnd<T>(mul_rn(s.rtol, m))));
    const O q = rnd<T>(div_rn(v[u], scale));
    acc += static_cast<double>(rnd<T>(mul_rn(q, q)));
  }
  return acc;
}

// One partial sum of q^2 a block; with one block, the norm itself
template <typename T, int V>
__device__ __forceinline__ void norm_all(const ComboArgs<Op<T>>& a,
                                         const NormArgs<Op<T>>& s,
                                         double* __restrict__ partial,
                                         T* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nvec = n / V;
  double acc = 0.0;
  for (long long i = tid; i < nvec; i += stride)
    acc += norm_terms<T, V>(a, s, i * V);
  for (long long e = nvec * V + tid; e < n; e += stride)
    acc += norm_terms<T, 1>(a, s, e);
  const double sum = block_sum(acc);
  if (threadIdx.x == 0) {
    if (gridDim.x == 1)
      finish<T>(sum, n, out);
    else
      partial[blockIdx.x] = sum;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    rk_norm_kernel(ComboArgs<Op<T>> a, NormArgs<Op<T>> s,
                   double* __restrict__ partial, T* __restrict__ out,
                   long long n) {
  norm_all<T, V>(a, s, partial, out, n);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    rk_norm_dh_kernel(ComboArgs<Op<T>> a, NormArgs<Op<T>> s,
                      const double* __restrict__ h,
                      double* __restrict__ partial, T* __restrict__ out,
                      long long n) {
  a.h = static_cast<Op<T>>(*h);
  norm_all<T, V>(a, s, partial, out, n);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rk_norm_finish_kernel(const double* __restrict__ partial, int parts,
                          T* __restrict__ out, long long n) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < parts; i += kThreads) acc += partial[i];
  const double sum = block_sum(acc);
  if (threadIdx.x == 0) finish<T>(sum, n, out);
}

template <typename T, int V>
__device__ __forceinline__ void scatter_at(const ScatterArgs<Op<T>>& a,
                                           long long e) {
  using O = Op<T>;
  O g[kMaxIn][V];
  O hg[kMaxIn][V];
#pragma unroll
  for (int m = 0; m < kMaxIn; ++m)
    if (m < a.n_in) load<T, V>(static_cast<const T*>(a.g[m]) + e, g[m]);
#pragma unroll
  for (int m = 0; m < kMaxIn; ++m)
    if (m < a.n_in) {
#pragma unroll
      for (int u = 0; u < V; ++u) hg[m][u] = rnd<T>(mul_rn(a.h, g[m][u]));
    }
#pragma unroll
  for (int p = 0; p < kMaxOut; ++p) {
    if (p < a.n_out) {
      O acc[V];
      bool first = true;
#pragma unroll
      for (int m = 0; m < kMaxIn; ++m) {
        if (m < a.n_in && a.c[p][m] != O(0)) {
#pragma unroll
          for (int u = 0; u < V; ++u) {
            const O t =
                rnd<T>(mul_rn(a.c[p][m], a.use_h[p] ? hg[m][u] : g[m][u]));
            acc[u] = first ? t : rnd<T>(add_rn(acc[u], t));
          }
          first = false;
        }
      }
      store<T, V>(static_cast<T*>(a.out[p]) + e, acc);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    rk_scatter_kernel(ScatterArgs<Op<T>> a, long long n) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nvec = n / V;
  for (long long i = tid; i < nvec; i += stride) scatter_at<T, V>(a, i * V);
  for (long long e = nvec * V + tid; e < n; e += stride)
    scatter_at<T, 1>(a, e);
}

template <typename T>
constexpr int kVec = 16 / sizeof(T);

// f(T(), vector width) for dtype 0 f32, 1 bf16, 2 f64, vec 1 or 16 bytes
template <typename F>
int dispatch(int dtype, int vec, F&& f) {
  switch (dtype) {
    case 0:
      return vec == 1 ? f(float(), std::integral_constant<int, 1>())
             : vec == kVec<float>
                 ? f(float(), std::integral_constant<int, kVec<float>>())
                 : -1;
    case 1:
      return vec == 1 ? f(bf16(), std::integral_constant<int, 1>())
             : vec == kVec<bf16>
                 ? f(bf16(), std::integral_constant<int, kVec<bf16>>())
                 : -1;
    case 2:
      return vec == 1 ? f(double(), std::integral_constant<int, 1>())
             : vec == kVec<double>
                 ? f(double(), std::integral_constant<int, kVec<double>>())
                 : -1;
  }
  return -1;
}

int bad_args() { return static_cast<int>(cudaErrorInvalidValue); }

template <typename O>
ComboArgs<O> combo_args(const void* const* x, const double* c, int n,
                        const void* base, double h, int has_h,
                        int lead_zero) {
  ComboArgs<O> a{};
  for (int j = 0; j < n; ++j) {
    a.x[j] = x[j];
    a.c[j] = static_cast<O>(c[j]);
  }
  a.base = base;
  a.h = static_cast<O>(h);
  a.n = n;
  a.has_h = has_h;
  a.lead_zero = lead_zero;
  return a;
}

// h_dev null: h from the host (rk_combine_kernel), else from *h_dev
// (rk_combine_dh_kernel)
int launch_combine(const void* const* x, const double* c, int n,
                   const void* base, double h, int has_h,
                   const double* h_dev, int lead_zero, void* out,
                   long long numel, int dtype, int vec, int grid,
                   void* stream_ptr) {
  if (n < 0 || n > kMaxIn || (n == 0 && !lead_zero) || grid <= 0)
    return bad_args();
  if (numel == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int err = dispatch(dtype, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int V = decltype(v)::value;
    const ComboArgs<Op<T>> a =
        combo_args<Op<T>>(x, c, n, base, h, has_h, lead_zero);
    if (h_dev)
      rk_combine_dh_kernel<T, V><<<grid, kThreads, 0, stream>>>(
          a, h_dev, static_cast<T*>(out), numel);
    else
      rk_combine_kernel<T, V><<<grid, kThreads, 0, stream>>>(
          a, static_cast<T*>(out), numel);
    return 0;
  });
  if (err) return bad_args();
  return static_cast<int>(cudaGetLastError());
}

// as launch_combine, for the norm
int launch_norm(const void* const* x, const double* c, int n, double h,
                int has_h, const double* h_dev, int lead_zero,
                const void* ref0, const void* ref1, double atol, double rtol,
                double* partial, void* out, long long numel, int dtype,
                int vec, int grid, void* stream_ptr) {
  if (n < 1 || n > kMaxIn || grid <= 0 || numel <= 0 || !ref0)
    return bad_args();
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int err = dispatch(dtype, vec, [&](auto t, auto v) {
    using T = decltype(t);
    using O = Op<T>;
    constexpr int V = decltype(v)::value;
    const ComboArgs<O> a =
        combo_args<O>(x, c, n, nullptr, h, has_h, lead_zero);
    const NormArgs<O> s{ref0, ref1, static_cast<O>(atol),
                        static_cast<O>(rtol)};
    if (h_dev)
      rk_norm_dh_kernel<T, V><<<grid, kThreads, 0, stream>>>(
          a, s, h_dev, partial, static_cast<T*>(out), numel);
    else
      rk_norm_kernel<T, V><<<grid, kThreads, 0, stream>>>(
          a, s, partial, static_cast<T*>(out), numel);
    if (grid > 1)
      rk_norm_finish_kernel<T><<<1, kThreads, 0, stream>>>(
          partial, grid, static_cast<T*>(out), numel);
    return 0;
  });
  if (err) return bad_args();
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: n input pointers, c: their n coefficients; base may be null. grid: the
// blocks to launch (the wrapper's choice, > 0).
int ngpde_rk_combine(const void* const* x, const double* c, int n,
                     const void* base, double h, int has_h, int lead_zero,
                     void* out, long long numel, int dtype, int vec, int grid,
                     void* stream_ptr) {
  return launch_combine(x, c, n, base, h, has_h, nullptr, lead_zero, out,
                        numel, dtype, vec, grid, stream_ptr);
}

// as ngpde_rk_combine, with h the double at h_dev in device memory
int ngpde_rk_combine_dh(const void* const* x, const double* c, int n,
                        const void* base, const void* h_dev, int lead_zero,
                        void* out, long long numel, int dtype, int vec,
                        int grid, void* stream_ptr) {
  if (!h_dev) return bad_args();
  return launch_combine(x, c, n, base, 0.0, 1,
                        static_cast<const double*>(h_dev), lead_zero, out,
                        numel, dtype, vec, grid, stream_ptr);
}

// partial: grid doubles of scratch (unused when grid is 1); out: one element
// of the state's dtype
int ngpde_rk_norm(const void* const* x, const double* c, int n, double h,
                  int has_h, int lead_zero, const void* ref0, const void* ref1,
                  double atol, double rtol, double* partial, void* out,
                  long long numel, int dtype, int vec, int grid,
                  void* stream_ptr) {
  return launch_norm(x, c, n, h, has_h, nullptr, lead_zero, ref0, ref1, atol,
                     rtol, partial, out, numel, dtype, vec, grid, stream_ptr);
}

// as ngpde_rk_norm, with h the double at h_dev in device memory
int ngpde_rk_norm_dh(const void* const* x, const double* c, int n,
                     const void* h_dev, int lead_zero, const void* ref0,
                     const void* ref1, double atol, double rtol,
                     double* partial, void* out, long long numel, int dtype,
                     int vec, int grid, void* stream_ptr) {
  if (!h_dev) return bad_args();
  return launch_norm(x, c, n, 0.0, 1, static_cast<const double*>(h_dev),
                     lead_zero, ref0, ref1, atol, rtol, partial, out, numel,
                     dtype, vec, grid, stream_ptr);
}

// g: n_in cotangents; out: n_out outputs; c: n_out rows of n_in
// coefficients (0: the input is not in that output, and every output has
// one that is not 0); use_h: per output
int ngpde_rk_scatter(const void* const* g, int n_in, void* const* out,
                     const double* c, const int* use_h, int n_out, double h,
                     long long numel, int dtype, int vec, int grid,
                     void* stream_ptr) {
  if (n_in < 1 || n_in > kMaxIn || n_out < 1 || n_out > kMaxOut || grid <= 0)
    return bad_args();
  for (int p = 0; p < n_out; ++p) {
    bool any = false;
    for (int m = 0; m < n_in; ++m) any |= c[p * n_in + m] != 0.0;
    if (!any) return bad_args();
  }
  if (numel == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int err = dispatch(dtype, vec, [&](auto t, auto v) {
    using T = decltype(t);
    using O = Op<T>;
    ScatterArgs<O> a{};
    for (int m = 0; m < n_in; ++m) a.g[m] = g[m];
    for (int p = 0; p < n_out; ++p) {
      a.out[p] = out[p];
      a.use_h[p] = use_h[p];
      for (int m = 0; m < n_in; ++m)
        a.c[p][m] = static_cast<O>(c[p * n_in + m]);
    }
    a.h = static_cast<O>(h);
    a.n_in = n_in;
    a.n_out = n_out;
    rk_scatter_kernel<T, decltype(v)::value><<<grid, kThreads, 0, stream>>>(
        a, numel);
    return 0;
  });
  if (err) return bad_args();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
