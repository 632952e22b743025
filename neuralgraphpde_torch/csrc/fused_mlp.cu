// K3: fused edge-MLP + receiver reduce over a receiver-sorted CSR whose
// `col` holds edge ids (the `tcsr_edges` layout),
//   out[i, :] = sum_{row_ptr[i] <= s < row_ptr[i+1]} w[s] * MLP(feats[col[s], :])
// with MLP = up to 4 Dense layers (x @ W + b, then a static activation), in
// true f32, and its VJP: dfeats, and dW, db of every layer.
// Replaces neuralgraphpde/kernels/fused_mlp_kernels.py::_fused_mlp_fwd and
// ::_fused_mlp_bwd_pallas.
//
// Dtypes, as the TPU kernels take them: feats (and the output, g_out and
// dfeats) in TF, the weights and biases (and dW, db) in TW, each f32 or
// bf16. Every operand is converted to f32 as it is loaded; the shared tiles,
// the accumulators and the per-block dW/db partials are f32, and each result
// is rounded to its dtype once, when it is stored (dW/db after the partials
// are summed). Under the precision policy TW is bf16 and TF is bf16, or f32
// where the edge features concatenate f32 graph data.
//
// What bounds it on the H100: at the VMH widths (4 -> 60 -> 60 -> 60) an
// edge costs ~7.4k FMAs forward and ~3x that backward, against 16 bytes of
// input and a 240-byte output row per receiver: far above the ridge point
// in f32, so the limit is the CUDA cores' f32 FMA rate and the shared-memory
// operand traffic that feeds them (the tensor cores would round to TF32).
// The TPU kernel keeps every hidden activation in VMEM; here a block keeps
// them in shared memory, so only the gathered inputs, the output rows (and
// backward the output-gradient rows and dfeats) touch device memory.
//
// Design:
// - a block of 128 threads owns a run of consecutive receiver rows and walks
//   their edge slots in chunks of 32. Every layer is a small GEMM on the
//   chunk (32 x K_in times K_in x K_out) in shared memory; each thread owns
//   4x4 output tiles. Widths are padded to a multiple of 4 with zeros, and
//   row strides are odd (padded width + 1) against bank conflicts.
// - forward: all weights and biases staged in shared memory once per block;
//   each row's sum is kept in shared memory by one owning thread, added in
//   slot order, stored once per row: no atomics, deterministic.
// - backward: the TPU kernel adds dW/db into output blocks that every
//   (sequential) grid step revisits; GPU blocks run in no order. Here each
//   block recomputes its chunk's activations, keeps them (and the
//   pre-activations) in shared memory, and reverses through the layers with
//   the exact derivative of each activation. dW/db accumulate per block in
//   shared memory, each entry owned by one thread; the block writes them to
//   a per-block scratch row and a second kernel sums the rows in block
//   order. dfeats[col[s]] is written directly: every edge id appears once in
//   `col`, so there is no scatter. The result is the same on every run.
//
// Two variants of each kernel, chosen by the launcher from the widths alone:
// - resident (above): every weight, and backward every dW/db, lives in
//   shared memory for the whole block. Taken when it fits (VMH's widths).
// - streamed: for wider MLPs (MP-PDE's 282 -> 128, 4 -> 300 -> 300, ...).
//   Each layer's W passes through shared tiles of `kt` rows, two buffers
//   filled by cp.async, so the next tile's copy runs under the current
//   tile's product; the chunk's activations (`te` edge slots, 4 <= te <=
//   32) and the layer's bias stay in shared memory. The backward stores its
//   first chunk's dW/db straight into the block's partial row in device
//   memory and adds the later chunks' onto it, each entry owned by one
//   thread (the same mapping on every chunk), and the same in-order sum of
//   the partials follows: still no atomics, still deterministic. Every
//   MLP of 1 to 4 layers with widths up to 1024 has a streamed plan (4
//   layers of 1024 take te = 4). W is read once per chunk whatever a
//   block's size, so the wrapper spreads a small graph's rows over about
//   one block per SM and the launcher sizes the chunk to the average slots
//   per block. The streamed backward runs kBwdThreads threads a block and
//   computes its recompute, dW = h^T dz and dh = dz W^T as register tiles
//   (see its section below).
// - the streamed blocks' other copies from device memory (the forward's
//   biases and gathered inputs, the backward's gathered inputs and
//   cotangent rows) issue kBatch loads per thread before their first
//   store: a plain loop waits out each load's latency,
//   since the compiler cannot move a load above a store that may alias it.
//   The resident kernels share the input gather but keep plain loops for
//   their weights and cotangent rows: batched there, the resident backward
//   ran slower on the H100.
#include "common.cuh"

namespace {

using ngpde::cp_async_commit;
using ngpde::cp_async_wait;
using ngpde::from_f32;
using ngpde::to_f32;
using bf16 = __nv_bfloat16;

constexpr int kMaxLayers = 4;
constexpr int kMaxWidth = 1024;
constexpr int kThreads = 128;
// the streamed backward's block: 8 warps, so that each SM scheduler has two
// to switch between (scripts/fused_mlp_variants.py times 128, 256 and 384)
constexpr int kBwdThreads = 256;
constexpr int kTE = 32;  // edge slots per chunk
constexpr int kKT = 64;  // W rows per streamed tile, at most
constexpr int kBatch = 8;  // loads in flight per thread in block_copy
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
// returned by the launchers for an MLP outside the envelope (cudaError_t
// codes are >= 0)
constexpr int kOutsideEnvelope = -1;
constexpr int kMaxFwdRows = 64;  // receiver rows per forward block, at most
enum Variant { kResident = 0, kStreamed = 1 };

enum Act {
  kIdentity = 0, kRelu, kTanh, kSigmoid, kSoftplus, kElu, kGelu, kSwish
};

struct Mlp {
  const void* w[kMaxLayers];  // (dim[l], dim[l+1]) row-major, in TW
  const void* b[kMaxLayers];  // (dim[l+1],), in TW
  int dim[kMaxLayers + 1];
  int act[kMaxLayers];
  int n;
};

__host__ __device__ __forceinline__ int pad4(int d) { return (d + 3) & ~3; }

// element i of a device array of T, as f32
template <typename T>
__device__ __forceinline__ float ld(const void* p, long long i) {
  return to_f32(static_cast<const T*>(p)[i]);
}
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

// float offsets into the dynamic shared memory of one block
struct Layout {
  int w[kMaxLayers], b[kMaxLayers], dw[kMaxLayers], db[kMaxLayers];
  int h[kMaxLayers + 1], z[kMaxLayers], d[2], acc;
  int sd;  // row stride of the chunk buffers h[0..1] (fwd) and d[0..1]
  int total;
};

__host__ __device__ inline Layout make_layout(const Mlp& m, int rows,
                                              bool bwd) {
  Layout L{};
  int off = 0, pmax = 0;
  for (int l = 0; l <= m.n; ++l) pmax = imax(pmax, pad4(m.dim[l]));
  L.sd = pmax + 1;
  for (int l = 0; l < m.n; ++l) {
    const int pin = pad4(m.dim[l]), pout = pad4(m.dim[l + 1]);
    L.w[l] = off;
    off += pin * (pout + 1);
    L.b[l] = off;
    off += pout;
    if (bwd) {
      L.dw[l] = off;
      off += pin * (pout + 1);
      L.db[l] = off;
      off += pout;
    }
  }
  if (bwd) {
    for (int l = 0; l <= m.n; ++l) {
      L.h[l] = off;
      off += kTE * (pad4(m.dim[l]) + 1);
    }
    for (int l = 0; l < m.n; ++l) {
      L.z[l] = off;
      off += kTE * (pad4(m.dim[l + 1]) + 1);
    }
    L.d[0] = off;
    off += kTE * L.sd;
    L.d[1] = off;
    off += kTE * L.sd;
  } else {
    L.h[0] = off;
    off += kTE * L.sd;
    L.h[1] = off;
    off += kTE * L.sd;
    L.acc = off;
    off += rows * pad4(m.dim[m.n]);
  }
  L.total = off;
  return L;
}

// float offsets into the dynamic shared memory of a streamed block: two W
// tiles, the bias, then the chunk buffers of te slots (bwd: h[0..n],
// z[0..n-1], d[0..1]; fwd: h[0..1] and the block's `rows` output sums).
// The forward's chunk rows have odd strides; the backward's are multiples
// of 4 floats (h[l] and z[l] pad4 of their width, d[0..1] the widest), so
// its float4 loads are aligned: its lanes read along a row, or all read
// one address, so no stride of theirs conflicts.
struct StreamLayout {
  int wt[2], bias, h[kMaxLayers + 1], z[kMaxLayers], d[2], acc;
  int sd;  // row stride of h[0..1] (fwd) and d[0..1]
  int te, kt, total;
};

__host__ __device__ inline StreamLayout make_stream_layout(const Mlp& m,
                                                           int te, int kt,
                                                           int rows,
                                                           bool bwd) {
  StreamLayout L{};
  int off = 0, pmax = 0;
  for (int l = 0; l <= m.n; ++l) pmax = imax(pmax, pad4(m.dim[l]));
  L.sd = bwd ? pmax : pmax + 1;
  L.te = te;
  L.kt = kt;
  for (int t = 0; t < 2; ++t) {
    L.wt[t] = off;
    off += kt * (pmax + 1);
  }
  L.bias = off;
  off += pmax;
  if (bwd) {
    // unrolled to kMaxLayers, so that L stays in registers on the device
#pragma unroll
    for (int l = 0; l <= kMaxLayers; ++l) {
      if (l > m.n) break;
      L.h[l] = off;
      off += te * pad4(m.dim[l]);
    }
#pragma unroll
    for (int l = 0; l < kMaxLayers; ++l) {
      if (l >= m.n) break;
      L.z[l] = off;
      off += te * pad4(m.dim[l + 1]);
    }
    L.d[0] = off;
    off += te * L.sd;
    L.d[1] = off;
    off += te * L.sd;
  } else {
    L.h[0] = off;
    off += te * L.sd;
    L.h[1] = off;
    off += te * L.sd;
    L.acc = off;
    off += rows * pad4(m.dim[m.n]);
  }
  L.total = off;
  return L;
}

// the resident block fits: forward at kMaxFwdRows rows, or the backward
bool resident_fits(const Mlp& m, bool bwd) {
  const int floats = bwd ? make_layout(m, 1, true).total
                         : make_layout(m, kMaxFwdRows, false).total;
  return floats * (int)sizeof(float) <= kMaxSmem;
}

struct StreamPlan {
  int te, kt, rows, smem;
};

// the largest chunk of at most max(4, te_max) slots, then the largest W
// tile, that fit, and (forward) at most `rows` receiver rows per block;
// false if nothing fits
bool plan_stream(const Mlp& m, int rows, int te_max, bool bwd,
                 StreamPlan* p) {
  const int pn = pad4(m.dim[m.n]);
  int te0 = 4;
  while (te0 < te_max && te0 < kTE) te0 <<= 1;
  for (int te = te0; te >= 4; te >>= 1) {
    for (int kt = kKT; kt >= 4; kt >>= 1) {
      const int avail = kMaxSmem / (int)sizeof(float) -
                        make_stream_layout(m, te, kt, 0, bwd).total;
      const int r = bwd ? rows : (avail / pn < rows ? avail / pn : rows);
      if (avail < 0 || r < 1) continue;
      p->te = te;
      p->kt = kt;
      p->rows = r;
      p->smem = make_stream_layout(m, te, kt, r, bwd).total *
                (int)sizeof(float);
      return true;
    }
  }
  return false;
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluA = 0.044715f;

__device__ __forceinline__ float act_fwd(int act, float z) {
  switch (act) {
    case kRelu: return fmaxf(z, 0.f);
    case kTanh: return tanhf(z);
    case kSigmoid: return sigmoid(z);
    case kSoftplus: return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
    case kElu: return z > 0.f ? z : expm1f(z);
    case kGelu:
      return 0.5f * z * (1.f + tanhf(kGeluC * (z + kGeluA * z * z * z)));
    case kSwish: return z * sigmoid(z);
    default: return z;
  }
}

// d act / dz at pre-activation z with value h = act(z)
__device__ __forceinline__ float act_grad(int act, float z, float h) {
  switch (act) {
    case kRelu: return z > 0.f ? 1.f : 0.f;
    case kTanh: return 1.f - h * h;
    case kSigmoid: return h * (1.f - h);
    case kSoftplus: return sigmoid(z);
    case kElu: return z > 0.f ? 1.f : expf(z);
    case kGelu: {
      const float t = tanhf(kGeluC * (z + kGeluA * z * z * z));
      return 0.5f * (1.f + t) +
             0.5f * z * (1.f - t * t) * kGeluC * (1.f + 3.f * kGeluA * z * z);
    }
    case kSwish: {
      const float s = sigmoid(z);
      return s + z * s * (1.f - s);
    }
    default: return 1.f;
  }
}

// out(i, j) = sum_{k < K} A[i*ai + k*ak] * B[k*bk + j*bj] for i < M, j < N
// (both multiples of 4); each thread takes 4x4 tiles, and `epi(i, j, v)`
// stores. Every (i, j) belongs to one thread, the same on every call with
// the same M and N.
template <typename Epi>
__device__ __forceinline__ void block_gemm(int M, int N, int K,
                                           const float* A, int ai, int ak,
                                           const float* B, int bk, int bj,
                                           Epi epi) {
  const int mt = M >> 2;
  const int tiles = mt * (N >> 2);
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const int i0 = (t % mt) << 2;
    const int j0 = (t / mt) << 2;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = A[(i0 + r) * ai + k * ak];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = B[k * bk + (j0 + c) * bj];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) epi(i0 + r, j0 + c, acc[r][c]);
  }
}

// store(i, load(i)) for i < count, by the whole block; each thread issues
// kBatch loads before its first store
template <typename Load, typename Store>
__device__ __forceinline__ void block_copy(int count, Load load,
                                           Store store) {
  for (int base = threadIdx.x; base < count; base += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads;
      v[u] = i < count ? load(i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads;
      if (i < count) store(i, v[u]);
    }
  }
}

// weights and biases into shared memory as f32, zero-padded; dW/db zeroed
// (bwd)
template <typename TW>
__device__ void stage_weights(const Mlp& m, const Layout& L, float* sm,
                              bool bwd) {
  for (int l = 0; l < m.n; ++l) {
    const int din = m.dim[l], dout = m.dim[l + 1];
    const int pin = pad4(din), sw = pad4(dout) + 1;
    for (int i = threadIdx.x; i < pin * sw; i += kThreads) {
      const int k = i / sw, j = i % sw;
      sm[L.w[l] + i] =
          (k < din && j < dout) ? ld<TW>(m.w[l], k * dout + j) : 0.f;
      if (bwd) sm[L.dw[l] + i] = 0.f;
    }
    for (int j = threadIdx.x; j < sw - 1; j += kThreads) {
      sm[L.b[l] + j] = j < dout ? ld<TW>(m.b[l], j) : 0.f;
      if (bwd) sm[L.db[l] + j] = 0.f;
    }
  }
}

// the chunk's input rows feats[col[s]] into h (te rows of stride sh) as
// f32, zero-padded
template <typename TF>
__device__ void gather_inputs(const Mlp& m, const int* __restrict__ col,
                              const TF* __restrict__ feats, int c0, int c1,
                              float* h, int sh, int te) {
  const int d0 = m.dim[0], p0 = pad4(d0);
  block_copy(
      te * p0,
      [&](int i) {
        const int e = i / p0, k = i % p0;
        const int s = c0 + e;
        return (s < c1 && k < d0) ? to_f32(feats[(long long)col[s] * d0 + k])
                                  : 0.f;
      },
      [&](int i, float v) { h[(i / p0) * sh + i % p0] = v; });
}

template <typename TF, typename TW>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_fwd_kernel(Mlp m, const int* __restrict__ row_ptr,
                         const int* __restrict__ col,
                         const float* __restrict__ ew,
                         const TF* __restrict__ feats,
                         TF* __restrict__ out, int n_rows, int rows) {
  extern __shared__ float sm[];
  const Layout L = make_layout(m, rows, false);
  stage_weights<TW>(m, L, sm, false);
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, n_rows);
  const int dn = m.dim[m.n], pn = pad4(dn);
  float* acc = sm + L.acc;
  for (int i = threadIdx.x; i < rows * pn; i += kThreads) acc[i] = 0.f;
  const int e_begin = row_ptr[r0], e_end = row_ptr[r1];
  const int sd = L.sd;
  __syncthreads();
  for (int c0 = e_begin; c0 < e_end; c0 += kTE) {
    const int c1 = min(c0 + kTE, e_end);
    gather_inputs(m, col, feats, c0, c1, sm + L.h[0], sd, kTE);
    __syncthreads();
    int cur = 0;
    for (int l = 0; l < m.n; ++l) {
      const float* hin = sm + L.h[cur];
      float* hout = sm + L.h[cur ^ 1];
      const int pin = pad4(m.dim[l]), pout = pad4(m.dim[l + 1]);
      const float* bias = sm + L.b[l];
      const int act = m.act[l];
      block_gemm(kTE, pout, pin, hin, sd, 1, sm + L.w[l], pout + 1, 1,
                 [&](int e, int j, float v) {
                   hout[e * sd + j] = act_fwd(act, v + bias[j]);
                 });
      __syncthreads();
      cur ^= 1;
    }
    // each (row, unit) pair adds the chunk's slots of its row, in order
    const float* hn = sm + L.h[cur];
    for (int i = threadIdx.x; i < (r1 - r0) * pn; i += kThreads) {
      const int r = i / pn, j = i % pn;
      const int lo = max(row_ptr[r0 + r], c0);
      const int hi = min(row_ptr[r0 + r + 1], c1);
      float a = acc[i];
      for (int s = lo; s < hi; ++s) a = fmaf(ew[s], hn[(s - c0) * sd + j], a);
      acc[i] = a;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < (r1 - r0) * dn; i += kThreads) {
    const int r = i / dn, j = i % dn;
    out[(long long)(r0 + r) * dn + j] = from_f32<TF>(acc[r * pn + j]);
  }
}

template <typename TF, typename TW>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_bwd_kernel(Mlp m, const int* __restrict__ row_ptr,
                         const int* __restrict__ col,
                         const float* __restrict__ ew,
                         const long long* __restrict__ slot_row,
                         const TF* __restrict__ feats,
                         const TF* __restrict__ g_out,
                         TF* __restrict__ dfeats,
                         float* __restrict__ partial, int n_rows, int rows,
                         int n_params) {
  extern __shared__ float sm[];
  const Layout L = make_layout(m, rows, true);
  stage_weights<TW>(m, L, sm, true);
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, n_rows);
  const int e_begin = row_ptr[r0], e_end = row_ptr[r1];
  const int sd = L.sd;
  const int d0 = m.dim[0], dn = m.dim[m.n];
  __syncthreads();
  for (int c0 = e_begin; c0 < e_end; c0 += kTE) {
    const int c1 = min(c0 + kTE, e_end);
    // recompute: h[l+1] = act(z[l]), z[l] = h[l] @ W[l] + b[l]
    gather_inputs(m, col, feats, c0, c1, sm + L.h[0], pad4(d0) + 1, kTE);
    __syncthreads();
    for (int l = 0; l < m.n; ++l) {
      const int pin = pad4(m.dim[l]), pout = pad4(m.dim[l + 1]);
      float* z = sm + L.z[l];
      float* h = sm + L.h[l + 1];
      const float* bias = sm + L.b[l];
      const int act = m.act[l];
      block_gemm(kTE, pout, pin, sm + L.h[l], pin + 1, 1, sm + L.w[l],
                 pout + 1, 1, [&](int e, int j, float v) {
                   const float zz = v + bias[j];
                   z[e * (pout + 1) + j] = zz;
                   h[e * (pout + 1) + j] = act_fwd(act, zz);
                 });
      __syncthreads();
    }
    // the output-gradient row of each slot's receiver, times its weight
    {
      const int pn = pad4(dn);
      float* d = sm + L.d[0];
      for (int i = threadIdx.x; i < kTE * pn; i += kThreads) {
        const int e = i / pn, j = i % pn;
        const int s = c0 + e;
        d[e * sd + j] = (s < c1 && j < dn)
                            ? ew[s] * to_f32(g_out[slot_row[s] * dn + j])
                            : 0.f;
      }
    }
    __syncthreads();
    int cur = 0;
    for (int l = m.n - 1; l >= 0; --l) {
      const int pin = pad4(m.dim[l]), pout = pad4(m.dim[l + 1]);
      float* dz = sm + L.d[cur];
      const float* z = sm + L.z[l];
      const float* h = sm + L.h[l + 1];
      const int act = m.act[l];
      for (int i = threadIdx.x; i < kTE * pout; i += kThreads) {
        const int e = i / pout, j = i % pout;
        const int q = e * (pout + 1) + j;
        dz[e * sd + j] *= act_grad(act, z[q], h[q]);
      }
      __syncthreads();
      // dW[l] += h[l]^T dz, db[l] += sum over slots of dz
      float* dw = sm + L.dw[l];
      block_gemm(pin, pout, kTE, sm + L.h[l], 1, pin + 1, dz, sd, 1,
                 [&](int k, int j, float v) { dw[k * (pout + 1) + j] += v; });
      float* db = sm + L.db[l];
      for (int j = threadIdx.x; j < pout; j += kThreads) {
        float a = db[j];
        for (int e = 0; e < kTE; ++e) a += dz[e * sd + j];
        db[j] = a;
      }
      // dh[l] = dz @ W[l]^T
      float* dh = sm + L.d[cur ^ 1];
      block_gemm(kTE, pin, pout, dz, sd, 1, sm + L.w[l], 1, pout + 1,
                 [&](int e, int k, float v) { dh[e * sd + k] = v; });
      __syncthreads();
      cur ^= 1;
    }
    const float* dh0 = sm + L.d[cur];
    for (int i = threadIdx.x; i < kTE * d0; i += kThreads) {
      const int e = i / d0, k = i % d0;
      const int s = c0 + e;
      if (s < c1)
        dfeats[(long long)col[s] * d0 + k] = from_f32<TF>(dh0[e * sd + k]);
    }
    __syncthreads();
  }
  // this block's dW/db: [dW0 (d0 x d1), db0 (d1), dW1, db1, ...]
  float* p = partial + (long long)blockIdx.x * n_params;
  for (int l = 0; l < m.n; ++l) {
    const int din = m.dim[l], dout = m.dim[l + 1];
    const int sw = pad4(dout) + 1;
    for (int i = threadIdx.x; i < din * dout; i += kThreads)
      p[i] = sm[L.dw[l] + (i / dout) * sw + i % dout];
    p += din * dout;
    for (int j = threadIdx.x; j < dout; j += kThreads) p[j] = sm[L.db[l] + j];
    p += dout;
  }
}

// ---------------------------------------------------------------- streamed
// 4 bytes from device memory into shared memory without passing through
// registers; zero-filled where !valid (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// rows [k0, k0 + kr) of layer l's W into the tile wt (row stride
// pad4(dout) + 1), zero outside W, as one cp.async group. A bf16 W is
// converted on its way in, so its tile is loaded by plain loads and stores
// (its group is empty): it lands before the tile's __syncthreads all the
// same.
template <typename TW, int NT = kThreads>
__device__ void load_w_tile(const Mlp& m, int l, int k0, int kr, float* wt) {
  const int din = m.dim[l], dout = m.dim[l + 1], sw = pad4(dout) + 1;
  for (int i = threadIdx.x; i < kr * sw; i += NT) {
    const int k = k0 + i / sw, j = i % sw;
    const bool in = k < din && j < dout;
    if constexpr (sizeof(TW) == sizeof(float)) {
      const float* w = static_cast<const float*>(m.w[l]);
      cp_async4(wt + i, in ? w + (long long)k * dout + j : w, in);
    } else {
      wt[i] = in ? ld<TW>(m.w[l], (long long)k * dout + j) : 0.f;
    }
  }
  cp_async_commit();
}

// body(k0, kr, tile) for rows [k0, k0 + kr) of layer l's W, kr = min(kt,
// total - k0), k0 = 0, kt, ... below total, in order. When body runs its
// tile is in shared memory and the next tile's copy is in flight into the
// other buffer. Starts and ends synchronised.
template <typename TW, int NT = kThreads, typename Body>
__device__ void for_w_tiles(const Mlp& m, int l, int total,
                            const StreamLayout& L, float* sm, Body body) {
  const int kt = L.kt;
  // the buffers as two scalars, chosen by a select (no indexed local)
  float* const w0 = sm + L.wt[0];
  float* const w1 = sm + L.wt[1];
  __syncthreads();  // no reader of either buffer is left
  load_w_tile<TW, NT>(m, l, 0, min(kt, total), w0);
  for (int k0 = 0, t = 0; k0 < total; k0 += kt, ++t) {
    const int next = k0 + kt;
    if (next < total) {
      load_w_tile<TW, NT>(m, l, next, min(kt, total - next),
                          (t & 1) ? w0 : w1);
      cp_async_wait<1>();  // this tile's copies are done, the next's not
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of this tile have landed
    body(k0, min(kt, total - k0), (t & 1) ? w1 : w0);
    __syncthreads();  // the buffer is free for the tile after next
  }
}

// out[e, j] = act(sum_{k < din} hin[e, k] W[k, j] + b[j]) for the te chunk
// rows and j < pad4(dout), W streamed through the shared tiles and b staged
// beside them; with `z`, the pre-activation is kept there too (row stride
// so). Padded columns (j >= dout) see zero weights and bias. Ends
// synchronised.
template <typename TW>
__device__ void stream_dense(const Mlp& m, int l, const StreamLayout& L,
                             float* sm, const float* hin, int sin,
                             float* out, int so, float* z) {
  const int din = m.dim[l], dout = m.dim[l + 1];
  const int pout = pad4(dout), sw = pout + 1;
  float* bias = sm + L.bias;
  // the last reader of the bias (the previous layer) ended synchronised
  block_copy(
      pout, [&](int j) { return j < dout ? ld<TW>(m.b[l], j) : 0.f; },
      [&](int j, float v) { bias[j] = v; });
  for_w_tiles<TW>(m, l, din, L, sm, [&](int k0, int kn, const float* wt) {
    const bool first = k0 == 0;
    // one owner per (e, j): the same tiling on every k-tile
    block_gemm(L.te, pout, kn, hin + k0, sin, 1, wt, sw, 1,
               [&](int e, int j, float v) {
                 float* q = out + e * so + j;
                 *q = first ? v : *q + v;
               });
  });
  const int act = m.act[l];
  for (int i = threadIdx.x; i < L.te * pout; i += kThreads) {
    const int e = i / pout, j = i % pout;
    const float zz = out[e * so + j] + bias[j];
    if (z != nullptr) z[e * so + j] = zz;
    out[e * so + j] = act_fwd(act, zz);
  }
  __syncthreads();
}

template <typename TF, typename TW>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_fwd_stream_kernel(Mlp m, const int* __restrict__ row_ptr,
                                const int* __restrict__ col,
                                const float* __restrict__ ew,
                                const TF* __restrict__ feats,
                                TF* __restrict__ out, int n_rows, int rows,
                                int te, int kt) {
  extern __shared__ float sm[];
  const StreamLayout L = make_stream_layout(m, te, kt, rows, false);
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, n_rows);
  const int dn = m.dim[m.n], pn = pad4(dn);
  float* acc = sm + L.acc;
  for (int i = threadIdx.x; i < rows * pn; i += kThreads) acc[i] = 0.f;
  const int e_begin = row_ptr[r0], e_end = row_ptr[r1];
  const int sd = L.sd;
  for (int c0 = e_begin; c0 < e_end; c0 += te) {
    const int c1 = min(c0 + te, e_end);
    gather_inputs(m, col, feats, c0, c1, sm + L.h[0], sd, te);
    int cur = 0;
    for (int l = 0; l < m.n; ++l) {
      stream_dense<TW>(m, l, L, sm, sm + L.h[cur], sd, sm + L.h[cur ^ 1], sd,
                       nullptr);
      cur ^= 1;
    }
    const float* hn = sm + L.h[cur];
    for (int i = threadIdx.x; i < (r1 - r0) * pn; i += kThreads) {
      const int r = i / pn, j = i % pn;
      const int lo = max(row_ptr[r0 + r], c0);
      const int hi = min(row_ptr[r0 + r + 1], c1);
      float a = acc[i];
      for (int s = lo; s < hi; ++s) a = fmaf(ew[s], hn[(s - c0) * sd + j], a);
      acc[i] = a;
    }
    __syncthreads();
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (r1 - r0) * dn; i += kThreads) {
    const int r = i / dn, j = i % dn;
    out[(long long)(r0 + r) * dn + j] = from_f32<TF>(acc[r * pn + j]);
  }
}

// ------------------------------------------------- streamed backward (H100)
// A block of kBwdThreads threads. Every product of a chunk is a register
// tile with inner loops of compile-time trip count (4-wide along the sum),
// each output owned by one thread, the same one on every chunk:
// - recompute z = h W + b per W k-tile: a warp task is tr chunk rows x 128
//   columns, each lane 4 columns 32 apart (conflict-free scalar reads of
//   the odd-stride W tile), h rows read as broadcast float4;
// - dW += h^T dz: a thread tile is 4 k-rows x 4 consecutive columns, te
//   slots summed in ascending order in 16 registers, then one 16-byte
//   read-modify-write per tile row of the block's partial row (consecutive
//   threads on consecutive column groups: coalesced), 4-byte accesses
//   where the row is not 16-byte aligned;
// - dh = dz W^T per W k-tile: a warp task is tr chunk rows x 64 W rows,
//   each lane 2 rows 32 apart (odd stride: conflict-free), dz rows read as
//   broadcast float4.
// Layer offsets are carried from layer to layer (no runtime-indexed local
// array), and the MLP stays in parameter space (__grid_constant__).

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// component u (0..3, known at compile time) of v
__device__ __forceinline__ float part(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// dst[e * sdst + k] = load(e, k) for e < te, k < p: one warp a row (lanes
// along the row, coalesced), kBatch loads in flight per lane. No divide
// per element: 3-4% faster than block_copy on the H100 at both timed
// shapes (scripts/fused_mlp_variants.py)
template <int NT, typename Load>
__device__ __forceinline__ void chunk_rows(int te, int p, float* dst,
                                           int sdst, Load load) {
  const int lane = threadIdx.x & 31;
  for (int e = threadIdx.x >> 5; e < te; e += NT / 32) {
    for (int k0 = lane; k0 < p; k0 += 32 * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + 32 * u;
        v[u] = k < p ? load(e, k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + 32 * u;
        if (k < p) dst[e * sdst + k] = v[u];
      }
    }
  }
}

// chunk rows per warp task: the largest of 4, 2, 1 that still gives every
// warp a task (te / tr * groups >= warps), else 1
template <int NT>
__device__ __forceinline__ int task_rows(int te, int groups) {
  int tr = 4;
  while (tr > 1 && (te / tr) * groups < NT / 32) tr >>= 1;
  return tr;
}

// one recompute task on W tile rows [0, kr) (kr a multiple of 4): rows
// e0..e0+TR-1 of hin (already offset to the tile's first k) times the tile,
// columns j0 + lane + 32c (c < 4) below pout. The first k-tile stores, later
// ones add; the last adds the bias, keeps the pre-activation in z and the
// activation in out (both of row stride so).
template <int TR>
__device__ __forceinline__ void recompute_task(
    const float* hin, int sin, const float* wt, int sw, int kr, int e0,
    int j0, int pout, float* out, float* z, int so, const float* bias,
    int act, bool first, bool last) {
  const int lane = threadIdx.x & 31;
  bool in[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) in[c] = j0 + lane + 32 * c < pout;
  float acc[TR][4];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  const float* w = wt + j0 + lane;
  for (int k = 0; k < kr; k += 4) {
    float4 a[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) a[r] = ld4(hin + (e0 + r) * sin + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float b[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        b[c] = in[c] ? w[(k + u) * sw + 32 * c] : 0.f;
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = fmaf(part(a[r], u), b[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!in[c]) continue;
      const int j = j0 + lane + 32 * c, q = (e0 + r) * so + j;
      const float v = first ? acc[r][c] : out[q] + acc[r][c];
      if (last) {
        const float zz = v + bias[j];
        z[q] = zz;
        out[q] = act_fwd(act, zz);
      } else {
        out[q] = v;
      }
    }
}

// one dh task on a W tile of kr rows: dh[e, k] = sum_{j < pout} dz[e, j]
// W[k, j] for rows e0..e0+TR-1 and k = lane + 32c (c < 2) below kr, j in
// ascending order; dh already offset to the tile's first k
template <int TR>
__device__ __forceinline__ void dh_task(const float* dz, int sd,
                                        const float* wt, int sw, int kr,
                                        int pout, int e0, float* dh) {
  const int lane = threadIdx.x & 31;
  const bool in0 = lane < kr, in1 = lane + 32 < kr;
  const float* w0 = wt + lane * sw;
  const float* w1 = wt + (lane + 32) * sw;
  float acc[TR][2];
#pragma unroll
  for (int r = 0; r < TR; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int j = 0; j < pout; j += 4) {
    float4 a[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) a[r] = ld4(dz + (e0 + r) * sd + j);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float b0 = in0 ? w0[j + u] : 0.f;
      const float b1 = in1 ? w1[j + u] : 0.f;
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        acc[r][0] = fmaf(part(a[r], u), b0, acc[r][0]);
        acc[r][1] = fmaf(part(a[r], u), b1, acc[r][1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    if (in0) dh[(e0 + r) * sd + lane] = acc[r][0];
    if (in1) dh[(e0 + r) * sd + lane + 32] = acc[r][1];
  }
}

// dW[k, j] (k < din, j < dout) of one layer from the chunk: h (te rows of
// stride pin) and dz (stride sd), into the block's partial row pw (row
// stride dout): stored on the first chunk, added to after. Tiles of 4 k x
// 4 j, column groups fastest over the threads.
template <int NT>
__device__ __forceinline__ void dw_tiles(const float* h, int pin,
                                         const float* dz, int sd, int te,
                                         int din, int dout, float* pw,
                                         bool vec, bool first) {
  const int ncg = pad4(dout) >> 2, nkg = pin >> 2;
  const int step_k = NT / ncg, step_j = NT % ncg;  // once per layer
  int kg = threadIdx.x / ncg, jg = threadIdx.x % ncg;
  while (kg < nkg) {
    const int k0 = kg << 2, j0 = jg << 2;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int e = 0; e < te; e += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 a = ld4(h + (e + u) * pin + k0);
        const float4 b = ld4(dz + (e + u) * sd + j0);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = fmaf(part(a, r), part(b, c), acc[r][c]);
      }
    }
    if (vec) {  // dout and the row's offset are multiples of 4
      float4 old[4] = {};
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (!first && k0 + r < din)
          old[r] = *reinterpret_cast<const float4*>(
              pw + (long long)(k0 + r) * dout + j0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (k0 + r >= din) continue;
        float4 v = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        if (!first) {
          v.x = old[r].x + v.x;
          v.y = old[r].y + v.y;
          v.z = old[r].z + v.z;
          v.w = old[r].w + v.w;
        }
        *reinterpret_cast<float4*>(pw + (long long)(k0 + r) * dout + j0) = v;
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (k0 + r >= din || j0 + c >= dout) continue;
          float* q = pw + (long long)(k0 + r) * dout + j0 + c;
          *q = first ? acc[r][c] : *q + acc[r][c];
        }
    }
    kg += step_k;
    jg += step_j;
    if (jg >= ncg) {
      jg -= ncg;
      ++kg;
    }
  }
}

template <typename TF, typename TW>
__global__ void __launch_bounds__(kBwdThreads)
    fused_mlp_bwd_stream_kernel(const __grid_constant__ Mlp m,
                                const int* __restrict__ row_ptr,
                                const int* __restrict__ col,
                                const float* __restrict__ ew,
                                const long long* __restrict__ slot_row,
                                const TF* __restrict__ feats,
                                const TF* __restrict__ g_out,
                                TF* __restrict__ dfeats,
                                float* __restrict__ partial, int n_rows,
                                int rows, int n_params, int te, int kt) {
  constexpr int NT = kBwdThreads;
  extern __shared__ float sm[];
  const StreamLayout L = make_stream_layout(m, te, kt, 0, true);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, n_rows);
  const int e_begin = row_ptr[r0], e_end = row_ptr[r1];
  const int sd = L.sd, n = m.n;
  const int d0 = m.dim[0], dn = m.dim[n];
  float* bias = sm + L.bias;
  // this block's dW/db, [dW0 (d0 x d1), db0 (d1), dW1, db1, ...]: its first
  // chunk stores them, later chunks add; a block without edges stores 0
  float* p = partial + (long long)blockIdx.x * n_params;
  if (e_begin == e_end) {
    for (int i = threadIdx.x; i < n_params; i += NT) p[i] = 0.f;
    return;
  }
  for (int c0 = e_begin; c0 < e_end; c0 += te) {
    const int c1 = min(c0 + te, e_end);
    const bool first = c0 == e_begin;
    // recompute: h[l+1] = act(z[l]), z[l] = h[l] @ W[l] + b[l]; h and z
    // walk the layers' buffers (each te rows of stride pad4(width))
    float* h = sm + L.h[0];
    float* z = sm + L.z[0];
    chunk_rows<NT>(te, pad4(d0), h, pad4(d0), [&](int e, int k) {
      const int s = c0 + e;
      return (s < c1 && k < d0) ? to_f32(feats[(long long)col[s] * d0 + k])
                                : 0.f;
    });
    for (int l = 0; l < n; ++l) {
      const int dout = m.dim[l + 1], act = m.act[l];
      const int pin = pad4(m.dim[l]), pout = pad4(dout);
      float* hout = h + te * pin;
      // the last reader of the bias (the previous layer) ended synchronised
      for (int j = threadIdx.x; j < pout; j += NT)
        bias[j] = j < dout ? ld<TW>(m.b[l], j) : 0.f;
      const int groups = (pout + 127) >> 7;
      const int tr = task_rows<NT>(te, groups);
      const int nrg = te / tr;
      // W rows pin > din are zero (load_w_tile), so every tile has a
      // multiple of 4 rows and the padded h columns add nothing
      for_w_tiles<TW, NT>(m, l, pin, L, sm,
                          [&](int k0, int kr, const float* wt) {
        const bool lo = k0 == 0, hi = k0 + kr == pin;
        for (int t = warp; t < nrg * groups; t += NT / 32) {
          const int e0 = (t % nrg) * tr, j0 = (t / nrg) << 7;
          if (tr == 4)
            recompute_task<4>(h + k0, pin, wt, pout + 1, kr, e0, j0, pout,
                              hout, z, pout, bias, act, lo, hi);
          else if (tr == 2)
            recompute_task<2>(h + k0, pin, wt, pout + 1, kr, e0, j0, pout,
                              hout, z, pout, bias, act, lo, hi);
          else
            recompute_task<1>(h + k0, pin, wt, pout + 1, kr, e0, j0, pout,
                              hout, z, pout, bias, act, lo, hi);
        }
      });
      h = hout;
      z += te * pout;
    }
    // the output-gradient row of each slot's receiver, times its weight
    float* dz = sm + L.d[0];
    float* dh = sm + L.d[1];
    chunk_rows<NT>(te, pad4(dn), dz, sd, [&](int e, int j) {
      const int s = c0 + e;
      return (s < c1 && j < dn) ? ew[s] * to_f32(g_out[slot_row[s] * dn + j])
                                : 0.f;
    });
    __syncthreads();
    int poff = n_params;  // layer l's offset in the partial row
    for (int l = n - 1; l >= 0; --l) {
      const int din = m.dim[l], dout = m.dim[l + 1], act = m.act[l];
      const int pin = pad4(din), pout = pad4(dout);
      const float* hz = h;  // h[l+1]
      z -= te * pout;       // z[l]
      h -= te * pin;        // h[l]
      poff -= din * dout + dout;
      for (int e = warp; e < te; e += NT / 32)
        for (int j = lane; j < pout; j += 32) {
          const int q = e * pout + j;
          dz[e * sd + j] *= act_grad(act, z[q], hz[q]);
        }
      __syncthreads();
      // dW[l] += h[l]^T dz and db[l] += the column sums of dz, into this
      // block's partial row
      float* pw = p + poff;
      dw_tiles<NT>(h, pin, dz, sd, te, din, dout, pw,
                   ((poff | dout | n_params) & 3) == 0, first);
      float* pb = pw + din * dout;
      for (int j = threadIdx.x; j < dout; j += NT) {
        float a = 0.f;
        for (int e = 0; e < te; ++e) a += dz[e * sd + j];
        pb[j] = first ? a : pb[j] + a;
      }
      // dh[l] = dz @ W[l]^T, by row tiles of W (column tiles of dh)
      const int tr = te >= 32 ? 4 : te >= 16 ? 2 : 1;
      for_w_tiles<TW, NT>(m, l, pin, L, sm,
                          [&](int k0, int kr, const float* wt) {
        for (int t = warp; t < te / tr; t += NT / 32) {
          if (tr == 4)
            dh_task<4>(dz, sd, wt, pout + 1, kr, pout, t * 4, dh + k0);
          else if (tr == 2)
            dh_task<2>(dz, sd, wt, pout + 1, kr, pout, t * 2, dh + k0);
          else
            dh_task<1>(dz, sd, wt, pout + 1, kr, pout, t, dh + k0);
        }
      });
      float* t = dz;
      dz = dh;
      dh = t;
    }
    for (int e = warp; e < te; e += NT / 32) {
      const int s = c0 + e;
      if (s >= c1) continue;
      TF* out = dfeats + (long long)col[s] * d0;
      for (int k = lane; k < d0; k += 32)
        out[k] = from_f32<TF>(dz[e * sd + k]);
    }
    __syncthreads();
  }
}

// out[i] = sum over blocks b, in order, of partial[b, i], rounded to TW
// once; kBatch loads in flight at a time, added in block order
template <typename TW>
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    TW* __restrict__ out, int n_blocks,
                                    int n_params) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_params) return;
  float a = 0.f;
  int b = 0;
  for (; b + kBatch <= n_blocks; b += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      v[u] = partial[(long long)(b + u) * n_params + i];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) a += v[u];
  }
  for (; b < n_blocks; ++b) a += partial[(long long)b * n_params + i];
  out[i] = from_f32<TW>(a);
}

// host: the MLP's widths; 0 or kOutsideEnvelope. K3's envelope: 1 to
// kMaxLayers layers of widths 1 to kMaxWidth (the cap keeps the layouts'
// int arithmetic from overflowing) that have a streamed plan, forward and
// backward (every such MLP has one). A forward never runs whose backward
// could not.
int make_mlp_dims(int n, const int* dims, Mlp* m) {
  if (n < 1 || n > kMaxLayers) return kOutsideEnvelope;
  *m = Mlp{};
  m->n = n;
  for (int l = 0; l <= n; ++l) {
    if (dims[l] < 1 || dims[l] > kMaxWidth) return kOutsideEnvelope;
    m->dim[l] = dims[l];
  }
  StreamPlan p;
  if (!plan_stream(*m, 1, 4, false, &p) || !plan_stream(*m, 1, 4, true, &p))
    return kOutsideEnvelope;
  return 0;
}

// host: the MLP from the wrapper's arrays; 0, cudaErrorInvalidValue for an
// unknown activation code, or kOutsideEnvelope
int make_mlp(int n, const int* dims, const int* acts, const void* const* w,
             const void* const* b, Mlp* m) {
  const int bad = make_mlp_dims(n, dims, m);
  if (bad != 0) return bad;
  for (int l = 0; l < n; ++l) {
    if (acts[l] < kIdentity || acts[l] > kSwish)
      return static_cast<int>(cudaErrorInvalidValue);
    m->act[l] = acts[l];
    m->w[l] = w[l];
    m->b[l] = b[l];
  }
  return 0;
}

// f(TF(), TW()) for the dtypes the flags pick (bf16 if set, else f32)
template <typename F>
int with_dtypes(int feats_bf16, int w_bf16, F f) {
  if (feats_bf16) return w_bf16 ? f(bf16(), bf16()) : f(bf16(), 0.f);
  return w_bf16 ? f(0.f, bf16()) : f(0.f, 0.f);
}

}  // namespace

extern "C" {

// which variant the launchers take for these widths (bwd: the backward's):
// kResident (0), kStreamed (1), or kOutsideEnvelope (-1)
int ngpde_fused_mlp_variant(int n, const int* dims, int bwd) {
  Mlp m;
  if (make_mlp_dims(n, dims, &m) != 0) return kOutsideEnvelope;
  return resident_fits(m, bwd != 0) ? kResident : kStreamed;
}

// out (n_rows, dims[n]) in feats' dtype. dims: n + 1 widths; acts: n
// activation codes; w, b: n device pointers each; feats_bf16 / w_bf16: the
// dtypes of feats (and out) and of every w and b (bf16 if set, else f32);
// rows: receiver rows per block (the streamed variant may take fewer);
// slots: the edge slots a block holds on average (the streamed variant's
// chunk is at most the power of two above it). Returns a cudaError_t, or
// kOutsideEnvelope (-1).
int ngpde_fused_mlp_fwd(const int* row_ptr, const int* col, const float* ew,
                        const void* feats, void* out, int n_rows, int rows,
                        int slots, int n, const int* dims, const int* acts,
                        const void* const* w, const void* const* b,
                        int feats_bf16, int w_bf16, void* stream_ptr) {
  Mlp m;
  const int bad = make_mlp(n, dims, acts, w, b, &m);
  if (bad != 0) return bad;
  if (rows < 1 || rows > kMaxFwdRows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return with_dtypes(feats_bf16, w_bf16, [&](auto tf, auto tw) {
    using TF = decltype(tf);
    using TW = decltype(tw);
    const TF* x = static_cast<const TF*>(feats);
    TF* y = static_cast<TF*>(out);
    cudaError_t err;
    if (resident_fits(m, false)) {
      const int smem = make_layout(m, rows, false).total * (int)sizeof(float);
      err = cudaFuncSetAttribute(fused_mlp_fwd_kernel<TF, TW>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      const int blocks = (n_rows + rows - 1) / rows;
      fused_mlp_fwd_kernel<TF, TW><<<blocks, kThreads, smem, stream>>>(
          m, row_ptr, col, ew, x, y, n_rows, rows);
      return static_cast<int>(cudaGetLastError());
    }
    StreamPlan p;
    if (!plan_stream(m, rows, slots, false, &p)) return kOutsideEnvelope;
    err = cudaFuncSetAttribute(fused_mlp_fwd_stream_kernel<TF, TW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (n_rows + p.rows - 1) / p.rows;
    fused_mlp_fwd_stream_kernel<TF, TW><<<blocks, kThreads, p.smem, stream>>>(
        m, row_ptr, col, ew, x, y, n_rows, p.rows, p.te, p.kt);
    return static_cast<int>(cudaGetLastError());
  });
}

// dfeats (E, dims[0]) in feats' dtype (g_out's too); grads: the n_params
// = sum_l dims[l]*dims[l+1] + dims[l+1] weight and bias gradients in the
// weights' dtype, concatenated per layer; partial: scratch of
// ceil(n_rows / rows) * n_params floats; dtypes and slots as for the
// forward.
int ngpde_fused_mlp_bwd(const int* row_ptr, const int* col, const float* ew,
                        const long long* slot_row, const void* feats,
                        const void* g_out, void* dfeats, void* grads,
                        float* partial, int n_rows, int rows, int slots, int n,
                        const int* dims, const int* acts,
                        const void* const* w, const void* const* b,
                        int feats_bf16, int w_bf16, void* stream_ptr) {
  Mlp m;
  const int bad = make_mlp(n, dims, acts, w, b, &m);
  if (bad != 0) return bad;
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  int n_params = 0;
  for (int l = 0; l < n; ++l) n_params += dims[l] * dims[l + 1] + dims[l + 1];
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = n_rows == 0 ? 0 : (n_rows + rows - 1) / rows;
  return with_dtypes(feats_bf16, w_bf16, [&](auto tf, auto tw) {
    using TF = decltype(tf);
    using TW = decltype(tw);
    const TF* x = static_cast<const TF*>(feats);
    const TF* g = static_cast<const TF*>(g_out);
    TF* dx = static_cast<TF*>(dfeats);
    if (blocks > 0) {
      cudaError_t err;
      if (resident_fits(m, true)) {
        const int smem =
            make_layout(m, rows, true).total * (int)sizeof(float);
        err = cudaFuncSetAttribute(fused_mlp_bwd_kernel<TF, TW>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        fused_mlp_bwd_kernel<TF, TW><<<blocks, kThreads, smem, stream>>>(
            m, row_ptr, col, ew, slot_row, x, g, dx, partial, n_rows, rows,
            n_params);
      } else {
        StreamPlan p;
        if (!plan_stream(m, rows, slots, true, &p)) return kOutsideEnvelope;
        err = cudaFuncSetAttribute(fused_mlp_bwd_stream_kernel<TF, TW>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   p.smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        fused_mlp_bwd_stream_kernel<TF, TW>
            <<<blocks, kBwdThreads, p.smem, stream>>>(
                m, row_ptr, col, ew, slot_row, x, g, dx, partial, n_rows,
                rows, n_params, p.te, p.kt);
      }
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    sum_partials_kernel<TW><<<(n_params + 255) / 256, 256, 0, stream>>>(
        partial, static_cast<TW*>(grads), blocks, n_params);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
