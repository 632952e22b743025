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
// - no atomics, and the same result on every run: every output has one
//   owning thread, and every sum runs in one fixed order (k ascending within
//   a W tile, tiles in order, then the bias; slots ascending within a chunk,
//   chunks in order, the blocks' partials as ngpde::sum_partials adds them;
//   j ascending in dh).
// - a block owns a run of consecutive receiver rows and walks their edge
//   slots in chunks; widths are padded to a multiple of 4 with zeros. Each
//   row's sum is kept in shared memory by one owning thread, added in slot
//   order and stored once per row.
// - backward: the TPU kernel adds dW/db into output blocks that every
//   (sequential) grid step revisits; GPU blocks run in no order. Here each
//   block recomputes its chunk's activations, keeps them (and the
//   pre-activations) in shared memory, and reverses through the layers with
//   the exact derivative of each activation. dW/db accumulate per block,
//   each entry owned by one thread; the block's partial row goes to scratch
//   and a second kernel sums the rows in block order. dfeats[col[s]] is
//   written directly: every edge id appears once in `col`, so there is no
//   scatter.
//
// Four kernels, chosen by the launcher from the widths alone, every product
// a register-tiled warp task with compile-time inner trip counts (see the
// chunked kernels' section below):
// - the streamed forward and backward (kChunkThreads threads), for wider
//   MLPs (MP-PDE's 282 -> 128, 4 -> 300 -> 300, ...). Each layer's W
//   passes through shared tiles of `kt` rows, two buffers filled by
//   cp.async, so the next tile's copy runs under the current tile's
//   product; the chunk's activations (`te` edge slots, 4 <= te <= 32) and
//   the layer's bias stay in shared memory. The backward stores its first
//   chunk's dW/db straight into the block's partial row in device memory
//   and adds the later chunks' onto it. Every MLP of 1 to 4 layers with
//   widths up to 1024 has a streamed plan (4 layers of 1024 take te = 4).
//   W is read once per chunk whatever a block's size, so the wrapper
//   spreads a small graph's rows over about one block per SM and the
//   launcher sizes the chunk to the average slots per block.
// - the resident forward and backward: the streamed kernels' bodies with
//   every W and b staged once per block (stage_weights: a warp a W row,
//   16-byte cp.async where the row stride allows it, no divide an element)
//   and chunks of 32 slots; the backward also sums dW/db in shared memory.
//   Taken where the block fits (VMH's widths; the forward also at 4 -> 128
//   -> 128 -> 128): the forward (kResFwdThreads threads) over about
//   _FWD_SLOTS slots a block (kernels/fused_mlp_kernels.py), the backward
//   (kResThreads threads) over at most one block per SM.
// - copies from device memory into shared memory keep kBatch loads in
//   flight per thread (block_copy, chunk_rows): a plain loop waits out each
//   load's latency, since the compiler cannot move a load above a store
//   that may alias it.
#include <type_traits>

#include "common.cuh"

namespace {

using ngpde::cp_async16;
using ngpde::cp_async4;
using ngpde::cp_async_commit;
using ngpde::cp_async_wait;
using ngpde::from_f32;
using ngpde::ld4;
using ngpde::part;
using ngpde::to_f32;
using bf16 = __nv_bfloat16;

constexpr int kMaxLayers = 4;
constexpr int kMaxWidth = 1024;
// the streamed kernels' block: 8 warps, so that each SM scheduler has two to
// switch between (scripts/fused_mlp_variants.py times 128 and 256)
constexpr int kChunkThreads = 256;
// the resident backward's block: 16 warps (its 32-slot chunk gives each a
// task; 5% faster than 8 at VMH's widths on the H100)
constexpr int kResThreads = 512;
// the resident forward's block, and the blocks an SM its registers are held
// to: 4, whose 64 registers do not spill, as VMH's 48 KB of shared memory
// lets 4 blocks share an SM (0.0457 device ms at the VMH mesh against
// 0.0572 at 1 and 0.0450 at 3, 0.306 against 0.388 and 0.328 at 2^15
// points on the H100; scripts/fused_mlp_variants.py)
constexpr int kResFwdThreads = 256, kResFwdBlocks = 4;
// columns a lane in the forward's recompute tasks, streamed and resident
// (1, 2 or 4): at the streamed forward's small chunks a task of fewer
// columns takes more rows, and each W value read from shared memory feeds
// that many FMAs
constexpr int kFwdCols = 2;
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

// floats of one layer in a resident block, as stage_weights lays them:
// forward W (pin rows of stride pout) and b; backward W (pin rows of stride
// pout + 1), b, dW (pin rows of stride pout) and db
__host__ __device__ __forceinline__ int resident_floats(int pin, int pout,
                                                        bool bwd) {
  return bwd ? pin * (pout + 1) + pout + pin * pout + pout
             : pin * pout + pout;
}

// float offsets into the dynamic shared memory of a chunked block. Streamed:
// two W tiles and the bias; resident: every layer's W and b (backward: and
// dW and db) as stage_weights lays them. Then the chunk buffers of te slots
// (bwd: h[0..n], z[0..n-1], d[0..1]; fwd: h[0..1] and the block's `rows`
// output sums). Every chunk row's stride is a multiple of 4 floats (h[l]
// and z[l] pad4 of their width, the other buffers the widest), so the
// float4 loads are aligned: their lanes read along a row, or all read one
// address, so no stride of theirs conflicts.
struct StreamLayout {
  int wt[2], bias, h[kMaxLayers + 1], z[kMaxLayers], d[2], acc;
  int sd;  // row stride of h[0..1] (fwd) and d[0..1]
  int te, kt, total;
};

__host__ __device__ inline StreamLayout make_stream_layout(
    const Mlp& m, int te, int kt, int rows, bool bwd, bool resident = false) {
  StreamLayout L{};
  int off = 0, pmax = 0;
  for (int l = 0; l <= m.n; ++l) pmax = imax(pmax, pad4(m.dim[l]));
  L.sd = pmax;
  L.te = te;
  L.kt = kt;
  if (resident) {
    // unrolled to kMaxLayers, so that L stays in registers on the device
#pragma unroll
    for (int l = 0; l < kMaxLayers; ++l) {
      if (l >= m.n) break;
      off += resident_floats(pad4(m.dim[l]), pad4(m.dim[l + 1]), bwd);
    }
  } else {
    for (int t = 0; t < 2; ++t) {
      L.wt[t] = off;
      off += kt * (pmax + 1);
    }
    L.bias = off;
    off += pmax;
  }
  if (bwd) {
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

// the resident backward's layout
__host__ __device__ inline StreamLayout make_resident_layout(const Mlp& m) {
  return make_stream_layout(m, kTE, 0, 0, true, true);
}

// The rule that picks the resident variant: the floats of the first
// resident blocks' layout, every row of odd stride (pad4 + 1), forward at
// kMaxFwdRows rows. Kept as it was, so that every MLP keeps its variant;
// the resident layouts in use need no more (each stride is at most the one
// counted here).
bool resident_fits(const Mlp& m, bool bwd) {
  int floats = 0, pmax = 0;
  for (int l = 0; l <= m.n; ++l) pmax = imax(pmax, pad4(m.dim[l]));
  for (int l = 0; l < m.n; ++l) {
    const int pin = pad4(m.dim[l]), pout = pad4(m.dim[l + 1]);
    floats += (bwd ? 2 : 1) * (pin * (pout + 1) + pout);
    if (bwd) floats += kTE * (pin + 1) + kTE * (pout + 1);
  }
  floats += 2 * kTE * (pmax + 1);
  floats += bwd ? kTE * (pad4(m.dim[m.n]) + 1)
                : kMaxFwdRows * pad4(m.dim[m.n]);
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

// f(std::integral_constant<int, act>()): a loop over many elements inside
// f takes the activation's switch once
template <typename F>
__device__ __forceinline__ void with_act(int act, F f) {
  switch (act) {
    case kRelu: f(std::integral_constant<int, kRelu>()); break;
    case kTanh: f(std::integral_constant<int, kTanh>()); break;
    case kSigmoid: f(std::integral_constant<int, kSigmoid>()); break;
    case kSoftplus: f(std::integral_constant<int, kSoftplus>()); break;
    case kElu: f(std::integral_constant<int, kElu>()); break;
    case kGelu: f(std::integral_constant<int, kGelu>()); break;
    case kSwish: f(std::integral_constant<int, kSwish>()); break;
    default: f(std::integral_constant<int, kIdentity>()); break;
  }
}

// store(i, load(i)) for i < count, by the whole block; each thread issues
// kBatch loads before its first store
template <int NT, typename Load, typename Store>
__device__ __forceinline__ void block_copy(int count, Load load,
                                           Store store) {
  for (int base = threadIdx.x; base < count; base += NT * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * NT;
      v[u] = i < count ? load(i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * NT;
      if (i < count) store(i, v[u]);
    }
  }
}

// ---------------------------------------------------------------- streamed
// rows [k0, k0 + kr) of layer l's W into the tile wt (row stride
// pad4(dout) + 1), zero outside W, as one cp.async group. A bf16 W is
// converted on its way in, so its tile is loaded by plain loads and stores
// (its group is empty): it lands before the tile's __syncthreads all the
// same.
template <typename TW, int NT>
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

// rows [k0, k0 + kr) of layer l's W into the tile wt of row stride
// pad4(dout), zero outside W, as one cp.async group, a warp a row: each lane
// copies 16 bytes where W's rows are 16-byte aligned (dout a multiple of 4,
// W aligned), else 4 bytes; a bf16 W is converted on its way in by plain
// loads, kBatch in flight a lane (chunk_rows). No divide per element: the
// per-element i / sw of load_w_tile cost the streamed forward about half of
// its cycles on the H100 (a clock64 split)
template <typename TW, int NT>
__device__ void load_w_rows(const Mlp& m, int l, int k0, int kr, float* wt);

// body(k0, kr, tile) for rows [k0, k0 + kr) of layer l's W, kr = min(kt,
// total - k0), k0 = 0, kt, ... below total, in order, each tile copied by
// load_w_tile (row stride pad4(dout) + 1) or, with Rows, by load_w_rows
// (stride pad4(dout)). When body runs its tile is in shared memory and the
// next tile's copy is in flight into the other buffer. Starts and ends
// synchronised.
template <typename TW, int NT, bool Rows = false, typename Body>
__device__ void for_w_tiles(const Mlp& m, int l, int total,
                            const StreamLayout& L, float* sm, Body body) {
  const int kt = L.kt;
  // the buffers as two scalars, chosen by a select (no indexed local)
  float* const w0 = sm + L.wt[0];
  float* const w1 = sm + L.wt[1];
  const auto load = [&](int k0, int kr, float* wt) {
    if constexpr (Rows)
      load_w_rows<TW, NT>(m, l, k0, kr, wt);
    else
      load_w_tile<TW, NT>(m, l, k0, kr, wt);
  };
  __syncthreads();  // no reader of either buffer is left
  load(0, min(kt, total), w0);
  for (int k0 = 0, t = 0; k0 < total; k0 += kt, ++t) {
    const int next = k0 + kt;
    if (next < total) {
      load(next, min(kt, total - next), (t & 1) ? w0 : w1);
      cp_async_wait<1>();  // this tile's copies are done, the next's not
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of this tile have landed
    body(k0, min(kt, total - k0), (t & 1) ? w1 : w0);
    __syncthreads();  // the buffer is free for the tile after next
  }
}

// ------------------------------------------------ chunked kernels (H100)
// The streamed forward, the streamed backward and the resident backward.
// Every product of a chunk is a register tile with inner loops of
// compile-time trip count (4-wide along the sum), each output owned by one
// thread, the same one on every chunk:
// - recompute z = h W + b per W k-tile: a warp task is tr chunk rows x 32 NC
//   columns, each lane NC columns 32 apart (conflict-free scalar reads of
//   the odd-stride W tile), h rows read as broadcast float4. The backward's
//   streamed tasks take NC = 4; the resident ones the fewest of 1, 2, 4
//   that span the layer's width (VMH's 60: 2, no idle half); the forward's
//   kFwdCols, so that at its small chunks each W read feeds tr FMAs;
// - dW += h^T dz: a thread tile is 4 k-rows x 4 consecutive columns, te
//   slots summed in ascending order in 16 registers, then one 16-byte
//   read-modify-write per tile row of the dW rows (streamed: the block's
//   partial row, consecutive threads on consecutive column groups,
//   coalesced; resident: the block's dW in shared memory), 4-byte accesses
//   where a row is not 16-byte aligned;
// - dh = dz W^T per W k-tile (resident: per 64-row slice of W): a warp task
//   is tr chunk rows x 64 W rows, each lane 2 rows 32 apart (odd stride:
//   conflict-free), dz rows read as broadcast float4; a resident layer of
//   fewer than 32 input rows takes one output a thread (dh_narrow).
// Layer offsets are carried from layer to layer (no runtime-indexed local
// array), and the MLP stays in parameter space (__grid_constant__).

// dst[e * sdst + k] = load(e, k) for e < te, k < p: one warp a row (lanes
// along the row, coalesced), kBatch loads in flight per lane. No divide
// per element: 3-4% faster than block_copy in the streamed backward on the
// H100 at both timed shapes (scripts/fused_mlp_variants.py)
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

// chunk_rows, or with Flat, for rows narrower than a warp, over the chunk's
// flat index (block_copy), so that every lane has loads in flight (VMH's
// inputs are 4 floats wide): two divides per element, which cost more than
// they save at 60 floats (a clock64 split on the H100)
template <int NT, bool Flat, typename Load>
__device__ __forceinline__ void gather_rows(int te, int p, float* dst,
                                            int sdst, Load load) {
  if (Flat && p < 32)
    block_copy<NT>(
        te * p, [&](int i) { return load(i / p, i % p); },
        [&](int i, float v) { dst[(i / p) * sdst + i % p] = v; });
  else
    chunk_rows<NT>(te, p, dst, sdst, load);
}

template <typename TW, int NT>
__device__ void load_w_rows(const Mlp& m, int l, int k0, int kr, float* wt) {
  const int din = m.dim[l], dout = m.dim[l + 1], pout = pad4(dout);
  if constexpr (sizeof(TW) == sizeof(float)) {
    const int lane = threadIdx.x & 31;
    const float* w = static_cast<const float*>(m.w[l]);
    const bool vec = (dout & 3) == 0 &&
                     (reinterpret_cast<unsigned long long>(w) & 15) == 0;
    for (int k = threadIdx.x >> 5; k < kr; k += NT / 32) {
      const bool row = k0 + k < din;
      const float* src = w + (long long)(k0 + k) * dout;
      float* dst = wt + k * pout;
      if (vec) {
        for (int j = lane << 2; j < pout; j += 128)
          cp_async16(dst + j, row ? src + j : w, row ? 16 : 0);
      } else {
        for (int j = lane; j < pout; j += 32) {
          const bool in = row && j < dout;
          cp_async4(dst + j, in ? src + j : w, in);
        }
      }
    }
  } else {
    chunk_rows<NT>(kr, pout, wt, pout, [&](int k, int j) {
      return (k0 + k < din && j < dout)
                 ? ld<TW>(m.w[l], (long long)(k0 + k) * dout + j)
                 : 0.f;
    });
  }
  cp_async_commit();
}

// every layer's W (pad4(din) rows of stride sw = pad4(dout) + Odd) and b
// into shared memory from sm on, as f32, zero-padded, a warp a W row with
// lanes along it (no divide an element); with `grads` (the resident
// backward) the layer's dW (stride pad4(dout)) and db follow, zeroed. An
// f32 W comes by cp.async, 16 bytes a lane where the rows allow it (an even
// stride, dout a multiple of 4, W 16-byte aligned), else 4; a bf16 W by
// plain loads, kBatch in flight a lane (chunk_rows). Returns with this
// thread's copies landed; the caller synchronises.
template <typename TW, int NT, bool Odd>
__device__ void stage_weights(const Mlp& m, float* sm, bool grads) {
  const int lane = threadIdx.x & 31;
  for (int l = 0; l < m.n; ++l) {
    const int din = m.dim[l], dout = m.dim[l + 1];
    const int pin = pad4(din), pout = pad4(dout), sw = pout + (Odd ? 1 : 0);
    if constexpr (sizeof(TW) == sizeof(float)) {
      const float* w = static_cast<const float*>(m.w[l]);
      const bool vec = !Odd && (dout & 3) == 0 &&
                       (reinterpret_cast<unsigned long long>(w) & 15) == 0;
      for (int k = threadIdx.x >> 5; k < pin; k += NT / 32) {
        const bool row = k < din;
        const float* src = w + (long long)k * dout;
        float* dst = sm + k * sw;
        if (vec) {
          for (int j = lane << 2; j < sw; j += 128)
            cp_async16(dst + j, row ? src + j : w, row ? 16 : 0);
        } else {
          for (int j = lane; j < sw; j += 32) {
            const bool in = row && j < dout;
            cp_async4(dst + j, in ? src + j : w, in);
          }
        }
      }
    } else {
      chunk_rows<NT>(pin, sw, sm, sw, [&](int k, int j) {
        return (k < din && j < dout)
                   ? ld<TW>(m.w[l], (long long)k * dout + j)
                   : 0.f;
      });
    }
    sm += pin * sw;
    for (int j = threadIdx.x; j < pout; j += NT)
      sm[j] = j < dout ? ld<TW>(m.b[l], j) : 0.f;
    sm += pout;
    if (grads) {
      for (int i = threadIdx.x; i < pin * pout + pout; i += NT) sm[i] = 0.f;
      sm += pin * pout + pout;
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
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
// columns j0 + lane + 32c (c < NC) below pout. The first k-tile stores,
// later ones add; the last adds the bias and keeps the activation in out
// and, with KZ, the pre-activation in z (both of row stride so).
template <int TR, int NC, bool KZ>
__device__ __forceinline__ void recompute_task(
    const float* hin, int sin, const float* wt, int sw, int kr, int e0,
    int j0, int pout, float* out, float* z, int so, const float* bias,
    int act, bool first, bool last) {
  const int lane = threadIdx.x & 31;
  bool in[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) in[c] = j0 + lane + 32 * c < pout;
  float acc[TR][NC];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  const float* w = wt + j0 + lane;
  for (int k = 0; k < kr; k += 4) {
    float4 a[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) a[r] = ld4(hin + (e0 + r) * sin + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float b[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        b[c] = in[c] ? w[(k + u) * sw + 32 * c] : 0.f;
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[r][c] = fmaf(part(a[r], u), b[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (!in[c]) continue;
      const int j = j0 + lane + 32 * c, q = (e0 + r) * so + j;
      const float v = first ? acc[r][c] : out[q] + acc[r][c];
      if (last) {
        const float zz = v + bias[j];
        if (KZ) z[q] = zz;
        out[q] = act_fwd(act, zz);
      } else {
        out[q] = v;
      }
    }
}

// the recompute tasks of one W tile (rows [0, kr) of stride sw) over the te
// chunk rows, as recompute_task describes them: warp w takes tasks w, w +
// warps, ... of tr rows (task_rows) x 32 NC columns, the same ones on every
// tile
template <int NT, int NC, bool KZ>
__device__ __forceinline__ void dense_tasks(
    const float* hin, int sin, const float* wt, int sw, int kr, int te,
    int pout, float* out, float* z, int so, const float* bias, int act,
    bool first, bool last) {
  constexpr int kCols = 32 * NC;
  const int groups = (pout + kCols - 1) / kCols;
  const int tr = task_rows<NT>(te, groups);
  const int nrg = te / tr;
  for (int t = threadIdx.x >> 5; t < nrg * groups; t += NT / 32) {
    const int e0 = (t % nrg) * tr, j0 = (t / nrg) * kCols;
    if (tr == 4)
      recompute_task<4, NC, KZ>(hin, sin, wt, sw, kr, e0, j0, pout, out, z,
                                so, bias, act, first, last);
    else if (tr == 2)
      recompute_task<2, NC, KZ>(hin, sin, wt, sw, kr, e0, j0, pout, out, z,
                                so, bias, act, first, last);
    else
      recompute_task<1, NC, KZ>(hin, sin, wt, sw, kr, e0, j0, pout, out, z,
                                so, bias, act, first, last);
  }
}

// one layer of the recompute with W streamed: hout = act(hin W + b) for the
// te chunk rows (row strides sin and so), b staged beside the W tiles
// (copied as for_w_tiles' Rows says); with KZ the pre-activation is kept in
// z (stride so). W rows pin > din are zero, so every tile has a multiple of
// 4 rows and the padded h columns add nothing; padded columns (j >= dout)
// see zero weights and bias. Ends synchronised.
template <typename TW, int NT, int NC, bool KZ, bool Rows>
__device__ __forceinline__ void stream_layer(const Mlp& m, int l,
                                             const StreamLayout& L,
                                             float* sm, int te,
                                             const float* hin, int sin,
                                             float* hout, int so, float* z) {
  const int dout = m.dim[l + 1], act = m.act[l];
  const int pin = pad4(m.dim[l]), pout = pad4(dout);
  float* bias = sm + L.bias;
  // the last reader of the bias (the previous layer) ended synchronised
  for (int j = threadIdx.x; j < pout; j += NT)
    bias[j] = j < dout ? ld<TW>(m.b[l], j) : 0.f;
  for_w_tiles<TW, NT, Rows>(m, l, pin, L, sm,
                            [&](int k0, int kr, const float* wt) {
    dense_tasks<NT, NC, KZ>(hin + k0, sin, wt, Rows ? pout : pout + 1, kr, te,
                            pout, hout, z, so, bias, act, k0 == 0,
                            k0 + kr == pin);
  });
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

// dh = dz W^T for a layer of fewer than 32 input rows (dh_task would leave
// most lanes idle; VMH's first layer has 4): one output a thread, j
// ascending as in dh_task
template <int NT>
__device__ __forceinline__ void dh_narrow(const float* dz, int sd,
                                          const float* w, int sw, int pin,
                                          int pout, int te, float* dh) {
  for (int i = threadIdx.x; i < te * pin; i += NT) {
    const int e = i / pin, k = i - e * pin;
    const float* b = w + k * sw;
    float acc = 0.f;
    for (int j = 0; j < pout; j += 4) {
      const float4 a = ld4(dz + e * sd + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) acc = fmaf(part(a, u), b[j + u], acc);
    }
    dh[e * sd + k] = acc;
  }
}

// dW[k, j] (k < din, j < dout) of one layer from the chunk: h (te rows of
// stride pin) and dz (stride sd), into the rows pw (row stride sw): stored
// on the first chunk, added to after. Tiles of 4 k x 4 j, column groups
// fastest over the threads. vec: sw and pw's offset are multiples of 4
// floats (16-byte accesses; the columns past dout up to pad4(dout) are
// written too)
template <int NT>
__device__ __forceinline__ void dw_tiles(const float* h, int pin,
                                         const float* dz, int sd, int te,
                                         int din, int dout, float* pw, int sw,
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
    if (vec) {
      float4 old[4] = {};
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (!first && k0 + r < din)
          old[r] = *reinterpret_cast<const float4*>(
              pw + (long long)(k0 + r) * sw + j0);
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
        *reinterpret_cast<float4*>(pw + (long long)(k0 + r) * sw + j0) = v;
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (k0 + r >= din || j0 + c >= dout) continue;
          float* q = pw + (long long)(k0 + r) * sw + j0 + c;
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

// The forward of a block, streamed or resident, in NT threads: each chunk's
// MLP by recompute tasks of kFwdCols columns a lane, then each (row, unit)
// pair adds the chunk's slots of its row, in order, onto the row's sum in
// shared memory. Resident: every W and b staged once (stage_weights), each
// layer's W one k-tile; te = kTE.
template <typename TF, typename TW, bool Resident, int NT>
__device__ __forceinline__ void fwd_block(
    const Mlp& m, const int* __restrict__ row_ptr,
    const int* __restrict__ col, const float* __restrict__ ew,
    const TF* __restrict__ feats, TF* __restrict__ out, int n_rows,
    int rows, int te, int kt) {
  extern __shared__ float sm[];
  const StreamLayout L = make_stream_layout(m, te, kt, rows, false, Resident);
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, n_rows);
  const int n = m.n, d0 = m.dim[0], dn = m.dim[n], pn = pad4(dn);
  const int sd = L.sd;
  float* acc = sm + L.acc;
  for (int i = threadIdx.x; i < rows * pn; i += NT) acc[i] = 0.f;
  const int e_begin = row_ptr[r0], e_end = row_ptr[r1];
  if constexpr (Resident) {
    if (e_begin < e_end) stage_weights<TW, NT, false>(m, sm, false);
  }
  for (int c0 = e_begin; c0 < e_end; c0 += te) {
    const int c1 = min(c0 + te, e_end);
    // h[l+1] = act(h[l] @ W[l] + b[l]) in the two buffers in turn
    float* h = sm + L.h[0];
    float* hout = sm + L.h[1];
    gather_rows<NT, Resident>(te, pad4(d0), h, sd, [&](int e, int k) {
      const int s = c0 + e;
      return (s < c1 && k < d0) ? to_f32(feats[(long long)col[s] * d0 + k])
                                : 0.f;
    });
    const float* wl = sm;  // resident: layer l's W, then its b
    for (int l = 0; l < n; ++l) {
      if constexpr (Resident) {
        const int pin = pad4(m.dim[l]), pout = pad4(m.dim[l + 1]);
        __syncthreads();  // h (and on the first chunk the weights) written
        dense_tasks<NT, kFwdCols, false>(h, sd, wl, pout, pin, te, pout,
                                         hout, nullptr, sd, wl + pin * pout,
                                         m.act[l], true, true);
        wl += resident_floats(pin, pout, false);
      } else {
        stream_layer<TW, NT, kFwdCols, false, true>(m, l, L, sm, te, h, sd,
                                                    hout, sd, nullptr);
      }
      float* t = h;
      h = hout;
      hout = t;
    }
    if constexpr (Resident) __syncthreads();  // the last layer's rows
    // each (row, unit) pair adds the chunk's slots of its row, in order
    for (int i = threadIdx.x; i < (r1 - r0) * pn; i += NT) {
      const int r = i / pn, j = i % pn;
      const int lo = max(row_ptr[r0 + r], c0);
      const int hi = min(row_ptr[r0 + r + 1], c1);
      float a = acc[i];
      for (int s = lo; s < hi; ++s) a = fmaf(ew[s], h[(s - c0) * sd + j], a);
      acc[i] = a;
    }
    __syncthreads();
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (r1 - r0) * dn; i += NT) {
    const int r = i / dn, j = i % dn;
    out[(long long)(r0 + r) * dn + j] = from_f32<TF>(acc[r * pn + j]);
  }
}

// one block an SM (its shared memory): without the 1, ptxas may hold it to
// 64 registers and spill
template <typename TF, typename TW>
__global__ void __launch_bounds__(kChunkThreads, 1)
    fused_mlp_fwd_stream_kernel(const __grid_constant__ Mlp m,
                                const int* __restrict__ row_ptr,
                                const int* __restrict__ col,
                                const float* __restrict__ ew,
                                const TF* __restrict__ feats,
                                TF* __restrict__ out, int n_rows, int rows,
                                int te, int kt) {
  fwd_block<TF, TW, false, kChunkThreads>(m, row_ptr, col, ew, feats, out,
                                          n_rows, rows, te, kt);
}

template <typename TF, typename TW>
__global__ void __launch_bounds__(kResFwdThreads, kResFwdBlocks)
    fused_mlp_fwd_resident_kernel(const __grid_constant__ Mlp m,
                                  const int* __restrict__ row_ptr,
                                  const int* __restrict__ col,
                                  const float* __restrict__ ew,
                                  const TF* __restrict__ feats,
                                  TF* __restrict__ out, int n_rows,
                                  int rows) {
  fwd_block<TF, TW, true, kResFwdThreads>(m, row_ptr, col, ew, feats, out,
                                          n_rows, rows, kTE, 0);
}

// The backward of a block, streamed or resident, in NT threads. Resident:
// every W and b staged once, dW/db kept in shared memory as running sums
// (each chunk's slots added in order onto the entry) and stored at the end;
// te = kTE.
template <typename TF, typename TW, bool Resident, int NT>
__device__ __forceinline__ void bwd_block(
    const Mlp& m, const int* __restrict__ row_ptr,
    const int* __restrict__ col, const float* __restrict__ ew,
    const long long* __restrict__ slot_row, const TF* __restrict__ feats,
    const TF* __restrict__ g_out, TF* __restrict__ dfeats,
    float* __restrict__ partial, int n_rows, int rows, int n_params, int te,
    int kt) {
  extern __shared__ float sm[];
  const StreamLayout L = Resident ? make_resident_layout(m)
                                  : make_stream_layout(m, te, kt, 0, true);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, n_rows);
  const int e_begin = row_ptr[r0], e_end = row_ptr[r1];
  const int sd = L.sd, n = m.n;
  const int d0 = m.dim[0], dn = m.dim[n];
  // this block's dW/db, [dW0 (d0 x d1), db0 (d1), dW1, db1, ...]: streamed,
  // its first chunk stores them and later chunks add; resident, they are
  // stored once at the end. A block without edges stores 0
  float* p = partial + (long long)blockIdx.x * n_params;
  if (e_begin == e_end) {
    for (int i = threadIdx.x; i < n_params; i += NT) p[i] = 0.f;
    return;
  }
  if constexpr (Resident) stage_weights<TW, NT, true>(m, sm, true);
  for (int c0 = e_begin; c0 < e_end; c0 += te) {
    const int c1 = min(c0 + te, e_end);
    const bool first = c0 == e_begin;
    // recompute: h[l+1] = act(z[l]), z[l] = h[l] @ W[l] + b[l]; h and z
    // walk the layers' buffers (each te rows of stride pad4(width)), wl the
    // resident layers' W, b, dW, db
    float* h = sm + L.h[0];
    float* z = sm + L.z[0];
    float* wl = sm;
    gather_rows<NT, Resident>(te, pad4(d0), h, pad4(d0), [&](int e, int k) {
      const int s = c0 + e;
      return (s < c1 && k < d0) ? to_f32(feats[(long long)col[s] * d0 + k])
                                : 0.f;
    });
    for (int l = 0; l < n; ++l) {
      const int pin = pad4(m.dim[l]), pout = pad4(m.dim[l + 1]);
      float* hout = h + te * pin;
      if constexpr (Resident) {
        __syncthreads();  // h (and on the first chunk the weights) written
        const int act = m.act[l];
        const float* b = wl + pin * (pout + 1);
        if (pout <= 32)
          dense_tasks<NT, 1, true>(h, pin, wl, pout + 1, pin, te, pout, hout,
                                   z, pout, b, act, true, true);
        else if (pout <= 64)
          dense_tasks<NT, 2, true>(h, pin, wl, pout + 1, pin, te, pout, hout,
                                   z, pout, b, act, true, true);
        else
          dense_tasks<NT, 4, true>(h, pin, wl, pout + 1, pin, te, pout, hout,
                                   z, pout, b, act, true, true);
        wl += resident_floats(pin, pout, true);
      } else {
        stream_layer<TW, NT, 4, true, false>(m, l, L, sm, te, h, pin, hout,
                                             pout, z);
      }
      h = hout;
      z += te * pout;
    }
    // the output-gradient row of each slot's receiver, times its weight
    float* dz = sm + L.d[0];
    float* dh = sm + L.d[1];
    gather_rows<NT, Resident>(te, pad4(dn), dz, sd, [&](int e, int j) {
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
      if constexpr (Resident) {
        // te = kTE rows: a warp's rows, two columns a lane, loaded before
        // the first store, and the activation's switch outside the loop
        constexpr int R = kTE / (NT / 32);
        with_act(act, [&](auto a) {
          for (int j0 = lane; j0 < pout; j0 += 64) {
            float v[R][2];
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int e = warp + r * (NT / 32), j = j0 + 32 * c;
                const int q = e * pout + j;
                v[r][c] = j < pout ? dz[e * sd + j] *
                                         act_grad(decltype(a)::value, z[q],
                                                  hz[q])
                                   : 0.f;
              }
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int e = warp + r * (NT / 32), j = j0 + 32 * c;
                if (j < pout) dz[e * sd + j] = v[r][c];
              }
          }
        });
      } else {
        for (int e = warp; e < te; e += NT / 32)
          for (int j = lane; j < pout; j += 32) {
            const int q = e * pout + j;
            dz[e * sd + j] *= act_grad(act, z[q], hz[q]);
          }
      }
      __syncthreads();
      // dW[l] += h[l]^T dz and db[l] += the column sums of dz: resident into
      // the block's dW/db in shared memory, streamed into its partial row
      if constexpr (Resident) wl -= resident_floats(pin, pout, true);
      const float* w = wl;
      float* pw = Resident ? wl + pin * (pout + 1) + pout : p + poff;
      float* pb = Resident ? pw + pin * pout : pw + din * dout;
      if (Resident)
        dw_tiles<NT>(h, pin, dz, sd, te, din, dout, pw, pout, true, false);
      else
        dw_tiles<NT>(h, pin, dz, sd, te, din, dout, pw, dout,
                     ((poff | dout | n_params) & 3) == 0, first);
      for (int j = threadIdx.x; j < dout; j += NT) {
        float a = Resident ? pb[j] : 0.f;
        for (int e = 0; e < te; ++e) a += dz[e * sd + j];
        pb[j] = Resident || first ? a : pb[j] + a;
      }
      // dh[l] = dz @ W[l]^T, by row tiles of W (column tiles of dh)
      if (Resident && pin < 32) {
        dh_narrow<NT>(dz, sd, w, pout + 1, pin, pout, te, dh);
        __syncthreads();
      } else if constexpr (Resident) {
        const int slices = (pin + 63) >> 6;
        const int tr = task_rows<NT>(te, slices), nrg = te / tr;
        for (int t = warp; t < nrg * slices; t += NT / 32) {
          const int e0 = (t % nrg) * tr, k0 = (t / nrg) << 6;
          const float* wk = w + k0 * (pout + 1);
          const int kr = min(64, pin - k0);
          if (tr == 4)
            dh_task<4>(dz, sd, wk, pout + 1, kr, pout, e0, dh + k0);
          else if (tr == 2)
            dh_task<2>(dz, sd, wk, pout + 1, kr, pout, e0, dh + k0);
          else
            dh_task<1>(dz, sd, wk, pout + 1, kr, pout, e0, dh + k0);
        }
        __syncthreads();
      } else {
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
      }
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
  if constexpr (Resident) {
    const float* wl = sm;
    for (int l = 0; l < n; ++l) {
      const int din = m.dim[l], dout = m.dim[l + 1];
      const int pin = pad4(din), pout = pad4(dout);
      const float* dw = wl + pin * (pout + 1) + pout;
      for (int i = threadIdx.x; i < din * dout; i += NT)
        p[i] = dw[(i / dout) * pout + i % dout];
      p += din * dout;
      for (int j = threadIdx.x; j < dout; j += NT) p[j] = dw[pin * pout + j];
      p += dout;
      wl += resident_floats(pin, pout, true);
    }
  }
}

// one block an SM (its shared memory): without the 1, ptxas may hold it to
// fewer registers and spill
template <typename TF, typename TW>
__global__ void __launch_bounds__(kResThreads, 1)
    fused_mlp_bwd_kernel(const __grid_constant__ Mlp m,
                         const int* __restrict__ row_ptr,
                         const int* __restrict__ col,
                         const float* __restrict__ ew,
                         const long long* __restrict__ slot_row,
                         const TF* __restrict__ feats,
                         const TF* __restrict__ g_out,
                         TF* __restrict__ dfeats,
                         float* __restrict__ partial, int n_rows, int rows,
                         int n_params) {
  bwd_block<TF, TW, true, kResThreads>(m, row_ptr, col, ew, slot_row, feats,
                                       g_out, dfeats, partial, n_rows, rows,
                                       n_params, kTE, 0);
}

template <typename TF, typename TW>
__global__ void __launch_bounds__(kChunkThreads)
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
  bwd_block<TF, TW, false, kChunkThreads>(m, row_ptr, col, ew, slot_row,
                                          feats, g_out, dfeats, partial,
                                          n_rows, rows, n_params, te, kt);
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
      const int smem =
          make_stream_layout(m, kTE, 0, rows, false, true).total *
          (int)sizeof(float);
      err = cudaFuncSetAttribute(fused_mlp_fwd_resident_kernel<TF, TW>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      const int blocks = (n_rows + rows - 1) / rows;
      fused_mlp_fwd_resident_kernel<TF, TW>
          <<<blocks, kResFwdThreads, smem, stream>>>(m, row_ptr, col, ew, x,
                                                     y, n_rows, rows);
      return static_cast<int>(cudaGetLastError());
    }
    StreamPlan p;
    if (!plan_stream(m, rows, slots, false, &p)) return kOutsideEnvelope;
    err = cudaFuncSetAttribute(fused_mlp_fwd_stream_kernel<TF, TW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (n_rows + p.rows - 1) / p.rows;
    fused_mlp_fwd_stream_kernel<TF, TW>
        <<<blocks, kChunkThreads, p.smem, stream>>>(m, row_ptr, col, ew, x, y,
                                                    n_rows, p.rows, p.te,
                                                    p.kt);
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
            make_resident_layout(m).total * (int)sizeof(float);
        err = cudaFuncSetAttribute(fused_mlp_bwd_kernel<TF, TW>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        fused_mlp_bwd_kernel<TF, TW><<<blocks, kResThreads, smem, stream>>>(
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
            <<<blocks, kChunkThreads, p.smem, stream>>>(
                m, row_ptr, col, ew, slot_row, x, g, dx, partial, n_rows,
                rows, n_params, p.te, p.kt);
      }
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(ngpde::sum_partials(
        partial, static_cast<TW*>(grads), blocks, n_params, stream));
  });
}

}  // extern "C"
