// K5: the GNO kernel-network matvec fused with the receiver sum, over a
// receiver-sorted CSR whose `col` holds edge ids (the `tcsr_edges` layout),
//   out[n, o] = sum_{s in row n} w[s] sum_i h[snd_s, i]
//               * (sum_k ph[e_s, k] Wl[i, k, o] + bl[i, o]),
// with e_s = col[s] and snd_s = senders[e_s], in true f32, and its VJP: dph
// (E, K), the per-edge dh_e (E, IN), dWl (IN, K, OUT) and dbl (IN, OUT).
// Replaces neuralgraphpde/kernels/gno_kernels.py::_fused_gno_fwd and
// ::_fused_gno_bwd_pallas.
//
// Reduce, then contract. With ph' = [ph, 1] and Wl' = [Wl; bl] along k (KB
// = K + 1 columns with a bias, K without), the sum over a receiver's edges
// moves in front of the contraction:
//   S[n, i, k] = sum_{s in row n} w[s] h[snd_s, i] ph'[e_s, k]   (N, IN*KB)
//   out        = S . Wl'                          (N x IN*KB) (IN*KB x OUT)
// At the GNO Darcy widths (K 128, IN = OUT = 64, mean in-degree 18.6) a
// forward is 0.70 G multiply-adds instead of the TPU kernel's per-edge
// E*K*IN*OUT = 10.0 G. For an output cotangent g (N, OUT) the backward is
//   dS   = g . Wl'^T                              (N, IN*KB)
//   dWl' = S^T . g                                (IN*KB, OUT); dbl = k = K
//   dph'[e_s, k] = w[s] sum_i h[snd_s, i] dS[n, i, k]
//   dh_e[e_s, i] = w[s] sum_k ph'[e_s, k] dS[n, i, k]
// S is recomputed in the backward, not kept from the forward. dh_e goes
// onto the senders outside the kernel (index_add_), as the JAX package's
// segment_sum does.
//
// Dtypes, as the TPU kernels take them: ph (with out, g and dph) in TP, h
// in TH, Wl' (with dWl') in TW, each f32 or bf16. Every operand is
// converted to f32 as it is loaded; S, dS, the per-edge dh_e, the products'
// accumulators and split partials stay f32, and each result is rounded to
// its dtype once, when it is stored (dh_e after the sum onto the senders).
// Under the precision policy TW is bf16, and TP and TH are bf16 or f32.
//
// What bounds it on the H100: at those widths the two products (541 M
// multiply-adds each) and the reduce (158 M) are far above the ridge point
// against the 34 MB of S written and read, so the limit is the CUDA cores'
// f32 FMA rate (the tensor cores would round to TF32) and the shared-memory
// traffic that feeds them.
//
// Design:
// - S, dS and Wl' are kept with k padded to KP (KB rounded up to 4) by
//   zeros: S and dS (N, IN, KP), Wl' (IN, KP, OUT). Every row of the three
//   starts 16-byte aligned, and the padding adds zeros to every sum.
// - reduce: one block per receiver row; each thread owns a kRI x 4 tile of
//   S[n] (8 i x 4 k: 8 x 33 = 264 tiles at the Darcy widths, 288 threads,
//   registers held for 2 blocks an SM) in registers across all the row's
//   chunks of 32 edge slots, adds each chunk's edges in slot order and
//   stores the tile once, 16 bytes a row: no atomics, S never read back,
//   the same sums on every run. A width with more tiles than kRedThreads
//   takes passes, each over a slice of k (every i, kgp groups of 4
//   columns: 6 passes of 172 columns at K 1024, IN 64) that walks the
//   row's chunks again and gathers only its slice of the ph' rows, so the
//   two chunk buffers still fit. A chunk is gathered
//   a warp an edge row: its col/senders/w loaded once, the ph rows asked for
//   before the senders arrive, then the h rows, by 16-byte cp.async (bf16 by
//   plain loads), the bias column and padding of ph' by plain stores, h
//   scaled by w[s] in place by the lane that copied it, no divide an
//   element; two chunk buffers let chunk c + 1's copies run under chunk c's
//   FMAs (one where two do not fit).
// - products: one tiled kernel for S.Wl', g.Wl'^T and S^T.g
//   (gno_gemm_kernel): a kBM x kBN output tile a block, each thread kRG x
//   kCG groups of 4 rows x 4 consecutive columns, kStages shared-memory
//   stages of kBK-deep operand tiles filled by 16-byte cp.async, so the
//   next tiles' copies run under the current tile's FMAs. Each operand is
//   staged in its layout in device memory (no transposing copy, no divide
//   an element): rows along k for S and g as A and for Wl' as B of
//   g.Wl'^T, rows along m or n otherwise, read as float4 along whichever is
//   contiguous. The reads do not conflict: a quarter warp's A reads are one
//   address (broadcast), B's along n are consecutive, and B's along k are
//   swizzled (the 16-byte chunk q of row n sits at q ^ (n / 4 mod kBK / 4)).
//   Each thread stores its 4 columns of a row as 16 bytes. A product with
//   few output tiles is split along its inner dimension into per-split
//   partials that ngpde::sum_partials adds in a fixed order: deterministic.
//   bf16 operands take plain loads, converted on their way into shared
//   memory.
// - per-edge backward: one block per receiver row, 3 an SM (2 in the
//   sliced form, below: its own instantiation). dS[n] is
//   staged by 16-byte cp.async, under the gather of the chunk's h and ph'
//   rows (32 edges a chunk), in the row-major (IN, KP) layout it has in
//   device memory, whole where that leaves two blocks an SM; a wider row
//   (K 1024, IN 64: dS[n] alone is 257 KB) is staged in slices of ks
//   columns k (a multiple of 128 where one fits, at a row stride ks + 4),
//   each slice walking the row's chunks with its columns of ph': dph's
//   sums lie within a slice, and dh_e's sum over k goes on across slices
//   through dh_e itself (the running sum stored unscaled, in f32, read
//   back by the next slice, scaled by w[s] after the last), so every sum
//   keeps one chain and the bits do not depend on the slices. The
//   chunk's outputs are warp tasks of TR edges, TR the
//   smallest that gives every warp at most one task (at mean in-degree 18.6
//   every warp has one): dph tasks of 128 columns k (4 consecutive a lane,
//   float4 reads of dS along k) summed over i, dh tasks of 64 rows i (2 a
//   lane, 32 apart, float4 reads along k at the row stride, KP or ks + 4:
//   conflict-free where it is 4 mod 32, as at the Darcy and GKN widths)
//   summed over k; the edges'
//   h and ph' rows are read as broadcast float4. w[s] multiplies each sum
//   once. Every edge id appears once in `col`, so dph and dh_e rows are
//   written directly, with no scatter.
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

constexpr int kTE = 32;  // edge slots per chunk
// the reduce: a thread's tile of S, kRI rows i x 4 columns k; at most
// kRedThreads threads a block (a row with more tiles takes passes), their
// registers held to kRedBlocks blocks an SM (scripts/gno_variants.py sweeps
// the three)
constexpr int kRI = 8, kRedThreads = 384, kRedBlocks = 2;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
// bytes of shared memory a block may use and still leave a second block its
// share of the SM's 228 KB (1 KB of each block's is the system's)
constexpr int kHalfSmPerBlock = 233472 / 2 - 1024;
// returned by the launchers for widths outside the envelope (cudaError_t
// codes are >= 0)
constexpr int kOutsideEnvelope = -1;
// K, IN and OUT each at most this (keeps the int offsets in range)
constexpr int kMaxWidth = 4096;
constexpr int kMaxSplits = 65535;  // gridDim.z
// the products' output tile and each thread's groups of 4 rows (kRG) and 4
// columns (kCG) in it (kernels/gno_kernels.py _TILE_M and _TILE_N follow
// kBM and kBN; scripts/gno_variants.py sweeps them), and the stages of
// kBK-deep operand tiles
constexpr int kBM = 128, kBN = 64, kRG = 2, kCG = 1;
constexpr int kBK = 32, kStages = 3;
constexpr int kGemmThreads = (kBM / (4 * kRG)) * (kBN / (4 * kCG));
// the per-edge backward's block, the blocks an SM its registers are held
// to (its shared memory allows 3 at the Darcy widths) and its widest task,
// in edges
constexpr int kEdgeThreads = 256, kEdgeBlocks = 3;
// the blocks an SM the sliced form's registers are held to (its slices are
// sized for 2; its tasks' running sums and slice bounds spill at 3). A row
// that fits whole keeps the unsliced form: at K 128, IN 64 on an H100 its 3
// blocks an SM run the per-edge backward 14-20% faster than the sliced
// form's 2
constexpr int kEdgeSlicedBlocks = 2;
constexpr int kMaxTR = 8;
constexpr int kBatch = 8;  // loads in flight a lane in the edge gather

static_assert(kRI % 4 == 0 && kRedThreads % 32 == 0 && kRedThreads <= 1024,
              "reduce block");
static_assert(kGemmThreads % 32 == 0 && kGemmThreads <= 1024, "gemm block");
static_assert(kBK % 4 == 0 && (kBK & (kBK - 1)) == 0, "kBK: a power of 2");
static_assert(kTE % kMaxTR == 0, "a task never reads past the chunk");

struct Gno {
  int k;    // ph width
  int kb;   // k + 1 with a bias, else k: the columns of ph' and rows of Wl'
  int in;   // h width
  int out;  // output width
  int kp;   // kb padded to a multiple of 4: S, dS and Wl' rows
  int inp;  // in padded to a multiple of 4
};

__host__ __device__ __forceinline__ int pad4(int d) { return (d + 3) & ~3; }

// The reduce's launch: hw rows of hs floats (in rounded up to kRI); passes
// over each row, pass q holding the tiles of every i and of the kgp groups
// of 4 columns k from q * kgp on (fewer in the last), gathered into pp
// rows of 4 * kgp floats; the threads a block (a multiple of 32); two
// chunk buffers where they fit in kMaxSmem, else one.
struct ReduceShape {
  int hs, kgp, passes, threads, bufs, smem;
};

inline ReduceShape reduce_shape(const Gno& p) {
  ReduceShape r;
  r.hs = (p.in + kRI - 1) / kRI * kRI;
  const int ig = r.hs / kRI, kt = p.kp >> 2;
  const int most = kRedThreads / ig > 1 ? kRedThreads / ig : 1;
  r.passes = (kt + most - 1) / most;
  r.kgp = (kt + r.passes - 1) / r.passes;
  r.threads = (ig * r.kgp + 31) / 32 * 32;
  const int buf = kTE * (r.hs + 4 * r.kgp + 1) * (int)sizeof(float);
  r.bufs = 2 * buf <= kMaxSmem ? 2 : 1;
  r.smem = r.bufs * buf;
  return r;
}

// The per-edge backward's slices of k: dS[n] and the ph' rows are staged
// ks columns at a time (the last slice runs to kp), in shared-memory rows
// of `stride` floats: one slice of all kp columns where that block leaves
// two blocks an SM; else the widest ks that does, a multiple of 128 (one
// dph task's columns) where one fits, else of 4, at a stride of ks + 4
// (4 mod 32 where ks is a multiple of 128: the dh tasks' reads do not
// conflict); where none leaves two blocks an SM, the same within kMaxSmem.
// ks = 0 where not even 4 columns fit.
struct EdgeShape {
  int ks, slices, stride, smem;
};

inline int edge_smem(const Gno& p, int stride) {
  return (p.inp * stride + kTE * (p.inp + stride)) * (int)sizeof(float);
}

inline EdgeShape edge_shape(const Gno& p) {
  EdgeShape e{p.kp, 1, p.kp, edge_smem(p, p.kp)};
  if (e.smem <= kHalfSmPerBlock) return e;
  const int budgets[2] = {kHalfSmPerBlock, kMaxSmem};
  for (int b = 0; b < 2; ++b) {
    // the widest ks (a multiple of 4) whose stride ks + 4 fits
    const int fl = budgets[b] / (int)sizeof(float) - kTE * p.inp;
    int ks = fl > 0 ? (fl / (p.inp + kTE) - 4) & ~3 : 0;
    if (ks >= p.kp) return e;  // one slice within kMaxSmem
    if (ks >= 128) ks &= ~127;
    if (ks >= 4) {
      e.ks = ks;
      e.slices = (p.kp - 4 + ks - 1) / ks;  // the last takes up to ks + 4
      e.stride = ks + 4;
      e.smem = edge_smem(p, e.stride);
      return e;
    }
  }
  e.ks = 0;
  return e;
}

// The reduce's chunk [c0, c0 + ne) of a row's slots, a warp an edge row
// (edges warp, warp + nw, ...): lane j first loads the edge id and weight of
// the warp's j-th edge (the weight into bw) and asks for its sender; then
// the warp copies the columns [k_lo, k_lo + kw) of each edge's ph' row
// into pp (rows of ps floats), and once the senders have arrived its h row
// into hw (hs floats a row). f32 rows go by 16-byte cp.async where they
// are 16-byte aligned (vec) and by 4-byte ones otherwise; bf16 rows by
// plain loads, converted to f32 (h times w[s] there); the bias column (1)
// and the zero padding of ph' by plain stores. f32 h rows land unscaled:
// reduce_scale multiplies them by w[s] once they have landed. hw's columns
// past `in` are left as they are: the tile rows they feed are never
// stored.
template <typename TP, typename TH>
__device__ __forceinline__ void reduce_gather(
    const Gno& p, int hs, int ps, int k_lo, int kw, bool ph_vec, bool h_vec,
    const int* __restrict__ col, const float* __restrict__ ew,
    const int* __restrict__ senders, const TP* __restrict__ ph,
    const TH* __restrict__ h, int c0, int ne, float* hw, float* pp,
    float* bw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int eid = 0, snd = 0;
  float w = 0.f;
  if (warp + nw * lane < ne) {
    const int s = c0 + warp + nw * lane;
    eid = col[s];
    w = ew[s];
    snd = senders[eid];
    bw[warp + nw * lane] = w;
  }
  for (int j = 0, e = warp; e < ne; ++j, e += nw) {
    const TP* prow = ph + __shfl_sync(~0u, eid, j) * (long long)p.k + k_lo;
    float* pd = pp + e * ps;
    if (sizeof(TP) == sizeof(float) && ph_vec) {
      // k and k_lo are multiples of 4: a chunk lies in ph or past it, and
      // the one chunk past it starts with the bias column
      for (int q = lane; q < kw >> 2; q += 32) {
        if (k_lo + 4 * q < p.k)
          cp_async16(pd + 4 * q, prow + 4 * q, 16);
        else
          *reinterpret_cast<float4*>(pd + 4 * q) =
              make_float4(p.kb > p.k ? 1.f : 0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int k = lane; k < kw; k += 32) {
        if (k_lo + k >= p.k) {
          pd[k] = k_lo + k < p.kb ? 1.f : 0.f;
        } else if constexpr (sizeof(TP) == sizeof(float)) {
          cp_async4(pd + k, prow + k, true);
        } else {
          pd[k] = to_f32(prow[k]);
        }
      }
    }
  }
  for (int j = 0, e = warp; e < ne; ++j, e += nw) {
    const TH* hrow = h + __shfl_sync(~0u, snd, j) * (long long)p.in;
    float* hd = hw + e * hs;
    if constexpr (sizeof(TH) == sizeof(float)) {
      if (h_vec) {
        for (int q = lane; q < p.in >> 2; q += 32)
          cp_async16(hd + 4 * q, hrow + 4 * q, 16);
      } else {
        for (int i = lane; i < p.in; i += 32) cp_async4(hd + i, hrow + i, true);
      }
    } else {
      const float wj = __shfl_sync(~0u, w, j);
      for (int i = lane; i < p.in; i += 32) hd[i] = wj * to_f32(hrow[i]);
    }
  }
}

// f32 h rows of a chunk: each lane multiplies the part of hw it copied by
// w[s] from bw (its own cp.async writes are visible to it after the wait;
// bw's, by lanes of the same warp, after __syncwarp), w[s] * h rounded as
// the product it is
__device__ __forceinline__ void reduce_scale(const Gno& p, int hs, bool h_vec,
                                            int ne, const float* bw,
                                            float* hw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  __syncwarp();
  for (int e = warp; e < ne; e += nw) {
    const float wj = bw[e];
    float* hd = hw + e * hs;
    if (h_vec) {
      for (int q = lane; q < p.in >> 2; q += 32) {
        float4 v = ld4(hd + 4 * q);
        v.x *= wj;
        v.y *= wj;
        v.z *= wj;
        v.w *= wj;
        *reinterpret_cast<float4*>(hd + 4 * q) = v;
      }
    } else {
      for (int i = lane; i < p.in; i += 32) hd[i] *= wj;
    }
  }
}

// S[r, i, k] for one receiver row r per block, stored (N, in, kp) in f32
// (zero for k >= kb). In pass q (reduce_shape), with kgn groups of 4
// columns from k_lo = 4 q kgp on, thread t owns the kRI x 4 tile (i, k) =
// (t / kgn * kRI, k_lo + t % kgn * 4) in registers across all the row's
// chunks and stores it once, a 16-byte store a row of the tile (rows i >=
// in are not stored); one pass holds every tile where they fit in
// kRedThreads. Chunk c + 1's copies run under chunk c's FMAs where two
// buffers fit (bufs 2), else the chunks share one. Each entry is the chain
// acc = 0, fmaf(w[s] h[snd_s, i], ph'[e_s, k], acc) over the row's slots in
// order, whichever pass and thread hold it.
template <typename TP, typename TH>
__global__ void __launch_bounds__(kRedThreads, kRedBlocks)
    gno_reduce_kernel(Gno p, ReduceShape rs, bool ph_vec, bool h_vec,
                      const int* __restrict__ row_ptr,
                      const int* __restrict__ col,
                      const float* __restrict__ ew,
                      const int* __restrict__ senders,
                      const TP* __restrict__ ph,
                      const TH* __restrict__ h, float* __restrict__ s_out) {
  extern __shared__ float4 sm4[];
  float* const sm = reinterpret_cast<float*>(sm4);
  // a chunk buffer: hw (kTE x hs), pp (kTE x ps), bw (kTE)
  const int hs = rs.hs, ps = 4 * rs.kgp, bufs = rs.bufs;
  const int buf_floats = kTE * (hs + ps + 1);
  const int r = blockIdx.x;
  const int e_begin = row_ptr[r], deg = row_ptr[r + 1] - e_begin;
  const int chunks = (deg + kTE - 1) / kTE;
  const int kt_n = p.kp >> 2, ig = hs / kRI;
  for (int pass = 0; pass < rs.passes; ++pass) {
    const int kg0 = pass * rs.kgp, kgn = min(rs.kgp, kt_n - kg0);
    const int k_lo = 4 * kg0, kw = 4 * kgn;
    const int t = threadIdx.x;
    const bool own = t < ig * kgn;
    const int i0 = own ? t / kgn * kRI : 0, k0 = own ? t % kgn * 4 : 0;
    float acc[kRI][4];
#pragma unroll
    for (int a = 0; a < kRI; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
    if (pass > 0) __syncthreads();  // the last pass has read the buffers
    for (int c = 0; c < chunks; ++c) {
      float* hw = sm + (c & (bufs - 1)) * buf_floats;
      float* pp = hw + kTE * hs;
      const int ne = min(kTE, deg - c * kTE);
      if (c == 0 || bufs == 1) {
        reduce_gather(p, hs, ps, k_lo, kw, ph_vec, h_vec, col, ew, senders,
                      ph, h, e_begin + c * kTE, ne, hw, pp, pp + kTE * ps);
        cp_async_commit();
      }
      if (bufs == 2 && c + 1 < chunks) {
        float* hn = sm + ((c + 1) & 1) * buf_floats;
        reduce_gather(p, hs, ps, k_lo, kw, ph_vec, h_vec, col, ew, senders,
                      ph, h, e_begin + (c + 1) * kTE,
                      min(kTE, deg - (c + 1) * kTE), hn, hn + kTE * hs,
                      hn + kTE * (hs + ps));
        cp_async_commit();
        cp_async_wait<1>();  // chunk c has landed (this thread's copies)
      } else {
        cp_async_wait<0>();
      }
      if constexpr (sizeof(TH) == sizeof(float))
        reduce_scale(p, hs, h_vec, ne, pp + kTE * ps, hw);
      __syncthreads();  // chunk c is in shared memory, scaled
      if (own) {
        const float* hb = hw + i0;
        const float* pb = pp + k0;
        for (int e = 0; e < ne; ++e) {
          const float4 b = ld4(pb + e * ps);
          float a[kRI];
#pragma unroll
          for (int q = 0; q < kRI / 4; ++q) {
            const float4 v = ld4(hb + e * hs + 4 * q);
#pragma unroll
            for (int u = 0; u < 4; ++u) a[4 * q + u] = part(v, u);
          }
#pragma unroll
          for (int x = 0; x < kRI; ++x)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              acc[x][u] = fmaf(a[x], part(b, u), acc[x][u]);
        }
      }
      if (c + 1 < chunks) __syncthreads();  // chunk c read: refill its buffer
    }
    if (own) {
      float* srow = s_out + (long long)r * p.in * p.kp + k_lo;
#pragma unroll
      for (int x = 0; x < kRI; ++x)
        if (i0 + x < p.in)
          *reinterpret_cast<float4*>(srow + (i0 + x) * p.kp + k0) =
              make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
    }
  }
}

// ------------------------------------------------------------- products
// Rows [0, R) x columns [0, C) of an operand tile into shared memory s (row
// stride C floats), from the matrix whose element (row0 + r, col0 + c) sits
// at g[(row0 + r) * ld + col0 + c], zero outside rows < rlim and columns <
// clim. With Swz the 16-byte chunk q of row r lands at chunk q ^ (r / 4 mod
// C / 4). f32: 16-byte cp.async where `vec` (g, ld and col0 16-byte
// aligned) and the chunk lies inside the matrix, 4-byte ones at its edge;
// bf16: plain loads converted to f32. No divide: R, C are powers of 2.
template <int R, int C, bool Swz, typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ g,
                                          long long ld, int row0, int rlim,
                                          int col0, int clim, bool vec,
                                          float* s) {
  constexpr int kQ = C / 4;  // chunks a row
  for (int idx = threadIdx.x; idx < R * kQ; idx += kGemmThreads) {
    const int r = idx / kQ, q = idx % kQ;
    const int gr = row0 + r, gc = col0 + 4 * q;
    float* dst = s + r * C + 4 * (Swz ? q ^ ((r >> 2) & (kQ - 1)) : q);
    const T* src = g + (long long)gr * ld + gc;
    const bool row_in = gr < rlim;
    if constexpr (sizeof(T) == sizeof(float)) {
      const float* gf = reinterpret_cast<const float*>(g);
      const float* sf = reinterpret_cast<const float*>(src);
      if (vec && (!row_in || gc + 4 <= clim || gc >= clim)) {
        const bool in = row_in && gc < clim;
        cp_async16(dst, in ? sf : gf, in ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool in = row_in && gc + u < clim;
          cp_async4(dst + u, in ? sf + u : gf, in);
        }
      }
    } else {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = (row_in && gc + u < clim) ? to_f32(src[u]) : 0.f;
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// C[m, n] = sum_k A(m, k) B(k, n) for m < M, n < N, in f32, k ascending,
// with A(m, k) = A[m * lda + k] (AK) or A[k * lda + m], and B(k, n) =
// B[n * ldb + k] (BK) or B[k * ldb + n]. Block z of the grid's third
// dimension takes the inner range [z*kc, min((z+1)*kc, K)) (kc a multiple
// of kBK) and writes the (M, N) slab C + z*M*N (zeros for an empty range).
// a_vec / b_vec: the operand's 16-byte chunks are 16-byte aligned.
template <bool AK, bool BK, typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(kGemmThreads, 2)
    gno_gemm_kernel(int M, int N, int K, int kc, const TA* __restrict__ A,
                    long long lda, bool a_vec, const TB* __restrict__ B,
                    long long ldb, bool b_vec, TC* __restrict__ C) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  constexpr int kA = kBM * kBK, kStage = kA + kBN * kBK;
  constexpr int kTX = kBN / (4 * kCG);  // threads along n
  constexpr int kRS = kBM / kRG, kCS = kBN / kCG;  // group strides
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int kbeg = blockIdx.z * kc, kend = min(kbeg + kc, K);
  const int nk = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;
  const auto load = [&](int t) {
    float* s = sm + (t % kStages) * kStage;
    const int k0 = kbeg + t * kBK;
    if constexpr (AK)
      load_tile<kBM, kBK, false>(A, lda, m0, M, k0, kend, a_vec, s);
    else
      load_tile<kBK, kBM, false>(A, lda, k0, kend, m0, M, a_vec, s);
    if constexpr (BK)
      load_tile<kBN, kBK, true>(B, ldb, n0, N, k0, kend, b_vec, s + kA);
    else
      load_tile<kBK, kBN, false>(B, ldb, k0, kend, n0, N, b_vec, s + kA);
  };
  float acc[4 * kRG][4 * kCG];
#pragma unroll
  for (int r = 0; r < 4 * kRG; ++r)
#pragma unroll
    for (int c = 0; c < 4 * kCG; ++c) acc[r][c] = 0.f;
  // one cp.async group per stage, empty past the last tile
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nk) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed (this thread's part)
    __syncthreads();  // every part of tile t, and tile t - 1 is read
    if (t + kStages - 1 < nk) load(t + kStages - 1);
    cp_async_commit();
    const float* As = sm + (t % kStages) * kStage;
    const float* Bs = As + kA;
#pragma unroll
    for (int q = 0; q < kBK / 4; ++q) {
      float a[4 * kRG][4], b[4][4 * kCG];  // [row][k], [k][column]
#pragma unroll
      for (int g = 0; g < kRG; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (AK) {
            const float4 v = ld4(As + (g * kRS + ty * 4 + i) * kBK + 4 * q);
#pragma unroll
            for (int u = 0; u < 4; ++u) a[g * 4 + i][u] = part(v, u);
          } else {
            const float4 v = ld4(As + (4 * q + i) * kBM + g * kRS + ty * 4);
#pragma unroll
            for (int r = 0; r < 4; ++r) a[g * 4 + r][i] = part(v, r);
          }
        }
#pragma unroll
      for (int g = 0; g < kCG; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (BK) {
            const int n = g * kCS + tx * 4 + i;
            const float4 v =
                ld4(Bs + n * kBK + 4 * (q ^ ((n >> 2) & (kBK / 4 - 1))));
#pragma unroll
            for (int u = 0; u < 4; ++u) b[u][g * 4 + i] = part(v, u);
          } else {
            const float4 v = ld4(Bs + (4 * q + i) * kBN + g * kCS + tx * 4);
#pragma unroll
            for (int c = 0; c < 4; ++c) b[i][g * 4 + c] = part(v, c);
          }
        }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int r = 0; r < 4 * kRG; ++r)
#pragma unroll
          for (int c = 0; c < 4 * kCG; ++c)
            acc[r][c] = fmaf(a[r][u], b[u][c], acc[r][c]);
    }
  }
  TC* c = C + (long long)blockIdx.z * M * N;
  // C from torch.empty: 16-byte aligned, and so is each row where N % 4 == 0
  const bool vec = sizeof(TC) == sizeof(float) && (N & 3) == 0;
#pragma unroll
  for (int g = 0; g < kRG; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + g * kRS + ty * 4 + i;
      if (m >= M) continue;
#pragma unroll
      for (int h = 0; h < kCG; ++h) {
        const int n = n0 + h * kCS + tx * 4;
        TC* dst = c + (long long)m * N + n;
        if (vec && n + 4 <= N) {
          *reinterpret_cast<float4*>(dst) = make_float4(
              acc[g * 4 + i][h * 4], acc[g * 4 + i][h * 4 + 1],
              acc[g * 4 + i][h * 4 + 2], acc[g * 4 + i][h * 4 + 3]);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (n + u < N) dst[u] = from_f32<TC>(acc[g * 4 + i][h * 4 + u]);
        }
      }
    }
}

// ------------------------------------------------------ per-edge backward
// The chunk [c0, c1) of slots: h[snd_s] rows into hs (kTE x inp) and the
// columns [k_lo, k_lo + kw) of the ph'[e_s] rows into pp (kTE rows of
// `stride` floats), as f32, zero-padded, rows past c1 zero: a warp a row,
// lanes along it, kBatch loads in flight a lane.
template <typename TP, typename TH>
__device__ __forceinline__ void gather_edges(
    const Gno& p, int k_lo, int kw, int stride, const int* __restrict__ col,
    const int* __restrict__ senders, const TP* __restrict__ ph,
    const TH* __restrict__ h, int c0, int c1, float* hs, float* pp) {
  const int lane = threadIdx.x & 31;
  for (int e = threadIdx.x >> 5; e < kTE; e += kEdgeThreads / 32) {
    const int s = c0 + e;
    const bool live = s < c1;
    const long long eid = live ? col[s] : 0;
    const TH* hrow = h + (live ? senders[eid] : 0) * (long long)p.in;
    const TP* prow = ph + eid * p.k;
    for (int i0 = lane; i0 < p.inp; i0 += 32 * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + 32 * u;
        v[u] = live && i < p.in ? to_f32(hrow[i]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (i0 + 32 * u < p.inp) hs[e * p.inp + i0 + 32 * u] = v[u];
    }
    for (int k0 = lane; k0 < kw; k0 += 32 * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k_lo + k0 + 32 * u;
        // the bias column of ph' is 1
        v[u] = !live ? 0.f
               : k < p.k ? to_f32(prow[k])
                         : (k < p.kb ? 1.f : 0.f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (k0 + 32 * u < kw) pp[e * stride + k0 + 32 * u] = v[u];
    }
  }
}

// One dph task: dph[e_s, k_lo + k0 .. k_lo + k0 + 3] (below k) = w[s]
// sum_i hs[e, i] dS[i, k], i ascending, for the chunk rows e = e0 .. e0 +
// TR - 1 whose slot s = c0 + e is below c1; dsm holds the slice's columns
// of dS at row stride `stride`, the first kd of them columns of dph
template <int TR, typename TP>
__device__ __forceinline__ void dph_task(const Gno& p, int k_lo, int kd,
                                         int stride, const float* dsm,
                                         const float* hs, int e0, int k0,
                                         int c0, int c1,
                                         const int* __restrict__ col,
                                         const float* __restrict__ ew,
                                         TP* __restrict__ dph) {
  if (k0 >= kd) return;  // k0 + 3 lies in the slice then
  float acc[TR][4];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  // two dS rows at a time, each edge's two h values as one 8-byte
  // broadcast, and the i loop not unrolled: a step's loads stay in
  // flight together, within the registers of 3 blocks an SM
#pragma unroll 1
  for (int i = 0; i < p.inp; i += 2) {
    const float4 b0 = ld4(dsm + i * stride + k0);
    const float4 b1 = ld4(dsm + (i + 1) * stride + k0);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const float2 a =
          *reinterpret_cast<const float2*>(hs + (e0 + r) * p.inp + i);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r][c] = fmaf(a.y, part(b1, c), fmaf(a.x, part(b0, c), acc[r][c]));
    }
  }
  const bool vec = sizeof(TP) == sizeof(float) && (p.k & 3) == 0;
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int s = c0 + e0 + r;
    if (s >= c1) break;
    const float w = ew[s];
    TP* dst = dph + (long long)col[s] * p.k + k_lo + k0;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(
          w * acc[r][0], w * acc[r][1], w * acc[r][2], w * acc[r][3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (k_lo + k0 + c < p.k) dst[c] = from_f32<TP>(w * acc[r][c]);
    }
  }
}

// One dh task over a slice of kw columns k: for i = i0 and i0 + 32 (below
// in) and the chunk rows e0 .. e0 + TR - 1 whose slot is below c1, the sum
// dh_e[e_s, i] = w[s] sum_k pp[e, k] dS[i, k], k ascending, goes on from
// the running sum that the last slice stored in dh_e (0 in the first
// slice), and is stored unscaled, or times w[s] in the last slice
template <int TR>
__device__ __forceinline__ void dh_task(const Gno& p, int kw, int stride,
                                        bool first, bool last,
                                        const float* dsm, const float* pp,
                                        int e0, int i0, int c0, int c1,
                                        const int* __restrict__ col,
                                        const float* __restrict__ ew,
                                        float* __restrict__ dh_edge) {
  const bool in0 = i0 < p.in, in1 = i0 + 32 < p.in;
  if (!in0) return;
  const float* d0 = dsm + i0 * stride;
  const float* d1 = in1 ? d0 + 32 * stride : d0;
  float acc[TR][2];
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    acc[r][0] = acc[r][1] = 0.f;
    const int s = c0 + e0 + r;
    if (!first && s < c1) {
      const float* src = dh_edge + (long long)col[s] * p.in + i0;
      acc[r][0] = src[0];
      if (in1) acc[r][1] = src[32];
    }
  }
#pragma unroll 1
  for (int k = 0; k < kw; k += 4) {
    const float4 b0 = ld4(d0 + k), b1 = ld4(d1 + k);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const float4 a = ld4(pp + (e0 + r) * stride + k);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[r][0] = fmaf(part(a, u), part(b0, u), acc[r][0]);
        acc[r][1] = fmaf(part(a, u), part(b1, u), acc[r][1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int s = c0 + e0 + r;
    if (s >= c1) break;
    const float w = last ? ew[s] : 1.f;
    float* dst = dh_edge + (long long)col[s] * p.in + i0;
    dst[0] = last ? w * acc[r][0] : acc[r][0];
    if (in1) dst[32] = last ? w * acc[r][1] : acc[r][1];
  }
}

// task t of a chunk with TR edges a task: the dph tasks (kgs column groups
// of 128) first, then the dh tasks (row groups of 64 i)
template <int TR, typename TP>
__device__ __forceinline__ void edge_task(
    const Gno& p, int k_lo, int kw, int kd, int stride, bool first,
    bool last, int t, int nrg, int kgs, const float* dsm, const float* hs,
    const float* pp, int c0, int c1, const int* __restrict__ col,
    const float* __restrict__ ew, TP* __restrict__ dph,
    float* __restrict__ dh_edge) {
  const int lane = threadIdx.x & 31;
  const int e0 = (t % nrg) * TR, g = t / nrg;
  if (g < kgs)
    dph_task<TR>(p, k_lo, kd, stride, dsm, hs, e0, g * 128 + 4 * lane, c0,
                 c1, col, ew, dph);
  else
    dh_task<TR>(p, kw, stride, first, last, dsm, pp, e0,
                (g - kgs) * 64 + lane, c0, c1, col, ew, dh_edge);
}

// dph (in TP) and dh_e (f32) of one receiver row per block, from dS stored
// (N, in, kp): whole (Sliced false: one slice of every column, at row
// stride kp), or slice by slice of k (edge_shape)
template <bool Sliced, typename TP, typename TH>
__global__ void __launch_bounds__(kEdgeThreads,
                                  Sliced ? kEdgeSlicedBlocks : kEdgeBlocks)
    gno_edge_bwd_kernel(Gno p, EdgeShape es,
                        const int* __restrict__ row_ptr,
                        const int* __restrict__ col,
                        const float* __restrict__ ew,
                        const int* __restrict__ senders,
                        const TP* __restrict__ ph,
                        const TH* __restrict__ h,
                        const float* __restrict__ ds,
                        TP* __restrict__ dph,
                        float* __restrict__ dh_edge) {
  constexpr int kWarps = kEdgeThreads / 32;
  extern __shared__ float4 sm4[];
  const int stride = Sliced ? es.stride : p.kp;
  const int slices = Sliced ? es.slices : 1;
  float* dsm = reinterpret_cast<float*>(sm4);  // (inp, stride): dS[r]'s slice
  float* hs = dsm + p.inp * stride;            // (kTE, inp)
  float* pp = hs + kTE * p.inp;                // (kTE, stride)
  const int r = blockIdx.x;
  const int e_begin = row_ptr[r], e_end = row_ptr[r + 1];
  if (e_begin == e_end) return;  // the same for the whole block
  const float* drow = ds + (long long)r * p.in * p.kp;
  const int warp = threadIdx.x >> 5;
  const int dh_groups = (p.in + 63) >> 6;
  for (int sl = 0; sl < slices; ++sl) {
    const int k_lo = Sliced ? sl * es.ks : 0;
    const int kw = Sliced && sl + 1 < slices ? es.ks : p.kp - k_lo;
    // the slice of dS[r]: in rows of kw floats, 16-byte aligned, at row
    // stride `stride` (whole, contiguous); the rows up to inp are zero (the
    // last slice's tasks have read dsm: the chunk loop ended in a barrier)
    if (Sliced) {
      const int q4 = kw >> 2;
      for (int q = threadIdx.x; q < p.in * q4; q += kEdgeThreads) {
        const int i = q / q4, c = q - i * q4;
        cp_async16(dsm + i * stride + 4 * c, drow + i * p.kp + k_lo + 4 * c,
                   16);
      }
    } else {
      for (int q = threadIdx.x; q < (p.in * p.kp) >> 2; q += kEdgeThreads)
        cp_async16(dsm + 4 * q, drow + 4 * q, 16);
    }
    cp_async_commit();
    for (int q = p.in * stride + threadIdx.x; q < p.inp * stride;
         q += kEdgeThreads)
      dsm[q] = 0.f;
    const int kd = min(kw, p.k - k_lo);  // the slice's columns of dph
    const int kgs = kd > 0 ? (kd + 127) >> 7 : 0, groups = kgs + dh_groups;
    const bool first = !Sliced || sl == 0;
    const bool last = !Sliced || sl + 1 == slices;
    for (int c0 = e_begin; c0 < e_end; c0 += kTE) {
      const int c1 = min(c0 + kTE, e_end);
      gather_edges(p, k_lo, kw, stride, col, senders, ph, h, c0, c1, hs, pp);
      cp_async_wait<0>();
      __syncthreads();  // dS[r]'s slice and the chunk's rows are in place
      // the fewest edges a task that leave no warp a second task, at most
      // kMaxTR; rows past the chunk's are zero and not stored
      const int ne = c1 - c0;
      int tr = 1;
      while (tr < kMaxTR && ((ne + tr - 1) / tr) * groups > kWarps) ++tr;
      const int nrg = (ne + tr - 1) / tr;
      for (int t = warp; t < nrg * groups; t += kWarps) {
        switch (tr) {
#define NGPDE_EDGE_TASK(TR)                                           \
  case TR:                                                            \
    edge_task<TR>(p, k_lo, kw, kd, stride, first, last, t, nrg, kgs,  \
                  dsm, hs, pp, c0, c1, col, ew, dph, dh_edge);        \
    break;
          NGPDE_EDGE_TASK(1)
          NGPDE_EDGE_TASK(2)
          NGPDE_EDGE_TASK(3)
          NGPDE_EDGE_TASK(4)
          NGPDE_EDGE_TASK(5)
          NGPDE_EDGE_TASK(6)
          NGPDE_EDGE_TASK(7)
          NGPDE_EDGE_TASK(8)
#undef NGPDE_EDGE_TASK
        }
      }
      // the next chunk overwrites hs and pp, the next slice dsm; and the
      // next slice's dh tasks read what this one stored in dh_e
      __syncthreads();
    }
  }
}

// host: the widths, or kOutsideEnvelope. K5's envelope: K, IN and OUT
// from 1 to kMaxWidth, the reduce's chunk buffer (reduce_shape) within
// kMaxSmem bytes, and a slice of at least 4 columns of the per-edge
// backward (edge_shape) too: IN up to 1,444 at any K (the backward's dS
// rows and h rows fill the block first). Both launchers hold the widths
// to it, so a forward never runs whose backward could not.
int make_gno(int k, int in, int out, int has_bias, Gno* p) {
  if (k < 1 || in < 1 || out < 1 || k > kMaxWidth || in > kMaxWidth ||
      out > kMaxWidth)
    return kOutsideEnvelope;
  p->k = k;
  p->kb = k + (has_bias ? 1 : 0);
  p->in = in;
  p->out = out;
  p->kp = pad4(p->kb);
  p->inp = pad4(in);
  if (reduce_shape(*p).smem > kMaxSmem || edge_shape(*p).ks == 0)
    return kOutsideEnvelope;
  return 0;
}

bool aligned16(const void* ptr, long long ld) {
  return (reinterpret_cast<unsigned long long>(ptr) & 15) == 0 &&
         (ld & 3) == 0;
}

// C = A . B as gno_gemm_kernel describes it; with splits > 1 through
// `partial` (splits * M * N floats) and ngpde::sum_partials.
template <bool AK, bool BK, typename TA, typename TB, typename TC>
cudaError_t launch_gemm(int M, int N, int K, int splits, const TA* A,
                        long long lda, const TB* B, long long ldb, TC* C,
                        float* partial, cudaStream_t stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  const int per = (K + splits - 1) / splits;
  const int kc = (per + kBK - 1) / kBK * kBK;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, splits);
  const int smem = kStages * (kBM + kBN) * kBK * (int)sizeof(float);
  const bool a_vec = sizeof(TA) == sizeof(float) && aligned16(A, lda);
  const bool b_vec = sizeof(TB) == sizeof(float) && aligned16(B, ldb);
  const auto run = [&](auto kernel, auto* out) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kGemmThreads, smem, stream>>>(M, N, K, kc, A, lda, a_vec,
                                                 B, ldb, b_vec, out);
    return cudaGetLastError();
  };
  if (splits == 1) return run(gno_gemm_kernel<AK, BK, TA, TB, TC>, C);
  cudaError_t err = run(gno_gemm_kernel<AK, BK, TA, TB, float>, partial);
  if (err != cudaSuccess) return err;
  return ngpde::sum_partials(partial, C, splits, (long long)M * N, stream);
}

template <typename TP, typename TH>
cudaError_t launch_reduce(const Gno& p, const int* row_ptr, const int* col,
                          const float* ew, const int* senders, const TP* ph,
                          const TH* h, float* s_buf, int n_rows,
                          cudaStream_t stream) {
  const ReduceShape rs = reduce_shape(p);
  const bool ph_vec = sizeof(TP) == sizeof(float) && aligned16(ph, p.k);
  const bool h_vec = sizeof(TH) == sizeof(float) && aligned16(h, p.in);
  cudaError_t err = cudaFuncSetAttribute(
      gno_reduce_kernel<TP, TH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      rs.smem);
  if (err != cudaSuccess) return err;
  gno_reduce_kernel<TP, TH><<<n_rows, rs.threads, rs.smem, stream>>>(
      p, rs, ph_vec, h_vec, row_ptr, col, ew, senders, ph, h, s_buf);
  return cudaGetLastError();
}

// f(TP(), TH(), TW()) for the dtypes the flags pick (bf16 if set, else f32)
template <typename F>
int with_dtypes(int ph_bf16, int h_bf16, int w_bf16, F f) {
  auto pick_w = [&](auto tp, auto th) {
    return w_bf16 ? f(tp, th, bf16()) : f(tp, th, 0.f);
  };
  auto pick_h = [&](auto tp) {
    return h_bf16 ? pick_w(tp, bf16()) : pick_w(tp, 0.f);
  };
  return ph_bf16 ? pick_h(bf16()) : pick_h(0.f);
}

}  // namespace

extern "C" {

// How K5 runs at the widths (k, in, out, has_bias): plan[0] the reduce's
// passes over a row, plan[1] its threads a block, plan[2] its chunk
// buffers, plan[3] the per-edge backward's slices of k, plan[4] their
// width (the last runs to kp) and plan[5] its shared-memory bytes. Returns
// 0, or kOutsideEnvelope (-1) outside the envelope.
int ngpde_gno_plan(int k, int in, int out, int has_bias, int* plan) {
  Gno p;
  const int bad = make_gno(k, in, out, has_bias, &p);
  if (bad != 0) return bad;
  const ReduceShape rs = reduce_shape(p);
  const EdgeShape es = edge_shape(p);
  plan[0] = rs.passes;
  plan[1] = rs.threads;
  plan[2] = rs.bufs;
  plan[3] = es.slices;
  plan[4] = es.ks;
  plan[5] = es.smem;
  return 0;
}

// out (n_rows, out_chs) in ph's dtype. ph (E, k); h (nodes, in); wlb (in,
// kp, out_chs) = [Wl; bl] along k (kb = k + has_bias rows), zero rows up to
// kp = kb rounded up to 4; ph_bf16, h_bf16, w_bf16: the dtypes of ph, h and
// wlb (bf16 if set, else f32); s_buf: n_rows * in * kp floats of scratch;
// partial: splits * n_rows * out_chs floats when splits > 1. Returns a
// cudaError_t, or kOutsideEnvelope (-1).
int ngpde_gno_fwd(const int* row_ptr, const int* col, const float* ew,
                  const int* senders, const void* ph, const void* h,
                  const void* wlb, void* out, float* s_buf, float* partial,
                  int n_rows, int k, int in, int out_chs, int has_bias,
                  int splits, int ph_bf16, int h_bf16, int w_bf16,
                  void* stream_ptr) {
  Gno p;
  const int bad = make_gno(k, in, out_chs, has_bias, &p);
  if (bad != 0) return bad;
  if (splits < 1 || splits > kMaxSplits || n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return with_dtypes(ph_bf16, h_bf16, w_bf16, [&](auto tp, auto th, auto tw) {
    using TP = decltype(tp);
    using TH = decltype(th);
    using TW = decltype(tw);
    cudaError_t err = launch_reduce(
        p, row_ptr, col, ew, senders, static_cast<const TP*>(ph),
        static_cast<const TH*>(h), s_buf, n_rows, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    // out = S . Wl': A(m = n, k = j) = S[n * J + j], B(j, o) = wlb[j * out + o]
    const int j = in * p.kp;
    return static_cast<int>(launch_gemm<true, false>(
        n_rows, out_chs, j, splits, static_cast<const float*>(s_buf), j,
        static_cast<const TW*>(wlb), out_chs, static_cast<TP*>(out), partial,
        stream));
  });
}

// For the cotangent g_out (n_rows, out_chs) in ph's dtype: dph (E, k) in
// ph's dtype and dh_edge (E, in) in f32, one row per edge, written for every
// edge in `col` (the wrapper zeroes them first); dwlb (in, kp, out_chs) =
// [dWl; dbl] in wlb's dtype (its padding rows zero). s_buf and ds_buf:
// n_rows * in * kp floats each; partial: splits * in * kp * out_chs floats
// when splits > 1 (the split of S^T . g along the receivers); wlb and the
// dtype flags as for the forward.
int ngpde_gno_bwd(const int* row_ptr, const int* col, const float* ew,
                  const int* senders, const void* ph, const void* h,
                  const void* wlb, const void* g_out, void* dph,
                  float* dh_edge, void* dwlb, float* s_buf, float* ds_buf,
                  float* partial, int n_rows, int k, int in, int out_chs,
                  int has_bias, int splits, int ph_bf16, int h_bf16,
                  int w_bf16, void* stream_ptr) {
  Gno p;
  const int bad = make_gno(k, in, out_chs, has_bias, &p);
  if (bad != 0) return bad;
  if (splits < 1 || splits > kMaxSplits || n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int j = in * p.kp;
  return with_dtypes(ph_bf16, h_bf16, w_bf16, [&](auto tp, auto th, auto tw) {
    using TP = decltype(tp);
    using TH = decltype(th);
    using TW = decltype(tw);
    const TP* php = static_cast<const TP*>(ph);
    const TH* hp = static_cast<const TH*>(h);
    const TW* wp = static_cast<const TW*>(wlb);
    const TP* gp = static_cast<const TP*>(g_out);
    cudaError_t err;
    if (n_rows > 0) {
      err = launch_reduce(p, row_ptr, col, ew, senders, php, hp, s_buf,
                          n_rows, stream);
      if (err != cudaSuccess) return static_cast<int>(err);
      // dS = g . Wl'^T: A(n, o) = g[n * out + o], B(o, j) = wlb[j * out + o]
      err = launch_gemm<true, true>(n_rows, j, out_chs, 1, gp,
                                    (long long)out_chs, wp,
                                    (long long)out_chs, ds_buf, nullptr,
                                    stream);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    // dWl' = S^T . g: A(j, n) = S[n * J + j], B(n, o) = g[n * out + o]
    // (zeros without rows)
    err = launch_gemm<false, false>(
        j, out_chs, n_rows, splits, static_cast<const float*>(s_buf),
        (long long)j, gp, (long long)out_chs, static_cast<TW*>(dwlb),
        partial, stream);
    if (err != cudaSuccess || n_rows == 0) return static_cast<int>(err);
    const EdgeShape es = edge_shape(p);
    const auto run = [&](auto kernel) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, es.smem);
      if (e != cudaSuccess) return e;
      kernel<<<n_rows, kEdgeThreads, es.smem, stream>>>(
          p, es, row_ptr, col, ew, senders, php, hp, ds_buf,
          static_cast<TP*>(dph), dh_edge);
      return cudaGetLastError();
    };
    return static_cast<int>(es.slices > 1
                                ? run(gno_edge_bwd_kernel<true, TP, TH>)
                                : run(gno_edge_bwd_kernel<false, TP, TH>));
  });
}

}  // extern "C"
