// Hopper (sm_90a) kernels for the fused 'diff' FactorGraphGRU round of the
// packed row layout.  Built by trackmpnn_tpu_torch/ops/_build.py into a
// shared library with a plain C interface and called through ctypes from
// ops/round.py, which checks device, dtype, shape, contiguity, alignment and
// the width rule before any pointer gets here.  All math is f32 except the
// incident sums, which add in f64 and round to f32 once; the GRU products
// run on the tensor cores in split TF32 (3xTF32, csrc/tf32_mma.cuh: f32-level
// error).  No kernel uses atomics and every sum runs in an order fixed by the
// shapes and the device, so every result is the same from run to run.
//
// Layout: h f32[B, cap, H]; idx int32[B, cap, 4] = (past, fut,
// is_live_edge, is_live_det), indices local to the window, read as one
// int4 a row.  A row flagged is_live_det is a detection, a row flagged
// is_live_edge and not is_live_det an edge, any other row dead.  The CSR
// incidence (inc_ptr int32[B*cap + 1] over flat rows, inc_idx int32[n] of
// window-local edge rows) lists each row's incident edges; a kernel skips
// the listed rows the step's idx does not flag as edges.  The GRU weights
// keep the JAX layout: w_ih, w_hh f32[H, 3H], column blocks r | z | n.
// Widths: every H that is a multiple of 8 from 8 to 256, any B and cap
// (B*cap < 2^31).
//
// The TPU kernels (pallas_round.py:79 _fwd_a_kernel, :127 _fwd_b_kernel,
// :225 _bwd_b_kernel, :268 _bwd_a_kernel) keep a whole window [cap, H] and
// both GRUs' weights in VMEM, feed the MXU and carry the incident sums and
// the weight gradients across a sequential grid.  The first design here ran
// the products on the CUDA cores: a CTA of 32 rows (H 64) ran both GRUs and
// read both GRUs' weights through __ldg for every tile (192 KB a CTA, ~200
// MB of L2 traffic a launch at 32,768 slots), six loads for every 48 FMAs;
// the backward first transposed the four matrices into scratch; d W kept H
// accumulators a thread and wrote ~25 MB of partials.  At phase 11's widest
// round (8 windows x 4,096 slots, H 64) it measured 166.21 / 199.42 /
// 246.98 us (forward / GRU backward / d W) against f32 bounds of 20.55 /
// 40.96 / 19.86, and it refused every H but 16, 32 and 64.
//
// This design:
//   * Rows by kind.  round_prep_kernel cuts the B*cap flat rows into
//     chunks of CH (256, more where there would be over kMaxChunks chunks)
//     and lists each chunk's edge rows and detection rows in increasing
//     order (a block scan of per-thread counts), with each chunk's two
//     counts; it also writes what the step needs row by row: the forward's
//     xin (ns = h[past] - h[fut] at an edge, the signed incident sum es in
//     f64 at a detection) and the zeros of dead rows in every output.  A
//     consumer CTA scans the chunks' counts into shared memory (two warps)
//     and finds the flat row of a kind's i-th row by binary search.  Edge
//     rows run only the edge GRU and detections only the node GRU (the TPU
//     runs both on every row and selects).
//   * Weights resident and split once.  The product kernels are persistent,
//     two warpgroups a CTA, grid (CTAs, H / U): CTA (x, y) owns units [y U,
//     y U + U) of each gate (U the widest of 32, 16, 8 dividing H whose
//     slab fits: 32 at H 64 and 128, 16 at H 48 and 256), each warpgroup
//     walking 64-row tiles (pairs 2x, 2x + 1, then + 2 gridDim.x) of the
//     edge rows, then of the detection rows (from an even tile, so that a
//     pair is of one kind).  At its first pair of a kind a CTA stages that
//     GRU's slab: [w_ih | w_hh] x its U units of r, z, n, read from global
//     memory, split once into TF32 big and small halves and stored as
//     wgmma's K-major core matrices (96 KB at H 64): each CTA stages at
//     most two slabs a launch instead of 192 KB every 32 rows.
//   * Products on the tensor cores: 3xTF32 wgmma with A from registers
//     (tf32_mma.cuh's wgmma_tf32 / wgmma3, fused_edge_gru's scheme), each
//     k step of 8 into a fresh accumulator added in f32.  A thread reads
//     its A values from global memory (L2), columns 2t and 2t + 1 of a k
//     step (the slab puts those k in the fragment's slots t and t + 4), a
//     k step ahead.  r and z sum x w_ih then h w_hh each k step; gi_n and
//     gh_n their own.  The gate epilogue stays in registers (expf / tanhf
//     as the plain version).
//   round_fwd: prep (xin, dead rows), then round_gru_kernel<U, false>:
//     out = (1 - z) n + z h of its units.
//   round_bwd_gru: prep (dead rows), round_gru_kernel<U, true> recomputes
//     the gates of its units and writes d4 = [d r | d z | d n | r d n] and
//     the direct part z g of d h; round_dgx_kernel<V> then takes the two
//     transposed products over K = 3H, d xin = d gi w_ih^T and ddir += d gh
//     w_hh^T, for V output columns a CTA (its slab [w_ih; w_hh] rows of
//     those columns, read straight from the untransposed matrices, so the
//     transposing launch and its scratch are gone).  Below 2H d gi and d gh
//     are the same A, and one wgmma of N = 2V takes both.  Its A rows come
//     in by cp.async, four k steps a group, three groups in flight in a
//     ring of shared memory a warpgroup, and the group's products go into
//     one fresh accumulator: with A in registers a group ahead it waited on
//     those loads about as long as on its products.
//   round_bwd_dw: prep (lists only), then round_dw_kernel: per kind the
//     split-K products xin^T d gi and h^T d gh over row slices (grid (S
//     slices, 64 x 48 tiles of both [H, 3H]); the kinds share the S slices
//     in proportion to their rows, so a round of many edges and few
//     detections keeps every CTA busy), 64 rows a stage gathered by
//     cp.async double-buffered, 3xTF32 mma.sync; the CTAs of tile row 0
//     also sum the bias gradients' columns in row order.  S fills one wave
//     of resident CTAs, so the partials (one [H*3H * 2 + 2*3H] a slice)
//     stay a few MB; round_dw_sum_kernel adds each kind's in slice order.
//   What holds them (PERF.md §6, §7): the gate kernel waits on each k
//   step's fresh accumulators (tried: two m tiles a warp, mma.sync, deeper
//   register prefetch, a shared-memory ring for its A, more CTAs an SM;
//   none was faster), and prep on the detections' incident sums (four
//   entries' loads in flight, kIncAhead).
// Bounds: f32 operations, 4 H 3H a live row for the forward and for d W
// (two [H, 3H] products), 8 H 3H for the GRU backward; as 3xTF32 three
// TF32 products for each f32 one, against the dense TF32 rate.
//
// round_bwd_dh
//   Replaces _bwd_a_kernel (:268-299): d h = ddir + (at an edge row) d
//   es[past] - d es[fut] + the signed sum of d ns over the row's incident
//   edges, in f64, rounded once.  Bound: bytes (a gather over the
//   incidence), but a row's sums wait on a chain of dependent loads (idx,
//   then the endpoints' idx, then d xin; the CSR offsets, then the entries,
//   then their idx and d xin).  The first design ran one thread per (row,
//   column), so each of a row's H threads repeated both chains and walked
//   the incident entries one at a time (36.04 us at phase 11's widest
//   round, H 64, against a 6.35 us bound).  This one takes a row per group
//   of lanes, columns as float4, loads each chain's last two levels
//   together and stages the incident entries a group's width at a time
//   (the kernel's note below).  At phase 11's widest round (H 64: 25,245
//   edge rows, 1,622 detections with 31 incident edges on average, 68 at
//   most) the detections' walks take two thirds of its time: without them
//   it ran 6.5 us.  Tried and slower or no faster: 2 or 8 entries' loads
//   ahead, a second chunk in flight, 3 or 5 CTAs an SM, 8 lanes a row at H
//   64, the lists' rows prefetched into L1 or L2, and a stage of 16 or 8
//   rows copied into shared memory by cp.async (PERF.md §6, §7).
//
// An index outside the window (an edge's endpoint, an incidence entry, a
// CSR offset outside inc_idx) traps the kernel: a sticky CUDA error that
// the next synchronisation raises.  No kernel synchronises or allocates:
// the caller allocates every output and scratch and every launch goes to
// the stream it is given.  Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"  // 3xTF32 mma, cp.async

namespace {

constexpr int kThreads = 256;       // round_bwd_dh
constexpr int kPrepThreads = 256;   // round_prep_kernel; a chunk is a multiple
constexpr int kMaxChunks = 2048;    // chunks a launch cuts its rows into
constexpr int kProdThreads = 256;   // the product kernels: two warpgroups
constexpr int kWgRows = 64;         // rows of a tile: a warpgroup's, 16 a warp
constexpr int kSmemMax = 232448;    // the most dynamic shared memory a CTA may opt in to
constexpr int kWgThreads = 128;     // a warpgroup
constexpr int kDgxSteps = 4;        // round_dgx_kernel: k steps a group (one fresh accumulator)
constexpr int kDgxStages = 3;       // and groups of A in its shared-memory ring
constexpr int kDgxStride = 72;      // floats a row of a ring stage: 4 steps x (d gi, d gh) x 8, padded
constexpr int kGThreads = 128;      // round_dw: four warps
constexpr int kDwRows = 64;         // round_dw: h rows of an output tile (16 a warp)
constexpr int kDwCols = 48;         // and its columns: 6 n tiles
constexpr int kDwK = 64;            // rows a stage
constexpr int kAStride = 72;        // floats a staged row of the A tile (8 mod 32)
constexpr int kBStride = 56;        // floats a staged row of the B tile (24 mod 32)
constexpr unsigned kFull = 0xffffffffu;

struct Gru {
  const float *w_ih, *w_hh, *b_ih, *b_hh;
};

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// 2 detection, 1 edge, 0 dead
__device__ __forceinline__ int kind_of(int4 q) { return q.w != 0 ? 2 : (q.z != 0 ? 1 : 0); }

__device__ __forceinline__ void check_row(int r, int cap) {
  if ((unsigned)r >= (unsigned)cap) __trap();
}

// flat rows a chunk: 256, or the multiple of 256 that keeps the chunks at
// most kMaxChunks
__host__ __device__ __forceinline__ int chunk_rows(int nrows) {
  const int by256 = (nrows + kPrepThreads - 1) / kPrepThreads;
  return kPrepThreads * max(1, (by256 + kMaxChunks - 1) / kMaxChunks);
}
__host__ __device__ __forceinline__ int n_chunks(int nrows) {
  const int ch = chunk_rows(nrows);
  return (nrows + ch - 1) / ch;
}

// units of each gate a product CTA owns: the widest of 32, 16, 8 that
// divides H and whose slab (48 U H bytes) fits with the largest chunk
// prefix: 32 at H 64 and 128, 16 at H 48 and 256
size_t prod_smem(int U, int H, int nchunks);
size_t dgx_smem(int V, int H, int nchunks);
int gru_units(int H) {
  for (int U = 32; U > 8; U /= 2)
    if (H % U == 0 && prod_smem(U, H, kMaxChunks) <= (size_t)kSmemMax) return U;
  return 8;
}
// output columns a round_dgx_kernel CTA owns: the same rule with its ring
// (32 at H 64, 16 at H 48 and 128, 8 at H 256)
int dgx_units(int H) {
  for (int V = 32; V > 8; V /= 2)
    if (H % V == 0 && dgx_smem(V, H, kMaxChunks) <= (size_t)kSmemMax) return V;
  return 8;
}


// round_prep_kernel's signed sum over row r's incident edges (window-local
// entries of the CSR incidence [e0, e1) within the window at idxb) of what
// `val(kk)` gives for edge row kk, in f64, entry order: ((past kk == r) -
// (fut kk == r)) val(kk), skipping the entries the step's idx does not flag
// as edges.  kIncAhead entries' indices, rows and values are loaded before
// they are added.  An entry outside the window traps.
constexpr int kIncAhead = 4;  // 1, 2, 8 and 16 were slower at phase 11's widest round

template <class T, class Val, class Add>
__device__ __forceinline__ void incident_sum(const int4* __restrict__ idxb,
                                             const int* __restrict__ inc_idx, int e0, int e1,
                                             int r, int cap, Val val, Add add) {
  for (int e = e0; e < e1; e += kIncAhead) {
    int kk[kIncAhead], coef[kIncAhead];
    T v[kIncAhead];
#pragma unroll
    for (int u = 0; u < kIncAhead; ++u) {
      kk[u] = e + u < e1 ? inc_idx[e + u] : 0;
      if (e + u < e1) check_row(kk[u], cap);
    }
#pragma unroll
    for (int u = 0; u < kIncAhead; ++u) {
      const int4 q = e + u < e1 ? idxb[kk[u]] : make_int4(0, 0, 0, 0);
      coef[u] = kind_of(q) == 1 ? (q.x == r) - (q.y == r) : 0;
    }
#pragma unroll
    for (int u = 0; u < kIncAhead; ++u)
      if (coef[u] != 0) v[u] = val(kk[u]);
#pragma unroll
    for (int u = 0; u < kIncAhead; ++u)
      if (coef[u] != 0) add(coef[u], v[u]);
  }
}

// ----------------------------------------------------------- row lists ----
// The rows scratch: list [2][nrows] (chunk c's rows of kind k at k*nrows +
// c*CH, in increasing order), then cnt [nchunks][2].
//
// Grid (nchunks, parts), kPrepThreads threads.  CTA (c, 0) lists chunk
// c: thread t counts the rows t*per .. of the chunk (per = CH /
// kPrepThreads), a block scan places them.  MODE 0 lists only; 1 also the
// forward's xin and dead rows' out and xin; 2 also the zeros of dead rows
// in d4, dxin and ddir: CTA (c, y) takes the chunk's (row, 4 columns)
// items y*kPrepThreads on, one a thread.
enum { kPrepLists = 0, kPrepFwd = 1, kPrepBwd = 2 };

template <int MODE>
__global__ void __launch_bounds__(kPrepThreads)
round_prep_kernel(const int4* __restrict__ idx, const float* __restrict__ h,
                  const int* __restrict__ inc_ptr, const int* __restrict__ inc_idx, int n_inc,
                  float* __restrict__ xin, float* __restrict__ out, float* __restrict__ d4,
                  float* __restrict__ dxin, float* __restrict__ ddir, int* __restrict__ list,
                  int* __restrict__ cnt, int nrows, int cap, int H, int CH) {
  __shared__ int wtot[2][kPrepThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, r0 = c * CH, r1 = min(nrows, r0 + CH);
  if (blockIdx.y == 0) {  // the lists (a barrier inside: the branch is the CTA's)
    const int per = CH / kPrepThreads, a = r0 + tid * per;
    int ne = 0, nd = 0;
    for (int i = 0; i < per; ++i) {
      const int r = a + i;
      if (r < r1) {
        const int k = kind_of(idx[r]);
        ne += k == 1;
        nd += k == 2;
      }
    }
    int ie = ne, id = nd;
#pragma unroll
    for (int sh = 1; sh < 32; sh <<= 1) {
      const int ve = __shfl_up_sync(kFull, ie, sh), vd = __shfl_up_sync(kFull, id, sh);
      if (lane >= sh) {
        ie += ve;
        id += vd;
      }
    }
    if (lane == 31) {
      wtot[0][warp] = ie;
      wtot[1][warp] = id;
    }
    __syncthreads();
    int be = ie - ne, bd = id - nd, te = 0, td = 0;
#pragma unroll
    for (int w = 0; w < kPrepThreads / 32; ++w) {
      if (w < warp) {
        be += wtot[0][w];
        bd += wtot[1][w];
      }
      te += wtot[0][w];
      td += wtot[1][w];
    }
    for (int i = 0; i < per; ++i) {
      const int r = a + i;
      if (r < r1) {
        const int k = kind_of(idx[r]);
        if (k == 1) list[r0 + be++] = r;
        else if (k == 2) list[nrows + r0 + bd++] = r;
      }
    }
    if (tid == 0) {
      cnt[2 * c] = te;
      cnt[2 * c + 1] = td;
    }
  }
  if (MODE == kPrepLists) return;
  const int H4 = H / 4;
  const float4* h4 = reinterpret_cast<const float4*>(h);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t e = (int64_t)blockIdx.y * kPrepThreads + tid;
  if (e < (int64_t)(r1 - r0) * H4) {
    const int r = r0 + (int)(e / H4), c4 = (int)(e % H4);
    const int4 q = idx[r];
    const int kind = kind_of(q);
    const int64_t o = (int64_t)r * H4 + c4;
    if (MODE == kPrepFwd) {
      float4 x = zero;
      const int base = r - r % cap, rl = r - base;
      if (kind == 1) {
        check_row(q.x, cap);
        check_row(q.y, cap);
        const float4 u = h4[(int64_t)(base + q.x) * H4 + c4], v = h4[(int64_t)(base + q.y) * H4 + c4];
        x = make_float4(u.x - v.x, u.y - v.y, u.z - v.z, u.w - v.w);
      } else if (kind == 2) {
        const int e0 = inc_ptr[r], e1 = inc_ptr[r + 1];
        if (e0 < 0 || e1 < e0 || e1 > n_inc) __trap();
        double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
        incident_sum<float4>(
            idx + base, inc_idx, e0, e1, rl, cap,
            [&](int kk) { return h4[(int64_t)(base + kk) * H4 + c4]; },
            [&](int coef, float4 v) {
              s0 += coef * (double)v.x;
              s1 += coef * (double)v.y;
              s2 += coef * (double)v.z;
              s3 += coef * (double)v.w;
            });
        x = make_float4((float)s0, (float)s1, (float)s2, (float)s3);
      } else {
        reinterpret_cast<float4*>(out)[o] = zero;
      }
      reinterpret_cast<float4*>(xin)[o] = x;
    } else if (kind == 0) {
      reinterpret_cast<float4*>(dxin)[o] = zero;
      reinterpret_cast<float4*>(ddir)[o] = zero;
      float4* d = reinterpret_cast<float4*>(d4) + (int64_t)r * 4 * H4 + c4;
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) d[q4 * H4] = zero;
    }
  }
}

// pre[k][c] = the rows of kind k in chunks before c (c = 0 .. nchunks, so
// pre[k][nchunks] is the kind's total), from cnt; warp k of the CTA scans
// kind k.  Ends with a barrier.
__device__ void scan_counts(const int* __restrict__ cnt, int nchunks, int* pre) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    int* p = pre + warp * (nchunks + 1);
    const int per = (nchunks + 31) / 32, c0 = lane * per, c1 = min(nchunks, c0 + per);
    int s = 0;
    for (int c = c0; c < c1; ++c) s += cnt[2 * c + warp];
    int incl = s;
#pragma unroll
    for (int sh = 1; sh < 32; sh <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, sh);
      if (lane >= sh) incl += v;
    }
    int run = incl - s;
    for (int c = c0; c < c1; ++c) {
      p[c] = run;
      run += cnt[2 * c + warp];
    }
    if (lane == 31) p[nchunks] = incl;
  }
  __syncthreads();
}

// The row lists of a launch, with the chunk prefix in shared memory
struct Rows {
  const int* list;
  const int* pre;
  int nchunks, CH, nrows;
  __device__ int total(int kind) const { return pre[kind * (nchunks + 1) + nchunks]; }
  // the flat row of the i-th row of `kind` (i < total(kind))
  __device__ int slot(int kind, int i) const {
    const int* p = pre + kind * (nchunks + 1);
    int lo = 0, hi = nchunks - 1;  // the last chunk c with p[c] <= i
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (p[mid] <= i) lo = mid;
      else hi = mid - 1;
    }
    return list[kind * nrows + lo * CH + (i - p[lo])];
  }
};

// ------------------------------------------------------------ products ----
__device__ __forceinline__ float2 ld2(const float* p) {
  return p ? __ldg(reinterpret_cast<const float2*>(p)) : make_float2(0.f, 0.f);
}

// One k step's B operand of N columns, big and small, K-major in core
// matrices of 8 columns x 4 k (16-byte rows): column group i, k half kh at i
// * 256 + kh * 128 bytes, column n % 8 16 bytes apart, element c holding k =
// 8 ks + 2 c + kh (so that the A fragment's k slots t and t + 4 are columns
// 2t and 2t + 1 of a row), small N * 32 bytes after big.  Thread writes of
// one 16-byte row: value(n, k) for its four k, split once.
template <class Value>
__device__ __forceinline__ void put_b_row(char* block, int N, int n, int kh, int k0, Value value) {
  float4 big, small;
  float* bp = &big.x;
  float* sp = &small.x;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t b, sm;
    split_tf32(value(n, k0 + 2 * c + kh), b, sm);
    bp[c] = __uint_as_float(b);
    sp[c] = __uint_as_float(sm);
  }
  char* dst = block + (n >> 3) * 256 + kh * 128 + (n & 7) * 16;
  *reinterpret_cast<float4*>(dst) = big;
  *reinterpret_cast<float4*>(dst + N * 32) = small;
}

// Shared memory of the product kernels: the CTA's split slab (48 U H bytes
// for both), the biases [4][U] (round_gru_kernel) and the chunk prefix
__host__ __device__ __forceinline__ size_t slab_bytes(int U, int H) { return (size_t)48 * U * H; }
size_t prod_smem(int U, int H, int nchunks) {
  return slab_bytes(U, H) + sizeof(float) * 4 * U + sizeof(int) * 2 * (nchunks + 1);
}
size_t dgx_smem(int V, int H, int nchunks) {
  return slab_bytes(V, H) + sizeof(float) * 2 * kDgxStages * kWgRows * kDgxStride +
         sizeof(int) * (2 * kWgRows + 2 * (nchunks + 1));
}

// The tile walk of a product CTA: pair p of 64-row tiles (2p, 2p + 1), one
// a warpgroup, for p = blockIdx.x, + gridDim.x, ...; edge tiles first, the
// detection tiles from an even index so that a pair is of one kind.
struct Walk {
  int n_e, n_d, te2, total;
  __device__ Walk(const Rows& rows) {
    n_e = rows.total(0);
    n_d = rows.total(1);
    const int te = (n_e + kWgRows - 1) / kWgRows;
    te2 = te + (te & 1);
    total = te2 + (n_d + kWgRows - 1) / kWgRows;
  }
};

// Grid (CTAs, H / U), two warpgroups.  CTA (x, y) owns units [y U, y U +
// U) of each gate and stages, for a kind, the B slab of [w_ih | w_hh] x
// those units of r, z, n (N = 3U; k step ks of matrix mat at (2 (2 ks +
// mat)) kPart bytes).  kBwd false: out of its units for every live row
// (round_fwd).  kBwd true: d4 and ddir = z g of them (round_bwd_gru's first
// pass), g the cotangent of out.
template <int U, bool kBwd>
__global__ void __launch_bounds__(kProdThreads, 1)
round_gru_kernel(const float* __restrict__ h, const float* __restrict__ xin,
                 const float* __restrict__ gout, const Gru we, const Gru wn,
                 const int* __restrict__ list, const int* __restrict__ cnt, int nchunks, int CH,
                 int nrows, int H, float* __restrict__ out, float* __restrict__ d4,
                 float* __restrict__ ddir) {
  constexpr int NT = U / 8, DN = 3 * U / 2;  // n tiles a gate; floats of a product
  constexpr int kPart = 3 * U * 32;          // bytes of a (k step, matrix) half of B
  constexpr uint64_t kPartD = kPart >> 4;
  extern __shared__ float4 smem4[];
  char* s_w = reinterpret_cast<char*>(smem4);
  float* bias = reinterpret_cast<float*>(s_w + slab_bytes(U, H));
  int* pre = reinterpret_cast<int*>(bias + 4 * U);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, t = lane & 3, u0 = blockIdx.y * U, nks = H / 8;
  scan_counts(cnt, nchunks, pre);
  const Rows rows{list, pre, nchunks, CH, nrows};
  const Walk walk(rows);
  const uint64_t desc0 = wg_desc(s_w, 128, 256);
  int staged = -1;
  for (int pair = blockIdx.x; 2 * pair < walk.total; pair += gridDim.x) {
    const int kind = 2 * pair < walk.te2 ? 0 : 1;  // the pair's, so the CTA's
    if (kind != staged) {
      __syncthreads();  // no wgmma reads the previous slab
      const Gru& w = kind ? wn : we;
      const int n = nks * 2 * 2 * 3 * U;  // (ks, mat, kh, column)
#pragma unroll 4
      for (int e = threadIdx.x; e < n; e += kProdThreads) {
        const int nn = e % (3 * U), rest = e / (3 * U);
        const int kh = rest & 1, mat = (rest >> 1) & 1, ks = rest >> 2;
        const float* src = (mat ? w.w_hh : w.w_ih) + (nn / U) * H + u0 + nn % U;
        put_b_row(s_w + (size_t)2 * (2 * ks + mat) * kPart, 3 * U, nn, kh, 8 * ks,
                  [&](int, int k) { return __ldg(src + (int64_t)k * 3 * H); });
      }
      for (int i = threadIdx.x; i < U; i += kProdThreads) {
        const int u = u0 + i;
        bias[i] = w.b_ih[u] + w.b_hh[u];
        bias[U + i] = w.b_ih[H + u] + w.b_hh[H + u];
        bias[2 * U + i] = w.b_ih[2 * H + u];
        bias[3 * U + i] = w.b_hh[2 * H + u];
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      staged = kind;
    }
    const int tile = 2 * pair + wg;
    if (tile >= walk.total) continue;  // the warpgroup's: its wgmmas stay convergent
    const int n_k = kind ? walk.n_d : walk.n_e;
    const int i0 = (kind ? tile - walk.te2 : tile) * kWgRows + 16 * wi + g;
    int slot[2];
    const float *xr[2], *hr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = i0 + 8 * rr;
      slot[rr] = i < n_k ? rows.slot(kind, i) : -1;
      xr[rr] = slot[rr] >= 0 ? xin + (int64_t)slot[rr] * H + 2 * t : nullptr;
      hr[rr] = slot[rr] >= 0 ? h + (int64_t)slot[rr] * H + 2 * t : nullptr;
    }
    float acc[NT][4][4];  // per n tile: r, z, gi_n, gh_n in the m16n8 C layout
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][q][e] = 0.f;
    // x, then h, at rows g and g + 8: columns 2t, 2t + 1 of a k step, a k
    // step ahead
    const auto fetch = [&](int ks, float2 (&v)[4]) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        v[rr] = ld2(xr[rr] ? xr[rr] + 8 * ks : nullptr);
        v[2 + rr] = ld2(hr[rr] ? hr[rr] + 8 * ks : nullptr);
      }
    };
    float2 next[4];
    fetch(0, next);
    for (int ks = 0; ks < nks; ++ks) {
      const FragA ax = frag_a(next[0].x, next[1].x, next[0].y, next[1].y);
      const FragA ah = frag_a(next[2].x, next[3].x, next[2].y, next[3].y);
      if (ks + 1 < nks) fetch(ks + 1, next);
      float dn[DN], dh[DN];  // x w_ih, h w_hh: [r | z | n] of the U units
      wg_hold(dn);
      wg_hold(dh);
      wg_fence();
      const uint64_t ih = desc0 + 4 * ks * kPartD, hh = ih + 2 * kPartD;
      wgmma3<3 * U>(dn, ax, ih, ih + kPartD);  // two commit groups: x's sums are added
      wg_commit();                             // while h's wgmmas run
      wgmma3<3 * U>(dh, ah, hh, hh + kPartD);
      wg_commit();
      wg_wait<1>();
      wg_hold(dn);
      float tr[NT][4], tz[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tr[j][e] = acc[j][0][e] + dn[4 * j + e];
          tz[j][e] = acc[j][1][e] + dn[4 * (NT + j) + e];
          acc[j][2][e] += dn[4 * (2 * NT + j) + e];
        }
      wg_wait<0>();
      wg_hold(dh);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[j][0][e] = tr[j][e] + dh[4 * j + e];
          acc[j][1][e] = tz[j][e] + dh[4 * (NT + j) + e];
          acc[j][3][e] += dh[4 * (2 * NT + j) + e];
        }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int ul = 8 * j + 2 * t, u = u0 + ul;  // U | H: u + 1 < H
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (slot[rr] < 0) continue;
        const int64_t row = slot[rr];
        const float2 hv = ld2(h + row * H + u), gv = ld2(kBwd ? gout + row * H + u : nullptr);
        const float hx[2] = {hv.x, hv.y}, gg[2] = {gv.x, gv.y};
        float o[4][2], dir[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * rr + e;
          const float r = sigmoid_f(acc[j][0][i] + bias[ul + e]);
          const float z = sigmoid_f(acc[j][1][i] + bias[U + ul + e]);
          const float ghn = acc[j][3][i] + bias[3 * U + ul + e];
          const float nn = tanhf((acc[j][2][i] + bias[2 * U + ul + e]) + r * ghn);
          if constexpr (!kBwd) {
            o[0][e] = (1.f - z) * nn + z * hx[e];
          } else {
            const float dz = (hx[e] - nn) * gg[e];
            const float dn = (1.f - z) * gg[e];
            dir[e] = z * gg[e];
            const float da_n = (1.f - nn * nn) * dn;
            o[0][e] = r * (1.f - r) * (da_n * ghn);
            o[1][e] = z * (1.f - z) * dz;
            o[2][e] = da_n;
            o[3][e] = r * da_n;
          }
        }
        if constexpr (!kBwd) {
          *reinterpret_cast<float2*>(out + row * H + u) = make_float2(o[0][0], o[0][1]);
        } else {
          float* d = d4 + row * 4 * H + u;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            *reinterpret_cast<float2*>(d + q * H) = make_float2(o[q][0], o[q][1]);
          *reinterpret_cast<float2*>(ddir + row * H + u) = make_float2(dir[0], dir[1]);
        }
      }
    }
  }
}

// round_bwd_gru's second pass.  Grid (CTAs, H / V), two warpgroups: CTA
// (x, y) owns output columns [y V, y V + V) and stages, for a kind, B over K
// = 3H: columns [0, V) w_ih[y V + n][k], columns [V, 2V) w_hh[y V + n -
// V][k] (read from the untransposed matrices), k step ks at 2 ks kPart
// bytes (big, then small).  Per 64-row tile: d xin = d gi w_ih^T and ddir
// += d gh w_hh^T (d gi = d4[0:3H], d gh = d4[0:2H] | d4[3H:4H]).  Below 2H
// the two share their A, and one wgmma of N = 2V takes both.  A comes in by
// cp.async, kDgxSteps k steps a group, kDgxStages groups in flight in a
// ring of shared memory a warpgroup (the d4 rows' loads, not the products,
// bounded this pass when they came through registers one group ahead).
template <int V>
__global__ void __launch_bounds__(kProdThreads, 1)
round_dgx_kernel(const float* __restrict__ d4, const Gru we, const Gru wn,
                 const int* __restrict__ list, const int* __restrict__ cnt, int nchunks, int CH,
                 int nrows, int H, float* __restrict__ dxin, float* __restrict__ ddir) {
  constexpr int NT = V / 8;
  constexpr int kPart = 2 * V * 32;  // bytes of a k step's B, big or small
  constexpr uint64_t kPartD = kPart >> 4, kHalfD = (V * 32) >> 4;  // the w_hh half
  extern __shared__ float4 smem4[];
  char* s_w = reinterpret_cast<char*>(smem4);
  float* ring = reinterpret_cast<float*>(s_w + slab_bytes(V, H));  // [2 wg][stages][rows][stride]
  int* slot_s = reinterpret_cast<int*>(ring + 2 * kDgxStages * kWgRows * kDgxStride);  // [2][64]
  int* pre = slot_s + 2 * kWgRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, t = lane & 3, tw = threadIdx.x & (kWgThreads - 1);
  const int v0 = blockIdx.y * V, H3 = 3 * H, nks = H3 / 8, nks2 = 2 * H / 8;
  const int ngroups = (nks + kDgxSteps - 1) / kDgxSteps;
  float* my_ring = ring + wg * kDgxStages * kWgRows * kDgxStride;
  int* my_slots = slot_s + wg * kWgRows;
  const auto wg_sync = [&] { asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWgThreads)); };
  scan_counts(cnt, nchunks, pre);
  const Rows rows{list, pre, nchunks, CH, nrows};
  const Walk walk(rows);
  const uint64_t desc0 = wg_desc(s_w, 128, 256);
  // group gi's A into stage gi % kDgxStages: row r, step d, part (0 d gi, 1
  // d gh past 2H), 8 columns, as 16-byte copies; rows without a slot are
  // zero-filled
  const auto issue = [&](int gi) {
    float* buf = my_ring + (gi % kDgxStages) * kWgRows * kDgxStride;
    for (int c = tw; c < kWgRows * kDgxSteps * 4; c += kWgThreads) {
      const int r = c / (kDgxSteps * 4), rem = c % (kDgxSteps * 4);
      const int d = rem >> 2, part = (rem >> 1) & 1, half = rem & 1, ks = gi * kDgxSteps + d;
      if (ks >= nks || (part == 1 && ks < nks2)) continue;
      const int sl = my_slots[r];
      const int col = (part ? H : 0) + 8 * ks + 4 * half;
      cp_async16(buf + r * kDgxStride + d * 16 + part * 8 + 4 * half,
                 sl >= 0 ? d4 + (int64_t)sl * 4 * H + col : d4, sl >= 0);
    }
    cp_async_commit();
  };
  int staged = -1;
  for (int pair = blockIdx.x; 2 * pair < walk.total; pair += gridDim.x) {
    const int kind = 2 * pair < walk.te2 ? 0 : 1;
    if (kind != staged) {
      __syncthreads();
      const Gru& w = kind ? wn : we;
      const int n = nks * 2 * 2 * V;  // (column, ks, kh): a warp reads along a row
#pragma unroll 4
      for (int e = threadIdx.x; e < n; e += kProdThreads) {
        const int nn = e / (2 * nks), rest = e % (2 * nks), kh = rest & 1, ks = rest >> 1;
        const float* src = (nn < V ? w.w_ih : w.w_hh) + (int64_t)(v0 + nn % V) * H3;
        put_b_row(s_w + (size_t)2 * ks * kPart, 2 * V, nn, kh, 8 * ks,
                  [&](int, int k) { return __ldg(src + k); });
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      staged = kind;
    }
    const int tile = 2 * pair + wg;
    if (tile >= walk.total) continue;
    const int n_k = kind ? walk.n_d : walk.n_e;
    const int i0 = (kind ? tile - walk.te2 : tile) * kWgRows + 16 * wi + g;
    int slot[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = i0 + 8 * rr;
      slot[rr] = i < n_k ? rows.slot(kind, i) : -1;
    }
    wg_sync();  // the previous tile's reads of the slots and the ring are done
    if (t == 0) {
      my_slots[16 * wi + g] = slot[0];
      my_slots[16 * wi + g + 8] = slot[1];
    }
    wg_sync();
#pragma unroll
    for (int gi = 0; gi < kDgxStages - 1; ++gi) issue(gi);
    float2 dd[NT][2];  // ddir's direct part, in flight during the products
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        dd[j][rr] = slot[rr] >= 0 ? *reinterpret_cast<const float2*>(
                                        ddir + (int64_t)slot[rr] * H + v0 + 8 * j + 2 * t)
                                  : make_float2(0.f, 0.f);
    float ax[NT * 4], ah[NT * 4];  // d xin, d gh w_hh^T of the V columns
#pragma unroll
    for (int e = 0; e < NT * 4; ++e) ax[e] = ah[e] = 0.f;
    for (int gi = 0; gi < ngroups; ++gi) {
      cp_async_wait<kDgxStages - 2>();
      wg_sync();  // group gi is in, and the stage it frees is read
      issue(gi + kDgxStages - 1);
      const float* buf = my_ring + (gi % kDgxStages) * kWgRows * kDgxStride;
      const float* lo = buf + (16 * wi + g) * kDgxStride + 2 * t;
      const float* hi = lo + 8 * kDgxStride;
      FragA agi[kDgxSteps], agh[kDgxSteps];
#pragma unroll
      for (int d = 0; d < kDgxSteps; ++d) {
        const float2 a0 = *reinterpret_cast<const float2*>(lo + d * 16);
        const float2 a1 = *reinterpret_cast<const float2*>(hi + d * 16);
        agi[d] = frag_a(a0.x, a1.x, a0.y, a1.y);
        if (gi * kDgxSteps + d >= nks2) {
          const float2 b0 = *reinterpret_cast<const float2*>(lo + d * 16 + 8);
          const float2 b1 = *reinterpret_cast<const float2*>(hi + d * 16 + 8);
          agh[d] = frag_a(b0.x, b1.x, b0.y, b1.y);
        } else {
          agh[d] = agi[d];
        }
      }
      // the group's wgmmas (3xTF32) into fresh accumulators, added in f32:
      // pc (N = 2V) for the steps below 2H, px and ph (N = V) for the others
      float pc[2 * NT * 4], px[NT * 4], ph[NT * 4];
      wg_hold(pc);
      wg_hold(px);
      wg_hold(ph);
      wg_fence();
      bool both = false, split = false;
#pragma unroll
      for (int d = 0; d < kDgxSteps; ++d) {
        const int ks = gi * kDgxSteps + d;
        if (ks >= nks) break;
        const uint64_t b = desc0 + 2 * ks * kPartD;
        if (ks < nks2) {
          wgmma_tf32<2 * V>(pc, agi[d].small, b, both);
          wgmma_tf32<2 * V>(pc, agi[d].big, b + kPartD, true);
          wgmma_tf32<2 * V>(pc, agi[d].big, b, true);
          both = true;
        } else {
          wgmma_tf32<V>(px, agi[d].small, b, split);
          wgmma_tf32<V>(px, agi[d].big, b + kPartD, true);
          wgmma_tf32<V>(px, agi[d].big, b, true);
          wgmma_tf32<V>(ph, agh[d].small, b + kHalfD, split);
          wgmma_tf32<V>(ph, agh[d].big, b + kPartD + kHalfD, true);
          wgmma_tf32<V>(ph, agh[d].big, b + kHalfD, true);
          split = true;
        }
      }
      wg_commit();
      wg_wait<0>();
      wg_hold(pc);
      wg_hold(px);
      wg_hold(ph);
      if (both) {
#pragma unroll
        for (int e = 0; e < NT * 4; ++e) {
          ax[e] += pc[e];
          ah[e] += pc[NT * 4 + e];
        }
      }
      if (split) {
#pragma unroll
        for (int e = 0; e < NT * 4; ++e) {
          ax[e] += px[e];
          ah[e] += ph[e];
        }
      }
    }
    cp_async_wait<0>();  // the ring's empty trailing groups
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int v = v0 + 8 * j + 2 * t;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (slot[rr] < 0) continue;
        const int64_t o = (int64_t)slot[rr] * H + v;
        *reinterpret_cast<float2*>(dxin + o) = make_float2(ax[4 * j + 2 * rr], ax[4 * j + 2 * rr + 1]);
        *reinterpret_cast<float2*>(ddir + o) = make_float2(dd[j][rr].x + ah[4 * j + 2 * rr],
                                                           dd[j][rr].y + ah[4 * j + 2 * rr + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------ d W ----
// The S row slices of d W split between the kinds in proportion to their
// rows: the edge kind's are slices [0, S_e), at least one for a kind with
// rows (S >= 2).
__device__ __forceinline__ int edge_slices(int n_e, int n_d, int S) {
  if (n_d == 0) return S;
  if (n_e == 0) return 0;
  const int se = (int)(((int64_t)S * n_e + (n_e + n_d) / 2) / (n_e + n_d));
  return min(max(se, 1), S - 1);
}

// Grid (S, tiles): CTA (x, y) sums slice x of the slices of its kind (x <
// S_e: edge rows, slice x; else detection rows, slice x - S_e), its 64-row
// stages [s per, (s + 1) per) of the kind's rows (per = ceil(stages /
// slices of the kind)), into output tile y of 2 * ceil(H / 64) * ceil(3H /
// 48): matrix m (0: xin^T d gi, 1: h^T d gh), rows [h_base, + 64) of H,
// columns [c_base, + 48) of 3H; one m tile of 16 rows a warp.  Writes its
// entries of the partials row part[x] = [d w_ih | d w_hh | d b_ih | d b_hh];
// the CTAs of h_base 0 also the biases' columns, summed in row order; CTA
// (0, 0) writes S_e after the S rows.
__global__ void __launch_bounds__(kGThreads)
round_dw_kernel(const float* __restrict__ h, const float* __restrict__ xin,
                const float* __restrict__ d4, const int* __restrict__ list,
                const int* __restrict__ cnt, int nchunks, int CH, int nrows, int H, int S,
                float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);  // [2][kDwK][kAStride]
  float* b_s = a_s + 2 * kDwK * kAStride;         // [2][kDwK][kBStride]
  int* slot_s = reinterpret_cast<int*>(b_s + 2 * kDwK * kBStride);  // [2][kDwK]
  int* pre = slot_s + 2 * kDwK;
  scan_counts(cnt, nchunks, pre);
  const Rows rows{list, pre, nchunks, CH, nrows};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int se = edge_slices(rows.total(0), rows.total(1), S);
  const int kind = (int)blockIdx.x < se ? 0 : 1;
  const int slice = kind ? blockIdx.x - se : blockIdx.x, nslices = kind ? S - se : se;
  const int H3 = 3 * H, hb = (H + kDwRows - 1) / kDwRows, cb = (H3 + kDwCols - 1) / kDwCols;
  const int m = blockIdx.y / (hb * cb), rest = blockIdx.y % (hb * cb);
  const int h_base = (rest / cb) * kDwRows, c_base = (rest % cb) * kDwCols;
  const int hcount = min(kDwRows, H - h_base);
  const int n_k = rows.total(kind), nst = (n_k + kDwK - 1) / kDwK;
  const int per = (nst + nslices - 1) / nslices;
  const int first = min(nst, slice * per), last = min(nst, first + per);
  const float* asrc = m ? h : xin;
  const bool bias_cta = h_base == 0;
  const auto stage = [&](int b, int st) {  // st's rows into buffer b
    if (tid < kDwK) {
      const int i = st * kDwK + tid;
      slot_s[b * kDwK + tid] = i < n_k ? rows.slot(kind, i) : -1;
    }
    __syncthreads();
    const int* sl = slot_s + b * kDwK;
    float* a = a_s + b * kDwK * kAStride;
    for (int e = tid; e < kDwK * (kDwRows / 4); e += kGThreads) {
      const int r = e / (kDwRows / 4), p = e % (kDwRows / 4);
      const bool valid = sl[r] >= 0 && 4 * p < hcount;
      cp_async16(a + r * kAStride + 4 * p,
                 valid ? asrc + (int64_t)sl[r] * H + h_base + 4 * p : asrc, valid);
    }
    float* bb = b_s + b * kDwK * kBStride;
    for (int e = tid; e < kDwK * (kDwCols / 4); e += kGThreads) {
      const int r = e / (kDwCols / 4), p = e % (kDwCols / 4);
      const int col = c_base + 4 * p;  // d gh's n block sits at 3H in d4
      const bool valid = sl[r] >= 0 && col < H3;
      const int src = (m == 0 || col < 2 * H) ? col : H + col;
      cp_async16(bb + r * kBStride + 4 * p, valid ? d4 + (int64_t)sl[r] * 4 * H + src : d4, valid);
    }
  };
  float acc[kDwCols / 8][4];
#pragma unroll
  for (int n = 0; n < kDwCols / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float bsum = 0.f;
  const int hl = warp * 16 + g;  // this thread's rows hl, hl + 8 of the tile
  const bool warp_on = warp * 16 < hcount;
  for (int st = first; st <= last; ++st) {  // stage st (if any), then compute st - 1
    const int b = (st - first) & 1;
    if (st < last) stage(b, st);
    cp_async_commit();
    if (st > first) {
      const int pb = b ^ 1;
      cp_async_wait<1>();
      __syncthreads();
      const float* a = a_s + pb * kDwK * kAStride;
      const float* bb = b_s + pb * kDwK * kBStride;
      if (warp_on) {
#pragma unroll 2
        for (int k0 = 0; k0 < kDwK; k0 += 8) {
          const float* a0 = a + (k0 + t) * kAStride + hl;
          const float* a1 = a0 + 4 * kAStride;
          const FragA fa = frag_a(a0[0], a0[8], a1[0], a1[8]);
          const float* b0 = bb + (k0 + t) * kBStride + g;
#pragma unroll
          for (int n = 0; n < kDwCols / 8; ++n)
            mma3(acc[n], fa, frag_b(b0[8 * n], b0[4 * kBStride + 8 * n]));
        }
      }
      if (bias_cta && tid < kDwCols)
        for (int r = 0; r < kDwK; ++r) bsum += bb[r * kBStride + tid];
    }
    __syncthreads();  // the buffer computed on is staged next
  }
  cp_async_wait<0>();
  const int64_t W = 2 * (int64_t)H * H3 + 2 * H3;
  float* prow = part + (int64_t)blockIdx.x * W;
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) reinterpret_cast<int*>(part + S * W)[0] = se;
#pragma unroll
  for (int n = 0; n < kDwCols / 8; ++n) {
    const int col = c_base + 8 * n + 2 * t;
    if (col >= H3) continue;
    if (hl < hcount)
      *reinterpret_cast<float2*>(prow + (int64_t)m * H * H3 + (int64_t)(h_base + hl) * H3 + col) =
          make_float2(acc[n][0], acc[n][1]);
    if (hl + 8 < hcount)
      *reinterpret_cast<float2*>(prow + (int64_t)m * H * H3 + (int64_t)(h_base + hl + 8) * H3 +
                                 col) = make_float2(acc[n][2], acc[n][3]);
  }
  if (bias_cta && tid < kDwCols && c_base + tid < H3)
    prow[2 * (int64_t)H * H3 + m * H3 + c_base + tid] = bsum;
}

size_t dw_smem(int nchunks) {
  return sizeof(float) * 2 * kDwK * (kAStride + kBStride) + sizeof(int) * (2 * kDwK + 2 * (nchunks + 1));
}

// dw[kind][k] = the sum over the kind's slices s, in increasing order, of
// part[s][k] (the edge kind's slices [0, S_e), the detections' [S_e, S),
// S_e after the S rows)
__global__ void round_dw_sum_kernel(const float* __restrict__ part, float* __restrict__ dw, int S,
                                    int64_t W) {
  const int64_t k = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (k >= 2 * W) return;
  const int se = reinterpret_cast<const int*>(part + S * W)[0];
  const int64_t kind = k / W, kk = k - kind * W;
  float acc = 0.f;
  for (int s = kind ? se : 0; s < (kind ? S : se); ++s) acc += part[(int64_t)s * W + kk];
  dw[k] = acc;
}

// ------------------------------------------------------------------ d h ----
// A group of L lanes a row (8 for H <= 32, 16 for H <= 64, 32 above), lane
// s owning the row's float4 columns s, s + L, ... (CPL of them), f64 sums.
// The row's index, CSR offsets and ddir come first; at an edge row its
// endpoints' idx and d xin rows load together (the rows are used only at a
// detection).  The incident entries are staged L at a time: lane s loads
// entry e + s, checks it, loads its edge's idx and forms its coefficient;
// the group then walks them in CSR order, kDhAhead entries' d xin rows
// loaded (their rows broadcast by shuffle) before any is added, the
// entry's coefficient formed only then so that its idx load overlaps the
// first rows'.  The rows of a warp walk side by side: its loops run to the
// longest list among them.  The sums run in the first design's order
// (ddir, d es[past] - d es[fut], the entries in CSR order), so d h is
// bitwise the first design's.
constexpr int kDhAhead = 4;  // divides every L

template <int L, int CPL>
__global__ void __launch_bounds__(kThreads, CPL == 1 ? 4 : 2)
round_bwd_dh_kernel(const int4* __restrict__ idx, const int* __restrict__ inc_ptr,
                    const int* __restrict__ inc_idx, int n_inc, const float4* __restrict__ dxin,
                    const float4* __restrict__ ddir, float4* __restrict__ dh, int cap,
                    int64_t nrows, int H4) {
  const int lane = threadIdx.x & 31, s = lane & (L - 1);
  const int64_t row = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / L;
  const bool live = row < nrows;  // a whole group; the warp stays whole for its shuffles
  const int64_t base = live ? row - row % cap : 0;
  const int r = (int)(row - base);
  const int4* idxb = idx + base;               // the row's window
  const float4* dxb = dxin + base * H4 + s;    // its d xin, at the lane's first column
  const int4 q = live ? idx[row] : make_int4(0, 0, 0, 0);
  const int e0 = live ? inc_ptr[row] : 0, e1 = live ? inc_ptr[row + 1] : 0;
  double acc[CPL][4];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int k = s + c * L;
    const float4 v = live && k < H4 ? ddir[row * H4 + k] : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c][0] = v.x;
    acc[c][1] = v.y;
    acc[c][2] = v.z;
    acc[c][3] = v.w;
  }
  if (kind_of(q) == 1) {  // through es: an edge row gets d es of its endpoints
    check_row(q.x, cap);  // (d xin at a detection; es is used nowhere else)
    check_row(q.y, cap);
    const int4 qa = idxb[q.x], qb = idxb[q.y];
    float4 va[CPL], vb[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (s + c * L < H4) {
        va[c] = dxb[q.x * H4 + c * L];
        vb[c] = dxb[q.y * H4 + c * L];
      }
    }
    if (kind_of(qa) == 2) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        acc[c][0] += va[c].x;
        acc[c][1] += va[c].y;
        acc[c][2] += va[c].z;
        acc[c][3] += va[c].w;
      }
    }
    if (kind_of(qb) == 2) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        acc[c][0] -= vb[c].x;
        acc[c][1] -= vb[c].y;
        acc[c][2] -= vb[c].z;
        acc[c][3] -= vb[c].w;
      }
    }
  }
  // through ns: every row gets the signed d ns of its incident edges.  The
  // stages and chunks run to the longest list of the warp's rows, so that
  // the rows of a warp walk side by side (a loop of each group's own length
  // would run them one after another)
  if (e0 < 0 || e1 < e0 || e1 > n_inc) __trap();
  int stages = e1 - e0;
#pragma unroll
  for (int off = 16; off >= L; off >>= 1) stages = max(stages, __shfl_xor_sync(kFull, stages, off));
  for (int e = 0; e < stages; e += L) {
    const int n = min(L, e1 - e0 - e);  // this row's entries of the stage (may be <= 0)
    int kk = 0;
    int4 qk = make_int4(0, 0, 0, 0);
    if (s < n) {
      kk = inc_idx[e0 + e + s];
      check_row(kk, cap);
      qk = idxb[kk];
    }
    const int width = min(L, stages - e);
    for (int u0 = 0; u0 < width; u0 += kDhAhead) {
      float4 v[kDhAhead][CPL];
#pragma unroll
      for (int u = 0; u < kDhAhead; ++u) {
        const int ku = __shfl_sync(kFull, kk, u0 + u, L);
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          if (u0 + u < n && s + c * L < H4) v[u][c] = dxb[ku * H4 + c * L];
      }
      // the staged edge's coefficient, formed where it is first needed so
      // that its idx load overlaps the first rows' loads
      const int coef = kind_of(qk) == 1 ? (qk.x == r) - (qk.y == r) : 0;
#pragma unroll
      for (int u = 0; u < kDhAhead; ++u) {
        const int cu = __shfl_sync(kFull, coef, u0 + u, L);
        if (u0 + u < n && cu != 0) {
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            acc[c][0] += cu * (double)v[u][c].x;
            acc[c][1] += cu * (double)v[u][c].y;
            acc[c][2] += cu * (double)v[u][c].z;
            acc[c][3] += cu * (double)v[u][c].w;
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int k = s + c * L;
    if (live && k < H4)
      dh[row * H4 + k] = make_float4((float)acc[c][0], (float)acc[c][1], (float)acc[c][2],
                                     (float)acc[c][3]);
  }
}

// ----------------------------------------------------------------- host ----
Gru gru(const void* w_ih, const void* w_hh, const void* b_ih, const void* b_hh) {
  return Gru{(const float*)w_ih, (const float*)w_hh, (const float*)b_ih, (const float*)b_hh};
}

bool width_ok(int H) { return H >= 8 && H <= 256 && H % 8 == 0; }

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// Opts `kernel` in to `smem` bytes of shared memory and returns how many of
// its CTAs of `threads` fill the card (at least 1) in *ctas
template <class K>
cudaError_t resident(K kernel, int threads, size_t smem, int* ctas) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  *ctas = sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

template <int MODE>
cudaError_t prep(const void* idx, const void* h, const void* inc_ptr, const void* inc_idx,
                 int n_inc, void* xin, void* out, void* d4, void* dxin, void* ddir, void* rows,
                 int nrows, int cap, int H, cudaStream_t s) {
  const int nc = n_chunks(nrows), ch = chunk_rows(nrows);
  const int parts = MODE == kPrepLists ? 1
                    : (int)(((int64_t)ch * (H / 4) + kPrepThreads - 1) / kPrepThreads);
  int* list = (int*)rows;
  round_prep_kernel<MODE><<<dim3(nc, parts), kPrepThreads, 0, s>>>(
      (const int4*)idx, (const float*)h, (const int*)inc_ptr, (const int*)inc_idx, n_inc,
      (float*)xin, (float*)out, (float*)d4, (float*)dxin, (float*)ddir, list, list + 2 * (int64_t)nrows,
      nrows, cap, H, chunk_rows(nrows));
  return cudaGetLastError();
}

// the product kernels' grid: enough CTA columns of H / U to fill the card,
// at most one a possible pair of tiles
dim3 prod_grid(int ctas, int nrows, int H, int U) {
  const int ncol = H / U, pairs = ((nrows + kWgRows - 1) / kWgRows + 2) / 2 + 1;
  return dim3((unsigned)max(1, min(pairs, ctas / ncol)), (unsigned)ncol);
}

template <int U>
int fwd(const void* h, const void* idx, const void* inc_ptr, const void* inc_idx, int n_inc,
        Gru we, Gru wn, void* out, void* xin, void* rows, int nrows, int cap, int H,
        cudaStream_t s) {
  const int nc = n_chunks(nrows);
  const size_t smem = prod_smem(U, H, nc);
  int ctas = 0;
  cudaError_t err = resident(round_gru_kernel<U, false>, kProdThreads, smem, &ctas);
  if (err == cudaSuccess)
    err = prep<kPrepFwd>(idx, h, inc_ptr, inc_idx, n_inc, xin, out, nullptr, nullptr, nullptr,
                         rows, nrows, cap, H, s);
  if (err != cudaSuccess) return (int)err;
  const int* list = (const int*)rows;
  round_gru_kernel<U, false><<<prod_grid(ctas, nrows, H, U), kProdThreads, smem, s>>>(
      (const float*)h, (const float*)xin, nullptr, we, wn, list, list + 2 * (int64_t)nrows, nc,
      chunk_rows(nrows), nrows, H, (float*)out, nullptr, nullptr);
  return (int)cudaGetLastError();
}

template <int V>
int dgx(const void* d4, Gru we, Gru wn, void* dxin, void* ddir, const void* rows, int nrows,
        int H, cudaStream_t s) {
  const int nc = n_chunks(nrows);
  const size_t smem = dgx_smem(V, H, nc);
  int ctas = 0;
  cudaError_t err = resident(round_dgx_kernel<V>, kProdThreads, smem, &ctas);
  if (err != cudaSuccess) return (int)err;
  const int* list = (const int*)rows;
  round_dgx_kernel<V><<<prod_grid(ctas, nrows, H, V), kProdThreads, smem, s>>>(
      (const float*)d4, we, wn, list, list + 2 * (int64_t)nrows, nc, chunk_rows(nrows), nrows, H,
      (float*)dxin, (float*)ddir);
  return (int)cudaGetLastError();
}

template <int U>
int bwd_gru(const void* h, const void* idx, const void* xin, const void* g, Gru we, Gru wn,
            void* d4, void* dxin, void* ddir, void* rows, int nrows, int cap, int H,
            cudaStream_t s) {
  const int nc = n_chunks(nrows);
  const size_t smem = prod_smem(U, H, nc);
  int ctas = 0;
  cudaError_t err = resident(round_gru_kernel<U, true>, kProdThreads, smem, &ctas);
  if (err == cudaSuccess)
    err = prep<kPrepBwd>(idx, nullptr, nullptr, nullptr, 0, nullptr, nullptr, d4, dxin, ddir,
                         rows, nrows, cap, H, s);
  if (err != cudaSuccess) return (int)err;
  const int* list = (const int*)rows;
  round_gru_kernel<U, true><<<prod_grid(ctas, nrows, H, U), kProdThreads, smem, s>>>(
      (const float*)h, (const float*)xin, (const float*)g, we, wn, list, list + 2 * (int64_t)nrows,
      nc, chunk_rows(nrows), nrows, H, nullptr, (float*)d4, (float*)ddir);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  switch (dgx_units(H)) {
    case 32: return dgx<32>(d4, we, wn, dxin, ddir, rows, nrows, H, s);
    case 16: return dgx<16>(d4, we, wn, dxin, ddir, rows, nrows, H, s);
    default: return dgx<8>(d4, we, wn, dxin, ddir, rows, nrows, H, s);
  }
}

// CALL names the unit count kU of width H
#define TM_ROUND_UNITS(H, CALL)                                     \
  switch (gru_units(H)) {                                           \
    case 32: { constexpr int kU = 32; return CALL; }                \
    case 16: { constexpr int kU = 16; return CALL; }                \
    default: { constexpr int kU = 8; return CALL; }                 \
  }

}  // namespace

// The ints of the rows scratch a launch over nrows flat rows needs: the
// per-kind lists [2][nrows] and the chunks' counts [nchunks][2].
extern "C" int tm_round_rows_ints(int nrows) { return 2 * nrows + 2 * n_chunks(nrows); }

// h f32[B, cap, H]; idx int32[B, cap, 4]; inc_ptr int32[B*cap + 1];
// inc_idx int32[n_inc]; we / wn: w_ih, w_hh f32[H, 3H], b_ih, b_hh f32[3H];
// out, xin f32[B, cap, H], every element written; rows: the scratch
// tm_round_rows_ints(B*cap) asks for.  H a multiple of 8 from 8 to 256; h,
// out, xin 16-byte aligned.
extern "C" int tm_round_fwd(const void* h, const void* idx, const void* inc_ptr,
                            const void* inc_idx, int n_inc, const void* we_ih, const void* we_hh,
                            const void* we_bih, const void* we_bhh, const void* wn_ih,
                            const void* wn_hh, const void* wn_bih, const void* wn_bhh, void* out,
                            void* xin, void* rows, int B, int cap, int H, void* stream) {
  if (!width_ok(H)) return (int)cudaErrorInvalidValue;
  if (B == 0 || cap == 0) return (int)cudaSuccess;
  const Gru we = gru(we_ih, we_hh, we_bih, we_bhh), wn = gru(wn_ih, wn_hh, wn_bih, wn_bhh);
  const cudaStream_t s = (cudaStream_t)stream;
  TM_ROUND_UNITS(H, fwd<kU>(h, idx, inc_ptr, inc_idx, n_inc, we, wn, out, xin, rows, B * cap,
                            cap, H, s));
}

// Inputs as tm_round_fwd plus xin (its output) and g, the cotangent of out
// (f32[B, cap, H]).  Writes d4 f32[B, cap, 4H], dxin and ddir f32[B, cap,
// H], every element.
extern "C" int tm_round_bwd_gru(const void* h, const void* idx, const void* xin, const void* g,
                                const void* we_ih, const void* we_hh, const void* we_bih,
                                const void* we_bhh, const void* wn_ih, const void* wn_hh,
                                const void* wn_bih, const void* wn_bhh, void* d4, void* dxin,
                                void* ddir, void* rows, int B, int cap, int H, void* stream) {
  if (!width_ok(H)) return (int)cudaErrorInvalidValue;
  if (B == 0 || cap == 0) return (int)cudaSuccess;
  const Gru we = gru(we_ih, we_hh, we_bih, we_bhh), wn = gru(wn_ih, wn_hh, wn_bih, wn_bhh);
  const cudaStream_t s = (cudaStream_t)stream;
  TM_ROUND_UNITS(H, bwd_gru<kU>(h, idx, xin, g, we, wn, d4, dxin, ddir, rows, B * cap, cap, H, s));
}

// The row slices of round_bwd_dw over nrows flat rows at width H on this
// device (one wave of resident CTAs, at least 2: the kinds share them in
// proportion to their rows); its partials scratch is f32[slices * (2*H*3H
// + 2*3H) + 1].  A negative value is minus a CUDA error.
extern "C" int tm_round_dw_slices(int nrows, int H) {
  if (!width_ok(H)) return -(int)cudaErrorInvalidValue;
  int ctas = 0;
  const cudaError_t err = resident(round_dw_kernel, kGThreads, dw_smem(n_chunks(nrows)), &ctas);
  if (err != cudaSuccess) return -(int)err;
  const int tiles = 2 * ((H + kDwRows - 1) / kDwRows) * ((3 * H + kDwCols - 1) / kDwCols);
  const int most = max(2, (nrows + kDwK - 1) / kDwK);
  return max(2, min(most, ctas / tiles));
}

// h, xin f32[nrows, H]; idx int32[nrows, 4]; d4 f32[nrows, 4H]; rows as
// tm_round_fwd; part the partials for `slices` (>= 2) from tm_round_dw_slices;
// dw f32[2, 2*H*3H + 2*3H] = per kind (edge, detection) [d w_ih | d w_hh |
// d b_ih | d b_hh].
extern "C" int tm_round_bwd_dw(const void* h, const void* idx, const void* xin, const void* d4,
                               void* rows, void* part, void* dw, int nrows, int H, int slices,
                               void* stream) {
  if (!width_ok(H) || slices < 2) return (int)cudaErrorInvalidValue;
  if (nrows == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nc = n_chunks(nrows);
  const size_t smem = dw_smem(nc);
  int ctas = 0;
  cudaError_t err = resident(round_dw_kernel, kGThreads, smem, &ctas);
  if (err == cudaSuccess)
    err = prep<kPrepLists>(idx, nullptr, nullptr, nullptr, 0, nullptr, nullptr, nullptr, nullptr,
                           nullptr, rows, nrows, 1, H, s);
  if (err != cudaSuccess) return (int)err;
  const int* list = (const int*)rows;
  const int tiles = 2 * ((H + kDwRows - 1) / kDwRows) * ((3 * H + kDwCols - 1) / kDwCols);
  round_dw_kernel<<<dim3(slices, tiles), kGThreads, smem, s>>>(
      (const float*)h, (const float*)xin, (const float*)d4, list, list + 2 * (int64_t)nrows, nc,
      chunk_rows(nrows), nrows, H, slices, (float*)part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int64_t W = 2 * (int64_t)H * 3 * H + 2 * 3 * H;
  round_dw_sum_kernel<<<(unsigned)((2 * W + 255) / 256), 256, 0, s>>>((const float*)part,
                                                                       (float*)dw, slices, W);
  return (int)cudaGetLastError();
}

// idx, inc_ptr, inc_idx as tm_round_fwd; dxin, ddir from tm_round_bwd_gru;
// dh f32[B, cap, H], every element written; dxin, ddir and dh 16-byte
// aligned.
extern "C" int tm_round_bwd_dh(const void* idx, const void* inc_ptr, const void* inc_idx,
                               int n_inc, const void* dxin, const void* ddir, void* dh, int B,
                               int cap, int H, void* stream) {
  if (!width_ok(H)) return (int)cudaErrorInvalidValue;
  if (B == 0 || cap == 0) return (int)cudaSuccess;
  const int64_t nrows = (int64_t)B * cap;
  const cudaStream_t s = (cudaStream_t)stream;
  const auto launch = [&](auto kernel, int L) {
    const int rows_per_cta = kThreads / L;
    const unsigned grid = (unsigned)((nrows + rows_per_cta - 1) / rows_per_cta);
    kernel<<<grid, kThreads, 0, s>>>((const int4*)idx, (const int*)inc_ptr, (const int*)inc_idx,
                                     n_inc, (const float4*)dxin, (const float4*)ddir,
                                     (float4*)dh, cap, nrows, H / 4);
    return (int)cudaGetLastError();
  };
  if (H <= 32) return launch(round_bwd_dh_kernel<8, 1>, 8);
  if (H <= 64) return launch(round_bwd_dh_kernel<16, 1>, 16);
  if (H <= 128) return launch(round_bwd_dh_kernel<32, 1>, 32);
  return launch(round_bwd_dh_kernel<32, 2>, 32);
}
