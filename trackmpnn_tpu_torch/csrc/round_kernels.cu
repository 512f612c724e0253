// Hopper (sm_90a) kernels for the fused 'diff' FactorGraphGRU round of the
// packed row layout.  Built by trackmpnn_tpu_torch/ops/_build.py into a
// shared library with a plain C interface and called through ctypes from
// ops/round.py, which checks device, dtype, shape, contiguity and alignment
// before any pointer gets here.  All math is f32 except the incident sums,
// which add in f64 and round to f32 once; no kernel uses atomics, so every
// result is the same from run to run whatever order the blocks run in.
//
// Layout: h f32[B, cap, H]; idx int32[B, cap, 4] = (past, fut,
// is_live_edge, is_live_det), indices local to the window, read as one
// int4 a row.  A row flagged is_live_det is a detection, a row flagged
// is_live_edge and not is_live_det an edge, any other row dead.  The CSR
// incidence (inc_ptr int32[B*cap + 1] over flat rows, inc_idx int32[n] of
// window-local edge rows) lists each row's incident edges; a kernel skips
// the listed rows the step's idx does not flag as edges.  The GRU weights
// keep the JAX layout: w_ih, w_hh f32[H, 3H], column blocks r | z | n.
//
// The TPU kernels keep a whole window [cap, H] in VMEM and carry the
// incident sums es across a sequential grid (pallas_round.py:87-104).
// Neither fits this card: a window's rows do not fit one SM's shared
// memory, and blocks run in no order.  So each output row is computed by
// one CTA from global memory (L2), and every sum over rows is either a
// gather over a fixed list (the incidence) or per-chunk partials summed in
// chunk order by a second launch.
//
// round_fwd
//   Replaces _fwd_a_kernel (pallas_round.py:79) and _fwd_b_kernel (:127).
//   One CTA per tile of TR = 8 * 256 / H rows of a window.  The tile's rows
//   split by kind into two lists (a block-wide ballot, increasing order);
//   for each list the CTA stages x (ns = h[past] - h[fut] for an edge, es =
//   the signed incident sum for a detection, through the incidence) and h
//   into shared memory, then runs that kind's GRU: thread (j, g) keeps the
//   six gate sums of column j for its 8 rows in registers, x and h come as
//   shared-memory broadcasts, the weights through the read-only cache
//   (96 KB a GRU, coalesced across j).  Only live edge rows run the edge
//   GRU and only detections the node GRU; the TPU runs both on every row
//   and selects (:114-147).  Writes out and xin = x (the one residual the
//   backward needs; the JAX VJP saves eight, :201); dead rows get 0.
//   Bound: f32 operations, 2 [H, 3H] products a live row (~50 flop a byte
//   of the row's h, x and out at H = 64, above the card's 20).
//
// round_bwd_gru
//   Replaces the GRU half of _bwd_b_kernel (:225-256).  The same tiling:
//   recomputes the gates from xin and h, then d4 = [d r | d z | d n | r d n]
//   (the gate gradients; d gi = d4[0:3H], d gh = d4[0:2H] | d4[3H:4H]),
//   dxin = d gi w_ih^T (d ns at an edge row, d es at a detection) and ddir =
//   z g + d gh w_hh^T.  A first small launch transposes the four weight
//   matrices into scratch [3H, H], so that the transposed products also
//   read coalesced across j.  Bound: f32 operations, 4 [H, 3H] products a
//   live row.
//
// round_bwd_dw
//   Replaces the weight-gradient accumulators of _bwd_b_kernel (:258-265),
//   which the TPU carries across its sequential grid.  Grid (chunk of
//   kDwChunk flat rows, kind, m): thread c owns column c of d w_ih (m = 0,
//   from xin) or d w_hh (m = 1, from h) and of its bias, its H sums in
//   registers; rows come into shared memory kDwBatch at a time, rows of the
//   other kind or dead as zeros (a batch with none of its kind is skipped).
//   Each CTA writes its half of its chunk's partials; a second launch sums
//   them over the chunks in chunk order.  Bound: f32 operations, 2 [H, 3H]
//   products a live row.
//
// round_bwd_dh
//   Replaces _bwd_a_kernel (:268-299).  One thread per (row, column):
//   d h = ddir + (at an edge row) d es[past] - d es[fut] + the signed sum of
//   d ns over the row's incident edges, in f64, rounded once.  Bound: bytes
//   (a gather over the incidence).
//
// An index outside the window (an edge's endpoint, an incidence entry, a
// CSR offset outside inc_idx) traps the kernel: a sticky CUDA error that
// the next synchronisation raises.  No kernel synchronises or allocates:
// the caller allocates every output and scratch and every launch goes to
// the stream it is given.  Each entry point returns cudaGetLastError().
// The products run on the CUDA cores, not the tensor cores: a later step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // round_fwd, round_bwd_gru, round_bwd_dh
constexpr int kRowsPerThread = 8;  // rows whose gate sums a thread keeps
constexpr int kDwChunk = 256;      // flat rows of one round_bwd_dw CTA
constexpr int kDwBatch = 16;       // rows round_bwd_dw stages at once

struct Gru {
  const float *w_ih, *w_hh, *b_ih, *b_hh;
};

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// 2 detection, 1 edge, 0 dead
__device__ __forceinline__ int kind_of(int4 q) { return q.w != 0 ? 2 : (q.z != 0 ? 1 : 0); }

template <int H>
struct Tile {
  static constexpr int kRows = (kThreads / H) * kRowsPerThread;
};

__device__ __forceinline__ void check_row(int r, int cap) {
  if ((unsigned)r >= (unsigned)cap) __trap();
}

// The rows r0 + t (t < TR) whose kinds[t] == kind, into list[] in
// increasing order; returns their count.  Every thread of the CTA calls it.
template <int TR>
__device__ int compact(const int* kinds, int kind, int r0, int* list, int* warp_tot) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const bool flag = t < TR && kinds[t] == kind;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_tot[w] = __popc(m);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int k = 0; k < TR / 32; ++k) {
    before += k < w ? warp_tot[k] : 0;
    total += warp_tot[k];
  }
  if (flag) list[before + __popc(m & ((1u << lane) - 1u))] = r0 + t;
  __syncthreads();
  return total;
}

// The tile's kinds into kinds[] (-1 past the window's end); returns whether
// any row is live (a block-wide vote).
template <int TR>
__device__ bool load_kinds(const int4* __restrict__ idx, int64_t base, int r0, int cap,
                           int* kinds) {
  int live = 0;
  for (int t = threadIdx.x; t < TR; t += kThreads) {
    const int k = r0 + t < cap ? kind_of(idx[base + r0 + t]) : -1;
    kinds[t] = k;
    live |= k > 0;
  }
  return __syncthreads_or(live) != 0;
}

// The six gate sums (gi = x w_ih, gh = h w_hh, without biases) of column j
// for rows i0 .. i0 + kRowsPerThread - 1 of the staged tile.
template <int H>
__device__ __forceinline__ void gate_sums(const float* xs, const float* hs, const Gru w, int j,
                                          int i0, float (&a)[6][kRowsPerThread]) {
  constexpr int H3 = 3 * H;
#pragma unroll
  for (int q = 0; q < 6; ++q)
#pragma unroll
    for (int ii = 0; ii < kRowsPerThread; ++ii) a[q][ii] = 0.f;
  for (int k = 0; k < H; k += 4) {
    float wv[6][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* wi = w.w_ih + (k + u) * H3 + j;
      const float* wh = w.w_hh + (k + u) * H3 + j;
      wv[0][u] = __ldg(wi);
      wv[1][u] = __ldg(wi + H);
      wv[2][u] = __ldg(wi + 2 * H);
      wv[3][u] = __ldg(wh);
      wv[4][u] = __ldg(wh + H);
      wv[5][u] = __ldg(wh + 2 * H);
    }
#pragma unroll
    for (int ii = 0; ii < kRowsPerThread; ++ii) {
      const float4 x = *reinterpret_cast<const float4*>(xs + (i0 + ii) * H + k);
      const float4 hv = *reinterpret_cast<const float4*>(hs + (i0 + ii) * H + k);
      const float xv[4] = {x.x, x.y, x.z, x.w}, hh[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[0][ii] = fmaf(xv[u], wv[0][u], a[0][ii]);
        a[1][ii] = fmaf(xv[u], wv[1][u], a[1][ii]);
        a[2][ii] = fmaf(xv[u], wv[2][u], a[2][ii]);
        a[3][ii] = fmaf(hh[u], wv[3][u], a[3][ii]);
        a[4][ii] = fmaf(hh[u], wv[4][u], a[4][ii]);
        a[5][ii] = fmaf(hh[u], wv[5][u], a[5][ii]);
      }
    }
  }
}

// Stages x and h of the listed rows of one kind into xs, hs: x = xb[row]
// (the saved xin) if xb is given, else ns = h[past] - h[fut] for an edge and
// es, the signed sum over the incidence in f64, for a detection.
template <int H>
__device__ void stage_rows(const float* __restrict__ hb, const float* __restrict__ xb,
                           const int4* __restrict__ idxb, const int* __restrict__ inc_ptr_b,
                           const int* __restrict__ inc_idx, int n_inc, const int* list, int n,
                           int kind, int cap, float* xs, float* hs) {
  for (int k = threadIdx.x; k < n * H; k += kThreads) {
    const int i = k / H, c = k % H, r = list[i];
    hs[i * H + c] = hb[(int64_t)r * H + c];
    float x;
    if (xb != nullptr) {
      x = xb[(int64_t)r * H + c];
    } else if (kind == 1) {
      const int4 q = idxb[r];
      check_row(q.x, cap);
      check_row(q.y, cap);
      x = hb[(int64_t)q.x * H + c] - hb[(int64_t)q.y * H + c];
    } else {
      const int e0 = inc_ptr_b[r], e1 = inc_ptr_b[r + 1];
      if (e0 < 0 || e1 < e0 || e1 > n_inc) __trap();
      double acc = 0.0;
      for (int e = e0; e < e1; ++e) {
        const int kk = inc_idx[e];
        check_row(kk, cap);
        const int4 q = idxb[kk];
        if (kind_of(q) != 1) continue;
        const int coef = (q.x == r) - (q.y == r);
        if (coef != 0) acc += coef * (double)hb[(int64_t)kk * H + c];
      }
      x = (float)acc;
    }
    xs[i * H + c] = x;
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads)
    round_fwd_kernel(const float* __restrict__ h, const int4* __restrict__ idx,
                     const int* __restrict__ inc_ptr, const int* __restrict__ inc_idx, int n_inc,
                     Gru we, Gru wn, float* __restrict__ out, float* __restrict__ xin, int cap) {
  constexpr int TR = Tile<H>::kRows;
  __shared__ __align__(16) float xs[TR * H];
  __shared__ __align__(16) float hs[TR * H];
  __shared__ int kinds[TR], list[TR], warp_tot[kThreads / 32];
  const int r0 = blockIdx.x * TR;
  const int64_t base = (int64_t)blockIdx.y * cap;
  const bool live = load_kinds<TR>(idx, base, r0, cap, kinds);
  for (int k = threadIdx.x; k < TR * H; k += kThreads) {
    const int t = k / H;
    if (kinds[t] == 0) {
      out[(base + r0) * H + k] = 0.f;
      xin[(base + r0) * H + k] = 0.f;
    }
  }
  if (!live) return;
  const int j = threadIdx.x % H, i0 = (threadIdx.x / H) * kRowsPerThread;
  for (int kind = 1; kind <= 2; ++kind) {
    const int n = compact<TR>(kinds, kind, r0, list, warp_tot);
    if (n == 0) continue;
    stage_rows<H>(h + base * H, nullptr, idx + base, inc_ptr + base, inc_idx, n_inc, list, n,
                  kind, cap, xs, hs);
    __syncthreads();
    const Gru w = kind == 1 ? we : wn;
    if (i0 < n) {
      float a[6][kRowsPerThread];
      gate_sums<H>(xs, hs, w, j, i0, a);
      const float bir = w.b_ih[j], biz = w.b_ih[H + j], bin = w.b_ih[2 * H + j];
      const float bhr = w.b_hh[j], bhz = w.b_hh[H + j], bhn = w.b_hh[2 * H + j];
#pragma unroll
      for (int ii = 0; ii < kRowsPerThread; ++ii) {
        const int i = i0 + ii;
        if (i >= n) break;
        const float r = sigmoid_f((a[0][ii] + bir) + (a[3][ii] + bhr));
        const float z = sigmoid_f((a[1][ii] + biz) + (a[4][ii] + bhz));
        const float nn = tanhf((a[2][ii] + bin) + r * (a[5][ii] + bhn));
        const int64_t o = (base + list[i]) * H + j;
        out[o] = (1.f - z) * nn + z * hs[i * H + j];
        xin[o] = xs[i * H + j];
      }
    }
    __syncthreads();  // xs, hs and list are restaged for the next kind
  }
}

// wt[m] = transpose of w[m] ([H, 3H] -> [3H, H]) for the four matrices
__global__ void transpose4_kernel(const float* __restrict__ w0, const float* __restrict__ w1,
                                  const float* __restrict__ w2, const float* __restrict__ w3,
                                  float* __restrict__ wt, int H) {
  const int H3 = 3 * H, k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= H * H3) return;
  const float* w = blockIdx.y == 0 ? w0 : blockIdx.y == 1 ? w1 : blockIdx.y == 2 ? w2 : w3;
  const int row = k / H3, col = k % H3;
  wt[(int64_t)blockIdx.y * H * H3 + col * H + row] = w[k];
}

template <int H>
__global__ void __launch_bounds__(kThreads)
    round_bwd_gru_kernel(const float* __restrict__ h, const int4* __restrict__ idx,
                         const float* __restrict__ xin, const float* __restrict__ g, Gru we,
                         Gru wn, const float* __restrict__ wt, float* __restrict__ d4,
                         float* __restrict__ dxin, float* __restrict__ ddir, int cap) {
  constexpr int TR = Tile<H>::kRows, H3 = 3 * H, H4 = 4 * H;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [TR][H]
  float* hs = xs + TR * H;                      // [TR][H]
  float* ds = hs + TR * H;                      // [TR][4H]  d4 of the listed rows
  __shared__ int kinds[TR], list[TR], warp_tot[kThreads / 32];
  const int r0 = blockIdx.x * TR;
  const int64_t base = (int64_t)blockIdx.y * cap;
  const bool live = load_kinds<TR>(idx, base, r0, cap, kinds);
  for (int k = threadIdx.x; k < TR * H; k += kThreads) {
    const int t = k / H;
    if (kinds[t] == 0) {
      dxin[(base + r0) * H + k] = 0.f;
      ddir[(base + r0) * H + k] = 0.f;
    }
  }
  for (int k = threadIdx.x; k < TR * H4; k += kThreads)
    if (kinds[k / H4] == 0) d4[(base + r0) * H4 + k] = 0.f;
  if (!live) return;
  const int j = threadIdx.x % H, i0 = (threadIdx.x / H) * kRowsPerThread;
  for (int kind = 1; kind <= 2; ++kind) {
    const int n = compact<TR>(kinds, kind, r0, list, warp_tot);
    if (n == 0) continue;
    stage_rows<H>(h + base * H, xin + base * H, idx + base, nullptr, nullptr, 0, list, n, kind,
                  cap, xs, hs);
    __syncthreads();
    const Gru w = kind == 1 ? we : wn;
    const float* wt_ih = wt + (kind == 1 ? 0 : 2) * H3 * H;
    const float* wt_hh = wt_ih + H3 * H;
    float direct[kRowsPerThread];
    if (i0 < n) {
      float a[6][kRowsPerThread];
      gate_sums<H>(xs, hs, w, j, i0, a);
      const float bir = w.b_ih[j], biz = w.b_ih[H + j], bin = w.b_ih[2 * H + j];
      const float bhr = w.b_hh[j], bhz = w.b_hh[H + j], bhn = w.b_hh[2 * H + j];
#pragma unroll
      for (int ii = 0; ii < kRowsPerThread; ++ii) {
        const int i = i0 + ii;
        const float gg = i < n ? g[(base + list[i]) * H + j] : 0.f;
        const float r = sigmoid_f((a[0][ii] + bir) + (a[3][ii] + bhr));
        const float z = sigmoid_f((a[1][ii] + biz) + (a[4][ii] + bhz));
        const float ghn = a[5][ii] + bhn;
        const float nn = tanhf((a[2][ii] + bin) + r * ghn);
        const float dz = (hs[i * H + j] - nn) * gg;
        const float dn = (1.f - z) * gg;
        direct[ii] = z * gg;
        const float da_n = (1.f - nn * nn) * dn;
        const float da_z = z * (1.f - z) * dz;
        const float da_r = r * (1.f - r) * (da_n * ghn);
        ds[i * H4 + j] = da_r;
        ds[i * H4 + H + j] = da_z;
        ds[i * H4 + 2 * H + j] = da_n;
        ds[i * H4 + 3 * H + j] = r * da_n;
      }
    }
    __syncthreads();
    if (i0 < n) {
      // dx = d gi w_ih^T, dhh = d gh w_hh^T: column j of the transposes
      float dx[kRowsPerThread], dhh[kRowsPerThread];
#pragma unroll
      for (int ii = 0; ii < kRowsPerThread; ++ii) dx[ii] = dhh[ii] = 0.f;
      for (int c = 0; c < H3; c += 4) {
        float ti[4], th[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          ti[u] = __ldg(wt_ih + (c + u) * H + j);
          th[u] = __ldg(wt_hh + (c + u) * H + j);
        }
        const int gh_off = c < 2 * H ? 0 : H;  // d gh's n block sits at 3H in d4
#pragma unroll
        for (int ii = 0; ii < kRowsPerThread; ++ii) {
          const float* row = ds + (i0 + ii) * H4;
          const float4 di = *reinterpret_cast<const float4*>(row + c);
          const float4 dg = *reinterpret_cast<const float4*>(row + c + gh_off);
          dx[ii] = fmaf(di.x, ti[0], dx[ii]);
          dx[ii] = fmaf(di.y, ti[1], dx[ii]);
          dx[ii] = fmaf(di.z, ti[2], dx[ii]);
          dx[ii] = fmaf(di.w, ti[3], dx[ii]);
          dhh[ii] = fmaf(dg.x, th[0], dhh[ii]);
          dhh[ii] = fmaf(dg.y, th[1], dhh[ii]);
          dhh[ii] = fmaf(dg.z, th[2], dhh[ii]);
          dhh[ii] = fmaf(dg.w, th[3], dhh[ii]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < kRowsPerThread; ++ii) {
        const int i = i0 + ii;
        if (i >= n) break;
        const int64_t o = (base + list[i]) * H + j;
        dxin[o] = dx[ii];
        ddir[o] = direct[ii] + dhh[ii];
      }
    }
    for (int k = threadIdx.x; k < n * H4; k += kThreads)
      d4[(base + list[k / H4]) * H4 + k % H4] = ds[k];
    __syncthreads();  // xs, hs, ds and list are restaged for the next kind
  }
}

template <int H>
__global__ void __launch_bounds__(3 * H)
    round_bwd_dw_kernel(const float* __restrict__ h, const int4* __restrict__ idx,
                        const float* __restrict__ xin, const float* __restrict__ d4,
                        float* __restrict__ part, int nrows) {
  constexpr int H3 = 3 * H, H4 = 4 * H, W = 2 * H * H3 + 2 * H3;
  __shared__ __align__(16) float as[kDwBatch * H];  // xin (m = 0) or h (m = 1) of the batch
  __shared__ float dsb[kDwBatch * H3];              // d gi (m = 0) or d gh (m = 1)
  __shared__ int keep[kDwBatch];
  const int kind = blockIdx.y + 1, m = blockIdx.z, c = threadIdx.x;
  const float* a_src = m == 0 ? xin : h;
  float acc[H], bacc = 0.f;
#pragma unroll
  for (int k = 0; k < H; ++k) acc[k] = 0.f;
  const int row0 = blockIdx.x * kDwChunk, row1 = min(row0 + kDwChunk, nrows);
  for (int rb = row0; rb < row1; rb += kDwBatch) {
    __syncthreads();  // the previous batch is no longer read
    int any = 0;
    for (int i = c; i < kDwBatch; i += blockDim.x) {
      keep[i] = rb + i < row1 && kind_of(idx[rb + i]) == kind;
      any |= keep[i];
    }
    if (!__syncthreads_or(any)) continue;
    for (int k = c; k < kDwBatch * H; k += blockDim.x) {
      const int i = k / H;
      as[k] = keep[i] ? a_src[(int64_t)(rb + i) * H + k % H] : 0.f;
    }
    for (int k = c; k < kDwBatch * H3; k += blockDim.x) {
      const int i = k / H3, col = k % H3;
      const int src = (m == 0 || col < 2 * H) ? col : H + col;  // d gh's n block at 3H
      dsb[k] = keep[i] ? d4[(int64_t)(rb + i) * H4 + src] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < kDwBatch; ++i) {
      const float d = dsb[i * H3 + c];
      bacc += d;
      const float4* a4 = reinterpret_cast<const float4*>(as + i * H);
#pragma unroll
      for (int k4 = 0; k4 < H / 4; ++k4) {
        const float4 a = a4[k4];
        acc[4 * k4] = fmaf(a.x, d, acc[4 * k4]);
        acc[4 * k4 + 1] = fmaf(a.y, d, acc[4 * k4 + 1]);
        acc[4 * k4 + 2] = fmaf(a.z, d, acc[4 * k4 + 2]);
        acc[4 * k4 + 3] = fmaf(a.w, d, acc[4 * k4 + 3]);
      }
    }
  }
  // partials row (chunk, kind): d w_ih [H][3H] | d w_hh [H][3H] | d b_ih | d b_hh;
  // this CTA writes the m half
  float* prow = part + ((int64_t)blockIdx.x * 2 + blockIdx.y) * W;
#pragma unroll
  for (int k = 0; k < H; ++k) prow[m * H * H3 + k * H3 + c] = acc[k];
  prow[2 * H * H3 + m * H3 + c] = bacc;
}

// out[kind][k] = sum over chunks q in increasing order of part[q][kind][k]
__global__ void sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int chunks, int width) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= width) return;
  float acc = 0.f;
  for (int q = 0; q < chunks; ++q) acc += part[(int64_t)q * width + k];
  out[k] = acc;
}

template <int H>
__global__ void __launch_bounds__(kThreads)
    round_bwd_dh_kernel(const int4* __restrict__ idx, const int* __restrict__ inc_ptr,
                        const int* __restrict__ inc_idx, int n_inc,
                        const float* __restrict__ dxin, const float* __restrict__ ddir,
                        float* __restrict__ dh, int cap, int64_t nrows) {
  const int j = threadIdx.x % H;
  const int64_t row = (int64_t)blockIdx.x * (kThreads / H) + threadIdx.x / H;
  if (row >= nrows) return;
  const int64_t base = row - row % cap;
  const int r = (int)(row - base);
  const int4 q = idx[row];
  double acc = ddir[row * H + j];
  if (kind_of(q) == 1) {  // through es: an edge row gets d es of its endpoints
    check_row(q.x, cap);  // (d xin at a detection; es is used nowhere else)
    check_row(q.y, cap);
    if (kind_of(idx[base + q.x]) == 2) acc += dxin[(base + q.x) * H + j];
    if (kind_of(idx[base + q.y]) == 2) acc -= dxin[(base + q.y) * H + j];
  }
  // through ns: every row gets the signed d ns of its incident edges
  const int e0 = inc_ptr[row], e1 = inc_ptr[row + 1];
  if (e0 < 0 || e1 < e0 || e1 > n_inc) __trap();
  for (int e = e0; e < e1; ++e) {
    const int kk = inc_idx[e];
    check_row(kk, cap);
    const int4 qk = idx[base + kk];
    if (kind_of(qk) != 1) continue;
    const int coef = (qk.x == r) - (qk.y == r);
    if (coef != 0) acc += coef * (double)dxin[(base + kk) * H + j];
  }
  dh[row * H + j] = (float)acc;
}

cudaError_t opt_in_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int H>
int fwd(const void* h, const void* idx, const void* inc_ptr, const void* inc_idx, int n_inc,
        Gru we, Gru wn, void* out, void* xin, int B, int cap, cudaStream_t s) {
  constexpr int TR = Tile<H>::kRows;
  const dim3 grid((cap + TR - 1) / TR, B);
  round_fwd_kernel<H><<<grid, kThreads, 0, s>>>(
      (const float*)h, (const int4*)idx, (const int*)inc_ptr, (const int*)inc_idx, n_inc, we, wn,
      (float*)out, (float*)xin, cap);
  return (int)cudaGetLastError();
}

template <int H>
int bwd_gru(const void* h, const void* idx, const void* xin, const void* g, Gru we, Gru wn,
            void* wt, void* d4, void* dxin, void* ddir, int B, int cap, cudaStream_t s) {
  constexpr int TR = Tile<H>::kRows;
  const int n = H * 3 * H;
  transpose4_kernel<<<dim3((n + 255) / 256, 4), 256, 0, s>>>(we.w_ih, we.w_hh, wn.w_ih, wn.w_hh,
                                                             (float*)wt, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)TR * 6 * H * sizeof(float);
  err = opt_in_smem((const void*)round_bwd_gru_kernel<H>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((cap + TR - 1) / TR, B);
  round_bwd_gru_kernel<H><<<grid, kThreads, smem, s>>>(
      (const float*)h, (const int4*)idx, (const float*)xin, (const float*)g, we, wn,
      (const float*)wt, (float*)d4, (float*)dxin, (float*)ddir, cap);
  return (int)cudaGetLastError();
}

template <int H>
int bwd_dw(const void* h, const void* idx, const void* xin, const void* d4, void* part,
           void* dw, int nrows, cudaStream_t s) {
  const int chunks = (nrows + kDwChunk - 1) / kDwChunk;
  round_bwd_dw_kernel<H><<<dim3(chunks, 2, 2), 3 * H, 0, s>>>(
      (const float*)h, (const int4*)idx, (const float*)xin, (const float*)d4, (float*)part,
      nrows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = 2 * (2 * H * 3 * H + 2 * 3 * H);
  sum_partials_kernel<<<(width + 255) / 256, 256, 0, s>>>((const float*)part, (float*)dw, chunks,
                                                          width);
  return (int)cudaGetLastError();
}

template <int H>
int bwd_dh(const void* idx, const void* inc_ptr, const void* inc_idx, int n_inc, const void* dxin,
           const void* ddir, void* dh, int B, int cap, cudaStream_t s) {
  const int64_t nrows = (int64_t)B * cap;
  const int rows_per_cta = kThreads / H;
  round_bwd_dh_kernel<H><<<(unsigned)((nrows + rows_per_cta - 1) / rows_per_cta), kThreads, 0,
                           s>>>((const int4*)idx, (const int*)inc_ptr, (const int*)inc_idx,
                                n_inc, (const float*)dxin, (const float*)ddir, (float*)dh, cap,
                                nrows);
  return (int)cudaGetLastError();
}

Gru gru(const void* w_ih, const void* w_hh, const void* b_ih, const void* b_hh) {
  return Gru{(const float*)w_ih, (const float*)w_hh, (const float*)b_ih, (const float*)b_hh};
}

}  // namespace

// CALL names the width kH: the hidden widths the kernels are compiled for
#define TM_ROUND_DISPATCH(H, CALL)                                   \
  switch (H) {                                                       \
    case 16: { constexpr int kH = 16; return CALL; }                 \
    case 32: { constexpr int kH = 32; return CALL; }                 \
    case 64: { constexpr int kH = 64; return CALL; }                 \
    default: return (int)cudaErrorInvalidValue;                      \
  }

// h f32[B, cap, H]; idx int32[B, cap, 4]; inc_ptr int32[B*cap + 1];
// inc_idx int32[n_inc]; we / wn: w_ih, w_hh f32[H, 3H], b_ih, b_hh f32[3H];
// out, xin f32[B, cap, H], every element written.  H is 16, 32 or 64.
extern "C" int tm_round_fwd(const void* h, const void* idx, const void* inc_ptr,
                            const void* inc_idx, int n_inc, const void* we_ih, const void* we_hh,
                            const void* we_bih, const void* we_bhh, const void* wn_ih,
                            const void* wn_hh, const void* wn_bih, const void* wn_bhh, void* out,
                            void* xin, int B, int cap, int H, void* stream) {
  if (B == 0 || cap == 0) return (int)cudaSuccess;
  const Gru we = gru(we_ih, we_hh, we_bih, we_bhh), wn = gru(wn_ih, wn_hh, wn_bih, wn_bhh);
  const cudaStream_t s = (cudaStream_t)stream;
  TM_ROUND_DISPATCH(H, fwd<kH>(h, idx, inc_ptr, inc_idx, n_inc, we, wn, out, xin, B, cap, s));
}

// Inputs as tm_round_fwd plus xin (its output) and g, the cotangent of out
// (f32[B, cap, H]); wt: scratch f32[4, 3H, H].  Writes d4 f32[B, cap, 4H],
// dxin and ddir f32[B, cap, H], every element.
extern "C" int tm_round_bwd_gru(const void* h, const void* idx, const void* xin, const void* g,
                                const void* we_ih, const void* we_hh, const void* we_bih,
                                const void* we_bhh, const void* wn_ih, const void* wn_hh,
                                const void* wn_bih, const void* wn_bhh, void* wt, void* d4,
                                void* dxin, void* ddir, int B, int cap, int H, void* stream) {
  if (B == 0 || cap == 0) return (int)cudaSuccess;
  const Gru we = gru(we_ih, we_hh, we_bih, we_bhh), wn = gru(wn_ih, wn_hh, wn_bih, wn_bhh);
  const cudaStream_t s = (cudaStream_t)stream;
  TM_ROUND_DISPATCH(H, bwd_gru<kH>(h, idx, xin, g, we, wn, wt, d4, dxin, ddir, B, cap, s));
}

// Chunks of round_bwd_dw over `nrows` flat rows: the partials scratch is
// f32[chunks, 2, 2*H*3H + 2*3H].
extern "C" int tm_round_dw_chunks(int nrows) { return (nrows + kDwChunk - 1) / kDwChunk; }

// h, xin f32[nrows, H]; idx int32[nrows, 4]; d4 f32[nrows, 4H]; part: the
// scratch above; dw f32[2, 2*H*3H + 2*3H] = per kind (edge, detection)
// [d w_ih | d w_hh | d b_ih | d b_hh].
extern "C" int tm_round_bwd_dw(const void* h, const void* idx, const void* xin, const void* d4,
                               void* part, void* dw, int nrows, int H, void* stream) {
  if (nrows == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  TM_ROUND_DISPATCH(H, bwd_dw<kH>(h, idx, xin, d4, part, dw, nrows, s));
}

// idx, inc_ptr, inc_idx as tm_round_fwd; dxin, ddir from tm_round_bwd_gru;
// dh f32[B, cap, H], every element written.
extern "C" int tm_round_bwd_dh(const void* idx, const void* inc_ptr, const void* inc_idx,
                               int n_inc, const void* dxin, const void* ddir, void* dh, int B,
                               int cap, int H, void* stream) {
  if (B == 0 || cap == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  TM_ROUND_DISPATCH(H, bwd_dh<kH>(idx, inc_ptr, inc_idx, n_inc, dxin, ddir, dh, B, cap, s));
}
