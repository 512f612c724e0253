// Hopper (sm_90a) kernels for the fused edge losses of the block train
// step.  Built by trackmpnn_tpu_torch/ops/_build.py into a shared library
// with a plain C interface and called through ctypes from ops/loss.py,
// which checks device, dtype, shape and contiguity before any pointer gets
// here.  All math is f32 (L2's block sums f64); no kernel uses atomics, and
// every sum runs in an order fixed by the shapes, so every result is the
// same from run to run.  The detection-sized glue between the kernels stays
// plain tensor code, as in the JAX package.
//
// The first design ran one CTA a block of P (120 CTAs at the training
// round, P 120, na = nt = 24) and walked each block in series: in L1 a warp
// took 72 cells one after another with one cell's loads in flight, then one
// thread a row; L2 one thread a column, walking it three times; the
// backward one thread a column for d logit, then 192 threads each walking
// all 576 cells of the block with one scalar load and store a step.  At K
// 192 it measured 55.76 / 17.17 / 104.27 us against bounds of 6.05 / 0.26 /
// 21.90 (PERF.md §6): latency, not bytes.  This design spreads a block
// over many CTAs, lists each tile's live cells so that no warp waits on a
// dead one, and keeps many loads in flight.  Its shared memory grows with
// nt, never with na * nt.
//
// edge_loss_l1
//   Replaces _l1_kernel (trackmpnn_tpu/ops/pallas_loss.py:88).  Per block:
//   logits = mask * (h_eo @ w_e + b_e), then per row the earliest positive
//   slot row r_min and the masked max m_r and exp-sum s_r of the logits.
//   Bound: bytes (h_eo, K floats a live cell, is read once and dominates).
//   Design: grid (block, tile of kL1Rows full rows): a tile's cells are one
//   contiguous run of h_eo.  A thread a cell reads the mask and labels,
//   writes the dead cells' logits (0) and lists the live cells in order (a
//   ballot a warp, list_cells).  A live cell takes L lanes (the power of
//   two >= its K / 4 float4s, or K floats where K % 4 != 0, at most 32), so
//   a warp takes 32 / L listed cells a pass and kCells passes at once: lane
//   l sums the cell's float4s l, l + L, ... (fmaf, x y z w), then an xor
//   tree over the L lanes.  The tile's logits and flags stay in shared
//   memory; then a warp a row, lanes over the columns (j = lane, lane + 32,
//   ...), forms r_min exactly, m_r by an xor max and s_r as per-lane sums
//   in column order and an xor tree.  Four rows a tile measured best (two
//   was slower before the live cells were listed, eight and sixteen after).
//
// edge_loss_l2
//   Replaces _l2_kernel (pallas_loss.py:126).  Per block, a warp a column,
//   lanes over the rows (i = lane, lane + 32, ...): the latest positive row
//   max_i (a ballot a 32 rows) and the masked max, then the targets, the
//   latest target row sel_i (a ballot), the exp-sum, and per cell ce_fut,
//   the BCE log-probability, the count and tp / fp / fn, in per-lane sums
//   and xor trees.  The sums run in f64 and round to f32 once (a block's BCE sums
//   up to na*nt terms, whose f32 rounding in another order than the plain
//   version's would reach 1e-5 by itself), the counts in integers.  A CTA
//   takes up to kL2Cols columns and adds them in column order; where nt is
//   wider, each of the block's CTAs writes its f64 sums and
//   l2_sum_tiles_kernel adds them in tile order.  Bound: bytes (logits,
//   labels and mask of the block, read once), a fraction of a us; a chain
//   of two dependent loads, two ballots and four xor trees holds it.
//
// edge_loss_bwd
//   Replaces _lb_kernel (pallas_loss.py:167).  The column statistics
//   (max_i, sel_i, the max and the exp-sum) need every row of a block:
//   edge_loss_cols_kernel forms them once, a warp a column, as L2 does,
//   into a scratch the wrapper allocates.  (Each CTA recomputing them from
//   the block's ~7 KB in L2 cost as much: a warp walked three columns in
//   series.  L2 writing them for the backward would change what the forward
//   saves, which stays the plain version's.)  Then grid (block, tile of
//   kBwdRows rows): first d h_eo = 0 at the dead cells, a warp a cell,
//   while the statistics are still being formed; then d logit, a thread a
//   cell, the cells whose d logit is not 0 listed in order; d h_eo = 0 at
//   the other cells; then thread (g, k) of G = 256 / n groups (n = K / 4
//   float4s, or K floats) writes d h_eo = d logit * w_e for the listed
//   cells g, g + G, ... (kBwdAhead cells' loads in flight) and sums h_eo *
//   d logit over them (where n > 256, one group, thread k taking columns k,
//   k + 256, ...).  Each CTA writes one row of d w_e | d b_e partials [P *
//   tiles, K + 1] (groups added in group order, d b_e from per-thread sums,
//   an xor tree and the warps in order), and sum_rows_kernel adds the rows:
//   warp w of a CTA of 32 the rows w, w + 32, ... in order, then the warps
//   in order (a chain of P * tiles dependent loads in one thread would take
//   longer than the kernel).  The three launches are chained by Hopper's
//   programmatic dependent launch: the next kernel's CTAs start as the
//   previous one's last CTAs run and wait in griddepcontrol.wait for its
//   results (without it each launch boundary cost ~1-1.5 us).  The TPU
//   kernel accumulates d w_e across its sequential grid (:223-231).  Bound:
//   bytes (h_eo read at the live cells, d h_eo written everywhere).
//
// No kernel synchronises or allocates; each entry point returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kBig = 1073741824.f;  // 2^30, larger than any slot row id
constexpr float kEps = 1e-10f;        // losses.EPS
constexpr int kL1Rows = 4;            // rows of a tile (a CTA) of L1
constexpr int kBwdRows = 8;           // and of the backward
constexpr int kTileThreads = 256;     // their CTA
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kCells = 8;             // L1: passes of cells a warp keeps in flight
constexpr int kL2Cols = 32;           // L2: columns a CTA, a warp each
constexpr int kBwdAhead = 4;          // backward: cells a thread loads before it adds
constexpr int kSumThreads = 1024;     // sum_rows_kernel: 32 warps over 32 columns
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

template <bool V4>
struct Vec {
  using T = float4;
};
template <>
struct Vec<false> {
  using T = float;
};

__device__ __forceinline__ float dot_acc(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float dot_acc(float a, float b, float acc) { return fmaf(a, b, acc); }
__device__ __forceinline__ float4 axpy(float4 a, float s, float4 acc) {
  return make_float4(fmaf(a.x, s, acc.x), fmaf(a.y, s, acc.y), fmaf(a.z, s, acc.z),
                     fmaf(a.w, s, acc.w));
}
__device__ __forceinline__ float axpy(float a, float s, float acc) { return fmaf(a, s, acc); }
__device__ __forceinline__ float4 scale(float4 a, float s) {
  return make_float4(s * a.x, s * a.y, s * a.z, s * a.w);
}
__device__ __forceinline__ float scale(float a, float s) { return s * a; }
template <class T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float4 zero_of<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }

// lanes a cell in L1: the power of two >= n, at most 32
__host__ __device__ __forceinline__ int lanes_for(int n) {
  int L = 1;
  while (L < n && L < 32) L <<= 1;
  return L;
}

// slot row of edge (i, j): edge_base + i * blk_nt + j, exact in f32
__device__ __forceinline__ float rowid(float eb, float bnt, int i, int j) {
  return (eb + (float)i * bnt) + (float)j;
}

template <class T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Programmatic dependent launch (Hopper): a kernel launched by launch_after
// may start while the stream's previous kernel finishes; it must call
// pdl_wait() before it reads what that kernel writes.  pdl_trigger() lets
// the next kernel's CTAs be scheduled.
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Lists into `list`, in increasing order, the cells c < ncell of a tile for
// which on(c) holds (on may write what the cell needs on the way) and
// returns their count: per 256 cells a ballot a warp and the warps' counts
// in order.  Every thread of the CTA calls it; it ends in a barrier.
template <class On>
__device__ __forceinline__ int list_cells(int ncell, On on, int* __restrict__ list,
                                          int* __restrict__ wtot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
  for (int c0 = 0; c0 < ncell; c0 += kTileThreads) {
    const int c = c0 + threadIdx.x;
    const bool in = c < ncell && on(c);
    const unsigned bits = __ballot_sync(kFull, in);
    if (lane == 0) wtot[warp] = __popc(bits);
    __syncthreads();
    int before = total, all = 0;
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) {
      before += w < warp ? wtot[w] : 0;
      all += wtot[w];
    }
    if (in) list[before + __popc(bits & ((1u << lane) - 1))] = c;
    total += all;
    __syncthreads();
  }
  return total;
}

// ------------------------------------------------------------------ L1 ----
template <bool V4>
__global__ void __launch_bounds__(kTileThreads)
edge_loss_l1_kernel(const float* __restrict__ heo, const float* __restrict__ we,
                    const float* __restrict__ be, const float* __restrict__ lbl,
                    const float* __restrict__ mask, const float* __restrict__ ebnt,
                    float* __restrict__ logits, float* __restrict__ rmin,
                    float* __restrict__ mr, float* __restrict__ sr, int na, int nt, int K) {
  using T = typename Vec<V4>::T;
  extern __shared__ float lg_s[];                          // [kL1Rows * nt] the tile's logits
  float* m_s = lg_s + kL1Rows * nt;                          // [kL1Rows * nt] its mask
  int* live_s = reinterpret_cast<int*>(m_s + kL1Rows * nt);  // [kL1Rows * nt] its live cells
  unsigned char* fl_s = reinterpret_cast<unsigned char*>(live_s + kL1Rows * nt);  // flags
  __shared__ int wtot_s[kTileWarps];
  const int q = blockIdx.x, i0 = blockIdx.y * kL1Rows;
  const int rows = min(kL1Rows, na - i0), ncell = rows * nt;
  const int64_t cell0 = ((int64_t)q * na + i0) * nt;
  const int n = V4 ? K / 4 : K;
  const int L = lanes_for(n), G = 32 / L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane / L, kl = lane % L;
  const T* h = reinterpret_cast<const T*>(heo);
  const T* w = reinterpret_cast<const T*>(we);
  const float b = be[0];
  // the tile's mask and labels, a thread a cell: flags, the dead cells'
  // logits (0), and the live cells listed in order
  const int nlive = list_cells(
      ncell,
      [&](int c) {
        const float m = mask[cell0 + c];
        m_s[c] = m;
        fl_s[c] = (m > 0.5f ? 1 : 0) | (lbl[cell0 + c] * m > 0.5f ? 2 : 0);
        if (m == 0.f) {
          lg_s[c] = 0.f;
          logits[cell0 + c] = 0.f;
        }
        return m != 0.f;
      },
      live_s, wtot_s);
  // the live cells' logits: a warp takes kCells passes of G cells at once
  for (int c0 = warp * kCells * G; c0 < nlive; c0 += kTileWarps * kCells * G) {
    int c[kCells];
    float acc[kCells];
#pragma unroll
    for (int p = 0; p < kCells; ++p) {
      const int x = c0 + p * G + g;
      c[p] = x < nlive ? live_s[x] : -1;
      acc[p] = 0.f;
    }
    for (int k = kl; k < n; k += L) {
      const T wk = w[k];
      T v[kCells];
#pragma unroll
      for (int p = 0; p < kCells; ++p)
        v[p] = c[p] >= 0 ? h[(cell0 + c[p]) * n + k] : zero_of<T>();
#pragma unroll
      for (int p = 0; p < kCells; ++p)
        if (c[p] >= 0) acc[p] = dot_acc(v[p], wk, acc[p]);
    }
#pragma unroll
    for (int p = 0; p < kCells; ++p) {
      for (int off = L / 2; off > 0; off >>= 1) acc[p] += __shfl_xor_sync(kFull, acc[p], off);
      if (kl == 0 && c[p] >= 0) {
        const float out = (acc[p] + b) * m_s[c[p]];
        lg_s[c[p]] = out;
        logits[cell0 + c[p]] = out;
      }
    }
  }
  __syncthreads();
  // the row statistics, a warp a row
  const float eb = ebnt[2 * (int64_t)q], bnt = ebnt[2 * (int64_t)q + 1];
  for (int r = warp; r < rows; r += kTileWarps) {
    const int i = i0 + r;
    const float* lg = lg_s + r * nt;
    const unsigned char* fl = fl_s + r * nt;
    float rm = kBig, mx = kNeg;
    for (int j = lane; j < nt; j += 32) {
      if (fl[j] & 2) rm = fminf(rm, rowid(eb, bnt, i, j));
      if (fl[j] & 1) mx = fmaxf(mx, lg[j]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      rm = fminf(rm, __shfl_xor_sync(kFull, rm, off));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    }
    const float safe = mx > kNeg / 2 ? mx : 0.f;
    float s = 0.f;
    for (int j = lane; j < nt; j += 32)
      if (fl[j] & 1) s += expf(lg[j] - safe);
    s = warp_sum(s);
    if (lane == 0) {
      const int64_t o = (int64_t)q * na + i;
      rmin[o] = rm;
      mr[o] = mx;
      sr[o] = s;
    }
  }
}

// --------------------------------------------------- column statistics ----
// The targets of column j (pallas_loss.py:111-123), one warp, lanes over the
// rows (i = lane, lane + 32, ...).  Pass A: the latest positive row max_i
// (a ballot a 32 rows) and the masked max; pass B: part_b and the targets
// tpos, the latest target row sel_i (a ballot) and the masked exp-sum
// (per-lane sums in row order, then an xor tree), calling cell(i, x, m,
// tpos, part_b) at each row i < na.  Pass B's loads hit L1: pass A made
// them.
struct Column {
  int max_i, sel_i;
  float safe, s_col;
};

template <class Cell>
__device__ __forceinline__ Column column_stats(const float* __restrict__ logits,
                                               const float* __restrict__ lbl,
                                               const float* __restrict__ mask,
                                               const float* __restrict__ sel1g, float eb,
                                               float bnt, int64_t cell0, int64_t row0, int na,
                                               int nt, int j, int lane, Cell cell) {
  Column c{-1, -1, 0.f, 0.f};
  float mx = kNeg;
  for (int i0 = 0; i0 < na; i0 += 32) {
    const int i = i0 + lane;
    bool pos = false;
    if (i < na) {
      const int64_t e = cell0 + (int64_t)i * nt + j;
      const float m = mask[e];
      pos = lbl[e] * m > 0.5f;
      if (m > 0.5f) mx = fmaxf(mx, logits[e]);
    }
    const unsigned bits = __ballot_sync(kFull, pos);
    if (bits) c.max_i = i0 + 31 - __clz(bits);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  c.safe = mx > kNeg / 2 ? mx : 0.f;
  float s = 0.f;
  for (int i0 = 0; i0 < na; i0 += 32) {
    const int i = i0 + lane;
    bool tpos = false;
    if (i < na) {
      const int64_t e = cell0 + (int64_t)i * nt + j;
      const float m = mask[e], x = logits[e];
      const bool pos = lbl[e] * m > 0.5f;
      const bool part_b = pos && rowid(eb, bnt, i, j) == sel1g[row0 + i];
      tpos = pos && (i == c.max_i || part_b);
      if (m > 0.5f) s += expf(x - c.safe);
      cell(i, x, m, tpos, part_b);
    }
    const unsigned bits = __ballot_sync(kFull, tpos);
    if (bits) c.sel_i = i0 + 31 - __clz(bits);
  }
  c.s_col = warp_sum(s);
  return c;
}

// ------------------------------------------------------------------ L2 ----
__global__ void __launch_bounds__(kL2Cols * 32)
edge_loss_l2_kernel(const float* __restrict__ logits, const float* __restrict__ lbl,
                    const float* __restrict__ mask, const float* __restrict__ ebnt,
                    const float* __restrict__ bna, const float* __restrict__ sel1g,
                    const float* __restrict__ lsedg, const float* __restrict__ sizedg,
                    float* __restrict__ out, double* __restrict__ part, int na, int nt) {
  __shared__ double col_s[kL2Cols][7];  // per-column partials
  pdl_trigger();
  const int q = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cols = min(kL2Cols, nt - (int)blockIdx.y * kL2Cols);
  if (warp < cols) {
    const int j = blockIdx.y * kL2Cols + warp;
    const int64_t row0 = (int64_t)q * na, cell0 = row0 * nt;
    const float eb = ebnt[2 * (int64_t)q], bnt = ebnt[2 * (int64_t)q + 1];
    const float size_col = fmaxf(bna[q], 1.f);
    double ce_fut = 0.0, bce = 0.0, cnt = 0.0;
    int tp = 0, fp = 0, fn = 0;
    const Column c = column_stats(
        logits, lbl, mask, sel1g, eb, bnt, cell0, row0, na, nt, j, lane,
        [&](int i, float x, float m, bool tpos, bool part_b) {
          const bool mb = m > 0.5f;
          if (part_b) ce_fut += (double)((lsedg[row0 + i] - x) / fmaxf(sizedg[row0 + i], 1.f));
          const float sg = sigmoid_f(x);
          if (mb) bce += (double)logf((tpos ? sg : 1.f - sg) + kEps);
          cnt += (double)m;
          const bool pred = sg >= 0.5f && mb;
          tp += pred && tpos;
          fp += pred && !tpos;
          fn += mb && !pred && tpos;
        });
    ce_fut = warp_sum(ce_fut);
    bce = warp_sum(bce);
    cnt = warp_sum(cnt);
    tp = warp_sum(tp);
    fp = warp_sum(fp);
    fn = warp_sum(fn);
    if (lane == 0) {
      double* r = col_s[warp];
      r[0] = 0.0;
      if (c.sel_i >= 0) {  // the selected logit: one cell of the column
        const float sel_logit = logits[cell0 + (int64_t)c.sel_i * nt + j];
        const float lse_col = c.safe + logf(fmaxf(c.s_col, 1e-30f));
        r[0] = (double)((lse_col - sel_logit) / size_col);
      }
      r[1] = ce_fut;
      r[2] = bce;
      r[3] = cnt;
      r[4] = tp;
      r[5] = fp;
      r[6] = fn;
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < 8) {
    double acc = 0.0;
    if (t < 7)
      for (int w = 0; w < cols; ++w) acc += col_s[w][t];
    if (gridDim.y == 1) out[(int64_t)q * 8 + t] = (float)acc;
    else part[((int64_t)q * gridDim.y + blockIdx.y) * 8 + t] = acc;
  }
}

// out[q][t] = the sum over block q's column tiles y, in increasing order,
// of part[q][y][t], rounded once
__global__ void l2_sum_tiles_kernel(const double* __restrict__ part, float* __restrict__ out,
                                    int tiles) {
  pdl_wait();  // the tiles' sums
  const int64_t q = blockIdx.x;
  const int t = threadIdx.x;
  double acc = 0.0;
  if (t < 7)
    for (int y = 0; y < tiles; ++y) acc += part[(q * tiles + y) * 8 + t];
  out[q * 8 + t] = (float)acc;
}

// ------------------------------------------------------------ backward ----
// The column statistics of every block, a warp a column (column_stats):
// cs[q * nt + j] = (the column's max or 0, its exp-sum >= 1e-30, max_i,
// sel_i), the two picks as int bits.
__global__ void __launch_bounds__(kTileThreads)
edge_loss_cols_kernel(const float* __restrict__ logits, const float* __restrict__ lbl,
                      const float* __restrict__ mask, const float* __restrict__ ebnt,
                      const float* __restrict__ sel1g, float4* __restrict__ cs, int na,
                      int nt) {
  pdl_trigger();
  const int q = blockIdx.x, lane = threadIdx.x & 31;
  const int j = blockIdx.y * kTileWarps + (threadIdx.x >> 5);
  if (j >= nt) return;  // a whole warp
  const int64_t row0 = (int64_t)q * na;
  const Column c = column_stats(logits, lbl, mask, sel1g, ebnt[2 * (int64_t)q],
                                ebnt[2 * (int64_t)q + 1], row0 * nt, row0, na, nt, j, lane,
                                [](int, float, float, bool, bool) {});
  if (lane == 0)
    cs[(int64_t)q * nt + j] = make_float4(c.safe, fmaxf(c.s_col, 1e-30f), __int_as_float(c.max_i),
                                         __int_as_float(c.sel_i));
}

template <bool V4>
__global__ void __launch_bounds__(kTileThreads)
edge_loss_bwd_kernel(const float* __restrict__ heo, const float* __restrict__ we,
                     const float* __restrict__ logits, const float* __restrict__ lbl,
                     const float* __restrict__ mask, const float* __restrict__ ebnt,
                     const float* __restrict__ bna, const float* __restrict__ sel1g,
                     const float* __restrict__ lsedg, const float* __restrict__ sizedg,
                     const float* __restrict__ wg, const float* __restrict__ dpart,
                     const float4* __restrict__ cs, float* __restrict__ dheo,
                     float* __restrict__ part, int na, int nt, int K) {
  using T = typename Vec<V4>::T;
  pdl_trigger();
  const int n = V4 ? K / 4 : K;
  const int G = n < kTileThreads ? kTileThreads / n : 1;
  extern __shared__ float4 smem4[];
  float* red_s = reinterpret_cast<float*>(smem4);               // [G][K] (G > 1) or [K]
  float* dl_s = red_s + (G > 1 ? G * K : K);                     // [kBwdRows * nt] d logits
  int* nz_s = reinterpret_cast<int*>(dl_s + kBwdRows * nt);      // cells whose d logit != 0
  unsigned char* zr_s = reinterpret_cast<unsigned char*>(nz_s + kBwdRows * nt);  // live, d logit 0
  __shared__ int wtot_s[kTileWarps];
  __shared__ float wsum_s[kTileWarps];
  const int q = blockIdx.x, tile = blockIdx.y, i0 = tile * kBwdRows;
  const int rows = min(kBwdRows, na - i0), ncell = rows * nt;
  const int64_t row0 = (int64_t)q * na, cell0 = (row0 + i0) * nt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* h = reinterpret_cast<const T*>(heo);
  const T* w = reinterpret_cast<const T*>(we);
  T* dh = reinterpret_cast<T*>(dheo);
  // 0. d h_eo = 0 at the dead cells (mask 0), a warp a cell, before the
  // column statistics are ready: warp w takes the cells w + 8 l, lane l
  // reading one cell's mask
  for (int c0 = 0; c0 < ncell; c0 += kTileThreads) {
    const int cl = c0 + warp + kTileWarps * lane;
    unsigned bits = __ballot_sync(kFull, cl < ncell && mask[cell0 + cl] == 0.f);
    while (bits) {
      const int c = c0 + warp + kTileWarps * (__ffs(bits) - 1);
      bits &= bits - 1;
      for (int k = lane; k < n; k += 32) dh[(cell0 + c) * n + k] = zero_of<T>();
    }
  }
  const float eb = ebnt[2 * (int64_t)q], bnt = ebnt[2 * (int64_t)q + 1];
  const float size_col = fmaxf(bna[q], 1.f);
  const float d_cep = dpart[(int64_t)q * 8], d_cef = dpart[(int64_t)q * 8 + 1];
  const float d_bce = dpart[(int64_t)q * 8 + 2];
  pdl_wait();  // the column statistics
  // 1. d logit, a thread a cell of the tile; the cells whose d logit is not
  // 0 listed in order
  float dsum = 0.f;
  const int nnz = list_cells(
      ncell,
      [&](int c) {
        const int i = i0 + c / nt, j = c % nt;
        const int64_t e = cell0 + c;
        const float m = mask[e], x = logits[e];
        const float4 st = cs[(int64_t)q * nt + j];
        const bool mb = m > 0.5f;
        const bool pos = lbl[e] * m > 0.5f;
        const bool part_b = pos && rowid(eb, bnt, i, j) == sel1g[row0 + i];
        const int max_i = __float_as_int(st.z), sel_i = __float_as_int(st.w);
        const bool tpos = pos && (i == max_i || part_b);
        const bool sel = tpos && i == sel_i;
        const float w_col = (sel_i >= 0 ? 1.f : 0.f) / size_col;
        const float e_col = mb ? expf(x - st.x) : 0.f;
        float dl = d_cep * w_col * (e_col / st.y - (sel ? 1.f : 0.f));
        const float soft_d = mb ? expf(x - lsedg[row0 + i]) : 0.f;
        const float sized = fmaxf(sizedg[row0 + i], 1.f);
        dl = dl + (wg[row0 + i] * soft_d - d_cef * (part_b ? 1.f : 0.f) / sized);
        float dbce = 0.f;
        if (mb) {
          const float sg = sigmoid_f(x);
          const float pt = tpos ? sg : 1.f - sg;
          dbce = (tpos ? 1.f : -1.f) * sg * (1.f - sg) / (pt + kEps);
        }
        dl = dl + d_bce * dbce;
        dl = dl * m;
        dl_s[c] = dl;
        zr_s[c] = m != 0.f && dl == 0.f;
        dsum += dl;
        return dl != 0.f;
      },
      nz_s, wtot_s);
  dsum = warp_sum(dsum);
  if (lane == 0) wsum_s[warp] = dsum;
  // 2. d h_eo = 0 at the live cells whose d logit is 0, h_eo unread
  for (int c = warp; c < ncell; c += kTileWarps)
    if (zr_s[c])
      for (int k = lane; k < n; k += 32) dh[(cell0 + c) * n + k] = zero_of<T>();
  // 3. the others: thread (g, k) owns element k of the listed cells g, g +
  // G, ...: d h_eo = d logit * w_e, and the sum of h_eo * d logit
  T* red = reinterpret_cast<T*>(red_s);
  const int g = G > 1 ? threadIdx.x / n : 0;
  const int kstep = G > 1 ? n : kTileThreads;
  for (int k = G > 1 ? threadIdx.x % n : threadIdx.x; g < G && k < n; k += kstep) {
    const T wk = w[k];
    T acc = zero_of<T>();
    for (int x0 = g; x0 < nnz; x0 += kBwdAhead * G) {
      int c[kBwdAhead];
      T v[kBwdAhead];
#pragma unroll
      for (int u = 0; u < kBwdAhead; ++u) {
        const int x = x0 + u * G;
        c[u] = x < nnz ? nz_s[x] : -1;
        v[u] = c[u] >= 0 ? h[(cell0 + c[u]) * n + k] : zero_of<T>();
      }
#pragma unroll
      for (int u = 0; u < kBwdAhead; ++u) {
        if (c[u] >= 0) {
          const float dl = dl_s[c[u]];
          dh[(cell0 + c[u]) * n + k] = scale(wk, dl);
          acc = axpy(v[u], dl, acc);
        }
      }
    }
    red[g * n + k] = acc;
  }
  __syncthreads();
  float* prow = part + ((int64_t)q * gridDim.y + tile) * (K + 1);
  for (int kk = threadIdx.x; kk < K; kk += kTileThreads) {
    float acc = 0.f;
    for (int gg = 0; gg < G; ++gg) acc += red_s[gg * K + kk];
    prow[kk] = acc;
  }
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int wi = 0; wi < kTileWarps; ++wi) acc += wsum_s[wi];
    prow[K] = acc;
  }
}

// out[k] = the sum of part[r][k] over the rows r: warp w of the CTA adds
// rows w, w + 32, ... in increasing order (four loads ahead) for column
// 32 x + lane, then warp 0 adds the 32 warps' sums in warp order
__global__ void __launch_bounds__(kSumThreads)
sum_rows_kernel(const float* __restrict__ part, float* __restrict__ out, int nrows, int width) {
  __shared__ float s_s[32][33];
  pdl_wait();  // the partials
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (k < width) {
    int r = warp;
    for (; r + 96 < nrows; r += 128) {
      const float v0 = part[(int64_t)r * width + k], v1 = part[(int64_t)(r + 32) * width + k];
      const float v2 = part[(int64_t)(r + 64) * width + k];
      const float v3 = part[(int64_t)(r + 96) * width + k];
      acc += v0;
      acc += v1;
      acc += v2;
      acc += v3;
    }
    for (; r < nrows; r += 32) acc += part[(int64_t)r * width + k];
  }
  s_s[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && k < width) {
    float t = 0.f;
    for (int wi = 0; wi < 32; ++wi) t += s_s[wi][lane];
    out[k] = t;
  }
}

cudaError_t opt_in_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int l1_tiles(int na) { return (na + kL1Rows - 1) / kL1Rows; }
int bwd_tiles(int na) { return (na + kBwdRows - 1) / kBwdRows; }
int col_tiles(int nt) { return (nt + kL2Cols - 1) / kL2Cols; }

// launches kernel(args...) on s as a programmatic dependent launch
template <class... Params, class... Args>
cudaError_t launch_after(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                         cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, (Params)args...);
}

bool vec4(int K, const void* a, const void* b = nullptr) {
  const auto aligned = [](const void* p) { return p == nullptr || ((uintptr_t)p & 15) == 0; };
  return K % 4 == 0 && aligned(a) && aligned(b);
}

}  // namespace

// Column tiles of L2 (a CTA each): where more than one, tm_edge_loss_l2
// needs an f64 scratch of P * tiles * 8.
extern "C" int tm_edge_loss_l2_tiles(int nt) { return col_tiles(nt); }

// Floats of tm_edge_loss_bwd's scratch: the column statistics, 4 a column
// of every block, then the partials, a row of K + 1 a (block, row tile).
extern "C" int tm_edge_loss_bwd_scratch_floats(int P, int na, int nt, int K) {
  return 4 * P * nt + P * bwd_tiles(na) * (K + 1);
}

// h_eo f32[P, na, nt, K]; w_e f32[K]; b_e f32[1]; lbl, mask f32[P, na, nt];
// ebnt f32[P, 2].  Writes logits f32[P, na, nt] and r_min, m_r, s_r
// f32[P, na].  P, na, nt, K > 0; h_eo and w_e are read as float4 where K %
// 4 == 0 and both are 16-byte aligned.
extern "C" int tm_edge_loss_l1(const void* heo, const void* we, const void* be, const void* lbl,
                               const void* mask, const void* ebnt, void* logits, void* rmin,
                               void* mr, void* sr, int P, int na, int nt, int K, void* stream) {
  if (K <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kL1Rows * nt * (3 * sizeof(float) + 1);
  const bool v4 = vec4(K, heo, we);
  const void* kernel = v4 ? (const void*)edge_loss_l1_kernel<true>
                          : (const void*)edge_loss_l1_kernel<false>;
  cudaError_t err = opt_in_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(P, l1_tiles(na));
  const auto launch = [&](auto k) {
    k<<<grid, kTileThreads, smem, (cudaStream_t)stream>>>(
        (const float*)heo, (const float*)we, (const float*)be, (const float*)lbl,
        (const float*)mask, (const float*)ebnt, (float*)logits, (float*)rmin, (float*)mr,
        (float*)sr, na, nt, K);
  };
  if (v4) launch(edge_loss_l1_kernel<true>);
  else launch(edge_loss_l1_kernel<false>);
  return (int)cudaGetLastError();
}

// logits, lbl, mask f32[P, na, nt]; ebnt f32[P, 2]; bna f32[P]; sel1g,
// lsedg, sizedg f32[P, na].  Writes out f32[P, 8]; scratch f64[P *
// tm_edge_loss_l2_tiles(nt) * 8] (unused with one tile).  P, na, nt > 0.
extern "C" int tm_edge_loss_l2(const void* logits, const void* lbl, const void* mask,
                               const void* ebnt, const void* bna, const void* sel1g,
                               const void* lsedg, const void* sizedg, void* out, void* scratch,
                               int P, int na, int nt, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int tiles = col_tiles(nt);
  const int threads = 32 * (nt < kL2Cols ? nt : kL2Cols);
  edge_loss_l2_kernel<<<dim3(P, tiles), threads, 0, s>>>(
      (const float*)logits, (const float*)lbl, (const float*)mask, (const float*)ebnt,
      (const float*)bna, (const float*)sel1g, (const float*)lsedg, (const float*)sizedg,
      (float*)out, (double*)scratch, na, nt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return (int)err;
  return (int)launch_after(l2_sum_tiles_kernel, dim3(P), 8, 0, s, (const double*)scratch,
                          (float*)out, tiles);
}

// Inputs as tm_edge_loss_l2 plus h_eo f32[P, na, nt, K] (any K > 0),
// w_e f32[K], wg f32[P, na] and dpart f32[P, 8] (the cotangent of the
// partials).  Writes d h_eo f32[P, na, nt, K], the scratch
// (tm_edge_loss_bwd_scratch_floats, 16-byte aligned) and dw f32[K + 1] =
// [d w_e | d b_e].  h_eo, w_e and d h_eo are float4 where K % 4 == 0 and
// all three are 16-byte aligned.
extern "C" int tm_edge_loss_bwd(const void* heo, const void* we, const void* logits,
                                const void* lbl, const void* mask, const void* ebnt,
                                const void* bna, const void* sel1g, const void* lsedg,
                                const void* sizedg, const void* wg, const void* dpart,
                                void* dheo, void* scratch, void* dw, int P, int na, int nt,
                                int K, void* stream) {
  if (K <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool v4 = vec4(K, heo, we) && vec4(K, dheo);
  const int n = v4 ? K / 4 : K;
  const int G = n < kTileThreads ? kTileThreads / n : 1;
  const size_t smem =
      (size_t)(G > 1 ? G * K : K) * sizeof(float) + (size_t)kBwdRows * nt * (2 * 4 + 1);
  const auto kernel = v4 ? edge_loss_bwd_kernel<true> : edge_loss_bwd_kernel<false>;
  cudaError_t err = opt_in_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  float4* cs = (float4*)scratch;
  float* part = (float*)scratch + 4 * (int64_t)P * nt;
  edge_loss_cols_kernel<<<dim3(P, (nt + kTileWarps - 1) / kTileWarps), kTileThreads, 0, s>>>(
      (const float*)logits, (const float*)lbl, (const float*)mask, (const float*)ebnt,
      (const float*)sel1g, cs, na, nt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int tiles = bwd_tiles(na);
  err = launch_after(kernel, dim3(P, tiles), kTileThreads, smem, s, (const float*)heo,
                     (const float*)we, (const float*)logits, (const float*)lbl,
                     (const float*)mask, (const float*)ebnt, (const float*)bna,
                     (const float*)sel1g, (const float*)lsedg, (const float*)sizedg,
                     (const float*)wg, (const float*)dpart, (const float4*)cs, (float*)dheo,
                     part, na, nt, K);
  if (err != cudaSuccess) return (int)err;
  err = launch_after(sum_rows_kernel, dim3((K + 1 + 31) / 32), kSumThreads, 0, s,
                     (const float*)part, (float*)dw, P * tiles, K + 1);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
