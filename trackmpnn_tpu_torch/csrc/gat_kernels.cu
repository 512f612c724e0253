// Hopper (sm_90a) kernels for the GAT attention heads of the block train
// step.  Built by trackmpnn_tpu_torch/ops/_build.py into a shared library
// with a plain C interface and called through ctypes from ops/gat.py, which
// checks device, dtype, shape and contiguity before any pointer gets here.
// All math is f32; no kernel uses atomics, so every result is the same from
// run to run whatever order the blocks run in.
//
// Layout: P blocks (edge rectangles) of na x nt cells; nh attention heads
// of width H.  Per-head detection projections arrive with the heads side by
// side on the feature axis (ha [P, na, nh*H], hn [P, nt, nh*H]); scores and
// softmax statistics are head-leading ([nh, P, ...]); the edge hiddens h_e
// [P, na, nt, H] are shared by the heads.  m3 [P, na, nt] is the 0/1 cell
// mask.
//
// gat_scores_fwd
//   Replaces _mh_stats_fwd_kernel / gat_scores_stats_mh in
//   trackmpnn_tpu/ops/pallas_gat.py.  Per head h and block:
//     e    = leaky(sum_k |ha[i, hH+k] - hn[j, hH+k]| * a[hH+k] * m3)
//     e_m  = m3 > 0 ? e : -1e30;  rmax / cmax = row / column max of e_m
//     sa_l = sum_j m3 * exp(e_m - rmax),  sb_l = sum_i m3 * exp(e_m - cmax)
//   Bound: f32 operations (3 a cell and hidden unit against 4 B a cell
//   written).  One CTA per (block, head) holds the head's ha / hn rows in
//   shared memory (rows padded to H + 1 floats, so that neighbouring cells'
//   hn rows fall in different banks), one thread per cell forms |diff| . a
//   without writing |diff| anywhere, then one thread per row and per column
//   takes the max and the exp-sum in a fixed order.  Masked cells skip the
//   product (their score is 0).
//
// gat_scores_bwd
//   Replaces _mh_stats_bwd_kernel (the custom VJP of gat_scores_stats_mh).
//   Recomputes e, rmax and cmax; the max carries no gradient (the caller
//   stops it, as JAX's softmax does), so
//     de   = ge + gsal * m3 * exp(e_m - rmax) + gsbl * m3 * exp(e_m - cmax)
//     dpre = de * (pre >= 0 ? 1 : alpha) * m3
//     d ha[i, k] = sum_j dpre * sign(d) * a[k],  d hn[j, k] = -sum_i ...,
//     d a[k] = sum over every cell of |d| * dpre,  d = ha[i, k] - hn[j, k]
//   with sign(0) = 0 (jnp.sign, not copysign: padded rows of ha and hn are
//   equal).  Bound: f32 operations.  Each CTA writes its block's d a as a
//   row of partials, summed over the blocks in block order by a second
//   small kernel, where the TPU accumulated across its sequential grid.
//
// gat_aggregate_fwd
//   Replaces _mh_agg_fwd_kernel / gat_aggregate_mh.  Per head
//     att_a = m3 * exp(e - m_row) / max(z_row, 1e-30) * ka / keep
//     att_n = m3 * exp(e - m_col) / max(z_col, 1e-30) * kn / keep
//   (the keep masks are read only when keep < 1; a mask with one head
//   broadcasts), and
//     rs[i] = sum_h sum_j att_a * h_e[i, j],  cs[j] = sum_h sum_i att_n * h_e[i, j].
//   Bound: device-memory bytes (h_e read once dominates).  Grid (block, 2):
//   one CTA forms the head-summed row weights in shared memory and writes
//   rs, the other the column weights and cs; threads run over (row, hidden
//   unit), so each warp reads 128 contiguous bytes of h_e a cell.  Masked
//   cells weigh exactly 0, so a row whose cells are all masked gives 0.
//
// gat_aggregate_bwd
//   Replaces _mh_agg_bwd_kernel together with the datt contraction that the
//   TPU ran as an XLA einsum outside its kernel (pallas_gat.py:398-405):
//     datt_a = <g_rs[i], h_e[i, j]>,  datt_n = <g_cs[j], h_e[i, j]>   (one warp a cell)
//     de     = datt_a * att_a + datt_n * att_n                         (per head)
//     d m_row = -sum_j datt_a * att_a,  d z_row = d m_row / max(z_row, 1e-30)
//     d m_col, d z_col likewise over i
//     d h_e  = sum_h att_a * g_rs[i] + att_n * g_cs[j]
//   Bound: device-memory bytes (h_e read and d h_e written).  One CTA per
//   block keeps every head's attention weights of the block in shared
//   memory.
//
// gat1_scores_fwd / gat1_scores_bwd / gat1_aggregate_fwd / gat1_aggregate_bwd
//   Replace the single-head kernels of the same file: _stats_fwd_kernel
//   (:167) and _stats_bwd_kernel (:187) of gat_scores_stats (:224), and
//   _agg_fwd_kernel (:306) and _agg_bwd_kernel (:317) of gat_aggregate
//   (:350), whose VJP took datt from an XLA einsum (_datt, :398) only
//   because of a TPU toolchain crash (:321-328); here datt is computed
//   inside the backward kernel, as in gat_aggregate_bwd.  The four bodies
//   above take the head count as a template parameter; these entry points
//   instantiate them at one head, so the head loops, the nh*H strides and
//   the head axis of the keep masks vanish at compile time: ha / hn [P, n,
//   H], a [H], e / keep masks [P, na, nt], statistics [P, na] / [P, nt], rs
//   / cs the head's own sums.  Same bounds and the same CTA layout as their
//   stacked forms at nh = 1: the per-head route of the block step
//   (train/block.py, gat_fused=False) launches each once per head.
//
// gat0_scores_fwd / gat0_scores_bwd
//   Replace _fwd_kernel (:40) and _bwd_kernel (:50) of gat_scores (:78), the
//   raw masked scores e = leaky(sum_k |ha_i,k - hn_j,k| a_k * m3) [P, na, nt]
//   and their custom VJP (d ha, d hn, d a summed over the grid; the mask
//   takes none).  It is gat_scores_stats without the statistics, so these
//   are the single-head bodies with a second compile-time flag, kStats =
//   false: the forward drops the row / column pass and the rmax / cmax /
//   sa_l / sb_l stores, the backward the statistics pass and the gsal /
//   gsbl terms of de (de = ge).  So e is bitwise gat1_scores_fwd's first
//   output and the backward bitwise gat1_scores_bwd's with zero gsal /
//   gsbl.  Same bounds (f32 operations), same CTA layout, d a through the
//   same per-block partials and the fixed-order sum, no atomics.  No path
//   of the JAX package calls gat_scores (its routes need the statistics
//   with the scores), so no path of the port launches these yet.
//
// No kernel synchronises or allocates: the caller allocates every output
// and scratch and every launch goes to the stream it is given.  Each entry
// point returns cudaGetLastError() so the caller can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegScore = -1e30f;  // pallas_gat.py:164
constexpr float kZFloor = 1e-30f;

__device__ __forceinline__ float sign0(float x) { return (float)((x > 0.f) - (x < 0.f)); }

struct ScoreSmem {
  float *ha, *hn, *a, *m, *pm;
};

// ha / hn rows of head h of block p (padded to H + 1), the head's a, the
// block's mask; leaves pm for the caller.
__device__ __forceinline__ ScoreSmem load_score_inputs(float* smem, const float* ha, const float* hn,
                                       const float* a, const float* mask, int p, int h,
                                       int na, int nt, int nh, int H) {
  const int ld = H + 1, HH = nh * H, ncell = na * nt;
  ScoreSmem s;
  s.ha = smem;
  s.hn = s.ha + na * ld;
  s.a = s.hn + nt * ld;
  s.m = s.a + H;
  s.pm = s.m + ncell;
  for (int k = threadIdx.x; k < na * H; k += blockDim.x)
    s.ha[(k / H) * ld + k % H] = ha[((int64_t)p * na + k / H) * HH + h * H + k % H];
  for (int k = threadIdx.x; k < nt * H; k += blockDim.x)
    s.hn[(k / H) * ld + k % H] = hn[((int64_t)p * nt + k / H) * HH + h * H + k % H];
  for (int k = threadIdx.x; k < H; k += blockDim.x) s.a[k] = a[h * H + k];
  for (int c = threadIdx.x; c < ncell; c += blockDim.x) s.m[c] = mask[(int64_t)p * ncell + c];
  __syncthreads();
  return s;
}

// pm = (|ha_i - hn_j| . a) * m for every cell (0 where masked, without the product)
__device__ void masked_scores(const ScoreSmem& s, int na, int nt, int H) {
  const int ld = H + 1;
  for (int c = threadIdx.x; c < na * nt; c += blockDim.x) {
    const float m = s.m[c];
    float pm = 0.f;
    if (m != 0.f) {
      const float* x = s.ha + (c / nt) * ld;
      const float* y = s.hn + (c % nt) * ld;
      float pre = 0.f;
      for (int k = 0; k < H; ++k) pre = fmaf(fabsf(x[k] - y[k]), s.a[k], pre);
      pm = pre * m;
    }
    s.pm[c] = pm;
  }
  __syncthreads();
}

__device__ __forceinline__ float leaky(float pm, float alpha) { return pm >= 0.f ? pm : alpha * pm; }

__device__ __forceinline__ float masked_score(const ScoreSmem& s, int c, float alpha) {
  return s.m[c] > 0.f ? leaky(s.pm[c], alpha) : kNegScore;
}

// row r < na or column r - na of the block: its max of e_m and exp-sum, in order
__device__ void row_or_col_stats(const ScoreSmem& s, int r, int na, int nt, float alpha,
                                 float* mx_out, float* sum_out) {
  const bool row = r < na;
  const int n = row ? nt : na, base = row ? r * nt : r - na, step = row ? 1 : nt;
  float mx = kNegScore;
  for (int k = 0; k < n; ++k) mx = fmaxf(mx, masked_score(s, base + k * step, alpha));
  float sum = 0.f;
  for (int k = 0; k < n; ++k) {
    const int c = base + k * step;
    sum += s.m[c] * expf(masked_score(s, c, alpha) - mx);
  }
  *mx_out = mx;
  *sum_out = sum;
}

// kNH: the head count when the compiler knows it (1: the single-head entry
// points), 0 for the runtime nh of the stacked ones; one CTA per (block, head).
// kStats false (gat0_*): the scores alone, no statistics (their pointers unused)
template <int kNH, bool kStats>
__global__ void gat_scores_fwd_kernel(const float* __restrict__ ha, const float* __restrict__ hn,
                                      const float* __restrict__ a, const float* __restrict__ mask,
                                      float* __restrict__ e, float* __restrict__ rmax,
                                      float* __restrict__ cmax, float* __restrict__ sal,
                                      float* __restrict__ sbl, int P, int na, int nt, int nh_arg,
                                      int H, float alpha) {
  extern __shared__ float smem[];
  const int nh = kNH > 0 ? kNH : nh_arg;
  const int p = blockIdx.x, h = kNH == 1 ? 0 : blockIdx.y, ncell = na * nt;
  const ScoreSmem s = load_score_inputs(smem, ha, hn, a, mask, p, h, na, nt, nh, H);
  masked_scores(s, na, nt, H);
  const int64_t hp = (int64_t)h * P + p;
  for (int c = threadIdx.x; c < ncell; c += blockDim.x) e[hp * ncell + c] = leaky(s.pm[c], alpha);
  if (!kStats) return;
  for (int r = threadIdx.x; r < na + nt; r += blockDim.x) {
    float mx, sum;
    row_or_col_stats(s, r, na, nt, alpha, &mx, &sum);
    if (r < na) {
      rmax[hp * na + r] = mx;
      sal[hp * na + r] = sum;
    } else {
      cmax[hp * nt + r - na] = mx;
      sbl[hp * nt + r - na] = sum;
    }
  }
}

template <int kNH, bool kStats>
__global__ void gat_scores_bwd_kernel(const float* __restrict__ ha, const float* __restrict__ hn,
                                      const float* __restrict__ a, const float* __restrict__ mask,
                                      const float* __restrict__ ge, const float* __restrict__ gsal,
                                      const float* __restrict__ gsbl, float* __restrict__ dha,
                                      float* __restrict__ dhn, float* __restrict__ part, int P,
                                      int na, int nt, int nh_arg, int H, float alpha) {
  extern __shared__ float smem[];
  const int nh = kNH > 0 ? kNH : nh_arg;
  const int p = blockIdx.x, h = kNH == 1 ? 0 : blockIdx.y, ncell = na * nt, ld = H + 1,
            HH = nh * H;
  const ScoreSmem s = load_score_inputs(smem, ha, hn, a, mask, p, h, na, nt, nh, H);
  float* mx_s = s.pm + ncell;    // [na + nt]  rmax | cmax
  float* dpre_s = mx_s + na + nt;  // [ncell]
  float* da_s = dpre_s + ncell;  // [na][H]  d a summed over j, per row
  masked_scores(s, na, nt, H);
  if (kStats) {
    for (int r = threadIdx.x; r < na + nt; r += blockDim.x) {
      float sum;
      row_or_col_stats(s, r, na, nt, alpha, &mx_s[r], &sum);
    }
    __syncthreads();
  }
  const int64_t hp = (int64_t)h * P + p;
  for (int c = threadIdx.x; c < ncell; c += blockDim.x) {
    const float m = s.m[c];
    float dpre = 0.f;
    if (m != 0.f) {
      float de = ge[hp * ncell + c];
      if (kStats) {
        const int i = c / nt, j = c % nt;
        const float em = masked_score(s, c, alpha);
        de = de + gsal[hp * na + i] * m * expf(em - mx_s[i])
             + gsbl[hp * nt + j] * m * expf(em - mx_s[na + j]);
      }
      dpre = de * (s.pm[c] >= 0.f ? 1.f : alpha) * m;
    }
    dpre_s[c] = dpre;
  }
  __syncthreads();
  // d ha and this row's share of d a: thread (i, k) over the row's cells in order
  for (int it = threadIdx.x; it < na * H; it += blockDim.x) {
    const int i = it / H, k = it % H;
    const float x = s.ha[i * ld + k], ak = s.a[k];
    float acc = 0.f, acc_a = 0.f;
    for (int j = 0; j < nt; ++j) {
      const float d = x - s.hn[j * ld + k], dp = dpre_s[i * nt + j];
      acc += sign0(d) * (dp * ak);
      acc_a = fmaf(fabsf(d), dp, acc_a);
    }
    dha[((int64_t)p * na + i) * HH + h * H + k] = acc;
    da_s[it] = acc_a;
  }
  for (int it = threadIdx.x; it < nt * H; it += blockDim.x) {
    const int j = it / H, k = it % H;
    const float y = s.hn[j * ld + k], ak = s.a[k];
    float acc = 0.f;
    for (int i = 0; i < na; ++i) acc += sign0(s.ha[i * ld + k] - y) * (dpre_s[i * nt + j] * ak);
    dhn[((int64_t)p * nt + j) * HH + h * H + k] = -acc;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < H; k += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < na; ++i) acc += da_s[i * H + k];
    part[(int64_t)p * HH + h * H + k] = acc;
  }
}

// out[k] = sum over blocks q in increasing order of part[q][k]
__global__ void sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int P, int width) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= width) return;
  float acc = 0.f;
  for (int q = 0; q < P; ++q) acc += part[(int64_t)q * width + k];
  out[k] = acc;
}

struct AggArgs {
  const float *e, *mr, *mc, *zr, *zc, *m, *ka, *kn;
  int P, na, nt, nh, nk;
  float keep;
};

// att_a (rows) or att_n (columns) of head h at cell c of block p; with one
// head known to the compiler (kNH == 1) the keep masks have no head axis
template <int kNH>
__device__ __forceinline__ float attention(const AggArgs& g, bool rows, int h, int p, int c,
                                           float m) {
  if (m == 0.f) return 0.f;
  const int i = c / g.nt, j = c % g.nt, ncell = g.na * g.nt;
  const int64_t hp = (int64_t)h * g.P + p;
  const float shift = rows ? g.mr[hp * g.na + i] : g.mc[hp * g.nt + j];
  const float z = rows ? g.zr[hp * g.na + i] : g.zc[hp * g.nt + j];
  float att = m * expf(g.e[hp * ncell + c] - shift) / fmaxf(z, kZFloor);
  if (g.keep < 1.f) {
    const float* k = rows ? g.ka : g.kn;
    const int kh = (kNH != 1 && g.nk > 1) ? h : 0;
    att = att * k[((int64_t)kh * g.P + p) * ncell + c] / g.keep;
  }
  return att;
}

template <int kNH>
__global__ void gat_aggregate_fwd_kernel(AggArgs g, const float* __restrict__ he,
                                         float* __restrict__ rs, float* __restrict__ cs, int H) {
  extern __shared__ float smem[];
  float* w_s = smem;  // [na][nt]  head-summed attention of this CTA's side
  const int p = blockIdx.x, ncell = g.na * g.nt, nh = kNH > 0 ? kNH : g.nh;
  const bool rows = blockIdx.y == 0;
  for (int c = threadIdx.x; c < ncell; c += blockDim.x) {
    const float m = g.m[(int64_t)p * ncell + c];
    float w = 0.f;
    for (int h = 0; h < nh; ++h) w += attention<kNH>(g, rows, h, p, c, m);
    w_s[c] = w;
  }
  __syncthreads();
  const float* heb = he + (int64_t)p * ncell * H;
  if (rows) {
    for (int it = threadIdx.x; it < g.na * H; it += blockDim.x) {
      const int i = it / H, d = it % H;
      float acc = 0.f;
      for (int j = 0; j < g.nt; ++j) acc = fmaf(w_s[i * g.nt + j], heb[(i * g.nt + j) * H + d], acc);
      rs[((int64_t)p * g.na + i) * H + d] = acc;
    }
  } else {
    for (int it = threadIdx.x; it < g.nt * H; it += blockDim.x) {
      const int j = it / H, d = it % H;
      float acc = 0.f;
      for (int i = 0; i < g.na; ++i) acc = fmaf(w_s[i * g.nt + j], heb[(i * g.nt + j) * H + d], acc);
      cs[((int64_t)p * g.nt + j) * H + d] = acc;
    }
  }
}

template <int kNH>
__global__ void gat_aggregate_bwd_kernel(AggArgs g, const float* __restrict__ he,
                                         const float* __restrict__ grs,
                                         const float* __restrict__ gcs, float* __restrict__ de,
                                         float* __restrict__ dmr, float* __restrict__ dmc,
                                         float* __restrict__ dzr, float* __restrict__ dzc,
                                         float* __restrict__ dhe, int H) {
  extern __shared__ float smem[];
  const int p = blockIdx.x, na = g.na, nt = g.nt, nh = kNH > 0 ? kNH : g.nh, ncell = na * nt;
  float* grs_s = smem;              // [na][H]
  float* gcs_s = grs_s + na * H;    // [nt][H]
  float* datt_a = gcs_s + nt * H;   // [ncell]
  float* datt_n = datt_a + ncell;   // [ncell]
  float* att_a = datt_n + ncell;    // [nh][ncell]
  float* att_n = att_a + nh * ncell;  // [nh][ncell]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  for (int k = threadIdx.x; k < na * H; k += blockDim.x) grs_s[k] = grs[(int64_t)p * na * H + k];
  for (int k = threadIdx.x; k < nt * H; k += blockDim.x) gcs_s[k] = gcs[(int64_t)p * nt * H + k];
  for (int c = threadIdx.x; c < ncell; c += blockDim.x) {
    const float m = g.m[(int64_t)p * ncell + c];
    for (int h = 0; h < nh; ++h) {
      att_a[h * ncell + c] = attention<kNH>(g, true, h, p, c, m);
      att_n[h * ncell + c] = attention<kNH>(g, false, h, p, c, m);
    }
  }
  __syncthreads();
  // datt: one warp a cell, lanes over the hidden units, a fixed shuffle tree
  const float* heb = he + (int64_t)p * ncell * H;
  for (int c = warp; c < ncell; c += nwarps) {
    float sa = 0.f, sn = 0.f;
    if (g.m[(int64_t)p * ncell + c] != 0.f) {
      const float* x = heb + (int64_t)c * H;
      const float* ra = grs_s + (c / nt) * H;
      const float* rn = gcs_s + (c % nt) * H;
      for (int d = lane; d < H; d += 32) {
        const float v = x[d];
        sa = fmaf(ra[d], v, sa);
        sn = fmaf(rn[d], v, sn);
      }
      for (int off = 16; off > 0; off >>= 1) {
        sa += __shfl_xor_sync(0xffffffffu, sa, off);
        sn += __shfl_xor_sync(0xffffffffu, sn, off);
      }
    }
    if (lane == 0) {
      datt_a[c] = sa;
      datt_n[c] = sn;
    }
  }
  __syncthreads();
  for (int it = threadIdx.x; it < nh * ncell; it += blockDim.x) {
    const int h = it / ncell, c = it % ncell;
    de[((int64_t)h * g.P + p) * ncell + c] = datt_a[c] * att_a[it] + datt_n[c] * att_n[it];
  }
  // d m and d z: one thread a (head, row) or (head, column), cells in order
  for (int it = threadIdx.x; it < nh * (na + nt); it += blockDim.x) {
    const int h = it / (na + nt), r = it % (na + nt);
    const int64_t hp = (int64_t)h * g.P + p;
    const float* att = (r < na ? att_a : att_n) + h * ncell;
    const float* datt = r < na ? datt_a : datt_n;
    const int n = r < na ? nt : na, base = r < na ? r * nt : r - na, step = r < na ? 1 : nt;
    float sum = 0.f;
    for (int k = 0; k < n; ++k) {
      const int c = base + k * step;
      sum += datt[c] * att[c];
    }
    if (r < na) {
      dmr[hp * na + r] = -sum;
      dzr[hp * na + r] = -sum / fmaxf(g.zr[hp * na + r], kZFloor);
    } else {
      dmc[hp * nt + r - na] = -sum;
      dzc[hp * nt + r - na] = -sum / fmaxf(g.zc[hp * nt + r - na], kZFloor);
    }
  }
  // d h_e: one thread an element, heads summed in order
  float* dheb = dhe + (int64_t)p * ncell * H;
  for (int64_t it = threadIdx.x; it < (int64_t)ncell * H; it += blockDim.x) {
    const int c = (int)(it / H), d = (int)(it % H);
    const float ga = grs_s[(c / nt) * H + d], gc = gcs_s[(c % nt) * H + d];
    float acc = 0.f;
    for (int h = 0; h < nh; ++h) acc += att_a[h * ncell + c] * ga + att_n[h * ncell + c] * gc;
    dheb[it] = acc;
  }
}

size_t score_smem_floats(int na, int nt, int H, bool backward) {
  const size_t ncell = (size_t)na * nt, ld = H + 1;
  size_t f = (na + nt) * ld + H + 2 * ncell;  // ha, hn, a, m, pm
  if (backward) f += (na + nt) + ncell + (size_t)na * H;  // max, dpre, d a rows
  return f;
}

size_t agg_smem_floats(int na, int nt, int nh, int H, bool backward) {
  const size_t ncell = (size_t)na * nt;
  if (!backward) return ncell;
  return (size_t)(na + nt) * H + 2 * ncell + 2 * (size_t)nh * ncell;
}

cudaError_t opt_in_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

AggArgs agg_args(const void* e, const void* mr, const void* mc, const void* zr, const void* zc,
                 const void* m3, const void* ka, const void* kn, int P, int na, int nt, int nh,
                 int nk, float keep) {
  AggArgs g;
  g.e = (const float*)e;
  g.mr = (const float*)mr;
  g.mc = (const float*)mc;
  g.zr = (const float*)zr;
  g.zc = (const float*)zc;
  g.m = (const float*)m3;
  g.ka = (const float*)ka;
  g.kn = (const float*)kn;
  g.P = P;
  g.na = na;
  g.nt = nt;
  g.nh = nh;
  g.nk = nk;
  g.keep = keep;
  return g;
}

// The launches, for the stacked (kNH = 0, nh heads at run time) and the
// single-head (kNH = 1) instances of each body; the score kernels also
// without their statistics (kStats = false).
template <int kNH, bool kStats>
int launch_scores_fwd(const void* ha, const void* hn, const void* a, const void* mask, void* e,
                      void* rmax, void* cmax, void* sal, void* sbl, int P, int na, int nt, int nh,
                      int H, float alpha, void* stream) {
  if (P == 0 || na == 0 || nt == 0 || nh == 0) return (int)cudaSuccess;
  const size_t smem = score_smem_floats(na, nt, H, false) * sizeof(float);
  cudaError_t err = opt_in_smem((const void*)gat_scores_fwd_kernel<kNH, kStats>, smem);
  if (err != cudaSuccess) return (int)err;
  gat_scores_fwd_kernel<kNH, kStats><<<dim3(P, nh), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)ha, (const float*)hn, (const float*)a, (const float*)mask, (float*)e,
      (float*)rmax, (float*)cmax, (float*)sal, (float*)sbl, P, na, nt, nh, H, alpha);
  return (int)cudaGetLastError();
}

template <int kNH, bool kStats>
int launch_scores_bwd(const void* ha, const void* hn, const void* a, const void* mask,
                      const void* ge, const void* gsal, const void* gsbl, void* dha, void* dhn,
                      void* partials, void* da, int P, int na, int nt, int nh, int H, float alpha,
                      void* stream) {
  if (P == 0 || na == 0 || nt == 0 || nh == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = score_smem_floats(na, nt, H, true) * sizeof(float);
  cudaError_t err = opt_in_smem((const void*)gat_scores_bwd_kernel<kNH, kStats>, smem);
  if (err != cudaSuccess) return (int)err;
  gat_scores_bwd_kernel<kNH, kStats><<<dim3(P, nh), kThreads, smem, s>>>(
      (const float*)ha, (const float*)hn, (const float*)a, (const float*)mask, (const float*)ge,
      (const float*)gsal, (const float*)gsbl, (float*)dha, (float*)dhn, (float*)partials, P, na,
      nt, nh, H, alpha);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = nh * H;
  sum_partials_kernel<<<(width + 255) / 256, 256, 0, s>>>((const float*)partials, (float*)da, P,
                                                          width);
  return (int)cudaGetLastError();
}

template <int kNH>
int launch_aggregate_fwd(const void* e, const void* mr, const void* mc, const void* zr,
                         const void* zc, const void* he, const void* mask, const void* ka,
                         const void* kn, void* rs, void* cs, int P, int na, int nt, int nh, int H,
                         int nk, float keep, void* stream) {
  if (P == 0 || na == 0 || nt == 0) return (int)cudaSuccess;
  const size_t smem = agg_smem_floats(na, nt, nh, H, false) * sizeof(float);
  cudaError_t err = opt_in_smem((const void*)gat_aggregate_fwd_kernel<kNH>, smem);
  if (err != cudaSuccess) return (int)err;
  gat_aggregate_fwd_kernel<kNH><<<dim3(P, 2), kThreads, smem, (cudaStream_t)stream>>>(
      agg_args(e, mr, mc, zr, zc, mask, ka, kn, P, na, nt, nh, nk, keep), (const float*)he,
      (float*)rs, (float*)cs, H);
  return (int)cudaGetLastError();
}

template <int kNH>
int launch_aggregate_bwd(const void* e, const void* mr, const void* mc, const void* zr,
                         const void* zc, const void* he, const void* mask, const void* ka,
                         const void* kn, const void* grs, const void* gcs, void* de, void* dmr,
                         void* dmc, void* dzr, void* dzc, void* dhe, int P, int na, int nt, int nh,
                         int H, int nk, float keep, void* stream) {
  if (P == 0 || na == 0 || nt == 0) return (int)cudaSuccess;
  const size_t smem = agg_smem_floats(na, nt, nh, H, true) * sizeof(float);
  cudaError_t err = opt_in_smem((const void*)gat_aggregate_bwd_kernel<kNH>, smem);
  if (err != cudaSuccess) return (int)err;
  gat_aggregate_bwd_kernel<kNH><<<P, kThreads, smem, (cudaStream_t)stream>>>(
      agg_args(e, mr, mc, zr, zc, mask, ka, kn, P, na, nt, nh, nk, keep), (const float*)he,
      (const float*)grs, (const float*)gcs, (float*)de, (float*)dmr, (float*)dmc, (float*)dzr,
      (float*)dzc, (float*)dhe, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a CTA of the score (kind 0) or aggregate (kind 1)
// kernels needs, forward (backward = 0) or backward.
extern "C" int tm_gat_smem_bytes(int kind, int na, int nt, int nh, int H, int backward) {
  const size_t f = kind == 0 ? score_smem_floats(na, nt, H, backward != 0)
                             : agg_smem_floats(na, nt, nh, H, backward != 0);
  return (int)(f * sizeof(float));
}

// ha: f32[P, na, nh*H]; hn: f32[P, nt, nh*H]; a: f32[nh*H]; mask: f32[P, na, nt].
// out: e f32[nh, P, na, nt], rmax / sa_l f32[nh, P, na], cmax / sb_l f32[nh, P, nt].
extern "C" int tm_gat_scores_fwd(const void* ha, const void* hn, const void* a, const void* mask,
                                 void* e, void* rmax, void* cmax, void* sal, void* sbl, int P,
                                 int na, int nt, int nh, int H, float alpha, void* stream) {
  return launch_scores_fwd<0, true>(ha, hn, a, mask, e, rmax, cmax, sal, sbl, P, na, nt, nh, H, alpha,
                              stream);
}

// Inputs as tm_gat_scores_fwd plus the cotangents ge (shape of e), gsal
// (sa_l), gsbl (sb_l).  Writes d ha, d hn (shapes of ha, hn), the per-block
// partials f32[P, nh*H] (scratch) and da f32[nh*H].
extern "C" int tm_gat_scores_bwd(const void* ha, const void* hn, const void* a, const void* mask,
                                 const void* ge, const void* gsal, const void* gsbl, void* dha,
                                 void* dhn, void* partials, void* da, int P, int na, int nt,
                                 int nh, int H, float alpha, void* stream) {
  return launch_scores_bwd<0, true>(ha, hn, a, mask, ge, gsal, gsbl, dha, dhn, partials, da, P, na, nt,
                              nh, H, alpha, stream);
}

// e: f32[nh, P, na, nt]; m_row / z_row: f32[nh, P, na]; m_col / z_col:
// f32[nh, P, nt]; h_e: f32[P, na, nt, H]; mask: f32[P, na, nt]; ka / kn:
// f32[nk, P, na, nt] with nk = 1 or nh, read only when keep < 1.
// out: rs f32[P, na, H], cs f32[P, nt, H].
extern "C" int tm_gat_aggregate_fwd(const void* e, const void* mr, const void* mc, const void* zr,
                                    const void* zc, const void* he, const void* mask,
                                    const void* ka, const void* kn, void* rs, void* cs, int P,
                                    int na, int nt, int nh, int H, int nk, float keep,
                                    void* stream) {
  return launch_aggregate_fwd<0>(e, mr, mc, zr, zc, he, mask, ka, kn, rs, cs, P, na, nt, nh, H,
                                 nk, keep, stream);
}

// Inputs as tm_gat_aggregate_fwd plus the cotangents g_rs f32[P, na, H] and
// g_cs f32[P, nt, H].  out: de f32[nh, P, na, nt], d m_row / d z_row
// f32[nh, P, na], d m_col / d z_col f32[nh, P, nt], d h_e f32[P, na, nt, H].
extern "C" int tm_gat_aggregate_bwd(const void* e, const void* mr, const void* mc, const void* zr,
                                    const void* zc, const void* he, const void* mask,
                                    const void* ka, const void* kn, const void* grs,
                                    const void* gcs, void* de, void* dmr, void* dmc, void* dzr,
                                    void* dzc, void* dhe, int P, int na, int nt, int nh, int H,
                                    int nk, float keep, void* stream) {
  return launch_aggregate_bwd<0>(e, mr, mc, zr, zc, he, mask, ka, kn, grs, gcs, de, dmr, dmc,
                                 dzr, dzc, dhe, P, na, nt, nh, H, nk, keep, stream);
}

// One head (gat_scores_stats, pallas_gat.py:224): ha f32[P, na, H], hn
// f32[P, nt, H], a f32[H], mask f32[P, na, nt].  out: e f32[P, na, nt], rmax /
// sa_l f32[P, na], cmax / sb_l f32[P, nt].
extern "C" int tm_gat1_scores_fwd(const void* ha, const void* hn, const void* a, const void* mask,
                                  void* e, void* rmax, void* cmax, void* sal, void* sbl, int P,
                                  int na, int nt, int H, float alpha, void* stream) {
  return launch_scores_fwd<1, true>(ha, hn, a, mask, e, rmax, cmax, sal, sbl, P, na, nt, 1, H, alpha,
                              stream);
}

// Its backward (pallas_gat.py:264): inputs as tm_gat1_scores_fwd plus the
// cotangents ge, gsal, gsbl; writes d ha, d hn, the per-block partials
// f32[P, H] (scratch) and da f32[H].
extern "C" int tm_gat1_scores_bwd(const void* ha, const void* hn, const void* a, const void* mask,
                                  const void* ge, const void* gsal, const void* gsbl, void* dha,
                                  void* dhn, void* partials, void* da, int P, int na, int nt,
                                  int H, float alpha, void* stream) {
  return launch_scores_bwd<1, true>(ha, hn, a, mask, ge, gsal, gsbl, dha, dhn, partials, da, P, na, nt,
                              1, H, alpha, stream);
}

// One head (gat_aggregate, pallas_gat.py:350): e, ka, kn, mask f32[P, na,
// nt]; m_row / z_row f32[P, na]; m_col / z_col f32[P, nt]; h_e f32[P, na,
// nt, H]; the keep masks are read only when keep < 1.  out: rs f32[P, na, H],
// cs f32[P, nt, H].
extern "C" int tm_gat1_aggregate_fwd(const void* e, const void* mr, const void* mc,
                                     const void* zr, const void* zc, const void* he,
                                     const void* mask, const void* ka, const void* kn, void* rs,
                                     void* cs, int P, int na, int nt, int H, float keep,
                                     void* stream) {
  return launch_aggregate_fwd<1>(e, mr, mc, zr, zc, he, mask, ka, kn, rs, cs, P, na, nt, 1, H, 1,
                                 keep, stream);
}

// Its backward (pallas_gat.py:408, with _datt inside): inputs as
// tm_gat1_aggregate_fwd plus g_rs f32[P, na, H], g_cs f32[P, nt, H].  out: de
// f32[P, na, nt], d m_row / d z_row f32[P, na], d m_col / d z_col f32[P, nt],
// d h_e f32[P, na, nt, H].
extern "C" int tm_gat1_aggregate_bwd(const void* e, const void* mr, const void* mc,
                                     const void* zr, const void* zc, const void* he,
                                     const void* mask, const void* ka, const void* kn,
                                     const void* grs, const void* gcs, void* de, void* dmr,
                                     void* dmc, void* dzr, void* dzc, void* dhe, int P, int na,
                                     int nt, int H, float keep, void* stream) {
  return launch_aggregate_bwd<1>(e, mr, mc, zr, zc, he, mask, ka, kn, grs, gcs, de, dmr, dmc,
                                 dzr, dzc, dhe, P, na, nt, 1, H, 1, keep, stream);
}

// gat_scores (pallas_gat.py:78): ha f32[P, na, H], hn f32[P, nt, H], a f32[H],
// mask f32[P, na, nt].  out: e f32[P, na, nt].
extern "C" int tm_gat0_scores_fwd(const void* ha, const void* hn, const void* a, const void* mask,
                                  void* e, int P, int na, int nt, int H, float alpha,
                                  void* stream) {
  return launch_scores_fwd<1, false>(ha, hn, a, mask, e, nullptr, nullptr, nullptr, nullptr, P, na,
                                     nt, 1, H, alpha, stream);
}

// Its VJP (pallas_gat.py:115): inputs as tm_gat0_scores_fwd plus the
// cotangent ge f32[P, na, nt]; writes d ha, d hn, the per-block partials
// f32[P, H] (scratch) and da f32[H].
extern "C" int tm_gat0_scores_bwd(const void* ha, const void* hn, const void* a, const void* mask,
                                  const void* ge, void* dha, void* dhn, void* partials, void* da,
                                  int P, int na, int nt, int H, float alpha, void* stream) {
  return launch_scores_bwd<1, false>(ha, hn, a, mask, ge, nullptr, nullptr, dha, dhn, partials, da,
                                     P, na, nt, 1, H, alpha, stream);
}
