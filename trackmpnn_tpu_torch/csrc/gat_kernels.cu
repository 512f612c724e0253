// Hopper (sm_90a) kernels for the GAT attention heads of the block train
// step.  Built by trackmpnn_tpu_torch/ops/_build.py into a shared library
// with a plain C interface and called through ctypes from ops/gat.py, which
// checks device, dtype, shape and contiguity before any pointer gets here
// and allocates the scratch tm_gat_scratch_floats asks for.  All math is
// f32 on the CUDA cores (no TF32: neither function is a product the tensor
// cores compute); no kernel uses atomics, and every sum runs in a fixed
// order, so every result is bitwise the same from run to run whatever order
// the blocks run in.
//
// Layout: P blocks (edge rectangles) of na x nt cells; nh attention heads
// of width H.  Per-head detection projections arrive with the heads side by
// side on the feature axis (ha [P, na, nh*H], hn [P, nt, nh*H]); scores and
// softmax statistics are head-leading ([nh, P, ...]); the edge hiddens h_e
// [P, na, nt, H] are shared by the heads.  m3 [P, na, nt] is the 0/1 cell
// mask.  Every kernel tiles the rectangle and loops over H in chunks, so
// its shared memory is fixed by the tile: every P, na, nt, nh and H that
// fits the C interface's ints is taken.
//
// gat_scores_fwd (#11)
//   Replaces _mh_stats_fwd_kernel (trackmpnn_tpu/ops/pallas_gat.py:505) of
//   gat_scores_stats_mh (:572).  Per head h and block:
//     e    = leaky(sum_k |ha[i, hH+k] - hn[j, hH+k]| * a[hH+k] * m3)
//     e_m  = m3 > 0 ? e : -1e30;  rmax / cmax = row / column max of e_m
//     sa_l = sum_j m3 * exp(e_m - rmax),  sb_l = sum_i m3 * exp(e_m - cmax)
//   Bound: f32 operations on the CUDA cores (|ha - hn| . a is not bilinear,
//   so no tensor core helps; 3 a cell and hidden unit).  One CTA of 256
//   threads per (head, block, band of 32 rows) walks the band's 32 x 32 cell
//   tiles: it stages 64 hidden units of the band's ha rows and the tile's hn
//   rows k-major in shared memory (every load of a chunk in flight at once,
//   the mask's before them), and each thread forms a 2 x 2 register block of
//   cells, so that an ha and an hn value loaded once serve two cells each.
//   A warp takes the max and exp-sum of four rows (then four columns) of the
//   tile at once, their shuffle trees interleaved; the rows' (max, sum)
//   pairs merge across the band's tiles in order, the columns' across bands
//   in a second small kernel (merge_col_stats_kernel), also in order, only
//   when na > 32.
//
// gat_scores_bwd (#11)
//   Replaces _mh_stats_bwd_kernel (:531).  Recomputes the scores; the max
//   carries no gradient (the caller stops it, as JAX's softmax does), so
//     de   = ge + gsal * m3 * exp(e_m - rmax) + gsbl * m3 * exp(e_m - cmax)
//     dpre = de * (pre >= 0 ? 1 : alpha) * m3
//     d ha[i, k] = a[k] sum_j dpre sign(d),  d hn[j, k] = -a[k] sum_i dpre sign(d),
//     d a[k] = sum over every cell of |d| dpre,  d = ha[i, k] - hn[j, k]
//   with sign(0) = 0 (jnp.sign, not copysign: padded rows of ha and hn are
//   equal; the sign is an xor of sign bits, zeroed where d == 0).  Bound: f32
//   operations.  The same CTAs and tiles: per tile the scores, then dpre in
//   shared memory (both orientations), then the three contractions from that
//   one recomputation: a thread (hidden unit k, group of 8 rows) sums d ha
//   over the tile's columns and d a beside it, a thread (k, group of 8
//   columns) d hn over the band's rows, with the 8 dpre values of a step two
//   16-byte broadcast loads and the ha / hn values in registers; ge, gsal
//   and gsbl are loaded before the scores, and dpre is formed from the
//   scores in registers.  The cross-tile partials merge in order: d ha over
//   the band's tiles in the thread that owns it, d hn over bands
//   (sum_tiles_kernel, when na > 32), d a over the blocks and bands
//   (sum_partials_kernel: a warp every eighth partial row, then the warps in
//   order).  Where the
//   rectangle is one tile (na, nt <= 32: every round of the training paths
//   so far) the CTA takes rmax and cmax itself; otherwise the forward kernel
//   writes them into scratch first.
//
// gat_aggregate_fwd (#12)
//   Replaces _mh_agg_fwd_kernel (:644) of gat_aggregate_mh (:700).  Per head
//     att_a = m3 * exp(e - m_row) / max(z_row, 1e-30) * ka / keep
//     att_n = m3 * exp(e - m_col) / max(z_col, 1e-30) * kn / keep
//   (the keep masks are read only when keep < 1; a mask with one head
//   broadcasts), and
//     rs[i] = sum_h sum_j att_a * h_e[i, j],  cs[j] = sum_h sum_i att_n * h_e[i, j].
//   Bound: device-memory bytes (h_e read once dominates).  One CTA of 8
//   warps per (block, tile of 8 rows), so a round of P blocks fills the
//   card with P ceil(na / 8) CTAs.  Per chunk of 32 columns a thread a cell
//   forms its head-summed weights once; then warp w reads the columns w, w +
//   8, ... of the tile, two rows at a time (a half-warp a row, 16-byte loads,
//   neighbouring lanes on neighbouring addresses), skips masked cells, and
//   forms rs and cs from the one read: cs of its column in registers over
//   the tile's rows, rs of each row in registers over its columns, summed
//   over the 8 warps in order at the end.  The tiles' cs partials are summed
//   in tile order by sum_tiles_kernel when na > 8.  Masked cells weigh 0, so
//   a row whose cells are all masked gives 0.
//
// gat_aggregate_bwd (#12)
//   Replaces _mh_agg_bwd_kernel (:664) together with the datt contraction
//   that the TPU ran as an XLA einsum outside its kernel (_datt, :398):
//     datt_a = <g_rs[i], h_e[i, j]>,  datt_n = <g_cs[j], h_e[i, j]>
//     de     = datt_a * att_a + datt_n * att_n                         (per head)
//     d m_row = -sum_j datt_a * att_a,  d z_row = d m_row / max(z_row, 1e-30)
//     d m_col, d z_col likewise over i
//     d h_e  = (sum_h att_a) g_rs[i] + (sum_h att_n) g_cs[j]
//   Bound: device-memory bytes (h_e read, d h_e written).  The forward's CTAs
//   and tiles.  Per chunk of 32 columns: a thread a cell forms each head's
//   weights once (the first four heads kept in shared memory for the third
//   step, a fifth and later head formed again there); one pass over h_e (a
//   half-warp a cell, 16-byte loads, masked cells skipped) forms datt and
//   writes d h_e (which needs the weights only; 0 at masked cells); then a
//   thread a cell writes de for every head,
//   the row sums are warp shuffles over the chunk's columns (accumulated
//   over chunks by the thread that owns the row) and the column sums a
//   fixed-order sum over the tile's 8 rows; the tiles' column partials are
//   summed in tile order by agg_col_finish_kernel when na > 8.
//
// gat1_scores_fwd / gat1_scores_bwd / gat1_aggregate_fwd / gat1_aggregate_bwd (#9, #10)
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
//   / cs the head's own sums.  Same bounds, tiles and orders as their
//   stacked forms at nh = 1, so bitwise equal to them: the per-head route of
//   the block step (train/block.py, gat_fused=False) launches each once per
//   head.
//
// gat0_scores_fwd / gat0_scores_bwd (#8)
//   Replace _fwd_kernel (:40) and _bwd_kernel (:50) of gat_scores (:78), the
//   raw masked scores e = leaky(sum_k |ha_i,k - hn_j,k| a_k * m3) [P, na, nt]
//   and their custom VJP (d ha, d hn, d a summed over the grid; the mask
//   takes none).  It is gat_scores_stats without the statistics, so these
//   are the single-head bodies with a second compile-time flag, kStats =
//   false: the forward drops the row / column statistics, the backward the
//   statistics and the gsal / gsbl terms of de (de = ge).  So e is bitwise
//   gat1_scores_fwd's first output and the backward bitwise gat1_scores_bwd's
//   with zero gsal / gsbl.  Same bounds and tiles, no atomics.  No path of
//   the JAX package calls gat_scores (its routes need the statistics with
//   the scores), so no path of the port launches these yet.
//
// No kernel synchronises or allocates: the caller allocates every output
// and the scratch, and every launch goes to the stream it is given.  Each
// entry point returns cudaGetLastError() so the caller can raise on a
// refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegScore = -1e30f;  // pallas_gat.py:164
constexpr float kZFloor = 1e-30f;

// score kernels: a band of rows a CTA, square cell tiles, hidden units staged
// in chunks; the contraction threads are (hidden unit, group of 8 rows or
// columns)
constexpr int kBand = 32;
constexpr int kTile = 32;
constexpr int kKC = 64;
constexpr int kLdK = kBand + 1;  // k-major staged rows: conflict-free both ways
constexpr int kLdD = kBand + 4;  // dpre rows: 16-byte aligned for the broadcasts
constexpr int kGroup = 8;
static_assert(kBand == kTile && kKC * (kBand / kGroup) == kThreads, "score tiling");

// aggregate kernels: a tile of rows a CTA, chunks of columns a step
constexpr int kRows = 8;
constexpr int kCols = 32;
constexpr int kStash = 4;      // heads whose weights a cell's thread keeps between steps
constexpr int kHeadChunk = 8;  // heads a column-sum step
static_assert(kRows == kWarps && kCols == 32, "aggregate tiling: a warp a row of a chunk");

__device__ __forceinline__ float leaky(float pm, float alpha) { return pm >= 0.f ? pm : alpha * pm; }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// every lane gets the same sum: a + b and b + a round alike
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// D * sign(d), with sign(0) = 0 (jnp.sign)
__device__ __forceinline__ float signed_by(float D, float d) {
  return d == 0.f ? 0.f : __int_as_float(__float_as_int(D) ^ (__float_as_int(d) & 0x80000000));
}

// (M, S) <- the softmax statistics of the union of two cell sets
__device__ __forceinline__ void merge_stats(float& M, float& S, float m, float s) {
  const float M2 = fmaxf(M, m);
  S = S * expf(M - M2) + s * expf(m - M2);
  M = M2;
}

// ------------------------------------------------------------- scores ----
struct __align__(16) ScoreShared {
  float d[kBand][kLdD];   // dpre [row][column]
  float dt[kTile][kLdD];  // dpre [column][row]
  float a[kKC][kLdK];     // a chunk of the band's ha rows, k-major
  float b[kKC][kLdK];     // the same chunk of the tile's hn rows
  float w[kKC];           // the head's a over the chunk
  float m[kBand][kTile + 1];
  float pm[kBand][kTile + 1];  // (|ha_i - hn_j| . a) * m, 0 where masked
  float rmax[kBand], cmax[kTile];
  float row_m[kBand], row_s[kBand];
  float da[kThreads / kKC][kKC];
};

struct ScoreBlock {
  const float *ha, *hn, *a, *mask;
  int P, na, nt, nh, H, nb;
  int p, h, band, i0, nrows;
  int64_t hp;  // h * P + p
};

// blockIdx.x = (h * P + p) * nb + band
__device__ __forceinline__ ScoreBlock score_block(const float* ha, const float* hn, const float* a,
                                                  const float* mask, int P, int na, int nt, int nh,
                                                  int H) {
  ScoreBlock q;
  q.ha = ha;
  q.hn = hn;
  q.a = a;
  q.mask = mask;
  q.P = P;
  q.na = na;
  q.nt = nt;
  q.nh = nh;
  q.H = H;
  q.nb = (na + kBand - 1) / kBand;
  q.band = blockIdx.x % q.nb;
  q.hp = blockIdx.x / q.nb;
  q.p = (int)(q.hp % P);
  q.h = (int)(q.hp / P);
  q.i0 = q.band * kBand;
  q.nrows = min(kBand, na - q.i0);
  return q;
}

// hidden units [k0, k0 + kc) of the band's ha rows and the tile's hn rows
// (zeros beyond the block), k-major
__device__ void stage(ScoreShared& s, const ScoreBlock& q, int j0, int ncols, int k0, int kc) {
  constexpr int kStep = kThreads / kKC;  // rows a pass of the CTA stages
  const int64_t HH = (int64_t)q.nh * q.H, off = (int64_t)q.h * q.H + k0;
  const int k = threadIdx.x % kKC, r0 = threadIdx.x / kKC;
  const float* xa = q.ha + ((int64_t)q.p * q.na + q.i0 + r0) * HH + off + k;
  const float* xb = q.hn + ((int64_t)q.p * q.nt + j0 + r0) * HH + off + k;
  const int64_t step = kStep * HH;
#pragma unroll
  for (int n = 0; n < kBand / kStep; ++n) {  // every load in flight at once
    const int r = r0 + kStep * n;
    const float x = k < kc && r < q.nrows ? xa[n * step] : 0.f;
    const float y = k < kc && r < ncols ? xb[n * step] : 0.f;
    s.a[k][r] = x;
    s.b[k][r] = y;
  }
  for (int k = threadIdx.x; k < kc; k += kThreads) s.w[k] = q.a[off + k];
}

// s.pm and s.m of the tile at columns [j0, j0 + ncols), and in registers the
// thread's own cells (ty + 16u, tx + 16v): pm and m.  The mask is loaded
// first, so its latency hides behind the products; begins and ends with a
// barrier.
__device__ void score_tile(ScoreShared& s, const ScoreBlock& q, int j0, int ncols,
                           float (&pm)[2][2], float (&m)[2][2]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int r = ty + 16 * u, c = tx + 16 * v;
      m[u][v] = r < q.nrows && c < ncols
                    ? q.mask[((int64_t)q.p * q.na + q.i0 + r) * q.nt + j0 + c] : 0.f;
    }
  __syncthreads();
  for (int k0 = 0; k0 < q.H; k0 += kKC) {
    const int kc = min(kKC, q.H - k0);
    if (k0 > 0) __syncthreads();
    stage(s, q, j0, ncols, k0, kc);
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      const float w = s.w[k];
      const float x0 = s.a[k][ty], x1 = s.a[k][ty + 16];
      const float y0 = s.b[k][tx], y1 = s.b[k][tx + 16];
      acc[0][0] = fmaf(fabsf(x0 - y0), w, acc[0][0]);
      acc[0][1] = fmaf(fabsf(x0 - y1), w, acc[0][1]);
      acc[1][0] = fmaf(fabsf(x1 - y0), w, acc[1][0]);
      acc[1][1] = fmaf(fabsf(x1 - y1), w, acc[1][1]);
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int r = ty + 16 * u, c = tx + 16 * v;
      pm[u][v] = m[u][v] != 0.f ? acc[u][v] * m[u][v] : 0.f;
      s.m[r][c] = m[u][v];
      s.pm[r][c] = pm[u][v];
    }
  __syncthreads();
}

// The max (and with kSum the exp-sum) over the cells of the tile's rows (kRow)
// or columns warp, warp + 8, ...: a lane a cell (cells beyond the block are
// masked), the lines' shuffle trees interleaved; every lane gets the results.
constexpr int kLines = kBand / kWarps;

template <bool kRow, bool kSum>
__device__ __forceinline__ void tile_lines(const ScoreShared& s, float alpha, float (&mx)[kLines],
                                           float (&sum)[kLines]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float m[kLines], em[kLines];
#pragma unroll
  for (int l = 0; l < kLines; ++l) {
    const int r = kRow ? warp + kWarps * l : lane, c = kRow ? lane : warp + kWarps * l;
    m[l] = s.m[r][c];
    em[l] = m[l] > 0.f ? leaky(s.pm[r][c], alpha) : kNegScore;
    mx[l] = em[l];
  }
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int l = 0; l < kLines; ++l) mx[l] = fmaxf(mx[l], __shfl_xor_sync(0xffffffffu, mx[l], o));
  if (!kSum) return;
#pragma unroll
  for (int l = 0; l < kLines; ++l) sum[l] = m[l] * expf(em[l] - mx[l]);
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int l = 0; l < kLines; ++l) sum[l] += __shfl_xor_sync(0xffffffffu, sum[l], o);
}

// kNH: the head count when the compiler knows it (1: the single-head entry
// points), 0 for the runtime nh of the stacked ones.  kStats false (gat0_*):
// the scores alone, no statistics (their pointers unused).  e null: the
// statistics alone (the backward's pass over wide rectangles).  With more
// than one band the column statistics go to cpart [nb, nh, P, nt, 2] as
// (max, sum) pairs for merge_col_stats_kernel.
template <int kNH, bool kStats>
__global__ void __launch_bounds__(kThreads)
    gat_scores_fwd_kernel(const float* __restrict__ ha, const float* __restrict__ hn,
                          const float* __restrict__ a, const float* __restrict__ mask,
                          float* __restrict__ e, float* __restrict__ rmax, float* __restrict__ cmax,
                          float* __restrict__ sal, float* __restrict__ sbl,
                          float* __restrict__ cpart, int P, int na, int nt, int nh_arg, int H,
                          float alpha) {
  __shared__ ScoreShared s;
  const int nh = kNH > 0 ? kNH : nh_arg;
  const ScoreBlock q = score_block(ha, hn, a, mask, P, na, nt, nh, H);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t ncell = (int64_t)na * nt;
  if (threadIdx.x < kBand) {
    s.row_m[threadIdx.x] = kNegScore;
    s.row_s[threadIdx.x] = 0.f;
  }
  for (int j0 = 0; j0 < nt; j0 += kTile) {
    const int ncols = min(kTile, nt - j0);
    float pm[2][2], m[2][2];
    score_tile(s, q, j0, ncols, pm, m);
    if (e != nullptr)
      for (int t = threadIdx.x; t < kBand * kTile; t += kThreads) {
        const int r = t / kTile, c = t % kTile;
        if (r < q.nrows && c < ncols)
          e[q.hp * ncell + (int64_t)(q.i0 + r) * nt + j0 + c] = leaky(s.pm[r][c], alpha);
      }
    if (!kStats) continue;
    float mt[kLines], st[kLines];
    tile_lines<true, true>(s, alpha, mt, st);
    if (lane == 0)
#pragma unroll
      for (int l = 0; l < kLines; ++l) {
        const int r = warp + kWarps * l;
        if (r < q.nrows) merge_stats(s.row_m[r], s.row_s[r], mt[l], st[l]);
      }
    tile_lines<false, true>(s, alpha, mt, st);
    if (lane == 0)
#pragma unroll
      for (int l = 0; l < kLines; ++l) {
        const int c = warp + kWarps * l;
        if (c >= ncols) continue;
        const int64_t o = q.hp * nt + j0 + c;
        if (q.nb == 1) {
          cmax[o] = mt[l];
          sbl[o] = st[l];
        } else {
          float* cp = cpart + 2 * ((int64_t)q.band * nh * P * nt + o);
          cp[0] = mt[l];
          cp[1] = st[l];
        }
      }
  }
  if (!kStats) return;
  __syncthreads();
  if (threadIdx.x < q.nrows) {
    const int64_t o = q.hp * na + q.i0 + threadIdx.x;
    rmax[o] = s.row_m[threadIdx.x];
    sal[o] = s.row_s[threadIdx.x];
  }
}

// cmax / sb_l [n] from the bands' (max, sum) pairs cpart [nb, n, 2], in band order
__global__ void merge_col_stats_kernel(const float* __restrict__ cpart, float* __restrict__ cmax,
                                       float* __restrict__ sbl, int nb, int64_t n) {
  for (int64_t x = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; x < n;
       x += (int64_t)gridDim.x * blockDim.x) {
    float M = kNegScore, S = 0.f;
    for (int b = 0; b < nb; ++b)
      merge_stats(M, S, cpart[2 * (b * n + x)], cpart[2 * (b * n + x) + 1]);
    cmax[x] = M;
    sbl[x] = S;
  }
}

// rmax / cmax null: the CTA takes them from its one tile (na, nt <= 32).
// d hn goes to dhn when the rectangle is one band, else a * sum over the
// band's rows to dhn_part [nb, P, nt, nh*H]; d a partials to da_part
// [P * nb, nh*H] (row p * nb + band).
template <int kNH, bool kStats>
__global__ void __launch_bounds__(kThreads)
    gat_scores_bwd_kernel(const float* __restrict__ ha, const float* __restrict__ hn,
                          const float* __restrict__ a, const float* __restrict__ mask,
                          const float* __restrict__ ge, const float* __restrict__ gsal,
                          const float* __restrict__ gsbl, const float* __restrict__ rmax,
                          const float* __restrict__ cmax, float* __restrict__ dha,
                          float* __restrict__ dhn, float* __restrict__ dhn_part,
                          float* __restrict__ da_part, int P, int na, int nt, int nh_arg, int H,
                          float alpha) {
  __shared__ ScoreShared s;
  const int nh = kNH > 0 ? kNH : nh_arg;
  const ScoreBlock q = score_block(ha, hn, a, mask, P, na, nt, nh, H);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kt = threadIdx.x % kKC, g = threadIdx.x / kKC;  // contraction threads
  const int64_t ncell = (int64_t)na * nt, HH = (int64_t)nh * H;
  for (int j0 = 0; j0 < nt; j0 += kTile) {
    const int ncols = min(kTile, nt - j0);
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float gcell[2][2], grow[2] = {0.f, 0.f}, gcol[2] = {0.f, 0.f};  // loaded ahead
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = ty + 16 * u, c = tx + 16 * u;
      if (kStats && r < q.nrows) grow[u] = gsal[q.hp * na + q.i0 + r];
      if (kStats && c < ncols) gcol[u] = gsbl[q.hp * nt + j0 + c];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int cc = tx + 16 * v;
        gcell[u][v] = r < q.nrows && cc < ncols
                          ? ge[q.hp * ncell + (int64_t)(q.i0 + r) * nt + j0 + cc] : 0.f;
      }
    }
    float pm[2][2], m[2][2];
    score_tile(s, q, j0, ncols, pm, m);
    if (kStats) {
      if (rmax == nullptr) {
        float mt[kLines], unused[kLines];
        tile_lines<true, false>(s, alpha, mt, unused);
        if (lane == 0)
#pragma unroll
          for (int l = 0; l < kLines; ++l) s.rmax[warp + kWarps * l] = mt[l];
        tile_lines<false, false>(s, alpha, mt, unused);
        if (lane == 0)
#pragma unroll
          for (int l = 0; l < kLines; ++l) s.cmax[warp + kWarps * l] = mt[l];
      } else if (threadIdx.x < kBand) {
        s.rmax[threadIdx.x] = threadIdx.x < q.nrows ? rmax[q.hp * na + q.i0 + threadIdx.x] : 0.f;
      } else if (threadIdx.x < kBand + kTile) {
        const int c = threadIdx.x - kBand;
        s.cmax[c] = c < ncols ? cmax[q.hp * nt + j0 + c] : 0.f;
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int r = ty + 16 * u, c = tx + 16 * v;
        const float mm = m[u][v];
        float D = 0.f;
        if (mm != 0.f) {
          float de = gcell[u][v];
          if (kStats) {
            const float em = mm > 0.f ? leaky(pm[u][v], alpha) : kNegScore;
            de = de + grow[u] * mm * expf(em - s.rmax[r]) + gcol[v] * mm * expf(em - s.cmax[c]);
          }
          D = de * (pm[u][v] >= 0.f ? 1.f : alpha) * mm;
        }
        s.d[r][c] = D;
        s.dt[c][r] = D;
      }
    __syncthreads();
    for (int k0 = 0; k0 < H; k0 += kKC) {
      const int kc = min(kKC, H - k0);
      if (H > kKC) {  // score_tile left only the last chunk staged
        __syncthreads();
        stage(s, q, j0, ncols, k0, kc);
        __syncthreads();
      }
      const int64_t col = (int64_t)q.h * H + k0 + kt;
      float da = 0.f;
      if (kt < kc && kGroup * g < q.nrows) {  // d ha and d a: rows 8g.., the tile's columns
        float x[kGroup], acc[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          x[u] = s.a[kt][kGroup * g + u];
          acc[u] = 0.f;
        }
        for (int c = 0; c < ncols; ++c) {
          const float y = s.b[kt][c];
          const float4 d0 = *reinterpret_cast<const float4*>(&s.dt[c][kGroup * g]);
          const float4 d1 = *reinterpret_cast<const float4*>(&s.dt[c][kGroup * g + 4]);
          const float D[kGroup] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            const float d = x[u] - y, t = signed_by(D[u], d);
            acc[u] += t;
            da = fmaf(d, t, da);
          }
        }
        const float w = s.w[kt];
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          if (kGroup * g + u < q.nrows) {
            const int64_t o = ((int64_t)q.p * na + q.i0 + kGroup * g + u) * HH + col;
            const float v = w * acc[u];
            dha[o] = j0 == 0 ? v : dha[o] + v;
          }
      }
      if (kt < kc && kGroup * g < ncols) {  // d hn: columns 8g.., the band's rows
        float y[kGroup], acc[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          y[u] = s.b[kt][kGroup * g + u];
          acc[u] = 0.f;
        }
        for (int r = 0; r < q.nrows; ++r) {
          const float x = s.a[kt][r];
          const float4 d0 = *reinterpret_cast<const float4*>(&s.d[r][kGroup * g]);
          const float4 d1 = *reinterpret_cast<const float4*>(&s.d[r][kGroup * g + 4]);
          const float D[kGroup] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
          for (int u = 0; u < kGroup; ++u) acc[u] += signed_by(D[u], x - y[u]);
        }
        const float w = s.w[kt];
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          if (kGroup * g + u < ncols) {
            const int64_t j = j0 + kGroup * g + u;
            if (q.nb == 1)
              dhn[((int64_t)q.p * nt + j) * HH + col] = -(w * acc[u]);
            else
              dhn_part[(((int64_t)q.band * P + q.p) * nt + j) * HH + col] = w * acc[u];
          }
      }
      s.da[g][kt] = da;
      __syncthreads();
      if (g == 0 && kt < kc) {
        float v = s.da[0][kt];
#pragma unroll
        for (int u = 1; u < kThreads / kKC; ++u) v += s.da[u][kt];
        const int64_t o = ((int64_t)q.p * q.nb + q.band) * HH + col;
        da_part[o] = j0 == 0 ? v : da_part[o] + v;
      }
    }
  }
}

// out[k] = sum over rows q of part[q][k] in a fixed order: a CTA 32 columns,
// its warp w the rows w, w + 8, ... in order, then the 8 warps' sums in order
__global__ void __launch_bounds__(kThreads)
    sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int rows,
                        int64_t width) {
  __shared__ float acc_s[kWarps][32];
  const int c = threadIdx.x % 32, w = threadIdx.x / 32;
  const int64_t k = blockIdx.x * 32LL + c;
  float acc = 0.f;
  if (k < width)
#pragma unroll 4
    for (int q = w; q < rows; q += kWarps) acc += part[q * width + k];
  acc_s[w][c] = acc;
  __syncthreads();
  if (w == 0 && k < width) {
    float v = acc_s[0][c];
#pragma unroll
    for (int u = 1; u < kWarps; ++u) v += acc_s[u][c];
    out[k] = v;
  }
}

// out[x] = scale * sum over tiles t in increasing order of part[t][x]
__global__ void sum_tiles_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int ntiles, int64_t n, float scale) {
  for (int64_t x = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; x < n;
       x += (int64_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < ntiles; ++t) acc += part[t * n + x];
    out[x] = scale * acc;
  }
}

// ---------------------------------------------------------- aggregate ----
struct AggArgs {
  const float *e, *mr, *mc, *zr, *zc, *m, *ka, *kn;
  int P, na, nt, nh, nk;
  float keep;
};

// att_a (rows) or att_n (columns) of head h at cell (i, j) of block p; with
// one head known to the compiler (kNH == 1) the keep masks have no head axis
template <int kNH>
__device__ __forceinline__ float attention(const AggArgs& g, bool rows, int h, int p, int i, int j,
                                           float m) {
  if (m == 0.f) return 0.f;
  const int64_t hp = (int64_t)h * g.P + p, ncell = (int64_t)g.na * g.nt, c = (int64_t)i * g.nt + j;
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

// V consecutive floats (V = 4: one 16-byte access)
template <int V>
__device__ __forceinline__ void load_v(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    p[0] = v[0];
}

struct AggTile {
  int ntiles, t, p, i0, nrows;
};

// blockIdx.x = p * ntiles + t
__device__ __forceinline__ AggTile agg_tile(const AggArgs& g) {
  AggTile a;
  a.ntiles = (g.na + kRows - 1) / kRows;
  a.t = blockIdx.x % a.ntiles;
  a.p = blockIdx.x / a.ntiles;
  a.i0 = a.t * kRows;
  a.nrows = min(kRows, g.na - a.i0);
  return a;
}

// V: floats a lane moves at a time (4 when H % 4 == 0 and the pointers are
// 16-byte aligned, else 1); a half-warp covers 16 V hidden units of a cell.
// cs goes to cs_part [ntiles, P, nt, H] when the block has more than one
// row tile.
template <int kNH, int V>
__global__ void __launch_bounds__(kThreads)
    gat_aggregate_fwd_kernel(AggArgs g, const float* __restrict__ he, float* __restrict__ rs,
                             float* __restrict__ cs, float* __restrict__ cs_part, int H) {
  constexpr int kHC = 16 * V;
  __shared__ float w_a[kRows][kCols], w_n[kRows][kCols], m_s[kRows][kCols];
  __shared__ __align__(16) float rs_s[kWarps][kRows][kHC];
  const AggTile T = agg_tile(g);
  const int nh = kNH > 0 ? kNH : g.nh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, half = lane / 16, l = lane % 16;
  const int64_t rows0 = (int64_t)T.p * g.na + T.i0;  // the tile's first row of [P * na]
  for (int k0 = 0; k0 < H; k0 += kHC) {
    const int k = k0 + l * V;
    const bool kin = k < H;
    float racc[kRows / 2][V];  // rows 2u + half, over this warp's columns
#pragma unroll
    for (int u = 0; u < kRows / 2; ++u)
#pragma unroll
      for (int x = 0; x < V; ++x) racc[u][x] = 0.f;
    for (int j0 = 0; j0 < g.nt; j0 += kCols) {
      __syncthreads();
      {  // head-summed weights: a thread a cell (warp = row, lane = column)
        const int j = j0 + lane;
        float m = 0.f, wa = 0.f, wn = 0.f;
        if (warp < T.nrows && j < g.nt) {
          m = g.m[(rows0 + warp) * g.nt + j];
          for (int h = 0; h < nh; ++h) {
            wa += attention<kNH>(g, true, h, T.p, T.i0 + warp, j, m);
            wn += attention<kNH>(g, false, h, T.p, T.i0 + warp, j, m);
          }
        }
        w_a[warp][lane] = wa;
        w_n[warp][lane] = wn;
        m_s[warp][lane] = m;
      }
      __syncthreads();
      for (int c = warp; c < kCols && j0 + c < g.nt; c += kWarps) {
        const int j = j0 + c;
        float v[kRows / 2][V];
        bool live[kRows / 2];
#pragma unroll
        for (int u = 0; u < kRows / 2; ++u) {  // the column's loads first, all in flight
          const int r = 2 * u + half;
          live[u] = kin && r < T.nrows && m_s[r][c] != 0.f;
          if (live[u])
            load_v<V>(v[u], he + ((rows0 + r) * g.nt + j) * H + k);
          else
#pragma unroll
            for (int x = 0; x < V; ++x) v[u][x] = 0.f;
        }
        float cacc[V];
#pragma unroll
        for (int x = 0; x < V; ++x) cacc[x] = 0.f;
#pragma unroll
        for (int u = 0; u < kRows / 2; ++u) {
          const int r = 2 * u + half;
          if (!live[u]) continue;
          const float wa = w_a[r][c], wn = w_n[r][c];
#pragma unroll
          for (int x = 0; x < V; ++x) {
            racc[u][x] = fmaf(wa, v[u][x], racc[u][x]);
            cacc[x] = fmaf(wn, v[u][x], cacc[x]);
          }
        }
#pragma unroll
        for (int x = 0; x < V; ++x) cacc[x] += __shfl_xor_sync(0xffffffffu, cacc[x], 16);
        if (half == 0 && kin) {
          float* out = T.ntiles == 1
                           ? cs + ((int64_t)T.p * g.nt + j) * H
                           : cs_part + (((int64_t)T.t * g.P + T.p) * g.nt + j) * H;
          store_v<V>(out + k, cacc);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kRows / 2; ++u)
#pragma unroll
      for (int x = 0; x < V; ++x) rs_s[warp][2 * u + half][l * V + x] = racc[u][x];
    __syncthreads();
    for (int x = threadIdx.x; x < kRows * kHC; x += kThreads) {
      const int r = x / kHC, kk = x % kHC;
      if (r < T.nrows && k0 + kk < H) {
        float acc = rs_s[0][r][kk];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) acc += rs_s[w][r][kk];
        rs[(rows0 + r) * H + k0 + kk] = acc;
      }
    }
  }
}

// The column sums go to dmc / dzc when the block has one row tile, else the
// raw sums to colpart [ntiles, nh, P, nt] for agg_col_finish_kernel.
template <int kNH, int V>
__global__ void __launch_bounds__(kThreads)
    gat_aggregate_bwd_kernel(AggArgs g, const float* __restrict__ he,
                             const float* __restrict__ grs, const float* __restrict__ gcs,
                             float* __restrict__ de, float* __restrict__ dmr,
                             float* __restrict__ dmc, float* __restrict__ dzr,
                             float* __restrict__ dzc, float* __restrict__ dhe,
                             float* __restrict__ colpart, int H) {
  constexpr int kHC = 16 * V;
  __shared__ float w_a[kRows][kCols], w_n[kRows][kCols], m_s[kRows][kCols];
  __shared__ float datt_a[kRows][kCols], datt_n[kRows][kCols];
  __shared__ float col_s[kHeadChunk][kRows][kCols + 1];
  __shared__ float att_s[2][kStash][kRows][kCols];  // a thread's own cell: no barrier needed
  const AggTile T = agg_tile(g);
  const int nh = kNH > 0 ? kNH : g.nh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, half = lane / 16, l = lane % 16;
  const int64_t rows0 = (int64_t)T.p * g.na + T.i0, ncell = (int64_t)g.na * g.nt;
  const int i_me = T.i0 + warp;  // the cell steps: warp = row, lane = column
  for (int j0 = 0; j0 < g.nt; j0 += kCols) {
    const int j_me = j0 + lane;
    const bool in = warp < T.nrows && j_me < g.nt;
    __syncthreads();
    // 1. each head's weights of the cell, once (the first kStash heads kept for step 3)
    float m = 0.f, wa = 0.f, wn = 0.f;
    if (in) m = g.m[(rows0 + warp) * g.nt + j_me];
    for (int h = 0; h < nh; ++h) {
      const float aa = in ? attention<kNH>(g, true, h, T.p, i_me, j_me, m) : 0.f;
      const float an = in ? attention<kNH>(g, false, h, T.p, i_me, j_me, m) : 0.f;
      wa += aa;
      wn += an;
      if (h < kStash) {
        att_s[0][h][warp][lane] = aa;
        att_s[1][h][warp][lane] = an;
      }
    }
    w_a[warp][lane] = wa;
    w_n[warp][lane] = wn;
    m_s[warp][lane] = m;
    __syncthreads();
    // 2. one pass over h_e: datt of each cell, and its d h_e
    for (int c = warp; c < kCols && j0 + c < g.nt; c += kWarps) {
      const int j = j0 + c;
      const float* gc_row = gcs + ((int64_t)T.p * g.nt + j) * H;
      float pa[kRows / 2], pn[kRows / 2];
#pragma unroll
      for (int u = 0; u < kRows / 2; ++u) pa[u] = pn[u] = 0.f;
      for (int k0 = 0; k0 < H; k0 += kHC) {
        const int k = k0 + l * V;
        if (k >= H) continue;
        float gc[V];
        load_v<V>(gc, gc_row + k);
        float v[kRows / 2][V], ga[kRows / 2][V];
#pragma unroll
        for (int u = 0; u < kRows / 2; ++u) {  // the column's loads first, all in flight
          const int r = 2 * u + half;
          if (r < T.nrows && m_s[r][c] != 0.f) {
            load_v<V>(v[u], he + ((rows0 + r) * g.nt + j) * H + k);
            load_v<V>(ga[u], grs + (rows0 + r) * H + k);
          } else {
#pragma unroll
            for (int x = 0; x < V; ++x) v[u][x] = ga[u][x] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kRows / 2; ++u) {
          const int r = 2 * u + half;
          if (r >= T.nrows) continue;
          const float a_w = w_a[r][c], n_w = w_n[r][c];
          float o[V];
#pragma unroll
          for (int x = 0; x < V; ++x) {
            pa[u] = fmaf(ga[u][x], v[u][x], pa[u]);
            pn[u] = fmaf(gc[x], v[u][x], pn[u]);
            o[x] = m_s[r][c] != 0.f ? a_w * ga[u][x] + n_w * gc[x] : 0.f;
          }
          store_v<V>(dhe + ((rows0 + r) * g.nt + j) * H + k, o);
        }
      }
#pragma unroll
      for (int u = 0; u < kRows / 2; ++u) {  // over the half-warp's 16 lanes, a fixed tree
        for (int o = 8; o > 0; o >>= 1) {
          pa[u] += __shfl_xor_sync(0xffffffffu, pa[u], o);
          pn[u] += __shfl_xor_sync(0xffffffffu, pn[u], o);
        }
        const int r = 2 * u + half;
        if (l == 0 && r < T.nrows) {
          datt_a[r][c] = pa[u];
          datt_n[r][c] = pn[u];
        }
      }
    }
    __syncthreads();
    // 3. de of every head; row sums by shuffles, column sums over the tile's rows
    const float dta = in ? datt_a[warp][lane] : 0.f, dtn = in ? datt_n[warp][lane] : 0.f;
    const bool last = j0 + kCols >= g.nt;
    for (int h0 = 0; h0 < nh; h0 += kHeadChunk) {
      for (int hh = 0; hh < kHeadChunk && h0 + hh < nh; ++hh) {
        const int h = h0 + hh;
        float aa, an;
        if (h < kStash) {
          aa = att_s[0][h][warp][lane];
          an = att_s[1][h][warp][lane];
        } else {
          aa = in ? attention<kNH>(g, true, h, T.p, i_me, j_me, m) : 0.f;
          an = in ? attention<kNH>(g, false, h, T.p, i_me, j_me, m) : 0.f;
        }
        const float pa = dta * aa, pn = dtn * an;
        const int64_t hp = (int64_t)h * g.P + T.p;
        if (in) de[hp * ncell + (int64_t)i_me * g.nt + j_me] = pa + pn;
        const float rsum = warp_sum(pa);
        if (lane == 0 && warp < T.nrows) {
          const int64_t o = hp * g.na + i_me;
          const float tot = j0 == 0 ? rsum : dmr[o] + rsum;
          if (last) {
            dmr[o] = -tot;
            dzr[o] = -tot / fmaxf(g.zr[o], kZFloor);
          } else {
            dmr[o] = tot;
          }
        }
        col_s[hh][warp][lane] = pn;
      }
      __syncthreads();
      for (int x = threadIdx.x; x < kHeadChunk * kCols; x += kThreads) {
        const int hh = x / kCols, c = x % kCols, h = h0 + hh, j = j0 + c;
        if (h < nh && j < g.nt) {
          float acc = col_s[hh][0][c];
#pragma unroll
          for (int r = 1; r < kRows; ++r) acc += col_s[hh][r][c];
          const int64_t o = ((int64_t)h * g.P + T.p) * g.nt + j;
          if (T.ntiles == 1) {
            dmc[o] = -acc;
            dzc[o] = -acc / fmaxf(g.zc[o], kZFloor);
          } else {
            colpart[(int64_t)T.t * nh * g.P * g.nt + o] = acc;
          }
        }
      }
      __syncthreads();
    }
  }
}

// d m_col / d z_col [n] from the row tiles' column sums colpart [ntiles, n], in tile order
__global__ void agg_col_finish_kernel(const float* __restrict__ colpart,
                                      const float* __restrict__ zc, float* __restrict__ dmc,
                                      float* __restrict__ dzc, int ntiles, int64_t n) {
  for (int64_t x = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; x < n;
       x += (int64_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < ntiles; ++t) acc += colpart[t * n + x];
    dmc[x] = -acc;
    dzc[x] = -acc / fmaxf(zc[x], kZFloor);
  }
}

// ------------------------------------------------------------ launches ----
int score_bands(int na) { return (na + kBand - 1) / kBand; }
int agg_tiles(int na) { return (na + kRows - 1) / kRows; }
// the backward takes rmax / cmax from its own tile (no statistics pass)
bool one_tile(int na, int nt) { return na <= kBand && nt <= kTile; }

int64_t score_scratch_floats(int P, int na, int nt, int nh, int H, bool backward, bool stats) {
  const int64_t nb = score_bands(na), HH = (int64_t)nh * H;
  const int64_t cpart = nb > 1 ? 2 * nb * nh * (int64_t)P * nt : 0;
  if (!backward) return stats ? cpart : 0;
  int64_t f = nb * P * HH;                // d a partials
  if (nb > 1) f += nb * P * (int64_t)nt * HH;  // d hn partials
  if (stats && !one_tile(na, nt)) f += cpart + 2 * (int64_t)nh * P * (na + nt);  // statistics
  return f;
}

int64_t agg_scratch_floats(int P, int na, int nt, int nh, int H, bool backward) {
  const int64_t ntiles = agg_tiles(na);
  if (ntiles == 1) return 0;
  return backward ? ntiles * nh * (int64_t)P * nt : ntiles * P * (int64_t)nt * H;
}

int grid_of(int64_t n) { return (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096); }

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int kNH, bool kStats>
cudaError_t scores_fwd(const void* ha, const void* hn, const void* a, const void* mask, void* e,
                       void* rmax, void* cmax, void* sal, void* sbl, void* cpart, int P, int na,
                       int nt, int nh, int H, float alpha, cudaStream_t s) {
  const int64_t blocks = (int64_t)P * nh * score_bands(na);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  gat_scores_fwd_kernel<kNH, kStats><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const float*)ha, (const float*)hn, (const float*)a, (const float*)mask, (float*)e,
      (float*)rmax, (float*)cmax, (float*)sal, (float*)sbl, (float*)cpart, P, na, nt, nh, H, alpha);
  cudaError_t err = cudaGetLastError();
  const int nb = score_bands(na);
  if (err != cudaSuccess || !kStats || nb == 1) return err;
  const int64_t n = (int64_t)nh * P * nt;
  merge_col_stats_kernel<<<grid_of(n), 256, 0, s>>>((const float*)cpart, (float*)cmax, (float*)sbl,
                                                    nb, n);
  return cudaGetLastError();
}

// The launches, for the stacked (kNH = 0, nh heads at run time) and the
// single-head (kNH = 1) instances of each body; the score kernels also
// without their statistics (kStats = false).
template <int kNH, bool kStats>
int launch_scores_fwd(const void* ha, const void* hn, const void* a, const void* mask, void* e,
                      void* rmax, void* cmax, void* sal, void* sbl, void* scratch, int P, int na,
                      int nt, int nh, int H, float alpha, void* stream) {
  if (P == 0 || na == 0 || nt == 0 || nh == 0) return (int)cudaSuccess;
  return (int)scores_fwd<kNH, kStats>(ha, hn, a, mask, e, rmax, cmax, sal, sbl, scratch, P, na, nt,
                                      nh, H, alpha, (cudaStream_t)stream);
}

template <int kNH, bool kStats>
int launch_scores_bwd(const void* ha, const void* hn, const void* a, const void* mask,
                      const void* ge, const void* gsal, const void* gsbl, void* dha, void* dhn,
                      void* scratch, void* da, int P, int na, int nt, int nh, int H, float alpha,
                      void* stream) {
  if (P == 0 || na == 0 || nt == 0 || nh == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nb = score_bands(na);
  const int64_t HH = (int64_t)nh * H, blocks = (int64_t)P * nh * nb;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  float* da_part = (float*)scratch;
  float* f = da_part + (int64_t)nb * P * HH;
  float* dhn_part = nullptr;
  if (nb > 1) {
    dhn_part = f;
    f += (int64_t)nb * P * nt * HH;
  }
  float *rmax = nullptr, *cmax = nullptr;
  cudaError_t err;
  if (kStats && !one_tile(na, nt)) {  // the forward's statistics first
    float* cpart = f;
    f += nb > 1 ? 2 * (int64_t)nb * nh * P * nt : 0;
    rmax = f;
    float* sal = rmax + (int64_t)nh * P * na;
    cmax = sal + (int64_t)nh * P * na;
    float* sbl = cmax + (int64_t)nh * P * nt;
    err = scores_fwd<kNH, true>(ha, hn, a, mask, nullptr, rmax, cmax, sal, sbl, cpart, P, na, nt,
                                nh, H, alpha, s);
    if (err != cudaSuccess) return (int)err;
  }
  gat_scores_bwd_kernel<kNH, kStats><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const float*)ha, (const float*)hn, (const float*)a, (const float*)mask, (const float*)ge,
      (const float*)gsal, (const float*)gsbl, rmax, cmax, (float*)dha, (float*)dhn, dhn_part,
      da_part, P, na, nt, nh, H, alpha);
  err = cudaGetLastError();
  if (err != cudaSuccess || HH == 0) return (int)err;
  if (nb > 1) {
    const int64_t n = (int64_t)P * nt * HH;
    sum_tiles_kernel<<<grid_of(n), 256, 0, s>>>(dhn_part, (float*)dhn, nb, n, -1.f);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sum_partials_kernel<<<(unsigned)((HH + 31) / 32), kThreads, 0, s>>>(da_part, (float*)da, P * nb,
                                                                     HH);
  return (int)cudaGetLastError();
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

template <int kNH>
int launch_aggregate_fwd(const void* e, const void* mr, const void* mc, const void* zr,
                         const void* zc, const void* he, const void* mask, const void* ka,
                         const void* kn, void* rs, void* cs, void* scratch, int P, int na, int nt,
                         int nh, int H, int nk, float keep, void* stream) {
  if (P == 0 || na == 0 || nt == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = agg_tiles(na);
  const int64_t blocks = (int64_t)P * ntiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const AggArgs g = agg_args(e, mr, mc, zr, zc, mask, ka, kn, P, na, nt, nh, nk, keep);
  const bool v4 = H % 4 == 0 && aligned16(he) && aligned16(rs) && aligned16(cs) &&
                  aligned16(scratch);
  if (v4)
    gat_aggregate_fwd_kernel<kNH, 4><<<(unsigned)blocks, kThreads, 0, s>>>(
        g, (const float*)he, (float*)rs, (float*)cs, (float*)scratch, H);
  else
    gat_aggregate_fwd_kernel<kNH, 1><<<(unsigned)blocks, kThreads, 0, s>>>(
        g, (const float*)he, (float*)rs, (float*)cs, (float*)scratch, H);
  cudaError_t err = cudaGetLastError();
  const int64_t n = (int64_t)P * nt * H;
  if (err != cudaSuccess || ntiles == 1 || n == 0) return (int)err;
  sum_tiles_kernel<<<grid_of(n), 256, 0, s>>>((const float*)scratch, (float*)cs, ntiles, n, 1.f);
  return (int)cudaGetLastError();
}

template <int kNH>
int launch_aggregate_bwd(const void* e, const void* mr, const void* mc, const void* zr,
                         const void* zc, const void* he, const void* mask, const void* ka,
                         const void* kn, const void* grs, const void* gcs, void* de, void* dmr,
                         void* dmc, void* dzr, void* dzc, void* dhe, void* scratch, int P, int na,
                         int nt, int nh, int H, int nk, float keep, void* stream) {
  if (P == 0 || na == 0 || nt == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = agg_tiles(na);
  const int64_t blocks = (int64_t)P * ntiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const AggArgs g = agg_args(e, mr, mc, zr, zc, mask, ka, kn, P, na, nt, nh, nk, keep);
  const bool v4 = H % 4 == 0 && aligned16(he) && aligned16(grs) && aligned16(gcs) &&
                  aligned16(dhe);
  if (v4)
    gat_aggregate_bwd_kernel<kNH, 4><<<(unsigned)blocks, kThreads, 0, s>>>(
        g, (const float*)he, (const float*)grs, (const float*)gcs, (float*)de, (float*)dmr,
        (float*)dmc, (float*)dzr, (float*)dzc, (float*)dhe, (float*)scratch, H);
  else
    gat_aggregate_bwd_kernel<kNH, 1><<<(unsigned)blocks, kThreads, 0, s>>>(
        g, (const float*)he, (const float*)grs, (const float*)gcs, (float*)de, (float*)dmr,
        (float*)dmc, (float*)dzr, (float*)dzc, (float*)dhe, (float*)scratch, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ntiles == 1) return (int)err;
  const int64_t n = (int64_t)nh * P * nt;
  agg_col_finish_kernel<<<grid_of(n), 256, 0, s>>>((const float*)scratch, (const float*)zc,
                                                   (float*)dmc, (float*)dzc, ntiles, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch a call needs (0: none, any pointer will do), written to
// *out: the score kernels (kind 0; stats = 0 for gat0_*) or the aggregate
// kernels (kind 1), forward (backward = 0) or backward.
extern "C" int tm_gat_scratch_floats(int kind, int P, int na, int nt, int nh, int H, int backward,
                                     int stats, int64_t* out) {
  *out = kind == 0 ? score_scratch_floats(P, na, nt, nh, H, backward != 0, stats != 0)
                   : agg_scratch_floats(P, na, nt, nh, H, backward != 0);
  return 0;
}

// ha: f32[P, na, nh*H]; hn: f32[P, nt, nh*H]; a: f32[nh*H]; mask: f32[P, na, nt].
// out: e f32[nh, P, na, nt], rmax / sa_l f32[nh, P, na], cmax / sb_l f32[nh, P, nt].
extern "C" int tm_gat_scores_fwd(const void* ha, const void* hn, const void* a, const void* mask,
                                 void* e, void* rmax, void* cmax, void* sal, void* sbl,
                                 void* scratch, int P, int na, int nt, int nh, int H, float alpha,
                                 void* stream) {
  return launch_scores_fwd<0, true>(ha, hn, a, mask, e, rmax, cmax, sal, sbl, scratch, P, na, nt,
                                    nh, H, alpha, stream);
}

// Inputs as tm_gat_scores_fwd plus the cotangents ge (shape of e), gsal
// (sa_l), gsbl (sb_l).  Writes d ha, d hn (shapes of ha, hn) and da
// f32[nh*H], with the scratch tm_gat_scratch_floats asks for.
extern "C" int tm_gat_scores_bwd(const void* ha, const void* hn, const void* a, const void* mask,
                                 const void* ge, const void* gsal, const void* gsbl, void* dha,
                                 void* dhn, void* scratch, void* da, int P, int na, int nt, int nh,
                                 int H, float alpha, void* stream) {
  return launch_scores_bwd<0, true>(ha, hn, a, mask, ge, gsal, gsbl, dha, dhn, scratch, da, P, na,
                                    nt, nh, H, alpha, stream);
}

// e: f32[nh, P, na, nt]; m_row / z_row: f32[nh, P, na]; m_col / z_col:
// f32[nh, P, nt]; h_e: f32[P, na, nt, H]; mask: f32[P, na, nt]; ka / kn:
// f32[nk, P, na, nt] with nk = 1 or nh, read only when keep < 1.
// out: rs f32[P, na, H], cs f32[P, nt, H].
extern "C" int tm_gat_aggregate_fwd(const void* e, const void* mr, const void* mc, const void* zr,
                                    const void* zc, const void* he, const void* mask,
                                    const void* ka, const void* kn, void* rs, void* cs,
                                    void* scratch, int P, int na, int nt, int nh, int H, int nk,
                                    float keep, void* stream) {
  return launch_aggregate_fwd<0>(e, mr, mc, zr, zc, he, mask, ka, kn, rs, cs, scratch, P, na, nt,
                                 nh, H, nk, keep, stream);
}

// Inputs as tm_gat_aggregate_fwd plus the cotangents g_rs f32[P, na, H] and
// g_cs f32[P, nt, H].  out: de f32[nh, P, na, nt], d m_row / d z_row
// f32[nh, P, na], d m_col / d z_col f32[nh, P, nt], d h_e f32[P, na, nt, H].
extern "C" int tm_gat_aggregate_bwd(const void* e, const void* mr, const void* mc, const void* zr,
                                    const void* zc, const void* he, const void* mask,
                                    const void* ka, const void* kn, const void* grs,
                                    const void* gcs, void* de, void* dmr, void* dmc, void* dzr,
                                    void* dzc, void* dhe, void* scratch, int P, int na, int nt,
                                    int nh, int H, int nk, float keep, void* stream) {
  return launch_aggregate_bwd<0>(e, mr, mc, zr, zc, he, mask, ka, kn, grs, gcs, de, dmr, dmc, dzr,
                                 dzc, dhe, scratch, P, na, nt, nh, H, nk, keep, stream);
}

// One head (gat_scores_stats, pallas_gat.py:224): ha f32[P, na, H], hn
// f32[P, nt, H], a f32[H], mask f32[P, na, nt].  out: e f32[P, na, nt], rmax /
// sa_l f32[P, na], cmax / sb_l f32[P, nt].
extern "C" int tm_gat1_scores_fwd(const void* ha, const void* hn, const void* a, const void* mask,
                                  void* e, void* rmax, void* cmax, void* sal, void* sbl,
                                  void* scratch, int P, int na, int nt, int H, float alpha,
                                  void* stream) {
  return launch_scores_fwd<1, true>(ha, hn, a, mask, e, rmax, cmax, sal, sbl, scratch, P, na, nt,
                                    1, H, alpha, stream);
}

// Its backward (pallas_gat.py:264): inputs as tm_gat1_scores_fwd plus the
// cotangents ge, gsal, gsbl; writes d ha, d hn and da f32[H], with scratch.
extern "C" int tm_gat1_scores_bwd(const void* ha, const void* hn, const void* a, const void* mask,
                                  const void* ge, const void* gsal, const void* gsbl, void* dha,
                                  void* dhn, void* scratch, void* da, int P, int na, int nt, int H,
                                  float alpha, void* stream) {
  return launch_scores_bwd<1, true>(ha, hn, a, mask, ge, gsal, gsbl, dha, dhn, scratch, da, P, na,
                                    nt, 1, H, alpha, stream);
}

// One head (gat_aggregate, pallas_gat.py:350): e, ka, kn, mask f32[P, na,
// nt]; m_row / z_row f32[P, na]; m_col / z_col f32[P, nt]; h_e f32[P, na,
// nt, H]; the keep masks are read only when keep < 1.  out: rs f32[P, na, H],
// cs f32[P, nt, H].
extern "C" int tm_gat1_aggregate_fwd(const void* e, const void* mr, const void* mc,
                                     const void* zr, const void* zc, const void* he,
                                     const void* mask, const void* ka, const void* kn, void* rs,
                                     void* cs, void* scratch, int P, int na, int nt, int H,
                                     float keep, void* stream) {
  return launch_aggregate_fwd<1>(e, mr, mc, zr, zc, he, mask, ka, kn, rs, cs, scratch, P, na, nt,
                                 1, H, 1, keep, stream);
}

// Its backward (pallas_gat.py:408, with _datt inside): inputs as
// tm_gat1_aggregate_fwd plus g_rs f32[P, na, H], g_cs f32[P, nt, H].  out: de
// f32[P, na, nt], d m_row / d z_row f32[P, na], d m_col / d z_col f32[P, nt],
// d h_e f32[P, na, nt, H].
extern "C" int tm_gat1_aggregate_bwd(const void* e, const void* mr, const void* mc,
                                     const void* zr, const void* zc, const void* he,
                                     const void* mask, const void* ka, const void* kn,
                                     const void* grs, const void* gcs, void* de, void* dmr,
                                     void* dmc, void* dzr, void* dzc, void* dhe, void* scratch,
                                     int P, int na, int nt, int H, float keep, void* stream) {
  return launch_aggregate_bwd<1>(e, mr, mc, zr, zc, he, mask, ka, kn, grs, gcs, de, dmr, dmc, dzr,
                                 dzc, dhe, scratch, P, na, nt, 1, H, 1, keep, stream);
}

// gat_scores (pallas_gat.py:78): ha f32[P, na, H], hn f32[P, nt, H], a f32[H],
// mask f32[P, na, nt].  out: e f32[P, na, nt].
extern "C" int tm_gat0_scores_fwd(const void* ha, const void* hn, const void* a, const void* mask,
                                  void* e, int P, int na, int nt, int H, float alpha,
                                  void* stream) {
  return launch_scores_fwd<1, false>(ha, hn, a, mask, e, nullptr, nullptr, nullptr, nullptr,
                                     nullptr, P, na, nt, 1, H, alpha, stream);
}

// Its VJP (pallas_gat.py:115): inputs as tm_gat0_scores_fwd plus the
// cotangent ge f32[P, na, nt]; writes d ha, d hn and da f32[H], with scratch.
extern "C" int tm_gat0_scores_bwd(const void* ha, const void* hn, const void* a, const void* mask,
                                  const void* ge, void* dha, void* dhn, void* scratch, void* da,
                                  int P, int na, int nt, int H, float alpha, void* stream) {
  return launch_scores_bwd<1, false>(ha, hn, a, mask, ge, nullptr, nullptr, dha, dhn, scratch, da,
                                     P, na, nt, 1, H, alpha, stream);
}
