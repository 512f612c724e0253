// Hopper (sm_90a) kernels for the block train step.  Built by
// trackmpnn_tpu_torch/ops/_build.py into a shared library with a plain C
// interface and called through ctypes from ops/block.py, which checks
// device, dtype, shape and contiguity before any pointer gets here.  All
// math is f32 but the incidence sums (f64, rounded to f32 once); no kernel
// uses atomics, so every result is the same from run to run whatever order
// the blocks run in.
//
// block_round_fwd
//   Replaces _fwd_kernel / fused_block_round in
//   trackmpnn_tpu/ops/pallas_block.py.  Per block q of P, on its rectangle
//   of na x nt edge cells of width H:
//     he_m = mask * h_e;  gh = he_m @ w_hh + b_hh           ([H, 3H] product)
//     gi[i, j] = ga[i] + sign * gb[j];  r, z, n (torch order r | z | n)
//     edge_out = mask * ((1 - z) * n + z * he_m);  lg = edge_out @ w_eb
//     rs, cs = row / column sums of he_m
//   Bound: f32 operations (2*H*3H multiply-adds a cell for gh against
//   H*4 B read and written a cell: ~50 flop/B at H = 64, above the card's
//   f32 ratio of 67 TFLOP/s over 3.35 TB/s = 20 flop/B).  Design: a block's
//   cells split over kRoundSplits CTAs (tile t goes to CTA t mod
//   kRoundSplits, row and column i to CTA i mod kRoundSplits for rs / cs),
//   so that at P ~ 100 blocks several CTAs share each SM; w_hh sits in
//   shared memory (49 KB at H = 64, past the 48 KB default, so the launch
//   opts in to more) with its rows padded to 3H + 1 floats, so that both
//   w_hh[k][h] (forward) and w_hh[h][k] (backward) reads by neighbouring h
//   fall in different banks.  Cells go through in tiles of TC; thread
//   (h, g) keeps the three gate sums of kCellsPerThread cells of column h
//   in registers while he_m comes from shared memory as a broadcast.  A
//   tile whose cells are all masked is written as zeros and skips the
//   product, so the work follows the live cells.  rs and cs are reduced in
//   the CTA in a fixed order at the end.  The product runs on the CUDA
//   cores, not the tensor cores: a later step.
//
// block_round_bwd
//   Replaces _bwd_kernel (the custom VJP of fused_block_round).  Per block
//   it recomputes the gates and writes d h_e (masked), d ga (sum over j)
//   and d gb (sign * sum over i), and a row of per-block partials
//   [d w_hh | d b_hh | d w_eb]; a second small kernel sums the partials
//   over the blocks in block order.  Bound: f32 operations (three [H, 3H]
//   products a cell: gh again, d gh @ w_hh^T and he_m^T @ d gh).  The
//   per-block d w_hh, d ga and d gb accumulate in shared memory, each entry
//   owned by one thread, tile after tile, so no atomics are needed.  The
//   products are bound by shared-memory loads on the CUDA cores, so each
//   value loaded is used several times: a w_hh value for 8 cells, a d gh
//   value for 8 rows of d w_hh.
//
// window_scatter
//   Replaces _wscatter_kernel / window_scatter in pallas_block.py.
//   out[(p % B)*capD + idx[p, i]] += vals[p, i]  over blocks p and rows i,
//   computed as a pull over a destination-sorted incidence: out[d] = the sum
//   of the source rows in d's list inc_slot[inc_ptr[d] .. inc_ptr[d+1]), in
//   list order, up to the first slot of a block >= P.  A slot q*(na + nt) + r
//   is row r of block q's src_a [P, na, F] where r < na, else row r - na of
//   src_b [P, nt, F].  Callers pass the batch's detection incidence
//   (BlockBatch.det_inc_*, the es round's), built once a batch: the es sum
//   scatters cat([rs, -cs]) as src_a with na = na_cap + nt_cap, nt = 0
//   (every slot a row of it); the backward of window_gather2 scatters d ga
//   (src_a, rows) and d gb (src_b, columns) in one launch into two outputs,
//   of the same width or not (a column past one side's width reads none of
//   that side).
//   That incidence lists only rows and columns of blocks with cells, where
//   every caller's values are 0 elsewhere; without one the wrapper builds
//   the full incidence of idx on the device (every position).
//   Bound: device-memory bytes (the sources read once, out written once).
//   The first design ran one CTA a (window, 64-column tile): 8 CTAs at
//   F 64 and 24 at F 192 on 132 SMs, each staging every block of its window
//   through 64 KiB of shared memory into a capD x 64 accumulator, every warp
//   scanning every staged id for its 1/8 of them: 39.00 us at F 192 and
//   54.97 at F 64 against bounds of 1.13 and 0.60, slower than its own plain
//   version and 4.9-7.3x one index_add_, and capD was bounded by shared
//   memory.  Here a group of S adjacent lanes owns one float4 column of one
//   destination row (B*capD*F/4 groups, ~98k at F 192) and walks the row's
//   list alone: lane s takes entries s, s + S, ..., kWsUnroll slots then
//   their values in flight, sums them in f64, and the S lanes combine by a
//   fixed shuffle tree; f32 rounding once.  S is the launch's: a batch
//   incidence holds at most one entry a block for a detection (lists of
//   about ceil(P/B) + 1), the full one every padded position (lists up to
//   ceil(P/B) * (na + nt)), and the entry point picks the smallest power
//   of two up to 32 that cuts the longest possible list to kWsUnroll a lane,
//   but no more lanes than keep the grid within one wave of the threads the
//   card holds resident (SMs x the kernel's occupancy, asked once a device)
//   (at F 192 a wave holds ~2.7 lanes a group; more lanes add waves of
//   the same three dependent loads: offsets, slots, values).  No shared
//   memory, no atomics, one launch; any capD.  Every id of idx is
//   checked over the grid: one outside [0, capD) traps the kernel (a sticky
//   CUDA error that the next synchronisation raises), as do a negative slot
//   and a list's offsets outside the slots.

// block_round_es_fwd
//   Replaces _es_fwd_kernel / fused_block_round_es in pallas_block.py:333,
//   the round with the input-gate gather and the edge-support reduction
//   inside.  Two launches: block_round_fwd_kernel<true>, which reads the
//   gates of row i and column j by index, ga_d[w*capD + act[q, i]] + b_ih
//   and gb_d[w*capD + new[q, j]] (w = q % B, step-major blocks), instead of
//   per-block rows, and writes the block's row and column sums to scratch;
//   then incidence_reduce_kernel, one thread per (detection, column): es[d]
//   = the row sums of d's active rows minus the column sums of its new
//   columns, walked in the order of the batch's incidence (block order),
//   summed in f64 and rounded once, stopping at the first block >= P.  The
//   TPU kernel gathers and scatters with one-hot matmuls over the window's
//   capD rows (_onehot_t, :319), an MXU idiom; here a CTA loads its own
//   indices, and an id outside [0, capD) traps the kernel.  Bound: f32
//   operations, as block_round_fwd (the reduction moves P*(na+nt)*H floats).
//
// block_round_es_bwd
//   Replaces _es_bwd_kernel (pallas_block.py:382).  block_round_bwd_kernel
//   <true> recomputes the gates from the gathered rows, takes the
//   cotangents of the row and column sums as d es[act_i] and -d es[new_j]
//   read by index, and adds d b_ih (the sum of the block's d ga rows) to
//   its per-block partials; sum_partials_kernel sums them in block order;
//   incidence_reduce_kernel then sums the per-block d ga / d gb rows over
//   the same incidence into d ga_d and d gb_d [B*capD, 3H], in f64, with
//   no atomics.  Bound: f32 operations, as block_round_bwd.
//
// No kernel synchronises or allocates: the caller allocates every output
// and scratch and every launch goes to the stream it is given.  Each entry
// point returns cudaGetLastError() so the caller can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsTarget = 256;
constexpr int kCellsPerThread = 8;
constexpr int kDwRows = 8;  // rows of d w_hh a backward thread sums at once (H % 8 == 0)
constexpr int kWsThreads = 256;
constexpr int kWsUnroll = 8;  // slots (then values) a lane has in flight
constexpr int kRoundSplits = 4;  // CTAs a block's forward is split over

// threads of a block-round CTA: H columns times G cell groups
inline int round_groups(int H) { return H >= kThreadsTarget ? 1 : kThreadsTarget / H; }

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// Where a round kernel reads the input gates of row i and column j of block
// q.  kGather false: per-block rows ga[P, na, 3H], gb[P, nt, 3H] (b_ih
// already in ga).  kGather true: the detection layout ga_d / gb_d [B*capD,
// 3H] at row (q % B)*capD + the window-local id act[q, i] / new[q, j], with
// b_ih added to the ga side; an id outside [0, capD) traps.
struct GateSrc {
  const float *ga, *gb, *bih;
  const int32_t *act, *nw;
  int B, capD;
};

template <bool kGather>
__device__ __forceinline__ void gate_rows(const GateSrc& g, int64_t q, int i, int j, int na,
                                          int nt, int H3, const float*& gai,
                                          const float*& gbj, int64_t& da, int64_t& dn) {
  if constexpr (kGather) {
    const int a = g.act[q * na + i], n = g.nw[q * nt + j];
    if ((unsigned)a >= (unsigned)g.capD || (unsigned)n >= (unsigned)g.capD) __trap();
    const int64_t base = (q % g.B) * (int64_t)g.capD;
    da = base + a;
    dn = base + n;
    gai = g.ga + da * H3;
    gbj = g.gb + dn * H3;
  } else {
    da = q * na + i;
    dn = q * nt + j;
    gai = g.ga + da * H3;
    gbj = g.gb + dn * H3;
  }
}

// ga's gate k of the row at gai: plus b_ih where the kernel gathers
template <bool kGather>
__device__ __forceinline__ float ga_at(const GateSrc& g, const float* gai, int k) {
  if constexpr (kGather) return gai[k] + g.bih[k];
  return gai[k];
}

struct RoundSmem {
  float *w, *b, *web, *he, *m;
};

__device__ __forceinline__ RoundSmem round_common_smem(float* smem, int H, int TC) {
  RoundSmem s;
  s.w = smem;                        // [H][3H + 1]
  s.b = s.w + H * (3 * H + 1);       // [3H]
  s.web = s.b + 3 * H;               // [H]
  s.he = s.web + H;                  // [TC][H]  masked h_e of the tile
  s.m = s.he + TC * H;               // [TC]     mask of the tile
  return s;
}

__device__ void load_weights(const RoundSmem& s, const float* whh, const float* bhh,
                             const float* web, int H) {
  const int H3 = 3 * H, ws = H3 + 1;
  for (int k = threadIdx.x; k < H * H3; k += blockDim.x) s.w[(k / H3) * ws + k % H3] = whh[k];
  for (int k = threadIdx.x; k < H3; k += blockDim.x) s.b[k] = bhh[k];
  for (int k = threadIdx.x; k < H; k += blockDim.x) s.web[k] = web[k];
}

// Loads the tile's masked h_e and mask; returns whether any cell is live
// (a block-wide vote, so it also separates the tile from the one before).
__device__ bool load_tile(const RoundSmem& s, const float* he, const float* mask,
                          int64_t cell0, int t0, int ncell, int TC, int H) {
  int live = 0;
  for (int c = threadIdx.x; c < TC; c += blockDim.x) {
    const float m = (t0 + c < ncell) ? mask[cell0 + t0 + c] : 0.f;
    s.m[c] = m;
    live |= (m != 0.f);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < TC * H; k += blockDim.x) {
    const int c = k / H;
    const float m = s.m[c];
    s.he[k] = (m != 0.f) ? m * he[(cell0 + t0 + c) * H + k % H] : 0.f;
  }
  return __syncthreads_or(live) != 0;
}

// The three gh sums (without b_hh) of column h for this thread's cells.
__device__ __forceinline__ void gate_products(const RoundSmem& s, int h, int g, int H,
                                              float (&ar)[kCellsPerThread],
                                              float (&az)[kCellsPerThread],
                                              float (&an)[kCellsPerThread]) {
  const int ws = 3 * H + 1;
#pragma unroll
  for (int cc = 0; cc < kCellsPerThread; ++cc) ar[cc] = az[cc] = an[cc] = 0.f;
  const float* hrow = s.he + g * kCellsPerThread * H;
  for (int k = 0; k < H; ++k) {
    const float wr = s.w[k * ws + h], wz = s.w[k * ws + H + h], wn = s.w[k * ws + 2 * H + h];
#pragma unroll
    for (int cc = 0; cc < kCellsPerThread; ++cc) {
      const float x = hrow[cc * H + k];
      ar[cc] = fmaf(x, wr, ar[cc]);
      az[cc] = fmaf(x, wz, az[cc]);
      an[cc] = fmaf(x, wn, an[cc]);
    }
  }
}

// Row and column sums of the masked rectangle of block q, in a fixed order:
// rows and columns split + nsplit * k of it.
__device__ void row_col_sums(const float* he, const float* mask, int64_t q, int na, int nt,
                             int H, float* rs, float* cs, int split, int nsplit) {
  const int64_t cell0 = q * na * nt;
  const int my_rows = (na - split + nsplit - 1) / nsplit, my_cols = (nt - split + nsplit - 1) / nsplit;
  for (int k = threadIdx.x; k < my_rows * H; k += blockDim.x) {
    const int i = split + nsplit * (k / H), h = k % H;
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < nt; ++j) {
      const int64_t cell = cell0 + (int64_t)i * nt + j;
      acc += mask[cell] * he[cell * H + h];
    }
    rs[(q * na + i) * H + h] = acc;
  }
  for (int k = threadIdx.x; k < my_cols * H; k += blockDim.x) {
    const int j = split + nsplit * (k / H), h = k % H;
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < na; ++i) {
      const int64_t cell = cell0 + (int64_t)i * nt + j;
      acc += mask[cell] * he[cell * H + h];
    }
    cs[(q * nt + j) * H + h] = acc;
  }
}

template <bool kGather>
__global__ void block_round_fwd_kernel(const float* __restrict__ he, const GateSrc gsrc,
                                       const float* __restrict__ whh,
                                       const float* __restrict__ bhh,
                                       const float* __restrict__ web,
                                       const float* __restrict__ mask,
                                       float* __restrict__ eo, float* __restrict__ rs,
                                       float* __restrict__ cs, float* __restrict__ lg,
                                       int na, int nt, int H, float sign) {
  extern __shared__ float smem[];
  const int G = blockDim.x / H, TC = G * kCellsPerThread;
  const RoundSmem s = round_common_smem(smem, H, TC);
  float* eo_s = s.m + TC;  // [TC][H]
  const int H3 = 3 * H, h = threadIdx.x % H, g = threadIdx.x / H;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const int64_t q = blockIdx.x;
  const int split = blockIdx.y, nsplit = gridDim.y;  // this CTA's share of the block
  const int ncell = na * nt;
  const int64_t cell0 = q * ncell;
  load_weights(s, whh, bhh, web, H);

  for (int t0 = split * TC; t0 < ncell; t0 += nsplit * TC) {
    if (!load_tile(s, he, mask, cell0, t0, ncell, TC, H)) {
      for (int k = threadIdx.x; k < TC * H; k += blockDim.x)
        if (t0 + k / H < ncell) eo[(cell0 + t0) * H + k] = 0.f;
      for (int c = threadIdx.x; c < TC; c += blockDim.x)
        if (t0 + c < ncell) lg[cell0 + t0 + c] = 0.f;
      continue;
    }
    float ar[kCellsPerThread], az[kCellsPerThread], an[kCellsPerThread];
    gate_products(s, h, g, H, ar, az, an);
#pragma unroll
    for (int cc = 0; cc < kCellsPerThread; ++cc) {
      const int c = g * kCellsPerThread + cc, cell = t0 + c;
      const float m = s.m[c];
      float out = 0.f;
      if (m != 0.f) {
        const int i = cell / nt, j = cell % nt;
        const float *gai, *gbj;
        int64_t da, dn;
        gate_rows<kGather>(gsrc, q, i, j, na, nt, H3, gai, gbj, da, dn);
        const float hm = s.he[c * H + h];
        const float r = sigmoid_f((ga_at<kGather>(gsrc, gai, h) + sign * gbj[h])
                                  + (ar[cc] + s.b[h]));
        const float z = sigmoid_f((ga_at<kGather>(gsrc, gai, H + h) + sign * gbj[H + h])
                                  + (az[cc] + s.b[H + h]));
        const float n = tanhf((ga_at<kGather>(gsrc, gai, 2 * H + h) + sign * gbj[2 * H + h])
                              + r * (an[cc] + s.b[2 * H + h]));
        out = m * ((1.f - z) * n + z * hm);
      }
      eo_s[c * H + h] = out;
      if (cell < ncell) eo[(cell0 + cell) * H + h] = out;
    }
    __syncthreads();
    // head partial lg = edge_out @ w_eb: one warp per cell, lanes over h,
    // a fixed shuffle tree
    for (int c = warp; c < TC; c += nwarps) {
      float acc = 0.f;
      for (int k = lane; k < H; k += 32) acc = fmaf(eo_s[c * H + k], s.web[k], acc);
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0 && t0 + c < ncell) lg[cell0 + t0 + c] = acc;
    }
    __syncthreads();
  }
  row_col_sums(he, mask, q, na, nt, H, rs, cs, split, nsplit);
}

// kGather: the gates as block_round_fwd_kernel<true> reads them, the
// cotangents of the row and column sums read as grs[da] and -gcs[dn] (grs =
// gcs = d es on the detection layout), and d b_ih (the sum of the block's d
// ga rows) appended to the partials row.
template <bool kGather>
__global__ void block_round_bwd_kernel(const float* __restrict__ he, const GateSrc gsrc,
                                       const float* __restrict__ whh,
                                       const float* __restrict__ bhh,
                                       const float* __restrict__ web,
                                       const float* __restrict__ mask,
                                       const float* __restrict__ geo,
                                       const float* __restrict__ grs,
                                       const float* __restrict__ gcs,
                                       const float* __restrict__ glg,
                                       float* __restrict__ dhe, float* __restrict__ dga,
                                       float* __restrict__ dgb, float* __restrict__ part,
                                       int na, int nt, int H, float sign) {
  extern __shared__ float smem[];
  const int G = blockDim.x / H, TC = G * kCellsPerThread;
  const RoundSmem s = round_common_smem(smem, H, TC);
  const int H3 = 3 * H, ws = H3 + 1;
  float* glg_s = s.m + TC;        // [TC]
  float* dgh_s = glg_s + TC;      // [TC][3H]  d gh: r | z | n*r
  float* dgn_s = dgh_s + TC * H3; // [TC][H]   d gi of n (= d pre_n)
  float* dw_s = dgn_s + TC * H;   // [H][3H]   this block's d w_hh
  float* dga_s = dw_s + H * H3;   // [na][3H]
  float* dgb_s = dga_s + na * H3; // [nt][3H]
  float* red_s = dgb_s + nt * H3; // [G][4H]   cross-group d b_hh | d w_eb
  const int h = threadIdx.x % H, g = threadIdx.x / H;
  const int64_t q = blockIdx.x;
  const int ncell = na * nt;
  const int64_t cell0 = q * ncell;
  load_weights(s, whh, bhh, web, H);
  for (int k = threadIdx.x; k < H * H3; k += blockDim.x) dw_s[k] = 0.f;
  for (int k = threadIdx.x; k < (na + nt) * H3; k += blockDim.x) dga_s[k] = 0.f;
  float db_r = 0.f, db_z = 0.f, db_n = 0.f, dweb_acc = 0.f;

  for (int t0 = 0; t0 < ncell; t0 += TC) {
    if (!load_tile(s, he, mask, cell0, t0, ncell, TC, H)) {
      for (int k = threadIdx.x; k < TC * H; k += blockDim.x)
        if (t0 + k / H < ncell) dhe[(cell0 + t0) * H + k] = 0.f;
      continue;
    }
    for (int c = threadIdx.x; c < TC; c += blockDim.x)
      glg_s[c] = (t0 + c < ncell) ? glg[cell0 + t0 + c] : 0.f;
    __syncthreads();
    float ar[kCellsPerThread], az[kCellsPerThread], an[kCellsPerThread];
    gate_products(s, h, g, H, ar, az, an);
    float direct[kCellsPerThread];  // go * z, the part of d he_m not through w_hh
#pragma unroll
    for (int cc = 0; cc < kCellsPerThread; ++cc) {
      const int c = g * kCellsPerThread + cc, cell = t0 + c;
      const float m = s.m[c];
      float d_r = 0.f, d_z = 0.f, d_n = 0.f, r = 0.f;
      direct[cc] = 0.f;
      if (m != 0.f) {
        const int i = cell / nt, j = cell % nt;
        const float *gai, *gbj;
        int64_t da, dn;
        gate_rows<kGather>(gsrc, q, i, j, na, nt, H3, gai, gbj, da, dn);
        const float hm = s.he[c * H + h];
        r = sigmoid_f((ga_at<kGather>(gsrc, gai, h) + sign * gbj[h]) + (ar[cc] + s.b[h]));
        const float z = sigmoid_f((ga_at<kGather>(gsrc, gai, H + h) + sign * gbj[H + h])
                                  + (az[cc] + s.b[H + h]));
        const float ghn = an[cc] + s.b[2 * H + h];
        const float n = tanhf((ga_at<kGather>(gsrc, gai, 2 * H + h) + sign * gbj[2 * H + h])
                              + r * ghn);
        const float gl = glg_s[c];
        const float go = (geo[(cell0 + cell) * H + h] + gl * s.web[h]) * m;
        const float out = m * ((1.f - z) * n + z * hm);
        dweb_acc = fmaf(out, gl, dweb_acc);
        const float dz = go * (hm - n);
        d_n = go * (1.f - z) * (1.f - n * n);
        d_r = d_n * ghn * r * (1.f - r);
        d_z = dz * z * (1.f - z);
        direct[cc] = go * z;
      }
      dgh_s[c * H3 + h] = d_r;
      dgh_s[c * H3 + H + h] = d_z;
      dgh_s[c * H3 + 2 * H + h] = d_n * r;
      dgn_s[c * H + h] = d_n;
      db_r += d_r;
      db_z += d_z;
      db_n += d_n * r;
    }
    __syncthreads();
    // d h_e = mask * (go * z + d gh @ w_hh^T + g_rs[i] + g_cs[j])
    {
      float acc[kCellsPerThread];
#pragma unroll
      for (int cc = 0; cc < kCellsPerThread; ++cc) acc[cc] = 0.f;
      const float* drow = dgh_s + g * kCellsPerThread * H3;
      const float* wrow = s.w + h * ws;
      for (int k = 0; k < H3; ++k) {
        const float wk = wrow[k];
#pragma unroll
        for (int cc = 0; cc < kCellsPerThread; ++cc) acc[cc] = fmaf(drow[cc * H3 + k], wk, acc[cc]);
      }
#pragma unroll
      for (int cc = 0; cc < kCellsPerThread; ++cc) {
        const int c = g * kCellsPerThread + cc, cell = t0 + c;
        if (cell >= ncell) continue;
        const float m = s.m[c];
        float v = 0.f;
        if (m != 0.f) {
          const int i = cell / nt, j = cell % nt;
          const float *gai, *gbj;
          int64_t da, dn;
          gate_rows<kGather>(gsrc, q, i, j, na, nt, H3, gai, gbj, da, dn);
          if constexpr (kGather) {
            v = m * (((direct[cc] + acc[cc]) + grs[da * H + h]) + -gcs[dn * H + h]);
          } else {
            v = m * (((direct[cc] + acc[cc]) + grs[da * H + h]) + gcs[dn * H + h]);
          }
        }
        dhe[(cell0 + cell) * H + h] = v;
      }
    }
    // d w_hh += he_m^T @ d gh over the tile: item (kk group of kDwRows rows,
    // column) owned by one thread, its kDwRows sums in registers
    for (int it = threadIdx.x; it < (H / kDwRows) * H3; it += blockDim.x) {
      const int kk0 = (it / H3) * kDwRows, col = it % H3;
      float acc[kDwRows];
#pragma unroll
      for (int u = 0; u < kDwRows; ++u) acc[u] = 0.f;
      for (int c = 0; c < TC; ++c) {
        const float d = dgh_s[c * H3 + col];
        const float4* hv = (const float4*)(s.he + c * H + kk0);
#pragma unroll
        for (int u = 0; u < kDwRows / 4; ++u) {
          const float4 x = hv[u];
          acc[4 * u] = fmaf(x.x, d, acc[4 * u]);
          acc[4 * u + 1] = fmaf(x.y, d, acc[4 * u + 1]);
          acc[4 * u + 2] = fmaf(x.z, d, acc[4 * u + 2]);
          acc[4 * u + 3] = fmaf(x.w, d, acc[4 * u + 3]);
        }
      }
#pragma unroll
      for (int u = 0; u < kDwRows; ++u) dw_s[(kk0 + u) * H3 + col] += acc[u];
    }
    // d ga[i] += sum over the tile's cells of row i; d gb[j] likewise over column j
    const int t1 = min(t0 + TC, ncell);
    const int i_first = t0 / nt, rows = (t1 - 1) / nt - i_first + 1;
    for (int k = threadIdx.x; k < rows * H3; k += blockDim.x) {
      const int i = i_first + k / H3, col = k % H3;
      const int c_lo = max(i * nt, t0) - t0, c_hi = min((i + 1) * nt, t1) - t0;
      float acc = 0.f;
      for (int c = c_lo; c < c_hi; ++c)
        acc += col < 2 * H ? dgh_s[c * H3 + col] : dgn_s[c * H + col - 2 * H];
      dga_s[i * H3 + col] += acc;
    }
    for (int k = threadIdx.x; k < nt * H3; k += blockDim.x) {
      const int j = k / H3, col = k % H3;
      float acc = 0.f;
      for (int c = ((j - t0 % nt) + nt) % nt; t0 + c < t1; c += nt)
        acc += col < 2 * H ? dgh_s[c * H3 + col] : dgn_s[c * H + col - 2 * H];
      dgb_s[j * H3 + col] += acc;
    }
    __syncthreads();
  }
  for (int k = threadIdx.x; k < na * H3; k += blockDim.x) dga[q * na * H3 + k] = dga_s[k];
  for (int k = threadIdx.x; k < nt * H3; k += blockDim.x) dgb[q * nt * H3 + k] = sign * dgb_s[k];
  red_s[g * 4 * H + h] = db_r;
  red_s[g * 4 * H + H + h] = db_z;
  red_s[g * 4 * H + 2 * H + h] = db_n;
  red_s[g * 4 * H + 3 * H + h] = dweb_acc;
  __syncthreads();
  const int width = H * H3 + 4 * H + (kGather ? H3 : 0);
  float* prow = part + q * width;
  for (int o = threadIdx.x; o < H * H3; o += blockDim.x) prow[o] = dw_s[o];
  for (int k = threadIdx.x; k < 4 * H; k += blockDim.x) {
    float acc = 0.f;
    for (int gg = 0; gg < G; ++gg) acc += red_s[gg * 4 * H + k];
    prow[H * H3 + k] = acc;
  }
  if constexpr (kGather) {
    // d b_ih: the block's d ga rows summed in row order
    for (int k = threadIdx.x; k < H3; k += blockDim.x) {
      float acc = 0.f;
      for (int i = 0; i < na; ++i) acc += dga_s[i * H3 + k];
      prow[H * H3 + 4 * H + k] = acc;
    }
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

// Per detection row d of nrows and column c of F: the sum of src_a rows
// (block q, row i) and of src_b rows (block q, column j) over d's incidence
// entries inc_slot[inc_ptr[d] .. inc_ptr[d+1]), slot = q*(na + nt) + i or
// q*(na + nt) + na + j, in list order (increasing blocks) up to the first
// block >= P; f64, rounded to f32 once.  out_b null: out_a = rows - columns
// (edge support); else out_a = rows, out_b = columns (the gate cotangents).
__global__ void incidence_reduce_kernel(const float* __restrict__ src_a,
                                        const float* __restrict__ src_b,
                                        const int32_t* __restrict__ inc_ptr,
                                        const int32_t* __restrict__ inc_slot, int na, int nt,
                                        int P, int nrows, int F, float* __restrict__ out_a,
                                        float* __restrict__ out_b) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)nrows * F) return;
  const int d = (int)(t / F), c = (int)(t % F);
  const int W = na + nt;
  const int64_t limit = (int64_t)P * W;
  double acc_a = 0.0, acc_b = 0.0;
  const int e1 = inc_ptr[d + 1];
  for (int e = inc_ptr[d]; e < e1; ++e) {
    const int slot = inc_slot[e];
    if (slot >= limit) break;
    if (slot < 0) __trap();
    const int q = slot / W, r = slot % W;
    if (r < na) acc_a += (double)src_a[((int64_t)q * na + r) * F + c];
    else acc_b += (double)src_b[((int64_t)q * nt + (r - na)) * F + c];
  }
  if (out_b == nullptr) {
    out_a[t] = (float)(acc_a - acc_b);
  } else {
    out_a[t] = (float)acc_a;
    out_b[t] = (float)acc_b;
  }
}

// Grid: ceil(nrows * max(fa4, fb4) * split / kWsThreads) CTAs.  Thread t:
// lane s = t % split of the group t / split, which owns destination row d
// and float4 column c of out_a (fa4 columns) and out_b (fb4).  out_b null:
// out_a = rows + columns (fb4 = fa4), else out_a = rows, out_b = columns.
// idx_a [P, na] and idx_b [P, nt] are checked; src_b and idx_b are not read
// where nt = 0.  d's offsets must lie in [0, n_slot], increasing.
__global__ void __launch_bounds__(kWsThreads)
window_pull_kernel(const float4* __restrict__ src_a, const float4* __restrict__ src_b,
                   const int32_t* __restrict__ idx_a, const int32_t* __restrict__ idx_b,
                   const int32_t* __restrict__ inc_ptr, const int32_t* __restrict__ inc_slot,
                   int n_slot, float4* __restrict__ out_a, float4* __restrict__ out_b, int P,
                   int na, int nt, int fa4, int fb4, int nrows, int capD, int split) {
  const int64_t t = (int64_t)blockIdx.x * kWsThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kWsThreads;
  const int W = na + nt;
  const int64_t limit = (int64_t)P * W;
  for (int64_t i = t; i < limit; i += stride) {  // every id, once over the grid
    const int64_t q = i / W;
    const int r = (int)(i - q * W);
    const int32_t id = r < na ? idx_a[q * na + r] : idx_b[q * nt + (r - na)];
    if ((uint32_t)id >= (uint32_t)capD) __trap();
  }
  const int f4 = fa4 > fb4 ? fa4 : fb4;
  const int64_t grp = t / split;
  const int s = (int)(t % split);
  const bool valid = grp < (int64_t)nrows * f4;  // no early exit: the lanes shuffle below
  const int d = valid ? (int)(grp / f4) : 0;
  const int c = valid ? (int)(grp % f4) : 0;
  const bool two = out_b != nullptr;
  const bool has_a = c < fa4, has_b = c < fb4;  // this column of the rows, of the columns
  double ax = 0.0, ay = 0.0, az = 0.0, aw = 0.0, bx = 0.0, by = 0.0, bz = 0.0, bw = 0.0;
  const int e0 = valid ? inc_ptr[d] : 0, e1 = valid ? inc_ptr[d + 1] : 0;
  if (e0 < 0 || e1 < e0 || e1 > n_slot) __trap();
  for (int base = e0 + s; base < e1; base += split * kWsUnroll) {
    int slot[kWsUnroll];
#pragma unroll
    for (int u = 0; u < kWsUnroll; ++u) {
      const int k = base + u * split;
      slot[u] = k < e1 ? __ldg(inc_slot + k) : 0x7fffffff;
      if (slot[u] < 0) __trap();
    }
    float4 v[kWsUnroll];
    bool row[kWsUnroll], use[kWsUnroll];
#pragma unroll
    for (int u = 0; u < kWsUnroll; ++u) {
      const bool live = slot[u] < limit;
      const int q = live ? slot[u] / W : 0;
      const int r = live ? slot[u] - q * W : 0;
      row[u] = r < na;
      use[u] = live && (row[u] ? has_a : has_b);
      const float4* src = row[u] ? src_a + ((int64_t)q * na + r) * fa4
                                 : src_b + ((int64_t)q * nt + (r - na)) * fb4;
      v[u] = use[u] ? __ldg(src + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kWsUnroll; ++u) {
      if (!use[u]) continue;
      if (row[u] || !two) {
        ax += (double)v[u].x; ay += (double)v[u].y; az += (double)v[u].z; aw += (double)v[u].w;
      } else {
        bx += (double)v[u].x; by += (double)v[u].y; bz += (double)v[u].z; bw += (double)v[u].w;
      }
    }
    if (slot[kWsUnroll - 1] >= limit) break;  // lists increase: the rest lie beyond P too
  }
  // the group's lanes, in a fixed tree
  for (int off = split / 2; off > 0; off /= 2) {
    ax += __shfl_down_sync(0xffffffffu, ax, off, split);
    ay += __shfl_down_sync(0xffffffffu, ay, off, split);
    az += __shfl_down_sync(0xffffffffu, az, off, split);
    aw += __shfl_down_sync(0xffffffffu, aw, off, split);
    if (two) {
      bx += __shfl_down_sync(0xffffffffu, bx, off, split);
      by += __shfl_down_sync(0xffffffffu, by, off, split);
      bz += __shfl_down_sync(0xffffffffu, bz, off, split);
      bw += __shfl_down_sync(0xffffffffu, bw, off, split);
    }
  }
  if (!valid || s != 0) return;
  if (has_a) out_a[(int64_t)d * fa4 + c] = make_float4((float)ax, (float)ay, (float)az, (float)aw);
  if (two && has_b)
    out_b[(int64_t)d * fb4 + c] = make_float4((float)bx, (float)by, (float)bz, (float)bw);
}

// Lanes a window_scatter group splits a destination's list over: the
// smallest power of two up to 32 that leaves a lane at most kWsUnroll of
// the longest list the incidence can hold, but no more than keep the groups
// within one wave of the card's resident threads of this kernel.
int window_split(int64_t groups, int longest, int* split) {
  static int64_t waves[64];  // resident threads a device, asked once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (waves[dev] == 0) {
    int sms = 0, ctas = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, window_pull_kernel, kWsThreads,
                                                          0);
    if (err != cudaSuccess) return (int)err;
    waves[dev] = (int64_t)sms * ctas * kWsThreads;
  }
  const int64_t wave = waves[dev];
  int lanes = 1;
  while (lanes < 32 && (int64_t)lanes * kWsUnroll < longest && 2 * lanes * groups <= wave)
    lanes *= 2;
  *split = lanes;
  return (int)cudaSuccess;
}

size_t round_smem_bytes(int na, int nt, int H, bool backward) {
  const size_t TC = (size_t)round_groups(H) * kCellsPerThread, H3 = 3 * (size_t)H;
  size_t floats = H * (H3 + 1) + H3 + H + TC * H + TC;  // w_hh, b_hh, w_eb, tile, mask
  if (!backward) return (floats + TC * H) * sizeof(float);  // + edge_out tile
  floats += TC + TC * H3 + TC * H + H * H3 + (size_t)(na + nt) * H3
            + (size_t)round_groups(H) * 4 * H;
  return floats * sizeof(float);
}

cudaError_t opt_in_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Bytes of shared memory a CTA of the forward (backward = 0) or backward
// kernel needs at these widths; -1 for a width the kernels do not take.
extern "C" int tm_block_round_smem_bytes(int na, int nt, int H, int backward) {
  if (H < kDwRows || H > kThreadsTarget || kThreadsTarget % H != 0) return -1;
  return (int)round_smem_bytes(na, nt, H, backward != 0);
}

// h_e: f32[P, na, nt, H]; ga: f32[P, na, 3H]; gb: f32[P, nt, 3H];
// w_hh: f32[H, 3H]; b_hh: f32[3H]; w_eb: f32[H]; mask: f32[P, na, nt];
// out: edge_out f32[P, na, nt, H], rs f32[P, na, H], cs f32[P, nt, H],
// lg f32[P, na, nt].  H divides 256 and is at least 8.
extern "C" int tm_block_round_fwd(const void* he, const void* ga, const void* gb,
                                  const void* whh, const void* bhh, const void* web,
                                  const void* mask, void* eo, void* rs, void* cs, void* lg,
                                  int P, int na, int nt, int H, float sign, void* stream) {
  if (P == 0 || na == 0 || nt == 0) return (int)cudaSuccess;
  const size_t smem = round_smem_bytes(na, nt, H, false);
  cudaError_t err = opt_in_smem((const void*)block_round_fwd_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  const GateSrc g{(const float*)ga, (const float*)gb, nullptr, nullptr, nullptr, 1, 0};
  block_round_fwd_kernel<false><<<dim3(P, kRoundSplits), H * round_groups(H), smem,
                                  (cudaStream_t)stream>>>(
      (const float*)he, g, (const float*)whh, (const float*)bhh, (const float*)web,
      (const float*)mask, (float*)eo, (float*)rs, (float*)cs, (float*)lg, na, nt, H, sign);
  return (int)cudaGetLastError();
}

// Inputs as tm_block_round_fwd plus the cotangents g_eo, g_rs, g_cs, g_lg
// (shapes of edge_out, rs, cs, lg).  Writes d h_e, d ga, d gb (shapes of
// h_e, ga, gb), the per-block partials f32[P, H*3H + 4H] (scratch) and
// dw f32[H*3H + 4H] = [d w_hh (H x 3H) | d b_hh (3H) | d w_eb (H)].
extern "C" int tm_block_round_bwd(const void* he, const void* ga, const void* gb,
                                  const void* whh, const void* bhh, const void* web,
                                  const void* mask, const void* geo, const void* grs,
                                  const void* gcs, const void* glg, void* dhe, void* dga,
                                  void* dgb, void* partials, void* dw, int P, int na,
                                  int nt, int H, float sign, void* stream) {
  if (P == 0 || na == 0 || nt == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = round_smem_bytes(na, nt, H, true);
  cudaError_t err = opt_in_smem((const void*)block_round_bwd_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  const GateSrc g{(const float*)ga, (const float*)gb, nullptr, nullptr, nullptr, 1, 0};
  block_round_bwd_kernel<false><<<P, H * round_groups(H), smem, s>>>(
      (const float*)he, g, (const float*)whh, (const float*)bhh, (const float*)web,
      (const float*)mask, (const float*)geo, (const float*)grs, (const float*)gcs,
      (const float*)glg, (float*)dhe, (float*)dga, (float*)dgb, (float*)partials, na, nt, H,
      sign);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = 3 * H * H + 4 * H;
  sum_partials_kernel<<<(width + 255) / 256, 256, 0, s>>>((const float*)partials,
                                                          (float*)dw, P, width);
  return (int)cudaGetLastError();
}

// The es round's forward.  h_e, w_hh, b_hh, w_eb, mask as tm_block_round_fwd;
// act int32[P, na], nw int32[P, nt] window-local ids in [0, capD) (else the
// kernel traps); gad, gbd f32[B*capD, 3H]; bih f32[3H]; the batch's
// incidence inc_ptr int32[nrows + 1], inc_slot int32[n] (slots as
// incidence_reduce_kernel reads them, increasing within a row).  Writes
// edge_out, lg, the scratch rs f32[P, na, H], cs f32[P, nt, H] and es
// f32[nrows, H], nrows = B*capD.  P, na, nt > 0.
extern "C" int tm_block_round_es_fwd(const void* he, const void* act, const void* nw,
                                     const void* gad, const void* gbd, const void* bih,
                                     const void* whh, const void* bhh, const void* web,
                                     const void* mask, const void* inc_ptr,
                                     const void* inc_slot, void* eo, void* rs, void* cs,
                                     void* lg, void* es, int P, int na, int nt, int H, int B,
                                     int capD, float sign, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = round_smem_bytes(na, nt, H, false);
  cudaError_t err = opt_in_smem((const void*)block_round_fwd_kernel<true>, smem);
  if (err != cudaSuccess) return (int)err;
  const GateSrc g{(const float*)gad, (const float*)gbd, (const float*)bih,
                  (const int32_t*)act, (const int32_t*)nw, B, capD};
  block_round_fwd_kernel<true><<<dim3(P, kRoundSplits), H * round_groups(H), smem, s>>>(
      (const float*)he, g, (const float*)whh, (const float*)bhh, (const float*)web,
      (const float*)mask, (float*)eo, (float*)rs, (float*)cs, (float*)lg, na, nt, H, sign);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)B * capD * H;
  incidence_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const float*)rs, (const float*)cs, (const int32_t*)inc_ptr, (const int32_t*)inc_slot,
      na, nt, P, B * capD, H, (float*)es, nullptr);
  return (int)cudaGetLastError();
}

// The es round's backward.  Inputs as tm_block_round_es_fwd plus the
// cotangents geo (of edge_out), glg (of lg) and ges f32[B*capD, H] (of es).
// Writes d h_e, the scratch d ga f32[P, na, 3H], d gb f32[P, nt, 3H] and
// partials f32[P, H*3H + 7H], dw f32[H*3H + 7H] = [d w_hh | d b_hh | d w_eb
// | d b_ih], and d ga_d, d gb_d f32[B*capD, 3H].  P, na, nt > 0.
extern "C" int tm_block_round_es_bwd(const void* he, const void* act, const void* nw,
                                     const void* gad, const void* gbd, const void* bih,
                                     const void* whh, const void* bhh, const void* web,
                                     const void* mask, const void* inc_ptr,
                                     const void* inc_slot, const void* geo, const void* glg,
                                     const void* ges, void* dhe, void* dga, void* dgb,
                                     void* partials, void* dw, void* dgad, void* dgbd, int P,
                                     int na, int nt, int H, int B, int capD, float sign,
                                     void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = round_smem_bytes(na, nt, H, true);
  cudaError_t err = opt_in_smem((const void*)block_round_bwd_kernel<true>, smem);
  if (err != cudaSuccess) return (int)err;
  const GateSrc g{(const float*)gad, (const float*)gbd, (const float*)bih,
                  (const int32_t*)act, (const int32_t*)nw, B, capD};
  block_round_bwd_kernel<true><<<P, H * round_groups(H), smem, s>>>(
      (const float*)he, g, (const float*)whh, (const float*)bhh, (const float*)web,
      (const float*)mask, (const float*)geo, (const float*)ges, (const float*)ges,
      (const float*)glg, (float*)dhe, (float*)dga, (float*)dgb, (float*)partials, na, nt, H,
      sign);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = 3 * H * H + 7 * H;
  sum_partials_kernel<<<(width + 255) / 256, 256, 0, s>>>((const float*)partials,
                                                          (float*)dw, P, width);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)B * capD * 3 * H;
  incidence_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const float*)dga, (const float*)dgb, (const int32_t*)inc_ptr, (const int32_t*)inc_slot,
      na, nt, P, B * capD, 3 * H, (float*)dgad, (float*)dgbd);
  return (int)cudaGetLastError();
}

// src_a f32[P, na, Fa], src_b f32[P, nt, Fb], idx_a int32[P, na], idx_b
// int32[P, nt] their window-local ids (src_b and idx_b may be null where
// nt = 0), the incidence inc_ptr int32[nrows + 1], inc_slot int32[n_slot]
// (slots q*(na + nt) + r, increasing within a row); out_a f32[nrows, Fa]
// and, unless null, out_b f32[nrows, Fb] (out_b null: out_a = rows +
// columns, Fb = Fa), every element written.  Fa % 4 == Fb % 4 == 0, every
// float pointer 16-byte aligned.  longest: the most entries a destination's
// list can hold, which picks the lanes a list is split over.  An id outside
// [0, capD), an offset outside [0, n_slot] or a negative slot traps the
// kernel.  One launch.
extern "C" int tm_window_scatter(const void* src_a, const void* src_b, const void* idx_a,
                                 const void* idx_b, const void* inc_ptr, const void* inc_slot,
                                 void* out_a, void* out_b, int n_slot, int P, int na, int nt,
                                 int Fa, int Fb, int nrows, int capD, int longest, void* stream) {
  if (Fa % 4 != 0 || Fb % 4 != 0 || (out_b == nullptr && Fb != Fa))
    return (int)cudaErrorInvalidValue;
  const int f4 = (Fa > Fb ? Fa : Fb) / 4;
  if (nrows == 0 || f4 == 0) return (int)cudaSuccess;
  int split = 1;
  const int err = window_split((int64_t)nrows * f4, longest, &split);
  if (err != (int)cudaSuccess) return err;
  const int64_t threads = (int64_t)nrows * f4 * split;
  window_pull_kernel<<<(unsigned)((threads + kWsThreads - 1) / kWsThreads), kWsThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float4*)src_a, (const float4*)src_b, (const int32_t*)idx_a, (const int32_t*)idx_b,
      (const int32_t*)inc_ptr, (const int32_t*)inc_slot, n_slot, (float4*)out_a,
      (float4*)out_b, P, na, nt, Fa / 4, Fb / 4, nrows, capD, split);
  return (int)cudaGetLastError();
}
