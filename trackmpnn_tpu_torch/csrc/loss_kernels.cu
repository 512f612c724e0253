// Hopper (sm_90a) kernels for the fused edge losses of the block train
// step.  Built by trackmpnn_tpu_torch/ops/_build.py into a shared library
// with a plain C interface and called through ctypes from ops/loss.py,
// which checks device, dtype, shape and contiguity before any pointer gets
// here.  All math is f32 (L2's block sums f64); no kernel uses atomics, and
// every sum runs in an order fixed by the shapes, so every result is the
// same from run to run.
// One CTA per block of P: a block's rectangle is at most na x nt cells
// (24 x 24 at the training workload), and the detection-sized glue between
// the kernels stays plain tensor code, as in the JAX package.
//
// edge_loss_l1
//   Replaces _l1_kernel (trackmpnn_tpu/ops/pallas_loss.py:88).  Per block:
//   logits = mask * (h_eo @ w_e + b_e), then per row the earliest positive
//   slot row r_min and the masked max m_r and exp-sum s_r of the logits.
//   Bound: bytes (h_eo, K floats a live cell, is read once and dominates).
//   Design: one warp a cell, lanes over K (coalesced loads of the cell's
//   row, a fixed shuffle tree for the dot); a dead cell is neither read nor
//   summed.  The logits stay in shared memory for the row statistics, one
//   thread a row, in column order.
//
// edge_loss_l2
//   Replaces _l2_kernel (pallas_loss.py:126).  Per block, one thread a
//   column: the latest positive row of the column, the target picks, the
//   column's logsumexp and selected logit (ce_past), and per cell ce_fut,
//   the BCE log-probability, the count and tp / fp / fn, summed down the
//   column; then one thread per partial sums the columns in order.  The
//   sums run in f64 and round to f32 once (a block's BCE sums up to na*nt
//   terms, whose f32 rounding in another order than the plain version's
//   would reach 1e-5 by itself).  Bound: bytes (logits, labels and mask of
//   the block, read once), a few us.
//
// edge_loss_bwd
//   Replaces _lb_kernel (pallas_loss.py:167).  Per block: d logits per cell
//   (one thread a column recomputes the picks, the column softmax and the
//   BCE derivative), then thread (g, k) writes d h_eo = d logit * w_e[k]
//   for the cells g, g + G, ... and sums h_eo * d logit over them (G =
//   256 / K groups of K threads where K < 256: K = nb*H is any head width,
//   192 for three branches at H 64; where K >= 256 one group whose threads
//   take columns k, k + 256, ...); the
//   block's d w_e and d b_e go to a row of per-block partials, which
//   sum_partials_kernel adds up in block order (the TPU kernel accumulates
//   them across its sequential grid, :223-231).  Bound: bytes (h_eo read
//   and d h_eo written at the live cells; d h_eo is written everywhere).
//
// No kernel synchronises or allocates; each entry point returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kBig = 1073741824.f;  // 2^30, larger than any slot row id
constexpr float kEps = 1e-10f;        // losses.EPS
constexpr int kL1Threads = 256;
constexpr int kBwdThreads = 256;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// slot row of edge (i, j): edge_base + i * blk_nt + j, exact in f32
__device__ __forceinline__ float rowid(const float* ebnt, int64_t q, int i, int j) {
  return (ebnt[2 * q] + (float)i * ebnt[2 * q + 1]) + (float)j;
}

__global__ void edge_loss_l1_kernel(const float* __restrict__ heo, const float* __restrict__ we,
                                    const float* __restrict__ be, const float* __restrict__ lbl,
                                    const float* __restrict__ mask,
                                    const float* __restrict__ ebnt, float* __restrict__ logits,
                                    float* __restrict__ rmin, float* __restrict__ mr,
                                    float* __restrict__ sr, int na, int nt, int K) {
  extern __shared__ float lg_s[];  // [na * nt]
  const int64_t q = blockIdx.x;
  const int ncell = na * nt;
  const int64_t cell0 = q * ncell;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  for (int c = warp; c < ncell; c += nwarps) {
    const float m = mask[cell0 + c];
    float out = 0.f;
    if (m != 0.f) {
      const float* row = heo + (cell0 + c) * K;
      float acc = 0.f;
      for (int k = lane; k < K; k += 32) acc = fmaf(row[k], we[k], acc);
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      out = (acc + be[0]) * m;
    }
    if (lane == 0) {
      lg_s[c] = out;
      logits[cell0 + c] = out;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < na; i += blockDim.x) {
    float rm = kBig, mx = kNeg;
    for (int j = 0; j < nt; ++j) {
      const int64_t cell = cell0 + (int64_t)i * nt + j;
      const float m = mask[cell];
      if (lbl[cell] * m > 0.5f) rm = fminf(rm, rowid(ebnt, q, i, j));
      if (m > 0.5f) mx = fmaxf(mx, lg_s[i * nt + j]);
    }
    const float safe = mx > kNeg / 2 ? mx : 0.f;
    float s = 0.f;
    for (int j = 0; j < nt; ++j)
      if (mask[cell0 + (int64_t)i * nt + j] > 0.5f) s += expf(lg_s[i * nt + j] - safe);
    rmin[q * na + i] = rm;
    mr[q * na + i] = mx;
    sr[q * na + i] = s;
  }
}

// The target picks of column j (pallas_loss.py:111-123): the latest
// positive row max_i, and after it the latest target-positive row sel_i.
struct ColumnPicks {
  int max_i, sel_i;
  bool has;
};

__device__ ColumnPicks column_picks(const float* lbl, const float* mask, const float* ebnt,
                                    const float* sel1g, int64_t q, int na, int nt, int j) {
  const int64_t cell0 = q * na * nt;
  ColumnPicks p{-1, -1, false};
  for (int i = 0; i < na; ++i) {
    const int64_t cell = cell0 + (int64_t)i * nt + j;
    if (lbl[cell] * mask[cell] > 0.5f) p.max_i = i;
  }
  for (int i = 0; i < na; ++i) {
    const int64_t cell = cell0 + (int64_t)i * nt + j;
    const bool pos = lbl[cell] * mask[cell] > 0.5f;
    const bool part_b = pos && rowid(ebnt, q, i, j) == sel1g[q * na + i];
    if (pos && (i == p.max_i || part_b)) p.sel_i = i;
  }
  p.has = p.sel_i >= 0;
  return p;
}

__device__ __forceinline__ bool is_part_b(const float* lbl, const float* mask, const float* ebnt,
                                          const float* sel1g, int64_t q, int na, int nt, int i,
                                          int j) {
  const int64_t cell = q * na * nt + (int64_t)i * nt + j;
  return lbl[cell] * mask[cell] > 0.5f && rowid(ebnt, q, i, j) == sel1g[q * na + i];
}

__global__ void edge_loss_l2_kernel(const float* __restrict__ logits,
                                    const float* __restrict__ lbl,
                                    const float* __restrict__ mask,
                                    const float* __restrict__ ebnt,
                                    const float* __restrict__ bna,
                                    const float* __restrict__ sel1g,
                                    const float* __restrict__ lsedg,
                                    const float* __restrict__ sizedg, float* __restrict__ out,
                                    int na, int nt) {
  extern __shared__ double col_s[];  // [nt][7] per-column partials
  const int64_t q = blockIdx.x;
  const int64_t cell0 = q * na * nt;
  const float size_col = fmaxf(bna[q], 1.f);
  for (int j = threadIdx.x; j < nt; j += blockDim.x) {
    const ColumnPicks pk = column_picks(lbl, mask, ebnt, sel1g, q, na, nt, j);
    float mx = kNeg;
    for (int i = 0; i < na; ++i) {
      const int64_t cell = cell0 + (int64_t)i * nt + j;
      if (mask[cell] > 0.5f) mx = fmaxf(mx, logits[cell]);
    }
    const float safe = mx > kNeg / 2 ? mx : 0.f;
    float s_col = 0.f, sel_logit = 0.f;
    double ce_fut = 0.0, bce = 0.0, cnt = 0.0, tp = 0.0, fp = 0.0, fn = 0.0;
    for (int i = 0; i < na; ++i) {
      const int64_t cell = cell0 + (int64_t)i * nt + j;
      const float m = mask[cell], x = logits[cell];
      const bool mb = m > 0.5f;
      const bool pos = lbl[cell] * m > 0.5f;
      const bool part_b = is_part_b(lbl, mask, ebnt, sel1g, q, na, nt, i, j);
      const bool tpos = pos && (i == pk.max_i || part_b);
      if (mb) s_col += expf(x - safe);
      if (tpos && i == pk.sel_i) sel_logit += x;
      if (part_b) ce_fut += (double)((lsedg[q * na + i] - x) / fmaxf(sizedg[q * na + i], 1.f));
      const float sg = sigmoid_f(x);
      if (mb) bce += (double)logf((tpos ? sg : 1.f - sg) + kEps);
      cnt += (double)m;
      const bool pred = sg >= 0.5f && mb;
      tp += (pred && tpos) ? 1.0 : 0.0;
      fp += (pred && !tpos) ? 1.0 : 0.0;
      fn += (mb && !pred && tpos) ? 1.0 : 0.0;
    }
    const float lse_col = safe + logf(fmaxf(s_col, 1e-30f));
    double* row = col_s + j * 7;
    row[0] = pk.has ? (double)((lse_col - sel_logit) / size_col) : 0.0;
    row[1] = ce_fut;
    row[2] = bce;
    row[3] = cnt;
    row[4] = tp;
    row[5] = fp;
    row[6] = fn;
  }
  __syncthreads();
  if (threadIdx.x < 8) {
    double acc = 0.0;
    if (threadIdx.x < 7)
      for (int j = 0; j < nt; ++j) acc += col_s[j * 7 + threadIdx.x];
    out[q * 8 + threadIdx.x] = (float)acc;
  }
}

__global__ void edge_loss_bwd_kernel(const float* __restrict__ heo, const float* __restrict__ we,
                                     const float* __restrict__ logits,
                                     const float* __restrict__ lbl,
                                     const float* __restrict__ mask,
                                     const float* __restrict__ ebnt,
                                     const float* __restrict__ bna,
                                     const float* __restrict__ sel1g,
                                     const float* __restrict__ lsedg,
                                     const float* __restrict__ sizedg,
                                     const float* __restrict__ wg,
                                     const float* __restrict__ dpart, float* __restrict__ dheo,
                                     float* __restrict__ part, int na, int nt, int K) {
  extern __shared__ float smem[];
  const int ncell = na * nt, G = K < (int)blockDim.x ? (int)blockDim.x / K : 1;
  float* dl_s = smem;              // [ncell]  d logits
  float* red_s = dl_s + ncell;     // [G][K]   per-group d w_e
  const int64_t q = blockIdx.x;
  const int64_t cell0 = q * ncell;
  const float d_cep = dpart[q * 8], d_cef = dpart[q * 8 + 1], d_bce = dpart[q * 8 + 2];
  const float size_col = fmaxf(bna[q], 1.f);
  for (int j = threadIdx.x; j < nt; j += blockDim.x) {
    const ColumnPicks pk = column_picks(lbl, mask, ebnt, sel1g, q, na, nt, j);
    float mx = kNeg;
    for (int i = 0; i < na; ++i) {
      const int64_t cell = cell0 + (int64_t)i * nt + j;
      if (mask[cell] > 0.5f) mx = fmaxf(mx, logits[cell]);
    }
    const float safe = mx > kNeg / 2 ? mx : 0.f;
    float s_col = 0.f;
    for (int i = 0; i < na; ++i) {
      const int64_t cell = cell0 + (int64_t)i * nt + j;
      if (mask[cell] > 0.5f) s_col += expf(logits[cell] - safe);
    }
    s_col = fmaxf(s_col, 1e-30f);
    const float w_col = (pk.has ? 1.f : 0.f) / size_col;
    for (int i = 0; i < na; ++i) {
      const int64_t cell = cell0 + (int64_t)i * nt + j;
      const float m = mask[cell], x = logits[cell];
      const bool mb = m > 0.5f;
      const bool pos = lbl[cell] * m > 0.5f;
      const bool part_b = is_part_b(lbl, mask, ebnt, sel1g, q, na, nt, i, j);
      const bool tpos = pos && (i == pk.max_i || part_b);
      const bool sel = tpos && i == pk.sel_i;
      const float e_col = mb ? expf(x - safe) : 0.f;
      float dl = d_cep * w_col * (e_col / s_col - (sel ? 1.f : 0.f));
      const float soft_d = mb ? expf(x - lsedg[q * na + i]) : 0.f;
      const float sized = fmaxf(sizedg[q * na + i], 1.f);
      dl = dl + (wg[q * na + i] * soft_d - d_cef * (part_b ? 1.f : 0.f) / sized);
      float dbce = 0.f;
      if (mb) {
        const float sg = sigmoid_f(x);
        const float pt = tpos ? sg : 1.f - sg;
        dbce = (tpos ? 1.f : -1.f) * sg * (1.f - sg) / (pt + kEps);
      }
      dl = dl + d_bce * dbce;
      dl_s[i * nt + j] = dl * m;
    }
  }
  __syncthreads();
  // d h_eo = d logit * w_e; thread (g, k) owns column k of the cells g + G*t
  // (threads past G groups idle; with one group a thread takes every
  // blockDim-th column)
  const int g = G > 1 ? threadIdx.x / K : 0;
  const int kstep = G > 1 ? K : blockDim.x;
  for (int k = G > 1 ? threadIdx.x % K : threadIdx.x; g < G && k < K; k += kstep) {
    const float wk = we[k];
    float acc = 0.f;
    for (int c = g; c < ncell; c += G) {
      const float dl = dl_s[c];
      float v = 0.f;
      if (dl != 0.f) {
        v = dl * wk;
        acc = fmaf(heo[(cell0 + c) * K + k], dl, acc);
      }
      dheo[(cell0 + c) * K + k] = v;
    }
    red_s[g * K + k] = acc;
  }
  __syncthreads();
  float* prow = part + q * (K + 1);
  for (int kk = threadIdx.x; kk < K; kk += blockDim.x) {
    float acc = 0.f;
    for (int gg = 0; gg < G; ++gg) acc += red_s[gg * K + kk];
    prow[kk] = acc;
  }
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int c = 0; c < ncell; ++c) acc += dl_s[c];
    prow[K] = acc;
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

cudaError_t opt_in_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// h_eo f32[P, na, nt, K]; w_e f32[K]; b_e f32[1]; lbl, mask f32[P, na, nt];
// ebnt f32[P, 2].  Writes logits f32[P, na, nt] and r_min, m_r, s_r
// f32[P, na].  P, na, nt > 0.
extern "C" int tm_edge_loss_l1(const void* heo, const void* we, const void* be, const void* lbl,
                               const void* mask, const void* ebnt, void* logits, void* rmin,
                               void* mr, void* sr, int P, int na, int nt, int K, void* stream) {
  const size_t smem = (size_t)na * nt * sizeof(float);
  cudaError_t err = opt_in_smem((const void*)edge_loss_l1_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  edge_loss_l1_kernel<<<P, kL1Threads, smem, (cudaStream_t)stream>>>(
      (const float*)heo, (const float*)we, (const float*)be, (const float*)lbl,
      (const float*)mask, (const float*)ebnt, (float*)logits, (float*)rmin, (float*)mr,
      (float*)sr, na, nt, K);
  return (int)cudaGetLastError();
}

// logits, lbl, mask f32[P, na, nt]; ebnt f32[P, 2]; bna f32[P]; sel1g,
// lsedg, sizedg f32[P, na].  Writes out f32[P, 8].  P, na, nt > 0.
extern "C" int tm_edge_loss_l2(const void* logits, const void* lbl, const void* mask,
                               const void* ebnt, const void* bna, const void* sel1g,
                               const void* lsedg, const void* sizedg, void* out, int P, int na,
                               int nt, void* stream) {
  const size_t smem = (size_t)nt * 7 * sizeof(double);
  cudaError_t err = opt_in_smem((const void*)edge_loss_l2_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = nt <= 32 ? 32 : (nt <= 128 ? ((nt + 31) / 32) * 32 : 128);
  edge_loss_l2_kernel<<<P, threads, smem, (cudaStream_t)stream>>>(
      (const float*)logits, (const float*)lbl, (const float*)mask, (const float*)ebnt,
      (const float*)bna, (const float*)sel1g, (const float*)lsedg, (const float*)sizedg,
      (float*)out, na, nt);
  return (int)cudaGetLastError();
}

// Inputs as tm_edge_loss_l2 plus h_eo f32[P, na, nt, K] (any K > 0),
// w_e f32[K], wg f32[P, na] and dpart f32[P, 8] (the cotangent of the
// partials).  Writes d h_eo f32[P, na, nt, K], the per-block partials
// f32[P, K + 1] (scratch) and dw f32[K + 1] = [d w_e | d b_e].
extern "C" int tm_edge_loss_bwd(const void* heo, const void* we, const void* logits,
                                const void* lbl, const void* mask, const void* ebnt,
                                const void* bna, const void* sel1g, const void* lsedg,
                                const void* sizedg, const void* wg, const void* dpart,
                                void* dheo, void* partials, void* dw, int P, int na, int nt,
                                int K, void* stream) {
  if (K <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // red_s holds G * K <= max(kBwdThreads, K) floats
  const size_t smem = ((size_t)na * nt + (K > kBwdThreads ? K : kBwdThreads)) * sizeof(float);
  cudaError_t err = opt_in_smem((const void*)edge_loss_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  edge_loss_bwd_kernel<<<P, kBwdThreads, smem, s>>>(
      (const float*)heo, (const float*)we, (const float*)logits, (const float*)lbl,
      (const float*)mask, (const float*)ebnt, (const float*)bna, (const float*)sel1g,
      (const float*)lsedg, (const float*)sizedg, (const float*)wg, (const float*)dpart,
      (float*)dheo, (float*)partials, na, nt, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(K + 1 + 255) / 256, 256, 0, s>>>((const float*)partials, (float*)dw, P,
                                                          K + 1);
  return (int)cudaGetLastError();
}
