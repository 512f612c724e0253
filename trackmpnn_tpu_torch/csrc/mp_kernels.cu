// Hopper (sm_90a) kernels for the message-passing ops of the serving path.
// Built by trackmpnn_tpu_torch/ops/_build.py into a shared library with a
// plain C interface and called through ctypes from ops/mp.py, which checks
// device, dtype, shape, contiguity and alignment before any pointer gets here.
//
// gather_diff and gather_concat (gather_rows_kernel<kConcat, L>)
//   gather_diff replaces _gather_diff_kernel / gather_diff_pallas in
//   trackmpnn_tpu/ops/pallas_mp.py:
//     out[k] = edge_k ? h[past_k] - h[fut_k] : 0                    (f32, exact)
//   gather_concat is msg concat's node support, [h[past] | h[fut]] on edge
//   rows (trackmpnn_tpu/models/mpnn.py:123-125; the JAX package computes it
//   in XLA, so it replaces no TPU kernel):
//     out[k, :H] = edge_k ? h[past_k] : 0,  out[k, H:] = edge_k ? h[fut_k] : 0
//   Both exact: a subtraction or a copy per element.
//   Bound: device-memory bytes (the rows of h the edge rows address read
//   once, 9 B of index and mask a row, out written once).  The TPU kernel
//   walks rows in a serial fori_loop because Mosaic could not lower a vector
//   gather; the card gathers natively.  The first design gave every float4
//   of the output a thread, which read mask[row], then inside that branch
//   past and fut, then the two h words, then stored: four dependent steps,
//   2.72 us at batch 1 (4,096 rows, H 64) against a 0.34 us bound.  This one:
//   * A group of L lanes takes a row (L = H/4 rounded up to a power of two,
//     at most 32; 16 at H 64): lane c owns float4 columns c, c + L, ...
//   * Mask and both endpoints are loaded together and unconditionally, so
//     the chain is index words -> h -> store.  A dead row selects row 0's
//     address instead of branching (one row, cached, for all of them) and
//     stores zeros; an endpoint outside the rows of a live row traps.
//   * Each group has kGatherRows = 2 rows in flight at once (their index
//     words, then their h words), walking rows grid-stride; the grid is
//     sized to the SMs (the most CTAs resident at once), not to the element
//     count.
//   * Dead rows are written with streaming stores (st.global.cs): every
//     element is written, and the zeros do not push live rows out of L2.
//   Measured (NVIDIA H100 80GB HBM3 at 700 W, trackmpnn_tpu_torch/tools/
//   ab_gather.py beside the first design): within 5% of the first design at
//   batch 1, serving and packed (~2.7, 3.8, 5.1 us), which is the launch
//   and two dependent loads: a kernel issued behind another in the stream
//   pays the gap between them.  As a programmatic dependent launch
//   (griddepcontrol.wait before the first load) the same kernel took 1.49 /
//   2.60 / 3.93 us back to back, but the batch-1 step's device time did not
//   move (14.39 ms either way: the host issues the step's launches slower
//   than the card runs them), so it launches plainly.
//
// signed_segment_sum
//   Replaces _signed_scatter_kernel / signed_segment_sum_pallas in
//   trackmpnn_tpu/ops/pallas_mp.py.
//   out[d] = sum over d's incidence entries (e, sign) of sign * mask[e] * h[e]
//   The incidence (ops/mp.py::segment_incidence, built once a graph view or
//   step batch on the device) lists every edge row at past(e) with sign +1
//   and at fut(e) with sign -1, sorted by destination, and leaves out the
//   rows that point at themselves (detections, padding); the kernel reads
//   mask[e] itself, so one incidence serves every round while `live`
//   changes.
//   Bound: device-memory bytes (edge rows of h read once, 9 B of index and
//   mask a row, out written once).  The TPU kernel accumulates serially in
//   VMEM over a sequential grid.  The first design scattered each edge
//   row with 2*H f64 atomics into a zeroed f64 scratch and rounded it in a
//   second kernel: three launches, ~1.46M atomics contending on ~170
//   destination rows in L2 at serving, 40.21 us against a 2.16 us bound,
//   and not bitwise repeatable.  This is a pull: no atomics, no scratch, one
//   launch.  CTA b owns the destination rows b + k * gridDim.x (k <
//   kPullRows), so the contiguous detection rows of one frame land on
//   different CTAs; it writes its empty rows as zeros at once, then takes
//   its listed rows one at a time with all 256 threads: thread t owns float4
//   column t % (H/4) and entry group t / (H/4) (16 groups at H = 64), walks
//   entries g, g + 16, ... with kPullUnroll of them (index, mask, then h)
//   in flight, in f64, and the groups are summed in group order through
//   shared memory and rounded to f32 once.  At serving (capacity 16,384,
//   ~170 detection rows of ~135 entries, H = 64) that is 1,024 CTAs and two
//   rounds of loads a listed row.  Fixed order throughout: bitwise the same
//   on every launch, and the correctly rounded sum unless the exact sum lies
//   within f64 rounding (~1e-14) of an f32 rounding boundary.
//
// segment_sum_halves (signed_pull_kernel<true>, the halves mode)
//   gather_concat's VJP (the JAX package takes it through XLA's autodiff of
//   the concatenation, so it replaces no TPU kernel):
//     out[d] = sum over d's incidence entries k of mask[e] * g[e, half_k]
//   with e the entry's row, half_k = :H for k < N (the past end) and H: for
//   k >= N (the fut end), every sign +1, g f32[N, 2H].  The same pull over
//   the same incidence, f64 sums in a fixed order rounded once, one launch.
//
// segment_incidence (the pull's incidence; no TPU counterpart)
//   ptr int32[n + 1] and ent int32[2N]: destination d's entries are
//   ent[ptr[d] .. ptr[d+1]), entry k < N row k at past[k] with sign +1,
//   entry k >= N row k - N at fut[k - N] with sign -1, in increasing k
//   (the stable sort of ops/mp.py::segment_incidence_reference, bitwise);
//   rows pointing at themselves at both ends and endpoints outside [0, n)
//   are not listed.  A serving forward builds one, and the host is what
//   serving waits on: a sort and a search in torch ops were ~10 launches and
//   ~80 us of device time and ~250-600 us of host time a forward.  Here one
//   call from the host enqueues a memset and four kernels: count each
//   destination's entries with atomics into ptr (a thread an entry), scan
//   ptr in one CTA of 1,024 threads, place each entry at its destination's
//   cursor (the arrival order of atomics), then put each list in entry
//   order: warp w looks at the destinations w + n_warps * lane (so a
//   frame's neighbouring detection rows go to different warps) and ranks
//   each list of two or more entries with the whole warp from shared
//   memory, an entry's place being the count of smaller entries in its list
//   (~135 entries a detection at serving, ~180 of 16,384 rows listed).  The
//   atomics decide only the order before that last pass, so the result is
//   the same on every launch.  A first design did all four in one CTA:
//   one launch, but 178 us at serving and 405 us at 32,768 rows, one SM
//   doing every pass.
//
// fused_edge_gru
//   Replaces _edge_gru_kernel / fused_edge_gru in
//   trackmpnn_tpu/ops/pallas_mp.py (forward only, as there).  Per row i:
//     ns  = edge_i ? h[past_i] - h[fut_i] : 0
//     gi  = ns . w_ih + b_ih,  gh = h_i . w_hh + b_hh   ([H, 3H], blocks r|z|n)
//     r, z = sigmoid(gi + gh) of their blocks,  n = tanh(gi_n + r * gh_n)
//     out_i = (1 - z) * n + z * h_i
//   Every row is computed, as on the TPU; the caller keeps the edge rows.
//   Bound: operations.  The two products take 2 * 2 * H * 3H a row (49,152
//   at H = 64) against ~4 * (2H + 3) bytes of traffic a row.  At the serving
//   window (16,384 rows, 11,437 live, H 64) the f32 bound is 8.72 us and
//   34.22 us at H 128 (67 TFLOP/s); the products run on the tensor cores in
//   3xTF32, three TF32 products for each f32 one, so the bound at that rate
//   (495 TFLOP/s) is 3.54 / 13.89 us.  The TPU kernel holds all of h in
//   VMEM and feeds 512-row tiles to the MXU.
//   The first design ran the products on the CUDA cores in f32, a thread a
//   hidden unit of 8 rows: 6 shared loads of weights and 16 broadcast loads
//   of rows for 48 FMAs a k step, so issue slots went to loads (35.33 us at
//   H 64, ~23 TFLOP/s); at H 128 it restaged two 64-row k chunks of both
//   weight matrices every 32-row tile, ~196 MB through L2 a launch (152.45
//   us).  This design:
//   * Tensor cores at f32-level error: 3xTF32 (tf32_mma.cuh's split) as
//     wgmma.m64nNk8 .tf32 with A from registers, every k step of 8 into a
//     fresh accumulator added in f32 (the tensor cores cut the low bits
//     where they accumulate).  mma.sync.m16n8k8 in the same scheme was
//     slower: with two warps a scheduler its 3-deep mma chains, fragment
//     loads and splits left the tensor pipe idle.
//   * Weights resident and split once.  A persistent CTA owns U units of
//     each gate (the widest of 32, 16, 8 whose slab fits: 32 at H 64 and
//     H 128, 16 at H 256; gridDim.y = ceil(H / U)) and stages its columns of
//     w_ih and w_hh, all Kp rows, once: each value read from global memory,
//     split into big and small and stored K-major in 8 x 16-byte core
//     matrices, the wgmmas' B operand (96 KiB at H 64, 192 KiB at H 128).  No weight byte is read again while the CTA
//     walks its tiles; splitting once beats splitting at fragment load
//     (~10 issue slots a product, as the block round kernels found) and
//     the wgmmas read B only from shared memory.  Splitting straight from
//     global memory beat copying the slab unsplit with cp.async first
//     (18.32 against 19.12 us at H 64).
//   * Rows.  The CTA's two warpgroups walk 64-row tiles on their own (no
//     barrier between them after the weights).  A thread reads its A
//     values straight from global memory (L2): h, h[past] and h[fut] at
//     rows g and g + 8 of its warp, columns 2t and 2t + 1 of each k step
//     (the B layout puts those k values in the fragment's slots t and t +
//     4), one k step ahead of their use (a tile's first while the weights
//     are staged); ns formed in f32, each value split once.  A first design
//     staged the rows through shared memory with cp.async in two stages:
//     its copies and barriers cost more than they saved, and they held the
//     shared memory that now lets H 128 keep 32 units a CTA (4 CTA columns
//     reading each row, not 8).
//   * Per k step a warpgroup issues ns x [w_ih r|z|n] and h x [w_hh r|z|n]
//     of its U units (N = 3U, three wgmmas each) as two commit groups and
//     adds each fresh sum once its group is done (ns's while h's run): r
//     and z take the ns part, then the h part (a K = 2H product of [ns | h]
//     against [w_ih; w_hh]); gi_n and gh_n their own.  The gates in fast
//     math (__expf, a reciprocal: ~1e-6).  Every row is computed, detection
//     and padding rows too (the wgmmas sit on no branch, or ptxas
//     serialises them).
//   * Widths.  Any H % 4 == 0: k and the units pad to multiples of 8 with
//     zeros; instances with H known to the compiler at 16, 32 and 64,
//     4-6% faster than the generic one (5.47 / 8.16 / 18.32 against 5.81 /
//     8.71 / 19.15 us).
//     Above H 600 no slab of 8 units fits, and each warpgroup restages a
//     32-row chunk of it (split again) every tile and chunk.
//   * Fixed order, no atomics: bitwise the same on every launch.
//   Shared memory 96.5 KiB at H 64, 192.5 KiB at H 128; ~238 registers a
//   thread: one CTA of 8 warps an SM.  Measured 18.32 / 55.35 us at H 64 /
//   128, 5.2x / 4.0x the TF32-rate bound (this note's times:
//   trackmpnn_tpu_torch/tools/ab_edge_gru.py at phase 2's window size, NVIDIA
//   H100 80GB HBM3 at 700 W).
//
// An endpoint index of a masked-in edge row outside the rows it addresses
// traps the kernel (a sticky CUDA error that the next synchronisation
// raises) rather than reading or writing out of bounds; the check is two
// compares a row (the pull checks every row once, over the grid), and the
// pull traps too on an incidence entry outside the rows.
//
// No kernel synchronises or allocates: the caller allocates `out` and every
// launch goes to the stream it is given.
// Each entry point returns cudaGetLastError() so the caller can raise on a
// refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"  // the TF32 split, A fragments, wgmma3

namespace {

constexpr int kGatherThreads = 256;

// A row's index words: mask and both endpoints, loaded together.
struct RowIdx {
  int32_t p, f;
  bool m;
};

__device__ __forceinline__ RowIdx row_idx(const int32_t* __restrict__ past,
                                          const int32_t* __restrict__ fut,
                                          const uint8_t* __restrict__ mask, int64_t row,
                                          int n_rows) {
  RowIdx r = {0, 0, false};
  if (row < n_rows) {
    r.m = __ldg(mask + row) != 0;
    r.p = __ldg(past + row);
    r.f = __ldg(fut + row);
  }
  return r;
}

constexpr int kGatherRows = 2;  // rows a group has in flight at once

// out [n_rows, W] with W = 2 h4 float4s for kConcat, else h4.  Grid: any
// count of CTAs of kGatherThreads; group g = blockIdx.x * (threads / L) +
// threadIdx.x / L takes the U = kGatherRows rows base + u * groups (u < U)
// at once, for base = g, g + U groups, ...
template <bool kConcat, int L>
__global__ void __launch_bounds__(kGatherThreads)
gather_rows_kernel(const float4* __restrict__ h, const int32_t* __restrict__ past,
                   const int32_t* __restrict__ fut, const uint8_t* __restrict__ mask,
                   float4* __restrict__ out, int n_rows, int h4) {
  constexpr int kGroups = kGatherThreads / L, U = kGatherRows;
  const int lane = threadIdx.x % L;
  const int64_t groups = (int64_t)gridDim.x * kGroups;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t base = (int64_t)blockIdx.x * kGroups + threadIdx.x / L; base < n_rows;
       base += groups * U) {
    RowIdx r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) r[u] = row_idx(past, fut, mask, base + u * groups, n_rows);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r[u].m && ((uint32_t)r[u].p >= (uint32_t)n_rows || (uint32_t)r[u].f >= (uint32_t)n_rows))
        __trap();
    for (int c = lane; c < h4; c += L) {
      float4 a[U], b[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {  // a dead row reads row 0
        a[u] = __ldg(h + (int64_t)(r[u].m ? r[u].p : 0) * h4 + c);
        b[u] = __ldg(h + (int64_t)(r[u].m ? r[u].f : 0) * h4 + c);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t row = base + u * groups;
        if (row >= n_rows) continue;
        float4* o = out + row * (kConcat ? 2 * h4 : h4);
        if (r[u].m) {
          if (kConcat) {
            o[c] = a[u];
            o[h4 + c] = b[u];
          } else {
            o[c] = make_float4(a[u].x - b[u].x, a[u].y - b[u].y, a[u].z - b[u].z,
                               a[u].w - b[u].w);
          }
        } else {
          __stcs(o + c, zero);
          if (kConcat) __stcs(o + h4 + c, zero);
        }
      }
    }
  }
}

constexpr int kPullThreads = 256;
constexpr int kPullRows = 16;    // destination rows a CTA owns (gridDim.x apart)
constexpr int kPullUnroll = 8;   // entries a thread has in flight

// Incidence entry k: row k with sign +1 for k < n_rows, row k - n_rows with
// sign -1 for k >= n_rows (the doubled incidence [past; fut]).  kHalves (the
// halves mode, gather_concat's VJP): h is [n_rows, 2 h4] float4s, entry k <
// n_rows reads h[k, :h4], entry k >= n_rows reads h[k - n_rows, h4:], every
// entry with sign +1.
// Grid: ceil(n_out / kPullRows) CTAs of kPullThreads; CTA b owns the rows
// b + k * gridDim.x, k < kPullRows (see the note at the top).
template <bool kHalves>
__global__ void __launch_bounds__(kPullThreads)
signed_pull_kernel(const float4* __restrict__ h, const int32_t* __restrict__ past,
                   const int32_t* __restrict__ fut, const uint8_t* __restrict__ mask,
                   const int32_t* __restrict__ inc_ptr, const int32_t* __restrict__ inc_ent,
                   int n_ent, float4* __restrict__ out, int n_rows, int n_out, int h4) {
  const int in4 = kHalves ? 2 * h4 : h4;  // float4s a row of h
  __shared__ double2 part[2 * kPullThreads];  // each thread's four partial sums
  __shared__ int beg_s[kPullRows], end_s[kPullRows];
  const int G = gridDim.x;
  if (threadIdx.x < kPullRows) {
    const int64_t d = blockIdx.x + (int64_t)threadIdx.x * G;
    int b = 0, e1 = 0;
    if (d < n_out) {
      b = inc_ptr[d];
      e1 = inc_ptr[d + 1];
      if (b < 0 || e1 < b || e1 > n_ent) __trap();
    }
    beg_s[threadIdx.x] = b;
    end_s[threadIdx.x] = e1;
  }
  // every masked-in row's endpoints lie in [0, n_out), checked once over the
  // grid (the three loads issued together, beside the offsets above)
  for (int64_t e = (int64_t)blockIdx.x * kPullThreads + threadIdx.x; e < n_rows;
       e += (int64_t)G * kPullThreads) {
    const bool m = mask[e];
    const uint32_t p = (uint32_t)__ldg(past + e), f = (uint32_t)__ldg(fut + e);
    if (m && (p >= (uint32_t)n_out || f >= (uint32_t)n_out)) __trap();
  }
  __syncthreads();
  // the rows with no entry are zeros
  for (int i = threadIdx.x; i < kPullRows * h4; i += kPullThreads) {
    const int k = i / h4;
    const int64_t d = blockIdx.x + (int64_t)k * G;
    if (d < n_out && beg_s[k] == end_s[k])
      out[d * h4 + (i - k * h4)] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the listed rows, one at a time: columns over cp threads, entries over groups
  const int cp = h4 < kPullThreads ? h4 : kPullThreads;
  const int groups = kPullThreads / cp;
  const int cl = threadIdx.x % cp, g = threadIdx.x / cp;
  for (int k = 0; k < kPullRows; ++k) {
    const int b = beg_s[k], e1 = end_s[k];
    if (b == e1) continue;  // the same for the whole CTA
    const int64_t d = blockIdx.x + (int64_t)k * G;
    for (int c0 = 0; c0 < h4; c0 += cp) {
      const int c = c0 + cl;
      double ax = 0.0, ay = 0.0, az = 0.0, aw = 0.0;
      if (g < groups && c < h4) {
        for (int base = b + g; base < e1; base += groups * kPullUnroll) {
          int ent[kPullUnroll];
#pragma unroll
          for (int u = 0; u < kPullUnroll; ++u) {
            const int i = base + u * groups;
            ent[u] = i < e1 ? __ldg(inc_ent + i) : -1;
          }
          bool use[kPullUnroll], neg[kPullUnroll];
#pragma unroll
          for (int u = 0; u < kPullUnroll; ++u) {
            const int i = base + u * groups;
            if (i < e1 && (uint32_t)ent[u] >= 2u * (uint32_t)n_rows) __trap();
            neg[u] = ent[u] >= n_rows;
            if (neg[u]) ent[u] -= n_rows;  // the row
            use[u] = i < e1 && mask[ent[u]];
          }
          float4 v[kPullUnroll];
#pragma unroll
          for (int u = 0; u < kPullUnroll; ++u)
            v[u] = use[u] ? __ldg(h + (int64_t)ent[u] * in4 + (kHalves && neg[u] ? h4 : 0) + c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int u = 0; u < kPullUnroll; ++u) {
            if (!use[u]) continue;
            if (!kHalves && neg[u]) {
              ax -= (double)v[u].x; ay -= (double)v[u].y;
              az -= (double)v[u].z; aw -= (double)v[u].w;
            } else {
              ax += (double)v[u].x; ay += (double)v[u].y;
              az += (double)v[u].z; aw += (double)v[u].w;
            }
          }
        }
      }
      part[2 * threadIdx.x] = make_double2(ax, ay);
      part[2 * threadIdx.x + 1] = make_double2(az, aw);
      __syncthreads();
      if (g == 0 && c < h4) {
        double sx = 0.0, sy = 0.0, sz = 0.0, sw = 0.0;
        for (int gg = 0; gg < groups; ++gg) {  // group order
          const double2 p = part[2 * (gg * cp + cl)], q = part[2 * (gg * cp + cl) + 1];
          sx += p.x; sy += p.y; sz += q.x; sw += q.y;
        }
        out[d * h4 + c] = make_float4((float)sx, (float)sy, (float)sz, (float)sw);
      }
      __syncthreads();  // part is read before the next row writes it
    }
  }
}

constexpr int kBuildThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanUnroll = 8;   // offsets a scan thread has in flight
constexpr int kRankStage = 256;  // longest list a warp ranks from shared memory

// Destination of incidence entry k (row k % n_rows, past side for k <
// n_rows), or -1 where the row points at itself at both ends or the
// endpoint lies outside [0, n_out): such entries are not listed.
__device__ __forceinline__ int entry_key(const int32_t* __restrict__ past,
                                         const int32_t* __restrict__ fut, int64_t k,
                                         int n_rows, int n_out) {
  const int e = (int)(k < n_rows ? k : k - n_rows);
  const int p = __ldg(past + e), f = __ldg(fut + e);
  if (p == e && f == e) return -1;
  const int key = k < n_rows ? p : f;
  return (uint32_t)key < (uint32_t)n_out ? key : -1;
}

// 1. ptr[d + 1] = the count of d's entries (ptr zeroed before); a thread an
// entry.
__global__ void __launch_bounds__(kBuildThreads)
incidence_count_kernel(const int32_t* __restrict__ past, const int32_t* __restrict__ fut,
                       int32_t* __restrict__ ptr, int n_rows, int n_out) {
  const int64_t k = (int64_t)blockIdx.x * kBuildThreads + threadIdx.x;
  if (k >= 2 * (int64_t)n_rows) return;
  const int key = entry_key(past, fut, k, n_rows, n_out);
  if (key >= 0) atomicAdd(ptr + key + 1, 1);
}

// 2. one CTA: the inclusive scan of ptr[1 .. n_out] in place (thread t sums
// a contiguous chunk, the chunk totals are scanned across the CTA, then each
// chunk is rewritten), so ptr[d] is d's first entry; cur[d] = ptr[d].
__global__ void __launch_bounds__(kScanThreads)
incidence_scan_kernel(int32_t* __restrict__ ptr, int32_t* __restrict__ cur, int n_out) {
  __shared__ int warp_tot[kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t chunk = (n_out + kScanThreads - 1) / kScanThreads;
  const int64_t lo = 1 + tid * chunk, hi = lo + chunk < n_out + 1 ? lo + chunk : n_out + 1;
  int tot = 0;
  for (int64_t i0 = lo; i0 < hi; i0 += kScanUnroll) {
    int v[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) v[u] = i0 + u < hi ? ptr[i0 + u] : 0;
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) tot += v[u];
  }
  int incl = tot;
  for (int off = 1; off < 32; off *= 2) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_tot[lane];
    int wi = w;
    for (int off = 1; off < 32; off *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += v;
    }
    warp_tot[lane] = wi - w;  // exclusive over warps
  }
  __syncthreads();
  int run = warp_tot[warp] + incl - tot;
  for (int64_t i0 = lo; i0 < hi; i0 += kScanUnroll) {
    int v[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) v[u] = i0 + u < hi ? ptr[i0 + u] : 0;
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      run += v[u];
      if (i0 + u < hi) {
        ptr[i0 + u] = run;
        if (i0 + u < n_out) cur[i0 + u] = run;
      }
    }
  }
  if (tid == 0 && n_out > 0) cur[0] = 0;
}

// 3. each listed entry into its destination's list, at its cursor (the
// arrival order of atomics); a thread an entry.
__global__ void __launch_bounds__(kBuildThreads)
incidence_place_kernel(const int32_t* __restrict__ past, const int32_t* __restrict__ fut,
                       int32_t* __restrict__ cur, int32_t* __restrict__ loose, int n_rows,
                       int n_out) {
  const int64_t k = (int64_t)blockIdx.x * kBuildThreads + threadIdx.x;
  if (k >= 2 * (int64_t)n_rows) return;
  const int key = entry_key(past, fut, k, n_rows, n_out);
  if (key >= 0) loose[atomicAdd(cur + key, 1)] = (int32_t)k;
}

// 4. each list in entry order.  Warp w of the grid's n_warps looks at the
// destinations w + n_warps * lane (n_warps apart, so the neighbouring
// detection rows of a frame go to different warps); each list of two or
// more entries is ranked by the whole warp, an entry's place being the
// count of smaller entries in its list (from shared memory up to
// kRankStage entries).
__global__ void __launch_bounds__(kBuildThreads)
incidence_order_kernel(const int32_t* __restrict__ ptr, const int32_t* __restrict__ loose,
                       int32_t* __restrict__ ent, int n_out) {
  constexpr int kPer = kRankStage / 32;
  __shared__ int stage[kBuildThreads / 32][kRankStage];
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = (int64_t)gridDim.x * (kBuildThreads / 32);
  const int64_t w = (int64_t)blockIdx.x * (kBuildThreads / 32) + (threadIdx.x >> 5);
  int* st = stage[threadIdx.x >> 5];
  const int64_t d = w + n_warps * lane;
  int b = 0, e1 = 0;
  if (d < n_out) {
    b = ptr[d];
    e1 = ptr[d + 1];
  }
  if (e1 - b == 1) ent[b] = loose[b];
  unsigned todo = __ballot_sync(0xffffffffu, e1 - b > 1);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int lb = __shfl_sync(0xffffffffu, b, src), le = __shfl_sync(0xffffffffu, e1, src);
    const int L = le - lb;
    if (L <= kRankStage) {
      for (int i = lane; i < L; i += 32) st[i] = loose[lb + i];
      __syncwarp();
      int x[kPer], rank[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        x[u] = lane + 32 * u < L ? st[lane + 32 * u] : 0x7fffffff;
        rank[u] = 0;
      }
      const int used = (L + 31) / 32;
      for (int j = 0; j < L; ++j) {
        const int y = st[j];
#pragma unroll
        for (int u = 0; u < kPer; ++u)
          if (u < used) rank[u] += y < x[u];
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        if (lane + 32 * u < L) ent[lb + rank[u]] = x[u];
      __syncwarp();  // st is read before the next list overwrites it
    } else {
      for (int i = lb + lane; i < le; i += 32) {
        const int x = loose[i];
        int rank = 0;
        for (int j = lb; j < le; ++j) rank += loose[j] < x;
        ent[lb + rank] = x;
      }
    }
  }
}

constexpr int kDevices = 64;  // devices whose resident CTA counts are cached

// One launch of gather_rows_kernel<kConcat, L>, its grid the rows' groups or
// the CTAs resident at once, whichever is fewer (found once a device).
template <bool kConcat, int L>
int launch_gather_rows(const void* h, const void* past, const void* fut, const void* mask,
                       void* out, int n_rows, int h4, cudaStream_t s) {
  static int cache[kDevices] = {};
  auto kernel = gather_rows_kernel<kConcat, L>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int ctas = dev < kDevices ? cache[dev] : 0;
  if (ctas == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGatherThreads,
                                                             0)) != cudaSuccess)
      return (int)err;
    ctas = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kDevices) cache[dev] = ctas;
  }
  const int64_t rows_a_cta = (int64_t)kGatherRows * (kGatherThreads / L);
  const int64_t need = (n_rows + rows_a_cta - 1) / rows_a_cta;
  kernel<<<(unsigned)(need < ctas ? need : ctas), kGatherThreads, 0, s>>>(
      (const float4*)h, (const int32_t*)past, (const int32_t*)fut, (const uint8_t*)mask,
      (float4*)out, n_rows, h4);
  return (int)cudaGetLastError();
}

// gather_rows_kernel's instance for h4 float4s a row: L = h4 rounded up to a
// power of two, at most 32.
template <bool kConcat>
int gather_rows(const void* h, const void* past, const void* fut, const void* mask, void* out,
                int n_rows, int hidden, void* stream) {
  const int h4 = hidden / 4;
  if (n_rows == 0 || h4 == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (h4 <= 1) return launch_gather_rows<kConcat, 1>(h, past, fut, mask, out, n_rows, h4, s);
  if (h4 <= 2) return launch_gather_rows<kConcat, 2>(h, past, fut, mask, out, n_rows, h4, s);
  if (h4 <= 4) return launch_gather_rows<kConcat, 4>(h, past, fut, mask, out, n_rows, h4, s);
  if (h4 <= 8) return launch_gather_rows<kConcat, 8>(h, past, fut, mask, out, n_rows, h4, s);
  if (h4 <= 16) return launch_gather_rows<kConcat, 16>(h, past, fut, mask, out, n_rows, h4, s);
  return launch_gather_rows<kConcat, 32>(h, past, fut, mask, out, n_rows, h4, s);
}

template <bool kHalves>
int signed_pull(const void* h, const void* past, const void* fut, const void* mask,
                const void* inc_ptr, const void* inc_ent, int n_ent, void* out, int n_rows,
                int n_out, int hidden, void* stream) {
  if (n_out == 0 || hidden == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((n_out + kPullRows - 1) / kPullRows);
  signed_pull_kernel<kHalves><<<grid, kPullThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)h, (const int32_t*)past, (const int32_t*)fut, (const uint8_t*)mask,
      (const int32_t*)inc_ptr, (const int32_t*)inc_ent, n_ent, (float4*)out, n_rows, n_out,
      hidden / 4);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- edge GRU ----
constexpr int kGruWarps = 8;         // two warpgroups, each on its own tiles
constexpr int kGruThreads = 32 * kGruWarps;
constexpr int kGruWgThreads = 128;   // threads of a warpgroup
constexpr int kGruRows = 64;         // rows of a tile: one warpgroup's, 16 a warp
constexpr int kGruKC = 32;           // k values a restaged weight chunk holds (above H 600)
constexpr int kGruSmemMax = 232448;  // the most dynamic shared memory a CTA may opt in to (sm_90)
constexpr int kGruBlocks = 6;        // weight column blocks: w_ih r | z | n, then w_hh r | z | n

// The gates in fast math: __expf (~2 ulp plus ~1 ulp a unit of |x|) and a
// reciprocal; at most ~1e-6 from the correctly rounded gate
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * x));
}

// How a launch cuts the work for hidden width H.
//   U: units of each gate a CTA owns (32, 16 or 8; gridDim.y = ceil(H / U));
//      its wgmmas are N = 3U wide (the r, z and n columns of one matrix)
//   Kp: H rounded up to 8 (the k slots past H are zeros)
//   resident: the CTA's slab of both weight matrices, all Kp rows, stays in
//      shared memory for the whole launch (widths to 600); else each
//      warpgroup restages a kGruKC-row chunk of it every tile and chunk
struct GruShape {
  int U, Kp;
  bool resident;
  size_t smem;
};

// The split slab (all Kp rows, or a chunk a warpgroup) and the biases: B is
// 8 bytes a value (big, small)
inline size_t gru_smem(int U, int Kp, bool resident) {
  const size_t w = (size_t)U * (resident ? Kp : 2 * kGruKC) * kGruBlocks * 8;
  return w + (size_t)4 * U * sizeof(float);
}

// The widest U (32, 16, then 8) whose resident slab fits; no U is wider than
// Kp, so that few units are padding.
inline GruShape gru_shape(int H) {
  GruShape s{};
  s.Kp = (H + 7) / 8 * 8;
  for (int U = 32; U >= 8; U /= 2) {
    if (U > s.Kp && U > 8) continue;
    s.U = U;
    s.resident = true;
    s.smem = gru_smem(U, s.Kp, true);
    if (s.smem <= (size_t)kGruSmemMax) return s;
  }
  s.resident = false;  // U = 8
  s.smem = gru_smem(s.U, s.Kp, false);
  return s;
}

// Grid (tile CTAs, ceil(H / U)): blockIdx.y picks units [u0, u0 + U) of each
// gate.  The CTA's two warpgroups share its weight slab and walk tiles of
// kGruRows rows on their own (warpgroup w of CTA x takes tiles 2x + w, then
// every 2 gridDim.x); warp i of a warpgroup owns rows 16i .. 16i + 15 of its
// tile.  A thread reads its A fragments straight from global memory (L2):
// columns 2t, 2t + 1 of k step ks of h, h[past], h[fut] at rows g and g + 8,
// one k step ahead of their use; ns = h[past] - h[fut] in f32 (0 on a row
// that is no edge); each value split once.  Per k step of 8 the warpgroup
// issues ns x [w_ih r|z|n] and h x [w_hh r|z|n] of its U units (N = 3U) as
// 3xTF32 wgmmas, each product into a fresh accumulator, waits, and adds them
// in f32: the r and z sums take ns x w_ih, then h x w_hh (a K = 2H product
// of [ns | h] against [w_ih; w_hh]), gi_n and gh_n their own.  Every row is
// computed.  HF is H where the instance was built for one width (16, 32,
// 64: loop bounds known to the compiler), else 0.
template <int U, int HF>
__global__ void __launch_bounds__(kGruThreads, 1)
fused_edge_gru_kernel(const float* __restrict__ h, const int32_t* __restrict__ past,
                      const int32_t* __restrict__ fut, const uint8_t* __restrict__ mask,
                      const float* __restrict__ w_ih, const float* __restrict__ w_hh,
                      const float* __restrict__ b_ih, const float* __restrict__ b_hh,
                      float* __restrict__ out, int n_rows, int hidden, bool resident) {
  constexpr int NT = U / 8, R = kGruRows, DN = 3 * U / 2;  // n tiles a gate; floats of a product
  constexpr int kPart = 3 * U * 32;  // bytes of a (k step, matrix) half of B
  constexpr uint64_t kPartD = kPart >> 4;  // kPart in the descriptor's address units
  const int H = HF ? HF : hidden;
  const int Kp = (H + 7) / 8 * 8;
  const int KC = resident ? Kp : kGruKC;  // k values a weight chunk holds
  const int nchunks = (Kp + KC - 1) / KC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, wi = warp & 3, tw = threadIdx.x & (kGruWgThreads - 1);
  const int g = lane >> 2, t = lane & 3;
  const int u0 = blockIdx.y * U;
  auto wg_sync = [&] { asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kGruWgThreads)); };

  extern __shared__ float4 smem4[];
  // B of matrix mat (0: w_ih, 1: w_hh) at k step ks: big at s_w + (2 (2 ks +
  // mat)) kPart bytes, small kPart bytes after it; each 3U x 8 (n x k, n =
  // gate * U + unit) K-major in core matrices: n group i, k half kh at i *
  // 256 + kh * 128 bytes, row n % 8 16 bytes apart, element c holding k =
  // 8 ks + 2c + kh (the A fragments' k slots t and t + 4 are columns 2t and
  // 2t + 1 of h).  Non-resident: one chunk for each warpgroup, chunk_bytes
  // apart.
  char* s_w = (char*)smem4;
  const size_t chunk_bytes = (size_t)KC / 8 * 2 * 2 * kPart;
  float* s_bias = (float*)(s_w + (resident ? chunk_bytes : 2 * chunk_bytes));

  // b_ih + b_hh of r and of z, b_ih of n, b_hh of n, for the CTA's units
  for (int i = threadIdx.x; i < U; i += kGruThreads) {
    const int u = u0 + i;
    const bool live = u < H;
    s_bias[i] = live ? b_ih[u] + b_hh[u] : 0.f;
    s_bias[U + i] = live ? b_ih[H + u] + b_hh[H + u] : 0.f;
    s_bias[2 * U + i] = live ? b_ih[2 * H + u] : 0.f;
    s_bias[3 * U + i] = live ? b_hh[2 * H + u] : 0.f;
  }

  // Weight rows [k0, k0 + kc) of the CTA's columns, read from global memory
  // (L2), into the B layout at dst, split once into big and small, then made
  // visible to the wgmmas; threads tid, tid + nthr, ...  A thread writes one
  // 16-byte row of a core matrix: 4 k values of one unit (zeros past H).
  auto split_weights = [&](char* dst0, int k0, int kc, int tid, int nthr) {
    const int n = kc / 8 * 2 * 2 * 3 * U;  // (ks, mat, kh, n)
#pragma unroll 4
    for (int e = tid; e < n; e += nthr) {
      const int nn = e % (3 * U), rest = e / (3 * U);
      const int kh = rest & 1, mat = (rest >> 1) & 1, ks = rest >> 2;
      const int gate = nn / U, u = u0 + nn % U;
      const float* w = (mat ? w_hh : w_ih) + gate * H + u;
      float4 big, small;
      float* bp = &big.x;
      float* sp = &small.x;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = k0 + 8 * ks + 2 * c + kh;
        uint32_t b, s;
        split_tf32(u < H && k < H ? __ldg(w + (int64_t)k * 3 * H) : 0.f, b, s);
        bp[c] = __uint_as_float(b);
        sp[c] = __uint_as_float(s);
      }
      char* dst = dst0 + (size_t)(2 * (2 * ks + mat)) * kPart + (nn >> 3) * 256 + kh * 128 +
                  (nn & 7) * 16;
      *(float4*)dst = big;
      *(float4*)(dst + kPart) = small;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  const int n_tiles = (n_rows + R - 1) / R;
  const int gw = 2 * blockIdx.x + wg, n_gw = 2 * gridDim.x;  // the warpgroup among all
  const float2 zero2 = make_float2(0.f, 0.f);
  // rows g and g + 8 of the warp's 16 in a tile: h, h[past], h[fut] (null
  // where there is no row or no edge: read as zeros)
  const float *hr[2], *hp[2], *hf[2];
  auto setup_rows = [&](int tile) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = tile * R + 16 * wi + g + 8 * rr;
      const bool in = row < n_rows;
      const bool m = in && mask[row] != 0;
      const int32_t p = m ? __ldg(past + row) : 0, f = m ? __ldg(fut + row) : 0;
      if (m && ((uint32_t)p >= (uint32_t)n_rows || (uint32_t)f >= (uint32_t)n_rows)) __trap();
      hr[rr] = in ? h + (int64_t)row * H + 2 * t : nullptr;
      hp[rr] = m ? h + (int64_t)p * H + 2 * t : nullptr;
      hf[rr] = m ? h + (int64_t)f * H + 2 * t : nullptr;
    }
  };
  // the six float2 of k step ks (zeros past H: k slots 2t, 2t + 1 < H or both not)
  auto fetch = [&](int ks, float2 (&v)[6]) {
    const int c = 8 * ks;
    const bool ok = c + 2 * t < H;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      v[rr] = ok && hr[rr] ? __ldg((const float2*)(hr[rr] + c)) : zero2;
      v[2 + rr] = ok && hp[rr] ? __ldg((const float2*)(hp[rr] + c)) : zero2;
      v[4 + rr] = ok && hf[rr] ? __ldg((const float2*)(hf[rr] + c)) : zero2;
    }
  };
  float2 next[6];  // the A values of the next k step, fetched one step ahead
  if (gw < n_tiles) {  // the first tile's, in flight while the weights are staged
    setup_rows(gw);
    fetch(0, next);
  }
  if (resident)  // once a CTA: every tile reads the same slab
    split_weights(s_w, 0, Kp, threadIdx.x, kGruThreads);
  __syncthreads();
  char* w_chunk = resident ? s_w : s_w + wg * chunk_bytes;  // non-resident: this warpgroup's

  for (int tile = gw; tile < n_tiles; tile += n_gw) {
    if (tile != gw) {
      setup_rows(tile);
      fetch(0, next);
    }
    const int wrow = tile * R + 16 * wi;  // the warp's first row
    float acc[NT][4][4];  // per n tile: r, z, gi_n, gh_n in the m16n8 C layout
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][q][e] = 0.f;
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      const int k0 = chunk * KC, kst = (Kp - k0 < KC ? Kp - k0 : KC) / 8;
      if (!resident) {  // the previous chunk's wgmmas are waited for
        wg_sync();
        split_weights(w_chunk, k0, kst * 8, tw, kGruWgThreads);
        wg_sync();
      }
      // descriptor of matrix mat's big half at k step ks: desc0 + 2 (2 ks + mat) kPart
      const uint64_t desc0 = wg_desc(resident ? s_w + (size_t)k0 / 8 * 2 * 2 * kPart : w_chunk,
                                     128, 256);
#pragma unroll 1
      for (int ks = 0; ks < kst; ++ks) {
        float2 v[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) v[i] = next[i];
        if (k0 / 8 + ks + 1 < Kp / 8) fetch(k0 / 8 + ks + 1, next);
        const FragA ah = frag_a(v[0].x, v[1].x, v[0].y, v[1].y);
        const FragA an = frag_a(v[2].x - v[4].x, v[3].x - v[5].x, v[2].y - v[4].y,
                                v[3].y - v[5].y);
        float dn[DN], dh[DN];  // ns x w_ih, h x w_hh: [r | z | n] of the U units
        wg_hold(dn);
        wg_hold(dh);
        wg_fence();
        const uint64_t ih = desc0 + 4 * ks * kPartD, hh = ih + 2 * kPartD;
        // two commit groups: ns's sums are added while h's wgmmas run
        wgmma3<3 * U>(dn, an, ih, ih + kPartD);
        wg_commit();
        wgmma3<3 * U>(dh, ah, hh, hh + kPartD);
        wg_commit();
        wg_wait<1>();
        wg_hold(dn);
        float tr[NT][4], tz[NT][4];  // r and z with the ns part: ns first, as in the K = 2H order
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
    }

#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int ul = 8 * j + 2 * t, u = u0 + ul;
      if (u >= H) continue;  // u even, H % 4 == 0: u + 1 < H too
      const float2 br = *(const float2*)(s_bias + ul), bz = *(const float2*)(s_bias + U + ul);
      const float2 bi = *(const float2*)(s_bias + 2 * U + ul);
      const float2 bh = *(const float2*)(s_bias + 3 * U + ul);
      const float b_r[2] = {br.x, br.y}, b_z[2] = {bz.x, bz.y};
      const float b_in[2] = {bi.x, bi.y}, b_hn[2] = {bh.x, bh.y};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = wrow + g + 8 * rr;
        if (row >= n_rows) continue;
        const float2 hv = __ldg((const float2*)(h + (int64_t)row * H + u));
        const float hx[2] = {hv.x, hv.y};
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * rr + e;
          const float rv = sigmoid_fast(acc[j][0][i] + b_r[e]);
          const float zv = sigmoid_fast(acc[j][1][i] + b_z[e]);
          const float nv = tanh_fast((acc[j][2][i] + b_in[e]) + rv * (acc[j][3][i] + b_hn[e]));
          o[e] = (1.f - zv) * nv + zv * hx[e];
        }
        *(float2*)(out + (int64_t)row * H + u) = make_float2(o[0], o[1]);
      }
    }
  }
}

// Opt in to the most shared memory a CTA may use (any width of this
// instance fits); the most CTAs of this width resident at once.
template <int U, int HF>
int setup_fused_edge_gru(const GruShape& sh, int* max_ctas) {
  cudaError_t err = cudaFuncSetAttribute(fused_edge_gru_kernel<U, HF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kGruSmemMax);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_edge_gru_kernel<U, HF>,
                                                           kGruThreads, sh.smem)) != cudaSuccess)
    return (int)err;
  *max_ctas = sms * (per_sm > 0 ? per_sm : 1);
  return (int)cudaSuccess;
}

template <int U, int HF>
int launch_fused_edge_gru(const GruShape& sh, const void* h, const void* past, const void* fut,
                          const void* mask, const void* w_ih, const void* w_hh,
                          const void* b_ih, const void* b_hh, void* out, int n_rows, int hidden,
                          int max_ctas, cudaStream_t s) {
  const int n_y = (hidden + sh.U - 1) / sh.U;
  const int n_pairs = (n_rows + 2 * kGruRows - 1) / (2 * kGruRows);  // two tiles a CTA at once
  const int per_y = max_ctas / n_y > 0 ? max_ctas / n_y : 1;
  const dim3 grid(n_pairs < per_y ? n_pairs : per_y, n_y);
  fused_edge_gru_kernel<U, HF><<<grid, kGruThreads, sh.smem, s>>>(
      (const float*)h, (const int32_t*)past, (const int32_t*)fut, (const uint8_t*)mask,
      (const float*)w_ih, (const float*)w_hh, (const float*)b_ih, (const float*)b_hh,
      (float*)out, n_rows, hidden, sh.resident);
  return (int)cudaGetLastError();
}

// Returns F<U, HF>(sh, ...) for the instance of width `hidden`: one built
// for the width (16, 32, 64), else the generic one of its U.
#define TM_EDGE_GRU_DISPATCH(F, sh, hidden, ...)   \
  switch (hidden) {                                \
    case 16: return F<16, 16>(sh, __VA_ARGS__);    \
    case 32: return F<32, 32>(sh, __VA_ARGS__);    \
    case 64: return F<32, 64>(sh, __VA_ARGS__);    \
  }                                                \
  if ((sh).U == 32) return F<32, 0>(sh, __VA_ARGS__); \
  if ((sh).U == 16) return F<16, 0>(sh, __VA_ARGS__); \
  return F<8, 0>(sh, __VA_ARGS__)

}  // namespace

// h: f32[n_rows, hidden]; past, fut: int32[n_rows]; mask: uint8/bool[n_rows];
// out: f32[n_rows, hidden].  hidden % 4 == 0, h and out 16-byte aligned;
// past/fut of every masked-in row lie in [0, n_rows), or the kernel traps.
// One launch.
extern "C" int tm_gather_diff(const void* h, const void* past, const void* fut,
                              const void* mask, void* out, int n_rows,
                              int hidden, void* stream) {
  return gather_rows<false>(h, past, fut, mask, out, n_rows, hidden, stream);
}

// As tm_gather_diff, with out: f32[n_rows, 2 hidden], h[past] in columns
// :hidden and h[fut] in hidden: of every masked-in row, zeros elsewhere.
extern "C" int tm_gather_concat(const void* h, const void* past, const void* fut,
                                const void* mask, void* out, int n_rows, int hidden,
                                void* stream) {
  return gather_rows<true>(h, past, fut, mask, out, n_rows, hidden, stream);
}

// h: f32[n_rows, hidden]; past, fut: int32[n_rows]; mask: uint8/bool[n_rows];
// inc_ptr: int32[n_out + 1], inc_ent: int32[n_ent] (entry k < n_rows: row k,
// sign +1; else row k - n_rows, sign -1; destination d's in
// inc_ent[inc_ptr[d] .. inc_ptr[d + 1])); out: f32[n_out, hidden], every
// element written.
// hidden % 4 == 0, h and out 16-byte aligned; past/fut of every masked-in
// row lie in [0, n_out), and the incidence's offsets and rows in range, or
// the kernel traps.  One launch.
extern "C" int tm_signed_segment_sum(const void* h, const void* past, const void* fut,
                                     const void* mask, const void* inc_ptr,
                                     const void* inc_ent, int n_ent, void* out, int n_rows,
                                     int n_out, int hidden, void* stream) {
  return signed_pull<false>(h, past, fut, mask, inc_ptr, inc_ent, n_ent, out, n_rows, n_out,
                            hidden, stream);
}

// The halves mode: g f32[n_rows, 2 hidden]; out[d] = the sum of g[e, :hidden]
// over masked-in rows e with past(e) = d plus that of g[e, hidden:] over those
// with fut(e) = d, through the same incidence, f64 rounded once; otherwise as
// tm_signed_segment_sum.  One launch.
extern "C" int tm_segment_sum_halves(const void* g, const void* past, const void* fut,
                                     const void* mask, const void* inc_ptr,
                                     const void* inc_ent, int n_ent, void* out, int n_rows,
                                     int n_out, int hidden, void* stream) {
  return signed_pull<true>(g, past, fut, mask, inc_ptr, inc_ent, n_ent, out, n_rows, n_out,
                           hidden, stream);
}

// past, fut int32[n_rows]; writes ptr int32[n_out + 1] and the first
// ptr[n_out] of ent int32[2 n_rows]; scratch int32[n_out + 2 n_rows].  One
// call: a memset and four kernels on `stream`, no synchronisation.
extern "C" int tm_segment_incidence(const void* past, const void* fut, void* ptr, void* ent,
                                    void* scratch, int n_rows, int n_out, void* stream) {
  if (n_rows < 0 || n_out < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* p = (int32_t*)ptr;
  int32_t* cur = (int32_t*)scratch;
  int32_t* loose = cur + n_out;
  const int32_t *pa = (const int32_t*)past, *fu = (const int32_t*)fut;
  cudaError_t err = cudaMemsetAsync(p, 0, ((size_t)n_out + 1) * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  // a thread for each entry
  const unsigned per_entry =
      (unsigned)((2 * (int64_t)n_rows + kBuildThreads - 1) / kBuildThreads);
  if (per_entry > 0)
    incidence_count_kernel<<<per_entry, kBuildThreads, 0, s>>>(pa, fu, p, n_rows, n_out);
  incidence_scan_kernel<<<1, kScanThreads, 0, s>>>(p, cur, n_out);
  if (per_entry > 0)
    incidence_place_kernel<<<per_entry, kBuildThreads, 0, s>>>(pa, fu, cur, loose, n_rows,
                                                               n_out);
  // a warp for each 32 destinations
  const unsigned per_dest = (unsigned)(((int64_t)n_out + kBuildThreads - 1) / kBuildThreads);
  if (per_dest > 0)
    incidence_order_kernel<<<per_dest, kBuildThreads, 0, s>>>(p, loose, (int32_t*)ent, n_out);
  return (int)cudaGetLastError();
}

// Once a device and hidden width, before tm_fused_edge_gru on that device:
// opts the kernel in to its shared memory and writes the grid's CTA cap to
// *max_ctas.  hidden % 4 == 0 and > 0 (else cudaErrorInvalidValue).
extern "C" int tm_fused_edge_gru_setup(int hidden, void* max_ctas) {
  if (hidden <= 0 || hidden % 4 != 0) return (int)cudaErrorInvalidValue;
  const GruShape sh = gru_shape(hidden);
  int* cap = (int*)max_ctas;
  TM_EDGE_GRU_DISPATCH(setup_fused_edge_gru, sh, hidden, cap);
}

// h: f32[n_rows, hidden]; past, fut: int32[n_rows]; mask: uint8/bool[n_rows];
// w_ih, w_hh: f32[hidden, 3 * hidden]; b_ih, b_hh: f32[3 * hidden]; out:
// f32[n_rows, hidden].  hidden % 4 == 0 (else cudaErrorInvalidValue); h, out
// and the weights 16-byte aligned; max_ctas from tm_fused_edge_gru_setup;
// past/fut of every masked-in row lie in [0, n_rows), or the kernel traps.
extern "C" int tm_fused_edge_gru(const void* h, const void* past, const void* fut,
                                 const void* mask, const void* w_ih, const void* w_hh,
                                 const void* b_ih, const void* b_hh, void* out, int n_rows,
                                 int hidden, int max_ctas, void* stream) {
  if (hidden <= 0 || hidden % 4 != 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const GruShape sh = gru_shape(hidden);
  TM_EDGE_GRU_DISPATCH(launch_fused_edge_gru, sh, hidden, h, past, fut, mask, w_ih, w_hh, b_ih,
                       b_hh, out, n_rows, hidden, max_ctas, (cudaStream_t)stream);
}
