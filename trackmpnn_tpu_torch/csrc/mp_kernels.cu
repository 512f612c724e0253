// Hopper (sm_90a) kernels for the message-passing ops of the serving path.
// Built by trackmpnn_tpu_torch/ops/_build.py into a shared library with a
// plain C interface and called through ctypes from ops/mp.py, which checks
// device, dtype, shape, contiguity and alignment before any pointer gets here.
//
// gather_diff
//   Replaces _gather_diff_kernel / gather_diff_pallas in
//   trackmpnn_tpu/ops/pallas_mp.py.
//   out[k] = edge_k ? h[past_k] - h[fut_k] : 0          (f32, exact)
//   Bound: device-memory bytes (h rows read, out written, 9 B of index per
//   row); one subtraction per element is nothing against that.  The TPU
//   kernel walks rows in a serial fori_loop because Mosaic could not lower a
//   vector gather; the card gathers natively, so here every thread owns one
//   float4 of one row (H/4 threads per row, 16 for H = 64): neighbouring
//   threads read neighbouring 16-byte words of the same h row, and every
//   load and store is one 16-byte transaction.
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
//   Bound: f32 operations.  The two products take 2 * 2 * H * 3H a row
//   (49,152 at H = 64) against ~4 * (3H + 3) bytes of traffic a row, ~60
//   operations a byte, three times the card's f32 ridge (67 TFLOP/s over
//   3.35 TB/s).  The TPU kernel holds all of h in VMEM and feeds 512-row
//   tiles to the MXU.  Here a CTA owns UC hidden units (16, 32 or 64: the
//   smallest that covers H, else 64; gridDim.y = ceil(H / UC)) and walks
//   tiles of kGruTileRows rows in a persistent grid (as many CTAs as fit on
//   the SMs).  The k loop runs in chunks of kGruKChunk: the chunk's rows of
//   both weight matrices (their UC columns of each gate block) and the
//   tile's h and gathered-difference columns go to opted-in dynamic shared
//   memory.  Where H <= kGruKChunk there is one chunk and the weights are
//   staged once a CTA (96 KiB at H = 64); wider widths (H = 128 would need
//   384 KiB) restage each chunk a tile.  Each thread owns one unit u (the r,
//   z and n columns of both products: six dot products) for kGruTileRows /
//   (256 / UC) rows, so each weight read from shared memory feeds that many
//   FMAs and each row value read is a broadcast.  Products on the CUDA
//   cores in f32, every sum in k order inside one thread whatever the
//   chunking: bitwise repeatable, no atomics.  Any N, any H % 4 == 0;
//   H 16, 32 and 64 get instances with H known to the compiler.
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

namespace {

constexpr int kThreads = 256;

__global__ void gather_diff_kernel(const float4* __restrict__ h,
                                   const int32_t* __restrict__ past,
                                   const int32_t* __restrict__ fut,
                                   const uint8_t* __restrict__ mask,
                                   float4* __restrict__ out,
                                   int64_t total, int h4, int n_rows) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t row = t / h4;
  const int c = (int)(t - row * h4);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (mask[row]) {
    const int32_t p = past[row], f = fut[row];
    if ((uint32_t)p >= (uint32_t)n_rows || (uint32_t)f >= (uint32_t)n_rows) __trap();
    const float4 a = __ldg(h + (int64_t)p * h4 + c);
    const float4 b = __ldg(h + (int64_t)f * h4 + c);
    v = make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
  }
  out[t] = v;
}

constexpr int kPullThreads = 256;
constexpr int kPullRows = 16;    // destination rows a CTA owns (gridDim.x apart)
constexpr int kPullUnroll = 8;   // entries a thread has in flight

// Incidence entry k: row k with sign +1 for k < n_rows, row k - n_rows with
// sign -1 for k >= n_rows (the doubled incidence [past; fut]).
// Grid: ceil(n_out / kPullRows) CTAs of kPullThreads; CTA b owns the rows
// b + k * gridDim.x, k < kPullRows (see the note at the top).
__global__ void __launch_bounds__(kPullThreads)
signed_pull_kernel(const float4* __restrict__ h, const int32_t* __restrict__ past,
                   const int32_t* __restrict__ fut, const uint8_t* __restrict__ mask,
                   const int32_t* __restrict__ inc_ptr, const int32_t* __restrict__ inc_ent,
                   int n_ent, float4* __restrict__ out, int n_rows, int n_out, int h4) {
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
            v[u] = use[u] ? __ldg(h + (int64_t)ent[u] * h4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int u = 0; u < kPullUnroll; ++u) {
            if (!use[u]) continue;
            if (neg[u]) {
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

inline unsigned int blocks_for(int64_t total) {
  return (unsigned int)((total + kThreads - 1) / kThreads);
}

constexpr int kGruThreads = 256;
constexpr int kGruTileRows = 32;
constexpr int kGruKChunk = 64;  // rows k of the weights staged at once

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// Units a CTA owns: the smallest of 16, 32, 64 that covers H, else 64.
inline int gru_units(int hidden) { return hidden <= 16 ? 16 : hidden <= 32 ? 32 : 64; }

// Shared memory of a CTA: two weight chunks [ks][3][UC] and the tile's h and
// ns columns [kGruTileRows][ks], ks = min(H, kGruKChunk).
inline size_t gru_smem_bytes(int units, int hidden) {
  const int ks = hidden < kGruKChunk ? hidden : kGruKChunk;
  return (size_t)(2 * ks * 3 * units + 2 * kGruTileRows * ks) * sizeof(float);
}

// Grid (tile CTAs, ceil(H / UC)): blockIdx.y picks the units [u0, u0 + UC),
// blockIdx.x walks tiles of kGruTileRows rows.  Each thread owns unit u of
// its CTA and RPT rows of a tile; the k loop runs in chunks of kGruKChunk
// (the chunk's weight rows, the tile's h and ns columns in shared memory).
// HF is H where H == UC (16, 32, 64: strides and loop bounds known to the
// compiler), else 0 (H from `hidden`).
template <int UC, int HF>
__global__ void __launch_bounds__(kGruThreads)
fused_edge_gru_kernel(const float* __restrict__ h, const int32_t* __restrict__ past,
                      const int32_t* __restrict__ fut, const uint8_t* __restrict__ mask,
                      const float* __restrict__ w_ih, const float* __restrict__ w_hh,
                      const float* __restrict__ b_ih, const float* __restrict__ b_hh,
                      float* __restrict__ out, int n_rows, int hidden) {
  const int H = HF ? HF : hidden;
  constexpr int RG = kGruThreads / UC;      // row groups: threads that share a unit
  constexpr int RPT = kGruTileRows / RG;    // rows a thread
  constexpr int UC4 = UC / 4;
  static_assert(kGruThreads % UC == 0 && kGruTileRows % RG == 0, "tile shape");
  extern __shared__ float4 smem4[];
  const int H4 = H / 4;
  const int ks = H < kGruKChunk ? H : kGruKChunk;  // k values a chunk holds
  float* s_wih = reinterpret_cast<float*>(smem4);  // [ks][3][UC]: the chunk's rows, gate blocks
  float* s_whh = s_wih + ks * 3 * UC;              // [ks][3][UC]
  float* s_h = s_whh + ks * 3 * UC;                // [kGruTileRows][ks]: the tile's rows
  float* s_ns = s_h + kGruTileRows * ks;           // [kGruTileRows][ks]: their differences
  const int u0 = blockIdx.y * UC;
  const int uw4 = (H - u0 < UC ? H - u0 : UC) / 4;  // live float4s of a gate block here
  const int lu = threadIdx.x % UC, rg = threadIdx.x / UC;
  const int u = u0 + lu;
  const bool live = lu < uw4 * 4;
  const float bir = live ? b_ih[u] : 0.f, biz = live ? b_ih[H + u] : 0.f;
  const float bin = live ? b_ih[2 * H + u] : 0.f, bhr = live ? b_hh[u] : 0.f;
  const float bhz = live ? b_hh[H + u] : 0.f, bhn = live ? b_hh[2 * H + u] : 0.f;
  const float4* h4 = reinterpret_cast<const float4*>(h);
  const float4* wih4 = reinterpret_cast<const float4*>(w_ih);
  const float4* whh4 = reinterpret_cast<const float4*>(w_hh);
  const int n_tiles = (n_rows + kGruTileRows - 1) / kGruTileRows;
  const bool one_chunk = H <= kGruKChunk;

  // Weight rows [k0, k0 + kc), columns [u0, u0 + UC) of each gate block;
  // zero beyond H.  Offsets are multiples of 4 floats (H % 4 == 0, u0 % 16 == 0).
  auto stage_weights = [&](int k0, int kc) {
    for (int i = threadIdx.x; i < kc * 3 * UC4; i += kGruThreads) {
      const int kk = i / (3 * UC4), rest = i - kk * 3 * UC4;
      const int g = rest / UC4, c = rest - g * UC4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (c < uw4) {
        const int64_t off = ((int64_t)(k0 + kk) * 3 * H + g * H + u0) / 4 + c;
        a = __ldg(wih4 + off);
        b = __ldg(whh4 + off);
      }
      reinterpret_cast<float4*>(s_wih)[i] = a;
      reinterpret_cast<float4*>(s_whh)[i] = b;
    }
  };
  if (one_chunk) stage_weights(0, H);  // once a CTA: every tile reads the same weights

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kGruTileRows;
    float ir[RPT], iz[RPT], in_[RPT], hr[RPT], hz[RPT], hn[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) ir[j] = iz[j] = in_[j] = hr[j] = hz[j] = hn[j] = 0.f;
    for (int k0 = 0; k0 < H; k0 += kGruKChunk) {
      const int kc = H - k0 < kGruKChunk ? H - k0 : kGruKChunk, kc4 = kc / 4;
      __syncthreads();  // weights staged; the previous chunk no longer read
      if (!one_chunk) stage_weights(k0, kc);
      for (int i = threadIdx.x; i < kGruTileRows * kc4; i += kGruThreads) {
        const int r = i / kc4, c = i - r * kc4;
        const int row = row0 + r;
        float4 hv = make_float4(0.f, 0.f, 0.f, 0.f), nv = hv;
        if (row < n_rows) {
          hv = __ldg(h4 + (int64_t)row * H4 + k0 / 4 + c);
          if (mask[row]) {
            const int32_t p = past[row], f = fut[row];
            if ((uint32_t)p >= (uint32_t)n_rows || (uint32_t)f >= (uint32_t)n_rows) __trap();
            const float4 a = __ldg(h4 + (int64_t)p * H4 + k0 / 4 + c);
            const float4 b = __ldg(h4 + (int64_t)f * H4 + k0 / 4 + c);
            nv = make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
          }
        }
        reinterpret_cast<float4*>(s_h)[r * (ks / 4) + c] = hv;
        reinterpret_cast<float4*>(s_ns)[r * (ks / 4) + c] = nv;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        const float* wi = s_wih + kk * 3 * UC;
        const float* wh = s_whh + kk * 3 * UC;
        const float wir = wi[lu], wiz = wi[UC + lu], win = wi[2 * UC + lu];
        const float whr = wh[lu], whz = wh[UC + lu], whn = wh[2 * UC + lu];
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const int r = rg + j * RG;
          const float x = s_ns[r * ks + kk], y = s_h[r * ks + kk];
          ir[j] = fmaf(x, wir, ir[j]);
          iz[j] = fmaf(x, wiz, iz[j]);
          in_[j] = fmaf(x, win, in_[j]);
          hr[j] = fmaf(y, whr, hr[j]);
          hz[j] = fmaf(y, whz, hz[j]);
          hn[j] = fmaf(y, whn, hn[j]);
        }
      }
    }
    if (!live) continue;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int row = row0 + rg + j * RG;
      if (row >= n_rows) continue;
      const float rv = sigmoidf((ir[j] + bir) + (hr[j] + bhr));
      const float zv = sigmoidf((iz[j] + biz) + (hz[j] + bhz));
      const float nv = tanhf((in_[j] + bin) + rv * (hn[j] + bhn));
      out[(int64_t)row * H + u] = (1.f - zv) * nv + zv * __ldg(h + (int64_t)row * H + u);
    }
  }
}

// Opt in to the kernel's shared memory on the current device (the most any
// width of this instance takes); the most CTAs of this width resident at once.
template <int UC, int HF>
int setup_fused_edge_gru(int hidden, int* max_ctas) {
  const size_t smem = gru_smem_bytes(UC, hidden);
  cudaError_t err = cudaFuncSetAttribute(fused_edge_gru_kernel<UC, HF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)gru_smem_bytes(UC, HF ? HF : kGruKChunk));
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_edge_gru_kernel<UC, HF>,
                                                           kGruThreads, smem)) != cudaSuccess)
    return (int)err;
  *max_ctas = sms * (per_sm > 0 ? per_sm : 1);
  return (int)cudaSuccess;
}

template <int UC, int HF>
int launch_fused_edge_gru(const void* h, const void* past, const void* fut, const void* mask,
                          const void* w_ih, const void* w_hh, const void* b_ih,
                          const void* b_hh, void* out, int n_rows, int hidden, int max_ctas,
                          cudaStream_t s) {
  const int n_uc = (hidden + UC - 1) / UC;
  const int n_tiles = (n_rows + kGruTileRows - 1) / kGruTileRows;
  const int per_uc = max_ctas / n_uc > 0 ? max_ctas / n_uc : 1;
  const dim3 grid(n_tiles < per_uc ? n_tiles : per_uc, n_uc);
  fused_edge_gru_kernel<UC, HF><<<grid, kGruThreads, gru_smem_bytes(UC, hidden), s>>>(
      (const float*)h, (const int32_t*)past, (const int32_t*)fut, (const uint8_t*)mask,
      (const float*)w_ih, (const float*)w_hh, (const float*)b_ih, (const float*)b_hh,
      (float*)out, n_rows, hidden);
  return (int)cudaGetLastError();
}

}  // namespace

// h: f32[n_rows, hidden]; past, fut: int32[n_rows]; mask: uint8/bool[n_rows];
// out: f32[n_rows, hidden].  hidden % 4 == 0, h and out 16-byte aligned;
// past/fut of every masked-in row lie in [0, n_rows), or the kernel traps.
extern "C" int tm_gather_diff(const void* h, const void* past, const void* fut,
                              const void* mask, void* out, int n_rows,
                              int hidden, void* stream) {
  const int h4 = hidden / 4;
  const int64_t total = (int64_t)n_rows * h4;
  if (total == 0) return (int)cudaSuccess;
  gather_diff_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)h, (const int32_t*)past, (const int32_t*)fut,
      (const uint8_t*)mask, (float4*)out, total, h4, n_rows);
  return (int)cudaGetLastError();
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
  if (n_out == 0 || hidden == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((n_out + kPullRows - 1) / kPullRows);
  signed_pull_kernel<<<grid, kPullThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)h, (const int32_t*)past, (const int32_t*)fut, (const uint8_t*)mask,
      (const int32_t*)inc_ptr, (const int32_t*)inc_ent, n_ent, (float4*)out, n_rows, n_out,
      hidden / 4);
  return (int)cudaGetLastError();
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
  int* cap = (int*)max_ctas;
  switch (hidden) {
    case 16: return setup_fused_edge_gru<16, 16>(hidden, cap);
    case 32: return setup_fused_edge_gru<32, 32>(hidden, cap);
    case 64: return setup_fused_edge_gru<64, 64>(hidden, cap);
  }
  switch (gru_units(hidden)) {
    case 16: return setup_fused_edge_gru<16, 0>(hidden, cap);
    case 32: return setup_fused_edge_gru<32, 0>(hidden, cap);
    default: return setup_fused_edge_gru<64, 0>(hidden, cap);
  }
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
  const cudaStream_t s = (cudaStream_t)stream;
#define TM_EDGE_GRU(UC, HF)                                                            \
  launch_fused_edge_gru<UC, HF>(h, past, fut, mask, w_ih, w_hh, b_ih, b_hh, out, n_rows, \
                                hidden, max_ctas, s)
  switch (hidden) {
    case 16: return TM_EDGE_GRU(16, 16);
    case 32: return TM_EDGE_GRU(32, 32);
    case 64: return TM_EDGE_GRU(64, 64);
  }
  switch (gru_units(hidden)) {
    case 16: return TM_EDGE_GRU(16, 0);
    case 32: return TM_EDGE_GRU(32, 0);
    default: return TM_EDGE_GRU(64, 0);
  }
#undef TM_EDGE_GRU
}
