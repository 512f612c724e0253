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
//   out[d] = sum_{e: past_e = d} h[e] - sum_{e: fut_e = d} h[e]  over edges e
//   Bound: device-memory bytes (edge rows of h read once, out written once)
//   plus 2*H atomics per edge row, which resolve in L2.  The TPU kernel
//   accumulates serially in VMEM over a sequential grid; blocks here run in
//   no order, so each thread scatters its float4 of one edge row with
//   red.add atomics into the two endpoint rows.  In f32 the varying order
//   would move the last bits from run to run, and at serving sizes (~135
//   terms a row, partial sums ~50) that noise reaches 1e-5.  So the atomics
//   accumulate in an f64 scratch the caller allocates, zeroed here on the
//   stream, and a second kernel rounds it to f32 once: the result is the
//   correctly rounded sum, whatever the order, unless the exact sum lies
//   within f64 rounding (~1e-14) of an f32 rounding boundary.  The cost is
//   the scratch's traffic (8 B a value, in L2 at serving sizes).
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
// An endpoint index of an edge row outside the rows it addresses traps the
// kernel (a sticky CUDA error that the next synchronisation raises) rather
// than reading or writing out of bounds; the check is two compares a thread.
//
// No kernel synchronises or allocates: the caller allocates `out` (and the
// scatter's scratch) and every launch goes to the stream it is given.
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

__global__ void signed_scatter_kernel(const float4* __restrict__ h,
                                      const int32_t* __restrict__ past,
                                      const int32_t* __restrict__ fut,
                                      const uint8_t* __restrict__ mask,
                                      double* __restrict__ acc,
                                      int64_t total, int h4, int n_out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t row = t / h4;
  if (!mask[row]) return;
  const int32_t p = past[row], f = fut[row];
  if ((uint32_t)p >= (uint32_t)n_out || (uint32_t)f >= (uint32_t)n_out) __trap();
  const int c = (int)(t - row * h4);
  const float4 v = __ldg(h + t);
  double* dp = acc + ((int64_t)p * h4 + c) * 4;
  double* df = acc + ((int64_t)f * h4 + c) * 4;
  atomicAdd(dp + 0, (double)v.x);
  atomicAdd(dp + 1, (double)v.y);
  atomicAdd(dp + 2, (double)v.z);
  atomicAdd(dp + 3, (double)v.w);
  atomicAdd(df + 0, -(double)v.x);
  atomicAdd(df + 1, -(double)v.y);
  atomicAdd(df + 2, -(double)v.z);
  atomicAdd(df + 3, -(double)v.w);
}

// out[i] = (float)acc[i], four values a thread.
__global__ void round_to_f32_kernel(const double2* __restrict__ acc,
                                    float4* __restrict__ out, int64_t total4) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total4) return;
  const double2 a = acc[2 * t], b = acc[2 * t + 1];
  out[t] = make_float4((float)a.x, (float)a.y, (float)b.x, (float)b.y);
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

// h: f32[n_rows, hidden]; scratch: f64[n_out, hidden], zeroed here on
// `stream`; out: f32[n_out, hidden].  hidden % 4 == 0, every pointer
// 16-byte aligned; past/fut of every masked-in row lie in [0, n_out), or
// the kernel traps.
extern "C" int tm_signed_segment_sum(const void* h, const void* past,
                                     const void* fut, const void* mask,
                                     void* scratch, void* out, int n_rows,
                                     int n_out, int hidden, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int h4 = hidden / 4;
  const int64_t total4 = (int64_t)n_out * h4;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)total4 * 4 * sizeof(double), s);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)n_rows * h4;
  if (total > 0) {
    signed_scatter_kernel<<<blocks_for(total), kThreads, 0, s>>>(
        (const float4*)h, (const int32_t*)past, (const int32_t*)fut,
        (const uint8_t*)mask, (double*)scratch, total, h4, n_out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (total4 == 0) return (int)cudaSuccess;
  round_to_f32_kernel<<<blocks_for(total4), kThreads, 0, s>>>(
      (const double2*)scratch, (float4*)out, total4);
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
