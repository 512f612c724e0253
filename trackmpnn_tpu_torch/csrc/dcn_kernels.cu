// Hopper (sm_90a) kernels for the bounded modulated deformable convolution
// (DCNv2, 3x3 taps, stride 1, padding 1, dilation 1) of the DLA-34
// embedding backbone, forward and backward.  Built by
// trackmpnn_tpu_torch/ops/_build.py into a shared library with a plain C
// interface and called through ctypes from ops/dcn.py, which checks device,
// dtype, shape and contiguity before any pointer gets here.  All math is
// f32; the two products run on the tensor cores in split TF32 (3xTF32,
// csrc/tf32_mma.cuh: f32-level error).  No kernel uses atomics and every sum
// runs in an order fixed by the shapes and the device, so every result is
// the same from run to run.
//
// Layouts (the JAX package's): x [N, H, W, C]; weight [9*C, O] with row
// k*C + c for tap k = kh*3 + kw; offset [N, H, W, 18] as (dy, dx) per tap;
// mask [N, H, W, 9], already sigmoided; out and its cotangent g [N, H, W,
// O]; the columns' cotangent dcols = g @ weight^T [N, H, W, 9*C].  Pixel
// p = (n*H + y)*W + x, below 2^31 (an offset array of 2^31 pixels would
// alone outgrow the card).
//
// Sampling.  Tap k of pixel p samples x at (y - 1 + kh + dy, x - 1 + kw +
// dx), each offset clamped to [-bound, bound].  The TPU kernel writes the
// bilinear sample as a sum over the (2R+2)^2 integer shifts of hat weights
// relu(1-|dy-u|) relu(1-|dx-v|), R = ceil(bound), because Mosaic cannot lower
// a gather (trackmpnn_tpu/ops/pallas_dcn.py:8-21).  For a clamped offset at
// most two hat weights a dimension are non-zero, floor(dy) and floor(dy)+1,
// so the sum is the 4-neighbour bilinear sample with zeros outside the
// image: the kernels read those four neighbours directly, and no cost grows
// with R except dcn_bwd_dx's halo.  The masked sample of
// (p, k, c) is sum_j (w_j * mask) * x[nb_j, c], j in neighbour order, in
// both kernels that build it.
//
// dcn_fwd
//   Replaces _dcn_kernel (trackmpnn_tpu/ops/pallas_dcn.py:45), the whole
//   batch in one launch (the TPU calls it once an image) and the bias added
//   in the epilogue.  out[p, o] = sum_{k, c} mask * sample(x, p, k)[c] *
//   weight[k*C + c, o] + bias[o].  Bound: operations, 2 * 9 * C * O a pixel
//   (18.1 GFLOP at the widest DLA-34 block, 8 x 96 x 320, C = O = 64: 287 us
//   at the f32 rate, 110 us as 3xTF32 at the TF32 rate).  The first design
//   ran the product on the CUDA cores (a 4 x 4 register tile, five
//   shared-memory loads for every 16 FMAs, single-buffered tiles filled by
//   one-warp-a-pixel gathers that did not overlap the product) at 3.5x the
//   f32 bound.
//   Design: an implicit GEMM on the tensor cores, 3xTF32 wgmma (m64n64k8,
//   A and B from shared memory).  A CTA of two warpgroups owns 128 pixels
//   (an 8 x 16 block of the map where the map is whole blocks, else 128 in
//   order) x 64 outputs, a warpgroup 64 pixels.  It resolves its pixels'
//   9 x 4 neighbour indices and mask-scaled bilinear weights once into
//   shared memory, then walks steps (16-channel chunk, tap), the taps of a
//   chunk after each other so that their overlapping neighbour rows are
//   read from L1 (the 2-D block keeps that footprint small).  Each step's A
//   (the masked samples) is built on the fly from 16-byte loads of each
//   neighbour's channel row and split into big and small TF32 parts once,
//   as it is stored in the wgmma layout; the tap's weight rows come in by
//   cp.async and are split once a CTA.  A and B are double-buffered: the
//   next step's gathers and weights are in flight while this step's first k
//   step runs, and are built while its second runs, one barrier a step.
//   Each k step of 8 goes into a fresh accumulator added in f32.  The
//   columns never reach device memory.  Where the grid would not give every
//   SM two CTAs (a small map with many channels, such as 8 x 12 x 40 at C
//   512, O 256), the taps are split into 3 or 9 groups over grid.z; each
//   group writes its partial outputs to scratch and a second launch sums
//   them in group order and adds the bias.
//
// dcn_bwd_sample
//   The sampling transpose and d weight (the TPU kernel is forward only;
//   JAX trains through the XLA custom VJP of the warp,
//   backbones/deform_conv.py:159-252).  From dcols and g it writes d weight
//   [9*C, O] = cols^T g, d offset and d mask, and the columns stay on chip.
//   r_j = sum_c x_j[c] * dcols[c] for the four neighbours; d mask = sum_j
//   w_j r_j, and d dy = mask * sum_v wx_v (r(u0+1, v) - r(u0, v)) (d dx
//   likewise) -- the hat derivative -sign(dy-u) where relu(1-|dy-u|) > 0,
//   with sign(0) = 0, so that at an integer offset (fy = 0) the offset
//   gradient is exactly 0, as the JAX VJP gives it (:233-242).  The clamp
//   passes the gradient inside the bound, half of it at the bound itself
//   (jnp.clip's) and none outside.  Bound: bytes (x, offset, mask, dcols
//   and g read once; d offset, d mask and d weight written: ~222 us at the
//   widest block, of which dcols is 566 MB); its d weight product is 18.1
//   GFLOP (110 us as 3xTF32).  The first design ran a warp for each (pixel,
//   tap) with 64-bit divisions, broadcast offset loads and four 5-level
//   shuffle trees for 8 FMAs a lane, and wrote the columns for a separate
//   cols^T g product in cuBLAS.
//   Design: the grid runs over (tap, output tile, channel tile, pixel
//   slice), the 9 taps of a slice next to each other in launch order, so
//   the slice's g and x rows are read from L2 after the first tap.  A CTA
//   of 8 warps owns d weight's [64 channels x 64 outputs] tile of its tap
//   (each warp 32 x 16) and walks its slice in tiles of 32 pixels.  For
//   each tile every thread takes one pixel and 8 channels: it resolves the
//   pixel's four neighbours (32-bit index arithmetic, the offsets and mask
//   read a tile ahead), reads their rows and dcols with 16-byte loads,
//   builds the masked sample and stores it split, and reduces r_j over its
//   CTA's channel groups with three shuffle levels (4 pixels a warp, 8
//   lanes a pixel); g comes in by cp.async and is split once.  d weight
//   accumulates on the tensor cores as 3xTF32 mma.sync (m16n8k8), each k
//   step of 8 pixels into a fresh accumulator added in f32.  Two tile
//   buffers: the next tile's loads are in flight during this tile's
//   products and built after them, one barrier a tile.  The number of
//   slices fills whole waves of resident CTAs (at most 4), so the d weight
//   partials (one a slice) stay a few MB; a second launch sums them in
//   slice order.  Where C > 64 or O > 64 the output tiles' CTAs share a
//   channel tile's r_j (channel group q goes to output tile q % nout), and
//   each CTA's part of d offset and d mask goes to scratch, summed in order
//   by the second launch too.  (A wgmma version of the d weight product,
//   its operands transposed into shared memory, was slower: PERF.md.)
//
// dcn_bwd_dx
//   d x without atomics, as a gather over per-target lists.  d x[q, c] is
//   the sum over the (output pixel p, tap k) whose bilinear sample reaches
//   q of weight * dcols[p, k, c]; the JAX VJP forms it as the dense
//   "unshift" over the (2R+2)^2 shifts (backbones/deform_conv.py:222-232).
//   Bound: bytes (dcols, 566 MB at the widest block, read once; d x
//   written).  The first design gave each input pixel q a warp that scanned,
//   for each tap, the (2R+2)^2 output pixels that can reach it (324 (pixel,
//   tap) probes a pixel at R 2, each reading two offsets and a mask at a
//   72-byte stride), served each hit alone (a ballot, two shuffles, then a
//   dependent dcols load) with half of its 128-channel lanes idle at C 64,
//   and fetched each dcols row in the ~4 warps of the pixels it reaches:
//   862.69 us at 8 x 96 x 320, C 64, 4.4x its bound, latency and issue bound.
//   Design: a CTA of 512 threads owns a block of kDxTH x kDxTW input
//   pixels (the targets) and 64 channels.  For each tap it resolves once,
//   into shared memory, the four neighbours and weights of every output
//   pixel of the tile's halo (R + 2 pixels before it, R + 1 after, on both
//   axes: 345 at R 2, 945 at R 8; the first halo row and column can only
//   reach the tile with a zero weight, as in the first design's scan), its
//   offsets and mask read once a CTA, and the chunk of the dcols row of
//   each pixel with an entry prefetched into L2 (its read from device
//   memory then overlaps the list stages); builds the targets' lists by count,
//   scan and place in halo order (warp ranks by __match_any_sync, no
//   atomics); then a half-warp owns four targets and walks their lists as
//   one, two dcols rows in flight (four and eight were slower: registers),
//   16 lanes of 16-byte loads over the 64 channels, and adds weight * row
//   with fmaf.  The rows a list names are
//   those the tile's neighbour samples touch, so each dcols row is read by
//   the one CTA its neighbours lie in (two to four at a tile's edge), the
//   other neighbours' reads of it hitting L1.  The sum keeps the first
//   design's order (taps outer, sources row-major, the weight formed as
//   (hat_y * hat_x) * mask, fmaf): the result is bitwise the first design's.
//   Shared memory 64 bytes a halo pixel (22 KB at R 2, 59 KB at R 8) plus 9
//   KB.  What holds it (PERF.md §6): each tap's four list stages and the
//   sum run one after the other in a CTA, so the sum's dcols reads (the
//   bytes bound) overlap only other CTAs' list building; and the lists are
//   rebuilt for every 64-channel chunk of wider maps, which at C 512 makes
//   it slower than the first design.
//
// No kernel synchronises the device or allocates; each entry point returns
// the first CUDA error (cudaGetLastError() after the launches) so the caller
// can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tf32_mma.cuh"

namespace {

constexpr int kTaps = 9;
// dcn_bwd_dx: a CTA's targets (an image block) and channels
constexpr int kDxTH = 8, kDxTW = 16, kDxTargets = kDxTH * kDxTW;
constexpr int kDxThreads = 512, kDxWarps = kDxThreads / 32;
constexpr int kDxChan = 64;                                  // 16 lanes of 4 channels
constexpr int kDxSlots = kDxTargets / (kDxThreads / 16);     // targets a half-warp owns
constexpr int kDxNone = 0xff;                                // no target
constexpr int kDxPer = 2;  // halo pixels a thread resolves: 945 at R 8 over 512 threads
constexpr int kDxInFlight = 2;  // dcols rows a half-warp has in flight (4 and 8 were slower)
constexpr int kMaxReach = 8;                                 // ops/dcn.py's MAX_REACH
constexpr int kSumThreads = 256;   // the partial sums
constexpr unsigned kFull = 0xffffffffu;

// dcn_fwd: a CTA's tile and the k chunk (channels of one tap)
constexpr int kFwdBM = 128, kFwdBN = 64, kFwdBK = 16;
constexpr int kTileH = 8, kTileW = 16;  // the CTA's pixels: a block of an image
constexpr int kFwdThreads = 256;  // two warpgroups
constexpr int kBBytes = 8 * kFwdBN * 4;  // one k step's B, big or small
constexpr int kALbo = 1056;              // bytes between the two k halves of A's core matrices
constexpr int kABytes = 2 * kALbo + 32;  // one k step's A of a warpgroup, big or small

// dcn_bwd_sample: d weight's tile (channels x outputs) and the pixels a step
constexpr int kBwdBC = 64, kBwdBN = 64, kBwdBP = 32, kBwdThreads = 256;
constexpr int kPStr = 72;  // [pixel][channel | output] rows

struct FwdSmem {
  // A of buffer st, warpgroup wg (64 pixels), k step s, big (0) or small
  // (1): 64 x 8 (m x k) K-major in core matrices of 8 m x 4 k: m group i, k
  // half kh at kh * kALbo + i * 128 bytes, m % 8 16 bytes apart (kALbo and
  // the block size keep a warp's 16-byte stores on distinct banks)
  char a[2][2][2][2][kABytes];
  // B of buffer st, k step s, big or small: 8 x 64 (k x n) K-major: n group
  // i, k half kh at i * 256 + kh * 128 bytes, n % 8 16 bytes apart
  char b[2][2][2][kBBytes];
  float b_raw[kFwdThreads][4];  // cp.async target: a thread's core-matrix row of weights
  float nb_w[kTaps][4][kFwdBM];
  int nb_idx[kTaps][4][kFwdBM];
};

struct BwdSmem {
  float c_big[2][kBwdBP][kPStr], c_small[2][kBwdBP][kPStr];  // masked samples
  float g_big[2][kBwdBP][kPStr], g_small[2][kBwdBP][kPStr];  // g rows
  float g_raw[kBwdBP][kBwdBN];  // cp.async target, split into g_big / g_small
};

__device__ __forceinline__ float clampf(float v, float bound) {
  return fminf(fmaxf(v, -bound), bound);
}

// d clip / d v of jnp.clip(v, -bound, bound): 1 inside, 1/2 at the bound
// (lax.max / lax.min split a tie), 0 outside
__device__ __forceinline__ float clip_grad(float v, float bound) {
  const float a = fabsf(v);
  return a < bound ? 1.f : (a == bound ? 0.5f : 0.f);
}

// The bilinear neighbours of tap k of pixel p: pixel indices (-1 outside
// the image) in the order (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1),
// and the fractions fy = dy - floor(dy), fx = dx - floor(dx), from the
// tap's raw offsets (oy, ox).  32-bit index arithmetic (p < 2^31).
struct Taps {
  int nb[4];
  float fy, fx;
};

__device__ __forceinline__ Taps tap_neighbours(float oy, float ox, int p, int k, int H, int W,
                                               float bound) {
  const int hw = H * W;
  const int n = p / hw, rem = p - n * hw;
  const int y = rem / W, xx = rem - y * W;
  const float dy = clampf(oy, bound), dx = clampf(ox, bound);
  const float fy0 = floorf(dy), fx0 = floorf(dx);
  Taps t;
  t.fy = dy - fy0;
  t.fx = dx - fx0;
  const int y0 = y - 1 + k / 3 + (int)fy0;
  const int x0 = xx - 1 + k % 3 + (int)fx0;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int yy = y0 + a, xb = x0 + b;
      const bool in = yy >= 0 && yy < H && xb >= 0 && xb < W;
      t.nb[2 * a + b] = in ? n * hw + yy * W + xb : -1;
    }
  }
  return t;
}

// the mask-scaled bilinear weight of neighbour j (0 outside the image)
__device__ __forceinline__ float nb_weight(const Taps& t, int j, float msk) {
  const float wy = (j >> 1) ? t.fy : 1.f - t.fy, wx = (j & 1) ? t.fx : 1.f - t.fx;
  return t.nb[j] >= 0 ? wy * wx * msk : 0.f;
}

// four floats from p (n of them valid, the rest 0): one 16-byte load when
// vec (then n >= 4 and p 16-byte aligned)
__device__ __forceinline__ float4 ld4(const float* __restrict__ p, int n, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v;
  v.x = n > 0 ? __ldg(p) : 0.f;
  v.y = n > 1 ? __ldg(p + 1) : 0.f;
  v.z = n > 2 ? __ldg(p + 2) : 0.f;
  v.w = n > 3 ? __ldg(p + 3) : 0.f;
  return v;
}

__device__ __forceinline__ float4 fma4(float w, float4 a, float4 acc) {
  return make_float4(fmaf(w, a.x, acc.x), fmaf(w, a.y, acc.y), fmaf(w, a.z, acc.z),
                     fmaf(w, a.w, acc.w));
}

// v split into TF32 big and small parts, stored as two float4
__device__ __forceinline__ void store_split(float* big, float* small, float4 v) {
  const float4 b = make_float4(tf32_round(v.x), tf32_round(v.y), tf32_round(v.z),
                               tf32_round(v.w));
  *reinterpret_cast<float4*>(big) = b;
  *reinterpret_cast<float4*>(small) =
      make_float4(tf32_round(v.x - b.x), tf32_round(v.y - b.y), tf32_round(v.z - b.z),
                  tf32_round(v.w - b.w));
}

__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }

// ------------------------------------------------------------- dcn_fwd ----
// d (+)= a b over one k step of 8: a 64 x 8 and b 8 x 64 tf32 from shared
// memory (descriptors); d in the m16n8 C layout a warp (rows 16 w .. 16 w +
// 15 of the 64) and n tile of 8.  acc false: d = a b.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b, bool acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,"
      "%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"((int)acc));
}

// d = a b in 3xTF32 into a fresh accumulator: a.small b.big, then + a.big
// b.small, then + a.big b.big
__device__ __forceinline__ void wgmma3_n64(float (&d)[32], uint64_t a_big, uint64_t a_small,
                                           uint64_t b_big, uint64_t b_small) {
  wgmma_n64(d, a_small, b_big, false);
  wgmma_n64(d, a_big, b_small, true);
  wgmma_n64(d, a_big, b_big, true);
}

// CTA (blockIdx.x, blockIdx.y, blockIdx.z): the kTileH x kTileW pixel
// block blockIdx.x (of image n), outputs [64 y, +64), taps of group z of
// `groups`; two warpgroups of 64 pixels (warp w: pixels 16 w .. 16 w + 15
// of the 128).  Each step (16-channel chunk, tap) the warpgroups run its
// two k steps on the tensor cores, each into a fresh accumulator, while
// every thread reads the next step's neighbour rows and weights and then
// builds its A rows and B row.  part null: out = the sum plus the bias;
// else the group's sum goes to part[z][P][O].
__global__ void __launch_bounds__(kFwdThreads, 2)
dcn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ off,
               const float* __restrict__ mask, float* __restrict__ out, float* __restrict__ part,
               int N, int H, int W, int C, int O, float bound, int groups, bool blocks,
               bool vec_x) {
  extern __shared__ float4 smem4[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  // the CTA's pixels (-1 outside the image): where the map is whole blocks,
  // a kTileH x kTileW block of image n, pixel m at row m / kTileW, column
  // m % kTileW of it; else pixels 128 blockIdx.x + m in order
  const int tiles_w = W / kTileW, tiles_h = H / kTileH;
  const int tx = blocks ? blockIdx.x % tiles_w : 0;
  const int ty = blocks ? (blockIdx.x / tiles_w) % tiles_h : 0;
  const int n = blocks ? blockIdx.x / tiles_w / tiles_h : 0;
  const int64_t P = (int64_t)N * H * W;
  const auto pixel = [&](int m) -> int64_t {
    if (!blocks) {
      const int64_t p = (int64_t)blockIdx.x * kFwdBM + m;
      return p < P ? p : -1;
    }
    return ((int64_t)n * H + ty * kTileH + m / kTileW) * W + tx * kTileW + m % kTileW;
  };
  const int o0 = blockIdx.y * kFwdBN;
  const int k_first = blockIdx.z * kTaps / groups, k_last = (blockIdx.z + 1) * kTaps / groups;

  // the 9 x 4 neighbours of the CTA's pixels, weights scaled by the mask
  for (int e = tid; e < (k_last - k_first) * kFwdBM; e += kFwdThreads) {
    const int k = k_first + e / kFwdBM, m = e % kFwdBM;
    const int64_t p = pixel(m);
    if (p >= 0) {
      const Taps tp = tap_neighbours(off[p * 18 + 2 * k], off[p * 18 + 2 * k + 1], (int)p, k, H,
                                     W, bound);
      const float msk = mask[p * kTaps + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sm.nb_idx[k][j][m] = tp.nb[j];
        sm.nb_w[k][j][m] = nb_weight(tp, j, msk);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sm.nb_idx[k][j][m] = -1;
        sm.nb_w[k][j][m] = 0.f;
      }
    }
  }
  __syncthreads();

  // steps (16-channel chunk, tap), taps inner: the taps of a chunk read
  // overlapping neighbour rows, which stay in L1 from tap to tap
  const int ntap = k_last - k_first;
  const int nstep = ntap * ((C + kFwdBK - 1) / kFwdBK);
  const int m0 = 16 * warp + g;  // the thread's rows m0 and m0 + 8
  const int c4 = 4 * t;          // and its channels c0 + c4 .. c0 + c4 + 3 of a chunk
  float4 v[2][4];                // their four neighbours' rows
  const auto load_a = [&](int step) {
    const int k = k_first + step % ntap, c = (step / ntap) * kFwdBK + c4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = sm.nb_idx[k][j][m0 + 8 * r];
        v[r][j] = (q >= 0 && c < C) ? ld4(x + (int64_t)q * C + c, C - c, vec_x)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  // the masked samples of the two rows, split, into A at buffer st: k step
  // t / 2, core-matrix half t % 2 (channels in order)
  const auto build_a = [&](int step, int st) {
    const int k = k_first + step % ntap;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + 8 * r, ml = m & 63;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 4; ++j) s = fma4(sm.nb_w[k][j][m], v[r][j], s);
      const int at = (t & 1) * kALbo + (ml >> 3) * 128 + (ml & 7) * 16;
      store_split((float*)(sm.a[st][wg][t >> 1][0] + at), (float*)(sm.a[st][wg][t >> 1][1] + at),
                  s);
    }
  };
  // B: a thread's core-matrix row of a step: output n, k step s, half kh:
  // the weights of channels c0 + 8s + 4kh .. + 3, by cp.async
  const int bn = tid & 63, bs = tid >> 7, bkh = (tid >> 6) & 1;
  const auto load_b = [&](int step) {
    const int k = k_first + step % ntap, c0 = (step / ntap) * kFwdBK + 8 * bs + 4 * bkh;
    const bool n_ok = o0 + bn < O;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool valid = n_ok && c0 + e < C;
      cp_async4(&sm.b_raw[tid][e], valid ? w + ((int64_t)k * C + c0 + e) * O + o0 + bn : w,
                valid);
    }
    cp_async_commit();
  };
  const auto store_b = [&](int st) {  // split once, into the wgmmas' layout
    cp_async_wait<0>();
    const float4 raw = *reinterpret_cast<const float4*>(sm.b_raw[tid]);
    const int at = (bn >> 3) * 256 + bkh * 128 + (bn & 7) * 16;
    store_split((float*)(sm.b[st][bs][0] + at), (float*)(sm.b[st][bs][1] + at), raw);
  };
  const auto proxy_fence = [] { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); };

  float acc[32], f[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  if (nstep > 0) {
    load_a(0);
    load_b(0);
    build_a(0, 0);
    store_b(0);
    proxy_fence();
    __syncthreads();
  }
  // k step s of the step at buffer st into the fresh accumulator f, then
  // added in f32
  const auto product = [&](int st, int s) {
    wg_hold(f);
    wg_fence();
    wgmma3_n64(f, wg_desc(sm.a[st][wg][s][0], kALbo, 128), wg_desc(sm.a[st][wg][s][1], kALbo, 128),
               wg_desc(sm.b[st][s][0], 128, 256), wg_desc(sm.b[st][s][1], 128, 256));
    wg_commit();
  };
  const auto add = [&] {
    wg_wait<0>();
    wg_hold(f);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += f[i];
  };
  for (int step = 0; step < nstep; ++step) {
    const int st = step & 1;
    const bool more = step + 1 < nstep;
    product(st, 0);
    if (more) {  // the next step's reads, in flight during the products
      load_a(step + 1);
      load_b(step + 1);
    }
    add();
    product(st, 1);
    if (more) {
      build_a(step + 1, st ^ 1);
      store_b(st ^ 1);
      proxy_fence();
    }
    add();
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t p = pixel(m0 + 8 * h);
    if (p < 0) continue;
    float* row = part != nullptr ? part + ((int64_t)blockIdx.z * P + p) * O : out + p * O;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int o = o0 + nt * 8 + 2 * t;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (o + i >= O) continue;
        const float a = acc[4 * nt + 2 * h + i];
        row[o + i] = part != nullptr ? a : a + (bias != nullptr ? bias[o + i] : 0.f);
      }
    }
  }
}

// out[i] = the tap groups' partial outputs summed in group order, plus the bias
__global__ void __launch_bounds__(kSumThreads)
dcn_fwd_sum_kernel(const float* __restrict__ part, const float* __restrict__ bias,
                   float* __restrict__ out, int64_t PO, int O, int groups) {
  const int64_t i = (int64_t)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= PO) return;
  float v = part[i];
  for (int z = 1; z < groups; ++z) v += part[z * PO + i];
  out[i] = v + (bias != nullptr ? bias[i % O] : 0.f);
}

// ------------------------------------------------------ dcn_bwd_sample ----
// CTA blockIdx.x = ((slice * nct + ct) * nout + ot) * 9 + k: tap k, d
// weight's channel tile ct (64 channels) and output tile ot (64 outputs),
// pixel tiles [first, last) of its slice.  Writes its tile of the slice's d
// weight partial part[slice][9*C][O], and its part of d offset and d mask:
// r_j over the channel groups (8 channels, a lane of 8) q of its channel
// tile with q % nout == ot.  Where one CTA covers all channels (nct = nout
// = 1) it writes d offset and d mask; else its part of (d mask, d dy, d dx)
// before the clamp goes to rpart[ct * nout + ot][P][9][3].
__global__ void __launch_bounds__(kBwdThreads, 2)
dcn_bwd_sample_kernel(const float* __restrict__ x, const float* __restrict__ off,
                      const float* __restrict__ mask, const float* __restrict__ dcols,
                      const float* __restrict__ gout, float* __restrict__ part,
                      float* __restrict__ rpart, float* __restrict__ doff,
                      float* __restrict__ dmask, int P, int H, int W, int C, int O, float bound,
                      int slices, bool vec_x, bool vec_d, bool vec_g) {
  extern __shared__ float4 smem4[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nct = (C + kBwdBC - 1) / kBwdBC, nout = (O + kBwdBN - 1) / kBwdBN;
  int b = blockIdx.x;
  const int k = b % kTaps;
  b /= kTaps;
  const int ot = b % nout;
  b /= nout;
  const int ct = b % nct, slice = b / nct;
  const int c_base = ct * kBwdBC, o_base = ot * kBwdBN;
  const int ntiles = (P + kBwdBP - 1) / kBwdBP, per = (ntiles + slices - 1) / slices;
  const int first = min(ntiles, slice * per), last = min(ntiles, first + per);
  const int q = lane & 7, c = c_base + 8 * q;
  const bool c_ok = c < C, r_mine = c_ok && q % nout == ot, direct = nct * nout == 1;
  float* rp_base = rpart + (int64_t)(ct * nout + ot) * P * kTaps * 3;

  // The thread's sample item of a tile: pixel px = 4 warp + lane / 8,
  // channels c..c+7 (8 lanes a pixel).  Tile t + 2's raw offsets and mask
  // are read while tile t + 1's neighbour rows, dcols and g rows are in
  // flight, and those while tile t's products run.
  const int px = 4 * warp + (lane >> 3);
  float om[3];   // raw (dy, dx) and mask of the next tile to issue
  float cur[3];  // those of the tile in flight
  Taps tp;
  float4 xv[4][2], dv[2];
  const auto load_om = [&](int tile) {
    const int p = tile * kBwdBP + px;
    const bool live = p < P;
    om[0] = live ? __ldg(off + (int64_t)p * 18 + 2 * k) : 0.f;
    om[1] = live ? __ldg(off + (int64_t)p * 18 + 2 * k + 1) : 0.f;
    om[2] = live ? __ldg(mask + (int64_t)p * kTaps + k) : 0.f;
  };
  const auto issue = [&](int tile) {
    const int p = tile * kBwdBP + px;
    cur[0] = om[0];
    cur[1] = om[1];
    cur[2] = om[2];
    if (p < P) {
      tp = tap_neighbours(om[0], om[1], p, k, H, W, bound);
    } else {
      tp.nb[0] = tp.nb[1] = tp.nb[2] = tp.nb[3] = -1;
      tp.fy = tp.fx = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = c + 4 * h;
        xv[j][h] = (tp.nb[j] >= 0 && ch < C) ? ld4(x + (int64_t)tp.nb[j] * C + ch, C - ch, vec_x)
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ch = c + 4 * h;
      dv[h] = (p < P && r_mine && ch < C)
                  ? ld4(dcols + ((int64_t)p * kTaps + k) * C + ch, C - ch, vec_d)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // the tile's g rows, two float4 a thread, into g_raw
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * kBwdThreads, gp = e >> 4, o4 = e & 15;
      const int pg = tile * kBwdBP + gp, o = o_base + 4 * o4;
      float* dst = &sm.g_raw[gp][4 * o4];
      const float* src = gout + (int64_t)pg * O + o;
      if (vec_g) {
        const bool valid = pg < P && o < O;
        cp_async16(dst, valid ? src : gout, valid);
      } else {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) dst[ii] = (pg < P && o + ii < O) ? __ldg(src + ii) : 0.f;
      }
    }
    cp_async_commit();
  };
  const auto finish = [&](int tile, int st) {
    const int p = tile * kBwdBP + px;
    const float msk = cur[2];
    float r[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 col = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 4; ++j) col = fma4(nb_weight(tp, j, msk), xv[j][h], col);
      store_split(&sm.c_big[st][px][8 * q + 4 * h], &sm.c_small[st][px][8 * q + 4 * h], col);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float a = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 xx = xv[j][h], d = dv[h];
        a = fmaf(xx.w, d.w, fmaf(xx.z, d.z, fmaf(xx.y, d.y, fmaf(xx.x, d.x, a))));
      }
      r[j] = a;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int sh = 4; sh > 0; sh >>= 1) r[j] += __shfl_xor_sync(kFull, r[j], sh);
    }
    if (p < P && q == 0) {
      const float fy = tp.fy, fx = tp.fx;
      const float wy0 = 1.f - fy, wx0 = 1.f - fx;
      const float dm = wy0 * wx0 * r[0] + wy0 * fx * r[1] + fy * wx0 * r[2] + fy * fx * r[3];
      // the hat derivative is 0 at an integer offset (sign(0) = 0)
      const float ddy = fy > 0.f ? msk * (wx0 * (r[2] - r[0]) + fx * (r[3] - r[1])) : 0.f;
      const float ddx = fx > 0.f ? msk * (wy0 * (r[1] - r[0]) + fy * (r[3] - r[2])) : 0.f;
      const int64_t item = (int64_t)p * kTaps + k;
      if (direct) {
        dmask[item] = dm;
        doff[2 * item] = ddy * clip_grad(cur[0], bound);
        doff[2 * item + 1] = ddx * clip_grad(cur[1], bound);
      } else {
        float* rp = rp_base + item * 3;
        rp[0] = dm;
        rp[1] = ddy;
        rp[2] = ddx;
      }
    }
    cp_async_wait<0>();  // the thread's own float4s of g_raw
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * kBwdThreads, gp = e >> 4, o4 = e & 15;
      const float4 raw = *reinterpret_cast<const float4*>(&sm.g_raw[gp][4 * o4]);
      store_split(&sm.g_big[st][gp][4 * o4], &sm.g_small[st][gp][4 * o4], raw);
    }
  };

  const int wm = warp & 1, wn = warp >> 1;  // 2 x 4 warps of 32 channels x 16 outputs
  float acc[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  // d weight[c, o] += sum_p cols[p, c] g[p, o]: A = cols^T (m = channel,
  // k = pixel), B = g (k = pixel, n = output)
  const auto compute = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < kBwdBP; kk += 8) {
      FragA fa[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int cl = wm * 32 + mt * 16 + g;
        fa[mt].big[0] = bits(sm.c_big[st][kk + t][cl]);
        fa[mt].big[1] = bits(sm.c_big[st][kk + t][cl + 8]);
        fa[mt].big[2] = bits(sm.c_big[st][kk + t + 4][cl]);
        fa[mt].big[3] = bits(sm.c_big[st][kk + t + 4][cl + 8]);
        fa[mt].small[0] = bits(sm.c_small[st][kk + t][cl]);
        fa[mt].small[1] = bits(sm.c_small[st][kk + t][cl + 8]);
        fa[mt].small[2] = bits(sm.c_small[st][kk + t + 4][cl]);
        fa[mt].small[3] = bits(sm.c_small[st][kk + t + 4][cl + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int ol = wn * 16 + nt * 8 + g;
        FragB fb;
        fb.big[0] = bits(sm.g_big[st][kk + t][ol]);
        fb.big[1] = bits(sm.g_big[st][kk + t + 4][ol]);
        fb.small[0] = bits(sm.g_small[st][kk + t][ol]);
        fb.small[1] = bits(sm.g_small[st][kk + t + 4][ol]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma3(acc[mt][nt], fa[mt], fb);
      }
    }
  };

  if (first < last) {
    load_om(first);
    issue(first);
    if (first + 1 < last) load_om(first + 1);
    finish(first, 0);
    __syncthreads();
  }
  for (int tile = first; tile < last; ++tile) {
    const int st = (tile - first) & 1;
    const bool more = tile + 1 < last;
    if (more) {  // the next tile's loads are in flight during the products
      issue(tile + 1);
      if (tile + 2 < last) load_om(tile + 2);
    }
    compute(st);
    if (more) finish(tile + 1, st ^ 1);
    __syncthreads();
  }

  float* pr = part + (int64_t)slice * kTaps * C * O;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cc = c_base + wm * 32 + mt * 16 + g + 8 * h;
      if (cc >= C) continue;
      float* row = pr + ((int64_t)k * C + cc) * O;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int o = o_base + wn * 16 + nt * 8 + 2 * t;
        if (o < O) row[o] = acc[mt][nt][2 * h];
        if (o + 1 < O) row[o + 1] = acc[mt][nt][2 * h + 1];
      }
    }
  }
}

// d weight[i] = the slices' partials summed in slice order (i < nw); then,
// where several CTAs shared a pixel's channels (nparts = nct * nout > 1),
// for item i = p * 9 + k: d mask and d offset from their parts summed in
// part order.
__global__ void __launch_bounds__(kSumThreads)
dcn_bwd_sum_kernel(const float* __restrict__ part, int slices, int64_t nw,
                   float* __restrict__ dweight, const float* __restrict__ rpart, int nparts,
                   int64_t items, const float* __restrict__ off, float bound,
                   float* __restrict__ doff, float* __restrict__ dmask) {
  int64_t i = (int64_t)blockIdx.x * kSumThreads + threadIdx.x;
  if (i < nw) {
    float s = part[i];
    for (int q = 1; q < slices; ++q) s += part[q * nw + i];
    dweight[i] = s;
    return;
  }
  i -= nw;
  if (i >= items) return;
  float dm = rpart[3 * i], ddy = rpart[3 * i + 1], ddx = rpart[3 * i + 2];
  for (int r = 1; r < nparts; ++r) {
    const float* rp = rpart + (r * items + i) * 3;
    dm += rp[0];
    ddy += rp[1];
    ddx += rp[2];
  }
  dmask[i] = dm;
  doff[2 * i] = ddy * clip_grad(off[2 * i], bound);
  doff[2 * i + 1] = ddx * clip_grad(off[2 * i + 1], bound);
}

// ---------------------------------------------------------- dcn_bwd_dx ----
// The CTA's halo for reach R: the output pixels whose taps can sample a
// target of its kDxTH x kDxTW tile, R + 2 rows and columns before the tile
// and R + 1 after it (tap rows and columns 0 .. 2, shifts -R .. R + 1)
__host__ __device__ __forceinline__ int dx_halo_h(int R) { return kDxTH + 2 * R + 3; }
__host__ __device__ __forceinline__ int dx_halo_w(int R) { return kDxTW + 2 * R + 3; }

// Shared memory of a CTA for reach R: per halo pixel its four weights and
// target bytes, per (halo pixel, neighbour) its rank and list slot (weight,
// dcols row, target), the per-warp counts and the targets' list bounds
size_t dx_smem(int R) {
  const size_t nh = (size_t)dx_halo_h(R) * dx_halo_w(R);
  return nh * (16 + 4 + 4 * (4 + 4 + 1 + 2)) +
         sizeof(int) * (kDxWarps * kDxTargets + 2 * kDxTargets + kDxWarps);
}

// Grid (tiles of N x ceil(H / kDxTH) x ceil(W / kDxTW), channel chunks of
// kDxChan).  Per tap k, in four barrier-separated stages:
//   1. resolve: each halo pixel p in the image (row-major halo index i) reads
//      its tap's offsets and mask once, clamps them and finds its four
//      neighbours and weights (hat_y * hat_x) * mask; a neighbour that lies
//      in the tile (and the image) with a non-zero weight is an entry for
//      that target, its byte in tgt[i] (kDxNone otherwise);
//   2. rank: warp w takes the halo indices of its segment [w seg, (w + 1)
//      seg) in order, 32 entries (i, j) at a time; an entry's rank among the
//      warp's entries for its target is the warp's count so far plus its
//      peers below it (__match_any_sync), and the last peer adds the group;
//   3. scan: each target's counts over the warps in order, then the targets'
//      totals over the tile (warp shuffles): the lists' bounds, and where
//      each warp's entries for a target start;
//   4. place: each warp puts its entries (i, j) at its start for their
//      target plus their rank, so each target's list holds its entries in
//      halo order, each as (weight, dcols row p * 9 + k, target);
//   5. sum: half-warp s owns targets kDxSlots s .. kDxSlots (s + 1) - 1
//      (their lists lie next to each other), each lane four channels of the
//      chunk; it walks the lists as one, kDxInFlight dcols rows in flight,
//      and adds weight * row with fmaf in list order into the running
//      target's sum.
// The accumulators stay in registers over the taps, so each target's sum
// runs taps outer, then its sources in row-major order: the first design's
// order, and bitwise its result.
__global__ void __launch_bounds__(kDxThreads, 2)
dcn_bwd_dx_kernel(const float* __restrict__ off, const float* __restrict__ mask,
                  const float* __restrict__ dcols, float* __restrict__ dx, int N, int H, int W,
                  int C, int R, float bound, int tiles_y, int tiles_x, bool vec) {
  extern __shared__ float4 smem4[];
  const int HX = dx_halo_w(R), NH = dx_halo_h(R) * HX;
  float4* wts = smem4;                              // [NH] weights of the four neighbours
  uint32_t* tgt = (uint32_t*)(wts + NH);            // [NH] their target bytes
  float* lw = (float*)(tgt + NH);                   // [4 NH] the lists' weights,
  int* lrow = (int*)(lw + 4 * NH);                  // [4 NH] dcols rows p * 9 + k,
  uint8_t* lt = (uint8_t*)(lrow + 4 * NH);          // [4 NH] and targets
  uint16_t* rank = (uint16_t*)(lt + 4 * NH);        // [4 NH] entry (i, j)'s rank
  int* cnt = (int*)(rank + 4 * NH);                 // [kDxWarps][kDxTargets]
  int* lo = cnt + kDxWarps * kDxTargets;            // [kDxTargets] list bounds
  int* hi = lo + kDxTargets;
  int* wsum = hi + kDxTargets;                      // [kDxWarps] scan scratch

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per_image = tiles_y * tiles_x;
  const int n = blockIdx.x / per_image, rem = blockIdx.x - n * per_image;
  const int ty0 = rem / tiles_x * kDxTH, tx0 = (rem % tiles_x) * kDxTW;
  const int oy = ty0 - R - 2, ox = tx0 - R - 2;  // the halo's first row and column
  const int half = tid >> 4, hl = tid & 15;
  const int cl = blockIdx.y * kDxChan + 4 * hl, nc = min(4, C - cl);  // this lane's channels
  const int seg = (NH + kDxWarps - 1) / kDxWarps;
  const int e_lo = warp * seg * 4, e_hi = min(NH, (warp + 1) * seg) * 4;  // the warp's entries
  float4 acc[kDxSlots];
#pragma unroll
  for (int s = 0; s < kDxSlots; ++s) acc[s] = make_float4(0.f, 0.f, 0.f, 0.f);
  // this thread's halo pixels tid + q kDxThreads: their pixel (-1 outside
  // the map or the halo) and tile-relative row and column
  int pix[kDxPer], prow[kDxPer], pcol[kDxPer];
#pragma unroll
  for (int q = 0; q < kDxPer; ++q) {
    const int i = tid + q * kDxThreads, hy = i / HX, py = oy + hy, px = ox + (i - hy * HX);
    pix[q] = i < NH && py >= 0 && py < H && px >= 0 && px < W ? (n * H + py) * W + px : -1;
    prow[q] = py - ty0;
    pcol[q] = px - tx0;
  }

  for (int k = 0; k < kTaps; ++k) {
    const int kh = k / 3, kw = k % 3;
    // 1. resolve
#pragma unroll
    for (int q = 0; q < kDxPer; ++q) {
      const int i = tid + q * kDxThreads;
      if (i >= NH) break;
      uint32_t tg = 0xffffffffu;
      float4 w4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (pix[q] >= 0) {
        const float dy = clampf(__ldg(off + (int64_t)pix[q] * 18 + 2 * k), bound);
        const float dxo = clampf(__ldg(off + (int64_t)pix[q] * 18 + 2 * k + 1), bound);
        const float m = __ldg(mask + (int64_t)pix[q] * kTaps + k);
        const float fy0 = floorf(dy), fx0 = floorf(dxo);
        const float fy = dy - fy0, fx = dxo - fx0;
        const int y0 = prow[q] - 1 + kh + (int)fy0, x0 = pcol[q] - 1 + kw + (int)fx0;
        float* wp = &w4.x;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int yy = y0 + (j >> 1), xx = x0 + (j & 1);
          const float wt = ((j >> 1) ? fy : 1.f - fy) * ((j & 1) ? fx : 1.f - fx) * m;
          if (yy >= 0 && yy < kDxTH && xx >= 0 && xx < kDxTW && ty0 + yy < H && tx0 + xx < W &&
              wt != 0.f) {
            tg = (tg & ~(0xffu << (8 * j))) | ((uint32_t)(yy * kDxTW + xx) << (8 * j));
            wp[j] = wt;
          }
        }
      }
      tgt[i] = tg;
      wts[i] = w4;
      if (tg != 0xffffffffu) {  // the pixel's dcols row of the chunk into L2 now, so that
                                // its read from device memory overlaps the list stages
        const float* src = dcols + ((int64_t)pix[q] * kTaps + k) * C + blockIdx.y * kDxChan;
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(src));
        if (C - (int)blockIdx.y * kDxChan > 32)
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(src + 32));
      }
    }
    for (int e = tid; e < kDxWarps * kDxTargets; e += kDxThreads) cnt[e] = 0;
    __syncthreads();
    // 2. rank
    int* wc = cnt + warp * kDxTargets;
    for (int e = e_lo; e < e_hi; e += 32) {
      const int ee = e + lane;
      const int t = ee < e_hi ? (int)((tgt[ee >> 2] >> (8 * (ee & 3))) & 0xffu) : kDxNone;
      const unsigned peers = __match_any_sync(kFull, t);
      if (t != kDxNone) rank[ee] = (uint16_t)(wc[t] + __popc(peers & ((1u << lane) - 1u)));
      __syncwarp();
      if (t != kDxNone && lane == 31 - __clz(peers)) wc[t] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // 3. scan
    int tot = 0, incl = 0;
    if (tid < kDxTargets) {
      for (int w = 0; w < kDxWarps; ++w) {
        const int c = cnt[w * kDxTargets + tid];
        cnt[w * kDxTargets + tid] = tot;
        tot += c;
      }
      incl = tot;
#pragma unroll
      for (int sh = 1; sh < 32; sh <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, sh);
        if (lane >= sh) incl += v;
      }
      if (lane == 31) wsum[warp] = incl;
    }
    __syncthreads();
    if (tid < kDxTargets) {
      int base = incl - tot;
      for (int w = 0; w < warp; ++w) base += wsum[w];
      lo[tid] = base;
      hi[tid] = base + tot;
      for (int w = 0; w < kDxWarps; ++w) cnt[w * kDxTargets + tid] += base;
    }
    __syncthreads();
    // 4. place: each warp its own entries
    for (int ee = e_lo + lane; ee < e_hi; ee += 32) {
      const int i = ee >> 2, j = ee & 3;
      const int t = (int)((tgt[i] >> (8 * j)) & 0xffu);
      if (t == kDxNone) continue;
      const int pos = wc[t] + rank[ee];
      const int hy = i / HX;
      lrow[pos] = ((n * H + oy + hy) * W + ox + (i - hy * HX)) * kTaps + k;
      lw[pos] = (&wts[i].x)[j];
      lt[pos] = (uint8_t)t;
    }
    __syncthreads();
    // 5. sum
    if (nc > 0) {
      const int t0 = kDxSlots * half, e1 = hi[t0 + kDxSlots - 1];
      int cur_s = -1;
      float4 cur = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int e = lo[t0]; e < e1; e += kDxInFlight) {
        float4 v[kDxInFlight];
        float wv[kDxInFlight];
        int sv[kDxInFlight];
#pragma unroll
        for (int u = 0; u < kDxInFlight; ++u) {
          if (e + u >= e1) break;
          wv[u] = lw[e + u];
          sv[u] = lt[e + u] - t0;
          v[u] = ld4(dcols + (int64_t)lrow[e + u] * C + cl, nc, vec);
        }
#pragma unroll
        for (int u = 0; u < kDxInFlight; ++u) {
          if (e + u >= e1) break;
          if (sv[u] != cur_s) {  // the lists are in target order: park the sum, take the next
#pragma unroll
            for (int s = 0; s < kDxSlots; ++s)
              if (s == cur_s) acc[s] = cur;
#pragma unroll
            for (int s = 0; s < kDxSlots; ++s)
              if (s == sv[u]) cur = acc[s];
            cur_s = sv[u];
          }
          cur = fma4(wv[u], v[u], cur);
        }
      }
#pragma unroll
      for (int s = 0; s < kDxSlots; ++s)
        if (s == cur_s) acc[s] = cur;
    }
    __syncthreads();  // the next tap restages every array
  }
  if (nc <= 0) return;
#pragma unroll
  for (int s = 0; s < kDxSlots; ++s) {
    const int t = kDxSlots * half + s;
    const int yy = ty0 + t / kDxTW, xx = tx0 + t % kDxTW;
    if (yy >= H || xx >= W) continue;
    float* o = dx + ((int64_t)(n * H + yy) * W + xx) * C + cl;
    if (vec) {
      *reinterpret_cast<float4*>(o) = acc[s];
    } else {
      const float a[4] = {acc[s].x, acc[s].y, acc[s].z, acc[s].w};
      for (int c = 0; c < nc; ++c) o[c] = a[c];
    }
  }
}

// ----------------------------------------------------------------- host ----
unsigned sum_blocks(int64_t n) { return (unsigned)((n + kSumThreads - 1) / kSumThreads); }

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Once a device: the kernels' shared-memory opt-in, the SM count and the
// backward's resident CTAs an SM.
struct Device {
  bool done;
  int sms, bwd_per_sm;
};
Device devices[64];

cudaError_t device_config(const Device** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  Device& d = devices[dev];
  if (!d.done) {
    err = cudaFuncSetAttribute(dcn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(FwdSmem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dcn_bwd_sample_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)sizeof(BwdSmem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dcn_bwd_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)dx_smem(kMaxReach));
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d.bwd_per_sm, dcn_bwd_sample_kernel,
                                                          kBwdThreads, sizeof(BwdSmem));
    if (err != cudaSuccess) return err;
    d.done = true;
  }
  *out = &d;
  return cudaSuccess;
}

// the forward's CTAs a map: kTileH x kTileW blocks where the map is whole
// blocks (their neighbour rows overlap more than a row's), else 128
// pixels in order
bool fwd_blocks(int H, int W) { return H % kTileH == 0 && W % kTileW == 0; }
int64_t fwd_tiles(int N, int H, int W) {
  return fwd_blocks(H, W) ? (int64_t)N * (H / kTileH) * (W / kTileW)
                          : ((int64_t)N * H * W + kFwdBM - 1) / kFwdBM;
}

// tap groups of the forward: 1, 3 or 9, the fewest that give every SM two CTAs
int fwd_groups(const Device& d, int N, int H, int W, int O) {
  const int64_t ctas = fwd_tiles(N, H, W) * ((O + kFwdBN - 1) / kFwdBN);
  for (int groups : {1, 3}) {
    if (ctas * groups >= 2 * (int64_t)d.sms) return groups;
  }
  return 9;
}

// pixel slices of the backward: the fewest (up to 4 waves of resident CTAs
// and a pixel tile a slice) whose last wave is at least 90% full, else the
// fullest; one d weight partial a slice
int bwd_slices(const Device& d, int64_t P, int C, int O) {
  const int64_t per_slice =
      (int64_t)kTaps * ((C + kBwdBC - 1) / kBwdBC) * ((O + kBwdBN - 1) / kBwdBN);
  const int64_t ntiles = (P + kBwdBP - 1) / kBwdBP;
  const int64_t slots = (int64_t)d.sms * std::max(d.bwd_per_sm, 1);
  const int64_t most = std::max<int64_t>(1, std::min<int64_t>(ntiles, 4 * slots / per_slice));
  int64_t best = 1;
  double best_fill = 0.0;
  for (int64_t s = 1; s <= most; ++s) {
    const int64_t ctas = s * per_slice, waves = (ctas + slots - 1) / slots;
    const double fill = (double)ctas / (double)(waves * slots);
    if (fill > best_fill) {
      best = s;
      best_fill = fill;
    }
    if (fill >= 0.9) break;
  }
  return (int)best;
}

cudaError_t pixels_ok(int N, int H, int W) {
  const int64_t P = (int64_t)N * H * W;
  return P > 0 && P <= 0x7fffffff ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// The scratch (floats) tm_dcn_fwd needs on this device: the tap groups'
// partial outputs where the taps are split, else 0.  Written to *n
// (int64).
extern "C" int tm_dcn_fwd_scratch_floats(int N, int H, int W, int C, int O, void* n) {
  const Device* d = nullptr;
  cudaError_t err = pixels_ok(N, H, W);
  if (err == cudaSuccess) err = device_config(&d);
  if (err != cudaSuccess) return (int)err;
  const int64_t P = (int64_t)N * H * W;
  const int groups = fwd_groups(*d, N, H, W, O);
  *(int64_t*)n = groups > 1 ? groups * P * O : 0;
  return (int)cudaSuccess;
}

// x f32[N, H, W, C]; w f32[9*C, O]; bias f32[O] or null; off f32[N, H, W,
// 18]; mask f32[N, H, W, 9]; scratch as tm_dcn_fwd_scratch_floats asks.
// Writes out f32[N, H, W, O].  N*H*W > 0, O > 0.
extern "C" int tm_dcn_fwd(const void* x, const void* w, const void* bias, const void* off,
                          const void* mask, void* out, void* scratch, int N, int H, int W, int C,
                          int O, float bound, void* stream) {
  const Device* d = nullptr;
  cudaError_t err = pixels_ok(N, H, W);
  if (err == cudaSuccess) err = device_config(&d);
  if (err != cudaSuccess) return (int)err;
  const int64_t P = (int64_t)N * H * W;
  const int groups = fwd_groups(*d, N, H, W, O);
  const cudaStream_t s = (cudaStream_t)stream;
  float* part = groups > 1 ? (float*)scratch : nullptr;
  const dim3 grid((unsigned)fwd_tiles(N, H, W), (unsigned)((O + kFwdBN - 1) / kFwdBN),
                  (unsigned)groups);
  dcn_fwd_kernel<<<grid, kFwdThreads, sizeof(FwdSmem), s>>>(
      (const float*)x, (const float*)w, (const float*)bias, (const float*)off,
      (const float*)mask, (float*)out, part, N, H, W, C, O, bound, groups, fwd_blocks(H, W),
      C % 4 == 0 && aligned16(x));
  if (groups > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dcn_fwd_sum_kernel<<<sum_blocks(P * O), kSumThreads, 0, s>>>(part, (const float*)bias,
                                                                 (float*)out, P * O, O, groups);
  }
  return (int)cudaGetLastError();
}

// The scratch (floats) tm_dcn_bwd_sample needs on this device: the d weight
// partials (one a pixel slice) and, where C > 64 or O > 64, the CTAs' parts
// of d offset and d mask.  Written to *n (int64).
extern "C" int tm_dcn_bwd_sample_scratch_floats(int N, int H, int W, int C, int O, void* n) {
  const Device* d = nullptr;
  cudaError_t err = pixels_ok(N, H, W);
  if (err == cudaSuccess) err = device_config(&d);
  if (err != cudaSuccess) return (int)err;
  const int64_t P = (int64_t)N * H * W;
  const int nparts = ((C + kBwdBC - 1) / kBwdBC) * ((O + kBwdBN - 1) / kBwdBN);
  *(int64_t*)n = (int64_t)bwd_slices(*d, P, C, O) * kTaps * C * O +
                 (nparts > 1 ? (int64_t)nparts * P * kTaps * 3 : 0);
  return (int)cudaSuccess;
}

// x, off, mask as tm_dcn_fwd; dcols f32[N, H, W, 9*C], the cotangent of
// the columns; g f32[N, H, W, O], the output's; scratch as
// tm_dcn_bwd_sample_scratch_floats asks.  Writes dweight f32[9*C, O], doff
// f32[N, H, W, 18] and dmask f32[N, H, W, 9].  N*H*W > 0, C > 0, O > 0.
extern "C" int tm_dcn_bwd_sample(const void* x, const void* off, const void* mask,
                                 const void* dcols, const void* g, void* dweight, void* doff,
                                 void* dmask, void* scratch, int N, int H, int W, int C, int O,
                                 float bound, void* stream) {
  const Device* d = nullptr;
  cudaError_t err = pixels_ok(N, H, W);
  if (err == cudaSuccess) err = device_config(&d);
  if (err != cudaSuccess) return (int)err;
  const int64_t P = (int64_t)N * H * W;
  const int nct = (C + kBwdBC - 1) / kBwdBC, nout = (O + kBwdBN - 1) / kBwdBN;
  const int slices = bwd_slices(*d, P, C, O);
  const int64_t nw = (int64_t)kTaps * C * O;
  float* part = (float*)scratch;
  float* rpart = part + slices * nw;  // read where nct * nout > 1
  const cudaStream_t s = (cudaStream_t)stream;
  dcn_bwd_sample_kernel<<<(unsigned)((int64_t)slices * nct * nout * kTaps), kBwdThreads,
                          sizeof(BwdSmem), s>>>(
      (const float*)x, (const float*)off, (const float*)mask, (const float*)dcols,
      (const float*)g, part, rpart, (float*)doff, (float*)dmask, (int)P, H, W, C, O, bound,
      slices, C % 4 == 0 && aligned16(x), C % 4 == 0 && aligned16(dcols),
      O % 4 == 0 && aligned16(g));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t items = nct * nout > 1 ? P * kTaps : 0;
  dcn_bwd_sum_kernel<<<sum_blocks(nw + items), kSumThreads, 0, s>>>(
      part, slices, nw, (float*)dweight, rpart, nct * nout, items, (const float*)off, bound,
      (float*)doff, (float*)dmask);
  return (int)cudaGetLastError();
}

// off, mask, dcols as tm_dcn_bwd_sample; R = ceil(bound), 0 <= R <= 8.
// Writes dx f32[N, H, W, C].  N*H*W > 0, C > 0.
extern "C" int tm_dcn_bwd_dx(const void* off, const void* mask, const void* dcols, void* dx,
                             int N, int H, int W, int C, int R, float bound, void* stream) {
  const Device* d = nullptr;
  cudaError_t err = pixels_ok(N, H, W);
  // the lists name dcols rows p * 9 + k as int
  if (err == cudaSuccess && (R < 0 || R > kMaxReach || C <= 0 || (int64_t)N * H * W * kTaps > 0x7fffffff))
    err = cudaErrorInvalidValue;
  if (err == cudaSuccess) err = device_config(&d);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (H + kDxTH - 1) / kDxTH, tiles_x = (W + kDxTW - 1) / kDxTW;
  const dim3 grid((unsigned)((int64_t)N * tiles_y * tiles_x), (unsigned)((C + kDxChan - 1) / kDxChan));
  dcn_bwd_dx_kernel<<<grid, kDxThreads, dx_smem(R), (cudaStream_t)stream>>>(
      (const float*)off, (const float*)mask, (const float*)dcols, (float*)dx, N, H, W, C, R, bound,
      tiles_y, tiles_x, C % 4 == 0 && aligned16(dcols) && aligned16(dx));
  return (int)cudaGetLastError();
}
