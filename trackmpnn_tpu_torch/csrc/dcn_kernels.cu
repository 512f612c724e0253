// Hopper (sm_90a) kernels for the bounded modulated deformable convolution
// (DCNv2, 3x3 taps, stride 1, padding 1, dilation 1) of the DLA-34
// embedding backbone, forward and backward.  Built by
// trackmpnn_tpu_torch/ops/_build.py into a shared library with a plain C
// interface and called through ctypes from ops/dcn.py, which checks device,
// dtype, shape and contiguity before any pointer gets here.  All math is
// f32.  No kernel uses atomics and every sum runs in an order fixed by the
// shapes, so every result is the same from run to run.
//
// Layouts (the JAX package's): x [N, H, W, C]; weight [9*C, O] with row
// k*C + c for tap k = kh*3 + kw; offset [N, H, W, 18] as (dy, dx) per tap;
// mask [N, H, W, 9], already sigmoided; out [N, H, W, O]; the columns and
// their cotangent [N, H, W, 9*C].  Pixel p = (n*H + y)*W + x.
//
// Sampling.  Tap k of pixel p samples x at (y - 1 + kh + dy, x - 1 + kw +
// dx), each offset clamped to [-bound, bound].  The TPU kernel writes the
// bilinear sample as a sum over the (2R+2)^2 integer shifts of hat weights
// relu(1-|dy-u|) relu(1-|dx-v|), R = ceil(bound), because Mosaic cannot lower
// a gather (trackmpnn_tpu/ops/pallas_dcn.py:8-21).  For a clamped offset at
// most two hat weights a dimension are non-zero, floor(dy) and floor(dy)+1,
// so the sum is the 4-neighbour bilinear sample with zeros outside the
// image: the kernels read those four neighbours directly, and no cost grows
// with R except the candidate scan of dcn_bwd_dx.
//
// dcn_fwd
//   Replaces _dcn_kernel (trackmpnn_tpu/ops/pallas_dcn.py:45), the whole
//   batch in one launch (the TPU calls it once an image) and the bias added
//   in the epilogue.  out[p, o] = sum_{k, c} mask * sample(x, p, k)[c] *
//   weight[k*C + c, o] + bias[o].  Bound: operations (2 * 9 * C * O a
//   pixel; 9.06 GFLOP at the widest DLA-34 block, 4 x 96 x 320, C = O = 64).
//   Design: a tiled product on the CUDA cores whose A tile is built on the
//   fly.  A CTA owns 64 pixels x 64 output channels; it resolves the 9 x 4
//   neighbour indices and mask-scaled bilinear weights of its pixels once
//   into shared memory, then for each tap and 32-channel chunk fills the
//   A tile (one warp a pixel, lanes over channels: coalesced 128-byte reads
//   of each neighbour's channel row) and the weight tile, and each thread
//   accumulates a 4 x 4 register tile.  No column ever reaches device
//   memory.
//
// dcn_bwd_sample
//   The sampling transpose for the offsets and the mask, plus the columns
//   that d weight needs (the TPU kernel is forward only; JAX trains through
//   the XLA custom VJP of the warp, backbones/deform_conv.py:159-252).  One
//   warp a (pixel, tap), lanes over channels: it re-reads the four
//   neighbours, writes the masked sample (the columns), and reduces
//   r_j = sum_c x_j[c] * dcols[c] for the four neighbours with a fixed
//   shuffle tree.  Then d mask = sum_j w_j r_j, and d dy = mask * sum_v
//   wx_v (r(u0+1, v) - r(u0, v)) (d dx likewise) -- the hat derivative
//   -sign(dy-u) where relu(1-|dy-u|) > 0, with sign(0) = 0, so that at an
//   integer offset (fy = 0) the offset gradient is exactly 0, as the JAX
//   VJP gives it (:233-242).  The clamp passes the gradient inside the
//   bound, half of it at the bound itself (jnp.clip's) and none outside.
//   Bound: bytes (the cotangent and the columns, 9*C floats a pixel each).
//
// dcn_bwd_dx
//   d x without atomics, as a gather: one warp an input pixel q, lanes over
//   channels (4 a lane, 128-channel chunks).  For each tap, the (2R+2)^2
//   output pixels whose clamped sample can reach q (the shifts of the JAX
//   VJP) are scanned 32 at a time, one a lane; a ballot collects those
//   whose bilinear weight on q is non-zero, and the warp adds weight * mask
//   * dcols[p, k, :] for each, in lane order.  Bound: bytes (the cotangent,
//   read once, and d x written).
//
// No kernel synchronises the device or allocates; each entry point returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 9;
constexpr int kBM = 64;   // pixels a CTA (dcn_fwd)
constexpr int kBN = 64;   // output channels a CTA
constexpr int kBK = 32;   // channels of one tap a chunk
constexpr int kFwdThreads = 256;
constexpr int kWarpThreads = 256;  // the one-warp-an-item kernels
constexpr int kDxChunk = 128;      // channels a pass of dcn_bwd_dx (4 a lane)
constexpr unsigned kFull = 0xffffffffu;

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
// and the fractions fy = dy - floor(dy), fx = dx - floor(dx).
struct Taps {
  int64_t nb[4];
  float fy, fx, dy, dx;
};

__device__ __forceinline__ Taps tap_neighbours(const float* __restrict__ off, int64_t p, int k,
                                               int H, int W, float bound) {
  const int64_t hw = (int64_t)H * W;
  const int64_t n = p / hw;
  const int rem = (int)(p - n * hw);
  const int y = rem / W, xx = rem - (rem / W) * W;
  Taps t;
  t.dy = clampf(off[p * 18 + 2 * k], bound);
  t.dx = clampf(off[p * 18 + 2 * k + 1], bound);
  const float fy0 = floorf(t.dy), fx0 = floorf(t.dx);
  t.fy = t.dy - fy0;
  t.fx = t.dx - fx0;
  const int y0 = y - 1 + k / 3 + (int)fy0;
  const int x0 = xx - 1 + k % 3 + (int)fx0;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int yy = y0 + a, xb = x0 + b;
      const bool in = yy >= 0 && yy < H && xb >= 0 && xb < W;
      t.nb[2 * a + b] = in ? n * hw + (int64_t)yy * W + xb : -1;
    }
  }
  return t;
}

__global__ void __launch_bounds__(kFwdThreads)
dcn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ off,
               const float* __restrict__ mask, float* __restrict__ out, int64_t P, int H, int W,
               int C, int O, float bound) {
  __shared__ int64_t nb_idx[kTaps][4][kBM];
  __shared__ float nb_w[kTaps][4][kBM];
  __shared__ float As[kBK][kBM + 1];  // +1: the fill's column writes hit distinct banks
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int64_t p0 = (int64_t)blockIdx.x * kBM;
  const int o0 = blockIdx.y * kBN;

  // the 9 x 4 neighbours of the CTA's pixels, weights scaled by the mask
  for (int e = tid; e < kTaps * kBM; e += kFwdThreads) {
    const int k = e / kBM, m = e - (e / kBM) * kBM;
    const int64_t p = p0 + m;
    if (p < P) {
      const Taps t = tap_neighbours(off, p, k, H, W, bound);
      const float msk = mask[p * kTaps + k];
      const float wy[2] = {1.f - t.fy, t.fy}, wx[2] = {1.f - t.fx, t.fx};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        nb_idx[k][j][m] = t.nb[j];
        nb_w[k][j][m] = t.nb[j] >= 0 ? wy[j >> 1] * wx[j & 1] * msk : 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        nb_idx[k][j][m] = -1;
        nb_w[k][j][m] = 0.f;
      }
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int ty = tid >> 4, tx = tid & 15;  // 4 pixels x 4 outputs a thread
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < kTaps; ++k) {
    for (int c0 = 0; c0 < C; c0 += kBK) {
      const int c = c0 + lane;
      for (int m = warp; m < kBM; m += kFwdThreads / 32) {
        float s = 0.f;
        if (c < C) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int64_t q = nb_idx[k][j][m];
            if (q >= 0) s = fmaf(nb_w[k][j][m], x[q * C + c], s);
          }
        }
        As[lane][m] = s;
      }
      for (int e = tid; e < kBK * kBN; e += kFwdThreads) {
        const int kk = e / kBN, nn = e - (e / kBN) * kBN;
        const int cc = c0 + kk, oo = o0 + nn;
        Bs[kk][nn] = (cc < C && oo < O) ? w[((int64_t)k * C + cc) * O + oo] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
          acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
          acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
          acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t p = p0 + ty * 4 + i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int oo = o0 + tx * 4 + j;
      if (oo < O) out[p * O + oo] = acc[i][j] + (bias != nullptr ? bias[oo] : 0.f);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
  return v;
}

__global__ void __launch_bounds__(kWarpThreads)
dcn_bwd_sample_kernel(const float* __restrict__ x, const float* __restrict__ off,
                      const float* __restrict__ mask, const float* __restrict__ dcols,
                      float* __restrict__ cols, float* __restrict__ doff,
                      float* __restrict__ dmask, int64_t P, int H, int W, int C, float bound) {
  const int64_t item = ((int64_t)blockIdx.x * kWarpThreads + threadIdx.x) >> 5;  // p * 9 + k
  const int lane = threadIdx.x & 31;
  if (item >= P * kTaps) return;
  const int64_t p = item / kTaps;
  const int k = (int)(item - p * kTaps);
  const Taps t = tap_neighbours(off, p, k, H, W, bound);
  const float msk = mask[item];
  const float wy[2] = {1.f - t.fy, t.fy}, wx[2] = {1.f - t.fx, t.fx};
  float wj[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wj[j] = wy[j >> 1] * wx[j & 1];

  const float* g = dcols + item * C;
  float* col = cols + item * C;
  float r[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = lane; c < C; c += 32) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = t.nb[j] >= 0 ? x[t.nb[j] * C + c] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) s = fmaf(wj[j], v[j], s);
    col[c] = msk * s;
    const float gc = g[c];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = fmaf(v[j], gc, r[j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = warp_sum(r[j]);
  if (lane == 0) {
    dmask[item] = wj[0] * r[0] + wj[1] * r[1] + wj[2] * r[2] + wj[3] * r[3];
    // the hat derivative is 0 at an integer offset (sign(0) = 0)
    const float ddy = t.fy > 0.f ? msk * (wx[0] * (r[2] - r[0]) + wx[1] * (r[3] - r[1])) : 0.f;
    const float ddx = t.fx > 0.f ? msk * (wy[0] * (r[1] - r[0]) + wy[1] * (r[3] - r[2])) : 0.f;
    doff[p * 18 + 2 * k] = ddy * clip_grad(off[p * 18 + 2 * k], bound);
    doff[p * 18 + 2 * k + 1] = ddx * clip_grad(off[p * 18 + 2 * k + 1], bound);
  }
}

// the bilinear weight of tap k of pixel p on an input row/column at integer
// shift u from the tap's base: 1 - f at floor(d), f at floor(d) + 1
__device__ __forceinline__ float hat_weight(float d, int u) {
  const float f0 = floorf(d);
  const int u0 = (int)f0;
  return u == u0 ? 1.f - (d - f0) : (u == u0 + 1 ? d - f0 : 0.f);
}

__global__ void __launch_bounds__(kWarpThreads)
dcn_bwd_dx_kernel(const float* __restrict__ off, const float* __restrict__ mask,
                  const float* __restrict__ dcols, float* __restrict__ dx, int64_t P, int H,
                  int W, int C, int R, float bound) {
  const int64_t q = ((int64_t)blockIdx.x * kWarpThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q >= P) return;
  const int64_t hw = (int64_t)H * W;
  const int64_t n = q / hw;
  const int rem = (int)(q - n * hw);
  const int qy = rem / W, qx = rem - (rem / W) * W;
  const int S = 2 * R + 2, ncand = S * S;

  for (int c0 = 0; c0 < C; c0 += kDxChunk) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < kTaps; ++k) {
      const int kh = k / 3, kw = k % 3;
      for (int base = 0; base < ncand; base += 32) {
        const int i = base + lane;
        float wt = 0.f;
        int64_t p = 0;
        if (i < ncand) {
          const int py = qy - kh - R + i / S, px = qx - kw - R + i % S;
          if (py >= 0 && py < H && px >= 0 && px < W) {
            p = n * hw + (int64_t)py * W + px;
            const float dy = clampf(off[p * 18 + 2 * k], bound);
            const float dxo = clampf(off[p * 18 + 2 * k + 1], bound);
            wt = hat_weight(dy, qy - (py - 1 + kh)) * hat_weight(dxo, qx - (px - 1 + kw)) *
                 mask[p * kTaps + k];
          }
        }
        unsigned hits = __ballot_sync(kFull, wt != 0.f);
        while (hits) {
          const int src = __ffs(hits) - 1;
          hits &= hits - 1;
          const float ws = __shfl_sync(kFull, wt, src);
          const int64_t ps = __shfl_sync(kFull, (long long)p, src);
          const float* g = dcols + (ps * kTaps + k) * C;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + lane + 32 * j;
            if (c < C) acc[j] = fmaf(ws, g[c], acc[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < C) dx[q * C + c] = acc[j];
    }
  }
}

unsigned warp_blocks(int64_t items) {
  return (unsigned)((items * 32 + kWarpThreads - 1) / kWarpThreads);
}

}  // namespace

// x f32[N, H, W, C]; w f32[9*C, O]; bias f32[O] or null; off f32[N, H, W,
// 18]; mask f32[N, H, W, 9].  Writes out f32[N, H, W, O].  N*H*W > 0.
extern "C" int tm_dcn_fwd(const void* x, const void* w, const void* bias, const void* off,
                          const void* mask, void* out, int N, int H, int W, int C, int O,
                          float bound, void* stream) {
  const int64_t P = (int64_t)N * H * W;
  const dim3 grid((unsigned)((P + kBM - 1) / kBM), (unsigned)((O + kBN - 1) / kBN));
  dcn_fwd_kernel<<<grid, kFwdThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)bias, (const float*)off,
      (const float*)mask, (float*)out, P, H, W, C, O, bound);
  return (int)cudaGetLastError();
}

// x, off, mask as tm_dcn_fwd; dcols f32[N, H, W, 9*C], the cotangent of
// the columns.  Writes cols f32[N, H, W, 9*C], doff f32[N, H, W, 18] and
// dmask f32[N, H, W, 9].
extern "C" int tm_dcn_bwd_sample(const void* x, const void* off, const void* mask,
                                 const void* dcols, void* cols, void* doff, void* dmask, int N,
                                 int H, int W, int C, float bound, void* stream) {
  const int64_t P = (int64_t)N * H * W;
  dcn_bwd_sample_kernel<<<warp_blocks(P * kTaps), kWarpThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)off, (const float*)mask, (const float*)dcols, (float*)cols,
      (float*)doff, (float*)dmask, P, H, W, C, bound);
  return (int)cudaGetLastError();
}

// off, mask, dcols as tm_dcn_bwd_sample; R = ceil(bound).  Writes dx
// f32[N, H, W, C].
extern "C" int tm_dcn_bwd_dx(const void* off, const void* mask, const void* dcols, void* dx,
                             int N, int H, int W, int C, int R, float bound, void* stream) {
  const int64_t P = (int64_t)N * H * W;
  dcn_bwd_dx_kernel<<<warp_blocks(P), kWarpThreads, 0, (cudaStream_t)stream>>>(
      (const float*)off, (const float*)mask, (const float*)dcols, (float*)dx, P, H, W, C, R,
      bound);
  return (int)cudaGetLastError();
}
