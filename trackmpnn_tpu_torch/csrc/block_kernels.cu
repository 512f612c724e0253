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
//
// block_round_bwd
//   Replaces _bwd_kernel (the custom VJP of fused_block_round): recomputes
//   gh and the gates and writes d h_e (masked), d ga (sum over j), d gb
//   (sign * sum over i) and [d w_hh | d b_hh | d w_eb].  Three products a
//   cell: gh again, d gh @ w_hh^T and he_m^T @ d gh.
//
// block_round_es_fwd / block_round_es_bwd
//   Replace _es_fwd_kernel / _es_bwd_kernel (fused_block_round_es,
//   pallas_block.py:333, :382): the same round with the input-gate gather
//   and the edge-support reduction inside.  The round kernels take kGather
//   true: they read the gates of row i and column j by index, ga_d[w*capD +
//   act[q, i]] + b_ih and gb_d[w*capD + new[q, j]] (w = q % B, step-major
//   blocks), and an id outside [0, capD) of a live cell traps the kernel.
//   The forward writes the block's row and column sums to scratch and
//   incidence_reduce_kernel, one thread per (detection, column), sums es[d]
//   = the row sums of d's active rows minus the column sums of its new
//   columns over the batch's incidence (block order, f64, rounded once,
//   stopping at the first block >= P).  The backward takes the cotangents
//   of the row and column sums as d es[act_i] and -d es[new_j], adds d b_ih
//   (the sum of the d ga rows) to the partials, and incidence_reduce_kernel
//   sums the per-block d ga / d gb rows into d ga_d, d gb_d [B*capD, 3H].
//   The TPU kernels gather and scatter with one-hot matmuls over a window's
//   capD rows (_onehot_t, :319), an MXU idiom; here a CTA loads its own
//   indices.
//
// Bound of the four: f32 operations (2*H*3H multiply-adds a live cell a
// product against ~H*4 B read and written a cell, ~50 flop/B at H = 64,
// above the card's f32 ratio of 67 TFLOP/s over 3.35 TB/s = 20 flop/B).
//
// The first design ran the products on the CUDA cores from shared memory:
// a whole w_hh padded to [H][3H + 1] resident in each CTA, the backward one
// CTA a block holding its d w_hh and every row's d ga and column's d gb
// (~178 KB at H 64, na = nt = 24: one CTA of 8 warps an SM, 120 CTAs on 132
// SMs, 18 serial tiles each with four barriers and three serial reduction
// passes), and each k of a product 11 shared loads for 24 FMAs.  At the
// widest round of the block step (P 120, na = nt = 24, H 64, ~25k live
// cells) it measured 148.78 / 602.44 us (fwd / bwd) and 174.81 / 650.68
// (es), 15-22x the f32 bound, and it refused H 128 (514 KB of shared
// memory) and na + nt > 114 at H 64.
//
// This design:
//   * Tensor cores at f32-level error.  Each product runs as
//     mma.sync.m16n8k8 .tf32 in the split-TF32 scheme CUTLASS calls
//     3xTF32 (tf32_mma.cuh, shared with mp_kernels.cu's edge GRU):
//     x = big + small, big = tf32(x) (round to nearest on the int32
//     view, ties away: (bits + 0x1000) & ~0x1fff), small = tf32(x - big)
//     (x - big is exact), a*b ~ a.small*b.big + a.big*b.small + a.big*b.big.
//     tf32 products are exact in f32; what is dropped (a.small*b.small, the
//     rounding of the smalls) is below 2^-22 |a b| a product.  The tensor
//     cores cut, not round, the low bits where they add into an
//     accumulator, an error that grows with every mma into one sum; so each
//     k step's three mmas go to a fresh accumulator and the CUDA cores add
//     it in f32 (without that, H 128 missed the forward's 1e-5 by 1.5x).
//     Against the plain version evaluated in f64 the kernels then err less
//     than the plain version in f32 does (tests/test_torch_block_tiling.py
//     emulates the arithmetic on the CPU; plain TF32 misses the bounds by
//     more than 10x).
//   * Forward and d h_e (round_fwd_kernel, round_dh_kernel): one CTA of
//     kWarps warps a tile of kTile consecutive cells, 1,080 at the widest
//     round; a tile whose cells are all masked is written as zeros and
//     does nothing else.  A warp owns 16 cells (the mma's M) and the CTA
//     steps through the unit chunks of 8 units: each step stages the next
//     chunk's slab of w_hh ([3 gates][H][8], split into big and small once
//     by the threads that copied it) with cp.async while the warps compute
//     gh of this chunk (r, z, n: three n tiles, K = H) and the gates in
//     registers (the accumulator's element (cell, unit) is the same thread's
//     for r, z and n; ga, gb and b_hh are loaded before the product, which
//     hides them).  The forward writes edge_out and sums lg in f64 (a fixed
//     shuffle tree over a row's four lanes; lg sums H products).  d h_e
//     forms d gh and adds d gh @ w_hh^T of the chunk from the same slab:
//     the accumulator's columns 2t, 2t + 1 are the next A fragment's k
//     slots t, t + 4 (the B rows read in the same order), so d gh never
//     leaves registers; a warp holds 64 columns of d h_e (passes over the
//     chunks where H > 64).  It leaves [d pre_r | d pre_z | d pre_n r |
//     d pre_n | edge_out g_lg] of each live cell in a scratch.  Shared
//     memory 42 KB a CTA at H 64 (165 KB at H 256).
//   * d w_hh = he_m^T @ d gh (round_dw_kernel): a split-K product, one CTA
//     a (block, split of at most 3 tiles of its cells) and 64 x 48 tile of
//     [H, 3H], 1,440 at the widest round, cp.async double-buffered, the
//     partials one row a (block, split).  The cell sums (round_sums_kernel,
//     one thread an entry, cell order): d ga (over j), d gb (over i) and
//     every 4 rows' sums for d b_hh, d w_eb and d b_ih.  They read only the
//     scratch, so they run on a side stream beside the product, joined by
//     events.  A masked cell is never read (its mask selects the address
//     of the mask itself, which holds 0), so no load waits on a branch.
//   * Fixed reduction order everywhere: sum_partials_kernel sums the
//     partial rows in two levels (kSumGroups strided groups, then the groups
//     in order) in one launch for d w_hh and the biases.  No atomics; every
//     output is the same on a second launch.
//   * Widths: shared memory depends on H only; any na, nt >= 1 and every H
//     that is a multiple of 8 from 8 to kMaxH = 256.
//
// block_round_fwd_bf16 / block_round_bwd_bf16 (#4 in bf16)
//   The round of the block step's bf16 rectangles (train/block.py,
//   compute_dtype=torch.bfloat16), the TPU kernel with mm_dtype bf16
//   (pallas_block.py:94-190, :253-279): h_e, ga, gb and d edge_out bf16;
//   he_m = f32(h_e) * mask; gh = he_m @ w_hh with both operands rounded to
//   bf16 and f32 sums; the gates in f32; edge_out stored in bf16 and lg
//   taken from the f32 edge_out before that rounding; rs / cs f32 sums of
//   he_m; the backward's d gh @ w_hh^T and he_m^T @ d gh with both operands
//   rounded to bf16; d h_e, d ga, d gb written in bf16, d w_hh, d b_hh,
//   d w_eb f32.  The same four kernels instantiated on the element type
//   and the product: each k step is one mma.sync.m16n8k16 .bf16 with f32
//   accumulators where the f32 round runs three m16n8k8 .tf32 (and K is 16
//   a step, not 8), so a product is a sixth of the f32 round's tensor-core
//   instructions; the tile of h_e, the gate rows and the outputs move half
//   the bytes.  A stage of w_hh is copied in f32 with cp.async and
//   converted once to bf16 in two layouts, one for each product that reads
//   it ([3][H][8] for d gh @ w_hh^T, [3][8][H] for gh).  d gh stays f32 in
//   the scratch (d b_hh and the gate sums are f32 sums of it) and is
//   rounded to bf16 where d w_hh's product reads it.  Same tiles, grids,
//   launches and reduction orders as the f32 round.
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
//
// No kernel synchronises or allocates: the caller allocates every output
// and scratch, and every launch goes to the stream it is given, but for the
// round backward's cell sums, which go to a side stream of the device that
// waits for the given stream and that the given stream waits for (events;
// no host synchronisation).  Each entry point returns cudaGetLastError() so
// the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"  // 3xTF32 mma, cp.async

namespace {

using bf16 = __nv_bfloat16;

// the round's element type: float (the f32 round) or bf16 (the bf16 round)
template <class E>
struct IsBf16 {
  static constexpr bool value = sizeof(E) == 2;
};

constexpr int kWarps = 4;              // warps of a round CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;              // cells of a warp tile: the mma's M
constexpr int kTile = kRows * kWarps;  // cells of a CTA tile
constexpr int kMaxH = 256;
constexpr int kChunk = 8;              // units of a chunk: one n tile each of r, z, n
constexpr int kDheTiles = 8;           // n tiles (8 columns) of d h_e a warp holds
constexpr int kDgs = 40;               // floats a cell and chunk of the d gh scratch
constexpr int kDwRows = 16 * kWarps;   // rows (h) of a d w_hh CTA tile: an m tile a warp
constexpr int kDwCols = 48;            // its columns: 6 n tiles
constexpr int kAStride = 72;           // floats a staged cell of h_e's 64 rows (8 mod 32)
constexpr int kBStride = 56;           // floats a staged cell of d gh's 48 columns (24 mod 32)
constexpr int kSumRows = 4;            // rows (q, i) a sums thread takes
constexpr int kSumGroups = 16;         // row groups of a partial-sum CTA
constexpr int kWsThreads = 256;
constexpr int kWsUnroll = 8;  // slots (then values) a lane has in flight

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// ------------------------------------------------------------ the round ----
// floats a staged row of h_e: H plus padding to 4 mod 32, so that an A
// fragment's loads (rows g, columns t) hit 32 banks
__host__ __device__ __forceinline__ int he_stride(int H) { return H + (36 - H % 32) % 32; }

// A unit chunk's slab of w_hh: [3 gates][H rows][8 columns] (columns gate*H
// + u*8 .. + 8 of every row), split into big and small halves of slab_floats
// each; conflict-free for both products that read it (rows t, columns g;
// rows g, columns 2t and 2t + 1).
__host__ __device__ __forceinline__ int slab_floats(int H) { return 3 * H * kChunk; }

// Elements a staged row of h_e takes: f32 he_stride(H); bf16 two a 32-bit
// word, he_stride(H / 2) words (4 mod 32 again, for the fragments' word
// loads).
template <class E>
__host__ __device__ __forceinline__ int tile_stride(int H) {
  return IsBf16<E>::value ? 2 * he_stride(H / 2) : he_stride(H);
}

// Floats a stage of w_hh takes: f32 its split (big | small); bf16 the
// staged f32 slab, then its bf16 copies in the A layout [3 gates][H rows][8
// units] (d gh @ w_hh^T reads its words: rows g, units 2t, 2t + 1) and the
// T layout [3 gates][8 units][H], rows he_stride(H / 2) words apart (gh
// reads its words: units g, rows 2t, 2t + 1).
template <class E>
__host__ __device__ __forceinline__ int stage_floats(int H) {
  return IsBf16<E>::value ? slab_floats(H) + slab_floats(H) / 2 + 3 * kChunk * he_stride(H / 2)
                          : 2 * slab_floats(H);
}

template <class E>
size_t tile_smem(int H) {  // forward and d h_e: a CTA tile and its masks, two stages
  return sizeof(E) * kTile * tile_stride<E>(H) + sizeof(float) * (kTile + 2 * stage_floats<E>(H));
}
size_t dw_smem() {  // two cell tiles of h_e and of d gh, their masks
  return sizeof(float) * 2 * kTile * (kAStride + kBStride + 1);
}

// Where a round kernel reads the input gates of row i and column j of block
// q.  kGather false: per-block rows ga[P, na, 3H], gb[P, nt, 3H] (b_ih
// already in ga).  kGather true: the detection layout ga_d / gb_d [B*capD,
// 3H] at row (q % B)*capD + the window-local id act[q, i] / new[q, j], with
// b_ih added to the ga side; an id outside [0, capD) traps.
template <class E>
struct GateSrcT {
  const E *ga, *gb;
  const float* bih;
  const int32_t *act, *nw;
  int B, capD;
};
using GateSrc = GateSrcT<float>;

// One cell of a thread's rows: its index among all P*na*nt cells (-1 past
// the block's), its mask and, where live, its gate rows; da / dn the rows
// of the cotangents of the row and column sums (detection rows where
// kGather).
template <class E>
struct CellT {
  int64_t cell;
  float m;
  const E *ga, *gb;
  int64_t da, dn;
};

template <bool kGather, class E>
__device__ __forceinline__ CellT<E> cell_at(const GateSrcT<E>& g, const float* __restrict__ mask,
                                            int64_t q, int na, int nt, int H, int c) {
  CellT<E> r{-1, 0.f, nullptr, nullptr, 0, 0};
  const int ncell = na * nt;
  if (c >= ncell) return r;
  r.cell = q * ncell + c;
  r.m = mask[r.cell];
  if (r.m == 0.f) return r;
  const int i = c / nt, j = c - (c / nt) * nt;
  if constexpr (kGather) {
    const int a = g.act[q * na + i], n = g.nw[q * nt + j];
    if ((unsigned)a >= (unsigned)g.capD || (unsigned)n >= (unsigned)g.capD) __trap();
    const int64_t base = (q % g.B) * (int64_t)g.capD;
    r.da = base + a;
    r.dn = base + n;
  } else {
    r.da = q * na + i;
    r.dn = q * nt + j;
  }
  r.ga = g.ga + r.da * 3 * H;
  r.gb = g.gb + r.dn * 3 * H;
  return r;
}

__device__ __forceinline__ float2 ld2(const float* p) { return __ldg((const float2*)p); }
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(__ldg((const __nv_bfloat162*)p));
}
// two values from shared memory, as floats
__device__ __forceinline__ float2 sh2(const float* p) { return *(const float2*)p; }
__device__ __forceinline__ float2 sh2(const bf16* p) {
  return __bfloat1622float2(*(const __nv_bfloat162*)p);
}
// two values stored in the output's type (bf16: rounded to nearest, ties even)
__device__ __forceinline__ void st2(float* p, float x, float y) { *(float2*)p = make_float2(x, y); }
__device__ __forceinline__ void st2(bf16* p, float x, float y) {
  *(__nv_bfloat162*)p = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void st1(float* p, float x) { *p = x; }
__device__ __forceinline__ void st1(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// (lo, hi) rounded to bf16 in one 32-bit register, lo in the low half: an
// mma fragment's pair of consecutive k (or n) values
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a b, one m16n8k16 bf16 product with f32 accumulators.  A (row
// major): a[0] row g, k 2t, 2t + 1; a[1] row g + 8; a[2], a[3] the same at k
// + 8.  B (column major): b[0] k 2t, 2t + 1 of column g; b[1] at k + 8.
// C as m16n8k8's: rows g, g + 8, columns 2t, 2t + 1.  The products of two
// bf16 values are exact in f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x where the mask at m is set, else m itself (which holds 0): a select of
// addresses, not a branch, so that a loop's loads are in flight together
__device__ __forceinline__ const float* masked(const float* m, const float* x) {
  return *m != 0.f ? x : m;
}

// A live cell's gate inputs at units h, h + 1 (h even): gi = ga + sign * gb
// (plus b_ih where kGather) and b_hh of r, z, n.  Loaded before the chunk's
// product, so that the product hides their latency.
struct GateIn {
  float gi[3][2], bh[3][2];
};

template <bool kGather, class E>
__device__ __forceinline__ GateIn gate_in(const GateSrcT<E>& g, const CellT<E>& c,
                                          const float* bhh, int H, int h, float sign) {
  GateIn o;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o.gi[k][0] = o.gi[k][1] = 0.f;
    const float2 b = ld2(bhh + k * H + h);
    o.bh[k][0] = b.x;
    o.bh[k][1] = b.y;
  }
  if (c.m == 0.f) return o;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float2 a = ld2(c.ga + k * H + h);
    if constexpr (kGather) {
      const float2 b = ld2(g.bih + k * H + h);
      a.x += b.x;
      a.y += b.y;
    }
    const float2 b = ld2(c.gb + k * H + h);
    o.gi[k][0] = a.x + sign * b.x;
    o.gi[k][1] = a.y + sign * b.y;
  }
  return o;
}

// The gates of units h, h + 1 from the chunk's products p[gate][e] (no
// bias): r, z, n and gh_n = p_n + b_hh_n.
struct Gates2 {
  float r[2], z[2], n[2], ghn[2];
};

__device__ __forceinline__ Gates2 gates2(const GateIn& in, const float (&p)[3][2]) {
  Gates2 o;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    o.r[e] = sigmoid_f(in.gi[0][e] + (p[0][e] + in.bh[0][e]));
    o.z[e] = sigmoid_f(in.gi[1][e] + (p[1][e] + in.bh[1][e]));
    o.ghn[e] = p[2][e] + in.bh[2][e];
    o.n[e] = tanhf(in.gi[2][e] + o.r[e] * o.ghn[e]);
  }
  return o;
}

// Copies unit chunk u's slab of w_hh into big with cp.async (two 16-byte
// pieces a slab row); split_slab then splits what the same thread copied.
__device__ __forceinline__ void stage_slab(float* big, const float* __restrict__ whh, int H,
                                           int u, int tid, int nthreads) {
  for (int e = tid; e < 2 * 3 * H; e += nthreads) {
    const int row = e >> 1, half = e & 1, gate = row / H, k = row - gate * H;
    cp_async16(big + row * kChunk + 4 * half,
               whh + (int64_t)k * 3 * H + gate * H + u * kChunk + 4 * half, true);
  }
}

__device__ __forceinline__ void split_slab(float* big, int H, int tid, int nthreads) {
  float* small = big + slab_floats(H);
  for (int e = tid; e < 2 * 3 * H; e += nthreads) {
    float4* pb = (float4*)(big + 4 * e);
    const float4 v = *pb;
    const float4 b = make_float4(tf32_round(v.x), tf32_round(v.y), tf32_round(v.z),
                                 tf32_round(v.w));
    *pb = b;
    *(float4*)(small + 4 * e) = make_float4(tf32_round(v.x - b.x), tf32_round(v.y - b.y),
                                            tf32_round(v.z - b.z), tf32_round(v.w - b.w));
  }
}

// The bf16 round's stage: converts the f32 slab at raw, the 16-byte pieces
// this thread copied (stage_slab's mapping), into its A and T layouts
// (stage_floats).
__device__ __forceinline__ void convert_slab(float* raw, int H, int tid, int nthreads) {
  bf16* a = (bf16*)(raw + slab_floats(H));
  bf16* tl = (bf16*)(raw + slab_floats(H) + slab_floats(H) / 2);
  const int ts = 2 * he_stride(H / 2);
  for (int e = tid; e < 2 * 3 * H; e += nthreads) {
    const float4 v = *(const float4*)(raw + 4 * e);
    const float x[4] = {v.x, v.y, v.z, v.w};
    const int row = e >> 1, u0 = 4 * (e & 1), gate = row / H, k = row - gate * H;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bf16 b = __float2bfloat16_rn(x[i]);
      a[4 * e + i] = b;  // raw index row * 8 + u0 + i
      tl[(gate * kChunk + u0 + i) * ts + k] = b;
    }
  }
}

template <class E>
__device__ __forceinline__ void prepare_slab(float* slab, int H, int tid, int nthreads) {
  if constexpr (IsBf16<E>::value)
    convert_slab(slab, H, tid, nthreads);
  else
    split_slab(slab, H, tid, nthreads);
}

// acc[gate] = the 16 staged rows at hs, times their masks m_lo (rows 0-7)
// and m_hi (8-15), @ the slab's gate columns (K = H), 3xTF32 with the
// slab's split.  Thread (g, t) holds rows g, g + 8 and units u*8 + 2t, + 1 of
// each gate.
__device__ __forceinline__ void gate_chunk(const float* hs, int stride, const float* slab,
                                           int H, int lane, float m_lo, float m_hi,
                                           float (&acc)[3][4]) {
  const int g = lane >> 2, t = lane & 3;
  const float* small = slab + slab_floats(H);
#pragma unroll
  for (int k = 0; k < 3; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;
  const float* lo = hs + g * stride + t;
  const float* hi = lo + 8 * stride;
#pragma unroll 2
  for (int k0 = 0; k0 < H; k0 += 8) {
    const FragA a = frag_a(m_lo * lo[k0], m_hi * hi[k0], m_lo * lo[k0 + 4], m_hi * hi[k0 + 4]);
#pragma unroll
    for (int gate = 0; gate < 3; ++gate) {
      const int i0 = (gate * H + k0 + t) * kChunk + g, i1 = i0 + 4 * kChunk;
      FragB b;
      b.big[0] = __float_as_uint(slab[i0]);
      b.big[1] = __float_as_uint(slab[i1]);
      b.small[0] = __float_as_uint(small[i0]);
      b.small[1] = __float_as_uint(small[i1]);
      mma3(acc[gate], a, b);
    }
  }
}

// The bf16 round's gh: acc[gate] = the 16 staged bf16 rows at hs, times
// their masks, @ the stage's T layout (K = H, 16 a step; where H is not a
// multiple of 16 the last step's upper 8 are zeros), bf16 products, f32
// sums.  Thread (g, t) holds rows g, g + 8 and units u*8 + 2t, + 1 of each
// gate, as gate_chunk's f32 form.
__device__ __forceinline__ void gate_chunk(const bf16* hs, int stride, const float* slab, int H,
                                           int lane, float m_lo, float m_hi, float (&acc)[3][4]) {
  const int g = lane >> 2, t = lane & 3, tw = he_stride(H / 2);
  const uint32_t* tl = (const uint32_t*)(slab + slab_floats(H) + slab_floats(H) / 2);
#pragma unroll
  for (int k = 0; k < 3; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;
  const bf16* lo = hs + g * stride + 2 * t;
  const bf16* hi = lo + 8 * stride;
#pragma unroll 2
  for (int k0 = 0; k0 < H; k0 += 16) {
    const bool up = k0 + 8 < H;
    uint32_t a[4] = {0u, 0u, 0u, 0u};
    float2 x = sh2(lo + k0), y = sh2(hi + k0);
    a[0] = pack_bf16(m_lo * x.x, m_lo * x.y);
    a[1] = pack_bf16(m_hi * y.x, m_hi * y.y);
    if (up) {
      x = sh2(lo + k0 + 8);
      y = sh2(hi + k0 + 8);
      a[2] = pack_bf16(m_lo * x.x, m_lo * x.y);
      a[3] = pack_bf16(m_hi * y.x, m_hi * y.y);
    }
#pragma unroll
    for (int gate = 0; gate < 3; ++gate) {
      const uint32_t* col = tl + (gate * kChunk + g) * tw + k0 / 2 + t;
      const uint32_t b[2] = {col[0], up ? col[4] : 0u};
      mma_bf16(acc[gate], a, b);
    }
  }
}

// Copies the live ones (mask_s[r] != 0) of the len cells from c0 of block
// q's h_e into dst [kTile][stride] with cp.async (16-byte pieces); the rest
// of the tile is zero-filled.
template <class E>
__device__ __forceinline__ void stage_tile(E* dst, const E* __restrict__ he, int64_t q,
                                           int ncell, int c0, int len, int H, int stride,
                                           const float* mask_s) {
  constexpr int kPer = 16 / sizeof(E);  // elements a piece
  const int per_row = H / kPer;
  for (int e = threadIdx.x; e < kTile * per_row; e += kThreads) {
    const int r = e / per_row, c4 = e - r * per_row;
    const bool valid = r < len && mask_s[r] != 0.f;
    cp_async16((float*)(dst + r * stride + kPer * c4),
               (const float*)(valid ? he + (q * ncell + c0 + r) * (int64_t)H + kPer * c4 : he),
               valid);
  }
}

// whether any of the 16 cells from c0 is live (a warp-wide vote)
__device__ __forceinline__ bool warp_tile_live(const float* __restrict__ mask, int64_t q,
                                               int ncell, int c0, int lane) {
  const int c = c0 + (lane & 15);
  return __any_sync(0xffffffffu, c < ncell && mask[q * ncell + c] != 0.f);
}

// the mask of thread tid's cell of the len cells from c0 (0 past len)
__device__ __forceinline__ float tile_mask(const float* __restrict__ mask, int64_t q, int ncell,
                                           int c0, int len) {
  return threadIdx.x < len ? mask[q * ncell + c0 + threadIdx.x] : 0.f;
}

// whether any of the len cells from c0 is live (a CTA-wide vote on m, each
// thread's tile_mask); the masks go to mask_s [kTile]
__device__ __forceinline__ bool cta_tile_live(float m, float* mask_s) {
  if (threadIdx.x < kTile) mask_s[threadIdx.x] = m;
  return __syncthreads_or(m != 0.f) != 0;
}

// Zeros rows [c0, c0 + rows) of a [.., H] output of block q (cells past
// ncell left alone), threads tid, tid + nthreads, ...
template <class E>
__device__ __forceinline__ void zero_rows(E* out, int64_t q, int ncell, int c0, int rows,
                                          int H, int tid, int nthreads) {
  rows = min(rows, ncell - c0);
  float4* p = (float4*)(out + (q * ncell + c0) * H);
  const int n4 = rows * H / (16 / (int)sizeof(E));
  for (int k = tid; k < n4; k += nthreads) p[k] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// *x where the mask at m is set, else 0 (masked(): a select of addresses)
__device__ __forceinline__ float masked_ld(const float* m, const float* x) { return *masked(m, x); }
__device__ __forceinline__ float masked_ld(const float* m, const bf16* x) {
  return __bfloat162float(*(*m != 0.f ? x : (const bf16*)m));  // the mask's 0.f reads as +0
}

// Row and column sums of the masked rectangle of block q, in a fixed order
// (f64, rounded once): rows and columns split + nsplit * k of it.
template <class E>
__device__ void row_col_sums(const E* __restrict__ he, const float* __restrict__ mask,
                             int64_t q, int na, int nt, int H, float* __restrict__ rs,
                             float* __restrict__ cs, int split, int nsplit) {
  const int64_t cell0 = q * na * nt;
  const int my_rows = (na - split + nsplit - 1) / nsplit, my_cols = (nt - split + nsplit - 1) / nsplit;
  for (int k = threadIdx.x; k < my_rows * H; k += blockDim.x) {
    const int i = split + nsplit * (k / H), h = k % H;
    double acc = 0.0;
    const float* mrow = mask + cell0 + (int64_t)i * nt;
    const E* hrow = he + (cell0 + (int64_t)i * nt) * H + h;
#pragma unroll 8
    for (int j = 0; j < nt; ++j)
      acc += (double)(mrow[j] * masked_ld(mrow + j, hrow + (int64_t)j * H));
    rs[(q * na + i) * H + h] = (float)acc;
  }
  for (int k = threadIdx.x; k < my_cols * H; k += blockDim.x) {
    const int j = split + nsplit * (k / H), h = k % H;
    double acc = 0.0;
    const float* mcol = mask + cell0 + j;
    const E* hcol = he + (cell0 + j) * H + h;
#pragma unroll 8
    for (int i = 0; i < na; ++i)
      acc += (double)(mcol[(int64_t)i * nt] *
                      masked_ld(mcol + (int64_t)i * nt, hcol + (int64_t)i * nt * H));
    cs[(q * nt + j) * H + h] = (float)acc;
  }
}

// The forward and d h_e kernels' walk: CTA (q, s) of grid (P, tiles) takes
// the kTile cells from s * kTile of block q.  A live tile is staged with the
// first chunk's slab; each step stages the next slab while every warp
// computes on this one (its 16 cells), between two barriers.  step(hs, slab,
// s, c0, live) runs steps s = 0 .. steps - 1 on chunk s % chunks, hs the
// warp's rows (h_e unmasked), c0 its first cell; dead(c0) writes a tile of
// masked cells.
template <class E, class Step, class Dead>
__device__ __forceinline__ void for_cta_tile(const E* __restrict__ he,
                                             const float* __restrict__ whh,
                                             const float* __restrict__ mask, int64_t q,
                                             int ncell, int H, int steps, Step step, Dead dead) {
  extern __shared__ float4 smem4[];
  const int stride = tile_stride<E>(H), chunks = H / kChunk, lane = threadIdx.x & 31;
  E* tile_s = (E*)smem4;
  float* mask_s = (float*)(tile_s + kTile * stride);  // [kTile]
  float* slabs = mask_s + kTile;                      // [2][stage_floats]
  const int c0 = blockIdx.y * kTile, len = min(kTile, ncell - c0);
  if (!cta_tile_live(tile_mask(mask, q, ncell, c0, len), mask_s)) {
    dead(c0);
    return;
  }
  stage_tile(tile_s, he, q, ncell, c0, len, H, stride, mask_s);
  stage_slab(slabs, whh, H, 0, threadIdx.x, kThreads);
  cp_async_commit();
  const int w0 = c0 + (threadIdx.x >> 5) * kRows;
  const bool live = warp_tile_live(mask, q, ncell, w0, lane);
  for (int s = 0; s < steps; ++s) {
    float* slab = slabs + (s & 1) * stage_floats<E>(H);
    if (s + 1 < steps)
      stage_slab(slabs + ((s + 1) & 1) * stage_floats<E>(H), whh, H, (s + 1) % chunks,
                 threadIdx.x, kThreads);
    cp_async_commit();
    cp_async_wait<1>();
    prepare_slab<E>(slab, H, threadIdx.x, kThreads);
    __syncthreads();
    step(tile_s + (threadIdx.x >> 5) * kRows * stride, slab, s, w0, live);
    __syncthreads();
  }
  cp_async_wait<0>();
}

// Grid (P, tiles); CTA (q, s) also sums rows and columns s + tiles * k of
// block q for rs and cs.  E: the element type of h_e, the gates and
// edge_out (bf16: the bf16 round).
template <bool kGather, class E>
__global__ void __launch_bounds__(kThreads)
round_fwd_kernel(const E* __restrict__ he, const GateSrcT<E> gsrc, const float* __restrict__ whh,
                 const float* __restrict__ bhh, const float* __restrict__ web,
                 const float* __restrict__ mask, E* __restrict__ eo, float* __restrict__ rs,
                 float* __restrict__ cs, float* __restrict__ lg, int na, int nt, int H,
                 float sign) {
  const int64_t q = blockIdx.x;
  const int ncell = na * nt, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int stride = tile_stride<E>(H), chunks = H / kChunk;
  CellT<E> c[2];
  double lgp[2];  // lg sums H products: f64, rounded once
  auto step = [&](const E* hs, const float* slab, int u, int w0, bool live) {
    if (u == 0) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        c[rr] = cell_at<kGather>(gsrc, mask, q, na, nt, H, w0 + g + 8 * rr);
        lgp[rr] = 0.0;
      }
    }
    if (!live) {
      if (u == 0) {
        zero_rows(eo, q, ncell, w0, kRows, H, lane, 32);
        if (lane < kRows && w0 + lane < ncell) lg[q * ncell + w0 + lane] = 0.f;
      }
      return;
    }
    const int h = u * kChunk + 2 * t;
    const float2 we = ld2(web + h);
    const GateIn in[2] = {gate_in<kGather>(gsrc, c[0], bhh, H, h, sign),
                          gate_in<kGather>(gsrc, c[1], bhh, H, h, sign)};
    float acc[3][4];
    gate_chunk(hs, stride, slab, H, lane, c[0].m, c[1].m, acc);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float out[2] = {0.f, 0.f};
      if (c[rr].m != 0.f) {
        const float p[3][2] = {{acc[0][2 * rr], acc[0][2 * rr + 1]},
                               {acc[1][2 * rr], acc[1][2 * rr + 1]},
                               {acc[2][2 * rr], acc[2][2 * rr + 1]}};
        const Gates2 gt = gates2(in[rr], p);
        const float2 hm = sh2(hs + (g + 8 * rr) * stride + h);
        const float hme[2] = {c[rr].m * hm.x, c[rr].m * hm.y};
#pragma unroll
        for (int e = 0; e < 2; ++e)
          out[e] = c[rr].m * ((1.f - gt.z[e]) * gt.n[e] + gt.z[e] * hme[e]);
      }
      if (c[rr].cell >= 0) st2(eo + c[rr].cell * H + h, out[0], out[1]);
      lgp[rr] = fma((double)out[1], (double)we.y, fma((double)out[0], (double)we.x, lgp[rr]));
    }
    if (u + 1 == chunks) {  // lg: the four lanes of a row, a fixed tree
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        double v = lgp[rr];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0 && c[rr].cell >= 0) lg[c[rr].cell] = (float)v;
      }
    }
  };
  auto dead = [&](int c0) {
    zero_rows(eo, q, ncell, c0, kTile, H, threadIdx.x, kThreads);
    if (threadIdx.x < kTile && c0 + threadIdx.x < ncell) lg[q * ncell + c0 + threadIdx.x] = 0.f;
  };
  for_cta_tile(he, whh, mask, q, ncell, H, chunks, step, dead);
  row_col_sums(he, mask, q, na, nt, H, rs, cs, blockIdx.y, gridDim.y);
}

// d h_e = mask * (go * z + d gh @ w_hh^T + g_rs[i] + g_cs[j]) (kGather: g_rs
// = d es at da, g_cs = -d es at dn).  Grid as round_fwd_kernel's.  A warp
// holds kDheTiles n tiles (8 columns each) of d h_e; where H/8 is more, the
// chunks run once a pass of columns.
template <bool kGather, class E>
__global__ void __launch_bounds__(kThreads)
round_dh_kernel(const E* __restrict__ he, const GateSrcT<E> gsrc, const float* __restrict__ whh,
                const float* __restrict__ bhh, const float* __restrict__ web,
                const float* __restrict__ mask, const E* __restrict__ geo,
                const float* __restrict__ grs, const float* __restrict__ gcs,
                const float* __restrict__ glg, E* __restrict__ dhe, float* __restrict__ dgs,
                int na, int nt, int H, float sign) {
  const int64_t q = blockIdx.x;
  const int ncell = na * nt, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int stride = tile_stride<E>(H), chunks = H / kChunk;
  const int passes = (chunks + kDheTiles - 1) / kDheTiles;
  const int per_pass = (chunks + passes - 1) / passes;
  CellT<E> c[2];
  float gl[2];
  float acc[kDheTiles][4];
  auto step = [&](const E* hs, const float* slab, int s, int w0, bool live) {
    const int u = s % chunks, n0 = (s / chunks) * per_pass, ncount = min(per_pass, chunks - n0);
    if (!live) {
      if (s == 0) zero_rows(dhe, q, ncell, w0, kRows, H, lane, 32);
      return;
    }
    if (s == 0) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        c[rr] = cell_at<kGather>(gsrc, mask, q, na, nt, H, w0 + g + 8 * rr);
        gl[rr] = c[rr].m != 0.f ? glg[c[rr].cell] : 0.f;
      }
    }
    if (u == 0) {
#pragma unroll
      for (int n = 0; n < kDheTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    }
    const int h = u * kChunk + 2 * t;
    const float2 we = ld2(web + h);
    const float wee[2] = {we.x, we.y};
    const GateIn in[2] = {gate_in<kGather>(gsrc, c[0], bhh, H, h, sign),
                          gate_in<kGather>(gsrc, c[1], bhh, H, h, sign)};
    float2 ge[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      ge[rr] = c[rr].m != 0.f ? ld2(geo + c[rr].cell * H + h) : make_float2(0.f, 0.f);
    float gh[3][4];
    gate_chunk(hs, stride, slab, H, lane, c[0].m, c[1].m, gh);
    float dgh[3][4], direct[4], dn[4], eg[4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        dgh[0][2 * rr + e] = dgh[1][2 * rr + e] = dgh[2][2 * rr + e] = direct[2 * rr + e] =
            dn[2 * rr + e] = eg[2 * rr + e] = 0.f;
      if (c[rr].m == 0.f) continue;
      const float p[3][2] = {{gh[0][2 * rr], gh[0][2 * rr + 1]},
                             {gh[1][2 * rr], gh[1][2 * rr + 1]},
                             {gh[2][2 * rr], gh[2][2 * rr + 1]}};
      const Gates2 gt = gates2(in[rr], p);
      const float2 hm = sh2(hs + (g + 8 * rr) * stride + h);
      const float hme[2] = {c[rr].m * hm.x, c[rr].m * hm.y}, gee[2] = {ge[rr].x, ge[rr].y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float z = gt.z[e], n = gt.n[e], r = gt.r[e];
        const float go = (gee[e] + gl[rr] * wee[e]) * c[rr].m;
        const float d_n = go * (1.f - z) * (1.f - n * n);
        dgh[0][2 * rr + e] = d_n * gt.ghn[e] * r * (1.f - r);
        dgh[1][2 * rr + e] = go * (hme[e] - n) * z * (1.f - z);
        dgh[2][2 * rr + e] = d_n * r;
        direct[2 * rr + e] = go * z;
        dn[2 * rr + e] = d_n;
        eg[2 * rr + e] = c[rr].m * ((1.f - z) * n + z * hme[e]) * gl[rr];
      }
    }
    // the first pass leaves the chunk's [d pre_r | d pre_z | d pre_n r |
    // d pre_n | edge_out g_lg] of each live cell to the weight-gradient
    // kernels
    if (s < chunks) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (c[rr].m == 0.f) continue;  // read as 0 by the mask
        float* d = dgs + (c[rr].cell * chunks + u) * kDgs + 2 * t;
        const int i = 2 * rr;
        *(float2*)(d) = make_float2(dgh[0][i], dgh[0][i + 1]);
        *(float2*)(d + kChunk) = make_float2(dgh[1][i], dgh[1][i + 1]);
        *(float2*)(d + 2 * kChunk) = make_float2(dgh[2][i], dgh[2][i + 1]);
        *(float2*)(d + 3 * kChunk) = make_float2(dn[i], dn[i + 1]);
        *(float2*)(d + 4 * kChunk) = make_float2(eg[i], eg[i + 1]);
      }
    }
    // the direct term lands on d h_e's n tile u (a select on every tile: an
    // indexed add would put the accumulators in local memory)
#pragma unroll
    for (int n = 0; n < kDheTiles; ++n) {
      const bool here = n == u - n0;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[n][k] += here ? direct[k] : 0.f;
    }
    // d h_e += d gh (this chunk's 24 columns) @ w_hh[:, those]^T: the
    // accumulator's columns 2t, 2t + 1 are the A fragment's k slots t, t + 4
    // (f32) or 2t, 2t + 1 (bf16: gates r | z as one k step of 16, n as one
    // with its upper 8 zero)
    if constexpr (IsBf16<E>::value) {
      const uint32_t* aw = (const uint32_t*)(slab + slab_floats(H));  // [3][H][4 words]
      const uint32_t arz[4] = {pack_bf16(dgh[0][0], dgh[0][1]), pack_bf16(dgh[0][2], dgh[0][3]),
                               pack_bf16(dgh[1][0], dgh[1][1]), pack_bf16(dgh[1][2], dgh[1][3])};
      const uint32_t an[4] = {pack_bf16(dgh[2][0], dgh[2][1]), pack_bf16(dgh[2][2], dgh[2][3]),
                              0u, 0u};
#pragma unroll
      for (int n = 0; n < kDheTiles; ++n) {
        if (n >= ncount) continue;
        const int hrow = (n0 + n) * kChunk + g;
        const uint32_t brz[2] = {aw[hrow * 4 + t], aw[(H + hrow) * 4 + t]};
        const uint32_t bn[2] = {aw[(2 * H + hrow) * 4 + t], 0u};
        mma_bf16(acc[n], arz, brz);
        mma_bf16(acc[n], an, bn);
      }
    } else {
      const float* small = slab + slab_floats(H);
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        const FragA a = frag_a(dgh[gate][0], dgh[gate][2], dgh[gate][1], dgh[gate][3]);
#pragma unroll
        for (int n = 0; n < kDheTiles; ++n) {
          if (n >= ncount) continue;
          const int i = (gate * H + (n0 + n) * kChunk + g) * kChunk + 2 * t;
          const float2 bb = *(const float2*)(slab + i), bs = *(const float2*)(small + i);
          FragB b;
          b.big[0] = __float_as_uint(bb.x);
          b.big[1] = __float_as_uint(bb.y);
          b.small[0] = __float_as_uint(bs.x);
          b.small[1] = __float_as_uint(bs.y);
          mma3(acc[n], a, b);
        }
      }
    }
    if (u + 1 < chunks) return;
#pragma unroll
    for (int n = 0; n < kDheTiles; ++n) {
      if (n >= ncount) continue;
      const int hh = (n0 + n) * kChunk + 2 * t;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (c[rr].cell < 0) continue;
        float2 v = make_float2(0.f, 0.f);
        if (c[rr].m != 0.f) {
          const float2 a = ld2(grs + c[rr].da * H + hh), b = ld2(gcs + c[rr].dn * H + hh);
          const float m = c[rr].m;
          if constexpr (kGather) {
            v = make_float2(m * ((acc[n][2 * rr] + a.x) + -b.x),
                            m * ((acc[n][2 * rr + 1] + a.y) + -b.y));
          } else {
            v = make_float2(m * ((acc[n][2 * rr] + a.x) + b.x),
                            m * ((acc[n][2 * rr + 1] + a.y) + b.y));
          }
        }
        st2(dhe + c[rr].cell * H + hh, v.x, v.y);
      }
    }
  };
  auto dead = [&](int c0) { zero_rows(dhe, q, ncell, c0, kTile, H, threadIdx.x, kThreads); };
  for_cta_tile(he, whh, mask, q, ncell, H, passes * chunks, step, dead);
}

// d w_hh = he_m^T @ d gh, split over K (the cells): grid (P * ksplit,
// output tiles).  CTA (q * ksplit + s, o) sums split s of block q's cell
// tiles (consecutive tiles of kTile cells) into output tile o: rows (h) of
// a kDwRows block, columns of a kDwCols block of [H, 3H], one 16-row m tile
// a warp; its entries of the partials row part[q * ksplit + s] = [H*3H].
// d gh comes from the scratch dgs that round_dh_kernel wrote for its live
// tiles; a masked cell reads as 0 (select), whatever the scratch holds.
template <class E>
__global__ void __launch_bounds__(kThreads)
round_dw_kernel(const E* __restrict__ he, const float* __restrict__ mask,
                const float* __restrict__ dgs, float* __restrict__ part, int na, int nt, int H,
                int ksplit) {
  extern __shared__ float4 smem4[];
  float* a_s = (float*)smem4;                  // [2][kTile][kAStride]: h_e of the rows
  float* b_s = a_s + 2 * kTile * kAStride;     // [2][kTile][kBStride]: d gh of the columns
  float* mask_s = b_s + 2 * kTile * kBStride;  // [2][kTile]
  const int64_t q = blockIdx.x / ksplit;
  const int split = blockIdx.x % ksplit, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, H3 = 3 * H, chunks = H / kChunk;
  const int nblocks = (H3 + kDwCols - 1) / kDwCols;
  const int h_base = (blockIdx.y / nblocks) * kDwRows, c_base = (blockIdx.y % nblocks) * kDwCols;
  const int hcount = min(kDwRows, H - h_base);
  const int ncell = na * nt, ntiles = (ncell + kTile - 1) / kTile;
  const int per = (ntiles + ksplit - 1) / ksplit;
  const int first = split * per, last = min(first + per, ntiles);
  constexpr int kPer = 16 / sizeof(E);  // elements of h_e a 16-byte piece
  const auto stage = [&](int b, int c0, int len) {  // live cells only
    const float* m_s = mask_s + b * kTile;
    E* a = (E*)a_s + b * kTile * kAStride;  // bf16: half the region, the same stride
    for (int e = tid; e < kTile * (kDwRows / kPer); e += kThreads) {
      const int r = e / (kDwRows / kPer), p = e % (kDwRows / kPer);
      const bool valid = r < len && kPer * p < hcount && m_s[r] != 0.f;
      cp_async16((float*)(a + r * kAStride + kPer * p),
                 (const float*)(valid ? he + (q * ncell + c0 + r) * (int64_t)H + h_base + kPer * p
                                      : he),
                 valid);
    }
    float* bb = b_s + b * kTile * kBStride;
    for (int e = tid; e < kTile * (kDwCols / 4); e += kThreads) {
      const int r = e / (kDwCols / 4), p = e % (kDwCols / 4);
      const int col = c_base + 4 * p, col8 = col & ~7;  // the n tile's first column
      const bool valid = r < len && col < H3 && m_s[r] != 0.f;
      const int gate = col8 / H, unit = col8 - gate * H;
      cp_async16(bb + r * kBStride + 4 * p,
                 valid ? dgs + ((q * ncell + c0 + r) * chunks + unit / kChunk) * kDgs
                             + gate * kChunk + (col - col8)
                       : dgs,
                 valid);
    }
  };
  float acc[kDwCols / 8][4];
#pragma unroll
  for (int n = 0; n < kDwCols / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int hl = warp * 16 + g;  // this thread's rows hl, hl + 8 of the tile
  const bool lo_ok = hl < hcount, hi_ok = hl + 8 < hcount;

  float m_next = first < last ? tile_mask(mask, q, ncell, first * kTile,
                                          min(kTile, ncell - first * kTile)) : 0.f;
  bool live = false;
  for (int tile = first; tile <= last; ++tile) {
    // stage tile (if live), then compute the one before
    const int b = (tile - first) & 1;
    bool live_here = false;
    if (tile < last) {
      const int c0 = tile * kTile, len = min(kTile, ncell - c0);
      live_here = cta_tile_live(m_next, mask_s + b * kTile);
      if (live_here) stage(b, c0, len);
      if (tile + 1 < last)
        m_next = tile_mask(mask, q, ncell, c0 + kTile, min(kTile, ncell - c0 - kTile));
    }
    cp_async_commit();
    if (tile > first && live) {
      const int pb = b ^ 1;
      cp_async_wait<1>();
      __syncthreads();
      const float* bb = b_s + pb * kTile * kBStride;
      const float* m_s = mask_s + pb * kTile;
      const auto mk = [](float m, float x) { return m != 0.f ? m * x : 0.f; };
      if constexpr (IsBf16<E>::value) {
        // k steps of 16 cells: cells k0 + 2t, + 1 and k0 + 2t + 8, + 9
        const bf16* a = (const bf16*)a_s + pb * kTile * kAStride;
        for (int k0 = 0; lo_ok && k0 < kTile; k0 += 16) {
          const int cl[4] = {k0 + 2 * t, k0 + 2 * t + 1, k0 + 2 * t + 8, k0 + 2 * t + 9};
          float mm[4], lo[4], hi[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            mm[i] = m_s[cl[i]];
            lo[i] = mk(mm[i], __bfloat162float(a[cl[i] * kAStride + hl]));
            hi[i] = hi_ok ? mk(mm[i], __bfloat162float(a[cl[i] * kAStride + hl + 8])) : 0.f;
          }
          const uint32_t fa[4] = {pack_bf16(lo[0], lo[1]), pack_bf16(hi[0], hi[1]),
                                  pack_bf16(lo[2], lo[3]), pack_bf16(hi[2], hi[3])};
#pragma unroll
          for (int n = 0; n < kDwCols / 8; ++n) {
            float v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[i] = mm[i] != 0.f ? bb[cl[i] * kBStride + 8 * n + g] : 0.f;
            const uint32_t fb[2] = {pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3])};
            mma_bf16(acc[n], fa, fb);
          }
        }
      } else if (lo_ok) {
        const float* a = (const float*)a_s + pb * kTile * kAStride;
        for (int k0 = 0; k0 < kTile; k0 += 8) {
          const float m0 = m_s[k0 + t], m1 = m_s[k0 + t + 4];
          const float* a0 = a + (k0 + t) * kAStride + hl;
          const float* a1 = a0 + 4 * kAStride;
          const FragA fa = frag_a(mk(m0, a0[0]), hi_ok ? mk(m0, a0[8]) : 0.f, mk(m1, a1[0]),
                                  hi_ok ? mk(m1, a1[8]) : 0.f);
          const float* b0 = bb + (k0 + t) * kBStride + g;
#pragma unroll
          for (int n = 0; n < kDwCols / 8; ++n)
            mma3(acc[n], fa, frag_b(m0 != 0.f ? b0[8 * n] : 0.f,
                                    m1 != 0.f ? b0[4 * kBStride + 8 * n] : 0.f));
        }
      }
    }
    __syncthreads();  // the buffer computed on is staged next
    live = live_here;
  }
  cp_async_wait<0>();
  float* prow = part + (int64_t)blockIdx.x * H * H3;
#pragma unroll
  for (int n = 0; n < kDwCols / 8; ++n) {
    const int col = c_base + 8 * n + 2 * t;
    if (col >= H3) continue;
    if (lo_ok)
      *(float2*)(prow + (int64_t)(h_base + hl) * H3 + col) = make_float2(acc[n][0], acc[n][1]);
    if (hi_ok)
      *(float2*)(prow + (int64_t)(h_base + hl + 8) * H3 + col) =
          make_float2(acc[n][2], acc[n][3]);
  }
}

// The sums of d gh's scratch over cells: for kSumRows rows (q, i) and a
// scratch column, each over j: d ga [P, na, 3H] (d pre_r | d pre_z |
// d pre_n) and the rows' part of the biases' gradients rsum [P*ceil(na /
// kSumRows), 4H or 7H] = [d pre_r | d pre_z | d pre_n r | edge_out g_lg (|
// d pre_r | d pre_z | d pre_n)]; for each column (q, j), over i: d gb =
// sign * (d pre_r | d pre_z | d pre_n).  Masked cells read as 0.  Each sum
// runs in cell order.
template <bool kGather, class E>
__global__ void __launch_bounds__(256)
round_sums_kernel(const float* __restrict__ mask, const float* __restrict__ dgs,
                  E* __restrict__ dga, E* __restrict__ dgb, float* __restrict__ rsum,
                  int P, int na, int nt, int H, float sign) {
  const int chunks = H / kChunk, ncell = na * nt, H3 = 3 * H;
  const int64_t id = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int groups = (na + kSumRows - 1) / kSumRows;
  const int64_t nrow = (int64_t)P * groups * chunks * kDgs;
  if (id < nrow) {
    const int k = (int)(id % kDgs);
    int64_t r = id / kDgs;
    const int u = (int)(r % chunks);
    r /= chunks;
    const int grp = (int)(r % groups);
    const int64_t q = r / groups;
    const int kind = k / kChunk, unit = u * kChunk + k % kChunk;
    float total = 0.f;
    for (int i = grp * kSumRows; i < min(na, grp * kSumRows + kSumRows); ++i) {
      const float* m = mask + q * ncell + (int64_t)i * nt;
      const float* x = dgs + ((q * ncell + (int64_t)i * nt) * chunks + u) * kDgs + k;
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < nt; ++j) acc += *masked(m + j, x + (int64_t)j * chunks * kDgs);
      total += acc;
      E* ga = dga + (q * na + i) * H3;
      if (kind < 2) st1(ga + kind * H + unit, acc);         // d pre_r, d pre_z
      else if (kind == 3) st1(ga + 2 * H + unit, acc);      // d pre_n
    }
    float* rs = rsum + (q * groups + grp) * (kGather ? 7 * H : 4 * H);
    if (kind < 2) {
      rs[kind * H + unit] = total;
      if (kGather) rs[(4 + kind) * H + unit] = total;
    } else if (kind == 2) {
      rs[2 * H + unit] = total;
    } else if (kind == 3) {
      if (kGather) rs[6 * H + unit] = total;
    } else {
      rs[3 * H + unit] = total;
    }
    return;
  }
  const int64_t c = id - nrow;
  if (c >= (int64_t)P * nt * chunks * 3 * kChunk) return;
  const int k = (int)(c % (3 * kChunk));
  int64_t r = c / (3 * kChunk);
  const int u = (int)(r % chunks);
  r /= chunks;
  const int j = (int)(r % nt);
  const int64_t q = r / nt;
  const float* m = mask + q * ncell + j;
  const float* x = dgs + ((q * ncell + j) * chunks + u) * kDgs + (k < 2 * kChunk ? k : k + kChunk);
  float acc = 0.f;
#pragma unroll 8
  for (int i = 0; i < na; ++i)
    acc += *masked(m + (int64_t)i * nt, x + (int64_t)i * nt * chunks * kDgs);
  st1(dgb + (q * nt + j) * H3 + (k / kChunk) * H + u * kChunk + k % kChunk, sign * acc);
}

// out[k] = the sum over rows q of part[q][k] (width columns, rows rows),
// for two such arrays in one launch (CTAs from split on take the second):
// group s of a CTA sums rows s, s + kSumGroups, ... in order, then the
// groups are summed in order.
__global__ void __launch_bounds__(32 * kSumGroups)
sum_partials_kernel(const float* __restrict__ part_a, float* __restrict__ out_a, int rows_a,
                    int width_a, const float* __restrict__ part_b, float* __restrict__ out_b,
                    int rows_b, int width_b, int split) {
  __shared__ float red[kSumGroups][32];
  const bool second = (int)blockIdx.x >= split;
  const float* part = second ? part_b : part_a;
  float* out = second ? out_b : out_a;
  const int rows = second ? rows_b : rows_a, width = second ? width_b : width_a;
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int k = ((int)blockIdx.x - (second ? split : 0)) * 32 + lane;
  float acc = 0.f;
  if (k < width) {
#pragma unroll 8
    for (int q = grp; q < rows; q += kSumGroups) acc += part[(int64_t)q * width + k];
  }
  red[grp][lane] = acc;
  __syncthreads();
  if (grp == 0 && k < width) {
    float s = 0.f;
    for (int gg = 0; gg < kSumGroups; ++gg) s += red[gg][lane];
    out[k] = s;
  }
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

// A device's side stream for the backward's cell sums, which run beside the
// d w_hh product; joined to the caller's stream by two events.
struct SideStream {
  cudaStream_t stream;
  cudaEvent_t fork, join;
};
SideStream sides[64];

// Once a device: every round kernel may take the shared memory it needs at
// the widest H; the side stream and its events.
cudaError_t configure_rounds() {
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  SideStream& side = sides[dev];
  err = cudaStreamCreateWithFlags(&side.stream, cudaStreamNonBlocking);
  if (err == cudaSuccess) err = cudaEventCreateWithFlags(&side.fork, cudaEventDisableTiming);
  if (err == cudaSuccess) err = cudaEventCreateWithFlags(&side.join, cudaEventDisableTiming);
  if (err != cudaSuccess) return err;
  const void* kernels[] = {
      (const void*)round_fwd_kernel<false, float>, (const void*)round_fwd_kernel<true, float>,
      (const void*)round_dh_kernel<false, float>,  (const void*)round_dh_kernel<true, float>,
      (const void*)round_fwd_kernel<false, bf16>,  (const void*)round_dh_kernel<false, bf16>,
      (const void*)round_dw_kernel<float>,         (const void*)round_dw_kernel<bf16>};
  const size_t bytes[] = {tile_smem<float>(kMaxH), tile_smem<float>(kMaxH),
                          tile_smem<float>(kMaxH), tile_smem<float>(kMaxH),
                          tile_smem<bf16>(kMaxH),  tile_smem<bf16>(kMaxH),
                          dw_smem(),               dw_smem()};
  for (int k = 0; k < 8; ++k) {
    err = cudaFuncSetAttribute(kernels[k], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes[k]);
    if (err != cudaSuccess) return err;
  }
  done[dev] = true;
  return cudaSuccess;
}

bool round_width_ok(int na, int nt, int H) {
  return na > 0 && nt > 0 && H >= kChunk && H <= kMaxH && H % kChunk == 0;
}

// the forward's and d h_e's grid: (P, a block's tiles)
dim3 round_grid(int P, int na, int nt) { return dim3(P, (na * nt + kTile - 1) / kTile); }

template <bool kGather, class E>
cudaError_t launch_fwd(const E* he, const GateSrcT<E>& g, const float* whh, const float* bhh,
                       const float* web, const float* mask, E* eo, float* rs, float* cs,
                       float* lg, int P, int na, int nt, int H, float sign, cudaStream_t s) {
  const cudaError_t err = configure_rounds();
  if (err != cudaSuccess) return err;
  round_fwd_kernel<kGather, E><<<round_grid(P, na, nt), kThreads, tile_smem<E>(H), s>>>(
      he, g, whh, bhh, web, mask, eo, rs, cs, lg, na, nt, H, sign);
  return cudaGetLastError();
}

// d h_e and the d gh scratch; d w_hh's partials and, on the side stream at
// the same time, the cell sums (d ga, d gb, the biases' row parts); then the
// partials and the row parts summed into dw = [d w_hh | d b_hh | d w_eb (|
// d b_ih)]
template <bool kGather, class E>
cudaError_t launch_bwd(const E* he, const GateSrcT<E>& g, const float* whh, const float* bhh,
                       const float* web, const float* mask, const E* geo, const float* grs,
                       const float* gcs, const float* glg, E* dhe, E* dga, E* dgb,
                       float* dgs, float* wpart, int ksplit, float* rsum, float* dw, int P,
                       int na, int nt, int H, float sign, cudaStream_t s) {
  cudaError_t err = configure_rounds();
  if (err != cudaSuccess) return err;
  round_dh_kernel<kGather, E><<<round_grid(P, na, nt), kThreads, tile_smem<E>(H), s>>>(
      he, g, whh, bhh, web, mask, geo, grs, gcs, glg, dhe, dgs, na, nt, H, sign);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const SideStream& side = sides[dev];
  err = cudaEventRecord(side.fork, s);
  if (err == cudaSuccess) err = cudaStreamWaitEvent(side.stream, side.fork, 0);
  if (err != cudaSuccess) return err;
  const int groups = (na + kSumRows - 1) / kSumRows;
  const int64_t items = (int64_t)P * (groups * 5 + nt * 3) * H;
  round_sums_kernel<kGather, E><<<(unsigned)((items + 255) / 256), 256, 0, side.stream>>>(
      mask, dgs, dga, dgb, rsum, P, na, nt, H, sign);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaEventRecord(side.join, side.stream);
  if (err != cudaSuccess) return err;
  const int H3 = 3 * H;
  const dim3 dw_grid(P * ksplit, ((H + kDwRows - 1) / kDwRows) * ((H3 + kDwCols - 1) / kDwCols));
  round_dw_kernel<E><<<dw_grid, kThreads, dw_smem(), s>>>(he, mask, dgs, wpart, na, nt, H,
                                                          ksplit);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaStreamWaitEvent(s, side.join, 0);
  if (err != cudaSuccess) return err;
  const int rw = kGather ? 7 * H : 4 * H, split = (H * H3 + 31) / 32;
  sum_partials_kernel<<<split + (rw + 31) / 32, 32 * kSumGroups, 0, s>>>(
      wpart, dw, P * ksplit, H * H3, rsum, dw + H * H3, P * groups, rw, split);
  return cudaGetLastError();
}

}  // namespace

// h_e: f32[P, na, nt, H]; ga: f32[P, na, 3H]; gb: f32[P, nt, 3H];
// w_hh: f32[H, 3H]; b_hh: f32[3H]; w_eb: f32[H]; mask: f32[P, na, nt];
// out: edge_out f32[P, na, nt, H], rs f32[P, na, H], cs f32[P, nt, H],
// lg f32[P, na, nt].  H a multiple of 8 from 8 to 256 (else
// cudaErrorInvalidValue).
extern "C" int tm_block_round_fwd(const void* he, const void* ga, const void* gb,
                                  const void* whh, const void* bhh, const void* web,
                                  const void* mask, void* eo, void* rs, void* cs, void* lg,
                                  int P, int na, int nt, int H, float sign, void* stream) {
  if (P == 0 || na == 0 || nt == 0) return (int)cudaSuccess;
  if (!round_width_ok(na, nt, H)) return (int)cudaErrorInvalidValue;
  const GateSrc g{(const float*)ga, (const float*)gb, nullptr, nullptr, nullptr, 1, 0};
  return (int)launch_fwd<false>((const float*)he, g, (const float*)whh, (const float*)bhh,
                                (const float*)web, (const float*)mask, (float*)eo, (float*)rs,
                                (float*)cs, (float*)lg, P, na, nt, H, sign,
                                (cudaStream_t)stream);
}

// Inputs as tm_block_round_fwd plus the cotangents g_eo, g_rs, g_cs, g_lg
// (shapes of edge_out, rs, cs, lg).  Writes d h_e, d ga, d gb (shapes of
// h_e, ga, gb) and dw f32[H*3H + 4H] = [d w_hh (H x 3H) | d b_hh (3H) |
// d w_eb (H)], with the scratch dgs f32[P*na*nt*5H], wpart f32[P*ksplit,
// H*3H] (ksplit >= 1 splits of a block's cells) and rsum f32[P*ceil(na/4),
// 4H].
extern "C" int tm_block_round_bwd(const void* he, const void* ga, const void* gb,
                                  const void* whh, const void* bhh, const void* web,
                                  const void* mask, const void* geo, const void* grs,
                                  const void* gcs, const void* glg, void* dhe, void* dga,
                                  void* dgb, void* dgs, void* wpart, void* rsum, void* dw,
                                  int ksplit, int P, int na, int nt, int H, float sign,
                                  void* stream) {
  if (P == 0 || na == 0 || nt == 0) return (int)cudaSuccess;
  if (!round_width_ok(na, nt, H)) return (int)cudaErrorInvalidValue;
  const GateSrc g{(const float*)ga, (const float*)gb, nullptr, nullptr, nullptr, 1, 0};
  return (int)launch_bwd<false>((const float*)he, g, (const float*)whh, (const float*)bhh,
                                (const float*)web, (const float*)mask, (const float*)geo,
                                (const float*)grs, (const float*)gcs, (const float*)glg,
                                (float*)dhe, (float*)dga, (float*)dgb, (float*)dgs,
                                (float*)wpart, ksplit, (float*)rsum, (float*)dw, P, na, nt, H,
                                sign, (cudaStream_t)stream);
}

// The bf16 round: tm_block_round_fwd with h_e, ga, gb and edge_out bf16
// (the other inputs and rs, cs, lg f32).
extern "C" int tm_block_round_fwd_bf16(const void* he, const void* ga, const void* gb,
                                       const void* whh, const void* bhh, const void* web,
                                       const void* mask, void* eo, void* rs, void* cs, void* lg,
                                       int P, int na, int nt, int H, float sign, void* stream) {
  if (P == 0 || na == 0 || nt == 0) return (int)cudaSuccess;
  if (!round_width_ok(na, nt, H)) return (int)cudaErrorInvalidValue;
  const GateSrcT<bf16> g{(const bf16*)ga, (const bf16*)gb, nullptr, nullptr, nullptr, 1, 0};
  return (int)launch_fwd<false, bf16>((const bf16*)he, g, (const float*)whh, (const float*)bhh,
                                      (const float*)web, (const float*)mask, (bf16*)eo,
                                      (float*)rs, (float*)cs, (float*)lg, P, na, nt, H, sign,
                                      (cudaStream_t)stream);
}

// The bf16 round's backward: tm_block_round_bwd with h_e, ga, gb, g_eo and
// d h_e, d ga, d gb bf16 (dw, the cotangents g_rs, g_cs, g_lg and the
// scratch f32, as there).
extern "C" int tm_block_round_bwd_bf16(const void* he, const void* ga, const void* gb,
                                       const void* whh, const void* bhh, const void* web,
                                       const void* mask, const void* geo, const void* grs,
                                       const void* gcs, const void* glg, void* dhe, void* dga,
                                       void* dgb, void* dgs, void* wpart, void* rsum, void* dw,
                                       int ksplit, int P, int na, int nt, int H, float sign,
                                       void* stream) {
  if (P == 0 || na == 0 || nt == 0) return (int)cudaSuccess;
  if (!round_width_ok(na, nt, H)) return (int)cudaErrorInvalidValue;
  const GateSrcT<bf16> g{(const bf16*)ga, (const bf16*)gb, nullptr, nullptr, nullptr, 1, 0};
  return (int)launch_bwd<false, bf16>(
      (const bf16*)he, g, (const float*)whh, (const float*)bhh, (const float*)web,
      (const float*)mask, (const bf16*)geo, (const float*)grs, (const float*)gcs,
      (const float*)glg, (bf16*)dhe, (bf16*)dga, (bf16*)dgb, (float*)dgs, (float*)wpart, ksplit,
      (float*)rsum, (float*)dw, P, na, nt, H, sign, (cudaStream_t)stream);
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
  if (!round_width_ok(na, nt, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const GateSrc g{(const float*)gad, (const float*)gbd, (const float*)bih,
                  (const int32_t*)act, (const int32_t*)nw, B, capD};
  cudaError_t err = launch_fwd<true>((const float*)he, g, (const float*)whh, (const float*)bhh,
                                     (const float*)web, (const float*)mask, (float*)eo,
                                     (float*)rs, (float*)cs, (float*)lg, P, na, nt, H, sign, s);
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)B * capD * H;
  incidence_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const float*)rs, (const float*)cs, (const int32_t*)inc_ptr, (const int32_t*)inc_slot,
      na, nt, P, B * capD, H, (float*)es, nullptr);
  return (int)cudaGetLastError();
}

// The es round's backward.  Inputs as tm_block_round_es_fwd plus the
// cotangents geo (of edge_out), glg (of lg) and ges f32[B*capD, H] (of es).
// Writes d h_e, dw f32[H*3H + 7H] = [d w_hh | d b_hh | d w_eb | d b_ih] and
// d ga_d, d gb_d f32[B*capD, 3H], with the scratch d ga f32[P, na, 3H], d gb
// f32[P, nt, 3H], dgs, wpart and rsum f32[P*ceil(na/4), 7H] as
// tm_block_round_bwd's.
// P, na, nt > 0.
extern "C" int tm_block_round_es_bwd(const void* he, const void* act, const void* nw,
                                     const void* gad, const void* gbd, const void* bih,
                                     const void* whh, const void* bhh, const void* web,
                                     const void* mask, const void* inc_ptr,
                                     const void* inc_slot, const void* geo, const void* glg,
                                     const void* ges, void* dhe, void* dga, void* dgb,
                                     void* dgs, void* wpart, void* rsum, void* dw, void* dgad,
                                     void* dgbd, int ksplit, int P,
                                     int na, int nt, int H, int B, int capD, float sign,
                                     void* stream) {
  if (!round_width_ok(na, nt, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const GateSrc g{(const float*)gad, (const float*)gbd, (const float*)bih,
                  (const int32_t*)act, (const int32_t*)nw, B, capD};
  cudaError_t err = launch_bwd<true>(
      (const float*)he, g, (const float*)whh, (const float*)bhh, (const float*)web,
      (const float*)mask, (const float*)geo, (const float*)ges, (const float*)ges,
      (const float*)glg, (float*)dhe, (float*)dga, (float*)dgb, (float*)dgs, (float*)wpart,
      ksplit, (float*)rsum, (float*)dw, P, na, nt, H, sign, s);
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
