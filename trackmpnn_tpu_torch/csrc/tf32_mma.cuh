// Split-TF32 tensor-core products (mma.sync and wgmma) and cp.async staging,
// shared by the kernels that run f32 products on the tensor cores
// (block_kernels.cu: the block round; mp_kernels.cu: the served edge GRU;
// round_kernels.cu: the fused round; dcn_kernels.cu: the deformable
// convolution's forward and d weight).
// ops/_build.py rebuilds a library when this header is newer than it.
//
// 3xTF32 (CUTLASS's name for the scheme): x = big + small, big = tf32(x)
// (round to nearest on the int32 view, ties away: (bits + 0x1000) &
// ~0x1fff), small = tf32(x - big) (x - big is exact), and a*b ~ a.small*b.big
// + a.big*b.small + a.big*b.big.  tf32 products are exact in f32; what is
// dropped (a.small*b.small, the rounding of the smalls) is below 2^-22 |a b|
// a product.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// ------------------------------------------------------------ 3xTF32 mma ----
// x rounded to tf32 (10 explicit mantissa bits) to nearest, ties away from
// zero, on the int32 view; the low 13 bits 0.
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

struct FragA {  // the A fragment of m16n8k8 .tf32, split
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  const float b = tf32_round(x);
  big = __float_as_uint(b);
  small = __float_as_uint(tf32_round(x - b));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: the two cross terms, then big * big.  The tensor
// cores add the products of an mma into its accumulator without rounding to
// nearest (the low bits are cut), an error that grows with every mma into
// the same sum; so each k step goes to a fresh accumulator, and the CUDA
// cores add it to c in f32, rounded to nearest.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(s, a.small, b.big);
  mma_tf32(s, a.big, b.small);
  mma_tf32(s, a.big, b.big);
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] += s[k];
}

// A fragment from four values: rows g, g + 8 (lo, hi) at k slots t (x) and
// t + 4 (y)
__device__ __forceinline__ FragA frag_a(float lo_x, float hi_x, float lo_y, float hi_y) {
  FragA a;
  split_tf32(lo_x, a.big[0], a.small[0]);
  split_tf32(hi_x, a.big[1], a.small[1]);
  split_tf32(lo_y, a.big[2], a.small[2]);
  split_tf32(hi_y, a.big[3], a.small[3]);
  return a;
}

__device__ __forceinline__ FragB frag_b(float x, float y) {
  FragB b;
  split_tf32(x, b.big[0], b.small[0]);
  split_tf32(y, b.big[1], b.small[1]);
  return b;
}

// ------------------------------------------------------------- cp.async ----
// 16 bytes from src to shared dst; where !valid nothing is read and dst is
// zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
// 4 bytes likewise (through L1)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------------ wgmma (sm_90a) ----
// Descriptor of a K-major operand (A or B) in shared memory without
// swizzle: core matrices of 8 rows (m or n) x 16 bytes (4 tf32 along k), lbo
// bytes apart along k and sbo bytes apart along m or n.
__device__ __forceinline__ uint64_t wg_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  return (uint64_t)((a & 0x3ffff) >> 4) | ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N of this warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of d across the asm
// statements around it (the wgmma writes d asynchronously)
template <int M>
__device__ __forceinline__ void wg_hold(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ------------------------------------------- wgmma with A from registers ----
// d (+)= a b over one k step of 8: a 64 x 8 tf32 from registers (each warp
// of the warpgroup its 16 rows in the m16n8k8 A layout), b 8 x N from the
// descriptor; d in the m16n8 C layout a warp and n tile of 8 (d[4j + e]).
// acc false: d = a b.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc, bool acc);
template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4], const uint32_t (&a)[4],
                                               uint64_t desc, bool acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"((int)acc));
}
template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t desc, bool acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0,%1,%2,%3,%4,%5,%6,%7}, "
      "{%8,%9,%10,%11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"((int)acc));
}
template <>
__device__ __forceinline__ void wgmma_tf32<24>(float (&d)[12], const uint32_t (&a)[4],
                                               uint64_t desc, bool acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11}, "
      "{%12,%13,%14,%15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"((int)acc));
}
template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t desc, bool acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"((int)acc));
}
template <>
__device__ __forceinline__ void wgmma_tf32<48>(float (&d)[24], const uint32_t (&a)[4],
                                               uint64_t desc, bool acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23}, "
      "{%24,%25,%26,%27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"((int)acc));
}
template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc, bool acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"((int)acc));
}
template <>
__device__ __forceinline__ void wgmma_tf32<96>(float (&d)[48], const uint32_t (&a)[4],
                                               uint64_t desc, bool acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47}, "
      "{%48,%49,%50,%51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"((int)acc));
}

// d = a b in 3xTF32 into a fresh accumulator: a.small b.big, then + a.big
// b.small, then + a.big b.big
template <int N>
__device__ __forceinline__ void wgmma3(float (&d)[N / 2], const FragA& a, uint64_t desc_big,
                                       uint64_t desc_small) {
  wgmma_tf32<N>(d, a.small, desc_big, false);
  wgmma_tf32<N>(d, a.big, desc_small, true);
  wgmma_tf32<N>(d, a.big, desc_big, true);
}
