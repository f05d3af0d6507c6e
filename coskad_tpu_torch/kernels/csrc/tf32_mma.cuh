// Tensor-core helpers shared by the port's kernels (stse_fused.cu, stse_train.cu):
// TF32 and bf16 rounding, the m16n8k8 TF32 mma.sync, the m16n8k16 and
// m16n8k8 bf16 mma.sync, cp.async, the operand precisions of a product
// (3xTF32, or bf16 operands), and the warp tiles of both (16 rows each).
//
// Include after <cuda_runtime.h> and <stdint.h>. Under CUDA_HOST_EMU (the
// host emulation of tests/cuda_host_emu.h) the inline-PTX helpers are left
// out: the emulator supplies __nv_bfloat16, tf32_of, bf16_bits, pack_bf16x2,
// mma_tf32, mma_bf16_k16, mma_bf16_k8 and the cp.async calls.
#pragma once

#ifndef CUDA_HOST_EMU
#include <cuda_bf16.h>
#endif

namespace {

#ifndef CUDA_HOST_EMU
// cvt.rna.tf32.f32: the top 19 bits, rounded to nearest, ties away from zero.
__device__ __forceinline__ uint32_t tf32_of(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// d += a b on one 16 x 8 x 8 tile; the fragments in the PTX layout for
// m16n8k8 .tf32 (g = lane / 4, t = lane % 4): a = A[g][t], A[g+8][t],
// A[g][t+4], A[g+8][t+4]; b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// cvt.rn.bf16.f32: v rounded to bf16, to nearest even, as the bits of a
// float (the low 16 bits zero): a TF32 operand exactly.
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(h) : "f"(v));
  return (uint32_t)h << 16;
}

// cvt.rn.bf16x2.f32: lo and hi rounded to bf16 (to nearest even, the bits
// bf16_bits gives each), packed with lo in the low 16 bits: one register of
// a bf16 mma fragment, the element of the lower k in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d += a b on one 16 x 8 x 16 tile of bf16 operands with fp32 accumulators;
// the fragments in the PTX layout for m16n8k16 .bf16 (g = lane / 4, t =
// lane % 4), each register a pair along k: a = A[g][2t, 2t+1], A[g+8][2t,
// 2t+1], A[g][2t+8, 2t+9], A[g+8][2t+8, 2t+9]; b = B[2t, 2t+1][g], B[2t+8,
// 2t+9][g]; d as mma_tf32's.
__device__ __forceinline__ void mma_bf16_k16(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The same on a 16 x 8 x 8 tile (m16n8k8 .bf16): a = A[g][2t, 2t+1],
// A[g+8][2t, 2t+1]; b = B[2t, 2t+1][g].
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// cp.async of 16 or 4 bytes (fp32 or bf16 values) from device to shared memory.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
#endif

// 3xTF32: v = big + small to ~2^-22 relative, each part a TF32 value.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32_of(v);
  small = tf32_of(v - __uint_as_float(big));
}

// d += a b in ~fp32 accuracy: the small parts' products first, then big x big.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_small);
  mma_tf32(d, a_big, b_big);
}

// The operand precision of a batch-reduction product (stse_train.cu's
// product kernels, a template argument):
//   kOpF32   3xTF32: each operand split into TF32 big and small parts, three
//            mma per product, ~fp32 (split_tf32, mma_3xtf32);
//   kOpBF16  each operand rounded to bf16, exact products summed in fp32 on
//            the bf16 mma (mma_bf16_k16, mma_bf16_k8): the function of JAX's
//            bf16 dot with preferred_element_type f32. The per-window passes
//            take the same two routes through warp_tile and warp_tile_bf16.
enum OperandPrecision { kOpF32 = 0, kOpBF16 = 1 };

__host__ __device__ constexpr int round8(int v) { return (v + 7) & ~7; }

// A lane's values of the A fragment at rows [r0, r0 + 16) x columns [k0,
// k0 + 8), and its B fragment at [k0, k0 + 8) x [c0, c0 + 8) as 3xTF32
// parts, in the PTX layout (see mma_tf32).
template <class FA>
__device__ __forceinline__ void frag_a(const FA& a, int r0, int k0, float (&v)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  v[0] = a(r0 + g, k0 + t);
  v[1] = a(r0 + g + 8, k0 + t);
  v[2] = a(r0 + g, k0 + t + 4);
  v[3] = a(r0 + g + 8, k0 + t + 4);
}

template <class FB>
__device__ __forceinline__ void frag_b(const FB& b, int k0, int c0, uint32_t (&big)[2],
                                       uint32_t (&small)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  split_tf32(b(k0 + t, c0 + g), big[0], small[0]);
  split_tf32(b(k0 + t + 4, c0 + g), big[1], small[1]);
}

// acc[j] += A[r0, r0 + 16) x [0, K) . B[0, K) x [c0 + 8 j, c0 + 8 j + 8) for
// j < tiles <= NT as 3xTF32 (~fp32); K a multiple of 8, the loaders 0 past
// their operand's edge. Each A fragment is loaded once, for all the column
// tiles, and one step ahead, so its latency (L2 for M) runs under the step
// before.
template <int NT, class FA, class FB>
__device__ __forceinline__ void warp_tile(float (&acc)[NT][4], int r0, int K, int c0, int tiles,
                                          const FA& a, const FB& b) {
  float next[4];
  if (K > 0) frag_a(a, r0, 0, next);
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(next[i], ab[i], as[i]);
    if (k0 + 8 < K) frag_a(a, r0, k0 + 8, next);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= tiles) break;
      uint32_t bb[2], bs[2];
      frag_b(b, k0, c0 + 8 * j, bb, bs);
      mma_3xtf32(acc[j], ab, as, bb, bs);
    }
  }
}

// acc[j] += A[r0, r0 + 16) x [0, K) . B[0, K) x [c0 + 8 j, c0 + 8 j + 8) for
// j < tiles <= NT on the bf16 tensor cores: m16n8k16 steps, then one
// m16n8k8 step where K (a multiple of 8) leaves 8, so a depth of 8 (2
// channels padded) takes no 16. The loaders give fragment registers: pa(r,
// k) the pair A[r][k], A[r][k + 1], pb(k, c) the pair B[k][c], B[k + 1][c]
// (k even; 0 past their operand's edge), a 32-bit load of bf16 memory or
// two values packed by pack_bf16x2 (pairs_a, pairs_b). The A fragment is
// loaded one step ahead, as in warp_tile.
template <int NT, class PA, class PB>
__device__ __forceinline__ void warp_tile_bf16(float (&acc)[NT][4], int r0, int K, int c0,
                                               int tiles, const PA& pa, const PB& pb) {
  const int g = (threadIdx.x & 31) >> 2, t2 = 2 * (threadIdx.x & 3);
  const int K16 = K & ~15;
  uint32_t next[4];
  auto load_a = [&](int k0) {
    next[0] = pa(r0 + g, k0 + t2);
    next[1] = pa(r0 + g + 8, k0 + t2);
    next[2] = pa(r0 + g, k0 + t2 + 8);
    next[3] = pa(r0 + g + 8, k0 + t2 + 8);
  };
  if (K16 > 0) load_a(0);
  for (int k0 = 0; k0 < K16; k0 += 16) {
    const uint32_t a[4] = {next[0], next[1], next[2], next[3]};
    if (k0 + 16 < K16) load_a(k0 + 16);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= tiles) break;
      const uint32_t b[2] = {pb(k0 + t2, c0 + 8 * j + g), pb(k0 + t2 + 8, c0 + 8 * j + g)};
      mma_bf16_k16(acc[j], a, b);
    }
  }
  if (K16 < K) {
    const uint32_t a[2] = {pa(r0 + g, K16 + t2), pa(r0 + g + 8, K16 + t2)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= tiles) break;
      mma_bf16_k8(acc[j], a, pb(K16 + t2, c0 + 8 * j + g));
    }
  }
}

// Pair loaders of warp_tile_bf16 from scalar loaders (row, k) -> value and
// (k, column) -> value: the two values packed by pack_bf16x2.
template <class F>
__device__ __forceinline__ auto pairs_a(const F& f) {
  return [&f](int r, int k) { return pack_bf16x2(f(r, k), f(r, k + 1)); };
}
template <class F>
__device__ __forceinline__ auto pairs_b(const F& f) {
  return [&f](int k, int c) { return pack_bf16x2(f(k, c), f(k + 1, c)); };
}

// Row and column, within its 16 x 8 tile, of a lane's accumulator entry i.
__device__ __forceinline__ int frag_row(int i) { return ((threadIdx.x & 31) >> 2) + (i >= 2 ? 8 : 0); }
__device__ __forceinline__ int frag_col(int i) { return 2 * (threadIdx.x & 3) + (i & 1); }

}  // namespace
