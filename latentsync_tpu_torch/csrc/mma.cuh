// mma.sync m16n8k16 (bf16 in, f32 out) with explicit fragments, for the
// attention kernels that rescale or reduce accumulator rows themselves
// (flash.cuh, oneshot_attention.cu). Thread (g = lane >> 2, t = lane & 3)
// of a warp holds rows g and g + 8 of the 16-row A and C tiles.
#pragma once

#include "common.cuh"

namespace ls_mma {

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 x 16, row-major, pitch ld) at (r0, k0).
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int ld, int r0, int k0,
                                       int g, int t) {
  a[0] = ld32(s + (r0 + g) * ld + k0 + 2 * t);
  a[1] = ld32(s + (r0 + g + 8) * ld + k0 + 2 * t);
  a[2] = ld32(s + (r0 + g) * ld + k0 + 2 * t + 8);
  a[3] = ld32(s + (r0 + g + 8) * ld + k0 + 2 * t + 8);
}

// Two bf16 values of a row-major (k, n) tile, one above the other, as the
// packed pair a B fragment wants.
__device__ __forceinline__ uint32_t pack2(const unsigned short* s, int i0, int i1) {
  return (uint32_t)s[i0] | ((uint32_t)s[i1] << 16);
}

// 16 bytes from device memory straight into shared memory (cp.async): the
// copy runs behind the thread, so a tile's loads are all in flight at once
// instead of one round trip per loop step. copy_wait() waits for the calling
// thread's copies; a __syncthreads() after it shows them to the block.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Start the copy of `rows` rows of D bf16 (row stride `row_stride` elements)
// into a shared tile of pitch ld whose rows are DP >= D wide: columns
// [D, DP) are zero, so a head dim that is no multiple of the MMA's 16-deep
// k-step contributes nothing there. D and DP are multiples of 8 and every
// row starts on a 16-byte boundary. Follow with copy_wait() and a barrier.
template <int D, int DP, int THREADS>
__device__ __forceinline__ void copy_rows(bf16* dst, int ld, const bf16* src, long row_stride,
                                          int rows) {
  constexpr int VPR = DP / 8;
  for (int i = threadIdx.x; i < rows * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    if (c < D)
      cp_async16(dst + r * ld + c, src + r * row_stride + c);
    else
      *reinterpret_cast<uint4*>(dst + r * ld + c) = make_uint4(0, 0, 0, 0);
  }
}

}  // namespace ls_mma
