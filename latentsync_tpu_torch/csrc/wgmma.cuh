// Hopper's warpgroup matrix multiply (wgmma), cp.async and the small helpers
// around them, shared by the attention core (attn_core.cuh) and the GEMM
// template (gemm.cuh).
//
// wgmma: D (f32, registers) = or += A (bf16) x B (bf16, shared memory), or
// D (s32) from int8 codes (K8, the forms at the end). The
// four warps of a warpgroup start it together; it runs behind them: fence
// before the first of a batch (registers and shared memory written by
// other code are then seen), commit after the last, wait before
// the accumulators are read or a tile it reads is overwritten. A comes from
// registers (the attention core: attn_core.cuh holds those forms) or, like B,
// from shared memory through a 64-bit descriptor (the forms below).
#pragma once

#include "common.cuh"

namespace ls_wg {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const bf162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// cp.async of 16 bytes to a shared-memory address already in its window
__device__ __forceinline__ void cp_async16s(unsigned smem_dst, const void* gmem_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_dst), "l"(gmem_src));
}

// the same, reading only `src_bytes` (16 or 0) and filling the rest with zeros
__device__ __forceinline__ void cp_async16z(unsigned smem_dst, const void* gmem_src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_dst), "l"(gmem_src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the matrix unit reads shared memory by another path (the async proxy) than
// the one cp.async and ordinary stores write through
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Descriptor of an unswizzled operand made of 128-byte core matrices.
// lbo / sbo: byte steps between core matrices; which dimension each walks
// depends on the operand's major-ness (see attn_core.cuh's two uses).
__device__ __forceinline__ uint64_t wg_desc(unsigned smem_addr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// Descriptor of a K-major operand tile whose rows are 128 bytes (64 bf16) in
// the 128-byte swizzle: the 16-byte chunk c of row r lies at
// r * 128 + ((c ^ (r & 7)) << 4) from a 1024-byte aligned base, so a group of
// 8 rows is 1024 bytes (the stride step); the leading step is not used by
// this layout. A k-step of 16 bf16 moves the start 32 bytes on (wg_step).
__device__ __forceinline__ uint64_t wg_desc_sw128(unsigned smem_addr) {
  return wg_desc(smem_addr, 16, 1024) | (1ull << 62);
}

// Descriptor of an MN-major operand (tnspB = 1: the operand's N runs along a
// row) in the 128-byte swizzle: a row of the tile holds 64 bf16 of N in 128
// bytes, chunk c of row r at r * 128 + ((c ^ (r & 7)) << 4) as above, rows
// are the product's K; 8 rows are 1024 bytes (the stride step) and the next
// 64 of N lie `atom_bytes` on (the leading step). A k-step of 16 rows moves
// the start 2048 bytes on.
__device__ __forceinline__ uint64_t wg_desc_sw128_mn(unsigned smem_addr, unsigned atom_bytes) {
  return wg_desc(smem_addr, atom_bytes, 1024) | (1ull << 62);
}

// what to add to a descriptor to move its start `bytes` (a multiple of 16) on
__device__ __forceinline__ uint64_t wg_step(int bytes) { return (uint64_t)(bytes >> 4); }

// byte offset of 16-byte chunk `c` of row `r` in a 128-byte-swizzled tile
__device__ __forceinline__ unsigned sw128_offset(int r, int c) {
  return (unsigned)(r * 128 + ((c ^ (r & 7)) << 4));
}

// a compile-time value passed as a lambda argument
template <int V>
struct Tag {
  static constexpr int value = V;
};

// d (64 x 32) = or += a (64 x 16) x b^T, both K-major operands in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,"
      "%10,%11,%12,%13,%14,%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64) = or += a (64 x 16) x b^T, both K-major 128-byte-swizzled tiles in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,"
      "%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,"
      "%30,%31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 160) = or += a (64 x 16) x b^T, both K-major 128-byte-swizzled tiles in shared memory
__device__ __forceinline__ void wgmma_ss_n160(float (&d)[80], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,"
      "%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,"
      "%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,"
      "%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,"
      "%70,%71,%72,%73,%74,%75,%76,%77,%78,%79}, "
      "%80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 120) = or += a (64 x 16) x b^T, both K-major 128-byte-swizzled tiles in shared memory
__device__ __forceinline__ void wgmma_ss_n120(float (&d)[60], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %62, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,"
      "%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,"
      "%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,"
      "%50,%51,%52,%53,%54,%55,%56,%57,%58,%59"
      "}, "
      "%60, %61, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 240) = or += a (64 x 16) x b^T, both K-major 128-byte-swizzled tiles in shared memory
__device__ __forceinline__ void wgmma_ss_n240(float (&d)[120], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %122, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n240k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,"
      "%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,"
      "%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,"
      "%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,"
      "%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,"
      "%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,"
      "%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,"
      "%110,%111,%112,%113,%114,%115,%116,%117,%118,%119"
      "}, "
      "%120, %121, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The int8 forms: d (s32) = or += a (64 x 32 codes) x b^T, both K-major
// 128-byte-swizzled tiles in shared memory (the only major-ness the integer
// product takes). A k-step of 32 codes is 32 bytes, as 16 bf16 are, so the
// descriptors and their steps are the bf16 forms' own; the s32 accumulators
// lie in registers as the f32 ones do.

// d (64 x 64) s32
__device__ __forceinline__ void wgmma_ss_s8_n64(int (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,"
      "%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,"
      "%30,%31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 160) s32
__device__ __forceinline__ void wgmma_ss_s8_n160(int (&d)[80], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,"
      "%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,"
      "%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,"
      "%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,"
      "%70,%71,%72,%73,%74,%75,%76,%77,%78,%79}, "
      "%80, %81, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

}  // namespace ls_wg
