// The attention core: softmax(q k^T * scale) v per (batch, head) with both
// products on Hopper's warpgroup tensor-core instruction (wgmma) and the
// logits and probabilities in registers from the first product to the
// second.
//
// K4 (the spatial core, spatial_attention.cu, and through ls_attn::spatial
// the spatial mode of K2) and the flash route of dot_product_attention
// (flash_attention.cu) run it with an online softmax; K11
// (oneshot_attention.cu) runs it in two sweeps over the keys so that the
// probabilities are normalised by the whole row's statistics before they
// are rounded; K12 (flash_kernel.cu) runs the online softmax with
// probabilities that are never rounded (three bf16 terms a probability,
// softmax_tile). q/k/v/o are read through a row pitch in the model's (rows,
// heads * D) layout, so a (B, S, D) tensor is the case heads = 1, pitch D;
// queries and keys have a length each. Head dims up to 160 run the row
// tiling described here; D = 512 runs the column-split tiling at the end of
// this file, on the same softmax.
//
// A warpgroup (four warps) owns 64 query rows, each warp 16 of them. A
// warp's Q fragments (D zero-padded to the 16-deep k-step: 48 / 80 / 128 /
// 160) are loaded once from device memory. Per tile of 64 keys:
//   s = q k^T        wgmma m64n64k16, A (q) from registers, B (the K tile)
//                    from shared memory through a descriptor, into 32 f32
//                    accumulator registers a thread;
//   row max          over the thread's 16 values a row, then across the four
//                    threads of a quad with two shuffles (the accumulator
//                    layout puts rows g and g + 8 of a warp's 16 on lanes
//                    4g..4g+3, as mma.sync m16n8 does);
//   p = 2^(s c - m c)  one FMA and one ex2 a logit, c = scale * log2(e);
//   o += p v         wgmma m64nDk16: the bf16-rounded p are the A fragments
//                    as they stand (two adjacent 8-wide accumulator tiles
//                    are one 16-deep A tile), B (the V tile) from shared
//                    memory, transposed by the descriptor's MN-major mode;
//                    the f32 output accumulator (64 x D a warpgroup) is
//                    rescaled only when a row's maximum moved.
// No logit or probability reaches shared memory and no barrier separates
// the two products. K and V tiles travel through a ring of STAGES buffers
// filled by cp.async, one barrier a tile: tile i + 2 loads while tile i
// multiplies. A tile lies in shared memory as wgmma's unswizzled layout
// wants it, in 8-row x 16-byte core matrices of 128 contiguous bytes (so
// the matrix unit reads whole 128-byte lines and no bank conflicts arise):
// row r, 16-byte chunk c of a tile with CH chunks a row is at
// (r / 8) * CH * 128 + c * 128 + (r % 8) * 16. That layout scatters a
// 128-byte line of device memory over eight lines of shared memory, and
// cp.async then moves 2.2 TB/s (NVIDIA H100 80GB HBM3, 700.00 W) where
// line-to-line copies move more than 7: nothing at D = 40, 80 and 160,
// where the loop is bound elsewhere, but at D = 128 and 512 the rows are
// whole 128-byte atoms and lie in the 128-byte swizzle instead (Tile::SW,
// wgmma.cuh). Keys past the keys' end are masked to -inf before the max
// (their K/V rows are zero or an earlier tile's in shared memory), query
// rows past the queries' end are computed on a clamped row and not stored.
//
// Bound: operations. At S = 1024, D = 40 a (batch, head) needs 4 S^2 D
// FLOP on the tensor cores and S^2 exponentials on the special-function
// units (16 a clock an SM), and the second is the larger time. What the
// core waits on, measured on an H100 by taking pieces out: not the
// exponentials (replacing ex2 by an FMA moved the time by 2 %) but
// instruction slots and latency: a logit costs a max, an FMA, an ex2, an
// add and half a convert, and every other instruction in the tile loop
// shows: a test for the short last tile, a modulo for the ring, a
// predicate a copied row each cost 3 to 12 %, so the loop carries none of
// them (the short tile is a second copy of the loop body). The same core
// on mma.sync m16n8k16 with ldmatrix (44 MMAs and 24 ldmatrix a warp and
// tile where this needs 7 wgmma) took 0.43 ms at (64, 1024, 8 x 40) where
// this takes 0.39. Starting the first product of the next tile ahead of
// the softmax (a fourth stage, 32 more registers) helped neither form.
// K12 at D = 128 with two warpgroups a block (197 registers, one block an
// SM) is nearly the sum of its phases, by the same method
// (scripts/attn_pieces.py, (512, 1024, 128) on an NVIDIA H100 80GB HBM3 at
// 700.00 W): 1.12-1.20 ms, of which the empty loop is 0.16, and taking out
// q k^T saves 0.24, the softmax with the three-term split 0.36, the three
// value products (which run at the tensor peak) 0.50: the two warpgroups
// meet at the tile's barrier and then run the same phase at the same time,
// so the tensor cores idle through the softmax and the other pipes through
// the products. As two blocks of one warpgroup an SM (flash_kernel.cu) it
// takes 0.99-1.00 (0.17, 0.19, 0.21, 0.39).
#pragma once

#include "wgmma.cuh"

namespace ls_core {

using namespace ls_wg;

constexpr int KT = 64;     // keys of one tile
constexpr int STAGES = 3;  // ring of K/V tiles in shared memory
constexpr float LOG2E = 1.4426950408889634f;

// q and o hold seq_q rows a batch entry, k and v seq_k; lse, where a
// kernel writes the row statistics (LSE below), batch * heads * seq_q f32
struct Args {
  const bf16 *q, *k, *v;
  int ldq, ldk, ldv;
  bf16* o;
  int ldo;
  int batch, seq_q, seq_k, heads;
  float scale;
  float* lse = nullptr;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(LS_FULL_MASK, x, 1));
  return fmaxf(x, __shfl_xor_sync(LS_FULL_MASK, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(LS_FULL_MASK, x, 1);
  return x + __shfl_xor_sync(LS_FULL_MASK, x, 2);
}

// wgmma with A from registers (fences, descriptors: wgmma.cuh)

// s (64 x 64) = or += a (64 x 16, registers) x K^T: B is 64 keys x 16 of d, K-major
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,"
      "%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,"
      "%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// o (64 x D) += p (64 x 16, registers) x V: B is 16 keys x D, MN-major (transposed)
__device__ __forceinline__ void wgmma_n40(float (&d)[20], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,"
      "%10,%11,%12,%13,%14,%15,%16,%17,%18,%19}, "
      "{%20,%21,%22,%23}, %24, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// the same for D = 80
__device__ __forceinline__ void wgmma_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,"
      "%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,"
      "%30,%31,%32,%33,%34,%35,%36,%37,%38,%39}, "
      "{%40,%41,%42,%43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// the same for D = 160
__device__ __forceinline__ void wgmma_n160(float (&d)[80], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,"
      "%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,"
      "%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,"
      "%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,"
      "%70,%71,%72,%73,%74,%75,%76,%77,%78,%79}, "
      "{%80,%81,%82,%83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// the same for D = 128
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,"
      "%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"
      "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,"
      "%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,"
      "%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63}, "
      "{%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// the same for a 256-column share of D = 512
__device__ __forceinline__ void wgmma_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
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
      "%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,"
      "%120,%121,%122,%123,%124,%125,%126,%127}, "
      "{%128,%129,%130,%131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// o (64 x N) += p (64 x 16) x V for an N-column accumulator
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (N == 40) wgmma_n40(d, a, desc, 1);
  if constexpr (N == 80) wgmma_n80(d, a, desc, 1);
  if constexpr (N == 128) wgmma_n128(d, a, desc, 1);
  if constexpr (N == 160) wgmma_n160(d, a, desc, 1);
  if constexpr (N == 256) wgmma_n256(d, a, desc, 1);
}

enum { ONLINE, STATS, NORMALISED };       // what a sweep does (see softmax_tile)
enum { P_ROUNDED, P_NORMALISED, P_SPLIT };  // a kernel's numerics (see attn_kernel)

// The softmax state of a thread's two query rows (g and g + 8 of its warp's
// 16): running maximum of the raw logits (the same on the four lanes of a
// quad), this lane's share of the running sum, and what the exponent
// subtracts: m c, and in K11's second sweep m c + log2(row sum), which
// normalises inside the exponential.
struct Rows {
  float mx[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float sub[2] = {0.f, 0.f};
};

__device__ __forceinline__ float bf16_lo(uint32_t pair) { return __uint_as_float(pair << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t pair) {
  return __uint_as_float(pair & 0xffff0000u);
}

// The softmax of one key tile on a thread's logits s (accumulator tile n,
// 8 keys, in s[4n..4n+3]: two values of row g, two of row g + 8), into the
// A fragments of the value product's k-steps (two adjacent 8-key tiles are
// one 16-deep A tile). MODE: ONLINE, the running softmax (the output
// accumulator acc is rescaled, and only when a row's maximum moved); STATS,
// K11's first sweep (max and sum only); NORMALISED, its second (the exponent
// subtracts m c + log2(sum): no max, no sum). TERMS = 1: p rounded to bf16.
// TERMS = 3: p = p0 + p1 + p2, each the bf16 rounding of what the terms
// before left; 8 + 8 + 8 mantissa bits, so the sum is the f32 p exactly and
// a value product issued once a term multiplies by the unrounded p. The row
// sum is always taken from the f32 p.
template <int MODE, int TERMS, int KSTEPS, int NS, int NACC>
__device__ __forceinline__ void softmax_tile(const float (&s)[NS], float (&acc)[NACC], Rows& r,
                                             float scale_log2,
                                             uint32_t (&pa)[TERMS][KSTEPS][4]) {
  static_assert(NS == 8 * KSTEPS, "two 8-key logit tiles a k-step");
  if (MODE != NORMALISED) {
    float x0 = r.mx[0], x1 = r.mx[1];
#pragma unroll
    for (int n = 0; n < NS / 4; ++n) {
      x0 = fmaxf(x0, fmaxf(s[4 * n], s[4 * n + 1]));
      x1 = fmaxf(x1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    x0 = quad_max(x0);
    x1 = quad_max(x1);
    if (__any_sync(LS_FULL_MASK, x0 != r.mx[0] || x1 != r.mx[1])) {  // a maximum moved
      const float c0 = ex2((r.mx[0] - x0) * scale_log2);
      const float c1 = ex2((r.mx[1] - x1) * scale_log2);
      r.l[0] *= c0;
      r.l[1] *= c1;
      if (MODE == ONLINE) {
#pragma unroll
        for (int n = 0; n < NACC / 4; ++n) {
          acc[4 * n] *= c0;
          acc[4 * n + 1] *= c0;
          acc[4 * n + 2] *= c1;
          acc[4 * n + 3] *= c1;
        }
      }
      r.mx[0] = x0;
      r.mx[1] = x1;
      r.sub[0] = x0 * scale_log2;
      r.sub[1] = x1 * scale_log2;
    }
  }
#pragma unroll
  for (int n = 0; n < NS / 4; ++n) {
    float p00 = ex2(fmaf(s[4 * n], scale_log2, -r.sub[0]));
    float p01 = ex2(fmaf(s[4 * n + 1], scale_log2, -r.sub[0]));
    float p10 = ex2(fmaf(s[4 * n + 2], scale_log2, -r.sub[1]));
    float p11 = ex2(fmaf(s[4 * n + 3], scale_log2, -r.sub[1]));
    if (MODE != NORMALISED) {
      r.l[0] += p00 + p01;
      r.l[1] += p10 + p11;
    }
    if (MODE != STATS) {
#pragma unroll
      for (int term = 0; term < TERMS; ++term) {
        const uint32_t h0 = pack_bf16(p00, p01);
        const uint32_t h1 = pack_bf16(p10, p11);
        pa[term][n / 2][(n & 1) * 2] = h0;
        pa[term][n / 2][(n & 1) * 2 + 1] = h1;
        if (term + 1 < TERMS) {  // what the rounding left, exact in f32
          p00 -= bf16_lo(h0);
          p01 -= bf16_hi(h0);
          p10 -= bf16_lo(h1);
          p11 -= bf16_hi(h1);
        }
      }
    }
  }
}

// The row statistics of a thread's two rows (row0 and row0 + 8) as one
// base-2 log-sum-exp each, sub + log2(row sum) with sub = m c, into
// lse[row] (this (batch, head)'s rows) by the first lane of each quad;
// rows past seq_q are not written. All four lanes of a quad call it.
__device__ __forceinline__ void write_lse(const Rows& r, float* lse, int row0, int seq_q, int t) {
  const float l0 = quad_sum(r.l[0]);
  const float l1 = quad_sum(r.l[1]);
  if (t == 0) {
    if (row0 < seq_q) lse[row0] = r.sub[0] + __log2f(l0);
    if (row0 + 8 < seq_q) lse[row0 + 8] = r.sub[1] + __log2f(l1);
  }
}

template <int D>
struct Tile {
  static constexpr int DP = (D + 15) / 16 * 16;  // D padded to the k-step
  static constexpr int KS = DP / 16;             // k-steps of q k^T
  static constexpr int KCH = DP / 8;             // 16-byte chunks of a K row, pad included
  static constexpr int VCH = D / 8;              // 16-byte chunks of a V row
  static constexpr int K_BYTES = KT / 8 * KCH * 128;
  static constexpr int V_BYTES = KT / 8 * VCH * 128;
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  // A row of whole 128-byte atoms (D = 128) lies in the 128-byte swizzle of
  // wgmma.cuh, atom by atom (KT rows x 128 bytes each), so that cp.async
  // moves a 128-byte line of device memory into one line of shared memory;
  // other head dims lie as 8-row x 16-byte core matrices (see above).
  static constexpr bool SW = D % 64 == 0;
  static constexpr int ATOM = KT * 128;
  static constexpr int SMEM_PAD = SW ? 1024 : 0;  // room to align the ring for the swizzle
  // what a descriptor moves on to k-step kk of q k^T, and to k-step j of p v
  __host__ __device__ static constexpr int k_step(int kk) {
    return SW ? kk / 4 * ATOM + kk % 4 * 32 : kk * 256;
  }
  __host__ __device__ static constexpr int v_step(int j) {
    return SW ? j * 2048 : j * 2 * VCH * 128;
  }
};

// D: head dim (40, 80, 128 or 160). NWG: warpgroups a block, 64 query rows
// each. NUM, where the probabilities are rounded: P_ROUNDED, online softmax
// and p rounded to bf16 (K4, the flash route); P_NORMALISED, two sweeps
// (statistics of the whole row first, then normalised probabilities rounded
// to bf16: K11); P_SPLIT, online softmax and p never rounded (K12: the value
// product runs once for each of p's three bf16 terms). Site only names the
// caller in a profile: void, or ls_attn::k2_spatial_core for K2's spatial
// mode (the same code as K4's). LSE (P_ROUNDED only: the flash route under
// grad) also writes each row's log-sum-exp of the scaled logits in base 2,
// m c + log2(l), to lse[(b * heads + h) * seq_q + row]: the residual its
// backward (flash_attention_bwd.cu) takes P = 2^(s c - lse) from. Without
// it the kernel is the same code as before the parameter existed.
template <int D, int NWG, int NUM, class Site = void, bool LSE = false>
__global__ void __launch_bounds__(128 * NWG)
    attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, int ldq, int ldk, int ldv, bf16* __restrict__ o,
                int ldo, int seq_q, int seq_k, int heads, int q_tiles, float scale_log2,
                float* __restrict__ lse) {
  static_assert(!LSE || NUM == P_ROUNDED, "row statistics of the online softmax only");
  using T = Tile<D>;
  constexpr int KS = T::KS;
  constexpr int THREADS = 128 * NWG;
  constexpr int BQ = 64 * NWG;  // query rows of the block
  constexpr bool TWO_SWEEPS = NUM == P_NORMALISED;
  constexpr int TERMS = NUM == P_SPLIT ? 3 : 1;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const unsigned smem_pad = T::SW ? -(unsigned)__cvta_generic_to_shared(smem_raw) & 1023u : 0u;
  const unsigned smem_base = (unsigned)__cvta_generic_to_shared(smem_raw) + smem_pad;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qt = blockIdx.x % q_tiles;  // the tiles of one (batch, head) run together
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const bf16* qb = q + (size_t)b * seq_q * ldq + (size_t)h * D;
  const bf16* kb = k + (size_t)b * seq_k * ldk + (size_t)h * D;
  const bf16* vb = v + (size_t)b * seq_k * ldv + (size_t)h * D;

  // A step is one tile of one sweep: steps [0, tiles), and with two sweeps
  // [tiles, 2 tiles) for the second sweep over the same tiles.
  const int tiles = (seq_k + KT - 1) / KT;
  const int full_tiles = seq_k / KT;  // tiles with all their keys inside the sequence
  const int steps = TWO_SWEEPS ? 2 * tiles : tiles;
  const int ring = steps < STAGES ? steps : STAGES;
  auto tile_of = [&](int step) { return TWO_SWEEPS && step >= tiles ? step - tiles : step; };
  auto has_v = [&](int step) { return !TWO_SWEEPS || step >= tiles; };

  // Loads: TPR threads a row (the next power of two over the row's 16-byte
  // chunks, so a thread's chunk is fixed), THREADS / TPR rows a pass. Rows
  // past the sequence's end are left alone: the whole ring is zeroed first
  // (the K tiles' pad chunk with it: q's pad is zero too), so what a short
  // last tile leaves there is zero or an earlier tile: finite logits under
  // the mask and p v = 0.
  // In the swizzled layout eight threads copy a 128-byte row of an atom.
  constexpr int TPR = T::SW || T::VCH <= 8 ? 8 : T::VCH <= 16 ? 16 : 32;
  constexpr int RP = THREADS / TPR;
  static_assert(T::VCH <= 32 && RP >= 1 && KT % RP == 0 && (!T::SW || RP % 8 == 0), "tile loads");
  const int lr = tid / TPR;
  const int lc = tid % TPR;
  for (int i = tid; i < ring * T::STAGE_BYTES / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem_raw + smem_pad)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();  // the zeros are down before any copy lands on them

  // Start the copy of the K tile of `step`, and of its V tile where the
  // step multiplies by it, into `stage`, as core matrices; one commit group
  // a call whatever it copies.
  auto load = [&](int step, int stage) {
    if ((T::SW || lc < T::VCH) && step < steps) {
      const int k0 = tile_of(step) * KT;
      const bool with_v = has_v(step);
      const bf16* ksrc = kb + (size_t)(k0 + lr) * ldk + lc * 8;
      const bf16* vsrc = vb + (size_t)(k0 + lr) * ldv + lc * 8;
      const unsigned dst = smem_base + stage * T::STAGE_BYTES +
                           (T::SW ? sw128_offset(lr, lc) : lc * 128);
      auto copy_rows = [&](auto all_rows) {
        const int rows = seq_k - k0 - lr;  // rows of this thread's chunk still inside
#pragma unroll
        for (int j = 0; j < KT / RP; ++j) {
          if (decltype(all_rows)::value || j * RP < rows) {
            if constexpr (T::SW) {
#pragma unroll
              for (int a = 0; a < D / 64; ++a) {
                const unsigned at = a * T::ATOM + j * RP * 128;  // RP % 8 == 0: the same swizzle
                cp_async16s(dst + at, ksrc + (size_t)j * RP * ldk + a * 64);
                if (with_v)
                  cp_async16s(dst + T::K_BYTES + at, vsrc + (size_t)j * RP * ldv + a * 64);
              }
            } else {
              const int r = lr + j * RP;
              const unsigned at = (r & 7) * 16;
              cp_async16s(dst + (r >> 3) * (T::KCH * 128) + at, ksrc + (size_t)j * RP * ldk);
              if (with_v)
                cp_async16s(dst + T::K_BYTES + (r >> 3) * (T::VCH * 128) + at,
                            vsrc + (size_t)j * RP * ldv);
            }
          }
        }
      };
      if (k0 + KT <= seq_k)
        copy_rows(Tag<true>{});
      else
        copy_rows(Tag<false>{});
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s, s);

  // This warp's Q fragments, straight from device memory: thread (g, t)
  // holds rows row0 and row0 + 8 (past the sequence's end: its last row,
  // computed and not stored).
  const int row0 = qt * BQ + warp * 16 + g;
  uint32_t aq[KS][4];
  {
    const bf16* q0 = qb + (size_t)min(row0, seq_q - 1) * ldq;
    const bf16* q1 = qb + (size_t)min(row0 + 8, seq_q - 1) * ldq;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = kk * 16 + 2 * t;
      aq[kk][0] = c < D ? ld32(q0 + c) : 0u;
      aq[kk][1] = c < D ? ld32(q1 + c) : 0u;
      aq[kk][2] = c + 8 < D ? ld32(q0 + c + 8) : 0u;
      aq[kk][3] = c + 8 < D ? ld32(q1 + c + 8) : 0u;
    }
  }

  // Output accumulator: tile n (columns 8n..8n+7) in acc[4n..4n+3], rows g
  // (the first two) and g + 8; the softmax state of those two rows.
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  Rows rows;

  // s = q k^T against the keys of the tile in `stage`; of a short last tile
  // only `valid` keys exist and the rest are masked. The K tile is K-major
  // for the matrix unit (a key's d run on): its descriptor steps 128 bytes
  // to the next 8 of d and a row group to the next 8 keys; a k-step is two
  // chunks on. (Swizzled: wgmma.cuh.)
  const uint64_t k_desc = T::SW ? wg_desc_sw128(smem_base) : wg_desc(smem_base, 128, T::KCH * 128);
  auto qk = [&](int stage, float (&s)[32], int valid, auto masked) {
    const uint64_t ks = k_desc + wg_step(stage * T::STAGE_BYTES);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_n64(s, aq[kk], ks + wg_step(T::k_step(kk)), kk > 0);
    wg_commit();
    wg_wait();
    if (decltype(masked)::value) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n * 8 + 2 * t + (e & 1) >= valid) s[4 * n + e] = -INFINITY;
    }
  };

  // The softmax of the tile in `stage` on its logits (softmax_tile, MODE a
  // compile-time tag), the copies of step `ahead` into the stage `fill`
  // that the tile before has left, and o += p v, once a term of p.
  const uint64_t v_desc = T::SW ? wg_desc_sw128_mn(smem_base + T::K_BYTES, T::ATOM)
                                : wg_desc(smem_base + T::K_BYTES, T::VCH * 128, 128);
  auto softmax_pv = [&](int stage, int ahead, int fill, float (&s)[32], auto mode) {
    constexpr int MODE = decltype(mode)::value;
    uint32_t pa[TERMS][KT / 16][4];  // p as the A fragments of the value product's four k-steps
    softmax_tile<MODE>(s, acc, rows, scale_log2, pa);
    load(ahead, fill);
    if (MODE == STATS) return;

    // The V tile is MN-major for the matrix unit (a key's d run on, and d is
    // the product's N): its descriptor steps a row group to the next 8 keys
    // and 128 bytes to the next 8 of d; a k-step is two row groups on.
    const uint64_t vs = v_desc + wg_step(stage * T::STAGE_BYTES);
    wg_fence();
#pragma unroll
    for (int term = 0; term < TERMS; ++term)
#pragma unroll
      for (int j = 0; j < KT / 16; ++j)
        wgmma_pv<D>(acc, pa[term][j], vs + wg_step(T::v_step(j)));
    wg_commit();
    wg_wait();
  };

  // One sweep over the tiles in one mode, from step `first`: the full tiles,
  // then the short last one with its mask (apart, so that the full tiles'
  // code carries no test for it). The stage of a step is step % STAGES,
  // carried along.
  int stage = 0;
  auto tile_step = [&](int step, int valid, auto mode, auto masked) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile `step` have landed
    fence_async_proxy();  // the copies and the zeros, for the matrix unit
    __syncthreads();  // everyone's have, and tile step - 1 has been read
    float s[32];
    qk(stage, s, valid, masked);
    softmax_pv(stage, step + STAGES - 1, stage == 0 ? STAGES - 1 : stage - 1, s, mode);
    stage = stage + 1 == STAGES ? 0 : stage + 1;
  };
  auto sweep = [&](int first, auto mode) {
    for (int i = 0; i < full_tiles; ++i) tile_step(first + i, KT, mode, Tag<false>{});
    if (full_tiles < tiles)
      tile_step(first + full_tiles, seq_k - full_tiles * KT, mode, Tag<true>{});
  };
  if (!TWO_SWEEPS) {
    sweep(0, Tag<ONLINE>{});
  } else {
    sweep(0, Tag<STATS>{});
#pragma unroll
    for (int r = 0; r < 2; ++r)
      rows.sub[r] = fmaf(rows.mx[r], scale_log2, __log2f(quad_sum(rows.l[r])));
    sweep(tiles, Tag<NORMALISED>{});
  }
  cp_async_wait<0>();

  // two sweeps: the probabilities were normalised before the product
  const float inv0 = TWO_SWEEPS ? 1.f : 1.f / quad_sum(rows.l[0]);
  const float inv1 = TWO_SWEEPS ? 1.f : 1.f / quad_sum(rows.l[1]);
  if constexpr (LSE) write_lse(rows, lse + (size_t)bh * seq_q, row0, seq_q, t);
  bf16* o0 = o + ((size_t)b * seq_q + row0) * ldo + (size_t)h * D + 2 * t;
  bf16* o1 = o0 + (size_t)8 * ldo;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (row0 < seq_q)
      *reinterpret_cast<bf162*>(o0 + n * 8) =
          __floats2bfloat162_rn(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
    if (row0 + 8 < seq_q)
      *reinterpret_cast<bf162*>(o1 + n * 8) =
          __floats2bfloat162_rn(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
  }
}

template <int D, int NWG, int NUM, class Site = void, bool LSE = false>
cudaError_t launch(const Args& a, cudaStream_t s) {
  if (LSE && a.lse == nullptr) return cudaErrorInvalidValue;
  if (a.seq_q <= 0 || a.seq_k <= 0 || a.heads <= 0 || !(a.scale > 0.f))
    return cudaErrorInvalidValue;
  const int tiles = (a.seq_k + KT - 1) / KT;
  const int steps = NUM == P_NORMALISED ? 2 * tiles : tiles;
  const size_t smem =
      (size_t)(steps < STAGES ? steps : STAGES) * Tile<D>::STAGE_BYTES + Tile<D>::SMEM_PAD;
  cudaError_t e = ls_allow_smem(attn_kernel<D, NWG, NUM, Site, LSE>, smem);
  if (e != cudaSuccess) return e;
  constexpr int BQ = 64 * NWG;
  const int q_tiles = (a.seq_q + BQ - 1) / BQ;
  const long long blocks = (long long)q_tiles * a.heads * a.batch;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attn_kernel<D, NWG, NUM, Site, LSE><<<(unsigned)blocks, 128 * NWG, smem, s>>>(
      a.q, a.k, a.v, a.ldq, a.ldk, a.ldv, a.o, a.ldo, a.seq_q, a.seq_k, a.heads, q_tiles,
      a.scale * LOG2E, a.lse);
  return cudaGetLastError();
}

// Query rows a block: 128 (two warpgroups sharing each K/V tile) where a
// (batch, head) has at least two such tiles' worth of rows, one
// warpgroup's 64 below that.
static inline int pick_block_q(int seq_q) { return seq_q >= 256 ? 128 : 64; }

// block_q: 64, 128, or 0 for pick_block_q(seq_q).
template <int D, int NUM, class Site = void, bool LSE = false>
cudaError_t run(const Args& a, int block_q, cudaStream_t s) {
  switch (block_q ? block_q : pick_block_q(a.seq_q)) {
    case 64: return launch<D, 1, NUM, Site, LSE>(a, s);
    case 128: return launch<D, 2, NUM, Site, LSE>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// D = 512: the same softmax on another tiling
// ---------------------------------------------------------------------------
//
// The 64 x 512 f32 output of one query tile is half of an SM's register file,
// so it cannot follow the rows as above: a block owns 64 query rows and its
// two warpgroups split the output by COLUMNS, 256 each (128 accumulator
// registers a thread, one block an SM). Each warpgroup computes the whole
// 64 x 32 logits of a key tile and its own softmax (the first product twice
// a block: 1.5 times the operations, and no exchange and no barrier between
// the products), then o[:, its 256 columns] += p v[:, its 256 columns]. The
// Q tile cannot stay in registers (32 k-steps): it lies in shared memory once
// a block (64 KB) and the first product takes it from there through a
// descriptor. K and V tiles of 32 keys (32 KB each) travel through a ring of
// two K+V stages (128 KB): tile i + 1 loads behind tile i's products, one
// barrier a tile. Q, K and V all lie in the 128-byte swizzle, as ATOMS
// column atoms of rows x 128 bytes each (wgmma.cuh): Q and K are K-major
// operands of the first product, V the MN-major operand of the second, from
// the same layout. Lengths must be whole tiles (64 queries, 32 keys): every
// caller's are.
//
// Bound: operations. What the loop waits on, measured on an NVIDIA H100
// 80GB HBM3 at 700.00 W at (64, 1024, 1, 512) by taking pieces out
// (scripts/attn_pieces.py): with the tiles as unswizzled core matrices the
// copies alone took 1.04 ms of 1.09 (2 TB/s from L2, see the top of this
// file); swizzled they take 0.30 ms alone and hide behind the products but
// for 0.02-0.05. Of the 0.48 ms, 0.10 is the empty loop with its barriers,
// 0.14-0.19 the first product (twice a block), about 0.09 the softmax and
// 0.03-0.10 the second product: the phases add up, because the two
// warpgroups run them in step. K12 adds two value products (0.63 ms).
// Pipelining inside a warpgroup (the next tile's first product started
// before this tile's softmax, or the softmax under the value product)
// measured 0.469-0.477 ms: a warp issues in order and a chain of 32 wgmma
// holds it until the chain has nearly run, so only another warpgroup's
// instructions fill the other pipes.
template <int D>
struct Wide {
  static constexpr int BQ = 64;       // query rows of a block
  static constexpr int WKT = 32;      // keys of one tile
  static constexpr int NWG = 2;       // warpgroups, each with D / NWG output columns
  static constexpr int DW = D / NWG;
  static constexpr int ATOMS = D / 64;          // 128-byte column atoms of a row
  static constexpr int Q_ATOM = BQ * 128;       // bytes of one atom of the Q tile
  static constexpr int T_ATOM = WKT * 128;      // of a K or a V tile
  static constexpr int Q_BYTES = ATOMS * Q_ATOM;
  static constexpr int T_BYTES = ATOMS * T_ATOM;
  static constexpr int STAGE_BYTES = 2 * T_BYTES;
  // Q, the ring, and room to align the base to the swizzle's 1024 bytes
  static constexpr int SMEM_BYTES = Q_BYTES + 2 * STAGE_BYTES + 1024;
};

// NUM: P_ROUNDED (the flash route) or P_SPLIT (K12), and LSE, as above.
template <int D, int NUM, bool LSE = false>
__global__ void __launch_bounds__(128 * Wide<D>::NWG, 1)
    attn_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, int ldq, int ldk, int ldv,
                     bf16* __restrict__ o, int ldo, int seq_q, int seq_k, int heads,
                     float scale_log2, float* __restrict__ lse) {
  static_assert(!LSE || NUM == P_ROUNDED, "row statistics of the online softmax only");
  using W = Wide<D>;
  constexpr int WKT = W::WKT;
  constexpr int TERMS = NUM == P_SPLIT ? 3 : 1;
  static_assert(W::DW == 256 && WKT == 32 && W::BQ % 32 == 0, "the wgmma shapes below");
  extern __shared__ unsigned char smem_raw[];
  const unsigned smem_base = ((unsigned)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q_tiles = seq_q / W::BQ;
  const int qt = blockIdx.x % q_tiles;  // the tiles of one (batch, head) run together
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const bf16* qb = q + ((size_t)b * seq_q + qt * W::BQ) * ldq + (size_t)h * D;
  const bf16* kb = k + (size_t)b * seq_k * ldk + (size_t)h * D;
  const bf16* vb = v + (size_t)b * seq_k * ldv + (size_t)h * D;
  const int tiles = seq_k / WKT;

  // Copies: eight threads a 128-byte row of an atom, 32 rows a pass; a
  // thread's chunk and its swizzled place in a row group are fixed.
  const int chunk = tid & 7;
  const int rip = tid >> 3;
  const unsigned sw = sw128_offset(rip, chunk);
  auto copy_rows = [&](unsigned dst, const bf16* src, int ld, auto passes) {
    constexpr int PASSES = decltype(passes)::value;  // 32-row passes of the tile
    const bf16* s0 = src + (size_t)rip * ld + chunk * 8;
#pragma unroll
    for (int a = 0; a < W::ATOMS; ++a)
#pragma unroll
      for (int rp = 0; rp < PASSES; ++rp)
        cp_async16s(dst + sw + a * PASSES * 32 * 128 + rp * 32 * 128,
                    s0 + (size_t)rp * 32 * ld + a * 64);
  };
  // the K and V tiles of `tile` into `stage`; one commit group a call
  auto load = [&](int tile, int stage) {
    if (tile < tiles) {
      const unsigned dst = smem_base + W::Q_BYTES + stage * W::STAGE_BYTES;
      copy_rows(dst, kb + (size_t)tile * WKT * ldk, ldk, Tag<WKT / 32>{});
      copy_rows(dst + W::T_BYTES, vb + (size_t)tile * WKT * ldv, ldv, Tag<WKT / 32>{});
    }
    cp_async_commit();
  };
  copy_rows(smem_base, qb, ldq, Tag<W::BQ / 32>{});  // Q travels in tile 0's group
  load(0, 0);

  // this warpgroup's 256 output columns: tile n (8 columns) in acc[4n..4n+3]
  float acc[W::DW / 2];
#pragma unroll
  for (int i = 0; i < W::DW / 2; ++i) acc[i] = 0.f;
  Rows rows;

  // Q and K are K-major operands (a row's d run on): a k-step of 16 of d is
  // 32 bytes on inside an atom, then the next atom. V is MN-major (d is the
  // second product's N), from this warpgroup's first column atom: a k-step
  // of 16 keys is two row groups on.
  const uint64_t q_desc = wg_desc_sw128(smem_base);
  const uint64_t k_desc = wg_desc_sw128(smem_base + W::Q_BYTES);
  const uint64_t v_desc = wg_desc_sw128_mn(
      smem_base + W::Q_BYTES + W::T_BYTES + wg * (W::DW / 64) * W::T_ATOM, W::T_ATOM);
  int stage = 0;
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<0>();   // this thread's copies of tile i have landed
    fence_async_proxy();  // for the matrix unit
    __syncthreads();      // everyone's have, and tile i - 1 has been read
    const uint64_t at = wg_step(stage * W::STAGE_BYTES);
    float s[WKT / 2];
    wg_fence();
#pragma unroll
    for (int a = 0; a < W::ATOMS; ++a)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_n32(s, q_desc + wg_step(a * W::Q_ATOM + ks * 32),
                     k_desc + at + wg_step(a * W::T_ATOM + ks * 32), a + ks > 0);
    wg_commit();
    load(i + 1, stage ^ 1);  // behind the product, into the stage tile i - 1 has left
    wg_wait();
    uint32_t pa[TERMS][WKT / 16][4];
    softmax_tile<ONLINE>(s, acc, rows, scale_log2, pa);
    wg_fence();
#pragma unroll
    for (int term = 0; term < TERMS; ++term)
#pragma unroll
      for (int j = 0; j < WKT / 16; ++j)
        wgmma_pv<W::DW>(acc, pa[term][j], v_desc + at + wg_step(j * 2048));
    wg_commit();
    wg_wait();
    stage ^= 1;
  }

  const float inv0 = 1.f / quad_sum(rows.l[0]);
  const float inv1 = 1.f / quad_sum(rows.l[1]);
  const int row0 = qt * W::BQ + warp * 16 + g;
  // both warpgroups hold the same row statistics: the first writes them
  if constexpr (LSE)
    if (wg == 0) write_lse(rows, lse + (size_t)bh * seq_q, row0, seq_q, t);
  bf16* o0 = o + ((size_t)b * seq_q + row0) * ldo + (size_t)h * D + wg * W::DW + 2 * t;
  bf16* o1 = o0 + (size_t)8 * ldo;
#pragma unroll
  for (int n = 0; n < W::DW / 8; ++n) {
    *reinterpret_cast<bf162*>(o0 + n * 8) =
        __floats2bfloat162_rn(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
    *reinterpret_cast<bf162*>(o1 + n * 8) =
        __floats2bfloat162_rn(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
  }
}

template <int D, int NUM, bool LSE = false>
cudaError_t run_wide(const Args& a, cudaStream_t s) {
  using W = Wide<D>;
  if (a.seq_q <= 0 || a.seq_q % W::BQ || a.seq_k <= 0 || a.seq_k % W::WKT || a.heads <= 0 ||
      !(a.scale > 0.f) || (LSE && a.lse == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t e = ls_allow_smem(attn_wide_kernel<D, NUM, LSE>, W::SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)(a.seq_q / W::BQ) * a.heads * a.batch;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attn_wide_kernel<D, NUM, LSE><<<(unsigned)blocks, 128 * W::NWG, W::SMEM_BYTES, s>>>(
      a.q, a.k, a.v, a.ldq, a.ldk, a.ldv, a.o, a.ldo, a.seq_q, a.seq_k, a.heads,
      a.scale * LOG2E, a.lse);
  return cudaGetLastError();
}

}  // namespace ls_core
