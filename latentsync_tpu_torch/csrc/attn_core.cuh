// The attention core of the spatial kernels: softmax(q k^T * scale) v per
// (batch, head) with both products on Hopper's warpgroup tensor-core
// instruction (wgmma) and the logits and probabilities in registers from
// the first product to the second.
//
// K4 (the spatial core, spatial_attention.cu, and through ls_attn::spatial
// the spatial mode of K2) runs it with an online softmax; K11
// (oneshot_attention.cu) runs it in two sweeps over the keys so that the
// probabilities are normalised by the whole row's statistics before they
// are rounded. q/k/v/o are read through a row pitch in the model's (rows,
// heads * D) layout, so a (B, S, D) tensor is the case heads = 1, pitch D.
//
// A warpgroup (four warps) owns 64 query rows, each warp 16 of them. A
// warp's Q fragments (D zero-padded to the 16-deep k-step: 48 / 80 / 160)
// are loaded once from device memory. Per tile of 64 keys:
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
// (r / 8) * CH * 128 + c * 128 + (r % 8) * 16. Keys past S are masked to
// -inf before the max (their K/V rows are zero or an earlier tile's in
// shared memory), query rows past S are computed on a clamped row and not
// stored.
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
#pragma once

#include "mma.cuh"
#include "wgmma.cuh"

namespace ls_core {

using ls_mma::ld32;
using namespace ls_wg;

constexpr int KT = 64;     // keys of one tile
constexpr int STAGES = 3;  // ring of K/V tiles in shared memory
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const bf16 *q, *k, *v;
  int ldq, ldk, ldv;
  bf16* o;
  int ldo;
  int batch, seq, heads;
  float scale;
};

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

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (D == 40) wgmma_n40(d, a, desc, 1);
  if constexpr (D == 80) wgmma_n80(d, a, desc, 1);
  if constexpr (D == 160) wgmma_n160(d, a, desc, 1);
}

enum { ONLINE, STATS, NORMALISED };  // what a sweep does (see softmax_pv)

template <int D>
struct Tile {
  static constexpr int DP = (D + 15) / 16 * 16;  // D padded to the k-step
  static constexpr int KS = DP / 16;             // k-steps of q k^T
  static constexpr int KCH = DP / 8;             // 16-byte chunks of a K row, pad included
  static constexpr int VCH = D / 8;              // 16-byte chunks of a V row
  static constexpr int NT = D / 8;               // 8-wide accumulator tiles of the output
  static constexpr int K_BYTES = KT / 8 * KCH * 128;
  static constexpr int V_BYTES = KT / 8 * VCH * 128;
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
};

// D: head dim (40, 80 or 160). NWG: warpgroups a block, 64 query rows each.
// EXACT: two sweeps (statistics of the whole row first, then normalised
// probabilities rounded to bf16) instead of the online softmax.
template <int D, int NWG, bool EXACT>
__global__ void __launch_bounds__(128 * NWG)
    attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, int ldq, int ldk, int ldv, bf16* __restrict__ o,
                int ldo, int seq, int heads, int q_tiles, float scale_log2) {
  using T = Tile<D>;
  constexpr int KS = T::KS;
  constexpr int NT = T::NT;
  constexpr int THREADS = 128 * NWG;
  constexpr int BQ = 64 * NWG;  // query rows of the block
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const unsigned smem_base = (unsigned)__cvta_generic_to_shared(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qt = blockIdx.x % q_tiles;  // the tiles of one (batch, head) run together
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const bf16* qb = q + (size_t)b * seq * ldq + (size_t)h * D;
  const bf16* kb = k + (size_t)b * seq * ldk + (size_t)h * D;
  const bf16* vb = v + (size_t)b * seq * ldv + (size_t)h * D;

  // A step is one tile of one sweep: steps [0, tiles), and in EXACT mode
  // [tiles, 2 tiles) for the second sweep over the same tiles.
  const int tiles = (seq + KT - 1) / KT;
  const int full_tiles = seq / KT;  // tiles with all their keys inside the sequence
  const int steps = EXACT ? 2 * tiles : tiles;
  const int ring = steps < STAGES ? steps : STAGES;
  auto tile_of = [&](int step) { return EXACT && step >= tiles ? step - tiles : step; };
  auto has_v = [&](int step) { return !EXACT || step >= tiles; };

  // Loads: TPR threads a row (the next power of two over the row's 16-byte
  // chunks, so a thread's chunk is fixed), THREADS / TPR rows a pass. Rows
  // past the sequence's end are left alone: the whole ring is zeroed first
  // (the K tiles' pad chunk with it: q's pad is zero too), so what a short
  // last tile leaves there is zero or an earlier tile: finite logits under
  // the mask and p v = 0.
  constexpr int TPR = T::VCH <= 8 ? 8 : T::VCH <= 16 ? 16 : 32;
  constexpr int RP = THREADS / TPR;
  static_assert(T::VCH <= 32 && RP >= 1 && KT % RP == 0, "tile loads");
  const int lr = tid / TPR;
  const int lc = tid % TPR;
  for (int i = tid; i < ring * T::STAGE_BYTES / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();  // the zeros are down before any copy lands on them

  // Start the copy of the K tile of `step`, and of its V tile where the
  // step multiplies by it, into `stage`, as core matrices; one commit group
  // a call whatever it copies.
  auto load = [&](int step, int stage) {
    if (lc < T::VCH && step < steps) {
      const int k0 = tile_of(step) * KT;
      const bool with_v = has_v(step);
      const bf16* ksrc = kb + (size_t)(k0 + lr) * ldk + lc * 8;
      const bf16* vsrc = vb + (size_t)(k0 + lr) * ldv + lc * 8;
      const unsigned dst = smem_base + stage * T::STAGE_BYTES + lc * 128;
      auto copy_rows = [&](auto all_rows) {
        const int rows = seq - k0 - lr;  // rows of this thread's chunk still inside
#pragma unroll
        for (int j = 0; j < KT / RP; ++j) {
          const int r = lr + j * RP;
          if (decltype(all_rows)::value || j * RP < rows) {
            const unsigned at = (r & 7) * 16;
            cp_async16s(dst + (r >> 3) * (T::KCH * 128) + at, ksrc + (size_t)j * RP * ldk);
            if (with_v)
              cp_async16s(dst + T::K_BYTES + (r >> 3) * (T::VCH * 128) + at,
                          vsrc + (size_t)j * RP * ldv);
          }
        }
      };
      if (k0 + KT <= seq)
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
    const bf16* q0 = qb + (size_t)min(row0, seq - 1) * ldq;
    const bf16* q1 = qb + (size_t)min(row0 + 8, seq - 1) * ldq;
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
  // (the first two) and g + 8. For those two rows: running maximum of the
  // raw logits (the same on the four lanes of a quad), this lane's share of
  // the running sum, and what the exponent subtracts: m c, and in EXACT
  // mode's second sweep m c + log2(row sum), which normalises inside the
  // exponential.
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float mx[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float sub[2] = {0.f, 0.f};

  // s = q k^T against the keys of the tile in `stage`; of a short last tile
  // only `valid` keys exist and the rest are masked. The K tile is K-major
  // for the matrix unit (a key's d run on): its descriptor steps 128 bytes
  // to the next 8 of d and a row group to the next 8 keys; a k-step is two
  // chunks on.
  const uint64_t k_desc = wg_desc(smem_base, 128, T::KCH * 128);
  auto qk = [&](int stage, float (&s)[32], int valid, auto masked) {
    const uint64_t ks = k_desc + wg_step(stage * T::STAGE_BYTES);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_n64(s, aq[kk], ks + wg_step(kk * 256), kk > 0);
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

  // The softmax of the tile in `stage` on its logits, the copies of step
  // `ahead` into the stage `fill` that the tile before has left, and
  // o += p v. MODE (a compile-time tag): ONLINE, the running softmax of K4;
  // STATS, K11's first sweep (max and sum only); NORMALISED, its second (the
  // exponent subtracts m c + log2(sum): no max, no sum).
  const uint64_t v_desc = wg_desc(smem_base + T::K_BYTES, T::VCH * 128, 128);
  auto softmax_pv = [&](int stage, int ahead, int fill, float (&s)[32], auto mode) {
    constexpr int MODE = decltype(mode)::value;
    if (MODE != NORMALISED) {
      float x0 = mx[0], x1 = mx[1];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        x0 = fmaxf(x0, fmaxf(s[4 * n], s[4 * n + 1]));
        x1 = fmaxf(x1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
      x0 = quad_max(x0);
      x1 = quad_max(x1);
      if (__any_sync(LS_FULL_MASK, x0 != mx[0] || x1 != mx[1])) {  // a maximum moved
        const float c0 = ex2((mx[0] - x0) * scale_log2);
        const float c1 = ex2((mx[1] - x1) * scale_log2);
        l[0] *= c0;
        l[1] *= c1;
        if (MODE == ONLINE) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            acc[4 * n] *= c0;
            acc[4 * n + 1] *= c0;
            acc[4 * n + 2] *= c1;
            acc[4 * n + 3] *= c1;
          }
        }
        mx[0] = x0;
        mx[1] = x1;
        sub[0] = x0 * scale_log2;
        sub[1] = x1 * scale_log2;
      }
    }
    uint32_t pa[KT / 16][4];  // p as the A fragments of the value product's four k-steps
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p00 = ex2(fmaf(s[4 * n], scale_log2, -sub[0]));
      const float p01 = ex2(fmaf(s[4 * n + 1], scale_log2, -sub[0]));
      const float p10 = ex2(fmaf(s[4 * n + 2], scale_log2, -sub[1]));
      const float p11 = ex2(fmaf(s[4 * n + 3], scale_log2, -sub[1]));
      if (MODE != NORMALISED) {
        l[0] += p00 + p01;
        l[1] += p10 + p11;
      }
      if (MODE != STATS) {
        pa[n / 2][(n & 1) * 2] = pack_bf16(p00, p01);
        pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p10, p11);
      }
    }
    load(ahead, fill);
    if (MODE == STATS) return;

    // The V tile is MN-major for the matrix unit (a key's d run on, and d is
    // the product's N): its descriptor steps a row group to the next 8 keys
    // and 128 bytes to the next 8 of d; a k-step is two row groups on.
    const uint64_t vs = v_desc + wg_step(stage * T::STAGE_BYTES);
    wg_fence();
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) wgmma_pv<D>(acc, pa[j], vs + wg_step(j * 2 * T::VCH * 128));
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
    if (full_tiles < tiles) tile_step(first + full_tiles, seq - full_tiles * KT, mode, Tag<true>{});
  };
  if (!EXACT) {
    sweep(0, Tag<ONLINE>{});
  } else {
    sweep(0, Tag<STATS>{});
#pragma unroll
    for (int r = 0; r < 2; ++r) sub[r] = fmaf(mx[r], scale_log2, __log2f(quad_sum(l[r])));
    sweep(tiles, Tag<NORMALISED>{});
  }
  cp_async_wait<0>();

  // EXACT: the probabilities were normalised before the product
  const float inv0 = EXACT ? 1.f : 1.f / quad_sum(l[0]);
  const float inv1 = EXACT ? 1.f : 1.f / quad_sum(l[1]);
  bf16* o0 = o + ((size_t)b * seq + row0) * ldo + (size_t)h * D + 2 * t;
  bf16* o1 = o0 + (size_t)8 * ldo;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (row0 < seq)
      *reinterpret_cast<bf162*>(o0 + n * 8) =
          __floats2bfloat162_rn(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
    if (row0 + 8 < seq)
      *reinterpret_cast<bf162*>(o1 + n * 8) =
          __floats2bfloat162_rn(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
  }
}

template <int D, int NWG, bool EXACT>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const int tiles = (a.seq + KT - 1) / KT;
  const int steps = EXACT ? 2 * tiles : tiles;
  const size_t smem = (size_t)(steps < STAGES ? steps : STAGES) * Tile<D>::STAGE_BYTES;
  cudaError_t e = ls_allow_smem(attn_kernel<D, NWG, EXACT>, smem);
  if (e != cudaSuccess) return e;
  constexpr int BQ = 64 * NWG;
  const int q_tiles = (a.seq + BQ - 1) / BQ;
  const long long blocks = (long long)q_tiles * a.heads * a.batch;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attn_kernel<D, NWG, EXACT><<<(unsigned)blocks, 128 * NWG, smem, s>>>(
      a.q, a.k, a.v, a.ldq, a.ldk, a.ldv, a.o, a.ldo, a.seq, a.heads, q_tiles,
      a.scale * LOG2E);
  return cudaGetLastError();
}

// Query rows a block: 128 (two warpgroups sharing each K/V tile) where a
// (batch, head) has at least two such tiles' worth of rows, one
// warpgroup's 64 below that.
static inline int pick_block_q(int seq) { return seq >= 256 ? 128 : 64; }

// block_q: 64, 128, or 0 for pick_block_q(seq).
template <int D, bool EXACT>
cudaError_t run(const Args& a, int block_q, cudaStream_t s) {
  if (a.seq <= 0 || a.heads <= 0 || !(a.scale > 0.f)) return cudaErrorInvalidValue;
  switch (block_q ? block_q : pick_block_q(a.seq)) {
    case 64: return launch<D, 1, EXACT>(a, s);
    case 128: return launch<D, 2, EXACT>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ls_core
