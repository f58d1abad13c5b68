// K2 in temporal mode: the whole self-attention block, keeping q/k/v on chip
//   out = x + Wo . SelfAttn_16 frames, per head(QKV(bf16(LN(x)) + pe)) + bo
// Replaces latentsync_tpu/ops/attn_block.py _kernel in temporal mode
// (pallas_call at attn_block.py:238), which kept LN(x), q/k/v and the
// attention output in VMEM. The port's first version was a chain of four
// launches (LN row pass, q/k/v product, the FMA core ls_attn::temporal,
// output product) whose intermediates crossed device memory: about 546 MB
// a call at (4096, 16, 320) where the function moves 84 MB.
//
// Rounding points are the plain version's (ops/attn_block.py
// self_attention_block_reference): bf16(LN(x)), then + pe in bf16; q, k, v
// in bf16; the attention output in bf16; the block output once. The
// probabilities go to the tensor cores as bf16, unnormalised (p <= 1), and
// the row sum is taken over the f32 values.
//
// Design. Persistent blocks walk row tiles of whole 16-frame sequences, a
// warpgroup 64 rows; warp w of a warpgroup owns rows 16w..16w+15: exactly
// one sequence. Shared memory holds, all in the 128-byte swizzle of
// wgmma.cuh (k-tiles of the tile's rows x 64 bf16):
//   ln  the tile's x, copied in by cp.async, then normalised in place (LPR
//       lanes a row, f32 two-pass statistics) into bf16 LN(x) + pe: the A
//       operand of the q/k/v products;
//   o   (head dim 40) the attention output, head by head: the A operand of
//       the output product;
//   a ring of STAGES weight k-tiles that cp.async fills ahead of the
//       products, across heads, phases and tiles: for each head the 3D rows
//       wq[hD..], wk[hD..], wv[hD..] of one k-tile (three pointers, no
//       concatenated weight), then for each pass of the output product its
//       rows of wo. Weights stay in L2.
// Per head, one wgmma m64n(3D)k16 chain gives each warpgroup its 64 rows'
// q | k | v in registers, in the accumulator layout that is mma.sync's
// m16n8 fragment layout, one sequence a warp. So the attention runs in the
// registers of the warp that holds the sequence, on mma.sync m16n8k16 (a
// 16-frame sequence is one m16 tile): q's accumulators are the A fragments
// of q k^T and k's the B fragments as they stand; the 16 x 16 logits and
// the softmax stay in registers; p's accumulator tiles are the A fragment of
// p v; v's 8 x 8 tiles are transposed in registers by movmatrix into p v's
// B fragments. q/k/v reach neither device nor shared memory.
//
// What bounds it (measured on an NVIDIA H100 80GB HBM3 at 700 W with pieces
// taken out, PERF.md): one block an SM (221 KB) runs its phases one after
// the other; at (4096, 16, 320) the k-loops alone take 0.08 ms, and the
// LayerNorm, the attention and the epilogue add 0.04-0.06 ms each. Two ways
// to overlap them lost: the attention and the LayerNorm between the issue
// and the wait of other k-tiles (0.256 against 0.229 ms: the warp that
// waits on the tensor cores is the one that issued to them), and two blocks
// of 64 rows an SM (0.316: the weights crossed from L2 twice as often). So
// head dim 40 (C = 320) is ONE launch of 128-row blocks: after the last
// head the output product (wgmma m64n160k16 from o and the ring) adds onto
// accumulators that start at the residual x (read from L2) plus the bias,
// in f32; one rounding, 16-byte stores after a quad transpose.
// Head dim 80 (C = 640) is two launches: ln and o (80 KB each at 64 rows)
// leave no room for a ring that hides the 30 KB k-tiles (at 64 rows and two
// stages the copies took 0.19 of 0.36 ms, measured). So a block takes 128
// rows (ln 160 KB) and writes the attention output to device memory (16-byte
// stores after a quad transpose), and the output product, bias and residual
// run on the GEMM template (gemm.cuh). q/k/v stay on chip at both.
//
// Traffic and bound: device memory sees x once and out once at D = 40
// (84 MB at (4096, 16, 320)), and the attention output twice more at D = 80
// (42 MB at (1024, 16, 640)); weight k-tiles cross from L2 once a tile. The
// products are 55 GFLOP at either served shape, so the bound is the tensor
// cores' (0.056 ms).
#pragma once

#include "gemm.cuh"

namespace ls_tblock {

using namespace ls_wg;

constexpr int TF = 16;           // frames of a sequence: one m16 tile
constexpr int RB = 128;          // bytes of a k-tile row: 64 bf16
constexpr int VPL = 5;           // 16-byte vectors a lane in the LN pass
constexpr int SMEM_MAX = 232448; // dynamic shared memory a block may have

template <int D>
struct Cfg;
// NWG warpgroups of 64 rows, STAGES ring stages, LPR lanes an x row in the
// LayerNorm pass (five 16-byte vectors a lane: C up to 40 LPR). OUT: the
// output product in this kernel, in passes of NO columns, its A operand (o)
// resident in shared memory; at D = 80 (C = 640) ln and o do not both fit
// beside 128 rows, so o goes to device memory and the output product to the
// GEMM template.
template <>
struct Cfg<40> {
  static constexpr int NWG = 2, STAGES = 3, LPR = 8, NO = 160;
  static constexpr bool OUT = true;
};
template <>
struct Cfg<80> {
  static constexpr int NWG = 2, STAGES = 2, LPR = 16, NO = 0;
  static constexpr bool OUT = false;
};

struct Args {
  const bf16* x;  // (m, c), m = batch * 16
  int m, c, inner, heads;
  const float* ln_w;
  const float* ln_b;
  float eps;
  const bf16* pe;  // (16, c) or null
  const bf16* wq;  // (inner, c) each
  const bf16* wk;
  const bf16* wv;
  const bf16* wo;  // (c, inner)
  const float* bo;
  float scale;
  bf16* out;  // (m, c)
  bf16* o;    // !Cfg<D>::OUT: the attention output (m, inner)
};

// d (16 x 8, f32) += a (16 x 16, bf16) x b (16 x 8, bf16), fragments in registers
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the 8 x 8 bf16 matrix held one pair a lane (lane 4g + t: row g, columns
// 2t, 2t+1), transposed in the same layout
__device__ __forceinline__ uint32_t transpose8x8(uint32_t v) {
  uint32_t r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(r) : "r"(v));
  return r;
}

// d (64 x N) += a x b^T of one k-step, both from shared memory
template <int N>
__device__ __forceinline__ void mma_n(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 120) wgmma_ss_n120(d, da, db, 1);
  if constexpr (N == 160) wgmma_ss_n160(d, da, db, 1);
  if constexpr (N == 240) wgmma_ss_n240(d, da, db, 1);
}

template <int D>
__global__ void __launch_bounds__(128 * Cfg<D>::NWG, 1)
    temporal_block_kernel(const Args p, int tiles) {
  constexpr int NWG = Cfg<D>::NWG;
  constexpr int NO = Cfg<D>::NO;
  constexpr int STAGES = Cfg<D>::STAGES;
  constexpr bool OUT = Cfg<D>::OUT;
  constexpr int BM = 64 * NWG;
  constexpr int THREADS = 128 * NWG;
  constexpr int NQ = 3 * D;                // q | k | v columns of one head
  constexpr int NS = NO > NQ ? NO : NQ;    // rows of a ring stage
  constexpr int STAGE_BYTES = NS * RB;
  constexpr int KT_BYTES = BM * RB;        // one k-tile of the ln or o region
  constexpr int ROWS_PASS = THREADS / 8;   // ring rows one copy pass covers
  constexpr int PASSES = (NS + ROWS_PASS - 1) / ROWS_PASS;
  constexpr int DT = D / 8;                // 8-column tiles of a head
  constexpr int KS = (D + 15) / 16;        // 16-deep k-steps of q k^T
  constexpr int NJG = (DT + 3) / 4;        // groups of four 8-column tiles of o
  constexpr int LPR = Cfg<D>::LPR;
  constexpr int RPW = 32 / LPR;            // x rows a warp normalises at once
  constexpr int SWEEPS = BM / (THREADS / 32 * RPW);  // LayerNorm sweeps of a tile
  static_assert(STAGE_BYTES % 1024 == 0 && D % 8 == 0 && NO % 32 == 0, "tile");

  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = (unsigned)__cvta_generic_to_shared(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);  // generic pointer to `base`

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int c = p.c;
  const int ktc = (c + 63) / 64;         // k-tiles of the q/k/v products
  const int kti = (p.inner + 63) / 64;   // k-tiles of the output product
  const int vpr = c / 8;                 // 16-byte vectors of an x row
  const unsigned ln_off = 0;
  const unsigned o_off = ktc * KT_BYTES;
  const unsigned ring_off = o_off + (OUT ? kti * KT_BYTES : 0);
  const int n_qkv = p.heads * ktc;
  const int n_out = OUT ? ((c + NO - 1) / NO) * kti : 0;
  const int per_tile = n_qkv + n_out;   // ring k-tiles a row tile consumes

  // byte offset of 16-byte chunk `i` (of a row's 8-column chunks) of row r
  // in the ln or o region
  auto at = [&](unsigned region, int r, int i) {
    return region + (i >> 3) * KT_BYTES + sw128_offset(r, i & 7);
  };

  // The k-tile tails past C (ln) and past inner (o) are zero, so the short
  // last k-tile adds nothing; no copy or store writes them later.
  {
    const int tail_c = ktc * 8 - vpr;
    for (int idx = tid; idx < BM * tail_c; idx += THREADS)
      *reinterpret_cast<uint4*>(gbase + at(ln_off, idx / tail_c, vpr + idx % tail_c)) =
          make_uint4(0, 0, 0, 0);
    if (OUT) {
      const int tail_i = kti * 8 - p.inner / 8;
      for (int idx = tid; idx < BM * tail_i; idx += THREADS)
        *reinterpret_cast<uint4*>(gbase + at(o_off, idx / tail_i, p.inner / 8 + idx % tail_i)) =
            make_uint4(0, 0, 0, 0);
    }
  }

  // x of row tile w into the ln region (rows past M zero-filled); the copies
  // join the next commit group of the ring
  auto load_x = [&](int w) {
    for (int idx = tid; idx < BM * vpr; idx += THREADS) {
      const int r = idx / vpr;
      const int i = idx - r * vpr;
      const int row = w * BM + r;
      const bool in_m = row < p.m;
      cp_async16z(base + at(ln_off, r, i), p.x + (in_m ? (size_t)row * c + 8 * i : 0),
                  in_m ? 16 : 0);
    }
  };

  // The ring's load cursor: row tile lw, k-tile li of that tile's sequence
  // (heads x ktc q/k/v k-tiles, then passes x kti output k-tiles).
  const int chunk = tid & 7;
  const int rip = tid >> 3;
  int lw = blockIdx.x;
  int li = 0;
  auto load = [&](int stage) {
    if (lw < tiles) {
      const unsigned dst = base + ring_off + stage * STAGE_BYTES;
      if (li < n_qkv) {
        const int h = li / ktc;
        const int col = (li - h * ktc) * 64 + chunk * 8;
        const bool in_k = col < c;
#pragma unroll
        for (int i = 0; i < PASSES; ++i) {
          const int r = rip + i * ROWS_PASS;
          if (r < NQ) {
            const int mat = r / D;
            const bf16* w = mat == 0 ? p.wq : mat == 1 ? p.wk : p.wv;
            cp_async16z(dst + sw128_offset(r, chunk),
                        w + (size_t)(h * D + r - mat * D) * c + (in_k ? col : 0), in_k ? 16 : 0);
          }
        }
      } else if (OUT) {
        const int j = li - n_qkv;
        const int nc = j / kti;
        const int col = (j - nc * kti) * 64 + chunk * 8;
        const bool in_k = col < p.inner;
#pragma unroll
        for (int i = 0; i < PASSES; ++i) {
          const int r = rip + i * ROWS_PASS;
          if (r < NO) {
            const int row = min(nc * NO + r, c - 1);  // rows past C: computed, not stored
            cp_async16z(dst + sw128_offset(r, chunk),
                        p.wo + (size_t)row * p.inner + (in_k ? col : 0), in_k ? 16 : 0);
          }
        }
      }
      if (++li == per_tile) {
        li = 0;
        lw += gridDim.x;
      }
    }
    cp_async_commit();
  };

  load_x(blockIdx.x);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);

  const uint64_t ring_desc = wg_desc_sw128(base + ring_off);
  int stage = 0;
  // One ring k-tile: wait for it, `issue` the products that read it, then
  // `before` and the copies STAGES - 1 k-tiles ahead while they run.
  auto ring_step = [&](auto issue, auto before) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of the k-tile have landed
    fence_async_proxy();          // and every normal store to ln / o is visible to wgmma
    __syncthreads();
    const uint64_t db = ring_desc + wg_step(stage * STAGE_BYTES);
    wg_fence();
    issue(db);
    wg_commit();
    before();
    load(stage == 0 ? STAGES - 1 : stage - 1);
    wg_wait();
    stage = stage + 1 == STAGES ? 0 : stage + 1;
  };
  // sum over the LPR lanes of one row (aligned groups of the warp)
  auto row_sum = [](float v) {
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(LS_FULL_MASK, v, o);
    return v;
  };

  // ---- LayerNorm in place: LPR lanes a row and RPW rows a warp at a time,
  // the row in registers ----
  auto ln_tile = [&]() {
    const int sl = lane % LPR;
#pragma unroll 1
    for (int sweep = 0; sweep < SWEEPS; ++sweep) {
      const int r = (sweep * (THREADS / 32) + (tid >> 5)) * RPW + lane / LPR;
      uint4 v[VPL];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int i = sl + LPR * j;
        if (i < vpr) {
          v[j] = *reinterpret_cast<const uint4*>(gbase + at(ln_off, r, i));
          const bf16* e = reinterpret_cast<const bf16*>(&v[j]);
#pragma unroll
          for (int t = 0; t < 8; ++t) s += __bfloat162float(e[t]);
        }
      }
      const float mu = row_sum(s) / c;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        if (sl + LPR * j < vpr) {
          const bf16* e = reinterpret_cast<const bf16*>(&v[j]);
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const float dv = __bfloat162float(e[t]) - mu;
            sq += dv * dv;
          }
        }
      }
      const float rstd = rsqrtf(row_sum(sq) / c + p.eps);
      const bf16* per = p.pe == nullptr ? nullptr : p.pe + (size_t)(r % TF) * c;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int i = sl + LPR * j;
        if (i < vpr) {
          bf16* e = reinterpret_cast<bf16*>(&v[j]);
          float wv[8], bv[8];
          *reinterpret_cast<float4*>(wv) = *reinterpret_cast<const float4*>(p.ln_w + 8 * i);
          *reinterpret_cast<float4*>(wv + 4) = *reinterpret_cast<const float4*>(p.ln_w + 8 * i + 4);
          *reinterpret_cast<float4*>(bv) = *reinterpret_cast<const float4*>(p.ln_b + 8 * i);
          *reinterpret_cast<float4*>(bv + 4) = *reinterpret_cast<const float4*>(p.ln_b + 8 * i + 4);
#pragma unroll
          for (int t = 0; t < 8; ++t)
            e[t] = __float2bfloat16((__bfloat162float(e[t]) - mu) * rstd * wv[t] + bv[t]);
          if (per != nullptr) {
            const uint4 pv = *reinterpret_cast<const uint4*>(per + 8 * i);
            const bf16* pb = reinterpret_cast<const bf16*>(&pv);
#pragma unroll
            for (int t = 0; t < 8; ++t)
              e[t] = __float2bfloat16(__bfloat162float(e[t]) + __bfloat162float(pb[t]));
          }
          *reinterpret_cast<uint4*>(gbase + at(ln_off, r, i)) = v[j];
        }
      }
    }
  };

  // ---- the attention of one head, from its q | k | v accumulators
  // packed to bf16 fragments: the logits and softmax (piece 0), then the
  // value product and the stores of four 8-column tiles of o at a time ----
  // accumulator tile j (columns 8j..8j+7) is acc[4j..4j+3]: rows g and g + 8
  // of this warp's sequence, columns 2t, 2t+1. Tiles 0..DT-1 are q,
  // DT..2DT-1 k, 2DT..3DT-1 v.
  uint32_t qa[KS][4];      // q k^T's A fragments
  uint32_t kb[2][KS][2];   // its B fragments, keys 0-7 and 8-15
  uint32_t vp[DT][2];      // v's 8 x 8 tiles, keys 0-7 and 8-15
  uint32_t pa[4];          // the probabilities: p v's A fragment
  float inv0 = 0.f, inv1 = 0.f;
  auto pack = [&](const float (&acc)[NQ / 2]) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int j0 = 2 * kk, j1 = 2 * kk + 1;
      qa[kk][0] = pack_bf16(acc[4 * j0], acc[4 * j0 + 1]);
      qa[kk][1] = pack_bf16(acc[4 * j0 + 2], acc[4 * j0 + 3]);
      qa[kk][2] = j1 < DT ? pack_bf16(acc[4 * j1], acc[4 * j1 + 1]) : 0u;
      qa[kk][3] = j1 < DT ? pack_bf16(acc[4 * j1 + 2], acc[4 * j1 + 3]) : 0u;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {  // keys 8nt..8nt+7 are rows g (+ 8nt) of k
        kb[nt][kk][0] = pack_bf16(acc[4 * (DT + j0) + 2 * nt], acc[4 * (DT + j0) + 2 * nt + 1]);
        kb[nt][kk][1] = j1 < DT ? pack_bf16(acc[4 * (DT + j1) + 2 * nt],
                                            acc[4 * (DT + j1) + 2 * nt + 1])
                                : 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      vp[j][0] = pack_bf16(acc[4 * (2 * DT + j)], acc[4 * (2 * DT + j) + 1]);
      vp[j][1] = pack_bf16(acc[4 * (2 * DT + j) + 2], acc[4 * (2 * DT + j) + 3]);
    }
  };
  auto piece = [&](auto pc, int h, int w) {
    constexpr int PC = decltype(pc)::value;
    if constexpr (PC > NJG) {
      return;
    } else if constexpr (PC == 0) {  // logits and softmax of rows g and g + 8 over 16 keys
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) mma16816(s[nt], qa[kk], kb[nt][kk][0], kb[nt][kk][1]);
      }
      float m0 = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
      float m1 = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(LS_FULL_MASK, m0, o));
        m1 = fmaxf(m1, __shfl_xor_sync(LS_FULL_MASK, m1, o));
      }
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        s[nt][0] = __expf((s[nt][0] - m0) * p.scale);
        s[nt][1] = __expf((s[nt][1] - m0) * p.scale);
        s[nt][2] = __expf((s[nt][2] - m1) * p.scale);
        s[nt][3] = __expf((s[nt][3] - m1) * p.scale);
        l0 += s[nt][0] + s[nt][1];
        l1 += s[nt][2] + s[nt][3];
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        l0 += __shfl_xor_sync(LS_FULL_MASK, l0, o);
        l1 += __shfl_xor_sync(LS_FULL_MASK, l1, o);
      }
      inv0 = 1.f / l0;
      inv1 = 1.f / l1;
      // the two 8-key tiles of p are one 16-deep A fragment
      pa[0] = pack_bf16(s[0][0], s[0][1]);
      pa[1] = pack_bf16(s[0][2], s[0][3]);
      pa[2] = pack_bf16(s[1][0], s[1][1]);
      pa[3] = pack_bf16(s[1][2], s[1][3]);
    } else {  // o's 8-column tiles 4(PC-1) .. 4(PC-1)+3
      constexpr int J0 = 4 * (PC - 1);
      constexpr int JN = DT - J0 < 4 ? DT - J0 : 4;  // tiles of this group
      const int orow = wg * 64 + warp * 16 + g;
      uint32_t lo[4] = {0u, 0u, 0u, 0u}, hi[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int jj = 0; jj < JN; ++jj) {
        float o[4] = {0.f, 0.f, 0.f, 0.f};
        mma16816(o, pa, transpose8x8(vp[J0 + jj][0]), transpose8x8(vp[J0 + jj][1]));
        lo[jj] = pack_bf16(o[0] * inv0, o[1] * inv0);
        hi[jj] = pack_bf16(o[2] * inv1, o[3] * inv1);
        if (OUT) {  // into the o region: A of the output product
          const unsigned off = at(o_off, orow, (h * D >> 3) + J0 + jj) + 4 * t4;
          *reinterpret_cast<uint32_t*>(gbase + off) = lo[jj];
          *reinterpret_cast<uint32_t*>(gbase + off + 8 * RB) = hi[jj];
        }
      }
      if (!OUT) {  // to device memory, 16 bytes a lane after a quad transpose
        ls_gemm::quad_transpose(lo, t4);
        ls_gemm::quad_transpose(hi, t4);
        const int row0 = w * BM + orow;
        if (J0 + t4 < DT) {
          const size_t col = (size_t)h * D + 8 * (J0 + t4);
          if (row0 < p.m)
            *reinterpret_cast<uint4*>(p.o + (size_t)row0 * p.inner + col) =
                make_uint4(lo[0], lo[1], lo[2], lo[3]);
          if (row0 + 8 < p.m)
            *reinterpret_cast<uint4*>(p.o + (size_t)(row0 + 8) * p.inner + col) =
                make_uint4(hi[0], hi[1], hi[2], hi[3]);
        }
      }
    }
  };
  static_assert(NJG <= 3, "o tile groups");

  for (int w = blockIdx.x; w < tiles; w += gridDim.x) {
    cp_async_wait<0>();  // this tile's x has landed
    __syncthreads();
    ln_tile();

    // ---- per head: q | k | v by wgmma, then the attention in the warp's
    // registers ----
    for (int h = 0; h < p.heads; ++h) {
      float acc[NQ / 2];
#pragma unroll
      for (int i = 0; i < NQ / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < ktc; ++kt) {
        const uint64_t da = wg_desc_sw128(base + ln_off + kt * KT_BYTES + wg * 64 * RB);
        ring_step(
            [&](uint64_t db) {
#pragma unroll
              for (int ks = 0; ks < 4; ++ks)
                mma_n<NQ>(acc, da + wg_step(32 * ks), db + wg_step(32 * ks));
            },
            [] {});
      }
      pack(acc);
      piece(Tag<0>{}, h, w);
      piece(Tag<1>{}, h, w);
      piece(Tag<2>{}, h, w);
      piece(Tag<3>{}, h, w);
    }

    if constexpr (OUT) {
      // ---- output product, bias and residual; the next tile's x starts
      // into the ln region, which it leaves alone ----
      const int row0 = w * BM + wg * 64 + warp * 16 + g;
      const int row1 = row0 + 8;
      for (int nc = 0; nc * NO < c; ++nc) {
        const int n0 = nc * NO;
        // the accumulators start at the residual plus the bias (f32), so the
        // products add onto them and the epilogue only rounds and stores
        float acc[NO / 2];
#pragma unroll
        for (int j = 0; j < NO / 8; ++j) {
          const int col = n0 + 8 * j + 2 * t4;
          float2 v0 = make_float2(0.f, 0.f), v1 = v0;
          if (col < c) {
            const float2 bv = *reinterpret_cast<const float2*>(p.bo + col);
            v0 = v1 = bv;
            if (row0 < p.m) {
              const float2 rv = __bfloat1622float2(
                  *reinterpret_cast<const bf162*>(p.x + (size_t)row0 * c + col));
              v0.x += rv.x; v0.y += rv.y;
            }
            if (row1 < p.m) {
              const float2 rv = __bfloat1622float2(
                  *reinterpret_cast<const bf162*>(p.x + (size_t)row1 * c + col));
              v1.x += rv.x; v1.y += rv.y;
            }
          }
          acc[4 * j] = v0.x; acc[4 * j + 1] = v0.y;
          acc[4 * j + 2] = v1.x; acc[4 * j + 3] = v1.y;
        }
        for (int kt = 0; kt < kti; ++kt) {
          const uint64_t da = wg_desc_sw128(base + o_off + kt * KT_BYTES + wg * 64 * RB);
          ring_step(
              [&](uint64_t db) {
#pragma unroll
                for (int ks = 0; ks < 4; ++ks)
                  mma_n<NO>(acc, da + wg_step(32 * ks), db + wg_step(32 * ks));
              },
              [&] {
                if (nc == 0 && kt == 0 && w + (int)gridDim.x < tiles) load_x(w + gridDim.x);
              });
        }
#pragma unroll
        for (int q = 0; q < NO / 32; ++q) {
          uint32_t lo[4], hi[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * q + jj;
            lo[jj] = pack_bf16(acc[4 * j], acc[4 * j + 1]);
            hi[jj] = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
          }
          ls_gemm::quad_transpose(lo, t4);
          ls_gemm::quad_transpose(hi, t4);
          const int col8 = n0 + 8 * (4 * q + t4);
          if (col8 < c) {
            if (row0 < p.m)
              *reinterpret_cast<uint4*>(p.out + (size_t)row0 * c + col8) =
                  make_uint4(lo[0], lo[1], lo[2], lo[3]);
            if (row1 < p.m)
              *reinterpret_cast<uint4*>(p.out + (size_t)row1 * c + col8) =
                  make_uint4(hi[0], hi[1], hi[2], hi[3]);
          }
        }
      }
    } else {
      // the ln region is free once every warp's last products have ended
      __syncthreads();
      if (w + (int)gridDim.x < tiles) load_x(w + gridDim.x);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();  // no copy is left in flight when the block ends
}

template <int D>
cudaError_t launch(const Args& p, cudaStream_t s) {
  constexpr int BM = 64 * Cfg<D>::NWG;
  constexpr int NS = Cfg<D>::NO > 3 * D ? Cfg<D>::NO : 3 * D;
  const int ktc = (p.c + 63) / 64;
  const int kti = Cfg<D>::OUT ? (p.inner + 63) / 64 : 0;
  const long long smem =
      (long long)(ktc + kti) * BM * RB + (long long)Cfg<D>::STAGES * NS * RB + 1024;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e = ls_allow_smem(temporal_block_kernel<D>, (size_t)smem);
  if (e != cudaSuccess) return e;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
  }
  const int tiles = (p.m + BM - 1) / BM;
  const int blocks = tiles < sms ? tiles : sms;
  temporal_block_kernel<D><<<blocks, 128 * Cfg<D>::NWG, (size_t)smem, s>>>(p, tiles);
  if ((e = cudaGetLastError()) != cudaSuccess || Cfg<D>::OUT) return e;
  // D = 80: the output product, bias and residual on the GEMM template
  ls_gemm::Args o = {};
  o.a = p.o;
  o.lda = p.inner;
  o.b = p.wo;
  o.ldb = p.inner;
  o.c = p.out;
  o.ldc = p.c;
  o.m = p.m;
  o.n = p.c;
  o.k = p.inner;
  o.bias = p.bo;
  o.res = p.x;
  o.ldr = p.c;
  return ls_gemm::gemm(o, s);
}

// The widest C the LayerNorm pass reaches at head dim d (0: no kernel for d)
static inline int max_c(int d) {
  return d == 40 ? 8 * VPL * Cfg<40>::LPR : d == 80 ? 8 * VPL * Cfg<80>::LPR : 0;
}

// K2's temporal mode: one launch at head dim 40 (C up to 320), two at 80 (C
// up to 640: this kernel, then the output product on the GEMM template,
// p.o its scratch); inner = heads * D, C a multiple of 8 (and what shared
// memory holds); refused otherwise.
static inline cudaError_t temporal_block(const Args& p, cudaStream_t s) {
  if (p.m <= 0 || p.m % TF || p.c <= 0 || p.c % 8 || p.heads <= 0 || p.inner % p.heads ||
      (long long)p.m * p.c > 0x7fffffffLL || (long long)p.m * p.inner > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int d = p.inner / p.heads;
  if (p.c > max_c(d)) return cudaErrorInvalidValue;
  if (d == 40) return launch<40>(p, s);
  if (p.o != nullptr) return launch<80>(p, s);
  return cudaErrorInvalidValue;
}

// The same from the entry point's flat arguments (ls_temporal_block)
static inline cudaError_t temporal_block(const void* x, int batch, int c, int inner, int heads,
                                         const float* ln_w, const float* ln_b, float eps,
                                         const void* pe, const void* wq, const void* wk,
                                         const void* wv, const void* wo, const float* bo,
                                         float scale, void* attn, void* out, cudaStream_t s) {
  Args p = {};
  p.x = static_cast<const bf16*>(x);
  p.m = batch * TF;
  p.c = c;
  p.inner = inner;
  p.heads = heads;
  p.ln_w = ln_w;
  p.ln_b = ln_b;
  p.eps = eps;
  p.pe = static_cast<const bf16*>(pe);
  p.wq = static_cast<const bf16*>(wq);
  p.wk = static_cast<const bf16*>(wk);
  p.wv = static_cast<const bf16*>(wv);
  p.wo = static_cast<const bf16*>(wo);
  p.bo = bo;
  p.scale = scale;
  p.o = static_cast<bf16*>(attn);
  p.out = static_cast<bf16*>(out);
  return temporal_block(p, s);
}

}  // namespace ls_tblock
