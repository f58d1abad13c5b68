// The gradient of the flash route (flash_attention.cu): dQ, dK and dV of
// unmasked softmax attention over (B, S, H, D) bf16, with the probabilities
// rounded to bf16 before the value product (the forward's P_ROUNDED):
//   P  = softmax(scale * Q K^T) = 2^(s c - lse),  c = scale * log2(e)
//   dV = bf16(P)^T dO
//   dP = dO V^T
//   dS = P * (dP - delta) * scale,  delta = rowsum(O * dO)
//   dQ = bf16(dS) K,  dK = bf16(dS)^T Q
// Replaces the VJP of jax's library TPU flash kernel that the reference's
// route reaches (latentsync_tpu/ops/attention.py _flash_bshd :85, routed at
// :51-59): _flash_attention_bwd_dkv (jax flash_attention.py :941, its
// pallas_call :1121) and _flash_attention_bwd_dq (:1287 / :1456). On the
// training path: the VAE mid-block's decode, (16, 1024, 1, 512); and, through
// K4's and K2's composed gradients (_spatial_xla routes its attention), the
// UNet's spatial attention at (16, 1024, 8, 40) and (16, 256, 8, 80); and
// CodeFormer's transformer in its stage-II training
// (latentsync_tpu/training/restoration_trainer.py), (B, 256, 8, 64) nine
// times a step (stage III's losses reach the transformer only through the
// argmax of its codes, so no backward runs there).
//
// jax's structure, not its blocks: the forward keeps each row's log-sum-exp
// (the core's LSE instantiation, attn_core.cuh: one f32 a row, base 2, as
// save_residuals keeps l and m), so no launch sweeps the keys for row
// statistics; delta is rowsum(o * do) from the forward's bf16 output, as
// jax's di; and there are two launches, seven products of S^2 D in all (the
// function needs five; s and dp are computed in each launch):
//   1. dQ: a warpgroup owns 64 query rows, writes their delta, and sweeps the
//      keys: s = q k^T and dp = do v^T on wgmma, P and dS in registers, and
//      dQ += bf16(dS) k on wgmma with dS as the register A operand and the K
//      tile as the MN-major B operand (the descriptor the core has for V);
//   2. dK / dV, after the first because it reads delta: a warpgroup owns 64
//      keys and sweeps the queries: s^T = k q^T and dp^T = v do^T, P^T and
//      dS^T in registers, dV += bf16(P^T) do and dK += bf16(dS^T) q.
// Both are one template, the roles of the operands swapped: a warpgroup's own
// 64 rows (q and do in 1, k and v in 2) are the A side of the first two
// products, the streamed tiles (k and v in 1, q and do in 2) their B side and
// the B side of the output products, lse and delta belong to the own rows in 1
// and to the streamed ones in 2. dQ is summed in one block's registers, as
// jax's dq kernel sums it: no atomics, and two calls give equal bits.
//
// Head dims 40, 64 and 80 (the row kernel): as the core's row tiling, the own
// rows' A fragments straight from device memory into registers (D
// zero-padded to the 16-deep k-step: 48 / 64 / 80), streamed tiles of 64 rows
// in the core's Tile<D> layout (K-major for the first two products,
// MN-major for the output products, whose N is D itself: m64n40 / m64n64 /
// m64n80, no padding there) behind a 3-stage cp.async ring, one barrier a
// tile; two warpgroups a block share the tiles. At D = 40 and 80 the layout
// is 8-row x 16-byte core matrices; at D = 64 a streamed row is one 128-byte
// atom and the tiles lie in the 128-byte swizzle (Tile<64>::SW, as the
// forward keeps its K and V tiles there): each stage starts 1024-aligned,
// a K-major k-step moves 32 bytes inside the atom (Tile::k_step) and an
// MN-major one 16 rows, 2048 bytes (Tile::v_step, which equals the core
// matrices' 2 KCH 128 at KCH = 8).
//
// D = 512 (the wide kernel): a 64-row tile's f32 dK and dV (256 KB) do not
// fit one SM's registers, so the 512 columns are split over a cluster of two
// blocks. Block r holds columns [256 r, 256 r + 256) of its own rows (q and
// do, or k and v: 64 KB in the 128-byte swizzle) and streams the same half of
// 32-row tiles through a 2-stage ring. Per tile, warpgroup 0 forms the
// partial s over the block's half of D and warpgroup 1 the partial dp
// (m64n32, both operands from shared memory). Each partial goes to the other
// block's shared memory by asynchronous remote stores (st.async) that count
// their bytes on a transaction barrier there, and to this block's other
// warpgroup through its own shared memory; every warpgroup then adds the
// two halves it needs (one addition of two terms: the same bits in all
// four). Then, in 1, each warpgroup adds bf16(dS) k to 128 of the block's dQ
// columns (m64n128); in 2, warpgroup 0 adds bf16(P^T) do to dV and
// warpgroup 1 bf16(dS^T) q to dK, 256 columns each (m64n256). The remote
// buffers alternate between two sets, each with its barrier: a block writes
// set i % 2 for tile i + 2 only after it has seen the other's tile i + 1,
// which that block sends after it has read tile i, so no barrier a tile
// spans the cluster (a cluster barrier a tile, the first design, was
// slower: both blocks waited at every tile for the later one). Not one block
// of four warpgroups over 32 keys instead (the forward's attn_wide_kernel
// splits its columns so): wgmma's accumulator has 64 rows, so 32 keys' f32
// dK and dV take the registers of 64 (64 x 1024 x 4 bytes, the whole
// register file); and a block that holds all 512 columns of its own 64 rows
// (128 KB) and of a 32-row streamed stage (64 KB) has room for one stage,
// not a ring, in the 227 KB a block may use.
//
// Bound: operations, 10 S^2 D FLOP a (batch, head) for the five products the
// function needs; at (16, 1024, 1, 512) 85.9 GFLOP. Measured on an NVIDIA
// H100 80GB HBM3 at 700.00 W (PERF.md section 6): 15-19 % of the bound at
// the three shapes above; at D = 512 the exchange is a third of the time,
// at D = 40 the phases add up (a block's two warpgroups meet at every
// tile's barrier) and the copies alone take a third. At CodeFormer's
// (4, 256, 8, 64) the bound is bytes instead: q, k, v and do read, dq, dk
// and dv written, seven tensors of 1.05 MB, 2.2 us at 3.35 TB/s
// beside 1.34 GFLOP, 1.4 us at the bf16 peak.
#include <cooperative_groups.h>

#include "attn_core.cuh"

namespace {

using namespace ls_core;
using namespace ls_wg;
namespace cgr = cooperative_groups;

// o, dout and the three gradients are contiguous (B, S, H, D): row pitch H D
struct Bwd {
  const bf16 *q, *k, *v, *o, *dout;
  int ldq, ldk, ldv;
  bf16 *dq, *dk, *dv;
  const float* lse;  // (B, H, S): the forward's log-sum-exp, base 2
  float* delta;      // (B, H, S): written by launch 1, read by launch 2
  int seq, heads;
  float scale;
};

// The operands of a launch: the own rows' x (the A side of s) and y (of dp),
// the streamed tiles' sx (the B side of s, and of the output product dQ or
// dK) and sy (of dp, and of dV), each with its row pitch.
struct Roles {
  const bf16 *x, *y, *sx, *sy;
  int ldx, ldy, ldsx, ldsy;
};

template <bool DKDV>
__device__ __forceinline__ Roles roles(const Bwd& a, int hd) {
  if constexpr (DKDV)
    return {a.k, a.v, a.q, a.dout, a.ldk, a.ldv, a.ldq, hd};
  else
    return {a.q, a.dout, a.k, a.v, a.ldq, hd, a.ldk, a.ldv};
}

__device__ __forceinline__ float dot2(uint32_t a, uint32_t b) {
  return bf16_lo(a) * bf16_lo(b) + bf16_hi(a) * bf16_hi(b);
}

// an N-column accumulator (tile n in acc[4n..4n+3]: rows g and g + 8,
// columns 8n + 2t + {0, 1}) as bf16 into rows out and out + 8 ld
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2], bf16* out, int ld) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    *reinterpret_cast<bf162*>(out + n * 8) = __floats2bfloat162_rn(acc[4 * n], acc[4 * n + 1]);
    *reinterpret_cast<bf162*>(out + (size_t)8 * ld + n * 8) =
        __floats2bfloat162_rn(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// P of one element from its logit and its query's lse (base 2)
__device__ __forceinline__ float prob(float s, float scale_log2, float lse) {
  return ex2(fmaf(s, scale_log2, -lse));
}

// transaction barriers in shared memory (mbarrier), for the wide kernel's
// exchange between the two blocks of a cluster
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// this block's arrival on `bar`, expecting `bytes` more to land on it
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// wait for the phase of `bar` with this parity to complete; what the other
// block stored before it counted its bytes is then visible
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nLS_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LS_WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// the address of shared-memory address `addr` in block `rank` of the cluster
__device__ __forceinline__ unsigned cluster_addr(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// 16 bytes into the other block's shared memory (cluster address `dst`),
// counted on its barrier (cluster address `bar`)
__device__ __forceinline__ void st_async16(unsigned dst, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// D = 40 and 80: the row kernel
// ---------------------------------------------------------------------------

constexpr int RING = 3;  // stages of the row kernel's ring

// bytes of one stage: the sx and sy tiles (KT rows in core matrices, D
// padded to the k-step, or KT 128-byte rows in the swizzle), and in launch 2
// the lse and delta of their rows; a swizzled stage is rounded up to 1024
// bytes, so that every stage's tiles start on the swizzle's alignment
template <int D, bool DKDV>
__host__ __device__ constexpr int row_stage_bytes() {
  constexpr int bytes = 2 * (KT / 8 * Tile<D>::KCH * 128) + (DKDV ? 2 * KT * 4 : 0);
  return Tile<D>::SW ? (bytes + 1023) / 1024 * 1024 : bytes;
}

// a warp's A fragments of own rows r0 (its rows g) and r1 (g + 8), D
// zero-padded to KS k-steps, straight from device memory, as the core loads q
template <int D, int KS>
__device__ __forceinline__ void own_frags(uint32_t (&f)[KS][4], const bf16* r0, const bf16* r1,
                                          int t) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + 2 * t;
    f[kk][0] = c < D ? ld32(r0 + c) : 0u;
    f[kk][1] = c < D ? ld32(r1 + c) : 0u;
    f[kk][2] = c + 8 < D ? ld32(r0 + c + 8) : 0u;
    f[kk][3] = c + 8 < D ? ld32(r1 + c + 8) : 0u;
  }
}

// DKDV false: launch 1 (dQ, delta); true: launch 2 (dK, dV). NWG
// warpgroups a block, 64 own rows each; seq % (64 NWG) == 0.
template <int D, int NWG, bool DKDV>
__global__ void __launch_bounds__(128 * NWG)
    bwd_row_kernel(Bwd a, int own_tiles, float scale_log2) {
  using T = Tile<D>;
  constexpr int KS = T::KS, KCH = T::KCH, VCH = T::VCH;
  constexpr int THREADS = 128 * NWG;
  constexpr int TILE = KT / 8 * KCH * 128;
  constexpr int STAGE = row_stage_bytes<D, DKDV>();
  constexpr int NT = KT / 8;  // 8-column tiles of a logit tile
  constexpr bool SW = T::SW;  // D = 64: the 128-byte swizzle, from a 1024-aligned ring
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const unsigned smem_pad = SW ? -(unsigned)__cvta_generic_to_shared(smem_raw) & 1023u : 0u;
  unsigned char* smem = smem_raw + smem_pad;
  const unsigned smem_base = (unsigned)__cvta_generic_to_shared(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x / own_tiles;  // the tiles of one (batch, head) run together
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int hd = a.heads * D;
  const size_t row_base = (size_t)b * a.seq;
  const size_t col = (size_t)h * D;
  const Roles r = roles<DKDV>(a, hd);
  const bf16* x = r.x + row_base * r.ldx + col;
  const bf16* y = r.y + row_base * r.ldy + col;
  const bf16* sx = r.sx + row_base * r.ldsx + col;
  const bf16* sy = r.sy + row_base * r.ldsy + col;
  const float* lse = a.lse + (size_t)bh * a.seq;
  float* delta = a.delta + (size_t)bh * a.seq;
  const int tiles = a.seq / KT;

  for (int i = tid; i < RING * STAGE / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();  // the zeros (every row's pad chunk) are down before any copy lands

  // the sx and sy tiles of `tile` into `stage` as core matrices (row r,
  // chunk c at (r / 8) KCH 128 + c 128 + (r % 8) 16; chunks past D stay
  // zero) or, at D = 64, in the swizzle (sw128_offset(r, c)), and in launch
  // 2 the lse and delta of their rows; one commit group a call whatever it
  // copies
  auto load = [&](int tile, int stage) {
    if (tile < tiles) {
      const size_t r0 = (size_t)tile * KT;
      const unsigned dst = smem_base + stage * STAGE;
      for (int i = tid; i < KT * VCH; i += THREADS) {
        const int row = i / VCH;
        const int c = i - row * VCH;
        const unsigned at =
            SW ? sw128_offset(row, c) : (row >> 3) * (KCH * 128) + c * 128 + (row & 7) * 16;
        cp_async16s(dst + at, sx + (r0 + row) * r.ldsx + c * 8);
        cp_async16s(dst + TILE + at, sy + (r0 + row) * r.ldsy + c * 8);
      }
      if constexpr (DKDV) {
        if (tid < KT / 2) {  // 16 chunks of lse, then 16 of delta
          const float* src = (tid < KT / 4 ? lse : delta) + r0 + (tid % (KT / 4)) * 4;
          cp_async16s(dst + 2 * TILE + tid * 16, src);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < RING - 1; ++st) load(st, st);

  const int row0 = (blockIdx.x % own_tiles) * 64 * NWG + warp * 16 + g;
  uint32_t ax[KS][4], ay[KS][4];
  own_frags<D>(ax, x + (size_t)row0 * r.ldx, x + (size_t)(row0 + 8) * r.ldx, t);
  own_frags<D>(ay, y + (size_t)row0 * r.ldy, y + (size_t)(row0 + 8) * r.ldy, t);

  // launch 1: the own rows' lse, and their delta = rowsum(o do) (do is y)
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  if constexpr (!DKDV) {
    const bf16* o = a.o + row_base * hd + col;
    uint32_t ao[KS][4];
    own_frags<D>(ao, o + (size_t)row0 * hd, o + (size_t)(row0 + 8) * hd, t);
    float u0 = 0.f, u1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      u0 += dot2(ao[kk][0], ay[kk][0]) + dot2(ao[kk][2], ay[kk][2]);
      u1 += dot2(ao[kk][1], ay[kk][1]) + dot2(ao[kk][3], ay[kk][3]);
    }
    delta_r[0] = quad_sum(u0);
    delta_r[1] = quad_sum(u1);
    if (t == 0) {
      delta[row0] = delta_r[0];
      delta[row0 + 8] = delta_r[1];
    }
    lse_r[0] = lse[row0];
    lse_r[1] = lse[row0 + 8];
  }

  // launch 1: dQ in acc; launch 2: dK in acc, dV in acc2
  float acc[D / 2], acc2[DKDV ? D / 2 : 1];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DKDV ? D / 2 : 1); ++i) acc2[i] = 0.f;

  // A streamed tile is K-major for s and dp (a row's D runs on, D is their
  // K: 128 bytes to the next 8 of D, a row group to the next 8 rows) and
  // MN-major for the output products (its rows are their K, D their N: a
  // row group to the next 8 rows, 128 bytes to the next 8 of D), from one
  // layout, as the core reads its K and V tiles. (Swizzled: wgmma.cuh; the
  // MN-major N = 64 is one atom, so its leading step is not used.)
  const uint64_t kdesc = SW ? wg_desc_sw128(smem_base) : wg_desc(smem_base, 128, KCH * 128);
  const uint64_t ndesc =
      SW ? wg_desc_sw128_mn(smem_base, T::ATOM) : wg_desc(smem_base, KCH * 128, 128);
  int stage = 0;
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<RING - 2>();  // this thread's copies of tile i have landed
    fence_async_proxy();        // the copies and the zeros, for the matrix unit
    __syncthreads();            // everyone's have, and tile i - 1 has been read
    load(i + RING - 1, stage == 0 ? RING - 1 : stage - 1);
    const int sb = stage * STAGE;
    float s[4 * NT], dp[4 * NT];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_n64(s, ax[kk], kdesc + wg_step(sb + T::k_step(kk)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_n64(dp, ay[kk], kdesc + wg_step(sb + TILE + T::k_step(kk)), kk > 0);
    wg_commit();
    wg_wait();

    // P and dS of the tile as the A fragments of the output products' four
    // k-steps (two adjacent 8-column tiles are one 16-deep A tile)
    const float* st = reinterpret_cast<const float*>(smem + sb + 2 * TILE);
    uint32_t fs[KT / 16][4], fp[DKDV ? KT / 16 : 1][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float l[4], dl[4];
      if constexpr (DKDV) {  // the columns' (streamed queries')
        const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * n + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(st + KT + 8 * n + 2 * t);
        l[0] = l[2] = l2.x;
        l[1] = l[3] = l2.y;
        dl[0] = dl[2] = d2.x;
        dl[1] = dl[3] = d2.y;
      } else {  // the rows' (own queries')
        l[0] = l[1] = lse_r[0];
        l[2] = l[3] = lse_r[1];
        dl[0] = dl[1] = delta_r[0];
        dl[2] = dl[3] = delta_r[1];
      }
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = prob(s[4 * n + e], scale_log2, l[e]);
        ds[e] = p[e] * (dp[4 * n + e] - dl[e]) * a.scale;
      }
      fs[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      fs[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      if constexpr (DKDV) {
        fp[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
        fp[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
    }

    // dQ += dS k (launch 1); dK += dS^T q, dV += P^T do (launch 2): 16
    // streamed rows a k-step, two row groups on (2048 bytes at D = 64, in
    // the swizzle too)
    wg_fence();
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      const int kb = sb + j * 2 * KCH * 128;
      wgmma_pv<D>(acc, fs[j], ndesc + wg_step(kb));
      if constexpr (DKDV) wgmma_pv<D>(acc2, fp[j], ndesc + wg_step(kb + TILE));
    }
    wg_commit();
    wg_wait();
    stage = stage + 1 == RING ? 0 : stage + 1;
  }
  cp_async_wait<0>();

  const size_t out = (row_base + row0) * hd + col + 2 * t;
  store_rows<D>(acc, (DKDV ? a.dk : a.dq) + out, hd);
  if constexpr (DKDV) store_rows<D>(acc2, a.dv + out, hd);
}

template <int D, int NWG, bool DKDV>
cudaError_t launch_row(const Bwd& a, int batch, cudaStream_t s) {
  const size_t smem = (size_t)RING * row_stage_bytes<D, DKDV>() + Tile<D>::SMEM_PAD;
  cudaError_t e = ls_allow_smem(bwd_row_kernel<D, NWG, DKDV>, smem);
  if (e != cudaSuccess) return e;
  const int own_tiles = a.seq / (64 * NWG);
  const long long blocks = (long long)own_tiles * a.heads * batch;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  bwd_row_kernel<D, NWG, DKDV><<<(unsigned)blocks, 128 * NWG, smem, s>>>(a, own_tiles,
                                                                         a.scale * LOG2E);
  return cudaGetLastError();
}

// the two launches; 128 own rows a block (two warpgroups sharing each
// streamed tile) where the sequence tiles so, as the core's pick_block_q
template <int D>
cudaError_t run_row(const Bwd& a, int batch, cudaStream_t s) {
  const bool two = a.seq % 128 == 0;
  cudaError_t e = two ? launch_row<D, 2, false>(a, batch, s) : launch_row<D, 1, false>(a, batch, s);
  if (e != cudaSuccess) return e;
  return two ? launch_row<D, 2, true>(a, batch, s) : launch_row<D, 1, true>(a, batch, s);
}

// ---------------------------------------------------------------------------
// D = 512: the wide kernel, a cluster of two blocks a 64-row tile
// ---------------------------------------------------------------------------

namespace wide {
constexpr int OWN = 64;   // own rows of a block
constexpr int ST = 32;    // rows of a streamed tile
constexpr int DH = 256;   // a block's columns: half of D = 512
constexpr int ATOMS = DH / 64;                // 128-byte column atoms of a row
constexpr int OWN_ATOM = OWN * 128;           // bytes of one atom of an own tile
constexpr int ST_ATOM = ST * 128;             // of a streamed tile
constexpr int OWN_BYTES = ATOMS * OWN_ATOM;   // 32 KB
constexpr int ST_BYTES = ATOMS * ST_ATOM;     // 16 KB
constexpr int STAGE = 2 * ST_BYTES;           // sx and sy
constexpr int PART = OWN * ST / 4;            // float4s of one partial tile (16 a thread)
// from the 1024-aligned base: own x, own y, the ring's two stages, the
// other block's partials [set][kind: s, dp], this block's [kind] for its
// other warpgroup, the ring's lse and delta
constexpr int RING_AT = 2 * OWN_BYTES;
constexpr int INBOX_AT = RING_AT + 2 * STAGE;
constexpr int LOCAL_AT = INBOX_AT + 4 * PART * 16;
constexpr int STAT_AT = LOCAL_AT + 2 * PART * 16;
constexpr int SMEM = STAT_AT + 2 * 2 * ST * 4 + 1024;
}  // namespace wide

template <bool DKDV>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(256, 1)
    bwd_wide_kernel(Bwd a, int own_tiles, float scale_log2) {
  using namespace wide;
  constexpr int N = DKDV ? DH : DH / 2;  // the output columns of a warpgroup
  extern __shared__ unsigned char smem_raw[];
  __shared__ float own_stat[2][OWN];  // launch 1: lse and delta of the own rows
  __shared__ __align__(8) uint64_t full[2];  // a set of the inbox has landed
  cgr::cluster_group cluster = cgr::this_cluster();
  const unsigned raw = (unsigned)__cvta_generic_to_shared(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int rank = (int)cluster.block_rank();  // the half of D this block holds
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int tw = tid & 127;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cl = blockIdx.x >> 1;  // the cluster: (batch, head) and own tile
  const int bh = cl / own_tiles;
  const int own0 = (cl % own_tiles) * OWN;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int hd = a.heads * 512;
  const size_t row_base = (size_t)b * a.seq;
  const size_t col = (size_t)h * 512 + rank * DH;
  const Roles r = roles<DKDV>(a, hd);
  const bf16* x = r.x + row_base * r.ldx + col;
  const bf16* y = r.y + row_base * r.ldy + col;
  const bf16* sx = r.sx + row_base * r.ldsx + col;
  const bf16* sy = r.sy + row_base * r.ldsy + col;
  const float* lse = a.lse + (size_t)bh * a.seq;
  float* delta = a.delta + (size_t)bh * a.seq;
  const int tiles = a.seq / ST;

  // Copies into the 128-byte swizzle (wgmma.cuh), atom by atom: eight
  // threads a 128-byte row, 32 rows a pass; a thread's chunk and its
  // swizzled place in a row group are fixed.
  const int chunk = tid & 7;
  const int rip = tid >> 3;
  const unsigned sw = sw128_offset(rip, chunk);
  auto copy_rows = [&](unsigned dst, const bf16* src, int ld, auto passes) {
    constexpr int PASSES = decltype(passes)::value;
    const bf16* s0 = src + (size_t)rip * ld + chunk * 8;
#pragma unroll
    for (int atom = 0; atom < ATOMS; ++atom)
#pragma unroll
      for (int rp = 0; rp < PASSES; ++rp)
        cp_async16s(dst + sw + atom * PASSES * 32 * 128 + rp * 32 * 128,
                    s0 + (size_t)rp * 32 * ld + atom * 64);
  };
  // the sx and sy tiles of `tile` into `stage` (and in launch 2 the lse and
  // delta of their rows); one commit group a call
  auto load = [&](int tile, int stage) {
    if (tile < tiles) {
      const unsigned dst = base + RING_AT + stage * STAGE;
      copy_rows(dst, sx + (size_t)tile * ST * r.ldsx, r.ldsx, Tag<ST / 32>{});
      copy_rows(dst + ST_BYTES, sy + (size_t)tile * ST * r.ldsy, r.ldsy, Tag<ST / 32>{});
      if constexpr (DKDV) {
        if (tid < ST / 2) {  // 8 chunks of lse, then 8 of delta
          const float* src = (tid < ST / 4 ? lse : delta) + tile * ST + (tid % (ST / 4)) * 4;
          cp_async16s(base + STAT_AT + stage * 2 * ST * 4 + tid * 16, src);
        }
      }
    }
    cp_async_commit();
  };
  copy_rows(base, x + (size_t)own0 * r.ldx, r.ldx, Tag<OWN / 32>{});  // in tile 0's group
  copy_rows(base + OWN_BYTES, y + (size_t)own0 * r.ldy, r.ldy, Tag<OWN / 32>{});
  load(0, 0);

  if constexpr (!DKDV) {
    // delta of the own rows over all 512 columns from o and do, four
    // threads a row; both blocks compute it, the first writes it
    const int row = tid >> 2;
    const int part = tid & 3;
    const size_t off = (row_base + own0 + row) * hd + (size_t)h * 512;
    const uint4* o4 = reinterpret_cast<const uint4*>(a.o + off);
    const uint4* d4 = reinterpret_cast<const uint4*>(a.dout + off);
    float u = 0.f;
#pragma unroll 4
    for (int j = part; j < 64; j += 4) {
      const uint4 ov = o4[j], dv = d4[j];
      u += dot2(ov.x, dv.x) + dot2(ov.y, dv.y) + dot2(ov.z, dv.z) + dot2(ov.w, dv.w);
    }
    u += __shfl_xor_sync(LS_FULL_MASK, u, 1);
    u += __shfl_xor_sync(LS_FULL_MASK, u, 2);
    if (part == 0) {
      own_stat[0][row] = lse[own0 + row];
      own_stat[1][row] = u;
      if (rank == 0) delta[own0 + row] = u;
    }
  }
  const unsigned full0 = (unsigned)__cvta_generic_to_shared(&full[0]);
  if (tid == 0) {
    mbar_init(full0, 1);
    mbar_init(full0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // both blocks run (the other's shared memory and barriers exist) before
  // any remote write; and own_stat is down
  cluster.sync();
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  if constexpr (!DKDV) {
    const int rr = warp * 16 + g;
    lse_r[0] = own_stat[0][rr];
    lse_r[1] = own_stat[0][rr + 8];
    delta_r[0] = own_stat[1][rr];
    delta_r[1] = own_stat[1][rr + 8];
  }

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const float4* inbox = reinterpret_cast<const float4*>(smem + INBOX_AT);
  float4* local = reinterpret_cast<float4*>(smem + LOCAL_AT);
  const unsigned peer = (unsigned)(rank ^ 1);
  const unsigned peer_inbox = cluster_addr(base + INBOX_AT, peer);
  const unsigned peer_full = cluster_addr(full0, peer);
  // the partial product: s = x sx^T in warpgroup 0, dp = y sy^T in 1, over
  // this block's half of D (both K-major: 32 bytes a k-step inside an atom)
  const uint64_t own_desc = wg_desc_sw128(base + wg * OWN_BYTES);
  const uint64_t st_desc = wg_desc_sw128(base + RING_AT + wg * ST_BYTES);
  // the output product's B, MN-major (16 streamed rows a k-step, 2048
  // bytes): launch 1, this warpgroup's 128 columns of sx (k); launch 2, the
  // 256 of sy (do) for dV in warpgroup 0, of sx (q) for dK in 1
  const unsigned out_at = DKDV ? (wg == 0 ? ST_BYTES : 0) : wg * 2 * ST_ATOM;
  const uint64_t out_desc = wg_desc_sw128_mn(base + RING_AT + out_at, ST_ATOM);
  int stage = 0;
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<0>();   // this thread's copies of tile i have landed
    fence_async_proxy();  // for the matrix unit
    __syncthreads();      // everyone's have, and tile i - 1 has been read
    const int sb = stage * STAGE;
    float part[ST / 2];
    wg_fence();
#pragma unroll
    for (int atom = 0; atom < ATOMS; ++atom)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_n32(part, own_desc + wg_step(atom * OWN_ATOM + ks * 32),
                     st_desc + wg_step(sb + atom * ST_ATOM + ks * 32), atom + ks > 0);
    wg_commit();
    load(i + 1, stage ^ 1);  // behind the product, into the stage tile i - 1 has left
    wg_wait();

    // the exchange: this partial into the other block's inbox, set i % 2,
    // slot [kind = wg] (thread tw's float4 j at j * 128 + tw), and for the
    // other warpgroup into this block's own slot; then the two halves of
    // what this warpgroup needs, each a sum of two terms (the same bits
    // whichever block adds them)
    const int set = i & 1;
    const bool needs_other = !DKDV || wg == 1;  // launch 2's dV needs no dp
    if (tid == 0) mbar_expect_tx(full0 + set * 8, 2 * PART * 16);
    {
      const unsigned dst = peer_inbox + ((set * 2 + wg) * PART + tw) * 16;
#pragma unroll
      for (int j = 0; j < ST / 8; ++j) {
        const float4 val =
            make_float4(part[4 * j], part[4 * j + 1], part[4 * j + 2], part[4 * j + 3]);
        st_async16(dst + j * 128 * 16, val, peer_full + set * 8);
        if (wg == 0 || !DKDV) local[wg * PART + j * 128 + tw] = val;
      }
    }
    __syncthreads();  // this block's partials are down
    mbar_wait(full0 + set * 8, (i >> 1) & 1);  // and the other block's have landed
    const float4* mate = inbox + (set * 2 + wg) * PART + tw;  // this kind, the other half
    const float4* o_here = local + (wg ^ 1) * PART + tw;       // the other kind, both halves
    const float4* o_there = inbox + (set * 2 + (wg ^ 1)) * PART + tw;
    float s[ST / 2], dp[ST / 2];
#pragma unroll
    for (int j = 0; j < ST / 8; ++j) {
      const float4 pv = mate[j * 128];
      const float m[4] = {part[4 * j] + pv.x, part[4 * j + 1] + pv.y, part[4 * j + 2] + pv.z,
                          part[4 * j + 3] + pv.w};
      float o[4] = {0.f, 0.f, 0.f, 0.f};
      if (needs_other) {
        const float4 o0 = o_here[j * 128], o1 = o_there[j * 128];
        o[0] = o0.x + o1.x;
        o[1] = o0.y + o1.y;
        o[2] = o0.z + o1.z;
        o[3] = o0.w + o1.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = wg == 0 ? m[e] : o[e];
        dp[4 * j + e] = wg == 0 ? o[e] : m[e];
      }
    }

    // P (launch 2's warpgroup 0) or dS as the A fragments of two k-steps
    const float* stat = reinterpret_cast<const float*>(smem + STAT_AT) + stage * 2 * ST;
    uint32_t fa[ST / 16][4];
#pragma unroll
    for (int n = 0; n < ST / 8; ++n) {
      float2 l2 = make_float2(0.f, 0.f), d2 = make_float2(0.f, 0.f);
      if constexpr (DKDV) {  // the columns' (streamed queries')
        l2 = *reinterpret_cast<const float2*>(stat + 8 * n + 2 * t);
        d2 = *reinterpret_cast<const float2*>(stat + ST + 8 * n + 2 * t);
      }
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = DKDV ? (e & 1 ? l2.y : l2.x) : lse_r[e >> 1];
        const float dl = DKDV ? (e & 1 ? d2.y : d2.x) : delta_r[e >> 1];
        const float p = prob(s[4 * n + e], scale_log2, l);
        v[e] = DKDV && wg == 0 ? p : p * (dp[4 * n + e] - dl) * a.scale;
      }
      fa[n >> 1][(n & 1) * 2] = pack_bf16(v[0], v[1]);
      fa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
    }
    wg_fence();
#pragma unroll
    for (int j = 0; j < ST / 16; ++j) wgmma_pv<N>(acc, fa[j], out_desc + wg_step(sb + j * 2048));
    wg_commit();
    wg_wait();
    stage ^= 1;
  }
  // no block leaves while the other may still store into it
  cluster.sync();

  const int r0 = own0 + warp * 16 + g;
  bf16* out = (DKDV ? (wg == 0 ? a.dv : a.dk) : a.dq) + (row_base + r0) * hd + col +
              (DKDV ? 0 : wg * N) + 2 * t;
  store_rows<N>(acc, out, hd);
}

template <bool DKDV>
cudaError_t launch_wide(const Bwd& a, int batch, cudaStream_t s) {
  cudaError_t e = ls_allow_smem(bwd_wide_kernel<DKDV>, wide::SMEM);
  if (e != cudaSuccess) return e;
  const int own_tiles = a.seq / wide::OWN;
  const long long blocks = 2LL * own_tiles * a.heads * batch;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  bwd_wide_kernel<DKDV><<<(unsigned)blocks, 256, wide::SMEM, s>>>(a, own_tiles,
                                                                  a.scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (batch, seq, heads, d) bf16 at row pitches ldq, ldk, ldv (a head d
// columns on); o (the forward's output), dout and dq, dk, dv contiguous
// (batch, seq, heads, d) bf16; lse: (batch, heads, seq) f32 from the
// forward's LSE instantiation (base 2); delta: (batch, heads, seq) f32
// scratch. Two launches (dQ, then dK / dV); seq a multiple of 64.
extern "C" int ls_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, int ldq, int ldk, int ldv,
                                      void* dq, void* dk, void* dv, const void* lse, void* delta,
                                      int batch, int seq, int heads, int d, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || heads <= 0 || seq <= 0 || seq % 64 || !(scale > 0.f) || ldq % 8 ||
      ldk % 8 || ldv % 8)
    return (int)cudaErrorInvalidValue;
  const Bwd a = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<const bf16*>(o),
                 static_cast<const bf16*>(dout), ldq, ldk, ldv, static_cast<bf16*>(dq),
                 static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<const float*>(lse),
                 static_cast<float*>(delta), seq, heads, scale};
  switch (d) {
    case 40: return (int)run_row<40>(a, batch, s);
    case 64: return (int)run_row<64>(a, batch, s);
    case 80: return (int)run_row<80>(a, batch, s);
    case 512: {
      const cudaError_t e = launch_wide<false>(a, batch, s);
      return (int)(e != cudaSuccess ? e : launch_wide<true>(a, batch, s));
    }
    default: return (int)cudaErrorInvalidValue;
  }
}
