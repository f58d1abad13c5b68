// bf16 tensor-core GEMM template with bias, GEGLU and residual epilogues, and
// the row passes that prepare its A operand: the matrix products of the TPU
// kernels latentsync_tpu/ops/ffn.py _geglu_kernel and _qkv_kernel and
// latentsync_tpu/ops/attn_block.py _kernel and _cross_kernel (their q/k/v
// and output projections), and of latentsync_tpu/ops/qmm.py _qmm_kernel in
// its int8 mode.
//
//   C[m, n] = epi( sum_k A[m, k] * B[n, k] )      f32 accumulation
//   epi     = + bias[n]                           (bias may be null)
//           | (acc + bias) * gelu_erf(acc2 + bias2)   DUAL: the GEGLU
//             up-projection, B the value rows and B2 the gate rows of w_up
//           then + residual[m, n] in f32          (residual may be null)
//           then one rounding to bf16
//   up to three B operands with an output each share one launch and one A
//   (K9: q, k, v); a block's column tile lies inside one of them.
//
// B is a torch nn.Linear weight, (N, K) row-major, i.e. the K-major operand
// the matrix unit wants, so weights are used as stored.
//
// A is always plain bf16 here. Where a caller wants A' = bf16(LN(A))
// (K1, K2's spatial mode, K5), a row pass (ln_rows: one warp a row, 16-byte
// accesses) writes A' once to a scratch buffer the wrapper allocates, and
// the product reads it like any A: the normalisation runs once a row, not
// once for every column block of the product as it did when it was this
// template's prologue. Rounding point unchanged: LN output to bf16.
//
// Design of the product. An output tile is 128 rows x BN columns (BN = 160
// or 64, picked on the host by pick_bn; DUAL: 64 value and 64 gate
// columns), two warpgroups of 64 rows. The launch has as many blocks as the
// card holds at once, and a block walks every gridDim.x-th output tile
// (column tiles of one row panel first, so neighbouring blocks read one A
// panel at the same time). The K loop walks k-tiles of 64 bf16: a row of a
// tile is 128 bytes, so the A tile (128 rows) and the B tile(s) (BN rows,
// K-major as stored) lie in shared memory in the 128-byte swizzle (chunk
// index XOR row mod 8), which cp.async writes directly, 16 bytes a copy. A
// ring of 3 such stages in dynamic shared memory is filled ahead of the
// products: k-tile t + 2 loads while k-tile t multiplies, and the loads run
// on into the block's next output tile, so its first k-tiles arrive while
// this tile's epilogue runs. Every product is wgmma m64nBNk16 with both
// operands read from shared memory through descriptors (four k-steps a
// tile, a descriptor step of 32 bytes each), f32 accumulators in registers
// (BN / 2 a thread, twice that for DUAL). Rows past M and columns past N
// are clamped to the last valid one when loaded and masked when stored; a
// last k-tile shorter than 64 is zero-filled by cp.async itself (a second
// copy of the load, so the full tiles' copies carry no test); the stage
// index is carried, not computed.
//
// Epilogue from registers: bias (each thread's columns are fixed, it loads
// them as it goes), GEGLU and the residual are applied to the accumulator
// fragments in f32; the bf16 pairs of four 8-column tiles are then
// transposed across the four lanes of a quad (two shuffle rounds), so a lane
// stores 16 contiguous bytes and a quad 64, straight to device memory. No
// shared-memory staging and no barrier after the K loop.
//
// What bounds it on the card (measured, PERF.md): a block's epilogue (for
// DUAL an erff a hidden element) must overlap another block's K loop, so
// the tiles are sized for two blocks an SM (three at BN = 64): DUAL at
// 128 + 128 columns (one block an SM) was 25-40 % slower than at 64 + 64 at
// every served shape and is not built. At K = 320 the products are 5
// k-tiles short and the time follows the traffic from the L2 cache into
// shared memory, M N K 2 (1 / BN + 1 / 128) bytes: hence the widest tile
// that fits twice, 160, and loads that do not stop at a tile's end. At
// K >= 1280 the loop reaches about two thirds of the bf16 peak at BN = 160.
//
// The int8 mode (E = int8_t, gemm_s8: K8, qmm.cu). A and B are int8 codes
// at a pitch that is a multiple of 16 with a zero tail, written by K8's
// quantizing row pass, and the product is wgmma m64nBNk32 s32.s8.s8
// (wgmma.cuh), both operands K-major as the integer product requires. A
// k-tile of 128 codes is one 128-byte row, as 64 bf16 are, so the ring, the
// swizzle, the resident blocks, pick_bn and the descriptors' 32-byte k-step
// are the bf16 mode's own; only the element count a copy and a tile covers
// differs.
// Its epilogue is K8's dequantization, from registers in the reference's
// order: bf16(bf16((f32(acc) * a_scale[m]) * b_scale[n]) + bias[n]) with a
// bf16 bias, IEEE roundings, no fused multiply-add; scales and bias of
// columns past N are read at the last valid pair and never stored.
#pragma once

#include <type_traits>

#include "wgmma.cuh"

namespace ls_gemm {

using namespace ls_wg;

constexpr int BM = 128;         // rows a block: two warpgroups of 64
constexpr int ROW_BYTES = 128;  // a k-tile's row in shared memory: 64 bf16 or 128 codes
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int SMS = 132;  // blocks a launch should at least have

// A and B are bf16, or int8 codes in the int8 mode (gemm_s8)
struct Args {
  const void* a;
  int lda;
  const void* b;   // first (or only) B operand, (n, k) row-major with pitch ldb
  const void* b1;  // second and third operands of a three-output launch (K9)
  const void* b2;
  int nb;              // B operands (1 or 3), each with its own output
  const void* b_gate;  // DUAL: the GEGLU gate rows, or null
  int ldb;
  bf16* c;  // output of operand 0 (and 1, 2), pitch ldc
  bf16* c1;
  bf16* c2;
  int ldc;
  int m, n, k;
  const float* bias;
  const float* bias_gate;
  const bf16* res;  // residual (m, n) with row pitch ldr, or null
  int ldr;
  // gemm_s8: the f32 scales of A's rows and B's rows, and a bf16 bias or null
  const float* a_scale;
  const float* b_scale;
  const bf16* bias_bf16;
};

static __device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.0f + erff(g * 0.70710678118654752f));
}

template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64) wgmma_ss_n64(d, da, db, 1);
  if constexpr (BN == 160) wgmma_ss_n160(d, da, db, 1);
}

template <int BN>
__device__ __forceinline__ void mma(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64) wgmma_ss_s8_n64(d, da, db, 1);
  if constexpr (BN == 160) wgmma_ss_s8_n160(d, da, db, 1);
}

// Four 32-bit values a lane, transposed across the four lanes of a quad:
// lane t gives v[0..3] and gets v[t] of lanes 0..3.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  const bool odd = t & 1;
  const bool high = t & 2;
#pragma unroll
  for (int b = 0; b < 4; b += 2) {
    const uint32_t got = __shfl_xor_sync(LS_FULL_MASK, odd ? v[b] : v[b + 1], 1);
    if (odd) v[b] = got; else v[b + 1] = got;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t got = __shfl_xor_sync(LS_FULL_MASK, high ? v[i] : v[i + 2], 2);
    if (high) v[i] = got; else v[i + 2] = got;
  }
}

template <int BN, bool DUAL>
struct Tile {
  static constexpr int NB = DUAL ? 2 : 1;
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int B_BYTES = BN * ROW_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + NB * B_BYTES;
  // the ring, and room to align its base to the swizzle's 1024 bytes
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;
};

// E: bf16, or int8_t for the int8 mode (then not DUAL)
template <int BN, bool DUAL, typename E>
__global__ void __launch_bounds__(THREADS, 2)  // registers capped for two blocks an SM
    gemm_kernel(const Args p, int tiles_n, int tiles_total) {
  using T = Tile<BN, DUAL>;
  constexpr int NB = T::NB;
  constexpr bool S8 = std::is_same_v<E, int8_t>;
  constexpr int BK = ROW_BYTES / (int)sizeof(E);  // elements of a k-tile
  constexpr int CE = 16 / (int)sizeof(E);         // elements of a 16-byte copy
  using Acc = std::conditional_t<S8, int, float>;
  static_assert(BN % 32 == 0 && T::STAGE_BYTES % 1024 == 0, "tile");
  static_assert(!S8 || !DUAL, "the int8 mode has K8's epilogue only");
  extern __shared__ unsigned char smem_raw[];
  const unsigned smem_base = ((unsigned)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int tiles_row = tiles_n * p.nb;  // output tiles of one 128-row panel

  // Loads: eight threads a 128-byte row, 32 rows a pass; a thread's chunk and
  // its swizzled place in a row group are fixed. Rows past the edge are
  // clamped to the last valid row (computed, never stored). The loads run
  // ahead of the products through the block's output tiles: `lw` is the tile
  // they have reached, `lkt` its next k-tile.
  const int chunk = tid & 7;
  const int rip = tid >> 3;
  const unsigned sw = sw128_offset(rip, chunk);
  constexpr int A_PASSES = BM / 32;
  constexpr int B_PASSES = BN / 32;
  int a_off[A_PASSES];
  int b_off[B_PASSES];
  const E* __restrict__ b_op = static_cast<const E*>(p.b);
  int lw = blockIdx.x;
  int lkt = 0;
  // output tile w: row panel w / tiles_row, then operand, then column tile
  auto aim_loads = [&](int w) {
    const int rt = w / tiles_row;
    const int rem = w - rt * tiles_row;
    const int op = rem / tiles_n;
    const int n0 = (rem - op * tiles_n) * BN;
    b_op = static_cast<const E*>(op == 0 ? p.b : op == 1 ? p.b1 : p.b2);
#pragma unroll
    for (int i = 0; i < A_PASSES; ++i) a_off[i] = min(rt * BM + rip + 32 * i, p.m - 1) * p.lda;
#pragma unroll
    for (int i = 0; i < B_PASSES; ++i) b_off[i] = min(n0 + rip + 32 * i, p.n - 1) * p.ldb;
  };
  aim_loads(lw);

  const int kt_full = p.k / BK;
  const int kt_all = (p.k + BK - 1) / BK;

  // Start the copies of k-tile `t` into `stage`; one commit group a call
  // whatever it copies. `partial`: the short last tile, whose chunks past K
  // are zero-filled (the source then points at the row's start: no byte of
  // it is read).
  auto copy_tile = [&](int t, int stage, auto partial) {
    const int k0 = t * BK + chunk * CE;
    const bool in_k = !decltype(partial)::value || k0 < p.k;
    const int kk = in_k ? k0 : 0;
    const int bytes = in_k ? 16 : 0;
    const unsigned dst = smem_base + stage * T::STAGE_BYTES + sw;
    const E* asrc = static_cast<const E*>(p.a) + kk;
    const E* bsrc = b_op + kk;
#pragma unroll
    for (int i = 0; i < A_PASSES; ++i) {
      if (decltype(partial)::value)
        cp_async16z(dst + i * 32 * ROW_BYTES, asrc + a_off[i], bytes);
      else
        cp_async16s(dst + i * 32 * ROW_BYTES, asrc + a_off[i]);
    }
#pragma unroll
    for (int i = 0; i < B_PASSES; ++i) {
      if (decltype(partial)::value)
        cp_async16z(dst + T::A_BYTES + i * 32 * ROW_BYTES, bsrc + b_off[i], bytes);
      else
        cp_async16s(dst + T::A_BYTES + i * 32 * ROW_BYTES, bsrc + b_off[i]);
    }
    if (DUAL) {
      const E* gsrc = static_cast<const E*>(p.b_gate) + kk;
#pragma unroll
      for (int i = 0; i < B_PASSES; ++i) {
        if (decltype(partial)::value)
          cp_async16z(dst + T::A_BYTES + T::B_BYTES + i * 32 * ROW_BYTES, gsrc + b_off[i], bytes);
        else
          cp_async16s(dst + T::A_BYTES + T::B_BYTES + i * 32 * ROW_BYTES, gsrc + b_off[i]);
      }
    }
  };
  // the next k-tile of the load cursor into `stage`, and the cursor moved on
  auto load = [&](int stage) {
    if (lw < tiles_total) {
      if (lkt < kt_full)
        copy_tile(lkt, stage, Tag<0>{});
      else
        copy_tile(lkt, stage, Tag<1>{});
      if (++lkt == kt_all) {
        lkt = 0;
        lw += gridDim.x;
        if (lw < tiles_total) aim_loads(lw);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);

  // descriptors of stage 0: this warpgroup's 64 rows of the A tile, the B tile(s)
  const uint64_t a_desc = wg_desc_sw128(smem_base + wg * 64 * ROW_BYTES);
  const uint64_t b_desc = wg_desc_sw128(smem_base + T::A_BYTES);

  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  int stage = 0;
  // The block's output tiles, every gridDim.x-th: neighbouring blocks work on
  // neighbouring column tiles of one row panel at the same time. The loads of
  // the next tile's first k-tiles are in flight while this one's epilogue runs.
  for (int w = blockIdx.x; w < tiles_total; w += gridDim.x) {
    Acc acc[NB][BN / 2];
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[h][i] = 0;

    for (int t = 0; t < kt_all; ++t) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of the k-tile have landed
      fence_async_proxy();
      __syncthreads();  // everyone's have, and the k-tile before has been multiplied
      const uint64_t sa = a_desc + wg_step(stage * T::STAGE_BYTES);
      const uint64_t sb = b_desc + wg_step(stage * T::STAGE_BYTES);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < ROW_BYTES / 32; ++ks) {  // k-steps of 32 bytes
        mma<BN>(acc[0], sa + wg_step(ks * 32), sb + wg_step(ks * 32));
        if (DUAL) mma<BN>(acc[NB - 1], sa + wg_step(ks * 32), sb + wg_step(T::B_BYTES + ks * 32));
      }
      wg_commit();
      // the copies two k-tiles ahead start while the products run, into the
      // stage the k-tile before has left
      load(stage == 0 ? STAGES - 1 : stage - 1);
      wg_wait();
      stage = stage + 1 == STAGES ? 0 : stage + 1;
    }

    // Epilogue. Accumulator tile j (columns 8j..8j+7) is acc[.][4j..4j+3]:
    // lane (g, t) of warp w holds columns 2t, 2t+1 of rows 16w + g (the first
    // two values) and 16w + g + 8.
    const int rt = w / tiles_row;
    const int rem = w - rt * tiles_row;
    const int op = rem / tiles_n;
    const int n0 = (rem - op * tiles_n) * BN;
    const int row0 = rt * BM + wg * 64 + warp * 16 + g;
    const int row1 = row0 + 8;
    bf16* __restrict__ c_op = op == 0 ? p.c : op == 1 ? p.c1 : p.c2;
    float as0 = 0.f, as1 = 0.f;  // int8 mode: the two rows' scales (rows past M: the last)
    if constexpr (S8) {
      as0 = p.a_scale[min(row0, p.m - 1)];
      as1 = p.a_scale[min(row1, p.m - 1)];
    }
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
      uint32_t lo[4], hi[4];  // rows row0 and row1 of tiles 4q..4q+3, packed bf16 pairs
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * q + jj;
        const int col = n0 + 8 * j + 2 * t4;
        if constexpr (S8) {
          // K8: bf16((f32(acc) * a_scale) * b_scale) [+ bias in f32, rounded
          // again by the pack]; columns past N read the last pair (N is even)
          const int cs = min(col, p.n - 2);
          const float2 ws = *reinterpret_cast<const float2*>(p.b_scale + cs);
          auto deq = [](int a, float sa, float sb) {
            return __bfloat162float(
                __float2bfloat16_rn(__fmul_rn(__fmul_rn(__int2float_rn(a), sa), sb)));
          };
          float v00 = deq(acc[0][4 * j], as0, ws.x), v01 = deq(acc[0][4 * j + 1], as0, ws.y);
          float v10 = deq(acc[0][4 * j + 2], as1, ws.x), v11 = deq(acc[0][4 * j + 3], as1, ws.y);
          if (p.bias_bf16 != nullptr) {
            const float2 bv =
                __bfloat1622float2(*reinterpret_cast<const bf162*>(p.bias_bf16 + cs));
            v00 = __fadd_rn(v00, bv.x); v01 = __fadd_rn(v01, bv.y);
            v10 = __fadd_rn(v10, bv.x); v11 = __fadd_rn(v11, bv.y);
          }
          lo[jj] = pack_bf16(v00, v01);
          hi[jj] = pack_bf16(v10, v11);
          continue;
        }
        const bool in_n = col < p.n;
        float v00 = acc[0][4 * j], v01 = acc[0][4 * j + 1];
        float v10 = acc[0][4 * j + 2], v11 = acc[0][4 * j + 3];
        if (p.bias != nullptr && in_n) {
          const float2 bv = *reinterpret_cast<const float2*>(p.bias + col);
          v00 += bv.x; v01 += bv.y; v10 += bv.x; v11 += bv.y;
        }
        if (DUAL) {
          float g00 = acc[NB - 1][4 * j], g01 = acc[NB - 1][4 * j + 1];
          float g10 = acc[NB - 1][4 * j + 2], g11 = acc[NB - 1][4 * j + 3];
          if (p.bias_gate != nullptr && in_n) {
            const float2 bg = *reinterpret_cast<const float2*>(p.bias_gate + col);
            g00 += bg.x; g01 += bg.y; g10 += bg.x; g11 += bg.y;
          }
          v00 *= gelu_erf(g00); v01 *= gelu_erf(g01);
          v10 *= gelu_erf(g10); v11 *= gelu_erf(g11);
        }
        if (p.res != nullptr && in_n) {
          if (row0 < p.m) {
            const float2 rv = __bfloat1622float2(
                *reinterpret_cast<const bf162*>(p.res + (size_t)row0 * p.ldr + col));
            v00 += rv.x; v01 += rv.y;
          }
          if (row1 < p.m) {
            const float2 rv = __bfloat1622float2(
                *reinterpret_cast<const bf162*>(p.res + (size_t)row1 * p.ldr + col));
            v10 += rv.x; v11 += rv.y;
          }
        }
        lo[jj] = pack_bf16(v00, v01);
        hi[jj] = pack_bf16(v10, v11);
      }
      // lane t4 now takes the 8 columns of tile 4q + t4 from its quad
      quad_transpose(lo, t4);
      quad_transpose(hi, t4);
      const int col8 = n0 + 8 * (4 * q + t4);
      if (col8 < p.n) {
        if (row0 < p.m)
          *reinterpret_cast<uint4*>(c_op + (size_t)row0 * p.ldc + col8) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        if (row1 < p.m)
          *reinterpret_cast<uint4*>(c_op + (size_t)row1 * p.ldc + col8) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The row pass that prepares A: one warp a row, 16-byte accesses
// ---------------------------------------------------------------------------

// out[r] = bf16(LN(x[r])): two-pass f32 statistics like the reference (the
// row is read three times, the last two from cache).
static __global__ void ln_rows_kernel(const bf16* __restrict__ x, int m, int k, int ldx, float eps,
                                      const float* __restrict__ ln_w,
                                      const float* __restrict__ ln_b, bf16* __restrict__ out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * ldx);
  const int nv = k / 8;
  float s = 0.f;
  for (int i = lane; i < nv; i += 32) {
    const uint4 v = xr[i];
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int t = 0; t < 8; ++t) s += __bfloat162float(e[t]);
  }
  const float mu = ls_warp_sum(s) / k;
  float sq = 0.f;
  for (int i = lane; i < nv; i += 32) {
    const uint4 v = xr[i];
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float d = __bfloat162float(e[t]) - mu;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(ls_warp_sum(sq) / k + eps);
  uint4* outr = reinterpret_cast<uint4*>(out + (size_t)row * k);
  for (int i = lane; i < nv; i += 32) {
    uint4 v = xr[i];
    bf16* e = reinterpret_cast<bf16*>(&v);
    float w[8], b[8];
    *reinterpret_cast<float4*>(w) = *reinterpret_cast<const float4*>(ln_w + 8 * i);
    *reinterpret_cast<float4*>(w + 4) = *reinterpret_cast<const float4*>(ln_w + 8 * i + 4);
    *reinterpret_cast<float4*>(b) = *reinterpret_cast<const float4*>(ln_b + 8 * i);
    *reinterpret_cast<float4*>(b + 4) = *reinterpret_cast<const float4*>(ln_b + 8 * i + 4);
#pragma unroll
    for (int t = 0; t < 8; ++t)
      e[t] = __float2bfloat16((__bfloat162float(e[t]) - mu) * rstd * w[t] + b[t]);
    outr[i] = v;
  }
}

// out (m, k) = bf16(LN(x)); x has row pitch ldx, out is dense; k % 8 == 0
static inline cudaError_t ln_rows(const bf16* x, int m, int k, int ldx, float eps,
                                  const float* ln_w, const float* ln_b, bf16* out,
                                  cudaStream_t s) {
  if (m <= 0 || k <= 0 || k % 8 || ldx % 8) return cudaErrorInvalidValue;
  const int rows_per_block = 8;
  ln_rows_kernel<<<(m + rows_per_block - 1) / rows_per_block, 32 * rows_per_block, 0, s>>>(
      x, m, k, ldx, eps, ln_w, ln_b, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Column tile of a launch with `m` rows, `n` columns an operand and `nb`
// operands: 160 where it leaves no ragged column tile (every width of the
// UNet is a multiple of it) and the launch has a block for every SM, else
// 64. The GEGLU up-projection (dual) holds two accumulator sets and always
// takes 64 + 64.
static inline int pick_bn(int m, int n, int nb, bool dual) {
  const long long blocks160 = (long long)((m + BM - 1) / BM) * nb * ((n + 159) / 160);
  return !dual && n % 160 == 0 && blocks160 >= SMS ? 160 : 64;
}

template <int BN, bool DUAL, typename E = bf16>
cudaError_t launch(const Args& p, cudaStream_t s) {
  using T = Tile<BN, DUAL>;
  cudaError_t e = ls_allow_smem(gemm_kernel<BN, DUAL, E>, T::SMEM_BYTES);
  if (e != cudaSuccess) return e;
  // as many blocks as the card holds at once; each walks its share of the tiles
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gemm_kernel<BN, DUAL, E>,
                                                      THREADS, T::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    if (sms * per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
  }
  const int tiles_n = (p.n + BN - 1) / BN;
  const long long tiles = (long long)tiles_n * p.nb * ((p.m + BM - 1) / BM);
  if (tiles > 0x7fff0000LL) return cudaErrorInvalidValue;  // the walk's counter adds gridDim.x
  const int blocks = tiles < resident ? (int)tiles : resident;
  gemm_kernel<BN, DUAL, E><<<blocks, THREADS, T::SMEM_BYTES, s>>>(p, tiles_n, (int)tiles);
  return cudaGetLastError();
}

// One launch of the template. DUAL when p.b_gate is set; p.nb = 0 means one
// operand. Shapes it does not take are refused:
// k and n multiples of 8 (16-byte copies and stores), pitches multiples of 8,
// offsets within 32 bits.
static inline cudaError_t gemm(const Args& args, cudaStream_t s) {
  Args p = args;
  if (p.nb == 0) p.nb = 1;
  const bool dual = p.b_gate != nullptr;
  if (p.m <= 0 || p.n <= 0 || p.k <= 0 || p.k % 8 || p.n % 8 || p.lda % 8 || p.ldb % 8 ||
      p.ldc % 8 || (p.res != nullptr && p.ldr % 2) || (p.nb != 1 && p.nb != 3) ||
      (dual && p.nb != 1) || (long long)p.m * p.lda > 0x7fffffffLL ||
      (long long)p.n * p.ldb > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (dual) return launch<64, true>(p, s);
  return pick_bn(p.m, p.n, p.nb, dual) == 160 ? launch<160, false>(p, s) : launch<64, false>(p, s);
}

// One launch of the int8 mode (K8): A and B int8 codes with their row scales
// (a_scale, b_scale), a bf16 bias or null, bf16 output. Refused: k and the
// pitches of A and B no multiples of 16 (whole 16-byte copies of codes), n
// and ldc no multiples of 8, more than one operand, any other epilogue.
static inline cudaError_t gemm_s8(const Args& p, cudaStream_t s) {
  if (p.m <= 0 || p.n <= 0 || p.k <= 0 || p.k % 16 || p.n % 8 || p.lda % 16 || p.ldb % 16 ||
      p.ldc % 8 || p.nb > 1 || p.b_gate != nullptr ||
      p.a_scale == nullptr || p.b_scale == nullptr || p.bias != nullptr || p.res != nullptr ||
      (long long)p.m * p.lda > 0x7fffffffLL || (long long)p.n * p.ldb > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  Args q = p;
  q.nb = 1;
  return pick_bn(q.m, q.n, 1, false) == 160 ? launch<160, false, int8_t>(q, s)
                                              : launch<64, false, int8_t>(q, s);
}

}  // namespace ls_gemm
