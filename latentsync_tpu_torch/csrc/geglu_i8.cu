// K10: the int8-in / int8-out GEGLU feed-forward
//   x      = bf16(xi * xs)                        (xi int8 (M, C), xs f32 (M,))
//   hidden = bf16((x Wv^T + bv) * gelu_erf(x Wg^T + bg))
//   res    = hidden Wd^T + bd                     (f32)
//   os     = max_c |res| / 127 + 1e-12;  oi = int8(rint(res / os))
// Replaces the TPU kernel latentsync_tpu/ops/ffn.py _geglu_i8_kernel
// (:338, pallas_call at :386), which kept the dequantized x, the hidden and
// the f32 result of a row block in VMEM across an inner grid axis.
//
// One launch, the TPU kernel's schedule: device memory sees int8 codes and
// their scales in and out, and the bf16 weights (read from L2); nothing else.
// A block owns a row block. It dequantizes its rows of x once into shared
// memory (the wgmma operand layout: k-tiles of 64 bf16 in the 128-byte
// swizzle of wgmma.cuh; a thread's loads of codes all in flight before it
// converts) and keeps them for every inner chunk; the biases are copied into
// shared memory once a block. It then walks the inner dimension
// in chunks of 64 hidden columns; for each chunk:
//   - wgmma m64n64k16 products of x with 32 value rows and the 32 matching
//     gate rows of w_up at once (one B tile: value rows then gate rows, so a
//     lane holds each value column beside its gate), two halves a chunk;
//   - the GEGLU epilogue in registers (bias, the exact-erf gelu_erf of the
//     plain version, one rounding to bf16), into a 64 x 64 hidden tile in
//     shared memory (same swizzle);
//   - wgmma m64n64k16 products of the hidden tile with the chunk's columns of
//     Wd, 64 output columns at a time, accumulated onto the f32 result, which
//     stays in registers across all chunks.
// The epilogue adds bd, takes each row's amax (a row of a wgmma accumulator
// lives in one quad of one warp), and writes the codes (IEEE division, round
// half to even, no clamp: |res| / os <= 127 by construction) and the scale.
// An all-zero row gives os = 1e-12 and zero codes.
//
// Warp specialization. A producer warpgroup (one thread works) walks the
// block's steps and brings each step's weight tiles by the tensor-memory
// accelerator (cp.async.bulk.tensor, 2-D tensor maps in the 128-byte swizzle,
// zeros past every edge) into a ring of STAGES stages, each with a "full"
// mbarrier (the bytes landed) and an "empty" one (all eight consumer warps
// are done with it); two consumer warpgroups multiply. setmaxnreg moves
// registers to the consumers (40 for the producer, 232 for a consumer).
//
// What bounds the design: registers. The result of a warpgroup is 64 rows x
// up to 320 columns of f32, 160 registers a thread, beside the 32 of a chunk
// half's value and gate accumulators. So:
//   - C <= 320: a block is 128 rows, two warpgroups of 64 rows, each with all
//     C columns of its rows; they share every weight tile and each computes
//     both halves of its own hidden chunk; they meet only through the ring.
//   - 320 < C <= 640: the result does not fit one warpgroup. A block is 64
//     rows; warpgroup 0 holds the first ceil(C / 128) pieces of 64 output
//     columns, warpgroup 1 the rest; warpgroup w computes half w of each
//     hidden chunk into a shared (double-buffered) hidden tile that both
//     read; a ring stage holds one weight tile for each warpgroup; the two
//     meet once a chunk and merge their row amax through shared memory.
// Above 640 columns the result would need a third warpgroup's registers: the
// kernel refuses such C. The row block's height is its FLOP per byte of
// weights read from L2 (each row block reads all 24 C^2 bytes): 2.5 GB a call
// at (131072, 320), 5.0 GB at (32768, 640). What the time goes to, by pieces
// taken out (scripts/ffn8_pieces.py, PERF.md): the products take about a
// third of it; the exact erf, the dequantization of x and the steps' own
// waits most of the rest.
//
// Bound: operations, 24 M C^2 FLOP on the tensor cores (0.326 ms at (131072,
// 320) and at (32768, 640) on an NVIDIA H100 80GB HBM3 at 700 W); device
// memory moves 2 M C bytes of codes.
#include <cuda.h>

#include "gemm.cuh"

namespace {

using namespace ls_wg;

constexpr int THREADS = 384;           // a producer warpgroup, two consumer warpgroups
constexpr int TILE = 64 * 128;         // a weight tile: 64 rows x 64 bf16 of K
constexpr int NPW = 5;                 // 64-column pieces of the result a warpgroup holds
constexpr int X_BYTES = 80 * 1024;     // dequantized x: 128 x 320 or 64 x 640 bf16
constexpr int H_BYTES = 2 * TILE;      // hidden tiles (one a warpgroup, or two shared)
constexpr int RED_BYTES = 2 * 64 * 4;  // the row amax of each warpgroup (SPLIT)
constexpr int MAX_C = 640;
constexpr int BIAS_BYTES = 9 * MAX_C * 4;  // b_up (8C) and b_dn (C), f32
// chunks of 8 codes of x a consumer thread converts a row block, at most:
// 64 rows x C / 8 over 128 threads (C <= 320) or 256 (C <= 640)
constexpr int XCH = 64 * (MAX_C / 8) / 256;
constexpr int MAX_STAGES = 16;  // ring stages, at most (a full and an empty mbarrier each)

// SPLIT: the two warpgroups split the output columns (C > 320)
template <bool SPLIT>
struct Cfg {
  static constexpr int ROWS = SPLIT ? 64 : 128;  // rows of x a block owns
  static constexpr int TPS = SPLIT ? 2 : 1;      // weight tiles a ring stage
  static constexpr int STAGE_BYTES = TPS * TILE;
  static constexpr int FIXED =
      1024 + X_BYTES + H_BYTES + RED_BYTES + BIAS_BYTES + 2 * MAX_STAGES * 8;
  static constexpr int STAGES_FIT = (232448 - FIXED) / STAGE_BYTES;
  static constexpr int STAGES = STAGES_FIT < MAX_STAGES ? STAGES_FIT : MAX_STAGES;
  static constexpr int SMEM = FIXED + STAGES * STAGE_BYTES;
  static_assert(STAGES >= 4 && SMEM <= 232448, "shared memory");
};

struct Args {
  const int8_t* xi;
  const float* xs;
  int m, c;
  const float* b_up;  // (8C): value biases, then gate biases
  const float* b_dn;  // (C)
  int8_t* out;
  float* out_scale;
};

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// the arrival of the thread that starts a stage's copies, and the bytes they will bring
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait for the phase of `bar` with this parity to complete. A wait that
// lasts seconds means a broken schedule: trap (a launch error) rather than
// hang the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  const long long t0 = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// a box of a 2-D tensor map into shared memory (128-byte swizzle, zeros past
// the tensor's edges), its bytes counted on `bar`
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, int col, int row,
                                         unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

// named barrier `id` over `threads` threads (0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
    geglu_i8_kernel(const Args p, const __grid_constant__ CUtensorMap tm_up,
                    const __grid_constant__ CUtensorMap tm_dn, int row_blocks) {
  using K = Cfg<SPLIT>;
  extern __shared__ unsigned char smem_raw[];
  const unsigned base = ((unsigned)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - (unsigned)__cvta_generic_to_shared(smem_raw));
  const unsigned x_s = base;
  const unsigned h_s = x_s + X_BYTES;
  const unsigned ring = h_s + H_BYTES;
  const int red_off = X_BYTES + H_BYTES + K::STAGES * K::STAGE_BYTES;
  float* red = reinterpret_cast<float*>(gbase + red_off);
  float* const b_up = red + 2 * 64;  // the biases, read by every row block
  float* const b_dn = b_up + 8 * MAX_C;
  // a "tiles landed" and a "stage free" mbarrier a stage
  const unsigned full = base + red_off + RED_BYTES + BIAS_BYTES;
  const unsigned empty = full + 8 * MAX_STAGES;

  const int tid = threadIdx.x;
  const int c = p.c;
  const int inner = 4 * c;
  const int kt = (c + 63) >> 6;                // k-tiles of x (and of a value/gate row)
  const int np = kt;                           // 64-column pieces of the result
  const int npw = SPLIT ? (np + 1) >> 1 : np;  // of a consumer warpgroup
  const int nsc = (inner + 63) >> 6;           // hidden chunks of 64 columns
  const int up_steps = SPLIT ? kt : 2 * kt;
  const int per_sc = up_steps + npw;           // ring steps a chunk

  for (int i = tid; i < 2 * inner; i += THREADS) b_up[i] = p.b_up[i];
  for (int i = tid; i < c; i += THREADS) b_dn[i] = p.b_dn[i];
  if (tid == 0) {
    for (int s = 0; s < K::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);  // the producer's arrival, with the tiles' bytes
      mbar_init(empty + 8 * s, 8);  // every consumer warp done with the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: thread 0 walks the block's ring steps and
    // starts each step's tiles as soon as its stage is free ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != 0) return;
    int stage = 0;
    unsigned par = 0;
    long long step = 0;
    for (int rb = blockIdx.x; rb < row_blocks; rb += gridDim.x) {
      for (int sc = 0; sc < nsc; ++sc) {
        const int c0 = 64 * sc;
        for (int r = 0; r < per_sc; ++r, ++step) {
          if (step >= K::STAGES) mbar_wait(empty + 8 * stage, par ^ 1u);
          const unsigned bar = full + 8 * stage;
          mbar_expect(bar, K::STAGE_BYTES);
#pragma unroll
          for (int slot = 0; slot < K::TPS; ++slot) {
            const unsigned dst = ring + stage * K::STAGE_BYTES + slot * TILE;
            if (r < up_steps) {
              // 32 value rows from hc0, then their 32 gate rows from inner + hc0
              const int half = SPLIT ? slot : (r >= kt);
              const int kk = SPLIT ? r : r - half * kt;
              const int hc0 = c0 + 32 * half;
              tma_load(dst, &tm_up, 64 * kk, hc0, bar);
              tma_load(dst + TILE / 2, &tm_up, 64 * kk, inner + hc0, bar);
            } else {
              // the rows of Wd (output columns) of the piece, the chunk's columns
              const int piece = (SPLIT ? slot * npw : 0) + r - up_steps;
              tma_load(dst, &tm_dn, c0, 64 * piece, bar);
            }
          }
          if (++stage == K::STAGES) {
            stage = 0;
            par ^= 1u;
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = tid - 128;  // thread within the consumers
  const int wg = ct >> 7;
  const int warp = (ct >> 5) & 3;
  const int lane = ct & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // without the split a warpgroup meets only itself; with it, both meet
  const int bar_id = SPLIT ? 1 : 2 + wg;
  const int bar_threads = SPLIT ? 256 : 128;
  const int tile_slot = SPLIT ? wg : 0;  // this warpgroup's tile of a stage
  // this warpgroup's 64 rows of x (k-tile 0)
  const unsigned x_wg = x_s + (SPLIT ? 0 : wg * 64 * 128);
  const int hrow = warp * 16 + g;  // rows hrow and hrow + 8 of the warpgroup's 64

  int stage = 0;
  unsigned par = 0;
  auto acquire = [&]() { mbar_wait(full + 8 * stage, par); };
  // the step's products have completed: the stage is this warp's no more
  auto release = [&]() {
    wg_wait();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * stage);
    if (++stage == K::STAGES) {
      stage = 0;
      par ^= 1u;
    }
  };

  for (int rb = blockIdx.x; rb < row_blocks; rb += gridDim.x) {
    // ---- x of the row block, dequantized once: bf16(code * scale); without
    // the split each warpgroup converts its own 64 rows. Every load of the
    // thread's share (XCH chunks of 8 codes at most) is in flight before the
    // first conversion ----
    {
      const int per_row = kt * 8;  // 8-code chunks a row, zeros past C
      const int r0 = SPLIT ? 0 : 64 * wg;
      const int first = SPLIT ? ct : ct - 128 * wg;
      uint2 codes[XCH];
      float scl[XCH];
#pragma unroll
      for (int j = 0; j < XCH; ++j) {
        const int i = first + j * bar_threads;
        const int grow = rb * K::ROWS + r0 + i / per_row;
        const int col = 8 * (i % per_row);
        codes[j] = make_uint2(0u, 0u);
        scl[j] = 0.f;
        if (i < 64 * per_row && grow < p.m && col < c) {
          codes[j] = *reinterpret_cast<const uint2*>(p.xi + (size_t)grow * c + col);
          scl[j] = p.xs[grow];
        }
      }
#pragma unroll
      for (int j = 0; j < XCH; ++j) {
        const int i = first + j * bar_threads;
        if (i < 64 * per_row) {
          const int r = r0 + i / per_row;
          const int ch = i % per_row;
          const signed char* cb = reinterpret_cast<const signed char*>(&codes[j]);
          const float sc = scl[j];
          *reinterpret_cast<uint4*>(gbase + (ch >> 3) * (K::ROWS * 128) +
                                    sw128_offset(r, ch & 7)) =
              make_uint4(pack_bf16((float)cb[0] * sc, (float)cb[1] * sc),
                         pack_bf16((float)cb[2] * sc, (float)cb[3] * sc),
                         pack_bf16((float)cb[4] * sc, (float)cb[5] * sc),
                         pack_bf16((float)cb[6] * sc, (float)cb[7] * sc));
        }
      }
    }
    fence_async_proxy();
    bar_sync(bar_id, bar_threads);

    float acc[NPW][32];
#pragma unroll
    for (int pc = 0; pc < NPW; ++pc)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[pc][i] = 0.f;

    for (int sc = 0; sc < nsc; ++sc) {
      const int c0 = 64 * sc;
      // the chunk's hidden tile: the warpgroup's own, or the shared one of this parity
      const int hbuf = SPLIT ? (sc & 1) : wg;
      unsigned char* const h_gen = gbase + X_BYTES + hbuf * TILE;
      // ---- up-projection and GEGLU, one or both halves of the chunk ----
      for (int hh = 0; hh < (SPLIT ? 1 : 2); ++hh) {
        const int half = SPLIT ? wg : hh;
        float up[32];
        for (int kk = 0; kk < kt; ++kk) {
          acquire();
          const uint64_t da = wg_desc_sw128(x_wg + kk * (K::ROWS * 128));
          const uint64_t db = wg_desc_sw128(ring + stage * K::STAGE_BYTES + tile_slot * TILE);
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_ss_n64(up, da + wg_step(32 * ks), db + wg_step(32 * ks), kk | ks);
          wg_commit();
          release();
        }
        // columns 0-31 of `up` are value columns, 32-63 the matching gate columns
        const int hc0 = c0 + 32 * half;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t lo = 0u, hi = 0u;
          if (hc0 < inner) {
            const int col = hc0 + 8 * j + 2 * t4;
            const float2 bv = *reinterpret_cast<const float2*>(b_up + col);
            const float2 bg = *reinterpret_cast<const float2*>(b_up + inner + col);
            const float* v = up + 4 * j;
            const float* gt = up + 4 * (j + 4);
            lo = pack_bf16((v[0] + bv.x) * ls_gemm::gelu_erf(gt[0] + bg.x),
                           (v[1] + bv.y) * ls_gemm::gelu_erf(gt[1] + bg.y));
            hi = pack_bf16((v[2] + bv.x) * ls_gemm::gelu_erf(gt[2] + bg.x),
                           (v[3] + bv.y) * ls_gemm::gelu_erf(gt[3] + bg.y));
          }
          const int ch = 4 * half + j;
          *reinterpret_cast<uint32_t*>(h_gen + sw128_offset(hrow, ch) + 4 * t4) = lo;
          *reinterpret_cast<uint32_t*>(h_gen + sw128_offset(hrow + 8, ch) + 4 * t4) = hi;
        }
      }
      fence_async_proxy();  // the hidden tile, complete, to the matrix unit
      bar_sync(bar_id, bar_threads);
      // ---- down-projection of the chunk onto the result, 64 columns a step ----
      const uint64_t dh = wg_desc_sw128(h_s + hbuf * TILE);
#pragma unroll
      for (int pc = 0; pc < NPW; ++pc) {
        if (pc < npw) {
          acquire();
          const uint64_t db = wg_desc_sw128(ring + stage * K::STAGE_BYTES + tile_slot * TILE);
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_ss_n64(acc[pc], dh + wg_step(32 * ks), db + wg_step(32 * ks), 1);
          wg_commit();
          release();
        }
      }
    }

    // ---- epilogue: + bd, row amax, codes and scales ----
    const int row0 = rb * K::ROWS + (SPLIT ? 0 : wg * 64) + hrow;
    const int row1 = row0 + 8;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int pc = 0; pc < NPW; ++pc) {
      if (pc < npw) {
        const int n0 = 64 * ((SPLIT ? wg * npw : 0) + pc);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = n0 + 8 * j + 2 * t4;
          if (col < c) {
            const float2 bd = *reinterpret_cast<const float2*>(b_dn + col);
            float* r = acc[pc] + 4 * j;
            r[0] += bd.x;
            r[1] += bd.y;
            r[2] += bd.x;
            r[3] += bd.y;
            a0 = fmaxf(a0, fmaxf(fabsf(r[0]), fabsf(r[1])));
            a1 = fmaxf(a1, fmaxf(fabsf(r[2]), fabsf(r[3])));
          }
        }
      }
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      a0 = fmaxf(a0, __shfl_xor_sync(LS_FULL_MASK, a0, x));
      a1 = fmaxf(a1, __shfl_xor_sync(LS_FULL_MASK, a1, x));
    }
    if (SPLIT) {  // the two warpgroups hold halves of each row: merge
      if (t4 == 0) {
        red[wg * 64 + hrow] = a0;
        red[wg * 64 + hrow + 8] = a1;
      }
      bar_sync(bar_id, bar_threads);
      a0 = fmaxf(red[hrow], red[64 + hrow]);
      a1 = fmaxf(red[hrow + 8], red[64 + hrow + 8]);
    }
    const float s0 = a0 / 127.0f + 1e-12f;
    const float s1 = a1 / 127.0f + 1e-12f;
#pragma unroll
    for (int pc = 0; pc < NPW; ++pc) {
      if (pc < npw) {
        const int n0 = 64 * ((SPLIT ? wg * npw : 0) + pc);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = n0 + 8 * j + 2 * t4;
          if (col < c) {
            const float* r = acc[pc] + 4 * j;
            if (row0 < p.m)
              *reinterpret_cast<char2*>(p.out + (size_t)row0 * c + col) =
                  make_char2((signed char)__float2int_rn(__fdiv_rn(r[0], s0)),
                             (signed char)__float2int_rn(__fdiv_rn(r[1], s0)));
            if (row1 < p.m)
              *reinterpret_cast<char2*>(p.out + (size_t)row1 * c + col) =
                  make_char2((signed char)__float2int_rn(__fdiv_rn(r[2], s1)),
                             (signed char)__float2int_rn(__fdiv_rn(r[3], s1)));
          }
        }
      }
    }
    if (t4 == 0 && (!SPLIT || wg == 0)) {
      if (row0 < p.m) p.out_scale[row0] = s0;
      if (row1 < p.m) p.out_scale[row1] = s1;
    }
  }
}

// cuTensorMapEncodeTiled, looked up through cudaGetDriverEntryPoint (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a row-major bf16 (rows, cols) matrix read in boxes of box_rows x 64 columns
// (128 bytes), 128-byte swizzled in shared memory as the wgmma descriptors
// expect, zeros past its edges
static bool weight_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool SPLIT>
cudaError_t launch(const Args& a, const void* w_up, const void* w_dn, cudaStream_t s) {
  using K = Cfg<SPLIT>;
  alignas(64) CUtensorMap tm_up, tm_dn;
  if (!weight_map(&tm_up, w_up, 8 * a.c, a.c, 32) || !weight_map(&tm_dn, w_dn, a.c, 4 * a.c, 64))
    return cudaErrorInvalidValue;
  cudaError_t e = ls_allow_smem(geglu_i8_kernel<SPLIT>, K::SMEM);
  if (e != cudaSuccess) return e;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
  }
  const int row_blocks = (a.m + K::ROWS - 1) / K::ROWS;
  const int blocks = row_blocks < sms ? row_blocks : sms;  // one block an SM
  geglu_i8_kernel<SPLIT><<<blocks, THREADS, K::SMEM, s>>>(a, tm_up, tm_dn, row_blocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ls_geglu_ffn_int8io(const void* xi, const float* xs, int m, int c, const void* w_up,
                                   const float* b_up, const void* w_down, const float* b_down,
                                   void* out_codes, float* out_scales, void* stream) {
  if (m < 0 || c <= 0 || c % 8 || c > MAX_C || (long long)m * c > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const Args a = {static_cast<const int8_t*>(xi), xs, m, c, b_up, b_down,
                  static_cast<int8_t*>(out_codes), out_scales};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(c > 320 ? launch<true>(a, w_up, w_down, s) : launch<false>(a, w_up, w_down, s));
}
