// K11: one-shot (whole-row) attention over (B, S, D), B folding batch and
// heads, S <= 1024:
//   s = q k^T * scale (f32);  p = exp(s - max) / sum  (exact, two passes);
//   o = bf16(p) v with f32 accumulation.
// Replaces the TPU kernel latentsync_tpu/ops/attention.py _oneshot_kernel
// (:109, pallas_call at :130), which held the whole (S, S) f32 logits of
// one (batch, head) in VMEM. A Hopper block has 227 KB, so one block owns
// 32 query rows of one (batch, head) and holds THEIR whole S-long f32
// logit rows in shared memory (128 KB at S = 1024): the softmax is the
// exact max / exp / divide over the full row, not an online one, and the
// probabilities are rounded to bf16 before the value product, as the TPU
// kernel rounds them. The bf16 probabilities overwrite the front half of
// their own f32 row (see phase 2), which leaves the rest of shared memory
// to one large K/V tile.
//
// Three phases, 8 warps:
//   1. keys stream through shared memory up to 512 at a time (two loads at
//      S = 1024); for each 64 keys of the tile every warp computes a
//      16 x 16 piece of the 32 x 64 logits with mma.sync m16n8k16 and
//      writes it, scaled, into the logit rows;
//   2. 8 threads per row: max, exp and sum, then p / sum as bf16, written
//      in place: the threads of a row move in lockstep 8 columns at a time,
//      and the bf16 values of columns [8i, 8i + 8) land on the f32 words
//      [4i, 4i + 4), which were read at step i / 2 or, for i = 0, are read
//      before a __syncwarp in the same step;
//   3. values stream through the same tile; warp w owns the m-tile w & 1
//      and the 16-key slice w >> 1 of each 64 keys, accumulating all DP
//      output columns; the four key slices of each m-tile are summed
//      through shared memory (the K/V tile, dead by then).
// Head dims 40 and 80 are no multiple of the MMA's 16-deep k-step: the Q,
// K and V tiles are zero-padded in shared memory to DP = 48 and 80.
//
// Bound: operations, 4 B S^2 D FLOP on the tensor cores against 4 B S D
// bf16 values moved (at S = 1024 about 1000 FLOP per byte). One block fits
// an SM, so nothing hides a load: the K/V tile is as large as shared memory
// allows (few waits) and its loads go out together as cp.async. What this
// version waits on is the softmax's three passes on the FP32 pipes and each
// tile's arrival before its products start (no pipeline yet).
#include "mma.cuh"

namespace {

using namespace ls_mma;

constexpr int OQ = 32;  // query rows per block
constexpr int OC = 64;  // keys of one logits step
constexpr int O_THREADS = 256;
constexpr int O_WARPS = O_THREADS / 32;

template <int D>
struct Dims {
  static constexpr int DP = (D + 15) / 16 * 16;
  static constexpr int LD = DP + 8;  // bf16 pitch of the Q and K/V tiles
  static constexpr int NT = DP / 8;
  static constexpr int MAX_TILE = 512;  // keys of the K/V tile
  static __host__ __device__ int tile_keys(int seq) { return seq < MAX_TILE ? seq : MAX_TILE; }
  // bf16 elements of the K/V tile, which later holds the 8 warps' f32 partial sums
  static __host__ __device__ int tile_elems(int seq) {
    const int kv = tile_keys(seq) * LD;
    const int red = O_WARPS * 16 * DP * 2;
    return kv > red ? kv : red;
  }
  static size_t smem(int seq) {
    return (size_t)(OQ * LD + tile_elems(seq)) * sizeof(bf16) +
           (size_t)OQ * (seq + 4) * sizeof(float);
  }
};

template <int D>
__global__ void __launch_bounds__(O_THREADS, 1)
    oneshot_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, int seq, float scale) {
  constexpr int DP = Dims<D>::DP;
  constexpr int LD = Dims<D>::LD;
  constexpr int NT = Dims<D>::NT;
  const int lds = seq + 4;  // f32 pitch of the logit rows
  const int ldp = 2 * lds;  // bf16 pitch of the probabilities, in place in those rows
  const int tile = Dims<D>::tile_keys(seq);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qt = reinterpret_cast<bf16*>(smem_raw);
  bf16* ct = qt + OQ * LD;  // the staged K, then V, tile
  float* st = reinterpret_cast<float*>(ct + Dims<D>::tile_elems(seq));
  const bf16* pt = reinterpret_cast<const bf16*>(st);

  const long bh = blockIdx.x;
  const int q0 = blockIdx.y * OQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bf16* kbase = k + bh * seq * D;
  const bf16* vbase = v + bh * seq * D;

  copy_rows<D, DP, O_THREADS>(qt, LD, q + (bh * seq + q0) * D, D, OQ);

  // phase 1: logits. warp w: rows [16 (w & 1), +16) x keys [16 (w >> 1), +16) of each 64
  const int s_r0 = (warp & 1) * 16;
  const int s_c0 = (warp >> 1) * 16;
  uint32_t aq[DP / 16][4];  // this warp's Q fragments, the same for every key
  for (int k0 = 0; k0 < seq; k0 += tile) {
    const int rows = min(tile, seq - k0);
    __syncthreads();  // the previous tile has been read
    copy_rows<D, DP, O_THREADS>(ct, LD, kbase + (long)k0 * D, D, rows);
    copy_wait();
    __syncthreads();  // (Q is staged too)
    if (k0 == 0) {
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) load_a(aq[kk / 16], qt, LD, s_r0, kk, g, t);
    }
    for (int kb = 0; kb < rows; kb += OC) {
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bf16* kr = ct + (kb + s_c0 + j * 8 + g) * LD + kk + 2 * t;
          mma16816(sc[j], aq[kk / 16], ld32(kr), ld32(kr + 8));
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = k0 + kb + s_c0 + j * 8 + 2 * t;
        st[(s_r0 + g) * lds + c] = sc[j][0] * scale;
        st[(s_r0 + g) * lds + c + 1] = sc[j][1] * scale;
        st[(s_r0 + g + 8) * lds + c] = sc[j][2] * scale;
        st[(s_r0 + g + 8) * lds + c + 1] = sc[j][3] * scale;
      }
    }
  }
  __syncthreads();

  {  // phase 2: exact softmax of each whole row, 8 threads (one quarter warp) a row
    const int r = tid >> 3;
    const int part = tid & 7;
    float* row = st + r * lds;
    float mx = -INFINITY;
    for (int c = part; c < seq; c += 8) mx = fmaxf(mx, row[c]);
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(LS_FULL_MASK, mx, off));
    float sum = 0.f;
    for (int c = part; c < seq; c += 8) {
      const float e = expf(row[c] - mx);
      row[c] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) sum += __shfl_xor_sync(LS_FULL_MASK, sum, off);
    bf16* prow = reinterpret_cast<bf16*>(row);
    for (int c = part; c < seq; c += 8) {  // every lane runs seq / 8 steps
      const bf16 pv = __float2bfloat16(row[c] / sum);
      __syncwarp();  // the row's threads have read step i before any writes over it
      prow[c] = pv;
    }
  }

  // phase 3: o = p v. warp w: m-tile w & 1, keys [16 (w >> 1), +16) of each 64
  const int mt = warp & 1;
  const int ks = warp >> 1;
  const unsigned short* ct16 = reinterpret_cast<const unsigned short*>(ct);
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int k0 = 0; k0 < seq; k0 += tile) {
    const int rows = min(tile, seq - k0);
    __syncthreads();  // the previous tile has been read (and P is written)
    copy_rows<D, DP, O_THREADS>(ct, LD, vbase + (long)k0 * D, D, rows);
    copy_wait();
    __syncthreads();
    for (int kb = 0; kb < rows; kb += OC) {
      uint32_t a[4];
      load_a(a, pt, ldp, mt * 16, k0 + kb + ks * 16, g, t);
      const int r0 = kb + ks * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n * 8 + g;
        const uint32_t b0 = pack2(ct16, r0 * LD + col, (r0 + 1) * LD + col);
        const uint32_t b1 = pack2(ct16, (r0 + 8) * LD + col, (r0 + 9) * LD + col);
        mma16816(acc[n], a, b0, b1);
      }
    }
  }
  __syncthreads();  // the last V tile has been read

  // sum the four key slices of each m-tile through the (dead) K/V tile
  float* red = reinterpret_cast<float*>(ct);
  float* mine = red + warp * 16 * DP;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    mine[g * DP + c] = acc[n][0];
    mine[g * DP + c + 1] = acc[n][1];
    mine[(g + 8) * DP + c] = acc[n][2];
    mine[(g + 8) * DP + c + 1] = acc[n][3];
  }
  __syncthreads();
  for (int i = tid; i < OQ * (D / 2); i += O_THREADS) {
    const int r = i / (D / 2);
    const int c = (i % (D / 2)) * 2;
    float x0 = 0.f, x1 = 0.f;
#pragma unroll
    for (int s = 0; s < O_WARPS / 2; ++s) {
      const float* src = red + ((s * 2 + (r >> 4)) * 16 + (r & 15)) * DP + c;
      x0 += src[0];
      x1 += src[1];
    }
    *reinterpret_cast<bf162*>(o + (bh * seq + q0 + r) * D + c) = __floats2bfloat162_rn(x0, x1);
  }
}

template <int D>
cudaError_t oneshot_d(const bf16* q, const bf16* k, const bf16* v, bf16* o, int bh, int seq,
                      float scale, cudaStream_t s) {
  const size_t smem = Dims<D>::smem(seq);
  cudaError_t e = ls_allow_smem(oneshot_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, seq / OQ);
  oneshot_kernel<D><<<grid, O_THREADS, smem, s>>>(q, k, v, o, seq, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous (bh, seq, d) bf16; seq a multiple of 64, at most 1024.
extern "C" int ls_oneshot_attention(const void* q, const void* k, const void* v, void* o, int bh,
                                    int seq, int d, float scale, void* stream) {
  if (seq % OC != 0 || seq > 1024 || seq <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  switch (d) {
    case 40: return (int)oneshot_d<40>(qp, kp, vp, op, bh, seq, scale, s);
    case 80: return (int)oneshot_d<80>(qp, kp, vp, op, bh, seq, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
