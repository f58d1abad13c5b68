// The gradient of the flash route (flash_attention.cu): dQ, dK and dV of
// unmasked softmax attention over (B, S, H, D) bf16, with the probabilities
// rounded to bf16 before the value product (the forward's P_ROUNDED):
//   P  = softmax(scale * Q K^T)        (f32 logits and statistics)
//   dV = bf16(P)^T dO
//   dP = dO V^T
//   dS = P * (dP - delta) * scale,    delta = rowsum(P * dP)
//   dQ = dS K,  dK = dS^T Q
// Replaces the VJP of jax's library TPU flash kernel that the reference's
// route reaches (latentsync_tpu/ops/attention.py _flash_bshd :85, routed at
// :51-59): _flash_attention_bwd_dkv (jax flash_attention.py :941, its
// pallas_call :1121) and _flash_attention_bwd_dq (:1287 / :1456). On the
// training path: the VAE mid-block's decode, (16, 1024, 1, 512); and, through
// K4's and K2's composed gradients (_spatial_xla routes its attention), the
// UNet's spatial attention at (16, 1024, 8, 40) and (16, 256, 8, 80).
//
// Three launches, each a block of eight warps on mma.sync m16n8k16 with
// ldmatrix operands from shared memory (csrc/mma_sync.cuh):
//   1. stats: a block owns 32 query rows and sweeps the keys in tiles of
//      32, computing s = q k^T and dp = do v^T for the tile; eight threads a
//      row keep a running max, sum and sum of p * dp over their columns and
//      merge them at the end into the row's log-sum-exp and delta (the
//      forward writes no row statistics, so they are recomputed here: one
//      more sweep of two products);
//   2. dK / dV: a block owns 16 keys (K and V tiles stay in shared memory)
//      and sweeps the queries in tiles of 32, recomputing s and dp, then P =
//      exp(s - lse) rounded to bf16 and dS, both stored key-major, and
//      accumulating dV += P^T do and dK += dS^T q in registers (16 keys x D
//      f32 each, spread over the eight warps);
//   3. dQ: a block owns 32 query rows and sweeps the keys in tiles of 32,
//      recomputing s, dp and dS, and accumulating dQ += dS k in registers.
// Head dims are zero-padded to the 16-deep k-step in shared memory (40 ->
// 48); each tile row is padded to an odd number of 16-byte chunks so that
// the eight rows an ldmatrix phase reads fall in distinct banks. Tiles are
// loaded with 16-byte loads and no pipelining: a simple kernel first.
//
// Bound: operations. The function needs five products of S^2 D (s, dp, dV,
// dK, dQ: 10 S^2 D FLOP a (batch, head)); this design does nine (s and dp
// in each of the three sweeps), and reads q and do from L2 once per 16-key
// block in the dK / dV sweep. At (16, 1024, 1, 512) the five products are
// 85.9 GFLOP.
#include "mma_sync.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 32;   // query rows of a tile
constexpr int kBK = 32;   // keys of a tile in the stats and dQ sweeps
constexpr int kBKV = 16;  // keys a dK / dV block owns

struct Args {
  const bf16 *q, *k, *v, *dout;
  int ldq, ldk, ldv, ldo;  // row pitches in elements
  bf16 *dq, *dk, *dv;      // contiguous (B, S, H, D)
  float *lse, *delta;      // (B * H * S)
  int seq, heads, d;
  float scale;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// rows x D of one (batch, head) slice into a shared tile of DP columns at row
// pitch RP bytes; columns D..DP-1 are zeros
template <int DP>
__device__ __forceinline__ void load_tile(char* tile, const bf16* g, int ld, int rows, int d) {
  constexpr int kCh = DP / 8;
  constexpr int kRP = ls_mma::odd_row_bytes(DP);
  for (int i = threadIdx.x; i < rows * kCh; i += kThreads) {
    const int r = i / kCh, c = i % kCh;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (c * 8 < d) val = *reinterpret_cast<const uint4*>(g + (size_t)r * ld + c * 8);
    *reinterpret_cast<uint4*>(tile + r * kRP + c * 16) = val;
  }
}

// c (16 x 8, f32) = a[a_row0 .. +16) . b[b_row0 .. +8)^T over DP columns; a
// and b are shared tiles of DP columns at pitch RP ([rows][columns])
template <int DP>
__device__ __forceinline__ void mma_abt(float (&c)[4], const char* a, int a_row0, const char* b,
                                        int b_row0) {
  constexpr int kRP = ls_mma::odd_row_bytes(DP);
  const int lane = threadIdx.x & 31;
  c[0] = c[1] = c[2] = c[3] = 0.f;
  const unsigned pa = smem_u32(a) + (a_row0 + (lane & 15)) * kRP + (lane >> 4) * 16;
  const unsigned pb = smem_u32(b) + (b_row0 + (lane & 7)) * kRP + ((lane >> 3) & 1) * 16;
#pragma unroll 4
  for (int k0 = 0; k0 < DP; k0 += 16) {
    uint32_t af[4], bf[2];
    ls_mma::ldsm_x4(af, pa + k0 * 2);
    ls_mma::ldsm_x2(bf, pb + k0 * 2);
    ls_mma::mma_k16(c, af, bf[0], bf[1]);
  }
}

// acc[i] (16 x 8 each, n-tiles nt0 + 4 i) += a (16 x 32, [m][k] at pitch kTP)
// . b (32 x DP, [k][n] at pitch RP, read transposed by ldmatrix)
template <int DP, int NPW>
__device__ __forceinline__ void mma_ab(float (&acc)[NPW][4], const char* a, int a_row0,
                                       int a_pitch, const char* b, int nt0) {
  constexpr int kRP = ls_mma::odd_row_bytes(DP);
  constexpr int kNT = DP / 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t af[4];
    ls_mma::ldsm_x4(af, smem_u32(a) + (a_row0 + (lane & 15)) * a_pitch + ks * 32 +
                            (lane >> 4) * 16);
    const unsigned pb = smem_u32(b) + (ks * 16 + (lane & 15)) * kRP;
#pragma unroll
    for (int i = 0; i < NPW; ++i) {
      const int nt = nt0 + 4 * i;
      if (nt < kNT) {
        uint32_t bf[2];
        ls_mma::ldsm_x2_t(bf, pb + nt * 16);
        ls_mma::mma_k16(acc[i], af, bf[0], bf[1]);
      }
    }
  }
}

// acc (rows r0 + g, r0 + g + 8; columns nt * 8 + 2 t, + 1) -> bf16 rows of a
// contiguous (B, S, H, D) gradient
template <int DP, int NPW>
__device__ __forceinline__ void store_rows(const float (&acc)[NPW][4], bf16* out, int r0,
                                           int nt0, int d, int hd) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < NPW; ++i) {
    const int col = (nt0 + 4 * i) * 8 + 2 * t;
    if (col < d) {
      *reinterpret_cast<bf162*>(out + (size_t)(r0 + g) * hd + col) =
          __floats2bfloat162_rn(acc[i][0], acc[i][1]);
      *reinterpret_cast<bf162*>(out + (size_t)(r0 + g + 8) * hd + col) =
          __floats2bfloat162_rn(acc[i][2], acc[i][3]);
    }
  }
}

// the (16 x 8) accumulator c of tile (mt, nt) into an f32 array at pitch `ld`
__device__ __forceinline__ void store_f32(float* dst, int ld, int mt, int nt, const float (&c)[4],
                                          float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* p = dst + (mt * 16 + g) * ld + nt * 8 + 2 * t;
  p[0] = c[0] * mul;
  p[1] = c[1] * mul;
  p[8 * ld] = c[2] * mul;
  p[8 * ld + 1] = c[3] * mul;
}

struct Slice {
  const bf16 *q, *k, *v, *o;
  size_t stat;  // offset of this (batch, head)'s rows in lse / delta
  size_t out;   // offset of its row 0, column 0 in the gradients
};

__device__ __forceinline__ Slice slice(const Args& a) {
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const size_t row0 = (size_t)b * a.seq;
  return {a.q + row0 * a.ldq + h * a.d, a.k + row0 * a.ldk + h * a.d,
          a.v + row0 * a.ldv + h * a.d, a.dout + row0 * a.ldo + h * a.d,
          (size_t)bh * a.seq, row0 * a.heads * a.d + h * a.d};
}

// 1. the row statistics
template <int DP>
__global__ void __launch_bounds__(kThreads) stats_kernel(Args a) {
  constexpr int kRP = ls_mma::odd_row_bytes(DP);
  extern __shared__ __align__(16) char smem[];
  char* qs = smem;
  char* os = qs + kBQ * kRP;
  char* ks = os + kBQ * kRP;
  char* vs = ks + kBK * kRP;
  float* s = reinterpret_cast<float*>(vs + kBK * kRP);  // [kBQ][kBK + 1], scaled logits
  float* dp = s + kBQ * (kBK + 1);
  const Slice sl = slice(a);
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, mt = warp >> 2, nt = warp & 3;
  load_tile<DP>(qs, sl.q + (size_t)q0 * a.ldq, a.ldq, kBQ, a.d);
  load_tile<DP>(os, sl.o + (size_t)q0 * a.ldo, a.ldo, kBQ, a.d);
  const int row = threadIdx.x >> 3, part = threadIdx.x & 7;
  float m = -INFINITY, l = 0.f, du = 0.f;
  for (int k0 = 0; k0 < a.seq; k0 += kBK) {
    load_tile<DP>(ks, sl.k + (size_t)k0 * a.ldk, a.ldk, kBK, a.d);
    load_tile<DP>(vs, sl.v + (size_t)k0 * a.ldv, a.ldv, kBK, a.d);
    __syncthreads();
    float c[4];
    mma_abt<DP>(c, qs, mt * 16, ks, nt * 8);
    store_f32(s, kBK + 1, mt, nt, c, a.scale);
    mma_abt<DP>(c, os, mt * 16, vs, nt * 8);
    store_f32(dp, kBK + 1, mt, nt, c, 1.f);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const int col = part * (kBK / 8) + j;
      const float x = s[row * (kBK + 1) + col];
      if (x > m) {
        const float corr = __expf(m - x);
        l *= corr;
        du *= corr;
        m = x;
      }
      const float p = __expf(x - m);
      l += p;
      du += p * dp[row * (kBK + 1) + col];
    }
    __syncthreads();
  }
  // merge the eight parts of a row (eight neighbouring lanes)
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    const float mo = __shfl_xor_sync(LS_FULL_MASK, m, off);
    const float lo = __shfl_xor_sync(LS_FULL_MASK, l, off);
    const float uo = __shfl_xor_sync(LS_FULL_MASK, du, off);
    const float mn = fmaxf(m, mo);
    const float ca = __expf(m - mn), cb = __expf(mo - mn);
    l = l * ca + lo * cb;
    du = du * ca + uo * cb;
    m = mn;
  }
  if (part == 0) {
    a.lse[sl.stat + q0 + row] = m + __logf(l);
    a.delta[sl.stat + q0 + row] = du / l;
  }
}

// 2. dK and dV of 16 keys
template <int DP>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(Args a) {
  constexpr int kRP = ls_mma::odd_row_bytes(DP);
  constexpr int kTP = ls_mma::odd_row_bytes(kBQ);  // a bf16 tile 32 wide
  constexpr int kNPW = (DP / 8 + 3) / 4;
  extern __shared__ __align__(16) char smem[];
  char* ks = smem;
  char* vs = ks + kBKV * kRP;
  char* qs = vs + kBKV * kRP;
  char* os = qs + kBQ * kRP;
  char* pt = os + kBQ * kRP;     // [kBKV][kBQ] bf16(P)^T
  char* dst = pt + kBKV * kTP;   // [kBKV][kBQ] bf16(dS)^T
  float* s = reinterpret_cast<float*>(dst + kBKV * kTP);  // [kBQ][kBKV + 1]
  float* dp = s + kBQ * (kBKV + 1);
  float* lse = dp + kBQ * (kBKV + 1);
  float* delta = lse + kBQ;
  const Slice sl = slice(a);
  const int k0 = blockIdx.x * kBKV;
  const int warp = threadIdx.x >> 5;
  load_tile<DP>(ks, sl.k + (size_t)k0 * a.ldk, a.ldk, kBKV, a.d);
  load_tile<DP>(vs, sl.v + (size_t)k0 * a.ldv, a.ldv, kBKV, a.d);
  // phase A: warps 0-3 the four (16 x 8) tiles of s, warps 4-7 those of dp
  const bool is_dp = warp >= 4;
  const int mt = (warp & 3) >> 1, nt = warp & 1;
  // phase B: warps 0-3 dV, 4-7 dK, n-tiles (warp & 3) + 4 i
  const int nt0 = warp & 3;
  float acc[kNPW][4];
#pragma unroll
  for (int i = 0; i < kNPW; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int q0 = 0; q0 < a.seq; q0 += kBQ) {
    load_tile<DP>(qs, sl.q + (size_t)q0 * a.ldq, a.ldq, kBQ, a.d);
    load_tile<DP>(os, sl.o + (size_t)q0 * a.ldo, a.ldo, kBQ, a.d);
    if (threadIdx.x < kBQ) {
      lse[threadIdx.x] = a.lse[sl.stat + q0 + threadIdx.x];
      delta[threadIdx.x] = a.delta[sl.stat + q0 + threadIdx.x];
    }
    __syncthreads();
    float c[4];
    if (is_dp) {
      mma_abt<DP>(c, os, mt * 16, vs, nt * 8);
      store_f32(dp, kBKV + 1, mt, nt, c, 1.f);
    } else {
      mma_abt<DP>(c, qs, mt * 16, ks, nt * 8);
      store_f32(s, kBKV + 1, mt, nt, c, a.scale);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kBQ * kBKV; e += kThreads) {
      const int r = e / kBKV, col = e % kBKV;
      const float p = __expf(s[r * (kBKV + 1) + col] - lse[r]);
      const float ds = p * (dp[r * (kBKV + 1) + col] - delta[r]) * a.scale;
      reinterpret_cast<bf16*>(pt + col * kTP)[r] = __float2bfloat16_rn(p);
      reinterpret_cast<bf16*>(dst + col * kTP)[r] = __float2bfloat16_rn(ds);
    }
    __syncthreads();
    if (is_dp)
      mma_ab<DP, kNPW>(acc, dst, 0, kTP, qs, nt0);  // dK += dS^T q
    else
      mma_ab<DP, kNPW>(acc, pt, 0, kTP, os, nt0);   // dV += P^T do
    __syncthreads();
  }
  store_rows<DP, kNPW>(acc, (is_dp ? a.dk : a.dv) + sl.out, k0, nt0, a.d, a.heads * a.d);
}

// 3. dQ of 32 query rows
template <int DP>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  constexpr int kRP = ls_mma::odd_row_bytes(DP);
  constexpr int kTP = ls_mma::odd_row_bytes(kBK);
  constexpr int kNPW = (DP / 8 + 3) / 4;
  extern __shared__ __align__(16) char smem[];
  char* qs = smem;
  char* os = qs + kBQ * kRP;
  char* ks = os + kBQ * kRP;
  char* vs = ks + kBK * kRP;
  char* dss = vs + kBK * kRP;  // [kBQ][kBK] bf16(dS)
  float* s = reinterpret_cast<float*>(dss + kBQ * kTP);  // [kBQ][kBK + 1]
  float* dp = s + kBQ * (kBK + 1);
  float* lse = dp + kBQ * (kBK + 1);
  float* delta = lse + kBQ;
  const Slice sl = slice(a);
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, mt = warp >> 2, nt = warp & 3;
  const int bmt = warp & 1, nt0 = warp >> 1;
  load_tile<DP>(qs, sl.q + (size_t)q0 * a.ldq, a.ldq, kBQ, a.d);
  load_tile<DP>(os, sl.o + (size_t)q0 * a.ldo, a.ldo, kBQ, a.d);
  if (threadIdx.x < kBQ) {
    lse[threadIdx.x] = a.lse[sl.stat + q0 + threadIdx.x];
    delta[threadIdx.x] = a.delta[sl.stat + q0 + threadIdx.x];
  }
  float acc[kNPW][4];
#pragma unroll
  for (int i = 0; i < kNPW; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int k0 = 0; k0 < a.seq; k0 += kBK) {
    load_tile<DP>(ks, sl.k + (size_t)k0 * a.ldk, a.ldk, kBK, a.d);
    load_tile<DP>(vs, sl.v + (size_t)k0 * a.ldv, a.ldv, kBK, a.d);
    __syncthreads();
    float c[4];
    mma_abt<DP>(c, qs, mt * 16, ks, nt * 8);
    store_f32(s, kBK + 1, mt, nt, c, a.scale);
    mma_abt<DP>(c, os, mt * 16, vs, nt * 8);
    store_f32(dp, kBK + 1, mt, nt, c, 1.f);
    __syncthreads();
    for (int e = threadIdx.x; e < kBQ * kBK; e += kThreads) {
      const int r = e / kBK, col = e % kBK;
      const float p = __expf(s[r * (kBK + 1) + col] - lse[r]);
      const float ds = p * (dp[r * (kBK + 1) + col] - delta[r]) * a.scale;
      reinterpret_cast<bf16*>(dss + r * kTP)[col] = __float2bfloat16_rn(ds);
    }
    __syncthreads();
    mma_ab<DP, kNPW>(acc, dss, bmt * 16, kTP, ks, nt0);  // dQ += dS k
    __syncthreads();
  }
  store_rows<DP, kNPW>(acc, a.dq + sl.out, q0 + bmt * 16, nt0, a.d, a.heads * a.d);
}

template <int DP>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int kRP = ls_mma::odd_row_bytes(DP);
  constexpr int kTP = ls_mma::odd_row_bytes(kBQ);
  if (a.seq % kBQ || a.seq % kBK || a.seq % kBKV || a.d > DP || a.d % 8 || a.ldq % 8 ||
      a.ldk % 8 || a.ldv % 8 || a.ldo % 8 || batch * a.heads > 65535)
    return cudaErrorInvalidValue;
  const size_t stats_smem = (2 * kBQ + 2 * kBK) * kRP + 2 * kBQ * (kBK + 1) * sizeof(float);
  const size_t dkdv_smem = (2 * kBKV + 2 * kBQ) * kRP + 2 * kBKV * kTP +
                           (2 * kBQ * (kBKV + 1) + 2 * kBQ) * sizeof(float);
  const size_t dq_smem = (2 * kBQ + 2 * kBK) * kRP + kBQ * kTP +
                         (2 * kBQ * (kBK + 1) + 2 * kBQ) * sizeof(float);
  cudaError_t err;
  if ((err = ls_allow_smem(stats_kernel<DP>, stats_smem)) != cudaSuccess) return err;
  if ((err = ls_allow_smem(dkdv_kernel<DP>, dkdv_smem)) != cudaSuccess) return err;
  if ((err = ls_allow_smem(dq_kernel<DP>, dq_smem)) != cudaSuccess) return err;
  const int bh = batch * a.heads;
  stats_kernel<DP><<<dim3(a.seq / kBQ, bh), kThreads, stats_smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv_kernel<DP><<<dim3(a.seq / kBKV, bh), kThreads, dkdv_smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel<DP><<<dim3(a.seq / kBQ, bh), kThreads, dq_smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout: (batch, seq, heads, d) bf16 at row pitches ldq, ldk, ldv, ldo
// (a head d columns on); dq, dk, dv contiguous (batch, seq, heads, d) bf16;
// lse, delta: batch * heads * seq f32 scratch, written by the first launch.
extern "C" int ls_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* dout, int ldq, int ldk, int ldv, int ldo,
                                      void* dq, void* dk, void* dv, void* lse, void* delta,
                                      int batch, int seq, int heads, int d, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout), ldq, ldk, ldv,
                  ldo, static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                  static_cast<float*>(lse), static_cast<float*>(delta), seq, heads, d, scale};
  switch (d) {
    case 40: return (int)launch<48>(a, batch, s);
    case 80: return (int)launch<80>(a, batch, s);
    case 512: return (int)launch<512>(a, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
