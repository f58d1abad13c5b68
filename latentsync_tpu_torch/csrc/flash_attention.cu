// Flash attention over (B, S, H, D = 512): the VAE mid-block's
// single-head self-attention (S = 1024, D = 512).
// Replaces jax's library TPU flash kernel as the reference routes to it:
// latentsync_tpu/ops/attention.py _flash_bshd (:85, routed at :51-59),
// unmasked 4-D self-attention with S >= 256 and S % 128 == 0.
//
//   o = softmax(q k^T * scale) v, f32 logits and online softmax, the
//   probabilities rounded to bf16 before the value product (as the plain
//   version rounds them), f32 accumulation, bf16 out.
//
// Design. Common flash kernels stop at D = 256 because the output
// accumulator lives in registers. Here one block of 8 warps owns 32 query
// rows of one (batch, head), and the 32 x 512 f32 accumulator is spread
// over all 8 warps: warp w owns output columns [w D/8, (w+1) D/8) of all
// 32 rows (64 f32 registers a thread at D = 512). The Q tile (32 x D)
// and one key block of K and V (64 x D each) sit in shared memory
// (178 KB at D = 512). Per key block: every warp computes a 16 x 16 piece
// of the 32 x 64 logits with mma.sync m16n8k16 (bf16 in, f32 out) over
// the whole D; 8 threads per row take the online-softmax step on the f32
// logits in shared memory and write bf16 probabilities; every warp then
// adds P (32 x 64) . V[:, its columns] into its accumulator, rescaled by
// the row's correction factor first.
//
// Bound: at S = 1024, D = 512 the two products are 4 S^2 D FLOP per
// (batch, head) on the tensor cores; K and V are re-read from L2 by each
// of the S / 32 query blocks (2 MB per block per batch at D = 512), and
// the loads are synchronous (no cp.async / TMA pipeline yet), so this
// first version is bound by those L2 reads and their latency.
#include "common.cuh"

namespace {

constexpr int FQ = 32;   // query rows per block
constexpr int FK = 64;   // keys per step
constexpr int F_THREADS = 256;
constexpr int F_WARPS = F_THREADS / 32;

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

__device__ __forceinline__ uint32_t pack2(const unsigned short* s, int i0, int i1) {
  return (uint32_t)s[i0] | ((uint32_t)s[i1] << 16);
}

__device__ __forceinline__ void copy_rows(bf16* dst, int ld, const bf16* src, long row_stride,
                                          int rows, int d) {
  const int vpr = d / 8;
  for (int i = threadIdx.x; i < rows * vpr; i += F_THREADS) {
    const int r = i / vpr;
    const int c = (i % vpr) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        *reinterpret_cast<const uint4*>(src + r * row_stride + c);
  }
}

template <int D>
__global__ void __launch_bounds__(F_THREADS, 1)
    flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, long qb, long qs, long qh, long kb, long ks,
                 long kh, long vb, long vs, long vh, bf16* __restrict__ o, int seq, int heads,
                 float scale) {
  constexpr int LD = D + 8;    // bf16 pitch of the Q/K/V tiles
  constexpr int LDS = FK + 4;  // f32 pitch of the logits
  constexpr int LDP = FK + 8;  // bf16 pitch of the probabilities
  constexpr int WC = D / F_WARPS;  // output columns per warp
  constexpr int NT = WC / 8;       // n-tiles of 8 per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qt = reinterpret_cast<bf16*>(smem_raw);
  bf16* kt = qt + FQ * LD;
  bf16* vt = kt + FK * LD;
  float* st = reinterpret_cast<float*>(vt + FK * LD);
  bf16* pt = reinterpret_cast<bf16*>(st + FQ * LDS);
  float* row_m = reinterpret_cast<float*>(pt + FQ * LDP);
  float* row_l = row_m + FQ;
  float* row_a = row_l + FQ;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * FQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  copy_rows(qt, LD, q + b * qb + (long)q0 * qs + h * qh, qs, FQ, D);
  if (tid < FQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  // logits: warp w computes rows [16 (w & 1), +16) x keys [16 (w >> 1), +16)
  const int s_r0 = (warp & 1) * 16;
  const int s_c0 = (warp >> 1) * 16;
  const unsigned short* vt16 = reinterpret_cast<const unsigned short*>(vt);

  for (int k0 = 0; k0 < seq; k0 += FK) {
    __syncthreads();  // the previous step is done with K, V and P
    copy_rows(kt, LD, k + b * kb + (long)k0 * ks + h * kh, ks, FK, D);
    copy_rows(vt, LD, v + b * vb + (long)k0 * vs + h * vh, vs, FK, D);
    __syncthreads();

    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      load_a(a, qt, LD, s_r0, kk, g, t);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bf16* kr = kt + (s_c0 + j * 8 + g) * LD + kk + 2 * t;
        mma16816(sc[j], a, ld32(kr), ld32(kr + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = s_c0 + j * 8 + 2 * t;
      st[(s_r0 + g) * LDS + c] = sc[j][0] * scale;
      st[(s_r0 + g) * LDS + c + 1] = sc[j][1] * scale;
      st[(s_r0 + g + 8) * LDS + c] = sc[j][2] * scale;
      st[(s_r0 + g + 8) * LDS + c + 1] = sc[j][3] * scale;
    }
    __syncthreads();

    {  // online softmax step: 8 threads per row, 8 keys each
      const int r = tid >> 3;
      const int c0 = (tid & 7) * 8;
      float sv[8];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sv[i] = st[r * LDS + c0 + i];
        mx = fmaxf(mx, sv[i]);
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(LS_FULL_MASK, mx, o));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        const float p0 = __expf(sv[i] - m_new);
        const float p1 = __expf(sv[i + 1] - m_new);
        sum += p0 + p1;
        *reinterpret_cast<bf162*>(pt + r * LDP + c0 + i) = __floats2bfloat162_rn(p0, p1);
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(LS_FULL_MASK, sum, o);
      __syncwarp();  // every thread of the row has read row_m
      if ((tid & 7) == 0) {
        const float alpha = __expf(m_old - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float a0 = row_a[mt * 16 + g];
      const float a1 = row_a[mt * 16 + g + 8];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[mt][n][0] *= a0;
        acc[mt][n][1] *= a0;
        acc[mt][n][2] *= a1;
        acc[mt][n][3] *= a1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < FK; kk += 16) {
      uint32_t a[2][4];
      load_a(a[0], pt, LDP, 0, kk, g, t);
      load_a(a[1], pt, LDP, 16, kk, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = warp * WC + n * 8 + g;
        const int r0 = kk + 2 * t;
        const uint32_t b0 = pack2(vt16, r0 * LD + col, (r0 + 1) * LD + col);
        const uint32_t b1 = pack2(vt16, (r0 + 8) * LD + col, (r0 + 9) * LD + col);
        mma16816(acc[0][n], a[0], b0, b1);
        mma16816(acc[1][n], a[1], b0, b1);
      }
    }
  }
  __syncthreads();

  const long o_row = (long)heads * D;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + half * 8;
      const float inv = 1.f / row_l[r];
      bf16* orow = o + ((long)b * seq + q0 + r) * o_row + (long)h * D;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = warp * WC + n * 8 + 2 * t;
        *reinterpret_cast<bf162*>(orow + c) = __floats2bfloat162_rn(
            acc[mt][n][2 * half] * inv, acc[mt][n][2 * half + 1] * inv);
      }
    }
  }
}

template <int D>
cudaError_t flash_d(const bf16* q, const bf16* k, const bf16* v, long qb, long qs, long qh,
                    long kb, long ks, long kh, long vb, long vs, long vh, bf16* o, int batch,
                    int seq, int heads, float scale, cudaStream_t s) {
  constexpr int LD = D + 8;
  const size_t smem = (size_t)(FQ + 2 * FK) * LD * sizeof(bf16) +
                      (size_t)FQ * (FK + 4) * sizeof(float) +
                      (size_t)FQ * (FK + 8) * sizeof(bf16) + 3 * FQ * sizeof(float);
  cudaError_t e = ls_allow_smem(flash_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(seq / FQ, heads, batch);
  flash_kernel<D><<<grid, F_THREADS, smem, s>>>(q, k, v, qb, qs, qh, kb, ks, kh, vb, vs, vh, o,
                                                seq, heads, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ls_flash_attention(const void* q, const void* k, const void* v, long long qb,
                                  long long qs, long long qh, long long kb, long long ks,
                                  long long kh, long long vb, long long vs, long long vh, void* o,
                                  int batch, int seq, int heads, int d, float scale,
                                  void* stream) {
  if (seq % FK != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  if (d != 512) return (int)cudaErrorInvalidValue;  // the VAE's head width
  return (int)flash_d<512>(qp, kp, vp, qb, qs, qh, kb, ks, kh, vb, vs, vh, op, batch, seq, heads,
                           scale, s);
}
