// K5: the audio cross-attention block
//   out = x + Wo . Attn(Q(LN(x)), K(ctx), V(ctx)) + bo
// Replaces the TPU kernel latentsync_tpu/ops/attn_block.py _cross_kernel
// (pallas_call at attn_block.py:370). On the TPU one program kept LN(x),
// q/k/v and the attention output in VMEM; here it is a chain of five
// launches on one stream, reusing the GEMM template of gemm.cuh:
//   1. LayerNorm row statistics of x;
//   2. q = bf16(LN(x)) Wq^T, the LN applied while x is staged (prologue);
//   3. [k | v] = ctx [Wk; Wv]^T, one product on the raw context;
//   4. the attention core below;
//   5. out = x + o Wo^T + bo, bias and residual added to the f32
//      accumulator before the one rounding to bf16.
// Rounding points follow _cross_kernel: LN(x), q, k, v, the probabilities
// and the attention output are bf16; logits, softmax and sums are f32.
//
// The core: the context is short (Sk = 50 audio tokens) and d = 40 or 80
// is not a multiple of the 16-wide MMA k-step, so it runs on the FMA
// pipes like the spatial core: one block owns 64 query rows of one
// (batch, head), holds that head's K and V (Sk x d, 8-16 KB) in shared
// memory, and four threads share a query row (d/4 columns each, partial
// dot products combined by two shuffles). Three sweeps over the keys:
// the row max, the f32 normaliser, then the value sum of the bf16-rounded
// normalised probabilities, exactly the plain version's rounding.
// Bound: the three GEMMs (K = 320 or 640) are tensor-core bound (see
// gemm.cuh). The core does little arithmetic but recomputes every logit
// in each sweep and pays two shuffles per key, so it is bound by
// instruction throughput and takes a large share of the block's time (PERF.md);
// keeping a row's Sk logits on chip between sweeps is its first speed item.
#include "gemm.cuh"

namespace {

constexpr int XQ = 64;          // query rows per block
constexpr int X_THREADS = 256;  // 4 threads per query row

template <int D>
__global__ void __launch_bounds__(X_THREADS)
    cross_core_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv, bf16* __restrict__ o,
                      int seq, int sk, int inner, float scale) {
  constexpr int DQ = D / 4;  // columns per thread (even)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + (size_t)sk * D;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * XQ;
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int part = tid & 3;
  const long ldkv = 2L * inner;

  constexpr int VPR = D / 8;
  for (int i = tid; i < sk * VPR; i += X_THREADS) {
    const int j = i / VPR;
    const int c = (i % VPR) * 8;
    const bf16* src = kv + ((long)b * sk + j) * ldkv + (long)h * D + c;
    *reinterpret_cast<uint4*>(ks + (size_t)j * D + c) = *reinterpret_cast<const uint4*>(src);
    *reinterpret_cast<uint4*>(vs + (size_t)j * D + c) =
        *reinterpret_cast<const uint4*>(src + inner);
  }

  const int qrow = min(q0 + row, seq - 1);
  float qv[DQ];
  {
    const bf162* qp = reinterpret_cast<const bf162*>(q + ((long)b * seq + qrow) * inner +
                                                     (long)h * D + part * DQ);
#pragma unroll
    for (int c = 0; c < DQ / 2; ++c) {
      const float2 f = __bfloat1622float2(qp[c]);
      qv[2 * c] = f.x;
      qv[2 * c + 1] = f.y;
    }
  }
  __syncthreads();

  auto logit = [&](int j) {
    const bf162* kp = reinterpret_cast<const bf162*>(ks + (size_t)j * D + part * DQ);
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < DQ / 2; ++c) {
      const float2 kf = __bfloat1622float2(kp[c]);
      dot = fmaf(qv[2 * c], kf.x, fmaf(qv[2 * c + 1], kf.y, dot));
    }
    dot += __shfl_xor_sync(LS_FULL_MASK, dot, 1);
    dot += __shfl_xor_sync(LS_FULL_MASK, dot, 2);
    return dot * scale;
  };

  float m = -INFINITY;
  for (int j = 0; j < sk; ++j) m = fmaxf(m, logit(j));
  float l = 0.f;
  for (int j = 0; j < sk; ++j) l += expf(logit(j) - m);
  float acc[DQ];
#pragma unroll
  for (int c = 0; c < DQ; ++c) acc[c] = 0.f;
  for (int j = 0; j < sk; ++j) {
    const float p = __bfloat162float(__float2bfloat16(expf(logit(j) - m) / l));
    const bf162* vp = reinterpret_cast<const bf162*>(vs + (size_t)j * D + part * DQ);
#pragma unroll
    for (int c = 0; c < DQ / 2; ++c) {
      const float2 vf = __bfloat1622float2(vp[c]);
      acc[2 * c] = fmaf(p, vf.x, acc[2 * c]);
      acc[2 * c + 1] = fmaf(p, vf.y, acc[2 * c + 1]);
    }
  }

  if (q0 + row < seq) {
    bf162* op = reinterpret_cast<bf162*>(o + ((long)b * seq + q0 + row) * inner + (long)h * D +
                                         part * DQ);
#pragma unroll
    for (int c = 0; c < DQ / 2; ++c) op[c] = __floats2bfloat162_rn(acc[2 * c], acc[2 * c + 1]);
  }
}

template <int D>
cudaError_t cross_core_d(const bf16* q, const bf16* kv, bf16* o, int batch, int seq, int sk,
                         int heads, float scale, cudaStream_t s) {
  const size_t smem = (size_t)2 * sk * D * sizeof(bf16);
  cudaError_t e = ls_allow_smem(cross_core_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((seq + XQ - 1) / XQ, heads, batch);
  cross_core_kernel<D><<<grid, X_THREADS, smem, s>>>(q, kv, o, seq, sk, heads * D, scale);
  return cudaGetLastError();
}

cudaError_t cross_core(const bf16* q, const bf16* kv, bf16* o, int batch, int seq, int sk,
                       int heads, int d, float scale, cudaStream_t s) {
  switch (d) {
    case 40: return cross_core_d<40>(q, kv, o, batch, seq, sk, heads, scale, s);
    case 80: return cross_core_d<80>(q, kv, o, batch, seq, sk, heads, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ls_cross_attn_block(const void* x, const void* ctx, int batch, int seq, int c,
                                   int sk, int cc, int inner, int heads, const float* ln_w,
                                   const float* ln_b, float eps, const void* w_q,
                                   const void* w_kv, const void* w_o, const float* b_o,
                                   float scale, void* stats, void* q, void* kv, void* attn,
                                   void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = batch * seq;
  const bf16* xb = static_cast<const bf16*>(x);
  float2* st = static_cast<float2*>(stats);
  bf16* qb = static_cast<bf16*>(q);
  bf16* kvb = static_cast<bf16*>(kv);
  bf16* ob = static_cast<bf16*>(attn);
  cudaError_t e = ls_gemm::row_stats(xb, m, c, c, eps, st, s);
  if (e != cudaSuccess) return (int)e;

  ls_gemm::Args pq = {};
  pq.a = xb;
  pq.lda = c;
  pq.b = static_cast<const bf16*>(w_q);
  pq.ldb = c;
  pq.c = qb;
  pq.ldc = inner;
  pq.m = m;
  pq.n = inner;
  pq.k = c;
  pq.stats = st;
  pq.ln_w = ln_w;
  pq.ln_b = ln_b;
  e = ls_gemm::gemm(pq, s);
  if (e != cudaSuccess) return (int)e;

  ls_gemm::Args pkv = {};
  pkv.a = static_cast<const bf16*>(ctx);
  pkv.lda = cc;
  pkv.b = static_cast<const bf16*>(w_kv);
  pkv.ldb = cc;
  pkv.c = kvb;
  pkv.ldc = 2 * inner;
  pkv.m = batch * sk;
  pkv.n = 2 * inner;
  pkv.k = cc;
  e = ls_gemm::gemm(pkv, s);
  if (e != cudaSuccess) return (int)e;

  e = cross_core(qb, kvb, ob, batch, seq, sk, heads, inner / heads, scale, s);
  if (e != cudaSuccess) return (int)e;

  ls_gemm::Args po = {};
  po.a = ob;
  po.lda = inner;
  po.b = static_cast<const bf16*>(w_o);
  po.ldb = inner;
  po.c = static_cast<bf16*>(out);
  po.ldc = c;
  po.m = m;
  po.n = c;
  po.k = inner;
  po.bias = b_o;
  po.res = xb;
  po.ldr = c;
  return (int)ls_gemm::gemm(po, s);
}
