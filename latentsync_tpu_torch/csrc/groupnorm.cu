// K6 and K7: GroupNorm (+ SiLU), bf16 in and out, f32 statistics,
// scale/bias and SiLU.
// Replace the TPU kernels latentsync_tpu/ops/groupnorm.py _gn_silu_kernel
// (pallas_call at groupnorm.py:92, one sample per grid step) and
// _gn_silu_streaming_kernel (pallas_call at groupnorm.py:185, a two-phase
// grid accumulating the sums in VMEM scratch).
//
// The TPU worked on channels-last (rows, C) tiles and needed one-hot MXU
// matmuls to gather per-group sums across lanes. In the port's
// channels-first layout (N, C, *spatial) each (sample, group) statistic
// covers one contiguous slab of (C/G) * spatial elements, for the 5-D
// cross-frame tensor and the frame-folded per-frame tensor alike, so a
// slab is read with plain 16-byte loads (8 elements of one channel:
// spatial % 8 == 0 on every UNet shape; other shapes take element loads).
// C/G is 10 at C = 320, so nothing is vectorised across channels.
//
// Statistics: every thread keeps (count, mean, M2) and merges them with
// Chan's formula, across the block and across blocks: the sums of
// 164 K elements stay accurate without Sigma x^2 - mean^2 cancellation.
//
//   K6 (ls_group_norm_silu): one block per slab, a statistics sweep and a
//      normalise sweep (the second mostly from L2).
//   K7 (ls_group_norm_silu_streaming): several blocks per slab. Launch 1
//      writes each chunk's (count, mean, M2) partial; launch 2 merges the
//      slab's partials in every block and normalises that block's chunk.
//
// Bound: memory. One read for the statistics, one read and one write to
// normalise: 6 bytes an element at bf16, against the f32 round trips of
// a composed GroupNorm.
#include "common.cuh"

namespace {

constexpr int GN_THREADS = 256;
constexpr int GN_WARPS = GN_THREADS / 32;

struct Moments {
  float n, mean, m2;
};

__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float delta = b.mean - a.mean;
  const float f = b.n / n;
  return {n, a.mean + delta * f, a.m2 + b.m2 + delta * delta * a.n * f};
}

__device__ __forceinline__ Moments shfl_xor(Moments a, int o) {
  return {__shfl_xor_sync(LS_FULL_MASK, a.n, o), __shfl_xor_sync(LS_FULL_MASK, a.mean, o),
          __shfl_xor_sync(LS_FULL_MASK, a.m2, o)};
}

__device__ __forceinline__ Moments warp_merge(Moments a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = merge(a, shfl_xor(a, o));
  return a;
}

// Merge every thread's moments; the result is returned to all threads.
__device__ Moments block_merge(Moments a) {
  __shared__ Moments part[GN_WARPS];
  __shared__ Moments total;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  a = warp_merge(a);
  if (lane == 0) part[warp] = a;
  __syncthreads();
  if (warp == 0) {
    Moments w = lane < GN_WARPS ? part[lane] : Moments{0.f, 0.f, 0.f};
    w = warp_merge(w);
    if (lane == 0) total = w;
  }
  __syncthreads();
  return total;
}

template <int V>
__device__ __forceinline__ void load(const bf16* p, float v[V]) {
  if constexpr (V == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}

// Moments of elements [begin, end) of one slab, V at a time per thread.
template <int V>
__device__ Moments slab_moments(const bf16* xs, long begin, long end) {
  Moments acc = {0.f, 0.f, 0.f};
  for (long i = begin + (long)threadIdx.x * V; i < end; i += (long)GN_THREADS * V) {
    float v[V];
    load<V>(xs + i, v);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) s += v[j];
    const float mean = s / V;
    float m2 = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) m2 += (v[j] - mean) * (v[j] - mean);
    acc = merge(acc, Moments{(float)V, mean, m2});
  }
  return acc;
}

template <int V>
__device__ void normalise(const bf16* xs, bf16* ys, long begin, long end, int c0, int spatial,
                          const float* __restrict__ w, const float* __restrict__ b, float mean,
                          float rstd, int silu) {
  for (long i = begin + (long)threadIdx.x * V; i < end; i += (long)GN_THREADS * V) {
    float v[V];
    load<V>(xs + i, v);
    const int ch = c0 + (int)(i / spatial);  // V divides spatial: one channel per load
    const float wc = w[ch];
    const float bc = b[ch];
    __align__(16) bf16 out[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float y = (v[j] - mean) * rstd * wc + bc;
      if (silu) y = y / (1.f + __expf(-y));
      out[j] = __float2bfloat16(y);
    }
    if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(ys + i) = *reinterpret_cast<const uint4*>(out);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) ys[i + j] = out[j];
    }
  }
}

template <int V>
__global__ void __launch_bounds__(GN_THREADS)
    gn_single_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, const float* w,
                     const float* b, int groups, int cg, int spatial, float eps, int silu) {
  const long slab = blockIdx.x;
  const long len = (long)cg * spatial;
  const bf16* xs = x + slab * len;
  const Moments mo = block_merge(slab_moments<V>(xs, 0, len));
  const float rstd = rsqrtf(mo.m2 / mo.n + eps);
  normalise<V>(xs, y + slab * len, 0, len, (int)(slab % groups) * cg, spatial, w, b, mo.mean,
               rstd, silu);
}

template <int V>
__global__ void __launch_bounds__(GN_THREADS)
    gn_partial_kernel(const bf16* __restrict__ x, int cg, int spatial, long chunk,
                      float* __restrict__ partials) {
  const long slab = blockIdx.y;
  const long len = (long)cg * spatial;
  const long begin = blockIdx.x * chunk;
  const long end = begin + chunk < len ? begin + chunk : len;
  const Moments mo = block_merge(slab_moments<V>(x + slab * len, begin, end));
  if (threadIdx.x == 0) {
    float* p = partials + (slab * gridDim.x + blockIdx.x) * 3;
    p[0] = mo.n;
    p[1] = mo.mean;
    p[2] = mo.m2;
  }
}

template <int V>
__global__ void __launch_bounds__(GN_THREADS)
    gn_apply_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, const float* w,
                    const float* b, int groups, int cg, int spatial, float eps, int silu,
                    long chunk, const float* __restrict__ partials) {
  __shared__ float stat[2];
  const long slab = blockIdx.y;
  const long len = (long)cg * spatial;
  const int chunks = gridDim.x;
  if (threadIdx.x < 32) {
    Moments acc = {0.f, 0.f, 0.f};
    for (int i = threadIdx.x; i < chunks; i += 32) {
      const float* p = partials + (slab * chunks + i) * 3;
      acc = merge(acc, Moments{p[0], p[1], p[2]});
    }
    acc = warp_merge(acc);
    if (threadIdx.x == 0) {
      stat[0] = acc.mean;
      stat[1] = rsqrtf(acc.m2 / acc.n + eps);
    }
  }
  __syncthreads();
  const long begin = blockIdx.x * chunk;
  const long end = begin + chunk < len ? begin + chunk : len;
  normalise<V>(x + slab * len, y + slab * len, begin, end, (int)(slab % groups) * cg, spatial,
               w, b, stat[0], stat[1], silu);
}

}  // namespace

extern "C" int ls_group_norm_silu(const void* x, void* y, const float* w, const float* b, int n,
                                  int c, int groups, int spatial, float eps, int silu,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
  const int cg = c / groups;
  const unsigned slabs = (unsigned)n * groups;
  if (spatial % 8 == 0)
    gn_single_kernel<8><<<slabs, GN_THREADS, 0, s>>>(xb, yb, w, b, groups, cg, spatial, eps, silu);
  else
    gn_single_kernel<1><<<slabs, GN_THREADS, 0, s>>>(xb, yb, w, b, groups, cg, spatial, eps, silu);
  return (int)cudaGetLastError();
}

extern "C" int ls_group_norm_silu_streaming(const void* x, void* y, const float* w,
                                            const float* b, int n, int c, int groups,
                                            int spatial, float eps, int silu, long long chunk,
                                            void* partials, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
  float* pp = static_cast<float*>(partials);
  const int cg = c / groups;
  if (chunk <= 0 || chunk % 8) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(((long long)cg * spatial + chunk - 1) / chunk), (unsigned)n * groups);
  if (spatial % 8 == 0) {
    gn_partial_kernel<8><<<grid, GN_THREADS, 0, s>>>(xb, cg, spatial, chunk, pp);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    gn_apply_kernel<8><<<grid, GN_THREADS, 0, s>>>(xb, yb, w, b, groups, cg, spatial, eps, silu,
                                                   chunk, pp);
  } else {
    gn_partial_kernel<1><<<grid, GN_THREADS, 0, s>>>(xb, cg, spatial, chunk, pp);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    gn_apply_kernel<1><<<grid, GN_THREADS, 0, s>>>(xb, yb, w, b, groups, cg, spatial, eps, silu,
                                                   chunk, pp);
  }
  return (int)cudaGetLastError();
}
