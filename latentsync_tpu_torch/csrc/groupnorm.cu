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
// spatial % 8 == 0 on every UNet shape; both kernels take other shapes with
// element loads).
// C/G is 10 at C = 320, so nothing is vectorised across channels.
//
// Statistics: every thread keeps (count, mean, M2) and merges them with
// Chan's formula, across the block and across blocks: the sums of
// 164 K elements stay accurate without Sigma x^2 - mean^2 cancellation.
//
//   K6 (ls_group_norm_silu): one block per slab, a statistics sweep and a
//      normalise sweep (the second mostly from L2).
//   K7 (ls_group_norm_silu_streaming): one thread-block cluster per slab,
//      one launch. Each block of the cluster (up to 8, the portable size;
//      the wrapper sizes the cluster by the slab) reads its contiguous part
//      of the slab once: the first 32 KB into registers, the rest into its
//      shared memory by the bulk-copy engine (cp.async.bulk, completion on an
//      mbarrier), so that two blocks fit an SM even at the largest part, and
//      takes its moments from there (sums about the part's first element:
//      no division an element). The blocks then read one another's moments through
//      distributed shared memory after a cluster barrier, each merging them
//      in rank order (so every block gets the same statistics), and each
//      normalises its part from shared memory. A second cluster barrier
//      keeps every block alive until the others have read its moments.
//      The largest served slab, (4, 960, 16, 32, 32) at 32 groups, is
//      983 KB: 123 KB a block at 8 blocks. SiLU is h + h tanh(h), h = y / 2:
//      one special-function instruction an element where y / (1 + e^-y)
//      takes two and a division. The TPU kernel had no shared
//      memory across cores and crossed device memory twice (statistics
//      pass, then normalise pass), as the port's first version did in two
//      launches; here device memory sees each element read once and
//      written once. Where spatial % 8 != 0 (no UNet shape) the slabs are
//      not 16-byte aligned: the whole part goes to shared memory by element
//      loads, one element a thread at a time.
//
// Bound: memory. K6: one read for the statistics, one read (mostly from
// L2) and one write to normalise. K7: one read and one write, 4 bytes an
// element at bf16, against the f32 round trips of a composed GroupNorm.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cgr = cooperative_groups;

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
template <int WARPS = GN_WARPS>
__device__ Moments block_merge(Moments a) {
  __shared__ Moments part[WARPS];
  __shared__ Moments total;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  a = warp_merge(a);
  if (lane == 0) part[warp] = a;
  __syncthreads();
  if (warp == 0) {
    Moments w = lane < WARPS ? part[lane] : Moments{0.f, 0.f, 0.f};
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

// bytes one bulk copy moves (a block's part goes in pieces of at most this)
constexpr int GN_PIECE = 32768;
// the portable cluster size
constexpr int GN_CLUSTER_MAX = 8;
// dynamic shared memory a block may have: Hopper's 227 KB less 1 KB for the
// kernel's static variables
constexpr int GN_SMEM_MAX = 232448 - 1024;

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

constexpr int GC_THREADS = 512;  // K7's block: 16 warps
constexpr int GC_RV = 4;         // 16-byte vectors of the part each thread holds in registers
constexpr int GC_HEAD = GC_RV * GC_THREADS * 8;  // elements of the part in registers

// tanh on the special-function unit (one instruction)
__device__ __forceinline__ float tanh_fast(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// y = x * a + c [SiLU] of V elements, stored as one 16-byte vector (V = 8)
// or elementwise
template <int V>
__device__ __forceinline__ void gn_apply(const float (&v)[V], float2 ab, int silu, bf16* dst) {
  __align__(16) bf16 out[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float t = fmaf(v[j], ab.x, ab.y);
    if (silu) {  // t * sigmoid(t) = h + h tanh(h), h = t / 2
      const float h = 0.5f * t;
      t = fmaf(h, tanh_fast(h), h);
    }
    out[j] = __float2bfloat16(t);
  }
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(out);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) dst[j] = out[j];
  }
}

// One cluster of gridDim.x blocks a slab (blockIdx.y); block r holds
// elements [r * chunk, min((r + 1) * chunk, len)) of it, its part. V = 8
// (spatial % 8 == 0; chunk % 8 == 0 always, so every 16-byte vector lies in
// one channel): the first GC_HEAD elements in registers (thread t holds
// vectors t, t + 512, ..., loaded by plain 16-byte loads), the rest in
// shared memory (one bulk copy engine transfer). So the largest part, 123
// KB, leaves 91 KB of shared memory a block and two blocks fit an SM. V = 1:
// the whole part in shared memory, thread t loading elements t, t + 512,
// ... (and later normalising the same ones). Dynamic shared memory: the
// part's elements past the registers, then (scale, shift) of each channel
// of the group.
template <int V>
__global__ void __launch_bounds__(GC_THREADS)
    gn_cluster_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, const float* w,
                      const float* b, int groups, int cg, int spatial, float eps, int silu,
                      int chunk) {
  constexpr int HEAD = V == 8 ? GC_HEAD : 0;  // elements of the part in registers
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ Moments mine;
  __shared__ float stat[2];
  cgr::cluster_group cluster = cgr::this_cluster();
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int blocks = (int)cluster.num_blocks();
  const long slab = blockIdx.y;
  const int len = cg * spatial;
  const int begin = rank * chunk;
  const int n = begin < len ? min(chunk, len - begin) : 0;
  const int nh = min(n, HEAD);  // elements in registers; [nh, n) in shared memory
  const bf16* xs = x + slab * len + begin;
  bf16* tail = reinterpret_cast<bf16*>(smem_raw);  // element i >= nh: tail[i - nh]
  const int tail_bytes = chunk > HEAD ? (chunk - HEAD) * 2 : 0;
  float2* coef = reinterpret_cast<float2*>(smem_raw + tail_bytes);
  const unsigned bar_s = (unsigned)__cvta_generic_to_shared(&bar);

  uint4 head[GC_RV];
  if constexpr (V == 8) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_s) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_s),
                   "r"((n - nh) * 2)
                   : "memory");
      const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_raw);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(xs + nh);
      for (int off = 0; off < (n - nh) * 2; off += GN_PIECE) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(dst + off),
            "l"(src + off), "r"(min(GN_PIECE, (n - nh) * 2 - off)), "r"(bar_s)
            : "memory");
      }
    }
#pragma unroll
    for (int k = 0; k < GC_RV; ++k) {
      const int i = (k * GC_THREADS + tid) * 8;
      head[k] = i < nh ? *reinterpret_cast<const uint4*>(xs + i) : make_uint4(0, 0, 0, 0);
    }
  }

  // this thread's moments from sums about the part's first element (no
  // division an element), then Chan's merge across the block
  Moments mo = {0.f, 0.f, 0.f};
  {
    const float shift = n > 0 ? __bfloat162float(xs[0]) : 0.f;
    float s1 = 0.f, s2 = 0.f;
    int cnt = 0;
    auto add = [&](const float (&v)[V]) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = v[j] - shift;
        s1 += d;
        s2 = fmaf(d, d, s2);
      }
      cnt += V;
    };
    if constexpr (V == 8) {
#pragma unroll
      for (int k = 0; k < GC_RV; ++k) {
        if ((k * GC_THREADS + tid) * 8 < nh) {
          float v[8];
          load<8>(reinterpret_cast<const bf16*>(&head[k]), v);
          add(v);
        }
      }
      while (!mbar_try_wait(bar_s, 0)) {
      }
      for (int i = nh + tid * 8; i < n; i += GC_THREADS * 8) {
        float v[8];
        load<8>(tail + (i - nh), v);
        add(v);
      }
    } else {
      for (int i = tid; i < n; i += GC_THREADS) {
        const bf16 e = xs[i];
        tail[i] = e;
        const float v[1] = {__bfloat162float(e)};
        add(v);
      }
    }
    if (cnt > 0) {
      const float mean = s1 / cnt;
      mo = {(float)cnt, shift + mean, fmaxf(s2 - s1 * mean, 0.f)};
    }
  }
  mo = block_merge<GC_THREADS / 32>(mo);
  if (tid == 0) mine = mo;
  cluster.sync();  // every block's moments are written and visible
  if (tid == 0) {
    Moments acc = {0.f, 0.f, 0.f};
    for (int r = 0; r < blocks; ++r) acc = merge(acc, *cluster.map_shared_rank(&mine, r));
    stat[0] = acc.mean;
    stat[1] = rsqrtf(acc.m2 / acc.n + eps);
  }
  __syncthreads();
  // this block reads no other block's shared memory any more
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  const int c0 = (int)(slab % groups) * cg;
  for (int ch = tid; ch < cg; ch += GC_THREADS) {  // y = x * a + (b - mean * a)
    const float a = w[c0 + ch] * stat[1];
    coef[ch] = make_float2(a, b[c0 + ch] - stat[0] * a);
  }
  __syncthreads();
  bf16* ys = y + slab * len + begin;
  if constexpr (V == 8) {
#pragma unroll
    for (int k = 0; k < GC_RV; ++k) {
      const int i = (k * GC_THREADS + tid) * 8;
      if (i < nh) {
        float v[8];
        load<8>(reinterpret_cast<const bf16*>(&head[k]), v);
        gn_apply<8>(v, coef[(begin + i) / spatial], silu, ys + i);
      }
    }
  }
  // the rest from shared memory; the channel of a thread's vector moves on
  // by a fixed quotient and remainder each step
  {
    constexpr int STEP = GC_THREADS * V;
    const int dq = STEP / spatial, dr = STEP % spatial;
    int ch = (begin + nh + tid * V) / spatial;
    int rem = (begin + nh + tid * V) - ch * spatial;
    for (int i = nh + tid * V; i < n; i += STEP) {
      float v[V];
      load<V>(tail + (i - nh), v);
      gn_apply<V>(v, coef[ch], silu, ys + i);
      ch += dq;
      rem += dr;
      if (rem >= spatial) {
        rem -= spatial;
        ++ch;
      }
    }
  }
  // no block leaves while another may still read its moments
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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
                                            int spatial, float eps, int silu, int cluster,
                                            void* stream) {
  const int cg = c / groups;
  const long long len = (long long)cg * spatial;
  if (cluster < 1 || cluster > GN_CLUSTER_MAX || len <= 0 || len > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bool vec = spatial % 8 == 0;  // 16-byte vectors, the first 32 KB in registers
  const int head = vec ? GC_HEAD : 0;
  const int chunk = (int)((len + cluster - 1) / cluster + 7) / 8 * 8;
  const size_t smem = (size_t)(chunk > head ? chunk - head : 0) * sizeof(bf16) +
                      (size_t)cg * sizeof(float2);
  if (smem > (size_t)GN_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const auto kernel = vec ? gn_cluster_kernel<8> : gn_cluster_kernel<1>;
  static bool allowed[2] = {false, false};  // one attribute for every launch's size
  if (!allowed[vec]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GN_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    allowed[vec] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)n * groups, 1);
  cfg.blockDim = dim3(GC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(x),
                         static_cast<bf16*>(y), w, b, groups, cg, spatial, eps, silu, chunk);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
