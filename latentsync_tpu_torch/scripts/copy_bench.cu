// How fast one block an SM pulls tiles from L2 into shared memory, by the way
// it copies them. Built and run by scripts/attn_pieces.py --copies.
//
// The work is what the attention core's D = 512 tiling does for (64, 1024, 512)
// K and V: 1024 blocks, 16 of them walking the same 2 MB (a batch entry's K and
// V) in 64 KB tiles, so all but the first read of a tile comes from L2. Each
// line names the copy (cp.async 16 bytes a thread, or bulk copies by one
// thread), the threads, the tiles in flight ahead of the one waited for, and
// the destination layout: "linear" (a line of device memory to a line of
// shared memory, as the 128-byte swizzle also keeps it) or "core matrices"
// (row r, 16-byte chunk c of a 1 KB row at (r / 8) * 8192 + c * 128 +
// (r % 8) * 16: wgmma's unswizzled layout, which scatters a 128-byte line
// over eight lines), read as 8 rows x 64 bytes or as 4 rows x 128 bytes a
// warp instruction.
#include <cstdio>

#include "wgmma.cuh"

using namespace ls_wg;

constexpr int BLOCKS = 64 * 16;
constexpr size_t ENTRY_BYTES = 2u << 20;  // K and V of one batch entry

template <int THREADS, int AHEAD, int TILE>
__global__ void __launch_bounds__(THREADS, 1)
    linear_kernel(const char* __restrict__ src, float* sink) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const unsigned base = (unsigned)__cvta_generic_to_shared(smem_raw);
  const int tiles = (int)(ENTRY_BYTES / TILE);
  const char* b = src + (size_t)(blockIdx.x / 16) * ENTRY_BYTES;
  auto load = [&](int t, int stage) {
    if (t < tiles)
      for (int i = threadIdx.x; i < TILE / 16; i += THREADS)
        cp_async16s(base + stage * TILE + i * 16, b + (size_t)t * TILE + i * 16);
    cp_async_commit();
  };
  for (int s = 0; s < AHEAD; ++s) load(s, s);
  int stage = 0;
  float acc = 0.f;
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<AHEAD - 1>();
    __syncthreads();
    acc += *reinterpret_cast<float*>(smem_raw + stage * TILE + threadIdx.x * 4);
    load(i + AHEAD, (stage + AHEAD) % (AHEAD + 1));
    stage = (stage + 1) % (AHEAD + 1);
  }
  cp_async_wait<0>();
  if (acc == 123.456f) sink[0] = acc;  // keeps the reads
}

// K and V tiles of 32 rows x 1 KB, one tile ahead, into core matrices
template <bool FULL_LINES>
__global__ void __launch_bounds__(256, 1)
    core_matrix_kernel(const char* __restrict__ src, float* sink) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const unsigned base = (unsigned)__cvta_generic_to_shared(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = 32;
  const bf16* kb = reinterpret_cast<const bf16*>(src) + (size_t)(blockIdx.x / 16) * 1024 * 512;
  const bf16* vb = kb + (size_t)64 * 1024 * 512;
  const int row = FULL_LINES ? (lane >> 3) + 4 * (warp & 1) : (lane & 7);
  const int chunk = FULL_LINES ? (warp >> 1) * 8 + (lane & 7) : warp * 4 + (lane >> 3);
  auto copy_rows = [&](unsigned dst, const bf16* s) {
    const bf16* s0 = s + (size_t)row * 512 + chunk * 8;
#pragma unroll
    for (int rg = 0; rg < 4; ++rg)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        cp_async16s(dst + chunk * 128 + row * 16 + rg * 8192 + p * 32 * 128,
                    s0 + (size_t)rg * 8 * 512 + p * 256);
  };
  auto load = [&](int t, int stage) {
    if (t < tiles) {
      copy_rows(base + stage * 65536, kb + (size_t)t * 32 * 512);
      copy_rows(base + stage * 65536 + 32768, vb + (size_t)t * 32 * 512);
    }
    cp_async_commit();
  };
  load(0, 0);
  int stage = 0;
  float acc = 0.f;
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    acc += *reinterpret_cast<float*>(smem_raw + stage * 65536 + threadIdx.x * 4);
    load(i + 1, stage ^ 1);
    stage ^= 1;
  }
  if (acc == 123.456f) sink[0] = acc;
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned phase) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar), "r"(phase)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the same walk, one thread issuing bulk copies of CHUNK bytes (no tensor map)
template <int AHEAD, int TILE, int CHUNK>
__global__ void __launch_bounds__(256, 1) bulk_kernel(const char* __restrict__ src, float* sink) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long bars[AHEAD + 1];
  const unsigned base = (unsigned)__cvta_generic_to_shared(smem_raw);
  const unsigned bar0 = (unsigned)__cvta_generic_to_shared(bars);
  const int tiles = (int)(ENTRY_BYTES / TILE);
  const char* b = src + (size_t)(blockIdx.x / 16) * ENTRY_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s <= AHEAD; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int t, int stage) {
    if (t < tiles && threadIdx.x == 0) {
      mbar_expect(bar0 + 8 * stage, TILE);
      for (int i = 0; i < TILE / CHUNK; ++i)
        bulk_copy(base + stage * TILE + i * CHUNK, b + (size_t)t * TILE + i * CHUNK, CHUNK,
                  bar0 + 8 * stage);
    }
  };
  for (int s = 0; s < AHEAD; ++s) load(s, s);
  int stage = 0;
  unsigned phase = 0;
  float acc = 0.f;
  for (int i = 0; i < tiles; ++i) {
    mbar_wait(bar0 + 8 * stage, phase);
    acc += *reinterpret_cast<float*>(smem_raw + stage * TILE + threadIdx.x * 4);
    __syncthreads();
    load(i + AHEAD, (stage + AHEAD) % (AHEAD + 1));
    if (++stage == AHEAD + 1) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (acc == 123.456f) sink[0] = acc;
}

template <typename K>
bool run(const char* label, K kernel, int threads, size_t smem, const char* src, float* sink) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int i = 0; i < 3; ++i) kernel<<<BLOCKS, threads, smem>>>(src, sink);
  cudaEventRecord(a);
  for (int i = 0; i < 10; ++i) kernel<<<BLOCKS, threads, smem>>>(src, sink);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0;
  cudaEventElapsedTime(&ms, a, b);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) {
    printf("%s: %s\n", label, cudaGetErrorString(e));
    return false;
  }
  ms /= 10;
  printf("{\"copy\": \"%s\", \"ms\": %.4f, \"tb_per_s\": %.2f}\n", label, ms,
         (double)BLOCKS * ENTRY_BYTES / 1e9 / ms);
  return true;
}

int main() {
  char* src;
  float* sink;
  const size_t bytes = 64 * ENTRY_BYTES;
  if (cudaMalloc(&src, bytes) != cudaSuccess || cudaMalloc(&sink, 4) != cudaSuccess) return 1;
  cudaMemset(src, 1, bytes);
  bool ok = true;
  ok &= run("cp.async, 256 threads, 1 ahead, linear", linear_kernel<256, 1, 65536>, 256,
            2 * 65536, src, sink);
  ok &= run("cp.async, 256 threads, 2 ahead, linear", linear_kernel<256, 2, 65536>, 256,
            3 * 65536, src, sink);
  ok &= run("cp.async, 512 threads, 1 ahead, linear", linear_kernel<512, 1, 65536>, 512,
            2 * 65536, src, sink);
  ok &= run("cp.async, 128 threads, 2 ahead, linear", linear_kernel<128, 2, 65536>, 128,
            3 * 65536, src, sink);
  ok &= run("cp.async, 256 threads, 1 ahead, core matrices, 8 rows x 64 B",
            core_matrix_kernel<false>, 256, 2 * 65536, src, sink);
  ok &= run("cp.async, 256 threads, 1 ahead, core matrices, 4 rows x 128 B",
            core_matrix_kernel<true>, 256, 2 * 65536, src, sink);
  ok &= run("bulk 1 KB, 2 ahead, linear", bulk_kernel<2, 65536, 1024>, 256, 3 * 65536, src, sink);
  ok &= run("bulk 16 KB, 2 ahead, linear", bulk_kernel<2, 65536, 16384>, 256, 3 * 65536, src,
            sink);
  return ok ? 0 : 1;
}
