// K3: the temporal attention core over (B, F = 16, heads * D).
// Replaces the TPU kernel latentsync_tpu/ops/temporal_attention.py _kernel
// (pallas_call at temporal_attention.py:101), which folded (F, heads) into
// one 128-wide MXU product with a block-diagonal mask. On Hopper a 16-frame
// sequence is exactly the m16 tile of mma.sync, so one warp owns one
// (sequence, head) task: no fold and no mask, heads never mix.
//
// Bound: memory. A task reads 3 * 16 * D bf16 and writes 16 * D, and does
// 2 * 16 * 16 * D multiply-adds, about 2 FLOP a byte against the card's ~295
// (42 MB and 0.0125 ms at (256, 16, 1280), 168 MB and 0.050 ms at (4096, 16,
// 320)). So the design keeps copies in flight at all times and makes the
// arithmetic short enough to hide under them:
//
// - Persistent warps. A launch has as many blocks as the card holds at once;
//   warp w of the launch walks tasks w, w + W, ... (W the launch's warps), so
//   neighbouring warps read neighbouring heads of one row at the same time.
// - A cp.async ring per warp. Each warp owns T_STAGES stages of shared memory
//   (q, k and v of one task each) and keeps the copies of its next two tasks
//   in flight while it computes one: 16-byte copies, a warp's 32 lanes on 32
//   consecutive chunks of a tile. A tile row is the head's D bf16 padded to an
//   odd number of 16-byte chunks, so that the eight rows an ldmatrix phase
//   reads, and a warp's cp.async chunks, land in distinct banks. No barrier
//   wider than the warp exists: warps never wait on each other.
// - mma.sync for both products. q k^T: m16n8k16 from ldmatrix (A from q's
//   rows, B from k's rows as they stand; a head dim with D % 16 == 8, e.g.
//   40, ends in one m16n8k8 step). The 16 x 16 logits and the softmax stay in
//   registers (row g of a lane quad's two 8-key tiles). p v: the probability
//   accumulators are p v's A fragment as they stand; v's B fragments come
//   transposed from ldmatrix.trans.
// - Output through a staging tile. o is rounded to bf16 and written into the
//   task's q tile (q is consumed by then), then leaves 16 bytes a lane,
//   coalesced, at the row pitch of o.
//
// Rounding: the plain version's and the TPU kernel's. Logits and softmax in
// f32 (logits scaled, max subtracted, exp, sum), p = e / sum normalised in
// f32 and rounded to bf16 before p v, the product summed in f32, o rounded
// once to bf16.
#include "attention.cuh"
#include "wgmma.cuh"

namespace ls_attn {

using ls_wg::cp_async16s;
using ls_wg::cp_async_commit;
using ls_wg::cp_async_wait;
using ls_wg::pack_bf16;

constexpr int TF = 16;        // frames of a sequence: one m16 tile
constexpr int T_WARPS = 4;    // warps a block, at most
constexpr int T_STAGES = 3;   // ring stages a warp: two tasks in flight while one computes
constexpr int T_SMEM_MAX = 232448;

// bytes between two rows of a tile: D bf16 padded to an odd number of chunks
__host__ __device__ constexpr int t_row_bytes(int d) { return ((d / 8) | 1) * 16; }
// one stage: q, k and v of one task
__host__ __device__ constexpr int t_stage_bytes(int d) { return 3 * TF * t_row_bytes(d); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d (16 x 8, f32) += a (16 x 16) x b (16 x 8), bf16 fragments in registers
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16 x 8, f32) += a (16 x 8) x b (8 x 8): the last k-step of a head dim with D % 16 == 8
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

static __global__ void __launch_bounds__(32 * T_WARPS)
    temporal_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, int ldq, int ldk, int ldv, bf16* __restrict__ o,
                    int ldo, int batch, int heads, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rb = t_row_bytes(d);
  const int sb = 3 * TF * rb;
  unsigned char* ring = smem_raw + (size_t)warp * T_STAGES * sb;
  const unsigned ring_s = (unsigned)__cvta_generic_to_shared(ring);
  const long tasks = (long)batch * heads;
  const long step = (long)gridDim.x * warps;
  const int cpr = d / 8;        // 16-byte chunks of a head's row
  const int chunks = TF * cpr;  // of one tile

  // the copies of `task` into `stage`: q, k, v tiles; one commit group a call
  auto load = [&](long task, int stage) {
    if (task < tasks) {
      const int b = (int)(task / heads);
      const int h = (int)(task - (long)b * heads);
      const unsigned dst = ring_s + stage * sb;
      for (int i = lane; i < chunks; i += 32) {
        const int f = i / cpr;
        const int c = i - f * cpr;
        const size_t row = (size_t)b * TF + f;
        const size_t col = (size_t)h * d + 8 * c;
        const unsigned off = f * rb + 16 * c;
        cp_async16s(dst + off, q + row * ldq + col);
        cp_async16s(dst + TF * rb + off, k + row * ldk + col);
        cp_async16s(dst + 2 * TF * rb + off, v + row * ldv + col);
      }
    }
    cp_async_commit();
  };

  const long first = (long)blockIdx.x * warps + warp;
#pragma unroll
  for (int s = 0; s < T_STAGES - 1; ++s) load(first + s * step, s);

  const int g = lane >> 2;
  const int t4 = lane & 3;
  // ldmatrix row addresses: A (q) rows of the four 8 x 8 matrices, then
  // B (k) rows (keys 0-7 | 8-15) and the column half each lane points at
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;
  int stage = 0;
  for (long task = first; task < tasks; task += step) {
    cp_async_wait<T_STAGES - 2>();  // this lane's copies of the task have landed
    __syncwarp();                   // and every lane's; the stage before is free
    load(task + (T_STAGES - 1) * step, stage == 0 ? T_STAGES - 1 : stage - 1);
    const unsigned qs = ring_s + stage * sb;
    const unsigned ks = qs + TF * rb;
    const unsigned vs = ks + TF * rb;

    // logits: s[nt] holds keys 8nt..8nt+7 of rows g and g + 8
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    int kk = 0;
    for (; kk + 16 <= d; kk += 16) {
      uint32_t a[4], b[4];
      ldsm_x4(a, qs + a_row * rb + (kk + a_col) * 2);
      ldsm_x4(b, ks + b_row * rb + (kk + b_col) * 2);
      mma_k16(s[0], a, b[0], b[1]);
      mma_k16(s[1], a, b[2], b[3]);
    }
    if (kk < d) {  // D % 16 == 8: one k-step of 8
      uint32_t a[2], b[2];
      ldsm_x2(a, qs + (lane & 15) * rb + kk * 2);
      ldsm_x2(b, ks + (lane & 15) * rb + kk * 2);
      mma_k8(s[0], a, b[0]);
      mma_k8(s[1], a, b[1]);
    }

    // softmax of rows g (s[.][0..1]) and g + 8 (s[.][2..3]); a row lives in one quad
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= scale;
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(LS_FULL_MASK, m0, x));
      m1 = fmaxf(m1, __shfl_xor_sync(LS_FULL_MASK, m1, x));
    }
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      s[nt][0] = expf(s[nt][0] - m0);
      s[nt][1] = expf(s[nt][1] - m0);
      s[nt][2] = expf(s[nt][2] - m1);
      s[nt][3] = expf(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      l0 += __shfl_xor_sync(LS_FULL_MASK, l0, x);
      l1 += __shfl_xor_sync(LS_FULL_MASK, l1, x);
    }
    // normalised in f32, rounded to bf16: the two 8-key tiles are one 16-deep A fragment
    uint32_t pa[4];
    pa[0] = pack_bf16(s[0][0] / l0, s[0][1] / l0);
    pa[1] = pack_bf16(s[0][2] / l1, s[0][3] / l1);
    pa[2] = pack_bf16(s[1][0] / l0, s[1][1] / l0);
    pa[3] = pack_bf16(s[1][2] / l1, s[1][3] / l1);

    // p v, two 8-column tiles of o at a time (one at an odd end), each staged
    // as bf16 pairs into the q tile: row g, columns 8j + 2t4 and 2t4 + 1
    unsigned char* stg = ring + stage * sb;
    __syncwarp();  // every lane's ldmatrix of q is done before o overwrites it
    auto stage_o = [&](int j, const float (&acc)[4]) {
      unsigned char* at = stg + g * rb + (8 * j + 2 * t4) * 2;
      *reinterpret_cast<uint32_t*>(at) = pack_bf16(acc[0], acc[1]);
      *reinterpret_cast<uint32_t*>(at + 8 * rb) = pack_bf16(acc[2], acc[3]);
    };
    int j = 0;
    for (; j + 2 <= cpr; j += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, vs + a_row * rb + (8 * j + a_col) * 2);
      float o0[4] = {0.f, 0.f, 0.f, 0.f}, o1[4] = {0.f, 0.f, 0.f, 0.f};
      mma_k16(o0, pa, b[0], b[1]);
      mma_k16(o1, pa, b[2], b[3]);
      stage_o(j, o0);
      stage_o(j + 1, o1);
    }
    if (j < cpr) {
      uint32_t b[2];
      ldsm_x2_t(b, vs + a_row * rb + 8 * j * 2);
      float o0[4] = {0.f, 0.f, 0.f, 0.f};
      mma_k16(o0, pa, b[0], b[1]);
      stage_o(j, o0);
    }
    __syncwarp();

    // the staged tile to o, 16 bytes a lane
    const int b = (int)(task / heads);
    const int h = (int)(task - (long)b * heads);
    for (int i = lane; i < chunks; i += 32) {
      const int f = i / cpr;
      const int c = i - f * cpr;
      *reinterpret_cast<uint4*>(o + ((size_t)b * TF + f) * ldo + (size_t)h * d + 8 * c) =
          *reinterpret_cast<const uint4*>(stg + f * rb + 16 * c);
    }
    stage = stage + 1 == T_STAGES ? 0 : stage + 1;
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// Launch geometry for head dim d: warps a block (fewest that keep the block's
// ring within shared memory, at most T_WARPS) and blocks the card holds at
// once, cached for the last few head dims.
static cudaError_t temporal_geometry(int d, int* warps, size_t* smem, int* resident) {
  const size_t per_warp = (size_t)T_STAGES * t_stage_bytes(d);
  const int w = (int)(T_SMEM_MAX / per_warp) < T_WARPS ? (int)(T_SMEM_MAX / per_warp) : T_WARPS;
  if (w < 1) return cudaErrorInvalidValue;
  *warps = w;
  *smem = (size_t)w * per_warp;
  static int cached_d[4] = {0, 0, 0, 0};
  static int cached_resident[4] = {0, 0, 0, 0};
  for (int i = 0; i < 4; ++i)
    if (cached_d[i] == d) {
      *resident = cached_resident[i];
      return cudaSuccess;
    }
  cudaError_t e = ls_allow_smem(temporal_kernel, *smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, temporal_kernel, 32 * w, *smem);
  if (e != cudaSuccess) return e;
  if (sms * per_sm < 1) return cudaErrorInvalidConfiguration;
  static int next = 0;
  cached_d[next] = d;
  cached_resident[next] = sms * per_sm;
  next = (next + 1) & 3;
  *resident = sms * per_sm;
  return cudaSuccess;
}

cudaError_t temporal(const bf16* q, const bf16* k, const bf16* v, int ldq, int ldk, int ldv,
                     bf16* o, int ldo, int batch, int heads, int d, float scale,
                     cudaStream_t s) {
  if (batch < 0 || heads <= 0 || d <= 0 || d % 8 || ldq % 8 || ldk % 8 || ldv % 8 || ldo % 8)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  int warps = 0, resident = 0;
  size_t smem = 0;
  cudaError_t e = temporal_geometry(d, &warps, &smem, &resident);
  if (e != cudaSuccess) return e;
  if ((e = ls_allow_smem(temporal_kernel, smem)) != cudaSuccess) return e;
  const long tasks = (long)batch * heads;
  const long wanted = (tasks + warps - 1) / warps;
  const int blocks = wanted < resident ? (int)wanted : resident;
  temporal_kernel<<<blocks, 32 * warps, smem, s>>>(q, k, v, ldq, ldk, ldv, o, ldo, batch, heads,
                                                   d, scale);
  return cudaGetLastError();
}

}  // namespace ls_attn

extern "C" int ls_temporal_attention(const void* q, const void* k, const void* v, int ldq, int ldk,
                                     int ldv, void* o, int ldo, int batch, int heads, int d,
                                     float scale, void* stream) {
  return (int)ls_attn::temporal(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                static_cast<const bf16*>(v), ldq, ldk, ldv, static_cast<bf16*>(o),
                                ldo, batch, heads, d, scale, static_cast<cudaStream_t>(stream));
}
