// K3: the temporal attention core over (B, F, heads * D), 1 <= F <= 24.
// Replaces the TPU kernel latentsync_tpu/ops/temporal_attention.py _kernel
// (pallas_call at temporal_attention.py:101), which folded (F, heads) into
// one 128-wide MXU product with a block-diagonal mask. On Hopper a sequence
// of up to 16 frames is one m16 tile of mma.sync (two row tiles up to 24),
// so one warp owns one (sequence, head) task: no fold, heads never mix.
//
// Frames past F. A tile has 16 MT rows (MT = 1 for F <= 16, 2 above). The
// ring copies exactly F rows of a task; the rows past F were zeroed once when
// the warp started, are never copied into, and stay finite: their keys get a
// logit of -inf before the row max (p = 0 exactly), their values meet only
// those zeros, and their query rows are computed and never stored.
//
// Bound: memory. A task reads 3 * 16 * D bf16 and writes 16 * D, and does
// 2 * 16 * 16 * D multiply-adds, about 2 FLOP a byte against the card's ~295
// (42 MB and 0.0125 ms at (256, 16, 1280), 168 MB and 0.050 ms at (4096, 16,
// 320); F = 24 moves 1.5 times the bytes of F = 16). So the design keeps
// copies in flight at all times and makes the arithmetic short enough to hide
// under them:
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
#include "mma_sync.cuh"
#include "wgmma.cuh"

namespace ls_attn {

using ls_wg::cp_async16s;
using ls_wg::cp_async_commit;
using ls_wg::cp_async_wait;
using ls_wg::pack_bf16;
using namespace ls_mma;

constexpr int T_MAX_F = 24;   // frames of a sequence, at most (two m16 row tiles)
constexpr int T_WARPS = 4;    // warps a block, at most
constexpr int T_STAGES = 3;   // ring stages a warp: two tasks in flight while one computes
constexpr int T_SMEM_MAX = 232448;

// one stage: q, k and v of one task, 16 MT rows each
__host__ __device__ constexpr int t_stage_bytes(int d, int mt) {
  return 3 * 16 * mt * odd_row_bytes(d);
}

// MT m16 row tiles a task: 16 MT query rows against 16 MT keys, F of each real
template <int MT>
static __global__ void __launch_bounds__(32 * T_WARPS)
    temporal_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, int ldq, int ldk, int ldv, bf16* __restrict__ o,
                    int ldo, int batch, int frames, int heads, int d, float scale) {
  constexpr int TT = 16 * MT;  // tile rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rb = odd_row_bytes(d);
  const int sb = 3 * TT * rb;
  unsigned char* ring = smem_raw + (size_t)warp * T_STAGES * sb;
  const unsigned ring_s = (unsigned)__cvta_generic_to_shared(ring);
  const long tasks = (long)batch * heads;
  const long step = (long)gridDim.x * warps;
  const int cpr = d / 8;            // 16-byte chunks of a head's row
  const int chunks = frames * cpr;  // of a task's F rows

  // rows past F: zero once, never copied into
  if (frames < TT) {
    for (int i = lane; i < T_STAGES * sb / 16; i += 32)
      *reinterpret_cast<uint4*>(ring + 16 * i) = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
  }

  // the copies of `task` into `stage`: q, k, v tiles; one commit group a call
  auto load = [&](long task, int stage) {
    if (task < tasks) {
      const int b = (int)(task / heads);
      const int h = (int)(task - (long)b * heads);
      const unsigned dst = ring_s + stage * sb;
      for (int i = lane; i < chunks; i += 32) {
        const int f = i / cpr;
        const int c = i - f * cpr;
        const size_t row = (size_t)b * frames + f;
        const size_t col = (size_t)h * d + 8 * c;
        const unsigned off = f * rb + 16 * c;
        cp_async16s(dst + off, q + row * ldq + col);
        cp_async16s(dst + TT * rb + off, k + row * ldk + col);
        cp_async16s(dst + 2 * TT * rb + off, v + row * ldv + col);
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
  // B (k) rows (keys 0-7 | 8-15 of a key tile) and the column half each lane points at
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
    const unsigned ks = qs + TT * rb;
    const unsigned vs = ks + TT * rb;

    // logits: s[mt][nt] holds keys 8nt..8nt+7 of rows 16mt + g and 16mt + g + 8
    float s[MT][2 * MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2 * MT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
    int kk = 0;
    for (; kk + 16 <= d; kk += 16) {
      uint32_t b[MT][4];
#pragma unroll
      for (int kt = 0; kt < MT; ++kt) ldsm_x4(b[kt], ks + (16 * kt + b_row) * rb + (kk + b_col) * 2);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, qs + (16 * mt + a_row) * rb + (kk + a_col) * 2);
#pragma unroll
        for (int kt = 0; kt < MT; ++kt) {
          mma_k16(s[mt][2 * kt], a, b[kt][0], b[kt][1]);
          mma_k16(s[mt][2 * kt + 1], a, b[kt][2], b[kt][3]);
        }
      }
    }
    if (kk < d) {  // D % 16 == 8: one k-step of 8
      uint32_t b[MT][2];
#pragma unroll
      for (int kt = 0; kt < MT; ++kt) ldsm_x2(b[kt], ks + (16 * kt + (lane & 15)) * rb + kk * 2);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[2];
        ldsm_x2(a, qs + (16 * mt + (lane & 15)) * rb + kk * 2);
#pragma unroll
        for (int kt = 0; kt < MT; ++kt) {
          mma_k8(s[mt][2 * kt], a[0], a[1], b[kt][0]);
          mma_k8(s[mt][2 * kt + 1], a[0], a[1], b[kt][1]);
        }
      }
    }

    // softmax of rows 16mt + g (s[mt][.][0..1]) and 16mt + g + 8 (s[mt][.][2..3]);
    // a row lives in one quad; keys past F take no part
    uint32_t pa[MT][MT][4];  // p v's A fragments: row tile mt, 16-key step ks
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2 * MT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][nt][e] *= scale;
          if (8 * nt + 2 * t4 + (e & 1) >= frames) s[mt][nt][e] = -INFINITY;
        }
        m0 = fmaxf(m0, fmaxf(s[mt][nt][0], s[mt][nt][1]));
        m1 = fmaxf(m1, fmaxf(s[mt][nt][2], s[mt][nt][3]));
      }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(LS_FULL_MASK, m0, x));
        m1 = fmaxf(m1, __shfl_xor_sync(LS_FULL_MASK, m1, x));
      }
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2 * MT; ++nt) {
        s[mt][nt][0] = expf(s[mt][nt][0] - m0);
        s[mt][nt][1] = expf(s[mt][nt][1] - m0);
        s[mt][nt][2] = expf(s[mt][nt][2] - m1);
        s[mt][nt][3] = expf(s[mt][nt][3] - m1);
        l0 += s[mt][nt][0] + s[mt][nt][1];
        l1 += s[mt][nt][2] + s[mt][nt][3];
      }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        l0 += __shfl_xor_sync(LS_FULL_MASK, l0, x);
        l1 += __shfl_xor_sync(LS_FULL_MASK, l1, x);
      }
      // normalised in f32, rounded to bf16: two 8-key tiles are one 16-deep A fragment
#pragma unroll
      for (int kq = 0; kq < MT; ++kq) {
        pa[mt][kq][0] = pack_bf16(s[mt][2 * kq][0] / l0, s[mt][2 * kq][1] / l0);
        pa[mt][kq][1] = pack_bf16(s[mt][2 * kq][2] / l1, s[mt][2 * kq][3] / l1);
        pa[mt][kq][2] = pack_bf16(s[mt][2 * kq + 1][0] / l0, s[mt][2 * kq + 1][1] / l0);
        pa[mt][kq][3] = pack_bf16(s[mt][2 * kq + 1][2] / l1, s[mt][2 * kq + 1][3] / l1);
      }
    }

    // p v, two 8-column tiles of o at a time (one at an odd end), each staged
    // as bf16 pairs into the q tile: row 16mt + g, columns 8j + 2t4 and 2t4 + 1
    unsigned char* stg = ring + stage * sb;
    __syncwarp();  // every lane's ldmatrix of q is done before o overwrites it
    auto stage_o = [&](int mt, int j, const float (&acc)[4]) {
      unsigned char* at = stg + (16 * mt + g) * rb + (8 * j + 2 * t4) * 2;
      *reinterpret_cast<uint32_t*>(at) = pack_bf16(acc[0], acc[1]);
      *reinterpret_cast<uint32_t*>(at + 8 * rb) = pack_bf16(acc[2], acc[3]);
    };
    int j = 0;
    for (; j + 2 <= cpr; j += 2) {
      uint32_t b[MT][4];
#pragma unroll
      for (int kq = 0; kq < MT; ++kq)
        ldsm_x4_t(b[kq], vs + (16 * kq + a_row) * rb + (8 * j + a_col) * 2);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float o0[4] = {0.f, 0.f, 0.f, 0.f}, o1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kq = 0; kq < MT; ++kq) {
          mma_k16(o0, pa[mt][kq], b[kq][0], b[kq][1]);
          mma_k16(o1, pa[mt][kq], b[kq][2], b[kq][3]);
        }
        stage_o(mt, j, o0);
        stage_o(mt, j + 1, o1);
      }
    }
    if (j < cpr) {
      uint32_t b[MT][2];
#pragma unroll
      for (int kq = 0; kq < MT; ++kq) ldsm_x2_t(b[kq], vs + (16 * kq + a_row) * rb + 8 * j * 2);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float o0[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kq = 0; kq < MT; ++kq) mma_k16(o0, pa[mt][kq], b[kq][0], b[kq][1]);
        stage_o(mt, j, o0);
      }
    }
    __syncwarp();

    // the staged tile's F rows to o, 16 bytes a lane
    const int b = (int)(task / heads);
    const int h = (int)(task - (long)b * heads);
    for (int i = lane; i < chunks; i += 32) {
      const int f = i / cpr;
      const int c = i - f * cpr;
      *reinterpret_cast<uint4*>(o + ((size_t)b * frames + f) * ldo + (size_t)h * d + 8 * c) =
          *reinterpret_cast<const uint4*>(stg + f * rb + 16 * c);
    }
    stage = stage + 1 == T_STAGES ? 0 : stage + 1;
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// Launch geometry for head dim d and MT row tiles: warps a block (fewest that
// keep the block's ring within shared memory, at most T_WARPS) and blocks the
// card holds at once, cached for the last few head dims.
template <int MT>
static cudaError_t temporal_geometry(int d, int* warps, size_t* smem, int* resident) {
  const size_t per_warp = (size_t)T_STAGES * t_stage_bytes(d, MT);
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
  cudaError_t e = ls_allow_smem(temporal_kernel<MT>, *smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, temporal_kernel<MT>, 32 * w, *smem);
  if (e != cudaSuccess) return e;
  if (sms * per_sm < 1) return cudaErrorInvalidConfiguration;
  static int next = 0;
  cached_d[next] = d;
  cached_resident[next] = sms * per_sm;
  next = (next + 1) & 3;
  *resident = sms * per_sm;
  return cudaSuccess;
}

template <int MT>
static cudaError_t temporal_launch(const bf16* q, const bf16* k, const bf16* v, int ldq, int ldk,
                                   int ldv, bf16* o, int ldo, int batch, int frames, int heads,
                                   int d, float scale, cudaStream_t s) {
  int warps = 0, resident = 0;
  size_t smem = 0;
  cudaError_t e = temporal_geometry<MT>(d, &warps, &smem, &resident);
  if (e != cudaSuccess) return e;
  if ((e = ls_allow_smem(temporal_kernel<MT>, smem)) != cudaSuccess) return e;
  const long tasks = (long)batch * heads;
  const long wanted = (tasks + warps - 1) / warps;
  const int blocks = wanted < resident ? (int)wanted : resident;
  temporal_kernel<MT><<<blocks, 32 * warps, smem, s>>>(q, k, v, ldq, ldk, ldv, o, ldo, batch,
                                                       frames, heads, d, scale);
  return cudaGetLastError();
}

cudaError_t temporal(const bf16* q, const bf16* k, const bf16* v, int ldq, int ldk, int ldv,
                     bf16* o, int ldo, int batch, int frames, int heads, int d, float scale,
                     cudaStream_t s) {
  if (batch < 0 || frames < 1 || frames > T_MAX_F || heads <= 0 || d <= 0 || d % 8 || ldq % 8 ||
      ldk % 8 || ldv % 8 || ldo % 8)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  if (frames <= 16)
    return temporal_launch<1>(q, k, v, ldq, ldk, ldv, o, ldo, batch, frames, heads, d, scale, s);
  return temporal_launch<2>(q, k, v, ldq, ldk, ldv, o, ldo, batch, frames, heads, d, scale, s);
}

}  // namespace ls_attn

extern "C" int ls_temporal_attention(const void* q, const void* k, const void* v, int ldq, int ldk,
                                     int ldv, void* o, int ldo, int batch, int frames, int heads,
                                     int d, float scale, void* stream) {
  return (int)ls_attn::temporal(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                static_cast<const bf16*>(v), ldq, ldk, ldv, static_cast<bf16*>(o),
                                ldo, batch, frames, heads, d, scale,
                                static_cast<cudaStream_t>(stream));
}
