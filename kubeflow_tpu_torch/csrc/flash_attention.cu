// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces both Pallas TPU forward kernels of kubeflow_tpu/ops/attention.py:
// the whole-K/V kernel (_fwd_whole_kernel, called by _fwd_whole_call) and
// the streamed one (_fwd_kernel, called by _fwd_pallas_call). The two
// compute one function and differ only in whether a row's K/V stays in the
// TPU's VMEM; here K/V always stream through shared memory, so one kernel
// covers any key length. It computes, for q (B, H, Sq, D) against
// unrepeated k/v (B, Hkv, Sk, D) (q head i reads kv head i / (H / Hkv)):
// O = softmax(q·kᵀ / sqrt(D)) · v over the keys a row may see — key
// position <= row + q_offset when causal, > row + q_offset - window when
// window > 0, and kv_mask[b, key] when a mask is given — and the row's
// natural-log logsumexp lse (f32). A row with no visible key gives O = 0
// and lse = -1e30 (the JAX package's NEG_INF convention, _flush_output).
//
// What bounds it on this card: at the main-path prefill (B 1, H 32, Hkv 8,
// Sq = Sk = 512, D 128, causal) the causal FLOPs (2.1 G) and the bytes
// every input and output must move (~10 MB) are near balance, the bytes
// bound (~3.1 us at 3.35 TB/s) a little above the FLOPs bound (~2.2 us at
// 989 TFLOP/s); from Sq = Sk = 1024 up operations bind (training, S 2048:
// 34.4 GFLOP, 0.0348 ms), since FLOPs grow with Sq·Sk and bytes with
// Sq + Sk. So the work must run on Hopper's warpgroup tensor-core
// products, and each K/V byte read from HBM must feed many query rows.
// What the design does about it:
// - one CTA per (64-row query tile, q head, batch row): one warpgroup (4
//   warps) computes and a fifth warp copies; the key loop runs inside the
//   CTA (CTAs run in no order; nothing carries between them). The q tile
//   is the slowest index of the block order and runs backwards, so under
//   causal the longest CTAs (the last q tiles) start first and the short
//   ones fill the SMs behind them; neighbouring CTAs are the q heads of
//   one kv head, which read the same K/V from L2;
// - the copying warp's one thread moves the q tile once, then each 64-key
//   K and V tile, with the Tensor Memory Accelerator (3-D tensor maps over
//   (planes, rows, D), boxes of 64 rows × 64 values with the 128-byte
//   swizzle that wgmma reads, rows past Sq or Sk filled with zeros by the
//   hardware) and the tile's mask bytes with a bulk copy, into two
//   stages, on `full` / `empty` mbarriers: it refills a stage once the
//   warpgroup has released it. The warpgroup issues no copy, no proxy
//   fence and no block-wide barrier in the loop: it waits on `full`,
//   computes, and arrives on `empty`;
// - S = Q·Kᵀ is wgmma m64n64k16 with both operands in shared memory,
//   K-major over D; the online softmax (exp2 units) runs on the f32
//   accumulator fragment; P is rounded to bf16 and packed in place as
//   the register A fragment of O += P·V, wgmma m64nDk16 (two m64n128k16
//   at D 256) with V read MN-major (keys the reduction) from the same
//   tile layout; O stays in registers for the whole loop (64 f32 a
//   thread at D 128, 128 at D 256). The descriptors are rebuilt each step
//   from an address the compiler cannot see through (`opaque`), and
//   `fence_regs` pins the accumulators around each product, so nothing
//   is hoisted into registers the accumulators need: ptxas reports 95,
//   158 and 212 registers at D 64, 128 and 256 with no spill (CUDA 12.8,
//   sm_90a), so every head dim runs this body (2 CTAs an SM at D 128, by
//   shared memory);
// - the loop runs only over the key tiles some row of the CTA can see
//   (causal and window bounds), so the warpgroup issues every product;
//   a warp whose 16 rows see a tile whole skips the per-element mask.
// Keeping the next tile's S = Q·Kᵀ in flight during the softmax (FA3's
// in-warpgroup overlap) was built and measured slower here: the other CTA
// on the SM already fills the tensor cores during a softmax.
// Rows and keys are independent of the schedule and nothing is summed
// across threads in a varying order, so O and lse repeat bit for bit.
//
// Any Sq, Sk >= 1: rows past Sq are zero-filled and never stored, keys
// past Sk are zero-filled and masked. The optional kv_mask comes padded by
// the wrapper to (B, Sk_pad) bytes, Sk_pad a multiple of 64, so each
// tile's mask bytes are one aligned 64-byte copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using kftt::bulk_load;
using kftt::fence_mbar_init;
using kftt::fence_regs;
using kftt::mbar_arrive;
using kftt::mbar_expect_tx;
using kftt::mbar_init;
using kftt::mbar_wait;
using kftt::opaque;
using kftt::pack_bf16;
using kftt::sw128_desc;
using kftt::tensor_map;
using kftt::tma_load_3d;
using kftt::wgmma_commit;
using kftt::wgmma_fence;
using kftt::wgmma_rs_m64n128;
using kftt::wgmma_rs_m64n64;
using kftt::wgmma_ss_m64n64;
using kftt::wgmma_wait;

constexpr int kConsumers = 128;           // one warpgroup computes
constexpr int kThreads = kConsumers + 32;  // and one warp copies
constexpr int kRows = 64;      // query rows of a CTA
constexpr int kKeys = 64;      // keys per tile
constexpr size_t kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;  // lse of a row with no visible key
constexpr float kLog2e = 1.4426950408889634f;

enum : int {
  kErrHeadDim = -1,
  kErrSmem = -2,
  kErrGroup = -3,
  kErrShape = -4,
  kErrTensorMap = -5,
};

// The wgmma products of one key tile. The descriptors are those of the
// tiles' first bytes; a step adds its offset (in 16-byte units) to the
// start address field. Every tile is [64 rows][D] bf16, 128-byte swizzled.
template <int D>
struct FwdMma {
  static constexpr int kTile = 64 * D * 2;  // bytes of a tile
  // S = Q·Kᵀ, 64 rows × 64 keys: A the q tile, B the key tile, both
  // K-major over D; step kk covers D values 16kk … 16kk + 15, 32 bytes
  // into a 128-byte row, or the next column block every 4 steps.
  static __device__ __forceinline__ void scores(float* s, uint64_t q_desc,
                                                uint64_t k_desc) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = ((kk / 4) * (64 * 128) + (kk % 4) * 32) >> 4;
      wgmma_ss_m64n64(s, q_desc + off, k_desc + off, kk > 0);
    }
  }
  // O += P·V: A the packed fragments p[ks] of keys 16ks … 16ks + 15, B the
  // V tile MN-major (keys the reduction, D the columns), step ks starting
  // 16 rows of 128 B further. At D 256 each step is two n128 products on
  // the halves of D, two column blocks (2 · 64 · 128 B) apart.
  static __device__ __forceinline__ void update(float* o, uint32_t (*p)[4],
                                                uint64_t v_desc) {
#pragma unroll
    for (int ks = 0; ks < kKeys / 16; ++ks) {
      const uint64_t desc = v_desc + ((ks * 16 * 128) >> 4);
      if constexpr (D == 64) {
        wgmma_rs_m64n64(o, p[ks], desc);
      } else {
        wgmma_rs_m64n128(o, p[ks], desc);
        if constexpr (D == 256)
          wgmma_rs_m64n128(o + 64, p[ks], desc + ((2 * 64 * 128) >> 4));
      }
    }
  }
  // K-major tiles: 8 rows of 128 B per stride step (LBO unused).
  static __device__ __forceinline__ uint64_t k_major(uint32_t addr) {
    return sw128_desc(opaque(addr), 16, 1024);
  }
  // MN-major tiles: 8 rows of 128 B per stride step, column blocks of 64
  // values 64 · 128 B apart.
  static __device__ __forceinline__ uint64_t mn_major(uint32_t addr) {
    return sw128_desc(opaque(addr), 64 * 128, 1024);
  }
};

// Byte offsets from a 1024-byte-aligned base in dynamic shared memory:
//   q:    [kRows][D] bf16, 128-byte swizzled
//   kv:   [stage][K|V][kKeys][D] bf16, two stages, 128-byte swizzled
//   mask: [stage][kKeys] kv_mask bytes
//   bar:  full[2], empty[2] and q mbarriers, 8 bytes each
// `total` adds 1024 bytes for aligning the base.
struct Smem {
  size_t q, kv, mask, bar, total;
  __host__ __device__ explicit Smem(int d) {
    const size_t tile = (size_t)64 * d * 2;
    q = 0;
    kv = q + tile;
    mask = kv + 4 * tile;
    bar = mask + 2 * kKeys;
    total = bar + 5 * 8 + 1024;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int b_count, int h, int hkv, int sq, int sk,
    int sk_pad, int causal, int q_offset, int window, float scale) {
  using Mma = FwdMma<D>;
  constexpr int ND = D / 8;     // n-tiles of O
  constexpr int NT = kKeys / 8;  // n-tiles of S
  constexpr int kBlocks = D / 64;  // 64-column blocks of a tile (TMA boxes)

  // The q tile slowest in the block order and the last (under causal the
  // longest) first, so the longest CTAs start first and the short ones
  // fill the SMs behind them; the heads of one kv head stay neighbours.
  const int lin =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int q0 = (gridDim.x - 1 - lin / (h * b_count)) * kRows;
  const int b = lin % (h * b_count) / h;
  const int head = lin % h;
  const int bkv = b * hkv + head / (h / hkv);
  const int tid = threadIdx.x;
  // Scores in log2 units, so the softmax's exponentials are exp2.
  const float scale_log2 = scale * kLog2e;

  const size_t bh = (size_t)b * h + head;
  const uint8_t* mask_b = mask ? mask + (size_t)b * sk_pad : nullptr;

  // The keys some row of this CTA can see: [k_lo, k_hi).
  const int rows_here = min(kRows, sq - q0);
  const int pos_lo = q0 + q_offset;
  const int pos_hi = q0 + rows_here - 1 + q_offset;
  const int k_hi = causal ? max(0, min(sk, pos_hi + 1)) : sk;
  const int k_lo = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const int kt_lo = k_lo / kKeys;
  const int nkt = k_hi > k_lo ? (k_hi + kKeys - 1) / kKeys - kt_lo : 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem lay(D);
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base_s = raw + (uint32_t)(base - smem_raw);
  const uint32_t q_s = base_s + lay.q;
  const uint8_t* mask_s = base + lay.mask;
  // full[st]: stage st holds its tile; empty[st]: the consumers are done
  // with it; q_bar: the q tile has landed.
  auto full = [&](int st) { return base_s + lay.bar + 8 * st; };
  auto empty = [&](int st) { return base_s + lay.bar + 16 + 8 * st; };
  const uint32_t q_bar = base_s + lay.bar + 32;
  auto k_tile = [&](int st) {
    return base_s + lay.kv + st * 2 * Mma::kTile;
  };

  if (tid == 0) {
    for (int st = 0; st < 2; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    mbar_init(q_bar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  // The copying warp: one thread issues the TMA copies of the q tile and
  // then of each key tile's K and V (and a bulk copy of its mask bytes)
  // into the stages in turn, waiting for a stage to be released before
  // refilling it. Rows past Sq and keys past Sk come in as zeros.
  if (tid >= kConsumers) {
    if (tid == kConsumers && nkt > 0) {
      mbar_expect_tx(q_bar, Mma::kTile);
      for (int c = 0; c < kBlocks; ++c)
        tma_load_3d(q_s + c * 64 * 128, &q_map, c * 64, q0, (int)bh, q_bar);
      for (int i = 0; i < nkt; ++i) {
        const int st = i & 1;
        const int k0 = (kt_lo + i) * kKeys;
        if (i >= 2) mbar_wait(empty(st), ((i >> 1) - 1) & 1);
        mbar_expect_tx(full(st),
                       2 * Mma::kTile + (mask_b != nullptr ? kKeys : 0));
        for (int c = 0; c < kBlocks; ++c) {
          tma_load_3d(k_tile(st) + c * 64 * 128, &k_map, c * 64, k0, bkv,
                      full(st));
          tma_load_3d(k_tile(st) + Mma::kTile + c * 64 * 128, &v_map, c * 64,
                      k0, bkv, full(st));
        }
        if (mask_b != nullptr)
          bulk_load(base_s + lay.mask + st * kKeys, mask_b + k0, kKeys,
                    full(st));
      }
    }
    return;
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tq = lane % 4;
  // This thread's rows a and b: the rows of the wgmma accumulator
  // fragment (warp w holds rows 16w … 16w + 15, as mma.sync's C).
  const int ra = warp * 16 + lane / 4;
  const int qpos_a = q0 + ra + q_offset;
  const int qpos_b = qpos_a + 8;
  // The warp's first and last query positions.
  const int wpos_lo = q0 + warp * 16 + q_offset;
  const int wpos_hi = wpos_lo + 15;

  float o[ND * 4];
#pragma unroll
  for (int i = 0; i < ND * 4; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max (log2 units)
  float l_a = 0.f, l_b = 0.f;              // this thread's partial sums

  if (nkt > 0) mbar_wait(q_bar, 0);
  for (int i = 0; i < nkt; ++i) {
    const int st = i & 1;
    const int k0 = (kt_lo + i) * kKeys;
    mbar_wait(full(st), (i >> 1) & 1);

    const uint32_t k_t = k_tile(st);
    const uint32_t v_t = k_t + Mma::kTile;
    // S = Q·Kᵀ for the CTA's 64 rows × 64 keys. The loop runs only over
    // tiles some row of the CTA sees, so the warpgroup always issues it.
    float s[NT * 4];
    wgmma_fence();
    Mma::scores(s, Mma::k_major(q_s), Mma::k_major(k_t));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NT * 4>(s);

    // Tiles every row of this warp sees whole skip the per-element mask.
    // Element (nt, e) is row a for e < 2, row b otherwise, at key
    // k0 + nt*8 + tq*2 + (e & 1).
    const bool interior = mask_b == nullptr && k0 + kKeys <= sk &&
                          (!causal || k0 + kKeys - 1 <= wpos_lo) &&
                          (window <= 0 || k0 > wpos_hi - window);
    if (!interior) {
      const uint8_t* mask_t = mask_s + st * kKeys;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = nt * 8 + tq * 2 + (e & 1);
          const int kpos = k0 + key;
          const int qpos = e >= 2 ? qpos_b : qpos_a;
          const bool ok = kpos < sk &&
                          (mask_b == nullptr || mask_t[key] != 0) &&
                          (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          if (!ok) s[nt * 4 + e] = -INFINITY;
        }
      }
    }
    // The per-row tile max; the four lanes of a quad share a row.
    float bmax_a = -INFINITY, bmax_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      bmax_a = fmaxf(bmax_a, fmaxf(s[nt * 4], s[nt * 4 + 1]));
      bmax_b = fmaxf(bmax_b, fmaxf(s[nt * 4 + 2], s[nt * 4 + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      bmax_a = fmaxf(bmax_a, __shfl_xor_sync(0xffffffffu, bmax_a, off));
      bmax_b = fmaxf(bmax_b, __shfl_xor_sync(0xffffffffu, bmax_b, off));
    }
    // Online softmax. A row with no visible key so far keeps m = -inf: its
    // alpha is pinned to 0 and its exponent offset to 0, so every p of it
    // is exp2(-inf) = 0, never NaN.
    const float mn_a = fmaxf(m_a, bmax_a * scale_log2);
    const float mn_b = fmaxf(m_b, bmax_b * scale_log2);
    const float al_a = mn_a == -INFINITY ? 0.f : exp2f(m_a - mn_a);
    const float al_b = mn_b == -INFINITY ? 0.f : exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    const float off_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float off_b = mn_b == -INFINITY ? 0.f : mn_b;
    // P in bf16, packed in place as the A fragments of P·V: k-step ks
    // covers keys ks*16 … +15, i.e. S n-tiles 2ks (a0, a1) and 2ks+1
    // (a2, a3).
    float sum_a = 0.f, sum_b = 0.f;
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = exp2f(fmaf(s[nt * 4], scale_log2, -off_a));
      const float p1 = exp2f(fmaf(s[nt * 4 + 1], scale_log2, -off_a));
      const float p2 = exp2f(fmaf(s[nt * 4 + 2], scale_log2, -off_b));
      const float p3 = exp2f(fmaf(s[nt * 4 + 3], scale_log2, -off_b));
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      pa[nt / 2][(nt % 2) * 2] = pack_bf16(p0, p1);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n * 4] *= al_a;
      o[n * 4 + 1] *= al_a;
      o[n * 4 + 2] *= al_b;
      o[n * 4 + 3] *= al_b;
    }
    // O += P·V.
    fence_regs<ND * 4>(o);
    wgmma_fence();
    Mma::update(o, pa, Mma::mn_major(v_t));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<ND * 4>(o);
    mbar_arrive(empty(st));  // this stage may be refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + ra + half * 8;
    if (row >= sq) continue;
    const float m = half ? m_b : m_a;
    const float l = half ? l_b : l_a;
    // A row that saw no key has o = 0 (every p was 0).
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* dst = out + (bh * sq + row) * D + tq * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __floats2bfloat162_rn(
          o[n * 4 + half * 2] * inv, o[n * 4 + half * 2 + 1] * inv);
    }
    if (tq == 0)
      lse[bh * sq + row] =
          m == -INFINITY ? kNegInf : m * 0.6931471805599453f + logf(l);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, void* lse, int b, int h, int hkv, int sq, int sk,
           int sk_pad, int causal, int q_offset, int window,
           cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!tensor_map(&q_map, q, D, sq, b * h) ||
      !tensor_map(&k_map, k, D, sk, b * hkv) ||
      !tensor_map(&v_map, v, D, sk, b * hkv))
    return kErrTensorMap;
  const size_t smem = Smem(D).total;
  auto fn = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kRows - 1) / kRows, h, b);
  fn<<<grid, kThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), b, h, hkv,
      sq, sk, sk_pad, causal, q_offset, window, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success), or a
// negative code for a shape this kernel does not take. Allocates nothing.
// q (B, H, Sq, D), k/v (B, Hkv, Sk, D) bf16 contiguous; mask (B, Sk_pad)
// bytes or null; out (B, H, Sq, D) bf16; lse (B, H, Sq) f32.
int kftt_flash_attention_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* out, void* lse, int b,
                             int h, int hkv, int sq, int sk, int sk_pad, int d,
                             int causal, int q_offset, int window,
                             void* stream) {
  if (hkv <= 0 || h % hkv) return kErrGroup;
  if (b <= 0 || sq <= 0 || sk <= 0 || sk_pad < sk || sk_pad % kKeys ||
      b > 65535 || h > 65535 ||
      (size_t)((sq + kRows - 1) / kRows) * h * b > 0x7fffffffu)
    return kErrShape;
  if (Smem(d).total > kMaxSmem) return kErrSmem;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, k, v, mask, out, lse, b, h, hkv, sq, sk, sk_pad,
                        causal, q_offset, window, st);
    case 128:
      return launch<128>(q, k, v, mask, out, lse, b, h, hkv, sq, sk, sk_pad,
                         causal, q_offset, window, st);
    case 256:
      return launch<256>(q, k, v, mask, out, lse, b, h, hkv, sq, sk, sk_pad,
                         causal, q_offset, window, st);
    default:
      return kErrHeadDim;
  }
}

const char* kftt_error_string(int code) {
  switch (code) {
    case kErrHeadDim: return "head_dim must be 64, 128 or 256";
    case kErrSmem: return "tile needs more shared memory than a block has";
    case kErrGroup: return "H must be a positive multiple of Hkv";
    case kErrShape: return "B, Sq, Sk must be >= 1 and Sk_pad a multiple of 64";
    case kErrTensorMap: return "cuTensorMapEncodeTiled is missing or refused a map";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
