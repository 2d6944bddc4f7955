// Flash attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU backward kernels of kubeflow_tpu/ops/attention.py
// that _bwd_pallas_call launches: _bwd_dq_kernel (the dq pallas_call) and
// _bwd_dkv_kernel (the dk/dv pallas_call, which sums each kv head's GQA group
// in the kernel). From the forward's natural-log lse and delta = rowsum(dO ⊙ O)
// (computed by the wrapper), for q (B, H, Sq, D), dO (B, H, Sq, D) and
// unrepeated k/v (B, Hkv, Sk, D), q head i reading kv head i / (H / Hkv):
//   p  = exp(q·kᵀ·scale − lse) on the keys a row sees, 0 elsewhere and on
//        rows with lse <= NEG_INF/2 (rows that see no key: zero gradients)
//   dv = Σ_rows pᵀ·dO          dp = dO·vᵀ          ds = p ⊙ (dp − delta)
//   dq = ds·k·scale            dk = Σ_rows dsᵀ·q·scale
// with the visibility of the forward kernel (flash_attention.cu): key
// position <= row + q_offset when causal, > row + q_offset − window when
// window > 0, and mask[b, key] != 0 when a mask is given. The exponentials
// run in exp2 units with lse brought to log2 units, as the forward's do.
//
// What bounds it on this card: at the training shape (B 1, H 32, Hkv 8,
// S 2048, D 128, causal) dq does 6·D FLOPs per visible (row, key) pair and
// dk/dv 8·D, 5.2e10 and 6.9e10 FLOPs against ~60 MB and ~51 MB of inputs
// and outputs: both are bound by operations (0.0521 and 0.0695 ms at
// 989 TFLOP/s), so the products run on the tensor cores and every K/V (dq)
// or Q/dO (dk/dv) byte loaded into shared memory feeds 64 rows or keys.
// What the design does about it:
// - dQ (kernel 6, replacing _bwd_dq_kernel): one CTA per (64-row query
//   tile, q head, batch row), 4 warps of 16 rows; Q and dO stay in shared
//   memory, 64-key K/V tiles stream through two cp.async stages, S = Q·Kᵀ
//   and dP = dO·Vᵀ and dQ += dS·K on mma.sync m16n8k16 (bf16 in, f32
//   accumulate), dQ in registers for the whole key loop and written once;
// - dK/dV (kernel 7, replacing _bwd_dkv_kernel, which sweeps each kv
//   head's GQA group in its grid into one VMEM scratch): one CTA per
//   (64-key tile, q head, batch row), one warpgroup of 4 warps. K and V
//   stay in shared memory; the CTA walks only its own q head's q tiles
//   that can see the key tile, Q/dO/lse/delta streaming through two
//   cp.async stages. K, V, Q and dO sit in the canonical 128-byte-swizzled
//   layout of wgmma (column blocks of 64 values, the 16-byte chunk index
//   XOR row % 8, applied by the cp.async writes). Each 64-row q tile goes
//   in two halves of 32 rows: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ as wgmma
//   m64n32k16 (A = K or V, B = the Q or dO rows, both K-major over D);
//   Pᵀ and dSᵀ are made in registers and packed straight into the A
//   fragments of dV += Pᵀ·dO and dK += dSᵀ·Q, wgmma m64n128k16 (n64 at
//   D 64) whose B, dO or Q, is read MN-major from the same tiles. The
//   halves keep Sᵀ and dPᵀ at 32 f32 registers a thread beside dK and
//   dV's 128, so nothing spills.
//   Splitting the group over CTAs shortens the longest CTA fourfold (a
//   causal key tile 0 walks 32 q tiles, not 4 × 32), and the block index
//   puts the key tile slowest, so every head of the lowest key tiles (the
//   longest CTAs under causal) starts first and the short ones fill the
//   SMs behind them. Each CTA writes its q head's f32 share of dK and dV
//   to scratch the wrapper allocates; flash_bwd_group_sum_kernel then adds
//   the G shares of each kv head in the fixed order g = 0 … G−1, scales dK
//   and rounds both to bf16. Every value is written by one thread and
//   summed in one order: no atomics, and repeats are bit-equal; keys no
//   row sees get exact zeros (their shares are all 0);
// - tiles that causal or window visibility rules out are never loaded
//   (each loop runs over the visible range); in dQ a warp skips a key tile
//   none of its rows can see, in dK/dV a warp whose keys no row of the q
//   tile sees takes P = dS = 0 without the exponentials (the products run
//   on the whole warpgroup); tiles wholly visible to a warp skip the
//   per-element mask.
// P and dS are rounded to bf16 once each, as operands of the products;
// p itself stays in f32 for ds, as in the JAX kernels.
// Later work: the dQ redesign (still mma.sync), TMA, and head_dim 256
// (dK and dV of 64 keys × 256 do not fit a warpgroup's registers: it
// needs D split over warpgroups or two passes).
//
// Any Sq, Sk >= 1: the wrapper pads lse (with NEG_INF) and delta to
// Sq_pad, a multiple of 64, and the mask to (B, Sk_pad) bytes, Sk_pad a
// multiple of 64; rows past Sq and keys past Sk are zero-filled, never
// stored, and get p = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using kftt::cp_async16;
using kftt::cp_async_commit;
using kftt::cp_async_wait;
using kftt::fence_async_shared;
using kftt::fence_regs;
using kftt::ld32;
using kftt::mma_bf16;
using kftt::opaque;
using kftt::pack_bf16;
using kftt::sw128_desc;
using kftt::sw128_offset;
using kftt::wgmma_commit;
using kftt::wgmma_fence;
using kftt::wgmma_rs_m64n128;
using kftt::wgmma_rs_m64n64;
using kftt::wgmma_ss_m64n32;
using kftt::wgmma_wait;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows of a tile
constexpr int kKeys = 64;           // keys of a tile
constexpr size_t kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;  // lse of a row with no visible key
constexpr float kLog2e = 1.4426950408889634f;

enum : int {
  kErrHeadDim = -1,
  kErrSmem = -2,
  kErrGroup = -3,
  kErrShape = -4,
};

// The ldmatrix.x2.trans B fragment of a row-major [k][n] bf16 tile: rows
// k0..k0+15 from the lane addresses (lanes 0..15; 16..31 repeat them),
// columns n..n+7. `lane_row` is the shared address of this lane's row.
__device__ __forceinline__ void ldmatrix_trans(uint32_t lane_row, int offset,
                                               uint32_t& b0, uint32_t& b1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(lane_row + (uint32_t)(offset * 2)));
}

// The A fragment of rows r..r+15 of a row-major bf16 tile with row stride
// RS, k-step kk (columns kk*16..+15); `base` points at row r + gq, column
// tq*2.
template <int RS>
__device__ __forceinline__ void load_a(const __nv_bfloat16* base, int kk,
                                       uint32_t* a) {
  a[0] = ld32(base + kk * 16);
  a[1] = ld32(base + 8 * RS + kk * 16);
  a[2] = ld32(base + kk * 16 + 8);
  a[3] = ld32(base + 8 * RS + kk * 16 + 8);
}

// ----------------------------------------------------------------------------
// Kernel 6: dQ.

// Byte offsets into dynamic shared memory (bf16 rows padded by 8):
//   q, do: [kRows][D + 8] bf16 each
//   kv:    [stage][K|V][kKeys][D + 8] bf16, two stages
//   mask:  [stage][kKeys] bytes
struct DqSmem {
  size_t q, dout, kv, mask, total;
  __host__ __device__ explicit DqSmem(int d) {
    const size_t padded = (size_t)(d + 8) * 2;
    q = 0;
    dout = q + kRows * padded;
    kv = dout + kRows * padded;
    mask = kv + 2 * 2 * kKeys * padded;
    total = mask + 2 * kKeys;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dq, int h,
    int hkv, int sq, int sk, int sk_pad, int sq_pad, int causal, int q_offset,
    int window, float scale) {
  constexpr int RS = D + 8;
  constexpr int ND = D / 8;   // n-tiles of dQ
  constexpr int KD = D / 16;  // k-steps over the head dim
  constexpr int kRowChunks = D / 8;
  constexpr int kTileChunks = 2 * kKeys * kRowChunks;
  constexpr int kIssueIters = (kTileChunks + kThreads - 1) / kThreads;
  constexpr int NT = kKeys / 8;   // n-tiles of S per key tile
  constexpr int KS = kKeys / 16;  // k-steps of dS·K per key tile

  const int q0 = blockIdx.x * kRows;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (h / hkv);
  const int tid = threadIdx.x;
  const float scale_log2 = scale * kLog2e;

  const size_t bh = (size_t)b * h + head;
  const __nv_bfloat16* q_bh = q + bh * sq * D;
  const __nv_bfloat16* do_bh = dout + bh * sq * D;
  const __nv_bfloat16* k_bh = k + ((size_t)b * hkv + kv_head) * sk * D;
  const __nv_bfloat16* v_bh = v + ((size_t)b * hkv + kv_head) * sk * D;
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
  const DqSmem lay(D);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.q);
  __nv_bfloat16* do_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.dout);
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.kv);
  uint8_t* mask_s = smem_raw + lay.mask;

  auto issue = [&](int kt, int st) {
    const int k0 = kt * kKeys;
#pragma unroll
    for (int i = 0; i < kIssueIters; ++i) {
      const int e = tid + i * kThreads;
      if (e < kTileChunks) {
        const int is_v = e >= kKeys * kRowChunks;
        const int ee = e - is_v * kKeys * kRowChunks;
        const int j = ee / kRowChunks;
        const int c = (ee % kRowChunks) * 8;
        const int key = k0 + j;
        const bool live = key < sk;
        const __nv_bfloat16* src =
            (is_v ? v_bh : k_bh) + (live ? (size_t)key * D + c : 0);
        cp_async16(kv_s + ((st * 2 + is_v) * kKeys + j) * RS + c, src, live);
      }
    }
    if (mask_b != nullptr && tid < kKeys / 16)
      cp_async16(mask_s + st * kKeys + tid * 16, mask_b + k0 + tid * 16,
                 true);
    cp_async_commit();
  };

  // Q and dO rows; rows past Sq are zero. They join the first tile's group.
  for (int e = tid; e < 2 * kRows * kRowChunks; e += kThreads) {
    const int is_do = e >= kRows * kRowChunks;
    const int ee = e - is_do * kRows * kRowChunks;
    const int r = ee / kRowChunks;
    const int c = (ee % kRowChunks) * 8;
    const bool live = q0 + r < sq;
    const __nv_bfloat16* src = is_do ? do_bh : q_bh;
    cp_async16((is_do ? do_s : q_s) + r * RS + c,
               live ? src + (size_t)(q0 + r) * D + c : src, live);
  }
  if (nkt > 0) issue(kt_lo, 0);
  else cp_async_commit();

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int ra = warp * 16 + gq;
  const int rb = ra + 8;
  const int qpos_a = q0 + ra + q_offset;
  const int qpos_b = q0 + rb + q_offset;
  const int wpos_lo = q0 + warp * 16 + q_offset;
  const int wpos_hi = wpos_lo + 15;
  const bool warp_live = warp * 16 < rows_here;
  // Rows a and b's lse in log2 units, delta, and whether the row sees a
  // key at all (q0 + rb < Sq_pad: the padded rows hold NEG_INF and 0).
  const float* lse_bh = lse + bh * sq_pad;
  const float* delta_bh = delta + bh * sq_pad;
  const float lse_a = lse_bh[q0 + ra], lse_b = lse_bh[q0 + rb];
  const bool live_a = lse_a > kNegInf * 0.5f;
  const bool live_b = lse_b > kNegInf * 0.5f;
  const float lse2_a = lse_a * kLog2e, lse2_b = lse_b * kLog2e;
  const float delta_a = delta_bh[q0 + ra], delta_b = delta_bh[q0 + rb];

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int i = 0; i < nkt; ++i) {
    const int st = i & 1;
    const int k0 = (kt_lo + i) * kKeys;
    if (i + 1 < nkt) {
      issue(kt_lo + i + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const bool dead = !warp_live || (causal && k0 > wpos_hi) ||
                      (window > 0 && k0 + kKeys - 1 <= wpos_lo - window);
    const bool interior = mask_b == nullptr && k0 + kKeys <= sk &&
                          (!causal || k0 + kKeys - 1 <= wpos_lo) &&
                          (window <= 0 || k0 > wpos_hi - window);
    if (!dead) {
      const __nv_bfloat16* k_t = kv_s + st * 2 * kKeys * RS;
      const __nv_bfloat16* v_t = k_t + kKeys * RS;
      const uint8_t* mask_t = mask_s + st * kKeys;
      // S = Q·Kᵀ and dP = dO·Vᵀ for this warp's 16 rows × 64 keys.
      float sc[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      }
      const __nv_bfloat16* qa = q_s + ra * RS + tq * 2;
      const __nv_bfloat16* da = do_s + ra * RS + tq * 2;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a_q[4], a_do[4];
        load_a<RS>(qa, kk, a_q);
        load_a<RS>(da, kk, a_do);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int off = (nt * 8 + gq) * RS + kk * 16 + tq * 2;
          mma_bf16(sc[nt], a_q, ld32(k_t + off), ld32(k_t + off + 8));
          mma_bf16(dp[nt], a_do, ld32(v_t + off), ld32(v_t + off + 8));
        }
      }
      // dS = P ⊙ (dP − delta), packed as the A fragments of dS·K: element
      // (nt, e) is row a for e < 2, row b otherwise, at key
      // k0 + nt*8 + tq*2 + (e & 1).
      uint32_t pa[KS][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool row_b = e >= 2;
          bool ok = row_b ? live_b : live_a;
          if (!interior) {
            const int key = nt * 8 + tq * 2 + (e & 1);
            const int kpos = k0 + key;
            const int qpos = row_b ? qpos_b : qpos_a;
            ok = ok && kpos < sk && (mask_b == nullptr || mask_t[key] != 0) &&
                 (!causal || kpos <= qpos) &&
                 (window <= 0 || kpos > qpos - window);
          }
          const float p =
              ok ? exp2f(sc[nt][e] * scale_log2 - (row_b ? lse2_b : lse2_a))
                 : 0.f;
          ds[e] = p * (dp[nt][e] - (row_b ? delta_b : delta_a));
        }
        pa[nt / 2][(nt % 2) * 2] = pack_bf16(ds[0], ds[1]);
        pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dQ += dS·K, K[key][d] row-major transposed into the B fragment.
      const uint32_t k_lane = static_cast<uint32_t>(
          __cvta_generic_to_shared(k_t + (lane % 16) * RS));
#pragma unroll
      for (int n = 0; n < ND; ++n) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t b0, b1;
          ldmatrix_trans(k_lane, ks * 16 * RS + n * 8, b0, b1);
          mma_bf16(acc[n], pa[ks], b0, b1);
        }
      }
    }
    __syncthreads();  // the next iteration refills this tile's stage
  }
  cp_async_wait<0>();  // nkt == 0: the Q/dO loads are still in flight

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + (half ? rb : ra);
    if (row >= sq) continue;
    __nv_bfloat16* dst = dq + (bh * sq + row) * D + tq * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __floats2bfloat162_rn(
          acc[n][half * 2] * scale, acc[n][half * 2 + 1] * scale);
    }
  }
}

// ----------------------------------------------------------------------------
// Kernel 7: dK and dV, on wgmma.

// The wgmma products of one (key tile, q tile) pair: D = 64 or 128. The
// descriptors are those of the tiles' first bytes; a step adds its offset
// (in 16-byte units) to the start address field.
template <int D>
struct DkvMma {
  static constexpr int kTile = 64 * D * 2;  // bytes of a 64-row tile
  // Sᵀ = K·Qᵀ (or dPᵀ = V·dOᵀ) for 32 q rows: A the key tile, B 32 rows
  // of the q tile, both K-major over D; step kk covers D values 16kk …
  // 16kk + 15, 32 bytes into a 128-byte row, or the next column block
  // every 4 steps.
  static __device__ __forceinline__ void scores(float* d, uint64_t a_desc,
                                                uint64_t b_desc) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = ((kk / 4) * (64 * 128) + (kk % 4) * 32) >> 4;
      wgmma_ss_m64n32(d, a_desc + off, b_desc + off, kk > 0);
    }
  }
  // d += Pᵀ·dO (or dSᵀ·Q) over 32 q rows: A the packed fragments a[ks] of
  // 16 rows each, B those rows of the q tile MN-major (q rows the
  // reduction, D the columns), step ks starting 16 rows of 128 B further.
  static __device__ __forceinline__ void update(float* d, uint32_t (*a)[4],
                                                uint64_t b_desc) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint64_t desc = b_desc + ((ks * 16 * 128) >> 4);
      if constexpr (D == 128) wgmma_rs_m64n128(d, a[ks], desc);
      else wgmma_rs_m64n64(d, a[ks], desc);
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
//   k, v: [kKeys][D] bf16 each, 128-byte swizzled
//   qd:   [stage][Q|dO][kRows][D] bf16, two stages, 128-byte swizzled
//   ld:   [stage][lse|delta][kRows] f32
//   mask: [kKeys] bytes
// `total` adds 1024 bytes for aligning the base.
struct DkvSmem {
  size_t k, v, qd, ld, mask, total;
  __host__ __device__ explicit DkvSmem(int d) {
    const size_t tile = (size_t)64 * d * 2;
    k = 0;
    v = k + tile;
    qd = v + tile;
    ld = qd + 4 * tile;
    mask = ld + 2 * 2 * kRows * 4;
    total = mask + kKeys + 1024;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ mask, float* __restrict__ dk_part,
    float* __restrict__ dv_part, int b_count, int h, int hkv, int sq, int sk,
    int sk_pad, int sq_pad, int causal, int q_offset, int window,
    float scale) {
  using Mma = DkvMma<D>;
  constexpr int ND = D / 8;
  constexpr int kRowChunks = D / 8;
  constexpr int kLdChunks = 2 * kRows / 4;  // lse and delta
  constexpr int NH = 32 / 8;  // n-tiles of Sᵀ per half q tile

  // Key tile slowest, so the scheduler hands out every (batch row, q
  // head) of the lowest key tiles first: under causal those walk the most
  // q tiles, and the short ones fill in behind them.
  const int lin =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int k0 = lin / (h * b_count) * kKeys;
  const int b = lin % (h * b_count) / h;
  const int head = lin % h;
  const int kv_head = head / (h / hkv);
  const int tid = threadIdx.x;
  const float scale_log2 = scale * kLog2e;

  const size_t bkv = (size_t)b * hkv + kv_head;
  const size_t bh = (size_t)b * h + head;
  const __nv_bfloat16* k_bh = k + bkv * sk * D;
  const __nv_bfloat16* v_bh = v + bkv * sk * D;
  const __nv_bfloat16* q_bh = q + bh * sq * D;
  const __nv_bfloat16* do_bh = dout + bh * sq * D;
  const uint8_t* mask_b = mask ? mask + (size_t)b * sk_pad : nullptr;

  // The query rows that can see some key of this tile: [r_lo, r_hi].
  const int k_last = min(k0 + kKeys, sk) - 1;
  const int r_lo = causal ? max(0, k0 - q_offset) : 0;
  const int r_hi = window > 0 ? min(sq - 1, k_last + window - 1 - q_offset)
                              : sq - 1;
  const int qt_lo = r_lo / kRows;
  const int n_iter = r_hi >= r_lo ? r_hi / kRows - qt_lo + 1 : 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DkvSmem lay(D);
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t k_s = raw + (uint32_t)(base - smem_raw) + lay.k;
  const uint32_t v_s = k_s + Mma::kTile;
  const uint32_t qd_s = k_s + lay.qd;
  float* ld_s = reinterpret_cast<float*>(base + lay.ld);
  uint8_t* mask_s = base + lay.mask;

  // This thread's 16-byte chunk of a row and its first row: it copies
  // every kRowStep-th row from there, a multiple of 8 rows apart, so its
  // chunk lands at the same swizzled place in each and every address is
  // one base plus a constant.
  constexpr int kRowStep = kThreads / kRowChunks;  // 8 at D 128, 16 at D 64
  const int c_own = tid % kRowChunks;
  const int r_own = tid / kRowChunks;
  const uint32_t sw_own = sw128_offset<kRows>(r_own, c_own);

  // Q, dO, lse and delta of q tile qt_lo + it into stage st, one cp.async
  // group.
  auto issue = [&](int it, int st) {
    const int q0 = (qt_lo + it) * kRows + r_own;
    unsigned char* dst = base + lay.qd + st * 2 * Mma::kTile + sw_own;
    const size_t src = (size_t)q0 * D + c_own * 8;
#pragma unroll
    for (int i = 0; i < kRows / kRowStep; ++i) {
      const bool live = q0 + i * kRowStep < sq;
      const size_t at = live ? src + (size_t)i * kRowStep * D : 0;
      cp_async16(dst + i * kRowStep * 128, q_bh + at, live);
      cp_async16(dst + Mma::kTile + i * kRowStep * 128, do_bh + at, live);
    }
    if (tid < kLdChunks) {
      const int is_delta = tid >= kLdChunks / 2;
      const int c = (tid - is_delta * kLdChunks / 2) * 4;
      cp_async16(ld_s + (st * 2 + is_delta) * kRows + c,
                 (is_delta ? delta : lse) + bh * sq_pad + (q0 - r_own) + c,
                 true);
    }
    cp_async_commit();
  };

  // K and V rows of this tile (keys past Sk are zero) and the mask bytes;
  // they join the first iteration's group.
#pragma unroll
  for (int i = 0; i < kKeys / kRowStep; ++i) {
    const int j = k0 + r_own + i * kRowStep;
    const bool live = j < sk;
    const size_t at = live ? (size_t)j * D + c_own * 8 : 0;
    cp_async16(base + lay.k + sw_own + i * kRowStep * 128, k_bh + at, live);
    cp_async16(base + lay.k + Mma::kTile + sw_own + i * kRowStep * 128,
               v_bh + at, live);
  }
  if (mask_b != nullptr && tid < kKeys / 16)
    cp_async16(mask_s + tid * 16, mask_b + k0 + tid * 16, true);
  if (n_iter > 0) issue(0, 0);
  else cp_async_commit();

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tq = lane % 4;
  // This thread's key rows a and b: the rows of the wgmma accumulator
  // fragment (warp w holds rows 16w … 16w + 15, as mma.sync's C).
  const int ka = warp * 16 + lane / 4;
  const int kb = ka + 8;
  const int kpos_a = k0 + ka;
  const int kpos_b = k0 + kb;
  const int wk_lo = k0 + warp * 16;  // the warp's first and last keys
  const int wk_hi = wk_lo + 15;

  float dk_acc[ND * 4], dv_acc[ND * 4];
#pragma unroll
  for (int i = 0; i < ND * 4; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int st = it & 1;
    const int q0 = (qt_lo + it) * kRows;
    if (it + 1 < n_iter) {
      issue(it + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();

    // Positions of the tile's first and last rows; the CTA skips a tile
    // none of its keys can see (wgmma runs on all four warps or none).
    const int pos_lo = q0 + q_offset;
    const int pos_hi = pos_lo + kRows - 1;
    const bool cta_dead = (causal && k0 > pos_hi) ||
                          (window > 0 && k0 + kKeys - 1 <= pos_lo - window);
    const bool dead = wk_lo >= sk || (causal && wk_lo > pos_hi) ||
                      (window > 0 && wk_hi <= pos_lo - window);
    const bool interior = mask_b == nullptr && wk_hi < sk &&
                          (!causal || wk_hi <= pos_lo) &&
                          (window <= 0 || wk_lo > pos_hi - window);
    if (!cta_dead) {
      const uint32_t q_t = qd_s + st * 2 * Mma::kTile;
      const uint32_t do_t = q_t + Mma::kTile;
      const float* lse_t = ld_s + st * 2 * kRows;
      const float* delta_t = lse_t + kRows;
      // The tile in two halves of 32 q rows, so Sᵀ and dPᵀ take 32 f32
      // registers a thread beside the 128 of dK and dV.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t rows = half * 32 * 128;  // bytes into each q tile
        // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, 64 keys × 32 rows.
        float sc[NH * 4], dp[NH * 4];
        wgmma_fence();
        Mma::scores(sc, Mma::k_major(k_s), Mma::k_major(q_t + rows));
        Mma::scores(dp, Mma::k_major(v_s), Mma::k_major(do_t + rows));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<NH * 4>(sc);
        fence_regs<NH * 4>(dp);
        // Pᵀ and dSᵀ, packed as the A fragments of Pᵀ·dO and dSᵀ·Q:
        // element (nt, e) is key a for e < 2, key b otherwise, at row
        // q0 + half*32 + nt*8 + tq*2 + (e & 1).
        uint32_t pp[2][4], pd[2][4];
#pragma unroll
        for (int nt = 0; nt < NH; ++nt) {
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = half * 32 + nt * 8 + tq * 2 + (e & 1);
            const float l = lse_t[r];
            bool ok = !dead && l > kNegInf * 0.5f;
            if (!interior) {
              const int kpos = e >= 2 ? kpos_b : kpos_a;
              const int qpos = q0 + r + q_offset;
              ok = ok && kpos < sk &&
                   (mask_b == nullptr || mask_s[kpos - k0] != 0) &&
                   (!causal || kpos <= qpos) &&
                   (window <= 0 || kpos > qpos - window);
            }
            p[e] = ok ? exp2f(sc[nt * 4 + e] * scale_log2 - l * kLog2e)
                      : 0.f;
            ds[e] = p[e] * (dp[nt * 4 + e] - delta_t[r]);
          }
          pp[nt / 2][(nt % 2) * 2] = pack_bf16(p[0], p[1]);
          pp[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
          pd[nt / 2][(nt % 2) * 2] = pack_bf16(ds[0], ds[1]);
          pd[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        // dV += Pᵀ·dO and dK += dSᵀ·Q over these 32 rows.
        fence_regs<ND * 4>(dv_acc);
        fence_regs<ND * 4>(dk_acc);
        wgmma_fence();
        Mma::update(dv_acc, pp, Mma::mn_major(do_t + rows));
        Mma::update(dk_acc, pd, Mma::mn_major(q_t + rows));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<ND * 4>(dv_acc);
        fence_regs<ND * 4>(dk_acc);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }
  cp_async_wait<0>();  // n_iter == 0: the K/V loads are still in flight

  // This q head's share of dK (unscaled) and dV, in f32, for the group sum.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? kpos_b : kpos_a;
    if (key >= sk) continue;
    const size_t row = (bh * sk + key) * D + tq * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(dk_part + row + n * 8) =
          make_float2(dk_acc[n * 4 + half * 2], dk_acc[n * 4 + half * 2 + 1]);
      *reinterpret_cast<float2*>(dv_part + row + n * 8) =
          make_float2(dv_acc[n * 4 + half * 2], dv_acc[n * 4 + half * 2 + 1]);
    }
  }
}

// The GQA group sum of kernel 7: dk = scale · Σ_g dk_part[g] and
// dv = Σ_g dv_part[g] over the group's q heads g = 0 … G−1, always in that
// order, so the result is the same bit for bit on every run. One thread
// per 4 consecutive values of (B, Hkv, Sk, D).
__global__ void __launch_bounds__(256) flash_bwd_group_sum_kernel(
    const float4* __restrict__ dk_part, const float4* __restrict__ dv_part,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    size_t n4, int group, size_t head4, float scale) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  // i = (b·Hkv + kv_head)·head4 + j; q head kv_head·G + g's values of the
  // same (key, d) sit at ((b·Hkv + kv_head)·G + g)·head4 + j.
  const size_t src = i / head4 * group * head4 + i % head4;
  float4 sk4 = dk_part[src], sv4 = dv_part[src];
  for (int g = 1; g < group; ++g) {
    const float4 a = dk_part[src + g * head4], c = dv_part[src + g * head4];
    sk4.x += a.x; sk4.y += a.y; sk4.z += a.z; sk4.w += a.w;
    sv4.x += c.x; sv4.y += c.y; sv4.z += c.z; sv4.w += c.w;
  }
  uint2 ok, ov;
  ok.x = pack_bf16(sk4.x * scale, sk4.y * scale);
  ok.y = pack_bf16(sk4.z * scale, sk4.w * scale);
  ov.x = pack_bf16(sv4.x, sv4.y);
  ov.y = pack_bf16(sv4.z, sv4.w);
  reinterpret_cast<uint2*>(dk)[i] = ok;
  reinterpret_cast<uint2*>(dv)[i] = ov;
}

// ----------------------------------------------------------------------------
// Launch.

int check_shape(int b, int h, int hkv, int sq, int sk, int sk_pad,
                int sq_pad) {
  if (hkv <= 0 || h % hkv) return kErrGroup;
  if (b <= 0 || sq <= 0 || sk <= 0 || sk_pad < sk || sk_pad % kKeys ||
      sq_pad < sq || sq_pad % kRows || b > 65535 || h > 65535)
    return kErrShape;
  return 0;
}

template <typename Kernel>
int set_smem(Kernel fn, size_t smem) {
  if (smem > kMaxSmem) return kErrSmem;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* mask, void* dq,
              int b, int h, int hkv, int sq, int sk, int sk_pad, int sq_pad,
              int causal, int q_offset, int window, cudaStream_t stream) {
  const size_t smem = DqSmem(D).total;
  auto fn = flash_bwd_dq_kernel<D>;
  if (int err = set_smem(fn, smem)) return err;
  const dim3 grid(sq_pad / kRows, h, b);
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(dq), h, hkv, sq, sk, sk_pad, sq_pad, causal,
      q_offset, window, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* mask,
               void* dk_part, void* dv_part, void* dk, void* dv, int b, int h,
               int hkv, int sq, int sk, int sk_pad, int sq_pad, int causal,
               int q_offset, int window, cudaStream_t stream) {
  const size_t smem = DkvSmem(D).total;
  auto fn = flash_bwd_dkv_kernel<D>;
  if (int err = set_smem(fn, smem)) return err;
  const float scale = 1.0f / sqrtf((float)D);
  const dim3 grid((sk + kKeys - 1) / kKeys, h, b);
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      static_cast<float*>(dk_part), static_cast<float*>(dv_part), b, h, hkv,
      sq, sk, sk_pad, sq_pad, causal, q_offset, window, scale);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  const size_t head4 = (size_t)sk * D / 4;
  const size_t n4 = (size_t)b * hkv * head4;
  flash_bwd_group_sum_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0,
                               stream>>>(
      static_cast<const float4*>(dk_part), static_cast<const float4*>(dv_part),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n4,
      h / hkv, head4, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both launch on `stream` and return cudaGetLastError() (0 on success), or
// a negative code for a shape they do not take. They allocate nothing.
// q, dout (B, H, Sq, D), k, v (B, Hkv, Sk, D) bf16 contiguous; lse, delta
// (B, H, Sq_pad) f32; mask (B, Sk_pad) bytes or null; dq (B, H, Sq, D),
// dk, dv (B, Hkv, Sk, D) bf16; dk_part, dv_part (B, H, Sk, D) f32 scratch,
// written whole before they are read (the caller need not clear them).
int kftt_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* mask, void* dq, int b, int h, int hkv,
                      int sq, int sk, int sk_pad, int sq_pad, int d,
                      int causal, int q_offset, int window, void* stream) {
  if (int err = check_shape(b, h, hkv, sq, sk, sk_pad, sq_pad)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, mask, dq, b, h, hkv, sq,
                           sk, sk_pad, sq_pad, causal, q_offset, window, st);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, mask, dq, b, h, hkv,
                            sq, sk, sk_pad, sq_pad, causal, q_offset, window,
                            st);
    default:
      return kErrHeadDim;
  }
}

int kftt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* mask, void* dk_part, void* dv_part,
                       void* dk, void* dv, int b, int h, int hkv, int sq,
                       int sk, int sk_pad, int sq_pad, int d, int causal,
                       int q_offset, int window, void* stream) {
  if (int err = check_shape(b, h, hkv, sq, sk, sk_pad, sq_pad)) return err;
  if ((size_t)((sk + kKeys - 1) / kKeys) * h * b > 0x7fffffffu)
    return kErrShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, mask, dk_part,
                            dv_part, dk, dv, b, h, hkv, sq, sk, sk_pad,
                            sq_pad, causal, q_offset, window, st);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, mask, dk_part,
                             dv_part, dk, dv, b, h, hkv, sq, sk, sk_pad,
                             sq_pad, causal, q_offset, window, st);
    default:
      return kErrHeadDim;
  }
}

const char* kftt_error_string(int code) {
  switch (code) {
    case kErrHeadDim: return "head_dim must be 64 or 128";
    case kErrSmem: return "tile needs more shared memory than a block has";
    case kErrGroup: return "H must be a positive multiple of Hkv";
    case kErrShape:
      return "B, Sq, Sk must be >= 1, Sk_pad a multiple of 64 and Sq_pad a "
             "multiple of 64";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
