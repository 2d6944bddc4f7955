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
// Head dims 64, 128 and 256.
//
// What bounds it on this card: at the training shape (B 1, H 32, Hkv 8,
// S 2048, D 128, causal) dq does 6·D FLOPs per visible (row, key) pair and
// dk/dv 8·D, 5.2e10 and 6.9e10 FLOPs against ~60 MB and ~51 MB of inputs
// and outputs: both are bound by operations (0.0521 and 0.0695 ms at
// 989 TFLOP/s), so the products run on Hopper's warpgroup tensor-core
// products (wgmma) and every K/V (dq) or Q/dO (dk/dv) byte loaded into
// shared memory feeds 64 rows or keys. Both kernels keep their tiles in
// the canonical 128-byte-swizzled layout of wgmma (column blocks of 64
// values, the 16-byte chunk index XOR row % 8, applied by TMA in dQ and by
// the cp.async writes in dK/dV), which serves the K-major and the MN-major
// reads alike. The m64
// accumulator fragment of one product is the register A fragment of the
// next, so P and dS go from the scores to the updates without a trip
// through shared memory. What the design does about it:
// - dQ (kernel 6, replacing _bwd_dq_kernel, which sweeps q and key blocks
//   in its grid with a VMEM accumulator): one CTA per (64-row query tile,
//   q head, batch row): one warpgroup of 4 warps computes and a fifth warp
//   copies; the block order puts the q tile slowest and the last first, so
//   under causal the longest CTAs start first and the short ones fill the
//   SMs behind them. The copying warp's one thread moves Q and dO once,
//   then each 64-key K and V tile, with the Tensor Memory Accelerator
//   (3-D tensor maps over (planes, rows, D), 64 × 64 boxes, rows past Sq
//   or Sk filled with zeros by the hardware) and the tile's mask bytes
//   with a bulk copy, into two stages on `full` / `empty` mbarriers; the
//   warpgroup issues no copy, proxy fence or block-wide barrier in its
//   loop (12% faster than the warpgroup's own cp.async copies, measured).
//   S = Q·Kᵀ and dP = dO·Vᵀ are wgmma with
//   both operands in shared memory, K-major over D; dS = P ⊙ (dP − delta)
//   is made on the accumulator fragments and packed to bf16 into the A
//   fragments of dQ += dS·K, wgmma m64nDk16 (two m64n128 at D 256) whose
//   B, K, is read MN-major (keys the reduction) from the same tile. dQ
//   stays in registers (64 f32 a thread at D 128, 128 at D 256) and is
//   scaled and rounded to bf16 once. At D 256 each key tile goes in two
//   halves of 32 keys, so S and dP take 16 + 16 registers beside dQ's 128;
//   at D 64 and 128 a tile is one step of 64 keys;
// - dK/dV (kernel 7, replacing _bwd_dkv_kernel, which sweeps each kv
//   head's GQA group in its grid into one VMEM scratch): one CTA per
//   (64-key tile, q head, batch row, and at D 256 half of D), one
//   warpgroup. K and V stay in shared memory; the CTA walks only its own q
//   head's q tiles that can see the key tile, Q/dO/lse/delta streaming
//   through two cp.async stages. Each 64-row q tile goes in two halves of
//   32 rows: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ as wgmma m64n32k16 (A = K or V, B =
//   the Q or dO rows, both K-major over D); Pᵀ and dSᵀ are made in
//   registers and packed straight into the A fragments of dV += Pᵀ·dO and
//   dK += dSᵀ·Q, wgmma m64n128k16 (n64 at D 64) whose B, dO or Q, is read
//   MN-major from the same tiles. The halves keep Sᵀ and dPᵀ at 32 f32
//   registers a thread beside dK and dV's 128, so nothing spills. dK and
//   dV of 64 keys × 256 would take 256 f32 a thread: at D 256 each CTA
//   computes Sᵀ and dPᵀ over the whole head dim but accumulates only its
//   own 128 columns of dK and dV, so its registers are D 128's, at the
//   cost of computing Sᵀ and dPᵀ in both halves (12·D FLOPs a pair instead
//   of 8·D).
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
//   (each loop runs over the visible range, so the warpgroup issues every
//   product); a warp whose rows (dQ) or keys (dK/dV) see none of a step
//   takes P = dS = 0 without the exponentials, and steps wholly visible to
//   a warp skip the per-element mask.
// Registers are the hard limit: the compiler hoists copy addresses and
// wgmma descriptors out of the loops into registers the accumulators need.
// So each thread of dK/dV copies one 16-byte chunk of every 8th row
// (addresses one base plus constants), descriptors are rebuilt each step
// from an address the compiler cannot see through (`opaque`), and
// `fence_regs` pins the accumulators around each product: no kernel
// spills at any head dim.
// P and dS are rounded to bf16 once each, as operands of the products;
// p itself stays in f32 for ds, as in the JAX kernels.
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

using kftt::bulk_load;
using kftt::cp_async16;
using kftt::cp_async_commit;
using kftt::cp_async_wait;
using kftt::fence_async_shared;
using kftt::fence_mbar_init;
using kftt::fence_regs;
using kftt::mbar_arrive;
using kftt::mbar_expect_tx;
using kftt::mbar_init;
using kftt::mbar_wait;
using kftt::opaque;
using kftt::pack_bf16;
using kftt::sw128_desc;
using kftt::sw128_offset;
using kftt::tensor_map;
using kftt::tma_load_3d;
using kftt::wgmma_commit;
using kftt::wgmma_fence;
using kftt::wgmma_rs_m64n128;
using kftt::wgmma_rs_m64n64;
using kftt::wgmma_ss_m64n32;
using kftt::wgmma_ss_m64n64;
using kftt::wgmma_wait;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // query rows of a tile
constexpr int kKeys = 64;      // keys of a tile
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

// K-major tiles: 8 rows of 128 B per stride step (LBO unused).
__device__ __forceinline__ uint64_t k_major(uint32_t addr) {
  return sw128_desc(opaque(addr), 16, 1024);
}
// MN-major tiles: 8 rows of 128 B per stride step, column blocks of 64
// values 64 · 128 B apart.
__device__ __forceinline__ uint64_t mn_major(uint32_t addr) {
  return sw128_desc(opaque(addr), 64 * 128, 1024);
}

// S (+)= A·Bᵀ over the head dim for 64 rows of A and N rows of B (32 or
// 64), both K-major 64-row tiles; step kk covers D values 16kk … 16kk + 15,
// 32 bytes into a 128-byte row, or the next column block every 4 steps.
template <int D, int N>
__device__ __forceinline__ void scores(float* s, uint64_t a_desc,
                                       uint64_t b_desc) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = ((kk / 4) * (64 * 128) + (kk % 4) * 32) >> 4;
    if constexpr (N == 64) wgmma_ss_m64n64(s, a_desc + off, b_desc + off, kk > 0);
    else wgmma_ss_m64n32(s, a_desc + off, b_desc + off, kk > 0);
  }
}

// d += A·B over R rows of B (the reduction; R / 16 steps): A the packed
// fragments a[ks] of 16 rows each, B those rows of a tile read MN-major
// (N columns from the descriptor's column block on), step ks starting 16
// rows of 128 B further. N = 256 is two n128 products on the halves, two
// column blocks (2 · 64 · 128 B) apart.
template <int N, int R>
__device__ __forceinline__ void update(float* d, uint32_t (*a)[4],
                                       uint64_t b_desc) {
#pragma unroll
  for (int ks = 0; ks < R / 16; ++ks) {
    const uint64_t desc = b_desc + ((ks * 16 * 128) >> 4);
    if constexpr (N == 64) {
      wgmma_rs_m64n64(d, a[ks], desc);
    } else {
      wgmma_rs_m64n128(d, a[ks], desc);
      if constexpr (N == 256)
        wgmma_rs_m64n128(d + 64, a[ks], desc + ((2 * 64 * 128) >> 4));
    }
  }
}

// A thread's share of the cp.async copy of two [64][D] bf16 tiles (Q and
// dO, or K and V) into the 128-byte-swizzled layout, the second tile kTile
// bytes after the first: chunk c_own (and at D 256 also chunk c_own + 16,
// two column blocks further) of every kRowStep-th row from r_own, the two
// tiles' rows in turn. kRowStep is a multiple of 8, so the chunk lands at
// the same swizzled place in every row it copies and each address is a
// base plus constants.
template <int D>
struct PairCopy {
  static constexpr int kTile = 64 * D * 2;
  static constexpr int kChunks = D / 8 < 16 ? D / 8 : 16;
  static constexpr int kPasses = D / 8 / kChunks;       // 2 at D 256, else 1
  static constexpr int kRowStep = kThreads / kChunks;  // 16 at D 64, else 8
  const int r_own, c_own;
  const uint32_t sw_own;
  __device__ explicit PairCopy(int tid)
      : r_own(tid / kChunks),
        c_own(tid % kChunks),
        sw_own(sw128_offset<64>(tid / kChunks, tid % kChunks)) {}
  // Rows row0 … row0 + 63 of a and of b (rows of D values; zeros from row
  // `rows` on) into the tiles at dst.
  __device__ __forceinline__ void copy(unsigned char* dst,
                                       const __nv_bfloat16* a,
                                       const __nv_bfloat16* b, int row0,
                                       int rows) const {
    const int r = row0 + r_own;
    const size_t src = (size_t)r * D + c_own * 8;
    dst += sw_own;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
#pragma unroll
      for (int i = 0; i < 64 / kRowStep; ++i) {
        const bool live = r + i * kRowStep < rows;
        const size_t at = live ? src + (size_t)i * kRowStep * D + p * 128 : 0;
        const int to = p * 2 * 64 * 128 + i * kRowStep * 128;
        cp_async16(dst + to, a + at, live);
        cp_async16(dst + kTile + to, b + at, live);
      }
    }
  }
};

// ----------------------------------------------------------------------------
// Kernel 6: dQ, on wgmma.

// Byte offsets from a 1024-byte-aligned base in dynamic shared memory:
//   q, dout: [kRows][D] bf16 each, 128-byte swizzled
//   kv:      [stage][K|V][kKeys][D] bf16, two stages, 128-byte swizzled
//   mask:    [stage][kKeys] bytes
//   bar:     full[2], empty[2] and q mbarriers, 8 bytes each
// `total` adds 1024 bytes for aligning the base.
struct DqSmem {
  size_t q, dout, kv, mask, bar, total;
  __host__ __device__ explicit DqSmem(int d) {
    const size_t tile = (size_t)64 * d * 2;
    q = 0;
    dout = q + tile;
    kv = dout + tile;
    mask = kv + 4 * tile;
    bar = mask + 2 * kKeys;
    total = bar + 5 * 8 + 1024;
  }
};

constexpr int kDqThreads = kThreads + 32;  // a warpgroup and a copying warp

template <int D>
__global__ void __launch_bounds__(kDqThreads) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dq,
    int b_count, int h, int hkv, int sq, int sk, int sk_pad, int sq_pad,
    int causal, int q_offset, int window, float scale) {
  constexpr int kTile = 64 * D * 2;  // bytes of a 64-row tile
  constexpr int kBlocks = D / 64;    // 64-column blocks (TMA boxes) a tile
  constexpr int ND = D / 8;          // n-tiles of dQ
  // Keys of one step: at D 256 a tile goes in two halves, so S and dP
  // take 16 f32 registers each beside dQ's 128.
  constexpr int KS = D == 256 ? 32 : 64;
  constexpr int NT = KS / 8;  // n-tiles of S in a step

  // The q tile slowest in the block order and the last (under causal the
  // longest) first; the heads of one kv head stay neighbours, reading the
  // same K/V from L2.
  const int lin =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int q0 = (gridDim.x - 1 - lin / (h * b_count)) * kRows;
  const int b = lin % (h * b_count) / h;
  const int head = lin % h;
  const int bkv = b * hkv + head / (h / hkv);
  const int tid = threadIdx.x;
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
  const DqSmem lay(D);
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base_s = raw + (uint32_t)(base - smem_raw);
  const uint32_t q_s = base_s + lay.q;
  const uint32_t do_s = base_s + lay.dout;
  const uint8_t* mask_s = base + lay.mask;
  // full[st]: stage st holds its tile; empty[st]: the warpgroup is done
  // with it; q_bar: Q and dO have landed.
  auto full = [&](int st) { return base_s + lay.bar + 8 * st; };
  auto empty = [&](int st) { return base_s + lay.bar + 16 + 8 * st; };
  const uint32_t q_bar = base_s + lay.bar + 32;
  auto k_tile = [&](int st) { return base_s + lay.kv + st * 2 * kTile; };

  if (tid == 0) {
    for (int st = 0; st < 2; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kThreads);
    }
    mbar_init(q_bar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  // The copying warp: one thread issues the TMA copies of Q and dO and
  // then of each key tile's K and V (and a bulk copy of its mask bytes)
  // into the stages in turn, waiting for a stage to be released before
  // refilling it. Rows past Sq and keys past Sk come in as zeros. A CTA
  // whose rows see no key loads nothing and writes zeros.
  if (tid >= kThreads) {
    if (tid == kThreads && nkt > 0) {
      mbar_expect_tx(q_bar, 2 * kTile);
      for (int c = 0; c < kBlocks; ++c) {
        tma_load_3d(q_s + c * 64 * 128, &q_map, c * 64, q0, (int)bh, q_bar);
        tma_load_3d(do_s + c * 64 * 128, &do_map, c * 64, q0, (int)bh, q_bar);
      }
      for (int i = 0; i < nkt; ++i) {
        const int st = i & 1;
        const int k0 = (kt_lo + i) * kKeys;
        if (i >= 2) mbar_wait(empty(st), ((i >> 1) - 1) & 1);
        mbar_expect_tx(full(st), 2 * kTile + (mask_b != nullptr ? kKeys : 0));
        for (int c = 0; c < kBlocks; ++c) {
          tma_load_3d(k_tile(st) + c * 64 * 128, &k_map, c * 64, k0, bkv,
                      full(st));
          tma_load_3d(k_tile(st) + kTile + c * 64 * 128, &v_map, c * 64, k0,
                      bkv, full(st));
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
  const int wpos_lo = q0 + warp * 16 + q_offset;  // the warp's first and
  const int wpos_hi = wpos_lo + 15;               // last positions
  // Rows a and b's lse in log2 units, delta, and whether the row sees a
  // key at all (rows up to Sq_pad exist: the pad holds NEG_INF and 0).
  const float* lse_bh = lse + bh * sq_pad;
  const float* delta_bh = delta + bh * sq_pad;
  const float lse_a = lse_bh[q0 + ra], lse_b = lse_bh[q0 + ra + 8];
  const bool live_a = lse_a > kNegInf * 0.5f;
  const bool live_b = lse_b > kNegInf * 0.5f;
  const float lse2_a = lse_a * kLog2e, lse2_b = lse_b * kLog2e;
  const float delta_a = delta_bh[q0 + ra], delta_b = delta_bh[q0 + ra + 8];

  float acc[ND * 4];
#pragma unroll
  for (int i = 0; i < ND * 4; ++i) acc[i] = 0.f;

  if (nkt > 0) mbar_wait(q_bar, 0);
  for (int i = 0; i < nkt; ++i) {
    const int st = i & 1;
    const int k0 = (kt_lo + i) * kKeys;
    mbar_wait(full(st), (i >> 1) & 1);

    const uint32_t k_t = k_tile(st);
    const uint32_t v_t = k_t + kTile;
    const uint8_t* mask_t = mask_s + st * kKeys;
#pragma unroll
    for (int half = 0; half < kKeys / KS; ++half) {
      const uint32_t keys = half * KS * 128;  // bytes into each key tile
      const int s0 = k0 + half * KS;          // the step's first key
      // S = Q·Kᵀ and dP = dO·Vᵀ, 64 rows × KS keys.
      float s[NT * 4], dp[NT * 4];
      wgmma_fence();
      scores<D, KS>(s, k_major(q_s), k_major(k_t + keys));
      scores<D, KS>(dp, k_major(do_s), k_major(v_t + keys));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NT * 4>(s);
      fence_regs<NT * 4>(dp);

      // A warp none of whose rows sees a key of the step takes dS = 0;
      // one whose rows see all of them skips the per-element mask.
      const bool dead = s0 >= sk || (causal && s0 > wpos_hi) ||
                        (window > 0 && s0 + KS - 1 <= wpos_lo - window);
      const bool interior = mask_b == nullptr && s0 + KS <= sk &&
                            (!causal || s0 + KS - 1 <= wpos_lo) &&
                            (window <= 0 || s0 > wpos_hi - window);
      // dS = P ⊙ (dP − delta), packed as the A fragments of dS·K: element
      // (nt, e) is row a for e < 2, row b otherwise, at key
      // s0 + nt*8 + tq*2 + (e & 1); k-step j covers n-tiles 2j and 2j + 1.
      uint32_t pa[KS / 16][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool row_b = e >= 2;
          bool ok = !dead && (row_b ? live_b : live_a);
          if (!interior) {
            const int key = half * KS + nt * 8 + tq * 2 + (e & 1);
            const int kpos = k0 + key;
            const int qpos = row_b ? qpos_b : qpos_a;
            ok = ok && kpos < sk && (mask_b == nullptr || mask_t[key] != 0) &&
                 (!causal || kpos <= qpos) &&
                 (window <= 0 || kpos > qpos - window);
          }
          const float p =
              ok ? exp2f(s[nt * 4 + e] * scale_log2 - (row_b ? lse2_b : lse2_a))
                 : 0.f;
          ds[e] = p * (dp[nt * 4 + e] - (row_b ? delta_b : delta_a));
        }
        pa[nt / 2][(nt % 2) * 2] = pack_bf16(ds[0], ds[1]);
        pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dQ += dS·K over the step's keys, K read MN-major.
      fence_regs<ND * 4>(acc);
      wgmma_fence();
      update<D, KS>(acc, pa, mn_major(k_t + keys));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<ND * 4>(acc);
    }
    mbar_arrive(empty(st));  // this stage may be refilled
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + ra + half * 8;
    if (row >= sq) continue;
    __nv_bfloat16* dst = dq + (bh * sq + row) * D + tq * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __floats2bfloat162_rn(
          acc[n * 4 + half * 2] * scale, acc[n * 4 + half * 2 + 1] * scale);
    }
  }
}

// ----------------------------------------------------------------------------
// Kernel 7: dK and dV, on wgmma.

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

// The columns of dK and dV one CTA accumulates: all of D up to 128, one
// half of D 256.
template <int D>
__host__ __device__ constexpr int dkv_cols() {
  return D < 128 ? D : 128;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ mask, float* __restrict__ dk_part,
    float* __restrict__ dv_part, int b_count, int h, int hkv, int sq, int sk,
    int sk_pad, int sq_pad, int causal, int q_offset, int window,
    float scale) {
  constexpr int kTile = 64 * D * 2;  // bytes of a 64-row tile
  constexpr int DC = dkv_cols<D>();  // columns of dK and dV of this CTA
  constexpr int NSPLIT = D / DC;     // CTAs over one key tile's columns
  constexpr int ND = DC / 8;
  constexpr int kLdChunks = 2 * kRows / 4;  // lse and delta
  constexpr int NH = 32 / 8;  // n-tiles of Sᵀ per half q tile

  // Key tile slowest, so the scheduler hands out every (batch row, q
  // head, column half) of the lowest key tiles first: under causal those
  // walk the most q tiles, and the short ones fill in behind them.
  const int lin =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int per_tile = h * b_count * NSPLIT;
  const int k0 = lin / per_tile * kKeys;
  const int col0 = lin % NSPLIT * DC;  // this CTA's first column of dK, dV
  const int b = lin % per_tile / NSPLIT / h;
  const int head = lin / NSPLIT % h;
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
  const uint32_t v_s = k_s + kTile;
  const uint32_t qd_s = k_s + lay.qd;
  float* ld_s = reinterpret_cast<float*>(base + lay.ld);
  uint8_t* mask_s = base + lay.mask;
  const PairCopy<D> pair(tid);

  // Q, dO, lse and delta of q tile qt_lo + it into stage st, one cp.async
  // group.
  auto issue = [&](int it, int st) {
    const int q0 = (qt_lo + it) * kRows;
    pair.copy(base + lay.qd + st * 2 * kTile, q_bh, do_bh, q0, sq);
    if (tid < kLdChunks) {
      const int is_delta = tid >= kLdChunks / 2;
      const int c = (tid - is_delta * kLdChunks / 2) * 4;
      cp_async16(ld_s + (st * 2 + is_delta) * kRows + c,
                 (is_delta ? delta : lse) + bh * sq_pad + q0 + c, true);
    }
    cp_async_commit();
  };

  // K and V rows of this tile (keys past Sk are zero) and the mask bytes;
  // they join the first iteration's group.
  pair.copy(base + lay.k, k_bh, v_bh, k0, sk);
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
      const uint32_t q_t = qd_s + st * 2 * kTile;
      const uint32_t do_t = q_t + kTile;
      // This CTA's columns of Q and dO: col0 / 64 column blocks in.
      const uint32_t cols = col0 / 64 * (64 * 128);
      const float* lse_t = ld_s + st * 2 * kRows;
      const float* delta_t = lse_t + kRows;
      // The tile in two halves of 32 q rows, so Sᵀ and dPᵀ take 32 f32
      // registers a thread beside the 128 of dK and dV.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t rows = half * 32 * 128;  // bytes into each q tile
        // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, 64 keys × 32 rows, over all of D.
        float sc[NH * 4], dp[NH * 4];
        wgmma_fence();
        scores<D, 32>(sc, k_major(k_s), k_major(q_t + rows));
        scores<D, 32>(dp, k_major(v_s), k_major(do_t + rows));
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
        // dV += Pᵀ·dO and dK += dSᵀ·Q over these 32 rows, this CTA's
        // columns.
        fence_regs<ND * 4>(dv_acc);
        fence_regs<ND * 4>(dk_acc);
        wgmma_fence();
        update<DC, 32>(dv_acc, pp, mn_major(do_t + cols + rows));
        update<DC, 32>(dk_acc, pd, mn_major(q_t + cols + rows));
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
    const size_t row = (bh * sk + key) * D + col0 + tq * 2;
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
  CUtensorMap q_map, do_map, k_map, v_map;
  if (!tensor_map(&q_map, q, D, sq, b * h) ||
      !tensor_map(&do_map, dout, D, sq, b * h) ||
      !tensor_map(&k_map, k, D, sk, b * hkv) ||
      !tensor_map(&v_map, v, D, sk, b * hkv))
    return kErrTensorMap;
  const size_t smem = DqSmem(D).total;
  auto fn = flash_bwd_dq_kernel<D>;
  if (int err = set_smem(fn, smem)) return err;
  const dim3 grid(sq_pad / kRows, h, b);
  fn<<<grid, kDqThreads, smem, stream>>>(
      q_map, do_map, k_map, v_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(dq), b, h, hkv, sq, sk, sk_pad, sq_pad,
      causal, q_offset, window, 1.0f / sqrtf((float)D));
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
  const dim3 grid((sk + kKeys - 1) / kKeys * (D / dkv_cols<D>()), h, b);
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
  if ((size_t)(sq_pad / kRows) * h * b > 0x7fffffffu) return kErrShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, mask, dq, b, h, hkv, sq,
                           sk, sk_pad, sq_pad, causal, q_offset, window, st);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, mask, dq, b, h, hkv,
                            sq, sk, sk_pad, sq_pad, causal, q_offset, window,
                            st);
    case 256:
      return launch_dq<256>(q, k, v, dout, lse, delta, mask, dq, b, h, hkv,
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
  if ((size_t)((sk + kKeys - 1) / kKeys) * 2 * h * b > 0x7fffffffu)
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
    case 256:
      return launch_dkv<256>(q, k, v, dout, lse, delta, mask, dk_part,
                             dv_part, dk, dv, b, h, hkv, sq, sk, sk_pad,
                             sq_pad, causal, q_offset, window, st);
    default:
      return kErrHeadDim;
  }
}

const char* kftt_error_string(int code) {
  switch (code) {
    case kErrHeadDim: return "head_dim must be 64, 128 or 256";
    case kErrSmem: return "tile needs more shared memory than a block has";
    case kErrGroup: return "H must be a positive multiple of Hkv";
    case kErrShape:
      return "B, Sq, Sk must be >= 1, Sk_pad a multiple of 64 and Sq_pad a "
             "multiple of 64";
    case kErrTensorMap:
      return "cuTensorMapEncodeTiled is missing or refused a map";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
