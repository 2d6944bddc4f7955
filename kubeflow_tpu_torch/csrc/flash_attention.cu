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
// 989 TFLOP/s); from Sq = Sk = 1024 up operations bind, since FLOPs grow
// with Sq·Sk and bytes with Sq + Sk. So the work must run on the tensor
// cores, and each K/V byte read from HBM must feed many query rows.
// What the design does about it:
// - one CTA per (64-row query tile, q head, batch row), 4 warps of 16 rows,
//   the k loop inside the CTA (CTAs run in no order; nothing carries
//   between them);
// - the math on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//   accumulate): S = Q·Kᵀ, an online softmax in exp2 units on the S
//   fragments in registers, O += P·V with V through ldmatrix.trans; the
//   output accumulator stays in registers for the whole loop;
// - key tiles of 64 with cp.async into two shared-memory stages, the next
//   tile's loads in flight while the current one is computed;
// - causal and window tiles that no row of the CTA can see are never
//   loaded (the loop runs over the tile's visible key range), tiles no row
//   of a warp can see are skipped by that warp, and tiles wholly visible
//   to a warp skip the per-element mask.
// Later work: wgmma and TMA, warp specialisation, and a CTA holding the
// whole GQA group of a kv head so K/V are read once for the group.
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

using kftt::cp_async16;
using kftt::cp_async_commit;
using kftt::cp_async_wait;
using kftt::ld32;
using kftt::mma_bf16;
using kftt::pack_bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows of one CTA
constexpr int kKeys = 64;           // keys per tile
constexpr size_t kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;   // lse of a row with no visible key

enum : int {
  kErrHeadDim = -1,
  kErrSmem = -2,
  kErrGroup = -3,
  kErrShape = -4,
};

// Byte offsets into dynamic shared memory. bf16 rows are padded by 8
// elements (16 bytes), as in ragged_attention.cu.
//   q:    [kRows][D + 8] bf16
//   kv:   [stage][K|V][kKeys][D + 8] bf16, two stages
//   mask: [stage][kKeys] kv_mask bytes
struct Smem {
  size_t q, kv, mask, total;
  __host__ __device__ explicit Smem(int d) {
    const size_t padded = (size_t)(d + 8) * 2;
    q = 0;
    kv = q + kRows * padded;
    mask = kv + 2 * 2 * kKeys * padded;
    total = mask + 2 * kKeys;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int h, int hkv,
    int sq, int sk, int sk_pad, int causal, int q_offset, int window,
    float scale) {
  constexpr int RS = D + 8;          // padded bf16 row, elements
  constexpr int ND = D / 8;          // n-tiles of the output
  constexpr int kRowChunks = D / 8;  // 16-byte chunks per row
  constexpr int kTileChunks = 2 * kKeys * kRowChunks;  // K and V
  constexpr int kIssueIters = (kTileChunks + kThreads - 1) / kThreads;
  constexpr int NT = kKeys / 8;   // n-tiles of S per key tile
  constexpr int KS = kKeys / 16;  // k-steps of P·V per key tile

  const int q0 = blockIdx.x * kRows;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (h / hkv);
  const int tid = threadIdx.x;
  // Scores in log2 units, so the softmax's exponentials are exp2.
  const float scale_log2 = scale * 1.4426950408889634f;

  const size_t bh = (size_t)b * h + head;
  const __nv_bfloat16* q_bh = q + bh * sq * D;
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
  const Smem lay(D);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.q);
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.kv);
  uint8_t* mask_s = smem_raw + lay.mask;

  // Issue the cp.async loads of key tile kt into stage st and commit them
  // as one group; keys past Sk are zero-filled.
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

  // Query rows; rows past Sq are zero. They join the first tile's group.
  for (int e = tid; e < kRows * (D / 8); e += kThreads) {
    const int r = e / (D / 8);
    const int c = (e % (D / 8)) * 8;
    const bool live = q0 + r < sq;
    cp_async16(q_s + r * RS + c, live ? q_bh + (size_t)(q0 + r) * D + c : q_bh,
               live);
  }
  if (nkt > 0) issue(kt_lo, 0);
  else cp_async_commit();

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;  // fragment row within 8
  const int tq = lane % 4;  // fragment column pair
  const int ra = warp * 16 + gq;
  const int rb = ra + 8;
  const int qpos_a = q0 + ra + q_offset;
  const int qpos_b = q0 + rb + q_offset;
  // The warp's first and last query positions.
  const int wpos_lo = q0 + warp * 16 + q_offset;
  const int wpos_hi = wpos_lo + 15;
  const bool warp_live = warp * 16 < rows_here;

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max, rows a and b
  float l_a = 0.f, l_b = 0.f;              // this thread's partial sums

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

    // Tiles no row of this warp can see are skipped; tiles every row of
    // it sees whole skip the per-element mask.
    const bool dead = !warp_live || (causal && k0 > wpos_hi) ||
                      (window > 0 && k0 + kKeys - 1 <= wpos_lo - window);
    const bool interior = mask_b == nullptr && k0 + kKeys <= sk &&
                          (!causal || k0 + kKeys - 1 <= wpos_lo) &&
                          (window <= 0 || k0 > wpos_hi - window);
    if (!dead) {
      const __nv_bfloat16* k_t = kv_s + st * 2 * kKeys * RS;
      const __nv_bfloat16* v_t = k_t + kKeys * RS;
      const uint8_t* mask_t = mask_s + st * kKeys;
      // S = Q·Kᵀ for this warp's 16 rows × 64 keys.
      float sc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const __nv_bfloat16* qa = q_s + ra * RS + tq * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        a[0] = ld32(qa + kk * 16);
        a[1] = ld32(qa + 8 * RS + kk * 16);
        a[2] = ld32(qa + kk * 16 + 8);
        a[3] = ld32(qa + 8 * RS + kk * 16 + 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const __nv_bfloat16* kb = k_t + (nt * 8 + gq) * RS + kk * 16 + tq * 2;
          mma_bf16(sc[nt], a, ld32(kb), ld32(kb + 8));
        }
      }
      // Scale, mask and the per-row tile max. Element (nt, e) is row a for
      // e < 2, row b otherwise, at key k0 + nt*8 + tq*2 + (e & 1).
      float bmax_a = -INFINITY, bmax_b = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool row_b = e >= 2;
          float x = sc[nt][e] * scale_log2;
          if (!interior) {
            const int key = nt * 8 + tq * 2 + (e & 1);
            const int kpos = k0 + key;
            const int qpos = row_b ? qpos_b : qpos_a;
            const bool ok = kpos < sk &&
                            (mask_b == nullptr || mask_t[key] != 0) &&
                            (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
            x = ok ? x : -INFINITY;
          }
          sc[nt][e] = x;
          if (row_b) bmax_b = fmaxf(bmax_b, x);
          else bmax_a = fmaxf(bmax_a, x);
        }
      }
      // The four lanes of a quad share a row.
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        bmax_a = fmaxf(bmax_a, __shfl_xor_sync(0xffffffffu, bmax_a, off));
        bmax_b = fmaxf(bmax_b, __shfl_xor_sync(0xffffffffu, bmax_b, off));
      }
      // Online softmax. A row with no visible key so far keeps m = -inf:
      // alpha and p are pinned to 0, never NaN.
      const float mn_a = fmaxf(m_a, bmax_a);
      const float mn_b = fmaxf(m_b, bmax_b);
      const float al_a = mn_a == -INFINITY ? 0.f : exp2f(m_a - mn_a);
      const float al_b = mn_b == -INFINITY ? 0.f : exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
      // P in bf16 as the A fragments of P·V: k-step ks covers keys
      // ks*16 .. +15, i.e. S n-tiles 2ks (a0, a1) and 2ks+1 (a2, a3).
      uint32_t pa[KS][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mn = e >= 2 ? mn_b : mn_a;
          p[e] = mn == -INFINITY ? 0.f : exp2f(sc[nt][e] - mn);
        }
        sum_a += p[0] + p[1];
        sum_b += p[2] + p[3];
        pa[nt / 2][(nt % 2) * 2] = pack_bf16(p[0], p[1]);
        pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
      // ldmatrix row address of this lane in the V tile (rows 0..15 of a
      // k-step; lanes 16..31 repeat them, their addresses are not read).
      const uint32_t v_lane = static_cast<uint32_t>(
          __cvta_generic_to_shared(v_t + (lane % 16) * RS));
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= al_a;
        o[n][1] *= al_a;
        o[n][2] *= al_b;
        o[n][3] *= al_b;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          // V[key][d] row-major, transposed into the B fragment.
          uint32_t b0, b1;
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
              : "=r"(b0), "=r"(b1)
              : "r"(v_lane + (uint32_t)((ks * 16 * RS + n * 8) * 2)));
          mma_bf16(o[n], pa[ks], b0, b1);
        }
      }
    }
    __syncthreads();  // the next iteration refills this tile's stage
  }
  cp_async_wait<0>();  // nkt == 0: the query loads are still in flight

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + (half ? rb : ra);
    if (row >= sq) continue;
    const float m = half ? m_b : m_a;
    const float l = half ? l_b : l_a;
    // A row that saw no key has o = 0 (every p was pinned to 0).
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* dst = out + (bh * sq + row) * D + tq * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __floats2bfloat162_rn(
          o[n][half * 2] * inv, o[n][half * 2 + 1] * inv);
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
  const size_t smem = Smem(D).total;
  auto fn = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kRows - 1) / kRows, h, b);
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), h, hkv, sq, sk, sk_pad, causal, q_offset,
      window, 1.0f / sqrtf((float)D));
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
      b > 65535 || h > 65535)
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
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
