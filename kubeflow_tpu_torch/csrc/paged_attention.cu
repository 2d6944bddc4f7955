// GQA decode attention for Hopper (sm_90a), plain C interface: one body,
// two ways to find a slot's keys.
//
// Replaces two Pallas TPU kernels of kubeflow_tpu/ops/paged_attention.py,
// which share their block loop (_attend) and differ only in where key
// block i of slot b lives:
// - paged_decode_kernel (kftt_paged_decode_attention) replaces _kernel,
//   called from paged_decode_attention: the keys are read through tables
//   (B, MAXB) from the block pools (NB, Hkv, BS, D) bf16, and kv_mask is
//   (B, MAXB*BS);
// - dense_decode_kernel (kftt_dense_decode_attention) replaces
//   _dense_kernel, called from dense_decode_attention: the keys of kv head h
//   are the contiguous rows ((b*Hkv + h)*C + k)*D of the per-slot caches
//   (B, Hkv, C, D) bf16, and kv_mask is (B, C).
// Both compute the same function: one new query token per slot, q (B, Hq,
// D), attends slot b's keys at positions k < seq_lens[b] where kv_mask
// allows, with f32 scores and an f32 online softmax. q head i reads kv
// head i / G (G = Hq / Hkv). A row whose keys are all masked comes out 0.
//
// What bounds it on this card: bytes. Each live K/V element is read once
// and used for G multiply-adds (G = 4 at llama-3-8b), ~4 FLOPs per byte,
// far below the ~295 FLOPs/byte where compute would bind; the floor is the
// live keys over HBM bandwidth (3.35 TB/s).
// What the design does about it:
// - one CTA per (slot, kv head) takes the kv head's G query rows, so each
//   key is read from HBM once for the whole group;
// - it walks only the slot's live keys: min(ceil(seq_len / BS), MAXB)
//   blocks through a copy of the table row in shared memory (paged), or
//   the first min(seq_len, C) rows of the slot's cache (dense); never past
//   the end, even for an idle slot's stale length;
// - keys are staged in tiles of 64 with 16-byte cp.async loads into two
//   shared-memory stages: the next tile is in flight while the current one
//   is computed, and a tile costs two barriers;
// - the 4 warps split each tile's keys, 16 each, and each keeps its own
//   online softmax in registers; their partial results are merged once, at
//   the end. The products run on the tensor cores (mma.sync m16n8k16, bf16
//   in, f32 accumulate; the G rows padded to 16), so a tile's math is a few
//   instructions per warp and the loop waits only on memory. The
//   probabilities are rounded to bf16 for P·V, as in the port's ragged
//   kernel.
// Later work: a split of long histories over several CTAs.

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
constexpr int kKeys = 16 * kWarps;  // keys per tile, 16 for each warp
constexpr int kRows = 16;           // query rows of one mma tile: G <= 16
constexpr size_t kMaxSmem = 232448;

enum : int {
  kErrHeadDim = -1,
  kErrSmem = -2,
  kErrGroup = -3,
};

// Byte offsets into dynamic shared memory. bf16 rows are padded by 8
// elements (16 bytes), as in ragged_attention.cu.
//   q:     [kRows][D + 8] bf16, rows past G zero
//   kv:    [stage][K|V][kKeys][D + 8] bf16, two stages
//   table: [MAXB] int, the slot's table row (paged only; MAXB = 0 dense)
// After the key loop the kv bytes hold the warps' partial results for the
// merge: [warp][D/8][4][32] f32 accumulators, then [warp][4][32] f32
// (m_a, m_b, l_a, l_b).
struct Smem {
  size_t q, kv, table, total;
  __host__ __device__ Smem(int d, int maxb) {
    const size_t padded = (size_t)(d + 8) * 2;
    q = 0;
    kv = q + kRows * padded;
    table = kv + 2 * 2 * kKeys * padded;
    total = table + (size_t)maxb * 4;
  }
};

// The shared body. kDense picks where key k of slot b, kv head h lives:
// row ((b*Hkv + h)*span + k) of the dense caches (span = C), or row
// (table[k / bs]*Hkv + h)*bs + k % bs of the pools (span = MAXB*bs).
template <int D, bool kDense>
__device__ __forceinline__ void decode_body(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_src,
    const __nv_bfloat16* __restrict__ v_src, const int* __restrict__ tables,
    const uint8_t* __restrict__ kv_mask, const int* __restrict__ seq_lens,
    __nv_bfloat16* __restrict__ out, int hq, int hkv, int bs, int maxb,
    int span, float scale) {
  constexpr int RS = D + 8;
  constexpr int ND = D / 8;  // n-tiles of the output
  constexpr int kRowChunks = D / 8;
  constexpr int kTileChunks = 2 * kKeys * kRowChunks;
  constexpr int kIssueIters = (kTileChunks + kThreads - 1) / kThreads;

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int group = hq / hkv;
  const int tid = threadIdx.x;
  const int seq_len = seq_lens[b];
  int nblk = 0, nkeys;
  if constexpr (kDense) {
    nkeys = seq_len > 0 ? min(seq_len, span) : 0;
  } else {
    nblk = seq_len > 0 ? min((seq_len + bs - 1) / bs, maxb) : 0;
    nkeys = nblk * bs;
  }
  const int ntiles = (nkeys + kKeys - 1) / kKeys;
  // Scores in log2 units, so the softmax's exponentials are exp2.
  const float scale_log2 = scale * 1.4426950408889634f;
  const uint8_t* mask_row = kv_mask + (size_t)b * span;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem lay(D, maxb);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.q);
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.kv);
  int* table_s = reinterpret_cast<int*>(smem_raw + lay.table);

  if constexpr (!kDense) {
    for (int i = tid; i < nblk; i += kThreads)
      table_s[i] = tables[(size_t)b * maxb + i];
  }
  // Query rows g < G: q head h*G + g; rows past G are zero. They join the
  // first tile's group.
  for (int e = tid; e < kRows * (D / 8); e += kThreads) {
    const int r = e / (D / 8);
    const int c = (e % (D / 8)) * 8;
    const bool live = r < group;
    cp_async16(q_s + r * RS + c,
               live ? q + ((size_t)b * hq + h * group + r) * D + c : q, live);
  }
  __syncthreads();  // table_s is read by every thread's loads

  // Issue the cp.async loads of key tile t into stage st as one group.
  // Keys past the live ones are zero-filled.
  auto issue = [&](int t, int st) {
#pragma unroll
    for (int i = 0; i < kIssueIters; ++i) {
      const int e = tid + i * kThreads;
      if (e < kTileChunks) {
        const int is_v = e >= kKeys * kRowChunks;
        const int ee = e - is_v * kKeys * kRowChunks;
        const int j = ee / kRowChunks;
        const int c = (ee % kRowChunks) * 8;
        const int kpos = t * kKeys + j;
        const bool live = kpos < nkeys;
        const __nv_bfloat16* src = is_v ? v_src : k_src;
        if (live) {
          size_t row;
          if constexpr (kDense)
            row = ((size_t)b * hkv + h) * span + kpos;
          else
            row = ((size_t)table_s[kpos / bs] * hkv + h) * bs + kpos % bs;
          src += row * D + c;
        }
        cp_async16(kv_s + ((st * 2 + is_v) * kKeys + j) * RS + c, src, live);
      }
    }
    cp_async_commit();
  };

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;  // fragment row within 8
  const int tq = lane % 4;  // fragment column pair
  const int key0 = warp * 16;  // this warp's keys within a tile

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max, rows gq, gq + 8
  float l_a = 0.f, l_b = 0.f;              // this thread's partial sums

  if (ntiles > 0) issue(0, 0);
  else cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    // The validity of this thread's four keys, read before the wait so
    // its latency hides behind the tile's loads: key
    // key0 + nt*8 + tq*2 + u for n-tile nt and u in {0, 1}.
    bool valid[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kpos = t * kKeys + key0 + nt * 8 + tq * 2 + u;
        valid[nt][u] = kpos < nkeys && kpos < seq_len && mask_row[kpos] != 0;
      }
    if (t + 1 < ntiles) {
      issue(t + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* k_t = kv_s + st * 2 * kKeys * RS;
    const __nv_bfloat16* v_t = k_t + kKeys * RS;

    // S = Q·Kᵀ for the 16 (padded) rows × this warp's 16 keys.
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    const __nv_bfloat16* qa = q_s + gq * RS + tq * 2;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      a[0] = ld32(qa + kk * 16);
      a[1] = ld32(qa + 8 * RS + kk * 16);
      a[2] = ld32(qa + kk * 16 + 8);
      a[3] = ld32(qa + 8 * RS + kk * 16 + 8);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const __nv_bfloat16* kb = k_t + (key0 + nt * 8 + gq) * RS + kk * 16 + tq * 2;
        mma_bf16(sc[nt], a, ld32(kb), ld32(kb + 8));
      }
    }
    // Scale, mask, and the per-row max over this warp's keys. Element
    // (nt, e) is row gq for e < 2, row gq + 8 otherwise.
    float bmax_a = -INFINITY, bmax_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = valid[nt][e & 1] ? sc[nt][e] * scale_log2 : -INFINITY;
        sc[nt][e] = x;
        if (e >= 2) bmax_b = fmaxf(bmax_b, x);
        else bmax_a = fmaxf(bmax_a, x);
      }
    }
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
    uint32_t pa[4];  // P as the A fragment of one 16-key k-step
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e >= 2 ? mn_b : mn_a;
        p[e] = mn == -INFINITY ? 0.f : exp2f(sc[nt][e] - mn);
      }
      sum_a += p[0] + p[1];
      sum_b += p[2] + p[3];
      pa[nt * 2] = pack_bf16(p[0], p[1]);
      pa[nt * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
    // O += P·V with V[key][d] through ldmatrix.trans (lanes 16..31 repeat
    // rows 0..15; their addresses are not read).
    const uint32_t v_lane = static_cast<uint32_t>(
        __cvta_generic_to_shared(v_t + (key0 + lane % 16) * RS));
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= al_a;
      o[n][1] *= al_a;
      o[n][2] *= al_b;
      o[n][3] *= al_b;
      uint32_t b0, b1;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
          : "=r"(b0), "=r"(b1)
          : "r"(v_lane + (uint32_t)(n * 8 * 2)));
      mma_bf16(o[n], pa, b0, b1);
    }
    __syncthreads();  // the next iteration refills this tile's stage
  }
  cp_async_wait<0>();  // ntiles == 0: the query loads are still in flight

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  // Merge the warps' partials into warp 0: each is rescaled from its own
  // running max to the common one. The key loop ended on a barrier (or
  // never loaded a tile), so the tile stages are free.
  float* po = reinterpret_cast<float*>(smem_raw + lay.kv);
  float* pml = po + kWarps * ND * 4 * 32;
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) po[((warp * ND + n) * 4 + e) * 32 + lane] = o[n][e];
  pml[(warp * 4 + 0) * 32 + lane] = m_a;
  pml[(warp * 4 + 1) * 32 + lane] = m_b;
  pml[(warp * 4 + 2) * 32 + lane] = l_a;
  pml[(warp * 4 + 3) * 32 + lane] = l_b;
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    const float m2a = pml[(w * 4 + 0) * 32 + lane];
    const float m2b = pml[(w * 4 + 1) * 32 + lane];
    const float mna = fmaxf(m_a, m2a);
    const float mnb = fmaxf(m_b, m2b);
    // A warp that saw no visible key has m = -inf and weight 0.
    const float sa = m_a == -INFINITY ? 0.f : exp2f(m_a - mna);
    const float sb = m_b == -INFINITY ? 0.f : exp2f(m_b - mnb);
    const float wa = m2a == -INFINITY ? 0.f : exp2f(m2a - mna);
    const float wb = m2b == -INFINITY ? 0.f : exp2f(m2b - mnb);
    l_a = l_a * sa + pml[(w * 4 + 2) * 32 + lane] * wa;
    l_b = l_b * sb + pml[(w * 4 + 3) * 32 + lane] * wb;
    m_a = mna;
    m_b = mnb;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float* p2 = po + ((w * ND + n) * 4) * 32 + lane;
      o[n][0] = o[n][0] * sa + p2[0] * wa;
      o[n][1] = o[n][1] * sa + p2[32] * wa;
      o[n][2] = o[n][2] * sb + p2[64] * wb;
      o[n][3] = o[n][3] * sb + p2[96] * wb;
    }
  }
  // A row that saw no key has o = 0 (every p was pinned to 0).
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = gq + half * 8;
    if (r >= group) continue;
    const float inv = 1.f / fmaxf(half ? l_b : l_a, 1e-30f);
    __nv_bfloat16* dst = out + ((size_t)b * hq + h * group + r) * D + tq * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __floats2bfloat162_rn(
          o[n][half * 2] * inv, o[n][half * 2 + 1] * inv);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ tables,
    const uint8_t* __restrict__ kv_mask, const int* __restrict__ seq_lens,
    __nv_bfloat16* __restrict__ out, int hq, int hkv, int bs, int maxb,
    float scale) {
  decode_body<D, false>(q, k_pool, v_pool, tables, kv_mask, seq_lens, out,
                        hq, hkv, bs, maxb, maxb * bs, scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads) dense_decode_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_cache,
    const __nv_bfloat16* __restrict__ v_cache,
    const uint8_t* __restrict__ kv_mask, const int* __restrict__ seq_lens,
    __nv_bfloat16* __restrict__ out, int hq, int hkv, int c, float scale) {
  decode_body<D, true>(q, k_cache, v_cache, nullptr, kv_mask, seq_lens, out,
                       hq, hkv, 0, 0, c, scale);
}

template <int D>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* kv_mask, const void* seq_lens,
           void* out, int b, int hq, int hkv, int bs, int maxb,
           cudaStream_t stream) {
  const size_t smem = Smem(D, maxb).total;
  auto fn = paged_decode_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b, hkv);
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(tables), static_cast<const uint8_t*>(kv_mask),
      static_cast<const int*>(seq_lens), static_cast<__nv_bfloat16*>(out), hq,
      hkv, bs, maxb, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dense(const void* q, const void* k_cache, const void* v_cache,
                 const void* kv_mask, const void* seq_lens, void* out, int b,
                 int hq, int hkv, int c, cudaStream_t stream) {
  const size_t smem = Smem(D, 0).total;
  auto fn = dense_decode_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b, hkv);
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache),
      static_cast<const uint8_t*>(kv_mask), static_cast<const int*>(seq_lens),
      static_cast<__nv_bfloat16*>(out), hq, hkv, c, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success), or a
// negative code for a shape this kernel does not take. Allocates nothing.
int kftt_paged_decode_attention(const void* q, const void* k_pool,
                                const void* v_pool, const void* tables,
                                const void* kv_mask, const void* seq_lens,
                                void* out, int b, int hq, int hkv, int d,
                                int bs, int maxb, void* stream) {
  if (hkv <= 0 || hq % hkv || hq / hkv > kRows) return kErrGroup;
  if (Smem(d, maxb).total > kMaxSmem) return kErrSmem;
  if (b == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, k_pool, v_pool, tables, kv_mask, seq_lens, out, b,
                        hq, hkv, bs, maxb, st);
    case 128:
      return launch<128>(q, k_pool, v_pool, tables, kv_mask, seq_lens, out, b,
                         hq, hkv, bs, maxb, st);
    case 256:
      return launch<256>(q, k_pool, v_pool, tables, kv_mask, seq_lens, out, b,
                         hq, hkv, bs, maxb, st);
    default:
      return kErrHeadDim;
  }
}

// The dense variant: q (B, Hq, D), caches (B, Hkv, C, D), kv_mask (B, C)
// bytes, seq_lens (B,) int32. Same return codes.
int kftt_dense_decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* kv_mask,
                                const void* seq_lens, void* out, int b, int hq,
                                int hkv, int d, int c, void* stream) {
  if (hkv <= 0 || hq % hkv || hq / hkv > kRows) return kErrGroup;
  if (b == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_dense<64>(q, k_cache, v_cache, kv_mask, seq_lens, out, b,
                              hq, hkv, c, st);
    case 128:
      return launch_dense<128>(q, k_cache, v_cache, kv_mask, seq_lens, out, b,
                               hq, hkv, c, st);
    case 256:
      return launch_dense<256>(q, k_cache, v_cache, kv_mask, seq_lens, out, b,
                               hq, hkv, c, st);
    default:
      return kErrHeadDim;
  }
}

const char* kftt_error_string(int code) {
  switch (code) {
    case kErrHeadDim: return "head_dim must be 64, 128 or 256";
    case kErrSmem: return "the slot's table row and tiles need more shared memory than a block has";
    case kErrGroup: return "Hq must be a multiple of Hkv with Hq / Hkv <= 16";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
