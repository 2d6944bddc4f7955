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
// live keys over HBM bandwidth (3.35 TB/s). Reaching it takes many bytes
// in flight on every SM at once, which one CTA walking a slot's history
// tile by tile never has.
// What the design does about it:
// - the grid is (split, kv head, slot): each CTA takes one run of `split`
//   keys of one slot (64, 128, 256 or 512, which the host fixes from the
//   span, B and Hkv, never from seq_lens) and serves the kv head's G query
//   rows, so each key is read from HBM once for the whole group and a long
//   history is read by many SMs at once. A CTA whose run starts at or past
//   the slot's live keys exits before any load;
// - a slot's live keys are its first min(ceil(seq_len / BS), MAXB) blocks
//   (paged) or the first min(seq_len, C) rows of its cache (dense); never
//   past the end, even for an idle slot's stale length. The paged kernel
//   loads its run's table entries beside seq_len, not after it, and turns
//   them into one pool row a key in shared memory, so its copies divide
//   by nothing;
// - keys are staged in tiles of 64 with 16-byte cp.async loads into two
//   shared-memory stages: the next tile is in flight while the current one
//   is computed, and a tile costs two barriers;
// - the 4 warps split each tile's keys, 16 each, and each keeps its own
//   online softmax in registers; their partial results are merged once, at
//   the end. The products run on the tensor cores (mma.sync m16n8k16, bf16
//   in, f32 accumulate; the G rows padded to 16), so a tile's math is a few
//   instructions per warp and the loop waits only on memory. The
//   probabilities are rounded to bf16 for P·V, as in the port's ragged
//   kernel;
// - a slot whose live keys fit in one run is finished by that run's CTA.
//   Otherwise each live CTA writes its unnormalised f32 partial O and its
//   rows' max m and sum l to scratch (a run that sees no key writes
//   m = -inf, l = 0 and weighs 0), then takes a ticket on its (slot, kv
//   head) counter. The last to arrive merges the partials in split order,
//   with their loads 8 at a time in flight, so the output is the same bits
//   on every run whichever CTA came last, and sets the counter back to 0
//   for the next call: one launch a call.

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
constexpr int kMaxSplit = 512;      // keys of one run, at most

enum : int {
  kErrHeadDim = -1,
  kErrGroup = -3,
  kErrSplit = -4,
};

// A read-only load issued where it stands: the compiler keeps it ahead
// of the branch that first uses another load's value (seq_len's).
__device__ __forceinline__ int ld_issued(const int* p) {
  int v;
  asm volatile("ld.global.nc.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

// Byte offsets into dynamic shared memory. bf16 rows are padded by 8
// elements (16 bytes), as in ragged_attention.cu.
//   q:     [kRows][D + 8] bf16, rows past G zero
//   kv:    [stage][K|V][kKeys][D + 8] bf16, two stages
//   rows:  [split] int, the pool row of each of the run's keys (paged
//          only; 0 dense)
// After the key loop the kv bytes hold the warps' partial results for the
// merge: [warp][D/8][4][32] f32 accumulators, then [warp][4][32] f32
// (m_a, m_b, l_a, l_b).
struct Smem {
  size_t q, kv, rows, total;
  __host__ __device__ Smem(int d, int row_count) {
    const size_t padded = (size_t)(d + 8) * 2;
    q = 0;
    kv = q + kRows * padded;
    rows = kv + 2 * 2 * kKeys * padded;
    total = rows + (size_t)row_count * 4;
  }
};

// The shared body. kDense picks where key k of slot b, kv head h lives:
// row ((b*Hkv + h)*span + k) of the dense caches (span = C), or row
// (table[k / bs]*Hkv + h)*bs + k % bs of the pools (span = MAXB*bs).
// CTA (s, h, b) takes keys [s*split, (s + 1)*split) of slot b's live ones.
// Scratch, for slots whose live keys span more than one run: part_o
// (B, Hkv, nsplit, G, D) f32 and part_ml (B, Hkv, nsplit, G) (m, l);
// counters (B*Hkv), 0 between calls.
template <int D, bool kDense>
__device__ __forceinline__ void decode_body(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_src,
    const __nv_bfloat16* __restrict__ v_src, const int* __restrict__ tables,
    const uint8_t* __restrict__ kv_mask, const int* __restrict__ seq_lens,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
    float2* __restrict__ part_ml, unsigned* __restrict__ counters, int hq,
    int hkv, int bs, int maxb, int span, int split, int nsplit, float scale) {
  constexpr int RS = D + 8;
  constexpr int ND = D / 8;  // n-tiles of the output
  constexpr int kRowChunks = D / 8;
  constexpr int kTileChunks = 2 * kKeys * kRowChunks;
  constexpr int kIssueIters = (kTileChunks + kThreads - 1) / kThreads;

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = hq / hkv;
  const int tid = threadIdx.x;
  const int k0 = s * split;
  const int seq_len = seq_lens[b];
  // Paged: the table entries of this thread's keys of the run, k0 + tid +
  // i*kThreads, loaded beside seq_len (their addresses need none of it).
  constexpr int kRunIters = kDense ? 0 : kMaxSplit / kThreads;
  int entry[kRunIters > 0 ? kRunIters : 1];
#pragma unroll
  for (int i = 0; i < kRunIters; ++i) {
    const int blk = (k0 + tid + i * kThreads) / bs;
    entry[i] = tid + i * kThreads < split && blk < maxb
                   ? ld_issued(tables + (size_t)b * maxb + blk)
                   : 0;
  }
  int nkeys;
  if constexpr (kDense)
    nkeys = seq_len > 0 ? min(seq_len, span) : 0;
  else
    nkeys = seq_len > 0 ? min((seq_len + bs - 1) / bs, maxb) * bs : 0;
  // Runs that hold live keys; at least one, so that a slot with no key
  // still writes its zero rows.
  const int nlive = max(1, (nkeys + split - 1) / split);
  if (s >= nlive) return;
  const int k1 = min(k0 + split, nkeys);
  const int ntiles = k1 > k0 ? (k1 - k0 + kKeys - 1) / kKeys : 0;
  // Scores in log2 units, so the softmax's exponentials are exp2.
  const float scale_log2 = scale * 1.4426950408889634f;
  const uint8_t* mask_row = kv_mask + (size_t)b * span;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem lay(D, kDense ? 0 : split);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.q);
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.kv);
  int* rows_s = reinterpret_cast<int*>(smem_raw + lay.rows);

  // Paged: the pool row of each of the run's keys, so that the copies
  // below divide by nothing.
#pragma unroll
  for (int i = 0; i < kRunIters; ++i) {
    const int kk = tid + i * kThreads;
    if (kk < split) {
      const int kpos = k0 + kk;
      rows_s[kk] = (entry[i] * hkv + h) * bs + kpos % bs;
    }
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
  __syncthreads();  // rows_s is read by every thread's loads

  // Issue the cp.async loads of the run's key tile t into stage st as one
  // group. Keys past the run's live ones are zero-filled.
  auto issue = [&](int t, int st) {
#pragma unroll
    for (int i = 0; i < kIssueIters; ++i) {
      const int e = tid + i * kThreads;
      if (e < kTileChunks) {
        const int is_v = e >= kKeys * kRowChunks;
        const int ee = e - is_v * kKeys * kRowChunks;
        const int j = ee / kRowChunks;
        const int c = (ee % kRowChunks) * 8;
        const int kpos = k0 + t * kKeys + j;
        const bool live = kpos < k1;
        const __nv_bfloat16* src = is_v ? v_src : k_src;
        if (live) {
          size_t row;
          if constexpr (kDense)
            row = ((size_t)b * hkv + h) * span + kpos;
          else
            row = (size_t)(unsigned)rows_s[kpos - k0];
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
        const int kpos = k0 + t * kKeys + key0 + nt * 8 + tq * 2 + u;
        valid[nt][u] = kpos < k1 && kpos < seq_len && mask_row[kpos] != 0;
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
  const size_t grp = (size_t)b * hkv + h;  // this CTA's (slot, kv head)
  if (warp == 0) {
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
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = gq + half * 8;
      if (r >= group) continue;
      if (nlive == 1) {
        // The run holds all the slot's live keys: normalise and write the
        // output. A row that saw no key has o = 0 (every p was pinned to 0).
        const float inv = 1.f / fmaxf(half ? l_b : l_a, 1e-30f);
        __nv_bfloat16* dst = out + ((size_t)b * hq + h * group + r) * D + tq * 2;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
              __floats2bfloat162_rn(o[n][half * 2] * inv,
                                    o[n][half * 2 + 1] * inv);
        }
      } else {
        const size_t row = (grp * nsplit + s) * group + r;
        float* dst = part_o + row * D + tq * 2;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          *reinterpret_cast<float2*>(dst + n * 8) =
              make_float2(o[n][half * 2], o[n][half * 2 + 1]);
        }
        if (tq == 0)
          part_ml[row] = make_float2(half ? m_b : m_a, half ? l_b : l_a);
      }
    }
  }
  if (nlive == 1) return;

  // The ticket: the partials are written (barrier, then a device-wide
  // fence), so the CTA that takes the last ticket sees every one of them.
  __shared__ int last;
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const unsigned ticket = atomicAdd(counters + grp, 1u);
    last = ticket == (unsigned)(nlive - 1);
    if (last) counters[grp] = 0;  // every live run has arrived
    __threadfence();
  }
  __syncthreads();
  if (!last) return;

  // The merge, in split order. Each warp takes rows g = warp, warp + 4,
  // ...: its lanes load the runs' m and l (lane i runs i, i + 32, ...),
  // the row's max comes by shuffles, and each run's weight goes to shared
  // memory (a run that saw no visible key has m = -inf and weight 0).
  // Then each thread takes 4 adjacent columns of a row and adds the runs'
  // partials, read through L2 (other SMs wrote them) 8 at a time, in
  // split order.
  float* w_s = reinterpret_cast<float*>(smem_raw + lay.kv);  // [nlive][G]
  float* l_s = w_s + nlive * group;                          // [nlive][G]
  const float2* ml = part_ml + grp * nsplit * group;
  const float* pog = part_o + grp * nsplit * group * D;
  for (int g = warp; g < group; g += kWarps) {
    float mx = -INFINITY;
    for (int sp = lane; sp < nlive; sp += 32) {
      const float2 v = __ldcg(ml + (size_t)sp * group + g);
      w_s[sp * group + g] = v.x;
      l_s[sp * group + g] = v.y;
      mx = fmaxf(mx, v.x);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    for (int sp = lane; sp < nlive; sp += 32) {
      const float m = w_s[sp * group + g];
      w_s[sp * group + g] = m == -INFINITY ? 0.f : exp2f(m - mx);
    }
  }
  __syncthreads();
  for (int e = tid; e < group * (D / 4); e += kThreads) {
    const int r = e / (D / 4);
    const int c = (e % (D / 4)) * 4;
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    auto add = [&](int sp, const float4& x) {
      const float w = w_s[sp * group + r];
      l += w * l_s[sp * group + r];
      acc.x += w * x.x;
      acc.y += w * x.y;
      acc.z += w * x.z;
      acc.w += w * x.w;
    };
    // Whole batches of 8 runs, then the last nlive % 8 loaded together
    // under a predicate: a slot of a few runs waits on one trip to L2.
    const int whole = nlive & ~7;
    int sp = 0;
#pragma unroll 8
    for (; sp < whole; ++sp)
      add(sp, __ldcg(reinterpret_cast<const float4*>(
                  pog + ((size_t)sp * group + r) * D + c)));
    float4 x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (sp + u < nlive)
        x[u] = __ldcg(reinterpret_cast<const float4*>(
            pog + ((size_t)(sp + u) * group + r) * D + c));
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (sp + u < nlive) add(sp + u, x[u]);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    uint2 packed;
    packed.x = pack_bf16(acc.x * inv, acc.y * inv);
    packed.y = pack_bf16(acc.z * inv, acc.w * inv);
    *reinterpret_cast<uint2*>(out + ((size_t)b * hq + h * group + r) * D + c) =
        packed;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D == 256 ? 1 : 3)
    paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ tables,
    const uint8_t* __restrict__ kv_mask, const int* __restrict__ seq_lens,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
    float2* __restrict__ part_ml, unsigned* __restrict__ counters, int hq,
    int hkv, int bs, int maxb, int split, int nsplit, float scale) {
  decode_body<D, false>(q, k_pool, v_pool, tables, kv_mask, seq_lens, out,
                        part_o, part_ml, counters, hq, hkv, bs, maxb,
                        maxb * bs, split, nsplit, scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads, D == 256 ? 1 : 3)
    dense_decode_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_cache,
    const __nv_bfloat16* __restrict__ v_cache,
    const uint8_t* __restrict__ kv_mask, const int* __restrict__ seq_lens,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
    float2* __restrict__ part_ml, unsigned* __restrict__ counters, int hq,
    int hkv, int c, int split, int nsplit, float scale) {
  decode_body<D, true>(q, k_cache, v_cache, nullptr, kv_mask, seq_lens, out,
                       part_o, part_ml, counters, hq, hkv, 0, 0, c, split,
                       nsplit, scale);
}

// The scratch pointers: part_ml follows part_o's B*Hkv*nsplit*G*D floats.
struct Scratch {
  float* part_o;
  float2* part_ml;
  Scratch(void* scratch, int b, int hkv, int nsplit, int group, int d)
      : part_o(static_cast<float*>(scratch)),
        part_ml(reinterpret_cast<float2*>(
            part_o + (size_t)b * hkv * nsplit * group * d)) {}
};

template <int D>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* kv_mask, const void* seq_lens,
           void* out, void* scratch, void* counters, int b, int hq, int hkv,
           int bs, int maxb, int split, int nsplit, cudaStream_t stream) {
  const size_t smem = Smem(D, split).total;
  auto fn = paged_decode_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Scratch part(scratch, b, hkv, nsplit, hq / hkv, D);
  const dim3 grid(nsplit, hkv, b);
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(tables), static_cast<const uint8_t*>(kv_mask),
      static_cast<const int*>(seq_lens), static_cast<__nv_bfloat16*>(out),
      part.part_o, part.part_ml, static_cast<unsigned*>(counters), hq, hkv,
      bs, maxb, split, nsplit, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dense(const void* q, const void* k_cache, const void* v_cache,
                 const void* kv_mask, const void* seq_lens, void* out,
                 void* scratch, void* counters, int b, int hq, int hkv, int c,
                 int split, int nsplit, cudaStream_t stream) {
  const size_t smem = Smem(D, 0).total;
  auto fn = dense_decode_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Scratch part(scratch, b, hkv, nsplit, hq / hkv, D);
  const dim3 grid(nsplit, hkv, b);
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache),
      static_cast<const uint8_t*>(kv_mask), static_cast<const int*>(seq_lens),
      static_cast<__nv_bfloat16*>(out), part.part_o, part.part_ml,
      static_cast<unsigned*>(counters), hq, hkv, c, split, nsplit,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// The refusals both entry points share: the group, and runs of `split`
// keys (a multiple of 64, at most 512) whose nsplit runs cover the span,
// with each run's m and l in the tile stages for the merge.
int check_shape(int hq, int hkv, int d, int span, int split, int nsplit) {
  if (hkv <= 0 || hq % hkv || hq / hkv > kRows) return kErrGroup;
  if (split <= 0 || split % kKeys || split > kMaxSplit || nsplit <= 0 ||
      (long long)split * nsplit < span ||
      (size_t)nsplit * 2 * (hq / hkv) * 4 > Smem(d, 0).rows - Smem(d, 0).kv)
    return kErrSplit;
  return 0;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success), or a
// negative code for a shape this kernel does not take. Allocates nothing:
// `scratch` holds at least B*Hkv*nsplit*G*(D + 2) floats (the partials of
// slots whose live keys span more than one run) and `counters` B*Hkv
// unsigned ints, 0 before the call and 0 again after it.
int kftt_paged_decode_attention(const void* q, const void* k_pool,
                                const void* v_pool, const void* tables,
                                const void* kv_mask, const void* seq_lens,
                                void* out, void* scratch, void* counters,
                                int b, int hq, int hkv, int d, int bs,
                                int maxb, int split, int nsplit,
                                void* stream) {
  if (int err = check_shape(hq, hkv, d, maxb * bs, split, nsplit))
    return err;
  if (b == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, k_pool, v_pool, tables, kv_mask, seq_lens, out,
                        scratch, counters, b, hq, hkv, bs, maxb, split,
                        nsplit, st);
    case 128:
      return launch<128>(q, k_pool, v_pool, tables, kv_mask, seq_lens, out,
                         scratch, counters, b, hq, hkv, bs, maxb, split,
                         nsplit, st);
    case 256:
      return launch<256>(q, k_pool, v_pool, tables, kv_mask, seq_lens, out,
                         scratch, counters, b, hq, hkv, bs, maxb, split,
                         nsplit, st);
    default:
      return kErrHeadDim;
  }
}

// The dense variant: q (B, Hq, D), caches (B, Hkv, C, D), kv_mask (B, C)
// bytes, seq_lens (B,) int32; scratch and counters as above. Same return
// codes.
int kftt_dense_decode_attention(const void* q, const void* k_cache,
                                const void* v_cache, const void* kv_mask,
                                const void* seq_lens, void* out,
                                void* scratch, void* counters, int b, int hq,
                                int hkv, int d, int c, int split, int nsplit,
                                void* stream) {
  if (int err = check_shape(hq, hkv, d, c, split, nsplit)) return err;
  if (b == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_dense<64>(q, k_cache, v_cache, kv_mask, seq_lens, out,
                              scratch, counters, b, hq, hkv, c, split, nsplit,
                              st);
    case 128:
      return launch_dense<128>(q, k_cache, v_cache, kv_mask, seq_lens, out,
                               scratch, counters, b, hq, hkv, c, split,
                               nsplit, st);
    case 256:
      return launch_dense<256>(q, k_cache, v_cache, kv_mask, seq_lens, out,
                               scratch, counters, b, hq, hkv, c, split,
                               nsplit, st);
    default:
      return kErrHeadDim;
  }
}

const char* kftt_error_string(int code) {
  switch (code) {
    case kErrHeadDim: return "head_dim must be 64, 128 or 256";
    case kErrGroup: return "Hq must be a multiple of Hkv with Hq / Hkv <= 16";
    case kErrSplit: return "split must be a multiple of 64 keys, at most 512, and nsplit runs of it must cover the span, their merge fitting in shared memory";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
