// Ragged paged GQA attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel kubeflow_tpu/ops/ragged_attention.py
// (_ragged_kernel, called from ragged_paged_attention). It computes the
// same function: rows of a flattened mixed decode/prefill batch q
// (T, Hq, D) belong to sequences given by (seq_starts, seq_lens, kv_lens);
// row j of sequence s attends slot s's KV blocks, read through
// tables (S, MAXB) from the block pools (NB, Hkv, BS, D), at kv positions
// k_pos <= kv_len - seq_len + j where kv_mask (S, MAXB*BS) allows it, with
// an f32 online softmax. Pools are bf16, or int8 values with bf16 scales
// (NB, Hkv, BS). Rows whose keys are all masked come out 0; rows owned by
// no sequence are never written (the wrapper zero-fills the output).
//
// What bounds it on this card: bytes, at every shape the engine runs but a
// long prompt's continuation chunk. At decode each query row reads its
// whole live history once, about 4 FLOPs per K/V byte — far below the
// ~295 FLOPs/byte where the H100's bf16 tensor cores would be the limit —
// so the floor is the live K/V blocks over HBM bandwidth (3.35 TB/s).
// Reaching it takes many bytes in flight on every SM at once, which one
// CTA walking a tile's whole history in series never has: the engine's
// decode steps are 8 rows, one a slot, so a grid of one CTA per (tile,
// kv head) has 64 CTAs for 132 SMs.
// What the design does about it:
// - a compact tile grid: the grid's tile axis holds the at most
//   min(T, (T + S·(q_tile − 1)) / q_tile) q-tiles of q_tile tokens that
//   can own rows. Each CTA finds its (sequence, tile) by a warp's prefix
//   sum of ceil(seq_len / q_tile) over the S sequences, loading seq_starts
//   and kv_lens in the same trip; a tile index past the last owned tile
//   exits at once, so the host never reads the device metadata;
// - the grid is (run, kv head, tile): each CTA takes one run of `split`
//   keys (a multiple of 64, which the host fixes from T, S, MAXB·BS, Hkv
//   and q_tile, never from seq_lens) of its tile's key range [0, hi), hi
//   being the tile's causal bound, and serves all q_tile·G query rows of
//   the kv head's GQA group (G = Hq/Hkv), so each K/V block is read from
//   HBM once per tile and reused by every q head that shares it, and a
//   long history is read by many SMs at once. A run that starts at or
//   past hi exits before any load. The 8 warps take 227-255 registers a
//   thread, so an SM holds one CTA: the host caps a call at one wave of
//   CTAs, and a tile is split only where few tiles walk far (the width-8
//   decode steps, long histories), not where the tiles already fill the
//   card (an admission step, a long prompt's chunk);
// - keys are staged in tiles of 64 with cp.async into two shared-memory
//   stages: the next tile's loads are in flight while the current tile is
//   computed, and every load of a tile is issued before any is waited for;
// - the math runs on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//   accumulate): S = Q·Kᵀ, the online softmax on the S fragments in
//   registers, O += P·V with V read through ldmatrix.trans, the output
//   accumulator in registers for the whole run;
// - each of the CTA's 8 warps takes 16 query rows; where the tile has fewer
//   rows than that (a decode tile has G), the warps of a row group split
//   every key tile between them, each with its own online softmax, and
//   merge their partial results at the end of the run;
// - a tile whose keys fit in one run is finished by that run's CTA.
//   Otherwise each run writes its rows' unnormalised f32 partial O and
//   their max m and sum l to scratch (a run that sees no key writes
//   m = -inf, l = 0 and weighs 0), then takes a ticket on its (tile, kv
//   head) counter. The last run to arrive merges the partials in run
//   order, so the output is the same bits on every run whichever CTA came
//   last, and sets the counter back to 0: one launch a call.
//
// int8 pools: the raw int8 tile is staged, then widened in shared memory
// to bf16 (exact: |v| <= 127), each thread widening the chunks it copied,
// so a tile costs the same two barriers as a bf16 one. Each key's K scale
// multiplies its f32 score, and each key's V scale multiplies its f32
// probability before that is rounded to bf16 for P·V —
// sum_k p_k·(s_k·v_k) = sum_k (p_k·s_k)·v_k.
//
// A long prompt's continuation chunk (hundreds of rows over thousands of
// keys) is bound by operations; there mma.sync's 16-row products, and not
// wgmma's 64-row ones, are what this kernel leaves on the table.
//
// Differences from the TPU kernel that correctness depends on:
// - CTAs run concurrently and in no order, so a partial last q-tile never
//   writes a row past seq_start + seq_len (the TPU kernel wrote whole
//   tiles and relied on a later sequential program to overwrite them), and
//   a tile over several runs is merged by whichever run finishes last.
// - Keys are walked in tiles of 64 positions through the tables, so any
//   block size works; a tile may span blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using kftt::cp_async16;
using kftt::cp_async_commit;
using kftt::cp_async_wait;
using kftt::Int;
using kftt::ld32;
using kftt::mma_bf16;
using kftt::pack_bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 16 * kWarps;  // q_tile * group rows of one CTA
constexpr int kKeys = 64;              // keys per tile, a multiple of 16
constexpr int kMaxRuns = 32;           // runs of one tile, at most
constexpr size_t kMaxSmem = 232448;

enum : int {
  kErrHeadDim = -1,
  kErrRows = -2,
  kErrSmem = -3,
  kErrGroup = -4,
  kErrSplit = -5,
};

// The q-tiles of q_tile tokens that can own rows of a T-row batch of S
// sequences: each owns at least one row, and sum_s ceil(n_s / q_tile) <=
// (T + S·(q_tile - 1)) / q_tile.
__host__ __device__ inline int grid_tiles(int t, int s, int q_tile) {
  const long long bound =
      ((long long)t + (long long)(s < t ? s : t) * (q_tile - 1)) / q_tile;
  return (int)(bound < t ? bound : t);
}

// Byte offsets into dynamic shared memory. bf16 rows are padded by 8
// elements (16 bytes): rows stay 16-byte aligned, and the 8 rows one
// fragment load touches start in distinct banks.
//   q:     [rows_pad][D + 8] bf16
//   kv:    bf16 K/V tiles, [stage][K|V][kKeys][D + 8]; two stages for bf16
//          pools (filled by cp.async), one for int8 (widened from raw)
//   raw:   int8 pools only, [stage][K|V][kKeys][D], two stages
//   scale: int8 pools only, [stage][K|V][kKeys] f32
//   row:   [stage][kKeys] int pool row of each key of the tile (-1 past the
//          table span), so the loads of a tile never wait on the tables
//   mask:  [stage][kKeys] kv_mask bytes of the tile's keys
// After the key loop, the bytes from kv on hold the warps' partial results
// for their merge: [warp][D/8][4][32] f32 accumulators, then [warp][4][32]
// f32 (m_a, m_b, l_a, l_b); and, in the CTA that merges a tile's runs, the
// runs' weights and sums, [2][kMaxRuns][kMaxRows] f32.
struct Smem {
  size_t q, kv, raw, scale, row, mask, total;
  __host__ __device__ Smem(int d, int rows_pad, bool quant) {
    const size_t padded = (size_t)(d + 8) * 2;  // bytes of a bf16 row
    q = 0;
    kv = q + rows_pad * padded;
    raw = kv + (quant ? 1 : 2) * 2 * kKeys * padded;
    scale = raw + (quant ? (size_t)2 * 2 * kKeys * d : 0);
    row = scale + (quant ? sizeof(float) * 2 * 2 * kKeys : 0);
    mask = row + sizeof(int) * 2 * kKeys;
    total = mask + 2 * kKeys;
    const size_t merge = kv + sizeof(float) * kWarps * 32 * 4 * (d / 8 + 1);
    const size_t runs = kv + sizeof(float) * 2 * kMaxRuns * kMaxRows;
    if (merge > total) total = merge;
    if (runs > total) total = runs;
  }
};

// CTA (run, h, tile) takes keys [run*split, (run + 1)*split) of its tile's
// range [0, hi) for kv head h. Scratch, for tiles over more than one run:
// part_o (T, Hq, nsplit, D) f32 and part_ml (T, Hq, nsplit) (m, l), by q
// row and q head; counters (tiles, Hkv), 0 between calls.
template <int D, bool QUANT>
__global__ void __launch_bounds__(kThreads) ragged_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pool,
    const void* __restrict__ v_pool, const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, const int* __restrict__ tables,
    const uint8_t* __restrict__ kv_mask, const int* __restrict__ seq_starts,
    const int* __restrict__ seq_lens, const int* __restrict__ kv_lens,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
    float2* __restrict__ part_ml, unsigned* __restrict__ counters, int nseq,
    int hq, int hkv, int bs, int maxb, int q_tile, int split, int nsplit,
    float scale) {
  constexpr int RS = D + 8;       // padded bf16 row, elements
  constexpr int ND = D / 8;       // n-tiles of the output
  constexpr int kChunk = QUANT ? 16 : 8;  // pool elements per 16 bytes
  constexpr int kRowChunks = D / kChunk;  // 16-byte chunks per pool row
  constexpr int kTileChunks = 2 * kKeys * kRowChunks;  // K and V
  constexpr int kIssueIters = (kTileChunks + kThreads - 1) / kThreads;

  const int run = blockIdx.x;
  const int h = blockIdx.y;
  const int tile = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // This CTA's (sequence s, tile t of s): every warp scans the sequences'
  // tile counts 32 at a time, loading their starts and kv lengths in the
  // same trip. A tile index past the last owned tile owns no row.
  int s = -1, t = 0, qlen = 0, start = 0, kvlen = 0;
  {
    int before = 0;  // tiles of the sequences scanned so far
    for (int s0 = 0; s0 < nseq; s0 += 32) {
      const int i = s0 + lane;
      int n = 0, st = 0, kl = 0;
      if (i < nseq) {
        n = seq_lens[i];
        st = seq_starts[i];
        kl = kv_lens[i];
      }
      const int c = n > 0 ? (n + q_tile - 1) / q_tile : 0;
      int incl = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      const int first = before + incl - c;
      const unsigned hit =
          __ballot_sync(0xffffffffu, tile >= first && tile < first + c);
      if (hit) {
        const int src = __ffs(hit) - 1;
        s = s0 + src;
        t = tile - __shfl_sync(0xffffffffu, first, src);
        qlen = __shfl_sync(0xffffffffu, n, src);
        start = __shfl_sync(0xffffffffu, st, src);
        kvlen = __shfl_sync(0xffffffffu, kl, src);
        break;
      }
      before += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  if (s < 0) return;
  const int group = hq / hkv;
  const int base = kvlen - qlen;  // kv position of the chunk's row 0
  const int ntok = min(q_tile, qlen - t * q_tile);
  const int rows = ntok * group;  // valid (token, group) rows, token-major
  const int row0 = start + t * q_tile;
  const int span = maxb * bs;
  // The tile's keys: its rows see none at or past hi, nor past the table
  // span.
  const int hi = max(0, min(min(base + (t + 1) * q_tile, kvlen), span));
  // Runs that hold the tile's keys; at least one, so that a tile with no
  // key still writes its zero rows.
  const int nlive = max(1, (hi + split - 1) / split);
  if (run >= nlive) return;
  const int k0 = run * split;
  const int k1 = min(k0 + split, hi);
  const int nkt = k1 > k0 ? (k1 - k0 + kKeys - 1) / kKeys : 0;
  const int rows_pad = (q_tile * group + 15) / 16 * 16;
  // Scores in log2 units, so the softmax's exponentials are exp2.
  const float scale_log2 = scale * 1.4426950408889634f;
  const uint8_t* mask_row = kv_mask + (size_t)s * span;
  const int* table = tables + (size_t)s * maxb;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem lay(D, rows_pad, QUANT);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.q);
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.kv);
  int8_t* raw_s = reinterpret_cast<int8_t*>(smem_raw + lay.raw);
  float* scale_s = reinterpret_cast<float*>(smem_raw + lay.scale);
  int* row_s = reinterpret_cast<int*>(smem_raw + lay.row);
  uint8_t* mask_s = smem_raw + lay.mask;

  // Thread tid < kKeys: the pool row of key tid of the run's key tile kt
  // for this slot and kv head, -1 past the table span. Loaded a tile before
  // the tile's K/V loads are issued, and kept in row_s[kt & 1]. Keys of the
  // run's last tile past k1 are either past hi, which no row of the tile
  // sees, or past the span (split is a multiple of kKeys, so a run's tiles
  // never reach into the next run).
  auto load_row = [&](int kt) -> int {
    const int kpos = k0 + kt * kKeys + tid;
    if (tid >= kKeys || kpos >= span) return -1;
    return (table[kpos / bs] * hkv + h) * bs + kpos % bs;
  };
  auto store_row = [&](int kt, int row) {
    if (tid < kKeys) row_s[(kt & 1) * kKeys + tid] = row;
  };

  // Issue the cp.async loads of the key tile whose rows are in row_s[st]
  // into stage st, and commit them as one group. Keys past the slot's
  // table span are zero-filled.
  auto issue = [&](int st) {
#pragma unroll
    for (int i = 0; i < kIssueIters; ++i) {
      const int e = tid + i * kThreads;
      if (e < kTileChunks) {
        const int is_v = e >= kKeys * kRowChunks;
        const int ee = e - is_v * kKeys * kRowChunks;
        const int j = ee / kRowChunks;
        const int c = (ee % kRowChunks) * kChunk;
        const int row = row_s[st * kKeys + j];
        const bool live = row >= 0;
        const unsigned char* src =
            static_cast<const unsigned char*>(is_v ? v_pool : k_pool);
        if (live) src += ((size_t)row * D + c) * (QUANT ? 1 : 2);
        void* dst =
            QUANT ? static_cast<void*>(raw_s + ((st * 2 + is_v) * kKeys + j) * D + c)
                  : static_cast<void*>(kv_s + ((st * 2 + is_v) * kKeys + j) * RS + c);
        cp_async16(dst, src, live);
      }
    }
    cp_async_commit();
  };

  // The small per-key data of key tile kt, loaded by thread tid into
  // registers and stored to stage st later, so its latency hides behind a
  // tile of math: the kv_mask byte of key tid (tid < kKeys) and, for int8
  // pools, K scale tid or V scale tid - kKeys (tid < 2·kKeys). Keys past
  // the table span read as masked, scale 0.
  struct Meta {
    __nv_bfloat16 scale;
    uint8_t mask;
  };
  auto load_meta = [&](int kt) -> Meta {
    Meta m{__float2bfloat16(0.f), 0};
    const int j = tid % kKeys;
    const int row = tid < 2 * kKeys ? row_s[(kt & 1) * kKeys + j] : -1;
    if (row < 0) return m;
    if (tid < kKeys) m.mask = mask_row[k0 + kt * kKeys + j];
    if (QUANT) m.scale = (tid >= kKeys ? v_scale : k_scale)[row];
    return m;
  };
  auto store_meta = [&](int st, Meta m) {
    if (tid < kKeys) mask_s[st * kKeys + tid] = m.mask;
    if (QUANT && tid < 2 * kKeys)
      scale_s[st * 2 * kKeys + tid] = __bfloat162float(m.scale);
  };

  // Query rows: row r = token * G + g reads q head h*G + g (a kv head's q
  // heads are contiguous). Rows past the tile's tokens are zero. They join
  // the first key tile's group.
  for (int e = tid; e < rows_pad * (D / 8); e += kThreads) {
    const int r = e / (D / 8);
    const int c = (e % (D / 8)) * 8;
    const int tk = r / group;
    const bool live = r < rows;
    const __nv_bfloat16* src =
        live ? q + ((size_t)(row0 + tk) * hq + h * group + (r - tk * group)) * D + c
             : q;
    cp_async16(q_s + r * RS + c, src, live);
  }
  if (nkt > 0) {
    store_row(0, load_row(0));
    store_row(1, load_row(1));
    __syncthreads();
    issue(0);
    store_meta(0, load_meta(0));
  } else {
    cp_async_commit();
    cp_async_wait<0>();
  }

  const int gq = lane / 4;  // fragment row within 8
  const int tq = lane % 4;  // fragment column pair
  // Warp roles: the tile's live row groups of 16 rows each get `wsplit`
  // warps (a power of two, at most 4); warp `part` of a group takes keys
  // [part, part + 1) * kKeys / wsplit of every key tile.
  const int groups = (rows + 15) / 16;
  int wsplit = 1;
  while (wsplit < 4 && 2 * wsplit * groups <= kWarps) wsplit *= 2;
  const int rgroup = warp / wsplit;
  const int part = warp % wsplit;
  const bool computes = rgroup < groups;
  const bool owner = computes && part == 0;  // holds the group's result
  // This thread's two rows and their absolute query positions.
  const int ra = rgroup * 16 + gq;
  const int rb = ra + 8;
  const int qpos_a = base + t * q_tile + ra / group;
  const int qpos_b = base + t * q_tile + rb / group;
  const bool va = ra < rows;
  const bool vb = rb < rows;

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max, rows a and b
  float l_a = 0.f, l_b = 0.f;              // this thread's partial sums

  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt & 1;
    const int kb = k0 + kt * kKeys;  // kv position of the tile's key 0
    const bool more = kt + 1 < nkt;
    // Put the next tile in flight (its stage was last read by the tile
    // before this one, which every thread has finished), then wait for
    // this one.
    Meta next{__float2bfloat16(0.f), 0};
    const int next_row = kt + 2 < nkt ? load_row(kt + 2) : -1;
    if (more) {
      issue(st ^ 1);
      next = load_meta(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (QUANT) {
      // Widen the raw int8 tile to bf16 (exact). Each thread widens the
      // 16-byte chunks its own cp.async loads brought (the chunks of
      // `issue`), which its own wait covers, so no barrier comes between
      // the wait and the widening; the bf16 stage was last read by the
      // previous tile's math, which the barrier ending that tile closed.
#pragma unroll
      for (int i = 0; i < kIssueIters; ++i) {
        const int e = tid + i * kThreads;
        if (e < kTileChunks) {
          const int is_v = e >= kKeys * kRowChunks;
          const int ee = e - is_v * kKeys * kRowChunks;
          const int j = ee / kRowChunks;
          const int c = (ee % kRowChunks) * kChunk;
          const uint4 raw = *reinterpret_cast<const uint4*>(
              raw_s + ((st * 2 + is_v) * kKeys + j) * D + c);
          const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
          __align__(16) __nv_bfloat16 vals[16];
#pragma unroll
          for (int u = 0; u < 16; ++u) vals[u] = __float2bfloat16_rn((float)b[u]);
          uint4* dst = reinterpret_cast<uint4*>(kv_s + (is_v * kKeys + j) * RS + c);
          dst[0] = reinterpret_cast<const uint4*>(vals)[0];
          dst[1] = reinterpret_cast<const uint4*>(vals)[1];
        }
      }
    }
    __syncthreads();

    const __nv_bfloat16* k_t;
    const __nv_bfloat16* v_t;
    if (QUANT) {
      k_t = kv_s;
      v_t = kv_s + kKeys * RS;
    } else {
      k_t = kv_s + st * 2 * kKeys * RS;
      v_t = k_t + kKeys * RS;
    }
    const float* ks = scale_s + st * 2 * kKeys;  // int8 pools only
    const float* vs = ks + kKeys;
    const uint8_t* mask_t = mask_s + st * kKeys;

    // This warp's share of the tile: NT n-tiles of 8 keys from key0.
    auto attend = [&](auto nt_count) {
      constexpr int NT = decltype(nt_count)::value;
      constexpr int KS = NT / 2;  // k-steps of P·V
      const int key0 = part * NT * 8;
      // S = Q·Kᵀ for this warp's 16 rows × NT·8 keys.
      float sc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
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
          const __nv_bfloat16* kbp =
              k_t + (key0 + nt * 8 + gq) * RS + kk * 16 + tq * 2;
          mma_bf16(sc[nt], a, ld32(kbp), ld32(kbp + 8));
        }
      }
      // Scale, mask (stored kv_mask AND the positional causal bound) and
      // the per-row tile max. Element (nt, i) is row a for i < 2, row b
      // otherwise, at key kb + key0 + nt*8 + tq*2 + (i & 1).
      float bmax_a = -INFINITY, bmax_b = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = key0 + nt * 8 + tq * 2 + (i & 1);
          const int kpos = kb + key;
          const bool row_b = i >= 2;
          const bool ok = (row_b ? vb : va) && mask_t[key] &&
                          kpos <= (row_b ? qpos_b : qpos_a);
          float x = sc[nt][i] * scale_log2;
          if (QUANT) x *= ks[key];
          x = ok ? x : -INFINITY;
          sc[nt][i] = x;
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
      // key0 + ks*16 .. +15, i.e. S n-tiles 2ks (a0, a1) and 2ks+1 (a2, a3).
      uint32_t pa[KS][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float mn = i >= 2 ? mn_b : mn_a;
          p[i] = mn == -INFINITY ? 0.f : exp2f(sc[nt][i] - mn);
        }
        sum_a += p[0] + p[1];
        sum_b += p[2] + p[3];
        if (QUANT) {
          const int key = key0 + nt * 8 + tq * 2;
          p[0] *= vs[key];
          p[1] *= vs[key + 1];
          p[2] *= vs[key];
          p[3] *= vs[key + 1];
        }
        pa[nt / 2][(nt % 2) * 2] = pack_bf16(p[0], p[1]);
        pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
      // ldmatrix row address of this lane in the V tile (rows 0..15 of a
      // k-step; lanes 16..31 repeat them, their addresses are not read).
      const uint32_t v_lane = static_cast<uint32_t>(
          __cvta_generic_to_shared(v_t + (key0 + lane % 16) * RS));
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= al_a;
        o[n][1] *= al_a;
        o[n][2] *= al_b;
        o[n][3] *= al_b;
#pragma unroll
        for (int ks_ = 0; ks_ < KS; ++ks_) {
          // V[key][d] row-major, transposed into the B fragment.
          uint32_t b0, b1;
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
              : "=r"(b0), "=r"(b1)
              : "r"(v_lane + (uint32_t)((ks_ * 16 * RS + n * 8) * 2)));
          mma_bf16(o[n], pa[ks_], b0, b1);
        }
      }
    };
    if (computes) {
      if (wsplit == 1) attend(Int<kKeys / 8>{});
      else if (wsplit == 2) attend(Int<kKeys / 16>{});
      else attend(Int<kKeys / 32>{});
    }
    // The next tile's per-key data goes to the stage this tile's
    // predecessor used; the rows of the tile after it, to this tile's.
    if (more) store_meta(st ^ 1, next);
    store_row(kt + 2, next_row);
    __syncthreads();  // the next iteration refills this tile's stage
  }

  if (computes) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
  }
  if (wsplit > 1) {
    // Merge the group's partial results into its part-0 warp: each
    // partial is rescaled from its own running max to the common one.
    // The key loop ended on a barrier, so the tile stages are free.
    float* po = reinterpret_cast<float*>(smem_raw + lay.kv);
    float* pml = po + kWarps * ND * 4 * 32;
    if (computes) {
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) po[((warp * ND + n) * 4 + i) * 32 + lane] = o[n][i];
      pml[(warp * 4 + 0) * 32 + lane] = m_a;
      pml[(warp * 4 + 1) * 32 + lane] = m_b;
      pml[(warp * 4 + 2) * 32 + lane] = l_a;
      pml[(warp * 4 + 3) * 32 + lane] = l_b;
    }
    __syncthreads();
    if (owner) {
      for (int w = warp + 1; w < warp + wsplit; ++w) {
        const float m2a = pml[(w * 4 + 0) * 32 + lane];
        const float m2b = pml[(w * 4 + 1) * 32 + lane];
        const float mna = fmaxf(m_a, m2a);
        const float mnb = fmaxf(m_b, m2b);
        // A part that saw no visible key has m = -inf and weight 0.
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
    }
  }
  // Row r of the tile is q row row0 + r / G, q head h*G + r % G.
  auto out_index = [&](int r) -> size_t {
    const int tk = r / group;
    return (size_t)(row0 + tk) * hq + h * group + (r - tk * group);
  };
  if (owner) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? rb : ra;
      if (r >= rows) continue;  // only the tile's own rows
      if (nlive == 1) {
        // The run holds all the tile's keys: normalise and write the
        // output. A row that saw no key has o = 0 (every p was pinned).
        const float inv = 1.f / fmaxf(half ? l_b : l_a, 1e-30f);
        __nv_bfloat16* dst = out + out_index(r) * D + tq * 2;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
              __floats2bfloat162_rn(o[n][half * 2] * inv,
                                    o[n][half * 2 + 1] * inv);
        }
      } else {
        const size_t idx = out_index(r) * nsplit + run;
        float* dst = part_o + idx * D + tq * 2;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          *reinterpret_cast<float2*>(dst + n * 8) =
              make_float2(o[n][half * 2], o[n][half * 2 + 1]);
        }
        if (tq == 0)
          part_ml[idx] = make_float2(half ? m_b : m_a, half ? l_b : l_a);
      }
    }
  }
  if (nlive == 1) return;

  // The ticket: the partials are written (barrier, then a device-wide
  // fence), so the CTA that takes the last ticket sees every one of them.
  __shared__ int last;
  __syncthreads();
  const size_t grp = (size_t)tile * hkv + h;  // this CTA's (tile, kv head)
  if (tid == 0) {
    __threadfence();
    const unsigned ticket = atomicAdd(counters + grp, 1u);
    last = ticket == (unsigned)(nlive - 1);
    if (last) counters[grp] = 0;  // every live run has arrived
    __threadfence();
  }
  __syncthreads();
  if (!last) return;

  // The merge, in run order. Each warp takes rows r = warp, warp + 8, ...:
  // its lanes load the runs' m and l (lane i runs i, i + 32), the row's max
  // comes by shuffles, and each run's weight goes to shared memory (a run
  // that saw no visible key has m = -inf and weight 0). Then each thread
  // takes 4 adjacent columns of a row and adds the runs' partials, read
  // through L2 (other SMs wrote them) 8 at a time, in run order.
  float* w_s = reinterpret_cast<float*>(smem_raw + lay.kv);  // [run][row]
  float* l_s = w_s + kMaxRuns * kMaxRows;                    // [run][row]
  for (int r = warp; r < rows; r += kWarps) {
    const float2* ml = part_ml + out_index(r) * nsplit;
    float mx = -INFINITY;
    for (int sp = lane; sp < nlive; sp += 32) {
      const float2 v = __ldcg(ml + sp);
      w_s[sp * kMaxRows + r] = v.x;
      l_s[sp * kMaxRows + r] = v.y;
      mx = fmaxf(mx, v.x);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    for (int sp = lane; sp < nlive; sp += 32) {
      const float m = w_s[sp * kMaxRows + r];
      w_s[sp * kMaxRows + r] = m == -INFINITY ? 0.f : exp2f(m - mx);
    }
  }
  __syncthreads();
  for (int e = tid; e < rows * (D / 4); e += kThreads) {
    const int r = e / (D / 4);
    const int c = (e % (D / 4)) * 4;
    const size_t oi = out_index(r);
    const float* pog = part_o + oi * nsplit * D + c;
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    auto add = [&](int sp, const float4& x) {
      const float w = w_s[sp * kMaxRows + r];
      l += w * l_s[sp * kMaxRows + r];
      acc.x += w * x.x;
      acc.y += w * x.y;
      acc.z += w * x.z;
      acc.w += w * x.w;
    };
    // Whole batches of 8 runs, then the last nlive % 8 loaded together
    // under a predicate: a tile of a few runs waits on one trip to L2.
    const int whole = nlive & ~7;
    int sp = 0;
#pragma unroll 8
    for (; sp < whole; ++sp)
      add(sp, __ldcg(reinterpret_cast<const float4*>(pog + (size_t)sp * D)));
    float4 x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (sp + u < nlive)
        x[u] = __ldcg(reinterpret_cast<const float4*>(pog + (size_t)(sp + u) * D));
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (sp + u < nlive) add(sp + u, x[u]);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    uint2 packed;
    packed.x = pack_bf16(acc.x * inv, acc.y * inv);
    packed.y = pack_bf16(acc.z * inv, acc.w * inv);
    *reinterpret_cast<uint2*>(out + oi * D + c) = packed;
  }
}

size_t smem_bytes(int d, int rows_alloc, bool quant) {
  return Smem(d, (rows_alloc + 15) / 16 * 16, quant).total;
}

// The scratch pointers: part_ml follows part_o's T*Hq*nsplit*D floats.
struct Scratch {
  float* part_o;
  float2* part_ml;
  Scratch(void* scratch, int t, int hq, int nsplit, int d)
      : part_o(static_cast<float*>(scratch)),
        part_ml(reinterpret_cast<float2*>(
            part_o + (size_t)t * hq * nsplit * d)) {}
};

template <int D, bool QUANT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* kv_mask, const void* seq_starts, const void* seq_lens,
           const void* kv_lens, void* out, void* scratch, void* counters,
           int t, int hq, int hkv, int bs, int s, int maxb, int q_tile,
           int split, int nsplit, cudaStream_t stream) {
  const int rows_alloc = q_tile * (hq / hkv);
  const size_t smem = smem_bytes(D, rows_alloc, QUANT);
  auto fn = ragged_kernel<D, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Scratch part(scratch, t, hq, nsplit, D);
  const dim3 grid(nsplit, hkv, grid_tiles(t, s, q_tile));
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k_pool, v_pool,
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int*>(tables), static_cast<const uint8_t*>(kv_mask),
      static_cast<const int*>(seq_starts), static_cast<const int*>(seq_lens),
      static_cast<const int*>(kv_lens), static_cast<__nv_bfloat16*>(out),
      part.part_o, part.part_ml, static_cast<unsigned*>(counters), s, hq,
      hkv, bs, maxb, q_tile, split, nsplit, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int quantized, const void* q, const void* k_pool,
             const void* v_pool, const void* k_scale, const void* v_scale,
             const void* tables, const void* kv_mask, const void* seq_starts,
             const void* seq_lens, const void* kv_lens, void* out,
             void* scratch, void* counters, int t, int hq, int hkv, int bs,
             int s, int maxb, int q_tile, int split, int nsplit,
             cudaStream_t stream) {
  if (quantized)
    return launch<D, true>(q, k_pool, v_pool, k_scale, v_scale, tables,
                           kv_mask, seq_starts, seq_lens, kv_lens, out,
                           scratch, counters, t, hq, hkv, bs, s, maxb, q_tile,
                           split, nsplit, stream);
  return launch<D, false>(q, k_pool, v_pool, k_scale, v_scale, tables,
                          kv_mask, seq_starts, seq_lens, kv_lens, out,
                          scratch, counters, t, hq, hkv, bs, s, maxb, q_tile,
                          split, nsplit, stream);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success), or a
// negative code for a shape this kernel does not take. Allocates nothing:
// `scratch` holds at least T*Hq*nsplit*(D + 2) floats (the partials of
// tiles over more than one run) and `counters` tiles*Hkv unsigned ints
// (tiles = min(T, (T + min(S, T)*(q_tile - 1)) / q_tile)), 0 before the
// call and 0 again after it. Runs of `split` keys, a multiple of 64, at
// most 32 of them, cover the table span MAXB*BS.
int kftt_ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* kv_mask, const void* seq_starts, const void* seq_lens,
    const void* kv_lens, void* out, void* scratch, void* counters, int t,
    int hq, int hkv, int d, int bs, int s, int maxb, int q_tile,
    int quantized, int split, int nsplit, void* stream) {
  if (hkv <= 0 || hq % hkv) return kErrGroup;
  if (q_tile <= 0 || q_tile * (hq / hkv) > kMaxRows) return kErrRows;
  if (smem_bytes(d, q_tile * (hq / hkv), quantized != 0) > kMaxSmem)
    return kErrSmem;
  if (split <= 0 || split % kKeys || nsplit <= 0 || nsplit > kMaxRuns ||
      (long long)split * nsplit < (long long)maxb * bs)
    return kErrSplit;
  if (t == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_d<64>(quantized, q, k_pool, v_pool, k_scale, v_scale,
                          tables, kv_mask, seq_starts, seq_lens, kv_lens, out,
                          scratch, counters, t, hq, hkv, bs, s, maxb, q_tile,
                          split, nsplit, st);
    case 128:
      return launch_d<128>(quantized, q, k_pool, v_pool, k_scale, v_scale,
                           tables, kv_mask, seq_starts, seq_lens, kv_lens,
                           out, scratch, counters, t, hq, hkv, bs, s, maxb,
                           q_tile, split, nsplit, st);
    case 256:
      return launch_d<256>(quantized, q, k_pool, v_pool, k_scale, v_scale,
                           tables, kv_mask, seq_starts, seq_lens, kv_lens,
                           out, scratch, counters, t, hq, hkv, bs, s, maxb,
                           q_tile, split, nsplit, st);
    default:
      return kErrHeadDim;
  }
}

const char* kftt_error_string(int code) {
  switch (code) {
    case kErrHeadDim: return "head_dim must be 64, 128 or 256";
    case kErrRows: return "q_tile * (Hq / Hkv) must be in 1..128";
    case kErrSmem: return "tile needs more shared memory than a block has";
    case kErrGroup: return "Hq must be a positive multiple of Hkv";
    case kErrSplit: return "split must be a positive multiple of 64 keys and at most 32 runs of it must cover the table span";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
