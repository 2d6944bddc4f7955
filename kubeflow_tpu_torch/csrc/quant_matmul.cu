// Weight-only quantized matrix product at decode widths for Hopper
// (sm_90a), plain C interface.
//
// No Pallas kernel of the JAX package computes this: kubeflow_tpu's
// models/llama.py (_mm, _lm_head_logits) leaves `x @ q.astype(x.dtype) * s`
// and `x @ dequantize_weight(w)` to XLA, which fuses the dequantization
// into the product so that the quantized tensor is what crosses HBM. Eager
// PyTorch cannot fuse it: `x @ q.to(bf16) * s` writes a bf16 copy of the
// weight and reads it back, 5 bytes a weight where bf16 reads 2. This
// kernel is that fusion, for x of at most 16 rows (MAX_ROWS in
// ops/quant_matmul.py), over the two stored layouts of
// kubeflow_tpu_torch/models/quant.py:
// - kn (quant_mm_kn_kernel, kftt_quant_matmul_kn): a layer weight q (K, N)
//   (int4: (K, N/2) bytes, two values a byte, the even index in the low
//   nibble), out (M, N) bf16 = x @ W;
// - nk (quant_mm_nk_kernel, kftt_quant_matmul_nk): the lm head q (V, K)
//   (int4: (V, K/2)), out (M, V) f32 = x @ W^T.
// Schemes and their rounding points, those of the JAX functions:
// - int8 and fp8 e4m3, per-output-channel f32 scale s: kn gives
//   bf16(bf16(x @ q) * bf16(s)); nk gives f32(bf16(x @ q^T)) * s;
// - int4, one f32 scale per `group` contraction values (s (K/group, N) or
//   (V, K/group)): the operand is bf16(q * s), rounded once from f32, and
//   the product is rounded to bf16 (nk: then widened to f32).
//
// What bounds it on this card: bytes. At M <= 16 rows it does 2*M
// operations a weight, ~32 a weight byte at int8, far below the ~295
// where the tensor cores would bind; the floor is the weight bytes (plus
// the scales) over HBM bandwidth (3.35 TB/s). Dequantizing on the CUDA
// cores and multiplying there would not reach it: at M = 8 that is 8 FMAs
// and a conversion a weight, as much time as the bytes take. What the
// design does about it:
// - the product runs on the tensor cores, mma.sync m16n8k16 (bf16 in, f32
//   accumulate) with the WEIGHT as the A operand (16 output channels a
//   tile) and x^T as B (8 rows of x a tile, one or two tiles: M <= 8 or
//   <= 16), so the math is a few instructions a weight byte;
// - the A fragment is built straight from global loads, never through
//   shared memory: the order of the 16 channels inside an mma tile and of
//   the 16 contraction values inside a k-step is free (a permutation the
//   B fragment repeats), so each thread's registers hold whole loads.
//   kn: thread (g, t) of a warp loads, for each of 4 contraction rows,
//   16 contiguous values of the row (16 bytes; int4: 8 bytes), channels
//   16g..16g+15 of the warp's 128, which feed the 8 channel tiles of the
//   warp (tile j takes channels 16g + 2j and 16g + 2j + 1 of each thread).
//   nk: thread (g, t) loads 16 contiguous bytes of rows g and g + 8 of a
//   16-row tile, 16 contraction values (int4: 32) for 4 (8) k-steps;
// - values become bf16 in registers by exact bit operations (int8: the
//   2^23 magic-number trick; fp8: the e4m3 bits shifted into an f32 and
//   scaled by 2^120; int4: the nibble into the magic number, times its
//   group scale, rounded to nearest even), no conversion instructions at
//   the slow rate;
// - x is staged in shared memory, 2048 (kn) or 1024 (nk) contraction values
//   at a time, rows past M zero;
// - kn splits the contraction over the 8 warps of a CTA (each warp a
//   contiguous run of k-steps of each staged chunk, the next two k-steps'
//   weights in flight while two are multiplied, the first two while x is
//   staged), adds the warps' partials
//   in shared memory in warp order, and splits it over CTAs (grid
//   (channel tile, split)) where 128-channel tiles alone would not fill the
//   card: the host picks the split from the shapes and the SM count. A tile
//   over several CTAs writes f32 partials to scratch and the last CTA to
//   arrive, by an atomic ticket on the tile's counter, adds them in split
//   order: repeats are bit-equal, whichever CTA came last;
// - nk gives each warp one 16-row tile over the whole contraction (the
//   head has 8016 of them at llama-3-8b), 4 k-steps' loads in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using kftt::mma_bf16;
using kftt::pack_bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileN = 128;       // kn: channels of a CTA, 16 per thread group
constexpr int kChunkSteps = 128;  // kn: k-steps (16 rows each) staged at once
constexpr int kNkChunk = 1024;    // nk: contraction values staged at once
constexpr int kNkBatch = 4;       // nk: loads of each row in flight
constexpr int kXPad = 8;          // bf16 of padding after a staged x row

enum Scheme : int { kInt8 = 0, kFp8 = 1, kInt4 = 2 };

enum : int {
  kErrScheme = -1,
  kErrRows = -2,
  kErrShape = -3,
  kErrGroup = -4,
  kErrSplit = -5,
};

// Value i of a thread's load of one row, exactly as f32 and unscaled:
// int8 and fp8 take byte i of words w[0..3], int4 nibble i (nibble i % 8
// of word i / 8).
template <int SCHEME>
__device__ __forceinline__ float value(const uint32_t* w, int i) {
  if constexpr (SCHEME == kInt8) {
    // 0x4B0000uu is 2^23 + uu; uu = b + 128 for the signed byte b.
    const uint32_t u = w[i / 4] ^ 0x80808080u;
    return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | (i % 4))) -
           8388736.f;
  } else if constexpr (SCHEME == kFp8) {
    // e4m3 s.eeee.mmm into f32 bits 31 and 26..20: the value times 2^-120
    // (subnormals included), exact; f32 denormals are kept (no -ftz).
    const uint32_t b = (w[i / 4] >> (8 * (i % 4))) & 0xFFu;
    return __uint_as_float(((b & 0x80u) << 24) | ((b & 0x7Fu) << 20)) *
           0x1p120f;
  } else {
    // The nibble's sign bit flipped gives q + 8 in 1..15.
    const uint32_t u = ((w[i / 8] ^ 0x88888888u) >> (4 * (i % 8))) & 0xFu;
    return __uint_as_float(u | 0x4B000000u) - 8388616.f;
  }
}

// Two f32 values holding bf16-exact numbers (int8, fp8) as a bf16 pair:
// their upper halves.
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint2 ld_stream8(const void* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
      : "=r"(v.x), "=r"(v.y)
      : "l"(p));
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Stages x[:, k0 : k0 + rows) into xs ([MP][stride] bf16), zero past M
// and past K. K % 8 == 0, so a 16-byte chunk is all in or all out.
template <int MP>
__device__ __forceinline__ void stage_x(const __nv_bfloat16* __restrict__ x,
                                        __nv_bfloat16* xs, int stride, int m,
                                        int k, int k0, int rows) {
  const int chunks = rows / 8;
  for (int e = threadIdx.x; e < MP * chunks; e += blockDim.x) {
    const int r = e / chunks;
    const int c = (e % chunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < m && k0 + c < k)
      v = *reinterpret_cast<const uint4*>(x + (size_t)r * k + k0 + c);
    *reinterpret_cast<uint4*>(xs + r * stride + c) = v;
  }
}

// ---------------------------------------------------------------------------
// kn: out (M, N) bf16 = x (M, K) @ W, W stored (K, N) (int4: (K, N/2)).
//
// Grid (N / 128 tiles, ksplit). CTA (tile, z) takes k-steps [z*spc,
// (z + 1)*spc) of 16 rows each, in chunks of kChunkSteps; inside a chunk
// warp w takes a contiguous run of its steps. Thread (g, t) holds, for
// k-step st, rows 16*st + 4t + r (r = 0..3) of channels n0 + 16g .. + 15:
// mma k-slots 2t, 2t+1, 2t+8, 2t+9 are rows 4t+0..3, and channel tile j's
// mma rows g and g+8 are channels 16g + 2j and 16g + 2j + 1. Its
// accumulators acc[j][mt] are then rows m = 8mt + 2t, +1 of channels
// 16g + 2j, +1.
//
// Shared memory: xs [MP][kChunkSteps*16 + kXPad] bf16, then red
// [kWarps][MP][kTileN] f32 (the warps' partials). Scratch, for ksplit > 1:
// (tiles, ksplit, MP, kTileN) f32; counters (tiles), 0 between calls.
template <int SCHEME, int MT>
__global__ void __launch_bounds__(kThreads, 1) quant_mm_kn_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
    const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
    float* __restrict__ scratch, unsigned* __restrict__ counters, int m,
    int k, int n, int group, int spc, int ksplit) {
  constexpr int MP = 8 * MT;
  constexpr int XS = kChunkSteps * 16 + kXPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem + (size_t)MP * XS * 2);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int tile = blockIdx.x, z = blockIdx.y;
  const int n0 = tile * kTileN;
  const int col = n0 + 16 * g;  // this thread's first channel
  const bool col_live = col < n;  // n % 16 == 0: all 16 or none
  const size_t row_bytes = SCHEME == kInt4 ? (size_t)n / 2 : (size_t)n;
  const uint8_t* qcol = q + (SCHEME == kInt4 ? col / 2 : col);
  const int ksteps = k / 16;
  const int s_begin = z * spc;
  const int s_end = min(ksteps, s_begin + spc);

  float acc[8][MT][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][mt][c] = 0.f;

  auto load = [&](int st, uint32_t (&w)[4][4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint8_t* p = qcol + (size_t)(st * 16 + 4 * t + r) * row_bytes;
      if constexpr (SCHEME == kInt4) {
        const uint2 v = col_live ? ld_stream8(p) : make_uint2(0u, 0u);
        w[r][0] = v.x;
        w[r][1] = v.y;
        w[r][2] = w[r][3] = 0u;
      } else {
        const uint4 v =
            col_live ? ld_stream16(p) : make_uint4(0u, 0u, 0u, 0u);
        w[r][0] = v.x;
        w[r][1] = v.y;
        w[r][2] = v.z;
        w[r][3] = v.w;
      }
    }
  };

  float sc[16];  // int4: the group scales of this thread's 16 channels
  int sc_group = -1;

  // One k-step of this thread: its 4 rows (w) times x's staged columns.
  auto step = [&](int st, int c0, const uint32_t (&w)[4][4]) {
    if constexpr (SCHEME == kInt4) {
      const int gi = st * 16 / group;  // group % 16 == 0: one a k-step
      if (gi != sc_group) {
        sc_group = gi;
        const float4* sp =
            reinterpret_cast<const float4*>(s + (size_t)gi * n + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v =
              col_live ? __ldg(sp + i) : make_float4(0.f, 0.f, 0.f, 0.f);
          sc[4 * i] = v.x;
          sc[4 * i + 1] = v.y;
          sc[4 * i + 2] = v.z;
          sc[4 * i + 3] = v.w;
        }
      }
    }
    const int kl = (st - c0) * 16 + 4 * t;
    uint32_t b[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint2 v =
          *reinterpret_cast<const uint2*>(xs + (mt * 8 + g) * XS + kl);
      b[mt][0] = v.x;
      b[mt][1] = v.y;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t a[4];
      const int i0 = 2 * j, i1 = 2 * j + 1;
      if constexpr (SCHEME == kInt4) {
        a[0] = pack_bf16(value<SCHEME>(w[0], i0) * sc[i0],
                         value<SCHEME>(w[1], i0) * sc[i0]);
        a[1] = pack_bf16(value<SCHEME>(w[0], i1) * sc[i1],
                         value<SCHEME>(w[1], i1) * sc[i1]);
        a[2] = pack_bf16(value<SCHEME>(w[2], i0) * sc[i0],
                         value<SCHEME>(w[3], i0) * sc[i0]);
        a[3] = pack_bf16(value<SCHEME>(w[2], i1) * sc[i1],
                         value<SCHEME>(w[3], i1) * sc[i1]);
      } else {
        a[0] = pack_exact(value<SCHEME>(w[0], i0), value<SCHEME>(w[1], i0));
        a[1] = pack_exact(value<SCHEME>(w[0], i1), value<SCHEME>(w[1], i1));
        a[2] = pack_exact(value<SCHEME>(w[2], i0), value<SCHEME>(w[3], i0));
        a[3] = pack_exact(value<SCHEME>(w[2], i1), value<SCHEME>(w[3], i1));
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_bf16(acc[j][mt], a, b[mt][0], b[mt][1]);
    }
  };

  for (int c0 = s_begin; c0 < s_end; c0 += kChunkSteps) {
    const int csteps = min(kChunkSteps, s_end - c0);
    const int per_warp = (csteps + kWarps - 1) / kWarps;
    const int w_begin = c0 + warp * per_warp;
    const int w_end = min(c0 + csteps, w_begin + per_warp);
    // This warp's first two k-steps are in flight while x is staged; in
    // the loop two more are loaded while two are multiplied.
    uint32_t a0[4][4], a1[4][4];
    if (w_begin < w_end) load(w_begin, a0);
    if (w_begin + 1 < w_end) load(w_begin + 1, a1);
    __syncthreads();  // the previous chunk's readers are done
    stage_x<MP>(x, xs, XS, m, k, c0 * 16, csteps * 16);
    __syncthreads();
    for (int st = w_begin; st < w_end; st += 2) {
      uint32_t b0[4][4], b1[4][4];
      if (st + 2 < w_end) load(st + 2, b0);
      if (st + 3 < w_end) load(st + 3, b1);
      step(st, c0, a0);
      if (st + 1 < w_end) step(st + 1, c0, a1);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          a0[r][c] = b0[r][c];
          a1[r][c] = b1[r][c];
        }
    }
  }

  // The warps' partials, then their sum in warp order.
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r0 = mt * 8 + 2 * t;
      float* dst = red + ((size_t)warp * MP + r0) * kTileN + 16 * g + 2 * j;
      *reinterpret_cast<float2*>(dst) =
          make_float2(acc[j][mt][0], acc[j][mt][2]);
      *reinterpret_cast<float2*>(dst + kTileN) =
          make_float2(acc[j][mt][1], acc[j][mt][3]);
    }
  __syncthreads();

  auto epilogue = [&](float v, int r, int c) {
    if (r >= m || n0 + c >= n) return;
    __nv_bfloat16 o;
    if constexpr (SCHEME == kInt4) {
      o = __float2bfloat16_rn(v);
    } else {
      o = __float2bfloat16_rn(round_bf16(v) * round_bf16(s[n0 + c]));
    }
    out[(size_t)r * n + n0 + c] = o;
  };

  constexpr int kPer = MP * kTileN / kThreads;
  float part[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kThreads;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[(size_t)w * MP * kTileN + e];
    part[i] = v;
  }
  if (ksplit == 1) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      epilogue(part[i], e / kTileN, e % kTileN);
    }
    return;
  }

  float* mine = scratch + ((size_t)tile * ksplit + z) * MP * kTileN;
#pragma unroll
  for (int i = 0; i < kPer; ++i) mine[tid + i * kThreads] = part[i];
  // The ticket: each thread's partials are fenced, then one thread counts
  // this CTA in; the CTA that takes the last ticket sees every partial.
  __threadfence();
  __shared__ int last;
  __syncthreads();
  if (tid == 0) {
    const unsigned ticket = atomicAdd(counters + tile, 1u);
    last = ticket == (unsigned)(ksplit - 1);
    if (last) counters[tile] = 0;  // every split has arrived
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  const float* all = scratch + (size_t)tile * ksplit * MP * kTileN;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kThreads;
    float v = 0.f;
    for (int zz = 0; zz < ksplit; ++zz)
      v += __ldcg(all + (size_t)zz * MP * kTileN + e);
    epilogue(v, e / kTileN, e % kTileN);
  }
}

// ---------------------------------------------------------------------------
// nk: out (M, V) f32 = x (M, K) @ W^T, W stored (V, K) (int4: (V, K/2)).
//
// Warp w of CTA b takes the 16-row tile v0 = 16*(b*kWarps + w). A load is
// 16 bytes of rows v0 + g and v0 + g + 8: bytes 16t.. of each 64-byte
// slice of the row, contraction values kk = L*c + P*t .. + P - 1 (P = 16
// values, L = 64; int4: P = 32, L = 128), which feed P/4 k-steps: in
// sub-step i, mma k-slots 2t, 2t+1, 2t+8, 2t+9 are kk + 4i + 0..3. Its
// accumulators are then rows v0 + g, v0 + g + 8 of x rows 8mt + 2t, +1.
template <int SCHEME, int MT>
__global__ void __launch_bounds__(kThreads, 2) quant_mm_nk_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
    const float* __restrict__ s, float* __restrict__ out, int m, int k,
    int v, int group) {
  constexpr int MP = 8 * MT;
  constexpr int XS = kNkChunk + kXPad;
  constexpr int P = SCHEME == kInt4 ? 32 : 16;  // values of one load
  constexpr int L = 4 * P;                      // values of one slice
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int v0 = 16 * (blockIdx.x * kWarps + warp);
  const int ra = v0 + g, rb = v0 + g + 8;
  const bool live_a = ra < v, live_b = rb < v;
  const size_t row_bytes = SCHEME == kInt4 ? (size_t)k / 2 : (size_t)k;
  const uint8_t* qa = q + (size_t)ra * row_bytes + 16 * t;
  const uint8_t* qb = q + (size_t)rb * row_bytes + 16 * t;
  const int groups = SCHEME == kInt4 ? k / group : 1;

  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[mt][c] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kNkChunk) {
    const int rows = min(kNkChunk, k - k0);
    __syncthreads();
    stage_x<MP>(x, xs, XS, m, k, k0, rows);
    __syncthreads();
    if (v0 >= v) continue;
    const int slices = rows / L;  // k % L == 0
    for (int c0 = 0; c0 < slices; c0 += kNkBatch) {
      uint4 wa[kNkBatch], wb[kNkBatch];
#pragma unroll
      for (int u = 0; u < kNkBatch; ++u) {
        const size_t off = ((size_t)(k0 / L + c0 + u) * 64);
        const bool in = c0 + u < slices;
        wa[u] = in && live_a ? ld_stream16(qa + off)
                             : make_uint4(0u, 0u, 0u, 0u);
        wb[u] = in && live_b ? ld_stream16(qb + off)
                             : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kNkBatch; ++u) {
        if (c0 + u >= slices) break;
        const int kk = (c0 + u) * L + P * t;  // inside the staged chunk
        float sa = 1.f, sb = 1.f;
        if constexpr (SCHEME == kInt4) {
          const int gi = (k0 + kk) / group;  // group % 32 == 0
          sa = live_a ? __ldg(s + (size_t)ra * groups + gi) : 0.f;
          sb = live_b ? __ldg(s + (size_t)rb * groups + gi) : 0.f;
        }
        const uint32_t ua[4] = {wa[u].x, wa[u].y, wa[u].z, wa[u].w};
        const uint32_t ub[4] = {wb[u].x, wb[u].y, wb[u].z, wb[u].w};
#pragma unroll
        for (int i = 0; i < P / 4; ++i) {
          uint32_t a[4];
          const int i0 = 4 * i;
          if constexpr (SCHEME == kInt4) {
            a[0] = pack_bf16(value<SCHEME>(ua, i0) * sa,
                             value<SCHEME>(ua, i0 + 1) * sa);
            a[1] = pack_bf16(value<SCHEME>(ub, i0) * sb,
                             value<SCHEME>(ub, i0 + 1) * sb);
            a[2] = pack_bf16(value<SCHEME>(ua, i0 + 2) * sa,
                             value<SCHEME>(ua, i0 + 3) * sa);
            a[3] = pack_bf16(value<SCHEME>(ub, i0 + 2) * sb,
                             value<SCHEME>(ub, i0 + 3) * sb);
          } else {
            a[0] = pack_exact(value<SCHEME>(ua, i0),
                              value<SCHEME>(ua, i0 + 1));
            a[1] = pack_exact(value<SCHEME>(ub, i0),
                              value<SCHEME>(ub, i0 + 1));
            a[2] = pack_exact(value<SCHEME>(ua, i0 + 2),
                              value<SCHEME>(ua, i0 + 3));
            a[3] = pack_exact(value<SCHEME>(ub, i0 + 2),
                              value<SCHEME>(ub, i0 + 3));
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint2 bx = *reinterpret_cast<const uint2*>(
                xs + (mt * 8 + g) * XS + kk + i0);
            mma_bf16(acc[mt], a, bx.x, bx.y);
          }
        }
      }
    }
  }
  if (v0 >= v) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = mt * 8 + 2 * t;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = r0 + (c & 1);
      const int row = c < 2 ? ra : rb;
      if (r >= m || row >= v) continue;
      float o = round_bf16(acc[mt][c]);
      if constexpr (SCHEME != kInt4) o *= s[row];
      out[(size_t)r * v + row] = o;
    }
  }
}

// Raises `fn`'s dynamic shared-memory limit to `smem` bytes on the
// current device, once per kernel and device: the launches of a decode
// step (7 per layer) pay for it on the first call only.
template <typename Fn>
cudaError_t allow_smem(Fn fn, size_t smem, unsigned* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) *done |= bit;
  return err;
}

size_t kn_smem(int mt) {
  return (size_t)8 * mt * (kChunkSteps * 16 + kXPad) * 2 +
         (size_t)kWarps * 8 * mt * kTileN * 4;
}

size_t nk_smem(int mt) { return (size_t)8 * mt * (kNkChunk + kXPad) * 2; }

template <int SCHEME, int MT>
int launch_kn(const void* x, const void* q, const void* s, void* out,
              void* scratch, void* counters, int m, int k, int n, int group,
              int spc, int ksplit, cudaStream_t stream) {
  auto fn = quant_mm_kn_kernel<SCHEME, MT>;
  const size_t smem = kn_smem(MT);
  static unsigned done = 0;  // one per instantiation
  if (cudaError_t err = allow_smem(fn, smem, &done)) return (int)err;
  const dim3 grid((n + kTileN - 1) / kTileN, ksplit);
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(scratch), static_cast<unsigned*>(counters), m, k,
      n, group, spc, ksplit);
  return (int)cudaGetLastError();
}

template <int SCHEME, int MT>
int launch_nk(const void* x, const void* q, const void* s, void* out, int m,
              int k, int v, int group, cudaStream_t stream) {
  auto fn = quant_mm_nk_kernel<SCHEME, MT>;
  const size_t smem = nk_smem(MT);
  static unsigned done = 0;  // one per instantiation
  if (cudaError_t err = allow_smem(fn, smem, &done)) return (int)err;
  const int tiles = (v + 15) / 16;
  const dim3 grid((tiles + kWarps - 1) / kWarps);
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(s), static_cast<float*>(out), m, k, v, group);
  return (int)cudaGetLastError();
}

// The refusals both entry points share.
int check(int scheme, int m, int group) {
  if (scheme != kInt8 && scheme != kFp8 && scheme != kInt4) return kErrScheme;
  if (m <= 0 || m > 16) return kErrRows;
  if (scheme == kInt4 && (group <= 0 || group % 32)) return kErrGroup;
  return 0;
}

}  // namespace

extern "C" {

// out (M, N) bf16 = x (M, K) bf16 @ W, W a layer weight stored (K, N)
// int8 / fp8 e4m3 bytes with s (N,) f32, or (K, N/2) packed int4 with s
// (K / group, N) f32. K % 16 == 0, N % 16 == 0, M <= 16. CTAs (N / 128
// rounded up, ksplit) each take `spc` k-steps of 16 rows; ksplit * spc
// covers K / 16. Launches on `stream` and returns cudaGetLastError() (0 on
// success), or a negative code for a shape this kernel does not take.
// Allocates nothing: `scratch` holds ceil(N / 128) * ksplit * 16 * 128
// floats when ksplit > 1 and `counters` ceil(N / 128) unsigned ints, 0
// before the call and 0 again after it.
int kftt_quant_matmul_kn(const void* x, const void* q, const void* s,
                         void* out, void* scratch, void* counters, int m,
                         int k, int n, int scheme, int group, int spc,
                         int ksplit, void* stream) {
  if (int err = check(scheme, m, group)) return err;
  if (k <= 0 || n <= 0 || k % 16 || n % 16) return kErrShape;
  if (spc <= 0 || ksplit <= 0 || (long long)spc * ksplit < k / 16 ||
      (long long)spc * (ksplit - 1) >= k / 16)
    return kErrSplit;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool two = m > 8;
  switch (scheme) {
    case kInt8:
      return two ? launch_kn<kInt8, 2>(x, q, s, out, scratch, counters, m, k,
                                       n, group, spc, ksplit, st)
                 : launch_kn<kInt8, 1>(x, q, s, out, scratch, counters, m, k,
                                       n, group, spc, ksplit, st);
    case kFp8:
      return two ? launch_kn<kFp8, 2>(x, q, s, out, scratch, counters, m, k,
                                      n, group, spc, ksplit, st)
                 : launch_kn<kFp8, 1>(x, q, s, out, scratch, counters, m, k,
                                      n, group, spc, ksplit, st);
    default:
      return two ? launch_kn<kInt4, 2>(x, q, s, out, scratch, counters, m, k,
                                       n, group, spc, ksplit, st)
                 : launch_kn<kInt4, 1>(x, q, s, out, scratch, counters, m, k,
                                       n, group, spc, ksplit, st);
  }
}

// out (M, V) f32 = x (M, K) bf16 @ W^T, W the lm head stored (V, K) int8 /
// fp8 e4m3 bytes with s (V,) f32, or (V, K/2) packed int4 with s (V, K /
// group) f32. K % 64 == 0 (int4: K % 128 == 0), M <= 16. Same return
// codes; no scratch.
int kftt_quant_matmul_nk(const void* x, const void* q, const void* s,
                         void* out, int m, int k, int v, int scheme,
                         int group, void* stream) {
  if (int err = check(scheme, m, group)) return err;
  if (k <= 0 || v <= 0 || k % (scheme == kInt4 ? 128 : 64)) return kErrShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool two = m > 8;
  switch (scheme) {
    case kInt8:
      return two ? launch_nk<kInt8, 2>(x, q, s, out, m, k, v, group, st)
                 : launch_nk<kInt8, 1>(x, q, s, out, m, k, v, group, st);
    case kFp8:
      return two ? launch_nk<kFp8, 2>(x, q, s, out, m, k, v, group, st)
                 : launch_nk<kFp8, 1>(x, q, s, out, m, k, v, group, st);
    default:
      return two ? launch_nk<kInt4, 2>(x, q, s, out, m, k, v, group, st)
                 : launch_nk<kInt4, 1>(x, q, s, out, m, k, v, group, st);
  }
}

const char* kftt_error_string(int code) {
  switch (code) {
    case kErrScheme: return "scheme must be 0 (int8), 1 (fp8) or 2 (int4)";
    case kErrRows: return "x must have 1 to 16 rows";
    case kErrShape: return "kn needs K and N multiples of 16; nk needs K a multiple of 64 (int4: 128)";
    case kErrGroup: return "the int4 group must be a positive multiple of 32";
    case kErrSplit: return "ksplit runs of spc k-steps must cover K / 16 with none empty";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
