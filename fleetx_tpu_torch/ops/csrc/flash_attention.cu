// Flash attention, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the three TPU kernels of fleetx_tpu/ops/pallas/flash_attention.py:
//   flash_fwd      <- `_fwd_kernel`     (:287, via `_fwd_call`, :625)
//   flash_bwd_dq   <- `_bwd_dq_kernel`  (:397, via `_dq_call`, :688)
//   flash_bwd_dkv  <- `_bwd_dkv_kernel` (:502, via `_dkv_call`, :722)
// and, called on one (q block, kv block) pair of a context-parallel ring with
// global offsets, the ring-CP entries `block_fwd_lse`, `block_dq` and
// `block_dkv` (:820-863) that run those kernels with a `meta` of
// [b0, h0, h_local, h_total, q_off, k_off] (`_global_ids`, :273-284).
//
// Operands keep the model layout [b, s, h, d] (any strides over b, s and h,
// the head dim contiguous; the bf16 forward at d 64/128 loads by TMA and
// needs the base and those strides on 16 bytes), so q, k and v are read
// straight out of the fused qkv projection. Outputs (o, dq, dk, dv) are contiguous [b, s, h, d]; lse
// and delta are fp32 [b*h, s]. T is bf16 or fp32; d is 16, 32, 64 or 128;
// s is a multiple of the 64-row tile (the wrapper pads).
//
// Numerics follow the Pallas kernels:
// - scores s = (q·kᵀ)·scale in fp32 over operands in T (scale after the dot;
//   q is loaded unscaled, so dq and dk take ·scale at the end, in fp32);
// - masked scores (causal k_off + k > q_off + q, or k_off + k >= kv_lens[b],
//   a global key count) are -1e30 and their p is exactly 0; a fully masked
//   row emits zeros and lse = m + log(1);
// - the forward takes p against the running max after each 64-wide key
//   tile, sums the UNDROPPED p into the normaliser l, and rounds the dropped
//   p to T before p·V; the backward regenerates p = exp(s - lse), scales dP
//   by the keep mask, uses p∘keep for dV and the undropped p for dS, and
//   rounds p∘keep and dS to T before their products. Accumulation is fp32.
// - dropout keeps a cell iff lowbias32(seed, gbh, q_off + q, k_off + k) &
//   0x7FFFFFFF >= threshold, with scale 1/(1-rate) (`dropout_keep_scale`,
//   :149-170), gbh = (b0 + bh / h_local) * h_total + h0 + bh % h_local the
//   global batch*head id; the hash runs in uint32, so shifts are logical and
//   multiplies wrap. The identity offsets [0, 0, h, h, 0, 0] give gbh = bh
//   and local positions, so an unsharded call computes what it did before
//   the offsets existed, bit for bit.
//
// Bound on this card, at GPT-345M training shapes (b 8, h 16, s 1024, d 64,
// causal, bf16): each causal product is b*h*d*s(s+1) = 8.6 GFLOP against
// 16.8 MB per [b, s, h, d] operand. dQ (3 products) and dK/dV (4) are bound
// by operations at 989 TFLOP/s (0.026 and 0.035 ms); the forward (2
// products, 67.6 MB in and out) narrowly by bytes at 3.35 TB/s (0.020 ms).
// In fp32 all three are bound by operations (67 TFLOP/s on CUDA cores).
//
// Every kernel skips the key (or query) tiles that are wholly masked (past
// the causal diagonal, shifted by q_off - k_off, or past kv_lens - k_off),
// as the Pallas index maps and tile walks clamp (:361-370, :456-465,
// :574-577), and takes p against the running max after each 64-key tile.
//
// The bf16 forward at d 64 and 128 (the training path's), on TMA and
// wgmma: one 384-thread block per (128 query rows, b*h row). Warpgroup 0
// gives its registers up (setmaxnreg) and one of its threads loads, by TMA
// through 4-D tensor maps over the call's [b, s, h, d] strides (so strided
// views of the fused qkv, and heads shards, load as they are), Q once and
// the 64-key K and V tiles into a ring of three stages on mbarriers, each
// tile D/64 boxes of 64 columns with 128-byte swizzle; rows past the
// sequence arrive as zeros. Warpgroups 1 and 2 each own 64 query rows: per
// key tile S = Q·Kᵀ is one wgmma m64n64k16 chain over d with both operands
// in shared memory; scale, masks, running max, p, the undropped row sum,
// the keep mask and the rescale of O run in registers on the accumulator
// layout, whose p∘keep, rounded to bf16 in pairs, is already the register
// A operand of O += P·V (wgmma m64n{d}k16, V through the transpose bit).
// No score or output tile passes through shared memory. The grid walks the
// b*h rows in groups whose K and V fit the L2 together, and within a group
// starts the query blocks with the most key tiles first.
// The other kernels (simple first): one 256-thread block per (q tile, b*h)
// for the forward at d 16/32 and dQ, one per (k tile, b*h) for dK/dV; a
// loop inside the block walks the other operand's 64-row tiles. The
// online-softmax state m and l lives in registers of the four threads that
// own a score row.
// - bf16: operand tiles sit in shared memory as bf16 and every product
//   runs on the tensor cores through `nvcuda::wmma` 16x16x16 fragments
//   with fp32 accumulation, each warp owning fixed 16x16 blocks of the
//   output. Scores and dP land in fp32 shared-memory tiles, where the CUDA
//   cores apply scale, mask, exp, dropout and the casts; the rounded p∘keep
//   and dS go back to shared memory as bf16 operands. dQ, dK and dV stay in
//   accumulator fragments across the loop; the d 16/32 forward's output
//   takes each tile's p·V from shared memory into registers, because the
//   per-row rescale by alpha cannot reach into a fragment.
// - fp32 (the exactness path): tiles staged as fp32; each thread owns a 4x4
//   (or 4 x d/16) register tile of every product, rows ty + 16i and columns
//   tx + 16j, computed with fp32 FMAs on the CUDA cores.
// TMA staging and wgmma for the backward are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

// Shared with the Python wrapper (ctypes.Structure `_FlashParams`): keep the
// field order and types in step.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* out;
  void* dq;
  void* dk;
  void* dv;
  float* lse;
  const float* delta;
  const int* kv_lens;    // [b] or null (every key live)
  long long q_strides[3];  // elements between batches, positions, heads
  long long k_strides[3];
  long long v_strides[3];
  long long do_strides[3];
  int batch;
  int heads;
  int seq;
  int causal;
  float scale;
  int dropout;
  unsigned int threshold;  // int(rate * 2^31)
  float keep_scale;        // float32(1) / float32(1 - rate)
  int seed;
  // global ids of the call (`_global_ids`): batch and head offsets, local and
  // total head counts, and the positions of query and key row 0
  int b0;
  int h0;
  int h_local;
  int h_total;
  int q_off;
  int k_off;
  int pad_;
};

namespace {

constexpr int kTile = 64;  // rows of q and of k per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr int kLDS = kTile + 1;  // padded row of a score tile

constexpr uint32_t kMix1 = 0x7FEB352Du;
constexpr uint32_t kMix2 = 0x846CA68Bu;
constexpr uint32_t kC1 = 0x9E3779B1u;
constexpr uint32_t kC2 = 0x85EBCA77u;
constexpr uint32_t kC3 = 0xC2B2AE3Du;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: what a cast before an MXU product does
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

// the keep scale (0 or keep_scale) of a cell whose hash input is x =
// q·C1 + (bh·C3 + seed) + k·C2 (uint32: the sums wrap, in any order)
__device__ __forceinline__ float keep_of(const FlashParams& p, uint32_t x) {
  x ^= x >> 16;
  x *= kMix1;
  x ^= x >> 15;
  x *= kMix2;
  x ^= x >> 16;
  return (x & 0x7FFFFFFFu) >= p.threshold ? p.keep_scale : 0.f;
}

// dropout keep scale of cell (q, k) of head row bh: 0 or keep_scale
__device__ __forceinline__ float drop_scale(const FlashParams& p, uint32_t bh, uint32_t q,
                                            uint32_t k) {
  return keep_of(p, (q * kC1 + (bh * kC3 + static_cast<uint32_t>(p.seed))) + k * kC2);
}

// live keys of the call's rows: kv_lens is a global key count
__device__ __forceinline__ int live_keys(const FlashParams& p, int b) {
  if (p.kv_lens == nullptr) return p.seq;
  return min(max(p.kv_lens[b] - p.k_off, 0), p.seq);
}

// the global batch*head id of local row bh, which keys the dropout hash
__device__ __forceinline__ uint32_t global_bh(const FlashParams& p, int bh) {
  return static_cast<uint32_t>((p.b0 + bh / p.h_local) * p.h_total + p.h0 + bh % p.h_local);
}

// key tiles a causal block of `rows` queries starting at q0 reaches: its
// last row sees local keys up to q0 + rows - 1 + (q_off - k_off)
__device__ __forceinline__ int causal_key_tiles(const FlashParams& p, int q0, int rows = kTile) {
  const int last = q0 + rows - 1 + p.q_off - p.k_off;
  return last < 0 ? 0 : last / kTile + 1;
}

// the first q tile that sees any key of a causal key tile starting at k0
__device__ __forceinline__ int causal_first_q_tile(const FlashParams& p, int k0) {
  const int first = k0 - (p.q_off - p.k_off);
  return first <= 0 ? 0 : first / kTile;
}

// causal test of local query row q against local key k, in global positions
__device__ __forceinline__ bool causal_live(const FlashParams& p, int q, int k) {
  return !p.causal || p.k_off + k <= p.q_off + q;
}

// a [kTile, D] tile of a [b, s, h, d] operand into shared memory as fp32,
// row pitch LD; `base` points at (b, row 0 of the tile, h, 0)
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* base, long long row_stride) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * LD + c] = to_float(base[r * row_stride + c]);
  }
}

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base, const long long* strides, int b,
                                             int h) {
  return static_cast<const T*>(base) + b * strides[0] + h * strides[2];
}

// offset of (b, pos, h, 0) in a contiguous [b, s, h, d] output
__device__ __forceinline__ size_t out_offset(const FlashParams& p, int b, int pos, int h, int d) {
  return ((static_cast<size_t>(b) * p.seq + pos) * p.heads + h) * d;
}

// ------------------------------------------------------------------ forward

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * kTile * (D + 1) + kTile * D + kTile * kLDS + 2 * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FlashParams p) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  float* sQ = smem;                 // [64][D+1]
  float* sK = sQ + kTile * LD;      // [64][D+1]
  float* sV = sK + kTile * LD;      // [64][D]
  float* sS = sV + kTile * D;       // [64][65]: scores, then rounded p
  float* sAlpha = sS + kTile * kLDS;
  float* sL = sAlpha + kTile;

  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const uint32_t gbh = global_bh(p, bh);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int srow = tid >> 2, spart = tid & 3;  // softmax: 4 threads per row
  const int q0 = qt * kTile;
  const T* Q = head_ptr<T>(p.q, p.q_strides, b, h);
  const T* K = head_ptr<T>(p.k, p.k_strides, b, h);
  const T* V = head_ptr<T>(p.v, p.v_strides, b, h);

  load_tile<T, D, LD>(sQ, Q + q0 * p.q_strides[1], p.q_strides[1]);
  const int kv_len = live_keys(p, b);
  int n_tiles = (kv_len + kTile - 1) / kTile;  // tiles holding any live key
  if (p.causal) n_tiles = min(n_tiles, causal_key_tiles(p, q0));

  float m_run = kNegInf, l_run = 0.f;
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's reads of sK, sV, sS are done
    load_tile<T, D, LD>(sK, K + k0 * p.k_strides[1], p.k_strides[1]);
    load_tile<T, D, D>(sV, V + k0 * p.v_strides[1], p.v_strides[1]);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = sK[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        const bool live = k0 + kc < kv_len && causal_live(p, q0 + r, k0 + kc);
        sS[r * kLDS + kc] = live ? s[i][j] * p.scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax over this tile; each of the 4 threads of a row owns
    // 16 of its columns
    float* row = sS + srow * kLDS + spart * 16;
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float sv = row[c];
      float pv = sv > 0.5f * kNegInf ? expf(sv - m_new) : 0.f;
      psum += pv;  // the normaliser sums the undropped p
      if (p.dropout) pv *= drop_scale(p, gbh, p.q_off + q0 + srow, p.k_off + k0 + spart * 16 + c);
      row[c] = round_to<T>(pv);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m_run - m_new);
    l_run = alpha * l_run + psum;
    m_run = m_new;
    if (spart == 0) sAlpha[srow] = alpha;
    __syncthreads();

    // acc = alpha * acc + p · V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sAlpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pr[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = sS[(ty + 16 * i) * kLDS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = sV[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
    }
  }

  if (spart == 0) {
    const float l_safe = l_run > 0.f ? l_run : 1.f;  // fully masked rows emit zeros
    sL[srow] = l_safe;
    p.lse[static_cast<size_t>(bh) * p.seq + q0 + srow] = m_run + logf(l_safe);
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float l = sL[r];
    T* dst = out + out_offset(p, b, q0 + r, h, D);
#pragma unroll
    for (int j = 0; j < NJ; ++j) dst[tx + 16 * j] = from_float<T>(acc[i][j] / l);
  }
}

// ---------------------------------------------------------------------- dQ

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kLDS + 2 * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const FlashParams p) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  float* sQ = smem;
  float* sDO = sQ + kTile * LD;
  float* sK = sDO + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sDS = sV + kTile * LD;  // [64][65]: dS rounded to T
  float* sLse = sDS + kTile * kLDS;
  float* sDelta = sLse + kTile;

  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const uint32_t gbh = global_bh(p, bh);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kTile;
  const T* Q = head_ptr<T>(p.q, p.q_strides, b, h);
  const T* K = head_ptr<T>(p.k, p.k_strides, b, h);
  const T* V = head_ptr<T>(p.v, p.v_strides, b, h);
  const T* DO = head_ptr<T>(p.dout, p.do_strides, b, h);

  load_tile<T, D, LD>(sQ, Q + q0 * p.q_strides[1], p.q_strides[1]);
  load_tile<T, D, LD>(sDO, DO + q0 * p.do_strides[1], p.do_strides[1]);
  if (tid < kTile) {
    sLse[tid] = p.lse[static_cast<size_t>(bh) * p.seq + q0 + tid];
    sDelta[tid] = p.delta[static_cast<size_t>(bh) * p.seq + q0 + tid];
  }
  const int kv_len = live_keys(p, b);
  int n_tiles = (kv_len + kTile - 1) / kTile;
  if (p.causal) n_tiles = min(n_tiles, causal_key_tiles(p, q0));

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<T, D, LD>(sK, K + k0 * p.k_strides[1], p.k_strides[1]);
    load_tile<T, D, LD>(sV, V + k0 * p.v_strides[1], p.v_strides[1]);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float a[4], g[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sQ[(ty + 16 * i) * LD + c];
        g[i] = sDO[(ty + 16 * i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = sK[(tx + 16 * j) * LD + c];
        vv[j] = sV[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        const bool live = k0 + kc < kv_len && causal_live(p, q0 + r, k0 + kc);
        const float pv = live ? expf(s[i][j] * p.scale - sLse[r]) : 0.f;
        float d = dp[i][j];
        // dP = (dO·Vᵀ)∘keep; delta already equals rowsum(p∘dP)
        if (p.dropout) d *= drop_scale(p, gbh, p.q_off + q0 + r, p.k_off + k0 + kc);
        sDS[r * kLDS + kc] = round_to<T>(pv * (d - sDelta[r]));
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float ds[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sDS[(ty + 16 * i) * kLDS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = sK[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
    }
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* dst = dq + out_offset(p, b, q0 + ty + 16 * i, h, D);
#pragma unroll
    for (int j = 0; j < NJ; ++j) dst[tx + 16 * j] = from_float<T>(acc[i][j] * p.scale);
  }
}

// ------------------------------------------------------------------- dK, dV

template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kLDS + 2 * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const FlashParams p) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  float* sK = smem;
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sDO = sQ + kTile * LD;
  float* sP = sDO + kTile * LD;   // [64 q][65]: p∘keep rounded to T
  float* sDS = sP + kTile * kLDS;  // [64 q][65]: dS rounded to T
  float* sLse = sDS + kTile * kLDS;
  float* sDelta = sLse + kTile;

  const int kt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const uint32_t gbh = global_bh(p, bh);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = kt * kTile;
  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
  const int kv_len = live_keys(p, b);

  if (k0 >= kv_len) {  // every score of this key tile is masked
    for (int e = tid; e < kTile * D; e += kThreads) {
      const size_t off = out_offset(p, b, k0 + e / D, h, D) + e % D;
      dk_out[off] = from_float<T>(0.f);
      dv_out[off] = from_float<T>(0.f);
    }
    return;
  }

  const T* Q = head_ptr<T>(p.q, p.q_strides, b, h);
  const T* K = head_ptr<T>(p.k, p.k_strides, b, h);
  const T* V = head_ptr<T>(p.v, p.v_strides, b, h);
  const T* DO = head_ptr<T>(p.dout, p.do_strides, b, h);
  load_tile<T, D, LD>(sK, K + k0 * p.k_strides[1], p.k_strides[1]);
  load_tile<T, D, LD>(sV, V + k0 * p.v_strides[1], p.v_strides[1]);

  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // causal: q tiles before this key tile's diagonal see none of its keys
  const int first = p.causal ? causal_first_q_tile(p, k0) : 0;
  const int n_q = p.seq / kTile;
  for (int qt = first; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, D, LD>(sQ, Q + q0 * p.q_strides[1], p.q_strides[1]);
    load_tile<T, D, LD>(sDO, DO + q0 * p.do_strides[1], p.do_strides[1]);
    if (tid < kTile) {
      sLse[tid] = p.lse[static_cast<size_t>(bh) * p.seq + q0 + tid];
      sDelta[tid] = p.delta[static_cast<size_t>(bh) * p.seq + q0 + tid];
    }
    __syncthreads();

    // scores of (q row ty + 16i, key column tx + 16j)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float a[4], g[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sQ[(ty + 16 * i) * LD + c];
        g[i] = sDO[(ty + 16 * i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = sK[(tx + 16 * j) * LD + c];
        vv[j] = sV[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        const bool live = k0 + kc < kv_len && causal_live(p, q0 + r, k0 + kc);
        const float pv = live ? expf(s[i][j] * p.scale - sLse[r]) : 0.f;
        float d = dp[i][j], pd = pv;
        if (p.dropout) {
          const float keep = drop_scale(p, gbh, p.q_off + q0 + r, p.k_off + k0 + kc);
          pd *= keep;  // dropped probabilities feed dV
          d *= keep;
        }
        sP[r * kLDS + kc] = round_to<T>(pd);
        sDS[r * kLDS + kc] = round_to<T>(pv * (d - sDelta[r]));
      }
    }
    __syncthreads();

    // dV += (p∘keep)ᵀ·dO and dK += dSᵀ·Q, key rows ty + 16i
#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float pr[4], dr[4], go[NJ], qv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = sP[qq * kLDS + ty + 16 * i];
        dr[i] = sDS[qq * kLDS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        go[j] = sDO[qq * LD + tx + 16 * j];
        qv[j] = sQ[qq * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dv[i][j] = fmaf(pr[i], go[j], dv[i][j]);
          dk[i][j] = fmaf(dr[i], qv[j], dk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t off = out_offset(p, b, k0 + ty + 16 * i, h, D);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk_out[off + tx + 16 * j] = from_float<T>(dk[i][j] * p.scale);
      dv_out[off + tx + 16 * j] = from_float<T>(dv[i][j]);
    }
  }
}

// ------------------------------------------------- bf16 tensor-core kernels

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kWarps = kThreads / 32;
constexpr int kLDF = kTile + 4;  // fp32 row pitch of a [64][64] score tile
constexpr int kLDP = kTile + 8;  // bf16 row pitch of a [64][64] p or dS tile

// bf16 row pitch of a [64][D] operand tile, fp32 pitch of a [64][D] output;
// both keep every 16x16 fragment 32-byte aligned
template <int D>
__host__ __device__ constexpr int ldh() { return D + 8; }
template <int D>
__host__ __device__ constexpr int ldo() { return D + 4; }
// accumulator fragments per warp for a [64][D] output (D/4 blocks of 16x16)
template <int D>
__host__ __device__ constexpr int frags() { return D >= 32 ? D / 32 : 1; }

// a [64][D] bf16 tile of a [b, s, h, d] operand into shared memory (pitch
// ldh<D>): 16-byte loads when the rows allow them (always in the model,
// whose q, k, v rows start on 8-element boundaries), else element by element
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* base,
                                               long long row_stride) {
  if (((reinterpret_cast<uintptr_t>(base) | (row_stride * sizeof(bf16))) & 15) == 0) {
    constexpr int kChunks = D / 8;  // 8 bf16 per 16 bytes
    for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 8;
      *reinterpret_cast<uint4*>(dst + r * ldh<D>() + c) =
          *reinterpret_cast<const uint4*>(base + r * row_stride + c);
    }
    return;
  }
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * ldh<D>() + c] = base[r * row_stride + c];
  }
}

// c[64][64] (fp32, pitch kLDF) = a[64][D] · b[64][D]ᵀ over bf16 tiles of
// pitch ldh<D>; warp w computes blocks (w/2, 2(w%2)) and (w/2, 2(w%2)+1)
template <int D>
__device__ __forceinline__ void mm_abt(float* c, const bf16* a, const bf16* b) {
  const int warp = threadIdx.x >> 5, i = warp >> 1;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int j = (warp & 1) * 2 + jj;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBT fb;
      wmma::load_matrix_sync(fa, a + 16 * i * ldh<D>() + 16 * kk, ldh<D>());
      wmma::load_matrix_sync(fb, b + 16 * j * ldh<D>() + 16 * kk, ldh<D>());
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + 16 * i * kLDF + 16 * j, acc, kLDF, wmma::mem_row_major);
  }
}

// acc += op(a) · b for the warp's blocks of a [64][D] output: a is a
// [64][64] bf16 tile of pitch kLDP (op = transpose when kTransA), b a
// [64][D] bf16 tile of pitch ldh<D>. Block t = warp + 8n is (t / (D/16),
// t % (D/16)).
template <int D, bool kTransA>
__device__ __forceinline__ void mm_acc(FragC* acc, const bf16* a, const bf16* b) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < frags<D>(); ++n) {
    const int t = warp + kWarps * n;
    if (t >= D / 4) break;
    const int i = t / (D / 16), j = t % (D / 16);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      FragB fb;
      wmma::load_matrix_sync(fb, b + 16 * kk * ldh<D>() + 16 * j, ldh<D>());
      if constexpr (kTransA) {
        FragAT fa;
        wmma::load_matrix_sync(fa, a + 16 * kk * kLDP + 16 * i, kLDP);
        wmma::mma_sync(acc[n], fa, fb, acc[n]);
      } else {
        FragA fa;
        wmma::load_matrix_sync(fa, a + 16 * i * kLDP + 16 * kk, kLDP);
        wmma::mma_sync(acc[n], fa, fb, acc[n]);
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void store_acc(float* out, const FragC* acc) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < frags<D>(); ++n) {
    const int t = warp + kWarps * n;
    if (t >= D / 4) break;
    const int i = t / (D / 16), j = t % (D / 16);
    wmma::store_matrix_sync(out + 16 * i * ldo<D>() + 16 * j, acc[n], ldo<D>(),
                            wmma::mem_row_major);
  }
}

template <int D>
__device__ __forceinline__ void zero_acc(FragC* acc) {
#pragma unroll
  for (int n = 0; n < frags<D>(); ++n) wmma::fill_fragment(acc[n], 0.f);
}

// shared memory: fp32 tiles first (sizes multiples of 32 bytes), then bf16
template <int D>
constexpr size_t fwd_tc_smem() {
  return sizeof(float) * (kTile * kLDF + kTile * ldo<D>() + 2 * kTile) +
         sizeof(bf16) * (3 * kTile * ldh<D>() + kTile * kLDP);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_tc_kernel(const FlashParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NJ = D / 16;
  float* sS = reinterpret_cast<float*>(smem_raw);  // [64][kLDF]: q·kᵀ
  float* sO = sS + kTile * kLDF;                   // [64][ldo]: this tile's p·V
  float* sAlpha = sO + kTile * ldo<D>();
  float* sL = sAlpha + kTile;
  bf16* sQ = reinterpret_cast<bf16*>(sL + kTile);
  bf16* sK = sQ + kTile * ldh<D>();
  bf16* sV = sK + kTile * ldh<D>();
  bf16* sP = sV + kTile * ldh<D>();  // [64][kLDP]: p∘keep rounded to bf16

  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const uint32_t gbh = global_bh(p, bh);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int srow = tid >> 2, spart = tid & 3;
  const int q0 = qt * kTile;
  const bf16* Q = head_ptr<bf16>(p.q, p.q_strides, b, h);
  const bf16* K = head_ptr<bf16>(p.k, p.k_strides, b, h);
  const bf16* V = head_ptr<bf16>(p.v, p.v_strides, b, h);

  load_tile_bf16<D>(sQ, Q + q0 * p.q_strides[1], p.q_strides[1]);
  const int kv_len = live_keys(p, b);
  int n_tiles = (kv_len + kTile - 1) / kTile;
  if (p.causal) n_tiles = min(n_tiles, causal_key_tiles(p, q0));

  float m_run = kNegInf, l_run = 0.f;
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's reads of sK, sV, sP, sO are done
    load_tile_bf16<D>(sK, K + k0 * p.k_strides[1], p.k_strides[1]);
    load_tile_bf16<D>(sV, V + k0 * p.v_strides[1], p.v_strides[1]);
    __syncthreads();
    mm_abt<D>(sS, sQ, sK);
    __syncthreads();

    const float* row = sS + srow * kLDF + spart * 16;
    float sv[16];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int kg = k0 + spart * 16 + c;
      const bool live = kg < kv_len && causal_live(p, q0 + srow, kg);
      sv[c] = live ? row[c] * p.scale : kNegInf;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    float psum = 0.f;
    bf16* prow = sP + srow * kLDP + spart * 16;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      float pv = sv[c] > 0.5f * kNegInf ? expf(sv[c] - m_new) : 0.f;
      psum += pv;  // the normaliser sums the undropped p
      if (p.dropout) pv *= drop_scale(p, gbh, p.q_off + q0 + srow, p.k_off + k0 + spart * 16 + c);
      prow[c] = __float2bfloat16(pv);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m_run - m_new);
    l_run = alpha * l_run + psum;
    m_run = m_new;
    if (spart == 0) sAlpha[srow] = alpha;
    __syncthreads();

    FragC pv[frags<D>()];
    zero_acc<D>(pv);
    mm_acc<D, false>(pv, sP, sV);
    store_acc<D>(sO, pv);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float a = sAlpha[r];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(acc[i][j], a, sO[r * ldo<D>() + tx + 16 * j]);
    }
  }

  if (spart == 0) {
    const float l_safe = l_run > 0.f ? l_run : 1.f;  // fully masked rows emit zeros
    sL[srow] = l_safe;
    p.lse[static_cast<size_t>(bh) * p.seq + q0 + srow] = m_run + logf(l_safe);
  }
  __syncthreads();
  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float l = sL[r];
    bf16* dst = out + out_offset(p, b, q0 + r, h, D);
#pragma unroll
    for (int j = 0; j < NJ; ++j) dst[tx + 16 * j] = __float2bfloat16(acc[i][j] / l);
  }
}

// the backward kernels: two fp32 score tiles (s, dP) — reused at the end
// to stage a [64][D] output — then four bf16 operand tiles and two bf16
// [64][64] tiles (p∘keep, dS)
template <int D>
constexpr size_t bwd_tc_smem() {
  return sizeof(float) * (2 * kTile * kLDF + 2 * kTile) +
         sizeof(bf16) * (4 * kTile * ldh<D>() + 2 * kTile * kLDP);
}
static_assert(2 * kTile * kLDF >= kTile * ldo<128>(), "output staging fits the score tiles");

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_tc_kernel(const FlashParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NJ = D / 16;
  float* sS = reinterpret_cast<float*>(smem_raw);  // [64][kLDF]: q·kᵀ
  float* sDP = sS + kTile * kLDF;                  // [64][kLDF]: dO·vᵀ
  float* sLse = sDP + kTile * kLDF;
  float* sDelta = sLse + kTile;
  bf16* sQ = reinterpret_cast<bf16*>(sDelta + kTile);
  bf16* sDO = sQ + kTile * ldh<D>();
  bf16* sK = sDO + kTile * ldh<D>();
  bf16* sV = sK + kTile * ldh<D>();
  bf16* sDS = sV + kTile * ldh<D>();  // [64][kLDP]: dS rounded to bf16

  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const uint32_t gbh = global_bh(p, bh);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kTile;
  const bf16* Q = head_ptr<bf16>(p.q, p.q_strides, b, h);
  const bf16* K = head_ptr<bf16>(p.k, p.k_strides, b, h);
  const bf16* V = head_ptr<bf16>(p.v, p.v_strides, b, h);
  const bf16* DO = head_ptr<bf16>(p.dout, p.do_strides, b, h);

  load_tile_bf16<D>(sQ, Q + q0 * p.q_strides[1], p.q_strides[1]);
  load_tile_bf16<D>(sDO, DO + q0 * p.do_strides[1], p.do_strides[1]);
  if (tid < kTile) {
    sLse[tid] = p.lse[static_cast<size_t>(bh) * p.seq + q0 + tid];
    sDelta[tid] = p.delta[static_cast<size_t>(bh) * p.seq + q0 + tid];
  }
  const int kv_len = live_keys(p, b);
  int n_tiles = (kv_len + kTile - 1) / kTile;
  if (p.causal) n_tiles = min(n_tiles, causal_key_tiles(p, q0));

  FragC dq[frags<D>()];
  zero_acc<D>(dq);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile_bf16<D>(sK, K + k0 * p.k_strides[1], p.k_strides[1]);
    load_tile_bf16<D>(sV, V + k0 * p.v_strides[1], p.v_strides[1]);
    __syncthreads();
    mm_abt<D>(sS, sQ, sK);
    mm_abt<D>(sDP, sDO, sV);
    __syncthreads();
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, kc = e % kTile;
      const bool live = k0 + kc < kv_len && causal_live(p, q0 + r, k0 + kc);
      const float pv = live ? expf(sS[r * kLDF + kc] * p.scale - sLse[r]) : 0.f;
      float d = sDP[r * kLDF + kc];
      // dP = (dO·Vᵀ)∘keep; delta already equals rowsum(p∘dP)
      if (p.dropout) d *= drop_scale(p, gbh, p.q_off + q0 + r, p.k_off + k0 + kc);
      sDS[r * kLDP + kc] = __float2bfloat16(pv * (d - sDelta[r]));
    }
    __syncthreads();
    mm_acc<D, false>(dq, sDS, sK);
  }

  __syncthreads();
  store_acc<D>(sS, dq);  // staged [64][ldo]
  __syncthreads();
  bf16* out = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    bf16* dst = out + out_offset(p, b, q0 + r, h, D);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dst[tx + 16 * j] = __float2bfloat16(sS[r * ldo<D>() + tx + 16 * j] * p.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_tc_kernel(const FlashParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NJ = D / 16;
  float* sS = reinterpret_cast<float*>(smem_raw);  // [64 q][kLDF]: q·kᵀ
  float* sDP = sS + kTile * kLDF;                  // [64 q][kLDF]: dO·vᵀ
  float* sLse = sDP + kTile * kLDF;
  float* sDelta = sLse + kTile;
  bf16* sK = reinterpret_cast<bf16*>(sDelta + kTile);
  bf16* sV = sK + kTile * ldh<D>();
  bf16* sQ = sV + kTile * ldh<D>();
  bf16* sDO = sQ + kTile * ldh<D>();
  bf16* sP = sDO + kTile * ldh<D>();  // [64 q][kLDP]: p∘keep rounded to bf16
  bf16* sDS = sP + kTile * kLDP;      // [64 q][kLDP]: dS rounded to bf16

  const int kt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const uint32_t gbh = global_bh(p, bh);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = kt * kTile;
  bf16* dk_out = static_cast<bf16*>(p.dk);
  bf16* dv_out = static_cast<bf16*>(p.dv);
  const int kv_len = live_keys(p, b);

  if (k0 >= kv_len) {  // every score of this key tile is masked
    for (int e = tid; e < kTile * D; e += kThreads) {
      const size_t off = out_offset(p, b, k0 + e / D, h, D) + e % D;
      dk_out[off] = __float2bfloat16(0.f);
      dv_out[off] = __float2bfloat16(0.f);
    }
    return;
  }

  const bf16* Q = head_ptr<bf16>(p.q, p.q_strides, b, h);
  const bf16* K = head_ptr<bf16>(p.k, p.k_strides, b, h);
  const bf16* V = head_ptr<bf16>(p.v, p.v_strides, b, h);
  const bf16* DO = head_ptr<bf16>(p.dout, p.do_strides, b, h);
  load_tile_bf16<D>(sK, K + k0 * p.k_strides[1], p.k_strides[1]);
  load_tile_bf16<D>(sV, V + k0 * p.v_strides[1], p.v_strides[1]);

  FragC dk[frags<D>()], dv[frags<D>()];
  zero_acc<D>(dk);
  zero_acc<D>(dv);
  // earlier q tiles see none of these keys
  const int first = p.causal ? causal_first_q_tile(p, k0) : 0;
  const int n_q = p.seq / kTile;
  for (int qt = first; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile_bf16<D>(sQ, Q + q0 * p.q_strides[1], p.q_strides[1]);
    load_tile_bf16<D>(sDO, DO + q0 * p.do_strides[1], p.do_strides[1]);
    if (tid < kTile) {
      sLse[tid] = p.lse[static_cast<size_t>(bh) * p.seq + q0 + tid];
      sDelta[tid] = p.delta[static_cast<size_t>(bh) * p.seq + q0 + tid];
    }
    __syncthreads();
    mm_abt<D>(sS, sQ, sK);
    mm_abt<D>(sDP, sDO, sV);
    __syncthreads();
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, kc = e % kTile;
      const bool live = k0 + kc < kv_len && causal_live(p, q0 + r, k0 + kc);
      const float pv = live ? expf(sS[r * kLDF + kc] * p.scale - sLse[r]) : 0.f;
      float d = sDP[r * kLDF + kc], pd = pv;
      if (p.dropout) {
        const float keep = drop_scale(p, gbh, p.q_off + q0 + r, p.k_off + k0 + kc);
        pd *= keep;  // dropped probabilities feed dV
        d *= keep;
      }
      sP[r * kLDP + kc] = __float2bfloat16(pd);
      sDS[r * kLDP + kc] = __float2bfloat16(pv * (d - sDelta[r]));
    }
    __syncthreads();
    mm_acc<D, true>(dv, sP, sDO);  // dV += (p∘keep)ᵀ·dO
    mm_acc<D, true>(dk, sDS, sQ);  // dK += dSᵀ·Q
  }

  // stage dK, then dV, through the score tiles
  __syncthreads();
  store_acc<D>(sS, dk);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    bf16* dst = dk_out + out_offset(p, b, k0 + r, h, D);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dst[tx + 16 * j] = __float2bfloat16(sS[r * ldo<D>() + tx + 16 * j] * p.scale);
  }
  __syncthreads();
  store_acc<D>(sS, dv);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    bf16* dst = dv_out + out_offset(p, b, k0 + r, h, D);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dst[tx + 16 * j] = __float2bfloat16(sS[r * ldo<D>() + tx + 16 * j]);
  }
}

// ------------------------------------- bf16 forward on TMA and wgmma (d 64, 128)

namespace wg {

using namespace hopper;

constexpr int kRowsQ = 128;     // query rows of a block: 64 per consumer warpgroup
constexpr int kConsumers = 2;   // warpgroups 1 and 2; warpgroup 0 loads
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kStages = 3;      // K/V tiles in flight
constexpr int kBox = 64;        // columns of a TMA box: one 128-byte swizzle row
// registers a thread after setmaxnreg: the launch holds 168 a thread
// (65536 / 384, rounded down to 8), the producer keeps 40 of them
constexpr int kLaunchRegs = 168;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs =
    (kLaunchRegs * kThreads - 128 * kProducerRegs) / (128 * kConsumers) / 8 * 8;
// the K and V tiles of the heads that run at once should stay in the 50 MB
// L2 while their query blocks read them again: heads are grouped to this
// many bytes of K and V
constexpr size_t kGroupBytes = 24u << 20;

// every tile is D / kBox boxes of [rows][kBox], 128-byte swizzle, box j
// holding columns kBox·j.. of each row
template <int D>
struct Smem {
  bf16 q[kRowsQ * D];
  bf16 k[kStages][kTile * D];
  bf16 v[kStages][kTile * D];
  uint64_t q_full;            // Q has landed
  uint64_t k_full[kStages];   // a K tile has landed
  uint64_t v_full[kStages];   // a V tile has landed
  uint64_t empty[kStages];    // both tiles of a stage are read (every consumer thread)
};
// the swizzled tiles need 1024-byte aligned addresses: the kernel aligns
// the dynamic shared memory itself
template <int D>
constexpr size_t smem_bytes() { return sizeof(Smem<D>) + 1024; }

// d[0:32] (+)= A·B for one warpgroup: A a K-major [64][16] tile and B a
// K-major [64][16] tile, both in shared memory behind their descriptors;
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0:32] += A·B for one warpgroup: A a [64][16] bf16 tile in registers
// (the accumulator layout of a score tile, two values a register), B an
// N-major [16][64] tile in shared memory (transposed by the descriptor)
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0:64] += A·B for one warpgroup: A a [64][16] bf16 tile in registers
// (the accumulator layout of a score tile, two values a register), B an
// N-major [16][128] tile in shared memory (transposed by the descriptor)
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// O (+)= P·V on one warpgroup's 64 rows: four 16-key steps, P's A
// fragments in registers, V's 16 rows of the step through the transpose
// bit (column boxes kTile·kBox elements apart)
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2], const uint32_t (&pa)[16],
                                           const bf16* v) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
    const uint64_t db = desc(v + kk * 16 * kBox, kTile * kBox * sizeof(bf16), 1024);
    if constexpr (D == 64)
      wgmma_rs_m64n64k16(o, a, db);
    else
      wgmma_rs_m64n128k16(o, a, db);
  }
}

// the online softmax of one warpgroup's [64][64] score tile sc, on the
// accumulator layout (row0 and row0 + 8, columns k0 + 8j + col0 + i):
// scale after the dot; with kMask the causal and kv_lens masks on global
// positions (-1e30, p exactly 0); the running max after the tile; p =
// exp(s - m); the undropped p summed into l; with kDropout the keep mask
// of the global (gbh, q, k) (hrow: the rows' hash terms); p∘keep rounded
// to bf16 in pairs, which are the P·V product's A fragments; alpha, the
// rescale of the rows' O. Branch-free over the 32 values, so that they
// interleave.
template <bool kMask, bool kDropout>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], uint32_t (&pa)[16],
                                             const FlashParams& p, int row0, int k0, int col0,
                                             int kv_len, const uint32_t (&hrow)[2]) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e / 2;
      float x = sc[4 * j + e] * p.scale;
      if constexpr (kMask) {
        const int kg = k0 + 8 * j + col0 + e % 2;
        const bool live = kg < kv_len && causal_live(p, row0 + 8 * r, kg);
        x = live ? x : kNegInf;
      }
      sc[4 * j + e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  float m_new[2], psum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the row's max over its four threads
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    m_new[r] = fmaxf(m[r], mx[r]);
  }
  const uint32_t hcol = static_cast<uint32_t>(p.k_off + k0 + col0) * kC2;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float pv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float x = sc[4 * j + 2 * r + i];
        const float e = expf(x - m_new[r]);
        pv[i] = kMask ? (x > 0.5f * kNegInf ? e : 0.f) : e;
        psum[r] += pv[i];
        if constexpr (kDropout)
          pv[i] *= keep_of(p, hrow[r] + hcol + static_cast<uint32_t>(8 * j + i) * kC2);
      }
      pa[2 * j + r] = pack_bf16(pv[0], pv[1]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
    alpha[r] = expf(m[r] - m_new[r]);
    l[r] = alpha[r] * l[r] + psum[r];
    m[r] = m_new[r];
  }
}

// a consumer: warpgroup c (thread t of it) owns query rows 64c .. 64c + 63
// of the block. Its thread holds, of every [64][n] accumulator, rows
// r0 = warp·16 + lane/4 and r0 + 8, columns 8j + 2·(lane%4) and the next
// (value 4j + 2·half + i): the online softmax runs on that layout, and
// each score tile's p, rounded to bf16 in pairs, is already the A operand
// of the P·V product.
template <int D>
__device__ __forceinline__ void consumer(Smem<D>& s, const FlashParams& p, int c, int t, int b,
                                         int h, int bh, int q0, int n_tiles, int kv_len) {
  const int warp = t / 32, lane = t % 32;
  const int row0 = q0 + c * 64 + warp * 16 + lane / 4;  // local query rows row0, row0 + 8
  const int col0 = 2 * (lane % 4);
  const int q_lo = q0 + c * 64;  // this warpgroup's first row
  // the row terms of the two rows' dropout hash inputs
  const uint32_t row_key = global_bh(p, bh) * kC3 + static_cast<uint32_t>(p.seed);
  const uint32_t hrow[2] = {static_cast<uint32_t>(p.q_off + row0) * kC1 + row_key,
                            static_cast<uint32_t>(p.q_off + row0 + 8) * kC1 + row_key};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const bf16* qw = s.q + c * 64 * kBox;  // this warpgroup's rows of each Q box

  if (n_tiles > 0) mbar_wait(&s.q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTile;
    // S = Q·Kᵀ over D in 16-deep steps (box kk/4, columns 16·(kk%4)..)
    float sc[32];
    mbar_wait(&s.k_full[stage], phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int col = (kk % 4) * 16;
      wgmma_ss_m64n64k16(sc, desc(qw + (kk / 4) * kRowsQ * kBox + col, 16, 1024),
                         desc(s.k[stage] + (kk / 4) * kTile * kBox + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);

    // the masks only where the tile crosses the diagonal or kv_lens for
    // this warpgroup's rows; the keep mask only under dropout
    const bool mask = k0 + kTile > kv_len ||
                      (p.causal && p.k_off + k0 + kTile - 1 > p.q_off + q_lo);
    float alpha[2];
    uint32_t pa[16];
    if (mask) {
      if (p.dropout)
        softmax_tile<true, true>(sc, m, l, alpha, pa, p, row0, k0, col0, kv_len, hrow);
      else
        softmax_tile<true, false>(sc, m, l, alpha, pa, p, row0, k0, col0, kv_len, hrow);
    } else {
      if (p.dropout)
        softmax_tile<false, true>(sc, m, l, alpha, pa, p, row0, k0, col0, kv_len, hrow);
      else
        softmax_tile<false, false>(sc, m, l, alpha, pa, p, row0, k0, col0, kv_len, hrow);
    }
    // O = alpha·O + P·V: the rescale in registers, the product added by wgmma
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    mbar_wait(&s.v_full[stage], phase);
    wgmma_fence();
    pv_product<D>(o, pa, s.v[stage]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    fence_regs(pa);
    mbar_arrive(&s.empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // rows past the sequence (a last block half past the end) are not stored
  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    if (q >= p.seq) continue;
    const float l_safe = l[r] > 0.f ? l[r] : 1.f;  // fully masked rows emit zeros
    if (lane % 4 == 0) p.lse[static_cast<size_t>(bh) * p.seq + q] = m[r] + logf(l_safe);
    bf16* dst = out + out_offset(p, b, q, h, D) + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / l_safe, o[4 * j + 2 * r + 1] / l_safe);
  }
}

// the producer: one thread loads Q once, then keeps the ring of K and V
// tiles full
template <int D>
__device__ __forceinline__ void producer(const CUtensorMap& tq, const CUtensorMap& tk,
                                         const CUtensorMap& tv, Smem<D>& s, int b, int h, int q0,
                                         int n_tiles) {
  constexpr uint32_t kTileBytes = kTile * D * sizeof(bf16);
  mbar_expect_tx(&s.q_full, kRowsQ * D * sizeof(bf16));
#pragma unroll
  for (int j = 0; j < D / kBox; ++j)
    tma_load(s.q + j * kRowsQ * kBox, &tq, &s.q_full, j * kBox, h, q0, b);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_tiles; ++it) {
    mbar_wait(&s.empty[stage], phase ^ 1);  // passes at once on the first round
    mbar_expect_tx(&s.k_full[stage], kTileBytes);
#pragma unroll
    for (int j = 0; j < D / kBox; ++j)
      tma_load(s.k[stage] + j * kTile * kBox, &tk, &s.k_full[stage], j * kBox, h, it * kTile, b);
    mbar_expect_tx(&s.v_full[stage], kTileBytes);
#pragma unroll
    for (int j = 0; j < D / kBox; ++j)
      tma_load(s.v[stage] + j * kTile * kBox, &tv, &s.v_full[stage], j * kBox, h, it * kTile, b);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

}  // namespace wg

// one block per (128 query rows, b·h row): the heads in groups of
// `group` b·h rows, and within a group the query blocks with the most key
// tiles first (under causal masking the last), every head of the group
// before the next block
template <int D>
__global__ void __launch_bounds__(wg::kThreads, 1)
    flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const FlashParams p, int group) {
  using namespace wg;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  Smem<D>& s = *reinterpret_cast<Smem<D>*>(smem_raw + ((1024 - (base & 1023)) & 1023));

  const int n_qb = (p.seq + kRowsQ - 1) / kRowsQ;
  const int g = blockIdx.x / (group * n_qb), in_group = blockIdx.x % (group * n_qb);
  const int heads = min(group, p.batch * p.heads - g * group);
  const int qb = n_qb - 1 - in_group / heads;
  const int bh = g * group + in_group % heads;
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = qb * kRowsQ;
  const int kv_len = live_keys(p, b);
  int n_tiles = (kv_len + kTile - 1) / kTile;  // tiles holding any live key
  if (p.causal) n_tiles = min(n_tiles, causal_key_tiles(p, q0, min(kRowsQ, p.seq - q0)));

  const int wgi = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(&s.q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.k_full[i], 1);
      mbar_init(&s.v_full[i], 1);
      mbar_init(&s.empty[i], 128 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the producer warpgroup gives registers to the consumers' accumulators
  // (launched at 168 a thread: 128 x kProducerRegs + 256 x kConsumerRegs
  // = 384 x 168); a block with no key tile loads nothing
  if (wgi == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && n_tiles > 0) producer<D>(tq, tk, tv, s, b, h, q0, n_tiles);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consumer<D>(s, p, wgi - 1, threadIdx.x - 128 * wgi, b, h, bh, q0, n_tiles, kv_len);
  }
}

// ------------------------------------------------------------------ launch

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const FlashParams& p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.seq / kTile, p.batch * p.heads);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// a TMA map of a [b, s, h, D] bf16 operand (strides in elements over b,
// s and h) whose box is [rows][64] of one (b, h); a dimension of extent 1
// takes the packed stride, which addresses nothing
bool head_map(CUtensorMap* map, const void* base, const long long* strides, const FlashParams& p,
              int D, int rows) {
  const long long sh = p.heads > 1 ? strides[2] : D;
  const long long sb = p.batch > 1 ? strides[0] : strides[1] * p.seq;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(p.heads),
                              static_cast<cuuint64_t>(p.seq), static_cast<cuuint64_t>(p.batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(sh) * sizeof(bf16),
                               static_cast<cuuint64_t>(strides[1]) * sizeof(bf16),
                               static_cast<cuuint64_t>(sb) * sizeof(bf16)};
  const cuuint32_t box[4] = {wg::kBox, 1, static_cast<cuuint32_t>(rows), 1};
  return hopper::tensor_map_bf16(map, base, 4, dims, bytes, box);
}

// the bf16 forward at d 64 and 128: the maps of q, k and v (refused, as
// cudaErrorInvalidValue, for a base or stride off 16 bytes), then one
// block per (128 query rows, b·h row)
template <int D>
int fwd_wg(const FlashParams& p, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, p.q, p.q_strides, p, D, wg::kRowsQ) ||
      !head_map(&tk, p.k, p.k_strides, p, D, kTile) ||
      !head_map(&tv, p.v, p.v_strides, p, D, kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = reinterpret_cast<const void*>(flash_fwd_wg_kernel<D>);
  int err = hopper::set_smem(kernel, wg::smem_bytes<D>());
  if (err != 0) return err;
  err = hopper::check_regs(kernel, wg::kLaunchRegs);
  if (err != 0) return err;
  const int rows = p.batch * p.heads;
  const size_t kv_bytes = 2ull * p.seq * D * sizeof(bf16);  // one head's K and V
  const int group = static_cast<int>(
      std::max<size_t>(1, std::min<size_t>(rows, wg::kGroupBytes / kv_bytes)));
  const int blocks = rows * ((p.seq + wg::kRowsQ - 1) / wg::kRowsQ);
  flash_fwd_wg_kernel<D><<<blocks, wg::kThreads, wg::smem_bytes<D>(), st>>>(tq, tk, tv, p, group);
  return static_cast<int>(cudaGetLastError());
}

// bf16 takes the tensor-core kernels (the forward at d 64 and 128 the TMA
// + wgmma one), fp32 the CUDA-core ones
template <typename T, int D>
int fwd(const FlashParams& p, cudaStream_t st) {
  if constexpr (std::is_same_v<T, bf16> && (D == 64 || D == 128))
    return fwd_wg<D>(p, st);
  else if constexpr (std::is_same_v<T, bf16>)
    return launch(flash_fwd_tc_kernel<D>, fwd_tc_smem<D>(), p, st);
  else
    return launch(flash_fwd_kernel<T, D>, fwd_smem<D>(), p, st);
}
template <typename T, int D>
int bwd_dq(const FlashParams& p, cudaStream_t st) {
  if constexpr (std::is_same_v<T, bf16>)
    return launch(flash_bwd_dq_tc_kernel<D>, bwd_tc_smem<D>(), p, st);
  else
    return launch(flash_bwd_dq_kernel<T, D>, dq_smem<D>(), p, st);
}
template <typename T, int D>
int bwd_dkv(const FlashParams& p, cudaStream_t st) {
  if constexpr (std::is_same_v<T, bf16>)
    return launch(flash_bwd_dkv_tc_kernel<D>, bwd_tc_smem<D>(), p, st);
  else
    return launch(flash_bwd_dkv_kernel<T, D>, dkv_smem<D>(), p, st);
}

#define FLASH_DISPATCH(FN)                                                         \
  do {                                                                             \
    if (p == nullptr || p->seq % kTile != 0)                                       \
      return static_cast<int>(cudaErrorInvalidValue);                              \
    if (p->seq == 0 || p->batch * p->heads == 0) return 0;                         \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                           \
    const bool bf16 = dtype == 1;                                                  \
    if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);  \
    switch (head_dim) {                                                            \
      case 16:                                                                     \
        return bf16 ? FN<__nv_bfloat16, 16>(*p, st) : FN<float, 16>(*p, st);       \
      case 32:                                                                     \
        return bf16 ? FN<__nv_bfloat16, 32>(*p, st) : FN<float, 32>(*p, st);       \
      case 64:                                                                     \
        return bf16 ? FN<__nv_bfloat16, 64>(*p, st) : FN<float, 64>(*p, st);       \
      case 128:                                                                    \
        return bf16 ? FN<__nv_bfloat16, 128>(*p, st) : FN<float, 128>(*p, st);     \
      default:                                                                     \
        return static_cast<int>(cudaErrorInvalidValue);                            \
    }                                                                              \
  } while (0)

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after its
// launch (0 = success); the caller raises on anything else.
extern "C" int flash_fwd(const FlashParams* p, int dtype, int head_dim, void* stream) {
  FLASH_DISPATCH(fwd);
}

extern "C" int flash_bwd_dq(const FlashParams* p, int dtype, int head_dim, void* stream) {
  FLASH_DISPATCH(bwd_dq);
}

extern "C" int flash_bwd_dkv(const FlashParams* p, int dtype, int head_dim, void* stream) {
  FLASH_DISPATCH(bwd_dkv);
}

// sizeof(FlashParams), so the wrapper can check its ctypes mirror
extern "C" int flash_params_size() { return static_cast<int>(sizeof(FlashParams)); }
