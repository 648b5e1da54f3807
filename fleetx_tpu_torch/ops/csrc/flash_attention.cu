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
// the head dim contiguous), so q, k and v are read straight out of the
// fused qkv projection; the bf16 kernels at d 64/128 load by TMA and need
// the base and those strides (and, for dK/dV, lse and delta) on 16 bytes.
// Outputs (o, dq, dk, dv) are contiguous [b, s, h, d]; lse and delta are
// fp32 [b*h, s]. T is bf16 or fp32; d is 16, 32, 64 or 128; s is a
// multiple of the 64-row tile (the wrapper pads).
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
// :574-577), and the forward takes p against the running max after each
// 64-key tile.
//
// bf16 at d 64 and 128 (every training path's) runs on TMA and wgmma: one
// block per (128 rows of its own operand, b*h row), in which one thread
// (in the forward, of a producer warpgroup that gives its registers up by
// setmaxnreg; in the backward, whose two consumer warpgroups need more
// registers than that split gives them, thread 0 of the consumers) loads,
// by TMA
// through 4-D tensor maps over the call's [b, s, h, d] strides (so strided
// views of the fused qkv, and heads shards, load as they are), the block's
// own operands once and the other side's 64-row tiles into a ring of three
// stages on mbarriers, each tile D/64 boxes of 64 columns with 128-byte
// swizzle; rows past the sequence arrive as zeros and are not stored.
// Two consumer warpgroups each own 64 of the block's rows. Every score tile is
// a wgmma m64n64k16 chain over d with both operands in shared memory; its
// accumulator layout is the register A layout of m64n{d}k16, so the
// elementwise pass (scale, masks, exp, the keep mask), run branch-free in
// registers and rounded to bf16 in pairs, feeds the next product directly
// (the other operand through the transpose bit). No score tile passes
// through shared memory, and no output element is written by two blocks
// (no atomics: two launches give the same bits).
// - forward (B1): own rows Q; per 64-key tile S = Q·Kᵀ, the online softmax
//   (masks only on tiles that cross the diagonal or kv_lens), O = alpha·O +
//   (p∘keep)·V.
// - dQ (B2): own rows Q and dO, with their lse and delta; per key tile S =
//   Q·Kᵀ and dP = dO·Vᵀ, dS = p∘(dP∘keep − delta), dQ += dS·K.
// - dK/dV (B3): own rows K and V; per 64-query tile, streamed with its lse
//   and delta, the transposed Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, whose layout
//   makes (p∘keep)ᵀ and dSᵀ the A operands of dV += (p∘keep)ᵀ·dO and dK +=
//   dSᵀ·Q. The hash keeps its (q, k) order: its row term is the key's.
// The grid walks b*h rows in groups whose streamed operands fit the L2,
// heaviest blocks first.
//
// fp32 (the exactness path), and bf16 at d 16/32: the CUDA-core kernels,
// one 256-thread block per (64-row tile, b*h row), a loop inside the block
// walking the other operand's 64-row tiles. Tiles are staged in shared
// memory as fp32 (bf16 operands convert exactly); each thread owns a 4x4
// (or 4 x d/16) register tile of every product, rows ty + 16i and columns
// tx + 16j, computed with fp32 FMAs; p∘keep and dS are rounded to T before
// their products (`round_to`). The forward's online-softmax state m and l
// lives in registers of the four threads that own a score row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

using bf16 = __nv_bfloat16;

// ------------------------ bf16 forward and backward on TMA and wgmma (d 64, 128)

namespace wg {

using namespace hopper;

// rows of a block's own operand (Q in the forward and dQ, K and V in
// dK/dV): 64 per consumer warpgroup
constexpr int kRows = 128;
constexpr int kConsumers = 2;   // warpgroups 1 and 2; warpgroup 0 loads
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kStages = 3;      // streamed tiles in flight
constexpr int kBox = 64;        // columns of a TMA box: one 128-byte swizzle row
// registers a thread after setmaxnreg: the launch holds 168 a thread
// (65536 / 384, rounded down to 8), the producer keeps 40 of them
constexpr int kLaunchRegs = 168;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs =
    (kLaunchRegs * kThreads - 128 * kProducerRegs) / (128 * kConsumers) / 8 * 8;
// the backward's block: the two consumer warpgroups alone, one of whose
// threads also keeps the ring full. Its consumers need more than 224
// registers at d 128 (dK and dV, 64 + 64 fp32 a thread, beside the two
// 32-value score tiles), which neither the forward's setmaxnreg split
// (ptxas kept the code after setmaxnreg.inc near the launch's 168 and
// spilled) nor a producer warp beside them (288 threads: 224 a thread)
// gives; 256 threads launch at up to 255 each
constexpr int kBwdThreads = 128 * kConsumers;
// the streamed tiles of the heads that run at once (K and V; Q and dO in
// dK/dV) should stay in the 50 MB L2 while the heads' other blocks read
// them again: heads are grouped to this many bytes of the two operands
constexpr size_t kGroupBytes = 24u << 20;

// every tile is D / kBox boxes of [rows][kBox], 128-byte swizzle, box j
// holding columns kBox·j.. of each row
template <int D>
struct Smem {
  bf16 q[kRows * D];
  bf16 k[kStages][kTile * D];
  bf16 v[kStages][kTile * D];
  uint64_t q_full;            // Q has landed
  uint64_t k_full[kStages];   // a K tile has landed
  uint64_t v_full[kStages];   // a V tile has landed
  uint64_t empty[kStages];    // both tiles of a stage are read (every consumer thread)
};

// dQ: Q and dO of the block's rows once, 64-key K and V tiles streamed
template <int D>
struct DqSmem {
  bf16 q[kRows * D];
  bf16 dout[kRows * D];
  bf16 k[kStages][kTile * D];
  bf16 v[kStages][kTile * D];
  uint64_t q_full;          // Q and dO have landed
  uint64_t full[kStages];   // the K and V tiles of a stage have landed
  uint64_t empty[kStages];  // a stage is read (every consumer thread)
};

// dK/dV: K and V of the block's rows once, 64-query Q and dO tiles
// streamed with the tile's lse and delta
template <int D>
struct DkvSmem {
  bf16 k[kRows * D];
  bf16 v[kRows * D];
  bf16 q[kStages][kTile * D];
  bf16 dout[kStages][kTile * D];
  float lse[kStages][kTile];
  float delta[kStages][kTile];
  uint64_t kv_full;         // K and V have landed
  uint64_t full[kStages];   // Q, dO, lse and delta of a stage have landed
  uint64_t empty[kStages];  // a stage is read (every consumer thread)
};

// the swizzled tiles need 1024-byte aligned addresses: the kernel aligns
// the dynamic shared memory itself
template <typename S>
constexpr size_t smem_bytes() { return sizeof(S) + 1024; }

template <typename S>
__device__ __forceinline__ S& smem_of(unsigned char* raw) {
  const uint32_t base = smem_u32(raw);
  return *reinterpret_cast<S*>(raw + ((1024 - (base & 1023)) & 1023));
}

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

// acc = A·Bᵀ on one warpgroup: A its 64 rows of a [a_rows][D] tile
// (a_rows apart between column boxes), B a [64][D] tile, both K-major in
// shared memory; over D in 16-deep steps (box kk/4, columns 16·(kk%4)..).
// Issued, not waited for.
template <int D>
__device__ __forceinline__ void ss_product(float (&acc)[32], const bf16* a, int a_rows,
                                           const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = (kk % 4) * 16;
    wgmma_ss_m64n64k16(acc, desc(a + (kk / 4) * a_rows * kBox + col, 16, 1024),
                       desc(b + (kk / 4) * kTile * kBox + col, 16, 1024), kk > 0);
  }
}

// acc += A·B on one warpgroup's 64 rows, four 16-deep steps: A a
// [64][64] bf16 tile in registers (a score tile's accumulator layout,
// rounded in pairs), B a [64][D] tile in shared memory whose rows are the
// depth (V for O += P·V; K for dQ += dS·K; dO and Q for dV += Pᵀ·dO and
// dK += dSᵀ·Q), through the transpose bit (column boxes kTile·kBox
// elements apart). Issued, not waited for.
template <int D>
__device__ __forceinline__ void rs_product(float (&acc)[D / 2], const uint32_t (&pa)[16],
                                           const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
    const uint64_t db = desc(b + kk * 16 * kBox, kTile * kBox * sizeof(bf16), 1024);
    if constexpr (D == 64)
      wgmma_rs_m64n64k16(acc, a, db);
    else
      wgmma_rs_m64n128k16(acc, a, db);
  }
}

// f(kMask, kDropout) with the two flags as compile-time constants
// (std::integral_constant), so that a tile's elementwise pass is
// instantiated without the masks where no cell of it is masked
template <typename F>
__device__ __forceinline__ void with_flags(bool mask, bool dropout, F&& f) {
  using yes = std::true_type;
  using no = std::false_type;
  if (mask)
    dropout ? f(yes{}, yes{}) : f(yes{}, no{});
  else
    dropout ? f(no{}, yes{}) : f(no{}, no{});
}

// a [rows][D] tile of a 4-D tensor map at (row, h, b) into dst: D / kBox
// boxes of [rows][kBox], completing on bar
template <int D>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap& map, uint64_t* bar,
                                         int rows, int h, int row, int b) {
#pragma unroll
  for (int j = 0; j < D / kBox; ++j) tma_load(dst + j * rows * kBox, &map, bar, j * kBox, h, row, b);
}

// this block's (row block, b·h row) in a grid of ceil(s / kRows) blocks
// for every b·h row: the rows in groups of `group`, every row of a group
// before the group's next block, from the last block when `from_last`
// (under causal masking the query blocks with the most key tiles) or from
// the first (the key block that the most query tiles see)
__device__ __forceinline__ int2 walk(const FlashParams& p, int group, bool from_last) {
  const int n_blk = (p.seq + kRows - 1) / kRows;
  const int g = blockIdx.x / (group * n_blk), in_group = blockIdx.x % (group * n_blk);
  const int rows = min(group, p.batch * p.heads - g * group);
  const int blk = in_group / rows;
  return make_int2(from_last ? n_blk - 1 - blk : blk, g * group + in_group % rows);
}

// the backward's ring of n streamed tiles: thread 0 of the block fills
// the stages first, then, at the top of iteration `it`, once both
// warpgroups have read the stage of iteration it - 1, loads iteration
// it - 1 + kStages there (load(stage, iteration)); its warp waits with
// it, so that the warpgroup's wgmma instructions run converged
template <typename Load>
__device__ __forceinline__ void ring_fill(int n, Load&& load) {
  if (threadIdx.x == 0)
    for (int i = 0; i < min(n, kStages); ++i) load(i, i);
}
template <typename Load>
__device__ __forceinline__ void ring_refill(uint64_t* empty, int it, int n, Load&& load) {
  const int prev = it - 1;
  if (threadIdx.x == 0 && prev >= 0 && prev + kStages < n) {
    mbar_wait(&empty[prev % kStages], (prev / kStages) & 1);
    load(prev % kStages, prev + kStages);
  }
  __syncwarp();
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
    float sc[32];  // S = Q·Kᵀ
    mbar_wait(&s.k_full[stage], phase);
    wgmma_fence();
    ss_product<D>(sc, qw, kRows, s.k[stage]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);

    // the masks only where the tile crosses the diagonal or kv_lens for
    // this warpgroup's rows; the keep mask only under dropout
    const bool mask = k0 + kTile > kv_len ||
                      (p.causal && p.k_off + k0 + kTile - 1 > p.q_off + q_lo);
    float alpha[2];
    uint32_t pa[16];
    with_flags(mask, p.dropout, [&](auto km, auto kd) {
      softmax_tile<decltype(km)::value, decltype(kd)::value>(sc, m, l, alpha, pa, p, row0, k0, col0, kv_len, hrow);
    });
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
    rs_product<D>(o, pa, s.v[stage]);
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
  mbar_expect_tx(&s.q_full, kRows * D * sizeof(bf16));
  tma_tile<D>(s.q, tq, &s.q_full, kRows, h, q0, b);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_tiles; ++it) {
    mbar_wait(&s.empty[stage], phase ^ 1);  // passes at once on the first round
    mbar_expect_tx(&s.k_full[stage], kTileBytes);
    tma_tile<D>(s.k[stage], tk, &s.k_full[stage], kTile, h, it * kTile, b);
    mbar_expect_tx(&s.v_full[stage], kTileBytes);
    tma_tile<D>(s.v[stage], tv, &s.v_full[stage], kTile, h, it * kTile, b);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// ---------------------------------------------------------------- dQ (B2)

// dS of one warpgroup's [64 q][64 k] tile on the accumulator layout (rows
// row0 + 8r, keys k0 + 8j + col0 + i) from S = Q·Kᵀ and dP = dO·Vᵀ: p =
// exp(s·scale − lse) regenerated; with kMask the causal and kv_lens masks
// (p exactly 0: a masked cell's exp may overflow, and the select drops
// it); with kDropout dP times the keep mask of the global (gbh, q, k)
// (hrow: the rows' hash terms); dS = p∘(dP − delta), rounded to bf16 in
// pairs, which are the A operand of dQ += dS·K. Branch-free over the 32
// values.
template <bool kMask, bool kDropout>
__device__ __forceinline__ void dq_tile(const float (&sc)[32], const float (&dp)[32],
                                        uint32_t (&ds)[16], const FlashParams& p,
                                        const float (&lse)[2], const float (&delta)[2], int row0,
                                        int k0, int col0, int kv_len, const uint32_t (&hrow)[2]) {
  const uint32_t hcol = static_cast<uint32_t>(p.k_off + k0 + col0) * kC2;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * j + 2 * r + i;
        float pv = expf(sc[e] * p.scale - lse[r]);
        if constexpr (kMask) {
          const int kg = k0 + 8 * j + col0 + i;
          pv = kg < kv_len && causal_live(p, row0 + 8 * r, kg) ? pv : 0.f;
        }
        float d = dp[e];
        if constexpr (kDropout)
          d *= keep_of(p, hrow[r] + hcol + static_cast<uint32_t>(8 * j + i) * kC2);
        v[i] = pv * (d - delta[r]);
      }
      ds[2 * j + r] = pack_bf16(v[0], v[1]);
    }
}

// a dQ block: warpgroup c = threadIdx / 128 owns query rows 64c .. 64c +
// 63 of the block, on the forward's accumulator layout. Thread 0 loads Q
// and dO once and keeps the ring of K and V tiles full. Per key tile S =
// Q·Kᵀ and dP = dO·Vᵀ (one commit group), dS in registers, then dQ +=
// dS·K; dQ·scale is stored at the end.
template <int D>
__device__ __forceinline__ void dq_block(const CUtensorMap& tq, const CUtensorMap& tk,
                                         const CUtensorMap& tv, const CUtensorMap& tdo,
                                         DqSmem<D>& s, const FlashParams& p, int b, int h, int bh,
                                         int q0, int n_tiles, int kv_len) {
  const auto load = [&](int stage, int it) {
    mbar_expect_tx(&s.full[stage], 2 * kTile * D * sizeof(bf16));
    tma_tile<D>(s.k[stage], tk, &s.full[stage], kTile, h, it * kTile, b);
    tma_tile<D>(s.v[stage], tv, &s.full[stage], kTile, h, it * kTile, b);
  };
  if (threadIdx.x == 0 && n_tiles > 0) {  // a block with no key tile loads nothing
    mbar_expect_tx(&s.q_full, 2 * kRows * D * sizeof(bf16));
    tma_tile<D>(s.q, tq, &s.q_full, kRows, h, q0, b);
    tma_tile<D>(s.dout, tdo, &s.q_full, kRows, h, q0, b);
  }
  ring_fill(n_tiles, load);

  const int c = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + c * 64 + warp * 16 + lane / 4;  // local query rows row0, row0 + 8
  const int col0 = 2 * (lane % 4);
  const int q_lo = q0 + c * 64;  // this warpgroup's first row
  const uint32_t row_key = global_bh(p, bh) * kC3 + static_cast<uint32_t>(p.seed);
  uint32_t hrow[2];
  float lse[2], delta[2];  // rows past the sequence take 0 and are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    hrow[r] = static_cast<uint32_t>(p.q_off + q) * kC1 + row_key;
    const size_t at = static_cast<size_t>(bh) * p.seq + q;
    lse[r] = q < p.seq ? p.lse[at] : 0.f;
    delta[r] = q < p.seq ? p.delta[at] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  const bf16* qw = s.q + c * 64 * kBox;  // this warpgroup's rows of each box
  const bf16* dow = s.dout + c * 64 * kBox;

  if (n_tiles > 0) mbar_wait(&s.q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    ring_refill(s.empty, it, n_tiles, load);
    const int stage = it % kStages, k0 = it * kTile;
    float sc[32], dp[32];  // S = Q·Kᵀ, dP = dO·Vᵀ
    mbar_wait(&s.full[stage], (it / kStages) & 1);
    wgmma_fence();
    ss_product<D>(sc, qw, kRows, s.k[stage]);
    ss_product<D>(dp, dow, kRows, s.v[stage]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
    const bool mask = k0 + kTile > kv_len ||
                      (p.causal && p.k_off + k0 + kTile - 1 > p.q_off + q_lo);
    uint32_t ds[16];
    with_flags(mask, p.dropout, [&](auto km, auto kd) {
      dq_tile<decltype(km)::value, decltype(kd)::value>(sc, dp, ds, p, lse, delta, row0, k0,
                                                        col0, kv_len, hrow);
    });
    wgmma_fence();
    rs_product<D>(dq, ds, s.k[stage]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dq);
    fence_regs(ds);
    mbar_arrive(&s.empty[stage]);
  }

  bf16* out = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    if (q >= p.seq) continue;
    bf16* dst = out + out_offset(p, b, q, h, D) + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(dq[4 * j + 2 * r] * p.scale, dq[4 * j + 2 * r + 1] * p.scale);
  }
}

// ------------------------------------------------------------ dK, dV (B3)

// (p∘keep)ᵀ and dSᵀ of one warpgroup's transposed [64 k][64 q] tile on
// the accumulator layout (key rows key0 + 8r, queries q0 + 8j + col0 + i)
// from Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, with each column's lse and delta from
// the stage. The masks as in dq_tile; the keep mask of the same global
// (gbh, q, k), whose hash now takes its row term from the key (k·C2) and
// its column term from the query (q·C1). p∘keep and dS = p∘(dP∘keep −
// delta), rounded to bf16 in pairs, are the A operands of dV += (p∘keep)ᵀ·dO
// and dK += dSᵀ·Q.
template <bool kMask, bool kDropout>
__device__ __forceinline__ void dkv_tile(const float (&st)[32], const float (&dpt)[32],
                                         uint32_t (&pa)[16], uint32_t (&ds)[16],
                                         const FlashParams& p, const float* lse,
                                         const float* delta, int key0, int q0, int col0,
                                         int kv_len, const uint32_t (&hrow)[2]) {
  const uint32_t hcol = static_cast<uint32_t>(p.q_off + q0 + col0) * kC1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse + 8 * j + col0);
    const float2 d2 = *reinterpret_cast<const float2*>(delta + 8 * j + col0);
    const float lc[2] = {l2.x, l2.y}, dc[2] = {d2.x, d2.y};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float pk[2], dsv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * j + 2 * r + i;
        float pv = expf(st[e] * p.scale - lc[i]);
        if constexpr (kMask) {
          const int kr = key0 + 8 * r;
          pv = kr < kv_len && causal_live(p, q0 + 8 * j + col0 + i, kr) ? pv : 0.f;
        }
        float d = dpt[e];
        pk[i] = pv;
        if constexpr (kDropout) {
          const float keep = keep_of(p, hrow[r] + hcol + static_cast<uint32_t>(8 * j + i) * kC1);
          pk[i] = pv * keep;  // dropped probabilities feed dV
          d *= keep;
        }
        dsv[i] = pv * (d - dc[i]);
      }
      pa[2 * j + r] = pack_bf16(pk[0], pk[1]);
      ds[2 * j + r] = pack_bf16(dsv[0], dsv[1]);
    }
  }
}

// a dK/dV block: warpgroup c = threadIdx / 128 owns key rows 64c .. 64c
// + 63 of the block. Thread 0 loads K and V once and keeps the ring of Q
// and dO tiles, with their rows' lse and delta, full. Per query tile the
// transposed tiles Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (one commit group), whose
// accumulator layout makes (p∘keep)ᵀ and dSᵀ the register A operands of
// dV += (p∘keep)ᵀ·dO and dK += dSᵀ·Q: no score tile passes through shared
// memory. A warpgroup whose keys all lie past kv_len, or whose first
// causal query tile comes later than the block's, passes the stages it
// has no work in (and stores zeros where no query sees its keys).
template <int D>
__device__ __forceinline__ void dkv_block(const CUtensorMap& tq, const CUtensorMap& tk,
                                          const CUtensorMap& tv, const CUtensorMap& tdo,
                                          DkvSmem<D>& s, const FlashParams& p, int b, int h,
                                          int bh, int k0, int first, int n_q, int kv_len) {
  const int n = n_q - first;  // the query tiles the block streams
  const float* lse_row = p.lse + static_cast<size_t>(bh) * p.seq;
  const float* delta_row = p.delta + static_cast<size_t>(bh) * p.seq;
  const auto load = [&](int stage, int it) {
    constexpr uint32_t kRowBytes = kTile * sizeof(float);
    const int q0 = (first + it) * kTile;
    mbar_expect_tx(&s.full[stage], 2 * kTile * D * sizeof(bf16) + 2 * kRowBytes);
    tma_tile<D>(s.q[stage], tq, &s.full[stage], kTile, h, q0, b);
    tma_tile<D>(s.dout[stage], tdo, &s.full[stage], kTile, h, q0, b);
    bulk_load(s.lse[stage], lse_row + q0, kRowBytes, &s.full[stage]);
    bulk_load(s.delta[stage], delta_row + q0, kRowBytes, &s.full[stage]);
  };
  if (threadIdx.x == 0 && n > 0) {  // a block with no query tile loads nothing
    mbar_expect_tx(&s.kv_full, 2 * kRows * D * sizeof(bf16));
    tma_tile<D>(s.k, tk, &s.kv_full, kRows, h, k0, b);
    tma_tile<D>(s.v, tv, &s.kv_full, kRows, h, k0, b);
  }
  ring_fill(n, load);

  const int c = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int key0 = k0 + c * 64 + warp * 16 + lane / 4;  // local key rows key0, key0 + 8
  const int col0 = 2 * (lane % 4);
  const int k_lo = k0 + c * 64;  // this warpgroup's first key
  const bool live = k_lo < kv_len;
  const int own_first = p.causal ? causal_first_q_tile(p, k_lo) : 0;
  // the row terms of the two rows' dropout hash inputs: the keys'
  const uint32_t row_key = global_bh(p, bh) * kC3 + static_cast<uint32_t>(p.seed);
  const uint32_t hrow[2] = {static_cast<uint32_t>(p.k_off + key0) * kC2 + row_key,
                            static_cast<uint32_t>(p.k_off + key0 + 8) * kC2 + row_key};
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  const bf16* kw = s.k + c * 64 * kBox;  // this warpgroup's rows of each box
  const bf16* vw = s.v + c * 64 * kBox;

  if (n > 0) mbar_wait(&s.kv_full, 0);
  for (int it = 0; it < n; ++it) {
    ring_refill(s.empty, it, n, load);
    const int stage = it % kStages, q0 = (first + it) * kTile;
    mbar_wait(&s.full[stage], (it / kStages) & 1);
    if (live && first + it >= own_first) {
      float st[32], dpt[32];  // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ
      wgmma_fence();
      ss_product<D>(st, kw, kRows, s.q[stage]);
      ss_product<D>(dpt, vw, kRows, s.dout[stage]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(st);
      fence_acc(dpt);
      const bool mask = k_lo + kTile > kv_len ||
                        (p.causal && p.k_off + k_lo + kTile - 1 > p.q_off + q0);
      uint32_t pa[16], ds[16];
      with_flags(mask, p.dropout, [&](auto km, auto kd) {
        dkv_tile<decltype(km)::value, decltype(kd)::value>(
            st, dpt, pa, ds, p, s.lse[stage], s.delta[stage], key0, q0, col0, kv_len, hrow);
      });
      wgmma_fence();
      rs_product<D>(dv, pa, s.dout[stage]);
      rs_product<D>(dk, ds, s.q[stage]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dv);
      fence_acc(dk);
      fence_regs(pa);
      fence_regs(ds);
    }
    mbar_arrive(&s.empty[stage]);
  }

  bf16* dk_out = static_cast<bf16*>(p.dk);
  bf16* dv_out = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k = key0 + 8 * r;
    if (k >= p.seq) continue;
    const size_t off = out_offset(p, b, k, h, D) + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk_out + off + 8 * j) =
          __floats2bfloat162_rn(dk[4 * j + 2 * r] * p.scale, dk[4 * j + 2 * r + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + off + 8 * j) =
          __floats2bfloat162_rn(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

}  // namespace wg

// one block per (128 query rows, b·h row), walked as `wg::walk` says:
// the heads in groups of `group` b·h rows, and within a group the query
// blocks with the most key tiles first (under causal masking the last)
template <int D>
__global__ void __launch_bounds__(wg::kThreads, 1)
    flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const FlashParams p, int group) {
  using namespace wg;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<D>& s = smem_of<Smem<D>>(smem_raw);

  const int2 at = walk(p, group, true);
  const int bh = at.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = at.x * kRows;
  const int kv_len = live_keys(p, b);
  int n_tiles = (kv_len + kTile - 1) / kTile;  // tiles holding any live key
  if (p.causal) n_tiles = min(n_tiles, causal_key_tiles(p, q0, min(kRows, p.seq - q0)));

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

// dQ: one block per (128 query rows, b·h row), walked as the forward's;
// the key tiles it streams are those the forward's block reads
template <int D>
__global__ void __launch_bounds__(wg::kBwdThreads, 1)
    flash_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo, const FlashParams p,
                           int group) {
  using namespace wg;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DqSmem<D>& s = smem_of<DqSmem<D>>(smem_raw);

  const int2 at = walk(p, group, true);
  const int bh = at.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = at.x * kRows;
  const int kv_len = live_keys(p, b);
  int n_tiles = (kv_len + kTile - 1) / kTile;
  if (p.causal) n_tiles = min(n_tiles, causal_key_tiles(p, q0, min(kRows, p.seq - q0)));

  if (threadIdx.x == 0) {
    mbar_init(&s.q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kBwdThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();
  dq_block<D>(tq, tk, tv, tdo, s, p, b, h, bh, q0, n_tiles, kv_len);
}

// dK/dV: one block per (128 key rows, b·h row), the heads in groups of
// `group` b·h rows and within a group the key blocks that the most query
// tiles see first (under causal masking the first)
template <int D>
__global__ void __launch_bounds__(wg::kBwdThreads, 1)
    flash_bwd_dkv_wg_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo, const FlashParams p,
                            int group) {
  using namespace wg;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DkvSmem<D>& s = smem_of<DkvSmem<D>>(smem_raw);

  const int2 at = walk(p, group, false);
  const int bh = at.y, b = bh / p.heads, h = bh % p.heads;
  const int k0 = at.x * kRows;
  const int kv_len = live_keys(p, b);
  const int n_q = p.seq / kTile;
  // the query tiles that see a key of the block: none when its keys all
  // lie past kv_len; under causal masking those from the one that reaches
  // its first key
  const int first = k0 >= kv_len ? n_q : p.causal ? min(causal_first_q_tile(p, k0), n_q) : 0;

  if (threadIdx.x == 0) {
    mbar_init(&s.kv_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kBwdThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();
  dkv_block<D>(tq, tk, tv, tdo, s, p, b, h, bh, k0, first, n_q, kv_len);
}

// ------------------------------------------------------------------ launch

// the CUDA-core kernels: one block per (64-row tile, b·h row)
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

// the maps of a TMA + wgmma call: q and dO with boxes of q_rows rows, k
// and v of k_rows (dO only when the call has one); false, for the caller
// to refuse as cudaErrorInvalidValue, on a base or stride off 16 bytes
template <int D>
bool wg_maps(CUtensorMap (&m)[4], const FlashParams& p, int q_rows, int k_rows) {
  return head_map(&m[0], p.q, p.q_strides, p, D, q_rows) &&
         head_map(&m[1], p.k, p.k_strides, p, D, k_rows) &&
         head_map(&m[2], p.v, p.v_strides, p, D, k_rows) &&
         (p.dout == nullptr || head_map(&m[3], p.dout, p.do_strides, p, D, q_rows));
}

// the shared memory a TMA + wgmma kernel needs, and its grid: the b·h
// rows grouped so that one group's streamed operands (two of [s, D] bf16
// per row) fit wg::kGroupBytes, times the 128-row blocks of a row.
// Returns (group, blocks), or (0, err).
template <int D>
int2 wg_grid(const void* kernel, size_t smem, const FlashParams& p) {
  const int err = hopper::set_smem(kernel, smem);
  if (err != 0) return make_int2(0, err);
  const int rows = p.batch * p.heads;
  const size_t bytes = 2ull * p.seq * D * sizeof(bf16);
  const int group = static_cast<int>(
      std::max<size_t>(1, std::min<size_t>(rows, wg::kGroupBytes / bytes)));
  return make_int2(group, rows * ((p.seq + wg::kRows - 1) / wg::kRows));
}

// the bf16 forward at d 64 and 128: one block per (128 query rows, b·h row)
template <int D>
int fwd_wg(const FlashParams& p, cudaStream_t st) {
  CUtensorMap m[4];
  if (!wg_maps<D>(m, p, wg::kRows, kTile)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = wg::smem_bytes<wg::Smem<D>>();
  const void* kernel = reinterpret_cast<const void*>(flash_fwd_wg_kernel<D>);
  const int err = hopper::check_regs(kernel, wg::kLaunchRegs);  // the setmaxnreg split
  if (err != 0) return err;
  const int2 g = wg_grid<D>(kernel, smem, p);
  if (g.x == 0) return g.y;
  flash_fwd_wg_kernel<D><<<g.y, wg::kThreads, smem, st>>>(m[0], m[1], m[2], p, g.x);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 dQ at d 64 and 128: one block per (128 query rows, b·h row)
template <int D>
int bwd_dq_wg(const FlashParams& p, cudaStream_t st) {
  CUtensorMap m[4];
  if (!wg_maps<D>(m, p, wg::kRows, kTile)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = wg::smem_bytes<wg::DqSmem<D>>();
  const int2 g = wg_grid<D>(reinterpret_cast<const void*>(flash_bwd_dq_wg_kernel<D>), smem, p);
  if (g.x == 0) return g.y;
  flash_bwd_dq_wg_kernel<D><<<g.y, wg::kBwdThreads, smem, st>>>(m[0], m[1], m[2], m[3], p, g.x);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 dK/dV at d 64 and 128: one block per (128 key rows, b·h row);
// lse and delta arrive by bulk copies, which need them on 16 bytes
template <int D>
int bwd_dkv_wg(const FlashParams& p, cudaStream_t st) {
  CUtensorMap m[4];
  if (!wg_maps<D>(m, p, kTile, wg::kRows) ||
      ((reinterpret_cast<uintptr_t>(p.lse) | reinterpret_cast<uintptr_t>(p.delta)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = wg::smem_bytes<wg::DkvSmem<D>>();
  const int2 g = wg_grid<D>(reinterpret_cast<const void*>(flash_bwd_dkv_wg_kernel<D>), smem, p);
  if (g.x == 0) return g.y;
  flash_bwd_dkv_wg_kernel<D><<<g.y, wg::kBwdThreads, smem, st>>>(m[0], m[1], m[2], m[3], p, g.x);
  return static_cast<int>(cudaGetLastError());
}

// bf16 at d 64 and 128 takes the TMA + wgmma kernels; fp32, and bf16 at
// d 16 and 32, the CUDA-core ones
template <typename T, int D>
constexpr bool kWg = std::is_same_v<T, bf16> && (D == 64 || D == 128);

template <typename T, int D>
int fwd(const FlashParams& p, cudaStream_t st) {
  if constexpr (kWg<T, D>)
    return fwd_wg<D>(p, st);
  else
    return launch(flash_fwd_kernel<T, D>, fwd_smem<D>(), p, st);
}
template <typename T, int D>
int bwd_dq(const FlashParams& p, cudaStream_t st) {
  if constexpr (kWg<T, D>)
    return bwd_dq_wg<D>(p, st);
  else
    return launch(flash_bwd_dq_kernel<T, D>, dq_smem<D>(), p, st);
}
template <typename T, int D>
int bwd_dkv(const FlashParams& p, cudaStream_t st) {
  if constexpr (kWg<T, D>)
    return bwd_dkv_wg<D>(p, st);
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
