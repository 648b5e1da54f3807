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
// the head dim contiguous), so q, k and v are read straight out of the fused
// qkv projection. Outputs (o, dq, dk, dv) are contiguous [b, s, h, d]; lse
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
// Design (simple first): one 256-thread block per (q tile, b*h) for the
// forward and dQ, one per (k tile, b*h) for dK/dV; a loop inside the block
// walks the other operand's 64-row tiles, skipping tiles that are wholly
// masked (past the causal diagonal, shifted by q_off - k_off, or past
// kv_lens - k_off), as the Pallas index maps and tile walks clamp
// (:361-370, :456-465, :574-577). The online-softmax state m and l lives in
// registers of the four threads that own a score row.
// - bf16 (training): operand tiles sit in shared memory as bf16 and every
//   product runs on the tensor cores through `nvcuda::wmma` 16x16x16
//   fragments with fp32 accumulation, each warp owning fixed 16x16 blocks of
//   the output. Scores and dP land in fp32 shared-memory tiles, where the
//   CUDA cores apply scale, mask, exp, dropout and the casts; the rounded
//   p∘keep and dS go back to shared memory as bf16 operands. dQ, dK and dV
//   stay in accumulator fragments across the loop; the forward's output
//   takes each tile's p·V from shared memory into registers, because the
//   per-row rescale by alpha cannot reach into a fragment.
// - fp32 (the exactness path): tiles staged as fp32; each thread owns a 4x4
//   (or 4 x d/16) register tile of every product, rows ty + 16i and columns
//   tx + 16j, computed with fp32 FMAs on the CUDA cores.
// cp.async/TMA staging, wgmma and pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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

// dropout keep scale of cell (q, k) of head row bh: 0 or keep_scale
__device__ __forceinline__ float drop_scale(const FlashParams& p, uint32_t bh, uint32_t q,
                                            uint32_t k) {
  uint32_t x = (q * kC1 + (bh * kC3 + static_cast<uint32_t>(p.seed))) + k * kC2;
  x ^= x >> 16;
  x *= kMix1;
  x ^= x >> 15;
  x *= kMix2;
  x ^= x >> 16;
  return (x & 0x7FFFFFFFu) >= p.threshold ? p.keep_scale : 0.f;
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

// key tiles a causal q tile starting at q0 reaches: its last row sees local
// keys up to q0 + 63 + (q_off - k_off)
__device__ __forceinline__ int causal_key_tiles(const FlashParams& p, int q0) {
  const int last = q0 + kTile - 1 + p.q_off - p.k_off;
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

// bf16 takes the tensor-core kernels, fp32 the CUDA-core ones
template <typename T, int D>
int fwd(const FlashParams& p, cudaStream_t st) {
  if constexpr (std::is_same_v<T, bf16>)
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
