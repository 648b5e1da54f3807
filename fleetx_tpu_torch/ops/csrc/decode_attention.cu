// Single-query decode attention over the contiguous cache and over paged
// pools, in the operand dtype or int8, for NVIDIA Hopper (sm_90a).
//
// Replaces the four TPU kernels of fleetx_tpu/ops/pallas/decode_attention.py,
// which share one online-softmax body (`_decode_kernel`, :243) and differ
// in how a K/V row is found and loaded:
//
//   B7  `_decode_kernel` (:243) via `flash_decode_attention` (:361):
//       contiguous cache, K/V in the operand dtype T;
//   B9  `_decode_kernel_q8` (:329): the same over int8 K/V with one fp32
//       scale per cached (position, head) vector;
//   B8  `_paged_decode_kernel` (:465) via `flash_decode_paged_attention`
//       (:525): K/V in T in [num_pages, page_size, h, d] pools, reached
//       through each row's block table; the Pallas kernel is
//       `_decode_kernel` with the page as its tile (`major = page_size`),
//       and so is this one: the paged body over T pools, block_k the page's;
//   B10 `_paged_decode_kernel_q8` (:479): the same over int8 K/V and scale
//       pools.
//
// For every (batch row b, head h) it computes softmax(q·kᵀ/√d)·v of one
// query against the row's window [starts[b], ends[b]) of cached positions:
//
//   q        [b, 1, h, d]                           T (bf16 or fp32)
//   k, v     [b, length, h, d]  (contiguous)        T, or int8 with
//            [num_pages, page_size, h, d] (paged)   k_scale, v_scale [.., h, 1] fp32
//   tables   [b, n_logical] int32 (paged only)
//   starts, ends [b] int32;  out [b, 1, h, d] T
//
// Numerics follow the TPU kernel: int8 values dequantize as
// (fp32)int8 * scale, rounded to T; scores accumulate in fp32 over operands
// in T; p is taken against the running max as it stands after each
// `block_k`-wide tile of positions (tiles aligned at multiples of block_k
// from position 0, block_k the TPU kernel's own) and rounded to T before
// the p·v product; the normaliser sums the unrounded p; the running max
// starts at -1e30; positions outside the window contribute nothing (they
// are never read); an empty window divides by 1.
//
// Bound on this card: HBM bytes. Per launch the kernel must read every live
// K and V vector once (live * h * d * 2 * sizeof(T); at int8
// live * h * (d + 4) * 2 with the scales, plus the live table entries when
// paged) and does ~4 * d flops per live position and head, far below the
// tensor cores' balance point.
//
// Design (simple first; split-K over the window, cp.async/TMA staging and
// a persistent grid are later work): one 128-thread block per (h, b). A
// position's d-vector is loaded by d*sizeof(S)/16 threads with one 16-byte
// load each, so a pass has 128*16/(d*sizeof(S)) positions in flight, and
// each thread starts four passes' loads before it uses them. The window is
// walked in chunks of up to 256 positions (whole tiles): the chunk's scores
// go to shared memory; each warp takes the maximum of some of its tiles;
// warp 0 scans those into the running max after each tile; then every
// thread accumulates round(p) * exp(m_tile - m_chunk) * v for its positions
// and columns in fp32 registers, rescaled by exp(m_old - m_new) between
// chunks. The partial sums are reduced over the block at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;           // scores held in shared memory at once
constexpr int kMaxTiles = kChunk / 8;  // block_k is a multiple of 8
constexpr int kUnroll = 4;            // passes whose loads are in flight together
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

// x rounded to T and widened back (the identity for fp32)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

// 16 bytes of K/V storage elements S, widened to fp32
template <typename S>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* out) {
    out[0] = __uint_as_float(r.x);
    out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z);
    out[3] = __uint_as_float(r.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float* out) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 is the high half of an fp32
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  static __device__ __forceinline__ void unpack(const uint4& r, float* out) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      out[i] = static_cast<float>(static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu));
  }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* starts;
  const int* ends;
  void* out;
  int heads;
  int length;     // positions a row can address (cache_len, or n_logical * page_size)
  int n_logical;  // block-table width (paged)
  int page_size;  // (paged)
  int block_k;    // the TPU kernel's tile width: p is rounded against its running max
  float scale;    // 1/sqrt(d)
};

template <typename T, typename S, bool kPaged, int D>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Args a) {
  constexpr bool kQuant = sizeof(S) == 1;
  constexpr int kVec = Vec<S>::N;       // elements per 16-byte load
  constexpr int kTpp = D / kVec;        // threads per position (1..32)
  constexpr int kGroups = kThreads / kTpp;  // positions per pass
  static_assert(D % kVec == 0 && kTpp >= 1 && kTpp <= 32, "unsupported head_dim");

  __shared__ float s_score[kChunk];
  __shared__ float s_tmax[kMaxTiles];    // a tile's max score, then its running max
  __shared__ float s_tscale[kMaxTiles];  // exp(running max of the tile - chunk's max)
  __shared__ float s_red[kWarps][D];
  __shared__ float s_l[kWarps];

  const T* q = static_cast<const T*>(a.q);
  const S* k = static_cast<const S*>(a.k);
  const S* v = static_cast<const S*>(a.v);
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = tid / kTpp;  // the position of a pass this thread helps load
  const int col0 = (tid % kTpp) * kVec;  // its first column

  const size_t row = static_cast<size_t>(b) * a.heads + h;
  float qr[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) qr[i] = to_float(q[row * D + col0 + i]);

  // a window past the row's reach is clamped to it, as the TPU grid is
  const int start = max(a.starts[b], 0);
  const int end = min(a.ends[b], a.length);
  const int* table = kPaged ? a.tables + static_cast<size_t>(b) * a.n_logical : nullptr;
  const size_t row_base = kPaged ? 0 : static_cast<size_t>(b) * a.length;
  // the storage slot (position index in the buffer or pool) of a logical position
  auto slot = [&](int pos) -> size_t {
    if (kPaged)
      return static_cast<size_t>(table[pos / a.page_size]) * a.page_size + pos % a.page_size;
    return row_base + pos;
  };

  float m = kNegInf;  // running max before the current chunk
  float l = 0.f;      // this thread's share of the normaliser
  float acc[kVec];    // this thread's share of the output columns col0..
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;

  if (start < end) {
    const int chunk = (kChunk / a.block_k) * a.block_k;
    for (int cs = (start / a.block_k) * a.block_k; cs < end; cs += chunk) {
      const int lo = max(start, cs);
      const int hi = min(end, cs + chunk);

      // 1. the chunk's scores; the loop bounds are the same for the whole block
      for (int base = lo; base < hi; base += kGroups * kUnroll) {
        uint4 raw[kUnroll];
        float sc[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int pos = base + u * kGroups + group;
          if (pos < hi) {
            const size_t sl = slot(pos);
            raw[u] = *reinterpret_cast<const uint4*>(k + (sl * a.heads + h) * D + col0);
            sc[u] = kQuant ? a.k_scale[sl * a.heads + h] : 1.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int pos = base + u * kGroups + group;
          float dot = 0.f;
          if (pos < hi) {
            float x[kVec];
            Vec<S>::unpack(raw[u], x);
#pragma unroll
            for (int i = 0; i < kVec; ++i)
              dot += qr[i] * (kQuant ? round_to<T>(x[i] * sc[u]) : x[i]);
          }
#pragma unroll
          for (int off = kTpp / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
          if (pos < hi && tid % kTpp == 0) s_score[pos - cs] = dot * a.scale;
        }
      }
      __syncthreads();

      // 2. each live tile's max score (the chunk starts on a tile border)
      const int ntiles = (hi - 1 - cs) / a.block_k + 1;
      for (int t = warp; t < ntiles; t += kWarps) {
        const int t_lo = max(lo, cs + t * a.block_k);
        const int t_hi = min(hi, cs + (t + 1) * a.block_k);
        float mx = kNegInf;
        for (int j = t_lo + lane; j < t_hi; j += 32) mx = fmaxf(mx, s_score[j - cs]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        if (lane == 0) s_tmax[t] = mx;
      }
      __syncthreads();

      // 3. the running max after each tile (a scan over at most 32 tiles)
      if (warp == 0) {
        float run = lane < ntiles ? s_tmax[lane] : kNegInf;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float o = __shfl_up_sync(kFull, run, off);
          if (lane >= off) run = fmaxf(run, o);
        }
        run = fmaxf(run, m);
        const float m_chunk = __shfl_sync(kFull, run, ntiles - 1);
        if (lane < ntiles) {
          s_tmax[lane] = run;
          s_tscale[lane] = expf(run - m_chunk);
        }
      }
      __syncthreads();
      const float m_chunk = s_tmax[ntiles - 1];
      const float alpha = expf(m - m_chunk);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] *= alpha;
      m = m_chunk;

      // 4. round(p) * v for the chunk's live positions
      for (int base = lo; base < hi; base += kGroups * kUnroll) {
        uint4 raw[kUnroll];
        float sc[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int pos = base + u * kGroups + group;
          if (pos < hi) {
            const size_t sl = slot(pos);
            raw[u] = *reinterpret_cast<const uint4*>(v + (sl * a.heads + h) * D + col0);
            sc[u] = kQuant ? a.v_scale[sl * a.heads + h] : 1.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int pos = base + u * kGroups + group;
          if (pos < hi) {
            const int t = (pos - cs) / a.block_k;
            const float p = expf(s_score[pos - cs] - s_tmax[t]);
            const float c = s_tscale[t];
            l += p * c;
            const float w = round_to<T>(p) * c;
            float x[kVec];
            Vec<S>::unpack(raw[u], x);
#pragma unroll
            for (int i = 0; i < kVec; ++i)
              acc[i] += w * (kQuant ? round_to<T>(x[i] * sc[u]) : x[i]);
          }
        }
      }
      __syncthreads();  // the next chunk rewrites s_score and s_tmax
    }
  }

  // 5. sum the partials: over the warp's groups, then over the warps
#pragma unroll
  for (int off = kTpp; off < 32; off <<= 1) {
    l += __shfl_xor_sync(kFull, l, off);
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], off);
  }
  if (lane < kTpp) {  // group 0 of the warp holds the warp's sums
#pragma unroll
    for (int i = 0; i < kVec; ++i) s_red[warp][col0 + i] = acc[i];
  }
  if (lane == 0) s_l[warp] = l;
  __syncthreads();
  if (tid < D) {
    float o = 0.f, n = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      o += s_red[w][tid];
      n += s_l[w];
    }
    static_cast<T*>(a.out)[row * D + tid] = from_float<T>(o / (n > 0.f ? n : 1.f));
  }
}

template <typename T, typename S, bool kPaged>
int launch(int head_dim, int batch, const Args& a, cudaStream_t stream) {
  const dim3 grid(a.heads, batch);
  switch (head_dim) {
    case 16:
      decode_kernel<T, S, kPaged, 16><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 32:
      decode_kernel<T, S, kPaged, 32><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 64:
      decode_kernel<T, S, kPaged, 64><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 128:
      decode_kernel<T, S, kPaged, 128><<<grid, kThreads, 0, stream>>>(a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_kind(int quant, int paged, int head_dim, int batch, const Args& a,
                cudaStream_t stream) {
  if (!quant && !paged) return launch<T, T, false>(head_dim, batch, a, stream);  // B7
  if (quant && !paged) return launch<T, int8_t, false>(head_dim, batch, a, stream);  // B9
  if (!quant) return launch<T, T, true>(head_dim, batch, a, stream);  // B8
  return launch<T, int8_t, true>(head_dim, batch, a, stream);  // B10
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; quant: K/V int8 with fp32 scales; paged:
// K/V (and scales) are pools reached through `tables`. `length` is the
// positions a row can address; `n_logical` and `page_size` describe the
// tables (ignored when not paged). Returns cudaGetLastError() after the
// launch (0 = success); the caller raises on anything else.
extern "C" int decode_attention(int dtype, int quant, int paged, int head_dim, const void* q,
                                const void* k, const void* v, const void* k_scale,
                                const void* v_scale, const void* tables, const void* starts,
                                const void* ends, void* out, int batch, int heads, int length,
                                int n_logical, int page_size, int block_k, float scale,
                                void* stream) {
  if (block_k < 8 || block_k > kChunk || block_k % 8 || (paged && page_size % block_k))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
               static_cast<const int*>(tables), static_cast<const int*>(starts),
               static_cast<const int*>(ends), out, heads, length, n_logical, page_size,
               block_k, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_kind<float>(quant, paged, head_dim, batch, a, st);
  if (dtype == 1) return launch_kind<__nv_bfloat16>(quant, paged, head_dim, batch, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
