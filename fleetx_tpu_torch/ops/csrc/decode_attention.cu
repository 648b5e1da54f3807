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
// Design: the window is split over blocks. A row's reach [0, length) is
// cut into splits of kSplit = 64 positions, and each (split, head, batch
// row) is one 128-thread block, so b·h·ceil(length / 64) blocks cover the
// card (2048 at GPT-345M's serving pools: 8 rows x 16 heads x 16 splits;
// a split outside the row's window exits at once). Two launches:
//
//   decode_scores_kernel: each block computes the fp32 scores of its
//     split's window positions into a scratch [b·h, length], and their
//     max. A position's
//     d-vector is loaded by d·sizeof(S)/16 threads with one 16-byte load
//     each, four passes' loads in flight before their use (a whole split
//     at bf16 d 64: 8 KB a block, ~16 blocks an SM). A paged split reads
//     its (at most nine) table entries once, into shared memory.
//   decode_values_kernel: once every tile maximum of a row is known, every
//     position's weight is fixed, so the window can be cut anywhere. Each
//     block takes the maximum of the row's scores before its first tile
//     and over the whole window (m_final; both from the splits' maxima
//     and at most one split's scores), the maxima of the tiles it
//     touches (whole tiles, though they may reach into other splits: a
//     max is exact in any order) and their running max run_t; then over
//     its own positions it sums round_T(exp(s - run_t))·exp(run_t -
//     m_final)·v and exp(s - run_t)·exp(run_t - m_final), as the plain
//     version writes them, into a partial [d + 1] in the scratch. The last
//     block of a row to finish (an arrival counter, zeroed by the first
//     launch) adds the partials in split order and divides.
//
// No atomics on data: the sums run in one order, so two launches give
// equal bits; only the fp32 association of the sums differs from the
// plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 64;                 // positions of a split
constexpr int kMaxSpans = kSplit / 8 + 1;  // pages or tiles a split touches (both >= 8 wide)
constexpr int kMaxBlockK = 256;            // the widest tile (the TPU kernels' default)
constexpr int kUnroll = 4;                 // passes whose loads are in flight together
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
  float* scores;   // scratch [b·h, length]: the window's fp32 scores
  float* smax;     // scratch [b·h, splits]: each split's max score
  float* partial;  // scratch [b·h, splits, D + 1]: each split's sums
  int* counters;   // scratch [b·h]: the splits of a row that have finished
  int heads;
  int length;     // positions a row can address (cache_len, or n_logical * page_size)
  int n_logical;  // block-table width (paged)
  int page_size;  // (paged)
  int block_k;    // the TPU kernel's tile width: p is rounded against its running max
  int splits;     // ceil(length / kSplit)
  float scale;    // 1/sqrt(d)
};

// one block's share of a row's window: [start, end) clamped to the row's
// reach (as the TPU grid clamps it), and its split's part [lo, hi) of it
struct Window {
  int start, end, lo, hi;
};

__device__ __forceinline__ Window window(const Args& a, int b, int split) {
  Window w;
  w.start = max(a.starts[b], 0);
  w.end = min(a.ends[b], a.length);
  w.lo = max(w.start, split * kSplit);
  w.hi = min(w.end, (split + 1) * kSplit);
  return w;
}

// where a split's K/V vectors are: the storage slot (position index in the
// cache buffer or the pool) of a logical position. A paged split reads its
// table entries once, into shared memory (the caller synchronises).
template <bool kPaged>
struct Slots {
  int* pages;  // shared [kMaxSpans]: the split's table entries
  int first;   // the logical page of pages[0]
  size_t base;

  __device__ __forceinline__ Slots(const Args& a, int b, const Window& w, int* s_pages)
      : pages(s_pages), first(0), base(0) {
    if constexpr (kPaged) {
      first = w.lo / a.page_size;
      const int count = (w.hi - 1) / a.page_size - first + 1;
      if (static_cast<int>(threadIdx.x) < count)
        pages[threadIdx.x] = a.tables[static_cast<size_t>(b) * a.n_logical + first + threadIdx.x];
    } else {
      base = static_cast<size_t>(b) * a.length;
    }
  }

  __device__ __forceinline__ size_t operator()(const Args& a, int pos) const {
    if constexpr (kPaged)
      return static_cast<size_t>(pages[pos / a.page_size - first]) * a.page_size +
             pos % a.page_size;
    return base + pos;
  }
};

// pass 1: the fp32 scores q·k/√d of the split's window positions
template <typename T, typename S, bool kPaged, int D>
__global__ void __launch_bounds__(kThreads) decode_scores_kernel(const Args a) {
  constexpr bool kQuant = sizeof(S) == 1;
  constexpr int kVec = Vec<S>::N;           // elements per 16-byte load
  constexpr int kTpp = D / kVec;            // threads per position (1..32)
  constexpr int kGroups = kThreads / kTpp;  // positions per pass
  static_assert(D % kVec == 0 && kTpp >= 1 && kTpp <= 32, "unsupported head_dim");
  __shared__ int s_pages[kMaxSpans];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(b) * a.heads + h;
  if (split == 0 && tid == 0) a.counters[row] = 0;  // pass 2 counts its arrivals afresh
  const Window w = window(a, b, split);
  if (w.lo >= w.hi) return;  // no position of the window in this split
  const Slots<kPaged> slot(a, b, w, s_pages);
  if constexpr (kPaged) __syncthreads();

  const int group = tid / kTpp;          // the position of a pass this thread helps load
  const int col0 = (tid % kTpp) * kVec;  // its first column
  const T* q = static_cast<const T*>(a.q);
  const S* k = static_cast<const S*>(a.k);
  float qr[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) qr[i] = to_float(q[row * D + col0 + i]);
  float* scores = a.scores + row * a.length;
  float mx = kNegInf;  // the max of the scores this thread wrote

  // the loop bounds are the same for the whole block
  for (int base = w.lo; base < w.hi; base += kGroups * kUnroll) {
    uint4 raw[kUnroll];
    float sc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u * kGroups + group;
      if (pos < w.hi) {
        const size_t sl = slot(a, pos);
        raw[u] = *reinterpret_cast<const uint4*>(k + (sl * a.heads + h) * D + col0);
        sc[u] = kQuant ? a.k_scale[sl * a.heads + h] : 1.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u * kGroups + group;
      float dot = 0.f;
      if (pos < w.hi) {
        float x[kVec];
        Vec<S>::unpack(raw[u], x);
#pragma unroll
        for (int i = 0; i < kVec; ++i) dot += qr[i] * (kQuant ? round_to<T>(x[i] * sc[u]) : x[i]);
      }
#pragma unroll
      for (int off = kTpp / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
      if (pos < w.hi && tid % kTpp == 0) {
        scores[pos] = dot * a.scale;
        mx = fmaxf(mx, dot * a.scale);
      }
    }
  }
  // the split's max score, which pass 2 reads for whole splits
  __shared__ float s_max[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  if ((tid & 31) == 0) s_max[tid >> 5] = mx;
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int i = 1; i < kWarps; ++i) mx = fmaxf(mx, s_max[i]);
    a.smax[row * a.splits + split] = mx;
  }
}

// pass 2: the split's weighted values and normaliser; the last split of
// the row to finish combines them
template <typename T, typename S, bool kPaged, int D>
__global__ void __launch_bounds__(kThreads) decode_values_kernel(const Args a) {
  constexpr bool kQuant = sizeof(S) == 1;
  constexpr int kVec = Vec<S>::N;
  constexpr int kTpp = D / kVec;
  constexpr int kGroups = kThreads / kTpp;
  __shared__ int s_pages[kMaxSpans];
  __shared__ float s_run[kMaxSpans];    // a touched tile's max, then its running max
  __shared__ float s_scale[kMaxSpans];  // exp(running max of the tile - m_final)
  __shared__ float s_max[2][kWarps];    // per warp: max before the first tile, and over all
  __shared__ float s_red[kWarps][D];
  __shared__ float s_l[kWarps];
  __shared__ int s_last;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = static_cast<size_t>(b) * a.heads + h;
  T* out = static_cast<T*>(a.out) + row * D;
  const Window w = window(a, b, split);
  if (w.start >= w.end) {  // an empty window divides by 1
    if (split == 0 && tid < D) out[tid] = from_float<T>(0.f);
    return;
  }
  if (w.lo >= w.hi) return;
  const Slots<kPaged> slot(a, b, w, s_pages);
  const float* scores = a.scores + row * a.length;
  const int bk = a.block_k;
  const int t0 = w.lo / bk;                 // the first tile this split touches
  const int ntiles = (w.hi - 1) / bk - t0 + 1;

  // 1. the window's max before tile t0 (the running max that tile starts
  //    from) and over the whole window (m_final): from the maxima of the
  //    window's splits (the splits before `cut` end at or before tile t0),
  //    and the scores of split `cut` before tile t0
  const int first = w.start / kSplit, last = (w.end - 1) / kSplit;
  const int cut = t0 * bk / kSplit;
  float m_pre = kNegInf, m_all = kNegInf;
  for (int sp = first + tid; sp <= last; sp += kThreads) {
    const float x = a.smax[row * a.splits + sp];
    m_all = fmaxf(m_all, x);
    if (sp < cut) m_pre = fmaxf(m_pre, x);
  }
  for (int pos = max(w.start, cut * kSplit) + tid; pos < t0 * bk; pos += kThreads)
    m_pre = fmaxf(m_pre, scores[pos]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m_pre = fmaxf(m_pre, __shfl_xor_sync(kFull, m_pre, off));
    m_all = fmaxf(m_all, __shfl_xor_sync(kFull, m_all, off));
  }
  if (lane == 0) {
    s_max[0][warp] = m_pre;
    s_max[1][warp] = m_all;
  }
  // 2. the max of each tile the split touches, over the tile's window
  //    positions (some of them in other splits)
  for (int i = warp; i < ntiles; i += kWarps) {
    const int t_lo = max(w.start, (t0 + i) * bk);
    const int t_hi = min(w.end, (t0 + i + 1) * bk);
    float mx = kNegInf;
#pragma unroll 4
    for (int j = t_lo + lane; j < t_hi; j += 32) mx = fmaxf(mx, scores[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    if (lane == 0) s_run[i] = mx;
  }
  __syncthreads();
  // 3. the running max after each touched tile, and its rescale to m_final
  if (tid == 0) {
    float run = kNegInf, m_final = kNegInf;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      run = fmaxf(run, s_max[0][i]);
      m_final = fmaxf(m_final, s_max[1][i]);
    }
    for (int i = 0; i < ntiles; ++i) {
      run = fmaxf(run, s_run[i]);
      s_run[i] = run;
      s_scale[i] = expf(run - m_final);
    }
  }
  __syncthreads();

  // 4. round(p)·exp(run_t - m_final)·v over the split's positions
  const int group = tid / kTpp;
  const int col0 = (tid % kTpp) * kVec;
  const S* v = static_cast<const S*>(a.v);
  float l = 0.f;    // this thread's share of the normaliser
  float acc[kVec];  // this thread's share of the output columns col0..
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
  for (int base = w.lo; base < w.hi; base += kGroups * kUnroll) {
    uint4 raw[kUnroll];
    float sc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u * kGroups + group;
      if (pos < w.hi) {
        const size_t sl = slot(a, pos);
        raw[u] = *reinterpret_cast<const uint4*>(v + (sl * a.heads + h) * D + col0);
        sc[u] = kQuant ? a.v_scale[sl * a.heads + h] : 1.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u * kGroups + group;
      if (pos < w.hi) {
        const int t = pos / bk - t0;
        const float p = expf(scores[pos] - s_run[t]);
        const float c = s_scale[t];
        l += p * c;
        const float wt = round_to<T>(p) * c;
        float x[kVec];
        Vec<S>::unpack(raw[u], x);
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          acc[i] += wt * (kQuant ? round_to<T>(x[i] * sc[u]) : x[i]);
      }
    }
  }

  // 5. the split's sums: over the warp's groups, then over the warps
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
  float* part = a.partial + (row * a.splits + split) * (D + 1);
  if (tid < D) {
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) o += s_red[i][tid];
    part[tid] = o;
  }
  if (tid == 0) {
    float n = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) n += s_l[i];
    part[D] = n;
  }

  // 6. the last split of the row to finish adds the partials in split
  //    order and divides
  __threadfence();  // this block's partial is visible before its arrival
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.counters + row, 1) == last - first;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (tid < D) {
    const float* rows = a.partial + (row * a.splits) * (D + 1);
    float o = 0.f, n = 0.f;
#pragma unroll 4
    for (int s = first; s <= last; ++s) {
      o += __ldcg(rows + s * (D + 1) + tid);
      n += __ldcg(rows + s * (D + 1) + D);
    }
    out[tid] = from_float<T>(o / (n > 0.f ? n : 1.f));
  }
}

template <typename T, typename S, bool kPaged, int D>
int launch_d(int batch, const Args& a, cudaStream_t stream) {
  const dim3 grid(a.splits, a.heads, batch);
  decode_scores_kernel<T, S, kPaged, D><<<grid, kThreads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_values_kernel<T, S, kPaged, D><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S, bool kPaged>
int launch(int head_dim, int batch, const Args& a, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch_d<T, S, kPaged, 16>(batch, a, stream);
    case 32:
      return launch_d<T, S, kPaged, 32>(batch, a, stream);
    case 64:
      return launch_d<T, S, kPaged, 64>(batch, a, stream);
    case 128:
      return launch_d<T, S, kPaged, 128>(batch, a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
// tables (ignored when not paged). `scratch` holds batch·heads·(length +
// splits·(head_dim + 2) + 1) fp32 words, splits = max(1, ceil(length /
// 64)), allocated by the caller. Returns cudaGetLastError() after the
// launches (0 = success); the caller raises on anything else.
extern "C" int decode_attention(int dtype, int quant, int paged, int head_dim, const void* q,
                                const void* k, const void* v, const void* k_scale,
                                const void* v_scale, const void* tables, const void* starts,
                                const void* ends, void* out, void* scratch, int batch, int heads,
                                int length, int n_logical, int page_size, int block_k, int splits,
                                float scale, void* stream) {
  if (block_k < 8 || block_k > kMaxBlockK || block_k % 8 || (paged && page_size % block_k) ||
      length < 0 ||
      splits != (length > kSplit ? (length + kSplit - 1) / kSplit : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t rows = static_cast<size_t>(batch) * heads;
  float* scores = static_cast<float*>(scratch);
  float* smax = scores + rows * length;
  float* partial = smax + rows * splits;
  int* counters = reinterpret_cast<int*>(partial + rows * splits * (head_dim + 1));
  const Args a{q, k, v, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
               static_cast<const int*>(tables), static_cast<const int*>(starts),
               static_cast<const int*>(ends), out, scores, smax, partial, counters, heads, length,
               n_logical, page_size, block_k, splits, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_kind<float>(quant, paged, head_dim, batch, a, st);
  if (dtype == 1) return launch_kind<__nv_bfloat16>(quant, paged, head_dim, batch, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
