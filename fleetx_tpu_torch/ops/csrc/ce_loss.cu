// Fused LM head and cross-entropy for NVIDIA Hopper (sm_90a).
//
// Replaces the three TPU kernels of fleetx_tpu/ops/pallas/ce_loss.py:
//   ce_fwd <- `_fwd_kernel` (:86, via `_fused_ce_fwd`, :185)
//   ce_dh  <- `_dh_kernel`  (:119, via `_dh_call`, :229)
//   ce_dw  <- `_dw_kernel`  (:150, via `_dw_call`, :251)
//
// h [n, E] and W [V, E] are contiguous, of one type T (bf16 or fp32), E a
// multiple of 16; labels are int32 [n]; every per-token vector is fp32 [n].
// s = h·Wᵀ is never stored outside shared memory.
//
// Numerics follow the Pallas kernels:
// - s takes T operands with fp32 accumulation;
// - forward: per vocab tile, m_new = max(m, max s), l = l·exp(m - m_new) +
//   Σ exp(s - m_new), and the label logit sums s where the global column
//   equals the label (a label matching no column adds nothing, so its loss
//   is the lse); lse = m + log(l), loss = lse - label logit;
// - backward: p = exp(s - lse) and dl = a·p + b·[label == column] in fp32,
//   then dl is rounded to T before its product; dh and dW are accumulated
//   in fp32 and rounded to T at the end.
//
// Bound on this card, at GPT-1.3B training shapes (n 8192 tokens, E 2048,
// V 50304, bf16): 2nVE = 1.69 TFLOP per product against 240 MB of h and W,
// so all three are bound by operations at 989 TFLOP/s: the forward does
// one product (1.71 ms), each backward two (s again, then dl times an
// operand: 3.41 ms). In fp32 they are bound by operations at 67 TFLOP/s on
// the CUDA cores.
//
// Design (simple first). bf16 products run on the tensor cores through
// `nvcuda::wmma` 16x16x16 fragments with fp32 accumulation; fp32 products
// on the CUDA cores, each thread owning a register tile of rows ty + 16i
// and columns tx + 16j. Operand tiles are staged in shared memory in
// chunks of the hidden dim (16-byte cp.async copies for bf16), so no block
// holds a whole [rows, E] operand.
// - ce_fwd: one 256-thread block per (128-token tile, vocab split) walks
//   its split's 128-column vocab tiles (64 x 64 in fp32); each tile's
//   scores land in an fp32 shared tile, where two threads per token fold
//   them into the running max, sum and label logit. The vocab is split so
//   that the grid fills the card; a second small kernel combines the
//   splits' partial statistics per token.
// - ce_dh / ce_dw: one template with the roles of h and W swapped. A block
//   owns 16 output rows (tokens for dh, vocab entries for dW) and keeps
//   their fp32 accumulator [16, E] in shared memory (128 KB at E 2048), so
//   s is computed once per (row, column) pair, as in Pallas; for each
//   128-column tile of the other operand it computes s (hidden dim in
//   chunks), turns it into dl (rounded to T) in shared memory, then adds
//   dl times the tile, streaming the tile's hidden-dim chunks again. With
//   16 rows of reuse the two passes read ~206 GB from L2 per call at the
//   1.3B shapes, so they are bound by L2 traffic and latency; the chunks
//   are double-buffered so that one chunk's copies overlap the previous
//   chunk's products. The accumulator and two buffers fit up to E 2048.
// TMA staging, wgmma and a cluster that would let dh/dW blocks own more
// than 16 rows (sharing the accumulator through distributed shared
// memory) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

// Shared with the Python wrapper (ctypes.Structure `_CEParams`): keep the
// field order and types in step.
struct CEParams {
  const void* h;      // [n, E]
  const void* w;      // [V, E]
  const int* labels;  // [n]
  const float* a;     // [n] backward cotangent of softmax
  const float* b;     // [n] backward cotangent of the one-hot
  float* lse;         // [n] written by ce_fwd, read by ce_dh / ce_dw
  float* loss;        // [n] written by ce_fwd
  void* grad;         // dh [n, E] (ce_dh) or dW [V, E] (ce_dw)
  float* partial;     // ce_fwd scratch [3][splits][n]: max, sum, label logit
  int n;
  int vocab;
  int hidden;
  int splits;
};

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the Pallas kernels' initial max
constexpr int kRows = 16;          // output rows of a ce_dh / ce_dw block
constexpr int kCols = 128;         // columns of a ce_dh / ce_dw tile

template <typename T>
constexpr bool kIsBf16 = std::is_same_v<T, bf16>;

// row padding of a staged T tile: bf16 rows stay 16-byte multiples (WMMA
// ldm, 32-byte aligned fragments), fp32 rows take an odd pitch so that the
// scalar products read shared memory without bank conflicts
template <typename T>
constexpr int kPad = kIsBf16<T> ? 8 : 1;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

// 16 bytes from global to shared memory without passing through registers
// (cp.async); a copy marked invalid reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + R) x columns [e0, e0 + K) of a row-major [nrows, E]
// matrix into a shared tile of pitch LD, zero outside the matrix. bf16
// tiles are copied asynchronously (the caller commits, waits and
// synchronises before reading them); fp32 tiles synchronously.
template <typename T, int R, int K, int LD>
__device__ __forceinline__ void stage(T* dst, const T* src, int nrows, int r0, int E, int e0) {
  if constexpr (kIsBf16<T>) {
    constexpr int kChunks = K / 8;  // 8 bf16 per 16 bytes; 8 | E keeps a chunk whole
    for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool valid = r0 + r < nrows && e0 + c < E;
      cp_async16(dst + r * LD + c,
                 valid ? src + static_cast<size_t>(r0 + r) * E + e0 + c : src, valid);
    }
  } else {
    for (int i = threadIdx.x; i < R * K; i += kThreads) {
      const int r = i / K, c = i % K;
      dst[r * LD + c] = (r0 + r < nrows && e0 + c < E)
                            ? src[static_cast<size_t>(r0 + r) * E + e0 + c]
                            : 0.f;
    }
  }
}

// A running [BR, BC] score tile s = A·Bᵀ, summed over hidden-dim chunks of
// EK: A is a staged [BR][EK] tile, B a staged [BC][EK] tile, both of pitch
// EK + kPad<T>. `store` writes it to an fp32 shared tile of pitch BC + 4.
template <typename T, int BR, int BC, int EK>
struct Scores;

template <int BR, int BC, int EK>
struct Scores<bf16, BR, BC, EK> {
  static constexpr int LD = EK + kPad<bf16>;
  static constexpr int FW = BR / 16;  // fragments per warp
  static_assert(BC / 16 == kWarps, "warp w owns the 16 columns 16w..16w+15");
  FragC acc[FW];  // fragment f: rows 16f..16f+15

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int f = 0; f < FW; ++f) wmma::fill_fragment(acc[f], 0.f);
  }

  __device__ __forceinline__ void add(const bf16* sA, const bf16* sB) {
    const int warp = threadIdx.x >> 5;
#pragma unroll 1
    for (int kk = 0; kk < EK / 16; ++kk) {
      FragBT fb;
      wmma::load_matrix_sync(fb, sB + 16 * warp * LD + 16 * kk, LD);
#pragma unroll
      for (int f = 0; f < FW; ++f) {
        FragA fa;
        wmma::load_matrix_sync(fa, sA + 16 * f * LD + 16 * kk, LD);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
  }

  __device__ __forceinline__ void store(float* sS) const {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int f = 0; f < FW; ++f)
      wmma::store_matrix_sync(sS + 16 * f * (BC + 4) + 16 * warp, acc[f], BC + 4,
                              wmma::mem_row_major);
  }
};

template <int BR, int BC, int EK>
struct Scores<float, BR, BC, EK> {
  static constexpr int LD = EK + kPad<float>;
  static constexpr int NI = BR / 16, NJ = BC / 16;
  float acc[NI][NJ];  // rows ty + 16i, columns tx + 16j

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void add(const float* sA, const float* sB) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
    for (int k = 0; k < EK; ++k) {
      float x[NI], y[NJ];
#pragma unroll
      for (int i = 0; i < NI; ++i) x[i] = sA[(ty + 16 * i) * LD + k];
#pragma unroll
      for (int j = 0; j < NJ; ++j) y[j] = sB[(tx + 16 * j) * LD + k];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  }

  __device__ __forceinline__ void store(float* sS) const {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) sS[(ty + 16 * i) * (BC + 4) + tx + 16 * j] = acc[i][j];
  }
};

// ------------------------------------------------------------------ forward

template <typename T>
struct FwdShape {
  static constexpr int BR = kIsBf16<T> ? 128 : 64;  // tokens per block
  static constexpr int BC = kIsBf16<T> ? 128 : 64;  // vocab columns per tile
  static constexpr int EK = 64;                        // hidden-dim chunk
  static constexpr int LD = EK + kPad<T>;
  static constexpr size_t smem() {
    return sizeof(float) * BR * (BC + 4) + sizeof(T) * (BR + BC) * LD;
  }
};

// two blocks per SM: the bf16 accumulators (8 fragments a thread) must fit
// in 128 registers
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ce_fwd_kernel(const CEParams p) {
  using S = FwdShape<T>;
  constexpr int BR = S::BR, BC = S::BC, EK = S::EK, LDS = BC + 4;
  constexpr int TPR = kThreads / BR;  // threads per token row (2 or 4)
  constexpr int CPT = BC / TPR;       // columns per thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sS = reinterpret_cast<float*>(smem_raw);  // [BR][LDS]: this tile's s
  T* sR = reinterpret_cast<T*>(sS + BR * LDS);     // [BR][LD]: h chunk
  T* sC = sR + BR * S::LD;                         // [BC][LD]: W chunk

  const int tid = threadIdx.x, row = tid / TPR, part = tid % TPR;
  const int r0 = blockIdx.x * BR, tok = r0 + row;
  const int tiles = (p.vocab + BC - 1) / BC;
  const int t_begin = static_cast<int>(static_cast<long long>(blockIdx.y) * tiles / p.splits);
  const int t_end = static_cast<int>(static_cast<long long>(blockIdx.y + 1) * tiles / p.splits);
  const T* H = static_cast<const T*>(p.h);
  const T* W = static_cast<const T*>(p.w);
  const int label = tok < p.n ? p.labels[tok] : -1;

  float m_run = kNegInf, l_run = 0.f, lab = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * BC;
    Scores<T, BR, BC, EK> s;
    s.zero();
    for (int e0 = 0; e0 < p.hidden; e0 += EK) {
      __syncthreads();  // the previous chunk's (and tile's) readers are done
      stage<T, BR, EK, S::LD>(sR, H, p.n, r0, p.hidden, e0);
      stage<T, BC, EK, S::LD>(sC, W, p.vocab, c0, p.hidden, e0);
      cp_async_commit();
      cp_async_wait<0>();  // two blocks per SM overlap one's copies with the other's products
      __syncthreads();
      s.add(sR, sC);
    }
    s.store(sS);
    __syncthreads();

    const float* srow = sS + row * LDS + part * CPT;
    const int col0 = c0 + part * CPT;
    float mx = kNegInf;
#pragma unroll 8
    for (int c = 0; c < CPT; ++c)
      if (col0 + c < p.vocab) mx = fmaxf(mx, srow[c]);
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
#pragma unroll 8
    for (int c = 0; c < CPT; ++c) {
      if (col0 + c < p.vocab) {
        sum += expf(srow[c] - m_new);
        if (col0 + c == label) lab += srow[c];
      }
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    l_run = l_run * expf(m_run - m_new) + sum;
    m_run = m_new;
  }
  // one lane of a row holds the label logit (or none does): the sum is exact
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) lab += __shfl_xor_sync(0xffffffffu, lab, o);
  if (part == 0 && tok < p.n) {
    const size_t plane = static_cast<size_t>(p.splits) * p.n;
    const size_t at = static_cast<size_t>(blockIdx.y) * p.n + tok;
    p.partial[at] = m_run;
    p.partial[plane + at] = l_run;
    p.partial[2 * plane + at] = lab;
  }
}

// the splits' (max, sum, label logit) of each token into its lse and loss
__global__ void ce_combine_kernel(const CEParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const size_t plane = static_cast<size_t>(p.splits) * p.n;
  float m = kNegInf;
  for (int s = 0; s < p.splits; ++s) m = fmaxf(m, p.partial[static_cast<size_t>(s) * p.n + i]);
  float l = 0.f, lab = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const size_t at = static_cast<size_t>(s) * p.n + i;
    l += p.partial[plane + at] * expf(p.partial[at] - m);
    lab += p.partial[2 * plane + at];
  }
  const float lse = m + logf(l);
  p.lse[i] = lse;
  p.loss[i] = lse - lab;
}

// ---------------------------------------------------------------- backward

template <typename T>
struct BwdShape {
  static constexpr int EK = kIsBf16<T> ? 128 : 64;  // hidden-dim chunk
  static constexpr int LD = EK + kPad<T>;            // staged operand pitch
  static constexpr int LDS = kCols + 4;               // fp32 score pitch
  static constexpr int LDL = kCols + kPad<T>;        // dl pitch
  static_assert(!kIsBf16<T> || EK / 16 == kWarps, "one dl·B fragment per warp");
  static size_t smem(int E) {  // operand chunks double-buffered
    return sizeof(float) * (kRows * (E + 4) + kRows * LDS + 4 * kCols) +
           sizeof(T) * (2 * (kRows + kCols) * LD + kRows * LDL);
  }
};

// acc[16][e0 : e0 + EK] (fp32 shared, pitch LDA) += dl[16][kCols] ·
// B[kCols][EK] (a staged chunk of the column operand); columns >= E skipped
template <typename T>
__device__ __forceinline__ void add_dl_times(float* acc, int LDA, int e0, int E, const T* sDl,
                                             const T* sB) {
  using S = BwdShape<T>;
  if constexpr (kIsBf16<T>) {
    const int warp = threadIdx.x >> 5, col = e0 + 16 * warp;
    if (col >= E) return;  // 16 | E: a fragment is wholly in or out
    FragC c;
    wmma::load_matrix_sync(c, acc + col, LDA, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(fa, sDl + 16 * kk, S::LDL);
      wmma::load_matrix_sync(fb, sB + 16 * kk * S::LD + 16 * warp, S::LD);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(acc + col, c, LDA, wmma::mem_row_major);
  } else {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;  // row ty
#pragma unroll
    for (int j = 0; j < S::EK / 16; ++j) {
      const int col = e0 + tx + 16 * j;
      if (col >= E) continue;
      float v = acc[ty * LDA + col];
#pragma unroll 8
      for (int c = 0; c < kCols; ++c) v = fmaf(sDl[ty * S::LDL + c], sB[c * S::LD + tx + 16 * j], v);
      acc[ty * LDA + col] = v;
    }
  }
}

// kTokenRows: rows are tokens (ce_dh: R = h, C = W); else rows are vocab
// entries (ce_dw: R = W, C = h). Per-token values (a, b, lse, label) are
// indexed by row in the first case and by column in the second.
template <typename T, bool kTokenRows>
__global__ void __launch_bounds__(kThreads) ce_bwd_kernel(const CEParams p) {
  using S = BwdShape<T>;
  constexpr int EK = S::EK, LD = S::LD, LDS = S::LDS, LDL = S::LDL;
  const int E = p.hidden, LDA = E + 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sAcc = reinterpret_cast<float*>(smem_raw);  // [16][E+4]: the output rows
  float* sS = sAcc + kRows * LDA;                    // [16][LDS]: this tile's s
  float* sLse = sS + kRows * LDS;                    // per-token values of the
  float* sA = sLse + kCols;                          // block's rows (kTokenRows)
  float* sB = sA + kCols;                            // or of the tile's columns
  int* sLab = reinterpret_cast<int*>(sB + kCols);
  T* sR = reinterpret_cast<T*>(sLab + kCols);        // [2][16][LD]: row operand chunks
  T* sC = sR + 2 * kRows * LD;                       // [2][kCols][LD]: column operand chunks
  T* sDl = sC + 2 * kCols * LD;                      // [16][LDL]: dl rounded to T

  const T* R = static_cast<const T*>(kTokenRows ? p.h : p.w);
  const T* C = static_cast<const T*>(kTokenRows ? p.w : p.h);
  const int nr = kTokenRows ? p.n : p.vocab, nc = kTokenRows ? p.vocab : p.n;
  const int tid = threadIdx.x, r0 = blockIdx.x * kRows;
  const int chunks = (E + EK - 1) / EK;

  for (int i = tid; i < kRows * LDA; i += kThreads) sAcc[i] = 0.f;
  auto load_tokens = [&](int t0, int count) {  // per-token values of [t0, t0 + count)
    if (tid < count && t0 + tid < p.n) {
      sLse[tid] = p.lse[t0 + tid];
      sA[tid] = p.a[t0 + tid];
      sB[tid] = p.b[t0 + tid];
      sLab[tid] = p.labels[t0 + tid];
    }
  };
  if (kTokenRows) load_tokens(r0, kRows);

  for (int c0 = 0; c0 < nc; c0 += kCols) {
    // the previous tile's readers of the per-token values passed the
    // barriers of its dl·B loop
    if (!kTokenRows) load_tokens(c0, kCols);
    // hidden-dim chunks double-buffered: chunk k + 1 is copied while chunk
    // k is multiplied; a buffer is refilled only after the barrier that
    // ends the products reading it
    auto stage_rc = [&](int k) {
      stage<T, kRows, EK, LD>(sR + (k & 1) * kRows * LD, R, nr, r0, E, k * EK);
      stage<T, kCols, EK, LD>(sC + (k & 1) * kCols * LD, C, nc, c0, E, k * EK);
      cp_async_commit();
    };
    auto stage_c = [&](int k) {
      stage<T, kCols, EK, LD>(sC + (k & 1) * kCols * LD, C, nc, c0, E, k * EK);
      cp_async_commit();
    };
    Scores<T, kRows, kCols, EK> s;
    s.zero();
    stage_rc(0);
    for (int k = 0; k < chunks; ++k) {
      if (k + 1 < chunks) {
        stage_rc(k + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      s.add(sR + (k & 1) * kRows * LD, sC + (k & 1) * kCols * LD);
      __syncthreads();
    }
    s.store(sS);
    stage_c(0);  // the dl·B pass's first chunk copies while dl is made
    __syncthreads();
    for (int i = tid; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      const int row = r0 + r, col = c0 + c;
      float dl = 0.f;
      if (row < nr && col < nc) {
        const int k = kTokenRows ? r : c;       // the token's slot
        const int v = kTokenRows ? col : row;   // the vocab id
        const float pv = expf(sS[r * LDS + c] - sLse[k]);
        dl = sA[k] * pv + (sLab[k] == v ? sB[k] : 0.f);
      }
      sDl[r * LDL + c] = from_float<T>(dl);
    }
    for (int k = 0; k < chunks; ++k) {
      if (k + 1 < chunks) {
        stage_c(k + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // chunk k has landed (and, for k = 0, dl is written)
      add_dl_times<T>(sAcc, LDA, k * EK, E, sDl, sC + (k & 1) * kCols * LD);
      __syncthreads();
    }
  }
  __syncthreads();  // the accumulator is complete (or, with no columns, zeroed)
  T* out = static_cast<T*>(p.grad);
  for (int i = tid; i < kRows * E; i += kThreads) {
    const int r = i / E, c = i % E;
    if (r0 + r < nr) out[static_cast<size_t>(r0 + r) * E + c] = from_float<T>(sAcc[r * LDA + c]);
  }
}

// ------------------------------------------------------------------ launch

int device_int(cudaDeviceAttr attr) {
  int dev = 0, value = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&value, attr, dev);
  return value;
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, const CEParams& p, cudaStream_t stream) {
  if (smem > static_cast<size_t>(device_int(cudaDevAttrMaxSharedMemoryPerBlockOptin)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool valid(const CEParams* p, int dtype) {
  return p != nullptr && (dtype == 0 || dtype == 1) && p->n >= 0 && p->vocab > 0 &&
         p->hidden > 0 && p->hidden % 16 == 0;
}

template <typename T>
int splits_for(int n, int vocab) {
  using S = FwdShape<T>;
  const int row_blocks = (n + S::BR - 1) / S::BR;
  const int tiles = (vocab + S::BC - 1) / S::BC;
  // about two blocks per SM over the whole grid, at most one tile each
  const int want = 2 * device_int(cudaDevAttrMultiProcessorCount) / (row_blocks > 0 ? row_blocks : 1);
  return want < 1 ? 1 : (want > tiles ? tiles : want);
}

template <typename T>
int fwd(const CEParams& p, cudaStream_t st) {
  using S = FwdShape<T>;
  if (p.splits != splits_for<T>(p.n, p.vocab)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p.n + S::BR - 1) / S::BR, p.splits);
  const int err = launch(ce_fwd_kernel<T>, grid, S::smem(), p, st);
  if (err != 0) return err;
  ce_combine_kernel<<<(p.n + kThreads - 1) / kThreads, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kTokenRows>
int bwd(const CEParams& p, cudaStream_t st) {
  const int rows = kTokenRows ? p.n : p.vocab;
  const dim3 grid((rows + kRows - 1) / kRows);
  return launch(ce_bwd_kernel<T, kTokenRows>, grid, BwdShape<T>::smem(p.hidden), p, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after
// its launches (0 = success); the caller raises on anything else.
extern "C" int ce_fwd_splits(int n, int vocab, int dtype) {
  return dtype == 1 ? splits_for<bf16>(n, vocab) : splits_for<float>(n, vocab);
}

extern "C" int ce_fwd(const CEParams* p, int dtype, void* stream) {
  if (!valid(p, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  if (p->n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? fwd<bf16>(*p, st) : fwd<float>(*p, st);
}

extern "C" int ce_dh(const CEParams* p, int dtype, void* stream) {
  if (!valid(p, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  if (p->n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? bwd<bf16, true>(*p, st) : bwd<float, true>(*p, st);
}

extern "C" int ce_dw(const CEParams* p, int dtype, void* stream) {
  if (!valid(p, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? bwd<bf16, false>(*p, st) : bwd<float, false>(*p, st);
}

// sizeof(CEParams), so the wrapper can check its ctypes mirror
extern "C" int ce_params_size() { return static_cast<int>(sizeof(CEParams)); }
