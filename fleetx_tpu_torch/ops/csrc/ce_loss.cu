// Fused LM head and cross-entropy for NVIDIA Hopper (sm_90a).
//
// Replaces the three TPU kernels of fleetx_tpu/ops/pallas/ce_loss.py:
//   ce_fwd <- `_fwd_kernel` (:86, via `_fused_ce_fwd`, :185)
//   ce_dh  <- `_dh_kernel`  (:119, via `_dh_call`, :229)
//   ce_dw  <- `_dw_kernel`  (:150, via `_dw_call`, :251)
//
// h [n, E] and W [V, E] are contiguous, of one type T (bf16 or fp32), E a
// multiple of 16; labels are int32 [n]; every per-token vector is fp32 [n].
// The scores s = h·Wᵀ are never stored outside shared memory or registers;
// the bf16 backward stores dl, rounded to bf16, one chunk at a time.
//
// Numerics follow the Pallas kernels:
// - s takes T operands with fp32 accumulation;
// - forward: per vocab tile, m_new = max(m, max s), l = l·exp(m - m_new) +
//   Σ exp(s - m_new), and the label logit sums s where the global column
//   equals the label (a label matching no column adds nothing, so its loss
//   is the lse); lse = m + log(l), loss = lse - label logit;
// - backward: p = exp(s - lse) and dl = a·p + b·[label == column] in fp32,
//   then dl is rounded to T before its product; dh and dW are accumulated
//   in fp32 over the whole reduction and rounded to T once.
//
// Bound on this card, at GPT-1.3B training shapes (n 8192 tokens, E 2048,
// V 50304, bf16): 2nVE = 1.69 TFLOP per product against 240 MB of h and W,
// so all three are bound by operations at 989 TFLOP/s: the forward does
// one product (1.71 ms), each backward two (s again, then dl times an
// operand: 3.41 ms). In fp32 they are bound by operations at 67 TFLOP/s on
// the CUDA cores.
//
// ce_fwd: one 256-thread block per (128-token tile, vocab split) walks its
// split's 128-column vocab tiles (64 x 64 in fp32); bf16 products run on
// the tensor cores through `nvcuda::wmma` 16x16x16 fragments, fp32 ones on
// the CUDA cores, operands staged in shared memory in hidden-dim chunks
// (cp.async for bf16). Each tile's scores land in an fp32 shared tile,
// where two threads per token fold them into the running max, sum and
// label logit; a second small kernel combines the splits per token.
//
// ce_dh / ce_dw in bf16: two GEMMs per chunk on `wgmma`. A backward has to
// multiply twice (s, then dl times an operand), and dl for one output row
// needs the whole of s's row, so a kernel that keeps the output in one
// block can reuse each streamed tile for only the few rows whose fp32
// accumulator fits in shared memory (16 in the first design: ~211 GB of
// L2 traffic per call, 5% of the tensor cores). Here dl goes through
// device memory instead, one chunk of output rows at a time (the wrapper
// plans the chunk and allocates the scratch, <= 256 MB):
// - ce_dh, per token chunk T: ce_dl_kernel<true> computes S = h[T]·Wᵀ and,
//   in its epilogue on the fp32 accumulator, dl from each row's token
//   values, rounded to bf16 into the scratch D [|T|, V]; ce_prod_kernel
//   then computes dh[T] = D·W (reduction over V, fp32 in registers,
//   rounded once).
// - ce_dw, per vocab chunk C: ce_dl_kernel<false> computes
//   Dᵀ = dl(W[C]·hᵀ) [|C|, n], the token values now per column;
//   ce_prod_kernel computes dW[C] = Dᵀ·h (reduction over tokens).
// Writing dl transposed for dW keeps A K-major in both products; B is
// K-major in the dl product and N-major (rows of W or h) in the second,
// which the bf16 `wgmma` reads through its descriptor's transpose bit.
// One mainloop serves both: a persistent block per SM walks 128 x 256
// output tiles (row tiles fastest, so that concurrent blocks share the
// column operand in L2); warpgroup 0 keeps a ring of four 64-deep stages
// filled by TMA (128-byte swizzle, zero fill past every edge) on
// mbarriers, and warpgroups 1 and 2 each multiply a 64 x 256 half with
// fp32 accumulators in registers (m64n256k16), one wgmma group in flight.
// Each streamed tile now serves 128 or 256 rows (~85 flops per byte read
// against 16), so the two products move ~40 GB through L2 per call at
// the 1.3B shapes, and the dl chunk adds ~1.65 GB written and read once.
// The fp32 backward keeps the first, CUDA-core design (below).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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
  void* scratch;      // bf16 ce_dh / ce_dw: dl of one chunk, [chunk, V] or [chunk, n]
  int n;
  int vocab;
  int hidden;
  int splits;
  int chunk;          // bf16 ce_dh: tokens per chunk; ce_dw: vocab rows per chunk
};

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;
using hopper::device_int;
using hopper::set_smem;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the Pallas kernels' initial max
constexpr int kRows = 16;          // output rows of an fp32 ce_dh / ce_dw block
constexpr int kCols = 128;         // columns of an fp32 ce_dh / ce_dw tile

template <typename T>
constexpr bool kIsBf16 = std::is_same_v<T, bf16>;

// row padding of a staged T tile: bf16 rows stay 16-byte multiples (WMMA
// ldm, 32-byte aligned fragments), fp32 rows take an odd pitch so that the
// scalar products read shared memory without bank conflicts
template <typename T>
constexpr int kPad = kIsBf16<T> ? 8 : 1;

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


// ---------------------------------------------------------- backward, fp32
//
// The first design, kept for fp32 (off the training path, which is bf16):
// one template with the roles of h and W swapped. A block owns 16 output
// rows (tokens for dh, vocab entries for dW) and keeps their fp32
// accumulator [16, E] in shared memory, so s is computed once per (row,
// column) pair, as in Pallas; for each 128-column tile of the other
// operand it computes s on the CUDA cores (hidden dim in chunks), turns
// it into dl in shared memory, then adds dl times the tile, streaming the
// tile's hidden-dim chunks again (double-buffered in shared memory). Bound
// by the L2 traffic of 16 rows of reuse and by the CUDA cores' rate.

struct BwdShape {
  static constexpr int EK = 64;             // hidden-dim chunk
  static constexpr int LD = EK + kPad<float>;  // staged operand pitch
  static constexpr int LDS = kCols + 4;      // score pitch
  static constexpr int LDL = kCols + kPad<float>;  // dl pitch
  static size_t smem(int E) {  // operand chunks double-buffered
    return sizeof(float) * (kRows * (E + 4) + kRows * LDS + 4 * kCols +
                            2 * (kRows + kCols) * LD + kRows * LDL);
  }
};

// acc[16][e0 : e0 + EK] (pitch LDA) += dl[16][kCols] · B[kCols][EK] (a
// staged chunk of the column operand); columns >= E skipped
__device__ __forceinline__ void add_dl_times(float* acc, int LDA, int e0, int E, const float* sDl,
                                             const float* sB) {
  using S = BwdShape;
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

// kTokenRows: rows are tokens (ce_dh: R = h, C = W); else rows are vocab
// entries (ce_dw: R = W, C = h). Per-token values (a, b, lse, label) are
// indexed by row in the first case and by column in the second.
template <bool kTokenRows>
__global__ void __launch_bounds__(kThreads) ce_bwd_kernel(const CEParams p) {
  using S = BwdShape;
  constexpr int EK = S::EK, LD = S::LD, LDS = S::LDS, LDL = S::LDL;
  const int E = p.hidden, LDA = E + 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sAcc = reinterpret_cast<float*>(smem_raw);  // [16][E+4]: the output rows
  float* sS = sAcc + kRows * LDA;                    // [16][LDS]: this tile's s
  float* sLse = sS + kRows * LDS;                    // per-token values of the
  float* sA = sLse + kCols;                          // block's rows (kTokenRows)
  float* sB = sA + kCols;                            // or of the tile's columns
  int* sLab = reinterpret_cast<int*>(sB + kCols);
  float* sR = reinterpret_cast<float*>(sLab + kCols);  // [2][16][LD]: row operand chunks
  float* sC = sR + 2 * kRows * LD;                     // [2][kCols][LD]: column operand chunks
  float* sDl = sC + 2 * kCols * LD;                    // [16][LDL]: dl

  const float* R = static_cast<const float*>(kTokenRows ? p.h : p.w);
  const float* C = static_cast<const float*>(kTokenRows ? p.w : p.h);
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
    // hidden-dim chunks double-buffered: chunk k + 1 is staged before
    // chunk k is multiplied; a buffer is refilled only after the barrier
    // that ends the products reading it
    auto stage_rc = [&](int k) {
      stage<float, kRows, EK, LD>(sR + (k & 1) * kRows * LD, R, nr, r0, E, k * EK);
      stage<float, kCols, EK, LD>(sC + (k & 1) * kCols * LD, C, nc, c0, E, k * EK);
    };
    auto stage_c = [&](int k) {
      stage<float, kCols, EK, LD>(sC + (k & 1) * kCols * LD, C, nc, c0, E, k * EK);
    };
    Scores<float, kRows, kCols, EK> s;
    s.zero();
    stage_rc(0);
    for (int k = 0; k < chunks; ++k) {
      if (k + 1 < chunks) stage_rc(k + 1);
      __syncthreads();
      s.add(sR + (k & 1) * kRows * LD, sC + (k & 1) * kCols * LD);
      __syncthreads();
    }
    s.store(sS);
    stage_c(0);  // the dl·B pass's first chunk is staged while dl is made
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
      sDl[r * LDL + c] = dl;
    }
    for (int k = 0; k < chunks; ++k) {
      if (k + 1 < chunks) stage_c(k + 1);
      __syncthreads();  // chunk k is staged (and, for k = 0, dl is written)
      add_dl_times(sAcc, LDA, k * EK, E, sDl, sC + (k & 1) * kCols * LD);
      __syncthreads();
    }
  }
  __syncthreads();  // the accumulator is complete (or, with no columns, zeroed)
  float* out = static_cast<float*>(p.grad);
  for (int i = tid; i < kRows * E; i += kThreads) {
    const int r = i / E, c = i % E;
    if (r0 + r < nr) out[static_cast<size_t>(r0 + r) * E + c] = sAcc[r * LDA + c];
  }
}

// ---------------------------------------------------------- backward, bf16

namespace gemm {

using namespace hopper;

constexpr int BM = 128;          // output rows of a tile: 64 per consumer warpgroup
constexpr int BN = 256;          // output columns of a tile
constexpr int BK = 64;           // reduction depth of a stage: one 128-byte swizzle row
constexpr int kBoxN = 64;        // an N-major B stage is BN / kBoxN TMA boxes of [BK][kBoxN]
constexpr int kStages = 4;
constexpr int kConsumers = 2;    // warpgroups 1 and 2; warpgroup 0 loads
constexpr int kThreads = 128 * (1 + kConsumers);
// registers a thread after setmaxnreg: the launch holds 168 a thread
// (65536 / 384, rounded down to 8), the producer keeps 40 of them
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = (168 * kThreads - 128 * kProducerRegs) / (128 * kConsumers) / 8 * 8;
constexpr uint32_t kABytes = BM * BK * sizeof(bf16);
constexpr uint32_t kBoxBytes = BK * kBoxN * sizeof(bf16);

enum class Epi {
  kDlRows,  // store dl rounded to bf16; rows are tokens row0 + r, columns vocab ids
  kDlCols,  // the same with rows vocab ids row0 + r and columns tokens
  kProd,    // store the product rounded to bf16
};

struct Args {
  int m, n, k;         // output rows, output columns, reduction length
  int row0;            // A's first row in its tensor map (and the id of output row 0)
  bf16* out;           // out[r * ldo + c] for r < m, c < n
  long long ldo;
  const float* lse;    // per-token values of the dl epilogues
  const float* a;
  const float* b;
  const int* labels;
};

struct Smem {
  bf16 a[kStages][BM * BK];  // [BM][BK], 128-byte swizzle
  bf16 b[kStages][BN * BK];  // [BN][BK] (K-major) or BN / kBoxN x [BK][kBoxN] (N-major)
  float lse[kConsumers][BN];  // kDlCols: the tile's per-token values, per warpgroup
  float pa[kConsumers][BN];
  float pb[kConsumers][BN];
  int lab[kConsumers][BN];
  uint64_t full[kStages];    // a stage has landed (TMA bytes)
  uint64_t empty[kStages];   // a stage has been read (every consumer thread)
};
// the swizzled tiles need 1024-byte aligned addresses: the kernel aligns
// the dynamic shared memory itself
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;

// d[0:128] (+)= A·B for one warpgroup: A a K-major [64][16] bf16 tile, B a
// [256][16] (K-major) or [16][256] (N-major: kTransB) tile, both in shared
// memory behind their descriptors; scale_d 0 overwrites d
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, %131;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
}

// the epilogue of one tile on one consumer warpgroup's accumulator: its
// thread t holds rows warp·16 + lane/4 (+8) and columns 8j + 2·(lane%4)
// (+1) of the warpgroup's 64 x 256 half; the rows and columns past the
// output's edges (zeros or stale columns) are not stored
template <Epi kEpi>
__device__ __forceinline__ void epilogue(const float (&d)[128], Smem& s, const Args& g, int c, int mt,
                                         int nt, int t) {
  const int warp = t / 32, lane = t % 32;
  const int col0 = nt * BN + 2 * (lane % 4);
  if constexpr (kEpi == Epi::kDlCols) {
    named_sync(1 + c);  // this warpgroup is done with the previous tile's values
    for (int i = t; i < BN; i += 128) {
      const int tok = nt * BN + i;
      if (tok < g.n) {
        s.lse[c][i] = g.lse[tok];
        s.pa[c][i] = g.a[tok];
        s.pb[c][i] = g.b[tok];
        s.lab[c][i] = g.labels[tok];
      }
    }
    named_sync(1 + c);
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = mt * BM + c * 64 + warp * 16 + lane / 4 + 8 * h2;
    if (r >= g.m) continue;
    bf16* orow = g.out + r * g.ldo;
    float lse = 0.f, pa = 0.f, pb = 0.f;
    int lab = -1;
    if constexpr (kEpi == Epi::kDlRows) {
      const int tok = g.row0 + r;
      lse = g.lse[tok];
      pa = g.a[tok];
      pb = g.b[tok];
      lab = g.labels[tok];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= g.n) continue;  // n is even, so col + 1 < n too
      float x0 = d[4 * j + 2 * h2], x1 = d[4 * j + 2 * h2 + 1];
      if constexpr (kEpi == Epi::kDlRows) {  // columns are vocab ids
        x0 = pa * expf(x0 - lse) + (lab == col ? pb : 0.f);
        x1 = pa * expf(x1 - lse) + (lab == col + 1 ? pb : 0.f);
      } else if constexpr (kEpi == Epi::kDlCols) {  // columns are tokens
        const int v = g.row0 + r, i = col - nt * BN;
        x0 = s.pa[c][i] * expf(x0 - s.lse[c][i]) + (s.lab[c][i] == v ? s.pb[c][i] : 0.f);
        x1 = s.pa[c][i + 1] * expf(x1 - s.lse[c][i + 1]) +
             (s.lab[c][i + 1] == v ? s.pb[c][i + 1] : 0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x0, x1);
    }
  }
}

// the producer: one thread keeps the ring of stages full, tile after tile
template <bool kNMajorB>
__device__ __forceinline__ void producer(const CUtensorMap& tmA, const CUtensorMap& tmB,
                                         const Args& g, Smem& s, int m_tiles, int tiles,
                                         int kblocks) {
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int mt = tile % m_tiles, nt = tile / m_tiles;
    // N-major B: boxes wholly past the last column are not loaded (their
    // columns of the product are never stored)
    const int left = (g.n - nt * BN + kBoxN - 1) / kBoxN;
    const int boxes = kNMajorB ? (left < BN / kBoxN ? left : BN / kBoxN) : 0;
    const uint32_t bytes = kABytes + (kNMajorB ? boxes * kBoxBytes : BN * BK * sizeof(bf16));
    for (int kb = 0; kb < kblocks; ++kb) {
      mbar_wait(&s.empty[stage], phase ^ 1);  // passes at once on the first round
      mbar_expect_tx(&s.full[stage], bytes);
      tma_load(s.a[stage], &tmA, &s.full[stage], kb * BK, g.row0 + mt * BM);
      if constexpr (kNMajorB) {
        for (int j = 0; j < boxes; ++j)
          tma_load(s.b[stage] + j * BK * kBoxN, &tmB, &s.full[stage], nt * BN + j * kBoxN,
                   kb * BK);
      } else {
        tma_load(s.b[stage], &tmB, &s.full[stage], kb * BK, nt * BN);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// a consumer: warpgroup c (thread t of it) multiplies rows 64c .. 64c + 63
// of each tile and runs the tile's epilogue on its accumulator
template <bool kNMajorB, Epi kEpi>
__device__ __forceinline__ void consumer(const Args& g, Smem& s, int c, int t, int m_tiles,
                                         int tiles, int kblocks) {
  float d[128];
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int mt = tile % m_tiles, nt = tile / m_tiles;
    int prev = 0;
    for (int kb = 0; kb < kblocks; ++kb) {
      mbar_wait(&s.full[stage], phase);
      wgmma_fence();
      const bf16* A = s.a[stage] + c * 64 * BK;
      const bf16* B = s.b[stage];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = desc(A + kk * 16, 16, 1024);
        const uint64_t db = kNMajorB ? desc(B + kk * 16 * kBoxN, kBoxBytes, 1024)
                                     : desc(B + kk * 16, 16, 1024);
        wgmma_m64n256k16<kNMajorB ? 1 : 0>(d, da, db, kb > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (kb > 0) mbar_arrive(&s.empty[prev]);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();  // k > 0: the reduction always has a block
    mbar_arrive(&s.empty[prev]);
    fence_acc(d);
    epilogue<kEpi>(d, s, g, c, mt, nt, t);
  }
}

// out[m, n] = A[m, k] · B, A K-major through tmA (rows from g.row0), B
// through tmB: K-major [n, k] or, with kNMajorB, N-major [k, n]. A
// persistent block walks the output tiles, row tiles fastest.
template <bool kNMajorB, Epi kEpi>
__device__ __forceinline__ void body(const CUtensorMap& tmA, const CUtensorMap& tmB, const Args& g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  Smem& s = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (base & 1023)) & 1023));
  const int m_tiles = (g.m + BM - 1) / BM, n_tiles = (g.n + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles, kblocks = (g.k + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], 128 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the producer warpgroup gives registers to the consumers' accumulators
  // (launched at 168 a thread: 128 x kProducerRegs + 256 x kConsumerRegs
  // = 384 x 168); the two branches never rejoin
  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) producer<kNMajorB>(tmA, tmB, g, s, m_tiles, tiles, kblocks);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consumer<kNMajorB, kEpi>(g, s, wg - 1, threadIdx.x - 128 * wg, m_tiles, tiles, kblocks);
  }
}

}  // namespace gemm

// the dl product: scratch = dl(A·Bᵀ) rounded to bf16, rows tokens
// (kTokenRows, ce_dh) or vocab entries (ce_dw)
template <bool kTokenRows>
__global__ void __launch_bounds__(gemm::kThreads, 1)
    ce_dl_kernel(const __grid_constant__ CUtensorMap a, const __grid_constant__ CUtensorMap b,
                 const gemm::Args g) {
  gemm::body<false, kTokenRows ? gemm::Epi::kDlRows : gemm::Epi::kDlCols>(a, b, g);
}

// the second product: dh or dW rows = scratch · (W or h), N-major B
__global__ void __launch_bounds__(gemm::kThreads, 1)
    ce_prod_kernel(const __grid_constant__ CUtensorMap a, const __grid_constant__ CUtensorMap b,
                   const gemm::Args g) {
  gemm::body<true, gemm::Epi::kProd>(a, b, g);
}

// ------------------------------------------------------------------ launch

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, const CEParams& p, cudaStream_t stream) {
  const int err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != 0) return err;
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

template <bool kTokenRows>
int bwd_fp32(const CEParams& p, cudaStream_t st) {
  const int rows = kTokenRows ? p.n : p.vocab;
  const dim3 grid((rows + kRows - 1) / kRows);
  return launch(ce_bwd_kernel<kTokenRows>, grid, BwdShape::smem(p.hidden), p, st);
}

// a TMA map of the row-major bf16 matrix [rows, cols] at base, boxes of
// [box_rows, box_cols] with 128-byte swizzle (box_cols 64), zeros outside
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
                int box_cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(bf16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  return hopper::tensor_map_bf16(map, base, 2, dims, strides, box);
}

template <typename Kernel>
int launch_gemm(Kernel kernel, const CUtensorMap& a, const CUtensorMap& b, const gemm::Args& g,
                cudaStream_t st) {
  const int tiles = ((g.m + gemm::BM - 1) / gemm::BM) * ((g.n + gemm::BN - 1) / gemm::BN);
  if (tiles == 0) return 0;
  int err = set_smem(reinterpret_cast<const void*>(kernel), gemm::kSmemBytes);
  if (err != 0) return err;
  // the launch holds 168 registers a thread for setmaxnreg to share out
  err = hopper::check_regs(reinterpret_cast<const void*>(kernel),
                           128 * (gemm::kProducerRegs + gemm::kConsumerRegs * gemm::kConsumers) /
                               gemm::kThreads);
  if (err != 0) return err;
  const int sms = device_int(cudaDevAttrMultiProcessorCount);
  kernel<<<tiles < sms ? tiles : sms, gemm::kThreads, gemm::kSmemBytes, st>>>(a, b, g);
  return static_cast<int>(cudaGetLastError());
}

// bf16 ce_dh (kTokenRows: chunks of tokens) or ce_dw (chunks of vocab
// rows): per chunk, the dl product into the scratch, then its product
// with the other operand into the chunk's rows of the gradient
template <bool kTokenRows>
int bwd_bf16(const CEParams& p, cudaStream_t st) {
  const int E = p.hidden;
  const int rows = kTokenRows ? p.n : p.vocab;   // chunked: the gradient's rows
  const int width = kTokenRows ? p.vocab : p.n;  // the scratch's row length
  if (!kTokenRows && p.n == 0)
    return static_cast<int>(
        cudaMemsetAsync(p.grad, 0, static_cast<size_t>(p.vocab) * E * sizeof(bf16), st));
  // the TMA maps need 16-byte row strides
  if (p.scratch == nullptr || p.chunk <= 0 || (p.chunk % gemm::BM && p.chunk < rows) ||
      width % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* R = kTokenRows ? p.h : p.w;  // the dl product's A: [rows, E]
  const void* C = kTokenRows ? p.w : p.h;  // its B [width, E], and the second product's B
  CUtensorMap mr, mc, mc_n;
  if (!tensor_map(&mr, R, rows, E, gemm::BM, gemm::BK) ||
      !tensor_map(&mc, C, width, E, gemm::BN, gemm::BK) ||
      !tensor_map(&mc_n, C, width, E, gemm::BK, gemm::kBoxN))
    return static_cast<int>(cudaErrorInvalidValue);
  bf16* scratch = static_cast<bf16*>(p.scratch);
  bf16* grad = static_cast<bf16*>(p.grad);
  for (int lo = 0; lo < rows; lo += p.chunk) {
    const int count = rows - lo < p.chunk ? rows - lo : p.chunk;
    const gemm::Args dl{count, width, E, lo, scratch, width, p.lse, p.a, p.b, p.labels};
    int err = launch_gemm(ce_dl_kernel<kTokenRows>, mr, mc, dl, st);
    if (err != 0) return err;
    CUtensorMap md;
    if (!tensor_map(&md, scratch, count, width, gemm::BM, gemm::BK))
      return static_cast<int>(cudaErrorInvalidValue);
    const gemm::Args prod{count, E, width, 0, grad + static_cast<size_t>(lo) * E, E,
                          nullptr, nullptr, nullptr, nullptr};
    err = launch_gemm(ce_prod_kernel, md, mc_n, prod, st);
    if (err != 0) return err;
  }
  return 0;
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
  return dtype == 1 ? bwd_bf16<true>(*p, st) : bwd_fp32<true>(*p, st);
}

extern "C" int ce_dw(const CEParams* p, int dtype, void* stream) {
  if (!valid(p, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? bwd_bf16<false>(*p, st) : bwd_fp32<false>(*p, st);
}

// sizeof(CEParams), so the wrapper can check its ctypes mirror
extern "C" int ce_params_size() { return static_cast<int>(sizeof(CEParams)); }
