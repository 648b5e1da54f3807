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
// - forward: per vocab tile, its max m_t, l_t = Σ exp(s - m_t) and the
//   label logit, s where the global column equals the label (a label
//   matching no column adds nothing, so its loss is the lse); the tiles
//   combine as m = max m_t, l = Σ l_t·exp(m_t - m) (the fp32 kernel folds
//   them one after another into a running max and sum, as Pallas does);
//   lse = m + log(l), loss = lse - label logit;
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
// All three bf16 kernels run one Hopper GEMM mainloop (`namespace gemm`):
// a persistent block per SM walks 128 x 256 output tiles (row tiles
// fastest, so that concurrent blocks share the column operand in L2);
// warpgroup 0 keeps a ring of four 64-deep stages filled by TMA (128-byte
// swizzle, zero fill past every edge) on mbarriers, and warpgroups 1 and 2
// each multiply a 64 x 256 half with fp32 accumulators in registers
// (m64n256k16), one wgmma group in flight. Only the epilogue on the fp32
// accumulator differs.
//
// ce_fwd in bf16: ce_stats_kernel computes S = h·Wᵀ over the same operand
// maps as ce_dh's first product and, in its epilogue, each row's (max,
// Σ exp(s - max), label logit) over the tile's columns below V; one tile
// is one vocab split, so the scratch `partial` is [3][ceil(V / 256)][n]
// fp32 (19.4 MB at the 1.3B head: 197 splits of 8192 tokens). The small
// ce_combine_kernel then folds the splits of each token, in split order,
// into its lse and loss. Up to fp32 association these are the Pallas
// kernel's numbers: a per-tile (m, l, lab) combined with exp(m_s - m).
//
// ce_dh / ce_dw in bf16: two GEMMs per chunk. A backward has to multiply
// twice (s, then dl times an operand), and dl for one output row needs the
// whole of s's row, so a kernel that keeps the output in one block can
// reuse each streamed tile for only the few rows whose fp32 accumulator
// fits in shared memory (16 in the first design: ~211 GB of L2 traffic per
// call, 5% of the tensor cores). Here dl goes through device memory
// instead, one chunk of output rows at a time (the wrapper plans the chunk
// and allocates the scratch, <= 256 MB):
// - ce_dh, per token chunk T: ce_dl_kernel<true> computes S = h[T]·Wᵀ and,
//   in its epilogue, dl from each row's token values, rounded to bf16 into
//   the scratch D [|T|, V]; ce_prod_kernel then computes dh[T] = D·W
//   (reduction over V, fp32 in registers, rounded once).
// - ce_dw, per vocab chunk C: ce_dl_kernel<false> computes
//   Dᵀ = dl(W[C]·hᵀ) [|C|, n], the token values now per column;
//   ce_prod_kernel computes dW[C] = Dᵀ·h (reduction over tokens).
// Writing dl transposed for dW keeps A K-major in both products; B is
// K-major in the dl and stats products and N-major (rows of W or h) in the
// second, which the bf16 `wgmma` reads through its descriptor's transpose
// bit. Each streamed tile serves 128 or 256 rows (~85 flops per byte read
// against 16), so the backward's two products move ~40 GB through L2 per
// call at the 1.3B shapes, and the dl chunk adds ~1.65 GB written and read
// once.
//
// fp32 keeps the first, CUDA-core design of all three: ce_fwd_kernel, one
// 256-thread block per (64-token tile, vocab split), walks its split's
// 64-column tiles with the operands staged in shared memory in hidden-dim
// chunks, folding each tile's scores into a running max, sum and label
// logit, then ce_combine_kernel as above; the backward below.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

using bf16 = __nv_bfloat16;
using hopper::device_int;
using hopper::set_smem;

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the Pallas kernels' initial max
constexpr int kRows = 16;          // output rows of an fp32 ce_dh / ce_dw block
constexpr int kCols = 128;         // columns of an fp32 ce_dh / ce_dw tile
// the row pitch of a staged fp32 tile is odd, so that the scalar products
// read shared memory without bank conflicts
constexpr int kPad = 1;

// rows [r0, r0 + R) x columns [e0, e0 + K) of a row-major fp32 [nrows, E]
// matrix into a shared tile of pitch LD, zero outside the matrix
template <int R, int K, int LD>
__device__ __forceinline__ void stage(float* dst, const float* src, int nrows, int r0, int E,
                                      int e0) {
  for (int i = threadIdx.x; i < R * K; i += kThreads) {
    const int r = i / K, c = i % K;
    dst[r * LD + c] =
        (r0 + r < nrows && e0 + c < E) ? src[static_cast<size_t>(r0 + r) * E + e0 + c] : 0.f;
  }
}

// A running [BR, BC] fp32 score tile s = A·Bᵀ on the CUDA cores, summed
// over hidden-dim chunks of EK: A is a staged [BR][EK] tile, B a staged
// [BC][EK] tile, both of pitch EK + kPad. `store` writes it to a shared
// tile of pitch BC + 4.
template <int BR, int BC, int EK>
struct Scores {
  static constexpr int LD = EK + kPad;
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

// ------------------------------------------------------------ forward, fp32

struct FwdShape {
  static constexpr int BR = 64;  // tokens per block
  static constexpr int BC = 64;  // vocab columns per tile
  static constexpr int EK = 64;  // hidden-dim chunk
  static constexpr int LD = EK + kPad;
  static constexpr size_t smem() { return sizeof(float) * (BR * (BC + 4) + (BR + BC) * LD); }
};

__global__ void __launch_bounds__(kThreads, 2) ce_fwd_kernel(const CEParams p) {
  using S = FwdShape;
  constexpr int BR = S::BR, BC = S::BC, EK = S::EK, LDS = BC + 4;
  constexpr int TPR = kThreads / BR;  // threads per token row
  constexpr int CPT = BC / TPR;       // columns per thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sS = reinterpret_cast<float*>(smem_raw);  // [BR][LDS]: this tile's s
  float* sR = sS + BR * LDS;                       // [BR][LD]: h chunk
  float* sC = sR + BR * S::LD;                     // [BC][LD]: W chunk

  const int tid = threadIdx.x, row = tid / TPR, part = tid % TPR;
  const int r0 = blockIdx.x * BR, tok = r0 + row;
  const int tiles = (p.vocab + BC - 1) / BC;
  const int t_begin = static_cast<int>(static_cast<long long>(blockIdx.y) * tiles / p.splits);
  const int t_end = static_cast<int>(static_cast<long long>(blockIdx.y + 1) * tiles / p.splits);
  const float* H = static_cast<const float*>(p.h);
  const float* W = static_cast<const float*>(p.w);
  const int label = tok < p.n ? p.labels[tok] : -1;

  float m_run = kNegInf, l_run = 0.f, lab = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * BC;
    Scores<BR, BC, EK> s;
    s.zero();
    for (int e0 = 0; e0 < p.hidden; e0 += EK) {
      __syncthreads();  // the previous chunk's (and tile's) readers are done
      stage<BR, EK, S::LD>(sR, H, p.n, r0, p.hidden, e0);
      stage<BC, EK, S::LD>(sC, W, p.vocab, c0, p.hidden, e0);
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
  static constexpr int EK = 64;            // hidden-dim chunk
  static constexpr int LD = EK + kPad;     // staged operand pitch
  static constexpr int LDS = kCols + 4;    // score pitch
  static constexpr int LDL = kCols + kPad;  // dl pitch
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
      stage<kRows, EK, LD>(sR + (k & 1) * kRows * LD, R, nr, r0, E, k * EK);
      stage<kCols, EK, LD>(sC + (k & 1) * kCols * LD, C, nc, c0, E, k * EK);
    };
    auto stage_c = [&](int k) {
      stage<kCols, EK, LD>(sC + (k & 1) * kCols * LD, C, nc, c0, E, k * EK);
    };
    Scores<kRows, kCols, EK> s;
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

// ------------------------------------------------- bf16: the GEMM mainloop

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
// k-blocks (3072 of the reduction) a fresh accumulator takes before it is
// added into the tile's running sum. The tensor cores' fp32 accumulation
// truncates each product group's alignment bits: over a reduction of
// 12288 (GPT-175B's hidden) a single accumulator drifted beyond CE_TOL of
// the IEEE sums of the plain version, as cuBLAS's bf16 GEMM does; summed
// per 3072 and the pieces added in IEEE fp32, the drift stays that of a
// reduction of 3072 (reductions up to 3072 take one piece, as before)
constexpr int kPromote = 48;

enum class Epi {
  kDlRows,  // store dl rounded to bf16; rows are tokens row0 + r, columns vocab ids
  kDlCols,  // the same with rows vocab ids row0 + r and columns tokens
  kProd,    // store the product rounded to bf16
  kStats,   // per row and tile: max, Σ exp(s - max) and the label logit (ce_fwd)
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
  float* partial;      // kStats: [3][ceil(n / BN)][m] max, sum, label logit
  float* park;         // k > kPromote·BK: each consumer thread's running sum,
                       // 128 contiguous floats
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

// the kStats epilogue of one of a thread's two rows (H2: row r, and the
// columns 8j + 2·(lane%4) + {0, 1} of d[4j + 2·H2 + {0, 1}]; `left` is
// the vocab less the thread's first column). A row's 256 columns lie on
// the four lanes of a quad, 64 each: its max over the columns below the
// vocab (TMA's zero fill past it is left out; the quad's first lane
// always holds the tile's first column, which lies below it), then Σ
// exp(s - max) and the label logit, each over the thread's columns and
// then over the quad; lane 0 of the quad writes them to the tile's split.
// Written per row, and with the columns counted from `left`, the epilogue
// stays in the 168 registers the launch holds (in one loop over both rows
// ptxas spilled 44 bytes)
template <int H2>
__device__ __forceinline__ void stats_row(const float (&d)[128], const Args& g, int r, int left,
                                          int nt, int lane) {
  const int label = r < g.m ? g.labels[g.row0 + r] : -1;
  // the label's column counted from the thread's first one; none below the
  // vocab (-1 or V and past) matches no column
  const int at_label = label >= 0 && label < g.n ? label - (g.n - left) : -1;
  float mx = kNegInf;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if (8 * j < left) mx = fmaxf(mx, d[4 * j + 2 * H2]);
    if (8 * j + 1 < left) mx = fmaxf(mx, d[4 * j + 2 * H2 + 1]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  float sum = 0.f, lab = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if (8 * j < left) sum += expf(d[4 * j + 2 * H2] - mx);
    if (8 * j + 1 < left) sum += expf(d[4 * j + 2 * H2 + 1] - mx);
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if (8 * j == at_label) lab = d[4 * j + 2 * H2];
    if (8 * j + 1 == at_label) lab = d[4 * j + 2 * H2 + 1];
  }
  // at most one lane of the quad holds the label logit: the sum is exact
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  lab += __shfl_xor_sync(0xffffffffu, lab, 1);
  lab += __shfl_xor_sync(0xffffffffu, lab, 2);
  if (lane % 4 == 0 && r < g.m) {
    const size_t plane = static_cast<size_t>((g.n + BN - 1) / BN) * g.m;
    const size_t at = static_cast<size_t>(nt) * g.m + r;
    g.partial[at] = mx;
    g.partial[plane + at] = sum;
    g.partial[2 * plane + at] = lab;
  }
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
  if constexpr (kEpi == Epi::kStats) {
    const int r = mt * BM + c * 64 + warp * 16 + lane / 4;
    const int left = g.n - col0;  // the thread's column 8j (+1) is below the vocab if < left
    stats_row<0>(d, g, r, left, nt, lane);
    stats_row<1>(d, g, r + 8, left, nt, lane);
    return;
  }
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

// 16 bytes of a park slot, loaded and stored by volatile asm: the
// compiler keeps them in program order, so a slot's loads are not hoisted
// ahead of the others' adds (128 more live registers would spill)
__device__ __forceinline__ float4 park_ld(const float4* p) {
  float4 v;
  asm volatile("ld.global.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void park_st(float4* p, float x, float y, float z, float w) {
  asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(x), "f"(y), "f"(z),
               "f"(w)
               : "memory");
}

// whether an epilogue's tiles take their reduction in pieces: the score
// products s = h·Wᵀ (over the hidden), whose exp the epilogues take; the
// second products (dl times an operand, kProd) stay in one accumulator,
// as their bf16 outputs were held at reductions up to 50304 before
template <Epi kEpi>
constexpr bool kPieces = kEpi != Epi::kProd;

// the running sum of a tile's accumulator pieces, in the thread's park
// slot (128 contiguous floats at constant offsets from one pointer): the
// first piece stored, each later one added in IEEE fp32. The loads go in
// groups of 8 (in flight together, 32 registers)
__device__ __forceinline__ void park_add(const float (&d)[128], float4* slot, bool first) {
  if (first) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
      park_st(slot + j, d[4 * j], d[4 * j + 1], d[4 * j + 2], d[4 * j + 3]);
    return;
  }
#pragma unroll
  for (int g = 0; g < 32; g += 8) {
    float4 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = park_ld(slot + g + j);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * (g + j);
      park_st(slot + g + j, d[i] + o[j].x, d[i + 1] + o[j].y, d[i + 2] + o[j].z,
              d[i + 3] + o[j].w);
    }
  }
}

// the last piece plus the running sum
__device__ __forceinline__ void park_settle(float (&d)[128], const float4* slot) {
#pragma unroll
  for (int g = 0; g < 32; g += 8) {
    float4 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = park_ld(slot + g + j);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * (g + j);
      d[i] += o[j].x;
      d[i + 1] += o[j].y;
      d[i + 2] += o[j].z;
      d[i + 3] += o[j].w;
    }
  }
}

// a consumer: warpgroup c (thread t of it) multiplies rows 64c .. 64c + 63
// of each tile and runs the tile's epilogue on its accumulator. For the
// score products, every kPromote k-blocks the accumulator starts afresh,
// its piece added into the thread's running sum (park_add)
template <bool kNMajorB, Epi kEpi>
__device__ __forceinline__ void consumer(const Args& g, Smem& s, int c, int t, int m_tiles,
                                         int tiles, int kblocks) {
  float d[128];
  int stage = 0;
  uint32_t phase = 0;
  // the thread's park slot, formed where it is used (a pointer held over
  // the mainloop would take registers from it)
  const auto slot = [&]() {
    return reinterpret_cast<float4*>(g.park) +
           (static_cast<size_t>(blockIdx.x) * 128 * kConsumers + 128 * c + t) * 32;
  };
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int mt = tile % m_tiles, nt = tile / m_tiles;
    int prev = 0, in_piece = 0;  // k-blocks of the piece so far
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
        wgmma_m64n256k16<kNMajorB ? 1 : 0>(d, da, db, in_piece > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (kb > 0) mbar_arrive(&s.empty[prev]);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      ++in_piece;
      if (kPieces<kEpi> && in_piece == kPromote && kb + 1 < kblocks) {
        wgmma_wait<0>();  // the piece is complete
        fence_acc(d);
        park_add(d, slot(), kb + 1 == kPromote);
        in_piece = 0;
      }
    }
    wgmma_wait<0>();  // k > 0: the reduction always has a block
    mbar_arrive(&s.empty[prev]);
    fence_acc(d);
    if (kPieces<kEpi> && kblocks > kPromote) park_settle(d, slot());
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

// ce_fwd's product: per token and 256-column vocab tile, (max, sum, label
// logit) of s = h·Wᵀ into the forward's scratch
__global__ void __launch_bounds__(gemm::kThreads, 1)
    ce_stats_kernel(const __grid_constant__ CUtensorMap a, const __grid_constant__ CUtensorMap b,
                    const gemm::Args g) {
  gemm::body<false, gemm::Epi::kStats>(a, b, g);
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

// the forward's vocab splits, the rows of its scratch `partial`: in bf16
// one per 256-column tile of ce_stats_kernel; in fp32 about two blocks per
// SM over the whole grid, at most one 64-column tile each
int splits_for(int n, int vocab, int dtype) {
  if (dtype == 1) return (vocab + gemm::BN - 1) / gemm::BN;
  const int row_blocks = (n + FwdShape::BR - 1) / FwdShape::BR;
  const int tiles = (vocab + FwdShape::BC - 1) / FwdShape::BC;
  const int want = 2 * device_int(cudaDevAttrMultiProcessorCount) / (row_blocks > 0 ? row_blocks : 1);
  return want < 1 ? 1 : (want > tiles ? tiles : want);
}

int fwd_fp32(const CEParams& p, cudaStream_t st) {
  const dim3 grid((p.n + FwdShape::BR - 1) / FwdShape::BR, p.splits);
  return launch(ce_fwd_kernel, grid, FwdShape::smem(), p, st);
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

// the park slots of a launch of at most `blocks` blocks (kept between
// launches, grown when a launch needs more)
float* park_buffer(int blocks) {
  static float* buf = nullptr;
  static size_t have = 0;
  const size_t want = static_cast<size_t>(blocks) * 128 * gemm::kConsumers * 128;
  if (want > have) {
    if (buf != nullptr) cudaFree(buf);
    buf = nullptr;
    have = 0;
    if (cudaMalloc(&buf, want * sizeof(float)) != cudaSuccess) return nullptr;
    have = want;
  }
  return buf;
}

template <typename Kernel>
int launch_gemm(Kernel kernel, const CUtensorMap& a, const CUtensorMap& b, gemm::Args g,
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
  const int blocks = tiles < sms ? tiles : sms;
  if (g.k > gemm::kPromote * gemm::BK) {
    g.park = park_buffer(sms);
    if (g.park == nullptr) return static_cast<int>(cudaErrorMemoryAllocation);
  }
  kernel<<<blocks, gemm::kThreads, gemm::kSmemBytes, st>>>(a, b, g);
  return static_cast<int>(cudaGetLastError());
}

// bf16 ce_fwd: the stats product over the same K-major maps as ce_dh's
// first product (h [n, E] in [128 x 64] boxes, W [V, E] in [256 x 64]
// boxes: only E needs 16-byte rows, V may be any size)
int fwd_bf16(const CEParams& p, cudaStream_t st) {
  CUtensorMap mr, mc;
  if (!tensor_map(&mr, p.h, p.n, p.hidden, gemm::BM, gemm::BK) ||
      !tensor_map(&mc, p.w, p.vocab, p.hidden, gemm::BN, gemm::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const gemm::Args g{p.n, p.vocab, p.hidden, 0, nullptr, 0,
                     nullptr, nullptr, nullptr, p.labels, p.partial};
  return launch_gemm(ce_stats_kernel, mr, mc, g, st);
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
extern "C" int ce_fwd_splits(int n, int vocab, int dtype) { return splits_for(n, vocab, dtype); }

// the splits' (max, sum, label logit) into each token's lse and loss: the
// stats kernel (bf16) or ce_fwd_kernel (fp32), then ce_combine_kernel
extern "C" int ce_fwd(const CEParams* p, int dtype, void* stream) {
  if (!valid(p, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  if (p->n == 0) return 0;
  if (p->splits != splits_for(p->n, p->vocab, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = dtype == 1 ? fwd_bf16(*p, st) : fwd_fp32(*p, st);
  if (err != 0) return err;
  ce_combine_kernel<<<(p->n + kThreads - 1) / kThreads, kThreads, 0, st>>>(*p);
  return static_cast<int>(cudaGetLastError());
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
