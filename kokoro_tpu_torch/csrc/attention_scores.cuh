// K4 past head dim 2048, "scores in memory" (sm_90a): the forward and the
// backward of the flash policy (attention_kernels.cuh's contract: causal
// triangle and segment ids, -0.7 * FLT_MAX added to a masked logit, no
// dropout) at every head dim that is a multiple of 64, bf16 here, f32 in
// attention_scores_tf32.cuh (wgmma, TMA), which takes this file's schedule
// and its f32 row pass.  flash_attention.cu and flash_attention_bwd.cu
// launch them (kokoro_flash_attention_{fwd,bwd}_scores) and the wrappers of
// ops/flash_attention.py take them past Dh 2048 (f32: attention_scores_tf32.cuh
// from F32_SCORES_FROM on).  They replace the same TPU
// kernels as the rest of K4: the library Pallas flash attention behind
// kokoro_tpu/models/blocks.py::_flash_attention (forward
// _flash_attention_kernel, pl.pallas_call flash_attention.py:758; backward
// _flash_attention_bwd_dkv, :1121, and _flash_attention_bwd_dq, :1456),
// which the reference's gate admits at any multiple of 64.
//
// Why not the cluster kernels (attention_tc.cuh, attention_tf32.cuh): a CTA
// there owns 128 head-dim columns of a row tile and sums the cluster's
// partial scores through its peers' shared memory, and Hopper's largest
// cluster is 16 CTAs: 2048 columns.  Past that the score matrix of a head,
// 4 T^2 bytes in f32, is smaller than its Q, K, V and O (8 T Dh bytes in
// bf16) wherever Dh > T / 2, so the scores go through device memory: no
// cross-CTA exchange, no cluster, and no limit on the head dim.
//
// Three templates, each a plain tiled product or a row pass:
//   * scores: one CTA a (128 queries x 128 keys) tile of one (b, h),
//     S = Q K^T over the whole head dim
//     in chunks of kChunk columns through a kStages-stage cp.async ring,
//     then S *= scale and the mask; under causal only the tiles on or below
//     the diagonal are launched (score_tile).  The backward's CTA takes S
//     and then dP = dO V^T for the same tile through the same ring, and its
//     epilogue is the backward's row pass, which is elementwise given the
//     forward's lse and each row's delta: P = exp(s - lse) and
//     dS = (dP - delta) * P * scale, each rounded to the input type.
//   * rows (forward): a warp a query row: m = max, l = sum exp(s - m) over
//     the written tiles, lse = m + log l, the unnormalised P~ = exp(s - m)
//     rounded to the input type (f32: over S in place).  A row with no
//     visible key (counted from the mask, not read from m: the mask value is
//     finite) gets P~ = 0, l = 1 and lse = +inf.
//   * apply: O = P~ V / l, dQ = dS K (rows are queries, the contraction over
//     keys, under causal up to the row tile's diagonal), dK = dS^T Q and
//     dV = P^T dO (rows are keys, the contraction over queries, under
//     causal from the key tile's first key on), each CTA a row tile times a
//     128-column strip of the head dim (a ragged 64-column last strip at
//     Dh = 128 n + 64: the warps past the head dim skip their products).
//   * delta (backward): each row's rowsum(dO * O), by the very products of
//     dP (the scores template on dO and O, the diagonal of the query tile),
//     so that a row whose one visible key gives O = that key's V row (P~ = 1)
//     has dP - delta = 0 exactly, hence dS = 0, as in the plain version.
//
// Products (no library GEMM): bf16 on mma.sync.m16n8k16 (ldmatrix, .trans
// for the operands stored with the contraction as their row: V, K, Q, dO
// in apply, and dS^T, P^T), f32 accumulate.  A CTA is 8 warps, 2 x 4 over
// its tile, warps of 64 x 32 (a CTA 128 x 128).  Shared memory rows are
// padded so that every ldmatrix read hits distinct banks.  Every
// output element is summed by one thread in a fixed order and nothing is
// atomic: two calls are bitwise equal, and nothing reads
// torch.backends.cuda.matmul.allow_tf32.
//
// Workspaces (the wrapper allocates them; a kernel allocates nothing): S in
// f32 and P~ in the input type (forward; the f32 row pass writes P~ over S),
// P and dS in the input type (backward), each (B H, Mq, Nk) with Mq, Nk = Tq, Tk rounded up to 128,
// whatever the head dim; the forward's row sums l (B H, Tq) f32, the
// backward's delta (B H, Tq) f32.  A scheduled score tile is written whole
// (zeros past Tq and Tk), so that apply reads nothing unwritten.  Offsets
// are 64-bit.
//
// What bounds them on an H100 (989 TFLOP/s bf16, 3.35 TB/s): a call does 4 Dh (forward) or 10 Dh (backward; 12 Dh
// here, with S recomputed and the delta's products) operations a visible
// (query, key) pair, and past Dh 2048 at the long path's T = 1408 those
// are the bound (the bf16 forward at Dh 2560, B=12, H=1, causal: 0.123 ms
// against 0.028 ms of bytes).  Every tile of the scores product costs the
// same (the whole head dim), so the launch is a flat list of tiles; the
// workspace traffic (S written and read twice, P~ written and read) is not
// in the bound, and costs about 0.05-0.09 ms of the bf16 forward there.

#pragma once

#include <math.h>

#include "attention_common.cuh"
#include "attention_tc.cuh"
#include "attention_tf32.cuh"

namespace kokoro_attn {
namespace scores {

constexpr int kTile = 128;    // a score tile: 128 queries x 128 keys (workspace padding)
constexpr int kChunk = 32;    // the contraction's chunk
constexpr int kStages = 3;    // the cp.async ring
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpsM = 2, kWarpsN = 4;  // a CTA's warps over its rows x columns
constexpr int kStrip = 128;   // head-dim columns a CTA of apply writes

// fragments of m16 x n8 a warp takes: 64 x 32
template <typename T> struct Frags;
template <> struct Frags<__nv_bfloat16> { static constexpr int MT = 4, NT = 4; };

// rows of a CTA's tile (its columns: kWarpsN * 8 * NT = 128 = kTile)
template <typename T>
__host__ __device__ constexpr int cta_rows() {
  return kWarpsM * 16 * Frags<T>::MT;
}
static_assert(kWarpsN * 8 * Frags<__nv_bfloat16>::NT == kTile, "a CTA's columns are a score tile's");

template <typename T>
using Acc = float[Frags<T>::MT][Frags<T>::NT][4];

// -- the schedule (ops/flash_scores.py mirrors it; tests/test_torch_flash_scores_schedule.py
// holds the mirror against the visible pairs) ----------------------------------------------

__host__ __device__ inline int tiles_of(int T) { return (T + kTile - 1) / kTile; }

// score tiles of one (b, h): every (query tile, key tile), or under causal
// those with a key at or below a query of the tile (kj <= qi)
__host__ __device__ inline int score_tiles(int nq, int nk, bool causal) {
  if (!causal) return nq * nk;
  if (nq <= nk) return nq * (nq + 1) / 2;
  return nk * (nk + 1) / 2 + (nq - nk) * nk;
}

// tile t of score_tiles' list -> (qi, kj): row by row, causal rows qi < nk
// holding qi + 1 tiles and the later ones nk
__host__ __device__ inline void score_tile(int t, int nk, bool causal, int& qi, int& kj) {
  if (!causal) {
    qi = t / nk;
    kj = t % nk;
    return;
  }
  const int tri = nk * (nk + 1) / 2;
  if (t >= tri) {
    qi = nk + (t - tri) / nk;
    kj = (t - tri) % nk;
    return;
  }
  int i = (int)((sqrtf(8.f * (float)t + 1.f) - 1.f) * 0.5f);
  while (i > 0 && i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  qi = i;
  kj = t - i * (i + 1) / 2;
}

// the contraction [k0, k1) of apply's row tile r0 .. r0 + rows: over keys
// (rows are queries: under causal up to the tile's last query) or over
// queries (rows are keys: under causal from the tile's first key), in
// whole chunks; the workspace past Tq or Tk inside a written tile is zero
__host__ __device__ inline void apply_range(int r0, int rows, int Tq, int Tk, bool causal,
                                            bool over_queries, int& k0, int& k1) {
  const int end = over_queries ? Tq : (causal ? (Tk < r0 + rows ? Tk : r0 + rows) : Tk);
  k0 = over_queries && causal ? r0 : 0;
  k1 = (end + kChunk - 1) / kChunk * kChunk;
  if (k1 < k0) k1 = k0;
}

// -- device helpers ---------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void cp16(T* dst, const T* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(tc::smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// ROWS x COLS of a row-major matrix (ld elements a row) from (row0, col0)
// into dst (rows LD elements apart); a row at or past row_end, or a 16-byte
// chunk at or past col_end, is zero-filled
template <typename T, int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, size_t ld, int row0, int row_end,
                                          int col0, int col_end) {
  constexpr int E = 16 / (int)sizeof(T), CH = COLS / E, N = ROWS * CH;
  static_assert(N % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < N / kThreads; ++j) {
    const int i = (int)threadIdx.x + j * kThreads;
    const int r = i / CH, c = (i % CH) * E;
    const bool in = row0 + r < row_end && col0 + c < col_end;
    cp16(dst + r * LD + c, in ? src + (size_t)(row0 + r) * ld + col0 + c : src, in);
  }
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tc::smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tc::smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// One product's ring stage: A (the CTA's rows x kChunk) and B (kChunk x
// 128), each kept as its source stores it: A_KM / B_KN, the contraction
// index is the row ([k][m], [k][n]: V, K, Q, dO in apply; dS^T, P^T),
// else the column ([m][k], [n][k]: Q, K, dO, V in scores; P~, dS).  Rows
// padded: 16 bytes past a contraction-major row (ldmatrix's 8 rows, and
// the f32 reads of rows g, columns t, on distinct banks), 8 elements past
// the others (the .trans reads, and f32 rows t, columns g).
template <typename T, bool A_KM, bool B_KN>
struct Stage {
  static constexpr int BM = cta_rows<T>(), BN = kTile;
  static constexpr int A_ROWS = A_KM ? kChunk : BM, A_COLS = A_KM ? BM : kChunk;
  static constexpr int A_LD = A_COLS + (A_KM ? 8 : 16 / (int)sizeof(T));
  static constexpr int B_ROWS = B_KN ? kChunk : BN, B_COLS = B_KN ? BN : kChunk;
  static constexpr int B_LD = B_COLS + (B_KN ? 8 : 16 / (int)sizeof(T));
  static constexpr int A_ELEMS = A_ROWS * A_LD;
  static constexpr int ELEMS = A_ELEMS + B_ROWS * B_LD;
  static constexpr int BYTES = kStages * ELEMS * (int)sizeof(T);
};

// a row-major matrix: element (r, c) at p[r * ld + c], rows below `rows`
// and columns below `cols` read, the rest zero
template <typename T>
struct Operand {
  const T* p;
  size_t ld;
  int rows, cols;
};

// the warp's first row and column in the CTA's tile
template <typename T>
__device__ __forceinline__ int warp_row0() {
  return (int)(threadIdx.x >> 5) / kWarpsN * 16 * Frags<T>::MT;
}
__device__ __forceinline__ int warp_col0() { return (int)(threadIdx.x >> 5) % kWarpsN * 32; }

// acc += a chunk's product, bf16: 2 steps of 16, ldmatrix fragments
template <bool A_KM, bool B_KN>
__device__ __forceinline__ void chunk_product(Acc<__nv_bfloat16>& acc, const __nv_bfloat16* As,
                                              const __nv_bfloat16* Bs) {
  using S = Stage<__nv_bfloat16, A_KM, B_KN>;
  constexpr int MT = Frags<__nv_bfloat16>::MT, NT = Frags<__nv_bfloat16>::NT;
  const int lane = threadIdx.x & 31;
  const int wm0 = warp_row0<__nv_bfloat16>(), wn0 = warp_col0();
#pragma unroll
  for (int ks = 0; ks < kChunk; ks += 16) {
    uint32_t a[MT][4], b[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (!A_KM)
        ldsm(a[mt], As + (wm0 + mt * 16 + (lane & 15)) * S::A_LD + ks + (lane >> 4) * 8);
      else
        ldsm_t(a[mt], As + (ks + (lane >> 4) * 8 + (lane & 7)) * S::A_LD + wm0 + mt * 16 +
                          ((lane >> 3) & 1) * 8);
    }
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t r[4];
      if constexpr (!B_KN)
        ldsm(r, Bs + (wn0 + nt * 8 + (lane >> 4) * 8 + (lane & 7)) * S::B_LD + ks +
                    ((lane >> 3) & 1) * 8);
      else
        ldsm_t(r, Bs + (ks + ((lane >> 3) & 1) * 8 + (lane & 7)) * S::B_LD + wn0 + nt * 8 +
                      (lane >> 4) * 8);
      b[nt][0] = r[0];
      b[nt][1] = r[1];
      b[nt + 1][0] = r[2];
      b[nt + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

// acc += A[m0.., k0..k1) B[k0..k1), n0..]: the chunks through the ring, one
// CTA barrier a chunk; `active` false: the warp loads and waits but takes
// no product (its columns are past the head dim).  Ends with the ring idle.
template <typename T, bool A_KM, bool B_KN>
__device__ __forceinline__ void product(Acc<T>& acc, T* smem, const Operand<T>& A, int m0,
                                        const Operand<T>& B, int n0, int k0, int k1,
                                        bool active) {
  using S = Stage<T, A_KM, B_KN>;
  const int n = k1 > k0 ? (k1 - k0) / kChunk : 0;
  auto load_chunk = [&](int c) {
    T* as = smem + (c % kStages) * S::ELEMS;
    T* bs = as + S::A_ELEMS;
    const int kc = k0 + c * kChunk;
    if constexpr (A_KM)
      load_tile<T, kChunk, S::BM, S::A_LD>(as, A.p, A.ld, kc, A.rows, m0, A.cols);
    else
      load_tile<T, S::BM, kChunk, S::A_LD>(as, A.p, A.ld, m0, A.rows, kc, A.cols);
    if constexpr (B_KN)
      load_tile<T, kChunk, S::BN, S::B_LD>(bs, B.p, B.ld, kc, B.rows, n0, B.cols);
    else
      load_tile<T, S::BN, kChunk, S::B_LD>(bs, B.p, B.ld, n0, B.rows, kc, B.cols);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load_chunk(s);
    tf32::cp_async_commit();
  }
  for (int c = 0; c < n; ++c) {
    tf32::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (c + kStages - 1 < n) load_chunk(c + kStages - 1);
    tf32::cp_async_commit();
    const T* as = smem + (c % kStages) * S::ELEMS;
    if (active) chunk_product<A_KM, B_KN>(acc, as, as + S::A_ELEMS);
  }
  tf32::cp_async_wait<0>();
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void zero(Acc<T>& acc) {
#pragma unroll
  for (int mt = 0; mt < Frags<T>::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Frags<T>::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// -- kernels ------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dout;
  const int *q_seg, *kv_seg;
  const float* lse;  // backward: the forward's row log-sum-exp (B H, Tq)
  float* delta;      // backward: each row's rowsum(dO * O) (B H, Tq)
  float* s;          // forward: S (B H, Mq, Nk) f32
  void* p;           // forward: P~ (f32: may be s); backward: P
  void* ds;          // backward: dS
  float* l;          // forward: each row's sum (B H, Tq)
  float* lse_out;    // forward: NULL or (B H, Tq)
  int H, Tq, Tk, Dh, Mq, Nk;
  float scale;
  int causal;
};

__device__ __forceinline__ bool visible(const Args& a, int b, int row, int col) {
  return (!a.causal || col <= row) &&
         (a.q_seg == nullptr || a.q_seg[(size_t)b * a.Tq + row] == a.kv_seg[(size_t)b * a.Tk + col]);
}

// the scaled, masked logit of (row, col), 0 past Tq or Tk
__device__ __forceinline__ float logit(const Args& a, int b, int row, int col, float x) {
  if (row >= a.Tq || col >= a.Tk) return 0.f;
  x *= a.scale;
  return visible(a, b, row, col) ? x : x + kFlashMask;
}

// the score tile of this CTA: its first query and key
template <typename T>
__device__ __forceinline__ void tile_origin(const Args& a, int& m0, int& n0) {
  int qi, kj;
  score_tile((int)blockIdx.x, a.Nk / kTile, a.causal != 0, qi, kj);
  m0 = qi * kTile + (int)blockIdx.y * cta_rows<T>();
  n0 = kj * kTile;
}

// S = scale Q K^T + mask, one tile, into the f32 workspace
template <typename T>
__global__ void __launch_bounds__(kThreads) scores_fwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int bh = blockIdx.z, b = bh / a.H;
  int m0, n0;
  tile_origin<T>(a, m0, n0);
  const Operand<T> Q{static_cast<const T*>(a.q) + (size_t)bh * a.Tq * a.Dh, (size_t)a.Dh, a.Tq,
                     a.Dh};
  const Operand<T> K{static_cast<const T*>(a.k) + (size_t)bh * a.Tk * a.Dh, (size_t)a.Dh, a.Tk,
                     a.Dh};
  Acc<T> acc;
  zero<T>(acc);
  product<T, false, false>(acc, smem, Q, m0, K, n0, 0, a.Dh, true);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm0 = warp_row0<T>(), wn0 = warp_col0();
  float* s = a.s + (size_t)bh * a.Mq * a.Nk;
#pragma unroll
  for (int mt = 0; mt < Frags<T>::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm0 + mt * 16 + g + 8 * h;
#pragma unroll
      for (int nt = 0; nt < Frags<T>::NT; ++nt) {
        const int col = n0 + wn0 + nt * 8 + 2 * t;
        store2(s + (size_t)row * a.Nk + col, logit(a, b, row, col, acc[mt][nt][2 * h]),
               logit(a, b, row, col + 1, acc[mt][nt][2 * h + 1]));
      }
    }
}

// the forward's row pass: a warp a query row of the written tiles
template <typename T>
__global__ void __launch_bounds__(kThreads) rows_kernel(Args a, int BH) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long gr = (long long)blockIdx.x * kWarps + warp;
  if (gr >= (long long)BH * a.Tq) return;
  const int bh = (int)(gr / a.Tq), row = (int)(gr % a.Tq), b = bh / a.H;
  const int c_end = a.causal ? min(a.Nk, (row / kTile + 1) * kTile) : a.Nk;
  const int c_real = min(a.Tk, c_end);
  const float* s = a.s + ((size_t)bh * a.Mq + row) * a.Nk;
  T* p = static_cast<T*>(a.p) + ((size_t)bh * a.Mq + row) * a.Nk;
  float m = -INFINITY;
  bool any = false;
  for (int c = lane; c < c_real; c += 32) {
    m = fmaxf(m, s[c]);
    any = any || visible(a, b, row, c);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  any = __any_sync(0xffffffffu, any);
  float l = 0.f;
  for (int c = lane; c < c_end; c += 32) {
    float x = 0.f;
    if (any && c < c_real) {
      x = expf(s[c] - m);
      l += x;
    }
    store1(p + c, x);  // f32: in place of s[c], read just above by this lane
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
  if (lane == 0) {
    const size_t r = (size_t)bh * a.Tq + row;
    a.l[r] = any ? l : 1.f;
    if (a.lse_out != nullptr) a.lse_out[r] = any ? m + logf(l) : INFINITY;
  }
}

// rows r0 .. of out = X Y (OVER_QUERIES false: X = P~ or dS, rows queries)
// or X^T Y (true: X = dS or P, rows keys), a 128-column strip of the head
// dim; the forward divides each row by its sum l
template <typename T, bool OVER_QUERIES>
__global__ void __launch_bounds__(kThreads) apply_kernel(const void* x, const void* y, void* out,
                                                            const float* l, Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int BM = cta_rows<T>();
  const int bh = blockIdx.z;
  const int To = OVER_QUERIES ? a.Tk : a.Tq, Ty = OVER_QUERIES ? a.Tq : a.Tk;
  // under causal the last query tiles (and the first key tiles) take the
  // longest contractions: they start first
  const int it = !OVER_QUERIES && a.causal ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int r0 = it * BM, n0 = (int)blockIdx.y * kStrip;
  int k0, k1;
  apply_range(r0, BM, a.Tq, a.Tk, a.causal != 0, OVER_QUERIES, k0, k1);
  const Operand<T> X{static_cast<const T*>(x) + (size_t)bh * a.Mq * a.Nk, (size_t)a.Nk, a.Tq,
                     a.Nk};
  const Operand<T> Y{static_cast<const T*>(y) + (size_t)bh * Ty * a.Dh, (size_t)a.Dh, Ty, a.Dh};
  const int wm0 = warp_row0<T>(), wn0 = warp_col0();
  Acc<T> acc;
  zero<T>(acc);
  product<T, OVER_QUERIES, true>(acc, smem, X, r0, Y, n0, k0, k1, n0 + wn0 < a.Dh);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  T* o = static_cast<T*>(out) + (size_t)bh * To * a.Dh;
#pragma unroll
  for (int mt = 0; mt < Frags<T>::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wm0 + mt * 16 + g + 8 * h;
      if (row >= To) continue;
      const float div = l != nullptr ? l[(size_t)bh * a.Tq + row] : 1.f;
#pragma unroll
      for (int nt = 0; nt < Frags<T>::NT; ++nt) {
        const int col = n0 + wn0 + nt * 8 + 2 * t;
        if (col >= a.Dh) continue;
        float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (l != nullptr) {
          v0 /= div;
          v1 /= div;
        }
        store2(o + (size_t)row * a.Dh + col, v0, v1);
      }
    }
}

// each row's delta: dO O^T over the query tile's own rows, its diagonal
template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int bh = blockIdx.z;
  const int m0 = (int)blockIdx.x * kTile + (int)blockIdx.y * cta_rows<T>();
  const int n0 = (int)blockIdx.x * kTile;
  const size_t head = (size_t)bh * a.Tq * a.Dh;
  const Operand<T> dO{static_cast<const T*>(a.dout) + head, (size_t)a.Dh, a.Tq, a.Dh};
  const Operand<T> O{static_cast<const T*>(a.o) + head, (size_t)a.Dh, a.Tq, a.Dh};
  Acc<T> acc;
  zero<T>(acc);
  product<T, false, false>(acc, smem, dO, m0, O, n0, 0, a.Dh, true);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm0 = warp_row0<T>(), wn0 = warp_col0();
#pragma unroll
  for (int mt = 0; mt < Frags<T>::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm0 + mt * 16 + g + 8 * h;
#pragma unroll
      for (int nt = 0; nt < Frags<T>::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn0 + nt * 8 + 2 * t + e;
          if (row == col && row < a.Tq) a.delta[(size_t)bh * a.Tq + row] = acc[mt][nt][2 * h + e];
        }
    }
}

// the backward's tile: S and dP, then P = exp(s - lse) and
// dS = (dP - delta) P scale, each in the input type, into the workspaces
template <typename T>
__global__ void __launch_bounds__(kThreads) scores_bwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int bh = blockIdx.z, b = bh / a.H;
  int m0, n0;
  tile_origin<T>(a, m0, n0);
  const size_t qh = (size_t)bh * a.Tq * a.Dh, kh = (size_t)bh * a.Tk * a.Dh;
  const Operand<T> Q{static_cast<const T*>(a.q) + qh, (size_t)a.Dh, a.Tq, a.Dh};
  const Operand<T> K{static_cast<const T*>(a.k) + kh, (size_t)a.Dh, a.Tk, a.Dh};
  const Operand<T> dO{static_cast<const T*>(a.dout) + qh, (size_t)a.Dh, a.Tq, a.Dh};
  const Operand<T> V{static_cast<const T*>(a.v) + kh, (size_t)a.Dh, a.Tk, a.Dh};
  Acc<T> s_acc, dp_acc;
  zero<T>(s_acc);
  zero<T>(dp_acc);
  product<T, false, false>(s_acc, smem, Q, m0, K, n0, 0, a.Dh, true);
  product<T, false, false>(dp_acc, smem, dO, m0, V, n0, 0, a.Dh, true);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm0 = warp_row0<T>(), wn0 = warp_col0();
  T* P = static_cast<T*>(a.p) + (size_t)bh * a.Mq * a.Nk;
  T* dS = static_cast<T*>(a.ds) + (size_t)bh * a.Mq * a.Nk;
#pragma unroll
  for (int mt = 0; mt < Frags<T>::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm0 + mt * 16 + g + 8 * h;
      const bool in_row = row < a.Tq;
      const float lse = in_row ? a.lse[(size_t)bh * a.Tq + row] : 0.f;
      const float di = in_row ? a.delta[(size_t)bh * a.Tq + row] : 0.f;
#pragma unroll
      for (int nt = 0; nt < Frags<T>::NT; ++nt) {
        const int col = n0 + wn0 + nt * 8 + 2 * t;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[e] = ds[e] = 0.f;
          if (in_row && col + e < a.Tk) {
            // lse = +inf on a row with no visible key: p = 0
            p[e] = expf(logit(a, b, row, col + e, s_acc[mt][nt][2 * h + e]) - lse);
            ds[e] = (dp_acc[mt][nt][2 * h + e] - di) * p[e] * a.scale;
          }
        }
        const size_t at = (size_t)row * a.Nk + col;
        store2(P + at, p[0], p[1]);
        store2(dS + at, ds[0], ds[1]);
      }
    }
}

// -- launches -----------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the shared memory of each kernel: the scores products' stage, apply's
template <typename T>
constexpr int kScoreSmem = Stage<T, false, false>::BYTES;
template <typename T, bool OVER_QUERIES>
constexpr int kApplySmem = Stage<T, OVER_QUERIES, true>::BYTES;

// grids (and the schedule's counts: ops/flash_scores.py::grid mirrors this)
struct Grid {
  int score_tiles;  // score tiles a (b, h)
  int ctas_a_tile;  // CTAs a score tile (1)
  int query_rows;   // apply's row tiles over queries (O, dQ)
  int key_rows;     // over keys (dK, dV)
  int strips;       // 128-column strips of the head dim
};

template <typename T>
Grid grid_of(int Tq, int Tk, int Dh, bool causal) {
  return Grid{score_tiles(tiles_of(Tq), tiles_of(Tk), causal), kTile / cta_rows<T>(),
              (Tq + cta_rows<T>() - 1) / cta_rows<T>(), (Tk + cta_rows<T>() - 1) / cta_rows<T>(),
              (Dh + kStrip - 1) / kStrip};
}

template <typename T>
cudaError_t set_attributes() {
  cudaError_t err = allow_smem(scores_fwd_kernel<T>, kScoreSmem<T>);
  if (err == cudaSuccess) err = allow_smem(scores_bwd_kernel<T>, kScoreSmem<T>);
  if (err == cudaSuccess) err = allow_smem(delta_kernel<T>, kScoreSmem<T>);
  if (err == cudaSuccess) err = allow_smem(apply_kernel<T, false>, kApplySmem<T, false>);
  if (err == cudaSuccess) err = allow_smem(apply_kernel<T, true>, kApplySmem<T, true>);
  return err;
}

// Once a library: internal linkage, since a function-local static of an
// inline function is one object across every library of the process (GNU
// unique binding), and flash_attention.cu and flash_attention_bwd.cu each
// hold their own copies of these kernels
namespace {
template <typename T>
cudaError_t attributes_once() {
  static const cudaError_t err = set_attributes<T>();
  return err;
}
}  // namespace

// forward: scores, rows, apply (O); a.s, a.p, a.l the workspaces
template <typename T>
cudaError_t launch_fwd(const Args& a, void* o, int BH, cudaStream_t st) {
  cudaError_t err = attributes_once<T>();
  if (err != cudaSuccess) return err;
  const Grid gr = grid_of<T>(a.Tq, a.Tk, a.Dh, a.causal != 0);
  constexpr int score_smem = kScoreSmem<T>, apply_smem = kApplySmem<T, false>;
  const dim3 score_grid(gr.score_tiles, gr.ctas_a_tile, BH);
  const dim3 apply_grid(gr.query_rows, gr.strips, BH);
  const unsigned row_blocks = (unsigned)(((long long)BH * a.Tq + kWarps - 1) / kWarps);
  scores_fwd_kernel<T><<<score_grid, kThreads, score_smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rows_kernel<T><<<row_blocks, kThreads, 0, st>>>(a, BH);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  apply_kernel<T, false><<<apply_grid, kThreads, apply_smem, st>>>(a.p, a.v, o, a.l, a);
  return cudaGetLastError();
}

// backward: delta, scores (P, dS), apply (dQ, dK, dV); a.p, a.ds the workspaces
template <typename T>
cudaError_t launch_bwd(const Args& a, void* dq, void* dk, void* dv, int BH, cudaStream_t st) {
  cudaError_t err = attributes_once<T>();
  if (err != cudaSuccess) return err;
  const Grid gr = grid_of<T>(a.Tq, a.Tk, a.Dh, a.causal != 0);
  constexpr int score_smem = kScoreSmem<T>;
  constexpr int q_smem = kApplySmem<T, false>, k_smem = kApplySmem<T, true>;
  const dim3 delta_grid(tiles_of(a.Tq), gr.ctas_a_tile, BH);
  const dim3 score_grid(gr.score_tiles, gr.ctas_a_tile, BH);
  const dim3 q_grid(gr.query_rows, gr.strips, BH), k_grid(gr.key_rows, gr.strips, BH);
  delta_kernel<T><<<delta_grid, kThreads, score_smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scores_bwd_kernel<T><<<score_grid, kThreads, score_smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  apply_kernel<T, false><<<q_grid, kThreads, q_smem, st>>>(a.ds, a.k, dq, nullptr, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  apply_kernel<T, true><<<k_grid, kThreads, k_smem, st>>>(a.ds, a.q, dk, nullptr, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  apply_kernel<T, true><<<k_grid, kThreads, k_smem, st>>>(a.p, a.dout, dv, nullptr, a);
  return cudaGetLastError();
}

// the arguments every launch checks: positive sizes, a head dim that is a
// multiple of 64, segment ids both or neither, B H within a grid's z
inline bool valid(int B, int H, int Tq, int Tk, int Dh, const int* q_seg, const int* kv_seg) {
  return B > 0 && H > 0 && Tq > 0 && Tk > 0 && (long long)B * H <= 65535 && Dh >= 64 &&
         Dh % 64 == 0 && (q_seg == nullptr) == (kv_seg == nullptr);
}

}  // namespace scores
}  // namespace kokoro_attn
