// K4's scores-in-memory path (sm_90a): what its two dtypes' kernels share.
// The forward and the backward of the flash policy (attention_kernels.cuh's
// contract: causal triangle and segment ids, -0.7 * FLT_MAX added to a
// masked logit, no dropout) at every head dim that is a multiple of 64, with
// each head's score matrix in device memory: bf16 in attention_scores_tc.cuh
// and f32 in attention_scores_tf32.cuh (both wgmma fed by TMA), launched by
// flash_attention.cu and flash_attention_bwd.cu
// (kokoro_flash_attention_{fwd,bwd}_scores); the wrappers of
// ops/flash_attention.py take them from BF16_SCORES_FROM / F32_SCORES_FROM
// on.  They replace the same TPU kernels as the rest of K4: the library
// Pallas flash attention behind kokoro_tpu/models/blocks.py::_flash_attention
// (forward _flash_attention_kernel, pl.pallas_call flash_attention.py:758;
// backward _flash_attention_bwd_dkv, :1121, and _flash_attention_bwd_dq,
// :1456), which the reference's gate admits at any multiple of 64.
//
// Why not the cluster kernels (attention_tc.cuh, attention_tf32.cuh): a CTA
// there owns 128 head-dim columns of a row tile and sums the cluster's
// partial scores through its peers' shared memory, and Hopper's largest
// cluster is 16 CTAs: 2048 columns.  Past that the score matrix of a head,
// 4 T^2 bytes in f32, is smaller than its Q, K, V and O (8 T Dh bytes in
// bf16) wherever Dh > T / 2, so the scores go through device memory: no
// cross-CTA exchange, no cluster, and no limit on the head dim.  Below it the
// exchange and the SMs the clusters leave idle cost more than the workspace
// traffic from the crossovers on (PERF.md).
//
// Here: the arguments (Args), the mask (visible, logit), the schedule both
// dtypes' launchers follow, and the forward's row pass, a template of both
// dtypes:
//   * scores: one CTA a (128 queries x 128 keys) tile of one (b, h),
//     S = Q K^T over the whole head dim, then S *= scale and the mask; under
//     causal only the tiles on or below the diagonal are launched
//     (score_tile).  The backward's CTA takes S and then dP = dO V^T for the
//     same tile, and its epilogue is the backward's row pass, which is
//     elementwise given the forward's lse and each row's delta: P =
//     exp(s - lse) and dS = (dP - delta) * P * scale, each rounded to the
//     input type.
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
//     Dh = 128 n + 64), the contraction in whole chunks of the dtype's
//     (apply_range).
//   * delta (backward): each row's rowsum(dO * O), by the very products of
//     dP (the scores products on dO and O, the diagonal of the query tile),
//     so that a row whose one visible key gives O = that key's V row (P~ = 1)
//     has dP - delta = 0 exactly, hence dS = 0, as in the plain version.
//
// Workspaces (the wrapper allocates them; a kernel allocates nothing): S in
// f32 and P~ in the input type (forward; the f32 row pass writes P~ over S),
// each (B H, Mq, Nk) with Mq, Nk = Tq, Tk rounded up to 128, whatever the
// head dim; the forward's row sums l (B H, Tq) f32, the backward's delta
// (B H, Tq) f32 and its P and dS (each dtype's header says how it lays them
// out).  A scheduled score tile is written whole (zeros past Tq and Tk), so
// that apply reads nothing unwritten.  Offsets are 64-bit.  Every output
// element is summed by one thread in a fixed order and nothing is atomic:
// two calls are bitwise equal, and nothing reads
// torch.backends.cuda.matmul.allow_tf32.
//
// What bounds them on an H100 (989 TFLOP/s bf16, 165 of 3xTF32 work, 3.35
// TB/s): a call does 4 Dh (forward) or 10 Dh (backward; 12 Dh here, with S
// recomputed and the delta's products) operations a visible (query, key)
// pair, and at the long path's T = 1408 those are the bound past Dh 256
// (the bf16 forward at Dh 2560, B=12, H=1, causal: 0.123 ms against 0.028 ms
// of bytes).  Every tile of the scores product costs the same (the whole
// head dim), so the launch is a flat list of tiles; the workspace traffic
// (S written and read, P~ written and read) is not in the bound and is flat
// in Dh.

#pragma once

#include <math.h>

#include "attention_common.cuh"

namespace kokoro_attn {
namespace scores {

constexpr int kTile = 128;    // a score tile: 128 queries x 128 keys (workspace padding)
constexpr int kChunk = 32;    // the f32 contraction's chunk (bf16's: attention_scores_tc.cuh)
constexpr int kThreads = 256; // the row pass: a warp a row
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 128;   // head-dim columns a CTA of apply writes

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
// whole chunks of `chunk` (the dtype's); the workspace past Tq or Tk inside
// a written tile is zero
__host__ __device__ inline void apply_range(int r0, int rows, int Tq, int Tk, bool causal,
                                            bool over_queries, int& k0, int& k1,
                                            int chunk = kChunk) {
  const int end = over_queries ? Tq : (causal ? (Tk < r0 + rows ? Tk : r0 + rows) : Tk);
  k0 = over_queries && causal ? r0 : 0;
  k1 = (end + chunk - 1) / chunk * chunk;
  if (k1 < k0) k1 = k0;
}

// -- device helpers ---------------------------------------------------------------

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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

// -- launches -----------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the launch grids' counts (each dtype's grid_of; ops/flash_scores.py::grid
// mirrors them)
struct Grid {
  int score_tiles;  // score tiles a (b, h)
  int ctas_a_tile;  // CTAs a score tile (1)
  int query_rows;   // apply's row tiles over queries (O, dQ)
  int key_rows;     // over keys (dK, dV)
  int strips;       // 128-column strips of the head dim
};

// the arguments every launch checks: positive sizes, a head dim that is a
// multiple of 64, segment ids both or neither, B H within a grid's z
inline bool valid(int B, int H, int Tq, int Tk, int Dh, const int* q_seg, const int* kv_seg) {
  return B > 0 && H > 0 && Tq > 0 && Tk > 0 && (long long)B * H <= 65535 && Dh >= 64 &&
         Dh % 64 == 0 && (q_seg == nullptr) == (kv_seg == nullptr);
}

}  // namespace scores
}  // namespace kokoro_attn
