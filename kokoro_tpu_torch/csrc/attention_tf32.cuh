// The f32 attention on Hopper's tensor cores in 3xTF32 (sm_90a): the
// forward kernel and the backward's dQ and dK/dV kernels of both mask
// policies (packed K1/K2/K3, flash K4), dropout on or off, Dh 64 or 128
// (the flash policy without dropout also from 320 to 2048 as a cluster of
// Dh 128 CTAs: template argument CL; K4 at Dh 192 and 256 has kernels of its
// own, attention_tf32_wide.cuh, built on this header's products), with the
// numerics contract of attention_kernels.cuh.  Replaces no TPU
// kernel of its own: it is the f32 instantiation of the kernels that
// packed_attention.cu, flash_attention.cu, packed_attention_bwd.cu and
// flash_attention_bwd.cu launch (their notes name the TPU kernels).
//
// Arithmetic.  f32's contract (forward within 2e-5, gradients within 1e-4,
// docs/attention_numerics_tpu.json) is beyond one TF32 product (10-bit
// mantissa: about 1e-3 off, tests/test_torch_tf32_split.py).  Each operand
// x of the products (forward: S = Q K^T, O += P V; backward: S, dPd = dO V^T,
// dV += Pd^T dO, dK += dS^T Q, dQ += dS K) is split into big = tf32(x) and
// small = tf32(x - big), both rounded to nearest with ties away (cvt.rna's
// rounding), and each product is big.big' + big.small' + small.big' (the
// dropped small.small' is below f32's rounding).  The tensor cores' own
// accumulation truncates: one accumulator over the 1433 queries of a
// one-key row's dV drifted from float64 several times as far as f32 adds
// do, and a score product so taken moved a one-key row's weight from 1,
// against the forward's lse, far enough to show in that dV.  So every two
// groups of 8 products go through the tensor cores into a fresh
// accumulator, which joins its sum by an f32 add.  The softmax (running max
// and sum, full-precision expf, the rescale of O; the backward's recompute)
// and the dropout stay on the CUDA cores.  Nothing reads
// torch.backends.cuda.matmul.allow_tf32: the result does not depend on it.
//
// The forward takes S by the backward's own score, in the same fragment
// order and grouping as the dQ kernel's recompute, so the lse it writes,
// m + log(l) of those very bits, gives back p = exp(s * scale - lse)
// exactly: a row's one visible key gets weight 1, as in the plain version.
// Each row's delta, rowsum(dO * O), is taken by the same products as the
// kernel's dPd, with the row of O in the place of a row of V (and
// O / (1/keep), times 1/keep again, under dropout): on a row with one
// visible key dS = p (dp - delta) is then exactly 0, as in the plain
// version, where an f32 FMA chain for delta left the products' rounding,
// summed over every query, in the key's dK (past 1e-4 at T = 1433, the rows
// tests/test_torch_kernels_cuda.py holds).  The dQ kernel takes both orders
// of the product (dO V^T there, V dO^T in the dK/dV kernel) and hands the
// second to the dK/dV kernel through the (B, H, Tq) workspace.
//
// Route: mma.sync.m16n8k8 (row.col, tf32 in, f32 accumulate) for every
// product.  wgmma takes tf32 operands from shared memory K-major only (its
// transpose bits exist for 16-bit types), and the products that contract
// over the sequence have an operand (V, dO, Q, K) stored [seq][Dh].
// mma.sync takes its fragments from registers, so each operand is read in
// the pattern its product needs, with the contraction index permuted inside
// each group of 8 (logical k = t and t + 4 are columns 2t and 2t + 1):
//   * a streamed tile (the key/value tiles of the forward and the dQ
//     kernel, the query/dO tiles of the dK/dV kernel) is split once by the
//     CTA into pairs, each 16-byte chunk big(c) small(c) big(c + 1)
//     small(c + 1), so a score product's B fragment is one 16-byte read and
//     a sequence product's (rows 2t and 2t + 1) two 8-byte reads, none split
//     again by a warp; the forward's Q is split once into pairs alike;
//   * the backward's owned tiles (Q and dO, or K and V) stay f32; a warp
//     reads its rows' A fragments as 8-byte pairs and splits them;
//   * the forward's P goes from the score accumulators straight into P V:
//     under the permuted index a C fragment's pairs are the A fragment's,
//     so the loop over k is unrolled and nothing is staged (at Dh 64 under
//     dropout, whose flags take registers, a tile in two steps of 32 keys:
//     one step spilled); the backward's P and dS go through a warp's
//     staging tile in shared memory, so its loops over k stay loops
//     (unrolled, their fragment loads took every register and spilled).
// Each layout swizzles its 16-byte chunks by row, so every one of these
// reads hits 32 distinct banks.
//
// Structure: a CTA is 8 warps and owns 128 rows at Dh 64 (16 a warp), 64 at
// Dh 128 (two warps share each 16 rows, each with half of the output
// columns): the forward's and the dQ kernel's query rows, the dK/dV
// kernel's keys.  A streamed tile (64 rows at Dh 64, 32 at Dh 128) arrives
// by cp.async through a ring of two stages, the next tile's load under this
// tile's products.  The backward (FlashAttention-2's split, no atomics:
// each gradient element is summed by one thread in a fixed order, so two
// calls are bitwise equal) splits a stage in place, four barriers a tile;
// its shared memory is 226.5 KB (dQ) and 210.5 KB (dK/dV) a CTA at Dh 64,
// 209.75 KB at Dh 128.  The dK/dV kernel takes a streamed tile in passes of
// 32 queries.  The forward lands the f32 rows in a ring apart from the
// pairs, two barriers a tile; a row's 8J scores of a tile sit in one quad,
// so its max and sum take two shuffles and alpha rescales the warp's O
// accumulators in registers; 193.5 KB a CTA (Q's pairs 64 KB, the tile's K
// and V pairs 64 KB, the ring 64 KB).  One CTA an SM.  Causal grids start
// with their heaviest tiles, a warp skips a streamed tile none of its rows
// sees, and a tile every pair of whose warp's rows sees skips the mask; the
// other grids keep a head's tiles together.
//
// What bounds it on an H100: operations.  4 * Dh per visible pair forward,
// 10 * Dh backward (the split recomputes S and dPd in both kernels: 14 * Dh
// done), each product three tensor-core products: 495 / 3 = 165 TFLOP/s of
// f32-accurate work at the TF32 peak (67 at the CUDA cores' f32 FMA rate).
// mma.sync reaches about 311 TFLOP/s of TF32 on an H100 (python -m
// kokoro_tpu_torch.scripts.probe_tf32: one product per 6.9 cycles on each
// of an SM's four schedulers, 34 cycles of latency), so about 104 TFLOP/s
// of f32-accurate work.  Beside the products the kernels issue fragment
// loads, splits, register moves and f32 adds (the same script counts them
// in each loop's SASS); every warp reads the whole streamed tile in pairs,
// twice f32's bytes, so shared memory's 128 bytes a clock bound a tile
// about as tightly as the products do; and a CTA's warps wait at its
// barriers while a streamed tile is split: PERF.md section 6 has the times.
// At 32 rows a CTA (Dh 192 and 256) that split, its barriers and the pairs'
// reads cost more than they save: attention_tf32_wide.cuh reads raw tiles.
//
// Past Dh 256 (CL): a cluster of ceil(Dh / 128) CTAs (3 to 16), each the Dh 128
// kernel on its 128 columns (cp.async predicated to zero past Dh) and its
// 32-row streamed tiles.  The two warps of a row group split each score's
// contraction (S, dPd, the delta products: 64 columns each, where the
// Dh 128 kernel has both take all 128), add their partials in shared memory
// half a tile each, and sum their halves across the cluster (pair_score,
// tc::ClusterSum's reduce-scatter and all-gather, in rank order), so a score
// tile crosses DSMEM once a row group and the forward and the dQ kernel
// still sum alike (the lse stays exact).  The forward shares the halves
// (pair_share); the backward carries each half through the weights and dS,
// and the halves meet in a staging tile the pair shares (the dPd slots the
// warps have read), 230,272 bytes of shared memory a CTA up to 8 CTAs and
// at most 231,168 past them (of 232,448; the exchange's slots sized by the
// cluster's size, tc::rs_cells).

#pragma once

#include "attention_common.cuh"
#include "attention_tc.cuh"

namespace kokoro_attn {
namespace tf32 {

constexpr int kWarps = 8;
constexpr int kCtaThreads = 32 * kWarps;
constexpr int kStages = 2;

// Probe switches: python -m kokoro_tpu_torch.scripts.probe_flash_tf32_wide
// builds the kernels with each of these defined to read what the part costs
// (the results are wrong: timing only); the port's own build defines none.
//   KOKORO_TF32_SPLIT_OFF: the split of the streamed tiles into TF32 pairs
//     (a CTA's split_stage / split_rows, their barrier included);
//   KOKORO_TF32_EXCHANGE_OFF: the score partials' exchange between the warps
//     of a row group (attention_tf32_wide.cuh's exchange: each warp keeps its
//     own partial);
//   KOKORO_TF32_BARRIERS_OFF: the CTA-wide barriers of the streaming loops.
#ifdef KOKORO_TF32_SPLIT_OFF
constexpr bool kProbeSplitOff = true;
#else
constexpr bool kProbeSplitOff = false;
#endif
#ifdef KOKORO_TF32_EXCHANGE_OFF
constexpr bool kProbeExchangeOff = true;
#else
constexpr bool kProbeExchangeOff = false;
#endif
#ifdef KOKORO_TF32_BARRIERS_OFF
constexpr bool kProbeBarriersOff = true;
#else
constexpr bool kProbeBarriersOff = false;
#endif

// a CTA-wide barrier of a streaming loop
__device__ __forceinline__ void ring_sync() {
  if constexpr (!kProbeBarriersOff) __syncthreads();
}

// warps sharing each 16 owned rows, each taking DH / split output columns
// (64); Dh 192 and 256 have kernels of their own (attention_tf32_wide.cuh)
template <int DH>
__host__ __device__ constexpr int col_split() {
  static_assert(DH == 64 || DH == 128, "Dh 64 or 128 (a cluster CTA: 128)");
  return DH == 64 ? 1 : 2;
}
// rows a CTA owns (16 a group of warps) and rows a streamed tile holds: 128
// and 64 at Dh 64, 64 and 32 at Dh 128 (a split stage of two tiles is 64 KB)
template <int DH>
__host__ __device__ constexpr int owned_rows() {
  return 16 * kWarps / col_split<DH>();
}
// A cluster launch (CL, K4 past Dh 256: DH = 128 columns a CTA, the score
// partials summed across the cluster) streams the Dh 128 kernel's tiles of
// kClusterRows rows (16 builds too: PERF.md section 6 times both).
constexpr int kClusterRows = 32;
template <int DH, bool CL = false>
__host__ __device__ constexpr int stream_rows() {
  return CL ? kClusterRows : 4096 / DH;
}
// the dK/dV kernel takes a streamed tile in passes of 32 queries
template <int DH, bool CL = false>
__host__ __device__ constexpr int pass_rows() {
  return stream_rows<DH, CL>() < 32 ? stream_rows<DH, CL>() : 32;
}
// a cluster launch's exchanges: half of a row group's 16 x kClusterRows
// score tile, at most 8 floats a lane (cells of one float: 256 a tile, 128
// at 4 floats a lane, whose slots tc::ClusterSum sizes for c <= 16)
constexpr int kClusterFloats = 8;

// -- shared memory ----------------------------------------------------------

// An owned tile: float (r, c) of DH-float rows, the 8-float block c / 8 at
// block (c / 8) ^ (r % 4): the fragment reads (rows g of a quad group,
// columns 2t, 2t + 1) hit 32 distinct banks.
template <int DH>
__device__ __forceinline__ int own_at(int r, int c) {
  return r * DH + (c ^ ((r & 3) << 3));
}

// A split streamed tile: rows of 2 DH floats, each 16-byte chunk the pair
// (big, small) of two neighbouring columns, big(c) small(c) big(c+1)
// small(c+1); chunk c / 2 of row n at chunk (c / 2) ^ sigma(n), sigma(n) =
// 2 ((n / 2) % 4) ^ 4 (n % 2).  The score product's B fragment (row g,
// columns 2t, 2t + 1) is one 16-byte read and the sequence products' (rows
// 2t and 2t + 1, column g) two 8-byte reads, each free of bank conflicts.
template <int DH>
__device__ __forceinline__ int pair_at(int n, int c) {
  const int chunk = (c >> 1) ^ (((n >> 1) & 3) << 1) ^ ((n & 1) << 2);
  return n * 2 * DH + 4 * chunk + 2 * (c & 1);
}

// A warp's staging tile of P or dS (16 rows of NQ floats), swizzled as an
// owned tile: the accumulator's pairs in, the A fragments' pairs out.  At
// NQ = 16 (a cluster pair's half tiles) two rows share a bank line, and the
// block c / 8 moves by bit 1 of the row: rows g = 0..7 land on four
// distinct 8-bank groups, the fewest conflicts 64 floats can have.
template <int NQ>
__device__ __forceinline__ int w_at(int r, int c) {
  return r * NQ + (c ^ (NQ >= 32 ? (r & 3) << 3 : (NQ == 16 ? ((r >> 1) & 1) << 3 : 0)));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(tc::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(tc::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every committed group but the newest (N = 1), or every one (N = 0), has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `rows` rows from row0 of one head (rows D floats apart) -> an owned tile
// (OWNED) or plain rows of DH floats; rows at or past row_end, and columns
// at or past cols, are zero-filled
template <int DH, bool OWNED>
__device__ __forceinline__ void load_tile_async(float* dst, const float* head, int row0,
                                                int rows, int row_end, int D, int cols = DH) {
  constexpr int CH = DH / 4;  // 16-byte chunks a row
#pragma unroll 4
  for (int idx = threadIdx.x; idx < rows * CH; idx += kCtaThreads) {
    const int r = idx / CH, c = 4 * (idx % CH);
    const bool in = row0 + r < row_end && (cols >= DH || c < cols);
    cp_async16(dst + (OWNED ? own_at<DH>(r, c) : r * DH + c),
               head + (in ? (size_t)(row0 + r) * D + c : 0), in ? 16 : 0);
  }
}

// values [row0, row0 + n) of a row vector -> shared memory; 0 at or past
// row_end
template <typename V>
__device__ __forceinline__ void load_vec_async(V* dst, const V* src, int row0, int n,
                                               int row_end) {
  if ((int)threadIdx.x < n) {
    const bool in = row0 + (int)threadIdx.x < row_end;
    cp_async4(dst + threadIdx.x, src + (in ? row0 + threadIdx.x : 0), in ? 4 : 0);
  }
}

// -- 3xTF32 products ------------------------------------------------------------

// x = big + small, both rounded to TF32 to nearest, ties away from zero
// (cvt.rna.tf32.f32's rounding, here in integer instructions: cvt.rna also
// tests for infinities, four instructions where these take two).  The
// tensor cores read only the top 19 bits of a TF32 operand, so small needs
// no mask; big does, since x - big is taken in f32.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// float4 idx of a streamed tile's f32 rows (row idx / (DH / 4), columns
// 4 (idx % (DH / 4)) .. + 3) -> its pairs in `tile`
template <int DH>
__device__ __forceinline__ void store_pairs(float* tile, int idx, float4 x) {
  const int n = idx / (DH / 4), c = 4 * (idx % (DH / 4));
  uint4 lo, hi;
  split(x.x, lo.x, lo.y);
  split(x.y, lo.z, lo.w);
  split(x.z, hi.x, hi.y);
  split(x.w, hi.z, hi.w);
  *reinterpret_cast<uint4*>(tile + pair_at<DH>(n, c)) = lo;
  *reinterpret_cast<uint4*>(tile + pair_at<DH>(n, c + 2)) = hi;
}

// The two streamed tiles of a ring stage (each 2 S DH floats, its f32 rows
// landed in its second half) split by the CTA into pairs over the whole
// tile: every thread reads its raw values, the CTA waits, then writes.
template <int DH, bool CL = false>
__device__ __forceinline__ void split_stage(float* stage) {
  if constexpr (kProbeSplitOff) return;
  constexpr int S = stream_rows<DH, CL>(), N4 = S * DH / 4 / kCtaThreads;  // float4 a thread a tile
  float4 x[2][N4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < N4; ++i)
      x[m][i] = reinterpret_cast<const float4*>(stage + (2 * m + 1) * S * DH)[threadIdx.x +
                                                                                i * kCtaThreads];
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < N4; ++i)
      store_pairs<DH>(stage + 2 * m * S * DH, threadIdx.x + i * kCtaThreads, x[m][i]);
}

// N tiles of ROWS f32 rows (ROWS DH floats each, back to back from raw)
// split by the CTA into pairs from `pairs` (2 ROWS DH floats each): the
// forward's K and V tiles, and its query rows.  Source and destination
// differ, so no thread waits for another between its reads and its writes.
template <int DH, int ROWS, int N>
__device__ __forceinline__ void split_rows(const float* raw, float* pairs) {
  if constexpr (kProbeSplitOff) return;
  constexpr int N4 = ROWS * DH / 4 / kCtaThreads;  // float4 a thread a tile
  float4 x[N][N4];
#pragma unroll
  for (int m = 0; m < N; ++m)
#pragma unroll
    for (int i = 0; i < N4; ++i)
      x[m][i] = reinterpret_cast<const float4*>(raw + m * ROWS * DH)[threadIdx.x + i * kCtaThreads];
#pragma unroll
  for (int m = 0; m < N; ++m)
#pragma unroll
    for (int i = 0; i < N4; ++i)
      store_pairs<DH>(pairs + 2 * m * ROWS * DH, threadIdx.x + i * kCtaThreads, x[m][i]);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B in 3xTF32: the two small terms, then big.big'
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                     uint32_t bs0, uint32_t bs1) {
  mma(d, ab, bs0, bs1);
  mma(d, as, bb0, bb1);
  mma(d, ab, bb0, bb1);
}

// an A fragment from two f32 pairs (rows g and g + 8, columns 2t, 2t + 1 of
// a group of 8: logical k = t and t + 4), split
__device__ __forceinline__ void a_fragment(float2 top, float2 bottom, uint32_t (&ab)[4],
                                           uint32_t (&as)[4]) {
  split(top.x, ab[0], as[0]);
  split(bottom.x, ab[1], as[1]);
  split(top.y, ab[2], as[2]);
  split(bottom.y, ab[3], as[3]);
}

// The A operand of score: 16 rows of an owned tile (rows row0 + g and
// row0 + g + 8 a thread), split at every use, as the backward takes them.
template <int DH>
struct OwnedRows {
  const float* A;
  int row0;
  // columns 8 kg .. 8 kg + 7 (logical t, t + 4 = columns 2t, 2t + 1), split
  __device__ __forceinline__ void fragment(int kg, int lane, uint32_t (&ab)[4],
                                           uint32_t (&as)[4]) const {
    const int g = lane >> 2, c = 8 * kg + 2 * (lane & 3);
    a_fragment(*reinterpret_cast<const float2*>(A + own_at<DH>(row0 + g, c)),
               *reinterpret_cast<const float2*>(A + own_at<DH>(row0 + g + 8, c)), ab, as);
  }
};

// The same rows split once into a pair tile (laid out as a split streamed
// tile: the forward's Q): the A fragment is two 16-byte reads of the values
// OwnedRows would split, so score takes the same products and gives the
// same bits.
template <int DH>
struct PairRows {
  const float* P;
  int row0;
  __device__ __forceinline__ void fragment(int kg, int lane, uint32_t (&ab)[4],
                                           uint32_t (&as)[4]) const {
    const int g = lane >> 2, c = 8 * kg + 2 * (lane & 3);
    const uint4 top = *reinterpret_cast<const uint4*>(P + pair_at<DH>(row0 + g, c));
    const uint4 bottom = *reinterpret_cast<const uint4*>(P + pair_at<DH>(row0 + g + 8, c));
    ab[0] = top.x, as[0] = top.y, ab[2] = top.z, as[2] = top.w;
    ab[1] = bottom.x, as[1] = bottom.y, ab[3] = bottom.z, as[3] = bottom.w;
  }
};

// s (16 x 8J: J tiles of 8 columns, C fragments) = A B^T over DH columns:
// A a warp's 16 rows (OwnedRows or PairRows), B rows b_row0.. of a split
// streamed tile or, with SPLIT_B false, of an owned tile split here alike.
// The contraction index is permuted in each group of 8 (logical t, t + 4 =
// columns 2t, 2t + 1).  Each element is the same sequence of products and
// adds whichever tile it sits in and however A and B were split.  kg0 and
// kg1 (even) bound the contraction to the groups of 8 [kg0, kg1).
template <int DH, int J, bool SPLIT_B = true, typename Rows>
__device__ __forceinline__ void score(float (&s)[J][4], const Rows& A, const float* B, int b_row0,
                                      int lane, int kg0 = 0, int kg1 = DH / 8) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < J; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 1
  for (int ks = kg0; ks < kg1; ks += 2) {
    float part[J][4] = {};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = 8 * (ks + u) + 2 * t;
      uint32_t ab[4], as[4];
      A.fragment(ks + u, lane, ab, as);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int n = b_row0 + 8 * j + g;
        uint32_t bb0, bs0, bb1, bs1;
        if constexpr (SPLIT_B) {
          const uint4 v = *reinterpret_cast<const uint4*>(B + pair_at<DH>(n, c));
          bb0 = v.x, bs0 = v.y, bb1 = v.z, bs1 = v.w;
        } else {
          const float2 v = *reinterpret_cast<const float2*>(B + own_at<DH>(n, c));
          split(v.x, bb0, bs0);
          split(v.y, bb1, bs1);
        }
        mma3(part[j], ab, as, bb0, bb1, bs0, bs1);
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
  }
}

// floats of a cluster launch's exchange of partial scores (pair_score): two
// slots of 16 x S / 2 a row group
template <int DH, bool CL = false>
__host__ __device__ constexpr int xch_floats() {
  return CL ? kWarps * 8 * stream_rows<DH, CL>() : 0;
}

// a barrier of the `warps` warps of row group `group` (ids 1..: 0 is
// __syncthreads)
__device__ __forceinline__ void row_group_sync(int group, int warps) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(32 * warps) : "memory");
}

// In a cluster launch (CL) the two warps of a row group (part 0 and 1) split
// each score's contraction over the CTA's 128 columns, part p taking columns
// [64 p, 64 p + 64), and part p then owns n-tiles [H p, H p + H) of the
// 16 x 8J tile (H = J / 2).  pair_score: each writes the other's half of
// its partial to its slot, and after the pair's barrier adds the other's
// partial of its own half (p0 + p1) and sums that half across the cluster
// (tc::ClusterSum, in rank order), so each score tile crosses DSMEM once a
// row group.  Every kernel sums alike, so the forward's lse still gives the
// dQ kernel's weights back exactly.  slots: the pair's two slots of 4 H
// floats a lane (lane-major), slot p written by part p.
template <int DH, int J, bool SPLIT_B = true, typename Rows>
__device__ __forceinline__ void pair_score(float (&h)[J / 2][4], const Rows& A, const float* B,
                                           int b_row0, int lane, float* slots, int group,
                                           int part, tc::ClusterSum<kClusterFloats>& cluster) {
  constexpr int H = J / 2, KG = DH / 16;  // n-tiles of a half; groups of 8 columns of a part
  float s[J][4];
  score<DH, J, SPLIT_B>(s, A, B, b_row0, lane, part * KG, (part + 1) * KG);
  float* mine = slots + part * 128 * H;
  const float* theirs = slots + (1 - part) * 128 * H;
#pragma unroll
  for (int j = 0; j < H; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[(4 * j + e) * 32 + lane] = part ? s[j][e] : s[H + j][e];
  row_group_sync(group, 2);
#pragma unroll
  for (int j = 0; j < H; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[j][e] = (part ? s[H + j][e] : s[j][e]) + theirs[(4 * j + e) * 32 + lane];
  cluster(*reinterpret_cast<float(*)[4 * H]>(&h[0][0]), lane);
}

// The pair's halves (pair_score's h) -> the whole tile in both warps: each
// writes its half into the slot it read, and after the pair's barrier reads
// the other's from its own slot.
template <int J>
__device__ __forceinline__ void pair_share(float (&s)[J][4], const float (&h)[J / 2][4],
                                           float* slots, int group, int part, int lane) {
  constexpr int H = J / 2;
  float* theirs = slots + (1 - part) * 128 * H;
  const float* mine = slots + part * 128 * H;
#pragma unroll
  for (int j = 0; j < H; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) theirs[(4 * j + e) * 32 + lane] = h[j][e];
  row_group_sync(group, 2);
#pragma unroll
  for (int j = 0; j < H; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = mine[(4 * j + e) * 32 + lane];
      s[j][e] = part ? x : h[j][e];
      s[H + j][e] = part ? h[j][e] : x;
    }
}

// a warp's 16 x 8J score tile (its C fragments) -> its staging tile W
template <int NQ, int J>
__device__ __forceinline__ void stage_tile(float* W, const float (&x)[J][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    *reinterpret_cast<float2*>(W + w_at<NQ>(g, 8 * j + 2 * t)) = make_float2(x[j][0], x[j][1]);
    *reinterpret_cast<float2*>(W + w_at<NQ>(g + 8, 8 * j + 2 * t)) = make_float2(x[j][2], x[j][3]);
  }
}

// The A operand of accumulate: a warp's 16 x 8J tile staged in W (16 rows
// of NQ floats), split at every use.
template <int NQ>
struct StagedRows {
  static constexpr int kUnroll = 1;  // accumulate's loop over k stays a loop
  const float* W;
  __device__ __forceinline__ void fragment(int kg, int lane, uint32_t (&ab)[4],
                                           uint32_t (&as)[4]) const {
    const int g = lane >> 2, c = 8 * kg + 2 * (lane & 3);
    a_fragment(*reinterpret_cast<const float2*>(W + w_at<NQ>(g, c)),
               *reinterpret_cast<const float2*>(W + w_at<NQ>(g + 8, c)), ab, as);
  }
};

// A pair's 16 x 8J tile staged as two sub-tiles of 16 x 8H (H = J / 2, the
// halves pair_score gives), each swizzled as a staging tile: the A operand
// of accumulate in a cluster launch.
template <int H>
struct PairStagedRows {
  static constexpr int kUnroll = 1;
  const float* T0;  // n-tiles [0, H)
  const float* T1;  // n-tiles [H, 2H)
  __device__ __forceinline__ void fragment(int kg, int lane, uint32_t (&ab)[4],
                                           uint32_t (&as)[4]) const {
    const float* T = kg < H ? T0 : T1;
    const int g = lane >> 2, c = 8 * (kg < H ? kg : kg - H) + 2 * (lane & 3);
    a_fragment(*reinterpret_cast<const float2*>(T + w_at<8 * H>(g, c)),
               *reinterpret_cast<const float2*>(T + w_at<8 * H>(g + 8, c)), ab, as);
  }
};

// The same tile straight from a warp's C fragments (x[j]: rows g and
// g + 8, columns 8j + 2t and 8j + 2t + 1): with the permuted contraction
// index a C fragment's pairs are the A fragment's, so nothing is staged.
template <int J>
struct FragmentRows {
  static constexpr int kUnroll = J / 2;  // unrolled: the fragments are registers
  const float (&x)[J][4];
  __device__ __forceinline__ void fragment(int kg, int, uint32_t (&ab)[4],
                                           uint32_t (&as)[4]) const {
    a_fragment(make_float2(x[kg][0], x[kg][1]), make_float2(x[kg][2], x[kg][3]), ab, as);
  }
};

// acc (16 x NC, C fragments of NC / 8 tiles: columns c0.. of the output)
// += X B, X a warp's 16 x 8J tile (StagedRows or FragmentRows), B rows
// b_row0 .. b_row0 + 8J, columns c0 .. c0 + NC of a split streamed tile.
// The contraction index is permuted in each group of 8 (logical t, t + 4 =
// columns 2t, 2t + 1), so B is read at rows 2t and 2t + 1.
template <int DH, int NC, int J, typename Rows>
__device__ __forceinline__ void accumulate(float (&acc)[NC / 8][4], const Rows& X, const float* B,
                                           int b_row0, int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  // pair_at<DH>(r, c0 + 8 nt + g) for the rows r = b_row0 + 8 kk + 2t (+1):
  // r % 8 is 2t (2t + 1) whatever kk, so the address is a row's pointer, a
  // per-thread column offset that depends on nt's parity, and 16 nt
  const int hi = (g >> 1) ^ ((t & 1) << 1), flip = t >> 1;  // sigma(2t) = 2t
  const int col = 2 * c0 + 4 * hi + 2 * (g & 1);
  const float* row0 = B + (b_row0 + 2 * t) * 2 * DH;
  // sigma(2t) bit 2 is t / 2; sigma(2t + 1) flips it
  const float* even0 = row0 + col + 16 * flip;
  const float* odd0 = row0 + col - 16 * flip;
  const float* even1 = row0 + 2 * DH + col + 16 * (1 - flip);
  const float* odd1 = row0 + 2 * DH + col - 16 * (1 - flip);
#pragma unroll (Rows::kUnroll)
  for (int kk = 0; kk < J; kk += 2) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) X.fragment(kk + u, lane, ab[u], as[u]);
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int step = 16 * DH * (kk + u) + 16 * nt;  // 8 rows of 2 DH floats a group
        const uint2 p0 = *reinterpret_cast<const uint2*>((nt & 1 ? odd0 : even0) + step);
        const uint2 p1 = *reinterpret_cast<const uint2*>((nt & 1 ? odd1 : even1) + step);
        mma3(part, ab[u], as[u], p0.x, p1.x, p0.y, p1.y);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += part[e];
    }
  }
}

// rows row0 + g and row0 + g + 8, columns c0 .. c0 + NC, of a 16-row
// accumulator -> rows D floats apart from dst; rows at or past row_end are
// not stored
template <int NC>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[NC / 8][4], int row0,
                                           int c0, int row_end, int D, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= row_end) continue;
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt)
      *reinterpret_cast<float2*>(dst + (size_t)row * D + c0 + 8 * nt + 2 * t) =
          make_float2(acc[nt][2 * i], acc[nt][2 * i + 1]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int nt = 0; nt < N; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
}

// the diagonal of a 16 x 16 score tile (rows g and g + 8 of the warp) to
// every lane of each quad: the lane t = g / 2 holds both
__device__ __forceinline__ void diagonal(const float (&x)[2][4], int lane, float (&d)[2]) {
  const int g = lane >> 2, e = g & 1;
  const float lo = e ? x[0][1] : x[0][0], hi = e ? x[1][3] : x[1][2];
  d[0] = __shfl_sync(0xffffffffu, lo, (lane & ~3) | (g >> 1));
  d[1] = __shfl_sync(0xffffffffu, hi, (lane & ~3) | (g >> 1));
}

// the softmax weight of one element from its logit s and the row's lse:
// 1 / Tk on a packed row with no key, 0 where not visible or out of bounds
__device__ __forceinline__ float weight(float s, bool in_bounds, bool uniform, bool visible,
                                        float lse, float scale, float inv_t) {
  if (uniform) return in_bounds ? inv_t : 0.f;
  return visible ? expf(s * scale - lse) : 0.f;
}

// whether every (query, key) of queries [q0, q0 + nq) and keys [k0, k0 + nk)
// is in bounds and visible (no segment ids, no packed row without keys)
template <bool FLASH>
__device__ __forceinline__ bool block_unmasked(const AttnArgs& a, const KeyRange& keys, bool seg,
                                               int q0, int nq, int k0, int nk) {
  if (seg || keys.uniform || q0 + nq > a.Tq || k0 + nk > a.Tk) return false;
  if (a.causal) return k0 + nk - 1 <= q0;  // the last key against the first query
  return FLASH || k0 + nk <= keys.len;
}

// The dropout flags of a thread's fragment of a (query, key) tile of J
// 8-key tiles, bit 4 j + 2 i + e for (query row + 8 i, key col0 + 8 j +
// 2 (lane % 4) + e): tc::keep_bits_q for any even J (there J = 8).
template <int J>
__device__ __forceinline__ uint32_t keep_bits_q(uint32_t bh, int row, int col0, int lane,
                                                const AttnArgs& a) {
  const int half = lane & 1, g_off = (lane & 3) >> 1;
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int jp = 0; jp < J / 2; ++jp) {
      const int j_mine = 2 * jp + half, j_other = 2 * jp + 1 - half;
      const uint32_t b4 = tc::keep4(bh, row + 8 * i, col0 / 4 + 2 * j_mine + g_off, a);
      const uint32_t recv = __shfl_xor_sync(0xffffffffu, (b4 >> (2 - 2 * half)) & 3u, 1);
      bits |= ((b4 >> (2 * half)) & 3u) << (4 * j_mine + 2 * i);
      bits |= recv << (4 * j_other + 2 * i);
    }
  }
  return bits;
}

// The same for the transposed (key, query) tile of J 8-query tiles, bit
// 4 j + 2 i + e for (key key4 + (lane / 4) % 4 + 8 i, query q0 + 8 j +
// 2 (lane % 4) + e): tc::keep_bits_kv for any J (there J = 8).
template <int J>
__device__ __forceinline__ uint32_t keep_bits_kv(uint32_t bh, int q0, int key4, int lane,
                                                 const AttnArgs& a) {
  const int av = (lane >> 2) & 3, bv = lane & 3;
  uint32_t mine = 0;
#pragma unroll
  for (int j = 0; j < J; ++j)
    mine |= tc::keep4(bh, q0 + 8 * j + 2 * bv + (av & 1), key4 / 4 + 2 * (av >> 1), a) << (4 * j);
  uint32_t bits = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint32_t v = __shfl_sync(0xffffffffu, mine, (lane & 16) | (4 * s) | bv);
    bits |= ((v >> av) & 0x11111111u) << s;
  }
  return bits;
}

// a CTA's (tile, batch * H + head): causal grids take the heaviest tiles
// first (the dQ kernel's last query tiles, the dK/dV kernel's first key
// tiles), the others a head's tiles together
__device__ __forceinline__ void cta_tile(int idx, int n_tiles, int heads, bool causal,
                                         bool last_heaviest, int& tile, int& bh) {
  if (causal) {
    tile = idx / heads;
    bh = idx % heads;
    if (last_heaviest) tile = n_tiles - 1 - tile;
  } else {
    tile = idx % n_tiles;
    bh = idx / n_tiles;
  }
}

// floats of a CTA's owned tile, of a ring stage (two streamed tiles in
// pairs, 2 S DH floats each) and of a warp's staging tile (the dQ kernel's
// 16 x S, the dK/dV kernel's 16 x kPassQ; in a cluster launch a row group's
// two warps share one, so half that a warp: w_cols)
template <int DH>
__host__ __device__ constexpr int own_floats() {
  return owned_rows<DH>() * DH;
}
template <int DH, bool CL = false>
__host__ __device__ constexpr int stage_floats() {
  return 4 * stream_rows<DH, CL>() * DH;
}
template <bool CL>
__host__ __device__ constexpr int w_cols(int rows) {
  return CL ? rows / 2 : rows;
}
// bytes of a cluster launch's exchange area (its warps' ClusterSum) in a
// cluster of c CTAs (c = 0: the most of any size)
template <bool CL>
__host__ __device__ constexpr size_t cluster_bytes(int c) {
  return !CL ? 0
             : c > 0 ? tc::xch_bytes<kClusterFloats>(kWarps, c)
                     : tc::max_xch_bytes<kClusterFloats>(kWarps);
}
// the two owned tiles, the ring, its row data (three words a streamed row),
// a word a thread (its dropout flags of the tile, drawn before the barrier
// and read back after it, so that the Philox rounds are not scheduled among
// the products), then the warps' staging tiles, then (CL) the exchange area
// of a cluster of c CTAs (0: the most of any size)
template <int DH, bool CL = false>
__host__ __device__ constexpr size_t smem_bytes(int stage_cols, int c = 0) {
  return sizeof(float) * (2 * own_floats<DH>() + kStages * stage_floats<DH, CL>()) +
         sizeof(float) * 3 * kStages * stream_rows<DH, CL>() + sizeof(uint32_t) * kCtaThreads +
         sizeof(float) * (kWarps * 16 * stage_cols + xch_floats<DH, CL>()) + cluster_bytes<CL>(c);
}
template <int DH, bool CL = false>
__host__ __device__ constexpr bool bwd_fits() {
  // O lands in the second stage before the dQ kernel's loop; the forward's
  // Q lands in its pair tiles before it is split
  return smem_bytes<DH, CL>(w_cols<CL>(stream_rows<DH, CL>())) <= 232448 &&
         own_floats<DH>() <= stage_floats<DH, CL>();
}
static_assert(bwd_fits<64>() && bwd_fits<128>() && bwd_fits<tc::kSliceCols, true>(),
              "a CTA's shared memory");

// The weights of a warp's 16 x 8JN tile of queries qw + g (+ 8) and keys
// k0 + 8 jj + 2t (+ 1) in place, s from S to p (kvseg: the keys' segment
// ids from k0), through the mask unless `unmasked`.
template <bool FLASH, int JN>
__device__ __forceinline__ void q_weights(float (&s)[JN][4], bool unmasked, const AttnArgs& a,
                                          const KeyRange& keys, bool seg, const int (&qseg)[2],
                                          const int* kvseg, int qw, int k0,
                                          const float (&lse_r)[2], float inv_t, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if (unmasked) {
#pragma unroll
    for (int jj = 0; jj < JN; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] = expf(s[jj][e] * a.scale - lse_r[e >> 1]);
  } else {
#pragma unroll
    for (int jj = 0; jj < JN; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = 8 * jj + 2 * t + (e & 1);
        const int row = qw + g + 8 * i, col = k0 + c;
        const bool in_bounds = row < a.Tq && col < a.Tk;
        const bool visible = in_bounds && is_visible<FLASH>(a, keys, row, col) &&
                             (!seg || qseg[i] == kvseg[c]);
        s[jj][e] = weight(s[jj][e], in_bounds, keys.uniform, visible, lse_r[i], a.scale, inv_t);
      }
  }
}

// The same for a transposed tile: rows the keys kw + g (+ 8), columns the
// queries q0 + qs + 8 jj + 2t (+ 1); lse_t and qseg indexed from q0.
template <bool FLASH, int JN>
__device__ __forceinline__ void kv_weights(float (&s)[JN][4], bool unmasked, const AttnArgs& a,
                                           const KeyRange& keys, bool seg, const int (&kvseg)[2],
                                           const int* qseg, const float* lse_t, int q0, int qs,
                                           int kw, float inv_t, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if (unmasked) {
#pragma unroll
    for (int jj = 0; jj < JN; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[jj][e] = expf(s[jj][e] * a.scale - lse_t[qs + 8 * jj + 2 * t + (e & 1)]);
  } else {
#pragma unroll
    for (int jj = 0; jj < JN; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i2 = e >> 1, qc = qs + 8 * jj + 2 * t + (e & 1);
        const int row = q0 + qc, key = kw + g + 8 * i2;
        const bool in_bounds = row < a.Tq && key < a.Tk;
        const bool visible = in_bounds && is_visible<FLASH>(a, keys, row, key) &&
                             (!seg || qseg[qc] == kvseg[i2]);
        s[jj][e] = weight(s[jj][e], in_bounds, keys.uniform, visible, lse_t[qc], a.scale, inv_t);
      }
  }
}

// -- the dQ kernel ------------------------------------------------------------

// CL (K4 past Dh 256, DH = 128): a cluster launch, the CTA's 128 columns
// from 128 * its rank; S, dPd and the deltas summed across the cluster by
// each row group's pair (pair_score), the pair's halves of dS meeting in
// its staging tile
template <int DH, bool FLASH, bool DROPOUT, bool CL = false>
__global__ void __launch_bounds__(kCtaThreads, 1)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta_out, float* __restrict__ dq, AttnArgs a, int B) {
  constexpr int R = owned_rows<DH>(), S = stream_rows<DH, CL>(), J = S / 8;
  constexpr int NC = DH / col_split<DH>();  // output columns a warp
  constexpr int TS = 2 * S * DH;            // floats of a split streamed tile
  constexpr int WQ = w_cols<CL>(S);         // staging columns a warp
  static_assert(!CL || (DH == tc::kSliceCols && J % 2 == 0 && FLASH && !DROPOUT),
                "a cluster launch: K4's 128-column slices");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // the CTA's query rows
  float* dOs = Qs + own_floats<DH>();
  float* ring = dOs + own_floats<DH>();  // per stage: K, then V, each in pairs
  int* kvseg_s = reinterpret_cast<int*>(ring + kStages * stage_floats<DH, CL>());  // kStages x S
  uint32_t* keep_words = reinterpret_cast<uint32_t*>(kvseg_s + 3 * kStages * S);
  volatile uint32_t* keep_s = keep_words;
  float* Ws = reinterpret_cast<float*>(keep_words + kCtaThreads);  // 16 x WQ a warp
  float* xch = Ws + kWarps * 16 * WQ;  // CL: the partial scores (pair_score)
  uint8_t* cxch = reinterpret_cast<uint8_t*>(xch + xch_floats<DH, CL>());  // CL: ClusterSum's
  float* Os = ring + stage_floats<DH, CL>();  // O in the second stage, until the loop loads it

  const int csize = CL ? tc::cluster_size() : 1;
  const int col0 = CL ? tc::kSliceCols * tc::cluster_rank() : 0;  // CL: the CTA's columns
  int qt, bhi;
  cta_tile((int)blockIdx.x / csize, (a.Tq + R - 1) / R, a.H * B, a.causal, true, qt, bhi);
  const int h = bhi % a.H, b = bhi / a.H;
  const int q0 = qt * R;
  const uint32_t bh = (uint32_t)bhi;
  // CL: the CTA's columns of rows a.dh floats apart
  const int D = CL ? a.dh : row_stride<FLASH, DH>(a.H);
  const int cols = CL ? a.dh - col0 : DH;
  const size_t q_base =
      CL ? (size_t)bhi * a.Tq * a.dh + col0 : head_offset<FLASH, DH>(b, h, a.H, a.Tq);
  const size_t kv_base =
      CL ? (size_t)bhi * a.Tk * a.dh + col0 : kv_offset<FLASH, DH>(q_base, b, h, a);
  const bool seg = FLASH && a.q_seg != nullptr;
  // every key tile a row of the CTA visits (its last rows see the most)
  const KeyRange keys = key_range<FLASH>(a, b, q0 + R - kBQ);
  const int n_tiles = (keys.kv_end + S - 1) / S;
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * (warp % (R / 16));  // the warp's first row in the tile
  const int c0 = (warp / (R / 16)) * NC;  // its first output column
  const int rgroup = warp % (R / 16), part = warp / (R / 16);  // CL: pair_score's row group
  const int qw = q0 + wr;                 // its first query
  // its staging tile (CL: its pair's, also the pair's dPd slots) and its
  // pair's S slots
  float* W = CL ? Ws + rgroup * 16 * S : Ws + warp * 16 * S;
  float* xch_s = xch + rgroup * 16 * S;
  const float inv_t = 1.f / (float)a.Tk;
  if constexpr (CL) {
    if (threadIdx.x == 0) tc::xch_init<kClusterFloats>(cxch, kWarps, csize);
    tc::cluster_sync();  // every CTA's barriers exist before a peer arrives
  }
  tc::ClusterSum<kClusterFloats> cluster(cxch, kWarps, CL ? warp : 0);

  auto issue = [&](int j) {  // f32 rows into each tile's second half
    float* st = ring + (j % kStages) * stage_floats<DH, CL>();
    load_tile_async<DH, false>(st + S * DH, k + kv_base, j * S, S, a.Tk, D, cols);
    load_tile_async<DH, false>(st + TS + S * DH, v + kv_base, j * S, S, a.Tk, D, cols);
    if (seg)
      load_vec_async(kvseg_s + (j % kStages) * S, a.kv_seg + (size_t)b * a.Tk, j * S, S, a.Tk);
  };
  load_tile_async<DH, true>(Qs, q + q_base, q0, R, a.Tq, D, cols);
  load_tile_async<DH, true>(dOs, dout + q_base, q0, R, a.Tq, D, cols);
  load_tile_async<DH, true>(Os, o + q_base, q0, R, a.Tq, D, cols);
  if (n_tiles > 0) issue(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (DROPOUT) {  // O / (1/keep): the kept weights' sum before the forward's 1/keep
    for (int idx = threadIdx.x; idx < own_floats<DH>(); idx += kCtaThreads) Os[idx] /= a.inv_keep;
    __syncthreads();
  }
  // each row's delta as the products take dPd: dO O^T here (dO V^T), and
  // O dO^T for the dK/dV kernel (V dO^T), each the diagonal of a 16 x 16
  // tile of the warp's rows
  float delta[2];
  {
    float x[2][4], d_kv[2];
    if constexpr (CL) {
      float hx[1][4];
      pair_score<DH, 2, false>(hx, OwnedRows<DH>{dOs, wr}, Os, wr, lane, xch_s, rgroup, part,
                               cluster);
      pair_share<2>(x, hx, xch_s, rgroup, part, lane);
      diagonal(x, lane, delta);
      pair_score<DH, 2, false>(hx, OwnedRows<DH>{Os, wr}, dOs, wr, lane, W, rgroup, part, cluster);
      pair_share<2>(x, hx, W, rgroup, part, lane);
    } else {
      score<DH, 2, false>(x, OwnedRows<DH>{dOs, wr}, Os, wr, lane);
      diagonal(x, lane, delta);
      score<DH, 2, false>(x, OwnedRows<DH>{Os, wr}, dOs, wr, lane);
    }
    diagonal(x, lane, d_kv);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = qw + g + 8 * i;
      delta[i] *= a.inv_keep;
      if (c0 == 0 && col0 == 0 && t == 0 && row < a.Tq)
        delta_out[(size_t)bh * a.Tq + row] = d_kv[i] * a.inv_keep;
    }
  }
  // the warp's rows g and g + 8: lse and segment ids
  float lse_r[2];
  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + g + 8 * i;
    lse_r[i] = row < a.Tq ? lse[(size_t)bh * a.Tq + row] : 0.f;
    qseg[i] = (seg && row < a.Tq) ? a.q_seg[(size_t)b * a.Tq + row] : 1;
  }
  __syncthreads();  // every warp is done with O before the loop loads the second stage

  float acc[NC / 8][4];
  zero(acc);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * S;
    float* st = ring + (j % kStages) * stage_floats<DH, CL>();
    if (j + 1 < n_tiles) issue(j + 1);
    cp_async_commit();
    if (DROPOUT) keep_s[threadIdx.x] = keep_bits_q<J>(bh, qw + g, k0, lane, a);
    cp_async_wait<1>();
    ring_sync();
    split_stage<DH, CL>(st);
    ring_sync();
    const float *Kp = st, *Vp = st + TS;
    const int* kvseg = kvseg_s + (j % kStages) * S;
    // a warp whose rows are all before the tile's first key (causal), or past
    // the end, has nothing in it
    if (qw < a.Tq && !(a.causal && k0 > qw + 15)) {
      const bool unmasked = block_unmasked<FLASH>(a, keys, seg, qw, 16, k0, S);
      if constexpr (CL) {
        // the warp's half of the tile: keys k0 + kh ..
        constexpr int H = J / 2;
        const int kh = 8 * H * part;
        float s[H][4], dp[H][4];
        pair_score<DH, J>(s, OwnedRows<DH>{Qs, wr}, Kp, 0, lane, xch_s, rgroup, part, cluster);
        q_weights<FLASH, H>(s, unmasked, a, keys, seg, qseg, kvseg + kh, qw, k0 + kh, lse_r,
                            inv_t, lane);
        pair_score<DH, J>(dp, OwnedRows<DH>{dOs, wr}, Vp, 0, lane, W, rgroup, part, cluster);
#pragma unroll
        for (int jj = 0; jj < H; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[jj][e] = tc::grad_ds<false>(s[jj][e], dp[jj][e], delta[e >> 1], true, a);
        // dS * scale: the half into the dPd slot this warp read (the other
        // warp reads the other), then the pair's tile
        __syncwarp();
        stage_tile<8 * H, H>(W + 128 * H * (1 - part), dp, lane);
        row_group_sync(rgroup, 2);
        accumulate<DH, NC, J>(acc, PairStagedRows<H>{W + 128 * H, W}, Kp, 0, c0, lane);
      } else {
        float s[J][4], dp[J][4];
        score<DH, J>(s, OwnedRows<DH>{Qs, wr}, Kp, 0, lane);
        const uint32_t keep = DROPOUT ? keep_s[threadIdx.x] : 0u;
        q_weights<FLASH, J>(s, unmasked, a, keys, seg, qseg, kvseg, qw, k0, lse_r, inv_t, lane);
        score<DH, J>(dp, OwnedRows<DH>{dOs, wr}, Vp, 0, lane);
#pragma unroll
        for (int jj = 0; jj < J; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[jj][e] = tc::grad_ds<DROPOUT>(s[jj][e], dp[jj][e], delta[e >> 1],
                                             (keep >> (4 * jj + e)) & 1u, a);
        stage_tile<S>(W, dp, lane);  // dS * scale
        __syncwarp();
        accumulate<DH, NC, J>(acc, StagedRows<S>{W}, Kp, 0, c0, lane);
        __syncwarp();
      }
    }
    ring_sync();  // every warp is done with this stage before it is loaded again
  }
  if (!CL || c0 < cols) store_rows<NC>(dq + q_base, acc, qw, c0, a.Tq, D, lane);
  if constexpr (CL) tc::cluster_sync();  // no CTA leaves while a peer reads its slots
}

// -- the dK/dV kernel ---------------------------------------------------------

// CL (K4 past Dh 256, DH = 128): a cluster launch, the CTA's 128 columns
// from 128 * its rank; S^T and dPd^T summed across the cluster by each row
// group's pair (pair_score), the pair's halves of Pd and dS meeting in its
// S slots and its staging tile
template <int DH, bool FLASH, bool DROPOUT, bool CL = false>
__global__ void __launch_bounds__(kCtaThreads, 1)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, AttnArgs a, int B) {
  constexpr int R = owned_rows<DH>(), S = stream_rows<DH, CL>();
  constexpr int NC = DH / col_split<DH>();  // output columns a warp
  constexpr int TS = 2 * S * DH;            // floats of a split streamed tile
  constexpr int kPassQ = pass_rows<DH, CL>(), kPassJ = kPassQ / 8;
  constexpr int WQ = w_cols<CL>(kPassQ);  // staging columns a warp
  static_assert(!CL || (DH == tc::kSliceCols && kPassQ == S && kPassJ % 2 == 0 && FLASH &&
                        !DROPOUT),
                "a cluster launch: K4's 128-column slices, a tile in one pass");
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // the CTA's keys
  float* Vs = Ks + own_floats<DH>();
  float* ring = Vs + own_floats<DH>();  // per stage: Q, then dO, each in pairs
  float* lse_s = ring + kStages * stage_floats<DH, CL>();  // kStages x S each
  float* delta_s = lse_s + kStages * S;
  int* qseg_s = reinterpret_cast<int*>(delta_s + kStages * S);
  uint32_t* keep_words = reinterpret_cast<uint32_t*>(qseg_s + kStages * S);
  volatile uint32_t* keep_s = keep_words;
  float* Ws = reinterpret_cast<float*>(keep_words + kCtaThreads);  // 16 x WQ a warp
  float* xch = Ws + kWarps * 16 * WQ;  // CL: the partial scores (pair_score)
  uint8_t* cxch = reinterpret_cast<uint8_t*>(xch + xch_floats<DH, CL>());  // CL: ClusterSum's

  const int csize = CL ? tc::cluster_size() : 1;
  const int col0 = CL ? tc::kSliceCols * tc::cluster_rank() : 0;  // CL: the CTA's columns
  int kt, bhi;
  cta_tile((int)blockIdx.x / csize, (a.Tk + R - 1) / R, a.H * B, a.causal, false, kt, bhi);
  const int h = bhi % a.H, b = bhi / a.H;
  const int k0 = kt * R;
  const uint32_t bh = (uint32_t)bhi;
  // CL: the CTA's columns of rows a.dh floats apart
  const int D = CL ? a.dh : row_stride<FLASH, DH>(a.H);
  const int cols = CL ? a.dh - col0 : DH;
  const size_t q_base =
      CL ? (size_t)bhi * a.Tq * a.dh + col0 : head_offset<FLASH, DH>(b, h, a.H, a.Tq);
  const size_t kv_base =
      CL ? (size_t)bhi * a.Tk * a.dh + col0 : kv_offset<FLASH, DH>(q_base, b, h, a);
  const bool seg = FLASH && a.q_seg != nullptr;
  // the key lengths do not depend on the query tile; the causal start does
  const KeyRange keys = key_range<FLASH>(a, b, 0);
  // a key at or past kv_lengths[b] > 0 gets zero gradient
  const bool any_key = keys.uniform || k0 < keys.len;
  const int q_begin = a.causal ? k0 : 0;  // earlier queries see none of these keys
  const int n_tiles = (any_key && q_begin < a.Tq) ? (a.Tq - q_begin + S - 1) / S : 0;
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * (warp % (R / 16));  // the warp's first key in the tile
  const int c0 = (warp / (R / 16)) * NC;  // its first output column
  const int rgroup = warp % (R / 16), part = warp / (R / 16);  // CL: pair_score's row group
  const int kw = k0 + wr;                 // its first key
  const bool my_keys = kw < a.Tk && (keys.uniform || kw < keys.len);
  // its staging tile (CL: its pair's, also the pair's dPd^T slots) and its
  // pair's S^T slots
  float* W = CL ? Ws + rgroup * 16 * kPassQ : Ws + warp * 16 * kPassQ;
  float* xch_s = xch + rgroup * 16 * kPassQ;
  const float inv_t = 1.f / (float)a.Tk;
  int kvseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kw + g + 8 * i;
    kvseg[i] = (seg && key < a.Tk) ? a.kv_seg[(size_t)b * a.Tk + key] : 1;
  }
  if constexpr (CL) {
    if (threadIdx.x == 0) tc::xch_init<kClusterFloats>(cxch, kWarps, csize);
    tc::cluster_sync();  // every CTA's barriers exist before a peer arrives
  }
  tc::ClusterSum<kClusterFloats> cluster(cxch, kWarps, CL ? warp : 0);

  auto issue = [&](int i) {  // f32 rows into each tile's second half
    const int stage = i % kStages, q0 = q_begin + i * S;
    float* st = ring + stage * stage_floats<DH, CL>();
    load_tile_async<DH, false>(st + S * DH, q + q_base, q0, S, a.Tq, D, cols);
    load_tile_async<DH, false>(st + TS + S * DH, dout + q_base, q0, S, a.Tq, D, cols);
    load_vec_async(lse_s + stage * S, lse + (size_t)bh * a.Tq, q0, S, a.Tq);
    load_vec_async(delta_s + stage * S, delta + (size_t)bh * a.Tq, q0, S, a.Tq);
    if (seg) load_vec_async(qseg_s + stage * S, a.q_seg + (size_t)b * a.Tq, q0, S, a.Tq);
  };

  float acc_dk[NC / 8][4], acc_dv[NC / 8][4];
  zero(acc_dk);
  zero(acc_dv);
  if (n_tiles > 0) {
    load_tile_async<DH, true>(Ks, k + kv_base, k0, R, a.Tk, D, cols);
    load_tile_async<DH, true>(Vs, v + kv_base, k0, R, a.Tk, D, cols);
    issue(0);
  }
  cp_async_commit();
  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = q_begin + i * S, stage = i % kStages;
    float* st = ring + stage * stage_floats<DH, CL>();
    if (i + 1 < n_tiles) issue(i + 1);
    cp_async_commit();
    if (DROPOUT) keep_s[threadIdx.x] = keep_bits_kv<S / 8>(bh, q0, kw + (g & ~3), lane, a);
    cp_async_wait<1>();
    ring_sync();
    split_stage<DH, CL>(st);
    ring_sync();
    const float *Qp = st, *dOp = st + TS;
    const float* lse_t = lse_s + stage * S;
    const float* delta_t = delta_s + stage * S;
    const int* qseg = qseg_s + stage * S;
    const uint32_t keep = DROPOUT ? keep_s[threadIdx.x] : 0u;  // bit 4 j + 2 i + e

#pragma unroll 1
    for (int pass = 0; pass < S / kPassQ; ++pass) {
      const int qs = pass * kPassQ;  // the pass's first query in the tile
      // a pass whose queries all come before the warp's first key (causal)
      // sees none of its keys
      if (!my_keys || (a.causal && q0 + qs + kPassQ - 1 < kw)) continue;
      const bool unmasked = block_unmasked<FLASH>(a, keys, seg, q0 + qs, kPassQ, kw, 16);
      if constexpr (CL) {
        // the warp's half of the transposed tiles: queries qh ..
        constexpr int H = kPassJ / 2;
        const int qh = qs + 8 * H * part;
        float s[H][4], dp[H][4];
        pair_score<DH, kPassJ>(s, OwnedRows<DH>{Ks, wr}, Qp, qs, lane, xch_s, rgroup, part,
                               cluster);
        kv_weights<FLASH, H>(s, unmasked, a, keys, seg, kvseg, qseg, lse_t, q0, qh, kw, inv_t,
                             lane);
        pair_score<DH, kPassJ>(dp, OwnedRows<DH>{Vs, wr}, dOp, qs, lane, W, rgroup, part,
                               cluster);
#pragma unroll
        for (int jj = 0; jj < H; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[jj][e] = tc::grad_ds<false>(s[jj][e], dp[jj][e],
                                           delta_t[qh + 8 * jj + 2 * t + (e & 1)], true, a);
        // the halves of Pd into the S^T slots (both read before the dPd^T
        // barrier), of dS * scale into the dPd^T slot this warp read; then
        // the pair's tiles
        stage_tile<8 * H, H>(xch_s + 128 * H * part, s, lane);
        __syncwarp();
        stage_tile<8 * H, H>(W + 128 * H * (1 - part), dp, lane);
        row_group_sync(rgroup, 2);
        accumulate<DH, NC, kPassJ>(acc_dv, PairStagedRows<H>{xch_s, xch_s + 128 * H}, dOp, qs,
                                   c0, lane);
        accumulate<DH, NC, kPassJ>(acc_dk, PairStagedRows<H>{W + 128 * H, W}, Qp, qs, c0, lane);
        continue;
      }
      const uint32_t kp = keep >> (pass * kPassQ / 2);  // the pass's flags, from bit 0
      // transposed tiles: rows the warp's keys, columns the pass's queries
      float s[kPassJ][4], dp[kPassJ][4];
      score<DH, kPassJ>(s, OwnedRows<DH>{Ks, wr}, Qp, qs, lane);
      kv_weights<FLASH, kPassJ>(s, unmasked, a, keys, seg, kvseg, qseg, lse_t, q0, qs, kw, inv_t,
                                lane);
      // dV += Pd^T dO, Pd the weights through the dropout flags
      if (DROPOUT) {
        float pd[kPassJ][4];
#pragma unroll
        for (int jj = 0; jj < kPassJ; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pd[jj][e] = ((kp >> (4 * jj + e)) & 1u) ? s[jj][e] * a.inv_keep : 0.f;
        stage_tile<kPassQ>(W, pd, lane);
      } else {
        stage_tile<kPassQ>(W, s, lane);
      }
      __syncwarp();
      accumulate<DH, NC, kPassJ>(acc_dv, StagedRows<kPassQ>{W}, dOp, qs, c0, lane);
      score<DH, kPassJ>(dp, OwnedRows<DH>{Vs, wr}, dOp, qs, lane);
#pragma unroll
      for (int jj = 0; jj < kPassJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[jj][e] = tc::grad_ds<DROPOUT>(s[jj][e], dp[jj][e],
                                           delta_t[qs + 8 * jj + 2 * t + (e & 1)],
                                           (kp >> (4 * jj + e)) & 1u, a);
      __syncwarp();  // every lane is done with Pd before dS takes its place
      stage_tile<kPassQ>(W, dp, lane);  // dS * scale
      __syncwarp();
      // dK += (dS * scale)^T Q
      accumulate<DH, NC, kPassJ>(acc_dk, StagedRows<kPassQ>{W}, Qp, qs, c0, lane);
      __syncwarp();
    }
    ring_sync();  // every warp is done with this stage before it is loaded again
  }
  if (!CL || c0 < cols) {
    store_rows<NC>(dk + kv_base, acc_dk, kw, c0, a.Tk, D, lane);
    store_rows<NC>(dv + kv_base, acc_dv, kw, c0, a.Tk, D, lane);
  }
  if constexpr (CL) tc::cluster_sync();  // no CTA leaves while a peer reads its slots
}

// -- the forward ----------------------------------------------------------------

// the forward's shared memory: the CTA's query rows in pairs, the split K
// and V tiles (one set), the ring of their f32 rows (K's, then V's, a
// stage), the ring's segment ids and a word a thread (its dropout flags);
// CL: then the exchange area of a cluster of c CTAs (0: the most of any size)
template <int DH, bool CL = false>
__host__ __device__ constexpr size_t fwd_smem_bytes(int c = 0) {
  return sizeof(float) * (2 * own_floats<DH>() + stage_floats<DH, CL>() +
                          kStages * 2 * stream_rows<DH, CL>() * DH) +
         sizeof(int) * kStages * stream_rows<DH, CL>() + sizeof(uint32_t) * kCtaThreads +
         sizeof(float) * xch_floats<DH, CL>() + cluster_bytes<CL>(c);
}
static_assert(fwd_smem_bytes<64>() <= 232448 && fwd_smem_bytes<128>() <= 232448 &&
                  fwd_smem_bytes<tc::kSliceCols, true>() <= 232448,
              "a CTA's shared memory");

// A CTA owns R query rows (owned_rows) and streams the key/value tiles its
// last row sees: each tile's f32 rows land by cp.async in the ring, the CTA
// splits them once into pairs, then each warp takes S for its 16 rows by
// score (so the bits of S, and of the lse, are the dQ kernel's), the online
// softmax in registers (a row's values sit in one quad: its max and sum take
// two shuffles), and O += P V.  Q is split once, into pairs read as a
// streamed tile's.  CL (K4 past Dh 256, DH = 128): a cluster launch, the
// CTA's 128 columns from 128 * its rank, S summed across the cluster as the
// dQ kernel sums it.
template <int DH, bool FLASH, bool DROPOUT, bool CL = false>
__global__ void __launch_bounds__(kCtaThreads, 1)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
           AttnArgs a, int B) {
  constexpr int R = owned_rows<DH>(), S = stream_rows<DH, CL>(), J = S / 8;
  constexpr int NC = DH / col_split<DH>();  // output columns a warp
  constexpr int TS = 2 * S * DH;            // floats of a split streamed tile
  // a key tile in steps of JS 8-key tiles: two at Dh 64 under dropout, whose
  // flags would otherwise take the registers the unrolled P V needs
  constexpr int STEPS = DH == 64 && DROPOUT ? 2 : 1, JS = J / STEPS;
  extern __shared__ float4 smem4[];
  float* Qp = reinterpret_cast<float*>(smem4);  // the CTA's query rows in pairs
  float* Kp = Qp + 2 * own_floats<DH>();        // this tile's keys, then values, in pairs
  float* Vp = Kp + TS;
  float* raw = Vp + TS;  // kStages x (S rows of K, S rows of V), f32
  int* kvseg_s = reinterpret_cast<int*>(raw + kStages * 2 * S * DH);  // kStages x S
  uint32_t* keep_words = reinterpret_cast<uint32_t*>(kvseg_s + kStages * S);
  volatile uint32_t* keep_s = keep_words;
  // CL: pair_score's partials
  float* xch = reinterpret_cast<float*>(keep_words + kCtaThreads);
  uint8_t* cxch = reinterpret_cast<uint8_t*>(xch + xch_floats<DH, CL>());  // CL: ClusterSum's
  static_assert(!CL || (DH == tc::kSliceCols && J % 2 == 0 && FLASH && !DROPOUT),
                "a cluster launch: K4's 128-column slices");

  const int csize = CL ? tc::cluster_size() : 1;
  const int col0 = CL ? tc::kSliceCols * tc::cluster_rank() : 0;  // CL: the CTA's columns
  int qt, bhi;
  cta_tile((int)blockIdx.x / csize, (a.Tq + R - 1) / R, a.H * B, a.causal, true, qt, bhi);
  const int h = bhi % a.H, b = bhi / a.H;
  const int q0 = qt * R;
  const uint32_t bh = (uint32_t)bhi;
  // CL: the CTA's columns of rows a.dh floats apart
  const int D = CL ? a.dh : row_stride<FLASH, DH>(a.H);
  const int cols = CL ? a.dh - col0 : DH;
  const size_t q_base =
      CL ? (size_t)bhi * a.Tq * a.dh + col0 : head_offset<FLASH, DH>(b, h, a.H, a.Tq);
  const size_t kv_base =
      CL ? (size_t)bhi * a.Tk * a.dh + col0 : kv_offset<FLASH, DH>(q_base, b, h, a);
  const bool seg = FLASH && a.q_seg != nullptr;
  // every key tile a row of the CTA visits (its last rows see the most)
  const KeyRange keys = key_range<FLASH>(a, b, q0 + R - kBQ);
  const int n_tiles = (keys.kv_end + S - 1) / S;
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * (warp % (R / 16));  // the warp's first row in the tile
  const int c0 = (warp / (R / 16)) * NC;  // its first output column
  const int rgroup = warp % (R / 16), part = warp / (R / 16);  // CL: pair_score's row group
  const int qw = q0 + wr;                 // its first query
  if constexpr (CL) {
    if (threadIdx.x == 0) tc::xch_init<kClusterFloats>(cxch, kWarps, csize);
    tc::cluster_sync();  // every CTA's barriers exist before a peer arrives
  }
  tc::ClusterSum<kClusterFloats> cluster(cxch, kWarps, CL ? warp : 0);

  auto issue = [&](int j) {  // K's and V's f32 rows into the ring
    float* st = raw + (j % kStages) * 2 * S * DH;
    load_tile_async<DH, false>(st, k + kv_base, j * S, S, a.Tk, D, cols);
    load_tile_async<DH, false>(st + S * DH, v + kv_base, j * S, S, a.Tk, D, cols);
    if (seg)
      load_vec_async(kvseg_s + (j % kStages) * S, a.kv_seg + (size_t)b * a.Tk, j * S, S, a.Tk);
  };
  load_tile_async<DH, false>(Kp, q + q_base, q0, R, a.Tq, D, cols);  // Q's f32 rows, split here
  issue(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_rows<DH, R, 1>(Kp, Qp);  // the loop's first barriers guard Kp and publish Qp
  const PairRows<DH> qa{Qp, wr};

  // the warp's rows g and g + 8: segment ids, running max and sum
  int qseg[2];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + g + 8 * i;
    qseg[i] = (seg && row < a.Tq) ? a.q_seg[(size_t)b * a.Tq + row] : 1;
  }

  float acc[NC / 8][4];
  zero(acc);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * S;
    if (DROPOUT) keep_s[threadIdx.x] = keep_bits_q<J>(bh, qw + g, k0, lane, a);
    cp_async_wait<0>();
    // tile j has landed, and every warp is done with the previous tile's pairs
    ring_sync();
    if (j + 1 < n_tiles) issue(j + 1);
    cp_async_commit();
    split_rows<DH, S, 2>(raw + (j % kStages) * 2 * S * DH, Kp);
    ring_sync();
    const int* kvseg = kvseg_s + (j % kStages) * S;
    // a warp whose rows are all before the tile's first key (causal), or past
    // the end, has nothing in it
    if (qw >= a.Tq || (a.causal && k0 > qw + 15)) continue;
    const uint32_t keep_tile = DROPOUT ? keep_s[threadIdx.x] : 0u;  // bit 4 jj + e
#pragma unroll
    for (int step = 0; step < STEPS; ++step) {
      const int kb = step * JS * 8;  // the step's first key in the tile
      const uint32_t keep = keep_tile >> (4 * JS * step);
      float s[JS][4];
      if constexpr (CL) {  // the pair's halves, summed across the cluster, then shared
        float hs[JS / 2][4];
        float* slots = xch + rgroup * 16 * S;
        pair_score<DH, JS>(hs, qa, Kp, kb, lane, slots, rgroup, part, cluster);
        pair_share<JS>(s, hs, slots, rgroup, part, lane);
      } else {
        score<DH, JS>(s, qa, Kp, kb, lane);
      }
      // the logits s * scale, through the mask unless every pair is visible:
      // packed, a masked logit is -1e9; flash, the mask value is added; a key
      // past Tk is no key at all
      if (block_unmasked<FLASH>(a, keys, seg, qw, 16, k0 + kb, 8 * JS)) {
#pragma unroll
        for (int jj = 0; jj < JS; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[jj][e] *= a.scale;
      } else {
#pragma unroll
        for (int jj = 0; jj < JS; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, c = kb + 8 * jj + 2 * t + (e & 1);
            const int row = qw + g + 8 * i, col = k0 + c;
            const bool visible =
                is_visible<FLASH>(a, keys, row, col) && (!seg || qseg[i] == kvseg[c]);
            const float x = s[jj][e] * a.scale;
            const float masked = FLASH ? x + kFlashMask : kMasked;
            s[jj][e] = col >= a.Tk ? -INFINITY : (visible ? x : masked);
          }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float tile_max = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < JS; ++jj)
          tile_max = fmaxf(tile_max, fmaxf(s[jj][2 * i], s[jj][2 * i + 1]));
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
        // a visited tile's first step holds key k0 < Tk, so m_new is finite
        const float m_new = fmaxf(m[i], tile_max);
        alpha[i] = expf(m[i] - m_new);
        float row_sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < JS; ++jj)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            const float p = expf(s[jj][e] - m_new);
            row_sum += p;
            // a dropped weight leaves P; the sum counts it (1/keep joins 1/l)
            s[jj][e] = (DROPOUT && !((keep >> (4 * jj + e)) & 1u)) ? 0.f : p;
          }
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
        l[i] = l[i] * alpha[i] + row_sum;
        m[i] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
      accumulate<DH, NC, JS>(acc, FragmentRows<JS>{s}, Vp, kb, c0, lane);
    }
  }

  // flash: a visible logit is far above half the mask value, and a row that
  // saw only masked keys has m at the mask value; a packed masked logit is
  // -1e9, so every packed row counts as visible
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool any_visible = !FLASH || m[i] > 0.5f * kFlashMask;
    inv[i] = any_visible ? (DROPOUT ? a.inv_keep : 1.f) / l[i] : 0.f;
    const int row = qw + g + 8 * i;
    if (lse != nullptr && c0 == 0 && col0 == 0 && t == 0 && row < a.Tq)
      lse[(size_t)bh * a.Tq + row] = any_visible ? m[i] + logf(l[i]) : INFINITY;
  }
#pragma unroll
  for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] *= inv[e >> 1];
  if (!CL || c0 < cols) store_rows<NC>(o + q_base, acc, qw, c0, a.Tq, D, lane);
  if constexpr (CL) tc::cluster_sync();  // no CTA leaves while a peer reads its slots
}

// -- launch -------------------------------------------------------------------

template <int DH, bool FLASH, bool DROPOUT>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       const AttnArgs& a, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<DH>();
  constexpr int R = owned_rows<DH>();
  static bool configured = false;
  const cudaError_t err = tc::allow_smem(fwd_kernel<DH, FLASH, DROPOUT>, smem, configured);
  if (err != cudaSuccess) return err;
  const long long ctas = (long long)((a.Tq + R - 1) / R) * a.H * B;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  fwd_kernel<DH, FLASH, DROPOUT><<<(unsigned)ctas, kCtaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, a, B);
  return cudaGetLastError();
}

// clusters of c CTAs of the forward's cluster kernel the card holds at once
// (a template, so that only a source that launches it compiles its kernel)
template <int DH = tc::kSliceCols>
cudaError_t fwd_split_fit(int c, int& fit) {
  static bool configured = false;
  static int fits[tc::kMaxClusterCtas + 1] = {};
  return tc::cluster_fit(fwd_kernel<DH, true, false, true>, kCtaThreads,
                         fwd_smem_bytes<DH, true>(), fwd_smem_bytes<DH, true>(c), c, configured,
                         fits, fit);
}

// K4's forward at a head dim dh past 256 (a multiple of 64 up to 2048): a
// cluster of tc::slice_ctas(dh) CTAs a tile of 64 query rows;
// cudaErrorInvalidConfiguration where the card holds no such cluster
template <int DH = tc::kSliceCols>
cudaError_t launch_fwd_split(const void* q, const void* k, const void* v, void* o, float* lse,
                             int B, int dh, const AttnArgs& args, cudaStream_t stream) {
  constexpr int R = owned_rows<DH>();
  const auto kernel = fwd_kernel<DH, true, false, true>;
  const int c = tc::slice_ctas(dh);
  const size_t smem = fwd_smem_bytes<DH, true>(c);
  AttnArgs a = args;
  a.dh = dh;
  int fit = 0;
  const cudaError_t err = fwd_split_fit<DH>(c, fit);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  const long long ctas = (long long)((a.Tq + R - 1) / R) * a.H * B * c;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  tc::ClusterLaunch launch(dim3((unsigned)ctas), kCtaThreads, smem, c, stream);
  return cudaLaunchKernelEx(&launch.cfg, kernel, static_cast<const float*>(q),
                            static_cast<const float*>(k), static_cast<const float*>(v),
                            static_cast<float*>(o), lse, a, B);
}

// the shared memory of the backward's cluster kernels in a cluster of c
// CTAs (0: the most of any size)
template <int DH = tc::kSliceCols>
__host__ __device__ constexpr size_t dq_split_smem(int c) {
  return smem_bytes<DH, true>(w_cols<true>(stream_rows<DH, true>()), c);
}
template <int DH = tc::kSliceCols>
__host__ __device__ constexpr size_t dkdv_split_smem(int c) {
  return smem_bytes<DH, true>(w_cols<true>(pass_rows<DH, true>()), c);
}

// clusters of c CTAs of the backward's dQ and dK/dV cluster kernels the card
// holds at once
template <int DH = tc::kSliceCols>
cudaError_t bwd_split_fit(int c, int& fit_dq, int& fit_dkdv) {
  static bool configured_dq = false, configured_dkdv = false;
  static int fits_dq[tc::kMaxClusterCtas + 1] = {}, fits_dkdv[tc::kMaxClusterCtas + 1] = {};
  fit_dkdv = 0;
  const cudaError_t err =
      tc::cluster_fit(bwd_dq_kernel<DH, true, false, true>, kCtaThreads, dq_split_smem<DH>(0),
                      dq_split_smem<DH>(c), c, configured_dq, fits_dq, fit_dq);
  if (err != cudaSuccess) return err;
  return tc::cluster_fit(bwd_dkdv_kernel<DH, true, false, true>, kCtaThreads,
                         dkdv_split_smem<DH>(0), dkdv_split_smem<DH>(c), c, configured_dkdv,
                         fits_dkdv, fit_dkdv);
}

// K4's backward at a head dim dh past 256: the dQ kernel, then the dK/dV
// kernel, each a cluster of tc::slice_ctas(dh) CTAs a tile of 64 rows;
// cudaErrorInvalidConfiguration where the card holds no cluster of either
template <int DH = tc::kSliceCols>
cudaError_t launch_bwd_split(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const float* lse, float* delta, void* dq, void* dk,
                             void* dv, int B, int dh, const AttnArgs& args, cudaStream_t stream) {
  constexpr int R = owned_rows<DH>();
  const auto dq_kernel = bwd_dq_kernel<DH, true, false, true>;
  const auto dkdv_kernel = bwd_dkdv_kernel<DH, true, false, true>;
  if (delta == nullptr) return cudaErrorInvalidValue;
  const int c = tc::slice_ctas(dh);
  AttnArgs a = args;
  a.dh = dh;
  int fit_dq = 0, fit_dkdv = 0;
  cudaError_t err = bwd_split_fit<DH>(c, fit_dq, fit_dkdv);
  if (err != cudaSuccess) return err;
  if (fit_dq < 1 || fit_dkdv < 1) return cudaErrorInvalidConfiguration;
  const long long heads = (long long)a.H * B;
  const long long ctas_dq = (long long)((a.Tq + R - 1) / R) * heads * c;
  const long long ctas_dkdv = (long long)((a.Tk + R - 1) / R) * heads * c;
  if (ctas_dq > 0x7fffffffLL || ctas_dkdv > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fdo = static_cast<const float*>(dout);
  tc::ClusterLaunch launch_dq(dim3((unsigned)ctas_dq), kCtaThreads, dq_split_smem<DH>(c), c,
                              stream);
  err = cudaLaunchKernelEx(&launch_dq.cfg, dq_kernel, fq, fk, fv, static_cast<const float*>(o),
                           fdo, lse, delta, static_cast<float*>(dq), a, B);
  if (err != cudaSuccess) return err;
  tc::ClusterLaunch launch_dkdv(dim3((unsigned)ctas_dkdv), kCtaThreads, dkdv_split_smem<DH>(c),
                                c, stream);
  return cudaLaunchKernelEx(&launch_dkdv.cfg, dkdv_kernel, fq, fk, fv, fdo, lse,
                            static_cast<const float*>(delta), static_cast<float*>(dk),
                            static_cast<float*>(dv), a, B);
}

// the dQ kernel, then the dK/dV kernel; `delta` (B, H, Tq) f32 carries each
// row's delta from the first to the second
template <int DH, bool FLASH, bool DROPOUT>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, const AttnArgs& a, cudaStream_t stream) {
  if (delta == nullptr) return cudaErrorInvalidValue;
  constexpr size_t smem_dq = smem_bytes<DH>(stream_rows<DH>());
  constexpr size_t smem_dkdv = smem_bytes<DH>(pass_rows<DH>());
  constexpr int R = owned_rows<DH>();
  static bool configured_dq = false, configured_dkdv = false;
  cudaError_t err = tc::allow_smem(bwd_dq_kernel<DH, FLASH, DROPOUT>, smem_dq, configured_dq);
  if (err == cudaSuccess)
    err = tc::allow_smem(bwd_dkdv_kernel<DH, FLASH, DROPOUT>, smem_dkdv, configured_dkdv);
  if (err != cudaSuccess) return err;
  const long long heads = (long long)a.H * B;
  const long long ctas_dq = (long long)((a.Tq + R - 1) / R) * heads;
  const long long ctas_dkdv = (long long)((a.Tk + R - 1) / R) * heads;
  if (ctas_dq > 0x7fffffffLL || ctas_dkdv > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fdo = static_cast<const float*>(dout);
  bwd_dq_kernel<DH, FLASH, DROPOUT><<<(unsigned)ctas_dq, kCtaThreads, smem_dq, stream>>>(
      fq, fk, fv, static_cast<const float*>(o), fdo, lse, delta, static_cast<float*>(dq), a, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<DH, FLASH, DROPOUT><<<(unsigned)ctas_dkdv, kCtaThreads, smem_dkdv, stream>>>(
      fq, fk, fv, fdo, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), a, B);
  return cudaGetLastError();
}

}  // namespace tf32
}  // namespace kokoro_attn
