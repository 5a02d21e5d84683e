// K4's f32 kernels at head dims 192 and 256 (sm_90a): the forward and the
// backward's dQ and dK/dV kernels with the flash mask policy and no dropout,
// in 3xTF32 on mma.sync under the numerics contract of attention_tf32.cuh
// (each operand split into a TF32 big and small part, three tensor-core
// products a product, every two groups of 8 products into a fresh
// accumulator joined by an f32 add), with one difference: small is the f32
// remainder x - big as the tensor cores truncate it (split_t), which makes
// the split of big + small give big and small back.  flash_attention.cu and
// flash_attention_bwd.cu launch them through attention_kernels.cuh (their
// notes name the TPU kernels they replace).
//
// Why not wgmma: it takes TF32 operands from shared memory K-major only (its
// transpose bits exist for 16-bit types), and the forward's A operand, Q's big
// and small for one 64-row warpgroup, is 2 x 64 x 256 x 4 = 128 KB at Dh 256,
// which leaves 99 KB of the 227 KB for a ring of K and V^T pairs (64 KB a
// 32-row stage of both): less than two stages, and nothing for the backward's
// owned tiles.  So the products stay on mma.sync, and the design works on
// what surrounds them.
//
// Structure (the attention_tf32.cuh kernels at Dh 64/128 split each streamed
// tile once, by the whole CTA, into pairs; at these head dims a CTA owns only
// 32 rows, so that split, its barriers and the pairs' doubled reads cost more
// than they save):
//   * a CTA is 8 warps and owns 32 rows (the forward's and the dQ kernel's
//     queries, the dK/dV kernel's keys); the four warps of each 16 rows (a
//     row group: warps 0-3 and 4-7, so each scheduler holds one warp of
//     each) split each score's contraction into quarters of Dh and each
//     product over the sequence by output columns (Dh / 4 each);
//   * streamed tiles of 32 rows (K and V, or Q and dO) arrive raw, in f32, by
//     cp.async through a ring of kFwdStages (forward) or bwd_stages<DH>()
//     stages with one CTA-wide barrier a tile (the wait for the tile is also
//     the release of the stage the next load takes), and each warp splits the
//     values it reads as it reads them: nothing splits a whole tile, and no
//     warp waits while another splits;
//   * the raw tiles are laid out by raw_at, whose swizzle serves both reading
//     patterns without a bank conflict: a score's B fragment (row g, columns
//     2t, 2t + 1: one 8-byte read) and a sequence product's (rows 2t and
//     2t + 1, column g: two 4-byte reads);
//   * the forward keeps its warp's quarter of Q in registers, split once (64
//     registers at Dh 256), and takes P straight from the score
//     accumulators; the backward's owned tiles stay f32 in shared memory and
//     are split at every use, its two score products in one loop (wscore2);
//     dS (and at Dh 192 the dK/dV kernel's P^T) straight from registers, the
//     dK/dV kernel's at Dh 256 staged in the warp's slot (its two
//     accumulators leave no registers for the unrolled product);
//   * the partials of a score meet in shared memory and are summed in the
//     warps' order (exchange): the forward's through two sets of slots, one
//     named barrier an exchange; the backward's S and dPd together, one
//     exchange of both a tile (two barriers: no second set fits beside the
//     owned tiles).
// Shared memory a CTA (Dh 256 / 192): forward 224.4 / 176.4 KB (three 64 /
// 48 KB stages, two 16 KB sets of slots); dQ and dK/dV 224.75 / 225.1 KB
// (the owned tiles 64 / 48 KB, two / three stages, 32 KB of slots).
//
// The invariants of attention_tf32.cuh hold: the forward and the dQ kernel
// take S by the same products in the same order and grouping (wscore or
// wscore2, then exchange), so the forward's lse gives the dQ kernel's
// weights back exactly (a row's one visible key gets weight 1); each row's
// delta is taken by the products of the kernel's dPd with the row of O in
// the place of a row of V, and a one-key row's O is its key's V row as
// split_t splits it, so such a row's dS is exactly 0; no atomics, each
// output element summed by one thread in a fixed order (two calls are
// bitwise equal); nothing reads torch.backends.cuda.matmul.allow_tf32.

#pragma once

#include "attention_tf32.cuh"

namespace kokoro_attn {
namespace tf32 {
namespace wide {

constexpr int kSplit = 4;                        // warps sharing each 16 rows
constexpr int kRows = 16 * kWarps / kSplit;      // rows a CTA owns: 32
constexpr int kStream = 32;                      // rows of a streamed tile
constexpr int kJ = kStream / 8;                  // 8-column n-tiles of a score tile
constexpr int kSlot = 2 * 16 * kStream;          // floats of a warp's slot: two 16 x 32 tiles
constexpr int kFwdStages = 3;

// output columns a warp (Dh / 4) and groups of 8 of a quarter's contraction
template <int DH>
__host__ __device__ constexpr int cols() {
  return DH / kSplit;
}
template <int DH>
__host__ __device__ constexpr int part_groups() {
  return DH / 8 / kSplit;
}
static_assert(part_groups<192>() % 2 == 0 && part_groups<256>() % 2 == 0,
              "a quarter's contraction in pairs of groups of 8");

// A raw streamed tile: float (r, c) of DH-float rows, the 8-float block c / 8
// at block (c / 8) ^ raw_swz(r % 8).  raw_swz takes each of {0..3}, {4..7},
// {0, 2, 4, 6} and {1, 3, 5, 7} onto 0..3, so the 8-byte reads of rows g
// (half a warp: g = 0..3 or 4..7) and the 4-byte reads of rows 2t or 2t + 1
// (a whole warp) each hit 32 distinct banks.
__device__ __forceinline__ int raw_swz(int r) {
  return (((r >> 1) & 1) << 1) | ((r ^ (r >> 2)) & 1);
}
template <int DH>
__device__ __forceinline__ int raw_at(int r, int c) {
  return r * DH + (c ^ (raw_swz(r) << 3));
}

// x = big + small: big = tf32(x) rounded to nearest, ties away (as
// attention_tf32.cuh's split), small the f32 bits of x - big, which the
// tensor cores read truncated to TF32 (their top 19 bits).  Unlike a rounded
// small, this split gives (big, small) back from big + small: a one-key row's
// O, which the forward's P V makes big(v) + small(v) of its key's row v,
// splits as v does, so that row's delta takes its dPd's very products (with
// small rounded too, about one value in 8,000 ties the next rounding and
// moves big by an ulp).  Truncation costs small at most one of its ulps, 2^-21
// of |x|: the products stay far inside f32's tolerances (PERF.md).
__device__ __forceinline__ void split_t(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// a streamed tile's value split as a warp reads it (KOKORO_TF32_SPLIT_OFF:
// its bits as big, no small: timing only)
__device__ __forceinline__ void split_b(float x, uint32_t& big, uint32_t& small) {
  if constexpr (kProbeSplitOff) {
    big = __float_as_uint(x);
    small = 0u;
  } else {
    split_t(x, big, small);
  }
}

// an A fragment from two f32 pairs (rows g and g + 8, columns 2t, 2t + 1 of
// a group of 8), split by split_t
__device__ __forceinline__ void a_fragment_t(float2 top, float2 bottom, uint32_t (&ab)[4],
                                             uint32_t (&as)[4]) {
  split_t(top.x, ab[0], as[0]);
  split_t(bottom.x, ab[1], as[1]);
  split_t(top.y, ab[2], as[2]);
  split_t(bottom.y, ab[3], as[3]);
}

// `rows` rows from row0 (rows DH floats apart) -> a raw tile; rows at or
// past row_end zero-filled
template <int DH>
__device__ __forceinline__ void load_raw_async(float* dst, const float* head, int row0, int rows,
                                               int row_end) {
  constexpr int CH = DH / 4;  // 16-byte chunks a row
#pragma unroll 4
  for (int idx = threadIdx.x; idx < rows * CH; idx += kCtaThreads) {
    const int r = idx / CH, c = 4 * (idx % CH);
    const bool in = row0 + r < row_end;
    cp_async16(dst + raw_at<DH>(r, c), head + (in ? (size_t)(row0 + r) * DH + c : 0), in ? 16 : 0);
  }
}

// -- the operands of a score ------------------------------------------------

// A: 16 rows of an owned f32 tile (own_at), split at every use; a loop
template <int DH>
struct OwnA {
  static constexpr int kUnroll = 1;
  const float* A;
  int row0;
  __device__ __forceinline__ void fragment(int, int kg, int lane, uint32_t (&ab)[4],
                                           uint32_t (&as)[4]) const {
    const int g = lane >> 2, c = 8 * kg + 2 * (lane & 3);
    a_fragment_t(*reinterpret_cast<const float2*>(A + own_at<DH>(row0 + g, c)),
                 *reinterpret_cast<const float2*>(A + own_at<DH>(row0 + g + 8, c)), ab, as);
  }
};

// A of a sequence product: a warp's 16 x 8J tile staged in W (w_at), or its
// C fragments (the permuted contraction index makes their pairs the A
// fragment's), split by split_t
template <int NQ>
struct StagedA {
  static constexpr int kUnroll = 1;
  const float* W;
  __device__ __forceinline__ void fragment(int kg, int lane, uint32_t (&ab)[4],
                                           uint32_t (&as)[4]) const {
    const int g = lane >> 2, c = 8 * kg + 2 * (lane & 3);
    a_fragment_t(*reinterpret_cast<const float2*>(W + w_at<NQ>(g, c)),
                 *reinterpret_cast<const float2*>(W + w_at<NQ>(g + 8, c)), ab, as);
  }
};
template <int J>
struct FragA {
  static constexpr int kUnroll = J / 2;
  const float (&x)[J][4];
  __device__ __forceinline__ void fragment(int kg, int, uint32_t (&ab)[4],
                                           uint32_t (&as)[4]) const {
    a_fragment_t(make_float2(x[kg][0], x[kg][1]), make_float2(x[kg][2], x[kg][3]), ab, as);
  }
};

// A: the same fragments split once into registers (the forward's Q: group i
// of the warp's quarter); unrolled, so that they stay registers
template <int KG>
struct RegA {
  static constexpr int kUnroll = KG / 2;
  const uint32_t (&b)[KG][4];
  const uint32_t (&s)[KG][4];
  __device__ __forceinline__ void fragment(int i, int, int, uint32_t (&ab)[4],
                                           uint32_t (&as)[4]) const {
#pragma unroll
    for (int r = 0; r < 4; ++r) ab[r] = b[i][r], as[r] = s[i][r];
  }
};

// B: columns c, c + 1 of row n of a raw streamed tile, or of an owned tile
template <int DH>
struct RawB {
  const float* p;
  __device__ __forceinline__ float2 pair(int n, int c) const {
    return *reinterpret_cast<const float2*>(p + raw_at<DH>(n, c));
  }
  __device__ __forceinline__ void split2(float2 v, uint32_t& bb0, uint32_t& bs0, uint32_t& bb1,
                                         uint32_t& bs1) const {
    split_b(v.x, bb0, bs0);
    split_b(v.y, bb1, bs1);
  }
};
template <int DH>
struct OwnB {
  const float* p;
  __device__ __forceinline__ float2 pair(int n, int c) const {
    return *reinterpret_cast<const float2*>(p + own_at<DH>(n, c));
  }
  __device__ __forceinline__ void split2(float2 v, uint32_t& bb0, uint32_t& bs0, uint32_t& bb1,
                                         uint32_t& bs1) const {
    split_t(v.x, bb0, bs0);
    split_t(v.y, bb1, bs1);
  }
};

// s (16 x 8J, C fragments) = this warp's partial of A B^T: the groups of 8
// [kg0, kg0 + part_groups) of the contraction, in pairs of groups, each pair
// into a fresh accumulator added to s (the products and adds of
// attention_tf32.cuh's score, element by element, whatever the operands'
// layout or J).  B rows b_row0 + 8j + g.
template <int DH, int J, typename Rows, typename Tile>
__device__ __forceinline__ void wscore(float (&s)[J][4], const Rows& A, const Tile& B, int b_row0,
                                       int lane, int kg0) {
  constexpr int KG = part_groups<DH>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < J; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll (Rows::kUnroll)
  for (int i = 0; i < KG; i += 2) {
    float part[J][4] = {};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int kg = kg0 + i + u, c = 8 * kg + 2 * t;
      uint32_t ab[4], as[4];
      A.fragment(i + u, kg, lane, ab, as);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        uint32_t bb0, bs0, bb1, bs1;
        B.split2(B.pair(b_row0 + 8 * j + g, c), bb0, bs0, bb1, bs1);
        mma3(part[j], ab, as, bb0, bb1, bs0, bs1);
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
  }
}

// wscore of two products at once (the backward's S and dPd, or its two
// delta products), their chains interleaved: each element the same products
// and adds as wscore's
template <int DH, int J, int UNROLL = 1, typename Rows0, typename Tile0, typename Rows1,
          typename Tile1>
__device__ __forceinline__ void wscore2(float (&x)[2][J][4], const Rows0& A0, const Tile0& B0,
                                        const Rows1& A1, const Tile1& B1, int b_row0, int lane,
                                        int kg0) {
  constexpr int KG = part_groups<DH>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < J; ++j) x[m][j][0] = x[m][j][1] = x[m][j][2] = x[m][j][3] = 0.f;
#pragma unroll (UNROLL)
  for (int i = 0; i < KG; i += 2) {
    float part[2][J][4] = {};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int kg = kg0 + i + u, c = 8 * kg + 2 * t;
      uint32_t ab[2][4], as[2][4];
      A0.fragment(i + u, kg, lane, ab[0], as[0]);
      A1.fragment(i + u, kg, lane, ab[1], as[1]);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        uint32_t bb0, bs0, bb1, bs1;
        B0.split2(B0.pair(b_row0 + 8 * j + g, c), bb0, bs0, bb1, bs1);
        mma3(part[0][j], ab[0], as[0], bb0, bb1, bs0, bs1);
        B1.split2(B1.pair(b_row0 + 8 * j + g, c), bb0, bs0, bb1, bs1);
        mma3(part[1][j], ab[1], as[1], bb0, bb1, bs0, bs1);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[m][j][e] += part[m][j][e];
  }
}

// NT partial tiles of a row group's four warps -> the whole tiles in each:
// each warp writes its partials to its slot (a lane's 4 floats of each
// n-tile together, lane-major), and after the
// group's barrier sums the group's four slots in the warps' order, so each
// element is ((p0 + p1) + p2) + p3 whichever kernel and warp takes it.
// `group_slots`: the group's four slots of SLOT floats.  FREE: a second
// barrier, after which the slots may be written again.
template <int NT, int J, bool FREE, int SLOT = kSlot>
__device__ __forceinline__ void exchange(float (&x)[NT][J][4], float* group_slots, int group,
                                         int part, int lane) {
  static_assert(NT * J * 4 * 32 <= SLOT, "a warp's slot");
  if constexpr (kProbeExchangeOff) return;
  float4* mine = reinterpret_cast<float4*>(group_slots + part * SLOT);
#pragma unroll
  for (int m = 0; m < NT; ++m)
#pragma unroll
    for (int j = 0; j < J; ++j)
      mine[(m * J + j) * 32 + lane] = make_float4(x[m][j][0], x[m][j][1], x[m][j][2], x[m][j][3]);
  row_group_sync(group, kSplit);
  const float4* all = reinterpret_cast<const float4*>(group_slots);
#pragma unroll
  for (int m = 0; m < NT; ++m)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int idx = (m * J + j) * 32 + lane;
      float4 sum = all[idx];
#pragma unroll
      for (int p = 1; p < kSplit; ++p) {
        const float4 y = all[p * (SLOT / 4) + idx];
        sum.x += y.x, sum.y += y.y, sum.z += y.z, sum.w += y.w;
      }
      x[m][j][0] = sum.x, x[m][j][1] = sum.y, x[m][j][2] = sum.z, x[m][j][3] = sum.w;
    }
  if constexpr (FREE) row_group_sync(group, kSplit);
}

// acc (16 x NC: columns c0.. of the output) += X B, X a warp's 16 x 8J tile
// (StagedA or FragA), B rows b_row0 .. b_row0 + 8J of a raw
// streamed tile, read at rows 2t and 2t + 1 (the permuted contraction index)
// and split as read.  b_row0 and c0 are multiples of 8.
template <int DH, int NC, int J, typename Rows>
__device__ __forceinline__ void accumulate_raw(float (&acc)[NC / 8][4], const Rows& X,
                                               const float* B, int b_row0, int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  // rows b_row0 + 8 kk + 2t (+ 1): raw_swz of 2t (2t + 1) whatever kk
  const int se = raw_swz(2 * t) << 3, so = raw_swz(2 * t + 1) << 3;
  const float* even = B + (b_row0 + 2 * t) * DH + g;
  const float* odd = even + DH;
#pragma unroll (Rows::kUnroll)
  for (int kk = 0; kk < J; kk += 2) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) X.fragment(kk + u, lane, ab[u], as[u]);
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt) {
      const int cb = c0 + 8 * nt;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int step = 8 * DH * (kk + u);  // 8 rows a group
        uint32_t bb0, bs0, bb1, bs1;
        split_b(even[step + (cb ^ se)], bb0, bs0);
        split_b(odd[step + (cb ^ so)], bb1, bs1);
        mma3(part, ab[u], as[u], bb0, bb1, bs0, bs1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += part[e];
    }
  }
}

// whether the dK/dV kernel stages P^T and dS^T in the warp's slot (its two
// accumulators leave no registers for the unrolled product at Dh 256) or
// takes them straight from its score accumulators
template <int DH>
constexpr bool kStaged = DH > 192;

// -- shared memory ------------------------------------------------------------

// floats of a raw stage (two streamed tiles) and of the owned tiles
template <int DH>
__host__ __device__ constexpr int raw_stage_floats() {
  return 2 * kStream * DH;
}
template <int DH>
__host__ __device__ constexpr int owned_floats() {
  return kRows * DH;
}
// the forward: the ring, its segment ids, two sets of the warps' slots
template <int DH>
__host__ __device__ constexpr size_t fwd_smem() {
  return sizeof(float) * (kFwdStages * raw_stage_floats<DH>() + 2 * kWarps * (kSlot / 2)) +
         sizeof(int) * kFwdStages * kStream;
}
// the backward: the two owned tiles, the ring, three words a streamed row
// (lse, delta, segment id; the dQ kernel uses one), the warps' slots
template <int DH, int ST>
__host__ __device__ constexpr size_t bwd_smem_at() {
  return sizeof(float) * (2 * owned_floats<DH>() + ST * raw_stage_floats<DH>() + kWarps * kSlot) +
         sizeof(float) * 3 * ST * kStream;
}
template <int DH>
__host__ __device__ constexpr int bwd_stages() {
  return bwd_smem_at<DH, 3>() <= 232448 ? 3 : 2;
}
template <int DH>
__host__ __device__ constexpr size_t bwd_smem() {
  return bwd_smem_at<DH, bwd_stages<DH>()>();
}
static_assert(fwd_smem<192>() <= 232448 && fwd_smem<256>() <= 232448 &&
                  bwd_smem<192>() <= 232448 && bwd_smem<256>() <= 232448,
              "a CTA's shared memory");
static_assert(owned_floats<256>() <= raw_stage_floats<256>(), "Q, O land in a stage");

// -- the forward ----------------------------------------------------------------

// A CTA owns 32 query rows and streams the key/value tiles its last row sees.
// Each warp keeps its quarter of its 16 rows of Q split in registers, takes
// its partial of S from the raw K tile (wscore), the row group's sum
// (exchange, the dQ kernel's products and order: the lse is exact), the
// online softmax in registers (a row's values sit in one quad: two shuffles),
// and O += P V on its Dh / 4 columns, P straight from the score accumulators.
template <int DH>
__global__ void __launch_bounds__(kCtaThreads, 1)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
           AttnArgs a, int B) {
  constexpr int R = kRows, S = kStream, J = kJ, NC = cols<DH>(), KG = part_groups<DH>();
  constexpr int ST = kFwdStages;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // per stage: K, then V, raw
  int* kvseg_s = reinterpret_cast<int*>(ring + ST * raw_stage_floats<DH>());  // ST x S
  float* xch = reinterpret_cast<float*>(kvseg_s + ST * S);  // two sets of 8 slots of kSlot / 2

  int qt, bhi;
  cta_tile((int)blockIdx.x, (a.Tq + R - 1) / R, a.H * B, a.causal, true, qt, bhi);
  const int h = bhi % a.H, b = bhi / a.H;
  const int q0 = qt * R;
  const uint32_t bh = (uint32_t)bhi;
  const size_t q_base = head_offset<true, DH>(b, h, a.H, a.Tq);
  const size_t kv_base = kv_offset<true, DH>(q_base, b, h, a);
  const bool seg = a.q_seg != nullptr;
  const KeyRange keys = key_range<true>(a, b, q0 + R - kBQ);  // kv_end: past the CTA's last row
  const int n_tiles = (keys.kv_end + S - 1) / S;
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rgroup = warp / kSplit, part = warp % kSplit;  // a scheduler: both groups
  const int wr = 16 * rgroup;  // the warp's first row in the tile
  const int c0 = part * NC;    // its first output column
  const int kg0 = part * KG;   // its quarter of the contraction
  const int qw = q0 + wr;      // its first query

  auto issue = [&](int j) {
    float* st = ring + (j % ST) * raw_stage_floats<DH>();
    load_raw_async<DH>(st, k + kv_base, j * S, S, a.Tk);
    load_raw_async<DH>(st + S * DH, v + kv_base, j * S, S, a.Tk);
    if (seg) load_vec_async(kvseg_s + (j % ST) * S, a.kv_seg + (size_t)b * a.Tk, j * S, S, a.Tk);
  };
  // Q's raw rows land in the last stage, which the loop loads first at j = 0
  float* Qraw = ring + (ST - 1) * raw_stage_floats<DH>();
  load_raw_async<DH>(Qraw, q + q_base, q0, R, a.Tq);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }
  cp_async_wait<ST - 1>();
  __syncthreads();
  uint32_t qb[KG][4], qs[KG][4];  // the warp's quarter of its rows of Q, split
#pragma unroll
  for (int i = 0; i < KG; ++i) {
    const int c = 8 * (kg0 + i) + 2 * t;
    a_fragment_t(*reinterpret_cast<const float2*>(Qraw + raw_at<DH>(wr + g, c)),
                 *reinterpret_cast<const float2*>(Qraw + raw_at<DH>(wr + g + 8, c)), qb[i],
                 qs[i]);
  }
  const RegA<KG> qa{qb, qs};

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
  int set = 0;  // the slots' set of the group's next exchange
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * S;
    cp_async_wait<ST - 2>();
    // tile j has landed, and every warp is done with tile j - 1's stage
    ring_sync();
    if (j + ST - 1 < n_tiles) issue(j + ST - 1);
    cp_async_commit();
    // a warp whose rows are all before the tile's first key, or past the
    // end, has nothing in it (nor has the rest of its row group)
    if (qw >= a.Tq || (a.causal && k0 > qw + 15)) continue;
    const float* Kt = ring + (j % ST) * raw_stage_floats<DH>();
    const float* Vt = Kt + S * DH;
    const int* kvseg = kvseg_s + (j % ST) * S;
    float s[1][J][4];
    wscore<DH, J>(s[0], qa, RawB<DH>{Kt}, 0, lane, kg0);
    exchange<1, J, false, kSlot / 2>(s, xch + (set * kWarps + rgroup * kSplit) * (kSlot / 2),
                                     rgroup, part, lane);
    set ^= 1;
    // the logits s * scale, through the mask unless every pair is visible: the
    // mask value is added; a key past Tk is no key at all
    if (block_unmasked<true>(a, keys, seg, qw, 16, k0, S)) {
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[0][jj][e] *= a.scale;
    } else {
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, c = 8 * jj + 2 * t + (e & 1);
          const int row = qw + g + 8 * i, col = k0 + c;
          const bool visible =
              is_visible<true>(a, keys, row, col) && (!seg || qseg[i] == kvseg[c]);
          const float x = s[0][jj][e] * a.scale;
          s[0][jj][e] = col >= a.Tk ? -INFINITY : (visible ? x : x + kFlashMask);
        }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
        tile_max = fmaxf(tile_max, fmaxf(s[0][jj][2 * i], s[0][jj][2 * i + 1]));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
      // a visited tile holds key k0 < Tk, so m_new is finite
      const float m_new = fmaxf(m[i], tile_max);
      alpha[i] = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          const float p = expf(s[0][jj][e] - m_new);
          row_sum += p;
          s[0][jj][e] = p;
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
    accumulate_raw<DH, NC, J>(acc, FragA<J>{s[0]}, Vt, 0, c0, lane);
  }

  // a visible logit is far above half the mask value, and a row that saw
  // only masked keys has m at the mask value
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool any_visible = m[i] > 0.5f * kFlashMask;
    inv[i] = any_visible ? 1.f / l[i] : 0.f;
    const int row = qw + g + 8 * i;
    if (lse != nullptr && c0 == 0 && t == 0 && row < a.Tq)
      lse[(size_t)bh * a.Tq + row] = any_visible ? m[i] + logf(l[i]) : INFINITY;
  }
#pragma unroll
  for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] *= inv[e >> 1];
  store_rows<NC>(o + q_base, acc, qw, c0, a.Tq, DH, lane);
}

// -- the dQ kernel ------------------------------------------------------------

// A CTA owns 32 query rows (Q, dO in f32) and streams the raw key/value
// tiles; a tile's S and dPd partials are exchanged together, then the
// weights, dS, and dQ += dS K on the warp's Dh / 4 columns, dS staged in the
// warp's own slot.  Each row's delta (dO O^T's diagonal, as dPd takes dO V^T)
// is taken first, and O dO^T's (the dK/dV kernel's V dO^T) written to
// delta_out.
template <int DH>
__global__ void __launch_bounds__(kCtaThreads, 1)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta_out, float* __restrict__ dq, AttnArgs a, int B) {
  constexpr int R = kRows, S = kStream, J = kJ, NC = cols<DH>(), KG = part_groups<DH>();
  constexpr int ST = bwd_stages<DH>();
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // the CTA's query rows (own_at)
  float* dOs = Qs + owned_floats<DH>();
  float* ring = dOs + owned_floats<DH>();  // per stage: K, then V, raw
  int* kvseg_s = reinterpret_cast<int*>(ring + ST * raw_stage_floats<DH>());  // ST x S
  float* xch = reinterpret_cast<float*>(kvseg_s + 3 * ST * S);  // 8 slots of kSlot
  float* Os = ring + (ST - 1) * raw_stage_floats<DH>();  // O, until the loop loads that stage

  int qt, bhi;
  cta_tile((int)blockIdx.x, (a.Tq + R - 1) / R, a.H * B, a.causal, true, qt, bhi);
  const int h = bhi % a.H, b = bhi / a.H;
  const int q0 = qt * R;
  const uint32_t bh = (uint32_t)bhi;
  const size_t q_base = head_offset<true, DH>(b, h, a.H, a.Tq);
  const size_t kv_base = kv_offset<true, DH>(q_base, b, h, a);
  const bool seg = a.q_seg != nullptr;
  const KeyRange keys = key_range<true>(a, b, q0 + R - kBQ);
  const int n_tiles = (keys.kv_end + S - 1) / S;
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rgroup = warp / kSplit, part = warp % kSplit;  // a scheduler: both groups
  const int wr = 16 * rgroup, c0 = part * NC, kg0 = part * KG, qw = q0 + wr;
  float* slots = xch + rgroup * kSplit * kSlot;  // the row group's
  const float inv_t = 1.f / (float)a.Tk;

  auto issue = [&](int j) {
    float* st = ring + (j % ST) * raw_stage_floats<DH>();
    load_raw_async<DH>(st, k + kv_base, j * S, S, a.Tk);
    load_raw_async<DH>(st + S * DH, v + kv_base, j * S, S, a.Tk);
    if (seg) load_vec_async(kvseg_s + (j % ST) * S, a.kv_seg + (size_t)b * a.Tk, j * S, S, a.Tk);
  };
  load_tile_async<DH, true>(Qs, q + q_base, q0, R, a.Tq, DH);
  load_tile_async<DH, true>(dOs, dout + q_base, q0, R, a.Tq, DH);
  load_tile_async<DH, true>(Os, o + q_base, q0, R, a.Tq, DH);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }
  cp_async_wait<ST - 1>();
  __syncthreads();
  // each row's delta by dPd's products: dO O^T here (dO V^T), O dO^T for the
  // dK/dV kernel (V dO^T), each the diagonal of a 16 x 16 tile of the
  // warp's rows
  float delta[2];
  {
    float x[2][2][4], d_kv[2];
    wscore2<DH, 2>(x, OwnA<DH>{dOs, wr}, OwnB<DH>{Os}, OwnA<DH>{Os, wr}, OwnB<DH>{dOs}, wr, lane,
                   kg0);
    exchange<2, 2, true>(x, slots, rgroup, part, lane);
    diagonal(x[0], lane, delta);
    diagonal(x[1], lane, d_kv);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = qw + g + 8 * i;
      if (c0 == 0 && t == 0 && row < a.Tq) delta_out[(size_t)bh * a.Tq + row] = d_kv[i];
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

  float acc[NC / 8][4];
  zero(acc);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * S;
    cp_async_wait<ST - 2>();
    // tile j has landed; every warp is done with tile j - 1's stage (and,
    // at j = 0, with O)
    ring_sync();
    if (j + ST - 1 < n_tiles) issue(j + ST - 1);
    cp_async_commit();
    if (qw >= a.Tq || (a.causal && k0 > qw + 15)) continue;
    const float* Kt = ring + (j % ST) * raw_stage_floats<DH>();
    const float* Vt = Kt + S * DH;
    const int* kvseg = kvseg_s + (j % ST) * S;
    const bool unmasked = block_unmasked<true>(a, keys, seg, qw, 16, k0, S);
    float sd[2][J][4];  // S, dPd
    wscore2<DH, J, 2>(sd, OwnA<DH>{Qs, wr}, RawB<DH>{Kt}, OwnA<DH>{dOs, wr}, RawB<DH>{Vt}, 0,
                      lane, kg0);
    exchange<2, J, true>(sd, slots, rgroup, part, lane);
    q_weights<true, J>(sd[0], unmasked, a, keys, seg, qseg, kvseg, qw, k0, lse_r, inv_t, lane);
#pragma unroll
    for (int jj = 0; jj < J; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sd[1][jj][e] = tc::grad_ds<false>(sd[0][jj][e], sd[1][jj][e], delta[e >> 1], true, a);
    accumulate_raw<DH, NC, J>(acc, FragA<J>{sd[1]}, Kt, 0, c0, lane);  // dS * scale
  }
  store_rows<NC>(dq + q_base, acc, qw, c0, a.Tq, DH, lane);
}

// -- the dK/dV kernel ---------------------------------------------------------

// A CTA owns 32 keys (K, V in f32) and streams the raw query/dO tiles from
// its first key (causal); a tile's S^T and dPd^T partials are exchanged
// together, then P^T (staged in the warp's slot) into dV += P^T dO, and
// dS^T into dK += dS^T Q, each on the warp's Dh / 4 columns.
template <int DH>
__global__ void __launch_bounds__(kCtaThreads, 1)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, AttnArgs a, int B) {
  constexpr int R = kRows, S = kStream, J = kJ, NC = cols<DH>(), KG = part_groups<DH>();
  constexpr int ST = bwd_stages<DH>();
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // the CTA's keys (own_at)
  float* Vs = Ks + owned_floats<DH>();
  float* ring = Vs + owned_floats<DH>();  // per stage: Q, then dO, raw
  float* lse_s = ring + ST * raw_stage_floats<DH>();  // ST x S each
  float* delta_s = lse_s + ST * S;
  int* qseg_s = reinterpret_cast<int*>(delta_s + ST * S);
  float* xch = reinterpret_cast<float*>(qseg_s + ST * S);  // 8 slots of kSlot

  int kt, bhi;
  cta_tile((int)blockIdx.x, (a.Tk + R - 1) / R, a.H * B, a.causal, false, kt, bhi);
  const int h = bhi % a.H, b = bhi / a.H;
  const int k0 = kt * R;
  const size_t q_base = head_offset<true, DH>(b, h, a.H, a.Tq);
  const size_t kv_base = kv_offset<true, DH>(q_base, b, h, a);
  const uint32_t bh = (uint32_t)bhi;
  const bool seg = a.q_seg != nullptr;
  const KeyRange keys = key_range<true>(a, b, 0);
  const int q_begin = a.causal ? k0 : 0;  // earlier queries see none of these keys
  const int n_tiles = q_begin < a.Tq ? (a.Tq - q_begin + S - 1) / S : 0;
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rgroup = warp / kSplit, part = warp % kSplit;  // a scheduler: both groups
  const int wr = 16 * rgroup, c0 = part * NC, kg0 = part * KG, kw = k0 + wr;
  const bool my_keys = kw < a.Tk;
  float* slots = xch + rgroup * kSplit * kSlot;
  float* W = slots + part * kSlot;  // this warp's slot, also its P / dS staging tile
  const float inv_t = 1.f / (float)a.Tk;
  int kvseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kw + g + 8 * i;
    kvseg[i] = (seg && key < a.Tk) ? a.kv_seg[(size_t)b * a.Tk + key] : 1;
  }

  auto issue = [&](int i) {
    const int stage = i % ST, q0 = q_begin + i * S;
    float* st = ring + stage * raw_stage_floats<DH>();
    load_raw_async<DH>(st, q + q_base, q0, S, a.Tq);
    load_raw_async<DH>(st + S * DH, dout + q_base, q0, S, a.Tq);
    load_vec_async(lse_s + stage * S, lse + (size_t)bh * a.Tq, q0, S, a.Tq);
    load_vec_async(delta_s + stage * S, delta + (size_t)bh * a.Tq, q0, S, a.Tq);
    if (seg) load_vec_async(qseg_s + stage * S, a.q_seg + (size_t)b * a.Tq, q0, S, a.Tq);
  };

  float acc_dk[NC / 8][4], acc_dv[NC / 8][4];
  zero(acc_dk);
  zero(acc_dv);
  if (n_tiles > 0) {
    load_tile_async<DH, true>(Ks, k + kv_base, k0, R, a.Tk, DH);
    load_tile_async<DH, true>(Vs, v + kv_base, k0, R, a.Tk, DH);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = q_begin + i * S, stage = i % ST;
    cp_async_wait<ST - 2>();
    // tile i (and K, V) has landed; every warp is done with tile i - 1's stage
    ring_sync();
    if (i + ST - 1 < n_tiles) issue(i + ST - 1);
    cp_async_commit();
    // a tile whose queries all come before the warp's first key sees none of
    // its keys
    if (!my_keys || (a.causal && q0 + S - 1 < kw)) continue;
    const float* Qt = ring + stage * raw_stage_floats<DH>();
    const float* dOt = Qt + S * DH;
    const float* lse_t = lse_s + stage * S;
    const float* delta_t = delta_s + stage * S;
    const int* qseg = qseg_s + stage * S;
    const bool unmasked = block_unmasked<true>(a, keys, seg, q0, S, kw, 16);
    // transposed tiles: rows the warp's keys, columns the tile's queries
    float sd[2][J][4];  // S^T, dPd^T
    wscore2<DH, J>(sd, OwnA<DH>{Ks, wr}, RawB<DH>{Qt}, OwnA<DH>{Vs, wr}, RawB<DH>{dOt}, 0, lane,
                   kg0);
    exchange<2, J, true>(sd, slots, rgroup, part, lane);
    kv_weights<true, J>(sd[0], unmasked, a, keys, seg, kvseg, qseg, lse_t, q0, 0, kw, inv_t,
                        lane);
    // dV += P^T dO
    if constexpr (kStaged<DH>) {
      stage_tile<S>(W, sd[0], lane);
      __syncwarp();
      accumulate_raw<DH, NC, J>(acc_dv, StagedA<S>{W}, dOt, 0, c0, lane);
    } else {
      accumulate_raw<DH, NC, J>(acc_dv, FragA<J>{sd[0]}, dOt, 0, c0, lane);
    }
#pragma unroll
    for (int jj = 0; jj < J; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sd[1][jj][e] = tc::grad_ds<false>(sd[0][jj][e], sd[1][jj][e],
                                          delta_t[8 * jj + 2 * t + (e & 1)], true, a);
    // dK += (dS * scale)^T Q
    if constexpr (kStaged<DH>) {
      __syncwarp();  // every lane is done with P before dS takes its place
      stage_tile<S>(W, sd[1], lane);
      __syncwarp();
      accumulate_raw<DH, NC, J>(acc_dk, StagedA<S>{W}, Qt, 0, c0, lane);
      __syncwarp();  // every lane is done with its slot before the next exchange writes it
    } else {
      accumulate_raw<DH, NC, J>(acc_dk, FragA<J>{sd[1]}, Qt, 0, c0, lane);
    }
  }
  store_rows<NC>(dk + kv_base, acc_dk, kw, c0, a.Tk, DH, lane);
  store_rows<NC>(dv + kv_base, acc_dv, kw, c0, a.Tk, DH, lane);
}

// -- launch -------------------------------------------------------------------

template <int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       const AttnArgs& a, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<DH>();
  static bool configured = false;
  const cudaError_t err = tc::allow_smem(fwd_kernel<DH>, smem, configured);
  if (err != cudaSuccess) return err;
  const long long ctas = (long long)((a.Tq + kRows - 1) / kRows) * a.H * B;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  fwd_kernel<DH><<<(unsigned)ctas, kCtaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, a, B);
  return cudaGetLastError();
}

// the dQ kernel, then the dK/dV kernel; `delta` (B, H, Tq) f32 carries each
// row's delta from the first to the second
template <int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, const AttnArgs& a, cudaStream_t stream) {
  if (delta == nullptr) return cudaErrorInvalidValue;
  constexpr size_t smem = bwd_smem<DH>();
  static bool configured_dq = false, configured_dkdv = false;
  cudaError_t err = tc::allow_smem(bwd_dq_kernel<DH>, smem, configured_dq);
  if (err == cudaSuccess) err = tc::allow_smem(bwd_dkdv_kernel<DH>, smem, configured_dkdv);
  if (err != cudaSuccess) return err;
  const long long heads = (long long)a.H * B;
  const long long ctas_dq = (long long)((a.Tq + kRows - 1) / kRows) * heads;
  const long long ctas_dkdv = (long long)((a.Tk + kRows - 1) / kRows) * heads;
  if (ctas_dq > 0x7fffffffLL || ctas_dkdv > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fdo = static_cast<const float*>(dout);
  bwd_dq_kernel<DH><<<(unsigned)ctas_dq, kCtaThreads, smem, stream>>>(
      fq, fk, fv, static_cast<const float*>(o), fdo, lse, delta, static_cast<float*>(dq), a, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<DH><<<(unsigned)ctas_dkdv, kCtaThreads, smem, stream>>>(
      fq, fk, fv, fdo, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), a, B);
  return cudaGetLastError();
}

}  // namespace wide
}  // namespace tf32
}  // namespace kokoro_attn
