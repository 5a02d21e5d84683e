// K4's bf16 kernels at head dims 192 and 256 (the flash policy, no dropout):
// the forward, dQ and dK/dV kernels, built from attention_tc.cuh's pieces
// (TMA boxes, wgmma products, the softmax, the weights) for these widths,
// where a 64-row tile is 24 or 32 KB and a CTA's own tiles and its ring of
// streamed ones fill its 227 KB of shared memory.  Each row takes the same
// products and sums, in the same order, as in attention_tc.cuh's Dh 64/128
// kernels.
//
// Bounded by their operations (4 Dh a visible pair forward, 10 Dh backward,
// at 989 TFLOP/s: 0.025 / 0.062 ms at B=12 T=1408 H=2 Dh=256) and, since a
// streamed 64-row tile serves 128 (forward, dQ) or 64 (dK/dV) rows, by how
// fast the streamed tiles come from L2.  The design, kernel by kernel:
//
// * The forward (persistent, as attention_tc.cuh's): K and V of a key tile
//   have slots and barriers of their own, loaded in the order the consumers
//   take them (K(j), then V(j - 1)).  S(j) frees K(j) once the softmax has
//   read its keys' segment ids, and P V(j - 1) frees V(j - 1), so K(j + 1) and
//   V(j) load under P V(j - 1).  (As one stage of K and V freed after its
//   P V, the two stages that fit at Dh 256 are both held by a consumer and
//   nothing loads while it computes.)  Two K and three V slots at Dh 256,
//   three and four at Dh 192.
// * The dQ kernel: two consumers of 64 query rows each (128 a CTA) share the
//   streamed tiles; each issues S(j) with the previous tile's dQ product,
//   then dPd(j).  One's weights and dS run under the other's products, and
//   a streamed byte serves 128 rows.  (Taking their products in turns, as
//   the forward's consumers do, was 6 % slower at Dh 192: PERF.md §6.)
//   Their own Q and dO take 128 KB at Dh 256, so K (read by S and again by
//   dQ) and V (read by dPd) have slots of their own: two K slots and one V
//   slot at Dh 256, three and two at Dh 192.  The grid walks the causal
//   query tiles heaviest first.
// * The dK/dV kernel: two consumers share the CTA's 64 keys (both
//   accumulators of a 64-key tile would take Dh registers a thread).  The
//   dV warpgroup computes S^T and P^T, hands P^T (f32, 16 KB a tile) to the
//   dK warpgroup through shared memory (named barriers kPReady + b: buffer b
//   holds a tile; kPReady + p_buffers + b: the dK warpgroup has read it) and
//   accumulates dV; the dK warpgroup computes dP^T, dS and dK.  Two products
//   a warpgroup, four a streamed tile, where two warpgroups that each
//   computed S^T would take five.  Two hand-off buffers at Dh 256, one at Dh
//   192 (where three stages of Q and dO leave room for one).  The grid walks
//   the causal key tiles heaviest first.
// No atomics: every gradient element is written by one thread, in a fixed
// order, so the backward is bitwise the same call to call.

#pragma once

#include "attention_tc.cuh"

namespace kokoro_attn {
namespace tc {
namespace wide {

template <int DH>
__host__ __device__ constexpr uint32_t tile_bytes() {  // a 64-row tile: DH / 64 boxes
  return DH / 64 * kBox;
}
// the forward's K and V slots
template <int DH>
__host__ __device__ constexpr int fwd_k_slots() {
  return DH == 256 ? 2 : 3;
}
template <int DH>
__host__ __device__ constexpr int fwd_v_slots() {
  return DH == 256 ? 3 : 4;
}
// the dQ kernel's K and V slots, beside the two consumers' Q and dO
template <int DH>
__host__ __device__ constexpr int dq_k_slots() {
  return DH == 256 ? 2 : 3;
}
template <int DH>
__host__ __device__ constexpr int dq_v_slots() {
  return DH == 256 ? 1 : 2;
}
// the dK/dV kernel's stages of Q and dO, and its P^T hand-off buffers
template <int DH>
__host__ __device__ constexpr int dkdv_stages() {
  return DH == 256 ? 2 : 3;
}
template <int DH>
__host__ __device__ constexpr int p_buffers() {
  return DH == 256 ? 2 : 1;
}
constexpr uint32_t kPBytes = kBQ * kBK * 4;  // a 64 x 64 f32 tile of P^T
constexpr int kPReady = 5;                   // named barriers: P^T in buffer b is ready (5 + b)

// Shared memory a CTA asks for: 1 KB of slack to align the tiles to the
// 128-byte swizzle's period, the tiles, the mbarriers, and the streamed rows'
// data (the forward's and dQ kernel's keys' segment ids, 64 a K slot; the
// dK/dV kernel's query rows' lse, delta and segment ids, 64 each a stage).
template <int DH>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  constexpr int KS = fwd_k_slots<DH>(), VS = fwd_v_slots<DH>();
  return 1024 + (size_t)(2 + KS + VS) * tile_bytes<DH>() + 8 * (2 + 2 * KS + 2 * VS) + 256 * KS;
}
template <int DH>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  constexpr int KS = dq_k_slots<DH>(), VS = dq_v_slots<DH>();
  return 1024 + (size_t)(4 + KS + VS) * tile_bytes<DH>() + 8 * (1 + 2 * KS + 2 * VS) + 256 * KS;
}
template <int DH>
__host__ __device__ constexpr size_t dkdv_smem_bytes() {
  constexpr int ST = dkdv_stages<DH>();
  return 1024 + (size_t)(2 + 2 * ST) * tile_bytes<DH>() + p_buffers<DH>() * kPBytes +
         8 * (1 + 2 * ST) + 768 * ST;
}

// A ring of N slots of one 64-row tile each: tile n of the ring's sequence
// lives in slot n % N; full completes when it has landed (32 arrivals of the
// producer warp and the TMA bytes), empty when the consumers' warps are done
// with it.
template <int DH, int N>
struct Slots {
  uint8_t* tiles;
  uint64_t* full;
  uint64_t* empty;
  __device__ __forceinline__ const uint8_t* tile(int n) const {
    return tiles + (size_t)(n % N) * tile_bytes<DH>();
  }
  __device__ __forceinline__ void wait_full(int n) const { mbar_wait(full + n % N, (n / N) & 1); }
  __device__ __forceinline__ void free(int n, int lane) const { release(empty + n % N, lane); }
  __device__ __forceinline__ void init(int consumer_warps) const {
    for (int s = 0; s < N; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, consumer_warps);
    }
  }
  // the producer warp: rows [row0, row0 + 64) of head h of batch b into tile
  // n's slot once the consumers have freed it (only the ring's first pass in
  // the probe's loads-off build); `rows` (every lane) writes the slot's row
  // data after the load is issued, before the lane's arrival
  template <typename Rows>
  __device__ __forceinline__ void produce(int n, const CUtensorMap* map, int row0, int h, int b,
                                          int lane, Rows rows) const {
    mbar_wait(empty + n % N, ((n / N) & 1) ^ 1);
    uint64_t* bar = full + n % N;
    if (lane == 0 && (!probed<DH>(kProbeLoadsOff) || n < N)) {
      mbar_expect_tx_only(bar, tile_bytes<DH>());
      tma_tile<true, DH>(tiles + (size_t)(n % N) * tile_bytes<DH>(), map, row0, h, b, bar);
    }
    rows();
    mbar_arrive(bar);
  }
};

// p, which the compiler cannot see through: a product's shared-memory
// descriptors derived from it are computed where they are used, not hoisted
// out of the loop (the dQ kernel's owned Q and dO would hold 64 registers of
// descriptors a thread across the loop, and spill at Dh 256)
__device__ __forceinline__ const uint8_t* opaque(const uint8_t* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// the keys' segment ids of key tile j (1 past Tk) into `ids`, by the lanes of
// the producer warp
__device__ __forceinline__ void key_segments(int* ids, const AttnArgs& a, int b, int j, int lane) {
  for (int c = lane; c < kBK; c += 32) {
    const int pos = j * kBK + c;
    ids[c] = pos < a.Tk ? a.kv_seg[(size_t)b * a.Tk + pos] : 1;
  }
}

// -- the forward ----------------------------------------------------------------

// Persistent, one CTA an SM, work items as attention_tc.cuh's forward (128
// query rows of a head, causal heaviest first, dealt in a snake order); a
// producer warpgroup and two consumers of 64 rows each.  O leaves from
// registers (the query tiles and the ring take the shared memory).
template <int DH>
__global__ void __launch_bounds__(3 * kWG, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
           float* __restrict__ lse, AttnArgs a, int B) {
  constexpr uint32_t TILE = tile_bytes<DH>();
  constexpr int C = 2, KS = fwd_k_slots<DH>(), VS = fwd_v_slots<DH>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);  // the item's query rows: one tile a consumer
  uint64_t* bars = reinterpret_cast<uint64_t*>(Qs + (C + KS + VS) * TILE);
  uint64_t* own = bars;           // the item's query tiles have landed
  uint64_t* own_free = bars + 1;  // the consumers' last S products have read them
  const Slots<DH, KS> kr{Qs + C * TILE, bars + 2, bars + 2 + KS};
  const Slots<DH, VS> vr{Qs + (C + KS) * TILE, bars + 2 + 2 * KS, bars + 2 + 2 * KS + VS};
  int* kseg = reinterpret_cast<int*>(bars + 2 + 2 * KS + 2 * VS);  // 64 a K slot

  const int n_q = (a.Tq + C * kBQ - 1) / (C * kBQ), heads = B * a.H, items = n_q * heads;
  const bool seg = a.q_seg != nullptr;
  const int group = warpgroup_index(), lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(own, 1);
    mbar_init(own_free, 4 * C);
    kr.init(4 * C);
    vr.init(4 * C);
    mbar_fence_init();
  }
  __syncthreads();

  if (group == 0) {  // the producer warpgroup; its first warp issues every load
    regs_dec<kProducerRegs>();
    if (warp_in_group() == 0) {
      int kn = 0, vn = 0;  // the rings' sequence numbers
      for (int n = 0, w; (w = fwd_work(n, items)) >= 0; ++n) {
        const FwdItem it = fwd_item<C>(w, n_q, heads, a);
        const int own_tiles = min(C, (a.Tq - it.q0 + kBQ - 1) / kBQ);
        const int n_tiles =
            (key_range<true>(a, it.b, it.q0 + (own_tiles - 1) * kBQ).kv_end + kBK - 1) / kBK;
        if (n > 0) mbar_wait(own_free, (n - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(own, own_tiles * TILE);
          for (int q = 0; q < own_tiles; ++q)
            tma_tile<true, DH>(Qs + q * TILE, &tq, it.q0 + q * kBQ, it.h, it.b, own);
        }
        // in the order the consumers take them: K(j), then V(j - 1)
        for (int j = 0; j <= n_tiles; ++j) {
          if (j < n_tiles) {
            int* ids = kseg + kBK * (kn % KS);
            kr.produce(kn++, &tk, j * kBK, it.h, it.b, lane, [&] {
              if (seg) key_segments(ids, a, it.b, j, lane);
            });
          }
          if (j > 0) vr.produce(vn++, &tv, (j - 1) * kBK, it.h, it.b, lane, [] {});
        }
      }
    }
  } else {  // a consumer warpgroup: 64 query rows of each item
    regs_inc<kConsumerRegs>();
    const int wg = group - 1, t = threadIdx.x & (kWG - 1);
    const int r0 = 16 * (t >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
    const uint8_t* Qw = Qs + wg * TILE;
    // the products in turns (named barrier 3 + wg), consumer 0 first; each
    // takes n_tiles + 1 turns an item
    const auto my_turn = [&] { pair_sync(3 + wg); };
    const auto your_turn = [&] { pair_arrive(3 + (wg ^ 1)); };
    if (wg == 1) your_turn();
    int kn = 0, vn = 0;
    for (int n = 0, w; (w = fwd_work(n, items)) >= 0; ++n) {
      const FwdItem it = fwd_item<C>(w, n_q, heads, a);
      const int own_tiles = min(C, (a.Tq - it.q0 + kBQ - 1) / kBQ);
      const int n_tiles =
          (key_range<true>(a, it.b, it.q0 + (own_tiles - 1) * kBQ).kv_end + kBK - 1) / kBK;
      const int qw = it.q0 + wg * kBQ, qrow = qw + r0;
      const KeyRange keys = key_range<true>(a, it.b, qw);
      const int my_tiles = wg < own_tiles ? (keys.kv_end + kBK - 1) / kBK : 0;
      int qseg[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = qrow + 8 * i;
        qseg[i] = (seg && row < a.Tq) ? a.q_seg[(size_t)it.b * a.Tq + row] : 1;
      }
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
      float acc[DH / 2], s[32];
      uint32_t pa[4][4];  // the previous tile's weights, bf16: P V's A operand
      zero(acc);
      int j = 0;
      mbar_wait(own, n & 1);
      // one tile's softmax (the segment ids of its K slot; the K slot is
      // freed after it)
      const auto softmax = [&](int k0) {
        if constexpr (probed<DH>(kProbeElementwiseOff)) {
          alpha[0] = alpha[1] = 1.f;
        } else {
          softmax_step<true, false, 64>(s, m, l, alpha,
                                        tile_unmasked<true>(a, keys, seg, qw, k0, kBK), 0u, a,
                                        keys, seg, qseg, kseg + kBK * (kn % KS), qrow, k0, c0);
        }
        kr.free(kn++, lane);
      };
      if (my_tiles > 0) {
        kr.wait_full(kn);  // tile 0: S and its softmax
        my_turn();
        wgmma_fence();
        score_tile<DH, 64>(s, Qw, kr.tile(kn));
        wgmma_commit();
        your_turn();
        wgmma_wait<0>();
        fence_regs(s);
        if (my_tiles == 1) release(own_free, lane);  // Q is read
        softmax(0);
        to_a_operand(s, pa);
        // every later tile: its S and the previous tile's P V issued
        // together, its softmax while P V runs
        for (j = 1; j < my_tiles; ++j) {
          kr.wait_full(kn);
          vr.wait_full(vn);  // V(j - 1)
          my_turn();
          wgmma_fence();
          score_tile<DH, 64>(s, Qw, kr.tile(kn));
          wgmma_commit();
          accumulate<DH>(acc, pa, vr.tile(vn));
          wgmma_commit();
          your_turn();
          wgmma_wait<1>();  // S is done, P V may still run
          fence_regs(s);
          if (j == my_tiles - 1) release(own_free, lane);  // Q is read
          softmax(j * kBK);
          // the softmax runs while P V does: the compiler may not sink it below the wait
          fence_regs(s);
          fence_regs(m);
          fence_regs(l);
          fence_regs(alpha);
          wgmma_wait<0>();  // P V is done: V(j - 1)'s slot is free
          fence_regs(acc);
          fence_operand(pa);
          vr.free(vn++, lane);
#pragma unroll
          for (int jj = 0; jj < (probed<DH>(kProbeElementwiseOff) ? 0 : DH / 8); ++jj) {
            acc[4 * jj] *= alpha[0];
            acc[4 * jj + 1] *= alpha[0];
            acc[4 * jj + 2] *= alpha[1];
            acc[4 * jj + 3] *= alpha[1];
          }
          to_a_operand(s, pa);
        }
        vr.wait_full(vn);
        my_turn();
        wgmma_fence();
        accumulate<DH>(acc, pa, vr.tile(vn));
        wgmma_commit();
        your_turn();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_operand(pa);
        vr.free(vn++, lane);
      } else {
        release(own_free, lane);
        my_turn();
        your_turn();
      }
      for (; j < n_tiles; ++j) {  // key tiles no row of this warpgroup visits
        kr.wait_full(kn);
        my_turn();
        your_turn();
        kr.free(kn++, lane);
        vr.wait_full(vn);
        vr.free(vn++, lane);
      }
      if (my_tiles > 0) {
        float inv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // a visible logit is far above half the mask value, and a row that
          // saw only masked keys has m near the mask value
          const bool any_visible = m[i] > 0.5f * kFlashMask;
          inv[i] = any_visible ? 1.f / l[i] : 0.f;
          const int row = qrow + 8 * i;
          if (lse != nullptr && (lane & 3) == 0 && row < a.Tq)
            lse[(size_t)it.bh * a.Tq + row] = any_visible ? m[i] * kLn2 + logf(l[i]) : INFINITY;
        }
        store_rows<DH>(o + head_offset<true, DH>(it.b, it.h, a.H, a.Tq), acc, qw, r0, c0, a.Tq,
                       DH, inv);
      }
    }
    if (wg == 0) my_turn();  // consumer 1's last hand-over
  }
}

// -- the backward -------------------------------------------------------------

// A CTA a 128-row query tile of a head (fwd_item's order: causal heaviest
// first), two consumers of 64 rows each.  Per key tile a consumer issues
// S(j) with the previous tile's dQ product, takes its weights while dQ runs,
// then issues dPd(j), whose wait frees V(j); dS follows, and dQ(j) goes with
// S(j + 1).  K(j) is freed once dQ(j) is done.
template <int DH>
__global__ void __launch_bounds__(3 * kWG, 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
              const bf16* __restrict__ o, const bf16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta_out,
              bf16* __restrict__ dq, AttnArgs a, int B) {
  constexpr uint32_t TILE = tile_bytes<DH>();
  constexpr int C = 2, KS = dq_k_slots<DH>(), VS = dq_v_slots<DH>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);  // the CTA's query rows: one tile a consumer
  uint8_t* dOs = Qs + C * TILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(dOs + (C + KS + VS) * TILE);
  uint64_t* own = bars;
  const Slots<DH, KS> kr{dOs + C * TILE, bars + 1, bars + 1 + KS};
  const Slots<DH, VS> vr{dOs + (C + KS) * TILE, bars + 1 + 2 * KS, bars + 1 + 2 * KS + VS};
  int* kseg = reinterpret_cast<int*>(bars + 1 + 2 * KS + 2 * VS);  // 64 a K slot

  const int n_q = (a.Tq + C * kBQ - 1) / (C * kBQ), heads = B * a.H;
  const FwdItem it = fwd_item<C>((int)blockIdx.x, n_q, heads, a);
  const int q0 = it.q0, b = it.b, h = it.h;
  const bool seg = a.q_seg != nullptr;
  const int own_tiles = min(C, (a.Tq - q0 + kBQ - 1) / kBQ);
  // every key tile a row of the CTA visits (its last tile's rows see the most)
  const int n_tiles = (key_range<true>(a, b, q0 + (own_tiles - 1) * kBQ).kv_end + kBK - 1) / kBK;
  const int group = warpgroup_index(), lane = threadIdx.x & 31;
  const float inv_t = 1.f / (float)a.Tk;
  if (threadIdx.x == 0) {
    mbar_init(own, 1);
    kr.init(4 * C);
    vr.init(4 * C);
    mbar_fence_init();
  }
  __syncthreads();

  if (group == 0) {  // the producer warpgroup; its first warp issues every load
    regs_dec<kProducerRegs>();
    if (warp_in_group() == 0) {
      if (lane == 0) {
        mbar_expect_tx(own, own_tiles * 2 * TILE);
        for (int w = 0; w < own_tiles; ++w) {
          tma_tile<true, DH>(Qs + w * TILE, &tq, q0 + w * kBQ, h, b, own);
          tma_tile<true, DH>(dOs + w * TILE, &tdo, q0 + w * kBQ, h, b, own);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        int* ids = kseg + kBK * (j % KS);
        kr.produce(j, &tk, j * kBK, h, b, lane, [&] {
          if (seg) key_segments(ids, a, b, j, lane);
        });
        vr.produce(j, &tv, j * kBK, h, b, lane, [] {});
      }
    }
  } else {  // a consumer warpgroup: 64 query rows
    regs_inc<kConsumerRegs>();
    const int wg = group - 1, t = threadIdx.x & (kWG - 1);
    const int r0 = 16 * (t >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
    const int qw = q0 + wg * kBQ;
    const KeyRange keys = key_range<true>(a, b, qw);
    const int my_tiles = qw < a.Tq ? (keys.kv_end + kBK - 1) / kBK : 0;
    const size_t q_base = head_offset<true, DH>(b, h, a.H, a.Tq);
    const float scale2 = a.scale * kLog2e;

    // the rows' delta (written once for the dK/dV kernel), lse and segment
    float delta[2], lse2[2];
    int qseg[2];
    quad_row_deltas<true, DH>(o, nullptr, dout, q_base, qw + r0, a.Tq, DH, lane, delta);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = qw + r0 + 8 * i;
      const bool in_rows = row < a.Tq;
      if (in_rows && (lane & 3) == 0) delta_out[(size_t)it.bh * a.Tq + row] = delta[i];
      lse2[i] = in_rows ? lse[(size_t)it.bh * a.Tq + row] * kLog2e : 0.f;
      qseg[i] = (seg && in_rows) ? a.q_seg[(size_t)b * a.Tq + row] : 1;
    }

    float acc[DH / 2], s[32], dp[32];
    uint32_t dsa[4][4];  // bf16(dS * scale): the dQ product's A operand
    zero(acc);
    mbar_wait(own, 0);
    // S of key tile j (complete) -> the weights P in place
    const auto weights = [&](int j) {
      const int k0 = j * kBK;
      if constexpr (probed<DH>(kProbeElementwiseOff)) {
      } else if (tile_unmasked<true>(a, keys, seg, qw, k0)) {
#pragma unroll
        for (int idx = 0; idx < 32; ++idx)
          s[idx] = exp2f(fmaf(s[idx], scale2, -lse2[(idx >> 1) & 1]));
      } else {
        const int* kvseg = kseg + kBK * (j % KS);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = qw + r0 + 8 * i;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * jj + c0 + e, col = k0 + c, idx = 4 * jj + 2 * i + e;
              const bool in_bounds = (row < a.Tq) & (col < a.Tk);
              const bool visible = in_bounds & is_visible<true>(a, keys, row, col) &
                                   ((!seg) | (qseg[i] == kvseg[c]));
              s[idx] = softmax_p(s[idx], in_bounds, false, visible, lse2[i], scale2, inv_t);
            }
          }
        }
      }
    };
    // dPd of key tile j (frees V(j)), then dS * scale as bf16 into the dQ
    // product's operand
    const auto dpd_ds = [&](int j) {
      vr.wait_full(j);
      wgmma_fence();
      score_tile<DH, 64>(dp, opaque(dOs + wg * TILE), vr.tile(j));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dp);
      vr.free(j, lane);
#pragma unroll
      for (int idx = 0; idx < (probed<DH>(kProbeElementwiseOff) ? 0 : 32); ++idx)
        s[idx] = grad_ds<false>(s[idx], dp[idx], delta[(idx >> 1) & 1], true, a);
      to_a_operand(s, dsa);
    };
    int j = 0;
    if (my_tiles > 0) {
      kr.wait_full(0);  // tile 0: S alone
      wgmma_fence();
      score_tile<DH, 64>(s, opaque(Qs + wg * TILE), kr.tile(0));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      weights(0);
      dpd_ds(0);
      // every later tile: its S and the previous tile's dQ product issued
      // together, its weights while dQ runs
      for (j = 1; j < my_tiles; ++j) {
        kr.wait_full(j);
        wgmma_fence();
        score_tile<DH, 64>(s, opaque(Qs + wg * TILE), kr.tile(j));
        wgmma_commit();
        accumulate<DH>(acc, dsa, kr.tile(j - 1));
        wgmma_commit();
        wgmma_wait<1>();  // S is done, dQ may still run
        fence_regs(s);
        weights(j);
        fence_regs(s);  // the weights run while dQ does
        wgmma_wait<0>();  // the previous dQ product is done: K(j - 1) is free
        fence_operand(dsa);
        fence_regs(acc);
        kr.free(j - 1, lane);
        dpd_ds(j);
      }
      wgmma_fence();  // the last dQ product
      accumulate<DH>(acc, dsa, kr.tile(my_tiles - 1));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(dsa);
      fence_regs(acc);
      kr.free(my_tiles - 1, lane);
    }
    for (; j < n_tiles; ++j) {  // key tiles no row of this warpgroup visits
      kr.wait_full(j);
      kr.free(j, lane);
      vr.wait_full(j);
      vr.free(j, lane);
    }
    const float one[2] = {1.f, 1.f};
    store_rows<DH>(dq + q_base, acc, qw, r0, c0, a.Tq, DH, one);
  }
}

// A CTA 64 keys of a head (causal: the key tiles in ascending order, the
// heaviest first), streaming the query tiles from its first key; consumer 1
// computes S^T = K Q^T, P^T, hands P^T over and accumulates dV += P^T dO;
// consumer 2 computes dP^T = V dO^T and, with P^T, dS^T and dK += dS^T Q.
template <int DH>
__global__ void __launch_bounds__(3 * kWG, 1)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, AttnArgs a, int B) {
  constexpr uint32_t TILE = tile_bytes<DH>();
  constexpr int ST = dkdv_stages<DH>(), NB = p_buffers<DH>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);  // the CTA's keys
  uint8_t* Vs = Ks + TILE;
  uint8_t* Qs = Vs + TILE;            // ST stages
  uint8_t* dOs = Qs + ST * TILE;
  float4* Pb = reinterpret_cast<float4*>(dOs + ST * TILE);  // NB buffers of P^T
  uint64_t* bars = reinterpret_cast<uint64_t*>(dOs + ST * TILE + NB * kPBytes);
  uint64_t* own = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + ST;
  float* rows = reinterpret_cast<float*>(empty + ST);  // a stage: lse2, delta, seg (64 each)

  const int n_k = (a.Tk + kBK - 1) / kBK, heads = B * a.H, w = (int)blockIdx.x;
  int rank, bh;
  if (a.causal) {  // the key tile the slowest index: the heaviest tiles first
    rank = w / heads;
    bh = w - rank * heads;
  } else {  // a head's tiles together, sharing its queries in L2
    bh = w / n_k;
    rank = w - bh * n_k;
  }
  const int k0 = rank * kBK, b = bh / a.H, h = bh - b * a.H;
  const bool seg = a.q_seg != nullptr;
  const KeyRange keys = key_range<true>(a, b, 0);
  const int q_begin = a.causal ? k0 : 0;  // earlier query tiles see none of these keys
  const int n_tiles = q_begin < a.Tq ? (a.Tq - q_begin + kBQ - 1) / kBQ : 0;
  const int group = warpgroup_index(), lane = threadIdx.x & 31;
  const float inv_t = 1.f / (float)a.Tk;
  if (threadIdx.x == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (group == 0) {  // the producer warpgroup; its first warp issues every load
    regs_dec<kProducerRegs>();
    if (warp_in_group() == 0) {
      if (lane == 0 && n_tiles > 0) {
        mbar_expect_tx(own, 2 * TILE);
        tma_tile<true, DH>(Ks, &tk, k0, h, b, own);
        tma_tile<true, DH>(Vs, &tv, k0, h, b, own);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int q0 = q_begin + i * kBQ, stage = i % ST;
        mbar_wait(empty + stage, ((i / ST) & 1) ^ 1);
        float* r = rows + stage * 192;
        if (lane == 0 && (!probed<DH>(kProbeLoadsOff) || i < ST)) {
          mbar_expect_tx_only(full + stage, 2 * TILE);
          tma_tile<true, DH>(Qs + stage * TILE, &tq, q0, h, b, full + stage);
          tma_tile<true, DH>(dOs + stage * TILE, &tdo, q0, h, b, full + stage);
        }
        for (int c = lane; c < kBQ; c += 32) {  // the query rows' lse and delta (the dQ kernel's)
          const int row = q0 + c;
          const bool in_rows = row < a.Tq;
          r[c] = in_rows ? lse[(size_t)bh * a.Tq + row] * kLog2e : 0.f;
          r[64 + c] = in_rows ? delta[(size_t)bh * a.Tq + row] : 0.f;
          if (seg) reinterpret_cast<int*>(r)[128 + c] = in_rows ? a.q_seg[(size_t)b * a.Tq + row] : 1;
        }
        mbar_arrive(full + stage);
      }
    }
  } else {
    regs_inc<kConsumerRegs>();
    const int t = threadIdx.x & (kWG - 1);
    const int r0 = 16 * (t >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
    const size_t kv_base = head_offset<true, DH>(b, h, a.H, a.Tk);
    float acc[DH / 2], x[32];  // x: S^T then P^T (dV), or dP^T then dS^T (dK)
    uint32_t op[4][4];         // the output product's A operand
    zero(acc);
    if (n_tiles > 0) mbar_wait(own, 0);
    if (group == 1) {  // dV += bf16(P)^T dO
      int kvseg[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = k0 + r0 + 8 * i;
        kvseg[i] = (seg && key < a.Tk) ? a.kv_seg[(size_t)b * a.Tk + key] : 1;
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int q0 = q_begin + i * kBQ, stage = i % ST, buf = i % NB;
        const float* r = rows + stage * 192;
        mbar_wait(full + stage, (i / ST) & 1);
        wgmma_fence();
        score_tile<DH, 64>(x, Ks, Qs + stage * TILE);
        wgmma_commit();
        if (i > 0) {  // the previous dV product is done: its stage is free of us
          wgmma_wait<1>();
          fence_operand(op);
          fence_regs(acc);
          release(empty + (i - 1) % ST, lane);
        }
        wgmma_wait<0>();
        fence_regs(x);
        if constexpr (!probed<DH>(kProbeElementwiseOff))
          transposed_weights<true>(x, a, keys, seg, q0, k0, r0, c0, r,
                                   reinterpret_cast<const int*>(r) + 128, kvseg, inv_t);
        // P^T to the dK warpgroup: float4 c of thread t at 128 c + t
        if (i >= NB) pair_sync(kPReady + NB + buf);  // it has read the buffer's last tile
        float4* p = Pb + (size_t)buf * (kPBytes / 16);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          p[128 * c + t] = make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
        pair_arrive(kPReady + buf);
        to_a_operand(x, op);  // bf16(P)^T
        wgmma_fence();
        accumulate<DH>(acc, op, dOs + stage * TILE);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_operand(op);
      fence_regs(acc);
      const float one[2] = {1.f, 1.f};
      store_rows<DH>(dv + kv_base, acc, k0, r0, c0, a.Tk, DH, one);
    } else {  // dK += bf16(dS * scale)^T Q
      for (int i = 0; i < n_tiles; ++i) {
        const int stage = i % ST, buf = i % NB;
        const float* delta_t = rows + stage * 192 + 64;
        mbar_wait(full + stage, (i / ST) & 1);
        wgmma_fence();
        score_tile<DH, 64>(x, Vs, dOs + stage * TILE);
        wgmma_commit();
        if (i > 0) {  // the previous dK product is done: its stage is free of us
          wgmma_wait<1>();
          fence_operand(op);
          fence_regs(acc);
          release(empty + (i - 1) % ST, lane);
        }
        wgmma_wait<0>();
        fence_regs(x);
        pair_sync(kPReady + buf);  // P^T of this tile
        const float4* p = Pb + (size_t)buf * (kPBytes / 16);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float4 pc = p[128 * c + t];
          const float pv[4] = {pc.x, pc.y, pc.z, pc.w};
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int idx = 4 * c + v, qc = 8 * c + c0 + (v & 1);
            if constexpr (!probed<DH>(kProbeElementwiseOff))
              x[idx] = grad_ds<false>(pv[v], x[idx], delta_t[qc], true, a);
          }
        }
        if (i + NB < n_tiles) pair_arrive(kPReady + NB + buf);  // the buffer is read
        to_a_operand(x, op);  // bf16(dS * scale)^T
        wgmma_fence();
        accumulate<DH>(acc, op, Qs + stage * TILE);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_operand(op);
      fence_regs(acc);
      const float one[2] = {1.f, 1.f};
      store_rows<DH>(dk + kv_base, acc, k0, r0, c0, a.Tk, DH, one);
    }
  }
}

// -- launches ---------------------------------------------------------------

template <int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       const AttnArgs& a, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<DH>();
  static_assert(smem <= 232448, "a CTA's shared memory");
  static bool configured = false;
  cudaError_t err = allow_smem(fwd_kernel<DH>, smem, configured);
  CUtensorMap mq, mk, mv;
  if (err == cudaSuccess) err = make_map<true>(&mq, q, B, a.H, a.Tq, DH);
  if (err == cudaSuccess) err = make_map<true>(&mk, k, B, a.H, a.Tk, DH);
  if (err == cudaSuccess) err = make_map<true>(&mv, v, B, a.H, a.Tk, DH);
  if (err != cudaSuccess) return err;
  // work items of 128 query rows of a head; one CTA an SM, each taking items in turn
  const long long items = (long long)((a.Tq + 2 * kBQ - 1) / (2 * kBQ)) * a.H * B;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const unsigned ctas = (unsigned)(items < sms ? items : sms);
  fwd_kernel<DH><<<ctas, 3 * kWG, smem, stream>>>(mq, mk, mv, static_cast<bf16*>(o), lse, a, B);
  return cudaGetLastError();
}

// the backward's tensor maps: q, k, v and dO
struct BwdMaps {
  CUtensorMap q, k, v, dout;
};

template <int DH>
cudaError_t bwd_maps(BwdMaps& m, const void* q, const void* k, const void* v, const void* dout,
                     int B, const AttnArgs& a) {
  cudaError_t err = make_map<true>(&m.q, q, B, a.H, a.Tq, DH);
  if (err == cudaSuccess) err = make_map<true>(&m.k, k, B, a.H, a.Tk, DH);
  if (err == cudaSuccess) err = make_map<true>(&m.v, v, B, a.H, a.Tk, DH);
  if (err == cudaSuccess) err = make_map<true>(&m.dout, dout, B, a.H, a.Tq, DH);
  return err;
}

// the dQ kernel: a CTA a 128-row query tile of a head; writes each row's
// delta into `delta` (B, H, Tq) f32 for the dK/dV kernel
template <int DH>
cudaError_t launch_dq(const BwdMaps& m, const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, int B, const AttnArgs& a, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DH>();
  static_assert(smem <= 232448, "a CTA's shared memory");
  static bool configured = false;
  cudaError_t err = allow_smem(bwd_dq_kernel<DH>, smem, configured);
  if (err != cudaSuccess) return err;
  const long long ctas = (a.Tq + 2 * kBQ - 1) / (2 * kBQ) * ((long long)a.H * B);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  bwd_dq_kernel<DH><<<(unsigned)ctas, 3 * kWG, smem, stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dq), a, B);
  return cudaGetLastError();
}

// the dK/dV kernel: a CTA 64 keys of a head; reads the rows' delta
template <int DH>
cudaError_t launch_dkdv(const BwdMaps& m, const float* lse, const float* delta, void* dk,
                        void* dv, int B, const AttnArgs& a, cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem_bytes<DH>();
  static_assert(smem <= 232448, "a CTA's shared memory");
  static bool configured = false;
  cudaError_t err = allow_smem(bwd_dkdv_kernel<DH>, smem, configured);
  if (err != cudaSuccess) return err;
  const long long ctas = (a.Tk + kBK - 1) / kBK * ((long long)a.H * B);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  bwd_dkdv_kernel<DH><<<(unsigned)ctas, 3 * kWG, smem, stream>>>(
      m.q, m.k, m.v, m.dout, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), a, B);
  return cudaGetLastError();
}

// the dQ kernel, then the dK/dV kernel; `delta` (B, H, Tq) f32 carries each
// row's delta from the first to the second
template <int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, const AttnArgs& a, cudaStream_t stream) {
  if (delta == nullptr) return cudaErrorInvalidValue;
  BwdMaps m;
  cudaError_t err = bwd_maps<DH>(m, q, k, v, dout, B, a);
  if (err == cudaSuccess) err = launch_dq<DH>(m, o, dout, lse, delta, dq, B, a, stream);
  if (err == cudaSuccess) err = launch_dkdv<DH>(m, lse, delta, dk, dv, B, a, stream);
  return err;
}

}  // namespace wide
}  // namespace tc
}  // namespace kokoro_attn
