// The bf16 attention kernels on Hopper's tensor cores (sm_90a): the forward,
// dQ and dK/dV templates of attention_kernels.cuh redesigned around wgmma and
// TMA, with the same two mask policies (packed K1/K2/K3, flash K4), dropout
// on or off, Dh 64 or 128 (the flash policy without dropout also from 320
// to 2048, as a cluster of Dh 128 CTAs: "clusters" below; at 192 and 256 it
// has kernels of its own, attention_tc_wide.cuh, built from these pieces),
// and the same numerics contract (see attention_kernels.cuh): S and dPd in
// f32; the unnormalised exp, Pd and dS * scale rounded to bf16 exactly where
// they become tensor-core operands; f32 sums, the f32 row lse.
//
// A warpgroup (128 threads) owns a 64-row tile: a query tile (forward, dQ) or
// a key tile (dK/dV).  Thread t of the warpgroup holds, of every 64 x N f32
// accumulator, rows r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8, columns
// 8 j + 2 (t % 4) + {0, 1}: element 4 j + 2 i + e is (r0 + 8 i,
// 8 j + 2 (t % 4) + e).  Row reductions of the softmax are over the thread's
// 16 values of a 64-column tile and then the quad (lanes xor 1, 2).  The same
// registers, rounded to bf16 in pairs, are wgmma's A operand for the second
// product (to_a_operand), so P, Pd and dS never reach shared memory.
//
// Tiles arrive by TMA (cp.async.bulk.tensor) as 64-row boxes of 64 bf16
// (128-byte rows, 128-byte swizzle; a tile is Dh / 64 boxes), completing on
// an mbarrier.  The tensor maps are 4-D so that a box never crosses into the
// next head or batch: packed (Dh, H, T, B), flash (Dh, T, H, B); rows past T
// are zero-filled by the TMA unit and masked by bounds.
//
// Products: a score tile (S = Q K^T, dPd = dO V^T, and in dK/dV the
// transposes S^T = K Q^T, dPd^T = V dO^T) is m64n64k16 with both operands in
// shared memory, K-major; an output product (O += P V, dQ += dS K,
// dV += Pd^T dO, dK += dS^T Q) is m64n{Dh}k16 with A from registers and B in
// shared memory MN-major (the transpose flag); from Dh 192
// (attention_tc_wide.cuh), one m64n128k16 product a 128-column block of the
// output (and m64n64k16 for the last 64 columns of Dh 192).
//
// The forward is warp-specialised like the backward: a CTA is a producer
// warpgroup and two consumer warpgroups of 64 query rows each (384 threads,
// setmaxnreg 24/240, at Dh 64 and 128 alike), so every key and value tile
// streamed through the ring (fwd_stages) serves 128 query rows; a streamed
// tile is 128 keys at Dh 64 (a 64 x 128 score tile a consumer: twice the
// work between two waits), 64 at Dh 128.  The kernel is persistent, one CTA
// an SM: a work item is (query tile of 128 rows, head), the causal mask's
// heaviest items first, dealt to the CTAs in a snake order, and the producer
// loads an item's query tiles while the previous item's last tiles and
// epilogue run.  Per key tile a consumer issues S = Q K^T together with the
// previous tile's O += P V, draws the tile's dropout flags in registers
// (keep_bits_q) while both run, waits for S alone, takes the online softmax
// (exp2 in one MUFU instruction; a tile wholly in bounds and visible skips
// the mask and folds the scale into the exponent's fma), then waits for P V,
// releases its stage, rescales O and rounds the new weights to bf16 for the
// next P V: one tile's softmax runs under the product of the one before.
// The two consumers issue their products in turns (named barriers), so one's
// softmax also runs under the other's products.  O leaves through shared
// memory and TMA stores; under grad the packed forward also writes O's bf16
// rounding residual, bf16(O32 - bf16(O32)), for the backward's delta.
//
// The backward (two launches, FlashAttention-2's split, no atomics: every
// gradient element is written by one thread in a fixed order, so dQ, dK and
// dV are bitwise the same call to call) is warp-specialised: a CTA is a
// producer warpgroup and, at Dh 64, two consumer warpgroups (384 threads,
// one CTA an SM; setmaxnreg gives the producer 24 registers a thread and
// the consumers 240), at Dh 128 one (256 threads: its dK and dV accumulators
// alone take 128 registers a thread).  One producer warp keeps TMA loads in flight through a ring of bwd_stages
// stages (full/empty mbarriers) and writes each stage's row data (the dK/dV kernel's lse and delta, the flash segment
// ids).  The consumers share each streamed tile: the dQ kernel's CTA owns 64
// query rows a consumer and streams the key/value tiles, the dK/dV kernel's
// CTA owns 64 keys a consumer and streams the query/dO tiles, so at Dh 64
// each streamed byte serves 128 owned rows.  Per streamed tile a consumer
// issues its score product S, then waits for the previous tile's output
// products (whose stage it then releases), issues dPd, draws the tile's
// dropout flags and takes the softmax of S while dPd runs (a tile wholly in
// bounds and visible skips the mask), then in dK/dV issues the dV product
// before dS is formed, and issues the last output product without waiting on
// it.  The dropout flags come from Philox in registers (keep_bits_q,
// keep_bits_kv: one call per four flags, shared between the lanes whose
// fragments hold them by shuffles; attention_common.cuh's counter).  Each
// query row's delta (the row term of dS = P (dP - delta)) is the dQ
// kernel's, which writes it for the dK/dV kernel: the packed policy's is
// rowsum(dO * (O + residual)) in f32, which is O32 to f32 rounding
// (rowsum(dO * O) on the bf16 O would round 1.25 v, a kept weight of a
// one-key row at rate 0.2, and put that rounding, summed over every query,
// into the key's dK); the flash policy's is the library's rowsum(dO * O).
// The kernels never trap: a trap holds the compiler to the launch's 168
// registers inside the consumers' setmaxnreg region (at Dh 64 it spilled and
// serialised the products with one).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time

#include "attention_common.cuh"

namespace kokoro_attn {
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWG = 128;                // threads of a warpgroup
constexpr uint32_t kBox = 64 * 64 * 2;  // one TMA box: 64 rows of 64 bf16
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Probe switches: python -m kokoro_tpu_torch.scripts.probe_flash_tc_wide
// builds the kernels with each of these defined to read what the part costs
// in K4's kernels at Dh 192 and 256 (attention_tc_wide.cuh; the results are
// wrong: timing only; the other instantiations do not read them); the port's
// own build defines none.
//   KOKORO_TC_LOADS_OFF: a streamed tile is loaded only on the ring's first
//     pass, so the consumers wait on no load after it;
//   KOKORO_TC_ELEMENTWISE_OFF: the softmax of the forward, and the weights
//     and dS of the backward, are not computed (the raw products stand in).
#ifdef KOKORO_TC_LOADS_OFF
constexpr bool kProbeLoadsOff = true;
#else
constexpr bool kProbeLoadsOff = false;
#endif
#ifdef KOKORO_TC_ELEMENTWISE_OFF
constexpr bool kProbeElementwiseOff = true;
#else
constexpr bool kProbeElementwiseOff = false;
#endif
// whether a probe switch acts on the instantiation at head dim DH
template <int DH>
__host__ __device__ constexpr bool probed(bool on) {
  return on && DH > 128 && DH <= 256;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory rounded up to 1024 bytes (the 128-byte swizzle's
// period; the launches allocate the extra)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// -- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// expect `bytes` more of TMA traffic in the current phase, without arriving
__device__ __forceinline__ void mbar_expect_tx_only(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// one arrival (release: the thread's earlier shared-memory accesses are
// ordered before it)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA --------------------------------------------------------------------

// one 64 x 64 box: columns [d0, d0 + 64) of rows [row0, row0 + 64) of head h
// of batch b
template <bool FLASH>
__device__ __forceinline__ void tma_box(uint8_t* dst, const CUtensorMap* map, int d0, int row0,
                                        int h, int b, uint64_t* bar) {
  const int c1 = FLASH ? row0 : h, c2 = FLASH ? h : row0;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(c1), "r"(c2), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// rows [row0, row0 + 64), columns [col0, col0 + DH): DH / 64 boxes, kBox
// bytes apart (columns past the tensor's read as zero)
template <bool FLASH, int DH>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, int row0, int h,
                                         int b, uint64_t* bar, int col0 = 0) {
#pragma unroll
  for (int g = 0; g < DH / 64; ++g)
    tma_box<FLASH>(dst + g * kBox, map, col0 + 64 * g, row0, h, b, bar);
}

// a 64 x 64 box of shared memory (128-byte swizzle) -> columns [d0, d0 + 64)
// of rows [row0, row0 + 64) of head h of batch b; rows past T are not written
template <bool FLASH>
__device__ __forceinline__ void tma_store_box(const CUtensorMap* map, const uint8_t* src, int d0,
                                              int row0, int h, int b) {
  const int c1 = FLASH ? row0 : h, c2 = FLASH ? h : row0;
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(d0), "r"(c1), "r"(c2), "r"(b), "r"(smem_u32(src))
      : "memory");
}

// this thread's generic-proxy writes to shared memory, ordered before the
// TMA unit's reads of them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the committed bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// a barrier of the 128 threads of one warpgroup (ids 1.. : 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// named barrier `id` of two warpgroups: wait for it, or arrive without waiting
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// -- clusters: K4 past Dh 256, the head dim split by columns -----------------
//
// From Dh 320 a cluster of c = ceil(Dh / 128) CTAs takes each work item
// together, CTA r owning columns [128 r, 128 r + 128) of every tile (the
// Dh 128 instantiation's tiles, rings and accumulators).  The row-wise
// contractions (S = Q K^T, dPd = dO V^T, the rows' delta) are partial sums
// over a CTA's columns, summed across the cluster through its shared memory
// (DSMEM) by a reduce-scatter and an all-gather of pushes (ClusterSum): each
// CTA owns a chunk of every exchanged tile, sums it in rank order, and sends
// the sum to the others, so every CTA holds the same bits and the softmax, P
// and dS agree across the cluster; each CTA then takes the output products
// of its own columns.  Columns past Dh read as zero (TMA's bounds, or a
// predicate) and are never stored.

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_size() {
  uint32_t n;
  asm("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return (int)n;
}

// every thread of every CTA of the cluster: arrive (release), then wait
// (acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

// the address of this CTA's shared `p` in CTA `rank`'s window of the
// cluster's shared memory
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// wait (acquire at cluster scope) until the barrier's phase `parity` has
// completed
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one asynchronous store of U floats (U = 1, 2 or 4) to the shared::cluster
// address `addr`, completing its 4 U bytes on the mbarrier at `bar` (in the
// same CTA as addr) with release semantics at cluster scope
template <int U>
__device__ __forceinline__ void st_async(uint32_t addr, const float* x, uint32_t bar) {
  if constexpr (U == 4) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
        "[%5];\n" ::"r"(addr),
        "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3]), "r"(bar)
        : "memory");
  } else if constexpr (U == 2) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
            addr),
        "f"(x[0]), "f"(x[1]), "r"(bar)
        : "memory");
  } else {
    static_assert(U == 1, "a cell of 1, 2 or 4 floats");
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(
                     addr),
                 "f"(x[0]), "r"(bar)
                 : "memory");
  }
}

// the U floats of a cell in this CTA's shared memory (4 U-byte aligned), in
// and out
template <int U>
__device__ __forceinline__ void ld_cell(const float* p, float* x) {
  if constexpr (U == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else if constexpr (U == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = *p;
  }
}
template <int U>
__device__ __forceinline__ void st_cell(float* p, const float* x) {
  if constexpr (U == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (U == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// the cluster of a K4 call past Dh 256: c = ceil(Dh / 128) CTAs of 128
// columns each, at most 16 (Hopper's largest cluster, which a kernel takes
// once it allows a non-portable size; 8 is the portable one), so Dh up to
// 2048
constexpr int kSliceCols = 128;
constexpr int kMaxClusterCtas = 16;
constexpr int kMaxClusterDh = kMaxClusterCtas * kSliceCols;
__host__ __device__ constexpr int slice_ctas(int dh) { return (dh + kSliceCols - 1) / kSliceCols; }

// the reduce-scatter slots of an exchange in a cluster of c CTAs: the most
// cells an owner receives, (c - 1) ceil(256 / c).  The portable sizes (c <=
// 8) share one layout, the most any of them needs (224, at c = 8); a larger
// cluster takes its own (232-252).
__host__ __device__ constexpr int rs_cells(int c) {
  return c <= 8 ? 224 : (c - 1) * ((256 + c - 1) / c);
}
// every size's exchanges fit its slots (of 256 cells, and of 128 cells of
// one float at M = 4)
__host__ __device__ constexpr bool rs_cells_fit() {
  for (int c = 2; c <= kMaxClusterCtas; ++c)
    if ((c - 1) * ((256 + c - 1) / c) > rs_cells(c) || (c - 1) * ((128 + c - 1) / c) > rs_cells(c))
      return false;
  return true;
}
static_assert(rs_cells_fit(), "an owner's slots hold every sender's cells");

// An exchanged tile is a warp's M floats a lane (M <= N), cut into cells of
// U = M / 8 floats (1 below M = 8): cell 32 u + l is floats [U u, U u + U)
// of lane l, 256 cells (128 at M = 4).  CTA r of c owns cells
// [ceil(256 r / c), ceil(256 (r + 1) / c)), the owner of cell x is
// floor(x c / 256), and its reduce-scatter slots hold each other CTA's
// partial of its cells, ceil(256 / c) cells a sender (rs_cells(c) slots:
// 224 up to c = 8, at most 252, at c = 15); its all-gather slots hold every
// cell at its index (256).  A warp's area (of each channel, ClusterSum's K):
// those rs_cells(c) + 256 cells of N / 8 floats (240 N bytes up to c = 8),
// rounded up to 16 bytes.
template <int N>
__host__ __device__ constexpr size_t xch_warp_bytes(int c) {
  static_assert(N % 8 == 0, "cells of N / 8 floats");
  return ((size_t)(rs_cells(c) + 256) * (N / 8) * sizeof(float) + 15) / 16 * 16;
}
// bytes of a CTA's exchange area in a cluster of c: `areas` warp areas
// (warps x channels), then two mbarriers an area (reduce-scatter,
// all-gather)
template <int N>
__host__ __device__ constexpr size_t xch_bytes(int areas, int c) {
  return (size_t)areas * (xch_warp_bytes<N>(c) + 2 * sizeof(uint64_t));
}
// the most of any cluster size (the kernels' shared memory limit)
template <int N>
__host__ __device__ constexpr size_t max_xch_bytes(int areas) {
  size_t most = 0;
  for (int c = 2; c <= kMaxClusterCtas; ++c)
    most = xch_bytes<N>(areas, c) > most ? xch_bytes<N>(areas, c) : most;
  return most;
}

// thread 0: the exchange area's mbarriers, each completed by its warp's
// lane 0 arriving with the bytes it expects and the peers' stores landing
template <int N>
__device__ __forceinline__ void xch_init(uint8_t* area, int areas, int c) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(area + (size_t)areas * xch_warp_bytes<N>(c));
  for (int i = 0; i < 2 * areas; ++i) mbar_init(bars + i, 1);
  mbar_fence_init();
}

// A warp's sums across the cluster, with the same warp of every other CTA:
// a reduce-scatter and an all-gather, both by pushes (st.async), each
// completing on the receiver's own mbarrier, so no CTA reads another's
// shared memory.  Each exchange: lane 0 arrives on both mbarriers with the
// bytes this CTA will receive (a store may land before that: the phase
// completes when both have happened); each lane pushes its cells that
// another CTA owns into that CTA's slots for this sender and parks the cells
// this CTA owns in its own all-gather slots (v is then dead until the end:
// its registers are free while the exchange waits), waits for its own
// slots, sums each of its own cells over the cluster in rank order (((p0 +
// p1) + p2) + ...) into its all-gather slot and pushes the sum into every
// other CTA's, waits for those, and reads all its cells back into v.  Every
// CTA holds the owner's bits of every cell, which are the rank-order sum.
//
// Reuse without a credit: every CTA owns at least one cell of every
// exchange (c <= 16 <= 128 cells), so a sender's push into a peer's slots for
// exchange n + 1 comes after its all-gather wait of exchange n, which took
// the peer's sums, which the peer sent after reading (and completing) its
// slots of exchange n; and a peer's all-gather push of n + 1 comes after
// this CTA's reduce-scatter push of n + 1, made after it read its all-gather
// slots of n.  The completions are releases and the waits acquires at
// cluster scope.  All the CTAs' warps make the same exchanges in the same
// order (the work items, rows and keys are the cluster's, only the columns
// differ), and the kernel ends on cluster_sync, so that no CTA leaves while
// a peer may still push to it.
//
// A ClusterSum of K channels holds K such exchanges of a warp, each with its
// own slots and mbarriers, in three phases (push, reduce, gather), so that
// the backward's S and dPd exchanges run together: push both, reduce both,
// then gather both.  No wait of a phase depends on a later phase of any
// CTA, so the interleaving cannot deadlock.
template <int N, int K = 1>
struct ClusterSum {
  static_assert(N % 8 == 0, "cells of N / 8 floats");
  // channel 0's slots: rs_cells(size) cells of reduce-scatter, then 256 of
  // all-gather, at kAg floats
  float* rs;
  uint64_t* bars;   // channel 0's two mbarriers; channel k's at + 2 k
  int rank, size;
  int kAg, kChannel;  // floats to the all-gather slots, and from a channel to the next
  uint32_t phases;  // bit k: channel k's exchanges so far, mod 2

  // `warps` warps of K channels each; this is warp `warp`'s
  __device__ __forceinline__ ClusterSum(uint8_t* area, int warps, int warp) : phases(0) {
    rank = cluster_rank();
    size = cluster_size();
    const size_t warp_bytes = xch_warp_bytes<N>(size);
    rs = reinterpret_cast<float*>(area + (size_t)warp * K * warp_bytes);
    bars = reinterpret_cast<uint64_t*>(area + (size_t)warps * K * warp_bytes) + 2 * K * warp;
    kAg = rs_cells(size) * (N / 8);
    kChannel = (int)(warp_bytes / sizeof(float));
  }

  // an exchange of M floats a lane: cells of U floats, NU a lane; this
  // CTA's cells [lo, hi), ch the largest chunk (a sender's slots)
  template <int M>
  struct Cut {
    static_assert(M <= N && (M == 4 || M % 8 == 0) && M <= 32, "cells of 1, 2 or 4 floats");
    static constexpr int U = M >= 8 ? M / 8 : 1, NU = M / U, CELLS = 32 * NU;
    static constexpr int SHIFT = NU == 8 ? 8 : 7;
    // ceil(2^16 / size): ceil(x / size) = ((x + size - 1) recip) >> 16, exact
    // while x + size - 1 < 2^16 / size (size 16 divides 2^16), so for every
    // x <= 256 x 16 at size <= 16
    uint32_t recip;
    int size, lo, hi, ch;
    __device__ __forceinline__ Cut(int rank, int size_) : size(size_) {
      recip = (65536u + (uint32_t)size - 1u) / (uint32_t)size;
      lo = ceil_div(CELLS * rank);
      hi = ceil_div(CELLS * (rank + 1));
      ch = ceil_div(CELLS);
    }
    __device__ __forceinline__ int ceil_div(int x) const {
      return (int)(((uint32_t)(x + size - 1) * recip) >> 16);
    }
  };

  // lane 0 arms both mbarriers with the bytes this CTA will receive; each
  // lane pushes its cells that another CTA owns into that CTA's slots for
  // this sender and parks this CTA's own in its all-gather slots (v is dead
  // until gather)
  template <int KK, int M>
  __device__ __forceinline__ void push(const float (&v)[M], int lane) {
#ifndef KOKORO_CLUSTER_SUM_OFF
    using C = Cut<M>;
    constexpr int U = C::U;
    const C cut(rank, size);
    float* slots = rs + KK * kChannel;
    uint64_t* bar = bars + 2 * KK;
    if (lane == 0) {
      mbar_expect_tx(bar, (uint32_t)((size - 1) * (cut.hi - cut.lo) * U * 4));
      mbar_expect_tx(bar + 1, (uint32_t)((C::CELLS - (cut.hi - cut.lo)) * U * 4));
    }
#pragma unroll
    for (int u = 0; u < C::NU; ++u) {
      const int cell = 32 * u + lane, r = (cell * size) >> C::SHIFT;
      if (r != rank) {
        const int slot = (rank < r ? rank : rank - 1) * cut.ch + cell - cut.ceil_div(C::CELLS * r);
        st_async<U>(peer_addr(slots + slot * U, r), &v[U * u], peer_addr(bar, r));
      } else {
        st_cell<U>(slots + kAg + cell * U, &v[U * u]);
      }
    }
#endif
  }

  // once this CTA's slots have landed: each of its cells summed in rank
  // order into its all-gather slot and pushed into every other CTA's
  template <int KK, int M>
  __device__ __forceinline__ void reduce(int lane) {
#ifndef KOKORO_CLUSTER_SUM_OFF
    using C = Cut<M>;
    constexpr int U = C::U;
    const C cut(rank, size);
    float* slots = rs + KK * kChannel;
    uint64_t* bar = bars + 2 * KK;
    mbar_wait_cluster(bar, (phases >> KK) & 1u);
#pragma unroll 1
    for (int cell = cut.lo + lane; cell < cut.hi; cell += 32) {
      float* own = slots + kAg + cell * U;
      // sender i's partial at + i ch U (i past this CTA's rank: i - 1)
      const float* mine = slots + (cell - cut.lo) * U;
      float x[U], y[U];
      ld_cell<U>(rank == 0 ? own : mine, x);
#pragma unroll 1
      for (int s = 1; s < size; ++s) {
        ld_cell<U>(s == rank ? own : mine + (s < rank ? s : s - 1) * cut.ch * U, y);
#pragma unroll
        for (int k = 0; k < U; ++k) x[k] += y[k];
      }
      st_cell<U>(own, x);
#pragma unroll 1
      for (int r = 0; r < size; ++r)
        if (r != rank) st_async<U>(peer_addr(own, r), x, peer_addr(bar + 1, r));
    }
#endif
  }

  // once every sum has landed: all the cells back into v
  template <int KK, int M>
  __device__ __forceinline__ void gather(float (&v)[M], int lane) {
#ifndef KOKORO_CLUSTER_SUM_OFF
    using C = Cut<M>;
    const float* ag = rs + KK * kChannel + kAg;
    mbar_wait_cluster(bars + 2 * KK + 1, (phases >> KK) & 1u);
#pragma unroll
    for (int u = 0; u < C::NU; ++u) ld_cell<C::U>(ag + (32 * u + lane) * C::U, &v[C::U * u]);
    phases ^= 1u << KK;
#endif
  }

  // v (M <= N floats) <- the sum over the cluster's CTAs, in rank order, of
  // each one's v.  KOKORO_CLUSTER_SUM_OFF compiles the exchange out, leaving
  // each CTA its own partial (timing only: scripts/probe_flash_cluster.py).
  template <int M>
  __device__ __forceinline__ void operator()(float (&v)[M], int lane) {
    push<0>(v, lane);
    reduce<0, M>(lane);
    gather<0>(v, lane);
  }
};

// -- wgmma ------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of the warpgroup are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the warpgroup's register budget (warp specialisation): the producer gives
// registers back, the consumers take them
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// keeps the compiler from reading an accumulator before the wgmma_wait that
// completes it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// a value computed before the next asm statement (a wgmma wait): the
// compiler may otherwise sink register arithmetic below the wait
__device__ __forceinline__ void fence_value(uint64_t& x) { asm volatile("" : "+l"(x)::"memory"); }

// the same for an A operand, before its registers are written again
template <int KS>
__device__ __forceinline__ void fence_operand(uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset, stride byte offset 1024 (8 rows of 128 bytes)
__device__ __forceinline__ uint64_t sw128_desc(const uint8_t* p, uint32_t lbo_bytes) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)(1024u >> 4) << 32) | (1ull << 62);
}

// K-major operand (a 64-row tile, the contraction over its columns): the
// 16-column step ks; steps 0-3 in the first box, 4-7 in the second
__device__ __forceinline__ uint64_t desc_k_major(const uint8_t* tile, int ks) {
  return sw128_desc(tile + (ks >> 2) * kBox + (ks & 3) * 32, 16);
}

// MN-major operand (a 64-row tile, the contraction over its rows): the
// 16-row step kk; the second box of Dh = 128 is kBox bytes on
__device__ __forceinline__ uint64_t desc_mn_major(const uint8_t* tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, kBox);
}

// D (64 x 64, f32) = A (64 x 16, shared memory, K-major) * B^T (B: 64 x 16,
// shared memory, K-major), plus D when `accumulate`
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 128, f32) = A (64 x 16, shared memory, K-major) * B^T (B: 128 x
// 16, shared memory, K-major), plus D when `accumulate`
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, shared memory,
// MN-major: the transpose flag)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, shared memory,
// MN-major: the transpose flag)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// s (64 x N) = A B^T over DH columns, A a 64-row tile and B an N-row tile
// (N / 64 64-row tiles back to back; N = 128 only at DH = 64) in shared
// memory (K-major), the first step overwriting s; the caller fences, commits
// and waits
template <int DH, int N>
__device__ __forceinline__ void score_tile(float (&s)[N / 2], const uint8_t* a, const uint8_t* b) {
  static_assert(N == 64 || DH == 64, "a 128-key score tile needs one box a row");
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    if constexpr (N == 64) {
      wgmma_ss_n64(s, desc_k_major(a, ks), desc_k_major(b, ks), ks > 0);
    } else {
      wgmma_ss_n128(s, desc_k_major(a, ks), desc_k_major(b, ks), ks > 0);
    }
  }
}

// columns [c, c + N) of a 64 x DH accumulator: the fragment of an N-column
// product (its elements are the accumulator's 4 j + 2 i + e from j = c / 8)
template <int N, int N2>
__device__ __forceinline__ float (&columns(float (&acc)[N2], int c))[N / 2] {
  return *reinterpret_cast<float(*)[N / 2]>(acc + c / 2);
}

// acc (64 x DH) += A (64 x 16 KS, bf16 registers) B (16 KS x DH rows, MN-major);
// past Dh 128, one product of 128 (or 64) columns a 128 (64) column block
// of B, whose boxes are kBox bytes apart as the descriptor's stride says
template <int DH, int KS>
__device__ __forceinline__ void accumulate(float (&acc)[DH / 2], const uint32_t (&a)[KS][4],
                                           const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if constexpr (DH == 64) {
      wgmma_rs_n64(acc, a[kk], desc_mn_major(b, kk));
    } else if constexpr (DH == 128) {
      wgmma_rs_n128(acc, a[kk], desc_mn_major(b, kk));
    } else {
#pragma unroll
      for (int c = 0; c + 128 <= DH; c += 128)
        wgmma_rs_n128(columns<128>(acc, c), a[kk], desc_mn_major(b + c / 64 * kBox, kk));
      if constexpr (DH % 128 != 0)
        wgmma_rs_n64(columns<64>(acc, DH - 64), a[kk], desc_mn_major(b + (DH / 64 - 1) * kBox, kk));
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a 64 x N f32 accumulator rounded to bf16 as N / 16 64 x 16 A operands
template <int N2>
__device__ __forceinline__ void to_a_operand(const float (&s)[N2], uint32_t (&a)[N2 / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N2 / 8; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// rows r0 and r0 + 8 of a 64 x DH accumulator -> bf16 rows of `dst` (D
// elements apart) scaled by inv[i]; rows at or past row_end, and columns at
// or past cols (a multiple of 8), are not stored
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[DH / 2], int row0,
                                           int r0, int c0, int row_end, int D,
                                           const float (&inv)[2], int cols = DH) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r0 + 8 * i;
    if (row >= row_end) continue;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      if (8 * j >= cols) break;
      const float x0 = acc[4 * j + 2 * i] * inv[i], x1 = acc[4 * j + 2 * i + 1] * inv[i];
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * D + 8 * j + c0) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

// rows r0 and r0 + 8 of a 64 x DH accumulator scaled by inv[i] -> bf16 in a
// 64-row tile of shared memory in TMA's 128-byte swizzle (DH / 64 boxes; the
// 16-byte chunk j of row r at chunk j ^ (r % 8), so a warp's writes hit 32
// banks); with `res`, O's rounding residual bf16(x - bf16(x)) into a second
// tile the same way
template <int DH>
__device__ __forceinline__ void stage_rows(uint8_t* dst, uint8_t* res, const float (&acc)[DH / 2],
                                           int r0, int c0, const float (&inv)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const float x0 = acc[4 * j + 2 * i] * inv[i], x1 = acc[4 * j + 2 * i + 1] * inv[i];
      const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
      const uint32_t at = (j >> 3) * kBox + r * 128 + ((((uint32_t)j & 7u) ^ (r & 7)) << 4) + 2 * c0;
      *reinterpret_cast<__nv_bfloat162*>(dst + at) = v;
      if (res != nullptr) {
        const float2 f = __bfloat1622float2(v);
        *reinterpret_cast<__nv_bfloat162*>(res + at) = __floats2bfloat162_rn(x0 - f.x, x1 - f.y);
      }
    }
  }
}

// -- warp specialisation (the forward and the backward) -----------------------

// ring depth of the backward's streamed tiles
template <int DH>
__host__ __device__ constexpr int bwd_stages() {
  return 3;
}
constexpr int kMaxStages = 5;  // stages the ring area (Ring, kRingBytes) has room for
// consumer warpgroups of a forward CTA: two, sharing each streamed key/value
// tile
template <int DH>
__host__ __device__ constexpr int fwd_consumers() {
  return 2;
}
// consumer warpgroups of a dQ CTA: two at Dh 64, sharing each streamed tile;
// one at Dh 128
template <int DH>
__host__ __device__ constexpr int dq_consumers() {
  return DH == 64 ? 2 : 1;
}
// the dK/dV kernel: at Dh 64 two consumer warpgroups of 64 keys each share
// each streamed tile; at Dh 128 one, whose dK and dV accumulators take 128
// registers a thread
template <int DH>
__host__ __device__ constexpr int dkdv_consumers() {
  return DH == 128 ? 1 : 2;
}
template <int DH>
__host__ __device__ constexpr int dkdv_keys() {  // keys a CTA owns
  return dkdv_consumers<DH>() * kBK;
}
// with two consumers: 128 x 24 + 256 x 240 = 384 x 168 registers
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// after the bf16 tiles of a CTA: the mbarriers (the CTA's own tiles, then
// `full` and `empty` of each ring stage), then each stage's row data: the
// query rows' lse * log2(e) and delta (dK/dV) and the streamed rows' segment
// ids (flash), 64 words each
struct Ring {
  uint64_t* own;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* own_free;  // the forward: the consumers are done with their own tiles
  uint8_t* rows;
  __device__ __forceinline__ float* lse2(int stage) const {
    return reinterpret_cast<float*>(rows) + stage * 192;
  }
  __device__ __forceinline__ float* delta(int stage) const { return lse2(stage) + 64; }
  __device__ __forceinline__ int* seg(int stage) const {
    return reinterpret_cast<int*>(lse2(stage) + 128);
  }
  // the forward's streamed keys' segment ids: up to 192 a stage
  __device__ __forceinline__ int* kv_seg(int stage) const {
    return reinterpret_cast<int*>(lse2(stage));
  }
};

constexpr size_t kRingBytes = 128 + (size_t)kMaxStages * 192 * 4;

__device__ __forceinline__ Ring carve_ring(uint8_t* p) {
  Ring r;
  r.own = reinterpret_cast<uint64_t*>(p);
  r.full = r.own + 1;
  r.empty = r.full + kMaxStages;
  r.own_free = r.empty + kMaxStages;
  r.rows = p + 128;
  return r;
}

// thread 0: the barriers' arrival counts (the producer warp's 32 lanes fill
// a stage, each of the consumers' warps empties it)
__device__ __forceinline__ void ring_init(const Ring& r, int consumers, int stages) {
  mbar_init(r.own, 1);
  mbar_init(r.own_free, 4 * consumers);
  for (int s = 0; s < stages; ++s) {
    mbar_init(r.full + s, 32);
    mbar_init(r.empty + s, 4 * consumers);
  }
  mbar_fence_init();
}

// the warpgroup and the warp within it, broadcast from lane 0 so that the
// compiler sees them uniform across each warp (its wgmma pipelining and
// setmaxnreg's register budgets hold only on paths it can prove convergent)
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x / kWG), 0);
}
__device__ __forceinline__ int warp_in_group() {
  return __shfl_sync(0xffffffffu, (int)((threadIdx.x / 32) % 4), 0);
}

// a consumer warp is done with a stage (its shared-memory reads and the
// products that read the stage's tiles)
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// bytes of dynamic shared memory of a CTA: `own` 64-row tiles (the forward's
// Q, the backward's two a consumer) and 2 `stages` streamed ones
template <int DH>
__host__ __device__ constexpr size_t ring_smem_bytes(int own, int stages) {
  return 1024 + (size_t)(own + 2 * stages) * (DH / 64) * kBox + kRingBytes;
}

// the four flags of one Philox call (its words below the threshold) as bits 0-3
__device__ __forceinline__ uint32_t keep4(uint32_t bh, int row, int group, const AttnArgs& a) {
  const uint4 w = philox4x32_10(make_uint4(bh, (uint32_t)row, (uint32_t)group, 0u), a.seed_lo,
                                a.seed_hi);
  return (uint32_t)(w.x < a.threshold) | ((uint32_t)(w.y < a.threshold) << 1) |
         ((uint32_t)(w.z < a.threshold) << 2) | ((uint32_t)(w.w < a.threshold) << 3);
}

// The dropout flags of a thread's fragment of a (query, key) tile, bit
// 4 j + 2 i + e for (query row + 8 i, key col0 + 8 j + c0 + e): lanes l and
// l ^ 1 hold the two halves of each Philox call's four columns, so each
// computes one call of each pair and hands the other half over.
__device__ __forceinline__ uint32_t keep_bits_q(uint32_t bh, int row, int col0, int lane,
                                                const AttnArgs& a) {
  const int half = lane & 1, g_off = (lane & 3) >> 1;
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const int j_mine = 2 * jp + half, j_other = 2 * jp + 1 - half;
      const uint32_t b4 = keep4(bh, row + 8 * i, col0 / 4 + 2 * j_mine + g_off, a);
      const uint32_t recv = __shfl_xor_sync(0xffffffffu, (b4 >> (2 - 2 * half)) & 3u, 1);
      bits |= ((b4 >> (2 * half)) & 3u) << (4 * j_mine + 2 * i);
      bits |= recv << (4 * j_other + 2 * i);
    }
  }
  return bits;
}

// The same for the transposed tile of dK/dV (rows keys, columns queries):
// bit 4 j + 2 i + e for (key key4 + (lane / 4) % 4 + 8 i, query q0 + 8 j +
// c0 + e), key4 the thread's first key rounded down to 4.  The four lanes
// 16 h + 4 a + b (a = 0..3) hold the four keys of each call, so lane a
// computes the calls of its element pair a = 2 i + e for every j, and a
// 4 x 4 exchange gives each lane its key's word of the others.
__device__ __forceinline__ uint32_t keep_bits_kv(uint32_t bh, int q0, int key4, int lane,
                                                 const AttnArgs& a) {
  const int av = (lane >> 2) & 3, bv = lane & 3;
  uint32_t mine = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    mine |= keep4(bh, q0 + 8 * j + 2 * bv + (av & 1), key4 / 4 + 2 * (av >> 1), a) << (4 * j);
  uint32_t bits = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint32_t v = __shfl_sync(0xffffffffu, mine, (lane & 16) | (4 * s) | bv);
    bits |= ((v >> av) & 0x11111111u) << s;
  }
  return bits;
}

// delta of rows `row` and row + 8 (a quad's rows): each lane of the quad sums
// a quarter of the columns of dO * (O + residual) (flash: dO * O) in f32,
// then the quad sums the four; 0 for rows at or past T.  Columns at or past
// cols (a multiple of 32) count as zero.
template <bool FLASH, int DH>
__device__ __forceinline__ void quad_row_deltas(const bf16* o, const bf16* res, const bf16* dout,
                                                size_t base, int row, int T, int D, int lane,
                                                float (&delta)[2], int cols = DH) {
  constexpr int Q = DH / 4;
  const int c_begin = (lane & 3) * Q;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = 0.f;
    const int r = row + 8 * i;
    if (r < T && c_begin < cols) {
      const size_t at = base + (size_t)r * D + c_begin;
#pragma unroll
      for (int c = 0; c < Q; c += 8) {
        float ov[8], dv[8];
        load16(o + at + c, ov);
        load16(dout + at + c, dv);
        if (!FLASH) {
          float rv[8];
          load16(res + at + c, rv);
#pragma unroll
          for (int e = 0; e < 8; ++e) ov[e] += rv[e];
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) sum = fmaf(ov[e], dv[e], sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    delta[i] = sum;
  }
}

// the softmax weight of one element from its logit s and the row's lse2
// (lse * log2(e)): 1 / Tk on a packed row with no key, 0 where not visible
// or out of bounds.  Branch-free (the exp is taken and discarded where not
// visible): a branch between the products would keep the compiler from
// running them asynchronously.
__device__ __forceinline__ float softmax_p(float s, bool in_bounds, bool uniform, bool visible,
                                           float lse2, float scale2, float inv_t) {
  const float p = exp2f(fmaf(s, scale2, -lse2));
  return uniform ? (in_bounds ? inv_t : 0.f) : (visible ? p : 0.f);
}

// whether every (query, key) of the 64 x 64 tile of queries q0.. and keys
// k0.. is in bounds and visible (no segment ids, no packed row without
// keys): then its weights need no mask
template <bool FLASH>
__device__ __forceinline__ bool tile_unmasked(const AttnArgs& a, const KeyRange& keys, bool seg,
                                              int q0, int k0, int bk = kBK) {
  if (seg || keys.uniform || q0 + kBQ > a.Tq || k0 + bk > a.Tk) return false;
  if (a.causal) return k0 + bk - 1 <= q0;  // the tile's last key against its first query
  return FLASH || k0 + bk <= keys.len;
}

// -- the forward ----------------------------------------------------------------

// keys a streamed tile of the forward: 128 at Dh 64 (a 64 x 128 score tile a
// consumer), 64 at Dh 128, whose O accumulator takes the registers
template <int DH>
__host__ __device__ constexpr int fwd_bn() {
  return DH == 64 ? 128 : 64;
}
// ring stages: a consumer holds two (the tile of its S and the one of its
// P V), the rest are in flight; as many as shared memory holds beside the
// query and output tiles
template <int DH>
__host__ __device__ constexpr int fwd_stages() {
  return DH == 64 ? 4 : 3;
}

// 2^x in one MUFU.EX2 instruction (subnormal results flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the dropout flags of a thread's fragment of a 64 x BN tile: bit idx for
// element idx (keep_bits_q of each 64-key half)
template <int BN>
__device__ __forceinline__ uint64_t fwd_keep_bits(uint32_t bh, int row, int k0, int lane,
                                                  const AttnArgs& a) {
  uint64_t bits = keep_bits_q(bh, row, k0, lane, a);
  if constexpr (BN == 128) bits |= (uint64_t)keep_bits_q(bh, row, k0 + 64, lane, a) << 32;
  return bits;
}

// One step of the online softmax over a consumer's 64 x BN score tile s
// (query rows qrow + 8 i, keys k0..; element 4 j + 2 i + e at key k0 + 8 j +
// c0 + e): the logits in log2 units, x = S * scale * log2(e), through the
// mask unless the whole tile is visible (packed: a masked logit is -1e9 in
// natural units; flash: the mask value is added; a key past Tk is no key at
// all); the rows' running max m and sum l updated, alpha[i] the factor that
// rescales row i's accumulator; s left holding the unnormalised weights
// exp2(x - m), zero where dropout drops them (the sum counts them: the kept
// weights are scaled by inv_keep / l at the end).  An unmasked tile keeps
// the raw scores when scale > 0: their max times scale * log2(e) is the
// logits' max (rounding is monotone) and each exponent one fma.
template <bool FLASH, bool DROPOUT, int BN>
__device__ __forceinline__ void softmax_step(float (&s)[BN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool unmasked, uint64_t keep,
                                             const AttnArgs& a, const KeyRange& keys, bool seg,
                                             const int (&qseg)[2], const int* kvseg, int qrow,
                                             int k0, int c0) {
  constexpr int NJ = BN / 8;  // the thread's column pairs a row
  const float scale2 = a.scale * kLog2e;
  const bool fold = unmasked & (scale2 > 0.f);
  const float k = fold ? scale2 : 1.f;
  if (!fold) {
    if (unmasked) {
#pragma unroll
      for (int idx = 0; idx < BN / 2; ++idx) s[idx] *= scale2;
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = qrow + 8 * i;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * jj + c0 + e, col = k0 + c, idx = 4 * jj + 2 * i + e;
            const bool visible =
                is_visible<FLASH>(a, keys, row, col) & ((!seg) | (qseg[i] == kvseg[c]));
            const float x = s[idx] * scale2;
            const float masked = FLASH ? x + kFlashMask : kMasked * kLog2e;
            s[idx] = col >= a.Tk ? -INFINITY : (visible ? x : masked);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};  // four chains, not one
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      mx[jj & 3] = fmaxf(mx[jj & 3], fmaxf(s[4 * jj + 2 * i], s[4 * jj + 2 * i + 1]));
    float tile_max = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3])) * k;
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    // every visited tile holds key k0 < Tk, so m_new is finite
    const float m_new = fmaxf(m[i], tile_max);
    alpha[i] = ex2(m[i] - m_new);
    float part[4] = {0.f, 0.f, 0.f, 0.f};  // four partial sums, not a chain
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * jj + 2 * i + e;
        const float p = ex2(fmaf(s[idx], k, -m_new));
        part[(2 * jj + e) & 3] += p;
        s[idx] = (DROPOUT && !((keep >> idx) & 1u)) ? 0.f : p;
      }
    }
    float row_sum = (part[0] + part[1]) + (part[2] + part[3]);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
    l[i] = l[i] * alpha[i] + row_sum;
    m[i] = m_new;
  }
}

// one work item of the forward: the query tile (C * 64 rows from q0) of one
// head.  Causal: the query tile is the slowest index and the last query
// tiles, which visit the most keys, come first.  Otherwise every query tile
// of a head has the same work, and a head's items run together, sharing its
// keys and values in L2.
struct FwdItem {
  int q0, b, h;
  uint32_t bh;  // b * H + h
};

// the k-th work item of this CTA: CTA i takes items i, 2 G - 1 - i, 2 G + i,
// ... (G CTAs), so that over the heaviest-first order every CTA's items add
// up to about the same work; -1 past the last item.  In a cluster launch
// (CL) i and G count clusters, so that a cluster's CTAs take the same items.
template <bool CL = false>
__device__ __forceinline__ int fwd_work(int k, int items) {
  const int size = CL ? cluster_size() : 1;
  const int i = (int)blockIdx.x / size, G = (int)gridDim.x / size;
  const int w = k * G + ((k & 1) ? G - 1 - i : i);
  return w < items ? w : -1;
}

template <int C>
__device__ __forceinline__ FwdItem fwd_item(int w, int n_q, int heads, const AttnArgs& a) {
  int rank, bh;
  if (a.causal) {
    rank = w / heads;
    bh = w - rank * heads;
  } else {
    bh = w / n_q;
    rank = w - bh * n_q;
  }
  FwdItem it;
  it.q0 = (a.causal ? n_q - 1 - rank : rank) * C * kBQ;
  it.b = bh / a.H;
  it.h = bh - it.b * a.H;
  it.bh = (uint32_t)bh;
  return it;
}

// whether O leaves through shared memory and TMA stores: not in a cluster
// launch, whose exchange area takes that shared memory
template <int DH, bool CL>
__host__ __device__ constexpr bool fwd_stages_o() {
  return !CL;
}

// RES: also write O's rounding residual (the packed forward under grad).
// Persistent, one CTA an SM taking its items in turn (fwd_work): the
// producer loads the next item's query tiles as soon as the consumers' last
// S products have read this item's, and keeps the ring going across items,
// so an item's first loads and its epilogue overlap its neighbours' work.
// CL (K4 past Dh 256, DH = 128): a cluster launch, the CTA's 128 columns
// from 128 * its rank, each S tile summed across the cluster (ClusterSum).
template <int DH, bool FLASH, bool DROPOUT, bool RES, bool CL = false>
__global__ void __launch_bounds__((1 + fwd_consumers<DH>()) * kWG, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
           const __grid_constant__ CUtensorMap tres, bf16* __restrict__ o,
           float* __restrict__ lse, AttnArgs a, int B) {
  constexpr uint32_t TILE = DH / 64 * kBox;  // 64 rows
  constexpr int C = fwd_consumers<DH>();
  constexpr int BN = fwd_bn<DH>();
  constexpr uint32_t KVT = BN / 64 * TILE;   // a streamed key (or value) tile
  constexpr int STAGES = fwd_stages<DH>();
  constexpr bool STAGE_O = fwd_stages_o<DH, CL>();
  constexpr uint32_t STAGED = STAGE_O ? C * TILE : 0;
  static_assert(!CL || (DH == kSliceCols && BN == 64 && FLASH && !DROPOUT && !RES),
                "a cluster launch: K4's 128-column slices");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);  // the item's query rows: one tile a consumer
  uint8_t* Os = Qs + C * TILE;        // O on its way out: one tile a consumer
  uint8_t* Rs = Os + STAGED;          // O's residual on its way out
  uint8_t* Ks = Rs + STAGED;          // STAGES stages
  uint8_t* Vs = Ks + STAGES * KVT;
  uint8_t* xch = Vs + STAGES * KVT;   // CL: the consumers' warps' exchange area
  const Ring ring = carve_ring(xch + (CL ? xch_bytes<BN / 2>(4 * C, cluster_size()) : 0));

  const int n_q = (a.Tq + C * kBQ - 1) / (C * kBQ), heads = B * a.H, items = n_q * heads;
  const bool seg = FLASH && a.q_seg != nullptr;
  const int group = warpgroup_index(), lane = threadIdx.x & 31;
  // CL: the CTA's columns of Q, K, V and O (the others' are its peers')
  const int col0 = CL ? kSliceCols * cluster_rank() : 0;
  if (threadIdx.x == 0) {
    ring_init(ring, C, STAGES);
    if constexpr (CL) xch_init<BN / 2>(xch, 4 * C, cluster_size());
  }
  __syncthreads();
  if constexpr (CL) cluster_sync();  // every CTA's barriers exist before a peer arrives

  if (group == 0) {  // the producer warpgroup; its first warp issues every load
    regs_dec<kProducerRegs>();
    if (warp_in_group() == 0) {
      int stage = 0, phase = 0;
      for (int n = 0, w; (w = fwd_work<CL>(n, items)) >= 0; ++n) {
        const FwdItem it = fwd_item<C>(w, n_q, heads, a);
        const int own = min(C, (a.Tq - it.q0 + kBQ - 1) / kBQ);  // query tiles within T
        // every key tile a row of the item visits (its last query tile's rows see the most)
        const int n_tiles =
            (key_range<FLASH>(a, it.b, it.q0 + (own - 1) * kBQ).kv_end + BN - 1) / BN;
        if (n > 0) mbar_wait(ring.own_free, (n - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(ring.own, own * TILE);
          for (int q = 0; q < own; ++q)
            tma_tile<FLASH, DH>(Qs + q * TILE, &tq, it.q0 + q * kBQ, it.h, it.b, ring.own, col0);
        }
        for (int j = 0; j < n_tiles; ++j) {
          mbar_wait(ring.empty + stage, phase ^ 1);
          if (lane == 0) {  // the loads first: they start before the segment ids' reads
            mbar_expect_tx_only(ring.full + stage, 2 * KVT);
#pragma unroll
            for (int r = 0; r < BN / 64; ++r) {
              tma_tile<FLASH, DH>(Ks + stage * KVT + r * TILE, &tk, j * BN + 64 * r, it.h, it.b,
                                  ring.full + stage, col0);
              tma_tile<FLASH, DH>(Vs + stage * KVT + r * TILE, &tv, j * BN + 64 * r, it.h, it.b,
                                  ring.full + stage, col0);
            }
          }
          if (seg) {
            for (int c = lane; c < BN; c += 32) {
              const int pos = j * BN + c;
              ring.kv_seg(stage)[c] = pos < a.Tk ? a.kv_seg[(size_t)it.b * a.Tk + pos] : 1;
            }
          }
          mbar_arrive(ring.full + stage);  // each lane, after its segment ids
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // a consumer warpgroup: 64 query rows of each item
    regs_inc<kConsumerRegs>();
    const int wg = group - 1, t = threadIdx.x & (kWG - 1);
    const int r0 = 16 * (t >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
    const uint8_t* Qw = Qs + wg * TILE;
    // CL: S summed across the cluster, warp by warp (unused otherwise)
    ClusterSum<BN / 2> cluster_s(xch, 4 * C, CL ? 4 * wg + warp_in_group() : 0);
    // the consumers issue their products in turns (named barrier 3 + wg), so
    // that one's softmax runs under the other's products; each takes n_tiles
    // + 1 turns an item, consumer 0 first
    const auto my_turn = [&] { pair_sync(3 + wg); };
    const auto your_turn = [&] { pair_arrive(3 + (wg ^ 1)); };
    if (wg == 1) your_turn();
    int base = 0;  // the item's first tile in the ring's sequence
    for (int n = 0, w; (w = fwd_work<CL>(n, items)) >= 0; ++n) {
      const FwdItem it = fwd_item<C>(w, n_q, heads, a);
      const int own = min(C, (a.Tq - it.q0 + kBQ - 1) / kBQ);
      const int n_tiles =
          (key_range<FLASH>(a, it.b, it.q0 + (own - 1) * kBQ).kv_end + BN - 1) / BN;
      const int qw = it.q0 + wg * kBQ, qrow = qw + r0;
      const KeyRange keys = key_range<FLASH>(a, it.b, qw);
      const int my_tiles = wg < own ? (keys.kv_end + BN - 1) / BN : 0;
      int qseg[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = qrow + 8 * i;
        qseg[i] = (seg && row < a.Tq) ? a.q_seg[(size_t)it.b * a.Tq + row] : 1;
      }
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
      float acc[DH / 2], s[BN / 2];
      uint32_t pa[BN / 16][4];  // the previous tile's weights, bf16: P V's A operand
      zero(acc);
      int j = 0;
      // every consumer sees each item's query tiles arrive, so that its wait
      // for the next item's cannot pass on this one's phase
      mbar_wait(ring.own, n & 1);
      if (my_tiles > 0) {
        const int stage0 = base % STAGES;
        mbar_wait(ring.full + stage0, (base / STAGES) & 1);  // tile 0: S and its softmax
        my_turn();
        wgmma_fence();
        score_tile<DH, BN>(s, Qw, Ks + stage0 * KVT);
        wgmma_commit();
        your_turn();
        uint64_t keep = DROPOUT ? fwd_keep_bits<BN>(it.bh, qrow, 0, lane, a) : 0u;
        wgmma_wait<0>();
        fence_regs(s);
        if (my_tiles == 1) release(ring.own_free, lane);  // Q is read
        if constexpr (CL) cluster_s(s, lane);
        softmax_step<FLASH, DROPOUT, BN>(s, m, l, alpha,
                                         tile_unmasked<FLASH>(a, keys, seg, qw, 0, BN), keep,
                                         a, keys, seg, qseg, ring.kv_seg(stage0), qrow, 0, c0);
        to_a_operand(s, pa);  // the unnormalised weights rounded to bf16
        // every later tile: its S and the previous tile's P V issued
        // together, its flags and softmax while P V runs
        for (j = 1; j < my_tiles; ++j) {
          const int stage = (base + j) % STAGES, prev = (base + j - 1) % STAGES, k0 = j * BN;
          mbar_wait(ring.full + stage, ((base + j) / STAGES) & 1);
          my_turn();
          wgmma_fence();
          score_tile<DH, BN>(s, Qw, Ks + stage * KVT);
          wgmma_commit();
          accumulate<DH>(acc, pa, Vs + prev * KVT);
          wgmma_commit();
          your_turn();
          keep = DROPOUT ? fwd_keep_bits<BN>(it.bh, qrow, k0, lane, a) : 0u;
          fence_value(keep);  // the flags drawn while S runs
          wgmma_wait<1>();  // S is done, P V may still run
          fence_regs(s);
          if (j == my_tiles - 1) release(ring.own_free, lane);  // Q is read
          if constexpr (CL) cluster_s(s, lane);  // the partials of the cluster's columns
          softmax_step<FLASH, DROPOUT, BN>(s, m, l, alpha,
                                           tile_unmasked<FLASH>(a, keys, seg, qw, k0, BN), keep,
                                           a, keys, seg, qseg, ring.kv_seg(stage), qrow, k0, c0);
          // the softmax runs while P V does: the compiler may not sink it below the wait
          fence_regs(s);
          fence_regs(m);
          fence_regs(l);
          fence_regs(alpha);
          wgmma_wait<0>();  // P V is done: the previous tile's stage is free
          fence_regs(acc);
          fence_operand(pa);
          release(ring.empty + prev, lane);
#pragma unroll
          for (int jj = 0; jj < DH / 8; ++jj) {
            acc[4 * jj] *= alpha[0];
            acc[4 * jj + 1] *= alpha[0];
            acc[4 * jj + 2] *= alpha[1];
            acc[4 * jj + 3] *= alpha[1];
          }
          to_a_operand(s, pa);
        }
        const int last = (base + my_tiles - 1) % STAGES;
        my_turn();
        wgmma_fence();
        accumulate<DH>(acc, pa, Vs + last * KVT);
        wgmma_commit();
        your_turn();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_operand(pa);
        release(ring.empty + last, lane);
      } else {
        release(ring.own_free, lane);
        my_turn();
        your_turn();
      }
      for (; j < n_tiles; ++j) {  // key tiles no row of this warpgroup visits
        const int stage = (base + j) % STAGES;
        mbar_wait(ring.full + stage, ((base + j) / STAGES) & 1);
        my_turn();
        your_turn();
        release(ring.empty + stage, lane);
      }
      base += n_tiles;
      if (my_tiles > 0) {
        float inv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // flash: a visible logit is far above half the mask value, and a
          // row that saw only masked keys has m near the mask value; a packed
          // masked logit is -1e9, so every packed row counts as visible
          const bool any_visible = !FLASH || m[i] > 0.5f * kFlashMask;
          inv[i] = any_visible ? (DROPOUT ? a.inv_keep : 1.f) / l[i] : 0.f;
          const int row = qrow + 8 * i;
          // (CL: every CTA holds the same m and l; the first writes them)
          if (lse != nullptr && (lane & 3) == 0 && row < a.Tq && col0 == 0)
            lse[(size_t)it.bh * a.Tq + row] = any_visible ? m[i] * kLn2 + logf(l[i]) : INFINITY;
        }
        if constexpr (STAGE_O) {
          // O (and its residual) through shared memory and TMA stores, which
          // write no row past T; the previous item's stores must have read
          // the staging tiles first
          uint8_t* Ow = Os + wg * TILE;
          uint8_t* Rw = Rs + wg * TILE;
          if (t == 0) bulk_wait_read();
          warpgroup_sync(1 + wg);
          stage_rows<DH>(Ow, RES ? Rw : nullptr, acc, r0, c0, inv);
          fence_async_smem();
          warpgroup_sync(1 + wg);
          if (t == 0) {
#pragma unroll
            for (int g = 0; g < DH / 64; ++g) {
              tma_store_box<FLASH>(&to, Ow + g * kBox, 64 * g, qw, it.h, it.b);
              if (RES) tma_store_box<FLASH>(&tres, Rw + g * kBox, 64 * g, qw, it.h, it.b);
            }
            bulk_commit();
          }
        } else {  // CL: the CTA's columns of rows a.dh elements apart
          store_rows<DH>(o + ((size_t)it.bh * a.Tq) * a.dh + col0, acc, qw, r0, c0, a.Tq, a.dh,
                         inv, a.dh - col0);
        }
      }
    }
    if (wg == 0) my_turn();  // consumer 1's first hand-over
    // the staging tiles live until the stores have read them
    if (STAGE_O && t == 0) bulk_wait_read();
  }
  if constexpr (CL) cluster_sync();  // no CTA leaves while a peer reads its slots
}

// -- the backward -------------------------------------------------------------

// dS * scale of one element from its weight p, its dPd, the row's delta and
// its dropout flag
template <bool DROPOUT>
__device__ __forceinline__ float grad_ds(float p, float dpd, float delta, bool kept,
                                         const AttnArgs& a) {
  if (DROPOUT) dpd = kept ? dpd * a.inv_keep : 0.f;
  return p * (dpd - delta) * a.scale;
}

// bf16(Pd) of a 64 x 64 tile of weights p as four A operands: p through
// the dropout flags (kept: p / keep, dropped: 0); p itself stays
template <bool DROPOUT>
__device__ __forceinline__ void pd_operand(const float (&p)[32], uint32_t keep,
                                           const AttnArgs& a, uint32_t (&pd)[4][4]) {
  float v[32];
#pragma unroll
  for (int idx = 0; idx < 32; ++idx)
    v[idx] = !DROPOUT ? p[idx] : (((keep >> idx) & 1u) ? p[idx] * a.inv_keep : 0.f);
  to_a_operand(v, pd);
}

// the shared memory of a backward CTA's exchange area (CL: its consumers'
// warps' ClusterSum of 32 floats, two channels a warp: S and dPd)
constexpr int kBwdChannels = 2;
template <int DH, bool CL>
__host__ __device__ constexpr size_t bwd_xch_bytes(int consumers, int c) {
  return CL ? xch_bytes<32>(kBwdChannels * 4 * consumers, c) : 0;
}

// CL (K4 past Dh 256, DH = 128): a cluster launch, the CTA's 128 columns
// from 128 * its rank; S, dPd and the rows' delta summed across the cluster
template <int DH, bool FLASH, bool DROPOUT, bool CL = false>
__global__ void __launch_bounds__((1 + dq_consumers<DH>()) * kWG, 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
              const bf16* __restrict__ o, const bf16* __restrict__ res,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta_out, bf16* __restrict__ dq, AttnArgs a) {
  constexpr uint32_t TILE = DH / 64 * kBox;
  constexpr int C = dq_consumers<DH>();
  constexpr int STAGES = bwd_stages<DH>();
  static_assert(!CL || (DH == kSliceCols && C == 1 && FLASH && !DROPOUT),
                "a cluster launch: K4's 128-column slices");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);  // the CTA's query rows: one tile a consumer
  uint8_t* dOs = Qs + C * TILE;
  uint8_t* Ks = dOs + C * TILE;       // STAGES stages
  uint8_t* Vs = Ks + STAGES * TILE;
  uint8_t* xch = Vs + STAGES * TILE;  // CL: the consumers' warps' exchange area
  const int csize = CL ? cluster_size() : 1;
  const Ring ring = carve_ring(xch + bwd_xch_bytes<DH, CL>(C, csize));

  const int col0 = CL ? kSliceCols * cluster_rank() : 0;  // CL: the CTA's columns
  const int q0 = (int)(blockIdx.x / csize) * C * kBQ, h = blockIdx.y, b = blockIdx.z;
  const uint32_t bh = (uint32_t)(b * a.H + h);
  const bool seg = FLASH && a.q_seg != nullptr;
  // every key tile a row of the CTA visits (the last tile's rows see the most)
  const int n_tiles = (key_range<FLASH>(a, b, q0 + (C - 1) * kBQ).kv_end + kBK - 1) / kBK;
  const int group = warpgroup_index(), lane = threadIdx.x & 31;
  const float inv_t = 1.f / (float)a.Tk;
  if (threadIdx.x == 0) {
    ring_init(ring, C, STAGES);
    if constexpr (CL) xch_init<32>(xch, kBwdChannels * 4 * C, csize);
  }
  __syncthreads();
  if constexpr (CL) cluster_sync();  // every CTA's barriers exist before a peer arrives

  if (group == 0) {  // the producer warpgroup; its first warp issues every load
    regs_dec<kProducerRegs>();
    if (warp_in_group() == 0) {
      if (lane == 0) {
        const int own = min(C, (a.Tq - q0 + kBQ - 1) / kBQ);
        mbar_expect_tx(ring.own, own * 2 * TILE);
        for (int w = 0; w < own; ++w) {
          tma_tile<FLASH, DH>(Qs + w * TILE, &tq, q0 + w * kBQ, h, b, ring.own, col0);
          tma_tile<FLASH, DH>(dOs + w * TILE, &tdo, q0 + w * kBQ, h, b, ring.own, col0);
        }
      }
      int stage = 0, phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        if (j >= STAGES) mbar_wait(ring.empty + stage, phase ^ 1);
        if (seg) {
          for (int c = lane; c < kBK; c += 32) {
            const int pos = j * kBK + c;
            ring.seg(stage)[c] = pos < a.Tk ? a.kv_seg[(size_t)b * a.Tk + pos] : 1;
          }
        }
        if (lane == 0) {
          mbar_expect_tx(ring.full + stage, 2 * TILE);
          tma_tile<FLASH, DH>(Ks + stage * TILE, &tk, j * kBK, h, b, ring.full + stage, col0);
          tma_tile<FLASH, DH>(Vs + stage * TILE, &tv, j * kBK, h, b, ring.full + stage, col0);
        } else {
          mbar_arrive(ring.full + stage);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // a consumer warpgroup: 64 query rows
    if constexpr (C > 1) regs_inc<kConsumerRegs>();
    const int wg = group - 1, t = threadIdx.x & (kWG - 1);
    const int r0 = 16 * (t >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
    const int qw = q0 + wg * kBQ;
    const KeyRange keys = key_range<FLASH>(a, b, qw);
    const int my_tiles = qw < a.Tq ? (keys.kv_end + kBK - 1) / kBK : 0;
    // CL: the CTA's columns of rows a.dh elements apart
    const int D = CL ? a.dh : row_stride<FLASH, DH>(a.H);
    const int cols = CL ? a.dh - col0 : DH;
    const size_t q_base =
        CL ? (size_t)bh * a.Tq * a.dh + col0 : head_offset<FLASH, DH>(b, h, a.H, a.Tq);
    const float scale2 = a.scale * kLog2e;
    // CL: S, dPd and the deltas summed across the cluster, warp by warp
    ClusterSum<32, kBwdChannels> cluster(xch, 4 * C, CL ? 4 * wg + warp_in_group() : 0);

    // the rows' delta (written once for the dK/dV kernel), lse and segment
    float delta[2], lse2[2];
    int qseg[2];
    quad_row_deltas<FLASH, DH>(o, res, dout, q_base, qw + r0, a.Tq, D, lane, delta, cols);
    if constexpr (CL) {
      float both[4] = {delta[0], delta[1], 0.f, 0.f};
      cluster(both, lane);
      delta[0] = both[0];
      delta[1] = both[1];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = qw + r0 + 8 * i;
      const bool in_rows = row < a.Tq;
      if (in_rows && (lane & 3) == 0 && col0 == 0) delta_out[(size_t)bh * a.Tq + row] = delta[i];
      lse2[i] = in_rows ? lse[(size_t)bh * a.Tq + row] * kLog2e : 0.f;
      qseg[i] = (seg && in_rows) ? a.q_seg[(size_t)b * a.Tq + row] : 1;
    }

    float acc[DH / 2], s[32], dp[32];
    uint32_t dsa[4][4];
    zero(acc);
    mbar_wait(ring.own, 0);
    int stage = 0, phase = 0, prev = 0;
    bool pending = false;  // the previous tile's dQ product may still run
    for (int j = 0; j < n_tiles; ++j) {
      const int k0 = j * kBK;
      mbar_wait(ring.full + stage, phase);
      if (j < my_tiles) {
        const uint8_t* Kt = Ks + stage * TILE;
        wgmma_fence();
        score_tile<DH, 64>(s, Qs + wg * TILE, Kt);
        wgmma_commit();
        if (pending) {  // the previous dQ product is done: its stage is free
          wgmma_wait<1>();
          fence_operand(dsa);
          fence_regs(acc);
          release(ring.empty + prev, lane);
        }
        score_tile<DH, 64>(dp, dOs + wg * TILE, Vs + stage * TILE);
        wgmma_commit();
        const uint32_t keep = DROPOUT ? keep_bits_q(bh, qw + r0, k0, lane, a) : 0u;
        wgmma_wait<1>();  // S is done, dPd may still run
        fence_regs(s);
        if constexpr (CL) {
          // the partials of the cluster's columns: S's exchange pushed while
          // dPd runs, then dPd's, and the two reduced and gathered together
          cluster.push<0>(s, lane);
          wgmma_wait<0>();
          fence_regs(dp);
          cluster.push<1>(dp, lane);
          cluster.reduce<0, 32>(lane);
          cluster.reduce<1, 32>(lane);
          cluster.gather<0>(s, lane);
        }
        if (tile_unmasked<FLASH>(a, keys, seg, qw, k0)) {
#pragma unroll
          for (int idx = 0; idx < 32; ++idx)
            s[idx] = exp2f(fmaf(s[idx], scale2, -lse2[(idx >> 1) & 1]));
        } else {
          const int* kvseg = ring.seg(stage);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = qw + r0 + 8 * i;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = 8 * jj + c0 + e, col = k0 + c, idx = 4 * jj + 2 * i + e;
                const bool in_bounds = (row < a.Tq) & (col < a.Tk);
                const bool visible = in_bounds & is_visible<FLASH>(a, keys, row, col) &
                                     ((!seg) | (qseg[i] == kvseg[c]));
                s[idx] = softmax_p(s[idx], in_bounds, keys.uniform, visible, lse2[i], scale2,
                                   inv_t);
              }
            }
          }
        }
        if constexpr (CL) {
          cluster.gather<1>(dp, lane);
        } else {
          wgmma_wait<0>();
          fence_regs(dp);
        }
#pragma unroll
        for (int idx = 0; idx < 32; ++idx)
          s[idx] = grad_ds<DROPOUT>(s[idx], dp[idx], delta[(idx >> 1) & 1], (keep >> idx) & 1u,
                                    a);
        to_a_operand(s, dsa);  // bf16(dS * scale)
        wgmma_fence();
        accumulate<DH>(acc, dsa, Kt);
        wgmma_commit();
        pending = true;
        prev = stage;
      } else {  // no row of this warpgroup visits the tile
        if (pending) {
          wgmma_wait<0>();
          fence_operand(dsa);
          fence_regs(acc);
          release(ring.empty + prev, lane);
          pending = false;
        }
        release(ring.empty + stage, lane);
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operand(dsa);
    fence_regs(acc);
    const float one[2] = {1.f, 1.f};
    store_rows<DH>(dq + q_base, acc, qw, r0, c0, a.Tq, D, one, cols);
  }
  if constexpr (CL) cluster_sync();  // no CTA leaves while a peer reads its slots
}

// The weights of a transposed (key, query) tile in place: s from S^T to p,
// rows the keys kw + r0 + 8 i, columns the queries q0 + 8 j + c0 + e; lse_t
// the query rows' lse * log2(e), qseg their segment ids (flash), kvseg the
// keys'
template <bool FLASH>
__device__ __forceinline__ void transposed_weights(float (&s)[32], const AttnArgs& a,
                                                   const KeyRange& keys, bool seg, int q0, int kw,
                                                   int r0, int c0, const float* lse_t,
                                                   const int* qseg, const int (&kvseg)[2],
                                                   float inv_t) {
  const float scale2 = a.scale * kLog2e;
  if (tile_unmasked<FLASH>(a, keys, seg, q0, kw)) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int idx = 4 * jj + v;
        s[idx] = exp2f(fmaf(s[idx], scale2, -lse_t[8 * jj + c0 + (v & 1)]));
      }
    }
  } else {
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int key = kw + r0 + 8 * ii;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = 8 * jj + c0 + e, row = q0 + qc, idx = 4 * jj + 2 * ii + e;
          const bool in_bounds = (row < a.Tq) & (key < a.Tk);
          const bool visible = in_bounds & is_visible<FLASH>(a, keys, row, key) &
                               ((!seg) | (qseg[qc] == kvseg[ii]));
          s[idx] = softmax_p(s[idx], in_bounds, keys.uniform, visible, lse_t[qc], scale2, inv_t);
        }
      }
    }
  }
}

// CL (K4 past Dh 256, DH = 128): a cluster launch, the CTA's 128 columns
// from 128 * its rank; S^T and dPd^T summed across the cluster
template <int DH, bool FLASH, bool DROPOUT, bool CL = false>
__global__ void __launch_bounds__((1 + dkdv_consumers<DH>()) * kWG, 1)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, AttnArgs a) {
  constexpr uint32_t TILE = DH / 64 * kBox;
  constexpr int C = dkdv_consumers<DH>();
  constexpr int NK = dkdv_keys<DH>() / kBK;  // the CTA's key tiles
  constexpr int STAGES = bwd_stages<DH>();
  static_assert(!CL || (DH == kSliceCols && C == 1 && FLASH && !DROPOUT),
                "a cluster launch: K4's 128-column slices");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);  // the CTA's keys: one tile a consumer
  uint8_t* Vs = Ks + NK * TILE;
  uint8_t* Qs = Vs + NK * TILE;       // STAGES stages
  uint8_t* dOs = Qs + STAGES * TILE;
  uint8_t* xch = dOs + STAGES * TILE;  // CL: the consumer's warps' exchange area
  const int csize = CL ? cluster_size() : 1;
  const Ring ring = carve_ring(xch + bwd_xch_bytes<DH, CL>(C, csize));

  const int col0 = CL ? kSliceCols * cluster_rank() : 0;  // CL: the CTA's columns
  const int k0 = (int)(blockIdx.x / csize) * NK * kBK, h = blockIdx.y, b = blockIdx.z;
  const uint32_t bh = (uint32_t)(b * a.H + h);
  const bool seg = FLASH && a.q_seg != nullptr;
  // the key lengths do not depend on the query tile; the causal start does
  const KeyRange keys = key_range<FLASH>(a, b, 0);
  // a key at or past kv_lengths[b] > 0 gets zero gradient
  const bool any_key = k0 < a.Tk && (keys.uniform || k0 < keys.len);
  const int q_begin = a.causal ? k0 : 0;  // earlier query tiles see none of these keys
  const int n_tiles = (any_key && q_begin < a.Tq) ? (a.Tq - q_begin + kBQ - 1) / kBQ : 0;
  const int group = warpgroup_index(), lane = threadIdx.x & 31;
  const float inv_t = 1.f / (float)a.Tk;
  if (threadIdx.x == 0) {
    ring_init(ring, C, STAGES);
    if constexpr (CL) xch_init<32>(xch, kBwdChannels * 4 * C, csize);
  }
  __syncthreads();
  if constexpr (CL) cluster_sync();  // every CTA's barriers exist before a peer arrives

  if (group == 0) {  // the producer warpgroup; its first warp issues every load
    regs_dec<kProducerRegs>();
    if (warp_in_group() == 0) {
      if (lane == 0 && n_tiles > 0) {
        const int own = min(NK, (a.Tk - k0 + kBK - 1) / kBK);
        mbar_expect_tx(ring.own, own * 2 * TILE);
        for (int w = 0; w < own; ++w) {
          tma_tile<FLASH, DH>(Ks + w * TILE, &tk, k0 + w * kBK, h, b, ring.own, col0);
          tma_tile<FLASH, DH>(Vs + w * TILE, &tv, k0 + w * kBK, h, b, ring.own, col0);
        }
      }
      int stage = 0, phase = 0;
      for (int i = 0; i < n_tiles; ++i) {
        const int q0 = q_begin + i * kBQ;
        if (i >= STAGES) mbar_wait(ring.empty + stage, phase ^ 1);
        for (int r = lane; r < kBQ; r += 32) {  // the query rows' lse and delta (the dQ kernel's)
          const int row = q0 + r;
          const bool in_rows = row < a.Tq;
          ring.lse2(stage)[r] = in_rows ? lse[(size_t)bh * a.Tq + row] * kLog2e : 0.f;
          ring.delta(stage)[r] = in_rows ? delta[(size_t)bh * a.Tq + row] : 0.f;
          if (seg) ring.seg(stage)[r] = in_rows ? a.q_seg[(size_t)b * a.Tq + row] : 1;
        }
        if (lane == 0) {
          mbar_expect_tx(ring.full + stage, 2 * TILE);
          tma_tile<FLASH, DH>(Qs + stage * TILE, &tq, q0, h, b, ring.full + stage, col0);
          tma_tile<FLASH, DH>(dOs + stage * TILE, &tdo, q0, h, b, ring.full + stage, col0);
        } else {
          mbar_arrive(ring.full + stage);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // a consumer warpgroup: 64 keys
    if constexpr (C > 1) regs_inc<kConsumerRegs>();
    const int wg = group - 1, t = threadIdx.x & (kWG - 1);
    const int r0 = 16 * (t >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
    const int kw = k0 + wg * kBK;
    const bool my_keys = kw < a.Tk && (keys.uniform || kw < keys.len);
    // CL: the CTA's columns of rows a.dh elements apart
    const int D = CL ? a.dh : row_stride<FLASH, DH>(a.H);
    const int cols = CL ? a.dh - col0 : DH;
    const size_t q_base = head_offset<FLASH, DH>(b, h, a.H, a.Tq);
    const size_t kv_base =
        CL ? (size_t)bh * a.Tk * a.dh + col0 : kv_offset<FLASH, DH>(q_base, b, h, a);
    // CL: S^T and dPd^T summed across the cluster, warp by warp
    ClusterSum<32, kBwdChannels> cluster(xch, 4 * C, CL ? 4 * wg + warp_in_group() : 0);
    int kvseg[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = kw + r0 + 8 * i;
      kvseg[i] = (seg && key < a.Tk) ? a.kv_seg[(size_t)b * a.Tk + key] : 1;
    }

    float acc_dk[DH / 2], acc_dv[DH / 2], s[32], dp[32];
    uint32_t pda[4][4], dsa[4][4];
    zero(acc_dk);
    zero(acc_dv);
    if (n_tiles > 0) mbar_wait(ring.own, 0);
    int stage = 0, phase = 0, prev = 0;
    bool pending = false;  // the previous tile's dV and dK products may still run
    for (int i = 0; i < n_tiles; ++i) {
      const int q0 = q_begin + i * kBQ;
      mbar_wait(ring.full + stage, phase);
      if (my_keys && (!a.causal || q0 + kBQ - 1 >= kw)) {
        const uint8_t* Qt = Qs + stage * TILE;
        const uint8_t* dOt = dOs + stage * TILE;
        // transposed tiles: rows are this warpgroup's keys, columns the query tile
        wgmma_fence();
        score_tile<DH, 64>(s, Ks + wg * TILE, Qt);
        wgmma_commit();
        if (pending) {  // the previous products are done: their stage is free
          wgmma_wait<1>();
          fence_operand(pda);
          fence_operand(dsa);
          fence_regs(acc_dv);
          fence_regs(acc_dk);
          release(ring.empty + prev, lane);
        }
        score_tile<DH, 64>(dp, Vs + wg * TILE, dOt);
        wgmma_commit();
        const uint32_t keep = DROPOUT ? keep_bits_kv(bh, q0, kw + (r0 & ~3), lane, a) : 0u;
        wgmma_wait<1>();  // S^T is done, dPd^T may still run
        fence_regs(s);
        if constexpr (CL) {
          // the partials of the cluster's columns, as in the dQ kernel; dPd^T
          // is summed before the dV product is issued (summed under it,
          // ptxas serialised the products: C7513) and before Pd^T is rounded
          // (its registers would be live across the exchange)
          cluster.push<0>(s, lane);
          wgmma_wait<0>();
          fence_regs(dp);
          cluster.push<1>(dp, lane);
          cluster.reduce<0, 32>(lane);
          cluster.reduce<1, 32>(lane);
          cluster.gather<0>(s, lane);
        }
        const float* lse_t = ring.lse2(stage);
        const float* delta_t = ring.delta(stage);
        transposed_weights<FLASH>(s, a, keys, seg, q0, kw, r0, c0, lse_t, ring.seg(stage), kvseg,
                                  inv_t);
        if constexpr (CL) cluster.gather<1>(dp, lane);
        // Pd^T to bf16 and its dV product first, running beside dPd^T
        pd_operand<DROPOUT>(s, keep, a, pda);  // bf16(Pd)^T; s keeps p for dS
        wgmma_fence();
        accumulate<DH>(acc_dv, pda, dOt);
        wgmma_commit();
        if constexpr (!CL) {
          wgmma_wait<1>();  // dPd^T is done, the dV product may still run
          fence_regs(dp);
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int idx = 4 * jj + v, qc = 8 * jj + c0 + (v & 1);
            dp[idx] = grad_ds<DROPOUT>(s[idx], dp[idx], delta_t[qc], (keep >> idx) & 1u, a);
          }
        }
        to_a_operand(dp, dsa);  // bf16(dS * scale)^T
        wgmma_fence();
        accumulate<DH>(acc_dk, dsa, Qt);
        wgmma_commit();
        pending = true;
        prev = stage;
      } else {  // none of this warpgroup's keys is visible to the tile
        if (pending) {
          wgmma_wait<0>();
          fence_operand(pda);
          fence_operand(dsa);
          fence_regs(acc_dv);
          fence_regs(acc_dk);
          release(ring.empty + prev, lane);
          pending = false;
        }
        release(ring.empty + stage, lane);
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operand(pda);
    fence_operand(dsa);
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    const float one[2] = {1.f, 1.f};
    store_rows<DH>(dk + kv_base, acc_dk, kw, r0, c0, a.Tk, D, one, cols);
    store_rows<DH>(dv + kv_base, acc_dv, kw, r0, c0, a.Tk, D, one, cols);
  }
  if constexpr (CL) cluster_sync();  // no CTA leaves while a peer reads its slots
}

// -- launches ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime so that the library
// needs no -lcuda; NULL where it is missing
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a bf16 tensor, packed (B, T, H*Dh) or flash (B, H, T, Dh), as a 4-D map of
// 64-row x 64-column boxes with 128-byte swizzle: packed (Dh, H, T, B),
// flash (Dh, T, H, B).  Rows past T read as zero.
template <bool FLASH>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int H, int T, int Dh) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t e = sizeof(bf16);
  const cuuint64_t dims_packed[4] = {(cuuint64_t)Dh, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t dims_flash[4] = {(cuuint64_t)Dh, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides_packed[3] = {Dh * e, (cuuint64_t)H * Dh * e, (cuuint64_t)T * H * Dh * e};
  const cuuint64_t strides_flash[3] = {Dh * e, (cuuint64_t)T * Dh * e, (cuuint64_t)H * T * Dh * e};
  const cuuint32_t box_packed[4] = {64, 1, 64, 1};
  const cuuint32_t box_flash[4] = {64, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
      FLASH ? dims_flash : dims_packed, FLASH ? strides_flash : strides_packed,
      FLASH ? box_flash : box_packed, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  configured = err == cudaSuccess;
  return err;
}

// `res`: NULL, or where the packed forward writes O's rounding residual
template <int DH, bool FLASH, bool DROPOUT>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* res,
                       float* lse, int B, const AttnArgs& a, cudaStream_t stream) {
  constexpr int C = fwd_consumers<DH>();
  // the query (and, staged, the output and residual) tiles, then the stages'
  // key and value tiles
  constexpr size_t smem = ring_smem_bytes<DH>(3 * C, fwd_stages<DH>() * fwd_bn<DH>() / 64);
  static_assert(smem <= 232448, "a CTA's shared memory");
  static bool configured = false, configured_res = false;
  cudaError_t err =
      res == nullptr ? allow_smem(fwd_kernel<DH, FLASH, DROPOUT, false>, smem, configured)
                     : allow_smem(fwd_kernel<DH, FLASH, DROPOUT, true>, smem, configured_res);
  CUtensorMap mq, mk, mv, mo, mres;
  if (err == cudaSuccess) err = make_map<FLASH>(&mq, q, B, a.H, a.Tq, DH);
  if (err == cudaSuccess) err = make_map<FLASH>(&mk, k, B, a.H, a.Tk, DH);
  if (err == cudaSuccess) err = make_map<FLASH>(&mv, v, B, a.H, a.Tk, DH);
  if (err == cudaSuccess) err = make_map<FLASH>(&mo, o, B, a.H, a.Tq, DH);
  if (err == cudaSuccess) err = make_map<FLASH>(&mres, res == nullptr ? o : res, B, a.H, a.Tq, DH);
  if (err != cudaSuccess) return err;
  // a work item a (query tile of C * 64 rows, head, batch row); one CTA an
  // SM, each taking items in turn
  const long long items = (long long)((a.Tq + C * kBQ - 1) / (C * kBQ)) * a.H * B;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const unsigned ctas = (unsigned)(items < sms ? items : sms);
  constexpr int threads = (1 + C) * kWG;
  bf16* out = static_cast<bf16*>(o);
  if (res != nullptr) {
    fwd_kernel<DH, FLASH, DROPOUT, true><<<ctas, threads, smem, stream>>>(mq, mk, mv, mo, mres,
                                                                         out, lse, a, B);
    return cudaGetLastError();
  }
  fwd_kernel<DH, FLASH, DROPOUT, false><<<ctas, threads, smem, stream>>>(mq, mk, mv, mo, mres,
                                                                        out, lse, a, B);
  return cudaGetLastError();
}

// the dQ kernel, then the dK/dV kernel; `delta` (B, H, Tq) f32 carries each
// row's delta from the first to the second.  `res`: the packed forward's
// rounding residual of O (the packed policy's delta needs it; NULL for flash)
template <int DH, bool FLASH, bool DROPOUT>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* res, const void* dout, const float* lse, float* delta,
                       void* dq, void* dk, void* dv, int B, const AttnArgs& a,
                       cudaStream_t stream) {
  if (delta == nullptr || (!FLASH && res == nullptr)) return cudaErrorInvalidValue;
  // each CTA's own tiles (Q and dO of its query rows; K and V of its keys),
  // then the ring's stages
  constexpr size_t smem_dq = ring_smem_bytes<DH>(2 * dq_consumers<DH>(), bwd_stages<DH>());
  constexpr size_t smem_dkdv = ring_smem_bytes<DH>(2 * dkdv_keys<DH>() / kBK, bwd_stages<DH>());
  static_assert(smem_dq <= 232448 && smem_dkdv <= 232448, "a CTA's shared memory");
  static bool configured_dq = false, configured_dkdv = false;
  cudaError_t err = allow_smem(bwd_dq_kernel<DH, FLASH, DROPOUT>, smem_dq, configured_dq);
  if (err == cudaSuccess)
    err = allow_smem(bwd_dkdv_kernel<DH, FLASH, DROPOUT>, smem_dkdv, configured_dkdv);
  CUtensorMap mq, mk, mv, mdo;
  if (err == cudaSuccess) err = make_map<FLASH>(&mq, q, B, a.H, a.Tq, DH);
  if (err == cudaSuccess) err = make_map<FLASH>(&mk, k, B, a.H, a.Tk, DH);
  if (err == cudaSuccess) err = make_map<FLASH>(&mv, v, B, a.H, a.Tk, DH);
  if (err == cudaSuccess) err = make_map<FLASH>(&mdo, dout, B, a.H, a.Tq, DH);
  if (err != cudaSuccess) return err;
  constexpr int rows = dq_consumers<DH>() * kBQ;  // owned query rows a CTA
  const dim3 grid_dq((a.Tq + rows - 1) / rows, a.H, B);
  bwd_dq_kernel<DH, FLASH, DROPOUT><<<grid_dq, (1 + dq_consumers<DH>()) * kWG, smem_dq, stream>>>(
      mq, mk, mv, mdo, static_cast<const bf16*>(o), static_cast<const bf16*>(res),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int keys = dkdv_keys<DH>();  // owned keys a CTA
  const dim3 grid_dkdv((a.Tk + keys - 1) / keys, a.H, B);
  bwd_dkdv_kernel<DH, FLASH, DROPOUT>
      <<<grid_dkdv, (1 + dkdv_consumers<DH>()) * kWG, smem_dkdv, stream>>>(
          mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), a);
  return cudaGetLastError();
}

// -- cluster launches (K4 past Dh 256) --------------------------------------

// the launch configuration of `grid` in clusters of c CTAs along x
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ClusterLaunch(dim3 grid, int threads, size_t smem, int c, cudaStream_t stream) : cfg{} {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Clusters of c CTAs of `kernel` (`threads` and `smem` bytes a CTA) the
// card holds at once, into `fit` (0: none); the first call allows the
// kernel `smem_max` bytes (its widest cluster's) and a cluster past the
// portable 8 (cudaFuncAttributeNonPortableClusterSizeAllowed), and each
// size's count is kept in `fits` (-1: none).
template <typename Kernel>
cudaError_t cluster_fit(Kernel kernel, int threads, size_t smem_max, size_t smem, int c,
                        bool& configured, int (&fits)[kMaxClusterCtas + 1], int& fit) {
  fit = 0;
  if (c < 1 || c > kMaxClusterCtas) return cudaErrorInvalidValue;
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (fits[c] == 0) {
    ClusterLaunch probe(dim3(c), threads, smem, c, nullptr);
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &probe.cfg);
    if (err != cudaSuccess) return err;
    fits[c] = n > 0 ? n : -1;
  }
  fit = fits[c] > 0 ? fits[c] : 0;
  return cudaSuccess;
}

// the shared memory of the forward's cluster kernel in a cluster of c
// (c = 0: the most of any size): its query tiles and ring, then the
// consumers' warps' exchange area
template <int DH = kSliceCols>
__host__ __device__ constexpr size_t fwd_split_smem(int c) {
  constexpr int areas = 4 * fwd_consumers<DH>();
  return ring_smem_bytes<DH>(fwd_consumers<DH>(), fwd_stages<DH>() * fwd_bn<DH>() / 64) +
         (c > 0 ? xch_bytes<fwd_bn<DH>() / 2>(areas, c) : max_xch_bytes<fwd_bn<DH>() / 2>(areas));
}

// clusters of c CTAs of the forward's cluster kernel the card holds at once
// (a template, so that only a source that launches it compiles its kernel)
template <int DH = kSliceCols>
cudaError_t fwd_split_fit(int c, int& fit) {
  static_assert(fwd_split_smem<DH>(0) <= 232448, "a CTA's shared memory");
  static bool configured = false;
  static int fits[kMaxClusterCtas + 1] = {};
  return cluster_fit(fwd_kernel<DH, true, false, false, true>, (1 + fwd_consumers<DH>()) * kWG,
                     fwd_split_smem<DH>(0), fwd_split_smem<DH>(c), c, configured, fits, fit);
}

// K4's forward at a head dim dh past 256 (a multiple of 64 up to 2048): the
// persistent forward over clusters of slice_ctas(dh) CTAs, as many clusters
// as fit on the card at once (at most one a work item);
// cudaErrorInvalidConfiguration where the card holds no such cluster
template <int DH = kSliceCols>
cudaError_t launch_fwd_split(const void* q, const void* k, const void* v, void* o, float* lse,
                             int B, int dh, const AttnArgs& args, cudaStream_t stream) {
  constexpr int C = fwd_consumers<DH>();
  const auto kernel = fwd_kernel<DH, true, false, false, true>;
  const int c = slice_ctas(dh);
  AttnArgs a = args;
  a.dh = dh;
  int fit = 0;
  cudaError_t err = fwd_split_fit<DH>(c, fit);
  if (err == cudaSuccess && fit < 1) err = cudaErrorInvalidConfiguration;
  CUtensorMap mq, mk, mv;
  if (err == cudaSuccess) err = make_map<true>(&mq, q, B, a.H, a.Tq, dh);
  if (err == cudaSuccess) err = make_map<true>(&mk, k, B, a.H, a.Tk, dh);
  if (err == cudaSuccess) err = make_map<true>(&mv, v, B, a.H, a.Tk, dh);
  if (err != cudaSuccess) return err;
  const long long items = (long long)((a.Tq + C * kBQ - 1) / (C * kBQ)) * a.H * B;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr int threads = (1 + C) * kWG;
  const unsigned clusters = (unsigned)(items < fit ? items : fit);
  ClusterLaunch launch(dim3(clusters * c), threads, fwd_split_smem<DH>(c), c, stream);
  // O leaves from registers: the output and residual maps are never read
  return cudaLaunchKernelEx(&launch.cfg, kernel, mq, mk, mv, mq, mq, static_cast<bf16*>(o), lse,
                            a, B);
}

// the shared memory of the backward's cluster kernels (dQ and dK/dV alike)
// in a cluster of c (c = 0: the most of any size): the CTA's own tiles and
// ring, then its consumer's warps' exchange area
template <int DH = kSliceCols>
__host__ __device__ constexpr size_t bwd_split_smem(int c) {
  return ring_smem_bytes<DH>(2, bwd_stages<DH>()) +
         (c > 0 ? bwd_xch_bytes<DH, true>(1, c) : max_xch_bytes<32>(kBwdChannels * 4));
}

// clusters of c CTAs of the backward's dQ and dK/dV cluster kernels the card
// holds at once
template <int DH = kSliceCols>
cudaError_t bwd_split_fit(int c, int& fit_dq, int& fit_dkdv) {
  static_assert(dq_consumers<DH>() == 1 && dkdv_consumers<DH>() == 1, "one consumer a CTA");
  static_assert(bwd_split_smem<DH>(0) <= 232448, "a CTA's shared memory");
  static bool configured_dq = false, configured_dkdv = false;
  static int fits_dq[kMaxClusterCtas + 1] = {}, fits_dkdv[kMaxClusterCtas + 1] = {};
  constexpr int threads = 2 * kWG;
  constexpr size_t most = bwd_split_smem<DH>(0);
  fit_dkdv = 0;
  const cudaError_t err = cluster_fit(bwd_dq_kernel<DH, true, false, true>, threads, most,
                                      bwd_split_smem<DH>(c), c, configured_dq, fits_dq, fit_dq);
  if (err != cudaSuccess) return err;
  return cluster_fit(bwd_dkdv_kernel<DH, true, false, true>, threads, most,
                     bwd_split_smem<DH>(c), c, configured_dkdv, fits_dkdv, fit_dkdv);
}

// K4's backward at a head dim dh past 256: the dQ kernel, then the dK/dV
// kernel, each over clusters of slice_ctas(dh) CTAs, a cluster a 64-row tile
// of a head; cudaErrorInvalidConfiguration where the card holds no cluster
// of either
template <int DH = kSliceCols>
cudaError_t launch_bwd_split(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const float* lse, float* delta, void* dq, void* dk,
                             void* dv, int B, int dh, const AttnArgs& args, cudaStream_t stream) {
  const auto dq_kernel = bwd_dq_kernel<DH, true, false, true>;
  const auto dkdv_kernel = bwd_dkdv_kernel<DH, true, false, true>;
  if (delta == nullptr) return cudaErrorInvalidValue;
  const int c = slice_ctas(dh);
  const size_t smem = bwd_split_smem<DH>(c);
  AttnArgs a = args;
  a.dh = dh;
  int fit_dq = 0, fit_dkdv = 0;
  cudaError_t err = bwd_split_fit<DH>(c, fit_dq, fit_dkdv);
  if (err == cudaSuccess && (fit_dq < 1 || fit_dkdv < 1)) err = cudaErrorInvalidConfiguration;
  CUtensorMap mq, mk, mv, mdo;
  if (err == cudaSuccess) err = make_map<true>(&mq, q, B, a.H, a.Tq, dh);
  if (err == cudaSuccess) err = make_map<true>(&mk, k, B, a.H, a.Tk, dh);
  if (err == cudaSuccess) err = make_map<true>(&mv, v, B, a.H, a.Tk, dh);
  if (err == cudaSuccess) err = make_map<true>(&mdo, dout, B, a.H, a.Tq, dh);
  if (err != cudaSuccess) return err;
  constexpr int threads = 2 * kWG;
  ClusterLaunch launch_dq(dim3((a.Tq + kBQ - 1) / kBQ * c, a.H, B), threads, smem, c, stream);
  err = cudaLaunchKernelEx(&launch_dq.cfg, dq_kernel, mq, mk, mv, mdo,
                           static_cast<const bf16*>(o), static_cast<const bf16*>(nullptr),
                           static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), a);
  if (err != cudaSuccess) return err;
  ClusterLaunch launch_dkdv(dim3((a.Tk + kBK - 1) / kBK * c, a.H, B), threads, smem, c, stream);
  return cudaLaunchKernelEx(&launch_dkdv.cfg, dkdv_kernel, mq, mk, mv, mdo, lse,
                            static_cast<const float*>(delta), static_cast<bf16*>(dk),
                            static_cast<bf16*>(dv), a);
}

}  // namespace tc
}  // namespace kokoro_attn
