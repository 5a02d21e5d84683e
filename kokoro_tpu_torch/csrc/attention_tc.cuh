// The bf16 attention kernels on Hopper's tensor cores (sm_90a): the forward,
// dQ and dK/dV templates of attention_kernels.cuh redesigned around wgmma and
// TMA, with the same two mask policies (packed K1/K2/K3, flash K4), dropout
// on or off, Dh 64 or 128, and the same numerics contract (see
// attention_kernels.cuh): S and dPd in f32; the unnormalised exp, Pd and
// dS * scale rounded to bf16 exactly where they become tensor-core operands;
// f32 sums, the f32 row lse.
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
// (128-byte rows, 128-byte swizzle; Dh = 128 is two boxes), completing on an
// mbarrier.  The tensor maps are 4-D so that a box never crosses into the
// next head or batch: packed (Dh, H, T, B), flash (Dh, T, H, B); rows past T
// are zero-filled by the TMA unit and masked by bounds.
//
// Products: a score tile (S = Q K^T, dPd = dO V^T, and in dK/dV the
// transposes S^T = K Q^T, dPd^T = V dO^T) is m64n64k16 with both operands in
// shared memory, K-major; an output product (O += P V, dQ += dS K,
// dV += Pd^T dO, dK += dS^T Q) is m64n{Dh}k16 with A from registers and B in
// shared memory MN-major (the transpose flag).
//
// The forward: one warpgroup a CTA, its query tile loaded once, the key and
// value tiles through a ring of two stages; the dropout flags of each 64 x 64
// tile come from dropout_tile (Philox, the plain version's mask bit for bit)
// into shared bytes [query][key] that each fragment element reads.  Under
// grad the packed forward also writes O's bf16 rounding residual,
// bf16(O32 - bf16(O32)), for the backward's delta.
//
// The backward (two launches, FlashAttention-2's split, no atomics: every
// gradient element is written by one thread in a fixed order, so dQ, dK and
// dV are bitwise the same call to call) is warp-specialised: a CTA is a
// producer warpgroup and, at Dh 64, two consumer warpgroups (384 threads,
// one CTA an SM; setmaxnreg gives the producer 24 registers a thread and
// the consumers 240), at Dh 128 one (256 threads: its dK and dV accumulators
// alone take 128 registers a thread).  One producer warp keeps TMA loads in
// flight through a ring of kStages stages (full/empty mbarriers) and writes
// each stage's row data (the dK/dV kernel's lse and delta, the flash segment
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
// fragments hold them by shuffles), the same counter as dropout_tile.  Each
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
constexpr int kWG = 128;                // threads of a warpgroup (the forward's CTA)
constexpr uint32_t kBox = 64 * 64 * 2;  // one TMA box: 64 rows of 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

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

// rows [row0, row0 + 64), every column: DH / 64 boxes, kBox bytes apart
template <bool FLASH, int DH>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, int row0, int h,
                                         int b, uint64_t* bar) {
#pragma unroll
  for (int g = 0; g < DH / 64; ++g) tma_box<FLASH>(dst + g * kBox, map, 64 * g, row0, h, b, bar);
}

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
// the same for an A operand, before its registers are written again
__device__ __forceinline__ void fence_operand(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
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

// s (64 x 64) = A B^T over DH columns, A and B 64-row tiles in shared memory
// (K-major), the first step overwriting s; the caller fences, commits and
// waits
template <int DH>
__device__ __forceinline__ void score_tile(float (&s)[32], const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
    wgmma_ss_n64(s, desc_k_major(a, ks), desc_k_major(b, ks), ks > 0);
}

// acc (64 x DH) += A (64 x 64, bf16 registers) B (64 x DH tile, MN-major)
template <int DH>
__device__ __forceinline__ void accumulate(float (&acc)[DH / 2], const uint32_t (&a)[4][4],
                                           const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (DH == 64) {
      wgmma_rs_n64(acc, a[kk], desc_mn_major(b, kk));
    } else {
      wgmma_rs_n128(acc, a[kk], desc_mn_major(b, kk));
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a 64 x 64 f32 accumulator rounded to bf16 as four 64 x 16 A operands
__device__ __forceinline__ void to_a_operand(const float (&s)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
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
// elements apart) scaled by inv[i]; rows at or past row_end are not stored.
// With `res`, also the rounding residual bf16(x - bf16(x)) of each value x.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[DH / 2], int row0,
                                           int r0, int c0, int row_end, int D,
                                           const float (&inv)[2], bf16* res = nullptr) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r0 + 8 * i;
    if (row >= row_end) continue;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const float x0 = acc[4 * j + 2 * i] * inv[i], x1 = acc[4 * j + 2 * i + 1] * inv[i];
      const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
      const size_t at = (size_t)row * D + 8 * j + c0;
      *reinterpret_cast<__nv_bfloat162*>(dst + at) = v;
      if (res != nullptr) {
        const float2 r = __bfloat1622float2(v);
        *reinterpret_cast<__nv_bfloat162*>(res + at) = __floats2bfloat162_rn(x0 - r.x, x1 - r.y);
      }
    }
  }
}

// -- shared memory ----------------------------------------------------------

// after the forward's bf16 tiles: three mbarriers (the CTA's own tile; ring
// stages 0 and 1), then the key segment ids (64), then the dropout flags
// (64 x 64 bytes)
struct Tail {
  uint64_t* bar;
  int* kvseg;
  uint8_t* keep;
};

constexpr size_t kTailBytes = 32 + 64 * 4 + 64 * 64;

__device__ __forceinline__ Tail carve_tail(uint8_t* p) {
  Tail t;
  t.bar = reinterpret_cast<uint64_t*>(p);
  t.kvseg = reinterpret_cast<int*>(p + 32);
  t.keep = reinterpret_cast<uint8_t*>(t.kvseg + 64);
  return t;
}

// bytes of dynamic shared memory of the forward: `tiles` 64-row tiles of DH
// columns
template <int DH>
constexpr size_t smem_bytes(int tiles) {
  return 1024 + (size_t)tiles * (DH / 64) * kBox + kTailBytes;
}

// -- kernels ----------------------------------------------------------------

// RES: also write O's rounding residual (the packed forward under grad)
template <int DH, bool FLASH, bool DROPOUT, bool RES>
__global__ void __launch_bounds__(kWG)
fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, bf16* __restrict__ res,
           float* __restrict__ lse, AttnArgs a) {
  constexpr uint32_t TILE = DH / 64 * kBox;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Ks = Qs + TILE;      // two stages
  uint8_t* Vs = Ks + 2 * TILE;  // two stages
  const Tail sh = carve_tail(Vs + 2 * TILE);

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int D = row_stride<FLASH, DH>(a.H);
  const size_t q_base = head_offset<FLASH, DH>(b, h, a.H, a.Tq);
  const uint32_t bh = (uint32_t)(b * a.H + h);
  const bool seg = FLASH && a.q_seg != nullptr;
  const KeyRange keys = key_range<FLASH>(a, b, q0);
  const int n_tiles = (keys.kv_end + kBK - 1) / kBK;
  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2), c0 = 2 * (lane & 3);

  auto load_kv = [&](int j) {
    uint64_t* bar = sh.bar + 1 + (j & 1);
    mbar_expect_tx(bar, 2 * TILE);
    tma_tile<FLASH, DH>(Ks + (j & 1) * TILE, &tk, j * kBK, h, b, bar);
    tma_tile<FLASH, DH>(Vs + (j & 1) * TILE, &tv, j * kBK, h, b, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(sh.bar + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(sh.bar, TILE);
    tma_tile<FLASH, DH>(Qs, &tq, q0, h, b, sh.bar);
    for (int j = 0; j < 2 && j < n_tiles; ++j) load_kv(j);
  }

  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    qseg[i] = (seg && row < a.Tq) ? a.q_seg[(size_t)b * a.Tq + row] : 1;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DH / 2];
  zero(acc);
  mbar_wait(sh.bar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK, slot = j & 1;
    if (j > 0) {
      __syncthreads();  // tile j - 1 is done: its stage, the flags and kvseg are free
      if (tid == 0 && j + 1 < n_tiles) load_kv(j + 1);
    }
    if (DROPOUT) dropout_tile<kWG>(sh.keep, bh, q0, k0, a.threshold, a.seed_lo, a.seed_hi);
    if (seg) load_segments(sh.kvseg, a.kv_seg, b, k0, a.Tk);
    if (DROPOUT || seg) __syncthreads();
    mbar_wait(sh.bar + 1 + slot, (j >> 1) & 1);

    float s[32];
    wgmma_fence();
    score_tile<DH>(s, Qs, Ks + slot * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r0 + 8 * i;
      float tile_max = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * jj + c0 + e, col = k0 + c, idx = 4 * jj + 2 * i + e;
          float val;
          if (col >= a.Tk) {
            val = -INFINITY;  // not a key at all: excluded from the softmax
          } else {
            const bool visible =
                is_visible<FLASH>(a, keys, row, col) && (!seg || qseg[i] == sh.kvseg[c]);
            val = s[idx] * a.scale;
            if (!visible) val = FLASH ? val + kFlashMask : kMasked;
          }
          s[idx] = val;
          tile_max = fmaxf(tile_max, val);
        }
      }
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
      // every visited tile holds column k0 < Tk, so m_new is finite
      const float m_new = fmaxf(m[i], tile_max);
      const float alpha = exp2f((m[i] - m_new) * kLog2e);
      float row_sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * jj + 2 * i + e;
          float p = exp2f((s[idx] - m_new) * kLog2e);
          row_sum += p;
          if (DROPOUT && !sh.keep[(r0 + 8 * i) * 64 + 8 * jj + c0 + e]) p = 0.f;
          s[idx] = p;
        }
      }
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DH / 8; ++jj) {
        acc[4 * jj + 2 * i] *= alpha;
        acc[4 * jj + 2 * i + 1] *= alpha;
      }
    }

    uint32_t pa[4][4];
    to_a_operand(s, pa);  // the unnormalised weights rounded to bf16
    wgmma_fence();
    accumulate<DH>(acc, pa, Vs + slot * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // flash: a visible logit is far above half the mask value, and a row that
    // saw only masked keys has m at the mask value; a packed masked logit is
    // -1e9, so every packed row counts as visible
    const bool any_visible = !FLASH || m[i] > 0.5f * kFlashMask;
    inv[i] = any_visible ? (DROPOUT ? a.inv_keep : 1.f) / l[i] : 0.f;
    const int row = q0 + r0 + 8 * i;
    if (lse != nullptr && (lane & 3) == 0 && row < a.Tq)
      lse[(size_t)bh * a.Tq + row] = any_visible ? m[i] + logf(l[i]) : INFINITY;
  }
  store_rows<DH>(o + q_base, acc, q0, r0, c0, a.Tq, D, inv, RES ? res + q_base : nullptr);
}

// -- the backward -------------------------------------------------------------

constexpr int kStages = 3;  // ring depth of the streamed tiles
// consumer warpgroups of a backward CTA: two at Dh 64, sharing each streamed
// tile; one at Dh 128, whose dK and dV accumulators alone take 128
// registers a thread (a CTA of three warpgroups may give each thread 168)
template <int DH>
__host__ __device__ constexpr int bwd_consumers() {
  return DH == 64 ? 2 : 1;
}
template <int DH>
__host__ __device__ constexpr int bwd_threads() {
  return (1 + bwd_consumers<DH>()) * kWG;
}
// with two consumers: 128 x 24 + 256 x 240 = 384 x 168 registers
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// after the bf16 tiles of a backward CTA: the mbarriers (the CTA's own tiles,
// then `full` and `empty` of each ring stage), then each stage's row data:
// the query rows' lse * log2(e) and delta (dK/dV) and the streamed rows'
// segment ids (flash), 64 words each
struct Ring {
  uint64_t* own;
  uint64_t* full;
  uint64_t* empty;
  uint8_t* rows;
  __device__ __forceinline__ float* lse2(int stage) const {
    return reinterpret_cast<float*>(rows) + stage * 192;
  }
  __device__ __forceinline__ float* delta(int stage) const { return lse2(stage) + 64; }
  __device__ __forceinline__ int* seg(int stage) const {
    return reinterpret_cast<int*>(lse2(stage) + 128);
  }
};

constexpr size_t kRingBytes = 64 + (size_t)kStages * 192 * 4;

__device__ __forceinline__ Ring carve_ring(uint8_t* p) {
  Ring r;
  r.own = reinterpret_cast<uint64_t*>(p);
  r.full = r.own + 1;
  r.empty = r.full + kStages;
  r.rows = p + 64;
  return r;
}

// thread 0: the barriers' arrival counts (the producer warp's 32 lanes fill
// a stage, each of the consumers' warps empties it)
__device__ __forceinline__ void ring_init(const Ring& r, int consumers) {
  mbar_init(r.own, 1);
  for (int s = 0; s < kStages; ++s) {
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

// bytes of dynamic shared memory of a backward CTA: two own 64-row tiles a
// consumer and 2 kStages streamed ones
template <int DH>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  return 1024 + (size_t)(2 * bwd_consumers<DH>() + 2 * kStages) * (DH / 64) * kBox + kRingBytes;
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
// then the quad sums the four; 0 for rows at or past T
template <bool FLASH, int DH>
__device__ __forceinline__ void quad_row_deltas(const bf16* o, const bf16* res, const bf16* dout,
                                                size_t base, int row, int T, int D, int lane,
                                                float (&delta)[2]) {
  constexpr int Q = DH / 4;
  const int c_begin = (lane & 3) * Q;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = 0.f;
    const int r = row + 8 * i;
    if (r < T) {
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
                                              int q0, int k0) {
  if (seg || keys.uniform || q0 + kBQ > a.Tq || k0 + kBK > a.Tk) return false;
  if (a.causal) return k0 + kBK - 1 <= q0;  // the tile's last key against its first query
  return FLASH || k0 + kBK <= keys.len;
}

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

template <int DH, bool FLASH, bool DROPOUT>
__global__ void __launch_bounds__(bwd_threads<DH>(), 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
              const bf16* __restrict__ o, const bf16* __restrict__ res,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta_out, bf16* __restrict__ dq, AttnArgs a) {
  constexpr uint32_t TILE = DH / 64 * kBox;
  constexpr int C = bwd_consumers<DH>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);  // the CTA's query rows: one tile a consumer
  uint8_t* dOs = Qs + C * TILE;
  uint8_t* Ks = dOs + C * TILE;       // kStages stages
  uint8_t* Vs = Ks + kStages * TILE;
  const Ring ring = carve_ring(Vs + kStages * TILE);

  const int q0 = blockIdx.x * C * kBQ, h = blockIdx.y, b = blockIdx.z;
  const uint32_t bh = (uint32_t)(b * a.H + h);
  const bool seg = FLASH && a.q_seg != nullptr;
  // every key tile a row of the CTA visits (the last tile's rows see the most)
  const int n_tiles = (key_range<FLASH>(a, b, q0 + (C - 1) * kBQ).kv_end + kBK - 1) / kBK;
  const int group = warpgroup_index(), lane = threadIdx.x & 31;
  const float inv_t = 1.f / (float)a.Tk;
  if (threadIdx.x == 0) ring_init(ring, C);
  __syncthreads();

  if (group == 0) {  // the producer warpgroup; its first warp issues every load
    regs_dec<kProducerRegs>();
    if (warp_in_group() == 0) {
      if (lane == 0) {
        const int own = min(C, (a.Tq - q0 + kBQ - 1) / kBQ);
        mbar_expect_tx(ring.own, own * 2 * TILE);
        for (int w = 0; w < own; ++w) {
          tma_tile<FLASH, DH>(Qs + w * TILE, &tq, q0 + w * kBQ, h, b, ring.own);
          tma_tile<FLASH, DH>(dOs + w * TILE, &tdo, q0 + w * kBQ, h, b, ring.own);
        }
      }
      int stage = 0, phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        if (j >= kStages) mbar_wait(ring.empty + stage, phase ^ 1);
        if (seg) {
          for (int c = lane; c < kBK; c += 32) {
            const int pos = j * kBK + c;
            ring.seg(stage)[c] = pos < a.Tk ? a.kv_seg[(size_t)b * a.Tk + pos] : 1;
          }
        }
        if (lane == 0) {
          mbar_expect_tx(ring.full + stage, 2 * TILE);
          tma_tile<FLASH, DH>(Ks + stage * TILE, &tk, j * kBK, h, b, ring.full + stage);
          tma_tile<FLASH, DH>(Vs + stage * TILE, &tv, j * kBK, h, b, ring.full + stage);
        } else {
          mbar_arrive(ring.full + stage);
        }
        if (++stage == kStages) {
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
    const int D = row_stride<FLASH, DH>(a.H);
    const size_t q_base = head_offset<FLASH, DH>(b, h, a.H, a.Tq);
    const float scale2 = a.scale * kLog2e;

    // the rows' delta (written once for the dK/dV kernel), lse and segment
    float delta[2], lse2[2];
    int qseg[2];
    quad_row_deltas<FLASH, DH>(o, res, dout, q_base, qw + r0, a.Tq, D, lane, delta);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = qw + r0 + 8 * i;
      const bool in_rows = row < a.Tq;
      if (in_rows && (lane & 3) == 0) delta_out[(size_t)bh * a.Tq + row] = delta[i];
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
        score_tile<DH>(s, Qs + wg * TILE, Kt);
        wgmma_commit();
        if (pending) {  // the previous dQ product is done: its stage is free
          wgmma_wait<1>();
          fence_operand(dsa);
          fence_regs(acc);
          release(ring.empty + prev, lane);
        }
        score_tile<DH>(dp, dOs + wg * TILE, Vs + stage * TILE);
        wgmma_commit();
        const uint32_t keep = DROPOUT ? keep_bits_q(bh, qw + r0, k0, lane, a) : 0u;
        wgmma_wait<1>();  // S is done, dPd may still run
        fence_regs(s);
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
        wgmma_wait<0>();
        fence_regs(dp);
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
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operand(dsa);
    fence_regs(acc);
    const float one[2] = {1.f, 1.f};
    store_rows<DH>(dq + q_base, acc, qw, r0, c0, a.Tq, D, one);
  }
}

template <int DH, bool FLASH, bool DROPOUT>
__global__ void __launch_bounds__(bwd_threads<DH>(), 1)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, AttnArgs a) {
  constexpr uint32_t TILE = DH / 64 * kBox;
  constexpr int C = bwd_consumers<DH>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);  // the CTA's keys: one tile a consumer
  uint8_t* Vs = Ks + C * TILE;
  uint8_t* Qs = Vs + C * TILE;        // kStages stages
  uint8_t* dOs = Qs + kStages * TILE;
  const Ring ring = carve_ring(dOs + kStages * TILE);

  const int k0 = blockIdx.x * C * kBK, h = blockIdx.y, b = blockIdx.z;
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
  if (threadIdx.x == 0) ring_init(ring, C);
  __syncthreads();

  if (group == 0) {  // the producer warpgroup; its first warp issues every load
    regs_dec<kProducerRegs>();
    if (warp_in_group() == 0) {
      if (lane == 0 && n_tiles > 0) {
        const int own = min(C, (a.Tk - k0 + kBK - 1) / kBK);
        mbar_expect_tx(ring.own, own * 2 * TILE);
        for (int w = 0; w < own; ++w) {
          tma_tile<FLASH, DH>(Ks + w * TILE, &tk, k0 + w * kBK, h, b, ring.own);
          tma_tile<FLASH, DH>(Vs + w * TILE, &tv, k0 + w * kBK, h, b, ring.own);
        }
      }
      int stage = 0, phase = 0;
      for (int i = 0; i < n_tiles; ++i) {
        const int q0 = q_begin + i * kBQ;
        if (i >= kStages) mbar_wait(ring.empty + stage, phase ^ 1);
        for (int r = lane; r < kBQ; r += 32) {  // the query rows' lse and delta (the dQ kernel's)
          const int row = q0 + r;
          const bool in_rows = row < a.Tq;
          ring.lse2(stage)[r] = in_rows ? lse[(size_t)bh * a.Tq + row] * kLog2e : 0.f;
          ring.delta(stage)[r] = in_rows ? delta[(size_t)bh * a.Tq + row] : 0.f;
          if (seg) ring.seg(stage)[r] = in_rows ? a.q_seg[(size_t)b * a.Tq + row] : 1;
        }
        if (lane == 0) {
          mbar_expect_tx(ring.full + stage, 2 * TILE);
          tma_tile<FLASH, DH>(Qs + stage * TILE, &tq, q0, h, b, ring.full + stage);
          tma_tile<FLASH, DH>(dOs + stage * TILE, &tdo, q0, h, b, ring.full + stage);
        } else {
          mbar_arrive(ring.full + stage);
        }
        if (++stage == kStages) {
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
    const int D = row_stride<FLASH, DH>(a.H);
    const size_t q_base = head_offset<FLASH, DH>(b, h, a.H, a.Tq);
    const size_t kv_base = kv_offset<FLASH, DH>(q_base, b, h, a);
    const float scale2 = a.scale * kLog2e;
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
        score_tile<DH>(s, Ks + wg * TILE, Qt);
        wgmma_commit();
        if (pending) {  // the previous products are done: their stage is free
          wgmma_wait<1>();
          fence_operand(pda);
          fence_operand(dsa);
          fence_regs(acc_dv);
          fence_regs(acc_dk);
          release(ring.empty + prev, lane);
        }
        score_tile<DH>(dp, Vs + wg * TILE, dOt);
        wgmma_commit();
        const uint32_t keep = DROPOUT ? keep_bits_kv(bh, q0, kw + (r0 & ~3), lane, a) : 0u;
        wgmma_wait<1>();  // S^T is done, dPd^T may still run
        fence_regs(s);
        const float* lse_t = ring.lse2(stage);
        const float* delta_t = ring.delta(stage);
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
          const int* qseg = ring.seg(stage);
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
                s[idx] = softmax_p(s[idx], in_bounds, keys.uniform, visible, lse_t[qc], scale2,
                                   inv_t);
              }
            }
          }
        }
        // Pd^T to bf16 and its dV product first, running beside dPd^T
        pd_operand<DROPOUT>(s, keep, a, pda);  // bf16(Pd)^T; s keeps p for dS
        wgmma_fence();
        accumulate<DH>(acc_dv, pda, dOt);
        wgmma_commit();
        wgmma_wait<1>();  // dPd^T is done, the dV product may still run
        fence_regs(dp);
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
      if (++stage == kStages) {
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
    store_rows<DH>(dk + kv_base, acc_dk, kw, r0, c0, a.Tk, D, one);
    store_rows<DH>(dv + kv_base, acc_dv, kw, r0, c0, a.Tk, D, one);
  }
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
  constexpr size_t smem = smem_bytes<DH>(5);
  static bool configured = false, configured_res = false;
  cudaError_t err = res == nullptr
                        ? allow_smem(fwd_kernel<DH, FLASH, DROPOUT, false>, smem, configured)
                        : allow_smem(fwd_kernel<DH, FLASH, DROPOUT, true>, smem, configured_res);
  CUtensorMap mq, mk, mv;
  if (err == cudaSuccess) err = make_map<FLASH>(&mq, q, B, a.H, a.Tq, DH);
  if (err == cudaSuccess) err = make_map<FLASH>(&mk, k, B, a.H, a.Tk, DH);
  if (err == cudaSuccess) err = make_map<FLASH>(&mv, v, B, a.H, a.Tk, DH);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + kBQ - 1) / kBQ, a.H, B);
  bf16* o_ = static_cast<bf16*>(o);
  bf16* res_ = static_cast<bf16*>(res);
  if (res == nullptr) {
    fwd_kernel<DH, FLASH, DROPOUT, false><<<grid, kWG, smem, stream>>>(mq, mk, mv, o_, res_, lse, a);
  } else {
    fwd_kernel<DH, FLASH, DROPOUT, true><<<grid, kWG, smem, stream>>>(mq, mk, mv, o_, res_, lse, a);
  }
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
  constexpr size_t smem = bwd_smem_bytes<DH>();
  static bool configured_dq = false, configured_dkdv = false;
  cudaError_t err = allow_smem(bwd_dq_kernel<DH, FLASH, DROPOUT>, smem, configured_dq);
  if (err == cudaSuccess)
    err = allow_smem(bwd_dkdv_kernel<DH, FLASH, DROPOUT>, smem, configured_dkdv);
  CUtensorMap mq, mk, mv, mdo;
  if (err == cudaSuccess) err = make_map<FLASH>(&mq, q, B, a.H, a.Tq, DH);
  if (err == cudaSuccess) err = make_map<FLASH>(&mk, k, B, a.H, a.Tk, DH);
  if (err == cudaSuccess) err = make_map<FLASH>(&mv, v, B, a.H, a.Tk, DH);
  if (err == cudaSuccess) err = make_map<FLASH>(&mdo, dout, B, a.H, a.Tq, DH);
  if (err != cudaSuccess) return err;
  constexpr int rows = bwd_consumers<DH>() * kBQ;  // owned rows a CTA
  constexpr int threads = bwd_threads<DH>();
  const dim3 grid_dq((a.Tq + rows - 1) / rows, a.H, B);
  bwd_dq_kernel<DH, FLASH, DROPOUT><<<grid_dq, threads, smem, stream>>>(
      mq, mk, mv, mdo, static_cast<const bf16*>(o), static_cast<const bf16*>(res),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_dkdv((a.Tk + rows - 1) / rows, a.H, B);
  bwd_dkdv_kernel<DH, FLASH, DROPOUT><<<grid_dkdv, threads, smem, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), a);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace kokoro_attn
