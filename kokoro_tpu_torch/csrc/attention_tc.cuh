// The bf16 attention kernels on Hopper's tensor cores (sm_90a): the forward,
// dQ and dK/dV templates of attention_kernels.cuh redesigned around wgmma and
// TMA, with the same two mask policies (packed K1/K2/K3, flash K4), dropout
// on or off, Dh 64 or 128, and the same numerics contract (see
// attention_kernels.cuh): S and dPd in f32; the unnormalised exp, Pd and
// dS * scale rounded to bf16 exactly where they become tensor-core operands;
// f32 sums, the f32 row lse.
//
// One CTA is one warpgroup (128 threads) and owns a 64-row tile: a query tile
// (forward, dQ) or a key tile (dK/dV).  Thread t of the warpgroup holds, of
// every 64 x N f32 accumulator, rows r0 = 16 (t / 32) + (t % 32) / 4 and
// r0 + 8, columns 8 j + 2 (t % 4) + {0, 1}: element 4 j + 2 i + e is
// (r0 + 8 i, 8 j + 2 (t % 4) + e).  Row reductions of the softmax are over
// the thread's 16 values of a 64-column tile and then the quad (lanes xor 1,
// 2).  The same registers, rounded to bf16 in pairs, are wgmma's A operand
// for the second product (to_a_operand), so P, Pd and dS never reach shared
// memory.
//
// Tiles arrive by TMA (cp.async.bulk.tensor) as 64-row boxes of 64 bf16
// (128-byte rows, 128-byte swizzle; Dh = 128 is two boxes), completing on an
// mbarrier.  The CTA's own tile is loaded once; the tiles it loops over stream
// through a ring of two stages, the next tile's load in flight while the
// current one computes.  Each query row's delta (the row term of dS = P (dP -
// delta)) is the dQ kernel's, which writes it to device memory for the dK/dV
// kernel: the packed policy's is the reference's sum of P * dP over the row in
// f32, from a first pass over the key tiles (rowsum(dO * O) on the bf16 O
// would round 1.25 v, a kept weight of a one-key row at rate 0.2, and put that
// rounding, summed over every query, into the key's dK); the flash policy's
// is the library's rowsum(dO * O).  The tensor maps are 4-D so that a box
// never crosses into the next head or batch: packed (Dh, H, T, B), flash
// (Dh, T, H, B); rows past T are zero-filled by the TMA unit and masked by
// bounds.
//
// Products: a score tile (S = Q K^T, dPd = dO V^T, and in dK/dV the
// transposes S^T = K Q^T, dPd^T = V dO^T) is m64n64k16 with both operands in
// shared memory, K-major; an output product (O += P V, dQ += dS K,
// dV += Pd^T dO, dK += dS^T Q) is m64n{Dh}k16 with A from registers and B in
// shared memory MN-major (the transpose flag).  The dropout flags of each
// 64 x 64 tile come from dropout_tile (Philox, the plain version's mask bit
// for bit) into shared bytes [query][key] that each fragment element reads.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time

#include "attention_common.cuh"

namespace kokoro_attn {
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWG = 128;                // threads of a CTA: one warpgroup
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from reading an accumulator before wgmma_wait_all
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// D (64 x 64, f32) += A (64 x 16, shared memory, K-major) * B^T (B: 64 x 16,
// shared memory, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
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
// (K-major); the caller fences, commits and waits
template <int DH>
__device__ __forceinline__ void scores(float (&s)[32], const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) wgmma_ss_n64(s, desc_k_major(a, ks), desc_k_major(b, ks));
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
// elements apart) scaled by inv[i]; rows at or past row_end are not stored
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[DH / 2], int row0,
                                           int r0, int c0, int row_end, int D,
                                           const float (&inv)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r0 + 8 * i;
    if (row >= row_end) continue;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * D + 8 * j + c0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv[i], acc[4 * j + 2 * i + 1] * inv[i]);
    }
  }
}

// -- shared memory ----------------------------------------------------------

// after the bf16 tiles: three mbarriers (the CTA's own tiles; ring stages 0
// and 1), then delta, lse, query and key segment ids (64 each), then the
// dropout flags (64 x 64 bytes)
struct Tail {
  uint64_t* bar;
  float* delta;
  float* lse;
  int* qseg;
  int* kvseg;
  uint8_t* keep;
};

constexpr size_t kTailBytes = 32 + 4 * 64 * 4 + 64 * 64;

__device__ __forceinline__ Tail carve_tail(uint8_t* p) {
  Tail t;
  t.bar = reinterpret_cast<uint64_t*>(p);
  t.delta = reinterpret_cast<float*>(p + 32);
  t.lse = t.delta + 64;
  t.qseg = reinterpret_cast<int*>(t.lse + 64);
  t.kvseg = t.qseg + 64;
  t.keep = reinterpret_cast<uint8_t*>(t.kvseg + 64);
  return t;
}

// bytes of dynamic shared memory for `tiles` 64-row tiles of DH columns
template <int DH>
constexpr size_t smem_bytes(int tiles) {
  return 1024 + (size_t)tiles * (DH / 64) * kBox + kTailBytes;
}

// -- kernels ----------------------------------------------------------------

template <int DH, bool FLASH, bool DROPOUT>
__global__ void __launch_bounds__(kWG)
fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
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
    zero(s);
    wgmma_fence();
    scores<DH>(s, Qs, Ks + slot * TILE);
    wgmma_commit();
    wgmma_wait_all();
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
    wgmma_wait_all();
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
  store_rows<DH>(o + q_base, acc, q0, r0, c0, a.Tq, D, inv);
}

// the softmax weight of one element from its logit s and the row's lse: 1 / Tk
// on a packed row with no key, 0 where not visible
__device__ __forceinline__ float softmax_p(float s, bool in_bounds, bool uniform, bool visible,
                                           float lse, const AttnArgs& a, float inv_t) {
  if (!in_bounds) return 0.f;
  return uniform ? inv_t : (visible ? exp2f((s * a.scale - lse) * kLog2e) : 0.f);
}

// p, Pd and dS * scale of one element from its logit s and dPd, the row's
// lse and delta; `visible` before segment ids, `kept` its dropout flag
template <bool DROPOUT>
__device__ __forceinline__ void grad_element(float s, float dpd, bool in_bounds, bool uniform,
                                             bool visible, float lse, float delta, bool kept,
                                             const AttnArgs& a, float inv_t, float& pd,
                                             float& ds) {
  const float p = softmax_p(s, in_bounds, uniform, visible, lse, a, inv_t);
  pd = p;
  if (DROPOUT) {
    pd = kept ? p * a.inv_keep : 0.f;
    dpd = kept ? dpd * a.inv_keep : 0.f;
  }
  ds = p * (dpd - delta) * a.scale;
}

template <int DH, bool FLASH, bool DROPOUT>
__global__ void __launch_bounds__(kWG)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
              const bf16* __restrict__ o, const bf16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta_out,
              bf16* __restrict__ dq, AttnArgs a) {
  constexpr uint32_t TILE = DH / 64 * kBox;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* dOs = Qs + TILE;
  uint8_t* Ks = dOs + TILE;     // two stages
  uint8_t* Vs = Ks + 2 * TILE;  // two stages
  const Tail sh = carve_tail(Vs + 2 * TILE);

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int D = row_stride<FLASH, DH>(a.H);
  const size_t q_base = head_offset<FLASH, DH>(b, h, a.H, a.Tq);
  const uint32_t bh = (uint32_t)(b * a.H + h);
  const bool seg = FLASH && a.q_seg != nullptr;
  const KeyRange keys = key_range<FLASH>(a, b, q0);
  const int n_tiles = (keys.kv_end + kBK - 1) / kBK;
  // the packed policy streams the key tiles twice: delta, then dQ
  const int n_iter = FLASH ? n_tiles : 2 * n_tiles;
  const float inv_t = 1.f / (float)a.Tk;
  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2), c0 = 2 * (lane & 3);

  // ring position j holds key tile j, or j - n_tiles in the second pass
  auto load_kv = [&](int j) {
    uint64_t* bar = sh.bar + 1 + (j & 1);
    const int k0 = (j < n_tiles ? j : j - n_tiles) * kBK;
    mbar_expect_tx(bar, 2 * TILE);
    tma_tile<FLASH, DH>(Ks + (j & 1) * TILE, &tk, k0, h, b, bar);
    tma_tile<FLASH, DH>(Vs + (j & 1) * TILE, &tv, k0, h, b, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(sh.bar + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(sh.bar, 2 * TILE);
    tma_tile<FLASH, DH>(Qs, &tq, q0, h, b, sh.bar);
    tma_tile<FLASH, DH>(dOs, &tdo, q0, h, b, sh.bar);
    for (int j = 0; j < 2 && j < n_iter; ++j) load_kv(j);
  }
  if (FLASH) {
    row_stats<bf16, DH, kWG>(o, dout, lse, q_base, (size_t)bh * a.Tq, q0, a.Tq, D, sh.delta,
                             sh.lse);
  } else if (tid < kBQ) {
    sh.lse[tid] = q0 + tid < a.Tq ? lse[(size_t)bh * a.Tq + q0 + tid] : 0.f;
  }
  if (seg) load_segments(sh.qseg, a.q_seg, b, q0, a.Tq);
  __syncthreads();
  if (FLASH && tid < kBQ && q0 + tid < a.Tq)
    delta_out[(size_t)bh * a.Tq + q0 + tid] = sh.delta[tid];
  float delta[2], lse_r[2];
  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    delta[i] = FLASH ? sh.delta[r0 + 8 * i] : 0.f;
    lse_r[i] = sh.lse[r0 + 8 * i];
    qseg[i] = seg ? sh.qseg[r0 + 8 * i] : 1;
  }
  // the packed policy's delta: the thread's partial sums of P * dP over its
  // columns, summed over the quad, written once a row for the dK/dV kernel
  auto publish_delta = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
      const int row = q0 + r0 + 8 * i;
      if ((lane & 3) == 0 && row < a.Tq) delta_out[(size_t)bh * a.Tq + row] = delta[i];
    }
  };
  if (!FLASH && n_tiles == 0) publish_delta();
  float acc[DH / 2];
  zero(acc);
  mbar_wait(sh.bar, 0);

  for (int j = 0; j < n_iter; ++j) {
    const bool first_pass = !FLASH && j < n_tiles;
    const int k0 = (j < n_tiles ? j : j - n_tiles) * kBK, slot = j & 1;
    if (j > 0) {
      __syncthreads();  // ring position j - 1 is done: its stage, the flags and kvseg are free
      if (tid == 0 && j + 1 < n_iter) load_kv(j + 1);
    }
    if (DROPOUT) dropout_tile<kWG>(sh.keep, bh, q0, k0, a.threshold, a.seed_lo, a.seed_hi);
    if (seg) load_segments(sh.kvseg, a.kv_seg, b, k0, a.Tk);
    if (DROPOUT || seg) __syncthreads();
    mbar_wait(sh.bar + 1 + slot, (j >> 1) & 1);

    float s[32], dp[32];
    zero(s);
    zero(dp);
    wgmma_fence();
    scores<DH>(s, Qs, Ks + slot * TILE);
    scores<DH>(dp, dOs, Vs + slot * TILE);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    if (!FLASH && j == n_tiles) publish_delta();  // the first pass is complete

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r0 + 8 * i;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * jj + c0 + e, col = k0 + c, idx = 4 * jj + 2 * i + e;
          const bool in_bounds = row < a.Tq && col < a.Tk;
          const bool visible = in_bounds && is_visible<FLASH>(a, keys, row, col) &&
                               (!seg || qseg[i] == sh.kvseg[c]);
          const bool kept = !DROPOUT || sh.keep[(r0 + 8 * i) * 64 + c] != 0;
          if (first_pass) {  // delta += p * dP, dP through the dropout flag
            const float dpk = DROPOUT ? (kept ? dp[idx] * a.inv_keep : 0.f) : dp[idx];
            delta[i] = fmaf(softmax_p(s[idx], in_bounds, keys.uniform, visible, lse_r[i], a,
                                      inv_t), dpk, delta[i]);
            continue;
          }
          float pd, ds;
          grad_element<DROPOUT>(s[idx], dp[idx], in_bounds, keys.uniform, visible, lse_r[i],
                                delta[i], kept, a, inv_t, pd, ds);
          s[idx] = ds;
        }
      }
    }
    if (first_pass) continue;
    uint32_t dsa[4][4];
    to_a_operand(s, dsa);  // bf16(dS * scale)
    wgmma_fence();
    accumulate<DH>(acc, dsa, Ks + slot * TILE);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<DH>(dq + q_base, acc, q0, r0, c0, a.Tq, D, one);
}

template <int DH, bool FLASH, bool DROPOUT>
__global__ void __launch_bounds__(kWG)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, AttnArgs a) {
  constexpr uint32_t TILE = DH / 64 * kBox;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + TILE;
  uint8_t* Qs = Vs + TILE;       // two stages
  uint8_t* dOs = Qs + 2 * TILE;  // two stages
  const Tail sh = carve_tail(dOs + 2 * TILE);

  const int k0 = blockIdx.x * kBK, h = blockIdx.y, b = blockIdx.z;
  const int D = row_stride<FLASH, DH>(a.H);
  const size_t q_base = head_offset<FLASH, DH>(b, h, a.H, a.Tq);
  const size_t kv_base = kv_offset<FLASH, DH>(q_base, b, h, a);
  const uint32_t bh = (uint32_t)(b * a.H + h);
  const bool seg = FLASH && a.q_seg != nullptr;
  // the key lengths do not depend on the query tile; the causal start does
  const KeyRange keys = key_range<FLASH>(a, b, 0);
  const int q_begin = a.causal ? k0 : 0;  // earlier query tiles see none of these keys
  // a key tile at or past kv_lengths[b] > 0 gets zero gradient
  const bool any_visible = keys.uniform || k0 < keys.len;
  const int n_tiles = any_visible ? (a.Tq - q_begin + kBQ - 1) / kBQ : 0;
  const float inv_t = 1.f / (float)a.Tk;
  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2), c0 = 2 * (lane & 3);

  auto load_q = [&](int i) {
    uint64_t* bar = sh.bar + 1 + (i & 1);
    mbar_expect_tx(bar, 2 * TILE);
    tma_tile<FLASH, DH>(Qs + (i & 1) * TILE, &tq, q_begin + i * kBQ, h, b, bar);
    tma_tile<FLASH, DH>(dOs + (i & 1) * TILE, &tdo, q_begin + i * kBQ, h, b, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(sh.bar + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(sh.bar, 2 * TILE);
    tma_tile<FLASH, DH>(Ks, &tk, k0, h, b, sh.bar);
    tma_tile<FLASH, DH>(Vs, &tv, k0, h, b, sh.bar);
    for (int i = 0; i < 2 && i < n_tiles; ++i) load_q(i);
  }
  if (seg) load_segments(sh.kvseg, a.kv_seg, b, k0, a.Tk);  // read after the loop's barrier

  float acc_dk[DH / 2], acc_dv[DH / 2];
  zero(acc_dk);
  zero(acc_dv);
  if (n_tiles > 0) mbar_wait(sh.bar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = q_begin + i * kBQ, slot = i & 1;
    if (i > 0) {
      __syncthreads();  // query tile i - 1 is done: its stage and row data are free
      if (tid == 0 && i + 1 < n_tiles) load_q(i + 1);
    }
    if (tid < kBQ) {  // the query rows' lse and delta (the dQ kernel's)
      const bool in_rows = q0 + tid < a.Tq;
      sh.lse[tid] = in_rows ? lse[(size_t)bh * a.Tq + q0 + tid] : 0.f;
      sh.delta[tid] = in_rows ? delta[(size_t)bh * a.Tq + q0 + tid] : 0.f;
    }
    if (seg) load_segments(sh.qseg, a.q_seg, b, q0, a.Tq);
    if (DROPOUT) dropout_tile<kWG>(sh.keep, bh, q0, k0, a.threshold, a.seed_lo, a.seed_hi);
    mbar_wait(sh.bar + 1 + slot, (i >> 1) & 1);
    __syncthreads();

    // transposed tiles: rows are this CTA's keys, columns the query tile
    float s[32], dp[32];
    zero(s);
    zero(dp);
    wgmma_fence();
    scores<DH>(s, Ks, Qs + slot * TILE);
    scores<DH>(dp, Vs, dOs + slot * TILE);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int kr = r0 + 8 * ii, key = k0 + kr;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = 8 * jj + c0 + e, row = q0 + qc, idx = 4 * jj + 2 * ii + e;
          const bool in_bounds = row < a.Tq && key < a.Tk;
          const bool visible = in_bounds && is_visible<FLASH>(a, keys, row, key) &&
                               (!seg || sh.qseg[qc] == sh.kvseg[kr]);
          const bool kept = !DROPOUT || sh.keep[qc * 64 + kr] != 0;
          float pd, ds;
          grad_element<DROPOUT>(s[idx], dp[idx], in_bounds, keys.uniform, visible, sh.lse[qc],
                                sh.delta[qc], kept, a, inv_t, pd, ds);
          s[idx] = pd;
          dp[idx] = ds;
        }
      }
    }
    uint32_t pda[4][4], dsa[4][4];
    to_a_operand(s, pda);   // bf16(Pd)^T
    to_a_operand(dp, dsa);  // bf16(dS * scale)^T
    wgmma_fence();
    accumulate<DH>(acc_dv, pda, dOs + slot * TILE);
    accumulate<DH>(acc_dk, dsa, Qs + slot * TILE);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<DH>(dk + kv_base, acc_dk, k0, r0, c0, a.Tk, D, one);
  store_rows<DH>(dv + kv_base, acc_dv, k0, r0, c0, a.Tk, D, one);
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

template <int DH, bool FLASH, bool DROPOUT>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       const AttnArgs& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>(5);
  static bool configured = false;
  cudaError_t err = allow_smem(fwd_kernel<DH, FLASH, DROPOUT>, smem, configured);
  CUtensorMap mq, mk, mv;
  if (err == cudaSuccess) err = make_map<FLASH>(&mq, q, B, a.H, a.Tq, DH);
  if (err == cudaSuccess) err = make_map<FLASH>(&mk, k, B, a.H, a.Tk, DH);
  if (err == cudaSuccess) err = make_map<FLASH>(&mv, v, B, a.H, a.Tk, DH);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + kBQ - 1) / kBQ, a.H, B);
  fwd_kernel<DH, FLASH, DROPOUT><<<grid, kWG, smem, stream>>>(mq, mk, mv, static_cast<bf16*>(o),
                                                              lse, a);
  return cudaGetLastError();
}

// the dQ kernel, then the dK/dV kernel; `delta` (B, H, Tq) f32 carries each
// row's delta from the first to the second
template <int DH, bool FLASH, bool DROPOUT>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, const AttnArgs& a, cudaStream_t stream) {
  if (delta == nullptr) return cudaErrorInvalidValue;
  constexpr size_t smem_dq = smem_bytes<DH>(6), smem_dkdv = smem_bytes<DH>(6);
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
  const bf16* o_ = static_cast<const bf16*>(o);
  const bf16* do_ = static_cast<const bf16*>(dout);
  const dim3 grid_dq((a.Tq + kBQ - 1) / kBQ, a.H, B);
  bwd_dq_kernel<DH, FLASH, DROPOUT><<<grid_dq, kWG, smem_dq, stream>>>(
      mq, mk, mv, mdo, o_, do_, lse, delta, static_cast<bf16*>(dq), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_dkdv((a.Tk + kBK - 1) / kBK, a.H, B);
  bwd_dkdv_kernel<DH, FLASH, DROPOUT><<<grid_dkdv, kWG, smem_dkdv, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), a);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace kokoro_attn
