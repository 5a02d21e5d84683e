// The attention kernels of the port, templated on a mask policy: the f32
// forward here, the f32 backward in attention_tf32.cuh, the bf16 forward and
// backward in attention_tc.cuh, and the dispatch between them at the end of
// this file.  The entry points (packed_attention.cu,
// packed_attention_bwd.cu, flash_attention.cu, flash_attention_bwd.cu) are
// thin launches of these templates.
//
// Two policies (template parameter FLASH):
//   packed (K1, K2, K3): q, k, v, o of shape (B, T, H*Dh), heads packed last
//     (rows H*Dh elements apart); causal triangle (col <= row) or keys at
//     col >= kv_lengths[b] masked; a masked logit is REPLACED by -1e9, so a
//     row whose keys are all masked averages V uniformly; optional
//     attention-weight dropout drawn in the kernel (attention_common.cuh).
//   flash (K4): q (B, H, Tq, Dh), k, v (B, H, Tk, Dh), head-first (rows Dh
//     elements apart); optional causal triangle and optional segment ids
//     q_seg (B, Tq), kv_seg (B, Tk), a key masked where its segment differs
//     from the query's; a masked logit gets -0.7 * FLT_MAX ADDED (the library
//     flash attention's DEFAULT_MASK_VALUE); no dropout.  A query row with no
//     visible key writes O = 0 and lse = +inf, so its P, and every gradient
//     through it, is 0.
// Both: f32 or bf16, Dh in {64, 128}, any lengths >= 1 (the ragged edge is
// masked by bounds: rows and columns past the end are zero-filled on load,
// excluded from the softmax and never stored).
//
// Numerics of both: S = Q K^T in f32, S *= scale, then the mask; an online
// softmax over key tiles with the unnormalised exp(S - m_running) rounded to
// the input type before its product with V (f32 sums), the row sum l of the
// unrounded weights; dropped weights leave the P tile and 1/keep joins 1/l at
// the end; O in the input type; the f32 row log-sum-exp m + log(l) written
// for the backward.  The backward recomputes
//   p = exp(s - lse);  pd = kept ? p / keep : 0;  dV = bf16(pd)^T dO;
//   dpd = dO V^T;  dp = kept ? dpd / keep : 0;  dS = p * (dp - rowsum(dO * O));
//   dQ = bf16(dS * scale) K;  dK = bf16(dS * scale)^T Q
// with f32 sums ("bf16(.)" is the identity for f32 inputs).  rowsum(dp * p)
// equals rowsum(dO * O) exactly (dropout included); the kernels take it from
// O (the library flash attention's `di`).  A packed row of kv length 0 (every
// key at -1e9) has p = 1/T for every key, which its lse cannot give (-1e9 +
// log T rounds to -1e9 in f32), so that case is set directly.
//
// Design.  The TPU kernels keep a head's whole (T, T) score tile in VMEM (the
// packed and folded kernels) or walk a sequential (q block, k block) grid
// carrying m, l and the accumulator in VMEM scratch (flash); an SM has 227 KB
// of shared memory and a CUDA CTA cannot carry state to another, so every
// kernel tiles the sequence:
//   * forward: a CTA owns query rows and loops over key tiles: S tile ->
//     running row max and sum in f32 -> P -> O accumulators in registers.
//   * backward (FlashAttention-2's split, no atomics): a dQ kernel whose CTA
//     owns query rows (Q, dO and the dQ accumulators) and loops over key
//     tiles, then a dK/dV kernel whose CTA owns keys (K, V and the dK, dV
//     accumulators) and loops over query tiles (S and dPd tiles, then
//     dV += Pd^T dO and dK += dS^T Q).  The dQ kernel hands each row's delta
//     to the dK/dV kernel through a (B, H, Tq) f32 workspace, and each
//     gradient element is written by one thread: bitwise deterministic.
// Causal CTAs stop at (forward, dQ) or start from (dK/dV) the diagonal tile;
// with kv_lengths they stop at ceil(kv_lengths[b] / 64) tiles and a key tile
// at or past kv_lengths[b] > 0 writes zero gradient (exp(-1e9 - lse) is 0 in
// f32).  The packed kernels index (B, T, H*Dh) directly, so no head transpose
// exists.  Dropout flags come from Philox as a CTA reaches a tile; rate 0
// compiles without them (template parameter DROPOUT).
//
// bf16 runs on the tensor cores (attention_tc.cuh: wgmma products, TMA loads,
// P, Pd and dS kept in registers as wgmma's A operand; both directions
// warp-specialised, a producer warpgroup feeding consumer warpgroups through
// a ring; the forward persistent, 128 query rows a work item).  The f32
// backward runs on the tensor cores in 3xTF32 (attention_tf32.cuh: each
// operand split into two TF32 parts, three mma.sync products for each
// product, as accurate as f32 FMA).  The f32 forward runs the scalar
// template below: one CTA a (b, h, 64-row query tile), a 256-thread CTA as a
// 16 x 16 grid, each thread 4 rows x 4 columns of a 64-key tile, tiles
// widened to f32 in shared memory, P through shared memory, f32 FMA on the
// CUDA cores.  f32 trains too: TrainingConfig.compute_dtype = "float32",
// which `kokoro-train --profile-dtypes` picks where its A/B finds it faster,
// runs K1, K2 and the packed backward in f32 with use_flash_attention.
//
// What bounds them on an H100 (989 TFLOP/s bf16 tensor cores; f32-accurate
// work 165 TFLOP/s on the TF32 tensor cores in three products, 67 at the CUDA
// cores' f32 FMA rate; 3.35 TB/s): a call moves 4 (forward) or 8 (backward)
// tensors of B*T*H*Dh elements and does 4*Dh (forward) or 10*Dh (backward)
// operations per visible (query, key) pair.  At the decoder's T=512 the
// bf16 calls are bounded by their bytes (about 0.02 / 0.04 ms at B=32); at
// the long path's T=1408 by their operations (0.025 ms for K4's forward,
// 0.123 ms for the kv-length backward); the f32 calls by their operations.
// The persistent bf16 forwards reach 32-45 % of their bound, the bf16
// backwards 20-29 %; the f32 rows are in PERF.md §6 (NVIDIA H100 80GB HBM3
// at 700 W).

#pragma once

#include <math.h>

#include "attention_common.cuh"
#include "attention_tc.cuh"
#include "attention_tf32.cuh"

namespace kokoro_attn {

template <typename T, int DH, bool FLASH, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, AttnArgs a) {
  constexpr int QS = DH + 4;  // padded strides: conflict-free float4 reads
  constexpr int KS = DH + 4;
  constexpr int VS = DH;
  constexpr int PS = kBK + 4;
  constexpr int G = DH / 64;  // 4-column groups per thread in O
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * KS;
  float* Ps = Vs + kBK * VS;
  uint8_t* keep = reinterpret_cast<uint8_t*>(Ps + kBQ * PS);  // DROPOUT only
  int* kvseg_s = reinterpret_cast<int*>(Ps + kBQ * PS);       // FLASH only

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = row_stride<FLASH, DH>(a.H);
  const size_t q_base = head_offset<FLASH, DH>(b, h, a.H, a.Tq);
  const size_t kv_base = kv_offset<FLASH, DH>(q_base, b, h, a);
  const uint32_t bh = (uint32_t)(b * a.H + h);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const bool seg = FLASH && a.q_seg != nullptr;
  const KeyRange keys = key_range<FLASH>(a, b, q0);

  int qseg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    qseg[i] = (seg && row < a.Tq) ? a.q_seg[(size_t)b * a.Tq + row] : 1;
  }

  load_tile<T, DH, QS>(Qs, q + q_base, q0, a.Tq, D);

  float m[4], l[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < keys.kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's P V is done with Ks, Vs, Ps, keep/kvseg_s
    load_tile<T, DH, KS>(Ks, k + kv_base, k0, a.Tk, D);
    load_tile<T, DH, VS>(Vs, v + kv_base, k0, a.Tk, D);
    if (DROPOUT) dropout_tile(keep, bh, q0, k0, a.threshold, a.seed_lo, a.seed_hi);
    if (seg) load_segments(kvseg_s, a.kv_seg, b, k0, a.Tk);
    __syncthreads();

    float s[4][4];
    dot_tile<DH, QS, KS>(Qs, Ks, ty, tx, s);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int col = k0 + c;
        float val;
        if (col >= a.Tk) {
          val = -INFINITY;  // not a key at all: excluded from the softmax
        } else {
          const bool visible =
              is_visible<FLASH>(a, keys, row, col) && (!seg || qseg[i] == kvseg_s[c]);
          val = s[i][j] * a.scale;
          if (!visible) val = FLASH ? val + kFlashMask : kMasked;
        }
        s[i][j] = val;
        tile_max = fmaxf(tile_max, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      // every visited tile holds column k0 < Tk, so m_new is finite
      const float m_new = fmaxf(m[i], tile_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        float kept = round_to(p, q);
        if (DROPOUT && !keep[(ty * 4 + i) * 64 + tx + 16 * j]) kept = 0.f;
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = kept;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * PS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[4 * G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 t =
              *reinterpret_cast<const float4*>(Vs + (kk + u) * VS + 64 * g + tx * 4);
          vv[4 * g] = t.x; vv[4 * g + 1] = t.y; vv[4 * g + 2] = t.z; vv[4 * g + 3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y : u == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < 4 * G; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.Tq) continue;
    // flash: a visible logit is far above half the mask value, and a row that
    // saw only masked keys has m at the mask value; a packed masked logit is
    // -1e9, so every packed row counts as visible
    const bool any_visible = !FLASH || m[i] > 0.5f * kFlashMask;
    const float inv = any_visible ? (DROPOUT ? a.inv_keep : 1.f) / l[i] : 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = acc[i][4 * g + e] * inv;
      store4(o + q_base + (size_t)row * D + 64 * g + tx * 4, out);
    }
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * a.Tq + row] = any_visible ? m[i] + logf(l[i]) : INFINITY;
  }
}

// -- launches ---------------------------------------------------------------

template <typename T, int DH, bool FLASH, bool DROPOUT>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, const AttnArgs& a, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * (kBQ * (DH + 4) + kBK * (DH + 4) + kBK * DH + kBQ * (kBK + 4)) +
      (FLASH ? sizeof(int) * kBK : 0) + (DROPOUT ? kBQ * kBK : 0);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<T, DH, FLASH, DROPOUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.Tq + kBQ - 1) / kBQ, a.H, B);
  attention_fwd_kernel<T, DH, FLASH, DROPOUT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, a);
  return cudaGetLastError();
}

// dtype: 0 = float32 (the scalar forward above), 1 = bfloat16 (the
// tensor-core forward of attention_tc.cuh); Dh 64 or 128.  `res`: NULL, or
// (bf16 only) where the forward writes O's rounding residual for the backward
template <bool FLASH, bool DROPOUT>
cudaError_t dispatch_fwd(int dtype, int Dh, const void* q, const void* k, const void* v,
                         void* o, void* res, float* lse, int B, const AttnArgs& a,
                         cudaStream_t s) {
  if (dtype == 0 && res != nullptr) return cudaErrorInvalidValue;
  if (dtype == 0 && Dh == 64) return launch_fwd<float, 64, FLASH, DROPOUT>(q, k, v, o, lse, B, a, s);
  if (dtype == 0 && Dh == 128) return launch_fwd<float, 128, FLASH, DROPOUT>(q, k, v, o, lse, B, a, s);
  if (dtype == 1 && Dh == 64) return tc::launch_fwd<64, FLASH, DROPOUT>(q, k, v, o, res, lse, B, a, s);
  if (dtype == 1 && Dh == 128) return tc::launch_fwd<128, FLASH, DROPOUT>(q, k, v, o, res, lse, B, a, s);
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32 (the 3xTF32 kernels of attention_tf32.cuh), 1 =
// bfloat16 (attention_tc.cuh); Dh 64 or 128.  `delta`: the (B, H, Tq) f32
// workspace that carries each row's delta from the dQ kernel to the dK/dV
// kernel (both dtypes).  `res`: the packed bf16 forward's residual of O
// (NULL otherwise)
template <bool FLASH, bool DROPOUT>
cudaError_t dispatch_bwd(int dtype, int Dh, const void* q, const void* k, const void* v,
                         const void* o, const void* res, const void* dout, const float* lse,
                         float* delta, void* dq, void* dk, void* dv, int B, const AttnArgs& a,
                         cudaStream_t s) {
  if (dtype == 0 && res != nullptr) return cudaErrorInvalidValue;
  if (dtype == 0 && Dh == 64)
    return tf32::launch_bwd<64, FLASH, DROPOUT>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, a, s);
  if (dtype == 0 && Dh == 128)
    return tf32::launch_bwd<128, FLASH, DROPOUT>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, a,
                                                 s);
  if (dtype == 1 && Dh == 64)
    return tc::launch_bwd<64, FLASH, DROPOUT>(q, k, v, o, res, dout, lse, delta, dq, dk, dv, B,
                                              a, s);
  if (dtype == 1 && Dh == 128)
    return tc::launch_bwd<128, FLASH, DROPOUT>(q, k, v, o, res, dout, lse, delta, dq, dk, dv, B,
                                               a, s);
  return cudaErrorInvalidValue;
}

}  // namespace kokoro_attn
