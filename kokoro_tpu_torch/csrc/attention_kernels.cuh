// The attention kernels of the port, templated on a mask policy: the f32
// forward and backward in attention_tf32.cuh (K4 at Dh 192 and 256 in
// attention_tf32_wide.cuh), the bf16 forward and backward in attention_tc.cuh
// (K4 at Dh 192 and 256 in attention_tc_wide.cuh), and here their contract
// and the dispatch between them.  The entry points (packed_attention.cu,
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
// Both: f32 or bf16, Dh in {64, 128} (flash also {192, 256}, and every
// multiple of 64 from 320 to 2048: a cluster of ceil(Dh / 128) CTAs, 3 to
// 16, splits the head dim by columns, attention_tc.cuh), any lengths >= 1 (the ragged
// edge is masked by bounds: rows and columns past the end are zero-filled
// on load, excluded from the softmax and never stored).
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
// a ring; the forward persistent, 128 query rows a work item; K4 at Dh 192
// and 256 in attention_tc_wide.cuh).  f32 runs on
// the tensor cores in 3xTF32 in both directions (attention_tf32.cuh: each
// operand split into two TF32 parts, three mma.sync products for each
// product, as accurate as f32 FMA; the forward takes S by the backward's
// own products, so its lse and the backward's recompute agree bit for
// bit; K4 at Dh 192 and 256 in attention_tf32_wide.cuh, on raw streamed
// tiles that each warp splits as it reads them); the CUDA cores take only
// the softmax and the dropout.  f32 trains
// too: TrainingConfig.compute_dtype = "float32",
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
// backwards 20-29 %, the f32 rows 16-29 % (PERF.md §6; NVIDIA H100 80GB
// HBM3 at 700 W).

#pragma once

#include <math.h>

#include "attention_common.cuh"
#include "attention_tc.cuh"
#include "attention_tc_wide.cuh"
#include "attention_tf32.cuh"
#include "attention_tf32_wide.cuh"

namespace kokoro_attn {

// whether the flash policy's kernels take head dim Dh past 256: a multiple
// of 64 up to 2048, the head dim split over a cluster of ceil(Dh / 128) CTAs
// (3 to 16; past 8 a non-portable cluster size)
inline bool cluster_head_dim(int Dh) {
  return Dh > 256 && Dh <= tc::kMaxClusterDh && Dh % 64 == 0;
}

// dtype: 0 = float32 (the 3xTF32 forward of attention_tf32.cuh; at Dh 192
// and 256 attention_tf32_wide.cuh's), 1 = bfloat16 (the tensor-core forward
// of attention_tc.cuh; at Dh 192 and 256 attention_tc_wide.cuh's); Dh 64 or
// 128, and for the flash policy (no dropout) also 192, 256 and
// cluster_head_dim's.
// `res`: NULL, or (bf16 only) where the forward writes O's rounding residual
// for the backward
template <bool FLASH, bool DROPOUT>
cudaError_t dispatch_fwd(int dtype, int Dh, const void* q, const void* k, const void* v,
                         void* o, void* res, float* lse, int B, const AttnArgs& a,
                         cudaStream_t s) {
  if (dtype == 0 && res != nullptr) return cudaErrorInvalidValue;
  if (dtype == 0 && Dh == 64)
    return tf32::launch_fwd<64, FLASH, DROPOUT>(q, k, v, o, lse, B, a, s);
  if (dtype == 0 && Dh == 128)
    return tf32::launch_fwd<128, FLASH, DROPOUT>(q, k, v, o, lse, B, a, s);
  if (dtype == 1 && Dh == 64) return tc::launch_fwd<64, FLASH, DROPOUT>(q, k, v, o, res, lse, B, a, s);
  if (dtype == 1 && Dh == 128) return tc::launch_fwd<128, FLASH, DROPOUT>(q, k, v, o, res, lse, B, a, s);
  if constexpr (FLASH && !DROPOUT) {  // K4 also at Dh 192 and 256
    if (dtype == 0 && Dh == 192) return tf32::wide::launch_fwd<192>(q, k, v, o, lse, B, a, s);
    if (dtype == 0 && Dh == 256) return tf32::wide::launch_fwd<256>(q, k, v, o, lse, B, a, s);
    if (dtype == 1 && Dh == 192 && res == nullptr)
      return tc::wide::launch_fwd<192>(q, k, v, o, lse, B, a, s);
    if (dtype == 1 && Dh == 256 && res == nullptr)
      return tc::wide::launch_fwd<256>(q, k, v, o, lse, B, a, s);
    if (cluster_head_dim(Dh) && res == nullptr) {
      if (dtype == 0) return tf32::launch_fwd_split(q, k, v, o, lse, B, Dh, a, s);
      if (dtype == 1) return tc::launch_fwd_split(q, k, v, o, lse, B, Dh, a, s);
    }
  }
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32 (the 3xTF32 kernels of attention_tf32.cuh; at Dh 192
// and 256 attention_tf32_wide.cuh's), 1 = bfloat16 (attention_tc.cuh; at
// Dh 192 and 256 attention_tc_wide.cuh's); Dh 64 or 128, and for the flash
// policy (no dropout) also 192, 256 and cluster_head_dim's.  `delta`: the
// (B, H, Tq) f32 workspace that
// carries each row's delta from the dQ kernel to the dK/dV kernel (both
// dtypes).  `res`: the packed bf16 forward's residual of O (NULL otherwise)
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
  if constexpr (FLASH && !DROPOUT) {  // K4 also at Dh 192 and 256
    if (dtype == 0 && Dh == 192)
      return tf32::wide::launch_bwd<192>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, a, s);
    if (dtype == 0 && Dh == 256)
      return tf32::wide::launch_bwd<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, a, s);
    if (dtype == 1 && Dh == 192 && res == nullptr)
      return tc::wide::launch_bwd<192>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, a, s);
    if (dtype == 1 && Dh == 256 && res == nullptr)
      return tc::wide::launch_bwd<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, a, s);
    if (cluster_head_dim(Dh) && res == nullptr) {
      if (dtype == 0)
        return tf32::launch_bwd_split(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Dh, a, s);
      if (dtype == 1)
        return tc::launch_bwd_split(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Dh, a, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace kokoro_attn
