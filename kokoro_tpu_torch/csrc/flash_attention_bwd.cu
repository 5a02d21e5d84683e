// K4 flash-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of the library flash attention's backward behind
// kokoro_tpu/models/blocks.py::_flash_attention: _flash_attention_bwd_dkv
// (body _flash_attention_dkv_kernel) and _flash_attention_bwd_dq (body
// _flash_attention_dq_kernel) of jax.experimental.pallas.ops.tpu.flash_attention.
// Inputs q, o, dO (B, H, Tq, Dh), k, v (B, H, Tk, Dh), head-first and
// contiguous, f32 or bf16, Dh in {64, 128, 192, 256} or a multiple of 64
// from 320 to 2048 (any multiple of 64: kokoro_flash_attention_bwd_scores
// below, the scores in device memory, which the wrappers take in bf16 from
// BF16_SCORES_FROM on, attention_scores_tc.cuh, and in f32 from
// F32_SCORES_FROM on, attention_scores_tf32.cuh), the forward's f32 row
// log-sum-exp (B, H, Tq) (flash_attention.cu) and the forward's causal flag
// and segment ids; outputs dQ, dK, dV of the inputs' shapes and type.  The
// kernels (dispatched by attention_kernels.cuh) are the dQ and dK/dV kernels
// of attention_tc.cuh (bf16) and attention_tf32.cuh (f32) with the flash
// mask policy: the library's recompute, p = exp(s - lse) from the saved
// statistics and di = rowsum(dO * O).  A row with no visible key has
// lse = +inf, so its p, and everything it contributes, is 0.  The library
// accumulates dK/dV over a sequential grid of query blocks in VMEM scratch,
// which CUDA CTAs cannot share; here each CTA owns its key tile and loops
// over the query tiles itself (no atomics).
//
// What bounds it on an H100: it reads q, k, v, o, dO and the lse and writes
// dQ, dK, dV (8 * B*H*T*Dh elements: 138 MB in bf16 at B=12, T=1408, H=8,
// Dh=64, about 41 us at 3.35 TB/s) and does 10 * Dh operations per visible
// (query, key) pair (61 GFLOP causal at that shape: 62 us at the bf16
// tensor-core peak the bf16 kernels run on; 0.370 ms at the 165 TFLOP/s of
// f32-accurate work the f32 kernels get from the TF32 tensor cores in three
// products, where the CUDA cores' 67 TFLOP/s f32 FMA rate would give 0.91
// ms).  Shared memory: bf16 82 / 164 KB a CTA (Dh 64 / 128), at Dh 192 / 256
// (attention_tc_wide.cuh) dQ 217.8 / 225.6 KB and dK/dV 211.3 / 226.5 KB; f32
// 226.5 (dQ) and 210.5 (dK/dV) / 209.75 (attention_tf32.cuh) / 225.1 /
// 224.75 KB (attention_tf32_wide.cuh).  From Dh 192 the bf16 dQ kernel's two
// consumer warpgroups of 64 rows share the streamed tiles, K and V in
// slots of their own; the dK/dV kernel's two share 64 keys, one computing
// S^T and handing P^T over and accumulating dV, the other dK (both
// accumulators of a 64-key tile would take Dh registers a thread); the f32
// kernels' four warps of each 16 rows split S's and dPd's
// contraction, exchange the two partials together once a 32-row tile, and
// read the streamed tiles raw, each warp splitting what it reads.
// From Dh 320 a cluster of ceil(Dh / 128) CTAs takes each 64-row tile, each
// CTA the Dh 128 kernel on its 128 columns, summing the cluster's partial S,
// dPd and row deltas in rank order through its peers' shared memory (f32:
// tiles of 32 streamed rows, the two warps of each 16 rows splitting each
// score's contraction, so that the exchange fits beside the Dh 128 tiles);
// past Dh 1024 the cluster (9 to 16 CTAs) is a non-portable size, which the
// kernels allow.

#include "attention_kernels.cuh"
#include "attention_scores.cuh"
#include "attention_scores_tc.cuh"
#include "attention_scores_tf32.cuh"

using namespace kokoro_attn;

// Gradients of kokoro_flash_attention_fwd.  o and lse are the forward's
// outputs for the same q, k, v, segment ids, scale and causal flag.  delta: a
// (B, H, Tq) f32 workspace the dQ kernel passes each row's di through to the
// dK/dV kernel.  dtype: 0 = float32, 1 = bfloat16.  Launches the dQ kernel,
// then the dK/dV kernel, on `stream`; does not synchronise.  Returns a
// cudaError_t (0 on success).
extern "C" int kokoro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const float* lse,
                                          float* delta, void* dq, void* dk, void* dv,
                                          const int* q_seg,
                                          const int* kv_seg, int B, int H, int Tq, int Tk,
                                          int Dh, float scale, int causal, int dtype,
                                          void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || H > 65535 || B > 65535 ||
      (q_seg == nullptr) != (kv_seg == nullptr))
    return (int)cudaErrorInvalidValue;
  const AttnArgs a{nullptr, q_seg, kv_seg, Tq, Tk, H, scale, causal, 0u, 1.f, 0u, 0u};
  return (int)dispatch_bwd<true, false>(dtype, Dh, q, k, v, o, nullptr, dout, lse, delta, dq,
                                        dk, dv, B, a, static_cast<cudaStream_t>(stream));
}

// Clusters of c CTAs (3 to 16, c = ceil(Dh / 128)) of the backward's dQ and
// dK/dV cluster kernels the card holds at once, at their shared memory, into
// *dq_clusters and *dkdv_clusters (0: none, and a launch at such a head dim
// returns cudaErrorInvalidConfiguration).  dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t.
extern "C" int kokoro_flash_attention_bwd_clusters(int dtype, int c, int* dq_clusters,
                                                   int* dkdv_clusters) {
  if (dq_clusters == nullptr || dkdv_clusters == nullptr || c < 3 || c > tc::kMaxClusterCtas)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)tf32::bwd_split_fit(c, *dq_clusters, *dkdv_clusters);
  if (dtype == 1) return (int)tc::bwd_split_fit(c, *dq_clusters, *dkdv_clusters);
  return (int)cudaErrorInvalidValue;
}

// Gradients of kokoro_flash_attention_fwd_scores (o and lse its outputs for
// the same inputs): each row's delta, the scores kernel's P and dS, then
// dQ = dS K, dK = dS^T Q, dV = P^T dO; five launches on `stream`.
// Workspaces: delta (B H, Tq) f32; bf16 (attention_scores_tc.cuh): p_ws (P)
// and ds_ws (dS) (B H, Mq, Nk), dst_ws unused (NULL); f32 (attention_scores_tf32.cuh): p_ws P^T
// (B H, Nk, Mq), ds_ws dS (B H, Mq, Nk) and dst_ws dS^T (B H, Nk, Mq);
// Mq, Nk = Tq, Tk rounded up to 128.  Returns a cudaError_t; does not
// synchronise.
extern "C" int kokoro_flash_attention_bwd_scores(const void* q, const void* k, const void* v,
                                                 const void* o, const void* dout,
                                                 const float* lse, float* delta, void* dq,
                                                 void* dk, void* dv, const int* q_seg,
                                                 const int* kv_seg, void* p_ws, void* ds_ws,
                                                 void* dst_ws, int B, int H, int Tq, int Tk,
                                                 int Dh,
                                                 float scale, int causal, int dtype,
                                                 void* stream) {
  if (!scores::valid(B, H, Tq, Tk, Dh, q_seg, kv_seg) || p_ws == nullptr || ds_ws == nullptr ||
      delta == nullptr || lse == nullptr)
    return (int)cudaErrorInvalidValue;
  scores::Args a{};
  a.q = q, a.k = k, a.v = v, a.o = o, a.dout = dout, a.q_seg = q_seg, a.kv_seg = kv_seg;
  a.lse = lse, a.delta = delta, a.p = p_ws, a.ds = ds_ws;
  a.H = H, a.Tq = Tq, a.Tk = Tk, a.Dh = Dh;
  a.Mq = scores::tiles_of(Tq) * scores::kTile, a.Nk = scores::tiles_of(Tk) * scores::kTile;
  a.scale = scale, a.causal = causal != 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (dst_ws == nullptr) return (int)cudaErrorInvalidValue;
    return (int)scores_tf32::launch_bwd(a, dst_ws, dq, dk, dv, B * H, st);
  }
  if (dtype == 1) return (int)scores_tc::launch_bwd(a, dq, dk, dv, B * H, st);
  return (int)cudaErrorInvalidValue;
}

