// Packed fused-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel kokoro_tpu/ops/fused_attention.py::_call_bwd_packed
// (body _bwd_kernel_packed), both variants (causal; non-causal with
// kv_lengths), and K3's backward (fused_attention.py::_call_bwd) on the folded
// view, with the same attention-weight dropout mask as the forward.  Inputs
// q, k, v, o, dO of shape (B, T, H*Dh), f32 or bf16, Dh in {64, 128}, any
// T >= 1, and the forward's f32 row log-sum-exp (B, H, T); outputs dQ, dK, dV
// of the inputs' shape and type.  The kernels are attention_kernels.cuh's dQ
// and dK/dV kernels with the packed mask policy: exactly the reference's
// recompute (p from the -1e9-masked logits, pd and dp through the dropout
// mask, each row's delta the f32 sum of p * dp; the f32 kernels take it as
// rowsum(dO * O), which the f32 O makes the same sum to f32 rounding).
//
// What bounds it on an H100: it reads q, k, v, o, dO and writes dQ, dK, dV
// (8 * B*T*H*Dh elements: 134 MB in bf16 at B=32, T=512, H=8, Dh=64, about
// 40 us at 3.35 TB/s) and does 10 * Dh operations per visible (query, key)
// pair (21.5 GFLOP causal at that shape: 22 us at the bf16 tensor-core peak
// the bf16 kernels run on, 0.32 ms at the 67 TFLOP/s f32 FMA rate of the f32
// kernels on the CUDA cores).  The bf16 dQ kernel streams the key tiles
// twice (the rows' delta, then dQ).  Shared memory of dK/dV: bf16 54 KB (Dh
// 64) / 102 KB (Dh 128), f32 109 / 175 KB.

#include "attention_kernels.cuh"

using namespace kokoro_attn;

// Gradients of kokoro_packed_attention_fwd.  o and lse are the forward's
// outputs for the same q, k, v, kv_lengths, scale, causal, dropout, threshold,
// inv_keep and seed.  delta: a (B, H, T) f32 workspace the bf16 kernels pass
// each row's delta through (NULL for float32).  dtype: 0 = float32, 1 =
// bfloat16.  Launches the dQ kernel, then the dK/dV kernel, on `stream`; does
// not synchronise.  Returns a cudaError_t (0 on success).
extern "C" int kokoro_packed_attention_bwd(const void* q, const void* k, const void* v,
                                           const void* o, const void* dout,
                                           const float* lse, float* delta, void* dq, void* dk,
                                           void* dv,
                                           const int* kv_lengths, int B, int T_len, int H,
                                           int Dh, float scale, int causal, int dtype,
                                           int dropout, uint32_t threshold, float inv_keep,
                                           unsigned long long seed, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const AttnArgs a{kv_lengths, nullptr, nullptr, T_len, T_len, H, scale, causal,
                   threshold, inv_keep, (uint32_t)(seed & 0xffffffffull),
                   (uint32_t)(seed >> 32)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dropout)
    return (int)dispatch_bwd<false, true>(dtype, Dh, q, k, v, o, dout, lse, delta, dq, dk,
                                          dv, B, a, s);
  return (int)dispatch_bwd<false, false>(dtype, Dh, q, k, v, o, dout, lse, delta, dq, dk, dv,
                                         B, a, s);
}
