// K4 flash-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of the library flash attention's backward behind
// kokoro_tpu/models/blocks.py::_flash_attention: _flash_attention_bwd_dkv
// (body _flash_attention_dkv_kernel) and _flash_attention_bwd_dq (body
// _flash_attention_dq_kernel) of jax.experimental.pallas.ops.tpu.flash_attention.
// Inputs q, o, dO (B, H, Tq, Dh), k, v (B, H, Tk, Dh), head-first and
// contiguous, f32 or bf16, Dh in {64, 128}, the forward's f32 row
// log-sum-exp (B, H, Tq) (flash_attention.cu) and the forward's causal flag
// and segment ids; outputs dQ, dK, dV of the inputs' shapes and type.  The
// kernels are attention_kernels.cuh's dQ and dK/dV kernels with the flash
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
// tensor-core peak the bf16 kernels run on, 0.91 ms at the 67 TFLOP/s f32 FMA
// rate of the f32 kernels on the CUDA cores).

#include "attention_kernels.cuh"

using namespace kokoro_attn;

// Gradients of kokoro_flash_attention_fwd.  o and lse are the forward's
// outputs for the same q, k, v, segment ids, scale and causal flag.  delta: a
// (B, H, Tq) f32 workspace the bf16 kernels pass each row's di through (NULL
// for float32).  dtype: 0 = float32, 1 = bfloat16.  Launches the dQ kernel,
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
