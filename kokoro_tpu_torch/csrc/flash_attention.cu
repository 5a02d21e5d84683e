// K4 flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel behind kokoro_tpu/models/blocks.py::_flash_attention:
// the Pallas flash attention of jax.experimental.pallas.ops.tpu.flash_attention
// (forward body _flash_attention_kernel, pl.pallas_call in
// _flash_attention_impl), which the JAX package runs for causal decoder
// self-attention at T >= 1024 with T a multiple of 128.  Here: q of shape
// (B, H, Tq, Dh), k and v (B, H, Tk, Dh), o like q, head-first and contiguous,
// float32 or bfloat16, Dh in {64, 128}, any Tq, Tk >= 1; optional causal mask
// (col <= row) and optional segment ids q_seg (B, Tq), kv_seg (B, Tk) int32
// (the library's SegmentIds: valid = 1, padding = 0).  The kernel is
// attention_kernels.cuh's forward with the flash mask policy, which keeps the
// library's numerics: -0.7 * FLT_MAX added to a masked logit, the
// unnormalised weights rounded to the input type before their product with V,
// the f32 row log-sum-exp for the backward.  A query row with no visible key
// (outside the library's contract: its kernel and its reference disagree
// there) gets O = 0 and lse = +inf, so its P, and every gradient through it,
// is 0.
//
// What bounds it on an H100: at the long training shape (B=12, T=1408, H=8,
// Dh=64, causal) the call moves 4 * B*H*T*Dh elements (69 MB in bf16, about
// 21 us at 3.35 TB/s) and does 4 * Dh operations per visible (query, key)
// pair (95 M causal pairs: 24.4 GFLOP, about 25 us at the bf16 tensor-core
// peak).  bf16 runs on the tensor cores (attention_tc.cuh: wgmma, TMA), f32
// on the CUDA cores in f32 FMA, whose 67 TFLOP/s rate is its ceiling (0.36 ms
// here).

#include "attention_kernels.cuh"

using namespace kokoro_attn;

// q (B, H, Tq, Dh); k, v (B, H, Tk, Dh); o like q.  dtype: 0 = float32,
// 1 = bfloat16.  q_seg (B, Tq) and kv_seg (B, Tk) int32 on the device, both
// NULL or both given.  lse: NULL or B*H*Tq float32 on the device.  Returns a
// cudaError_t (0 on success); launches on `stream` and does not synchronise.
extern "C" int kokoro_flash_attention_fwd(const void* q, const void* k, const void* v,
                                          void* o, float* lse, const int* q_seg,
                                          const int* kv_seg, int B, int H, int Tq, int Tk,
                                          int Dh, float scale, int causal, int dtype,
                                          void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || H > 65535 || B > 65535 ||
      (q_seg == nullptr) != (kv_seg == nullptr))
    return (int)cudaErrorInvalidValue;
  const AttnArgs a{nullptr, q_seg, kv_seg, Tq, Tk, H, scale, causal, 0u, 1.f, 0u, 0u};
  return (int)dispatch_fwd<true, false>(dtype, Dh, q, k, v, o, nullptr, lse, B, a,
                                        static_cast<cudaStream_t>(stream));
}
