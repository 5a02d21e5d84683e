// Packed fused-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel kokoro_tpu/ops/fused_attention.py::_call_fwd_packed
// (body _fwd_kernel_packed), both variants:
//   K1  causal self-attention          (causal = 1, kv_lengths = NULL)
//   K2  non-causal cross-attention     (causal = 0, keys at col >= kv_lengths[b]
//                                        masked; q_len == kv_len)
// and K3 (kokoro_tpu/ops/fused_attention.py::_call_fwd) on the folded
// (B*H, T, Dh) view, i.e. packed with one head.  q, k, v, o of shape
// (B, T, H*Dh), heads packed last, float32 or bfloat16, Dh in {64, 128}, any
// T >= 1, optional attention-weight dropout drawn in the kernel.  The kernel
// is attention_kernels.cuh's forward with the packed mask policy (masked
// logits -1e9, as in the reference; a row whose keys are all masked averages
// V uniformly).
//
// What bounds it on an H100: at the decoder's shapes (B=32, T=512, H=8, Dh=64)
// the call moves 4 * B*T*H*Dh elements (67 MB in bf16, about 20 us at
// 3.35 TB/s) and does 4 * B*H*T*T*Dh operations (17.2 GFLOP non-causal, about
// half causal; about 17 us at the bf16 tensor-core peak).  bf16 runs on the
// tensor cores (attention_tc.cuh: wgmma, TMA); f32 on the CUDA cores in full
// f32 FMA (no TF32), whose ceiling is the 67 TFLOP/s f32 rate.

#include "attention_kernels.cuh"

using namespace kokoro_attn;

// dtype: 0 = float32, 1 = bfloat16.  kv_lengths: NULL or B int32 on the
// device.  lse: NULL or B*H*T float32 on the device.  res: NULL or (bf16
// only, under grad) a tensor like o that receives O's rounding residual
// bf16(O32 - bf16(O32)), the backward's delta.  dropout: 0 or 1; a
// weight is kept iff its Philox word is below `threshold`, and kept weights
// are scaled by inv_keep.  Returns a cudaError_t (0 on success); launches on
// `stream` and does not synchronise.
extern "C" int kokoro_packed_attention_fwd(const void* q, const void* k,
                                           const void* v, void* o, void* res, float* lse,
                                           const int* kv_lengths, int B,
                                           int T_len, int H, int Dh,
                                           float scale, int causal, int dtype,
                                           int dropout, uint32_t threshold,
                                           float inv_keep, unsigned long long seed,
                                           void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const AttnArgs a{kv_lengths, nullptr, nullptr, T_len, T_len, H, scale, causal,
                   threshold, inv_keep, (uint32_t)(seed & 0xffffffffull),
                   (uint32_t)(seed >> 32)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dropout) return (int)dispatch_fwd<false, true>(dtype, Dh, q, k, v, o, res, lse, B, a, s);
  return (int)dispatch_fwd<false, false>(dtype, Dh, q, k, v, o, res, lse, B, a, s);
}
