// Helpers of the attention kernels (attention_kernels.cuh, attention_tc.cuh,
// attention_tf32.cuh): 64 x 64 tiles, bf16 loads widened to f32, the
// counter-based dropout mask of the packed kernels, and the arguments,
// layouts (rows D elements apart: the packed (B, T, H*Dh) layout, or
// head-first (B, H, T, Dh) with D = Dh) and mask tests the kernel families
// share.
//
// Dropout: the TPU kernels draw attention-weight dropout from the TPU core's
// hardware PRNG (kokoro_tpu/ops/fused_attention.py::_dropout_mask), whose
// bits no other machine reproduces.  Here the mask is Philox4x32-10 (Salmon
// et al., "Parallel random numbers: as easy as 1, 2, 3", SC'11), a pure
// function of (seed, b*H + h, row, col): key = the call's 64-bit seed,
// counter = (b*H + h, row, col / 4, 0); one call gives the bits of the 4
// adjacent columns 4*(col/4) .. +3, and a weight is kept iff its 32-bit word
// is below floor(keep * 2^32), the reference's threshold.  Any tiling
// regenerates the same mask, so the forward and both backward kernels agree
// without the mask ever reaching device memory; kokoro_tpu_torch/ops/philox.py
// is the same generator in plain PyTorch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace kokoro_attn {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // key columns per tile
constexpr float kMasked = -1e9f;  // the packed kernels' masked logit (reference: -1e9)
// the flash kernels' mask value, ADDED to a masked logit (the library's
// DEFAULT_MASK_VALUE)
constexpr float kFlashMask = -0.7f * FLT_MAX;

// 8 bf16 values (16 bytes) widened to f32
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Philox4x32-10 (Random123's constants and round function).
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint32_t k0, uint32_t k1) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, ctr.x), lo0 = M0 * ctr.x;
    const uint32_t hi1 = __umulhi(M1, ctr.z), lo1 = M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0);
  }
  return ctr;
}

// -- what the kernel families share (attention_tc.cuh, attention_tf32.cuh)

// what a kernel needs besides the tensors
struct AttnArgs {
  const int* kv_lengths;  // packed: (B,) or NULL
  const int* q_seg;       // flash: (B, Tq) segment ids or NULL
  const int* kv_seg;      // flash: (B, Tk), given with q_seg
  int Tq, Tk, H;          // packed: Tq == Tk
  float scale;
  int causal;
  uint32_t threshold;  // dropout: a weight is kept iff its Philox word is below
  float inv_keep;
  uint32_t seed_lo, seed_hi;
  int dh;  // a cluster launch (K4 past Dh 256): the whole head dim; 0 otherwise
};

// offset of row 0 of head h of batch b, and the distance between rows
template <bool FLASH, int DH>
__device__ __forceinline__ size_t head_offset(int b, int h, int H, int T) {
  return FLASH ? ((size_t)b * H + h) * T * DH : (size_t)b * T * H * DH + (size_t)h * DH;
}

template <bool FLASH, int DH>
__device__ __forceinline__ int row_stride(int H) {
  return FLASH ? DH : H * DH;
}

// The keys a CTA of query tile q0 visits end at kv_end; keys at col >= len
// are masked.  A packed row of kv length 0 (uniform) sees every key.
struct KeyRange {
  int len, kv_end;
  bool uniform;
};

template <bool FLASH>
__device__ __forceinline__ KeyRange key_range(const AttnArgs& a, int b, int q0) {
  KeyRange r{a.Tk, a.Tk, false};
  if (a.causal) {
    r.kv_end = min(a.Tk, q0 + kBQ);
  } else if (!FLASH && a.kv_lengths != nullptr) {
    r.len = a.kv_lengths[b];
    r.uniform = r.len <= 0;
    r.kv_end = r.uniform ? a.Tk : min(r.len, a.Tk);
  }
  return r;
}

// offset of the key/value head: packed q and kv share it (Tq == Tk)
template <bool FLASH, int DH>
__device__ __forceinline__ size_t kv_offset(size_t q_base, int b, int h, const AttnArgs& a) {
  return FLASH ? head_offset<FLASH, DH>(b, h, a.H, a.Tk) : q_base;
}

// whether key col (< Tk) is visible to query row before segment ids: flash
// the optional causal triangle, packed the causal triangle or the kv length.
// The callers AND the segment test after it, so that the segment ids are
// read only when there are any.
template <bool FLASH>
__device__ __forceinline__ bool is_visible(const AttnArgs& a, const KeyRange& keys, int row,
                                           int col) {
  if (FLASH) return !a.causal || col <= row;
  return a.causal ? col <= row : col < keys.len;
}

}  // namespace kokoro_attn
