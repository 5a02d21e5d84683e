// Helpers of the attention kernels (attention_kernels.cuh, attention_tc.cuh):
// 64 x 64 tiles; for the f32 kernels 256 threads as a 16 x 16 grid and loads
// of rows D elements apart (the packed (B, T, H*Dh) layout, or head-first
// (B, H, T, Dh) with D = Dh) into f32 shared memory; the backward's row
// statistics; the counter-based dropout mask of the packed kernels; the
// arguments, layouts and mask tests both kernel families share.
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
constexpr int kThreads = 256;  // 16 x 16 threads, each 4 rows x 4 columns of a tile
constexpr float kMasked = -1e9f;  // the packed kernels' masked logit (reference: -1e9)
// the flash kernels' mask value, ADDED to a masked logit (the library's
// DEFAULT_MASK_VALUE)
constexpr float kFlashMask = -0.7f * FLT_MAX;

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

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

__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// a value rounded to the input type (the reference's casts of P and dS): the
// identity for the f32 kernels; the bf16 kernels round where the values
// become tensor-core operands (attention_tc.cuh, to_a_operand)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }

// rows [row0, row0 + 64) of one head -> shared memory as f32, row stride
// STRIDE; rows at or past row_end are zero.
template <typename T, int DH, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const T* head, int row0,
                                          int row_end, int D) {
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = DH / V;
  for (int idx = threadIdx.x; idx < 64 * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * V;
    float vals[V];
    if (row0 + r < row_end) {
      load16(head + (size_t)(row0 + r) * D + c, vals);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; i += 4) store4(dst + r * STRIDE + c + i, vals + i);
  }
}

// s[i][j] = sum_d A[ty*4 + i][d] * B[tx + 16 j][d] over two 64-row tiles in
// shared memory (row strides AS, BS; padded so the float4 reads are
// conflict-free).
template <int DH, int AS, int BS>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm, int ty,
                                         int tx, float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * AS + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * BS + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// rowsum(dO * O) and the saved lse of query rows [q0, q0 + 64) -> shared
// memory (0 for rows at or past T_len); rows are D elements apart from
// `base`.  kThreads / 64 threads per row.  The f32 backward kernels' di.
template <typename T, int DH>
__device__ __forceinline__ void row_stats(const T* o, const T* dout, const float* lse,
                                          size_t base, size_t lse_base, int q0, int T_len,
                                          int D, float* delta_s, float* lse_s) {
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = kThreads / 64;
  const int r = threadIdx.x / PER_ROW, part = threadIdx.x % PER_ROW;
  const int row = q0 + r;
  float sum = 0.f;
  if (row < T_len) {
    const T* orow = o + base + (size_t)row * D;
    const T* drow = dout + base + (size_t)row * D;
#pragma unroll
    for (int c = part * V; c < DH; c += PER_ROW * V) {
      float a[V], d[V];
      load16(orow + c, a);
      load16(drow + c, d);
#pragma unroll
      for (int e = 0; e < V; ++e) sum = fmaf(a[e], d[e], sum);
    }
  }
#pragma unroll
  for (int off = 1; off < PER_ROW; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (part == 0) {
    delta_s[r] = sum;
    lse_s[r] = row < T_len ? lse[lse_base + row] : 0.f;
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

// Keep flags of the 64 x 64 tile (rows row0.., columns col0..; col0 a
// multiple of 4) into shared bytes keep[r * 64 + c]: 1024 Philox calls shared
// by the CTA's NT threads.
template <int NT = kThreads>
__device__ __forceinline__ void dropout_tile(uint8_t* keep, uint32_t bh, int row0,
                                             int col0, uint32_t threshold,
                                             uint32_t k0, uint32_t k1) {
  for (int idx = threadIdx.x; idx < 64 * 16; idx += NT) {
    const int r = idx / 16, g = idx % 16;
    const uint4 bits = philox4x32_10(
        make_uint4(bh, (uint32_t)(row0 + r), (uint32_t)(col0 / 4 + g), 0u), k0, k1);
    const uchar4 flags = make_uchar4(bits.x < threshold, bits.y < threshold,
                                     bits.z < threshold, bits.w < threshold);
    *reinterpret_cast<uchar4*>(keep + r * 64 + 4 * g) = flags;
  }
}


// -- what both kernel families share (attention_kernels.cuh, attention_tc.cuh)

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

// segment ids of positions [p0, p0 + 64) of row b -> shared memory (1 past
// the end, as for a missing side)
__device__ __forceinline__ void load_segments(int* dst, const int* seg, int b, int p0,
                                              int len) {
  if (threadIdx.x < 64) {
    const int pos = p0 + threadIdx.x;
    dst[threadIdx.x] = pos < len ? seg[(size_t)b * len + pos] : 1;
  }
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
