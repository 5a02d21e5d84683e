// Packed fused-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel kokoro_tpu/ops/fused_attention.py::_call_fwd_packed
// (body _fwd_kernel_packed), both variants:
//   K1  causal self-attention          (causal = 1, kv_lengths = NULL)
//   K2  non-causal cross-attention     (causal = 0, keys at col >= kv_lengths[b]
//                                        masked; q_len == kv_len)
// on q, k, v, o of shape (B, T, H*Dh), heads packed last, float32 or bfloat16,
// Dh in {64, 128}, any T >= 1, with optional attention-weight dropout drawn in
// the kernel (attention_common.cuh: Philox keyed on the call's seed).
//
// What it computes, per (b, h): S = Q K^T * scale in f32; masked logits are
// -1e9 (not -inf), as in the reference, so a row whose keys are all masked
// averages V uniformly; softmax in f32; dropped weights are 0 and kept ones
// scaled by 1/keep; P rounded to the input type before P V (bf16: P rounded
// to bf16, products and sums in f32); O in the input type.  With `lse`
// given it also writes the f32 row log-sum-exp m + log(l) of the scaled,
// masked logits, shape (B, H, T), which the backward kernels recompute P
// from.
//
// What bounds it on an H100: at the decoder's shapes (B=32, T=512, H=8, Dh=64)
// the call moves 4 * B*T*H*Dh elements (67 MB in bf16, about 20 us at
// 3.35 TB/s) and does 4 * B*H*T*T*Dh operations (17.2 GFLOP non-causal, about
// half causal; about 17 us at the bf16 tensor-core peak).  This first version
// computes on the CUDA cores in f32 FMA (full f32 for f32 inputs, no TF32), so
// its own ceiling is the 67 TFLOP/s f32 rate; tensor cores (wgmma, TMA loads)
// are later work.
//
// Design: the TPU kernel keeps the whole (T, T) f32 score tile of a head in
// VMEM; an SM has 227 KB of shared memory, so this is a blocked online-softmax
// forward instead.  One CTA of 256 threads takes one (b, h, 64-row query tile),
// keeps the query tile in shared memory, and loops over 64-column key tiles:
// S tile (each thread 4 rows x 4 columns) -> running row max and sum in f32 ->
// P tile through shared memory -> O accumulators in registers (each thread the
// same 4 rows, Dh/16 columns).  Causal CTAs stop at the diagonal; with
// kv_lengths they stop at ceil(kv_lengths[b] / 64) tiles.  The ragged edge
// (T not a multiple of 64) is masked by bounds: rows and columns past T are
// zero-filled on load, excluded from the softmax, and never stored.  The
// kernel indexes the packed (B, T, H*Dh) layout directly, so no head
// transpose exists.  With dropout the CTA fills the key tile's keep flags in
// shared memory while it loads K and V; the row sum l stays the sum of all
// weights (dropout acts on the normalised P), the dropped weights leave the
// P tile, and 1/keep joins 1/l at the end.  Rate 0 compiles the same code
// without the flags (a template parameter).

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace kokoro_attn;

template <typename T, int DH, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
packed_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            float* __restrict__ lse,
                            const int* __restrict__ kv_lengths, int T_len,
                            int H, float scale, int causal, uint32_t threshold,
                            float inv_keep, uint32_t seed_lo, uint32_t seed_hi) {
  constexpr int QS = DH + 4;    // padded strides: conflict-free float4 reads
  constexpr int KS = DH + 4;
  constexpr int VS = DH;
  constexpr int PS = kBK + 4;
  constexpr int G = DH / 64;    // 4-column groups per thread in O
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * KS;
  float* Ps = Vs + kBK * VS;
  uint8_t* keep = reinterpret_cast<uint8_t*>(Ps + kBQ * PS);  // DROPOUT only

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * DH;
  const size_t base = (size_t)b * T_len * D + (size_t)h * DH;
  const uint32_t bh = (uint32_t)(b * H + h);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  int len = T_len;
  int kv_end = T_len;  // key columns this CTA visits
  if (causal) {
    kv_end = min(T_len, q0 + kBQ);
  } else if (kv_lengths != nullptr) {
    len = kv_lengths[b];
    // a row with every key masked averages all T keys, as the reference does
    kv_end = len > 0 ? min(len, T_len) : T_len;
  }

  load_tile<T, DH, QS>(Qs, q + base, q0, T_len, D);

  float m[4], l[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's P V is done with Ks, Vs, Ps, keep
    load_tile<T, DH, KS>(Ks, k + base, k0, T_len, D);
    load_tile<T, DH, VS>(Vs, v + base, k0, T_len, D);
    if (DROPOUT) dropout_tile(keep, bh, q0, k0, threshold, seed_lo, seed_hi);
    __syncthreads();

    float s[4][4];
    dot_tile<DH, QS, KS>(Qs, Ks, ty, tx, s);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float val;
        if (col >= T_len) {
          val = -INFINITY;  // not a key at all: excluded from the softmax
        } else {
          const bool visible = causal ? (col <= row) : (col < len);
          val = visible ? s[i][j] * scale : kMasked;
        }
        s[i][j] = val;
        tile_max = fmaxf(tile_max, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      // every visited tile holds column k0 < T, so m_new is finite
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
    if (row >= T_len) continue;
    const float inv = (DROPOUT ? inv_keep : 1.f) / l[i];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = acc[i][4 * g + e] * inv;
      store4(o + base + (size_t)row * D + 64 * g + tx * 4, out);
    }
    if (lse != nullptr && tx == 0) lse[(size_t)bh * T_len + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int DH, bool DROPOUT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const int* kv_lengths, int B, int T_len, int H, float scale,
                   int causal, uint32_t threshold, float inv_keep,
                   unsigned long long seed, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * (kBQ * (DH + 4) + kBK * (DH + 4) + kBK * DH + kBQ * (kBK + 4)) +
      (DROPOUT ? kBQ * kBK : 0);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        packed_attention_fwd_kernel<T, DH, DROPOUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((T_len + kBQ - 1) / kBQ, H, B);
  packed_attention_fwd_kernel<T, DH, DROPOUT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, kv_lengths, T_len, H,
      scale, causal, threshold, inv_keep, (uint32_t)(seed & 0xffffffffull),
      (uint32_t)(seed >> 32));
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_rate(const void* q, const void* k, const void* v, void* o, float* lse,
                        const int* kv_lengths, int B, int T_len, int H, float scale,
                        int causal, int dropout, uint32_t threshold, float inv_keep,
                        unsigned long long seed, cudaStream_t s) {
  if (dropout)
    return launch<T, DH, true>(q, k, v, o, lse, kv_lengths, B, T_len, H, scale, causal,
                               threshold, inv_keep, seed, s);
  return launch<T, DH, false>(q, k, v, o, lse, kv_lengths, B, T_len, H, scale, causal,
                              threshold, inv_keep, seed, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  kv_lengths: NULL or B int32 on the
// device.  lse: NULL or B*H*T float32 on the device.  dropout: 0 or 1; a
// weight is kept iff its Philox word is below `threshold`, and kept weights
// are scaled by inv_keep.  Returns a cudaError_t (0 on success); launches on
// `stream` and does not synchronise.
extern "C" int kokoro_packed_attention_fwd(const void* q, const void* k,
                                           const void* v, void* o, float* lse,
                                           const int* kv_lengths, int B,
                                           int T_len, int H, int Dh,
                                           float scale, int causal, int dtype,
                                           int dropout, uint32_t threshold,
                                           float inv_keep, unsigned long long seed,
                                           void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 64)
    return (int)launch_rate<float, 64>(q, k, v, o, lse, kv_lengths, B, T_len, H, scale,
                                       causal, dropout, threshold, inv_keep, seed, s);
  if (dtype == 0 && Dh == 128)
    return (int)launch_rate<float, 128>(q, k, v, o, lse, kv_lengths, B, T_len, H, scale,
                                        causal, dropout, threshold, inv_keep, seed, s);
  if (dtype == 1 && Dh == 64)
    return (int)launch_rate<__nv_bfloat16, 64>(q, k, v, o, lse, kv_lengths, B, T_len, H,
                                               scale, causal, dropout, threshold,
                                               inv_keep, seed, s);
  if (dtype == 1 && Dh == 128)
    return (int)launch_rate<__nv_bfloat16, 128>(q, k, v, o, lse, kv_lengths, B, T_len, H,
                                                scale, causal, dropout, threshold,
                                                inv_keep, seed, s);
  return (int)cudaErrorInvalidValue;
}
