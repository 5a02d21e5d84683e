// Packed fused-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel kokoro_tpu/ops/fused_attention.py::_call_bwd_packed
// (body _bwd_kernel_packed), both variants (causal; non-causal with
// kv_lengths), with the same attention-weight dropout mask as the forward
// (attention_common.cuh).  Inputs q, k, v, o, dO of shape (B, T, H*Dh), f32 or
// bf16, Dh in {64, 128}, any T >= 1, and the forward's f32 row log-sum-exp
// (B, H, T); outputs dQ, dK, dV of the inputs' shape and type.
//
// What it computes, per (b, h), exactly the reference's recompute:
//   s = Q K^T * scale in f32 with the -1e9 mask;  p = softmax(s);
//   pd = mask ? p / keep : 0;  dV = bf16(pd)^T dO;  dpd = dO V^T;
//   dp = mask ? dpd / keep : 0;  dS = p * (dp - rowsum(dp * p));
//   dQ = bf16(dS * scale) K;  dK = bf16(dS * scale)^T Q
// with f32 sums ("bf16(.)" is the identity for f32 inputs).  p comes back
// from the saved log-sum-exp as exp(s - lse); a kv-length row of length 0
// (every key at -1e9) has p = 1/T for every key, which its lse cannot give
// (-1e9 + log T rounds to -1e9 in f32), so that case is set directly.
// rowsum(dp * p) equals rowsum(dO * O) exactly (dropout included: both are
// sum_j pd_j (dO . v_j)); the kernels take it from O, whose rounding to bf16
// moves it by about one bf16 spacing of |dO . O|.
//
// What bounds it on an H100: it reads q, k, v, o, dO and writes dQ, dK, dV
// (8 * B*T*H*Dh elements: 134 MB in bf16 at B=32, T=512, H=8, Dh=64, about
// 40 us at 3.35 TB/s) and does 10 * Dh operations per visible (query, key)
// pair (21.5 GFLOP causal at that shape: 22 us at the bf16 tensor-core peak,
// 0.32 ms at the 67 TFLOP/s f32 FMA rate these CUDA-core kernels run at).
//
// Design (FlashAttention-2's split, scalar f32 FMA, no atomics): no (T, T)
// tile exists; 64 x 64 tiles live in shared memory.
//   * dK/dV kernel: one CTA of 256 threads per (b, h, 64-key tile) keeps K, V
//     and the dK, dV accumulators, and loops over 64-row query tiles: S and
//     dPd tiles (each thread 4 x 4), P, Pd and dS through shared memory, then
//     dV += Pd^T dO and dK += dS^T Q.  Causal CTAs start at the diagonal tile;
//     a key tile at or past kv_lengths[b] > 0 writes zeros.
//   * dQ kernel: one CTA per (b, h, 64-query tile) keeps Q, dO and the dQ
//     accumulators, and loops over key tiles up to the diagonal or
//     ceil(kv_lengths[b] / 64) (all of them when the length is 0).
// The skipped tiles hold exactly zero gradient because exp(-1e9 - lse) is 0 in
// f32.  Each CTA recomputes rowsum(dO * O) of a query tile from device memory
// (64 x Dh products), so the two kernels share no scratch and each gradient
// element is written by one thread: the result is bitwise deterministic.
// Rows and columns past T are zero-filled and never stored.  The dropout
// flags of each 64 x 64 tile come from Philox into shared memory, keyed as in
// the forward.  Shared memory: 109 KB (Dh 64) / 175 KB (Dh 128) for dK/dV.

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace kokoro_attn;

struct BwdArgs {
  const int* kv_lengths;
  int T_len, H;
  float scale;
  int causal;
  uint32_t threshold;
  float inv_keep;
  uint32_t seed_lo, seed_hi;
};

// rowsum(dO * O) and the saved lse of query rows [q0, q0 + 64) -> shared
// memory (0 for rows past T).  Four threads per row.
template <typename T, int DH>
__device__ __forceinline__ void row_stats(const T* o, const T* dout, const float* lse,
                                          size_t base, size_t lse_base, int q0, int T_len,
                                          int D, float* delta_s, float* lse_s) {
  constexpr int V = 16 / sizeof(T);
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;
  const int row = q0 + r;
  float sum = 0.f;
  if (row < T_len) {
    const T* orow = o + base + (size_t)row * D;
    const T* drow = dout + base + (size_t)row * D;
#pragma unroll
    for (int c = part * V; c < DH; c += 4 * V) {
      float a[V], d[V];
      load16(orow + c, a);
      load16(drow + c, d);
#pragma unroll
      for (int e = 0; e < V; ++e) sum = fmaf(a[e], d[e], sum);
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  if (part == 0) {
    delta_s[r] = sum;
    lse_s[r] = row < T_len ? lse[lse_base + row] : 0.f;
  }
}

// P, Pd and dS*scale (rounded to the input type) of one 64 x 64 tile from
// its S and dPd tiles.
template <typename T, bool DROPOUT>
__device__ __forceinline__ void grad_tile(const float s[4][4], const float dpd[4][4],
                                          int q0, int k0, int ty, int tx, int len,
                                          bool uniform, const BwdArgs& a,
                                          const float* delta_s, const float* lse_s,
                                          const uint8_t* keep, float* Pd_out, int PS,
                                          float* dS_out) {
  const T* tag = nullptr;
  const float inv_t = 1.f / (float)a.T_len;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int col = k0 + c;
      float p = 0.f;
      if (row < a.T_len && col < a.T_len) {
        if (uniform) {
          p = inv_t;
        } else {
          const bool visible = a.causal ? (col <= row) : (col < len);
          if (visible) p = expf(s[i][j] * a.scale - lse_s[r]);
        }
      }
      float pd = p, dp = dpd[i][j];
      if (DROPOUT) {
        const bool kept = keep[r * 64 + c] != 0;
        pd = kept ? p * a.inv_keep : 0.f;
        dp = kept ? dp * a.inv_keep : 0.f;
      }
      const float ds = p * (dp - delta_s[r]);
      if (Pd_out != nullptr) Pd_out[r * PS + c] = round_to(pd, tag);
      dS_out[r * PS + c] = round_to(ds * a.scale, tag);
    }
  }
}

template <typename T, int DH, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
packed_attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const T* __restrict__ o,
                                 const T* __restrict__ dout,
                                 const float* __restrict__ lse, T* __restrict__ dk,
                                 T* __restrict__ dv, BwdArgs a) {
  constexpr int S = DH + 4;
  constexpr int PS = kBK + 4;
  constexpr int G = DH / 64;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBK * S;
  float* Qs = Vs + kBK * S;
  float* dOs = Qs + kBQ * S;
  float* Pds = dOs + kBQ * S;   // [query][key]
  float* dSs = Pds + kBQ * PS;  // [query][key]
  float* delta_s = dSs + kBQ * PS;
  float* lse_s = delta_s + kBQ;
  uint8_t* keep = reinterpret_cast<uint8_t*>(lse_s + kBQ);  // DROPOUT only

  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int T_len = a.T_len;
  const int D = a.H * DH;
  const size_t base = (size_t)b * T_len * D + (size_t)h * DH;
  const uint32_t bh = (uint32_t)(b * a.H + h);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  int len = T_len, q_begin = 0;
  bool uniform = false, any_visible = true;
  if (a.causal) {
    q_begin = k0;  // earlier query tiles see none of these keys
  } else if (a.kv_lengths != nullptr) {
    len = a.kv_lengths[b];
    uniform = len <= 0;
    any_visible = uniform || k0 < len;
  }

  float acc_dk[4][4 * G], acc_dv[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  if (any_visible) {
    load_tile<T, DH, S>(Ks, k + base, k0, T_len, D);
    load_tile<T, DH, S>(Vs, v + base, k0, T_len, D);
    for (int q0 = q_begin; q0 < T_len; q0 += kBQ) {
      __syncthreads();  // the previous query tile is done with Qs, dOs, Pds, dSs
      load_tile<T, DH, S>(Qs, q + base, q0, T_len, D);
      load_tile<T, DH, S>(dOs, dout + base, q0, T_len, D);
      row_stats<T, DH>(o, dout, lse, base, (size_t)bh * T_len, q0, T_len, D, delta_s, lse_s);
      if (DROPOUT) dropout_tile(keep, bh, q0, k0, a.threshold, a.seed_lo, a.seed_hi);
      __syncthreads();

      float s[4][4], dpd[4][4];
      dot_tile<DH, S, S>(Qs, Ks, ty, tx, s);
      dot_tile<DH, S, S>(dOs, Vs, ty, tx, dpd);
      grad_tile<T, DROPOUT>(s, dpd, q0, k0, ty, tx, len, uniform, a, delta_s, lse_s,
                            keep, Pds, PS, dSs);
      __syncthreads();

      // this thread's keys: ty*4 + i; its columns: 64g + tx*4 + e
#pragma unroll 4
      for (int qq = 0; qq < kBQ; ++qq) {
        const float4 pd4 = *reinterpret_cast<const float4*>(Pds + qq * PS + ty * 4);
        const float4 ds4 = *reinterpret_cast<const float4*>(dSs + qq * PS + ty * 4);
        const float pdv[4] = {pd4.x, pd4.y, pd4.z, pd4.w};
        const float dsv[4] = {ds4.x, ds4.y, ds4.z, ds4.w};
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 d4 = *reinterpret_cast<const float4*>(dOs + qq * S + 64 * g + tx * 4);
          const float4 q4 = *reinterpret_cast<const float4*>(Qs + qq * S + 64 * g + tx * 4);
          const float dov[4] = {d4.x, d4.y, d4.z, d4.w};
          const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc_dv[i][4 * g + e] = fmaf(pdv[i], dov[e], acc_dv[i][4 * g + e]);
              acc_dk[i][4 * g + e] = fmaf(dsv[i], qv[e], acc_dk[i][4 * g + e]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= T_len) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      store4(dk + base + (size_t)row * D + 64 * g + tx * 4, &acc_dk[i][4 * g]);
      store4(dv + base + (size_t)row * D + 64 * g + tx * 4, &acc_dv[i][4 * g]);
    }
  }
}

template <typename T, int DH, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
packed_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ o,
                               const T* __restrict__ dout,
                               const float* __restrict__ lse, T* __restrict__ dq,
                               BwdArgs a) {
  constexpr int S = DH + 4;
  constexpr int PS = kBK + 4;
  constexpr int G = DH / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kBQ * S;
  float* Ks = dOs + kBQ * S;
  float* Vs = Ks + kBK * S;
  float* dSs = Vs + kBK * S;  // [query][key]
  float* delta_s = dSs + kBQ * PS;
  float* lse_s = delta_s + kBQ;
  uint8_t* keep = reinterpret_cast<uint8_t*>(lse_s + kBQ);  // DROPOUT only

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int T_len = a.T_len;
  const int D = a.H * DH;
  const size_t base = (size_t)b * T_len * D + (size_t)h * DH;
  const uint32_t bh = (uint32_t)(b * a.H + h);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  int len = T_len, kv_end = T_len;
  bool uniform = false;
  if (a.causal) {
    kv_end = min(T_len, q0 + kBQ);
  } else if (a.kv_lengths != nullptr) {
    len = a.kv_lengths[b];
    uniform = len <= 0;
    kv_end = uniform ? T_len : min(len, T_len);
  }

  load_tile<T, DH, S>(Qs, q + base, q0, T_len, D);
  load_tile<T, DH, S>(dOs, dout + base, q0, T_len, D);
  row_stats<T, DH>(o, dout, lse, base, (size_t)bh * T_len, q0, T_len, D, delta_s, lse_s);

  float acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous key tile is done with Ks, Vs, dSs, keep
    load_tile<T, DH, S>(Ks, k + base, k0, T_len, D);
    load_tile<T, DH, S>(Vs, v + base, k0, T_len, D);
    if (DROPOUT) dropout_tile(keep, bh, q0, k0, a.threshold, a.seed_lo, a.seed_hi);
    __syncthreads();

    float s[4][4], dpd[4][4];
    dot_tile<DH, S, S>(Qs, Ks, ty, tx, s);
    dot_tile<DH, S, S>(dOs, Vs, ty, tx, dpd);
    grad_tile<T, DROPOUT>(s, dpd, q0, k0, ty, tx, len, uniform, a, delta_s, lse_s, keep,
                          nullptr, PS, dSs);
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 d4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        d4[i] = *reinterpret_cast<const float4*>(dSs + (ty * 4 + i) * PS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float kv[4 * G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 t =
              *reinterpret_cast<const float4*>(Ks + (kk + u) * S + 64 * g + tx * 4);
          kv[4 * g] = t.x; kv[4 * g + 1] = t.y; kv[4 * g + 2] = t.z; kv[4 * g + 3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ds = u == 0 ? d4[i].x : u == 1 ? d4[i].y : u == 2 ? d4[i].z : d4[i].w;
#pragma unroll
          for (int c = 0; c < 4 * G; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= T_len) continue;
#pragma unroll
    for (int g = 0; g < G; ++g)
      store4(dq + base + (size_t)row * D + 64 * g + tx * 4, &acc[i][4 * g]);
  }
}

template <typename T, int DH, bool DROPOUT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, void* dk, void* dv,
                   int B, const BwdArgs& a, cudaStream_t stream) {
  constexpr int S = DH + 4, PS = kBK + 4;
  constexpr size_t tail = sizeof(float) * 2 * kBQ + (DROPOUT ? kBQ * kBK : 0);
  constexpr size_t smem_dkdv = sizeof(float) * (4 * 64 * S + 2 * 64 * PS) + tail;
  constexpr size_t smem_dq = sizeof(float) * (4 * 64 * S + 64 * PS) + tail;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        packed_attention_bwd_dkdv_kernel<T, DH, DROPOUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(packed_attention_bwd_dq_kernel<T, DH, DROPOUT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.T_len + 63) / 64, a.H, B);
  packed_attention_bwd_dq_kernel<T, DH, DROPOUT><<<grid, kThreads, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dq), a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  packed_attention_bwd_dkdv_kernel<T, DH, DROPOUT><<<grid, kThreads, smem_dkdv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dk),
      static_cast<T*>(dv), a);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_rate(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, void* dq, void* dk, void* dv,
                        int B, int dropout, const BwdArgs& a, cudaStream_t s) {
  if (dropout) return launch<T, DH, true>(q, k, v, o, dout, lse, dq, dk, dv, B, a, s);
  return launch<T, DH, false>(q, k, v, o, dout, lse, dq, dk, dv, B, a, s);
}

}  // namespace

// Gradients of kokoro_packed_attention_fwd.  o and lse are the forward's
// outputs for the same q, k, v, kv_lengths, scale, causal, dropout, threshold,
// inv_keep and seed.  dtype: 0 = float32, 1 = bfloat16.  Launches the dQ
// kernel, then the dK/dV kernel, on `stream`; does not synchronise.  Returns
// a cudaError_t (0 on success).
extern "C" int kokoro_packed_attention_bwd(const void* q, const void* k, const void* v,
                                           const void* o, const void* dout,
                                           const float* lse, void* dq, void* dk, void* dv,
                                           const int* kv_lengths, int B, int T_len, int H,
                                           int Dh, float scale, int causal, int dtype,
                                           int dropout, uint32_t threshold, float inv_keep,
                                           unsigned long long seed, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{kv_lengths, T_len, H, scale, causal, threshold, inv_keep,
                  (uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 64)
    return (int)launch_rate<float, 64>(q, k, v, o, dout, lse, dq, dk, dv, B, dropout, a, s);
  if (dtype == 0 && Dh == 128)
    return (int)launch_rate<float, 128>(q, k, v, o, dout, lse, dq, dk, dv, B, dropout, a, s);
  if (dtype == 1 && Dh == 64)
    return (int)launch_rate<__nv_bfloat16, 64>(q, k, v, o, dout, lse, dq, dk, dv, B,
                                               dropout, a, s);
  if (dtype == 1 && Dh == 128)
    return (int)launch_rate<__nv_bfloat16, 128>(q, k, v, o, dout, lse, dq, dk, dv, B,
                                                dropout, a, s);
  return (int)cudaErrorInvalidValue;
}
