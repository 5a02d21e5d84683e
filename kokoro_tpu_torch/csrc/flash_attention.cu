// K4 flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel behind kokoro_tpu/models/blocks.py::_flash_attention:
// the Pallas flash attention of jax.experimental.pallas.ops.tpu.flash_attention
// (forward body _flash_attention_kernel, pl.pallas_call in
// _flash_attention_impl), which the JAX package runs for causal decoder
// self-attention at T >= 1024 with T a multiple of 128.  Here: q of shape
// (B, H, Tq, Dh), k and v (B, H, Tk, Dh), o like q, head-first and contiguous,
// float32 or bfloat16, Dh in {64, 128, 192, 256} or a multiple of 64 from
// 320 to 2048 (past 2048, any multiple of 64: kokoro_flash_attention_fwd_scores
// below, attention_scores.cuh), any Tq, Tk >= 1; optional
// causal mask (col <= row) and optional segment ids q_seg (B, Tq), kv_seg
// (B, Tk) int32 (the library's SegmentIds: valid = 1, padding = 0).  The
// library's kernel takes a head dim up to 128 or a multiple of 128 (it
// raises at 192); the reference's gate admits any multiple of 64.  The kernel is
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
// peak).  bf16 runs on the tensor cores (attention_tc.cuh: wgmma, TMA) in the
// packed forward's persistent, warp-specialised template with the flash mask
// policy: two consumer warpgroups of 64 query rows share each streamed tile
// of 128 keys, the softmax runs under the previous tile's P V and the other
// consumer's products, tiles below the diagonal skip the mask (with segment
// ids every tile takes it), and the last query tiles, which see the most
// keys, start first.  The bf16 kernel adds the mask value to the logit in
// log2 units.  f32 runs on the tensor cores in 3xTF32, in the packed
// forward's f32 template with the flash mask policy (attention_tf32.cuh):
// its bound is 165 TFLOP/s of f32-accurate work (0.148 ms here; the CUDA
// cores' 67 TFLOP/s f32 FMA rate would allow no less than 0.36 ms).  At Dh
// 192 and 256 (the flagship's hidden 512 over 2 heads: H=2, the same bytes
// and operations as H=8, Dh=64) the bf16 kernel (attention_tc_wide.cuh)
// streams 64-key tiles with K and V in slots of their own, K freed by S and
// V by P V, and stores O from registers; the f32 kernel's four
// warps of each 16 rows split S's contraction, Q split once into registers,
// K and V read raw through a three-stage ring and split by each warp as it
// reads them (attention_tf32_wide.cuh).  From
// Dh 320 (the flagship's hidden 512 at one head: Dh 512, H=1, again the same
// bytes and operations) no CTA holds a tile's rows: a cluster of
// ceil(Dh / 128) CTAs takes each work item, each CTA the Dh 128 kernel on its
// 128 columns, and each sums the cluster's partial S tiles in rank order from
// its peers' shared memory (attention_tc.cuh, "clusters"); past Dh 1024 the
// cluster (9 to 16 CTAs) is larger than the portable 8, which the kernels
// allow (cudaFuncAttributeNonPortableClusterSizeAllowed).

#include "attention_kernels.cuh"
#include "attention_scores.cuh"

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

// Clusters of c CTAs (3 to 16: the head dims past 256, c = ceil(Dh / 128)) of
// the forward's cluster kernel the card holds at once, at the kernel's shared
// memory, into *clusters (0: none, and a launch at such a head dim returns
// cudaErrorInvalidConfiguration).  dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t.
extern "C" int kokoro_flash_attention_fwd_clusters(int dtype, int c, int* clusters) {
  if (clusters == nullptr || c < 3 || c > tc::kMaxClusterCtas) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)tf32::fwd_split_fit(c, *clusters);
  if (dtype == 1) return (int)tc::fwd_split_fit(c, *clusters);
  return (int)cudaErrorInvalidValue;
}

// K4 past Dh 2048 (any multiple of 64 from 64 on; the wrapper takes it past
// 2048), the scores in device memory (attention_scores.cuh): the scores
// kernel, the row pass and O = P~ V / l, three launches on `stream`.
// Workspaces, (B H, Mq, Nk) with Mq, Nk = Tq, Tk rounded up to 128:
// s_ws f32, p_ws of the input type (f32: may be s_ws); l_ws (B H, Tq) f32.
// lse: NULL or (B H, Tq) f32 (+inf on a row with no visible key).  Returns
// a cudaError_t; does not synchronise.
extern "C" int kokoro_flash_attention_fwd_scores(const void* q, const void* k, const void* v,
                                                 void* o, float* lse, const int* q_seg,
                                                 const int* kv_seg, float* s_ws, void* p_ws,
                                                 float* l_ws, int B, int H, int Tq, int Tk,
                                                 int Dh, float scale, int causal, int dtype,
                                                 void* stream) {
  if (!scores::valid(B, H, Tq, Tk, Dh, q_seg, kv_seg) || s_ws == nullptr || p_ws == nullptr ||
      l_ws == nullptr)
    return (int)cudaErrorInvalidValue;
  scores::Args a{};
  a.q = q, a.k = k, a.v = v, a.q_seg = q_seg, a.kv_seg = kv_seg;
  a.s = s_ws, a.p = p_ws, a.l = l_ws, a.lse_out = lse;
  a.H = H, a.Tq = Tq, a.Tk = Tk, a.Dh = Dh;
  a.Mq = scores::tiles_of(Tq) * scores::kTile, a.Nk = scores::tiles_of(Tk) * scores::kTile;
  a.scale = scale, a.causal = causal != 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)scores::launch_fwd<float>(a, o, B * H, st);
  if (dtype == 1) return (int)scores::launch_fwd<__nv_bfloat16>(a, o, B * H, st);
  return (int)cudaErrorInvalidValue;
}

// The scores path's launch grid at (Tq, Tk, Dh, causal, dtype), into
// counts[5]: score tiles a (b, h), CTAs a score tile, apply's row tiles over
// queries and over keys, 128-column strips of the head dim
// (ops/flash_scores.py::grid computes the same).  Returns a cudaError_t.
extern "C" int kokoro_flash_attention_scores_grid(int Tq, int Tk, int Dh, int causal, int dtype,
                                                  int* counts) {
  if (counts == nullptr || Tq <= 0 || Tk <= 0 || Dh < 64 || Dh % 64 != 0 || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  const scores::Grid g = dtype == 0 ? scores::grid_of<float>(Tq, Tk, Dh, causal != 0)
                                    : scores::grid_of<__nv_bfloat16>(Tq, Tk, Dh, causal != 0);
  counts[0] = g.score_tiles, counts[1] = g.ctas_a_tile, counts[2] = g.query_rows;
  counts[3] = g.key_rows, counts[4] = g.strips;
  return 0;
}
