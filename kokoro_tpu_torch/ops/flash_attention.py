"""K4 flash attention: the Hopper kernels, their plain versions, the autograd
Function and the dispatcher.

Port of ``kokoro_tpu/models/blocks.py:102-173`` (``_flash_supported`` and
``_flash_attention``), which runs the library Pallas flash attention
(``jax.experimental.pallas.ops.tpu.flash_attention``: a blocked forward and a
two-kernel backward) for causal decoder self-attention at T >= 1024 frames.
Head-first ``(B, H, T, Dh)``; optional causal mask; optional padding masks
``q_valid`` / ``kv_valid`` ``(B, T)`` that become the library's segment ids
(valid = 1, padding = 0; a key is masked where its segment differs from the
query's); no dropout.

* :func:`flash_supported` is the reference's shape gate without its
  ``default_backend() == "tpu"`` clause: the port routes by shape on every
  device, and the CPU runs the plain version.  It admits every multiple of
  64 (:func:`supported_head_dim`), as the reference does.  From 320 to 2048
  a cluster of ceil(head_dim / 128) CTAs splits the head dim by columns: 3
  to 16 CTAs, past 8 (head dims past 1024) a cluster larger than the
  portable size; :func:`cluster_fits` reads how many such clusters the card
  holds.  Past 2048 (more columns than Hopper's largest cluster) the kernels
  keep the scores in device memory (``ops/flash_scores.py``,
  ``csrc/attention_scores.cuh``): no cluster and no upper limit.  Each dtype
  takes that path from its crossover on, the smallest head dim from which
  its scores kernels (on wgmma, fed by TMA: ``csrc/attention_scores_tc.cuh``
  in bf16, ``csrc/attention_scores_tf32.cuh`` in f32) beat the on-chip kernels
  at the long path's shape: :data:`BF16_SCORES_FROM`,
  :data:`F32_SCORES_FROM`, :func:`scores_path`.
  ``_pick_block_q`` (TPU block tuning) has no counterpart: the kernels tile
  by 64 at any T.
* :func:`flash_attention_reference` / :func:`flash_attention_bwd_reference`
  are the plain PyTorch versions, after the library's
  ``mha_reference_no_custom_vjp`` and ``mha_reference_bwd``, with the
  kernels' numerics: f32 logits, ``s *= scale``, masked logits get
  ``MASK_VALUE`` (-0.7 * f32 max) ADDED, the unnormalised weights rounded to
  the input dtype before their product with V, dV from the normalised
  weights in the input dtype, ``di = rowsum(dO * O)``, dS * scale rounded to
  the input dtype before dQ and dK.
* A query row with no visible key (every key masked by its segment) is
  outside the library's contract: its kernel, which skips blocks above the
  diagonal, and its reference disagree there.  The port returns 0 for such a
  row and passes no gradient through it; both versions do the same.
* :data:`flash_attention_fwd` / :data:`flash_attention_bwd` launch the kernels
  (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``) and count
  their launches; a launch the card refuses (at a cluster size it holds no
  cluster of, say) raises, naming the kernel, the head dim and, at a
  cluster head dim, the cluster size.  :func:`flash_attention_fwd_onchip` /
  :func:`flash_attention_bwd_onchip` and :func:`flash_attention_fwd_scores`
  / :func:`flash_attention_bwd_scores` launch either family at any head dim
  it takes, without counting, for the measurements that compare them.
  :class:`FlashAttentionFunction` runs plain forward and backward on CPU
  tensors and the kernels, and nothing else, on CUDA tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)  # the library's DEFAULT_MASK_VALUE
FLASH_MIN_LEN = 1024
FLASH_BLOCK = 128
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
# the kernels' head dims, K4's own: every multiple of 64 (from 320 to 2048
# over a cluster of CTAs of 128 columns each, at most 16; past 2048 the
# scores in device memory); the packed kernels (ops/fused_attention.py)
# take 64 and 128
SLICE_COLS = 128
MAX_CLUSTER_CTAS = 16
MAX_CLUSTER_HEAD_DIM = MAX_CLUSTER_CTAS * SLICE_COLS
# the head dims of the cluster kernels
CLUSTER_HEAD_DIMS = tuple(range(320, MAX_CLUSTER_HEAD_DIM + 1, 64))
# each dtype takes the scores path from this head dim on: the smallest
# sampled head dim from which its forward + backward beat the on-chip
# kernels' at B=12, T=1408, H=1, causal, there and at every sampled head dim
# above it (chip_smoke.py kernel_times_flash_crossover; PERF.md)
F32_SCORES_FROM = 192
BF16_SCORES_FROM = 320


def supported_head_dim(head_dim: int) -> bool:
    """Whether K4's kernels take ``head_dim``: a multiple of 64, at least 64
    (the reference's gate admits the same)."""
    return head_dim >= 64 and head_dim % 64 == 0


def scores_path(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the wrappers take ``head_dim`` in ``dtype`` to the
    scores-in-memory kernels (``ops/flash_scores.py``): bf16 from
    :data:`BF16_SCORES_FROM`, f32 from :data:`F32_SCORES_FROM` on (64 and
    128, the packed kernels' own head dims, never)."""
    start = F32_SCORES_FROM if dtype == torch.float32 else BF16_SCORES_FROM
    return head_dim >= start and head_dim > 128


def flash_supported(q_len: int, kv_len: int, head_dim: int, causal: bool = True) -> bool:
    """The reference's K4 shape gate (``blocks.py::_flash_supported``): causal,
    both lengths multiples of 128 and at least 1024, head_dim a multiple of
    64 (:func:`supported_head_dim`), every one of which the kernels take."""
    return (
        causal
        and q_len % FLASH_BLOCK == 0
        and kv_len % FLASH_BLOCK == 0
        and supported_head_dim(head_dim)
        and q_len >= FLASH_MIN_LEN
        and kv_len >= FLASH_MIN_LEN
    )


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be (B, H, T, Dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must share B, H, Dh")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"q, k, v must all be float32 or bfloat16; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not supported_head_dim(q.shape[3]):
        raise ValueError(f"head_dim {q.shape[3]} is not a multiple of 64 (at least 64)")


def segment_ids(q, k, q_valid: Optional[torch.Tensor], kv_valid: Optional[torch.Tensor]
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(q_seg (B, Tq), kv_seg (B, Tk))`` int32 on q's device, a missing side
    all ones, as ``_flash_attention`` builds its ``SegmentIds``; ``(None,
    None)`` when neither mask is given."""
    if q_valid is None and kv_valid is None:
        return None, None
    B, Tq, Tk = q.shape[0], q.shape[2], k.shape[2]

    def seg(valid, T):
        if valid is None:
            return torch.ones(B, T, dtype=torch.int32, device=q.device)
        if valid.shape != (B, T):
            raise ValueError(f"a padding mask must be ({B}, {T}); got {tuple(valid.shape)}")
        return valid.to(device=q.device, dtype=torch.int32).contiguous()

    return seg(q_valid, Tq), seg(kv_valid, Tk)


def _logits(q, k, scale, causal, q_seg, kv_seg):
    """f32 scaled logits with the additive mask, and whether each query row
    sees a key ``(B, 1, Tq, 1)``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    Tq, Tk = q.shape[2], k.shape[2]
    visible = None
    if q_seg is not None:
        visible = (q_seg[:, :, None] == kv_seg[:, None, :])[:, None]
    if causal:
        tri = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()[None, None]
        visible = tri if visible is None else visible & tri
    if visible is None:
        return s, None
    s = s + torch.where(visible, 0.0, MASK_VALUE)
    return s, visible.any(-1, keepdim=True)


def _weights(s, row_visible):
    """(unnormalised exp(s - m), row sum l), both f32; rows without a visible
    key are zero (l = 1)."""
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if row_visible is not None:
        p = torch.where(row_visible, p, 0.0)
    l = p.sum(-1, keepdim=True)
    return p, torch.where(l > 0, l, torch.ones_like(l))


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, scale: float,
    q_seg: Optional[torch.Tensor] = None, kv_seg: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch K4 forward, the forward kernel's contract."""
    s, row_visible = _logits(q, k, scale, causal, q_seg, kv_seg)
    p, l = _weights(s, row_visible)
    o = torch.matmul(p.to(q.dtype).float(), v.float()) / l
    return o.to(q.dtype)


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor, *,
    causal: bool, scale: float, q_seg: Optional[torch.Tensor] = None,
    kv_seg: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K4 backward ``(dq, dk, dv)`` from the forward's output
    ``o``: the library's recompute step by step, the backward kernels'
    contract."""
    dtype = q.dtype
    s, row_visible = _logits(q, k, scale, causal, q_seg, kv_seg)
    p, l = _weights(s, row_visible)
    p = p / l
    do32 = do.float()
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), do32)
    dp = torch.matmul(do32, v.float().transpose(-1, -2))
    di = (o.float() * do32).sum(-1, keepdim=True)
    ds = ((dp - di) * p * scale).to(dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


# -- the CUDA kernels ------------------------------------------------------
def _kernel_check(tensors):
    for label, x in tensors.items():
        if x is None:
            continue
        if x.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors; {label} is on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{label} must be 16-byte aligned")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def cluster_ctas(head_dim: int) -> int:
    """CTAs of the cluster that takes a work item at ``head_dim``: one a
    128-column slice from 320 to 2048 (3 to 16), else 1 (no cluster)."""
    return -(-head_dim // SLICE_COLS) if 256 < head_dim <= MAX_CLUSTER_HEAD_DIM else 1


def cluster_fits(dtype: torch.dtype, ctas: int) -> dict:
    """How many clusters of ``ctas`` CTAs (3 to 16) of each K4 cluster
    kernel of ``dtype`` the current card holds at once, at the kernel's shared
    memory (``cudaOccupancyMaxActiveClusters``): ``{"fwd": n, "dq": n,
    "dkdv": n}``; 0 where it holds none, and a launch there raises."""
    from kokoro_tpu_torch.ops import kernels

    if not 3 <= ctas <= MAX_CLUSTER_CTAS:
        raise ValueError(f"a K4 cluster has 3 to {MAX_CLUSTER_CTAS} CTAs, not {ctas}")
    code = 0 if dtype == torch.float32 else 1
    fwd, dq, dkdv = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    err = kernels.load("flash_attention").kokoro_flash_attention_fwd_clusters(
        code, ctas, ctypes.byref(fwd))
    if err == 0:
        err = kernels.load("flash_attention_bwd").kokoro_flash_attention_bwd_clusters(
            code, ctas, ctypes.byref(dq), ctypes.byref(dkdv))
    if err != 0:
        raise RuntimeError(f"the occupancy query of K4's clusters of {ctas} CTAs failed: "
                           f"cudaError_t {err}")
    return {"fwd": fwd.value, "dq": dq.value, "dkdv": dkdv.value}


def _launch_error(name: str, kernels_of: Tuple[str, ...], err: int, q: torch.Tensor, *,
                  scores: bool) -> str:
    """The message of a refused launch: the head dim and its kernels (the
    scores-in-memory kernels where ``scores``); at a cluster head dim, the
    cluster size and each of the wrapper's kernels the card holds no cluster
    of."""
    Dh, ctas = q.shape[3], cluster_ctas(q.shape[3])
    msg = f"{name} kernel launch failed: cudaError_t {err}"
    if scores:
        header = "tf32" if q.dtype == torch.float32 else "tc"
        return (f"{msg} (head_dim {Dh}: the scores-in-memory kernels, "
                f"csrc/attention_scores_{header}.cuh)")
    if ctas == 1:
        return f"{msg} (head_dim {Dh})"
    try:
        fits = cluster_fits(q.dtype, ctas)
    except RuntimeError as exc:
        return f"{msg} ({exc})"
    none = [k for k in kernels_of if fits[k] == 0]
    if none:
        return (f"{msg}: the card holds no cluster of {ctas} CTAs (head_dim {Dh}, "
                f"{str(q.dtype).split('.')[1]}) of the {' and '.join(none)} kernel")
    return f"{msg} (head_dim {Dh}: clusters of {ctas} CTAs, the card holds {fits})"


class FlashAttentionKernel:
    """Wrapper of ``kokoro_flash_attention_fwd``.  ``launches`` counts the
    launches this wrapper made, and nothing else; ``scores_launches`` those
    of them that took the scores path (:func:`scores_path`)."""

    name = "flash_attention_fwd"
    source = "kokoro_tpu_torch/csrc/flash_attention.cu"
    replaces = ("kokoro_tpu/models/blocks.py:139 (_flash_attention: library flash "
                "attention forward, pl.pallas_call at jax/experimental/pallas/ops/tpu/"
                "flash_attention.py:758)")

    def __init__(self) -> None:
        self.launches = 0
        self.scores_launches = 0

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                 scale: float, q_seg: Optional[torch.Tensor] = None,
                 kv_seg: Optional[torch.Tensor] = None, return_lse: bool = False):
        """``o``, or ``(o, lse)`` with the f32 row log-sum-exp ``(B, H, Tq)``
        the backward kernels need (+inf on rows without a visible key)."""
        kw = dict(causal=causal, scale=scale, q_seg=q_seg, kv_seg=kv_seg, return_lse=return_lse)
        _check(q, k, v)
        if scores_path(q.shape[3], q.dtype):
            out = flash_attention_fwd_scores(q, k, v, **kw)
            self.scores_launches += 1
        else:
            out = flash_attention_fwd_onchip(q, k, v, **kw)
        self.launches += 1
        return out


class FlashAttentionBwdKernel:
    """Wrapper of ``kokoro_flash_attention_bwd`` (the dQ kernel, then the dK/dV
    kernel).  ``launches`` counts the calls that launched them;
    ``scores_launches`` those of them that took the scores path."""

    name = "flash_attention_bwd"
    source = "kokoro_tpu_torch/csrc/flash_attention_bwd.cu"
    replaces = ("kokoro_tpu/models/blocks.py:139 (_flash_attention: library "
                "_flash_attention_bwd_dkv flash_attention.py:941, pl.pallas_call :1121, "
                "and _flash_attention_bwd_dq :1287, pl.pallas_call :1456)")

    def __init__(self) -> None:
        self.launches = 0
        self.scores_launches = 0

    def __call__(self, q, k, v, o, do, lse, *, causal: bool, scale: float,
                 q_seg: Optional[torch.Tensor] = None, kv_seg: Optional[torch.Tensor] = None):
        kw = dict(causal=causal, scale=scale, q_seg=q_seg, kv_seg=kv_seg)
        _check(q, k, v)
        if scores_path(q.shape[3], q.dtype):
            grads = flash_attention_bwd_scores(q, k, v, o, do, lse, **kw)
            self.scores_launches += 1
        else:
            grads = flash_attention_bwd_onchip(q, k, v, o, do, lse, **kw)
        self.launches += 1
        return grads


flash_attention_fwd = FlashAttentionKernel()
flash_attention_bwd = FlashAttentionBwdKernel()
KERNELS = (flash_attention_fwd, flash_attention_bwd)


def _check_bwd(q, k, v, o, do, lse, q_seg, kv_seg):
    _check(q, k, v)
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("q_seg and kv_seg come together")
    for label, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError(f"{label} must match q's shape and dtype")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError("lse must be float32 (B, H, Tq)")
    _kernel_check({"q": q, "k": k, "v": v, "o": o, "do": do, "lse": lse,
                   "q_seg": q_seg, "kv_seg": kv_seg})


# the kernels that keep the scores on chip (csrc/flash_attention{,_bwd}.cu
# through attention_kernels.cuh: Dh 64 to 2048, past 256 over clusters):
# the wrappers' route below scores_path, callable at every head dim they
# take for a measurement (they count nothing)
def flash_attention_fwd_onchip(q, k, v, *, causal: bool, scale: float,
                               q_seg: Optional[torch.Tensor] = None,
                               kv_seg: Optional[torch.Tensor] = None, return_lse: bool = False):
    """``kokoro_flash_attention_fwd`` on CUDA tensors: ``o``, or ``(o,
    lse)``; raises where the launch is refused."""
    from kokoro_tpu_torch.ops import kernels

    _check(q, k, v)
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("q_seg and kv_seg come together")
    _kernel_check({"q": q, "k": k, "v": v, "q_seg": q_seg, "kv_seg": kv_seg})
    lib = kernels.load("flash_attention")
    B, H, Tq, Dh = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Tq, device=q.device) if return_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.kokoro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _ptr(lse),
            _ptr(q_seg), _ptr(kv_seg), B, H, Tq, k.shape[2], Dh,
            ctypes.c_float(float(scale)), int(causal),
            0 if q.dtype == torch.float32 else 1, stream,
        )
    if err != 0:
        raise RuntimeError(_launch_error(flash_attention_fwd.name, ("fwd",), err, q,
                                         scores=False))
    return (o, lse) if return_lse else o


def flash_attention_bwd_onchip(q, k, v, o, do, lse, *, causal: bool, scale: float,
                               q_seg: Optional[torch.Tensor] = None,
                               kv_seg: Optional[torch.Tensor] = None):
    """``kokoro_flash_attention_bwd`` (the dQ kernel, then the dK/dV kernel)
    on CUDA tensors: ``(dq, dk, dv)`` from the on-chip forward's ``o`` and
    ``lse``; raises where the launch is refused."""
    from kokoro_tpu_torch.ops import kernels

    _check_bwd(q, k, v, o, do, lse, q_seg, kv_seg)
    lib = kernels.load("flash_attention_bwd")
    B, H, Tq, Dh = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the kernels' workspace: each row's di, from dQ to dK/dV
    delta = torch.empty_like(lse)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.kokoro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _ptr(q_seg), _ptr(kv_seg), B, H, Tq, k.shape[2], Dh,
            ctypes.c_float(float(scale)), int(causal),
            0 if q.dtype == torch.float32 else 1, stream,
        )
    if err != 0:
        raise RuntimeError(_launch_error(flash_attention_bwd.name, ("dq", "dkdv"), err, q,
                                         scores=False))
    return dq, dk, dv


# the scores-in-memory kernels at any head dim (ops/flash_scores.py): the
# wrappers' route from scores_path on, callable at any multiple of 64 for a
# measurement (they count nothing)
def flash_attention_fwd_scores(q, k, v, *, causal: bool, scale: float,
                               q_seg: Optional[torch.Tensor] = None,
                               kv_seg: Optional[torch.Tensor] = None, return_lse: bool = False):
    """``kokoro_flash_attention_fwd_scores`` on CUDA tensors: ``o``, or
    ``(o, lse)``; raises where the launch is refused."""
    from kokoro_tpu_torch.ops import flash_scores

    _check(q, k, v)
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("q_seg and kv_seg come together")
    _kernel_check({"q": q, "k": k, "v": v, "q_seg": q_seg, "kv_seg": kv_seg})
    err, o, lse = flash_scores.scores_fwd(q, k, v, causal=causal, scale=scale, q_seg=q_seg,
                                          kv_seg=kv_seg, return_lse=return_lse)
    if err != 0:
        raise RuntimeError(_launch_error(flash_attention_fwd.name, ("fwd",), err, q,
                                         scores=True))
    return (o, lse) if return_lse else o


def flash_attention_bwd_scores(q, k, v, o, do, lse, *, causal: bool, scale: float,
                               q_seg: Optional[torch.Tensor] = None,
                               kv_seg: Optional[torch.Tensor] = None):
    """``kokoro_flash_attention_bwd_scores`` on CUDA tensors: ``(dq, dk,
    dv)`` from the scores forward's ``o`` and ``lse``; raises where the
    launch is refused."""
    from kokoro_tpu_torch.ops import flash_scores

    _check_bwd(q, k, v, o, do, lse, q_seg, kv_seg)
    err, dq, dk, dv = flash_scores.scores_bwd(q, k, v, o, do, lse, causal=causal, scale=scale,
                                              q_seg=q_seg, kv_seg=kv_seg)
    if err != 0:
        raise RuntimeError(_launch_error(flash_attention_bwd.name, ("dq", "dkdv"), err, q,
                                         scores=True))
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """K4 with its backward: plain forward and plain backward on CPU tensors,
    the forward and backward kernels on CUDA tensors.  Saved for the backward:
    q, k, v, o, the kernel's lse (CUDA, and only when a gradient is wanted)
    and the segment ids."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, scale):
        kw = dict(causal=causal, scale=scale, q_seg=q_seg, kv_seg=kv_seg)
        lse = None
        if q.device.type == "cpu":
            o = flash_attention_reference(q, k, v, **kw)
        elif any(ctx.needs_input_grad[:3]):
            o, lse = flash_attention_fwd(q, k, v, return_lse=True, **kw)
        else:
            o = flash_attention_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse, q_seg, kv_seg)
        ctx.args = (causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_seg, kv_seg = ctx.saved_tensors
        causal, scale = ctx.args
        kw = dict(causal=causal, scale=scale, q_seg=q_seg, kv_seg=kv_seg)
        do = do.contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_reference(q, k, v, o, do, **kw)
        else:
            dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, **kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, scale: float,
    q_valid: Optional[torch.Tensor] = None, kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention ``(B, H, Tq, Dh) x (B, H, Tk, Dh) -> (B, H, Tq, Dh)``,
    differentiable; the counterpart of ``blocks.py::_flash_attention``.

    CPU tensors run the plain versions; CUDA tensors launch the kernels.
    ``q_valid`` / ``kv_valid`` ``(B, T)`` (True or 1 = valid) mask keys
    whose validity differs from the query's.  Refuses dtypes other than
    float32/bfloat16 and a head_dim that is not a multiple of 64 on every
    device; the caller gates shapes with
    :func:`flash_supported`."""
    _check(q, k, v)
    q_seg, kv_seg = segment_ids(q, k, q_valid, kv_valid)
    return FlashAttentionFunction.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                        q_seg, kv_seg, causal, scale)
