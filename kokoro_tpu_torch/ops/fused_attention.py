"""Packed and folded fused attention: the Hopper kernels, their plain
versions, the autograd Function and the dispatchers.

Port of ``kokoro_tpu/ops/fused_attention.py::fused_attention_packed`` and its
custom VJP (``_fused_packed``: ``_call_fwd_packed`` / ``_call_bwd_packed``):
attention on PACKED projections ``(B, T, H*Dh) -> (B, T, H*Dh)``, either
causal (decoder self-attention, K1) or non-causal with per-row
``kv_lengths`` (decoder cross-attention, K2, where keys at
``col >= kv_lengths[b]`` are masked and q_len == kv_len), with optional
attention-weight dropout.

* :func:`packed_attention_reference` and :func:`packed_attention_bwd_reference`
  are the plain PyTorch versions of the forward and of the reference's
  recompute backward: f32 logits, the -1e9 masked constant, f32 softmax,
  dropout ``where(keep, p / keep_rate, 0)``, the weights (and dS * scale)
  cast to the input dtype before their products, f32 sums.  Each row's
  delta (``rowsum(p * dp)``) is the reference's sum, or, given the
  forward's output and its rounding residual, ``rowsum(dO * (O + residual))``
  as the kernels take it.
* Under grad the forward also returns what the backward needs: the f32 row
  log-sum-exp and, for bf16, O's rounding residual ``bf16(O32 - bf16(O32))``
  (one more bf16 tensor of O's shape), from which the backward takes each
  row's delta without a second pass over the keys.
* Dropout is Philox4x32-10 keyed on a 64-bit ``seed`` (``ops/philox.py``); the
  kernels draw the same mask in-kernel, so the TPU's bits are not
  reproduced, only its distribution and its fwd/bwd agreement.
* :data:`packed_attention_causal` / :data:`packed_attention_kvlen` launch the
  forward kernel (``csrc/packed_attention.cu``),
  :data:`packed_attention_bwd_causal` / :data:`packed_attention_bwd_kvlen`
  the backward kernels (``csrc/packed_attention_bwd.cu``); each wrapper
  counts its launches.
* :class:`PackedAttentionFunction` is the ``torch.autograd.Function``: on CPU
  tensors plain forward and plain backward, on CUDA tensors the kernels and
  nothing else.
* :func:`packed_attention` is the dispatcher of the packed layout.  Nothing
  falls back: a CUDA tensor launches a kernel or raises.
* K3, :func:`fused_attention` (``_call_fwd`` / ``_call_bwd`` behind
  ``fused_attention``): causal attention on head-first ``(B, H, T, Dh)``.
  Made contiguous and folded to ``(B*H, T, Dh)`` it is the packed layout with
  one head, so :data:`folded_attention_fwd` / :data:`folded_attention_bwd`
  launch the packed kernels on that view and count their own launches.  The
  Philox counter ``(b*H + h, row, col/4)`` is then the packed layout's, so
  one seed drops the same weights in both layouts, bit for bit (the
  reference's ``packed_layout_identity``).  Its plain version is
  :func:`packed_attention_reference` on the folded view.

The TPU-only gates of the reference (``MIN/MAX_FUSED_LEN``, zero-padding T to
a multiple of 128, the 128-lane head-panel rule) do not carry over: the
kernels mask by bounds at any T.  One consequence: a kv-length row of length
0 averages the T real keys here, the reference the 128-padded ones.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from kokoro_tpu_torch.ops.philox import attention_keep_mask, keep_threshold

NEG_INF = -1e9  # masked-logit constant, as in models/blocks.py
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
SUPPORTED_HEAD_DIMS = (64, 128)


def _check(q, k, v, num_heads, kv_lengths, dropout_rate, seed):
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1); got {dropout_rate}")
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one (B, T, H*Dh) shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in SUPPORTED_DTYPES:
        raise TypeError(
            f"q, k, v must all be float32 or bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    D = q.shape[2]
    if D % num_heads:
        raise ValueError(f"d_model {D} not divisible by num_heads {num_heads}")
    if D // num_heads not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {D // num_heads} not in {SUPPORTED_HEAD_DIMS}")
    if kv_lengths is not None and (
        kv_lengths.shape != (q.shape[0],) or kv_lengths.device != q.device
    ):
        raise ValueError("kv_lengths must be (B,) on the device of q")


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.reshape(B, T, H, D // H).transpose(1, 2).float().contiguous()


def _packed(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    B, H, T, Dh = x.shape
    return x.to(dtype).transpose(1, 2).reshape(B, T, H * Dh)


def _logits(q, k, num_heads, scale, causal, kv_lengths):
    """Masked f32 logits (B, H, T, T), the masked ones at ``NEG_INF``."""
    T = q.shape[1]
    s = torch.matmul(_heads(q, num_heads), _heads(k, num_heads).transpose(-1, -2)) * scale
    cols = torch.arange(T, device=q.device)
    if causal:
        visible = (cols[None, :] <= cols[:, None])[None, None]
    elif kv_lengths is not None:
        visible = (cols[None, :] < kv_lengths.to(q.device)[:, None])[:, None, None, :]
    else:
        visible = None
    if visible is not None:
        s = torch.where(visible, s, torch.full((), NEG_INF, device=q.device))
    return s


def _probs_and_keep(q, k, num_heads, scale, causal, kv_lengths, dropout_rate, seed):
    """f32 softmax weights (B, H, T, T) and the keep flags (None at rate 0)."""
    B, T, _ = q.shape
    p = torch.softmax(_logits(q, k, num_heads, scale, causal, kv_lengths), dim=-1)
    keep = None
    if dropout_rate > 0.0:
        keep = attention_keep_mask(seed, B, num_heads, T, dropout_rate, device=q.device)
    return p, keep


def packed_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, num_heads: int,
    scale: float, causal: bool = True, kv_lengths: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0, seed: Optional[int] = None, for_backward: bool = False,
):
    """Plain PyTorch packed attention, the forward kernel's contract (any
    head_dim).  ``for_backward``: ``(o, lse, residual)`` with the f32 row
    log-sum-exp (B, H, T) and, for bf16, ``bf16(O32 - o)`` (None for f32)."""
    p, keep = _probs_and_keep(q, k, num_heads, scale, causal, kv_lengths, dropout_rate, seed)
    if keep is not None:
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), torch.zeros((), device=q.device))
    o32 = _packed(torch.matmul(p.to(q.dtype).float(), _heads(v, num_heads)), torch.float32)
    o = o32.to(q.dtype)
    if not for_backward:
        return o
    lse = torch.logsumexp(_logits(q, k, num_heads, scale, causal, kv_lengths), dim=-1)
    residual = None if q.dtype == torch.float32 else (o32 - o.float()).to(q.dtype)
    return o, lse, residual


def packed_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, *,
    num_heads: int, scale: float, causal: bool = True,
    kv_lengths: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
    seed: Optional[int] = None, o: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward ``(dq, dk, dv)``: the reference's recompute
    (``_bwd_kernel_packed``) step by step, the backward kernels' contract.
    Each row's delta is the reference's f32 ``rowsum(dp * p)``, or, given
    the forward's ``o`` (and for bf16 its ``residual``), the kernels'
    ``rowsum(dO * (o + residual))`` in f32."""
    dtype, H = q.dtype, num_heads
    p, keep = _probs_and_keep(q, k, H, scale, causal, kv_lengths, dropout_rate, seed)
    zero = torch.zeros((), device=q.device)
    inv_keep = 1.0 / (1.0 - dropout_rate)
    pd = p if keep is None else torch.where(keep, p * inv_keep, zero)
    do_h, v_h = _heads(do, H), _heads(v, H)
    dv = torch.matmul(pd.to(dtype).float().transpose(-1, -2), do_h)
    dpd = torch.matmul(do_h, v_h.transpose(-1, -2))
    dp = dpd if keep is None else torch.where(keep, dpd * inv_keep, zero)
    if o is None:
        delta = (dp * p).sum(-1, keepdim=True)
    else:
        o32 = o.float() if residual is None else o.float() + residual.float()
        delta = (do_h * _heads(o32, H)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    ds16 = (ds * scale).to(dtype).float()
    dq = torch.matmul(ds16, _heads(k, H))
    dk = torch.matmul(ds16.transpose(-1, -2), _heads(q, H))
    return _packed(dq, dtype), _packed(dk, dtype), _packed(dv, dtype)


# -- the CUDA kernels ------------------------------------------------------
def _kernel_inputs(tensors, kv_lengths, causal):
    for label, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors; {label} is on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{label} must be 16-byte aligned")
    if kv_lengths is not None and not causal:
        kv_lengths = kv_lengths.to(torch.int32).contiguous()
        return kv_lengths, kv_lengths.data_ptr()
    return None, None


def _dropout_args(dropout_rate: float, seed: Optional[int]):
    """(flag, threshold, 1/keep, seed) as the kernels take them."""
    if dropout_rate <= 0.0:
        return 0, ctypes.c_uint32(0), ctypes.c_float(1.0), ctypes.c_uint64(0)
    return (1, ctypes.c_uint32(keep_threshold(dropout_rate)),
            ctypes.c_float(1.0 / (1.0 - dropout_rate)),
            ctypes.c_uint64(int(seed) & 0xFFFFFFFFFFFFFFFF))


class PackedAttentionKernel:
    """Wrapper of ``kokoro_packed_attention_fwd`` for one variant: causal (K1)
    or non-causal with optional ``kv_lengths`` (K2).  ``launches`` counts the
    launches this wrapper made, and nothing else."""

    source = "kokoro_tpu_torch/csrc/packed_attention.cu"

    def __init__(self, causal: bool, name: Optional[str] = None,
                 replaces: str = "kokoro_tpu/ops/fused_attention.py:322 (_call_fwd_packed)"
                 ) -> None:
        self.causal = causal
        self.name = name or "packed_attention_fwd_" + ("causal" if causal else "kvlen")
        self.replaces = replaces
        self.launches = 0

    def __call__(
        self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        num_heads: int, scale: float, kv_lengths: Optional[torch.Tensor] = None,
        dropout_rate: float = 0.0, seed: Optional[int] = None, for_backward: bool = False,
    ):
        """``o``, or with ``for_backward`` what the backward kernel needs:
        ``(o, lse, residual)``, the f32 row log-sum-exp ``(B, H, T)`` and,
        for bf16, O's rounding residual (None for f32)."""
        _check(q, k, v, num_heads, kv_lengths, dropout_rate, seed)
        kv_lengths, lens_ptr = _kernel_inputs({"q": q, "k": k, "v": v}, kv_lengths,
                                              self.causal)
        from kokoro_tpu_torch.ops import kernels

        lib = kernels.load("packed_attention")
        B, T, D = q.shape
        o = torch.empty_like(q)
        lse = torch.empty(B, num_heads, T, device=q.device) if for_backward else None
        residual = (torch.empty_like(q) if for_backward and q.dtype == torch.bfloat16
                    else None)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            err = lib.kokoro_packed_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if residual is None else residual.data_ptr(),
                None if lse is None else lse.data_ptr(), lens_ptr,
                B, T, num_heads, D // num_heads, ctypes.c_float(float(scale)),
                int(self.causal), 0 if q.dtype == torch.float32 else 1,
                *_dropout_args(dropout_rate, seed), stream,
            )
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: cudaError_t {err}")
        self.launches += 1
        return (o, lse, residual) if for_backward else o


class PackedAttentionBwdKernel:
    """Wrapper of ``kokoro_packed_attention_bwd`` (the dQ kernel, then the
    dK/dV kernel) for one variant.  ``launches`` counts the calls that
    launched them."""

    source = "kokoro_tpu_torch/csrc/packed_attention_bwd.cu"

    def __init__(self, causal: bool, name: Optional[str] = None,
                 replaces: str = "kokoro_tpu/ops/fused_attention.py:354 (_call_bwd_packed)"
                 ) -> None:
        self.causal = causal
        self.name = name or "packed_attention_bwd_" + ("causal" if causal else "kvlen")
        self.replaces = replaces
        self.launches = 0

    def __call__(
        self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        do: torch.Tensor, lse: torch.Tensor, residual: Optional[torch.Tensor] = None, *,
        num_heads: int, scale: float, kv_lengths: Optional[torch.Tensor] = None,
        dropout_rate: float = 0.0, seed: Optional[int] = None,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(dq, dk, dv)`` from the forward's ``o``, ``lse`` and (bf16)
        ``residual``, as the forward returns them with ``for_backward``."""
        _check(q, k, v, num_heads, kv_lengths, dropout_rate, seed)
        B, T, D = q.shape
        tensors = {"q": q, "k": k, "v": v, "o": o, "do": do, "lse": lse}
        if q.dtype == torch.bfloat16:
            if residual is None:
                raise ValueError("the bf16 backward needs the forward's residual")
            tensors["residual"] = residual
        elif residual is not None:
            raise ValueError("a float32 forward has no residual")
        for label in ("o", "do", "residual"):
            x = tensors.get(label)
            if x is not None and (x.shape != q.shape or x.dtype != q.dtype):
                raise ValueError(f"{label} must match q's shape and dtype")
        if lse.shape != (B, num_heads, T) or lse.dtype != torch.float32:
            raise ValueError("lse must be float32 (B, H, T)")
        kv_lengths, lens_ptr = _kernel_inputs(tensors, kv_lengths, self.causal)
        from kokoro_tpu_torch.ops import kernels

        lib = kernels.load("packed_attention_bwd")
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        # the bf16 kernels' workspace: each row's delta, from dQ to dK/dV
        delta = None if q.dtype == torch.float32 else torch.empty_like(lse)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            err = lib.kokoro_packed_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if residual is None else residual.data_ptr(), do.data_ptr(),
                lse.data_ptr(), None if delta is None else delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lens_ptr,
                B, T, num_heads, D // num_heads, ctypes.c_float(float(scale)),
                int(self.causal), 0 if q.dtype == torch.float32 else 1,
                *_dropout_args(dropout_rate, seed), stream,
            )
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: cudaError_t {err}")
        self.launches += 1
        return dq, dk, dv


packed_attention_causal = PackedAttentionKernel(causal=True)
packed_attention_kvlen = PackedAttentionKernel(causal=False)
packed_attention_bwd_causal = PackedAttentionBwdKernel(causal=True)
packed_attention_bwd_kvlen = PackedAttentionBwdKernel(causal=False)
# K3: the same kernels on the folded (B*H, T, Dh) view, counted apart
folded_attention_fwd = PackedAttentionKernel(
    causal=True, name="folded_attention_fwd",
    replaces="kokoro_tpu/ops/fused_attention.py:153 (_call_fwd)")
folded_attention_bwd = PackedAttentionBwdKernel(
    causal=True, name="folded_attention_bwd",
    replaces="kokoro_tpu/ops/fused_attention.py:179 (_call_bwd)")
FWD_KERNELS = (packed_attention_causal, packed_attention_kvlen)
BWD_KERNELS = (packed_attention_bwd_causal, packed_attention_bwd_kvlen)
FOLDED_KERNELS = (folded_attention_fwd, folded_attention_bwd)
KERNELS = FWD_KERNELS + BWD_KERNELS + FOLDED_KERNELS


def total_launches() -> int:
    return sum(kern.launches for kern in KERNELS)


def _kernel_pair(variant: str):
    """(forward, backward) wrappers of a variant, looked up when called."""
    if variant == "folded":
        return folded_attention_fwd, folded_attention_bwd
    if variant == "causal":
        return packed_attention_causal, packed_attention_bwd_causal
    return packed_attention_kvlen, packed_attention_bwd_kvlen


class PackedAttentionFunction(torch.autograd.Function):
    """Packed attention with its backward: plain forward and plain backward
    on CPU tensors, the forward and backward kernels of ``variant``
    ("causal", "kvlen" or "folded") on CUDA tensors.  When a gradient is
    wanted both save the same tensors for the backward (:data:`SAVED`): q,
    k, v, o, the f32 row lse, O's bf16 rounding residual (None for f32) and
    kv_lengths; the seed and the other arguments are plain Python values.
    Without grad the forward writes and saves neither lse nor residual."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lengths, num_heads, scale, variant, dropout_rate, seed):
        causal = variant != "kvlen"
        kw = dict(num_heads=num_heads, scale=scale, kv_lengths=kv_lengths,
                  dropout_rate=dropout_rate, seed=seed)
        grad = any(ctx.needs_input_grad[:3])
        if q.device.type == "cpu":
            out = packed_attention_reference(q, k, v, causal=causal, for_backward=grad, **kw)
        else:
            out = _kernel_pair(variant)[0](q, k, v, for_backward=grad, **kw)
        o, lse, residual = out if grad else (out, None, None)
        ctx.save_for_backward(q, k, v, o, lse, residual, kv_lengths)
        ctx.args = (num_heads, scale, variant, dropout_rate, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, residual, kv_lengths = ctx.saved_tensors
        num_heads, scale, variant, dropout_rate, seed = ctx.args
        kw = dict(num_heads=num_heads, scale=scale, kv_lengths=kv_lengths,
                  dropout_rate=dropout_rate, seed=seed)
        do = do.contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = packed_attention_bwd_reference(
                q, k, v, do, causal=variant != "kvlen", o=o, residual=residual, **kw)
        else:
            dq, dk, dv = _kernel_pair(variant)[1](q, k, v, o, do, lse, residual, **kw)
        return dq, dk, dv, None, None, None, None, None, None


# the names of what PackedAttentionFunction saves, in order
SAVED = ("q", "k", "v", "o", "lse", "residual", "kv_lengths")


def packed_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, num_heads: int,
    scale: float, causal: bool = True, kv_lengths: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0, seed: Optional[int] = None,
) -> torch.Tensor:
    """Packed attention ``(B, T, H*Dh) -> (B, T, H*Dh)``, differentiable.

    CPU tensors run the plain versions; CUDA tensors launch the kernels.
    ``dropout_rate > 0`` needs ``seed`` (a 64-bit int): the mask is a pure
    function of it, so a call with the same seed drops the same weights.
    Refuses dtypes other than float32/bfloat16 and head_dim outside
    {64, 128} on every device."""
    _check(q, k, v, num_heads, kv_lengths, dropout_rate, seed)
    kv_lengths = None if causal else kv_lengths
    return PackedAttentionFunction.apply(q, k, v, kv_lengths, num_heads, scale,
                                         "causal" if causal else "kvlen", dropout_rate, seed)


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    dropout_rate: float = 0.0, seed: Optional[int] = None,
) -> torch.Tensor:
    """K3: causal self-attention ``(B, H, T, Dh) -> (B, H, T, Dh)``,
    differentiable (the counterpart of ``fused_attention.py::fused_attention``).

    The inputs are folded to ``(B*H, T, Dh)``, the packed layout with one
    head: CPU tensors run the packed plain versions on that view, CUDA
    tensors launch the folded wrappers.  The reference's zero-padding of T to
    a multiple of 128 is TPU-only; the kernels mask by bounds.  ``seed`` as
    in :func:`packed_attention`."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, H, T, Dh) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, T, Dh = q.shape
    folded = [x.contiguous().view(B * H, T, Dh) for x in (q, k, v)]
    _check(*folded, 1, None, dropout_rate, seed)
    out = PackedAttentionFunction.apply(*folded, None, 1, scale, "folded", dropout_rate, seed)
    return out.view(B, H, T, Dh)
