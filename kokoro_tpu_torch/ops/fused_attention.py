"""Packed fused attention: the Hopper kernel, its plain version, the dispatcher.

Port of ``kokoro_tpu/ops/fused_attention.py::fused_attention_packed`` (the
forward of ``_call_fwd_packed``): attention on PACKED projections
``(B, T, H*Dh) -> (B, T, H*Dh)``, either causal (decoder self-attention, K1)
or non-causal with per-row ``kv_lengths`` (decoder cross-attention, K2, where
keys at ``col >= kv_lengths[b]`` are masked and q_len == kv_len).

* :func:`packed_attention_reference` is the plain PyTorch version of the
  function: f32 logits, the -1e9 masked constant, f32 softmax, the weights
  cast to the input dtype, then P @ V with f32 sums.
* :data:`packed_attention_causal` (K1) and :data:`packed_attention_kvlen`
  (K2) launch the CUDA kernel (``csrc/packed_attention.cu``) and count their
  launches.
* :func:`packed_attention` is the one dispatcher the model calls: CPU tensors
  take the plain version, CUDA tensors launch the kernel or raise.  Nothing
  falls back.

The TPU-only gates of the reference (``MIN/MAX_FUSED_LEN``, zero-padding T to
a multiple of 128, the 128-lane head-panel rule) do not carry over: the
kernel masks by bounds at any T.  Attention-weight dropout (rate > 0) is not
implemented yet and raises; it comes with the backward kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e9  # masked-logit constant, as in models/blocks.py
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
SUPPORTED_HEAD_DIMS = (64, 128)


def _check(q, k, v, num_heads, kv_lengths, dropout_rate):
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "packed attention with dropout_rate > 0 is not ported yet"
        )
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


def packed_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, num_heads: int,
    scale: float, causal: bool = True, kv_lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch packed attention, the kernel's contract (any head_dim)."""
    B, T, D = q.shape
    H = num_heads

    def heads(x):
        return x.reshape(B, T, H, D // H).transpose(1, 2)

    s = torch.matmul(heads(q).float(), heads(k).float().transpose(-1, -2)) * scale
    cols = torch.arange(T, device=q.device)
    if causal:
        visible = (cols[None, :] <= cols[:, None])[None, None]
    elif kv_lengths is not None:
        visible = (cols[None, :] < kv_lengths.to(q.device)[:, None])[:, None, None, :]
    else:
        visible = None
    if visible is not None:
        s = torch.where(visible, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.matmul(p.float(), heads(v).float()).to(q.dtype)
    return o.transpose(1, 2).reshape(B, T, D)


class PackedAttentionKernel:
    """Wrapper of ``kokoro_packed_attention_fwd`` for one variant: causal (K1)
    or non-causal with optional ``kv_lengths`` (K2).  ``launches`` counts the
    launches this wrapper made, and nothing else."""

    source = "kokoro_tpu_torch/csrc/packed_attention.cu"
    replaces = "kokoro_tpu/ops/fused_attention.py:322 (_call_fwd_packed)"

    def __init__(self, causal: bool) -> None:
        self.causal = causal
        self.name = "packed_attention_fwd_" + ("causal" if causal else "kvlen")
        self.launches = 0

    def __call__(
        self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        num_heads: int, scale: float, kv_lengths: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        _check(q, k, v, num_heads, kv_lengths, 0.0)
        if q.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors; got {q.device}")
        for name, x in (("q", q), ("k", k), ("v", v)):
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
        lens_ptr = None
        if kv_lengths is not None and not self.causal:
            kv_lengths = kv_lengths.to(torch.int32).contiguous()
            lens_ptr = kv_lengths.data_ptr()
        from kokoro_tpu_torch.ops import kernels

        lib = kernels.load("packed_attention")
        B, T, D = q.shape
        o = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            err = lib.kokoro_packed_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lens_ptr,
                B, T, num_heads, D // num_heads, ctypes.c_float(float(scale)),
                int(self.causal), 0 if q.dtype == torch.float32 else 1, stream,
            )
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: cudaError_t {err}")
        self.launches += 1
        return o


packed_attention_causal = PackedAttentionKernel(causal=True)
packed_attention_kvlen = PackedAttentionKernel(causal=False)
KERNELS = (packed_attention_causal, packed_attention_kvlen)


def total_launches() -> int:
    return sum(kern.launches for kern in KERNELS)


def packed_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, num_heads: int,
    scale: float, causal: bool = True, kv_lengths: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """Packed attention ``(B, T, H*Dh) -> (B, T, H*Dh)``.

    CPU tensors run :func:`packed_attention_reference`; CUDA tensors launch the
    kernel.  Refuses ``dropout_rate > 0``, dtypes other than float32/bfloat16
    and head_dim outside {64, 128} on every device."""
    _check(q, k, v, num_heads, kv_lengths, dropout_rate)
    kv_lengths = None if causal else kv_lengths
    if q.device.type == "cpu":
        return packed_attention_reference(q, k, v, num_heads=num_heads, scale=scale,
                                          causal=causal, kv_lengths=kv_lengths)
    kernel = packed_attention_causal if causal else packed_attention_kvlen
    return kernel(q, k, v, num_heads=num_heads, scale=scale, kv_lengths=kv_lengths)
