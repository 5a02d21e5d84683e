"""Transformer building blocks: multi-head attention (RoPE or ALiBi, per-head
RMSNorm on Q, K and V), GLU feed-forward, stochastic depth, pre-norm encoder
and decoder blocks.

Port of ``kokoro_tpu/models/blocks.py``.  What must match the flax modules:

* LayerNorm and RMSNorm use eps 1e-6 and float32 statistics, the variance as
  E[x^2] - E[x]^2 clipped at 0 (flax's fast variance);
* GELU is the tanh approximation;
* w_q, w_k, w_v are bias-free, w_o has a bias; a flax Dense ``kernel (in, out)``
  is a torch ``weight (out, in)``;
* logits and softmax are float32 with the -1e9 masked constant;
* ALiBi reproduces the reference's bidirectional quirk (positive bias toward
  distant future keys in non-causal attention) on purpose.

Attention routes with ``use_flash``, in the reference's order
(``MultiHeadAttention.__call__``), for full-sequence attention without ALiBi:

1. K4 (``ops/flash_attention.py``): causal attention at T >= 1024 in multiples
   of 128 with attention dropout inactive, on the head-split path, at every
   head dim that is a multiple of 64 (at one head of the flagship's hidden
   512, Dh 512; of hidden 1536, Dh 1536; of hidden 2560, Dh 2560; from each
   dtype's crossover on the kernels keep the scores in device memory);
2. K1 (``ops/fused_attention.py``, packed): any other causal self-attention;
3. K2 (packed, kv lengths): cross-attention with q_len == kv_len;
4. K3 (``fused_attention``, folded): causal attention on the head-split path
   (a key given) with q_len == kv_len;
5. everything else (the encoder, the cached decode step, precomputed cross
   K/V) is plain matmul/softmax, as the JAX package leaves it to XLA.

K1, K2 and K3 take head dims 64 and 128, as the reference's packed gate
does (``fused_attention.SUPPORTED_HEAD_DIMS``); K4 takes its own
(``flash_attention.supported_head_dim``: every multiple of 64).

The packed routes take any T: the reference's TPU-only gates (128 <= T <=
896) do not carry over, so K1 and K2 also run outside K4's regime where the
reference uses einsum.  KV caches are preallocated ``(B, H, S, Dh)`` tensors
updated in place.

Training: every random draw (dropout, stochastic depth, the kernels'
attention dropout) comes from the ``rng`` argument (``models/rng.py``), one
named child per site; the global RNG is never read.  :class:`Linear` and
:class:`Embedding` compute in their ``compute_dtype`` when it is set (flax's
``dtype`` over ``param_dtype``: input and weight are cast, the f32 parameters
keep the gradient); the norms keep f32 statistics and f32 scales.

Tensor parallelism (``parallel/tp.py::shard_model``): a sharded attention
block holds ``num_heads / tp`` heads (``local_heads``, the global heads from
``head_offset``) and a sharded GLU ``ff / tp`` of its width; each takes its
input through ``copy_to_region`` and sums its output projection over the
``model`` group before adding the bias.  Sites on the sharded activations
(the attention dropout, the GLU's ``dropout_0``) fold the model rank into
their stream; every other site draws the same mask on every rank of a
``model`` group.  A sharded block runs the training and evaluation forwards,
not the cached decode step.

Sequence parallelism (``KokoroModel.shard_sequence``): a decoder block with
``sp_mesh`` runs on the seq rank's window of frames, which starts at global
frame ``offset = s * T_local``.  Its causal self-attention gathers the
whole K and V over the ``seq`` group (``parallel/mesh.py::seq_gather``,
after RoPE at the global positions) and its local queries attend to them
under the causal mask and ALiBi at ``offset``; cross-attention takes the
whole memory with local queries and needs no gather.  The sites on local
frames (every dropout of the block and its attention) fold the seq rank
into their stream; stochastic depth, a draw per batch row, does not.  Such
a block runs the plain attention route, as the reference's trainer turns
its kernels off under ``seq``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from kokoro_tpu_torch.models.positional import apply_rope, apply_rope_heads_last
from kokoro_tpu_torch.models.rng import Rng, attention_seed, drop_path, dropout, fold
from kokoro_tpu_torch.ops.flash_attention import flash_attention, flash_supported
from kokoro_tpu_torch.ops.fused_attention import (
    SUPPORTED_HEAD_DIMS as PACKED_HEAD_DIMS, fused_attention, packed_attention,
)
from kokoro_tpu_torch.parallel.mesh import seq_gather
from kokoro_tpu_torch.parallel.tp import copy_to_region, reduce_from_region

NEG_INF = -1e9


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype`` (None: the weight's
    dtype), as a flax ``Dense(dtype=..., param_dtype=...)`` does."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)

    def row_parallel(self, x: torch.Tensor, mesh) -> torch.Tensor:
        """The row-parallel projection of a sharded input: the local
        product summed over ``mesh``'s ``model`` group, then the bias."""
        dt = self.compute_dtype or self.weight.dtype
        y = reduce_from_region(F.linear(x.to(dt), self.weight.to(dt)), mesh)
        return y if self.bias is None else y + self.bias.to(dt)


def _model_rank_stream(rng: Optional[Rng], mesh) -> Optional[Rng]:
    """The stream of a site on a sharded activation: the model rank folded
    in, so each rank drops its own heads' or features' weights."""
    return rng if mesh is None or rng is None else rng.fold(f"model_rank_{mesh.index('model')}")


def _seq_rank_stream(rng: Optional[Rng], mesh) -> Optional[Rng]:
    """The stream of a site on the seq rank's window of frames: the seq rank
    folded in, so each rank draws its own frames' masks."""
    return rng if mesh is None or rng is None else rng.fold(f"seq_rank_{mesh.index('seq')}")


class Embedding(nn.Embedding):
    """``nn.Embedding`` whose table is read in ``compute_dtype`` (flax
    ``Embed(dtype=...)``)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.weight.to(self.compute_dtype or self.weight.dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: eps 1e-6, f32 statistics, fast variance."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((x32 - mean) * mul + self.bias.float()).to(x.dtype)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: eps 1e-6, f32 statistics, scale only."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = (x32 * x32).mean(-1, keepdim=True)
        return (x32 * (torch.rsqrt(var + self.eps) * self.weight.float())).to(x.dtype)


def alibi_slopes(num_heads: int) -> torch.Tensor:
    return torch.tensor(
        [2.0 ** (-8.0 * (i + 1) / num_heads) for i in range(num_heads)], dtype=torch.float32
    )


class MultiHeadAttention(nn.Module):
    """Multi-head attention with optional RoPE/ALiBi and per-head q/k/v RMSNorm.

    ``forward`` returns ``(output, updated_kv_cache_or_None)``.  A
    ``kv_cache={'k': (B,H,S,Dh), 'v': ..., 'index': i}`` runs a cached decode
    step: the new K/V are written in place at ``index`` and attention spans
    ``[0, index + Tq)``.  ``precomputed_kv=(K, V)`` attends a fixed memory."""

    def __init__(
        self, d_model: int, num_heads: int, dropout: float = 0.1, *,
        use_rope: bool = False, use_alibi: bool = False, qk_norm: bool = False,
        use_flash: bool = False,
    ):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.dropout = dropout
        self.use_rope = use_rope
        self.use_alibi = use_alibi
        self.qk_norm = qk_norm
        self.use_flash = use_flash
        self.w_q = Linear(d_model, d_model, bias=False)
        self.w_k = Linear(d_model, d_model, bias=False)
        self.w_v = Linear(d_model, d_model, bias=False)
        self.w_o = Linear(d_model, d_model, bias=True)
        if qk_norm:
            self.q_norm = RMSNorm(self.head_dim)
            self.k_norm = RMSNorm(self.head_dim)
            self.v_norm = RMSNorm(self.head_dim)
        # this rank's heads: all of them unless sharded (shard_heads)
        self.local_heads, self.head_offset, self.tp_mesh = num_heads, 0, None
        # set on a decoder's causal self-attention under a 'seq' axis
        self.sp_mesh = None

    def shard_heads(self, mesh) -> None:
        """Run on this rank's ``num_heads / tp`` heads of ``mesh``'s
        ``model`` axis (``parallel/tp.py::shard_model`` slices the weights)."""
        self.local_heads = self.num_heads // mesh.tp
        self.head_offset = mesh.index("model") * self.local_heads
        self.tp_mesh = mesh

    @property
    def local_width(self) -> int:
        return self.local_heads * self.head_dim

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_mesh is None:
            return self.w_o(x)
        return self.w_o.row_parallel(x, self.tp_mesh)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        return x.reshape(B, T, self.local_heads, -1).transpose(1, 2)

    def _norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, name)(x) if self.qk_norm else x

    def project_kv(self, memory: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Cross-attention K/V ``(B, H, S, Dh)`` for a fixed memory."""
        k = self._norm("k_norm", self._heads(self.w_k(memory)))
        v = self._norm("v_norm", self._heads(self.w_v(memory)))
        return k, v

    def _packed(self, query, key, key_padding_mask, causal, rate, rng):
        """Heads-last packed projections -> the packed dispatcher -> w_o; no
        head transpose is ever materialised."""
        B, T, _ = query.shape
        H, Dh = self.local_heads, self.head_dim

        def heads_last(lin, norm, x, rope_pos):
            h = self._norm(norm, lin(x).reshape(B, T, H, Dh))
            if self.use_rope and rope_pos is not None:
                h = apply_rope_heads_last(h, rope_pos)
            # the projections' compute dtype, as the reference's astype(dtype)
            return h.reshape(B, T, H * Dh).to(lin.compute_dtype or h.dtype).contiguous()

        if causal:
            pos = torch.arange(T, device=query.device)
            q = heads_last(self.w_q, "q_norm", query, pos)
            k = heads_last(self.w_k, "k_norm", query, pos)
            v = heads_last(self.w_v, "v_norm", query, None)
            kv_lens = None
        else:
            q = heads_last(self.w_q, "q_norm", query, None)
            k = heads_last(self.w_k, "k_norm", key, None)
            v = heads_last(self.w_v, "v_norm", key, None)
            kv_lens = (
                None if key_padding_mask is None
                else (T - key_padding_mask.sum(-1)).to(torch.int32)
            )
        out = packed_attention(
            q, k, v, num_heads=H, scale=1.0 / math.sqrt(Dh), causal=causal,
            kv_lengths=kv_lens, dropout_rate=rate, seed=attention_seed(rng, rate),
        )
        return self._out(out)

    def _head_split_kernel(self, q, k, v, flash, rate, rng):
        """Head-first q, k, v -> K4 (``flash``) or K3 -> w_o.  Causal under
        suffix padding needs no key mask (as in :meth:`_packed`)."""
        B, H, Tq, Dh = q.shape
        dt = self.w_q.compute_dtype or self.w_q.weight.dtype
        q, k, v = (x.to(dt) for x in (q, k, v))
        if flash:
            out = flash_attention(q, k, v, causal=True, scale=1.0 / math.sqrt(Dh))
        else:
            out = fused_attention(q, k, v, scale=1.0 / math.sqrt(Dh), dropout_rate=rate,
                                  seed=attention_seed(rng, rate))
        return self._out(out.transpose(1, 2).reshape(B, Tq, H * Dh))

    def forward(
        self, query: torch.Tensor, key: Optional[torch.Tensor] = None,
        value: Optional[torch.Tensor] = None, *, causal: bool = False,
        key_padding_mask: Optional[torch.Tensor] = None,  # (B, S) True = pad
        kv_cache: Optional[dict] = None,
        precomputed_kv: Optional[tuple] = None,
        rng: Optional[Rng] = None,
    ):
        B, Tq, _ = query.shape
        rate = self.dropout if self.training else 0.0
        if self.tp_mesh is not None:
            if kv_cache is not None or precomputed_kv is not None:
                raise NotImplementedError("a sharded attention block runs full sequences only")
            rng = _model_rank_stream(rng, self.tp_mesh)
            shared_value = value is key
            query = copy_to_region(query, self.tp_mesh)
            if key is not None:
                key = copy_to_region(key, self.tp_mesh)
            if shared_value:
                value = key
            elif value is not None:
                value = copy_to_region(value, self.tp_mesh)
        if self.sp_mesh is not None and kv_cache is None and precomputed_kv is None:
            return self._seq_parallel(query, key_padding_mask, rng), None
        kernels = (self.use_flash and kv_cache is None and precomputed_kv is None
                   and not self.use_alibi)
        # the packed kernels' head dims (K1, K2, K3)
        full_seq = kernels and self.head_dim in PACKED_HEAD_DIMS
        Tk = Tq if key is None else key.shape[1]
        # K4 takes the long causal regime when no attention weight is dropped,
        # at its own head dims
        flash = (kernels and causal and rate == 0.0
                 and flash_supported(Tq, Tk, self.head_dim, causal))
        # causal self-attention needs no key mask under suffix padding: a
        # padded key is visible only to padded queries, masked downstream
        if full_seq and causal and key is None and value is None and not flash:
            return self._packed(query, None, None, True, rate, rng), None
        if (
            full_seq and not causal and key is not None
            and (value is None or value is key) and not self.use_rope
            and Tq == key.shape[1]
        ):
            return self._packed(query, key, key_padding_mask, False, rate, rng), None

        q = self._norm("q_norm", self._heads(self.w_q(query)))
        new_cache = None
        if precomputed_kv is not None:
            k, v = precomputed_kv
        elif kv_cache is not None:
            key = query if key is None else key
            k_new = self._norm("k_norm", self._heads(self.w_k(key)))
            v_new = self._norm("v_norm", self._heads(self.w_v(key)))
            index = int(kv_cache["index"])
            if self.use_rope:
                pos_new = index + torch.arange(Tq, device=query.device)
                k_new = apply_rope(k_new, pos_new)
                q = apply_rope(q, pos_new)
            k, v = kv_cache["k"], kv_cache["v"]
            k[:, :, index : index + Tq] = k_new.to(k.dtype)
            v[:, :, index : index + Tq] = v_new.to(v.dtype)
            new_cache = {"k": k, "v": v, "index": index + Tq}
            S = k.shape[2]
            # cache slots beyond the write frontier are masked
            invalid = torch.arange(S, device=query.device) > (index + Tq - 1)
            key_padding_mask = (
                invalid.expand(B, S) if key_padding_mask is None
                else (key_padding_mask.to(torch.bool) | invalid)
            )
        else:
            key = query if key is None else key
            value = key if value is None else value
            k = self._norm("k_norm", self._heads(self.w_k(key)))
            v = self._norm("v_norm", self._heads(self.w_v(value)))
            if self.use_rope:
                pos = torch.arange(k.shape[2], device=query.device)
                q = apply_rope(q, pos[:Tq])
                k = apply_rope(k, pos)
            if flash or (full_seq and causal and Tq == Tk):
                return self._head_split_kernel(q, k, v, flash, rate, rng), None

        Tk = k.shape[2]
        if kv_cache is not None:
            q_start = kv_cache["index"]
        else:
            q_start = Tk - Tq
        return self._attend(q, k, v, q_start, causal and kv_cache is None, key_padding_mask,
                            rng, query.dtype), new_cache

    def _attend(self, q, k, v, q_start: int, causal: bool, key_padding_mask, rng, dtype):
        """The plain route from head-split q, k, v to the output projection:
        float32 logits, ALiBi and the causal mask with query i at key
        position ``q_start + i``, the key mask, softmax, weight dropout."""
        B, _, Tq, _ = q.shape
        Tk = k.shape[2]
        device = q.device
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
            1.0 / math.sqrt(self.head_dim)
        )
        if self.use_alibi:  # the slopes of this rank's global heads
            slopes = alibi_slopes(self.num_heads)[
                self.head_offset:self.head_offset + self.local_heads].to(device)
            q_pos = (q_start + torch.arange(Tq, device=device)).float()
            dist = torch.arange(Tk, device=device, dtype=torch.float32)[None, :] - q_pos[:, None]
            logits = logits + slopes[None, :, None, None] * dist[None, None]
        neg = torch.full((), NEG_INF, device=device)
        if causal:
            mask = torch.ones(Tq, Tk, dtype=torch.bool, device=device).tril(q_start)
            logits = torch.where(mask[None, None], logits, neg)
        if key_padding_mask is not None:
            logits = torch.where(key_padding_mask[:, None, None, :].to(torch.bool), neg, logits)
        weights = dropout(torch.softmax(logits, dim=-1).to(dtype), self.dropout, rng,
                          self.training)
        out = torch.matmul(weights, v.to(weights.dtype))
        out = out.transpose(1, 2).reshape(B, Tq, self.local_width)
        return self._out(out)

    def _seq_parallel(self, query, key_padding_mask, rng):
        """Causal self-attention of the seq rank's frames: RoPE at the
        global positions ``offset + i``, the whole K and V gathered over the
        ``seq`` group in one collective (``key_padding_mask`` is the whole
        frame axis's), local queries at ``offset``."""
        Tl = query.shape[1]
        offset = self.sp_mesh.index("seq") * Tl
        q = self._norm("q_norm", self._heads(self.w_q(query)))
        k = self._norm("k_norm", self._heads(self.w_k(query)))
        v = self._norm("v_norm", self._heads(self.w_v(query)))
        if self.use_rope:
            pos = offset + torch.arange(Tl, device=query.device)
            q, k = apply_rope(q, pos), apply_rope(k, pos)
        k, v = seq_gather(torch.stack([k, v.to(k.dtype)]), 3, self.sp_mesh).unbind(0)
        return self._attend(q, k, v, offset, True, key_padding_mask, rng, query.dtype)


class GLUFeedForward(nn.Module):
    """linear1 -> split (gate, linear) -> gelu(gate) * linear -> dropout ->
    linear2 -> optional RMSNorm -> dropout (flax's gelu: the tanh form)."""

    def __init__(self, d_model: int, dim_feedforward: int, dropout: float = 0.1,
                 use_output_norm: bool = False):
        super().__init__()
        self.linear1 = Linear(d_model, dim_feedforward * 2)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.output_norm = RMSNorm(d_model) if use_output_norm else None
        self.dropout = dropout
        # set by parallel/tp.py::shard_model: linear1 holds this rank's rows of
        # the gate half and the same rows of the linear half, linear2 the
        # matching columns
        self.tp_mesh = None

    def forward(self, x: torch.Tensor, rng: Optional[Rng] = None) -> torch.Tensor:
        mesh = self.tp_mesh
        if mesh is not None:
            x = copy_to_region(x, mesh)
        gate, linear = self.linear1(x).chunk(2, dim=-1)
        h = dropout(F.gelu(gate, approximate="tanh") * linear, self.dropout,
                    _model_rank_stream(fold(rng, "dropout_0"), mesh), self.training)
        h = self.linear2(h) if mesh is None else self.linear2.row_parallel(h, mesh)
        if self.output_norm is not None:
            h = self.output_norm(h)
        return dropout(h, self.dropout, fold(rng, "dropout_1"), self.training)


class EncoderBlock(nn.Module):
    """Pre-norm encoder block: self-attention + GLU FFN."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dropout: float, drop_path_rate: float = 0.0, qk_norm: bool = False,
                 ffn_output_norm: bool = False, attention_weight_dropout: bool = True,
                 use_flash: bool = False, rel_pos_type: str = "rope"):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNorm(d_model)
        self.self_attn = MultiHeadAttention(
            d_model, num_heads, dropout if attention_weight_dropout else 0.0,
            use_rope=rel_pos_type == "rope", use_alibi=rel_pos_type == "alibi",
            qk_norm=qk_norm, use_flash=use_flash,
        )
        self.norm2 = LayerNorm(d_model)
        self.ff = GLUFeedForward(d_model, dim_feedforward, dropout,
                                 use_output_norm=ffn_output_norm)
        self.dropout = dropout

    def _residual(self, out, i, rng, frame_rng=None):
        # stochastic depth draws per batch row from ``rng``; the dropout
        # draws per element from ``frame_rng`` (the seq rank folded in)
        out = drop_path(out, self.drop_path_rate, fold(rng, f"drop_path_{i}"), self.training)
        return dropout(out, self.dropout, fold(frame_rng or rng, f"dropout_{i}"),
                       self.training)

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                rng: Optional[Rng] = None):
        attn_out, _ = self.self_attn(self.norm1(x), key_padding_mask=padding_mask,
                                     rng=fold(rng, "self_attn"))
        x = x + self._residual(attn_out, 0, rng)
        ff_out = self.ff(self.norm2(x), rng=fold(rng, "ff"))
        return x + self._residual(ff_out, 1, rng)


class DecoderBlock(nn.Module):
    """Pre-norm decoder block: causal self-attention (RoPE) + cross-attention
    (no positions) + GLU FFN."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dropout: float, drop_path_rate: float = 0.0, qk_norm: bool = False,
                 ffn_output_norm: bool = False, attention_weight_dropout: bool = True,
                 use_flash: bool = False, rel_pos_type: str = "rope"):
        super().__init__()
        attn_p = dropout if attention_weight_dropout else 0.0
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.self_attn = MultiHeadAttention(
            d_model, num_heads, attn_p, use_rope=rel_pos_type == "rope",
            use_alibi=rel_pos_type == "alibi", qk_norm=qk_norm, use_flash=use_flash,
        )
        self.cross_attn = MultiHeadAttention(
            d_model, num_heads, attn_p, use_rope=False, qk_norm=qk_norm,
            use_flash=use_flash,
        )
        self.ff = GLUFeedForward(d_model, dim_feedforward, dropout,
                                 use_output_norm=ffn_output_norm)
        self.dropout = dropout
        self.sp_mesh = None  # set by KokoroModel.shard_sequence

    _residual = EncoderBlock._residual

    def shard_sequence(self, mesh) -> None:
        """Run on the seq rank's window of frames of ``mesh`` (module
        docstring)."""
        self.sp_mesh = self.self_attn.sp_mesh = mesh

    def forward(
        self, x: torch.Tensor, memory: Optional[torch.Tensor] = None,
        memory_padding_mask: Optional[torch.Tensor] = None,
        tgt_padding_mask: Optional[torch.Tensor] = None,
        self_kv_cache: Optional[dict] = None, cross_kv: Optional[tuple] = None,
        rng: Optional[Rng] = None,
    ):
        """Full-sequence or cached single-step forward; returns
        ``(y, new_self_kv_cache)``.  Under ``sp_mesh`` ``x`` is the seq
        rank's window of frames, ``tgt_padding_mask`` (keys) the whole frame
        axis's and ``memory`` whole."""
        frame_rng = _seq_rank_stream(rng, self.sp_mesh)
        attn_out, new_cache = self.self_attn(
            self.norm1(x), causal=True, key_padding_mask=tgt_padding_mask,
            kv_cache=self_kv_cache, rng=fold(frame_rng, "self_attn"),
        )
        x = x + self._residual(attn_out, 0, rng, frame_rng)
        cross_out, _ = self.cross_attn(
            self.norm2(x), memory, memory, key_padding_mask=memory_padding_mask,
            precomputed_kv=cross_kv, rng=fold(frame_rng, "cross_attn"),
        )
        x = x + self._residual(cross_out, 1, rng, frame_rng)
        ff_out = self.ff(self.norm3(x), rng=fold(frame_rng, "ff"))
        return x + self._residual(ff_out, 2, rng, frame_rng), new_cache

    def project_cross_kv(self, memory: torch.Tensor):
        return self.cross_attn.project_kv(memory)
