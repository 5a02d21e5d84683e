"""The yardstick's arithmetic: the card's peaks, the least time an attention
call's inputs need, and the model FLOPs of a training step, all from shapes.

The attention bound is ``chip_smoke.py``'s (``visible_pairs``,
``attention_bound``), copied: each input byte read once and each output
written once, 4*Dh operations per visible (query, key) pair forward and
10*Dh backward, the larger of the bytes at the HBM rate and the operations
at the tensor-core rate.
"""

from __future__ import annotations

from typing import Optional, Sequence

# one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 495e12 / 3}  # f32: 3xTF32 on the tensor cores
PEAK_BF16 = 989e12


def visible_pairs(B: int, T: int, causal: bool, lens: Optional[Sequence[int]] = None) -> int:
    """(query, key) pairs over B rows of T queries and T keys, heads not
    counted: the causal triangle, or each row's key length (a row of length
    0 averages all T keys)."""
    if causal:
        return B * T * (T + 1) // 2
    if lens is None:
        return B * T * T
    return T * sum(min(x, T) if x > 0 else T for x in lens)


def attention_bound(B: int, T: int, H: int, Dh: int, dtype_name: str, causal: bool,
                    lens: Optional[Sequence[int]] = None, *, backward: bool = False) -> dict:
    """Least seconds for the work this input needs, what bounds it, and its
    operations.  Forward: q, k, v read, o written; backward: q, k, v, o, dO
    and the f32 lse read, dq, dk, dv written; key lengths (4 bytes a row)
    read."""
    elem = 2 if dtype_name == "bfloat16" else 4
    tensors = 8 if backward else 4
    nbytes = tensors * B * T * H * Dh * elem + (4 * B * H * T if backward else 0)
    nbytes += 4 * B if lens is not None else 0
    ops = (10 if backward else 4) * Dh * H * visible_pairs(B, T, causal, lens)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype_name]
    return {"bound_s": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations", "ops": ops}


def forward_flops(m: dict, B: int, T: int, L: int, causal_full: bool = False) -> int:
    """FLOPs of the matrix products, convolutions and attention products of
    one training forward on a ``(B, T frames, L phonemes)`` batch, as the
    shapes give them (padding included).  Causal self-attention counts its
    visible triangle; ``causal_full`` counts the whole square, as a plain
    route computes it."""
    D, H, M = m["hidden_dim"], m["n_heads"], m["n_mels"]
    Fe, Fd = m["encoder_ff_dim"], m["decoder_ff_dim"]
    V, K = m["variance_filter_size"], m["variance_kernel_size"]

    def dense(rows, n_in, n_out):
        return 2 * rows * n_in * n_out

    def glu(rows, ff):
        return dense(rows, D, 2 * ff) + dense(rows, ff, D)

    def predictor(rows):
        return dense(rows, D * K, V) + dense(rows, V * K, V) + dense(rows, V, 1)

    enc = m["n_encoder_layers"] * (4 * dense(B * L, D, D) + 4 * B * L * L * D + glu(B * L, Fe))
    pairs = B * T * T if causal_full else B * T * (T + 1) // 2
    dec = m["n_decoder_layers"] * (
        4 * dense(B * T, D, D) + 4 * pairs * D         # causal self-attention
        + 4 * dense(B * T, D, D) + 4 * B * T * T * D   # cross-attention over the frames
        + glu(B * T, Fd))
    adaptor = predictor(B * L) + 2 * predictor(B * T)
    heads = dense(B * T, M, D) + dense(B * T, D, M) + dense(B * T, D, 1)
    return enc + dec + adaptor + heads


def step_flops(m: dict, B: int, T: int, L: int) -> int:
    """Model FLOPs of a training step: the forward's, times three for the
    backward's two products per forward product, no recompute counted."""
    return 3 * forward_flops(m, B, T, L)
