"""K4's "scores in memory" kernels: their launches, their workspaces and
their schedule.

The kernels (``csrc/attention_scores_tc.cuh`` in bf16,
``csrc/attention_scores_tf32.cuh`` in f32, both wgmma fed by TMA, sharing
``csrc/attention_scores.cuh``'s schedule and row pass; launched by
``kokoro_flash_attention_{fwd,bwd}_scores`` in ``csrc/flash_attention.cu``
and ``csrc/flash_attention_bwd.cu``) keep each head's score matrix in device
memory: a scores product over the whole head dim into (128 x 128)-tiles,
a row pass, and products over keys or queries by 128-column strips of the
head dim, so they take any head dim that is a multiple of 64.
``ops/flash_attention.py``'s wrappers send them bf16 from
``BF16_SCORES_FROM`` and f32 from ``F32_SCORES_FROM`` on, and count the
launches; :func:`scores_fwd` / :func:`scores_bwd` here launch without
counting, so that a measurement can also run them at head dims the wrappers
give the on-chip kernels.

The schedule functions mirror the launchers' (``attention_scores.cuh``:
``score_tiles``, ``score_tile``, ``apply_range``; each dtype's ``grid_of``
and chunk), for the workspaces' sizes and the tests on the CPU;
``kokoro_flash_attention_scores_grid`` returns the launcher's own counts on
the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

TILE = 128    # a score tile: 128 queries x 128 keys; the workspaces are padded to it
CHUNK = 32    # the f32 contraction's chunk: 128 bytes, one row of the 128-byte swizzle
BF16_CHUNK = 64  # bf16's: the same 128 bytes
STRIP = 128   # head-dim columns a CTA of the products over keys or queries writes


def chunk_of(dtype: torch.dtype) -> int:
    """The contraction's chunk of ``dtype``'s kernels, in elements."""
    return CHUNK if dtype == torch.float32 else BF16_CHUNK


def cta_rows(dtype: torch.dtype) -> int:
    """Rows of a CTA's tile, a whole score tile in both dtypes: two
    warpgroups of 64 x 128 (wgmma)."""
    return TILE


def tiles_of(T: int) -> int:
    return -(-T // TILE)


def padded(T: int) -> int:
    """A workspace's rows (Tq) or columns (Tk): T rounded up to a tile."""
    return tiles_of(T) * TILE


def score_tile_count(Tq: int, Tk: int, causal: bool) -> int:
    """Score tiles of one (b, h): every (query tile, key tile), or under
    causal those holding a key at or below one of their queries."""
    nq, nk = tiles_of(Tq), tiles_of(Tk)
    if not causal:
        return nq * nk
    if nq <= nk:
        return nq * (nq + 1) // 2
    return nk * (nk + 1) // 2 + (nq - nk) * nk


def score_tile(t: int, Tq: int, Tk: int, causal: bool) -> Tuple[int, int]:
    """Tile ``t`` of the list -> (query tile, key tile), row by row."""
    nk = tiles_of(Tk)
    if not causal:
        return t // nk, t % nk
    tri = nk * (nk + 1) // 2
    if t >= tri:
        return nk + (t - tri) // nk, (t - tri) % nk
    i = int((math.sqrt(8.0 * t + 1.0) - 1.0) * 0.5)
    while i > 0 and i * (i + 1) // 2 > t:
        i -= 1
    while (i + 1) * (i + 2) // 2 <= t:
        i += 1
    return i, t - i * (i + 1) // 2


def apply_range(r0: int, rows: int, Tq: int, Tk: int, causal: bool,
                over_queries: bool, chunk: int = CHUNK) -> Tuple[int, int]:
    """The contraction ``[k0, k1)`` of the row tile ``r0 .. r0 + rows`` of a
    product over keys (rows are queries: O, dQ; under causal up to the
    tile's last query) or over queries (rows are keys: dK, dV; under causal
    from the tile's first key), in whole chunks of ``chunk`` (the dtype's,
    :func:`chunk_of`)."""
    if over_queries:
        end = Tq
    else:
        end = min(Tk, r0 + rows) if causal else Tk
    k0 = r0 if over_queries and causal else 0
    k1 = -(-end // chunk) * chunk
    return k0, max(k0, k1)


def dh_strips(Dh: int) -> list:
    """``[(first column, width), ...]`` of the 128-column strips of the head
    dim, the last 64 wide at Dh = 128 n + 64."""
    return [(n0, min(STRIP, Dh - n0)) for n0 in range(0, Dh, STRIP)]


def grid(Tq: int, Tk: int, Dh: int, causal: bool, dtype: torch.dtype) -> dict:
    """The launch's counts, as ``kokoro_flash_attention_scores_grid`` gives
    them: score tiles a (b, h), CTAs a score tile, the row tiles of the
    products over queries' rows (O, dQ) and over keys' rows (dK, dV), the
    head dim's strips, and the contraction's chunk."""
    rows = cta_rows(dtype)
    return {"score_tiles": score_tile_count(Tq, Tk, causal), "ctas_a_tile": TILE // rows,
            "query_rows": -(-Tq // rows), "key_rows": -(-Tk // rows),
            "strips": len(dh_strips(Dh)), "chunk": chunk_of(dtype)}


GRID_KEYS = ("score_tiles", "ctas_a_tile", "query_rows", "key_rows", "strips", "chunk")


def launch_grid(Tq: int, Tk: int, Dh: int, causal: bool, dtype: torch.dtype) -> dict:
    """``grid``'s counts from the compiled launcher (on the machine with the card)."""
    from kokoro_tpu_torch.ops import kernels

    out = (ctypes.c_int * len(GRID_KEYS))()
    err = kernels.load("flash_attention").kokoro_flash_attention_scores_grid(
        Tq, Tk, Dh, int(causal), 0 if dtype == torch.float32 else 1, out)
    if err != 0:
        raise RuntimeError(f"kokoro_flash_attention_scores_grid failed: cudaError_t {err}")
    return dict(zip(GRID_KEYS, out))


def _code(dtype: torch.dtype) -> int:
    return 0 if dtype == torch.float32 else 1


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def scores_fwd(q, k, v, *, causal: bool, scale: float, q_seg=None, kv_seg=None,
               return_lse: bool = False):
    """Launch the forward (scores, row pass, O) on CUDA tensors checked by the
    caller: ``(err, o, lse)``, the C function's error code, the output and
    (``return_lse``, else None) the row log-sum-exp; counts nothing."""
    from kokoro_tpu_torch.ops import kernels

    lib = kernels.load("flash_attention")
    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Tq, device=q.device) if return_lse else None
    s = torch.empty(B * H, padded(Tq), padded(Tk), device=q.device)
    p = s if q.dtype == torch.float32 else torch.empty(s.shape, dtype=q.dtype, device=q.device)
    row_sum = torch.empty(B, H, Tq, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.kokoro_flash_attention_fwd_scores(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _ptr(lse), _ptr(q_seg),
            _ptr(kv_seg), s.data_ptr(), p.data_ptr(), row_sum.data_ptr(), B, H, Tq, Tk, Dh,
            ctypes.c_float(float(scale)), int(causal), _code(q.dtype), stream)
    return err, o, lse


def scores_bwd(q, k, v, o, do, lse, *, causal: bool, scale: float, q_seg=None, kv_seg=None):
    """Launch the backward (row deltas, scores, dQ, dK, dV) on CUDA tensors
    checked by the caller: ``(err, dq, dk, dv)``; counts nothing.  The
    workspaces: bf16 P and dS; f32 P^T, dS and dS^T (the B operands of dV,
    dQ and dK on wgmma)."""
    from kokoro_tpu_torch.ops import kernels

    lib = kernels.load("flash_attention_bwd")
    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    ds = torch.empty(B * H, padded(Tq), padded(Tk), dtype=q.dtype, device=q.device)
    if q.dtype == torch.float32:
        p = torch.empty(B * H, padded(Tk), padded(Tq), device=q.device)
        ds_t = torch.empty_like(p)
    else:
        p, ds_t = torch.empty_like(ds), None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.kokoro_flash_attention_bwd_scores(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _ptr(q_seg), _ptr(kv_seg), p.data_ptr(), ds.data_ptr(), _ptr(ds_t), B, H, Tq, Tk,
            Dh,
            ctypes.c_float(float(scale)), int(causal), _code(q.dtype), stream)
    return err, dq, dk, dv
