"""What sets the pace of K4's cluster kernels (head dims 320-1024), and how
their numerics compare with the single-CTA kernels'.

Two readings behind PERF.md section 6 (K4 past head dim 256):

* ``exchange``: K4 forward and backward at B=12, T=1408, causal, at (H, Dh)
  (1, 512), (2, 384) and (1, 1024), bf16 and f32, device time by CUDA-graph
  replay, built as shipped and built with ``-DKOKORO_CLUSTER_SUM_OFF``, which
  compiles the cluster's exchange of the score partials out (each CTA then
  uses its own partial: wrong results, timing only).  The difference is the
  exchange's share of the time.  Beside it, the bytes that cross DSMEM in
  one call, counted from the shapes and the kernels' tiling (``dsmem_bytes``),
  and the rates they imply over the call and over the exchange's share.
  With ``--parent DIR`` (a checkout of an earlier tree) its kernels are built
  and timed too, and the bf16 outputs (O, lse, dQ, dK, dV) of both builds are
  compared bit for bit (by SHA-256 of their bytes).
* ``numerics``: the long training step's model (hidden 512, 6+6 layers, ff
  1536, seeded init, every dropout 0; B=12, L=256, T=1408) at 1, 2 and 8
  heads (Dh 512, 256, 64).  The bf16 loss on the kernel path, on the plain
  path, and with K4's plain version in the kernel's place inside the model,
  against the f32 plain path's loss; and K4's output on the q, k, v of
  decoder layers 0 and 5 (captured on the kernel path), the kernel's and its
  plain version's, against float64: mean and max error, signed error sum,
  and the share of elements where the two differ.

    python -m kokoro_tpu_torch.scripts.probe_flash_cluster [--out FILE] [--parent DIR]

Needs the card and ``nvcc``; each build variant runs in its own process.
Prints one JSON object (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

TIMED = ((1, 512), (2, 384), (1, 1024))
SHAPE = {"B": 12, "T": 1408}
VARIANTS = {"shipped": (), "no_cluster_sum": ("-DKOKORO_CLUSTER_SUM_OFF",), "parent": ()}
LIBRARIES = ("flash_attention", "flash_attention_bwd")


def _visits(rows: int, keys: int, T: int) -> int:
    """Causal (row tile, key tile) pairs of a head at length ``T`` where a
    tile of ``rows`` rows visits a tile of ``keys`` keys: the key tile's
    first key is at or before the row tile's last row."""
    return sum((min(r0 + rows, T) - 1) // keys + 1 for r0 in range(0, T, rows))


def _visits_t(keys: int, cta_keys: int, queries: int, T: int) -> int:
    """The same seen from the keys (the dK/dV kernels): a CTA of
    ``cta_keys`` keys streams query tiles of ``queries`` from its first key,
    and a group of ``keys`` keys skips a tile whose last query is before
    its first key."""
    n = 0
    for c0 in range(0, T, cta_keys):
        for kw in range(c0, min(c0 + cta_keys, T), keys):
            n += sum(1 for q0 in range(c0, T, queries) if q0 + queries - 1 >= kw)
    return n


def dsmem_bytes(kind: str, dtype: str, H: int, Dh: int, design: str = "push") -> dict:
    """Bytes that cross DSMEM in one causal call of K4's cluster kernels at
    ``SHAPE`` (B, T) and (H, Dh), from the kernels' tiling.

    ``push`` (shipped): a reduce-scatter and an all-gather of pushes, each
    exchanged tile moving 2 (c - 1) tiles across the cluster (each CTA sends
    and receives 2 (c - 1) / c of it); the f32 kernels exchange each 16 x 32
    score tile of a row group once (the pair of warps a half each).  ``pull``
    (the design before it): every CTA reads its c - 1 peers' whole tiles,
    c (c - 1) tiles; f32 16-row streamed tiles, each warp of a pair
    exchanging its own 16 x 16 tile.  The f32 delta rounds are the dQ kernel's two 16 x 16 products a
    row group; the bf16 dQ kernel's one exchange of 4 floats a lane a warp."""
    B, T = SHAPE["B"], SHAPE["T"]
    c = -(-Dh // 128)
    heads = B * H
    tiles = 0  # the bytes of every exchanged tile, each once
    if dtype == "bfloat16":
        tile = 4 * 16 * 64 * 4  # a warpgroup's 64 x 64 f32 score tile (four warps)
        if kind == "fwd":
            tiles = _visits(64, 64, T) * tile
        elif kind == "bwd":
            n_q = -(-T // 64)
            tiles = 2 * _visits(64, 64, T) * tile + n_q * 4 * 32 * 4 * 4  # dQ + delta
            tiles += 2 * _visits_t(64, 64, 64, T) * tile  # dK/dV: S^T, dPd^T
    else:
        if design == "push":
            tile, rows = 16 * 32 * 4, 32  # a row group's 16 x 32 tile, once
            delta = 2 * 16 * 16 * 4
        else:
            tile, rows = 2 * 16 * 16 * 4, 16  # each warp of the pair its 16 x 16 tile
            delta = 2 * 2 * 16 * 16 * 4
        n_groups = -(-T // 16)
        if kind == "fwd":
            tiles = _visits(16, rows, T) * tile
        elif kind == "bwd":
            tiles = 2 * _visits(16, rows, T) * tile + n_groups * delta
            tiles += 2 * _visits_t(16, 64, rows, T) * tile
    per_tile = 2 * (c - 1) if design == "push" else c * (c - 1)
    return {"cluster_ctas": c, "exchanged_bytes": heads * tiles,
            "dsmem_bytes": heads * tiles * per_tile}


def graph_ms(fn, iters: int = 10) -> float:
    """Device ms of one call: ``iters`` calls in a CUDA graph, replayed
    between CUDA events, the median of 5 replays."""
    import statistics

    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def build(variant: str, parent: str | None = None) -> dict:
    """``{library: path}`` of the flash libraries built with the variant's
    flags beside the port's own builds (``parent``: from that checkout's
    sources)."""
    from kokoro_tpu_torch.ops import kernels

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    csrc = Path(parent) / "kokoro_tpu_torch" / "csrc" if parent else kernels.CSRC_DIR
    paths, procs = {}, []
    for name in LIBRARIES:
        out = kernels.library_path(name).with_name(f"lib{name}-probe-{variant}.so")
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, *VARIANTS[variant], "-o", str(out),
               str(csrc / kernels.SOURCES[name])]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
        paths[name] = out
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} ({variant}) did not build:\n{log}")
    return paths


def digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def time_variant(variant: str, parent: str | None = None) -> dict:
    """K4's times at ``TIMED`` with the variant's libraries loaded in place
    of the port's, and the SHA-256 of each bf16 call's outputs."""
    import torch

    from kokoro_tpu_torch.ops import flash_attention as fl
    from kokoro_tpu_torch.ops import kernels

    for name, path in build(variant, parent).items():
        lib = ctypes.CDLL(str(path))
        kernels._declare(name, lib)
        kernels._loaded[name] = lib
    dev = torch.device("cuda")
    out = {}
    for H, Dh in TIMED:
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator().manual_seed(Dh)
            q, k, v, do = (torch.randn(12, H, 1408, Dh, generator=gen).to(dev, dtype)
                           for _ in range(4))
            kw = dict(causal=True, scale=Dh ** -0.5)
            o, lse = fl.flash_attention_fwd(q, k, v, return_lse=True, **kw)
            key = f"H={H}/Dh={Dh}/{str(dtype).split('.')[1]}"
            out[key] = {
                "fwd_ms": graph_ms(lambda: fl.flash_attention_fwd(q, k, v, **kw)),
                "bwd_ms": graph_ms(lambda: fl.flash_attention_bwd(q, k, v, o, do, lse, **kw))}
            if dtype == torch.bfloat16:
                out[key]["sha256_o_lse_dq_dk_dv"] = digest(
                    o, lse, *fl.flash_attention_bwd(q, k, v, o, do, lse, **kw))
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    return out


def exchange(parent: str | None = None) -> dict:
    """Each variant's times, from a process of its own (two builds of one
    library do not share a process); the exchange's share, its bytes and
    rates; with ``parent``, whether the bf16 outputs equal the parent's."""
    out = {}
    for variant in VARIANTS:
        if variant == "parent" and parent is None:
            continue
        cmd = [sys.executable, "-m", __spec__.name, "--time-variant", variant]
        if variant == "parent":
            cmd += ["--parent", parent]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
        out[variant] = json.loads(proc.stdout.strip().splitlines()[-1])
    share, rates = {}, {}
    for key, times in out["shipped"].items():
        H, Dh, dtype = (part.split("=")[-1] for part in key.split("/"))
        share[key], rates[key] = {}, {}
        for kind in ("fwd", "bwd"):
            ms, off = times[f"{kind}_ms"], out["no_cluster_sum"][key][f"{kind}_ms"]
            share[key][f"{kind}_ms"] = 1.0 - off / ms
            counted = dsmem_bytes(kind, dtype, int(H), int(Dh))
            rates[key][kind] = {
                **counted,
                "parent_design_dsmem_bytes": dsmem_bytes(kind, dtype, int(H), int(Dh),
                                                         "pull")["dsmem_bytes"],
                "gb_per_s_over_call": counted["dsmem_bytes"] / ms / 1e6,
                "gb_per_s_over_exchange": counted["dsmem_bytes"] / (ms - off) / 1e6
                if ms > off else None}
    result = {"times_ms": out, "exchange_share": share, "dsmem": rates}
    if "parent" in out:
        result["bf16_bitwise_equal_to_parent"] = {
            key: times["sha256_o_lse_dq_dk_dv"] == out["parent"][key]["sha256_o_lse_dq_dk_dv"]
            for key, times in out["shipped"].items() if "sha256_o_lse_dq_dk_dv" in times}
    return result


def numerics() -> dict:
    import torch

    from kokoro_tpu_torch.cli.profile_paths import LONG_REGIME, LONG_SHAPE, training_batch
    from kokoro_tpu_torch.config import get_default_config
    from kokoro_tpu_torch.models import blocks
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.models.rng import Rng
    from kokoro_tpu_torch.ops import flash_attention as fl
    from kokoro_tpu_torch.training.train_step import DTYPES, make_loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    B, L, T = LONG_SHAPE["B"], LONG_SHAPE["L"], LONG_SHAPE["T"]
    no_dropout = dict(encoder_dropout=0.0, decoder_dropout=0.0, decoder_input_dropout=0.0,
                      variance_dropout=0.0, use_stochastic_depth=False)

    def plain_fwd(q, k, v, *, causal, scale, q_seg=None, kv_seg=None, return_lse=False):
        o = fl.flash_attention_reference(q, k, v, causal=causal, scale=scale, q_seg=q_seg,
                                         kv_seg=kv_seg)
        return (o, None) if return_lse else o

    def loss(n_heads, flash, dtype, plain_k4=False, capture=None):
        model_cfg, train_cfg = get_default_config(**{
            **LONG_REGIME, **no_dropout, "n_heads": n_heads, "use_flash_attention": flash})
        model = KokoroModel(model_cfg)
        model.load_state_dict(model.init_weights(torch.Generator().manual_seed(0)).state_dict())
        model.to(dev, torch.float32).set_compute_dtype(DTYPES[dtype])
        batch = training_batch(model_cfg, B, T, L, dev)
        real_fwd, real_attn = fl.flash_attention_fwd, blocks.flash_attention

        def spy(q, k, v, **kw):
            capture.append((q.detach().contiguous(), k.detach().contiguous(),
                            v.detach().contiguous(), kw))
            return real_attn(q, k, v, **kw)

        if plain_k4:
            fl.flash_attention_fwd = plain_fwd
        if capture is not None:
            blocks.flash_attention = spy
        try:
            with torch.no_grad():
                total, _ = make_loss_fn(model, train_cfg, spec_augment=False)(
                    batch, Rng.from_generator(torch.Generator().manual_seed(0)))
            return total.item()
        finally:
            fl.flash_attention_fwd, blocks.flash_attention = real_fwd, real_attn

    out = {}
    for n_heads in (1, 2, 8):
        captured = []
        losses = {"f32_plain": loss(n_heads, False, "float32"),
                  "kernel": loss(n_heads, True, "bfloat16", capture=captured),
                  "plain": loss(n_heads, False, "bfloat16"),
                  "k4_plain_version": loss(n_heads, True, "bfloat16", plain_k4=True)}
        ref = losses["f32_plain"]
        row = {"head_dim": 512 // n_heads, "losses": losses,
               "to_f32_rel": {k: abs(v - ref) / abs(ref) for k, v in losses.items() if k != "f32_plain"},
               "kernel_to_plain_rel": abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"]),
               "kernel_to_k4_plain_version_rel": abs(losses["kernel"] - losses["k4_plain_version"])
               / abs(losses["k4_plain_version"])}
        for layer in (0, 5):
            q, k, v, kw = captured[layer]
            args = dict(causal=kw["causal"], scale=kw["scale"])
            o_kernel = fl.flash_attention_fwd(q, k, v, **args).double()
            o_plain = fl.flash_attention_reference(q, k, v, **args).double()
            s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * args["scale"]
            s = s + torch.full_like(s, -torch.inf).triu(1)
            exact = torch.matmul(torch.softmax(s, -1), v.double())
            e_k, e_p = o_kernel - exact, o_plain - exact
            row[f"layer{layer}"] = {
                "kernel_mean_abs_err": e_k.abs().mean().item(),
                "plain_mean_abs_err": e_p.abs().mean().item(),
                "kernel_max_abs_err": e_k.abs().max().item(),
                "plain_max_abs_err": e_p.abs().max().item(),
                "kernel_err_sum": e_k.sum().item(), "plain_err_sum": e_p.sum().item(),
                "share_kernel_ne_plain": (o_kernel != o_plain).double().mean().item()}
            del s, exact
        out[f"n_heads={n_heads}"] = row
        del captured
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--parent", default=None,
                        help="a checkout of an earlier tree: its kernels are timed beside, and "
                             "the bf16 outputs compared bit for bit")
    parser.add_argument("--skip-numerics", action="store_true",
                        help="the exchange reading only")
    parser.add_argument("--time-variant", choices=sorted(VARIANTS), help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.time_variant:
        print(json.dumps(time_variant(args.time_variant, args.parent)))
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = {"device": smi, "exchange": exchange(args.parent)}
    if not args.skip_numerics:
        result["numerics"] = numerics()
    text = json.dumps(result)
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
