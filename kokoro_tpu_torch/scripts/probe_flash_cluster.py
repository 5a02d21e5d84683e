"""What sets the pace of K4's cluster kernels (head dims 320-1024), and how
their numerics compare with the single-CTA kernels'.

Two readings behind PERF.md section 6 (K4 past head dim 256):

* ``exchange``: K4 forward and backward at B=12, T=1408, causal, at (H, Dh)
  (1, 512), (2, 384) and (1, 1024), bf16 and f32, device time by CUDA-graph
  replay, built as shipped and built with ``-DKOKORO_CLUSTER_SUM_OFF``, which
  compiles the cluster's exchange of the score partials out (each CTA then
  uses its own partial: wrong results, timing only).  The difference is the
  exchange's share of the time.
* ``numerics``: the long training step's model (hidden 512, 6+6 layers, ff
  1536, seeded init, every dropout 0; B=12, L=256, T=1408) at 1, 2 and 8
  heads (Dh 512, 256, 64).  The bf16 loss on the kernel path, on the plain
  path, and with K4's plain version in the kernel's place inside the model,
  against the f32 plain path's loss; and K4's output on the q, k, v of
  decoder layers 0 and 5 (captured on the kernel path), the kernel's and its
  plain version's, against float64: mean and max error, signed error sum,
  and the share of elements where the two differ.

    python -m kokoro_tpu_torch.scripts.probe_flash_cluster [--out FILE]

Needs the card and ``nvcc``; each build variant runs in its own process.
Prints one JSON object (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

TIMED = ((1, 512), (2, 384), (1, 1024))
VARIANTS = {"shipped": (), "no_cluster_sum": ("-DKOKORO_CLUSTER_SUM_OFF",)}
LIBRARIES = ("flash_attention", "flash_attention_bwd")


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


def build(variant: str) -> dict:
    """``{library: path}`` of the flash libraries built with the variant's
    flags beside the port's own builds."""
    from kokoro_tpu_torch.ops import kernels

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths, procs = {}, []
    for name in LIBRARIES:
        out = kernels.library_path(name).with_name(f"lib{name}-probe-{variant}.so")
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, *VARIANTS[variant], "-o", str(out),
               str(kernels.CSRC_DIR / kernels.SOURCES[name])]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
        paths[name] = out
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} ({variant}) did not build:\n{log}")
    return paths


def time_variant(variant: str) -> dict:
    """K4's times at ``TIMED`` with the variant's libraries loaded in place
    of the port's."""
    import torch

    from kokoro_tpu_torch.ops import flash_attention as fl
    from kokoro_tpu_torch.ops import kernels

    for name, path in build(variant).items():
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
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    return out


def exchange() -> dict:
    """Each variant's times, from a process of its own (two builds of one
    library do not share a process)."""
    out = {}
    for variant in VARIANTS:
        proc = subprocess.run([sys.executable, "-m", __spec__.name, "--time-variant", variant],
                              capture_output=True, text=True, check=True)
        out[variant] = json.loads(proc.stdout.strip().splitlines()[-1])
    share = {key: {kind: 1.0 - out["no_cluster_sum"][key][kind] / ms
                   for kind, ms in times.items()}
             for key, times in out["shipped"].items()}
    return {"times_ms": out, "exchange_share": share}


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
    parser.add_argument("--time-variant", choices=sorted(VARIANTS), help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.time_variant:
        print(json.dumps(time_variant(args.time_variant)))
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = {"device": smi, "exchange": exchange(), "numerics": numerics()}
    text = json.dumps(result)
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
