"""K4's scores path on wgmma (``csrc/attention_scores_tf32.cuh`` in f32,
``csrc/attention_scores_tc.cuh`` in bf16) against the kernels it replaces,
on one card: the readings behind PERF.md's entries on that path and
``ops/flash_attention.py``'s ``F32_SCORES_FROM`` and ``BF16_SCORES_FROM``.

* ``times``: at B=12, T=1408, H=1, causal, both dtypes, at ``HEAD_DIMS``:
  the wrappers' forward and backward (the route of the tree that runs it),
  the scores path called directly and, where the tree has them as a call of
  their own, the on-chip kernels called directly; each row's bound (the
  bytes each input read once and each output written once, or the visible
  pairs' operations at the dtype's peak) and, at ``SDPA_HEAD_DIMS``, SDPA
  with its memory-efficient backend pinned (a yardstick: the port never
  calls it).  Device ms by CUDA-graph replay (10 calls, the median of 5
  replays).
* ``crossover``: from ``times``, each dtype's forward and backward of the
  scores path against the on-chip kernels at each sampled head dim, and the
  smallest sampled head dim from which the scores path is faster (forward +
  backward) there and at every sampled head dim above it (the route's
  ``F32_SCORES_FROM`` / ``BF16_SCORES_FROM``).
* ``step``: the bf16 kernel-path training step of phase ``long`` (B=4,
  L=256, T=1408, every dropout 0, SpecAugment off) with one head at hidden
  512, 1536 and 2560: the median ms of 8 steps after 2 warm-up steps, K4's
  launches a step, all and on the scores path, and the attention kernels'
  device ms in a profiled step (``--steps-only``: the steps alone).

    python -m kokoro_tpu_torch.scripts.probe_flash_scores_tf32 [--out FILE]
    cd PARENT && PYTHONPATH=$PWD python /path/to/probe_flash_scores_tf32.py

Run from a checkout of an earlier tree (the second form), it measures that
tree's kernels with the same code, so that parent and change can be timed
in one call, in the order parent, change, change, parent.  Needs the card
and ``nvcc``.  Prints one JSON object (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

SHAPE = {"B": 12, "T": 1408, "H": 1}
SAMPLED = (192, 256, 320, 384, 512, 768, 1024, 1088, 1536, 2048)
HEAD_DIMS = (*SAMPLED[:8], 1152, *SAMPLED[8:], 2560, 4096)
SDPA_HEAD_DIMS = (192, 256, 384, 512, 1024, 1152, 1536, 2048, 2560, 4096)
STEP_HIDDEN = (512, 1536, 2560)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12, "float32": 495e12 / 3}  # bf16; 3xTF32 work on TF32


def bound_ms(Dh: int, dname: str, backward: bool) -> dict:
    """The least time of K4 at ``SHAPE`` and ``Dh``, causal: q, k, v read and
    o written once (backward: q, k, v, o, dO and the f32 lse read, dq, dk,
    dv written), or 4 Dh (backward 10 Dh) operations a visible pair at the
    dtype's peak, whichever is larger."""
    B, T, H = SHAPE["B"], SHAPE["T"], SHAPE["H"]
    elem = 2 if dname == "bfloat16" else 4
    nbytes = (8 if backward else 4) * B * H * T * Dh * elem + (4 * B * H * T if backward else 0)
    ops = (10 if backward else 4) * Dh * B * H * T * (T + 1) // 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dname] * 1e3
    return {"ms": max(t_bytes, t_ops), "by": "bytes" if t_bytes >= t_ops else "operations"}


def graph_ms(fn, iters: int = 10) -> float:
    """Device ms of one call: ``iters`` calls in a CUDA graph, replayed
    between CUDA events, the median of 5 replays."""
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
    del graph
    return statistics.median(times)


def _pair(fwd, bwd, q, k, v, do, kw, iters: int) -> dict:
    """fwd and bwd ms of one kernel family (fwd(..., return_lse=True) gives
    the lse its bwd takes)."""
    o, lse = fwd(q, k, v, return_lse=True, **kw)
    return {"fwd": graph_ms(lambda: fwd(q, k, v, **kw), iters),
            "bwd": graph_ms(lambda: bwd(q, k, v, o, do, lse, **kw), iters)}


def times(head_dims=HEAD_DIMS, sdpa: bool = True, wrapper: bool = True, iters: int = 10) -> dict:
    """Each dtype's rows at ``head_dims`` (``wrapper`` false: the wrappers
    not timed apart from the family they route to)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from kokoro_tpu_torch.ops import flash_attention as fl

    B, T, H = SHAPE["B"], SHAPE["T"], SHAPE["H"]
    dev = torch.device("cuda")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for Dh in head_dims:
            g = torch.Generator().manual_seed(Dh)
            q, k, v, do = (torch.randn(B, H, T, Dh, generator=g).to(dev, dtype) for _ in range(4))
            kw = dict(causal=True, scale=Dh ** -0.5)
            row = {"scores": _pair(fl.flash_attention_fwd_scores, fl.flash_attention_bwd_scores,
                                   q, k, v, do, kw, iters),
                   "bound": {d: bound_ms(Dh, dname, d == "bwd") for d in ("fwd", "bwd")}}
            if wrapper:
                row["wrapper"] = _pair(fl.flash_attention_fwd, fl.flash_attention_bwd, q, k, v, do,
                                       kw, iters)
            if hasattr(fl, "flash_attention_fwd_onchip") and Dh <= fl.MAX_CLUSTER_HEAD_DIM:
                row["onchip"] = _pair(fl.flash_attention_fwd_onchip, fl.flash_attention_bwd_onchip,
                                      q, k, v, do, kw, iters)
            if sdpa and Dh in SDPA_HEAD_DIMS:
                leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]

                def sdpa():
                    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                        return F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                              scale=Dh ** -0.5)

                try:
                    fwd_ms = graph_ms(sdpa)
                    both = graph_ms(lambda: torch.autograd.grad(sdpa(), leaves, do))
                    row["sdpa_efficient"] = {"fwd": fwd_ms, "bwd": both - fwd_ms}
                except RuntimeError as exc:  # the backend refuses the shape: its words
                    torch.cuda.synchronize()
                    row["sdpa_efficient"] = {"refused": str(exc).splitlines()[0][:300]}
                del leaves
            out[f"{dname}/Dh={Dh}"] = row
            del q, k, v, do
            torch.cuda.empty_cache()
    return out


def crossover(t: dict) -> dict:
    """Each dtype's scores path against the on-chip kernels (forward,
    backward and their sum) at the sampled head dims, and the smallest
    sampled head dim from which the scores path wins there and at every one
    above."""
    out = {}
    for dname in ("float32", "bfloat16"):
        rows, wins = {}, []
        for Dh in SAMPLED:
            r = t.get(f"{dname}/Dh={Dh}", {})
            if "onchip" not in r:
                continue
            s, c = (r["scores"]["fwd"] + r["scores"]["bwd"], r["onchip"]["fwd"] + r["onchip"]["bwd"])
            rows[Dh] = {"scores_ms": s, "onchip_ms": c, "scores_faster": s < c,
                        "scores_fwd_bwd_ms": [r["scores"]["fwd"], r["scores"]["bwd"]],
                        "onchip_fwd_bwd_ms": [r["onchip"]["fwd"], r["onchip"]["bwd"]]}
            if "wrapper" in r:
                rows[Dh]["wrapper_ms"] = r["wrapper"]["fwd"] + r["wrapper"]["bwd"]
            wins.append((Dh, s < c))
        first = None
        for i, (Dh, _) in enumerate(wins):
            if all(w for _, w in wins[i:]):
                first = Dh
                break
        out[dname] = {"table": rows, "scores_from": first}
    return out


def step_ms(hidden: int, steps: int = 8) -> dict:
    """The bf16 kernel-path training step at ``hidden`` and one head: each
    step's ms on the host clock (synchronised) and their
    median, K4's launches a step (all, and those that took the scores
    path), and the device ms a step of the port's attention kernels
    (namespace ``kokoro_attn``: at one head K4 alone, the packed kernels
    taking Dh 64 and 128 only) from ``torch.profiler`` over one step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kokoro_tpu_torch.cli.profile_paths import training_batch
    from kokoro_tpu_torch.config import KokoroConfig, TrainingConfig
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.ops import flash_attention as fl
    from kokoro_tpu_torch.training.optimizer import build_preclip_norms
    from kokoro_tpu_torch.training.train_step import create_train_state, make_train_step

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    no_dropout = dict(encoder_dropout=0.0, decoder_dropout=0.0, decoder_input_dropout=0.0,
                      variance_dropout=0.0, use_stochastic_depth=False)
    model_cfg = KokoroConfig(**no_dropout, hidden_dim=hidden, n_heads=1, use_flash_attention=True)
    cfg = TrainingConfig(compute_dtype="bfloat16", gradient_checkpointing=False,
                         use_spec_augment=False, warmup_steps=2)
    model = KokoroModel(model_cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    state = create_train_state(model.to(dev), cfg, total_steps=20000)
    step = make_train_step(cfg, build_preclip_norms(state.names, cfg), spec_augment=False)
    batch = training_batch(KokoroConfig(), 4, 1408, 256, dev)
    for i in range(2):
        step(state, batch, torch.Generator().manual_seed(i))
    torch.cuda.synchronize()
    before = [(kern.launches, kern.scores_launches) for kern in fl.KERNELS]
    each = []
    for i in range(steps):
        t0 = time.perf_counter()
        step(state, batch, torch.Generator().manual_seed(2 + i))
        torch.cuda.synchronize()
        each.append((time.perf_counter() - t0) * 1e3)
    names = [kern.name for kern in fl.KERNELS]
    launches = [(kern.launches - b, kern.scores_launches - s)
                for kern, (b, s) in zip(fl.KERNELS, before)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batch, torch.Generator().manual_seed(2 + steps))
        torch.cuda.synchronize()
    attention = sum(ev.device_time_total for ev in prof.key_averages()
                    if ev.device_type.name == "CUDA" and "kokoro_attn" in ev.key) / 1e3
    del model, state, step, batch
    torch.cuda.empty_cache()
    return {"ms": statistics.median(each), "ms_each": each,
            "attention_device_ms_per_step": attention,
            "k4_launches_per_step": {n: a / steps for n, (a, _) in zip(names, launches)},
            "k4_scores_path_launches_per_step": {n: s / steps
                                                 for n, (_, s) in zip(names, launches)}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--no-step", action="store_true", help="skip the training steps")
    parser.add_argument("--steps-only", action="store_true", help="only the training steps")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from kokoro_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = {"device": smi, "shape": SHAPE}
    if not args.steps_only:
        t = times()
        result.update(build_and_times_s=time.perf_counter() - t0, times_ms=t,
                      crossover=crossover(t))
    if not args.no_step:
        result["bfloat16_step"] = {f"hidden={h}": step_ms(h) for h in STEP_HIDDEN}
    text = json.dumps(result)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
