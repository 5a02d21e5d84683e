"""What sets the pace of K4's f32 kernels at head dims 192 and 256.

Two readings behind PERF.md section 6 (K4's f32 kernels at Dh 192/256):

* ``parts``: the f32 K4 forward and backward at B=12, T=1408, causal, at
  (H, Dh) (2, 256) and (4, 192), device time by CUDA-graph replay, and the
  backward's split into its dQ and dK/dV kernels (``torch.profiler``), built
  as shipped and built with each probe switch of the f32 kernels
  (``csrc/attention_tf32.cuh``, ``csrc/attention_tf32_wide.cuh``):
  ``-DKOKORO_TF32_SPLIT_OFF`` (the split of the streamed tiles into TF32
  pairs), ``-DKOKORO_TF32_EXCHANGE_OFF`` (the exchange of the score
  partials between the warps that share a row group) and
  ``-DKOKORO_TF32_BARRIERS_OFF`` (the CTA-wide barriers of the streaming
  loops), and with all three.  A switched build computes wrong results: it
  is timed only.  The difference to the shipped build is the part's share of
  the time.  SDPA's memory-efficient backend is timed beside, as a yardstick.
  With ``--parent DIR`` (a checkout of an earlier tree) its kernels are
  built and timed too, in the order parent, shipped, shipped, parent.
* ``tiling``: what one causal call at that shape does beside its products,
  counted from the shapes and a design's tiling (``tiling``): CTAs, the
  (CTA, streamed tile) visits, the streamed tiles a whole CTA splits into
  pairs, the CTA-wide barriers of the loops, and the exchanges of score
  partials and their named barriers, for the parent's design (the
  shared f32 template's kernels at these head dims) and this one.
* ``--digests`` (with ``--parent DIR``): the SHA-256 of every kernel's
  outputs on fixed inputs (packed K1/K2 and their backward at rates 0 and
  0.1, folded K3, flash K4 at Dh 64-1024, bf16 and f32), built from this
  tree's sources and from DIR's, and which cases differ: what a change to
  some kernels leaves bit for bit as it was.

    python -m kokoro_tpu_torch.scripts.probe_flash_tf32_wide [--out FILE] [--parent DIR]
    python -m kokoro_tpu_torch.scripts.probe_flash_tf32_wide --digests --parent DIR

Needs the card and ``nvcc``; each build runs in its own process.  Prints one
JSON object (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

TIMED = ((2, 256), (4, 192))
SHAPE = {"B": 12, "T": 1408}
SWITCHES = {"split_off": ("-DKOKORO_TF32_SPLIT_OFF",),
            "exchange_off": ("-DKOKORO_TF32_EXCHANGE_OFF",),
            "barriers_off": ("-DKOKORO_TF32_BARRIERS_OFF",)}
VARIANTS = {"shipped": (), **SWITCHES,
            "all_off": tuple(flag for flags in SWITCHES.values() for flag in flags),
            "parent": ()}
LIBRARIES = ("flash_attention", "flash_attention_bwd")
ALL_LIBRARIES = ("packed_attention", "packed_attention_bwd", *LIBRARIES)
DIGEST_HEAD_DIMS = (64, 128, 192, 256, 320, 512, 1024)

# The tilings at Dh 192 and 256: rows a CTA owns (16 a row group of `split`
# warps, which split each score's contraction and exchange the partials),
# rows a streamed tile holds, the CTA-wide barriers a streamed tile takes in
# each kernel's loop, whether a whole CTA splits each streamed tile into
# pairs, the exchanges a row group makes for each tile it sees, those the dQ
# kernel makes once for its rows' deltas, and the named barriers of an
# exchange.
DESIGNS = {
    # the shared f32 template at these head dims: the split in place (dQ,
    # dK/dV: two barriers around it, one in it, one at the end of the tile;
    # the forward splits from its raw ring)
    "parent": {"rows": 32, "stream": 16, "split": 4, "cta_split": True,
               "barriers": {"fwd": 2, "dq": 4, "dkdv": 4},
               "exchanges": {"fwd": 1, "dq": 2, "dkdv": 2}, "delta_exchanges": 2,
               "exchange_barriers": {"fwd": 2, "dq": 2, "dkdv": 2}},
    # this design: raw f32 tiles in a cp.async ring, split by each warp as
    # it reads them; one barrier a tile; S and dPd exchanged together (the
    # two delta products too); the forward's exchange through two sets of
    # slots, one barrier
    "wide": {"rows": 32, "stream": 32, "split": 4, "cta_split": False,
             "barriers": {"fwd": 1, "dq": 1, "dkdv": 1},
             "exchanges": {"fwd": 1, "dq": 1, "dkdv": 1}, "delta_exchanges": 1,
             "exchange_barriers": {"fwd": 1, "dq": 2, "dkdv": 2}},
}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def tiling(kind: str, design: str, B: int, H: int, T: int, causal: bool = True) -> dict:
    """What one call of ``kind`` (``fwd``, ``dq`` or ``dkdv``) at (B, H, T,
    T) does beside its products under ``design`` (a key of ``DESIGNS``):
    ``ctas``; ``cta_tiles``, the (CTA, streamed tile) pairs a CTA loads;
    ``split_tiles``, the streamed tiles (two a visit: K and V, or Q and dO)
    a whole CTA splits into pairs; ``loop_barriers``, the CTA-wide barriers
    of the loops; ``group_tiles``, the (row group, streamed tile) pairs a
    row group computes; ``exchanges`` of score partials and the
    ``named_barriers`` of the groups' warps they take."""
    d = DESIGNS[design]
    R, S = d["rows"], d["stream"]
    heads = B * H
    cta_tiles = group_tiles = 0
    for c0 in range(0, T, R):
        if kind == "dkdv":  # a CTA owns keys, streams the queries from its first key
            first = c0 if causal else 0
            n = _ceil(T - first, S)
            cta_tiles += n
            for kw in range(c0, min(c0 + R, T), 16):
                group_tiles += sum(1 for i in range(n) if not causal or first + (i + 1) * S - 1 >= kw)
        else:  # a CTA owns queries, streams the keys up to its last row
            n = _ceil(min(T, c0 + R) if causal else T, S)
            cta_tiles += n
            for qw in range(c0, min(c0 + R, T), 16):
                group_tiles += sum(1 for j in range(n) if not causal or j * S <= qw + 15)
    ctas = _ceil(T, R) * heads
    cta_tiles *= heads
    group_tiles *= heads
    exchanges = group_tiles * d["exchanges"][kind]
    if kind == "dq":
        exchanges += d["delta_exchanges"] * _ceil(T, 16) * heads  # the rows' deltas
    return {"ctas": ctas, "cta_tiles": cta_tiles,
            "split_tiles": 2 * cta_tiles if d["cta_split"] else 0,
            "loop_barriers": d["barriers"][kind] * cta_tiles, "group_tiles": group_tiles,
            "exchanges": exchanges, "named_barriers": d["exchange_barriers"][kind] * exchanges}


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


def kernel_split_ms(fn, calls: int = 10) -> dict:
    """Device ms a launch of each CUDA kernel ``fn`` launches, from
    ``torch.profiler`` over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {ev.key.split("(")[0].replace("void ", ""): ev.device_time_total / ev.count / 1e3
            for ev in prof.key_averages() if ev.device_type.name == "CUDA"}


def build(variant: str, parent: str | None = None, libraries=LIBRARIES, flags=None,
          tag: str = "tf32probe") -> dict:
    """``{library: path}`` of ``libraries`` built with the variant's flags
    (``flags``, else ``VARIANTS[variant]``) beside the port's own builds,
    named after ``tag`` and the variant (``parent``: from that checkout's
    sources)."""
    from kokoro_tpu_torch.ops import kernels

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    csrc = Path(parent) / "kokoro_tpu_torch" / "csrc" if parent else kernels.CSRC_DIR
    flags = VARIANTS[variant] if flags is None else flags
    paths, procs = {}, []
    for name in libraries:
        out = kernels.library_path(name).with_name(f"lib{name}-{tag}-{variant}.so")
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, *flags, "-o", str(out),
               str(csrc / kernels.SOURCES[name])]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
        paths[name] = out
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} ({variant}) did not build:\n{log}")
    return paths


def _load(paths: dict) -> None:
    """Load the built libraries in place of the port's own."""
    from kokoro_tpu_torch.ops import kernels

    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        kernels._declare(name, lib)
        kernels._loaded[name] = lib


def digest_outputs(parent: str | None = None) -> dict:
    """``{case: SHA-256 of its outputs}`` with every library built from this
    tree's sources (or ``parent``'s): packed K1/K2 forward and backward
    (B=4, T=433, H=2, kv lengths [T, 1, 0, T - 37]) at rates 0 and 0.1, the
    folded K3 at both rates, flash K4 causal and not with segment ids (B=2,
    H=2, T=1100) at ``DIGEST_HEAD_DIMS``, each in bf16 and f32."""
    import hashlib

    import torch

    from kokoro_tpu_torch.ops import flash_attention as fl
    from kokoro_tpu_torch.ops import fused_attention as fa

    _load(build("parent" if parent else "shipped", parent, ALL_LIBRARIES))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def digest(*tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for Dh in (64, 128):
            B, T, H = 4, 433, 2
            g = torch.Generator().manual_seed(Dh)
            q, k, v, do = (torch.randn(B, T, H * Dh, generator=g).to(dev, dtype) for _ in range(4))
            lens = torch.tensor([T, 1, 0, T - 37], dtype=torch.int32, device=dev)
            for rate in (0.0, 0.1):
                for causal in (True, False):
                    kw = dict(num_heads=H, scale=Dh ** -0.5, kv_lengths=None if causal else lens,
                              dropout_rate=rate, seed=5 if rate else None)
                    fwd, bwd = ((fa.packed_attention_causal, fa.packed_attention_bwd_causal)
                                if causal else (fa.packed_attention_kvlen,
                                                fa.packed_attention_bwd_kvlen))
                    o, lse, res = fwd(q, k, v, for_backward=True, **kw)
                    out[f"packed/{dn}/Dh={Dh}/causal={causal}/rate={rate}"] = digest(
                        o, lse, *bwd(q, k, v, o, do, lse, res, **kw))

                def fold(x):
                    return x.view(B, T, H, Dh).transpose(1, 2).reshape(B * H, T, Dh).contiguous()

                kw = dict(num_heads=1, scale=Dh ** -0.5, dropout_rate=rate,
                          seed=6 if rate else None)
                o, lse, res = fa.folded_attention_fwd(fold(q), fold(k), fold(v), for_backward=True,
                                                      **kw)
                out[f"folded/{dn}/Dh={Dh}/rate={rate}"] = digest(o, lse, *fa.folded_attention_bwd(
                    fold(q), fold(k), fold(v), o, fold(do), lse, res, **kw))
        for Dh in DIGEST_HEAD_DIMS:
            B, H, T = 2, 2, 1100
            g = torch.Generator().manual_seed(Dh + 1)
            q, k, v, do = (torch.randn(B, H, T, Dh, generator=g).to(dev, dtype) for _ in range(4))
            seg = torch.ones(B, T, dtype=torch.int32, device=dev)
            seg[1, 700:] = 0
            for causal in (True, False):
                kw = dict(causal=causal, scale=Dh ** -0.5, q_seg=seg, kv_seg=seg.clone())
                o, lse = fl.flash_attention_fwd(q, k, v, return_lse=True, **kw)
                out[f"flash/{dn}/Dh={Dh}/causal={causal}"] = digest(
                    o, lse, *fl.flash_attention_bwd(q, k, v, o, do, lse, **kw))
    return out


def time_variant(variant: str, parent: str | None = None, rounds: int = 1) -> dict:
    """The f32 K4 times at ``TIMED`` with the variant's libraries loaded in
    place of the port's (``rounds`` readings each), the backward's split
    into its kernels, and (shipped) SDPA's memory-efficient times."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from kokoro_tpu_torch.ops import flash_attention as fl

    _load(build(variant, parent))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    B, T = SHAPE["B"], SHAPE["T"]
    out = {}
    for H, Dh in TIMED:
        gen = torch.Generator().manual_seed(Dh)
        q, k, v, do = (torch.randn(B, H, T, Dh, generator=gen).to(dev) for _ in range(4))
        kw = dict(causal=True, scale=Dh ** -0.5)
        o, lse = fl.flash_attention_fwd(q, k, v, return_lse=True, **kw)

        def fwd():
            return fl.flash_attention_fwd(q, k, v, **kw)

        def bwd():
            return fl.flash_attention_bwd(q, k, v, o, do, lse, **kw)

        row = {"fwd_ms": [graph_ms(fwd) for _ in range(rounds)],
               "bwd_ms": [graph_ms(bwd) for _ in range(rounds)],
               "bwd_kernel_split_ms": kernel_split_ms(bwd)}
        if variant == "shipped":
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]

            def sdpa():
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    return F.scaled_dot_product_attention(*leaves, is_causal=True, scale=Dh ** -0.5)

            def sdpa_fwd_bwd():
                torch.autograd.grad(sdpa(), leaves, do)

            sdpa_fwd = graph_ms(sdpa)
            row["sdpa_efficient_ms"] = {"fwd": sdpa_fwd, "bwd": graph_ms(sdpa_fwd_bwd) - sdpa_fwd}
        out[f"H={H}/Dh={Dh}"] = row
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return out


def run_variant(module: str, variant: str, parent: str | None, rounds: int = 1,
                digests: bool = False) -> dict:
    """``python -m module --time-variant variant ...`` in a process of its
    own (two builds of one library do not share a process): its last line,
    a JSON object."""
    cmd = [sys.executable, "-m", module, "--time-variant", variant, "--rounds", str(rounds)]
    if digests:
        cmd.append("--digests")
    if parent is not None:
        cmd += ["--parent", parent]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"variant {variant} failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _run_variant(variant: str, parent: str | None, rounds: int = 1, digests: bool = False) -> dict:
    return run_variant(__spec__.name, variant, parent, rounds, digests)


def parts(parent: str | None = None) -> dict:
    """Each build's times (a process each: two builds of one library do not
    share a process), each switched part's share of the shipped time, and
    with ``parent`` the parent's times in the order parent, shipped, shipped,
    parent."""
    out = {}
    if parent is not None:
        out["parent_1"] = _run_variant("parent", parent)
    out["shipped"] = _run_variant("shipped", None, rounds=2)
    for variant in (*SWITCHES, "all_off"):
        out[variant] = _run_variant(variant, None)
    if parent is not None:
        out["parent_2"] = _run_variant("parent", parent)
    share = {}
    for key, times in out["shipped"].items():
        share[key] = {}
        for kind in ("fwd", "bwd"):
            ms = min(times[f"{kind}_ms"])
            share[key][kind] = {v: 1.0 - min(out[v][key][f"{kind}_ms"]) / ms
                                for v in (*SWITCHES, "all_off")}
    return {"times_ms": out, "share_of_shipped": share}


def tilings() -> dict:
    B, T = SHAPE["B"], SHAPE["T"]
    return {f"H={H}/Dh={Dh}/{design}": {kind: tiling(kind, design, B, H, T)
                                       for kind in ("fwd", "dq", "dkdv")}
            for H, Dh in TIMED for design in DESIGNS}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--parent", default=None,
                        help="a checkout of an earlier tree: its kernels are timed beside")
    parser.add_argument("--digests", action="store_true",
                        help="compare every kernel's outputs with --parent's, bit for bit")
    parser.add_argument("--time-variant", choices=sorted(VARIANTS), help=argparse.SUPPRESS)
    parser.add_argument("--rounds", type=int, default=1, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.time_variant:
        if args.digests:
            print(json.dumps(digest_outputs(args.parent if args.time_variant == "parent" else None)))
        else:
            print(json.dumps(time_variant(args.time_variant, args.parent, args.rounds)))
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    if args.digests:
        if args.parent is None:
            raise SystemExit("--digests compares with --parent DIR")
        mine = _run_variant("shipped", None, digests=True)
        theirs = _run_variant("parent", args.parent, digests=True)
        result = {"device": smi, "cases": len(mine),
                  "equal": sorted(k for k in mine if mine[k] == theirs.get(k)),
                  "differ": sorted(k for k in mine if mine[k] != theirs.get(k))}
    else:
        result = {"device": smi, "shape": "B=12 T=1408 causal f32", "tiling": tilings(),
                  "parts": parts(args.parent)}
    text = json.dumps(result)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
