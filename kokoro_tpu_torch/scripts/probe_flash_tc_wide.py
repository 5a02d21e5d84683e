"""What sets the pace of K4's bf16 kernels at head dims 192 and 256.

Two readings behind PERF.md section 6 (K4's bf16 kernels at Dh 192/256):

* ``parts``: the bf16 K4 forward and backward at B=12, T=1408, causal, at
  (H, Dh) (2, 256) and (4, 192), device time by CUDA-graph replay, and the
  backward's split into its dQ and dK/dV kernels (``torch.profiler``), built
  as shipped and built with each probe switch of the bf16 kernels
  (``csrc/attention_tc.cuh``, ``csrc/attention_tc_wide.cuh``):
  ``-DKOKORO_TC_LOADS_OFF`` (a streamed tile is loaded only on the ring's
  first pass, so the consumers wait on no load after it) and
  ``-DKOKORO_TC_ELEMENTWISE_OFF`` (no softmax, weights or dS: the raw
  products stand in), and with both.  A switched build computes wrong
  results: it is timed only.  The difference to the shipped build is the
  part's share of the time.  SDPA is timed beside (its own choice of
  backend, named), as a yardstick.  With ``--trees DIR ...`` (checkouts of
  earlier trees, or copies of ``csrc/`` with a lever taken back) their
  kernels are built and timed too, in the order given, then the shipped
  build twice, the switches, then the trees in reverse order.
* ``schedule``: a host-side model of a design's schedule (``schedule``):
  per CTA, the products each warpgroup issues a streamed tile, the tiles the
  producer has in flight when a consumer starts a tile, each kernel's shared
  memory, and the (CTA, tile) and (warpgroup, tile) visits of a call, for
  two designs: ``templates`` (attention_tc.cuh's Dh 64/128 templates
  instantiated at these head dims) and ``wide`` (attention_tc_wide.cuh's
  kernels).

    python -m kokoro_tpu_torch.scripts.probe_flash_tc_wide [--out FILE] [--trees DIR ...]

Needs the card and ``nvcc``; each build runs in its own process.  Prints one
JSON object (and writes it to ``--out``).  Every kernel's outputs are
compared with an earlier checkout's, bit for bit, by
``python -m kokoro_tpu_torch.scripts.probe_flash_tf32_wide --digests --parent DIR``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from kokoro_tpu_torch.scripts import probe_flash_tf32_wide as f32probe

TIMED = ((2, 256), (4, 192))
SHAPE = {"B": 12, "T": 1408}
SWITCHES = {"loads_off": ("-DKOKORO_TC_LOADS_OFF",),
            "elementwise_off": ("-DKOKORO_TC_ELEMENTWISE_OFF",)}
VARIANTS = {"shipped": (), **SWITCHES,
            "all_off": tuple(flag for flags in SWITCHES.values() for flag in flags)}
SMEM_LIMIT = 232448  # a CTA's shared memory on the H100

# The designs' shared memory and schedules (attention_tc.cuh's constants and
# attention_tc_wide.cuh's): a TMA box is 64 rows of 64 bf16; a 64-row tile
# is Dh / 64 boxes.
BOX = 64 * 64 * 2
ALIGN = 1024  # the launches' slack for aligning the tiles to the 128-byte swizzle's period
PARENT_RING = 128 + 5 * 192 * 4  # attention_tc.cuh's kRingBytes
P_BUFFER = 64 * 64 * 4  # the dK/dV kernel's P^T hand-off, f32


def _tile(dh: int) -> int:
    return dh // 64 * BOX


def slots(design: str, kind: str, dh: int) -> dict:
    """Ring depths of a kernel: ``stages`` of K and V (or Q and dO) together
    (``templates``, and ``wide``'s dK/dV kernel), or ``k`` and ``v`` slots
    apart (``wide``'s forward and dQ kernels); ``p`` the dK/dV kernel's P^T
    buffers."""
    if design == "templates":
        return {"stages": 2 if dh == 256 else 3}
    if kind == "fwd":
        return {"k": 2 if dh == 256 else 3, "v": 3 if dh == 256 else 4}
    if kind == "dq":
        return {"k": 2 if dh == 256 else 3, "v": 1 if dh == 256 else 2}
    return {"stages": 2 if dh == 256 else 3, "p": 2 if dh == 256 else 1}


def smem_bytes(design: str, kind: str, dh: int) -> int:
    """A CTA's dynamic shared memory, as the launches ask for it."""
    t, s = _tile(dh), slots(design, kind, dh)
    if design == "templates":  # ring_smem_bytes: two own 64-row tiles (Q of two consumers, Q and dO,
        return ALIGN + (2 + 2 * s["stages"]) * t + PARENT_RING  # K and V), two tiles a stage
    if kind == "fwd":  # Q of two consumers; K and V slots; own, own_free, full/empty a slot; K's ids
        return (ALIGN + (2 + s["k"] + s["v"]) * t + 8 * (2 + 2 * s["k"] + 2 * s["v"])
                + 256 * s["k"])
    if kind == "dq":  # Q and dO of two consumers; K and V slots; own, full/empty; K's ids
        return (ALIGN + (4 + s["k"] + s["v"]) * t + 8 * (1 + 2 * s["k"] + 2 * s["v"])
                + 256 * s["k"])
    # K and V of the CTA's keys; Q and dO a stage; P^T buffers; own, full/empty;
    # the stage's query rows' lse, delta and segment ids
    return (ALIGN + (2 + 2 * s["stages"]) * t + s["p"] * P_BUFFER + 8 * (1 + 2 * s["stages"])
            + 768 * s["stages"])


def products_per_tile(design: str, kind: str) -> dict:
    """The products each consumer warpgroup of a CTA issues for a streamed
    tile it sees (64 x 64 x Dh each)."""
    if kind == "fwd":  # S = Q K^T, O += P V: two consumers of 64 query rows
        return {"consumer_0": 2, "consumer_1": 2}
    if kind == "dq":  # S, dPd, dQ += dS K
        return {"consumer": 3} if design == "templates" else {"consumer_0": 3, "consumer_1": 3}
    if design == "templates":  # S^T in both; dV; dP^T and dK
        return {"dv": 2, "dk": 3}
    return {"dv": 2, "dk": 2}  # S^T and dV; dP^T and dK (P^T handed over)


def in_flight(design: str, kind: str, dh: int) -> int:
    """Streamed tiles a producer has in flight when a consumer starts a tile,
    in steady state: the ring's slots less the ones the consumer holds (the
    tile it starts, and the one whose last product is still running)."""
    s = slots(design, kind, dh)
    if "stages" in s:
        return s["stages"] - 2
    if kind == "fwd":  # holds K(j) for S(j) and V(j-1) for P V(j-1)
        return min(s["k"] - 1, s["v"] - 1)
    return min(s["k"] - 2, s["v"] - 1)  # dQ: K(j - 1) under dQ(j - 1), K(j); V(j)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def schedule(design: str, kind: str, dh: int, B: int, H: int, T: int, causal: bool = True) -> dict:
    """One call of ``kind`` (``fwd``, ``dq`` or ``dkdv``) at (B, H, T, T,
    ``dh``) under ``design`` (``templates`` or ``wide``): ``ctas``;
    ``cta_tiles``, the (CTA, streamed tile) pairs a CTA loads;
    ``group_tiles``, the (64-row warpgroup, streamed tile) pairs a
    warpgroup computes (a dK/dV CTA's two warpgroups share its 64 keys, so
    there a CTA's); ``products``, the 64 x 64 x Dh products of the call;
    ``products_per_tile``, ``in_flight`` and ``smem_bytes``."""
    rows = 128 if kind == "fwd" or (kind == "dq" and design == "wide") else 64
    heads = B * H
    cta_tiles = group_tiles = 0
    for c0 in range(0, T, rows):
        if kind == "dkdv":  # a CTA owns 64 keys, streams the query tiles from its first key
            first = c0 if causal else 0
            cta_tiles += _ceil(T - first, 64)
        else:  # a CTA owns queries, streams the key tiles up to its last row
            cta_tiles += _ceil(min(T, c0 + rows) if causal else T, 64)
            for qw in range(c0, min(c0 + rows, T), 64):
                group_tiles += _ceil(min(T, qw + 64) if causal else T, 64)
    if kind == "dkdv":
        group_tiles = cta_tiles
    per_tile = products_per_tile(design, kind)
    per_group = sum(per_tile.values()) if kind == "dkdv" else next(iter(per_tile.values()))
    return {"ctas": _ceil(T, rows) * heads, "cta_tiles": cta_tiles * heads,
            "group_tiles": group_tiles * heads, "products": per_group * group_tiles * heads,
            "products_per_tile": per_tile, "in_flight": in_flight(design, kind, dh),
            "smem_bytes": smem_bytes(design, kind, dh)}


def schedules() -> dict:
    B, T = SHAPE["B"], SHAPE["T"]
    return {f"H={H}/Dh={Dh}/{design}": {kind: schedule(design, kind, Dh, B, H, T)
                                       for kind in ("fwd", "dq", "dkdv")}
            for H, Dh in TIMED for design in ("templates", "wide")}


def sdpa_default_backend(q, k, v, scale: float) -> str:
    """The backend SDPA picks, unpinned, for a causal call on ``q, k, v``
    (``torch._fused_sdp_choice``): what its timed calls run."""
    import torch
    from torch.nn.attention import SDPBackend

    choice = torch._fused_sdp_choice(q, k, v, None, 0.0, True, scale=scale)
    return next(name for name, member in SDPBackend.__members__.items()
                if int(member.value) == int(choice))


def time_variant(variant: str, parent: str | None = None, rounds: int = 1) -> dict:
    """The bf16 K4 times at ``TIMED`` with the variant's libraries loaded in
    place of the port's (``rounds`` readings each), the backward's split
    into its kernels, and (shipped) SDPA's times and backend."""
    import torch
    import torch.nn.functional as F

    from kokoro_tpu_torch.ops import flash_attention as fl

    flags = () if parent else VARIANTS[variant]
    f32probe._load(f32probe.build(variant, parent, flags=flags, tag="tcprobe"))
    dev = torch.device("cuda")
    B, T = SHAPE["B"], SHAPE["T"]
    out = {}
    for H, Dh in TIMED:
        gen = torch.Generator().manual_seed(Dh)
        q, k, v, do = (torch.randn(B, H, T, Dh, generator=gen).to(dev, torch.bfloat16)
                       for _ in range(4))
        kw = dict(causal=True, scale=Dh ** -0.5)
        o, lse = fl.flash_attention_fwd(q, k, v, return_lse=True, **kw)

        def fwd():
            return fl.flash_attention_fwd(q, k, v, **kw)

        def bwd():
            return fl.flash_attention_bwd(q, k, v, o, do, lse, **kw)

        row = {"fwd_ms": [f32probe.graph_ms(fwd) for _ in range(rounds)],
               "bwd_ms": [f32probe.graph_ms(bwd) for _ in range(rounds)],
               "bwd_kernel_split_ms": f32probe.kernel_split_ms(bwd)}
        if variant == "shipped":
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]

            def sdpa():
                return F.scaled_dot_product_attention(*leaves, is_causal=True, scale=Dh ** -0.5)

            def sdpa_fwd_bwd():
                torch.autograd.grad(sdpa(), leaves, do)

            sdpa_fwd = f32probe.graph_ms(sdpa)
            row["sdpa_ms"] = {"fwd": sdpa_fwd, "bwd": f32probe.graph_ms(sdpa_fwd_bwd) - sdpa_fwd,
                              "backend": sdpa_default_backend(*leaves, Dh ** -0.5)}
        out[f"H={H}/Dh={Dh}"] = row
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return out


def _run(variant: str, tree: str | None, rounds: int = 1) -> dict:
    return f32probe.run_variant(__spec__.name, variant, tree, rounds)


def parts(trees=()) -> dict:
    """Each build's times (a process each), each switched part's share of the
    shipped time, and each of ``trees`` timed before and after them."""
    out = {}
    for i, tree in enumerate(trees):
        out[f"tree{i}_1"] = _run(f"tree{i}", tree)
    out["shipped"] = _run("shipped", None, rounds=2)
    for variant in (*SWITCHES, "all_off"):
        out[variant] = _run(variant, None)
    for i, tree in reversed(list(enumerate(trees))):
        out[f"tree{i}_2"] = _run(f"tree{i}", tree)
    share = {}
    for key, times in out["shipped"].items():
        share[key] = {}
        for kind in ("fwd", "bwd"):
            ms = min(times[f"{kind}_ms"])
            share[key][kind] = {v: 1.0 - min(out[v][key][f"{kind}_ms"]) / ms
                                for v in (*SWITCHES, "all_off")}
    return {"times_ms": out, "share_of_shipped": share, "trees": list(trees)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--trees", nargs="*", default=[],
                        help="checkouts (or copies of csrc/ in a checkout's layout) timed beside")
    parser.add_argument("--time-variant", help=argparse.SUPPRESS)
    parser.add_argument("--parent", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--rounds", type=int, default=1, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.time_variant:
        print(json.dumps(time_variant(args.time_variant, args.parent, args.rounds)))
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = {"device": smi, "shape": "B=12 T=1408 causal bf16", "schedule": schedules(),
              "parts": parts(args.trees)}
    text = json.dumps(result)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
