"""flash_attn_roofline: K4's forward and backward kernels' share of their
bound, in percent, as ``packed_attn_roofline`` reads it, from the calls of
``ops/flash_attention.py::flash_attention``; layer: attention kernels,
flash."""

from benchmark.attention_share import share


def read(r):
    return share(r, "flash")
