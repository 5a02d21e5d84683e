"""packed_attn_roofline: the packed attention kernels' (K1, K2 and the
packed backward) share of their bound, in percent: the sum of the bounds of
the calls recorded at the entry ``ops/fused_attention.py::packed_attention``
in the profiled stretch (forward, and backward for each call under grad)
over the sum of the device time of the packed kernels there; layer:
attention kernels, packed."""

from benchmark.attention_share import share


def read(r):
    return share(r, "packed")
