"""Port's K4 past head dim 1024 (kokoro_tpu_torch/ops/flash_attention.py,
where the kernels split the head dim over a cluster of 9 to 16 CTAs) against
the JAX package's ``_flash_attention`` on the CPU: the library Pallas flash
attention in the TPU interpreter (``pltpu.force_tpu_interpret_mode()``) at
Dh 1152, 1536 and 2048, and at Dh 1088, which the library's kernel refuses
(a head_dim above 128 must be a multiple of 128 there; the ragged 64-column
last slice of the port's cluster), the library's own plain reference,
``mha_reference_no_custom_vjp``.  B=1, H=1, T=1024: one head of the widths
a model at hidden 1088-2048 and one head gives K4.

Tolerances (docs/attention_numerics_tpu.json ``tolerances``): forward f32
2e-5 / bf16 2e-2, gradients f32 1e-4 / bf16 3e-2, abs and rel.  A file of
its own, so that its cases take a worker of their own.
"""

import pytest

from kokoro_tpu_torch.ops import flash_attention as port
from tests.test_torch_flash import hold_plain_against_library

# (T, Dh, dtype, causal, masks): Dh 1152 (9 CTAs) and 1536 (12, the model of
# phase long's hidden 1536 at one head) in both dtypes, Dh 1088 (9, ragged)
# against the library's plain reference, Dh 2048 (16, the largest cluster)
# in both dtypes; Dh 1280, 1664 and 1920 (10, 13 and 15 CTAs); each dtype,
# mask kind and causal flag at least once, T 1152 once
CASES = [
    (1024, 1152, "bfloat16", True, "none"),
    (1024, 1152, "float32", True, "suffix"),
    (1024, 1536, "float32", True, "interior"),
    (1024, 1536, "bfloat16", True, "suffix"),
    (1024, 1088, "float32", True, "interior"),
    (1024, 1088, "bfloat16", False, "suffix"),
    (1024, 2048, "bfloat16", True, "none"),
    (1024, 2048, "float32", False, "interior"),
    (1024, 1280, "bfloat16", False, "none"),
    (1152, 1664, "float32", True, "none"),
    (1024, 1920, "float32", True, "suffix"),
]


@pytest.mark.parametrize("T,Dh,dname,causal,masks", CASES)
def test_plain_matches_library_past_head_dim_1024(T, Dh, dname, causal, masks):
    assert port.flash_supported(T, T, Dh)
    hold_plain_against_library(T, Dh, dname, causal, masks, B=1, H=1)
