"""Port's K4 past head dim 2048 (kokoro_tpu_torch/ops/flash_attention.py,
where the kernels keep the scores in device memory, csrc/attention_scores.cuh)
against the JAX package's ``_flash_attention`` on the CPU: the library Pallas
flash attention in the TPU interpreter (``pltpu.force_tpu_interpret_mode()``)
at Dh 2176, 2560 (the model of phase long's hidden 2560 at one head) and
4096, and at Dh 2112, which the library's kernel refuses (a head_dim above
128 must be a multiple of 128 there; the ragged 64-column last strip of the
port's products over keys and queries), the library's own plain reference,
``mha_reference_no_custom_vjp``.  B=1, H=1: one head of the widths a model at
hidden 2112-4096 and one head gives K4.

Tolerances (docs/attention_numerics_tpu.json ``tolerances``): forward f32
2e-5 / bf16 2e-2, gradients f32 1e-4 / bf16 3e-2, abs and rel.  A file of
its own, so that its cases take a worker of their own.
"""

import pytest

from kokoro_tpu_torch.ops import flash_attention as port
from tests.test_torch_flash import hold_plain_against_library

# (T, Dh, dtype, causal, masks): Dh 2176, 2560 and 4096 in both dtypes, Dh
# 2112 against the library's plain reference in both; each dtype, mask kind
# and causal flag at least once, T 1152 once
CASES = [
    (1024, 2176, "bfloat16", True, "none"),
    (1024, 2176, "float32", False, "suffix"),
    (1024, 2560, "float32", True, "interior"),
    (1024, 2560, "bfloat16", True, "suffix"),
    (1024, 4096, "bfloat16", False, "interior"),
    (1024, 4096, "float32", True, "none"),
    (1024, 2112, "float32", True, "suffix"),
    (1152, 2112, "bfloat16", True, "interior"),
]


@pytest.mark.parametrize("T,Dh,dname,causal,masks", CASES)
def test_plain_matches_library_past_head_dim_2048(T, Dh, dname, causal, masks):
    assert port.flash_supported(T, T, Dh)
    assert port.scores_path(Dh) and port.cluster_ctas(Dh) == 1
    hold_plain_against_library(T, Dh, dname, causal, masks, B=1, H=1)
