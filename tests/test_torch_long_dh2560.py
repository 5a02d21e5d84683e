"""The long-utterance regime at head_dim 2560 (hidden 2560 at one head, 1+1
layers, ff 256) against the JAX package on the same parameters, on the CPU:
K4 past Dh 2048, where the port's kernels keep the scores in device memory
(csrc/attention_scores.cuh; the CPU runs K4's plain version); the weights
reach the port through the converter as at the other widths.  The forward
takes K4 once per decoder layer and matches both the reference's einsum
path and its flash branch (the library Pallas kernel in the TPU interpreter);
one f32 train step matches with the adaptive stabilization live.

A file of its own, so that its cases take a worker of their own.
Tolerances: tests/test_torch_long.py's (forward 1e-4; metrics 2e-5 relative,
parameters and EMA 4e-6 absolute).
"""

import pytest

from tests.test_torch_long import (
    ARCH_DH256, _forward_takes_k4_and_matches_reference, long_batch,
)
from tests.test_torch_training import Pair, assert_metrics, assert_state

# head_dim 2560: hidden 2560 at one head
ARCH_DH2560 = {**ARCH_DH256, "hidden_dim": 2560, "n_heads": 1}


@pytest.fixture(scope="module")
def pair_dh2560():
    return Pair("float32", arch=ARCH_DH2560)


def test_long_forward_at_head_dim_2560_one_head_takes_k4_and_matches_reference(
        pair_dh2560, monkeypatch):
    assert pair_dh2560.arch["hidden_dim"] // pair_dh2560.arch["n_heads"] == 2560
    packed = _forward_takes_k4_and_matches_reference(pair_dh2560, long_batch(8), monkeypatch)
    assert packed == []  # the cross-attention at Dh 2560 stays on einsum too


def test_long_train_step_at_head_dim_2560_one_head_matches_reference(pair_dh2560):
    batch = long_batch(9)
    js, jm = pair_dh2560.run_jax(pair_dh2560.jax_state(), batch, 0)
    ps = pair_dh2560.port_state()
    pm = pair_dh2560.run_port(ps, batch, 0)
    assert pm["stepped"] == 1.0 and pm["loss_scale"] < 1.0
    assert_metrics(jm, pm)
    assert_state(js, ps)
