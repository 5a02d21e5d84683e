"""``benchmark/spans.py`` on a synthetic trace: two
steps of known spans on the main thread, the backward's launches on a
second thread, kernels tied to runtime calls or (one) to their operator
alone, a span mirrored on the device's timeline, and known idle gaps in
the collate and after the host read, with the device's timestamps offset
from the host's or not."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import spans

MAIN, AUTOGRAD = 1, 2


def _event(name, start, end, thread=MAIN, device=False, corr=0, linked=0, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           thread=thread, device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           id=corr, linked_correlation_id=linked, is_user_annotation=annotation)


def _step(t, corr, skew):
    """One step from host time ``t`` (us), the device's times ``skew`` us
    off the host's: collate [t, t+10000] while a kernel launched earlier
    runs 4000 us of it, the step's first kernel at t+11000; the step's
    spans; kernels of 10000 + 5000 (forward), 14000 + 6000 (backward,
    launched from the autograd thread), 3000 + 1000 + 4000 (optimizer:
    clip, the host read's copy, the update) and 1000 outside the phases;
    the host read's copy ends at t+77000 and the update's kernel starts at
    t+93000."""
    ev = []

    def kernel(name, launch, a, b, thread=MAIN, runtime="cudaLaunchKernel"):
        nonlocal corr
        corr += 1
        if runtime:
            ev.append(_event(runtime, t + launch, t + launch + 5, thread, corr=corr))
            ev.append(_event(name, t + a + skew, t + b + skew, device=True, corr=corr))
        else:  # tied to its operator alone
            ev.append(_event("aten::mul", t + launch, t + launch + 5, thread, corr=corr + 10 ** 6))
            ev.append(_event(name, t + a + skew, t + b + skew, device=True, corr=corr,
                             linked=corr + 10 ** 6))

    ev += [_event("kokoro.collate", t, t + 10000),
           _event("kokoro.train_step", t + 10000, t + 100000, corr=corr + 50000),
           _event("kokoro.forward", t + 12000, t + 40000),
           _event("kokoro.encoder", t + 12000, t + 18000),
           _event("kokoro.decoder", t + 19000, t + 39000),
           _event("kokoro.backward", t + 40000, t + 70000),
           _event("kokoro.optimizer", t + 70000, t + 100000),
           _event("kokoro.clip", t + 70000, t + 75000),
           _event("kokoro.host_read", t + 75000, t + 90000),
           _event("kokoro.update", t + 90000, t + 100000),
           # the profiler's mirror of a span on the device's timeline
           _event("kokoro.forward", t + 15000, t + 30000, device=True, annotation=True)]
    kernel("void at::native::vectorized_elementwise_kernel<4>", -1, 0, 4000)
    kernel("void at::native::reduce_kernel<128>", 11000, 11000, 12000)
    kernel("ampere_bf16_gemm", 13000, 15000, 25000)
    kernel("void at::native::elementwise_kernel<128, 2>", 20000, 25000, 30000, runtime=None)
    kernel("void kokoro_attn::tc::bwd_kernel<64, false>", 45000, 46000, 60000, AUTOGRAD)
    kernel("void at::native::reduce_kernel<512>", 50000, 60000, 66000, AUTOGRAD)
    kernel("void at::native::reduce_kernel<128>", 71000, 71000, 74000)
    kernel("Memcpy DtoH (Device -> Pageable)", 76000, 76000, 77000, runtime="cudaMemcpyAsync")
    kernel("void at::native::multi_tensor_apply_kernel", 92000, 93000, 97000)
    return ev, corr


def _trace(skew=0.0):
    first, corr = _step(0, 0, skew)
    second, _ = _step(200000, corr, skew)
    return SimpleNamespace(events=lambda: first + second)


@pytest.mark.parametrize("skew", [0.0, -1050.0, 300.0])
def test_numbers_of_a_synthetic_stretch(skew):
    got = spans.read(spans.events_of(_trace(skew)))
    assert got["fwd_ms"] == pytest.approx(15.0)
    assert got["bwd_ms"] == pytest.approx(20.0)
    assert got["optimizer_ms"] == pytest.approx(8.0)
    # from the copy's end to the update's start: [77000, 93000]
    assert got["host_read_idle_ms"] == pytest.approx(16.0)
    # from the earlier kernel's end to the step's first: [4000, 11000]
    assert got["data_wait_ms"] == pytest.approx(7.0)
    b = got["breakdown"]
    assert b["steps"] == 2 and b["unattributed_ms"] == 0
    assert b["phase_share_of_step"] == pytest.approx(43.0 / 44.0)
    assert b["by_span"]["kokoro.encoder"] == {"launches": 1.0, "ms": pytest.approx(10.0)}
    assert b["by_span"]["kokoro.decoder"] == {"launches": 1.0, "ms": pytest.approx(5.0)}
    assert b["by_span"]["kokoro.backward"] == {"launches": 2.0, "ms": pytest.approx(20.0)}
    assert b["by_span"]["kokoro.host_read"] == {"launches": 0.0, "ms": pytest.approx(1.0)}
    assert b["by_span"]["kokoro.train_step"]["ms"] == pytest.approx(1.0)
    assert b["by_span"]["(no span)"]["ms"] == pytest.approx(4.0)
    assert b["kinds"]["bwd_ms"] == {"attention": pytest.approx(0.7),
                                    "reduction": pytest.approx(0.3)}
    assert b["kinds"]["optimizer_ms"] == {"elementwise": pytest.approx(0.5),
                                          "reduction": pytest.approx(3 / 8),
                                          "copy": pytest.approx(1 / 8)}
    assert spans.describe(got)[0].startswith("spans: 2 steps")


def test_no_collate_no_data_wait_and_no_step_no_numbers():
    events = [e for e in _trace().events() if e.name != "kokoro.collate"]
    got = spans.read(spans.events_of(SimpleNamespace(events=lambda: events)))
    assert "data_wait_ms" not in got and got["fwd_ms"] == pytest.approx(15.0)
    events = [e for e in events if e.name != "kokoro.train_step"]
    assert spans.read(spans.events_of(SimpleNamespace(events=lambda: events))) == {}


def test_tally_of_the_port_counters():
    snapshot = {"batches": 3, "frames_true": 900, "frames_padded": 1200,
                "attention": {("packed", 8, 512, 8, 64, "bfloat16", True, True): 24,
                              ("flash", 48, 1408, 8, 64, "bfloat16", True, True): 6}}
    got = spans.tally(snapshot, steps=3)
    assert got == {"padding_eff": 75.0, "batches": 3, "attention_calls": {
        "flash B=48 T=1408 H=8 Dh=64 bfloat16 causal=True grad=True": 2.0,
        "packed B=8 T=512 H=8 Dh=64 bfloat16 causal=True grad=True": 8.0}}
    assert spans.tally(dict(snapshot, frames_padded=0), 3)["padding_eff"] is None
    lines = spans.describe({"breakdown": spans.read(spans.events_of(_trace()))["breakdown"],
                            "counts": got})
    assert "counts: padding_eff 75.0 % over 3 batches" in lines
    assert "attention flash B=48 T=1408 H=8 Dh=64 bfloat16 causal=True grad=True: " \
           "2.00 calls a step" in lines


def test_device_reading_counts_no_span():
    """The harness's device-only stretch (its CPU stand-in here) reads the
    device's activities through ``benchmark/trace.py::_device``: the port's
    spans are recorded, and none of them is among what it counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import traffic
    from benchmark.program import Program, configs
    from benchmark.tests.small import small_cell
    from benchmark.trace import _device

    seed, cpu = 2 ** 33 + 7, torch.device("cpu")
    c = small_cell("hp-ladder", "float32")
    model_cfg, train_cfg = configs(c["config"], c["traffic"].get("training", {}))
    program = Program(c["config"], c["traffic"].get("training", {}),
                      traffic.derive(seed, "weights"), cpu)
    batch = next(traffic.iterate(traffic.make_feed(c["traffic"], seed, model_cfg, train_cfg,
                                                   cpu)))[0]
    gen = torch.Generator().manual_seed(traffic.derive(seed, "steps"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        program.step(program.state, batch, gen)
    events = prof.events()
    assert {"kokoro.train_step", "kokoro.forward", "kokoro.backward",
            "kokoro.optimizer"} <= {e.name for e in events}
    assert not [n for *_, n in _device(events) if n.startswith(spans.PREFIX)]
