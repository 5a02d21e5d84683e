"""The port's vocoder training path (``kokoro_tpu_torch/scripts/train_hifigan.py``
and ``quantize_hifigan.py``) against the reference scripts of the same
names, loaded by path, and the JAX package, on the CPU at a small width.

* ``build_segment_bank`` on a 4-utterance quality-run corpus: the
  reference's bank size, its WAV crops bit for bit, its mels within 1e-4.
* ``multires_stft_l1`` on a corpus crop and a near-silent one (where the
  ``1e-7`` floor of the log dominates): value within 1e-5 relative, the
  gradient with respect to the prediction within 1e-4 (norm of the
  difference over the norm).
* The whole loss ``45 * mel_l1 + stft_l1`` of a HiFi-GAN V1 at
  ``upsample_initial_channel`` 32, f32, on one parameter set carried across
  by ``convert.hifigan_state_dict_from_flax``: the loss and both terms
  within 1e-5 relative, the gradient of every generator tensor within 1e-4
  (the repository's f32 gradient contract) of the JAX gradient evaluated
  in float64, the transposed convolutions' included.
* The learning rate at every step of a 150- and a 60-step run equals
  optax's ``warmup_cosine_decay_schedule`` within 1e-7 relative (0 at step
  0; a run of at most 100 steps never decays).
* Five optimizer steps on one index sequence against ``optax.adamw`` (b1
  0.8, b2 0.99, weight decay 1e-4): every tensor within 1e-5 relative, and
  what the steps moved it within 1e-2.
* ``train_hifigan.main`` with ``--device cpu --channels 16``: the ``.npz``
  loads in the JAX ``load_hifigan_npz`` to the same config, the JAX
  generator on it gives the port's audio within 1e-4, the metrics JSON has
  the reference's keys, the history rows fall every ``--scan-steps``.
* ``quantize_hifigan.main`` on that file: its int8 arrays and scales equal
  the JAX exporter's, and its payload equals the reference script's run on
  the same file and corpus (the same keys; ``max_rel_weight_err`` and
  ``segments`` equal, the mel L1s within their printed rounding).
* The committed H100 runs (``kokoro_tpu_torch/scripts/hifigan_train_h100.json``,
  ``hifigan_v1_int8_h100.json``): the 2000-step V1 at 13.93 M parameters,
  every logged loss finite, the round-trip mel L1 over 64 segments within
  15 % of the reference's recorded f32 value (``docs/hifigan_v1_int8.json``)
  and the int8 delta at most 0.005, each with the card's name.
"""

import ast
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from kokoro_tpu.inference.vocoder import export_hifigan_npz as ref_export
from kokoro_tpu.inference.vocoder import load_hifigan_npz as ref_load
from kokoro_tpu.models.hifigan import HiFiGANConfig as RefConfig
from kokoro_tpu.models.hifigan import HiFiGANGenerator as RefGenerator
from kokoro_tpu.ops.stft import log_mel_spectrogram as ref_log_mel
from kokoro_tpu_torch.convert import flax_params_from_module, hifigan_state_dict_from_flax
from kokoro_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from kokoro_tpu_torch.scripts import quality_run as port_qr
from kokoro_tpu_torch.scripts import quantize_hifigan as port_quant
from kokoro_tpu_torch.scripts import train_hifigan as port_train
from tests.torch_parity import n, t, variables_from_flat

ROOT = Path(__file__).resolve().parents[1]
CHANNELS = 32


def _reference(name):
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _payload_keys(name):
    """The keys of the ``payload`` dict the reference script's ``main``
    writes."""
    tree = ast.parse((ROOT / "scripts" / f"{name}.py").read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(tg, "id", None) == "payload" for tg in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no payload in scripts/{name}.py")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def ref_train():
    return _reference("train_hifigan")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("hifigan_corpus")
    port_qr.build_corpus(root, 4)
    return root


@pytest.fixture(scope="module")
def bank(corpus):
    return port_train.build_segment_bank(corpus)


@pytest.fixture(scope="module")
def pair():
    """(flax variables, flat params, port generator) of one V1 at
    ``CHANNELS``: the port's seeded init in flax layout, every leaf moved by
    numpy-seeded noise."""
    gen, _ = port_train.init_generator(CHANNELS)
    rng = np.random.default_rng(3)
    flat = {k: (v + 0.02 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in sorted(flax_params_from_module(gen).items())}
    gen.load_state_dict(hifigan_state_dict_from_flax(flat), strict=True)
    return variables_from_flat(flat), flat, gen


def _ref_loss(ref_train, gen_j):
    """The reference's ``loss_fn`` (a closure of its ``main``), on the JAX
    package's generator."""
    def loss_fn(p, mel, wav):
        pred = gen_j.apply(p, mel)
        args = (22050, 1024, 256, 1024, 80, 0.0, 8000.0)
        mel_l1 = jnp.mean(jnp.abs(ref_log_mel(pred, *args) - ref_log_mel(wav, *args)))
        stft_l1 = ref_train.multires_stft_l1(pred, wav)
        return 45.0 * mel_l1 + stft_l1, (mel_l1, stft_l1)

    return loss_fn


def test_segment_bank_matches_the_reference(ref_train, corpus, bank):
    ref_mels, ref_wavs = ref_train.build_segment_bank(corpus)
    mels, wavs = bank
    # 4.4 s utterances: (97020 - 16384) // 16384 = 4 segments each
    assert mels.shape == ref_mels.shape == (16, 64, 80)
    assert wavs.shape == ref_wavs.shape == (16, port_train.SEGMENT_SAMPLES)
    assert wavs.dtype == ref_wavs.dtype and np.array_equal(wavs, ref_wavs)
    np.testing.assert_allclose(mels, ref_mels, rtol=0, atol=1e-4)
    capped, _ = port_train.build_segment_bank(corpus, max_segments=6)
    assert capped.shape[0] == 6 and np.array_equal(capped, mels[:6])


def test_multires_stft_l1_value_and_gradient(ref_train, bank):
    _, wavs = bank
    rng = np.random.default_rng(0)
    target = np.stack([wavs[1], 1e-4 * rng.standard_normal(wavs.shape[1])]).astype(np.float32)
    pred = (0.3 * rng.standard_normal(target.shape)).astype(np.float32)
    pred[1] *= 1e-3  # a near-silent prediction for the near-silent crop
    value, grad = jax.jit(jax.value_and_grad(ref_train.multires_stft_l1))(
        jnp.asarray(pred), jnp.asarray(target))
    p = t(pred).requires_grad_(True)
    ours = port_train.multires_stft_l1(p, t(target))
    ours.backward()
    assert abs(ours.item() - float(value)) <= 1e-5 * abs(float(value))
    assert _rel(n(p.grad), grad) <= 1e-4
    for row in range(2):
        assert _rel(n(p.grad)[row], np.asarray(grad)[row]) <= 1e-4, row


def test_loss_and_every_gradient_match_jax(ref_train, bank, pair):
    """The JAX side runs in float64 (``jax.enable_x64``, the generator's
    ``dtype``) on the same f32 parameters and inputs: its own f32 gradient
    misses its float64 one by up to 3e-4 on the resblocks' biases (sums of
    2 x 16384 terms that nearly cancel), where the port's f32 gradient stays
    within 3e-5 of it."""
    variables, flat, gen = pair
    mels, wavs = bank
    idx = [0, 5]
    cfg_j = RefConfig(upsample_initial_channel=CHANNELS)
    with jax.enable_x64(True):
        (loss_j, (mel_j, stft_j)), grads_j = jax.jit(jax.value_and_grad(
            _ref_loss(ref_train, RefGenerator(cfg_j, dtype=jnp.float64)), has_aux=True))(
            variables, mels[idx].astype(np.float64), wavs[idx].astype(np.float64))
        ref_grads = hifigan_state_dict_from_flax(
            {k: np.asarray(v, np.float64)
             for k, v in flatten_dict(grads_j["params"], sep="/").items()})
    assert np.asarray(loss_j).dtype == np.float64
    gen.zero_grad()
    loss, mel_l1, stft_l1 = port_train.loss_fn(gen, t(mels[idx]), t(wavs[idx]))
    loss.backward()
    for ours, ref in ((loss, loss_j), (mel_l1, mel_j), (stft_l1, stft_j)):
        assert abs(ours.item() - float(ref)) <= 1e-5 * abs(float(ref))
    params = dict(gen.named_parameters())
    assert ref_grads.keys() == params.keys()
    worst = {name: _rel(n(params[name].grad), n(g)) for name, g in ref_grads.items()}
    assert max(worst.values()) <= 1e-4, sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    assert any(name.startswith("ups.") for name in worst)


@pytest.mark.parametrize("steps", [150, 60])
def test_lr_schedule_equals_optax(steps):
    lr = 2e-4
    ref = optax.warmup_cosine_decay_schedule(0.0, lr, 100, max(steps, 101), lr * 0.05)
    ours = port_train.lr_schedule(lr, steps)
    # optax's schedule evaluated op by op (under jit XLA rewrites the
    # warm-up's (0 - lr) * (1 - n / 100) + lr, whose f32 cancellation then
    # moves a value by up to 1.4e-6 of itself)
    counts = np.arange(steps + 3)
    want = np.array([float(ref(jnp.asarray(c, jnp.int32))) for c in counts])
    assert ours(0) == 0.0 == want[0]
    got = np.array([ours(int(c)) for c in counts])
    assert (np.abs(got - want) <= 1e-7 * np.abs(want)).all(), np.abs(got - want).max()
    if steps <= 100:  # never decays
        assert ours(steps - 1) < lr
    # the optimizer applies schedule(count) at the update's pre-increment count
    gen = torch.nn.Linear(2, 2)
    opt, sched = port_train.make_optimizer(gen, lr, steps)
    seen = []
    for _ in range(3):
        seen.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    assert seen == [ours(0), ours(1), ours(2)]


def test_five_adamw_steps_match_optax(ref_train, bank, pair):
    variables, flat, _ = pair
    mels, wavs = bank
    lr, steps, batch = 2e-4, 150, 2
    gen_j = RefGenerator(RefConfig(upsample_initial_channel=CHANNELS))
    opt_j = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, lr, 100, steps, lr * 0.05),
                        b1=0.8, b2=0.99, weight_decay=1e-4)
    loss_j = _ref_loss(ref_train, gen_j)

    @jax.jit
    def step_j(p, s, mel, wav):
        (loss, aux), grads = jax.value_and_grad(loss_j, has_aux=True)(p, mel, wav)
        updates, s = opt_j.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    gen = HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=CHANNELS))
    gen.load_state_dict(hifigan_state_dict_from_flax(flat), strict=True)
    opt, sched = port_train.make_optimizer(gen, lr, steps)
    p_j, s_j = variables, opt_j.init(variables)
    for step in range(5):
        idx = n(port_train.batch_indices(step, batch, mels.shape[0]))
        p_j, s_j, loss = step_j(p_j, s_j, mels[idx], wavs[idx])
        metrics = port_train.one_step(gen, opt, sched, t(mels[idx]), t(wavs[idx]))
        assert abs(metrics[0].item() - float(loss)) <= 1e-5 * abs(float(loss)), step
    ref = hifigan_state_dict_from_flax(
        {k: np.asarray(v) for k, v in flatten_dict(p_j["params"], sep="/").items()})
    init = hifigan_state_dict_from_flax(flat)
    for name, p in gen.named_parameters():
        assert _rel(n(p), n(ref[name])) <= 1e-5, name
        moved, moved_ref = n(p) - n(init[name]), n(ref[name]) - n(init[name])
        assert np.linalg.norm(moved_ref) > 0, name
        assert _rel(moved, moved_ref) <= 1e-2, name


def test_batch_indices_are_seeded_per_step():
    a = port_train.batch_indices(3, 8, 100)
    assert a.shape == (8,) and a.dtype == torch.int64 and int(a.min()) >= 0 and int(a.max()) < 100
    assert torch.equal(a, port_train.batch_indices(3, 8, 100))
    assert not torch.equal(a, port_train.batch_indices(4, 8, 100))


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("hifigan_run")
    args = ["--device", "cpu", "--channels", "16", "--steps", "3", "--scan-steps", "2",
            "--batch", "2", "--corpus", str(corpus), "--out", str(out / "v.npz"),
            "--metrics", str(out / "train.json")]
    assert port_train.main(args) == 0
    return out


def test_main_writes_weights_the_reference_loads(trained, bank):
    payload = json.loads((trained / "train.json").read_text())
    assert _payload_keys("train_hifigan") <= payload.keys()
    # 3 steps in intervals of 2 -> the reference's loop runs 4, rows at 2 and 4
    assert [row["step"] for row in payload["history"]] == [2, 4]
    assert payload["optimizer_steps"] == 4 and payload["final"] == payload["history"][-1]
    assert payload["segments"] == 16 and payload["weights"] == str(trained / "v.npz")
    assert payload["nonfinite_history_rows"] == 0 and np.isfinite(payload["roundtrip_mel_l1"])
    params_j, cfg_j = ref_load(trained / "v.npz")
    assert cfg_j == RefConfig(upsample_initial_channel=16)
    flat = {k: np.asarray(v) for k, v in flatten_dict(params_j["params"], sep="/").items()}
    gen = HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=16))
    gen.load_state_dict(hifigan_state_dict_from_flax(flat), strict=True)
    mels = bank[0][:2]
    ref = jax.jit(RefGenerator(cfg_j).apply)(params_j, mels)
    with torch.no_grad():
        ours = gen.eval()(t(mels))
    assert ours.shape == ref.shape == (2, port_train.SEGMENT_SAMPLES)
    np.testing.assert_allclose(n(ours), np.asarray(ref), rtol=1e-4, atol=1e-4)
    assert abs(port_train.roundtrip_mel_l1(gen, t(mels[:1])) - payload["roundtrip_mel_l1"]) < 1e-5


def test_quantize_matches_the_reference(trained, corpus, monkeypatch, capsys):
    src = trained / "v.npz"
    assert port_quant.main(["--device", "cpu", "--src", str(src), "--out",
                            str(trained / "ours.npz"), "--metrics", str(trained / "ours.json"),
                            "--corpus", str(corpus), "--segments", "4"]) == 0
    ref_quant = _reference("quantize_hifigan")
    monkeypatch.setattr("sys.argv", ["quantize_hifigan.py", "--src", str(src), "--out",
                                     str(trained / "theirs.npz"), "--metrics",
                                     str(trained / "theirs.json"), "--corpus", str(corpus),
                                     "--segments", "4"])
    assert ref_quant.main() == 0
    with np.load(trained / "ours.npz") as a, np.load(trained / "theirs.npz") as b:
        assert set(a.files) == set(b.files) and any(k.endswith("::scale") for k in a.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    params, _ = ref_load(src)
    ref_export(params, trained / "exported.npz", config=RefConfig(upsample_initial_channel=16),
               quantize="int8")
    with np.load(trained / "ours.npz") as a, np.load(trained / "exported.npz") as b:
        for k in b.files:
            assert np.array_equal(a[k], b[k]), k
    ours = json.loads((trained / "ours.json").read_text())
    theirs = json.loads((trained / "theirs.json").read_text())
    assert set(theirs) <= set(ours) and set(theirs) == _payload_keys("quantize_hifigan")
    for key in ("segments", "max_rel_weight_err", "src_mb", "out_mb"):
        assert ours[key] == theirs[key], key
    for key in ("mel_l1_f32", "mel_l1_int8"):
        assert abs(ours[key] - theirs[key]) <= 1.5e-4, key
    assert ours["device"] == "cpu" and ours["tf32"] is None


def test_committed_h100_runs_meet_the_reference():
    scripts = ROOT / "kokoro_tpu_torch" / "scripts"
    train = json.loads((scripts / "hifigan_train_h100.json").read_text())
    quant = json.loads((scripts / "hifigan_v1_int8_h100.json").read_text())
    ref = json.loads((ROOT / "docs" / "hifigan_v1_int8.json").read_text())
    assert _payload_keys("train_hifigan") <= train.keys()
    assert set(ref) <= quant.keys() == set(ref) | {"device", "tf32"}
    assert train["steps"] == 2000 and train["channels"] == 512 and train["params_m"] == 13.93
    assert train["nonfinite_history_rows"] == 0 and len(train["history"]) >= 40
    # the 48-utterance corpus's bank, and the step's time beside its bound
    assert train["segments"] == 192 and train["optimizer_steps"] == 2000
    assert 0 < train["tf32_bound_ms"] < train["steady_ms_per_step"] < train["ms_per_step"]
    assert all(np.isfinite([r["loss"], r["mel_l1"], r["stft_l1"]]).all()
               for r in train["history"])
    assert quant["segments"] == ref["segments"] == 64
    assert quant["mel_l1_f32"] <= 1.15 * ref["mel_l1_f32"]
    assert abs(quant["mel_l1_delta"]) <= 0.005
    assert quant["max_rel_weight_err"] <= 0.005
    for payload in (train, quant):
        assert "H100" in payload["device"] and payload["device"].endswith(" W")
        assert payload["tf32"] == {"cudnn": True, "cublas": False}
