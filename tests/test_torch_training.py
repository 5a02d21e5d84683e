"""The port's training slice (kokoro_tpu_torch/training/, the training
branches of the model) against the JAX package's, on the CPU.

Small model: hidden 128, 2 heads (head_dim 64, so both packages take their
packed attention route), 2+2 layers, ff 256, B=2, T=128.  The reference's
train step runs with ``blocks.FUSED_ON_CPU_FOR_TESTS``, so its decoder
attention goes through the Pallas packed forward AND backward in interpret
mode (asserted by ``FUSED_TRACE_COUNT``); the port takes its autograd
Function, which on CPU tensors runs the plain forward and backward.  Every
dropout rate is 0 and SpecAugment off where the two are compared (the two
packages draw different random numbers).

Tolerances, each from the readings on these inputs with headroom:
* losses and eval metrics: 1e-5 relative (f32 elementwise work);
* f32 train steps: per-step losses and grad norms 2e-5 relative (read: at
  most 2.6e-6, the energy loss); params and EMA after three steps 4e-6
  absolute (read: 4.3e-7; Adam moves a weight by about lr = 1e-3 per step);
* one bf16 step from a state past warmup: losses and grad norm 2e-2 relative
  (read: at most 3.3e-3 and 4.2e-3; bf16 rounds at different places in the
  two frameworks).  Params and EMA are held by what the step moved them:
  ``|d_port - d_ref| / |d_ref|`` with ``d`` = after - before, at most 0.75
  per tensor (read: 0.50, norm scales whose gradients sit at bf16 rounding,
  so Adam's sign-like step flips) and 0.45 over all tensors together (read:
  0.29).  A tensor the update missed reads 1, a wrong-signed update 2.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import kokoro_tpu.models.blocks as ref_blocks
from kokoro_tpu.config import TrainingConfig as RefConfig
from kokoro_tpu.models.kokoro import KokoroModel as RefModel
from kokoro_tpu.training import losses as ref_losses
from kokoro_tpu.training import optimizer as ref_opt
from kokoro_tpu.training.train_step import create_train_state as ref_create_state
from kokoro_tpu.training.train_step import make_eval_step as ref_make_eval_step
from kokoro_tpu.training.train_step import make_train_step as ref_make_step
from kokoro_tpu_torch.config import KokoroConfig, TrainingConfig
from kokoro_tpu_torch.convert import _torch_name, kokoro_state_dict_from_flax, train_state_from_flax
from kokoro_tpu_torch.models.kokoro import KokoroModel
from kokoro_tpu_torch.models.rng import Rng
from kokoro_tpu_torch.training import losses, optimizer
from kokoro_tpu_torch.training.train_step import (
    create_train_state, make_eval_step, make_loss_fn, make_train_step,
)
from tests.torch_parity import init_flax, n, perturbed_params, t

ARCH = dict(vocab_size=59, n_mels=80, hidden_dim=128, n_encoder_layers=2, n_decoder_layers=2,
            n_heads=2, encoder_ff_dim=256, decoder_ff_dim=256, variance_filter_size=64)
NO_DROPOUT = dict(encoder_dropout=0.0, decoder_dropout=0.0, decoder_input_dropout=0.0,
                  variance_dropout=0.0, use_stochastic_depth=False)
# warmup over 2 steps, so the LR moves; explosion floors low enough that a
# state with a live detector (>= 100 observed norms) fires on this model
TRAIN = dict(learning_rate=1e-3, warmup_steps=2, grad_explosion_warmup_floor=0.5,
             grad_explosion_final_floor=0.5, gradient_checkpointing=False,
             use_spec_augment=False)
TOTAL_STEPS = 1000
EMA_DECAY = 0.9
METRIC_KEYS = ("total", "mel", "duration", "stop", "pitch", "energy", "grad_norm",
               "grad_norm_clipped", "clip_norm", "exploded", "stepped")
STEP_RTOL = 2e-5
PARAM_ATOL = 4e-6


def make_batch(seed, B=2, T=128, L=24, accum=None):
    rng = np.random.default_rng(seed)
    lead = (accum,) if accum else ()
    mel_len = np.broadcast_to(np.asarray([T, T - 19], np.int32), lead + (B,)).copy()
    phon_len = np.broadcast_to(np.asarray([L, L - 5], np.int32), lead + (B,)).copy()
    stop = np.asarray(ref_losses.build_stop_token_targets(T, jnp.asarray(mel_len.reshape(-1))))
    return {
        "phoneme_indices": rng.integers(1, 59, size=lead + (B, L)).astype(np.int32),
        "stress_indices": rng.integers(0, 3, size=lead + (B, L)).astype(np.int32),
        "phoneme_durations": rng.integers(1, 2 * T // L, size=lead + (B, L)).astype(np.int32),
        "mel_specs": rng.normal(-5.0, 2.0, size=lead + (B, T, 80)).astype(np.float32),
        "pitch_targets": rng.uniform(size=lead + (B, T)).astype(np.float32),
        "energy_targets": rng.uniform(size=lead + (B, T)).astype(np.float32),
        "stop_token_targets": stop.reshape(lead + (B, T)).astype(np.float32),
        "mel_lengths": mel_len,
        "phoneme_lengths": phon_len,
    }


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: t(v) for k, v in batch.items()}


def flat_np(tree):
    return {k: np.array(v, np.float32) for k, v in flatten_dict(tree["params"], sep="/").items()}


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-8)


class Pair:
    """A reference model + jitted train step, and the port's counterpart,
    from one perturbed parameter set (``base``'s, when given: the parameter
    tree does not depend on the compute dtype)."""

    def __init__(self, compute_dtype, base=None, arch=ARCH):
        batch = make_batch(0)
        dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[compute_dtype]
        self.arch = arch
        self.jm = RefModel(**arch, **NO_DROPOUT, gradient_checkpointing=False,
                           use_flash_attention=True, use_spec_augment=False, dtype=dtype)
        if base is None:
            init_batch = {k: jnp.asarray(batch[k]) for k in (
                "phoneme_indices", "mel_specs", "phoneme_durations", "stress_indices",
                "pitch_targets", "energy_targets")}
            self.variables, self.flat = perturbed_params(init_flax(self.jm, **init_batch), 0)
        else:
            self.variables, self.flat = base.variables, base.flat
        self.jcfg = RefConfig(**TRAIN, compute_dtype=compute_dtype)
        self.jopt = ref_opt.build_optimizer(self.jcfg, self.variables, TOTAL_STEPS)
        preclips = ref_opt.build_preclip_tree(self.variables, self.jcfg)
        self.jstep = jax.jit(ref_make_step(self.jm, self.jcfg, self.jopt, preclips,
                                           ema_decay=EMA_DECAY, spec_augment=False))
        # JAX states are immutable: every test may start from this one
        self.jax_state0 = ref_create_state(self.jm, self.jcfg, self.jopt, jax.random.PRNGKey(0),
                                           jax_batch(batch), params=self.variables)
        self.cfg = TrainingConfig(**TRAIN, compute_dtype=compute_dtype)
        self.step = make_train_step(
            self.cfg, optimizer.build_preclip_norms(self.port_state().names, self.cfg),
            ema_decay=EMA_DECAY, spec_augment=False)

    def jax_state(self):
        return self.jax_state0

    def port_model(self):
        model = KokoroModel(KokoroConfig(**self.arch, **NO_DROPOUT, use_flash_attention=True))
        model.load_state_dict(kokoro_state_dict_from_flax(self.flat), strict=True)
        return model

    def port_state(self):
        return create_train_state(self.port_model(), self.cfg, TOTAL_STEPS)

    def run_jax(self, state, batch, i):
        old, count0 = ref_blocks.FUSED_ON_CPU_FOR_TESTS, ref_blocks.FUSED_TRACE_COUNT
        ref_blocks.FUSED_ON_CPU_FOR_TESTS = True
        try:
            state, metrics = self.jstep(state, jax_batch(batch), jax.random.PRNGKey(i))
        finally:
            ref_blocks.FUSED_ON_CPU_FOR_TESTS = old
        self.traced_fused = ref_blocks.FUSED_TRACE_COUNT - count0
        return state, {k: float(v) for k, v in metrics.items()}

    def run_port(self, state, batch, i):
        return self.step(state, torch_batch(batch), torch.Generator().manual_seed(i))


@pytest.fixture(scope="module")
def f32():
    return Pair("float32")


@pytest.fixture(scope="module")
def three_steps(f32):
    """Three steps of both packages from one state, on three batches."""
    js, ps = f32.jax_state(), f32.port_state()
    traced, out = [], []
    for i in range(3):
        js, jm = f32.run_jax(js, make_batch(10 + i), i)
        traced.append(f32.traced_fused)
        out.append((jm, f32.run_port(ps, make_batch(10 + i), i)))
    return js, ps, out, traced


def assert_metrics(jm, pm, rtol=STEP_RTOL, keys=METRIC_KEYS):
    for key in keys:
        assert rel(pm[key], jm[key]) <= rtol, (key, pm[key], jm[key])


def assert_state(js, ps, atol=PARAM_ATOL, rtol=STEP_RTOL):
    params = kokoro_state_dict_from_flax(flat_np(js.params))
    ema = kokoro_state_dict_from_flax(flat_np(js.ema_params))
    port_params = dict(ps.model.named_parameters())
    assert set(params) == set(port_params)
    for name, value in params.items():
        torch.testing.assert_close(port_params[name].detach(), value, rtol=0, atol=atol,
                                   msg=name)
        torch.testing.assert_close(ps.ema[name], ema[name], rtol=0, atol=atol, msg=name)
    assert_counters(js, ps, rtol)


def assert_moved_alike(start, js, ps, leaf_limit, tree_limit):
    """Params and EMA moved alike from ``start`` (flat flax params): per
    tensor and over all tensors, ``|d_port - d_ref| / |d_ref|``."""
    start = kokoro_state_dict_from_flax(start)
    port_params = {name: p.detach() for name, p in ps.model.named_parameters()}
    for ref, port in ((js.params, port_params), (js.ema_params, ps.ema)):
        ref = kokoro_state_dict_from_flax(flat_np(ref))
        assert set(ref) == set(port)
        diff2 = moved2 = 0.0
        for name, value in ref.items():
            d_ref, d_port = value - start[name], port[name] - start[name]
            assert d_ref.norm() > 0, name
            leaf = ((d_port - d_ref).norm() / d_ref.norm()).item()
            assert leaf <= leaf_limit, (name, leaf)
            diff2 += (d_port - d_ref).pow(2).sum().item()
            moved2 += d_ref.pow(2).sum().item()
        assert math.sqrt(diff2 / moved2) <= tree_limit, math.sqrt(diff2 / moved2)


def assert_counters(js, ps, rtol):
    assert ps.opt_step == int(js.opt_step) and ps.ema_updates == int(js.ema_updates)
    assert ps.skipped_steps == int(js.skipped_steps)
    assert ps.grad_ema_steps == int(js.grad_ema_steps)
    assert rel(ps.grad_ema, float(js.grad_ema)) <= rtol
    assert ps.optimizer.count == int(js.opt_state.count)


# -- the slice as a whole: three training steps ----------------------------
def test_three_train_steps_metrics_match(three_steps):
    _, _, out, traced = three_steps
    # the reference traced its packed kernels once: self + cross per layer
    assert traced[0] == 2 * ARCH["n_decoder_layers"]
    for jm, pm in out:
        assert pm["stepped"] == 1.0
        assert_metrics(jm, pm)


def test_three_train_steps_params_and_ema_match(three_steps):
    js, ps, _, _ = three_steps
    assert ps.opt_step == 3
    assert_state(js, ps)


def test_eval_step_on_ema_params_matches(f32, three_steps):
    """The validation step on the EMA parameters after the three steps."""
    js, ps, _, _ = three_steps
    batch = make_batch(40)
    old = ref_blocks.FUSED_ON_CPU_FOR_TESTS
    ref_blocks.FUSED_ON_CPU_FOR_TESTS = True
    try:
        ref = jax.jit(ref_make_eval_step(f32.jm, f32.jcfg))(js.ema_params, jax_batch(batch))
    finally:
        ref_blocks.FUSED_ON_CPU_FOR_TESTS = old
    out = make_eval_step(ps.model, f32.cfg)(torch_batch(batch), ps.ema)
    assert set(out) == set(ref)
    for key, value in ref.items():
        assert rel(out[key], float(value)) <= STEP_RTOL, (key, out[key], float(value))


def test_gradient_accumulation_matches(f32):
    batch = make_batch(20, accum=2)
    js, jm = f32.run_jax(f32.jax_state(), batch, 0)
    ps = f32.port_state()
    pm = f32.run_port(ps, batch, 0)
    assert_metrics(jm, pm)
    assert_state(js, ps)


def test_non_finite_batch_is_skipped_as_in_the_reference(f32):
    bad = make_batch(0)
    bad["mel_specs"][0, 0, 0] = np.nan
    js0, ps = f32.jax_state(), f32.port_state()
    before = {n: p.detach().clone() for n, p in ps.model.named_parameters()}
    js, jm = f32.run_jax(js0, bad, 0)
    pm = f32.run_port(ps, bad, 0)
    assert jm["stepped"] == pm["stepped"] == 0.0
    assert math.isnan(pm["grad_norm"]) and math.isnan(jm["grad_norm"])
    assert ps.skipped_steps == int(js.skipped_steps) == 1
    assert ps.opt_step == 0 and ps.optimizer.count == 0 and ps.grad_ema_steps == 0
    for name, p in ps.model.named_parameters():
        assert torch.equal(p.detach(), before[name])
        assert torch.equal(ps.ema[name], before[name])
    assert all(torch.count_nonzero(m) == 0 for m in ps.optimizer.mu + ps.optimizer.nu)
    assert_state(js, ps, atol=0.0)


def test_explosion_detector_fires_from_a_mid_training_state(f32):
    """A reference state past warmup with a live detector (200 observed
    norms, EMA 0.01) goes across through ``train_state_from_flax``; the next
    step must fire the detector and clip at ``emergency_clip_norm`` in both."""
    rng = np.random.default_rng(3)
    js = f32.jax_state()
    noise = lambda scale, positive=False: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jnp.asarray((np.abs if positive else np.asarray)(
            scale * rng.standard_normal(x.shape)).astype(np.float32)), js.params)
    mu, nu = noise(1e-3), noise(1e-5, positive=True)
    ema = jax.tree_util.tree_map(lambda p, d: p + d, js.params, noise(1e-2))
    js = js.replace(
        opt_state=ref_opt.FusedAdamWState(count=jnp.int32(500), mu=mu, nu=nu),
        opt_step=jnp.int32(500), ema_params=ema, ema_updates=jnp.int32(480),
        grad_ema=jnp.float32(0.01), grad_ema_steps=jnp.int32(200), skipped_steps=jnp.int32(2))
    ps = train_state_from_flax(
        f32.port_model(), f32.cfg, TOTAL_STEPS, params=flat_np(js.params), mu=flat_np(mu),
        nu=flat_np(nu), ema=flat_np(ema), count=500, opt_step=500, ema_updates=480,
        grad_ema=0.01, grad_ema_steps=200, skipped_steps=2)
    assert_state(js, ps, atol=0.0)
    js, jm = f32.run_jax(js, make_batch(30), 0)
    pm = f32.run_port(ps, make_batch(30), 0)
    assert jm["exploded"] == pm["exploded"] == 1.0
    assert pm["clip_norm"] == f32.cfg.emergency_clip_norm
    assert_metrics(jm, pm)
    assert_state(js, ps)


# -- one bf16 step ---------------------------------------------------------
def test_bf16_step_matches_reference(f32):
    """One bf16 step from a state past warmup (optimizer count 500, LR near
    its peak, zero moments, so the update follows this step's gradient
    alone), taken across through ``train_state_from_flax``."""
    pair = Pair("bfloat16", base=f32)
    js = pair.jax_state()
    zeros = jax.tree_util.tree_map(jnp.zeros_like, js.params)
    js = js.replace(opt_state=ref_opt.FusedAdamWState(count=jnp.int32(500), mu=zeros, nu=zeros),
                    opt_step=jnp.int32(500), ema_updates=jnp.int32(500))
    start = flat_np(js.params)
    ps = train_state_from_flax(
        pair.port_model(), pair.cfg, TOTAL_STEPS, params=start, mu=flat_np(zeros),
        nu=flat_np(zeros), ema=flat_np(js.ema_params), count=500, opt_step=500, ema_updates=500,
        grad_ema=0.0, grad_ema_steps=0, skipped_steps=0)
    js, jm = pair.run_jax(js, make_batch(10), 0)
    pm = pair.run_port(ps, make_batch(10), 0)
    assert pm["stepped"] == jm["stepped"] == 1.0
    assert pm["exploded"] == jm["exploded"] == 0.0
    assert_metrics(jm, pm, rtol=2e-2, keys=("total", "mel", "duration", "stop", "pitch", "energy",
                                            "grad_norm"))
    assert_moved_alike(start, js, ps, leaf_limit=0.75, tree_limit=0.45)
    assert_counters(js, ps, rtol=2e-2)


# -- the port's own training semantics --------------------------------------
def _dropout_model():
    """The port's model with the reference's dropout rates and stochastic
    depth, attention-weight dropout through the packed route."""
    model = KokoroModel(KokoroConfig(**ARCH, use_flash_attention=True))
    return model.init_weights(torch.Generator().manual_seed(0))


def _loss_and_grads(model, cfg, seed):
    loss_fn = make_loss_fn(model, cfg, spec_augment=True)
    total, _ = loss_fn(torch_batch(make_batch(5)), Rng.from_generator(
        torch.Generator().manual_seed(seed)))
    grads = torch.autograd.grad(total, list(model.parameters()), allow_unused=True)
    return total.detach(), grads


def test_remat_matches_no_remat_with_dropout_on():
    model = _dropout_model()
    cfg = TrainingConfig(compute_dtype="float32", use_spec_augment=True)
    plain_loss, plain = _loss_and_grads(
        model, TrainingConfig(compute_dtype="float32", gradient_checkpointing=False), 3)
    remat_loss, remat = _loss_and_grads(model, cfg, 3)
    assert cfg.gradient_checkpointing
    torch.testing.assert_close(remat_loss, plain_loss, rtol=0, atol=0)
    for a, b in zip(remat, plain):
        if a is None or b is None:
            assert a is None and b is None
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_same_generator_same_loss_with_dropout_on():
    model = _dropout_model()
    cfg = TrainingConfig(compute_dtype="float32", gradient_checkpointing=False)
    first, _ = _loss_and_grads(model, cfg, 7)
    again, _ = _loss_and_grads(model, cfg, 7)
    other, _ = _loss_and_grads(model, cfg, 8)
    assert torch.equal(first, again)
    assert not torch.equal(first, other)
    model.eval()
    with torch.no_grad():  # eval draws nothing: no Rng needed
        model(**{k: v for k, v in torch_batch(make_batch(5)).items()
                 if k in ("phoneme_indices", "mel_specs", "phoneme_durations", "stress_indices")})


# -- losses, metrics, optimizer pieces --------------------------------------
def _loss_inputs(seed, B=3, T=40, L=12):
    rng = np.random.default_rng(seed)
    d = dict(
        predicted_mel=rng.normal(size=(B, T, 80)), mel_specs=rng.normal(size=(B, T, 80)),
        predicted_log_durations=rng.normal(size=(B, L)),
        phoneme_durations=rng.integers(0, 6, size=(B, L)).astype(np.int32),
        predicted_stop_logits=rng.normal(size=(B, T)) * 3,
        stop_token_targets=rng.uniform(size=(B, T)),
        predicted_pitch=rng.uniform(size=(B, T)), pitch_targets=rng.uniform(size=(B, T)),
        predicted_energy=rng.uniform(size=(B, T)), energy_targets=rng.uniform(size=(B, T)),
        mel_lengths=np.asarray([T, T // 2, 0], np.int32),     # an empty mel mask row
        phoneme_lengths=np.asarray([L, 0, L - 3], np.int32),  # an empty phoneme row
    )
    d = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in d.items()}
    d["predicted_mel"][0, 3, 5] = np.nan
    d["predicted_mel"][1, 2, 0] = np.inf
    d["predicted_pitch"][0, 7] = np.nan
    d["predicted_stop_logits"][0, 1] = -np.inf
    return d


@pytest.mark.parametrize("seed", [0, 1])
def test_losses_match_reference_with_non_finite_elements(seed):
    d = _loss_inputs(seed)
    ref = jax.jit(ref_losses.calculate_training_losses)(**{k: jnp.asarray(v) for k, v in d.items()})
    out = losses.calculate_training_losses(**{k: t(v) for k, v in d.items()})
    for key, value in ref.items():
        np.testing.assert_allclose(n(out[key]), np.asarray(value), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    empty = dict(d, mel_lengths=np.zeros(3, np.int32), phoneme_lengths=np.zeros(3, np.int32))
    out = losses.calculate_training_losses(**{k: t(v) for k, v in empty.items()})
    assert float(out["total"]) == 0.0


def test_eval_metrics_and_stop_targets_match_reference():
    d = _loss_inputs(2)
    target = d["mel_specs"]
    pred = target + 0.3 * np.random.default_rng(9).standard_normal(target.shape).astype(np.float32)
    mask = np.arange(40)[None, :] < d["mel_lengths"][:, None]
    for name in ("spectral_convergence", "mel_cepstral_distortion"):
        ref = jax.jit(getattr(ref_losses, name))(jnp.asarray(pred), jnp.asarray(target),
                                                  jnp.asarray(mask))
        out = getattr(losses, name)(t(pred), t(target), t(mask))
        np.testing.assert_allclose(n(out), np.asarray(ref), rtol=1e-5, err_msg=name)
    pitch = d["pitch_targets"].copy()
    pitch[:, ::3] = 0.0  # unvoiced frames
    ref = ref_losses.f0_rmse(jnp.asarray(d["predicted_pitch"]), jnp.asarray(pitch), jnp.asarray(mask))
    out = losses.f0_rmse(t(d["predicted_pitch"]), t(pitch), t(mask))
    np.testing.assert_allclose(n(out), np.asarray(ref), rtol=1e-5)
    lengths = np.asarray([40, 5, 1, 0], np.int32)
    np.testing.assert_allclose(
        n(losses.build_stop_token_targets(40, t(lengths))),
        np.asarray(ref_losses.build_stop_token_targets(40, jnp.asarray(lengths))), rtol=0, atol=0)


@pytest.fixture(scope="module")
def full_width_paths():
    """Every parameter path of the full-width reference model, from
    ``jax.eval_shape`` of its init (nothing runs at full width)."""
    jm = RefModel(vocab_size=59)
    L, T = 8, 16
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), phoneme_indices=jnp.zeros((1, L), jnp.int32),
        mel_specs=jnp.zeros((1, T, 80)), phoneme_durations=jnp.ones((1, L), jnp.int32),
        stress_indices=jnp.zeros((1, L), jnp.int32), pitch_targets=jnp.zeros((1, T)),
        energy_targets=jnp.zeros((1, T))))
    with torch.device("meta"):
        names = {name for name, _ in KokoroModel(KokoroConfig()).named_parameters()}
    return shapes, names


def test_labels_preclips_and_weight_norm_targets_of_every_parameter(full_width_paths):
    shapes, names = full_width_paths
    jcfg = RefConfig()
    cfg = TrainingConfig()
    labels = flatten_dict(ref_opt.label_params(shapes)["params"], sep="/")
    clips = flatten_dict(ref_opt.build_preclip_tree(shapes, jcfg)["params"], sep="/")
    # a scalar 1000 per leaf: the projection shrinks exactly its targets
    big = jax.tree_util.tree_map(lambda _: jnp.float32(1000.0), shapes)
    projected = flatten_dict(ref_opt.apply_weight_norm_constraints(big, jcfg)["params"], sep="/")
    assert {_torch_name(p) for p in labels} == names
    assert len(names) > 200
    for path, label in labels.items():
        name = _torch_name(path)
        assert optimizer.label_for_name(name) == label, (path, name)
        assert optimizer.preclip_norm_for_name(name, cfg) == clips[path], (path, name)
        assert optimizer.is_weight_norm_target(name) == (float(projected[path]) < 1000.0), name
    assert len(set(labels.values())) == len(optimizer.GROUP_LABELS)


@pytest.mark.parametrize("kind", ["onecycle", "onecycle_no_warmup", "restarts", "restarts_tmult1"])
def test_schedules_match_reference(kind):
    over = {"onecycle": dict(warmup_steps=40),
            "onecycle_no_warmup": dict(use_warmup=False, max_lr_multiplier=3.0),
            "restarts": dict(use_onecycle_lr=False, num_epochs=30, lr_T_0=2, lr_T_mult=2),
            "restarts_tmult1": dict(use_onecycle_lr=False, num_epochs=30, lr_T_0=3, lr_T_mult=1),
            }[kind]
    total = 600
    steps = np.arange(0, total + 20)
    jcfg, cfg = RefConfig(**over), TrainingConfig(**over)
    for label in optimizer.GROUP_LABELS:
        ref = np.asarray(ref_opt.make_group_schedule(jcfg, total, label)(jnp.asarray(steps)))
        sched = optimizer.make_group_schedule(cfg, total, label)
        out = np.asarray([sched(int(s)) for s in steps])
        # the reference evaluates in f32: 2e-6 of the peak LR (the cosine's
        # f32 rounding cancels to ~3e-5 relative near the schedule's floor)
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6 * ref.max(), err_msg=label)
