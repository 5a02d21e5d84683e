"""Sequence parallelism (the ``seq`` axis) of the port, on the CPU over gloo.

The model and config of ``tests/test_torch_parallel_step.py`` (hidden 128,
2 heads of 64, 2+2 layers, ff 256, every dropout rate 0, f32), the plain
attention route (the reference's trainer turns its kernels off under
``seq``), three numpy-seeded batches of B=4 rows with 128, 109, 87 and 20
valid frames of T=128, so that at ``sp = 4`` (windows of 32 frames) the
last row's windows 1-3 hold padding only.  One world of 4 spawned ranks
(``tests/torch_parallel_workers.py``) trains three steps at ``(2, 2)``
``('data', 'seq')``, ``(1, 4)`` and ``(1, 2, 2)`` ``('data', 'seq',
'model')``:

* against the port's single process: loss rtol 1e-5, parameters and EMA
  rtol 2e-4 / atol 2e-5, the reference's limits
  (``tests/unit/test_sequence_parallel.py:236-256``);
* against the JAX package's ``make_sharded_train_step`` on the conftest's
  fake CPU mesh of the same shape and names: ``STEP_RTOL`` / ``PARAM_ATOL``
  of ``tests/test_torch_training.py``;
* the eval metrics (losses, spectral convergence, MCD, F0 RMSE) under
  ``seq`` equal the single process's (1e-5 relative);
* ``shard_batch``'s windows are ``batch_pspec``'s shard shapes (the JAX
  package's, on the fake mesh); ``seq_gather`` of the windows is the whole
  tensor and routes each window its summed gradient; a decoder block (RoPE
  and ALiBi) on a window equals the whole block's window, and its
  gradients summed over the ranks equal the whole gradient;
* dropout: replicated sites draw one mask on a ``seq`` group, the sites on
  a rank's frames distinct masks, one step seed repeats itself;
* the trainer at ``(1, 2)`` ``('data', 'seq')``: one epoch against one
  process, the reference's "use_flash_attention disabled" line, no kernel
  route, its checkpoint resumed by one process; a mel bucket ``sp`` does not
  divide is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import kokoro_tpu.parallel.mesh as ref_mesh
from kokoro_tpu.config import get_smoke_test_config as ref_smoke_config
from kokoro_tpu.parallel.tp import tree_shardings
from kokoro_tpu.training import losses as ref_losses
from kokoro_tpu.training import optimizer as ref_opt
from kokoro_tpu.training.train_step import make_train_step as ref_make_step
from kokoro_tpu_torch.config import get_smoke_test_config
from kokoro_tpu_torch.convert import kokoro_state_dict_from_flax
from kokoro_tpu_torch.parallel import mesh as port_mesh
from tests import torch_parallel_workers as workers
from tests.test_torch_parallel_trainer import OVERRIDES, corpus, jsonl_logs, single_trainer  # noqa: F401
from tests.test_torch_training import (
    ARCH, EMA_DECAY, NO_DROPOUT, PARAM_ATOL, STEP_RTOL, TRAIN, Pair, flat_np, rel,
)

MESHES = [((2, 2), ("data", "seq")), ((1, 4), ("data", "seq")),
          ((1, 2, 2), ("data", "seq", "model"))]
IDS = ["2x2", "1x4", "1x2x2"]
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL_REF = 1e-5, 2e-4, 2e-5  # the reference's limits
PORT_TRAIN = dict(TRAIN, compute_dtype="float32")
PORT_ARCH = dict(ARCH, **NO_DROPOUT, use_flash_attention=False)
LOSS_KEYS = ("total", "mel", "duration", "stop", "pitch", "energy")


def make_batch(seed, B=4, T=128, L=24):
    rng = np.random.default_rng(seed)
    mel_len = np.asarray([T, T - 19, T - 41, 20], np.int32)
    phon_len = np.asarray([L, L - 5, L - 9, 6], np.int32)
    stop = np.asarray(ref_losses.build_stop_token_targets(T, jnp.asarray(mel_len)))
    return {
        "phoneme_indices": rng.integers(1, 59, size=(B, L)).astype(np.int32),
        "stress_indices": rng.integers(0, 3, size=(B, L)).astype(np.int32),
        "phoneme_durations": rng.integers(1, 2 * T // L, size=(B, L)).astype(np.int32),
        "mel_specs": rng.normal(-5.0, 2.0, size=(B, T, 80)).astype(np.float32),
        "pitch_targets": rng.uniform(size=(B, T)).astype(np.float32),
        "energy_targets": rng.uniform(size=(B, T)).astype(np.float32),
        "stop_token_targets": stop.astype(np.float32),
        "mel_lengths": mel_len,
        "phoneme_lengths": phon_len,
    }


BATCHES = [make_batch(50 + i) for i in range(3)]


@pytest.fixture(scope="module")
def pair():
    return Pair("float32")


@pytest.fixture(scope="module")
def runs(pair, tmp_path_factory):
    """Every mesh's saved run and the (1, 4) details."""
    out = tmp_path_factory.mktemp("parallel_seq")
    workers.run_world(workers.seq_world, 4, out, pair.flat, PORT_ARCH, PORT_TRAIN, BATCHES,
                      MESHES, str(out))
    saved = {shape: torch.load(out / f"seq_{'x'.join(map(str, shape))}.pt", weights_only=False)
             for shape, _ in MESHES}
    return saved, torch.load(out / "seq_details.pt", weights_only=False)


@pytest.fixture(scope="module")
def single(pair):
    """The port's single process on the same batches, and its eval metrics."""
    metrics, params, ema, _ = workers.run_steps(pair.flat, PORT_ARCH, PORT_TRAIN, BATCHES)
    return metrics, params, ema, workers.eval_metrics(pair.flat, PORT_ARCH, PORT_TRAIN,
                                                      BATCHES[0])


_JAX_RUNS = {}


def jax_sharded(pair, shape, names):
    """Three steps of the JAX package's sharded step on a fake CPU mesh
    (once per mesh)."""
    if shape not in _JAX_RUNS:
        _JAX_RUNS[shape] = _jax_sharded(pair, shape, names)
    return _JAX_RUNS[shape]


def _jax_sharded(pair, shape, names):
    step = ref_make_step(pair.jm, pair.jcfg, pair.jopt,
                         ref_opt.build_preclip_tree(pair.variables, pair.jcfg),
                         ema_decay=EMA_DECAY, spec_augment=False)
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)
    state0 = pair.jax_state()
    sharding = tree_shardings(state0, mesh)
    sharded_step = ref_mesh.make_sharded_train_step(step, mesh, donate_state=False,
                                                    state_sharding=sharding)
    state = jax.device_put(state0, sharding)
    metrics = []
    for i, batch in enumerate(BATCHES):
        state, m = sharded_step(state, ref_mesh.shard_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, mesh), jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return state, metrics


@pytest.mark.parametrize("shape", [s for s, _ in MESHES], ids=IDS)
def test_seq_mesh_matches_the_single_process(runs, single, shape):
    saved = runs[0][shape]
    metrics, params, ema, _ = single
    for mine, ref in zip(saved["metrics"], metrics):
        assert mine["stepped"] == ref["stepped"] == 1.0
        for key in LOSS_KEYS:
            assert rel(mine[key], ref[key]) <= LOSS_RTOL, (shape, key, mine[key], ref[key])
    for name, value in params.items():
        torch.testing.assert_close(saved["params"][name], value, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL_REF, msg=name)
        torch.testing.assert_close(saved["ema"][name], ema[name], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL_REF, msg=name)


@pytest.fixture(scope="module")
def jax_single(pair):
    """The JAX package's single-device step on the batches: its state and
    metrics."""
    state, metrics = pair.jax_state(), []
    for i, batch in enumerate(BATCHES):
        state, m = pair.jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return state, metrics


@pytest.mark.parametrize("shape,names", MESHES, ids=IDS)
def test_seq_mesh_matches_the_jax_package(runs, pair, jax_single, shape, names):
    """Each step's losses against the JAX sharded step on the same mesh; the
    gradient norm, parameters and EMA against the JAX single-device step,
    which every sharded step must reproduce (``kokoro_tpu/parallel/mesh.py``)
    and the JAX sharded step does not at (1, 2, 2)
    (:func:`test_jax_three_axis_step_misses_its_single_device_numbers`)."""
    saved = runs[0][shape]
    _, jax_metrics = jax_sharded(pair, shape, names)
    js, single_metrics = jax_single
    for mine, ref, one in zip(saved["metrics"], jax_metrics, single_metrics):
        for key in LOSS_KEYS:
            assert rel(mine[key], ref[key]) <= STEP_RTOL, (shape, key, mine[key], ref[key])
        assert rel(mine["grad_norm"], one["grad_norm"]) <= STEP_RTOL, (shape, mine, one)
    for tree, ref_tree in ((saved["params"], js.params), (saved["ema"], js.ema_params)):
        ref = kokoro_state_dict_from_flax(flat_np(jax.device_get(ref_tree)))
        assert set(ref) == set(tree)
        for name, value in ref.items():
            torch.testing.assert_close(tree[name], value, rtol=0, atol=PARAM_ATOL, msg=name)
    assert int(js.opt_step) == 3


def test_jax_three_axis_step_misses_its_single_device_numbers(runs, pair, jax_single):
    """A fault of the reference, pinned (ROADMAP.md §3): on the fake CPU
    mesh the JAX sharded step at (1, 2, 2) ('data', 'seq', 'model') gives
    the single-device losses but a gradient norm more than 1 % off (at
    (1, 1, 2) and (1, 2, 1) it gives the single-device norm).  The port's
    (1, 2, 2) run gives the single-device norm."""
    _, jax_metrics = jax_sharded(pair, (1, 2, 2), ("data", "seq", "model"))
    single_norm = jax_single[1][0]["grad_norm"]
    assert rel(jax_metrics[0]["total"], jax_single[1][0]["total"]) <= STEP_RTOL
    assert rel(jax_metrics[0]["grad_norm"], single_norm) > 1e-2
    assert rel(runs[0][(1, 2, 2)]["metrics"][0]["grad_norm"], single_norm) <= STEP_RTOL


@pytest.mark.parametrize("shape", [s for s, _ in MESHES], ids=IDS)
def test_eval_metrics_under_seq_equal_the_single_process(runs, single, shape):
    mine, ref = runs[0][shape]["eval"], single[3]
    assert set(mine) == set(ref) >= {"spectral_convergence", "mcd", "f0_rmse", *LOSS_KEYS}
    for key, value in ref.items():
        assert rel(mine[key], value) <= LOSS_RTOL, (shape, key, mine[key], value)


def test_seq_steps_gather_kv_once_a_decoder_layer_each_way(runs):
    """Beside (2,)'s collectives, a (2, 2) step makes one batch gather and,
    per decoder layer, one K/V gather forward and one sum backward."""
    per_step = runs[0][(2, 2)]["stats"]["all_reduce"] / 3
    n_layers = ARCH["n_decoder_layers"]
    # (2,) makes 3-10 a step (tests/test_torch_parallel_step.py)
    assert 3 + 1 + 2 * n_layers <= per_step <= 10 + 1 + 2 * n_layers, per_step


@pytest.mark.parametrize("shape,names", [((2, 2), ("data", "seq")), ((1, 4), ("data", "seq")),
                                         ((2, 4), ("data", "seq")),
                                         ((2, 2, 2), ("data", "seq", "model"))],
                         ids=["2x2", "1x4", "2x4", "2x2x2"])
def test_shard_batch_windows_are_batch_pspec_shard_shapes(shape, names):
    batch = BATCHES[0]
    jmesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)
    placed = ref_mesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, jmesh)
    for key, value in batch.items():
        spec = tuple(ref_mesh.batch_pspec(key, value.ndim, seq_axis="seq"))
        assert port_mesh.batch_pspec(key, value.ndim, seq_axis="seq") == spec, key
    mel = batch["mel_specs"]
    for rank in range(int(np.prod(shape))):
        mesh = port_mesh.Mesh(shape, names, rank=rank)
        local = port_mesh.shard_batch(batch, mesh)
        for key, value in placed.items():
            assert local[key].shape == value.sharding.shard_shape(value.shape), (rank, key)
        d, s = mesh.index("data"), mesh.index("seq")
        rows, frames = mel.shape[0] // mesh.dp, mel.shape[1] // mesh.sp
        np.testing.assert_array_equal(
            local["mel_specs"], mel[d * rows:(d + 1) * rows, s * frames:(s + 1) * frames])
        np.testing.assert_array_equal(local["phoneme_indices"],
                                      batch["phoneme_indices"][d * rows:(d + 1) * rows])
        assert port_mesh.frame_window(mesh, mel.shape[1]) == (s * frames, frames)


def test_seq_gather_is_the_whole_tensor_and_routes_gradients(runs):
    gather = runs[1]["gather"]
    assert gather["forward"] == 0.0 and gather["backward"] <= 1e-6, gather


@pytest.mark.parametrize("kind", ["rope", "alibi"])
def test_frame_sharded_decoder_block_matches_the_whole_block(runs, kind):
    block = runs[1]["block"][kind]
    assert block["output"] <= 2e-6 and block["grad_rel"] <= 1e-5, block


def test_dropout_streams_under_seq(runs):
    reading = runs[1]["dropout"]
    assert reading["draws"] > 10 and reading["repeatable"], reading
    # a replicated site (the encoder's, SpecAugment, stochastic depth, the
    # decoder input's) draws the mask of the seq group; a site on the
    # rank's frames its own
    assert any(reading["sharded"]) and not all(reading["sharded"])
    assert [not s for s in reading["sharded"]] == reading["equal_to_rank1"]
    assert reading["loss_equal_to_rank1"]


def test_mel_bucket_not_divisible_by_sp_is_refused():
    kw = dict(mesh_shape=(2, 4), mesh_axis_names=("data", "seq"))
    for make in (get_smoke_test_config, ref_smoke_config):
        with pytest.raises(ValueError, match="divisible by 4"):
            make(**kw, mel_bucket_sizes=(30, 64), max_seq_length=64)
        with pytest.raises(ValueError, match="divisible by 4"):
            make(**kw, mel_bucket_sizes=(32,), max_seq_length=70)


# -- the trainer ------------------------------------------------------------------
TRAINER = dict(OVERRIDES, use_flash_attention=True, save_every=1)


@pytest.fixture(scope="module")
def seq_trainer(corpus, tmp_path_factory):  # noqa: F811
    out = tmp_path_factory.mktemp("seq_trainer")
    workers.run_world(workers.trainer_world, 2, out, str(corpus), TRAINER, [(1, 2)], str(out),
                      ("data", "seq"), 1)
    return out, torch.load(out / "trainer_1x2.pt", weights_only=False)


def test_trainer_on_seq_matches_one_process(corpus, tmp_path, seq_trainer,  # noqa: F811
                                            jsonl_logs):  # noqa: F811
    one = single_trainer(corpus, tmp_path / "one", mesh_shape=(1,), use_flash_attention=False)
    epoch = one.train_epoch(0)
    val = one.validate_epoch(1)
    run = seq_trainer[1]
    assert (run["dp_size"], run["sp_size"]) == (1, 2)
    for key in ("total", "mel"):
        assert abs(epoch[key] - run["epochs"][0][key]) < 5e-4, (key, epoch, run["epochs"])
    for key in ("total", "mel", "spectral_convergence", "mcd"):
        assert abs(val[key] - run["val"][key]) <= 1e-5 * max(1.0, abs(val[key])), key
    assert run["opt_step"] == one.state.opt_step > 0
    for name, param in one.state.params.items():
        torch.testing.assert_close(run["params"][name], param.detach(), rtol=2e-4, atol=2e-5,
                                   msg=name)


def test_trainer_on_seq_turns_the_kernels_off(seq_trainer):
    run = seq_trainer[1]
    # the ranks ran with every kernel route raising (workers.forbid_kernel_routes)
    assert run["use_flash"] is False
    assert any(line.startswith("use_flash_attention disabled: 2-way seq x 1-way pipeline")
               for line in run["log"]), run["log"]
    assert any("Parallelism: 1-way data x 2-way seq x 1-way tensor x 1-way pipeline" in line
               for line in run["log"])
    # each rank collated its rows with T forced to a multiple of sp (then up
    # to the bucket) and kept half of the frames
    assert run["local_rows"] == run["quantum"]
    assert run["forced_frames"] % 2 == 0 and run["local_frames"] * 2 >= run["forced_frames"]


def test_seq_checkpoint_resumes_in_one_process(corpus, seq_trainer, jsonl_logs):  # noqa: F811
    out, run = seq_trainer
    resumed = single_trainer(corpus, out / "run_1x2", num_epochs=2, resume_checkpoint="auto")
    resumed.train()
    assert resumed.start_epoch == 1 and resumed.state.opt_step > run["opt_step"]
