"""The port's training step on a mesh of processes, on the CPU over gloo.

The model and config of ``tests/test_torch_training.py`` (hidden 128, 2
heads of 64, 2+2 layers, ff 256, every dropout rate 0, f32), one perturbed
flax parameter set, three numpy-seeded batches of B=4 rows whose rows hold
different numbers of valid frames (so each data rank's share of the masked
means differs).  Spawned ranks (``tests/torch_parallel_workers.py``) train
three steps at ``(2,)``, ``(1, 2)`` and ``(2, 2)`` ``('data', 'model')``
meshes; rank 0 saves the metrics and the gathered parameters and EMA.

* Against the port's single process: loss rtol 1e-5, parameters and EMA
  rtol 2e-4 / atol 2e-5, the reference's own limits
  (``tests/unit/test_tensor_parallel.py:196-232``, ``test_parallel.py``).
* Against the JAX package's sharded step (``make_sharded_train_step`` with
  ``tree_shardings`` on the conftest's fake CPU mesh of the same shape):
  the tolerance ``tests/test_torch_training.py`` holds the single-device
  step to, ``STEP_RTOL`` on losses and gradient norms and ``PARAM_ATOL`` on
  parameters and EMA.
* At ``(1, 2)``: the synchronised gradients (the q/k/v norm scales' summed
  over the ``model`` group), the pre-clips and the weight-norm projection
  equal the single process's, and without that sum (the control) the
  norm scales' gradients break the limit.
* Dropout: ranks draw distinct masks on sharded sites and on every site of
  another data rank, identical masks on replicated sites; a forward repeats
  itself under the same seed, and the ranks' losses (the global batch's)
  agree bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import kokoro_tpu.parallel.mesh as ref_mesh
from kokoro_tpu.parallel.tp import tree_shardings
from kokoro_tpu.training import losses as ref_losses
from kokoro_tpu.training import optimizer as ref_opt
from kokoro_tpu.training.train_step import make_train_step as ref_make_step
from kokoro_tpu_torch.convert import kokoro_state_dict_from_flax
from tests import torch_parallel_workers as workers
from tests.test_torch_training import (
    ARCH, EMA_DECAY, NO_DROPOUT, PARAM_ATOL, STEP_RTOL, TRAIN, Pair, flat_np, rel,
)

MESHES = [(2,), (1, 2), (2, 2)]
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL_REF = 1e-5, 2e-4, 2e-5  # the reference's limits
PORT_TRAIN = dict(TRAIN, compute_dtype="float32")


def make_batch(seed, B=4, T=128, L=24):
    rng = np.random.default_rng(seed)
    mel_len = np.asarray([T, T - 19, T - 41, T - 7], np.int32)[:B]
    phon_len = np.asarray([L, L - 5, L - 9, L - 2], np.int32)[:B]
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


BATCHES = [make_batch(30 + i) for i in range(3)]


@pytest.fixture(scope="module")
def pair():
    return Pair("float32")


@pytest.fixture(scope="module")
def runs(pair, tmp_path_factory):
    """Every mesh's saved run, the (1, 2) checks and the dropout readings."""
    out = tmp_path_factory.mktemp("parallel_step")
    arch = dict(ARCH, **NO_DROPOUT, use_flash_attention=True)
    workers.run_world(workers.step_world, 2, out, pair.flat, arch, PORT_TRAIN, BATCHES,
                      [(2,), (1, 2)], str(out), True)
    workers.run_world(workers.step_world, 4, out, pair.flat, arch, PORT_TRAIN, BATCHES,
                      [(2, 2)], str(out))
    saved = {shape: torch.load(out / f"mesh_{'x'.join(map(str, shape))}.pt",
                               weights_only=False) for shape in MESHES}
    return saved, torch.load(out / "tensor_parallel.pt"), torch.load(out / "dropout.pt")


@pytest.fixture(scope="module")
def single(pair):
    """The port's single process on the same batches."""
    arch = dict(ARCH, **NO_DROPOUT, use_flash_attention=True)
    metrics, params, ema, _ = workers.run_steps(pair.flat, arch, PORT_TRAIN, BATCHES)
    return metrics, params, ema


def jax_sharded(pair, shape):
    """Three steps of the JAX package's sharded step on a fake CPU mesh."""
    step = ref_make_step(pair.jm, pair.jcfg, pair.jopt,
                         ref_opt.build_preclip_tree(pair.variables, pair.jcfg),
                         ema_decay=EMA_DECAY, spec_augment=False)
    names = ("data", "model")[:len(shape)]
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


@pytest.mark.parametrize("shape", MESHES, ids=["2", "1x2", "2x2"])
def test_mesh_matches_the_single_process(runs, single, shape):
    saved = runs[0][shape]
    metrics, params, ema = single
    for mine, ref in zip(saved["metrics"], metrics):
        assert mine["stepped"] == ref["stepped"] == 1.0
        for key in ("total", "mel", "duration", "stop", "pitch", "energy"):
            assert rel(mine[key], ref[key]) <= LOSS_RTOL, (shape, key, mine[key], ref[key])
    for name, value in params.items():
        torch.testing.assert_close(saved["params"][name], value, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL_REF, msg=name)
        torch.testing.assert_close(saved["ema"][name], ema[name], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL_REF, msg=name)


@pytest.mark.parametrize("shape", MESHES, ids=["2", "1x2", "2x2"])
def test_mesh_matches_the_jax_sharded_step(runs, pair, shape):
    saved = runs[0][shape]
    js, jax_metrics = jax_sharded(pair, shape)
    for mine, ref in zip(saved["metrics"], jax_metrics):
        for key in ("total", "mel", "duration", "stop", "pitch", "energy", "grad_norm"):
            assert rel(mine[key], ref[key]) <= STEP_RTOL, (shape, key, mine[key], ref[key])
    for tree, ref_tree in ((saved["params"], js.params), (saved["ema"], js.ema_params)):
        ref = kokoro_state_dict_from_flax(flat_np(jax.device_get(ref_tree)))
        assert set(ref) == set(tree)
        for name, value in ref.items():
            torch.testing.assert_close(tree[name], value, rtol=0, atol=PARAM_ATOL, msg=name)
    assert int(js.opt_step) == 3


def test_tensor_parallel_shards_and_sums(runs):
    saved = runs[0]
    assert saved[(2,)]["splits"] == {} and saved[(2,)]["partial"] == ()
    for shape in ((1, 2), (2, 2)):
        splits = saved[shape]["splits"]
        # every attention projection and GLU linear of the 2+2 layers
        assert len(splits) == 2 * 7 + 2 * 11
        assert all(s.halves == 2 for n, s in splits.items() if ".linear1." in n)
        assert len(saved[shape]["partial"]) == 3 * 2 + 6 * 2


def test_gradients_move_in_a_few_buckets(runs):
    """A step's gradient sum is a few flat buckets, not one call per tensor
    (about 200 of them): the rest of a step's collectives are the losses'
    and the stabilization's sums, the norms and the broadcast host read."""
    stats = runs[0][(2,)]["stats"]
    per_step = stats["all_reduce"] / 3
    assert 3 <= per_step <= 10, stats
    assert stats["broadcast"] >= 3


def test_tensor_parallel_gradients_preclips_and_projection(runs):
    readings = runs[1]
    assert len(readings["norm_scales"]) == 18 and readings["projected"]
    # without the model-group sum each rank holds its part: far off
    assert readings["control_rel"] > 1e-2, readings


def test_dropout_streams_by_rank(runs):
    dropout = runs[2]
    data, model = dropout["2"], dropout["1x2"]
    for reading in (data, model):
        assert reading["draws"] > 10 and reading["repeatable"], reading
    # another data rank draws every mask of its own rows
    assert not any(data["equal_to_rank1"]) and not any(data["sharded"])
    # the model ranks: distinct masks exactly on the sharded sites
    assert any(model["sharded"]) and not all(model["sharded"])
    assert [not s for s in model["sharded"]] == model["equal_to_rank1"]
    # the loss is the global batch's on every rank
    assert model["loss_equal_to_rank1"] and data["loss_equal_to_rank1"]
