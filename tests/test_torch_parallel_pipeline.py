"""Pipeline parallelism (the ``stage`` axis) of the port, on the CPU over gloo.

* The primitive (``parallel/pp.py``) against the JAX package's
  ``pipeline_apply`` / ``sequential_apply`` on the same stacked parameters
  (the conftest's fake CPU mesh) and against the port's own
  ``sequential_apply``: outputs (1e-5 absolute, the reference's own gate)
  and the gradients of ``sum(outputs ** 2)`` with respect to the stacked
  parameters and the microbatches (``assert_grads_match``, the reference's
  magnitude-relative rule), at S = 2 with M = 5 > S, at S = 4 with
  M = 2 < S, dp x pp at ``(2, 2)``, the decoder block with its memory and
  mask as per-microbatch aux, and a layer that is NaN on an all-zero
  activation (what a bubble would carry) leaving every gradient finite.
  ``stack_layer_params`` / ``unstack_layer_params`` equal the reference's.
* The step (``parallel/pp_step.py``), three steps of 2 microbatches at
  ``(1, 2)`` and ``(2, 2)`` ``('data', 'stage')`` on the model and the
  batches of ``tests/test_torch_parallel_step.py`` (2 decoder layers, one a
  stage; rows of 128, 109, 87 and 121 valid frames): against the port's
  standard accumulation step in one process at the reference's limits
  (``tests/unit/test_pp_trainer.py:75-98``: losses within 5e-4, parameters
  rtol 3e-4 / atol 3e-5), ``(2, 2)`` also against the standard step at
  ``(2,)``, the same data split, as the reference's test holds dp x pp to
  dp (1e-6), and against the JAX package's ``make_pp_train_step`` at
  ``STEP_RTOL`` / ``PARAM_ATOL``.  (On the batches of
  ``tests/test_torch_parallel_seq.py``, whose 20-frame row leaves some
  gradients near 1e-9, the data split alone moves a parameter past those
  limits in three Adam steps at lr 1e-3, in the standard step at ``(2,)``
  as in the pipelined one: Adam's eps of 1e-8 turns f32 rounding of such a
  gradient into a sizeable part of a step.)
* The config's and the step's refusals; dropout under ``stage``; the
  trainer at ``(1, 2)`` ``('data', 'stage')``: one epoch against one
  process, the reference's "use_flash_attention disabled" line, no kernel
  route, its checkpoint resumed by one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from jax.sharding import Mesh

import kokoro_tpu.parallel.mesh as ref_mesh
from kokoro_tpu.config import get_smoke_test_config as ref_smoke_config
from kokoro_tpu.models.blocks import DecoderBlock as RefDecoderBlock
from kokoro_tpu.parallel import pp as ref_pp
from kokoro_tpu.parallel.pp_step import make_pp_train_step as ref_make_pp_step
from kokoro_tpu.training import optimizer as ref_opt
from kokoro_tpu_torch.config import KokoroConfig, TrainingConfig, get_smoke_test_config
from kokoro_tpu_torch.convert import kokoro_state_dict_from_flax
from kokoro_tpu_torch.models.blocks import DecoderBlock
from kokoro_tpu_torch.models.kokoro import KokoroModel
from kokoro_tpu_torch.parallel import pp
from kokoro_tpu_torch.parallel.mesh import Mesh as PortMesh
from kokoro_tpu_torch.parallel.pp_step import make_pp_loss_fn
from tests import torch_parallel_workers as workers
from tests.test_torch_parallel_seq import LOSS_KEYS, PORT_ARCH, PORT_TRAIN
from tests.test_torch_parallel_step import make_batch
from tests.test_torch_parallel_trainer import OVERRIDES, corpus, jsonl_logs, single_trainer  # noqa: F401
from tests.test_torch_training import (
    EMA_DECAY, PARAM_ATOL, STEP_RTOL, Pair, flat_np, rel,
)

D, HEADS, FF = 32, 4, 48
LOSS_ATOL, PARAM_RTOL, PARAM_ATOL_REF = 5e-4, 3e-4, 3e-5  # test_pp_trainer.py's limits


def _mlp_layers(n, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (0.3 * rng.standard_normal((D, D))).astype(np.float32),
             "b": (0.1 * rng.standard_normal(D)).astype(np.float32)} for _ in range(n)]


def _ref_decoder():
    return RefDecoderBlock(d_model=D, num_heads=HEADS, dim_feedforward=FF, dropout=0.0)


def _decoder_layers(n, seed):
    """``n`` flax DecoderBlock parameter trees (flat numpy)."""
    block, x, mem = _ref_decoder(), jnp.zeros((2, 8, D)), jnp.zeros((2, 6, D))
    return [{k: np.asarray(v) for k, v in flatten_dict(
        block.init(key, x, mem)["params"], sep="/").items()}
        for key in jax.random.split(jax.random.PRNGKey(seed), n)]


def _case(tag, shape, layer, n_layers, M, B=2, T=8, seed=0):
    S = shape[1]
    rng = np.random.default_rng(100 + seed)
    case = {"tag": tag, "shape": shape, "layer": layer, "d_model": D, "heads": HEADS, "ff": FF,
            "microbatches": rng.standard_normal((M, B, T, D)).astype(np.float32)}
    if layer == "mlp":
        layers = _mlp_layers(n_layers, seed)
        case["flax_layers"] = layers
        torch_layers = layers
    elif layer == "garbage":
        layers = [{"scale": np.float32(1.0 + 0.1 * i)} for i in range(n_layers)]
        case["flax_layers"] = layers
        torch_layers = [{"scale": np.asarray(v["scale"])} for v in layers]
    else:
        layers = _decoder_layers(n_layers, seed)
        case["flax_layers"] = layers
        torch_layers = [{k: v.numpy() for k, v in kokoro_state_dict_from_flax(p).items()}
                        for p in layers]
        case["memory"] = rng.standard_normal((M, B, 6, D)).astype(np.float32)
        case["memory_padding_mask"] = np.tile(np.arange(6)[None, None] >= 4, (M, B, 1))
    case["stacked"] = {k: v.numpy() for k, v in pp.stack_layer_params(
        [{k: torch.from_numpy(np.asarray(v)) for k, v in p.items()} for p in torch_layers],
        S).items()}
    return case


CASES = {
    "s2_m5": _case("s2_m5", (1, 2), "mlp", 4, 5, seed=1),
    "s4_m2": _case("s4_m2", (1, 4), "mlp", 4, 2, seed=2),
    "dp2_s2": _case("dp2_s2", (2, 2), "mlp", 4, 3, B=4, seed=3),
    "s4_decoder": _case("s4_decoder", (1, 4), "decoder", 4, 3, seed=4),
    "s4_garbage": _case("s4_garbage", (1, 4), "garbage", 4, 3, seed=5),
}
STEP_MESHES = [(1, 2), (2, 2)]
ACCUM = 2


def pp_batch(seed):
    a, b = make_batch(seed), make_batch(seed + 100)
    return {k: np.stack([a[k], b[k]]) for k in a}


BATCHES = [pp_batch(70 + i) for i in range(3)]


@pytest.fixture(scope="module")
def pair():
    return Pair("float32")


@pytest.fixture(scope="module")
def runs(pair, tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel_pipeline")
    two = [CASES["s2_m5"]]
    four = [CASES[t] for t in ("s4_m2", "dp2_s2", "s4_decoder", "s4_garbage")]
    workers.run_world(workers.pipeline_world, 2, out, pair.flat, PORT_ARCH, PORT_TRAIN, BATCHES,
                      two, [(1, 2)], str(out), True)
    workers.run_world(workers.step_world, 2, out, pair.flat, PORT_ARCH, PORT_TRAIN, BATCHES,
                      [(2,)], str(out))
    workers.run_world(workers.pipeline_world, 4, out, pair.flat, PORT_ARCH, PORT_TRAIN, BATCHES,
                      four, [(2, 2)], str(out))
    return out


def _load(out, name):
    return torch.load(out / name, weights_only=False)


def _port_layer_fn(case):
    if case["layer"] == "decoder":
        block = DecoderBlock(D, HEADS, FF, 0.0).eval()
        return workers.decoder_layer(block)
    return {"mlp": workers.mlp_layer, "garbage": workers.garbage_layer}[case["layer"]]


def _ref_layer_fn(case):
    if case["layer"] == "mlp":
        return lambda p, a, aux: jnp.tanh(a @ p["w"] + p["b"]) + a
    if case["layer"] == "garbage":
        return lambda p, a, aux: a * p["scale"] + a * (jnp.sum(a * a) / jnp.sum(a * a))
    block = _ref_decoder()

    def fn(p, a, aux):
        y, _ = block.apply({"params": p}, a, aux["memory"], aux["memory_padding_mask"], None,
                           True)
        return y

    return fn


def _to_torch_grads(case, stacked_grads):
    """JAX stacked gradients as the port's stacked dict."""
    if case["layer"] != "decoder":
        return {k: torch.from_numpy(np.asarray(v)) for k, v in stacked_grads.items()}
    layers = [{k: np.asarray(v) for k, v in flatten_dict(p, sep="/").items()}
              for p in ref_pp.unstack_layer_params(stacked_grads)]
    return pp.stack_layer_params([kokoro_state_dict_from_flax(p) for p in layers],
                                 case["shape"][1])


_JAX_PIPELINES = {}


def jax_pipeline(case):
    """The JAX package's pipelined outputs and the gradients of
    sum(outputs ** 2) (parameters, microbatches), and its sequential
    outputs (jitted, once per case)."""
    if case["tag"] not in _JAX_PIPELINES:
        _JAX_PIPELINES[case["tag"]] = _jax_pipeline(case)
    return _JAX_PIPELINES[case["tag"]]


def _jax_pipeline(case):
    n_data, S = case["shape"]
    mesh = ref_pp.create_pp_mesh(S, n_data=n_data)
    fn = _ref_layer_fn(case)
    if case["layer"] == "decoder":
        layers = [unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in p.items()})
                  for p in case["flax_layers"]]
    else:
        layers = [{k: jnp.asarray(v) for k, v in p.items()} for p in case["flax_layers"]]
    stacked = ref_pp.stack_layer_params(layers, S)
    mbs = jnp.asarray(case["microbatches"])
    aux = None
    if case["layer"] == "decoder":
        aux = {"memory": jnp.asarray(case["memory"]),
               "memory_padding_mask": jnp.asarray(case["memory_padding_mask"])}
    batch_axis = "data" if n_data > 1 else None

    def loss(p, x):
        out = ref_pp.pipeline_apply(fn, p, x, mesh, aux=aux, batch_axis=batch_axis)
        return jnp.sum(out ** 2), out

    (_, out), (g_params, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                           has_aux=True))(stacked, mbs)
    seq = jax.jit(lambda p, x: ref_pp.sequential_apply(fn, p, x, aux=aux))(stacked, mbs)
    return np.asarray(out), _to_torch_grads(case, g_params), np.asarray(g_x), np.asarray(seq)


def port_sequential(case):
    """The port's sequential schedule in this process: outputs and the
    gradients of sum(outputs ** 2)."""
    stacked = {k: torch.from_numpy(v).requires_grad_() for k, v in case["stacked"].items()}
    mbs = torch.from_numpy(case["microbatches"]).requires_grad_()
    aux = None
    if case["layer"] == "decoder":
        aux = {"memory": torch.from_numpy(case["memory"]),
               "memory_padding_mask": torch.from_numpy(case["memory_padding_mask"])}
    out = pp.sequential_apply(_port_layer_fn(case), stacked, mbs, aux)
    grads = torch.autograd.grad((out ** 2).sum(), list(stacked.values()) + [mbs])
    return out.detach(), dict(zip(stacked, grads[:-1])), grads[-1]


def pipelined(out, case):
    n_data = case["shape"][0]
    tag = case["tag"]
    outputs = torch.cat([_load(out, f"pp_{tag}_out_{d}.pt") for d in range(n_data)], dim=1)
    dx = torch.cat([_load(out, f"pp_{tag}_dx_{d}.pt") for d in range(n_data)], dim=1)
    return outputs, _load(out, f"pp_{tag}_grads.pt"), dx


def test_stacking_matches_the_reference():
    layers = _mlp_layers(4, 0)
    ref = ref_pp.stack_layer_params([{k: jnp.asarray(v) for k, v in p.items()} for p in layers],
                                    2)
    mine = pp.stack_layer_params([{k: torch.from_numpy(v) for k, v in p.items()}
                                  for p in layers], 2)
    for k in ref:
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(ref[k]))
    for a, b in zip(pp.unstack_layer_params(mine), layers):
        for k in b:
            np.testing.assert_array_equal(a[k].numpy(), b[k])
    assert [list(pp.stage_layers(6, 3, s)) for s in range(3)] == [[0, 1], [2, 3], [4, 5]]
    with pytest.raises(ValueError, match="do not divide"):
        pp.stack_layer_params([{k: torch.from_numpy(v) for k, v in p.items()} for p in layers],
                               3)
    with pytest.raises(ValueError, match="stages"):
        pp.pipeline_apply(workers.mlp_layer, mine, torch.zeros(2, 2, 8, D), None)


@pytest.mark.parametrize("tag", list(CASES))
def test_pipeline_forward_matches_the_reference(runs, tag):
    case = CASES[tag]
    outputs, _, _ = pipelined(runs, case)
    ref_out, _, _, ref_seq = jax_pipeline(case)
    seq, _, _ = port_sequential(case)
    assert torch.isfinite(outputs).all()
    np.testing.assert_allclose(outputs.numpy(), ref_out, atol=1e-5)
    np.testing.assert_allclose(outputs.numpy(), ref_seq, atol=1e-5)
    np.testing.assert_allclose(outputs.numpy(), seq.numpy(), atol=1e-5)


@pytest.mark.parametrize("tag", list(CASES))
def test_pipeline_gradients_match_the_reference(runs, tag):
    case = CASES[tag]
    _, grads, dx = pipelined(runs, case)
    _, ref_grads, ref_dx, _ = jax_pipeline(case)
    _, seq_grads, seq_dx = port_sequential(case)
    assert set(grads) == set(ref_grads)
    pp.assert_grads_match(grads, ref_grads)  # finite, and within the gate
    pp.assert_grads_match(grads, seq_grads)
    pp.assert_grads_match(dx, ref_dx)
    pp.assert_grads_match(dx, seq_dx)


def test_assert_grads_match_rejects_a_real_mismatch():
    with pytest.raises(AssertionError, match="gradient mismatch"):
        pp.assert_grads_match({"w": torch.ones(4, 4)}, {"w": torch.ones(4, 4) * 1.01})
    with pytest.raises(AssertionError, match="non-finite"):
        pp.assert_grads_match({"w": torch.tensor([float("nan")])}, {"w": torch.tensor([0.0])})
    with pytest.raises(AssertionError, match="trees differ"):
        pp.assert_grads_match([torch.ones(1)], [torch.ones(1), torch.ones(1)])


# -- the step -----------------------------------------------------------------------
@pytest.fixture(scope="module")
def accumulation(pair):
    """The port's standard accumulation step in one process."""
    metrics, params, ema, _ = workers.run_steps(pair.flat, PORT_ARCH, PORT_TRAIN, BATCHES)
    return metrics, params, ema


def jax_pipelined_step(pair, shape):
    """Three steps of the JAX package's pipelined step on a fake CPU mesh."""
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                ("data", "stage"))
    step = ref_make_pp_step(pair.jm, pair.jcfg, pair.jopt, mesh,
                            ref_opt.build_preclip_tree(pair.variables, pair.jcfg),
                            ema_decay=EMA_DECAY, spec_augment=False)
    step = ref_mesh.make_sharded_train_step(step, mesh, donate_state=False)
    state = jax.device_put(pair.jax_state(), ref_mesh.replicated(mesh))
    metrics = []
    for i, batch in enumerate(BATCHES):
        state, m = step(state, ref_mesh.shard_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, mesh), jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return state, metrics


@pytest.mark.parametrize("shape", STEP_MESHES, ids=["1x2", "2x2"])
def test_pp_step_matches_the_accumulation_step(runs, accumulation, shape):
    saved = _load(runs, f"pp_step_{'x'.join(map(str, shape))}.pt")
    metrics, params, ema = accumulation
    for mine, ref in zip(saved["metrics"], metrics):
        assert mine["stepped"] == ref["stepped"] == 1.0
        for key in LOSS_KEYS:
            assert abs(mine[key] - ref[key]) < LOSS_ATOL, (shape, key, mine[key], ref[key])
    for name, value in params.items():
        torch.testing.assert_close(saved["params"][name], value, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL_REF, msg=name)
        torch.testing.assert_close(saved["ema"][name], ema[name], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL_REF, msg=name)


def test_pp_step_matches_data_parallelism_on_the_same_split(runs):
    """(2, 2) against the standard step at (2,): the pipeline adds nothing
    but the order of a few sums."""
    pp_run, dp_run = _load(runs, "pp_step_2x2.pt"), _load(runs, "mesh_2.pt")
    for mine, ref in zip(pp_run["metrics"], dp_run["metrics"]):
        for key in LOSS_KEYS + ("grad_norm",):
            assert rel(mine[key], ref[key]) <= 1e-6, (key, mine[key], ref[key])
    for tree in ("params", "ema"):
        for name, value in dp_run[tree].items():
            torch.testing.assert_close(pp_run[tree][name], value, rtol=0, atol=1e-6, msg=name)


@pytest.mark.parametrize("shape", STEP_MESHES, ids=["1x2", "2x2"])
def test_pp_step_matches_the_jax_pipelined_step(runs, pair, shape):
    saved = _load(runs, f"pp_step_{'x'.join(map(str, shape))}.pt")
    js, jax_metrics = jax_pipelined_step(pair, shape)
    for mine, ref in zip(saved["metrics"], jax_metrics):
        for key in LOSS_KEYS + ("grad_norm",):
            assert rel(mine[key], ref[key]) <= STEP_RTOL, (shape, key, mine[key], ref[key])
    for tree, ref_tree in ((saved["params"], js.params), (saved["ema"], js.ema_params)):
        ref = kokoro_state_dict_from_flax(flat_np(jax.device_get(ref_tree)))
        for name, value in ref.items():
            torch.testing.assert_close(tree[name], value, rtol=0, atol=PARAM_ATOL, msg=name)
    assert int(js.opt_step) == 3


def test_pp_step_hand_offs(runs):
    """Per step and rank of (1, 2): M hand-offs forward and M backward, the
    losses' broadcast from the last stage and the host read's; the
    gradients' all_reduce over ('data', 'stage')."""
    stats = _load(runs, "pp_step_1x2.pt")["stats"]
    assert stats["broadcast"] == 3 * (2 * ACCUM + 2), stats
    assert 1 <= stats["all_reduce"] / 3 <= 4, stats


def test_stage_configurations_are_refused():
    kw = dict(mesh_shape=(2, 4), mesh_axis_names=("data", "stage"))
    for make in (get_smoke_test_config, ref_smoke_config):
        with pytest.raises(ValueError, match="divisible"):
            make(**kw, n_decoder_layers=6, use_stochastic_depth=False)
        with pytest.raises(ValueError, match="stochastic"):
            make(**kw, use_stochastic_depth=True, stochastic_depth_rate=0.1)
        with pytest.raises(ValueError, match="'data' only"):
            make(mesh_shape=(2, 2, 2), mesh_axis_names=("data", "seq", "stage"))
        with pytest.raises(ValueError, match="'data' only"):
            make(mesh_shape=(2, 2), mesh_axis_names=("model", "stage"))
    mesh = PortMesh((1, 2), ("data", "stage"))
    cfg = TrainingConfig()
    with pytest.raises(ValueError, match="not divisible"):
        make_pp_loss_fn(KokoroModel(KokoroConfig(n_decoder_layers=3, hidden_dim=64,
                                                 n_heads=2, use_stochastic_depth=False)),
                        cfg, mesh)
    with pytest.raises(ValueError, match="stochastic"):
        make_pp_loss_fn(KokoroModel(KokoroConfig(hidden_dim=64, n_heads=2)), cfg, mesh)


def test_dropout_under_stage(runs):
    reading = _load(runs, "pp_dropout.pt")
    mine, theirs, standard = (set(reading[k]) for k in ("seeds", "rank1_seeds",
                                                       "standard_seeds"))
    assert reading["repeatable"] and reading["loss_equal_to_rank1"], reading
    # the encoder's, SpecAugment's and the decoder input's draws are shared by
    # the stages; each stage draws its own layers'; together they are the
    # accumulation step's draws
    assert mine & theirs and mine - theirs and theirs - mine
    assert mine | theirs == standard and len(reading["standard_seeds"]) > 10


# -- the trainer ------------------------------------------------------------------
TRAINER = dict(OVERRIDES, use_flash_attention=True, save_every=1, gradient_accumulation_steps=2)


@pytest.fixture(scope="module")
def stage_trainer(corpus, tmp_path_factory):  # noqa: F811
    out = tmp_path_factory.mktemp("stage_trainer")
    workers.run_world(workers.trainer_world, 2, out, str(corpus), TRAINER, [(1, 2)], str(out),
                      ("data", "stage"), 1)
    return out, torch.load(out / "trainer_1x2.pt", weights_only=False)


def test_trainer_on_stage_matches_one_process(corpus, tmp_path, stage_trainer,  # noqa: F811
                                              jsonl_logs):  # noqa: F811
    one = single_trainer(corpus, tmp_path / "one", mesh_shape=(1,), use_flash_attention=False,
                         gradient_accumulation_steps=2)
    epoch = one.train_epoch(0)
    val = one.validate_epoch(1)
    run = stage_trainer[1]
    assert (run["dp_size"], run["pp_size"]) == (1, 2)
    for key in ("total", "mel", "duration", "stop"):
        assert abs(epoch[key] - run["epochs"][0][key]) < LOSS_ATOL, (key, epoch, run["epochs"])
    for key in ("total", "mel", "spectral_convergence", "mcd"):
        assert abs(val[key] - run["val"][key]) <= 1e-5 * max(1.0, abs(val[key])), key
    assert run["opt_step"] == one.state.opt_step > 0
    for name, param in one.state.params.items():
        torch.testing.assert_close(run["params"][name], param.detach(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL_REF, msg=name)


def test_trainer_on_stage_turns_the_kernels_off(stage_trainer):
    run = stage_trainer[1]
    assert run["use_flash"] is False
    assert any(line.startswith("use_flash_attention disabled: 1-way seq x 2-way pipeline")
               for line in run["log"]), run["log"]
    assert any("Parallelism: 1-way data x 1-way seq x 1-way tensor x 2-way pipeline" in line
               for line in run["log"])


def test_stage_checkpoint_resumes_in_one_process(corpus, stage_trainer, jsonl_logs):  # noqa: F811
    out, run = stage_trainer
    resumed = single_trainer(corpus, out / "run_1x2", num_epochs=2, resume_checkpoint="auto",
                             gradient_accumulation_steps=2)
    resumed.train()
    assert resumed.start_epoch == 1 and resumed.state.opt_step > run["opt_step"]


def test_kokoro_train_on_stage_under_torch_distributed_run(corpus, tmp_path):  # noqa: F811
    """The entry point on 2 CPU processes at ``(1, 2)`` ('data', 'stage'),
    the backend named by ``--dist-backend`` (as several processes share one
    card), at the smoke widths (``get_default_config`` swapped for the smoke
    preset, as ``tests/test_torch_parallel_trainer.py`` does)."""
    import json
    import os
    import signal
    import subprocess
    import sys

    from tests.test_torch_parallel_trainer import ROOT, logged

    script = tmp_path / "train_smoke.py"
    script.write_text(
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from kokoro_tpu_torch import config\n"
        "from kokoro_tpu_torch.cli import args, train\n"
        "from kokoro_tpu_torch.training import trainer\n"
        "args.get_default_config = config.get_smoke_test_config\n"
        "trainer._make_writer = trainer._JsonlWriter\n"
        "raise SystemExit(train.main())\n")
    out = tmp_path / "run"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", str(script), "--distributed", "--dist-backend", "gloo", "--mesh-shape", "1,2",
           "--mesh-axes", "data,stage", "--device", "cpu", "--data-dir", str(corpus),
           "--output-dir", str(out), "--epochs", "1", "--no-mfa", "--no-spec-augment",
           "--no-speed-perturbation", "--no-stochastic-depth", "--gradient-accumulation", "2",
           "--save-every", "1"]
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RANK", "WORLD_SIZE",
                                                                    "LOCAL_RANK", "MASTER"))}
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, start_new_session=True)
    try:
        _, stderr = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail("kokoro-train on 2 processes did not end within 240 s")
    assert proc.returncode == 0, stderr[-4000:]
    assert "Parallelism: 1-way data x 1-way seq x 1-way tensor x 2-way pipeline" in stderr
    meta = json.loads((out / "checkpoint_epoch_1" / "metadata.json").read_text())
    assert meta["config"]["mesh_axis_names"] == ["data", "stage"]
    assert logged(out, "loss/train_total_epoch")
