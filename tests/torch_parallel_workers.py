"""Rank bodies of the port's multi-process tests (tests/test_torch_parallel*.py).

This module imports torch and the port only, never JAX: each rank is a fresh
process started by ``torch.multiprocessing.spawn`` that imports it.
:func:`run_world` starts the ranks over gloo with a ``file://`` store (no TCP
port to collide with another test worker), joins them with a timeout and
kills them when it expires, so a hung collective fails its test instead of
the suite.  A rank that raises fails the test with its traceback.  Results
come back as ``torch.save`` files written by rank 0.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD_TIMEOUT_S = 300


def run_world(fn, world_size: int, tmp_path: Path, *args, timeout: float = WORLD_TIMEOUT_S):
    """Run ``fn(rank, world_size, store, *args)`` in ``world_size`` spawned
    processes; fail (and kill them) if they do not all end within
    ``timeout`` seconds."""
    store = tmp_path / f"store_{time.monotonic_ns()}"
    ctx = mp.start_processes(fn, args=(world_size, str(store), *args), nprocs=world_size,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
            for proc in ctx.processes:
                proc.join(10)
            pytest.fail(f"{fn.__name__}: {world_size} ranks did not end within {timeout} s")


def start_rank(rank: int, world_size: int, store: str):
    """This rank's process group over gloo on the CPU."""
    from kokoro_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    return init_distributed(device="cpu", backend="gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world_size, timeout_s=WORLD_TIMEOUT_S)


def end_rank() -> None:
    """Every rank at the barrier, then the group's end: a rank that left
    while another still wrote or reduced would abort gloo there."""
    dist.barrier()
    dist.destroy_process_group()


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in batch.items()}


def port_state(flat, arch, train, mesh=None):
    """(state, step, config) of the port from flat flax params."""
    from kokoro_tpu_torch.config import KokoroConfig, TrainingConfig
    from kokoro_tpu_torch.convert import kokoro_state_dict_from_flax
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.training.optimizer import build_preclip_norms
    from kokoro_tpu_torch.training.train_step import create_train_state, make_train_step

    cfg = TrainingConfig(**train)
    model = KokoroModel(KokoroConfig(**arch))
    model.load_state_dict(kokoro_state_dict_from_flax(flat), strict=True)
    state = create_train_state(model, cfg, 1000, mesh)
    step = make_train_step(cfg, build_preclip_norms(state.names, cfg), ema_decay=0.9,
                           spec_augment=False)
    return state, step, cfg


def run_steps(flat, arch, train, batches, mesh=None):
    """Three (or len(batches)) steps from ``flat``; ``(metrics, whole
    params, whole EMA)`` (the gathers are collective calls)."""
    from kokoro_tpu_torch.parallel.mesh import shard_batch
    from kokoro_tpu_torch.training.checkpoint import training_state_dict

    state, step, _ = port_state(flat, arch, train, mesh)
    metrics = []
    for i, batch in enumerate(batches):
        local = batch if mesh is None else shard_batch(batch, mesh)
        metrics.append(step(state, torch_batch(local), torch.Generator().manual_seed(i)))
    saved = training_state_dict(state)
    return metrics, saved["model"], saved["ema"], state


def step_world(rank, world_size, store, flat, arch, train, batches, meshes, out_dir,
               checks=False):
    """Training steps on each of ``meshes`` (shapes of ``world_size``
    devices, ``('data', 'model')`` axes), rank 0 saving each run; with
    ``checks`` also :func:`tensor_parallel_checks` and
    :func:`dropout_checks` on the first batch."""
    from kokoro_tpu_torch.config import TrainingConfig
    from kokoro_tpu_torch.parallel.mesh import create_mesh

    start_rank(rank, world_size, store)
    try:
        for shape in meshes:
            mesh = create_mesh(TrainingConfig(mesh_shape=shape,
                                              mesh_axis_names=("data", "model")))
            metrics, params, ema, state = run_steps(flat, arch, train, batches, mesh)
            layout = state.layout
            if rank == 0:
                torch.save({"metrics": metrics, "params": params, "ema": ema,
                            "splits": dict(layout.splits), "partial": layout.partial,
                            "stats": dict(mesh.stats)},
                           Path(out_dir) / f"mesh_{'x'.join(map(str, shape))}.pt")
        if checks:
            tensor_parallel_checks(rank, flat, arch, train, batches[0], out_dir)
            dropout_checks(rank, flat, arch, train, batches[0], out_dir)
        end_rank()
    except BaseException:
        dist.destroy_process_group()
        raise


def _grads(state, cfg, batch, seed=0):
    from kokoro_tpu_torch.training.train_step import step_gradients

    grads, *_ = step_gradients(state, torch_batch(batch), torch.Generator().manual_seed(seed),
                               cfg, spec_augment=False)
    return dict(zip(state.names, grads))


def _close(a, b, what):
    torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-6, msg=what)


def tensor_parallel_checks(rank, flat, arch, train, batch, out_dir):
    """At (1, 2): the synchronised gradients (the q/k/v norm scales'
    partial sums included), the pre-clips and the weight-norm projection
    against the single process's; the control without the partial sum."""
    from kokoro_tpu_torch.config import TrainingConfig
    from kokoro_tpu_torch.parallel.mesh import create_mesh
    from kokoro_tpu_torch.parallel.tp import shard_tree
    from kokoro_tpu_torch.training import optimizer

    mesh = create_mesh(TrainingConfig(mesh_shape=(1, 2), mesh_axis_names=("data", "model")))
    single, _, cfg = port_state(flat, arch, train)
    sharded, _, _ = port_state(flat, arch, train, mesh)
    layout = sharded.layout
    ref = _grads(single, cfg, batch)
    got = _grads(sharded, cfg, batch)
    norm_scales = [n for n in layout.partial if ".q_norm." in n or ".k_norm." in n
                   or ".v_norm." in n]
    assert norm_scales and set(norm_scales) == set(layout.partial)
    for name in ref:
        _close(got[name], layout.shard(name, ref[name]), f"grad {name}")
    # the control: without the model-group sum the norm scales' gradients
    # are each rank's part, and break the limit
    partial, layout.partial = layout.partial, ()
    bad = _grads(sharded, cfg, batch)
    layout.partial = partial
    control = max(((bad[n] - ref[n]).norm() / ref[n].norm()).item() for n in norm_scales)
    # pre-clips with ceilings every attention and FFN tensor exceeds
    names = single.names
    ceilings = [1e-3 if optimizer.preclip_norm_for_name(n, cfg) else 0.0 for n in names]
    ref_clip = [ref[n].clone() for n in names]
    got_clip = [got[n].clone() for n in names]
    optimizer.apply_preclips(ref_clip, ceilings)
    optimizer.apply_preclips(got_clip, ceilings, names, layout)
    for n, a, b in zip(names, got_clip, ref_clip):
        _close(a, layout.shard(n, b), f"pre-clipped {n}")
    # the weight-norm projection onto a ball every FFN weight leaves
    small = TrainingConfig(**{**train, "dec_ffn_max_weight_norm": 0.5})
    ref_p = {n: p.detach().clone() for n, p in single.params.items()}
    got_p = {n: p.detach().clone() for n, p in sharded.params.items()}
    optimizer.apply_weight_norm_constraints(ref_p, small)
    optimizer.apply_weight_norm_constraints(got_p, small, layout)
    projected = [n for n in names if optimizer.is_weight_norm_target(n)]
    assert any(n in layout.splits for n in projected)
    for n, value in shard_tree(ref_p, layout).items():
        _close(got_p[n], value, f"projected {n}")
    if rank == 0:
        torch.save({"control_rel": control, "norm_scales": norm_scales,
                    "projected": projected}, Path(out_dir) / "tensor_parallel.pt")


def dropout_checks(rank, flat, arch, train, batch, out_dir):
    """Training forwards with every dropout on, at (2,) and (1, 2): the seed
    of each draw (every mask comes from ``Rng.generator`` or, in the
    attention kernels, ``attention_seed``) and the streams the sharded
    sites fold their model rank into; the outputs of a (1, 2) forward on
    both ranks; the same seed twice."""
    from kokoro_tpu_torch.config import KokoroConfig, TrainingConfig
    from kokoro_tpu_torch.models import blocks
    from kokoro_tpu_torch.models.rng import Rng
    from kokoro_tpu_torch.parallel.mesh import create_mesh, shard_batch
    from kokoro_tpu_torch.training.train_step import make_loss_fn, step_rng

    draws, sharded_streams = [], []
    generator_of, seed_of, stream_of = (Rng.generator, blocks.attention_seed,
                                        blocks._model_rank_stream)

    def generator(self, device):
        draws.append(self.seed)
        return generator_of(self, device)

    def attention_seed(rng, rate):
        seed = seed_of(rng, rate)
        if seed is not None:
            draws.append(seed)
        return seed

    def model_rank_stream(rng, mesh):
        out = stream_of(rng, mesh)
        if mesh is not None and out is not None:
            sharded_streams.append(out.seed)
        return out

    Rng.generator, blocks.attention_seed = generator, attention_seed
    blocks._model_rank_stream = model_rank_stream
    result = {}
    for shape in ((2,), (1, 2)):
        cfg = TrainingConfig(**{**train, "mesh_shape": shape,
                                "mesh_axis_names": ("data", "model")})
        mesh = create_mesh(cfg)
        state, _, _ = port_state(flat, {**arch, **DROPOUT_ON}, train, mesh)
        loss_fn = make_loss_fn(state.model, cfg, spec_augment=True, mesh=mesh)
        local = torch_batch(shard_batch(batch, mesh))
        runs = []
        for _ in range(2):  # the same step seed twice
            draws.clear()
            sharded_streams.clear()
            total, _ = loss_fn(local, step_rng(torch.Generator().manual_seed(5), mesh))
            runs.append((list(draws), list(sharded_streams), total.detach()))
        seeds = torch.tensor(runs[0][0], dtype=torch.int64)
        other = seeds.clone()
        dist.broadcast(other, src=1)  # rank 1's seeds on every rank
        out = torch.stack([total for *_, total in runs])
        out1 = out.clone()
        dist.broadcast(out1, src=1)
        result["x".join(map(str, shape))] = {
            "draws": len(runs[0][0]), "sharded": [s in runs[0][1] for s in runs[0][0]],
            "equal_to_rank1": (seeds == other).tolist(),
            "repeatable": runs[0][:2] == runs[1][:2] and torch.equal(out[0], out[1]),
            "loss_equal_to_rank1": torch.equal(out, out1)}
    Rng.generator, blocks.attention_seed = generator_of, seed_of
    blocks._model_rank_stream = stream_of
    if rank == 0:
        torch.save(result, Path(out_dir) / "dropout.pt")


DROPOUT_ON = dict(encoder_dropout=0.1, decoder_dropout=0.1, decoder_input_dropout=0.1,
                  variance_dropout=0.1, use_stochastic_depth=True, stochastic_depth_rate=0.1,
                  attention_weight_dropout=True)


# -- the trainer ----------------------------------------------------------------
def smoke_trainer(corpus, out, overrides, device="cpu"):
    """A ``KokoroTrainer`` of the smoke preset that logs to JSONL (no
    tensorboard import in a rank; a rank's process only)."""
    from kokoro_tpu_torch.config import get_smoke_test_config
    from kokoro_tpu_torch.training import trainer as trainer_mod

    trainer_mod._make_writer = trainer_mod._JsonlWriter
    model_cfg, cfg = get_smoke_test_config(**{"data_dir": str(corpus), "output_dir": str(out),
                                              **overrides})
    return trainer_mod.KokoroTrainer(model_cfg, cfg, device=device)


def whole_params(trainer):
    from kokoro_tpu_torch.parallel.tp import gather_tree

    return gather_tree({n: p.detach().clone() for n, p in trainer.state.params.items()},
                       trainer.state.layout)


def trainer_world(rank, world_size, store, corpus, overrides, meshes, out_dir):
    """Two epochs of the smoke trainer on each mesh; rank 0 saves the epoch
    metrics, the whole parameters and what the run wrote."""
    start_rank(rank, world_size, store)
    try:
        for shape in meshes:
            tag = "x".join(map(str, shape))
            run = Path(out_dir) / f"run_{tag}"
            trainer = smoke_trainer(corpus, run, {**overrides, "mesh_shape": shape,
                                                  "mesh_axis_names": ("data", "model")})
            epochs = [trainer.train_epoch(e) for e in range(2)]
            val = trainer.validate_epoch(1)
            params = whole_params(trainer)
            batch = trainer._assemble(trainer.batcher.build_batches(0)[:1],
                                      np.random.default_rng(0))
            if rank == 0:
                torch.save({"epochs": epochs, "val": val, "params": params,
                            "opt_step": trainer.state.opt_step,
                            "dp_size": trainer.dp_size, "tp_size": trainer.tp_size,
                            "local_rows": int(batch["mel_specs"].shape[0]),
                            "quantum": trainer._batch_quantum()},
                           Path(out_dir) / f"trainer_{tag}.pt")
        end_rank()
    except BaseException:
        dist.destroy_process_group()
        raise


def resume_world(rank, world_size, store, corpus, overrides, out_dir):
    """At (2, 2): resume a checkpoint a single process wrote, train one more
    epoch (checkpoints written by rank 0 only), and save the whole
    parameters just after the resume and at the end."""
    start_rank(rank, world_size, store)
    try:
        trainer = smoke_trainer(Path(corpus), Path(out_dir) / "run",
                                {**overrides, "mesh_shape": (2, 2),
                                 "mesh_axis_names": ("data", "model")})
        record = {}
        resume = trainer._maybe_resume

        def recorded_resume():
            resume()
            record.update(resumed=whole_params(trainer), start_step=trainer.state.opt_step)

        trainer._maybe_resume = recorded_resume
        trainer.train()
        final = whole_params(trainer)
        if rank == 0:
            torch.save({**record, "final": final, "start_epoch": trainer.start_epoch,
                        "opt_step": trainer.state.opt_step, "writer": type(trainer.writer).__name__},
                       Path(out_dir) / "resume_2x2.pt")
        elif type(trainer.writer).__name__ != "_NullWriter":
            raise AssertionError(f"rank {rank} has a metric writer")
        end_rank()
    except BaseException:
        dist.destroy_process_group()
        raise
