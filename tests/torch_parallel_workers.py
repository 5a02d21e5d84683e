"""Rank bodies of the port's multi-process tests (tests/test_torch_parallel*.py):
data and tensor parallelism, and the ``seq`` and ``stage`` axes.

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


def port_state(flat, arch, train, mesh=None, pipelined=False):
    """(state, step, config) of the port from flat flax params; the step is
    ``parallel/pp_step.py``'s when ``pipelined``."""
    from kokoro_tpu_torch.config import KokoroConfig, TrainingConfig
    from kokoro_tpu_torch.convert import kokoro_state_dict_from_flax
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.training.optimizer import build_preclip_norms
    from kokoro_tpu_torch.training.train_step import create_train_state, make_train_step

    cfg = TrainingConfig(**train)
    model = KokoroModel(KokoroConfig(**arch))
    model.load_state_dict(kokoro_state_dict_from_flax(flat), strict=True)
    state = create_train_state(model, cfg, 1000, mesh)
    if pipelined:
        from kokoro_tpu_torch.parallel.pp_step import make_pp_train_step as make_train_step
    step = make_train_step(cfg, build_preclip_norms(state.names, cfg), ema_decay=0.9,
                           spec_augment=False)
    return state, step, cfg


def run_steps(flat, arch, train, batches, mesh=None, pipelined=False):
    """Three (or len(batches)) steps from ``flat``; ``(metrics, whole
    params, whole EMA)`` (the gathers are collective calls)."""
    from kokoro_tpu_torch.parallel.mesh import shard_batch
    from kokoro_tpu_torch.training.checkpoint import training_state_dict

    state, step, _ = port_state(flat, arch, train, mesh, pipelined)
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


def _mesh(shape, names):
    from kokoro_tpu_torch.config import TrainingConfig
    from kokoro_tpu_torch.parallel.mesh import create_mesh

    return create_mesh(TrainingConfig(mesh_shape=shape, mesh_axis_names=names))


def _tag(shape) -> str:
    return "x".join(map(str, shape))


# -- sequence parallelism ---------------------------------------------------------
def seq_world(rank, world_size, store, flat, arch, train, batches, meshes, out_dir):
    """The ``seq`` axis: on each of ``meshes`` (``(shape, names)``), three
    steps and the eval metrics of the first batch at the start state; then at
    ``(1, world_size)`` the gather, the frame-sharded decoder block and the
    dropout streams.  Rank 0 saves."""
    start_rank(rank, world_size, store)
    try:
        for shape, names in meshes:
            mesh = _mesh(shape, names)
            evaluated = eval_metrics(flat, arch, train, batches[0], mesh)
            metrics, params, ema, _ = run_steps(flat, arch, train, batches, mesh)
            if rank == 0:
                torch.save({"metrics": metrics, "params": params, "ema": ema, "eval": evaluated,
                            "stats": dict(mesh.stats)}, Path(out_dir) / f"seq_{_tag(shape)}.pt")
        mesh = _mesh((1, world_size), ("data", "seq"))
        result = {"gather": gather_checks(mesh),
                  "block": {kind: block_checks(mesh, kind) for kind in ("rope", "alibi")},
                  "dropout": seq_dropout_checks(flat, arch, train, batches[0], mesh)}
        if rank == 0:
            torch.save(result, Path(out_dir) / "seq_details.pt")
        end_rank()
    except BaseException:
        dist.destroy_process_group()
        raise


def eval_metrics(flat, arch, train, batch, mesh=None):
    """``make_eval_step``'s metrics of the start state on ``batch`` (the
    rank's part of it under ``mesh``)."""
    from kokoro_tpu_torch.parallel.mesh import shard_batch
    from kokoro_tpu_torch.training.train_step import make_eval_step

    state, _, cfg = port_state(flat, arch, train, mesh)
    local = batch if mesh is None else shard_batch(batch, mesh)
    return make_eval_step(state.model, cfg, mesh)(torch_batch(local))


def gather_checks(mesh, B=3, T=32, D=8):
    """``seq_gather`` of each rank's window gives the whole tensor, and its
    backward gives each window the sum over the ranks of their gradients'
    window.  Returns the largest errors (0 when exact)."""
    from kokoro_tpu_torch.parallel.mesh import frame_window, seq_gather

    full = torch.randn(B, T, D, generator=torch.Generator().manual_seed(1))
    off, n = frame_window(mesh, T)
    x = full[:, off:off + n].clone().requires_grad_()
    gathered = seq_gather(x, 1, mesh)
    weights = [torch.randn(B, T, D, generator=torch.Generator().manual_seed(10 + r))
               for r in range(mesh.sp)]
    (grad,) = torch.autograd.grad((gathered * weights[mesh.index("seq")]).sum(), [x])
    want = sum(weights)[:, off:off + n]
    return {"forward": (gathered - full).abs().max().item(),
            "backward": (grad - want).abs().max().item()}


def block_checks(mesh, rel_pos_type, B=3, T=32, S=20, D=32, heads=4):
    """A decoder block (RoPE or ALiBi, q/k/v norms) on the seq rank's window
    against the whole block on the whole frame axis: the window of its
    output, and each parameter's gradient summed over the ranks against the
    whole gradient, for a loss summed over frames.  Rows of 32, 23 and 5
    valid frames, so that a window holds padding only."""
    from kokoro_tpu_torch.models.blocks import DecoderBlock
    from kokoro_tpu_torch.parallel.mesh import frame_window

    gen = torch.Generator().manual_seed(2)
    block = DecoderBlock(D, heads, 2 * D, 0.0, qk_norm=True, rel_pos_type=rel_pos_type)
    with torch.no_grad():  # the same parameters on every rank
        for p in block.parameters():
            p.copy_((1.0 if p.dim() == 1 else 0.0) + 0.2 * torch.randn(p.shape, generator=gen))
    block.eval()
    x, memory, w = (torch.randn(shape, generator=gen) for shape in
                    ((B, T, D), (B, S, D), (B, T, D)))
    lengths = torch.tensor([T, T - 9, 5])
    tgt_pad = torch.arange(T)[None] >= lengths[:, None]
    mem_pad = torch.arange(S)[None] >= torch.tensor([S, 12, 7])[:, None]
    params = list(block.parameters())
    y_full, _ = block(x, memory, mem_pad, tgt_pad)
    g_full = torch.autograd.grad((y_full * w).sum(), params)
    off, n = frame_window(mesh, T)
    block.shard_sequence(mesh)
    y, _ = block(x[:, off:off + n], memory, mem_pad, tgt_pad)
    grads = torch.autograd.grad((y * w[:, off:off + n]).sum(), params)
    summed = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]), "seq")
    return {"output": (y - y_full[:, off:off + n]).abs().max().item(),
            "grad_rel": ((summed - torch.cat([g.reshape(-1) for g in g_full])).norm()
                         / torch.cat([g.reshape(-1) for g in g_full]).norm()).item()}


def _record_draws():
    """Patch the port's random sites to record the seed of every draw and
    which draws descend from a seq-rank fold; returns (draws, folded,
    undo)."""
    from kokoro_tpu_torch.models import blocks
    from kokoro_tpu_torch.models.rng import Rng

    draws, folded = [], []
    generator_of, stream_of = Rng.generator, blocks._seq_rank_stream

    class Folded(Rng):
        """A stream under a seq-rank fold, and every stream folded from it."""

        def fold(self, name):
            return Folded(Rng.fold(self, name).seed)

    def generator(self, device):
        draws.append(self.seed)
        if isinstance(self, Folded):
            folded.append(self.seed)
        return generator_of(self, device)

    def seq_rank_stream(rng, mesh):
        out = stream_of(rng, mesh)
        return Folded(out.seed) if mesh is not None and out is not None else out

    Rng.generator, blocks._seq_rank_stream = generator, seq_rank_stream

    def undo():
        Rng.generator, blocks._seq_rank_stream = generator_of, stream_of

    return draws, folded, undo


def _compare_to_rank(values, src):
    """Elementwise ``values == src's values`` (an int64 collective)."""
    mine = torch.tensor(values, dtype=torch.int64)
    other = mine.clone()
    dist.broadcast(other, src=src)
    return (mine == other).tolist()


def seq_dropout_checks(flat, arch, train, batch, mesh):
    """Training forwards with every dropout on under ``mesh`` (a seq axis):
    the seed of every draw, whether its stream was folded with the seq rank
    (a site on the rank's frames), against rank 1's; the same step seed
    twice; the loss on every rank."""
    from kokoro_tpu_torch.config import TrainingConfig
    from kokoro_tpu_torch.parallel.mesh import shard_batch
    from kokoro_tpu_torch.training.train_step import make_loss_fn, step_rng

    draws, folded, undo = _record_draws()
    try:
        cfg = TrainingConfig(**{**train, "use_spec_augment": True})
        state, _, _ = port_state(flat, {**arch, **DROPOUT_ON}, train, mesh)
        loss_fn = make_loss_fn(state.model, cfg, spec_augment=True, mesh=mesh)
        local = torch_batch(shard_batch(batch, mesh))
        runs = []
        for _ in range(2):
            draws.clear()
            folded.clear()
            total, _ = loss_fn(local, step_rng(torch.Generator().manual_seed(5), mesh))
            runs.append((list(draws), set(folded), total.detach()))
    finally:
        undo()
    seeds, sharded, total = runs[0]
    totals = torch.stack([total, runs[1][2]])
    totals1 = totals.clone()
    dist.broadcast(totals1, src=1)
    return {"draws": len(seeds), "sharded": [d in sharded for d in seeds],
            "equal_to_rank1": _compare_to_rank(seeds, 1),
            "repeatable": runs[0][:2] == runs[1][:2] and torch.equal(totals[0], totals[1]),
            "loss_equal_to_rank1": torch.equal(totals, totals1)}


# -- pipeline parallelism ---------------------------------------------------------
def mlp_layer(params, x, aux):
    """A shape-preserving residual MLP layer, the JAX test's own."""
    return torch.tanh(x @ params["w"] + params["b"]) + x


def garbage_layer(params, x, aux):
    """Finite on real microbatches, 0/0 on an all-zero activation (what a
    bubble would carry)."""
    denom = (x * x).sum()
    return x * params["scale"] + x * (denom / denom)


def decoder_layer(block):
    from torch.func import functional_call

    def fn(params, x, aux):
        y, _ = functional_call(block, params, (x, aux["memory"], aux["memory_padding_mask"]))
        return y

    return fn


def pipeline_case(case, out_dir):
    """One ``pipeline_apply`` case on a ``(data, stage)`` mesh: the outputs
    (the last stage's, each data row to its own file) and the gradients of
    ``sum(outputs ** 2)`` with respect to the stacked parameters and the
    microbatches, summed over the mesh (rank 0 saves them)."""
    from kokoro_tpu_torch.models.blocks import DecoderBlock
    from kokoro_tpu_torch.parallel.mesh import process_local_rows
    from kokoro_tpu_torch.parallel.pp import create_pp_mesh, pipeline_apply

    n_data, S = case["shape"]
    mesh = create_pp_mesh(S, n_data)
    rows = process_local_rows(case["microbatches"].shape[1], n_data, mesh.index("data"))
    stacked = {k: torch.from_numpy(v).requires_grad_() for k, v in case["stacked"].items()}
    mbs = torch.from_numpy(case["microbatches"])[:, rows].contiguous().requires_grad_()
    aux = None
    if case["layer"] == "decoder":
        block = DecoderBlock(case["d_model"], case["heads"], case["ff"], 0.0).eval()
        fn = decoder_layer(block)
        aux = {"memory": torch.from_numpy(case["memory"])[:, rows],
               "memory_padding_mask": torch.from_numpy(case["memory_padding_mask"])[:, rows]}
    else:
        fn = {"mlp": mlp_layer, "garbage": garbage_layer}[case["layer"]]
    out, anchor, chain = pipeline_apply(fn, stacked, mbs, mesh, aux=aux)
    loss = anchor if out is None else (out ** 2).sum() + anchor
    inputs = list(stacked.values()) + [mbs, chain]
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)[:-1]
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads[:-1]]), ("data", "stage"))
    names = list(stacked)
    if out is not None:
        torch.save(out.detach(), Path(out_dir) / f"pp_{case['tag']}_out_{mesh.index('data')}.pt")
    if mesh.index("stage") == 0:  # the microbatches' gradient is stage 0's
        torch.save(grads[-1], Path(out_dir) / f"pp_{case['tag']}_dx_{mesh.index('data')}.pt")
    if mesh.rank == 0:
        torch.save({n: piece.view_as(stacked[n]) for n, piece in zip(
            names, flat.split([stacked[n].numel() for n in names]))},
            Path(out_dir) / f"pp_{case['tag']}_grads.pt")


def pipeline_world(rank, world_size, store, flat, arch, train, batches, cases, step_meshes,
                   out_dir, checks=False):
    """The ``stage`` axis: the ``pipeline_apply`` cases; three pipelined
    steps on each of ``step_meshes`` (``('data', 'stage')``, rank 0 saves);
    with ``checks`` the dropout streams at ``(1, world_size)``."""
    start_rank(rank, world_size, store)
    try:
        for case in cases:
            pipeline_case(case, out_dir)
        for shape in step_meshes:
            mesh = _mesh(shape, ("data", "stage"))
            metrics, params, ema, _ = run_steps(flat, arch, train, batches, mesh, pipelined=True)
            if rank == 0:
                torch.save({"metrics": metrics, "params": params, "ema": ema,
                            "stats": dict(mesh.stats)}, Path(out_dir) / f"pp_step_{_tag(shape)}.pt")
        if checks:
            first = {k: v[0] for k, v in batches[0].items()}  # one microbatch
            result = stage_dropout_checks(flat, arch, train, first, world_size)
            if rank == 0:
                torch.save(result, Path(out_dir) / "pp_dropout.pt")
        end_rank()
    except BaseException:
        dist.destroy_process_group()
        raise


def stage_dropout_checks(flat, arch, train, batch, stages):
    """The pipelined loss with every dropout on but stochastic depth (which
    the pipeline refuses) at ``(1, stages)``: the seeds this stage draws,
    stage 1's, and those of the standard loss on the same microbatch and
    step seed in this process; the same step seed twice; the losses on
    every stage."""
    from kokoro_tpu_torch.config import TrainingConfig
    from kokoro_tpu_torch.parallel.pp_step import make_pp_loss_fn
    from kokoro_tpu_torch.training.train_step import make_loss_fn, step_rng

    mesh = _mesh((1, stages), ("data", "stage"))
    draws, _, undo = _record_draws()
    try:
        cfg = TrainingConfig(**{**train, "use_spec_augment": True})
        arch = {**arch, **DROPOUT_ON, "use_stochastic_depth": False}
        state, _, _ = port_state(flat, arch, train, mesh)
        loss_fn = make_pp_loss_fn(state.model, cfg, mesh, spec_augment=True)
        local = torch_batch(batch)
        runs = []
        for _ in range(2):
            draws.clear()
            _, losses, _ = loss_fn({k: v[None] for k, v in local.items()},
                                   [step_rng(torch.Generator().manual_seed(5), mesh)])
            runs.append((list(draws), losses["total"].detach()))
        draws.clear()
        make_loss_fn(state.model, cfg, spec_augment=True)(
            local, step_rng(torch.Generator().manual_seed(5), mesh))
        standard = list(draws)
    finally:
        undo()
    seeds = runs[0][0]
    count = torch.tensor([len(seeds)])
    dist.all_reduce(count, op=dist.ReduceOp.MAX)
    theirs = torch.tensor(seeds + [-1] * (int(count) - len(seeds)), dtype=torch.int64)
    dist.broadcast(theirs, src=1)
    totals = torch.stack([runs[0][1], runs[1][1]])
    totals1 = totals.clone()
    dist.broadcast(totals1, src=1)
    return {"seeds": seeds, "rank1_seeds": [x for x in theirs.tolist() if x != -1],
            "standard_seeds": standard,
            "repeatable": runs[0][0] == runs[1][0] and torch.equal(totals[0], totals[1]),
            "loss_equal_to_rank1": torch.equal(totals, totals1)}


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


def forbid_kernel_routes():
    """Make every attention kernel route of the blocks raise: a path that
    must run the plain route fails if it takes one."""
    from kokoro_tpu_torch.models import blocks

    def refuse(*args, **kwargs):
        raise AssertionError("an attention kernel route was taken")

    blocks.packed_attention = blocks.flash_attention = blocks.fused_attention = refuse


def trainer_world(rank, world_size, store, corpus, overrides, meshes, out_dir,
                  names=("data", "model"), n_epochs=2):
    """``n_epochs`` epochs of the smoke trainer on each mesh of ``names``;
    rank 0 saves the epoch metrics, the whole parameters, what the run
    wrote and the trainer's log lines.  Under ``seq`` or ``stage`` the
    attention kernel routes raise."""
    import logging

    start_rank(rank, world_size, store)
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logging.getLogger("kokoro_tpu_torch.training.trainer").addHandler(handler)
    logging.getLogger("kokoro_tpu_torch.training.trainer").setLevel(logging.INFO)
    if {"seq", "stage"} & set(names):
        forbid_kernel_routes()
    try:
        for shape in meshes:
            tag = "x".join(map(str, shape))
            run = Path(out_dir) / f"run_{tag}"
            trainer = smoke_trainer(corpus, run, {**overrides, "mesh_shape": shape,
                                                  "mesh_axis_names": names})
            epochs = [trainer.train_epoch(e) for e in range(n_epochs)]
            val = trainer.validate_epoch(1)
            params = whole_params(trainer)
            first = trainer.batcher.build_batches(0)[:1]
            batch = trainer._assemble(first, np.random.default_rng(0))
            forced = trainer._forced_dims(trainer.train_dataset, first[0])
            if {"seq", "stage"} & set(names):
                trainer._save(trainer.ckpt.save_epoch_checkpoint, len(epochs) - 1, len(epochs))
            if rank == 0:
                torch.save({"epochs": epochs, "val": val, "params": params,
                            "opt_step": trainer.state.opt_step,
                            "dp_size": trainer.dp_size, "tp_size": trainer.tp_size,
                            "sp_size": trainer.sp_size, "pp_size": trainer.pp_size,
                            "use_flash": trainer.state.model.config.use_flash_attention,
                            "local_rows": int(batch["mel_specs"].shape[0]),
                            "local_frames": int(batch["mel_specs"].shape[-2]),
                            "forced_frames": forced.get("pad_mel_to"),
                            "quantum": trainer._batch_quantum(), "log": list(lines)},
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
