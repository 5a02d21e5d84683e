"""The port's parallel layer (kokoro_tpu_torch/parallel/) against the JAX
package's rules, in one process: the tensor-parallel rule against
``kokoro_tpu.parallel.tp.leaf_pspec`` for every parameter of the smoke model
(``linear1``'s interleaved halves the one stated difference), the batch
placement helpers against ``kokoro_tpu.parallel.mesh``, the config's mesh
validation against the reference config's (patterns of
``tests/unit/test_tensor_parallel.py`` and ``test_sequence_parallel.py``),
the rank layout, and the sharded blocks' arithmetic: on a mesh without a
process group each rank's attention or GLU output is its partial sum, and
the partial sums over the ranks give the whole block's output.
"""

import numpy as np
import pytest
import torch

from kokoro_tpu import config as ref_config
from kokoro_tpu.parallel import mesh as ref_mesh
from kokoro_tpu.parallel.tp import leaf_pspec
from kokoro_tpu_torch import config as port_config
from kokoro_tpu_torch.config import KokoroConfig
from kokoro_tpu_torch.convert import flax_names
from kokoro_tpu_torch.models import blocks
from kokoro_tpu_torch.models.kokoro import KokoroModel
from kokoro_tpu_torch.models.rng import Rng
from kokoro_tpu_torch.parallel import mesh as port_mesh
from kokoro_tpu_torch.parallel import tp as port_tp

torch.set_num_threads(1)
SMOKE = dict(hidden_dim=64, n_encoder_layers=2, n_decoder_layers=2, n_heads=4,
             encoder_ff_dim=128, decoder_ff_dim=128, variance_filter_size=32)


def smoke_model():
    return KokoroModel(KokoroConfig(**SMOKE)).init_weights(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("tp", [2, 4])
def test_rule_matches_leaf_pspec_for_every_parameter(tp):
    model = smoke_model()
    paths = flax_names(model)
    sharded = 0
    for name, param in model.named_parameters():
        path = tuple(paths[name].split("/"))
        flax_shape = tuple(reversed(param.shape)) if path[-1] == "kernel" else tuple(param.shape)
        spec = tuple(leaf_pspec(path, flax_shape, tp))
        split = port_tp.param_split(name, tuple(param.shape), tp)
        if split is None:
            assert "model" not in spec, name
            continue
        sharded += 1
        flax_dim = spec.index("model")
        # a Dense kernel (in, out) is a torch weight (out, in)
        assert split.dim == (1 - flax_dim if path[-1] == "kernel" else flax_dim), name
        # the stated difference: linear1's [gate; linear] halves split alike
        assert split.halves == (2 if ".ff.linear1." in name else 1), name
    # w_q/w_k/w_v/w_o weights, linear1 weight+bias, linear2 weight per block
    assert sharded == (2 * 4 + 2 * 8) + 3 * 4


def test_duration_adaptor_mlp_stays_replicated():
    """The second stated difference: only the GLU's linear1/linear2 shard."""
    model = KokoroModel(KokoroConfig(**SMOKE, use_variance_predictor=False))
    names = [n for n, _ in model.named_parameters() if n.startswith("duration_adaptor.linear")]
    assert names and all(port_tp.param_split(n, (64, 64), 2) is None for n in names)


def test_rule_guards_indivisible_dimensions():
    assert port_tp.param_split("decoder_layers.0.self_attn.w_q.weight", (6, 64), 4) is None
    assert port_tp.param_split("decoder_layers.0.ff.linear1.weight", (12, 64), 4) is None
    assert port_tp.param_split("decoder_layers.0.ff.linear2.weight", (64, 6), 4) is None
    assert port_tp.param_split("decoder_layers.0.self_attn.w_q.weight", (64, 64), 1) is None


@pytest.mark.parametrize("halves,dim", [(1, 0), (1, 1), (2, 0)])
def test_shards_place_back_into_the_whole_tensor(halves, dim):
    full = torch.randn(16, 8, generator=torch.Generator().manual_seed(1))
    split, tp = port_tp.Split(dim, halves), 4
    rebuilt = torch.zeros_like(full)
    for rank in range(tp):
        shard = port_tp.shard_tensor(full, split, tp, rank)
        assert shard.shape[dim] == full.shape[dim] // tp
        port_tp.place_shard(shard, split, tp, rank, rebuilt)
    assert torch.equal(rebuilt, full)
    if halves == 2:  # rank 1 holds rows 2-3 of each half
        assert torch.equal(port_tp.shard_tensor(full, split, tp, 1),
                           torch.cat([full[2:4], full[10:12]]))


def test_shard_model_slices_what_the_rule_names():
    model = smoke_model()
    whole = {n: p.detach().clone() for n, p in model.named_parameters()}
    mesh = port_mesh.Mesh((1, 2), ("data", "model"), rank=1)
    layout = port_tp.shard_model(model, mesh)
    expected = {n: s for n, p in whole.items()
                if (s := port_tp.param_split(n, tuple(p.shape), 2)) is not None}
    assert layout.splits == expected
    for name, param in model.named_parameters():
        assert torch.equal(param.detach(), layout.shard(name, whole[name])), name
    assert set(layout.partial) == {f"{layer}.{attn}.{norm}.weight"
                                   for layer in ("encoder_layers.0", "encoder_layers.1")
                                   for attn in ("self_attn",)
                                   for norm in ("q_norm", "k_norm", "v_norm")} | {
        f"decoder_layers.{i}.{attn}.{norm}.weight" for i in (0, 1)
        for attn in ("self_attn", "cross_attn") for norm in ("q_norm", "k_norm", "v_norm")}
    attn = model.decoder_layers[0].self_attn
    assert (attn.local_heads, attn.head_offset, attn.local_width) == (2, 2, 32)


def test_shard_tree_then_gather_tree_without_a_group():
    """Without a process group ``gather_tree`` places one rank's slice and
    sums nothing: the other rank's rows stay zero."""
    model = smoke_model()
    name = "decoder_layers.0.ff.linear1.weight"
    whole = model.get_parameter(name).detach().clone()
    mesh = port_mesh.Mesh((2,), ("model",), rank=0)
    layout = port_tp.shard_model(model, mesh)
    local = port_tp.shard_tree({name: whole}, layout)[name]
    back = port_tp.gather_tree({name: local}, layout)[name]
    assert back.shape == whole.shape
    assert torch.equal(back[:64], whole[:64]) and torch.equal(back[128:192], whole[128:192])
    assert not back[64:128].any() and not back[192:].any()


def _sharded_sum(make, tp, run):
    """Sum over ``tp`` ranks of a sharded copy's output (a mesh without a
    group: each rank's partial sum), minus the output bias added on every
    rank but one; and the whole module's output."""
    whole = make()
    out_whole = run(whole)
    total = 0.0
    for rank in range(tp):
        module = make()
        mesh = port_mesh.Mesh((tp,), ("model",), rank=rank)
        # the GLU's rule names its parent "ff", as in the blocks
        port_tp.shard_model(torch.nn.ModuleDict({"ff": module}), mesh)
        total = total + run(module)
    return total, out_whole, whole


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_glu_partial_sums_give_the_whole_ffn(tp):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 5, 16, generator=gen)

    def make():
        torch.manual_seed(0)
        return blocks.GLUFeedForward(16, 24, dropout=0.0).eval()

    total, whole_out, whole = _sharded_sum(make, tp, lambda m: m(x))
    total = total - (tp - 1) * whole.linear2.bias
    torch.testing.assert_close(total, whole_out, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["self_causal", "cross_kvlen", "encoder", "alibi"])
def test_sharded_attention_partial_sums_give_the_whole_block(kind):
    tp, d, H = 2, 128, 2  # head_dim 64: the packed route on the CPU's plain versions
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 7, d, generator=gen)
    mem = torch.randn(2, 7, d, generator=gen)
    pad = torch.tensor([[False] * 7, [False] * 5 + [True] * 2])

    def make():
        torch.manual_seed(0)
        m = blocks.MultiHeadAttention(d, H, 0.0, use_rope=kind == "self_causal",
                                      use_alibi=kind == "alibi", qk_norm=True,
                                      use_flash=kind != "encoder")
        with torch.no_grad():
            for norm in (m.q_norm, m.k_norm, m.v_norm):
                norm.weight.uniform_(0.5, 1.5)
        return m.eval()

    def run(m):
        if kind == "self_causal":
            out, _ = m(x, causal=True)
        elif kind == "cross_kvlen":
            out, _ = m(x, mem, mem, key_padding_mask=pad)
        else:
            out, _ = m(x, key_padding_mask=pad)
        return out

    total, whole_out, whole = _sharded_sum(make, tp, run)
    total = total - (tp - 1) * whole.w_o.bias
    torch.testing.assert_close(total, whole_out, rtol=1e-5, atol=1e-5)


def test_sharded_blocks_fold_the_model_rank_into_sharded_sites_only():
    rng = Rng(7)
    mesh0 = port_mesh.Mesh((2,), ("model",), rank=0)
    mesh1 = port_mesh.Mesh((2,), ("model",), rank=1)
    assert blocks._model_rank_stream(rng, None) is rng
    a, b = blocks._model_rank_stream(rng, mesh0), blocks._model_rank_stream(rng, mesh1)
    assert a.seed != b.seed != rng.seed


def test_rank_layout_puts_the_model_axis_fastest():
    grid = np.arange(8).reshape(4, 2)  # the reference's np.asarray(devices).reshape
    for rank in range(8):
        m = port_mesh.Mesh((4, 2), ("data", "model"), rank=rank)
        assert grid[m.index("data"), m.index("model")] == rank
        assert rank == m.index("data") * 2 + m.index("model")
    assert (m.dp, m.tp, port_mesh.mesh_size(m), port_mesh.seq_size(m)) == (4, 2, 8, 1)


def test_create_mesh_without_a_process_group():
    _, cfg = port_config.get_smoke_test_config(mesh_shape=(1, 1),
                                               mesh_axis_names=("data", "model"))
    mesh = port_mesh.create_mesh(cfg)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.groups == {} and mesh.world is None
    _, cfg = port_config.get_smoke_test_config(mesh_shape=(2,))
    with pytest.raises(ValueError, match="2 processes"):
        port_mesh.create_mesh(cfg)
    # a 2-axis shape defaults its second axis to 'model', as the reference's
    _, cfg = port_config.get_smoke_test_config(mesh_shape=(1, 1))
    assert port_mesh.mesh_axes(cfg) == ((1, 1), ("data", "model"))


KEYS = list(ref_mesh._TRAILING_DIMS) + ["unknown_key"]


@pytest.mark.parametrize("key", KEYS)
def test_batch_axis_index_matches_reference(key):
    for ndim in range(1, 6):
        assert port_mesh.batch_axis_index(key, ndim) == ref_mesh.batch_axis_index(key, ndim)
    assert port_mesh._TRAILING_DIMS == ref_mesh._TRAILING_DIMS


@pytest.mark.parametrize("rows,count", [(8, 1), (8, 2), (12, 4), (6, 3), (7, 2)])
def test_process_local_rows_matches_reference(rows, count, monkeypatch):
    monkeypatch.setattr(ref_mesh.jax, "process_count", lambda: count)
    for index in range(count):
        monkeypatch.setattr(ref_mesh.jax, "process_index", lambda i=index: i)
        if rows % count:
            with pytest.raises(ValueError, match="not divisible"):
                ref_mesh.process_local_rows(rows)
            with pytest.raises(ValueError, match="not divisible"):
                port_mesh.process_local_rows(rows, count, index)
        else:
            assert port_mesh.process_local_rows(rows, count, index) == \
                ref_mesh.process_local_rows(rows)


def test_round_up_to_multiple_matches_reference():
    for n in range(0, 40):
        for multiple in (0, 1, 2, 3, 4, 8, 12):
            assert port_mesh.round_up_to_multiple(n, multiple) == \
                ref_mesh.round_up_to_multiple(n, multiple)


def test_shard_batch_takes_the_data_ranks_block():
    batch = {"mel_specs": np.arange(4 * 3 * 2).reshape(4, 3, 2),
             "mel_lengths": np.arange(4), "phoneme_indices": np.arange(2 * 4 * 5).reshape(2, 4, 5)}
    m = port_mesh.Mesh((2, 2), ("data", "model"), rank=3)  # data rank 1
    out = port_mesh.shard_batch(batch, m)
    assert out["mel_specs"].tolist() == batch["mel_specs"][2:].tolist()
    assert out["mel_lengths"].tolist() == [2, 3]
    assert out["phoneme_indices"].tolist() == batch["phoneme_indices"][:, 2:].tolist()


CONFIG_CASES = [
    dict(mesh_shape=(2, 4), mesh_axis_names=("data", "model")),
    dict(mesh_shape=(2, 4), mesh_axis_names=("data", "expert")),
    dict(mesh_shape=(2, 2, 2)),
    dict(mesh_shape=(2, 2, 2), mesh_axis_names=("data", "seq", "model")),
    dict(mesh_shape=(2, 2, 2, 1), mesh_axis_names=("data", "seq", "model", "expert")),
    dict(mesh_shape=(2, 4), mesh_axis_names=("data", "seq")),
    dict(mesh_shape=(2, 4), mesh_axis_names=("data", "ring")),
    dict(mesh_shape=(2, 4), mesh_axis_names=("data", "seq"), mel_bucket_sizes=(30, 64),
         max_seq_length=64),
    dict(mesh_shape=(2, 4), mesh_axis_names=("data", "seq"), mel_bucket_sizes=(32,),
         max_seq_length=70),
    dict(mesh_shape=(2, 2), mesh_axis_names=("data", "stage")),
    dict(mesh_shape=(2, 2), mesh_axis_names=("data", "stage"), use_stochastic_depth=False),
    dict(mesh_shape=(2, 4), mesh_axis_names=("data", "stage"), use_stochastic_depth=False),
    dict(mesh_shape=(2, 2), mesh_axis_names=("stage", "model"), use_stochastic_depth=False),
    dict(mesh_shape=None, mesh_axis_names=("data",)),
]


@pytest.mark.parametrize("case", CONFIG_CASES, ids=[str(i) for i in range(len(CONFIG_CASES))])
def test_config_accepts_and_rejects_what_the_reference_does(case):
    outcomes = []
    for make in (ref_config.get_smoke_test_config, port_config.get_smoke_test_config):
        try:
            made = make(**case)
        except ValueError as err:
            outcomes.append(("error", str(err).split(";")[0].split(":")[0]))
        else:
            cfg = made[1] if isinstance(made, tuple) else made
            outcomes.append(("ok", cfg.mesh_shape, cfg.mesh_axis_names))
    assert outcomes[0] == outcomes[1]


def test_trainer_refuses_seq_and_stage_naming_the_next_slice(tmp_path):
    """The slice that was next is here: the trainer takes a 'seq' or 'stage'
    axis, and one process refuses a mesh of two devices only for want of
    the second process, naming the command that starts both."""
    from kokoro_tpu_torch.training.trainer import KokoroTrainer

    for names in (("data", "seq"), ("data", "stage")):
        model_cfg, cfg = port_config.get_smoke_test_config(
            data_dir=str(tmp_path), output_dir=str(tmp_path / "run"), mesh_shape=(1, 2),
            mesh_axis_names=names, use_stochastic_depth=False)
        with pytest.raises(ValueError, match="needs 2 processes: start them with python -m "
                                             "torch.distributed.run"):
            KokoroTrainer(model_cfg, cfg, device="cpu")


def test_converted_flax_state_enters_a_sharded_run():
    """``convert.train_state_from_flax`` onto a mesh: the parameters,
    moments and EMA are the rank's slices of the converted tensors."""
    from kokoro_tpu_torch.config import TrainingConfig
    from kokoro_tpu_torch.convert import flax_params_from_module, train_state_from_flax

    flat = flax_params_from_module(smoke_model())
    rng = np.random.default_rng(0)
    mu = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in flat.items()}
    mesh = port_mesh.Mesh((1, 2), ("data", "model"), rank=1)
    state = train_state_from_flax(
        KokoroModel(KokoroConfig(**SMOKE)), TrainingConfig(), 100, params=flat, mu=mu, nu=mu,
        ema=flat, count=3, opt_step=3, ema_updates=3, grad_ema=0.5, grad_ema_steps=3,
        skipped_steps=0, mesh=mesh)
    whole = smoke_model()
    name = "decoder_layers.1.ff.linear1.weight"
    split = state.layout.splits[name]
    assert split.halves == 2
    assert torch.equal(state.params[name].detach(),
                       port_tp.shard_tensor(whole.get_parameter(name).detach(), split, 2, 1))
    i = state.names.index(name)
    mu_whole = torch.from_numpy(mu[flax_names(whole)[name]].T.copy())
    assert torch.equal(state.optimizer.mu[i], port_tp.shard_tensor(mu_whole, split, 2, 1))
    assert torch.equal(state.ema[name], state.params[name].detach())
