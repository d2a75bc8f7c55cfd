"""The port's placement rule (omnibiote_tpu_torch/parallel/sharding.py)
against the JAX package's `param_pspecs`, for every mode and mesh shape; no
processes. Also the placements of every rank of a mesh, simulated: their
shards, written as checkpoint pieces, partition each JAX leaf and rebuild
it exactly, and a tp rank's c_attn holds whole heads of q, k and v."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import jax
import numpy as np
import pytest
import torch

import omnibiote_tpu as obt
from omnibiote_tpu.parallel.mesh import make_mesh
from omnibiote_tpu.parallel.sharding import param_pspecs as jax_param_pspecs

import omnibiote_tpu_torch as port
from omnibiote_tpu_torch.parallel import sharding
from omnibiote_tpu_torch.parallel.tensor import TensorParallel, qkv_rows
from omnibiote_tpu_torch.utils.convert import (flatten_tree, jax_params_from_state,
                                               torch_leaf_map)

MESHES = [((1,), ("data",)), ((4,), ("data",)), ((8,), ("data",)),
          ((2, 2), ("data", "model")), ((4, 2), ("data", "model")),
          ((1, 4), ("data", "model")), ((8, 1), ("data", "model"))]
SIZES = [dict(n_layer=2, n_embd=64, n_head=2, vocab_size=128),
         dict(n_layer=8, n_embd=64, n_head=4, vocab_size=96, bias=True),
         dict(n_layer=3, n_embd=48, n_head=2, vocab_size=128),
         # fsdp over 4 or 8 ranks splits this one's layer axis
         dict(n_layer=8, n_embd=6, n_head=1, vocab_size=16)]


@pytest.mark.parametrize("size", range(len(SIZES)))
@pytest.mark.parametrize("mesh_shape,names", MESHES)
@pytest.mark.parametrize("mode", [m for m in sharding.MODES if m not in sharding.PP_MODES])
def test_param_pspecs_match_jax(mode, mesh_shape, names, size):
    """Spec for spec, on the JAX leaf shapes."""
    kw = SIZES[size]
    params = jax.eval_shape(lambda: obt.init_params(jax.random.PRNGKey(0),
                                                    obt.OmniBioTAConfig(**kw)))
    n = int(np.prod(mesh_shape))
    mesh = make_mesh(mesh_shape, axis_names=names, devices=jax.devices()[:n])
    want = flatten_tree(jax.tree.map(
        tuple, jax_param_pspecs(params, mode, mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    shapes = sharding.jax_leaf_shapes(port.OmniBioTAConfig(**kw))
    axes = dict(zip(names, mesh_shape))
    got = sharding.param_pspecs(shapes, mode, axes.get("data", 1), axes.get("model", 1))
    flat = flatten_tree(params)
    assert set(got) == set(flat)
    for k, leaf in flat.items():
        assert shapes[k] == tuple(leaf.shape), k
        assert got[k] == tuple(want[k]) + (None,) * (leaf.ndim - len(want[k])), k


PP_MESHES = [((1,), ("stage",)), ((2,), ("stage",)), ((4,), ("stage",)),
             ((2, 2), ("data", "stage")), ((4, 2), ("data", "stage")),
             ((2, 4), ("data", "stage")), ((8, 1), ("data", "stage"))]


@pytest.mark.parametrize("size", range(len(SIZES)))
@pytest.mark.parametrize("mesh_shape,names", PP_MESHES)
@pytest.mark.parametrize("mode", sharding.PP_MODES)
def test_pp_param_pspecs_match_jax(mode, mesh_shape, names, size):
    """The pipeline's rule spec for spec against the JAX package's
    `pp_param_pspecs` (fsdp over the data axis under fsdp+pp, its first of
    equal largest dimensions), on ('stage',) and ('data', 'stage') meshes."""
    from omnibiote_tpu.parallel.pipeline import pp_param_pspecs as jax_pp_param_pspecs
    kw = SIZES[size]
    params = jax.eval_shape(lambda: obt.init_params(jax.random.PRNGKey(0),
                                                    obt.OmniBioTAConfig(**kw)))
    n_data = dict(zip(names, mesh_shape)).get("data", 1)
    want = flatten_tree(jax.tree.map(
        tuple, jax_pp_param_pspecs(params, n_data if mode == "fsdp+pp" else 1),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    shapes = sharding.jax_leaf_shapes(port.OmniBioTAConfig(**kw))
    got = sharding.param_pspecs(shapes, mode, n_data, 1)
    flat = flatten_tree(params)
    assert set(got) == set(flat)
    for k, leaf in flat.items():
        assert got[k] == tuple(want[k]) + (None,) * (leaf.ndim - len(want[k])), k
    if mode == "fsdp+pp" and n_data > 1 and size == 0:
        # a tie: the (D, D) attention output takes the first dimension
        assert got["blocks/attn/wo"] == ("stage", "data", None)


@pytest.mark.parametrize("size,n_stage", [(0, 2), (1, 4), (1, 8), (2, 3), (3, 2)])
@pytest.mark.parametrize("mode,n_data", [("pp", 1), ("pp", 2), ("fsdp+pp", 2),
                                         ("fsdp+pp", 4)])
def test_pp_placements_partition_every_leaf(mode, n_data, size, n_stage):
    """Every (data, stage) rank's shards of a random full state, as its
    checkpoint pieces, cover each JAX leaf exactly once and rebuild it; a
    stage holds the blocks of its own layers only, and every stage the
    rest; under fsdp+pp each held tensor is 1/n_data of the whole, where
    it divides."""
    cfg = port.OmniBioTAConfig(**SIZES[size])
    leaf_map = torch_leaf_map(cfg)
    gen = torch.Generator().manual_seed(size)
    full = {n: torch.randn(shape, generator=gen) for n, (_, _, _, shape) in leaf_map.items()}
    want = flatten_tree(jax_params_from_state(full, cfg))
    got = {k: torch.zeros(v.shape) for k, v in want.items()}
    hits = {k: torch.zeros(v.shape, dtype=torch.int32) for k, v in want.items()}
    per = cfg.n_layer // n_stage
    for d in range(n_data):
        for s in range(n_stage):
            pls = sharding.plan_placements(cfg, mode, n_data, 1, d, 0, 0, n_stage, s)
            assert set(pls) == {n for n, (_, layer, _, _) in leaf_map.items()
                                if layer is None or layer // per == s}
            for name, shard in sharding.shard_params(full, pls).items():
                pl = pls[name]
                assert pl.staged == (pl.layer is not None)
                if pl.data_dim is not None:
                    assert shard.numel() * n_data == full[name].numel()
                if not pl.writes():
                    continue
                for idx, piece in pl.jax_pieces(shard):
                    got[pl.jax_key][idx] = piece
                    hits[pl.jax_key][idx] += 1
    for k in want:
        assert bool((hits[k] == 1).all()), k
        assert torch.equal(got[k], want[k]), k


def test_pp_stage_count_must_divide_the_layers():
    """3 layers over 2 stages is refused, as the JAX pipeline asserts."""
    cfg = port.OmniBioTAConfig(**SIZES[2])
    with pytest.raises(ValueError, match="must divide by 2 pipeline stages"):
        sharding.plan_placements(cfg, "pp", 1, 1, 0, 0, 0, 2, 0)


@pytest.mark.parametrize("size", range(len(SIZES)))
@pytest.mark.parametrize("mode,n_data,n_model", [
    ("replicated", 4, 1), ("fsdp", 4, 1), ("fsdp", 8, 1), ("tp", 1, 2),
    ("tp", 2, 2), ("fsdp+tp", 2, 2), ("fsdp+tp", 4, 2)])
def test_placements_partition_every_leaf(mode, n_data, n_model, size):
    """Every rank's shards of a random full state, as the pieces its
    checkpoint would hold, cover each JAX leaf exactly once and rebuild it;
    shards of one tensor are equal-sized across data ranks (per JAX leaf
    for a layer-axis split), and a data-split tensor's shard is 1/n_data
    of its model-local tensor."""
    cfg = port.OmniBioTAConfig(**SIZES[size])
    gen = torch.Generator().manual_seed(size)
    full = {n: torch.randn(shape, generator=gen)
            for n, (_, _, _, shape) in torch_leaf_map(cfg).items()}
    want = flatten_tree(jax_params_from_state(full, cfg))
    got = {k: torch.zeros(v.shape) for k, v in want.items()}
    hits = {k: torch.zeros(v.shape, dtype=torch.int32) for k, v in want.items()}
    for d in range(n_data):
        for m in range(n_model):
            pls = sharding.plan_placements(cfg, mode, n_data, n_model, d, m)
            for name, pl in pls.items():
                shard = pl.take(full[name])
                assert tuple(shard.shape) == pl.shard_shape(d)
                if pl.data_dim is not None:
                    assert shard.numel() * n_data == int(np.prod(pl.local_shape))
                if not pl.writes():
                    continue
                for idx, piece in pl.jax_pieces(shard):
                    got[pl.jax_key][idx] = piece
                    hits[pl.jax_key][idx] += 1
    for k in want:
        assert bool((hits[k] == 1).all()), k
        assert torch.equal(got[k], want[k]), k


def test_tp_rank_holds_whole_heads():
    """With 4 heads over 2 model ranks, rank 1's c_attn rows are heads 2-3
    of q, of k and of v: three column ranges of the JAX wqkv."""
    cfg = port.OmniBioTAConfig(n_layer=1, n_embd=64, n_head=4, vocab_size=128)
    pl = sharding.plan_placements(cfg, "tp", 1, 2, 0, 1)["transformer.h.0.attn.c_attn.weight"]
    assert pl.model_ranges == ((32, 64), (96, 128), (160, 192))
    rows = qkv_rows(64, TensorParallel(None, 1, 2))
    assert rows.tolist() == [*range(32, 64), *range(96, 128), *range(160, 192)]
    keys = [idx for idx, _ in pl.jax_pieces(torch.zeros(96, 64))]
    assert [k[2] for k in keys] == [slice(32, 64), slice(96, 128), slice(160, 192)]


def test_norm_weights_count_each_value_once():
    """Summed over the ranks of a (2, 2) fsdp+tp mesh, every tensor's
    weight times its share of the elements is one whole tensor."""
    cfg = port.OmniBioTAConfig(n_layer=2, n_embd=64, n_head=2, vocab_size=128, bias=True)
    total = {}
    for d in range(2):
        for m in range(2):
            pls = sharding.plan_placements(cfg, "fsdp+tp", 2, 2, d, m)
            names = list(pls)
            for n, w in zip(names, sharding.norm_weights(names, pls)):
                total[n] = total.get(n, 0) + w * int(np.prod(pls[n].shard_shape(d)))
    for n, (_, _, _, shape) in torch_leaf_map(cfg).items():
        assert total[n] == int(np.prod(shape)), n


@pytest.mark.parametrize("mode", sharding.PP_MODES)
def test_pp_norm_weights_count_each_value_once(mode):
    """Over the ranks of a (2, 2) ('data', 'stage') mesh: the embedding,
    ln_f and the head, which every stage holds, count on stage 0 only, each
    block on its own stage; every value once."""
    cfg = port.OmniBioTAConfig(n_layer=4, n_embd=64, n_head=2, vocab_size=128, bias=True)
    total = {}
    for d in range(2):
        for s in range(2):
            pls = sharding.plan_placements(cfg, mode, 2, 1, d, 0, 0, 2, s)
            names = list(pls)
            for n, w in zip(names, sharding.norm_weights(names, pls)):
                assert w == 0.0 or pls[n].staged or s == 0, n
                total[n] = total.get(n, 0) + w * int(np.prod(pls[n].shard_shape(d)))
    for n, (_, _, _, shape) in torch_leaf_map(cfg).items():
        assert total[n] == int(np.prod(shape)), n
