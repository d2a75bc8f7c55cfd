"""PyTorch port vs the JAX package on a mesh: the sharding modes over
torch.distributed (gloo) against the JAX Trainer on the 8-device virtual
CPU mesh (jitted).

One group of 4 ranks (tests/torch_parallel_worker.py, one intra-op thread
each) runs every case; the tests hold what the ranks computed against the
JAX package:

  * 'replicated' (4,) and 'fsdp' (4,): 2 steps at A = 2, dropout 0, from
    the JAX Trainer's own initial parameters, with the JAX Trainer's MLM
    masks handed to the port;
  * 'fsdp+tp' (2, 2), with biases: the same 2 steps; 'tp' (2, 2): forward
    logits through flash_attention_tp;
  * 'replicated' (4,) and 'fsdp' (4,) with the masks the ranks draw
    themselves, against the port's own single-process Trainer;
  * Encoder(mesh=) over 4 ranks with a short final chunk;
  * the dropout streams on a (2, 2) tp mesh.

Small size: 2 layers, d 256, 2 heads of 128, vocab 128, T 128, 2 rows a
data rank; fp32. The parameters are held through the pieces each rank
writes to a checkpoint (its replica-0 shards in the JAX layout), assembled
here: so the assembly also checks that the pieces partition every leaf.
"""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import omnibiote_tpu as obt
from omnibiote_tpu.ops.segments import segment_ids_np
from omnibiote_tpu.parallel.mesh import make_mesh
from omnibiote_tpu.parallel.sharding import param_pspecs as jax_param_pspecs
from omnibiote_tpu.training import mlm as jax_mlm
from omnibiote_tpu.training import train as jax_train

from omnibiote_tpu_torch.utils.convert import flatten_tree
from torch_parallel_worker import run_ranks, shared_workdir

CFG = dict(n_layer=2, n_embd=256, n_head=2, vocab_size=128, block_size=128,
           dropout=0.0, compute_dtype="float32", param_dtype="float32",
           attn_impl="xla")
# fsdp over 4 ranks splits this one's layer axis (no other dimension of
# its stacked leaves divides by 4): each rank holds whole layers
LAYER_AXIS_CFG = dict(CFG, n_layer=4, n_embd=6, n_head=1, vocab_size=32)
MINI, T, A = 2, 128, 2
RTOL, ATOL = 1e-4, 1e-5     # tests/test_training.py::test_fsdp_sharding_mode


def _rows(n, rng, vocab=128):
    """Rows where token t+1 follows t inside EOS-delimited segments."""
    out = []
    for _ in range(n):
        row = []
        while len(row) < T:
            start = int(rng.integers(4, vocab - 12))
            row.extend(range(start, start + int(rng.integers(4, 10))))
            row.append(obt.EOS_TOKEN)
        out.append(row[:T])
    return np.asarray(out, np.int32)


def _jax_trainer(mode, mesh_shape, n_steps, seed, cfg_kw=CFG):
    """A JAX Trainer on the first prod(mesh_shape) virtual devices, and the
    port's case: the Trainer's initial parameters, its global batches and
    the MLM masks its steps will draw."""
    n = int(np.prod(mesh_shape))
    names = ("data", "model")[:len(mesh_shape)]
    mesh = make_mesh(mesh_shape, axis_names=names, devices=jax.devices()[:n])
    micro = MINI * dict(zip(names, mesh_shape))["data"]
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(n_steps):
        toks = np.stack([_rows(micro, rng, cfg_kw["vocab_size"]) for _ in range(A)])
        steps.append({"tokens": toks, "segments": np.stack([segment_ids_np(t) for t in toks])})
    tc = dict(batch_size=A * micro, mini_batch_size=MINI, ctx_len=T, lr=1e-2,
              token_budget=1e6, seed=seed, sharding=mode)

    def global_rows():
        for s in steps:
            yield {"tokens": s["tokens"].reshape(A * micro, T),
                   "segments": s["segments"].reshape(A * micro, T)}

    jt = jax_train.Trainer(obt.OmniBioTAConfig(**cfg_kw), obt.TrainConfig(**tc),
                           batch_iter=global_rows(), mesh=mesh)
    for s, step in enumerate(steps):
        step["masks"] = np.stack([np.asarray(jax_mlm.make_mlm_mask(
            jax.random.split(jax.random.fold_in(jax.random.fold_in(jt.rng, s), i))[0],
            jnp.asarray(step["tokens"][i]), 0.15)) for i in range(A)])
    params = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jt.params)).items()}
    case = {"kind": "train", "mesh": tuple(mesh_shape), "cfg": cfg_kw, "tc": tc,
            "params": params, "steps": steps}
    return jt, case


def _drawn_case(mode, seed):
    """A (4,) case with no masks and no parameters: the ranks init from
    the seed and draw their MLM masks."""
    rng = np.random.default_rng(seed)
    micro = 4 * MINI
    steps = []
    for _ in range(2):
        toks = np.stack([_rows(micro, rng) for _ in range(A)])
        steps.append({"tokens": toks, "segments": np.stack([segment_ids_np(t) for t in toks])})
    tc = dict(batch_size=A * micro, mini_batch_size=MINI, ctx_len=T, lr=1e-2,
              token_budget=1e6, seed=seed, sharding=mode)
    return {"kind": "train", "name": f"{mode}, drawn masks", "mesh": (4,),
            "cfg": CFG, "tc": tc, "steps": steps}


def _assemble(pieces_by_rank, shapes):
    """Full JAX leaves from the ranks' pieces; every element covered once."""
    full = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    hits = {k: np.zeros(s, np.int32) for k, s in shapes.items()}
    for pieces in pieces_by_rank:
        for key, arr in pieces.items():
            leaf, _, idx = key.rpartition("@")
            sl = tuple(slice(*map(int, part.split(":"))) for part in idx.split(","))
            full[leaf][sl] = arr
            hits[leaf][sl] += 1
    for k, h in hits.items():
        assert (h == 1).all(), f"{k}: pieces cover {h.min()}..{h.max()} times"
    return full


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX trainers and inputs, then one 4-rank gloo run of every case."""
    trainers, cases = {}, []
    for name, mode, shape, cfg_kw in (
            ("replicated", "replicated", (4,), CFG), ("fsdp", "fsdp", (4,), CFG),
            ("fsdp+tp", "fsdp+tp", (2, 2), dict(CFG, bias=True)),
            ("fsdp, layer axis", "fsdp", (4,), LAYER_AXIS_CFG)):
        jt, case = _jax_trainer(mode, shape, 2, seed=len(cases), cfg_kw=cfg_kw)
        trainers[name] = jt
        cases.append(dict(case, name=name))
    for mode in ("replicated", "fsdp"):
        cases.append(_drawn_case(mode, seed=len(cases)))
    flash = dict(CFG, attn_impl="flash")
    jt, _ = _jax_trainer("tp", (2, 2), 0, seed=5, cfg_kw=flash)
    rng = np.random.default_rng(6)
    toks = _rows(4, rng)
    fwd_params = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jt.params)).items()}
    cases.append({"kind": "forward", "mesh": (2, 2), "cfg": flash,
                  "tc": dict(batch_size=8, mini_batch_size=2, ctx_len=T, sharding="tp"),
                  "params": fwd_params, "tokens": toks, "segments": segment_ids_np(toks)})
    trainers["tp"] = jt
    seqs = ["<protein>MKVLAAGIWQRST", "<DNA>" + "ACGT" * 30, "<protein>ACDEFGHIK",
            "<DNA>ACGTACGT", "<protein>MKV"]      # batch 4: a final chunk of 1
    cases.append({"kind": "encoder", "mesh": (4,), "cfg": flash,
                  "params": fwd_params, "seqs": seqs, "batch_size": 4})
    toks = _rows(4, np.random.default_rng(8))
    cases.append({"kind": "dropout", "mesh": (2, 2),
                  "cfg": dict(CFG, attn_impl="flash", dropout=0.1),
                  "tc": dict(batch_size=8, mini_batch_size=2, ctx_len=T, sharding="tp"),
                  "tokens": toks, "segments": segment_ids_np(toks)})
    out = run_ranks(4, cases, shared_workdir(tmp_path_factory, "torch_parallel_ranks"))
    by_kind = {"threads": (None, [ranks[-1]["threads"] for ranks in out])}
    for i, case in enumerate(cases):
        by_kind[case.get("name", case["kind"])] = (case, [ranks[i] for ranks in out])
    return trainers, by_kind


def test_one_intra_op_thread_everywhere(world):
    """tests/torch_threads.py reached this process (whatever test ran first
    on it) and the ranks it started: one intra-op thread each."""
    import torch
    assert torch.get_num_threads() == 1
    assert world[1]["threads"][1] == [1, 1, 1, 1]


def _shapes(cfg_kw):
    import omnibiote_tpu_torch as port
    from omnibiote_tpu_torch.parallel.sharding import jax_leaf_shapes
    return jax_leaf_shapes(port.OmniBioTAConfig(**cfg_kw))


@pytest.mark.parametrize("mode", ["replicated", "fsdp", "fsdp+tp", "fsdp, layer axis"])
def test_sharded_steps_match_jax(world, mode):
    """Two steps at A = 2 from the JAX Trainer's parameters: loss, grad
    norm, token counts and every parameter and Adam moment against the JAX
    Trainer on the same mesh shape, rtol 1e-4 / atol 1e-5. fsdp's ranks
    hold 1/4 of every leaf that param_pspecs shards, and so do the
    moments. 'fsdp+tp' carries biases (c_attn's and c_fc's are sliced per
    model rank, their gradients summed over 'model'). 'fsdp, layer axis':
    a model so narrow (d 6, 4 layers) that fsdp splits the stacked layer
    axis."""
    trainers, by_kind = world
    jt = trainers[mode]
    case, ranks = by_kind[mode]
    for s in range(2):
        jm = jt.train_step_once()
        for r in ranks:
            pm = r["metrics"][s]
            np.testing.assert_allclose(pm["loss"], float(jm["loss"]), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(pm["grad_norm"], float(jm["grad_norm"]),
                                       rtol=RTOL, atol=ATOL)
            assert pm["masked_tokens"] == float(jm["masked_tokens"])
            assert pm["num_tokens"] == float(jm["num_tokens"])
    shapes = _shapes(case["cfg"])
    params = _assemble([r["params"] for r in ranks], shapes)
    want = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jt.params)).items()}
    for k in shapes:
        np.testing.assert_allclose(params[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    leaves = jax.tree.leaves(jt.opt_state)
    n = len(shapes)
    assert len(leaves) == 2 * n + 3
    for at, moment in ((2, "mu"), (2 + n, "nu")):
        got = _assemble([r[moment] for r in ranks], shapes)
        for i, k in enumerate(sorted(shapes)):     # the JAX tree's leaf order
            np.testing.assert_allclose(got[k], np.asarray(leaves[at + i]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{moment} {k}")
    if mode == "fsdp":
        import omnibiote_tpu_torch as port
        from omnibiote_tpu_torch.utils.convert import torch_leaf_map
        leaf_map = torch_leaf_map(port.OmniBioTAConfig(**CFG))
        specs = flatten_tree(jax_param_pspecs(jt.params, "fsdp", jt.mesh))
        for r in ranks:
            assert r["mu_shapes"] == r["shapes"]
            for name, shape in r["shapes"].items():
                key, _, _, full = leaf_map[name]
                assert "data" in tuple(specs[key]), key   # every leaf at this size
                assert int(np.prod(shape)) * 4 == int(np.prod(full)), name


@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_drawn_masks_match_the_single_device_step(world, mode):
    """dp over 4 ranks at dropout 0, each rank drawing its rows of the
    global micro-batch's MLM masks: two steps at A = 2 equal the port's
    single-process Trainer on the same seed and global batches (its
    micro-batch the global one): loss, grad norm and token counts a step,
    then every parameter, rtol 1e-4 / atol 1e-5. A wrong row offset would
    mask other positions and change the masked count."""
    import omnibiote_tpu_torch as port
    from omnibiote_tpu_torch.config import TrainConfig
    from omnibiote_tpu_torch.training.train import Trainer
    from omnibiote_tpu_torch.utils.convert import jax_params_from_state
    from torch_parallel_worker import _global_batches
    _, by_kind = world
    case, ranks = by_kind[f"{mode}, drawn masks"]
    tc = dict(case["tc"], sharding="replicated", mini_batch_size=4 * MINI)
    cfg = port.OmniBioTAConfig(**case["cfg"])
    with Trainer(cfg, TrainConfig(**tc), batch_iter=_global_batches(case["steps"]),
                 device="cpu") as tr:
        assert tr.plan is None and tr.accum_slots == A
        for s in range(2):
            m = {k: float(v) for k, v in tr.train_step_once().items()}
            for r in ranks:
                pm = r["metrics"][s]
                np.testing.assert_allclose(pm["loss"], m["loss"], rtol=RTOL, atol=ATOL)
                np.testing.assert_allclose(pm["grad_norm"], m["grad_norm"],
                                           rtol=RTOL, atol=ATOL)
                assert pm["masked_tokens"] == m["masked_tokens"]
                assert pm["num_tokens"] == m["num_tokens"]
        state = {n: p.detach() for n, p in tr.params.items()}
    want = {k: v.numpy() for k, v in flatten_tree(jax_params_from_state(state, cfg)).items()}
    shapes = _shapes(case["cfg"])
    got = _assemble([r["params"] for r in ranks], shapes)
    for k in shapes:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_tp_forward_logits_match_jax(world):
    """tp on a (2, 2) mesh: every rank's logits (its vocab block gathered
    over 'model', attention through flash_attention_tp on its one head)
    equal the JAX forward under the same mesh (flash_attention_tp in
    interpret mode), rtol 1e-4 / atol 1e-5."""
    trainers, by_kind = world
    case, ranks = by_kind["forward"]
    jt = trainers["tp"]
    cfg = obt.OmniBioTAConfig(**case["cfg"])
    want = jax.jit(lambda p, t, s: obt.forward(p, cfg, t, segment_ids=s, tp_mesh=jt.mesh))(
        jt.params, jnp.asarray(case["tokens"]), jnp.asarray(case["segments"]))
    for r in ranks:
        assert tuple(r["local_heads"]) == (3 * 128, 256)
        np.testing.assert_allclose(r["logits"], np.asarray(want), rtol=RTOL, atol=ATOL)


def test_encoder_mesh_matches_single_device(world):
    """Encoder(mesh=) over 4 data ranks: the padded final chunk of one row
    and the all-gather give every rank the single-device embeddings (the
    tolerance of tests/test_api.py's mesh test)."""
    _, by_kind = world
    _, ranks = by_kind["encoder"]
    for r in ranks:
        for method, (single, dp) in r.items():
            assert dp.shape == single.shape == (5, 256)
            np.testing.assert_allclose(dp, single, rtol=1e-5, atol=1e-6, err_msg=method)


def test_dropout_streams_on_a_2x2_mesh(world):
    """tp on (2, 2), dropout 0.1, one training forward: every keep rate
    near 0.9; layer 0's attention masks differ between every pair of ranks;
    its residual masks are equal within a model group (same data index)
    and differ across data ranks."""
    _, by_kind = world
    _, ranks = by_kind["dropout"]
    for r in ranks:
        assert r["n_resid"] == 1 + 2 * CFG["n_layer"] and r["n_attn"] == CFG["n_layer"]
        for m in (r["resid1"], r["attn"]):
            assert abs(m.mean() - 0.9) < 0.02, m.mean()
    for a in range(4):
        for b in range(a + 1, 4):
            assert (ranks[a]["attn"] != ranks[b]["attn"]).mean() > 0.1, (a, b)
            same_data = a // 2 == b // 2
            resid_equal = np.array_equal(ranks[a]["resid1"], ranks[b]["resid1"])
            assert resid_equal == same_data, (a, b)
