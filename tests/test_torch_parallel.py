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
  * the dropout streams on a (2, 2) tp mesh;
  * sequence parallelism: `ring_attention` (the flash body, P2P over gloo)
    over N = 4 blocks of Tl = 128 against the JAX package's plain ring
    body (`use_flash=False`) on 4 devices; the 'sp' Trainer on (4,) and
    dp x sp on (2, 2) (2 layers, d 128, 2 heads of 64, so the JAX ring takes
    its plain body), 2 steps at A = 2 against the JAX sp Trainer on the
    same mesh with its masks handed in; sp (4,) drawing its own masks
    against the port's single-process Trainer; the sp checkpoint and
    resume, bit for bit;
  * --multihost (a pipeline a data group) under tp (2, 2) and fsdp+tp
    (2, 2) through the CLI, bit for bit equal to the run without it fed
    the same global rows.

No case runs the JAX flash ring body (the Pallas interpreter under a
multi-shard shard_map can deadlock on a few cores). Small size: 2 layers,
d 256, 2 heads of 128, vocab 128, T 128, 2 rows a data rank; fp32. The parameters are held through the pieces each rank
writes to a checkpoint (its replica-0 shards in the JAX layout), assembled
here: so the assembly also checks that the pieces partition every leaf.
"""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import omnibiote_tpu as obt
from omnibiote_tpu.ops.ring_attention import ring_attention as jax_ring_attention
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
# sequence parallelism: heads of 64, so the JAX ring takes its plain body
SP_CFG = dict(CFG, n_embd=128, attn_impl="ring")
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


def _jax_trainer(mode, mesh_shape, n_steps, seed, cfg_kw=CFG, axes=None):
    """A JAX Trainer on the first prod(mesh_shape) virtual devices, and the
    port's case: the Trainer's initial parameters, its global batches and
    the MLM masks its steps will draw. axes: the port's mesh axes (the JAX
    mesh's are ('data', 'model'), or ('data',) / ('data', 'seq') for sp,
    whose 1-D mesh is the sequence axis under the name 'data')."""
    n = int(np.prod(mesh_shape))
    names = ("data", "model")[:len(mesh_shape)]
    if mode == "sp":
        names = ("data", "seq")[:len(mesh_shape)]
        axes = axes or (("seq",) if len(mesh_shape) == 1 else names)
    axes = axes or names
    mesh = make_mesh(mesh_shape, axis_names=names, devices=jax.devices()[:n])
    micro = MINI * dict(zip(axes, mesh_shape)).get("data", 1)
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
    case = {"kind": "train", "mesh": tuple(mesh_shape), "axes": tuple(axes),
            "cfg": cfg_kw, "tc": tc, "params": params, "steps": steps}
    assert jt.global_micro == micro
    return jt, case


def _drawn_case(mode, seed, axes=("data",), cfg_kw=CFG, **tc_kw):
    """A (4,) case with no masks and no parameters: the ranks init from
    the seed and draw their MLM masks. Its global micro-batch is MINI rows
    a data rank."""
    rng = np.random.default_rng(seed)
    micro = MINI * (4 if axes == ("data",) else 1)
    steps = []
    for _ in range(2):
        toks = np.stack([_rows(micro, rng) for _ in range(A)])
        steps.append({"tokens": toks, "segments": np.stack([segment_ids_np(t) for t in toks])})
    tc = dict(batch_size=A * micro, mini_batch_size=MINI, ctx_len=T, lr=1e-2,
              token_budget=1e6, seed=seed, sharding=mode, **tc_kw)
    return {"kind": "train", "name": f"{mode}, drawn masks", "mesh": (4,), "axes": axes,
            "cfg": cfg_kw, "tc": tc, "steps": steps, "micro": micro}


def _ring_case(seed):
    """q, k, v, a cotangent and packed ids (B 2, T 512, H 2, D 128) for
    ring_attention over 4 ranks."""
    rng = np.random.default_rng(seed)
    q, k, v, g = rng.standard_normal((4, 2, 512, 2, 128)).astype(np.float32)
    toks = _rows(2, rng)
    seg = np.stack([segment_ids_np(np.tile(r, 4)) for r in toks])
    return {"kind": "ring", "mesh": (4,), "axes": ("seq",), "q": q, "k": k, "v": v,
            "g": g, "seg": seg, "scale": 1.0 / np.sqrt(128)}


def _write_shards(root, rng, n_files=2, n_seq=150):
    """Token shards of genbank/train and genbank/val (n_files each), each
    file put in place whole: under xdist another worker may be writing the
    same (seeded) files while ranks read them."""
    for corpus in ("genbank/train", "genbank/val"):
        d = os.path.join(root, corpus)
        os.makedirs(d, exist_ok=True)
        for f in range(n_files):
            toks = []
            for _ in range(n_seq):
                seq = rng.integers(20, 500, size=int(rng.integers(5, 60)))
                seq[-1] = obt.EOS_TOKEN
                toks.extend(seq.tolist())
            tmp = os.path.join(d, f".s{f}.{os.getpid()}.tmp")
            with open(tmp, "wb") as fh:
                np.save(fh, np.asarray(toks, np.int32))
            os.replace(tmp, os.path.join(d, f"s{f}.npy"))


def _multihost_case(mode, workdir):
    data = os.path.join(workdir, "multihost_data")
    _write_shards(data, np.random.default_rng(12))
    argv = ["--base_dir", data, "--train_type", "nucleotide", "--n_layer", "2",
            "--n_embd", "128", "--n_head", "2", "--ctx_len", "128",
            "--mini_batch_size", "2", "--batch_size", "8", "--max_steps", "2",
            "--test_freq", "1e12", "--seed", "3", "--sharding", mode,
            "--mesh_shape", "2", "2"]
    return {"kind": "multihost", "name": f"multihost {mode}", "argv": argv,
            "workdir": workdir}


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
    workdir = shared_workdir(tmp_path_factory, "torch_parallel_ranks")
    trainers, cases = {}, []
    for name, mode, shape, cfg_kw in (
            ("replicated", "replicated", (4,), CFG), ("fsdp", "fsdp", (4,), CFG),
            ("fsdp+tp", "fsdp+tp", (2, 2), dict(CFG, bias=True)),
            ("fsdp, layer axis", "fsdp", (4,), LAYER_AXIS_CFG)):
        jt, case = _jax_trainer(mode, shape, 2, seed=len(cases), cfg_kw=cfg_kw)
        trainers[name] = jt
        cases.append(dict(case, name=name))
    for name, shape in (("sp (4,)", (4,)), ("dp x sp (2, 2)", (2, 2))):
        jt, case = _jax_trainer("sp", shape, 2, seed=len(cases), cfg_kw=SP_CFG)
        trainers[name] = jt
        cases.append(dict(case, name=name))
    for mode in ("replicated", "fsdp"):
        cases.append(_drawn_case(mode, seed=len(cases)))
    # a mask rate whose compaction capacity is the whole block (0.6 -> 1.0):
    # sp compacts each block at its own capacity, as the JAX package does,
    # so only then can no position the whole-row compaction keeps be dropped
    cases.append(_drawn_case("sp", seed=len(cases), axes=("seq",), cfg_kw=SP_CFG,
                             mask_prob=0.6))
    resume = _drawn_case("sp", seed=len(cases), axes=("seq",), cfg_kw=SP_CFG)
    resume["tc"]["save_dir"] = os.path.join(workdir, "sp_resume")
    cases.append(dict(resume, kind="resume", name="sp resume", save_at=1))
    cases.append(dict(_ring_case(seed=len(cases)), name="ring"))
    for mode in ("tp", "fsdp+tp"):
        cases.append(_multihost_case(mode, workdir))
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
    out = run_ranks(4, cases, workdir)
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


@pytest.mark.parametrize("mode", ["replicated", "fsdp", "fsdp+tp", "fsdp, layer axis",
                                  "sp (4,)", "dp x sp (2, 2)"])
def test_sharded_steps_match_jax(world, mode):
    """Two steps at A = 2 from the JAX Trainer's parameters: loss, grad
    norm, token counts and every parameter and Adam moment against the JAX
    Trainer on the same mesh shape, rtol 1e-4 / atol 1e-5. fsdp's ranks
    hold 1/4 of every leaf that param_pspecs shards, and so do the
    moments. 'fsdp+tp' carries biases (c_attn's and c_fc's are sliced per
    model rank, their gradients summed over 'model'). 'fsdp, layer axis':
    a model so narrow (d 6, 4 layers) that fsdp splits the stacked layer
    axis. 'sp (4,)': the whole mesh the sequence axis (each rank 32 of the
    128 positions of every row, the ring over 4); 'dp x sp (2, 2)': rows
    over 'data', positions over 'seq', the ring over 2 within each data
    row; both against the JAX sp Trainer (its plain ring body)."""
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


@pytest.mark.parametrize("mode", ["replicated", "fsdp", "sp"])
def test_drawn_masks_match_the_single_device_step(world, mode):
    """dp over 4 ranks at dropout 0, each rank drawing its rows of the
    global micro-batch's MLM masks: two steps at A = 2 equal the port's
    single-process Trainer on the same seed and global batches (its
    micro-batch the global one): loss, grad norm and token counts a step,
    then every parameter, rtol 1e-4 / atol 1e-5. A wrong row offset would
    mask other positions and change the masked count. 'sp': sequence
    parallelism over 4 ranks, each drawing its block of positions of the
    global masks (mask rate 0.6, whose compaction keeps every masked
    position of a block), against the single-process Trainer with a ring
    of one. Then a validation probe (eval_loss; under sp through the ring,
    each rank its block of positions) equals the single-process one."""
    import omnibiote_tpu_torch as port
    from omnibiote_tpu_torch.config import TrainConfig
    from omnibiote_tpu_torch.training.train import Trainer
    from omnibiote_tpu_torch.utils.convert import jax_params_from_state
    from torch_parallel_worker import _global_batches
    _, by_kind = world
    case, ranks = by_kind[f"{mode}, drawn masks"]
    tc = dict(case["tc"], sharding="replicated", mini_batch_size=case["micro"])
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
        probe = case["steps"][0]
        want_eval = tr.eval_loss(probe["tokens"][0], probe["segments"][0])
        state = {n: p.detach() for n, p in tr.params.items()}
    want = {k: v.numpy() for k, v in flatten_tree(jax_params_from_state(state, cfg)).items()}
    shapes = _shapes(case["cfg"])
    got = _assemble([r["params"] for r in ranks], shapes)
    for k in shapes:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    for r in ranks:
        np.testing.assert_allclose(r["eval"], want_eval, rtol=RTOL, atol=ATOL)


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


def test_ring_attention_matches_the_jax_plain_ring(world):
    """ring_attention with the flash body over 4 gloo ranks (N = 4, Tl =
    128, D = 128; the plain kernels on the CPU, each rotation's ids and
    bounds from one all-gather, k and v by P2P both ways) against the JAX
    package's ring_attention(use_flash=False) on 4 devices: every rank's
    block of o and of (dq, dk, dv), rtol/atol 2e-5 (o) and 5e-4 (grads),
    tests/test_ring_attention.py's tolerances."""
    _, by_kind = world
    case, ranks = by_kind["ring"]
    mesh = make_mesh((4,), axis_names=("data",), devices=jax.devices()[:4])

    @jax.jit
    def ring_vjp(q, k, v, g):
        o, vjp = jax.vjp(lambda q, k, v: jax_ring_attention(
            q, k, v, jnp.asarray(case["seg"]), scale=case["scale"], mesh=mesh,
            use_flash=False), q, k, v)
        return o, vjp(g)

    want, want_g = ring_vjp(*(jnp.asarray(case[x]) for x in "qkvg"))
    Tl = 128
    assert sorted(r["index"] for r in ranks) == [0, 1, 2, 3]
    for r in ranks:
        rows = slice(r["index"] * Tl, (r["index"] + 1) * Tl)
        np.testing.assert_allclose(r["o"], np.asarray(want)[:, rows], rtol=2e-5, atol=2e-5)
        for name, g, w in zip(("dq", "dk", "dv"), r["grads"], want_g):
            np.testing.assert_allclose(g, np.asarray(w)[:, rows], rtol=5e-4, atol=5e-4,
                                       err_msg=name)


def test_sp_resume_is_exact(world):
    """sp over 4 ranks: a trainer restored from the pod-sharded save (each
    replicated tensor written once, by seq rank 0) takes the next step
    exactly as the unbroken run does: metrics, parameters and moments bit
    for bit."""
    _, by_kind = world
    _, ranks = by_kind["sp resume"]
    for r in ranks:
        assert r["resumed_at"] == (1, True)
        assert r["resumed"]["metrics"] == r["unbroken"]["metrics"]
        for part in ("params", "mu", "nu"):
            assert r["resumed"][part].keys() == r["unbroken"][part].keys()
            for k, v in r["unbroken"][part].items():
                np.testing.assert_array_equal(r["resumed"][part][k], v, err_msg=k)
    assert sum(len(r["unbroken"]["params"]) for r in ranks[1:]) == 0
    _assemble([r["unbroken"]["params"] for r in ranks], _shapes(SP_CFG))


@pytest.mark.parametrize("mode", ["tp", "fsdp+tp"])
def test_multihost_equals_the_run_without_it(world, mode):
    """The CLI with --multihost on a (2, 2) mesh: data_hosts is the data-axis
    size (2, not the world's 4), the two ranks of a data group build one
    pipeline, and 2 steps end bit for bit where a Trainer without it ends
    when fed the same global rows (losses, parameters, moments)."""
    _, by_kind = world
    _, ranks = by_kind[f"multihost {mode}"]
    for r in ranks:
        assert r["data_hosts"] == 2 and r["steps"] == 2 and r["equal"]
    assert sum(r["n_pieces"] for r in ranks) > 0
    assert ranks[0]["logged"] == ranks[0]["losses"]
