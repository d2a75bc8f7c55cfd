"""PyTorch port vs the JAX package: the pipeline (parallel/pipeline.py, the
'pp', dp x pp and 'fsdp+pp' Trainer) over torch.distributed (gloo) against
the JAX pp Trainer on the 8-device virtual CPU mesh (jitted).

One group of 4 ranks (tests/torch_parallel_worker.py, one intra-op thread
each) runs every case; the tests hold what the ranks computed:

  * pp (4,) with L = 4 and A = 4 (head balance: each stage computes the CE
    of its slot), pp (4,) with A = 3 (the last stage computes all of it),
    dp x pp (2, 2) and fsdp+pp (2, 2): 2 steps, dropout 0, fp32,
    attn_impl 'xla', from the JAX pp Trainer's initial parameters with
    its MLM masks handed in, against that Trainer on the same mesh shape;
  * pp (4,) at dropout 0.1 drawing its own masks, and a batch-ramp run
    whose first steps leave slots inactive, against the port's
    single-process Trainer, and a validation probe;
  * one pass of the schedule with checkpoint_freq 1 against 0;
  * resume under pp (4,) and fsdp+pp (2, 2), bit for bit, and a pp
    checkpoint resumed by the single-process Trainer;
  * --multihost under dp x pp (2, 2) through the CLI, bit for bit equal to
    the run without it.

No case runs a Pallas body of the JAX package under a multi-shard
shard_map (its interpreter can deadlock on a few cores): the JAX Trainers
here run the plain attention. Small size: L 4, d 64, 2 heads of 32, vocab
128, T 64, 2 rows a data rank. The parameters are held through the pieces
each rank writes to a checkpoint, assembled here, so the assembly also
checks that the stages' pieces partition every leaf.
"""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import omnibiote_tpu as obt
from omnibiote_tpu.ops.segments import segment_ids_np
from omnibiote_tpu.parallel.mesh import make_mesh
from omnibiote_tpu.training import mlm as jax_mlm
from omnibiote_tpu.training import train as jax_train

from omnibiote_tpu_torch.utils.convert import flatten_tree
from torch_parallel_worker import run_ranks, shared_workdir

CFG = dict(n_layer=4, n_embd=64, n_head=2, vocab_size=128, block_size=64,
           dropout=0.0, compute_dtype="float32", param_dtype="float32",
           attn_impl="xla")
MINI, T = 2, 64
RTOL, ATOL = 1e-4, 1e-5     # tests/test_training.py:455
JAX_RUNS = {  # name: (mode, mesh shape, axes, slots A)
    "pp (4,), head balance": ("pp", (4,), ("stage",), 4),
    "pp (4,), last-stage readout": ("pp", (4,), ("stage",), 3),
    "dp x pp (2, 2)": ("pp", (2, 2), ("data", "stage"), 2),
    "fsdp+pp (2, 2)": ("fsdp+pp", (2, 2), ("data", "stage"), 2),
}


def _rows(n, rng):
    """Rows where token t+1 follows t inside EOS-delimited segments."""
    out = []
    for _ in range(n):
        row = []
        while len(row) < T:
            start = int(rng.integers(4, CFG["vocab_size"] - 12))
            row.extend(range(start, start + int(rng.integers(4, 10))))
            row.append(obt.EOS_TOKEN)
        out.append(row[:T])
    return np.asarray(out, np.int32)


def _steps(n_steps, A, micro, rng):
    steps = []
    for _ in range(n_steps):
        toks = np.stack([_rows(micro, rng) for _ in range(A)])
        steps.append({"tokens": toks, "segments": np.stack([segment_ids_np(t) for t in toks])})
    return steps


def _jax_case(name, seed):
    """A JAX pp Trainer on the first virtual devices and the port's case:
    its initial parameters, global batches and the MLM masks its steps
    draw (the pp step's keys are the dp step's)."""
    mode, shape, axes, A = JAX_RUNS[name]
    n = int(np.prod(shape))
    mesh = make_mesh(shape, axis_names=axes, devices=jax.devices()[:n])
    micro = MINI * dict(zip(axes, shape)).get("data", 1)
    steps = _steps(2, A, micro, np.random.default_rng(seed))
    tc = dict(batch_size=A * micro, mini_batch_size=MINI, ctx_len=T, lr=1e-2,
              token_budget=1e6, seed=seed, sharding=mode, mesh_shape=shape)
    rows = ({"tokens": s["tokens"].reshape(A * micro, T),
             "segments": s["segments"].reshape(A * micro, T)} for s in steps)
    jt = jax_train.Trainer(obt.OmniBioTAConfig(**CFG), obt.TrainConfig(**tc),
                           batch_iter=rows, mesh=mesh)
    assert jt.global_micro == micro and jt.accum_slots == A
    for s, step in enumerate(steps):
        step["masks"] = np.stack([np.asarray(jax_mlm.make_mlm_mask(
            jax.random.split(jax.random.fold_in(jax.random.fold_in(jt.rng, s), i))[0],
            jnp.asarray(step["tokens"][i]), 0.15)) for i in range(A)])
    params = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jt.params)).items()}
    return jt, {"kind": "train", "name": name, "mesh": shape, "axes": axes, "cfg": CFG,
                "tc": tc, "params": params, "steps": steps}


def _drawn_case(name, seed, kind="train", mesh=(4,), axes=("stage",), A=4,
                cfg_kw=None, **tc_kw):
    """A case whose ranks init from the seed and draw their own masks
    (dropout 0.1 unless cfg_kw says otherwise)."""
    micro = MINI * dict(zip(axes, mesh)).get("data", 1)
    tc = dict(batch_size=A * micro, mini_batch_size=MINI, ctx_len=T, lr=1e-2,
              token_budget=1e6, seed=seed, sharding="pp", mesh_shape=mesh)
    tc.update(tc_kw)
    return {"kind": kind, "name": name, "mesh": mesh, "axes": axes,
            "cfg": dict(CFG, dropout=0.1, **(cfg_kw or {})), "tc": tc, "micro": micro,
            "steps": _steps(2, A, micro, np.random.default_rng(seed))}


def _write_shards(root, rng, n_files=2, n_seq=150):
    """Token shards of genbank/train and genbank/val, each file put in
    place whole (another xdist worker may write the same seeded files)."""
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


def _shapes(cfg_kw):
    import omnibiote_tpu_torch as port
    from omnibiote_tpu_torch.parallel.sharding import jax_leaf_shapes
    return jax_leaf_shapes(port.OmniBioTAConfig(**cfg_kw))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX pp Trainers and inputs, then one 4-rank gloo run of every
    case."""
    workdir = shared_workdir(tmp_path_factory, "torch_pipeline_ranks")
    trainers, cases = {}, []
    for name in JAX_RUNS:
        jt, case = _jax_case(name, seed=len(cases))
        trainers[name] = jt
        cases.append(case)
    cases.append(_drawn_case("pp (4,), dropout 0.1", seed=len(cases)))
    # 512 tokens a step, 4 steps in all, the ramp over the first 2: step 0
    # has 1 active slot of 4, step 1 has 3
    cases.append(_drawn_case("pp (4,), batch ramp", seed=len(cases), batch_ramp=True,
                             token_budget=4 * 4 * MINI * T, warmup_period=0.5))
    remat = _drawn_case("remat", seed=len(cases), kind="remat")
    step = remat.pop("steps")[0]
    remat.update(tokens=step["tokens"], segments=step["segments"],
                 seeds=[int(x) for x in np.random.default_rng(5).integers(0, 2**62, 4)])
    cases.append(remat)
    for name, mesh, axes, mode in (("pp resume", (4,), ("stage",), "pp"),
                                   ("fsdp+pp resume", (2, 2), ("data", "stage"), "fsdp+pp")):
        case = _drawn_case(name, seed=len(cases), kind="resume", mesh=mesh, axes=axes,
                           A=2, sharding=mode,
                           save_dir=os.path.join(workdir, name.replace(" ", "_")))
        cases.append(dict(case, save_at=1))
    data = os.path.join(workdir, "multihost_data")
    _write_shards(data, np.random.default_rng(12))
    argv = ["--base_dir", data, "--train_type", "nucleotide", "--n_layer", "2",
            "--n_embd", "64", "--n_head", "2", "--ctx_len", "64",
            "--mini_batch_size", "2", "--batch_size", "8", "--max_steps", "2",
            "--test_freq", "1e12", "--seed", "3", "--sharding", "pp",
            "--mesh_shape", "2", "2"]
    cases.append({"kind": "multihost", "name": "multihost dp x pp", "argv": argv,
                  "workdir": workdir})
    out = run_ranks(4, cases, workdir)
    by_name = {case["name"]: (case, [ranks[i] for ranks in out])
               for i, case in enumerate(cases)}
    return trainers, by_name


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_pp_steps_match_jax(world, name):
    """Two steps from the JAX pp Trainer's parameters with its masks: loss,
    grad norm and token counts a step, then every parameter and Adam
    moment, against the JAX pp Trainer on the same mesh shape, rtol 1e-4 /
    atol 1e-5. A stage holds its own layers' blocks only (and under
    fsdp+pp its half of every tensor, the moments alike)."""
    trainers, by_name = world
    jt = trainers[name]
    case, ranks = by_name[name]
    for s in range(2):
        jm = jt.train_step_once()
        for r in ranks:
            pm = r["metrics"][s]
            np.testing.assert_allclose(pm["loss"], float(jm["loss"]), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(pm["grad_norm"], float(jm["grad_norm"]),
                                       rtol=RTOL, atol=ATOL)
            assert pm["masked_tokens"] == float(jm["masked_tokens"])
            assert pm["num_tokens"] == float(jm["num_tokens"])
    shapes = _shapes(CFG)
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
    import omnibiote_tpu_torch as port
    from omnibiote_tpu_torch.utils.convert import torch_leaf_map
    leaf_map = torch_leaf_map(port.OmniBioTAConfig(**CFG))
    n_stage = case["mesh"][-1]
    for rank, r in enumerate(ranks):
        stage = rank % n_stage
        held = {n for n, (_, layer, _, _) in leaf_map.items()
                if layer is None or layer // (CFG["n_layer"] // n_stage) == stage}
        assert set(r["shapes"]) == held
        assert r["mu_shapes"] == r["shapes"]
        if case["tc"]["sharding"] == "fsdp+pp":
            for name_, shape in r["shapes"].items():
                assert int(np.prod(shape)) * 2 == int(np.prod(leaf_map[name_][3])), name_


@pytest.mark.parametrize("name", ["pp (4,), dropout 0.1", "pp (4,), batch ramp"])
def test_pp_matches_the_single_device_trainer(world, name):
    """pp over 4 stages at dropout 0.1, drawing its MLM masks and dropout
    masks itself (the layer seeds at their global indices): two steps
    equal the port's single-process Trainer on the same seed and batches
    (loss, grad norm and token counts a step, then every parameter, rtol
    1e-4 / atol 1e-5), and so does a validation probe through the
    schedule's forward. 'batch ramp': step 0 has one active slot of 4 and
    step 1 three; the schedule skips the others."""
    import omnibiote_tpu_torch as port
    from omnibiote_tpu_torch.config import TrainConfig
    from omnibiote_tpu_torch.training.train import Trainer
    from omnibiote_tpu_torch.utils.convert import jax_params_from_state
    from torch_parallel_worker import _global_batches
    _, by_name = world
    case, ranks = by_name[name]
    tc = dict(case["tc"], sharding="replicated", mesh_shape=None,
              mini_batch_size=case["micro"])
    cfg = port.OmniBioTAConfig(**case["cfg"])
    with Trainer(cfg, TrainConfig(**tc), batch_iter=_global_batches(case["steps"]),
                 device="cpu") as tr:
        assert tr.plan is None
        for s in range(2):
            m = {k: float(v) for k, v in tr.train_step_once().items()}
            for r in ranks:
                pm = r["metrics"][s]
                np.testing.assert_allclose(pm["loss"], m["loss"], rtol=RTOL, atol=ATOL)
                np.testing.assert_allclose(pm["grad_norm"], m["grad_norm"],
                                           rtol=RTOL, atol=ATOL)
                assert pm["masked_tokens"] == m["masked_tokens"]
                assert pm["num_tokens"] == m["num_tokens"]
        if "ramp" in name:
            assert [r["metrics"][0]["num_tokens"] for r in ranks] == [MINI * T] * 4
        probe = case["steps"][0]
        want_eval = tr.eval_loss(probe["tokens"][0], probe["segments"][0])
        state = {n: p.detach() for n, p in tr.params.items()}
    want = {k: v.numpy() for k, v in flatten_tree(jax_params_from_state(state, cfg)).items()}
    got = _assemble([r["params"] for r in ranks], _shapes(case["cfg"]))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    for r in ranks:
        np.testing.assert_allclose(r["eval"], want_eval, rtol=RTOL, atol=ATOL)


def test_pp_remat_changes_nothing(world):
    """One pass of the schedule over 4 stages at dropout 0.1 with each
    stage's slice of layers rematerialised (checkpoint_freq 1) and
    without: every stage's loss share, masked count and gradients the
    same, bit for bit."""
    _, by_name = world
    _, ranks = by_name["remat"]
    assert sum(r[0]["loss"] for r in ranks) > 0
    for r in ranks:
        assert r[1]["loss"] == r[0]["loss"] and r[1]["masked"] == r[0]["masked"]
        assert r[1]["grads"].keys() == r[0]["grads"].keys()
        for n, g in r[0]["grads"].items():
            np.testing.assert_array_equal(r[1]["grads"][n], g, err_msg=n)


@pytest.mark.parametrize("name", ["pp resume", "fsdp+pp resume"])
def test_pp_resume_is_exact(world, name):
    """pp (4,) and fsdp+pp (2, 2): a trainer restored from the pod-sharded
    save (every stage writing its own layers, stage 0 the tensors all
    stages hold) takes the next step exactly as the unbroken run does:
    metrics, parameters and moments bit for bit."""
    _, by_name = world
    case, ranks = by_name[name]
    for r in ranks:
        assert r["resumed_at"] == (1, True)
        assert r["resumed"]["metrics"] == r["unbroken"]["metrics"]
        for part in ("params", "mu", "nu"):
            assert r["resumed"][part].keys() == r["unbroken"][part].keys()
            for k, v in r["unbroken"][part].items():
                np.testing.assert_array_equal(r["resumed"][part][k], v, err_msg=k)
    _assemble([r["unbroken"]["params"] for r in ranks], _shapes(case["cfg"]))


def test_pp_checkpoint_resumes_the_single_device_trainer(world):
    """The pp (4,) save, read by the port's single-process Trainer, takes
    the step the pipeline took after it: the same metrics and parameters
    (rtol 1e-4 / atol 1e-5)."""
    import omnibiote_tpu_torch as port
    from omnibiote_tpu_torch.config import TrainConfig
    from omnibiote_tpu_torch.training.train import Trainer
    from omnibiote_tpu_torch.utils.convert import jax_params_from_state
    from torch_parallel_worker import _global_batches
    _, by_name = world
    case, ranks = by_name["pp resume"]
    tc = dict(case["tc"], sharding="replicated", mesh_shape=None, seed=99,
              mini_batch_size=case["micro"])
    cfg = port.OmniBioTAConfig(**case["cfg"])
    with Trainer(cfg, TrainConfig(**tc), batch_iter=_global_batches(case["steps"][1:]),
                 device="cpu") as tr:
        tr.restore_checkpoint(ranks[0]["path"])
        assert tr.step == 1
        m = {k: float(v) for k, v in tr.train_step_once().items()}
        state = {n: p.detach() for n, p in tr.params.items()}
    for k, v in ranks[0]["unbroken"]["metrics"].items():
        np.testing.assert_allclose(m[k], v, rtol=RTOL, atol=ATOL, err_msg=k)
    want = {k: v.numpy() for k, v in flatten_tree(jax_params_from_state(state, cfg)).items()}
    got = _assemble([r["unbroken"]["params"] for r in ranks], _shapes(case["cfg"]))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_multihost_dp_x_pp_equals_the_run_without_it(world):
    """The CLI with --sharding pp --mesh_shape 2 2 --multihost: data_hosts
    is the data-axis size, the two stages of a data group build one
    pipeline, and 2 steps end bit for bit where a Trainer without it ends
    when fed the same global rows (losses, parameters, moments). Only data
    rank 0's stages (ranks 0 and 1) write checkpoint pieces."""
    _, by_name = world
    _, ranks = by_name["multihost dp x pp"]
    for r in ranks:
        assert r["data_hosts"] == 2 and r["steps"] == 2 and r["equal"]
    assert [r["n_pieces"] > 0 for r in ranks] == [True, True, False, False]
    assert ranks[0]["logged"] == ranks[0]["losses"]
