"""The pod-sharded checkpoint on a mesh, between the port and the JAX
package: one gloo group of 2 ranks (tests/torch_parallel_worker.py) runs
fsdp with data_hosts = 2.

  * each rank on its own pipeline (its stripe of the shard files): a
    pod-sharded save, then fresh trainers restored from it take the next
    step exactly as the unbroken run does, rows, masks and all;
  * each rank fed its rows of known global batches: the JAX package's
    `restore_into_trainer` reads the port's save, holds its parameters and
    moments bit for bit, and its next step (masks from the restored seed)
    matches the port's unbroken step, rtol 1e-4 / atol 1e-5;
  * the JAX package's own pod-sharded save (`_save_checkpoint_multiproc`)
    restores into the port's ranks bit for bit.

Sizes as tests/test_torch_parallel.py: 2 layers, d 256, 2 heads of 128,
vocab 128, T 128, 2 rows a rank, A = 2, fp32, dropout 0, dense attention.
"""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import omnibiote_tpu as obt
from omnibiote_tpu.ops.segments import segment_ids_np
from omnibiote_tpu.parallel.mesh import make_mesh
from omnibiote_tpu.training import checkpoint as jax_ckpt
from omnibiote_tpu.training import train as jax_train

from omnibiote_tpu_torch.utils.convert import flatten_tree
from test_torch_parallel import ATOL, CFG, RTOL, T, _assemble, _rows, _shapes
from torch_parallel_worker import run_ranks, shared_workdir

MINI, A, RANKS, SAVE_AT, SEED = 2, 2, 2, 2, 4
MICRO = MINI * RANKS
TC = dict(batch_size=A * MICRO, mini_batch_size=MINI, ctx_len=T, lr=1e-2,
          token_budget=1e6, seed=SEED, sharding="fsdp")


def _jax_trainer(save_dir, batches=()):
    mesh = make_mesh((RANKS,), axis_names=("data",), devices=jax.devices()[:RANKS])

    def rows():
        for b in batches:
            yield {k: b[k].reshape(A * MICRO, T) for k in ("tokens", "segments")}

    return jax_train.Trainer(obt.OmniBioTAConfig(**CFG),
                             obt.TrainConfig(**TC, save_dir=str(save_dir)),
                             batch_iter=rows(), mesh=mesh)


def _write_shards(root, rng):
    d = os.path.join(root, "genbank", "train")
    os.makedirs(d)
    for f in range(4):
        toks = []
        for _ in range(120):
            seq = rng.integers(20, 128, size=int(rng.integers(5, 60)))
            seq[-1] = obt.EOS_TOKEN
            toks.extend(seq.tolist())
        np.save(os.path.join(d, f"s{f}.npy"), np.asarray(toks, np.int32))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    rng = np.random.default_rng(SEED)
    _write_shards(str(root / "data"), rng)
    steps = []
    for _ in range(SAVE_AT + 1):
        toks = np.stack([_rows(MICRO, rng) for _ in range(A)])
        steps.append({"tokens": toks,
                      "segments": np.stack([segment_ids_np(t) for t in toks])})
    # the JAX Trainer's initial parameters start every port trainer
    src = _jax_trainer(root / "jax", steps)
    params = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(src.params)).items()}
    # the JAX package's own pod-sharded save, after one step
    src.train_step_once()
    jpath = str(root / "jax" / "pod")
    os.makedirs(jpath + ".tmp")
    jax_ckpt._save_checkpoint_multiproc(src, jpath, jpath + ".tmp", final=False)
    # the masks the JAX Trainer will draw at step SAVE_AT from the port's
    # seed (restored as a raw key): Bernoulli draws for the global batch
    port_rng = int(np.random.SeedSequence(SEED).generate_state(2, np.uint64)[0])
    raw = jnp.asarray([port_rng & 0xFFFFFFFF, port_rng >> 32], jnp.uint32)
    bern = np.stack([np.asarray(jax.random.bernoulli(
        jax.random.split(jax.random.fold_in(jax.random.fold_in(raw, SAVE_AT), i))[0],
        0.15, (MICRO, T))) for i in range(A)])
    case = {"kind": "checkpoint", "cfg": CFG, "tc": dict(TC, save_dir=str(root / "port")),
            "params": params, "steps": steps, "save_at": SAVE_AT, "bern": bern,
            "data": str(root / "data"), "jax_ckpt": jpath}
    ranks = [r[0] for r in run_ranks(
        RANKS, [case], shared_workdir(tmp_path_factory, "torch_parallel_checkpoint_ranks"))]
    return {"ranks": ranks, "steps": steps, "src": src, "root": root}


def test_pod_sharded_resume_is_exact(run):
    """Per-rank pipelines: the save holds a shard file a rank and a reader
    state file a rank; the restored trainers stand at the saved step with
    the saved seed and take the next step on the same rows with the same
    loss, parameters and moments, bit for bit."""
    ranks = run["ranks"]
    path = ranks[0]["pipeline"]["path"]
    assert sorted(os.path.basename(f) for f in glob.glob(os.path.join(path, "*"))) == [
        "meta.json", "opt_state.shard0.npz", "opt_state.shard1.npz",
        "params.shard0.npz", "params.shard1.npz",
        "reader_states.proc0.json", "reader_states.proc1.json"]
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert (meta["step"], meta["data_hosts"], meta["sharded"]) == (SAVE_AT, RANKS, True)
    states = [json.load(open(os.path.join(path, f"reader_states.proc{r}.json")))
              for r in range(RANKS)]
    assert states[0] != states[1]
    for r in ranks:
        p = r["pipeline"]
        assert p["resumed_at"] == (SAVE_AT, True)
        assert p["resumed"]["metrics"] == p["unbroken"]["metrics"]
        np.testing.assert_array_equal(p["resumed"]["tokens"], p["unbroken"]["tokens"])
        for part in ("params", "mu", "nu"):
            assert p["resumed"][part].keys() == p["unbroken"][part].keys()
            for k, v in p["unbroken"][part].items():
                np.testing.assert_array_equal(p["resumed"][part][k], v, err_msg=k)
    assert not np.array_equal(ranks[0]["pipeline"]["unbroken"]["tokens"],
                              ranks[1]["pipeline"]["unbroken"]["tokens"])


def test_jax_restores_the_port_checkpoint(run):
    """The JAX Trainer (fsdp over 2 virtual devices) restores the port's
    pod-sharded save bit for bit, and its next step, fed the same global
    rows, matches the port's unbroken step."""
    ranks = run["ranks"]
    shapes = _shapes(CFG)
    jt = _jax_trainer(run["root"] / "jax2", run["steps"][SAVE_AT:])
    jt.restore_checkpoint(ranks[0]["arrays"]["path"])
    assert jt.step == SAVE_AT
    saved = {part: _assemble([r["arrays"]["saved"][part] for r in ranks], shapes)
             for part in ("params", "mu", "nu")}
    got = flatten_tree(jax.device_get(jt.params))
    for k in shapes:
        np.testing.assert_array_equal(np.asarray(got[k]), saved["params"][k], err_msg=k)
    leaves = jax.tree.leaves(jt.opt_state)
    n = len(shapes)
    for i, k in enumerate(sorted(shapes)):
        np.testing.assert_array_equal(np.asarray(leaves[2 + i]), saved["mu"][k])
        np.testing.assert_array_equal(np.asarray(leaves[2 + n + i]), saved["nu"][k])
    jm = jt.train_step_once()
    for r in ranks:
        pm = r["arrays"]["unbroken"]["metrics"]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(pm[k], float(jm[k]), rtol=RTOL, atol=ATOL, err_msg=k)
        assert pm["masked_tokens"] == float(jm["masked_tokens"])
    after = _assemble([r["arrays"]["unbroken"]["params"] for r in ranks], shapes)
    got = flatten_tree(jax.device_get(jt.params))
    for k in shapes:
        np.testing.assert_allclose(after[k], np.asarray(got[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_port_restores_the_jax_checkpoint(run):
    """The JAX package's pod-sharded save (a process's shards of both
    devices in one file) restores into the port's 2 fsdp ranks: each holds
    half of every leaf, and the pieces they would write back equal the JAX
    state bit for bit."""
    ranks, src = run["ranks"], run["src"]
    shapes = _shapes(CFG)
    got = {part: _assemble([r["from_jax"][part] for r in ranks], shapes)
           for part in ("params", "mu", "nu")}
    want = flatten_tree(jax.device_get(src.params))
    leaves = jax.tree.leaves(src.opt_state)
    n = len(shapes)
    for i, k in enumerate(sorted(shapes)):
        np.testing.assert_array_equal(got["params"][k], np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(got["mu"][k], np.asarray(leaves[2 + i]))
        np.testing.assert_array_equal(got["nu"][k], np.asarray(leaves[2 + n + i]))
    for r in ranks:
        assert (r["from_jax"]["step"], r["from_jax"]["count"]) == (1, 1)
        assert sum(int(np.prod(s)) for s in r["from_jax"]["shapes"].values()) * RANKS == \
            sum(int(np.prod(s)) for s in shapes.values())
