"""The rank program of the port's multi-process tests, and their launcher.

`run_ranks(world, cases, workdir)` starts `world` processes of this file,
one gloo group on a free localhost port, as torchrun would (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), each with one intra-op
thread. Every rank runs every case of `cases` (a list of dicts, pickled to
the workdir) in order inside that one group, and writes what it computed
to `<workdir>/rank<r>.pkl` as numpy arrays; `run_ranks` returns the ranks'
results, one list a rank. Only torch and the port are imported here: the
tests hold the results against the JAX package in the parent process.

Under pytest-xdist the tests of one module may land on several workers,
each with its own module fixture: `shared_workdir` gives them one
directory, and the first `run_ranks` there starts the ranks while the
others wait for its results (the cases are the same: built from seeds).

    python tests/torch_parallel_worker.py CASES.pkl OUT_DIR
"""
import os
import pickle
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shared_workdir(tmp_path_factory, name: str) -> str:
    """A directory that every xdist worker of this session finds under one
    name (a fresh temporary one without xdist)."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return str(tmp_path_factory.mktemp(name))
    path = os.path.join(str(tmp_path_factory.getbasetemp().parent), name)
    os.makedirs(path, exist_ok=True)
    return path


def run_ranks(world: int, cases, workdir, timeout: float = 150.0):
    """Run `cases` on `world` gloo ranks; [rank 0's results, rank 1's, ...]
    (each a list of one dict a case, then {"threads": the rank's intra-op
    thread count}). In a workdir where another process already runs them,
    wait for its results instead."""
    import time

    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    done, failed_file = os.path.join(workdir, "done"), os.path.join(workdir, "failed")
    try:
        os.close(os.open(os.path.join(workdir, "lock"), os.O_CREAT | os.O_EXCL))
    except FileExistsError:
        t0 = time.time()
        while not (os.path.exists(done) or os.path.exists(failed_file)):
            if time.time() - t0 > timeout:
                raise TimeoutError(f"no results in {workdir} after {timeout} s")
            time.sleep(0.2)
        if os.path.exists(failed_file):
            raise RuntimeError(open(failed_file).read())
        return _results(world, workdir)
    try:
        out = _run(world, cases, workdir, timeout)
    except BaseException as e:
        with open(failed_file, "w") as f:
            f.write(str(e))
        raise
    open(done, "w").close()
    return out


def _results(world, workdir):
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _run(world, cases, workdir, timeout):
    case_file = os.path.join(workdir, "cases.pkl")
    with open(case_file, "wb") as f:
        pickle.dump(cases, f)
    port = str(_free_port())
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([os.path.dirname(HERE), HERE,
                                               os.environ.get("PYTHONPATH", "")]))
        log = open(os.path.join(workdir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                        case_file, workdir], env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    failed = []
    try:
        for r, (p, log) in enumerate(procs):
            if p.wait(timeout=timeout) != 0:
                failed.append(r)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        logs = "".join(open(os.path.join(workdir, f"rank{r}.log")).read()[-3000:]
                       for r in failed)
        raise RuntimeError(f"ranks {failed} failed:\n{logs}")
    return _results(world, workdir)


# ---------------------------------------------------------------------------
# The rank side
# ---------------------------------------------------------------------------

def _np(x):
    import torch
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy().copy()
    return x


def _mesh(case):
    """The case's DeviceMesh: its shape over its axes (by default 'data',
    then 'model'; 'stage' for the pipeline's)."""
    from omnibiote_tpu_torch.parallel.mesh import make_mesh
    shape = tuple(case["mesh"])
    return make_mesh(shape, case.get("axes", ("data", "model")[:len(shape)]), device="cpu")


def _trainer(case, mesh, **kw):
    import omnibiote_tpu_torch as port
    from omnibiote_tpu_torch.config import TrainConfig
    from omnibiote_tpu_torch.training.train import Trainer

    cfg = port.OmniBioTAConfig(**case["cfg"])
    tc = TrainConfig(**case["tc"])
    return Trainer(cfg, tc, device="cpu", mesh=mesh, **kw)


def _load_jax_params(tr, flat):
    """Put a full JAX parameter tree ({flat key: array}) into a trainer's
    shards."""
    import torch
    from omnibiote_tpu_torch.utils.convert import nest, state_from_jax_params
    state = state_from_jax_params(nest({k: torch.from_numpy(v) for k, v in flat.items()}),
                                  tr.model_cfg)
    with torch.no_grad():
        for n, p in tr.params.items():
            p.copy_(tr.plan.placements[n].take(state[n]))


def _step(tr, masks=None):
    """One step of the trainer on its staged batch, with explicit global
    masks (A, micro, T) when given."""
    import torch
    batch, weights = next(tr._staged_iter())
    m = tr._train_step(tr.params, tr.opt_state, torch.as_tensor(batch["tokens"]),
                       torch.as_tensor(batch["segments"]), weights, tr.rng, tr.step,
                       masks=None if masks is None else torch.as_tensor(masks))
    tr.step += 1
    return {k: float(v) for k, v in m.items()}, batch


def _pieces(tr):
    """{JAX index key: piece} of the parameters and moments this rank
    writes to a checkpoint (its replica-0 shards, in the JAX layout)."""
    from omnibiote_tpu_torch.training.checkpoint import _shard_pieces
    return {"params": {k: _np(v) for k, v in _shard_pieces(tr, tr.params, lambda k: k).items()},
            "mu": {k: _np(v) for k, v in _shard_pieces(tr, tr.opt_state.mu, lambda k: k).items()},
            "nu": {k: _np(v) for k, v in _shard_pieces(tr, tr.opt_state.nu, lambda k: k).items()}}


def _global_batches(steps):
    """A batch iterator yielding each step's global rows, slot after slot."""
    for s in steps:
        A, micro, T = s["tokens"].shape
        yield {"tokens": s["tokens"].reshape(A * micro, T),
               "segments": s["segments"].reshape(A * micro, T)}


def case_train(case):
    """Steps of a sharded Trainer on the global batches given: from the JAX
    package's parameters where the case has them (else its own seeded
    init), with the case's global masks where its steps have them (else
    the rank's rows of its own global draw); metrics, final pieces, shard
    shapes, and a validation probe on the first micro-batch after them."""
    tr = _trainer(case, _mesh(case), batch_iter=_global_batches(case["steps"]))
    if "params" in case:
        _load_jax_params(tr, case["params"])
    metrics = [_step(tr, s.get("masks"))[0] for s in case["steps"]]
    probe = case["steps"][0]
    return {"metrics": metrics, **_pieces(tr),
            "eval": tr.eval_loss(probe["tokens"][0], probe["segments"][0]),
            "shapes": {n: tuple(p.shape) for n, p in tr.params.items()},
            "mu_shapes": {n: tuple(p.shape) for n, p in tr.opt_state.mu.items()}}


def case_forward(case):
    """Logits of the tensor-parallel model (gathered over 'model') on the
    whole batch, from the JAX package's parameters."""
    import torch
    from torch.func import functional_call
    from omnibiote_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(case["mesh"], ("data", "model"), device="cpu")
    tr = _trainer(case, mesh)
    _load_jax_params(tr, case["params"])
    with torch.no_grad():
        logits = functional_call(tr.model, tr.plan.gather(tr.params),
                                 (torch.as_tensor(case["tokens"]),
                                  torch.as_tensor(case["segments"])))
    return {"logits": _np(logits), "local_heads": tr.model.transformer.h[0].attn.c_attn.weight.shape}


class _CharPieces:
    """A tokenizer stand-in: one id a character."""

    def encode(self, s):
        return [4 + ord(c) % 96 for c in s]


def case_encoder(case):
    """Encoder(mesh=) on every rank against the single-device Encoder."""
    import omnibiote_tpu_torch as port
    from omnibiote_tpu_torch.api import Encoder
    from omnibiote_tpu_torch.parallel.mesh import make_mesh
    from omnibiote_tpu_torch.utils.convert import nest, state_from_jax_params
    import torch
    cfg = port.OmniBioTAConfig(**case["cfg"])
    model = port.OmniBioTA(cfg, device="cpu")
    model.load_state_dict(state_from_jax_params(
        nest({k: torch.from_numpy(v) for k, v in case["params"].items()}), cfg))
    mesh = make_mesh(case["mesh"], device="cpu")
    out = {}
    for method in ("mean", "max"):
        single = Encoder(model, _CharPieces(), device="cpu").encode_sequences(
            case["seqs"], method=method, batch_size=case["batch_size"])
        dp = Encoder(model, _CharPieces(), mesh=mesh).encode_sequences(
            case["seqs"], method=method, batch_size=case["batch_size"])
        out[method] = (single, dp)
    return out


def case_dropout(case):
    """Layer 0's residual and attention keep masks of one training forward
    on this rank's rows, taken where the model draws them."""
    import torch
    from omnibiote_tpu_torch.models import omnibiota
    from omnibiote_tpu_torch.ops import flash_attention as fa
    from omnibiote_tpu_torch.parallel.mesh import make_mesh, shard_batch_pytree
    from omnibiote_tpu_torch.training.mlm import mlm_loss

    mesh = make_mesh(case["mesh"], ("data", "model"), device="cpu")
    tr = _trainer(case, mesh)
    seen = {"resid": [], "attn": []}
    plain_dropout, plain_flash = omnibiota._dropout, fa.flash_attention

    def dropout(x, rate, seed, cols=None):
        if seed is not None and rate > 0:
            seen["resid"].append(_np(plain_dropout(torch.ones_like(x), rate, seed, cols) != 0))
        return plain_dropout(x, rate, seed, cols)

    def flash(q, k, v, *a, seed=0, dropout_rate=0.0, **kw):
        # the mask of the seed the kernels' stream gets
        B, T, H, _ = q.shape
        seen["attn"].append(_np(fa.dropout_keep(seed, dropout_rate, B, H, T, 0, T)))
        return plain_flash(q, k, v, *a, seed=seed, dropout_rate=dropout_rate, **kw)

    omnibiota._dropout, fa.flash_attention = dropout, flash
    try:
        rows = shard_batch_pytree(mesh, {"t": torch.as_tensor(case["tokens"]),
                                         "s": torch.as_tensor(case["segments"])})
        params = {n: p.requires_grad_() for n, p in tr.plan.gather(tr.params).items()}
        mlm_loss(tr.model, rows["t"], rows["s"], 1234, params=params,
                 mask_rows=tr.plan.rows(rows["t"].shape[0]),
                 count_group=tr.plan.data_group)
    finally:
        omnibiota._dropout, fa.flash_attention = plain_dropout, plain_flash
    # the embedding's mask, then per layer resid1 and resid2
    return {"resid1": seen["resid"][1], "attn": seen["attn"][0],
            "n_resid": len(seen["resid"]), "n_attn": len(seen["attn"])}


def case_checkpoint(case):
    """fsdp over every rank, data_hosts = the rank count. (i) Each rank's
    own pipeline: steps, a pod-sharded save, one more step (the unbroken
    run), then fresh trainers restored from the save take that step
    again. (ii) Each rank fed its rows of the given global batches: steps,
    a save, one more step with the given global Bernoulli draw as its
    masks. (iii) A restore of the JAX package's own pod-sharded save."""
    import torch
    import torch.distributed as dist
    from omnibiote_tpu_torch.data.loader import build_pipeline
    from omnibiote_tpu_torch.parallel.mesh import make_mesh
    from omnibiote_tpu_torch.training.checkpoint import restore_into_trainer

    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh(None, device="cpu")
    out = {}

    def pipeline():
        return build_pipeline(case["data"], ["genbank/train"], [1.0],
                              batch_size=case["tc"]["batch_size"],
                              ctx_len=case["tc"]["ctx_len"], seed=3,
                              num_hosts=world, host_id=rank)

    # (i)
    it, states = pipeline()
    tc_i = dict(case["tc"], save_dir=case["tc"]["save_dir"] + "/pipeline")
    tr = _trainer(dict(case, tc=tc_i), mesh, batch_iter=it, reader_states=states,
                  data_hosts=world)
    _load_jax_params(tr, case["params"])
    for _ in range(case["save_at"]):
        _step(tr)
    path = tr.save_checkpoint()
    m, batch = _step(tr)
    out["pipeline"] = {"path": path, "unbroken": {"metrics": m, **_pieces(tr),
                                                  "tokens": batch["tokens"]}}
    it2, states2 = pipeline()
    t2 = _trainer(dict(case, tc=dict(tc_i, seed=7)), mesh, batch_iter=it2,
                  reader_states=states2, data_hosts=world)
    restore_into_trainer(t2, path)
    out["pipeline"]["resumed_at"] = (t2.step, t2.rng == tr.rng)
    m2, batch2 = _step(t2)
    out["pipeline"]["resumed"] = {"metrics": m2, **_pieces(t2), "tokens": batch2["tokens"]}

    # (ii)
    def my_rows(step):
        A, micro, T = step["tokens"].shape
        b = micro // world
        for k in ("tokens", "segments"):
            yield step[k][:, rank * b:(rank + 1) * b].reshape(A * b, T)

    def rows_iter():
        for s in case["steps"]:
            t, g = my_rows(s)
            yield {"tokens": t, "segments": g}

    tr = _trainer(case, mesh, batch_iter=rows_iter(), data_hosts=world)
    _load_jax_params(tr, case["params"])
    for _ in range(case["save_at"]):
        _step(tr)
    path = tr.save_checkpoint()
    out["arrays"] = {"path": path, "saved": _pieces(tr), "rng": tr.rng}
    from omnibiote_tpu_torch.config import EOS_TOKEN, PAD_TOKEN
    masks = torch.as_tensor(case["bern"])
    tok = torch.as_tensor(case["steps"][case["save_at"]]["tokens"])
    m, _ = _step(tr, masks & (tok != PAD_TOKEN) & (tok != EOS_TOKEN))
    out["arrays"]["unbroken"] = {"metrics": m, **_pieces(tr)}

    # (iii)
    t3 = _trainer(case, mesh)
    restore_into_trainer(t3, case["jax_ckpt"])
    out["from_jax"] = {**_pieces(t3), "step": t3.step, "count": t3.opt_state.count,
                       "shapes": {n: tuple(p.shape) for n, p in t3.params.items()}}
    return out


def case_ring(case):
    """ring_attention over the case's seq axis (P2P over gloo), the flash
    body: this rank's block of o and of the gradients of q, k and v under
    the case's cotangent."""
    import torch
    from omnibiote_tpu_torch.ops.ring_attention import ring_attention
    mesh = _mesh(case)
    i, n = mesh.get_local_rank("seq"), mesh.size(0)
    Tl = case["q"].shape[1] // n
    cut = lambda x: torch.as_tensor(x[:, i * Tl:(i + 1) * Tl]).contiguous()
    q, k, v = (cut(case[x]).requires_grad_() for x in "qkv")
    o = ring_attention(q, k, v, cut(case["seg"]), scale=case["scale"], mesh=mesh,
                       use_flash=True)
    grads = torch.autograd.grad(o, (q, k, v), cut(case["g"]))
    return {"index": i, "o": _np(o), "grads": [_np(g) for g in grads]}


def case_resume(case):
    """A trainer on the case's mesh from its seed, drawing its own masks:
    steps, a pod-sharded save, one more step (the unbroken run); then a
    fresh trainer (another seed) restored from the save takes that step."""
    from omnibiote_tpu_torch.training.checkpoint import restore_into_trainer
    mesh, at = _mesh(case), case["save_at"]
    tr = _trainer(case, mesh, batch_iter=_global_batches(case["steps"]))
    for _ in range(at):
        _step(tr)
    path = tr.save_checkpoint()
    m, _ = _step(tr)
    t2 = _trainer(dict(case, tc=dict(case["tc"], seed=case["tc"]["seed"] + 1)), mesh,
                  batch_iter=_global_batches(case["steps"][at:]))
    restore_into_trainer(t2, path)
    resumed_at = (t2.step, t2.rng == tr.rng)
    m2, _ = _step(t2)
    return {"unbroken": {"metrics": m, **_pieces(tr)},
            "resumed": {"metrics": m2, **_pieces(t2)}, "resumed_at": resumed_at,
            "path": path}


def case_multihost(case):
    """The training CLI with --multihost on the case's mesh (a pipeline a
    data group), then the same run without it: a Trainer on the same mesh
    fed the global rows those pipelines make (each slot the data groups'
    rows in data order). Both runs' final pieces, and whether they are
    equal bit for bit."""
    import json

    import numpy as np
    import torch.distributed as dist
    from omnibiote_tpu_torch.data.loader import build_pipeline
    from omnibiote_tpu_torch.parallel.mesh import DATA_AXIS, axis_size
    from omnibiote_tpu_torch.training import cli
    from omnibiote_tpu_torch.training.train import Trainer, choose_mesh

    out_dir = os.path.join(case["workdir"], f"multihost_{case['name']}")
    argv = [*case["argv"], "--save_dir", out_dir, "--device", "cpu",
            "--metrics_jsonl", os.path.join(out_dir, "m.jsonl"), "--log_every", "1"]
    multi = cli.main(argv + ["--multihost"])
    tc, cfg = multi.train_cfg, multi.model_cfg
    mesh = choose_mesh(tc, "cpu")
    n = axis_size(mesh, DATA_AXIS)
    A, micro_l = multi.accum_slots, multi.global_micro // n
    its = [build_pipeline(tc.base_dir, tc.mixture[0], tc.mixture[3],
                          batch_size=tc.batch_size, ctx_len=tc.ctx_len, seed=tc.seed,
                          num_hosts=n, host_id=d)[0] for d in range(n)]

    def global_rows():
        while True:
            parts = [next(it) for it in its]
            yield {k: np.concatenate([p[k][i * micro_l:(i + 1) * micro_l]
                                      for i in range(A) for p in parts])
                   for k in ("tokens", "segments")}

    single = Trainer(cfg, tc, batch_iter=global_rows(), mesh=mesh, device="cpu")
    losses = [float(single.train_step_once()["loss"]) for _ in range(multi.step)]
    a, b = _pieces(multi), _pieces(single)
    equal = all(a[part].keys() == b[part].keys() and all(
        np.array_equal(a[part][k], b[part][k]) for k in a[part]) for part in a)
    dist.barrier()
    logged = []
    if dist.get_rank() == 0:
        with open(os.path.join(out_dir, "m.jsonl")) as f:
            logged = [json.loads(l)["loss"] for l in f if '"loss"' in l]
    return {"equal": equal, "losses": losses, "logged": logged,
            "data_hosts": multi.data_hosts, "steps": multi.step,
            "n_pieces": len(a["params"])}


def case_remat(case):
    """One pass of the pipeline's schedule on the case's mesh (its stage
    axis), from the trainer's seeded parameters and the case's tokens, with
    checkpoint_freq 0 and 1: this rank's loss share and the gradients of
    the compute copy, by name."""
    import torch
    from omnibiote_tpu_torch.parallel.pipeline import pipeline_step
    mesh = _mesh(case)
    tokens, segments = torch.as_tensor(case["tokens"]), torch.as_tensor(case["segments"])
    out = {}
    for freq in (0, 1):
        tr = _trainer(dict(case, cfg=dict(case["cfg"], checkpoint_freq=freq)), mesh)
        params = {n: p.detach().clone().requires_grad_() for n, p in tr.params.items()}
        loss, masked, _ = pipeline_step(tr.model, tr.plan.stage, params, tokens, segments,
                                        [1.0] * len(tokens), case["seeds"])
        out[freq] = {"loss": float(loss), "masked": float(masked),
                     "grads": {n: _np(p.grad) for n, p in params.items()
                               if p.grad is not None}}
    return out


CASES = {"train": case_train, "forward": case_forward, "encoder": case_encoder,
         "dropout": case_dropout, "checkpoint": case_checkpoint, "ring": case_ring,
         "resume": case_resume, "multihost": case_multihost, "remat": case_remat}


def main(case_file, out_dir):
    import datetime

    import torch_threads  # noqa: F401  (one intra-op thread)
    import torch.distributed as dist
    from omnibiote_tpu_torch.parallel.mesh import init_distributed

    # every wait of the group (the ring's P2P included: it runs on this
    # group) fails after 120 s instead of hanging the run
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=120))
    init_distributed("cpu")
    with open(case_file, "rb") as f:
        cases = pickle.load(f)
    import torch
    results = [CASES[c["kind"]](c) for c in cases]
    results.append({"threads": torch.get_num_threads()})
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
