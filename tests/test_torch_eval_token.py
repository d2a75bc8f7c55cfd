"""PyTorch port vs the JAX package: the token-level / single-target engine
(`evals/token_finetune.py`).

`finetune_token_task` with a frozen backbone (the default) and with
`train_backbone=True`, single-target and per-token, MSE and CE, then
`evaluate_token_task`, on one checkpoint written by the JAX Trainer (fp32,
dense attention, dropout 0) and one synthetic protein fixture aligned by
`evals/alignment.py`. The port's head is the JAX head (injected). Held:
the per-step losses (rtol 1e-4), the val-metric history and the test
metric (1e-6), the final head and, when it trains, the backbone (max
|d| <= 0.05·lr·k at the parameter's group LR), and the frozen embeddings
(rtol 2e-4, atol 2e-5). Then one learnability check at the JAX TAPE test's
bar (per-residue accuracy > 0.36 on three classes).
"""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import jax
import numpy as np
import pytest
import torch

from omnibiote_tpu.evals import alignment as jalignment
from omnibiote_tpu.evals import token_finetune as jtoken
from omnibiote_tpu.training.checkpoint import load_model_checkpoint as jax_load
from omnibiote_tpu_torch.evals import alignment, token_finetune
from omnibiote_tpu_torch.evals.metrics import accuracy_score
from omnibiote_tpu_torch.ops import _kernels
from omnibiote_tpu_torch.tokenizer import SentencePieceProcessor
from omnibiote_tpu_torch.training.checkpoint import load_model_checkpoint
from scipy.stats import spearmanr

from test_torch_eval_common import (
    ATOL, LOSS_RTOL, METRIC_ATOL, RTOL, assert_trees_close, banned, jax_head_injector,
    make_checkpoint, make_tokenizer)
from test_torch_eval_engine import group_tol, port_tree


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("token")
    return (make_checkpoint(root, block_size=1024),
            SentencePieceProcessor(make_tokenizer(root)))


def protein(rng, y, n=24):
    """Class-dependent composition (the JAX TAPE test's fixture)."""
    main = "W" if y else "A"
    return "".join(rng.choice([main] * 3 + list("MKVLGI"), size=n))


def split(sp, n, seed, single_target, is_mse):
    rng = np.random.default_rng(seed)
    seqs = [protein(rng, i % 2, n=int(rng.integers(12, 40))) for i in range(n)]
    prefix = [t for t in sp.encode("<protein>") if t not in banned(sp)]
    if single_target:
        ys = [float(i % 2) * 2.0 + 0.1 if is_mse else i % 2 for i in range(n)]
        align = alignment.align_single
    else:
        ys = [[(0 if c == "A" else 1 if c == "W" else 2) for c in s] for s in seqs]
        if is_mse:
            ys = [[v / 2.0 for v in y] for y in ys]
        align = alignment.align_labels_mean if is_mse else alignment.align_labels_mode
    X, Y = alignment.process_split(sp, seqs, ys, align, prefix, banned(sp))
    jalign = getattr(jalignment, align.__name__)
    assert (X, Y) == jalignment.process_split(sp, seqs, ys, jalign, prefix, banned(sp))
    return X, Y


def metric_for(is_mse):
    return (lambda y, p: spearmanr(y, p)[0]) if is_mse else accuracy_score


CASES = [
    # (single_target, is_mse, train_backbone, accumulation steps)
    (True, True, False, 1),
    (True, False, False, 2),
    (False, False, False, 1),
    (False, True, False, 1),
    (False, False, True, 2),
    (True, True, True, 1),
]


@pytest.mark.parametrize("single_target,is_mse,train_backbone,accum", CASES,
                         ids=[f"{'single' if s else 'token'}-{'mse' if m else 'ce'}-"
                              f"{'backbone' if b else 'frozen'}-A{a}" for s, m, b, a in CASES])
def test_finetune_token_task_matches_jax(setup, monkeypatch, single_target, is_mse,
                                         train_backbone, accum):
    ckpt, sp = setup
    data = {"train": split(sp, 12, 0, single_target, is_mse),
            "val": split(sp, 6, 1, single_target, is_mse)}
    X_test, Y_test = split(sp, 6, 2, single_target, is_mse)
    kw = dict(loss_str="mse" if is_mse else "cross_entropy", metric_fn=metric_for(is_mse),
              single_target=single_target, num_epochs=2, batch_size=4,
              num_accumulation_steps=accum, lr=1e-3, embed_lr=1e-2, head_lr=1e-2,
              seed=4, train_backbone=train_backbone)
    k = 2 * 12 // (4 * accum)
    ekw = dict(metric_fn=metric_for(is_mse), single_target=single_target,
               is_mse=is_mse, batch_size=4)

    jparams, jcfg = jax_load(ckpt)
    jlog, plog = [], []
    jm, jh, jinfo = jtoken.finetune_token_task(jparams, jcfg, data, log=jlog.append, **kw)
    jtest = jtoken.evaluate_token_task(jm, jh, jcfg, X_test, Y_test, **ekw)

    jax_head_injector(monkeypatch, token_finetune, split=True)
    model, cfg = load_model_checkpoint(ckpt, device="cpu")
    before = port_tree(model)
    pm, ph, pinfo = token_finetune.finetune_token_task(model, cfg, data, log=plog.append, **kw)
    ptest = token_finetune.evaluate_token_task(pm, ph, cfg, X_test, Y_test, **ekw)

    assert [r["step"] for r in plog] == [r["step"] for r in jlog]
    assert sum("loss" in r for r in plog) == k
    for p, j in zip(plog, jlog):
        if "loss" in j:
            np.testing.assert_allclose(p["loss"], j["loss"], rtol=LOSS_RTOL)
        else:
            assert abs(p["val_metric"] - j["val_metric"]) <= METRIC_ATOL, (p, j)
    assert abs(pinfo["best_val"] - jinfo["best_val"]) <= METRIC_ATOL
    assert abs(ptest - jtest) <= METRIC_ATOL, (ptest, jtest)
    got, want = port_tree(pm, ph), jax.tree.map(np.asarray, {"model": jm, "head": jh})
    assert_trees_close(got, want, group_tol(k, kw["lr"], kw["embed_lr"], kw["head_lr"]))
    if not train_backbone:
        assert pm is model   # frozen: the backbone handed back as it came
        assert_trees_close(got["model"], before["model"], 0.0)


def test_frozen_embeddings_match_jax_and_launch_no_backward(setup):
    ckpt, sp = setup
    X, _ = split(sp, 7, 3, False, False)
    X[0] = X[0] * 60   # over MAX_TOKENS: cut at 1024 by both
    jparams, jcfg = jax_load(ckpt)
    model, cfg = load_model_checkpoint(ckpt, device="cpu")
    want = jtoken._batched_embeddings(jparams, jcfg, X, 3, 128)
    got = token_finetune._batched_embeddings(model, cfg, X, 3, 128)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert got[0].shape[0] == token_finetune.MAX_TOKENS
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    # the frozen fine-tune builds no autograd graph through the model
    data = {"train": split(sp, 8, 0, True, False), "val": split(sp, 4, 1, True, False)}
    before = dict(_kernels.LAUNCHES)
    token_finetune.finetune_token_task(model, cfg, data, loss_str="cross_entropy",
                                       metric_fn=accuracy_score, single_target=True,
                                       num_epochs=1, batch_size=4)
    assert all(p.grad is None for p in model.parameters())
    assert _kernels.LAUNCHES == before   # CPU tensors: the plain versions only


def test_token_task_learns_composition(setup):
    """The JAX TAPE test's bar (tests/test_evals_tape_pglue.py): a frozen
    backbone's linear probe beats 3-class chance (> 0.36), port alone."""
    ckpt, sp = setup
    model, cfg = load_model_checkpoint(ckpt, device="cpu")
    data = {"train": split(sp, 32, 0, False, False), "val": split(sp, 8, 1, False, False)}
    pm, ph, _ = token_finetune.finetune_token_task(
        model, cfg, data, loss_str="cross_entropy", metric_fn=accuracy_score,
        num_epochs=4, batch_size=8, seed=0)
    X, Y = split(sp, 16, 2, False, False)
    acc = token_finetune.evaluate_token_task(pm, ph, cfg, X, Y,
                                             metric_fn=accuracy_score, batch_size=8)
    assert acc > 0.36, acc
