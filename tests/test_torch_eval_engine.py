"""PyTorch port vs the JAX package: the sequence-classification engine
(`evals/engine.py`): `finetune_classifier` and `domain_mlm_pretrain`.

Both packages load one checkpoint written by the JAX Trainer (2 layers,
d 64, 2 heads, vocab 2^16, fp32, dense attention, dropout 0), see the same
token lists and, through `numpy.random.default_rng(seed)` drawn in the same
order, the same batches and MLM masks; the port's head is the JAX head
(injected through the new head converter). Held: the per-step losses
(rtol 1e-4), the val metrics and the returned metrics (1e-6), the val
predictions (equal), the final parameters (max |d| <= 0.05·lr·k for k
optimizer steps at the parameter's group LR) and the predict logits
(rtol 2e-4, atol 2e-5). Then one learnability check at the JAX GUE test's
bar (MCC > 0.3).
"""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import jax
import numpy as np
import pytest
import torch

from omnibiote_tpu.evals import engine as jengine
from omnibiote_tpu.training.checkpoint import load_model_checkpoint as jax_load
from omnibiote_tpu_torch.evals import engine
from omnibiote_tpu_torch.evals.common import tokenize_sequences
from omnibiote_tpu_torch.tokenizer import SentencePieceProcessor
from omnibiote_tpu_torch.training.checkpoint import load_model_checkpoint
from omnibiote_tpu_torch.utils.convert import jax_head_from_port, jax_params_from_state

from test_torch_eval_common import (
    LOSS_RTOL, METRIC_ATOL, assert_trees_close, banned, jax_head_injector,
    make_checkpoint, make_tokenizer)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("engine")
    return make_checkpoint(root, n_layer=2), SentencePieceProcessor(make_tokenizer(root))


def motif_split(rng, n, seq_len=24):
    """The JAX GUE test's task: the class is a fixed 12-mer prefix."""
    X, Y = [], []
    for i in range(n):
        y = i % 2
        prefix = "GGGGCCGGGGCC" if y else "ATATATATATAT"
        X.append(prefix + "".join(rng.choice(list("ACGT"), size=seq_len)))
        Y.append(y)
    return X, np.asarray(Y)


def gue_data(sp, n_train, n_eval, seed=0):
    rng = np.random.default_rng(seed)
    data = {}
    for split, n in (("train", n_train), ("val", n_eval), ("test", n_eval)):
        X, Y = motif_split(rng, n)
        data[split] = (tokenize_sequences(sp, X, "<DNA>", banned(sp)), Y)
    return data


def port_tree(model, head=None):
    cfg = model.cfg
    tree = {"model": jax_params_from_state(
        {n: p.detach().numpy() for n, p in model.named_parameters()}, cfg)}
    if head is not None:
        tree["head"] = jax_head_from_port(head)
    return tree


def group_tol(k, lr, embed_lr, head_lr):
    """0.05·lr·k at the leaf's group LR (path '/model/wte', '/head/..', rest)."""
    def tol(path):
        peak = embed_lr if path.endswith("/wte") else head_lr if path.startswith("/head") else lr
        return 0.05 * peak * k
    return tol


def test_finetune_classifier_matches_jax(setup, monkeypatch):
    ckpt, sp = setup
    data = gue_data(sp, 16, 8)
    kw = dict(num_classes=2, num_epochs=4, batch_size=4, num_accumulation_steps=2,
              lr=1e-3, embed_lr=1e-2, head_lr=1e-2, seed=3)
    jparams, jcfg = jax_load(ckpt)
    jlog, plog = [], []
    jm, jf, jaux = jengine.finetune_classifier(jparams, jcfg, data, log=jlog.append, **kw)

    jax_head_injector(monkeypatch, engine, split=True)
    model, cfg = load_model_checkpoint(ckpt, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    pm, pf, paux = engine.finetune_classifier(model, cfg, data, log=plog.append, **kw)

    n_steps = 8
    assert len(plog) == len(jlog) == 2 * n_steps
    for p, j in zip(plog, jlog):
        assert p.keys() == j.keys() and p["step"] == j["step"]
        if "loss" in j:
            np.testing.assert_allclose(p["loss"], j["loss"], rtol=LOSS_RTOL)
        else:
            for key in ("val_primary", "val_secondary"):
                assert abs(p[key] - j[key]) <= METRIC_ATOL, (p, j)
    assert abs(pm - jm) <= METRIC_ATOL and abs(pf - jf) <= METRIC_ATOL
    np.testing.assert_allclose(paux["last_test"], jaux["last_test"], atol=METRIC_ATOL)
    assert abs(paux["best_val"] - jaux["best_val"]) <= METRIC_ATOL
    # the best model is a later one than the first: k updates went into it
    k = next(r["step"] for r in jlog if r.get("val_primary") == jaux["best_val"])
    assert k > 0 and paux["snapshots"] > 1
    best = paux["params"]
    assert_trees_close(port_tree(best["model"], best["head"]),
                       jax.tree.map(np.asarray, jaux["params"]),
                       group_tol(k, kw["lr"], kw["embed_lr"], kw["head_lr"]))
    # the val predictions of the returned (best) model and head, and their logits
    X_val = data["val"][0]
    assert engine._predict_classes(best["model"], best["head"], cfg, X_val, 4, 128, None) == \
        jengine._predict_classes(jaux["params"]["model"], jaux["params"]["head"], jcfg,
                                 X_val, 4, 128, None)
    # the caller's model is untouched
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n


def test_classifier_logits_match_jax(setup):
    """The masked forward's embeddings and the pooled-classification
    forward of one PAD-filled batch, both poolings, on the same weights and
    head."""
    from omnibiote_tpu.evals.common import init_linear_head as jax_head
    from omnibiote_tpu.evals.common import masked_forward_embeddings as jax_emb
    from omnibiote_tpu_torch.evals.common import masked_forward_embeddings, pad_batch
    from omnibiote_tpu_torch.utils.convert import head_from_jax
    import jax.numpy as jnp
    ckpt, sp = setup
    X = gue_data(sp, 6, 1)["train"][0]
    x, seg = pad_batch(X, 128)
    jparams, jcfg = jax_load(ckpt)
    model, cfg = load_model_checkpoint(ckpt, device="cpu")
    with torch.inference_mode():
        got = masked_forward_embeddings(model, cfg, torch.from_numpy(x), torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_emb(jparams, jcfg, x, seg)),
                               rtol=2e-4, atol=2e-5)
    jh = jax_head(jax.random.PRNGKey(0), 64, 3)
    for pool in ("first", "mean"):
        want = jengine._classify_fwd(jcfg, pool)(jparams, jh, jnp.asarray(x), jnp.asarray(seg))
        with torch.inference_mode():
            got = engine.classify_logits(model, head_from_jax(jh), torch.from_numpy(x),
                                         torch.from_numpy(seg), pool=pool)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_domain_mlm_pretrain_matches_jax(setup):
    ckpt, sp = setup
    rng = np.random.default_rng(5)
    tokenized = tokenize_sequences(sp, motif_split(rng, 16)[0], "<DNA>", banned(sp))
    kw = dict(num_epochs=1, batch_size=4, num_accumulation_steps=2, lr=1e-3, seed=7)
    jparams, jcfg = jax_load(ckpt)
    jlog, plog = [], []
    jout = jengine.domain_mlm_pretrain(jparams, jcfg, tokenized, log=jlog.append, **kw)
    model, cfg = load_model_checkpoint(ckpt, device="cpu")
    pout = engine.domain_mlm_pretrain(model, cfg, tokenized, log=plog.append, **kw)
    k = 2
    assert [r["step"] for r in plog] == [r["step"] for r in jlog] == list(range(k))
    np.testing.assert_allclose([r["loss"] for r in plog], [r["loss"] for r in jlog],
                               rtol=LOSS_RTOL)
    assert pout is not model
    assert_trees_close(port_tree(pout)["model"], jax.tree.map(np.asarray, jout),
                       0.05 * kw["lr"] * k)


def test_finetune_classifier_learns_the_motif_task(setup):
    """The JAX GUE test's bar (tests/test_evals_gue.py:69): MCC > 0.3 on
    the motif task, port alone."""
    ckpt, sp = setup
    model, cfg = load_model_checkpoint(ckpt, device="cpu")
    mcc, f1, aux = engine.finetune_classifier(
        model, cfg, gue_data(sp, 64, 32, seed=1), num_classes=2, num_epochs=4,
        batch_size=8, num_accumulation_steps=2, lr=1e-3, embed_lr=1e-3,
        head_lr=1e-2, seed=0)
    assert mcc > 0.3, (mcc, f1, aux["best_val"])
