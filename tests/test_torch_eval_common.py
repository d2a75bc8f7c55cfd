"""PyTorch port vs the JAX package: the eval harness's shared pieces
(`evals/common.py`, `evals/metrics.py`).

Schedules against optax at every step, the three-group AdamW against
`optax.multi_transform(adamw)` fed identical gradients, batching against
the JAX helpers, and every metric against scikit-learn (which only this
test imports) on seeded random cases and edge cases. Also the shared
fixtures of the other eval tests: a BPE vocabulary trained by `train_bpe`
on synthetic DNA/protein sentences and a small checkpoint written by the
JAX Trainer (fp32, dense attention), which both packages load.
"""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import sklearn.metrics as skm
import torch

from omnibiote_tpu.evals import common as jcommon
from omnibiote_tpu_torch import OmniBioTAConfig as PortConfig, init_params
from omnibiote_tpu_torch.evals import common, metrics
from omnibiote_tpu_torch.tokenizer import SentencePieceProcessor, train_bpe
from omnibiote_tpu_torch.utils.convert import (
    head_from_jax, jax_head_from_port, jax_params_from_state)

# forwards and embeddings (tests/test_model_parity.py:50); per-step losses;
# returned metrics
RTOL, ATOL = 2e-4, 2e-5
LOSS_RTOL = 1e-4
METRIC_ATOL = 1e-6
SPECIALS = ["<EOS>", "<DNA>", "<protein>", "<RNA>"]


def corpus(seed=0):
    rng = np.random.default_rng(seed)
    sents = []
    for i in range(300):
        if i % 2:
            body = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"),
                                      size=int(rng.integers(20, 60))))
            sents.append("<protein>" + body + "<EOS>")
        else:
            body = "".join(rng.choice(list("ACGT"), size=int(rng.integers(20, 60))))
            sents.append("<DNA>" + body + "<EOS>")
    return sents


def make_tokenizer(root) -> str:
    """A ~200-piece BPE vocabulary ('<EOS>' is id 3, as EOS_TOKEN)."""
    path = str(root / "toy.model")
    train_bpe(corpus(), vocab_size=200, out_path=path, user_defined=SPECIALS)
    assert SentencePieceProcessor(path).piece_to_id("<EOS>") == 3
    return path


def banned(sp):
    """The vocabulary's whitespace piece, which the harness strips (the
    role of id 65533 in the reference's mixed vocabulary)."""
    return [sp.piece_to_id("\u2581")]


def make_checkpoint(root, n_layer=1, block_size=256) -> str:
    """A checkpoint written by the JAX Trainer: d 64, 2 heads, vocab 2^16,
    fp32, dense attention, dropout 0."""
    from omnibiote_tpu import OmniBioTAConfig, TrainConfig
    from omnibiote_tpu.training.train import Trainer
    cfg = OmniBioTAConfig(n_layer=n_layer, n_head=2, n_embd=64,
                          vocab_size=2 ** 16, block_size=block_size,
                          dropout=0.0, attn_impl="xla", compute_dtype="float32")
    tc = TrainConfig(batch_size=8, mini_batch_size=1, ctx_len=block_size,
                     token_budget=1e9, save_dir=str(root / "ck"), save_name="m")
    return Trainer(cfg, tc, batch_iter=iter(())).save_checkpoint(final=True)


def jax_head_injector(monkeypatch, module, split: bool):
    """Make `module.init_linear_head` (a port eval module) return the head
    the JAX package draws for the same seed: from split(PRNGKey(seed))[1]
    (split=True, the engines) or PRNGKey(seed) itself."""
    def init(gen, in_dim, out_dim, dtype=torch.float32, device=None):
        key = jax.random.PRNGKey(gen.initial_seed())
        if split:
            key = jax.random.split(key)[1]
        return head_from_jax(jcommon.init_linear_head(key, in_dim, out_dim), device)
    monkeypatch.setattr(module, "init_linear_head", init)


def assert_trees_close(got, want, tol, what="", rtol=0.0):
    """Every leaf of two nested dicts of arrays within tol + rtol·|want|
    (tol a float or a function of the leaf's path)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (what, set(got) ^ set(want))
        for k in want:
            assert_trees_close(got[k], want[k], tol, f"{what}/{k}", rtol)
        return
    limit = tol(what) if callable(tol) else tol
    want = np.asarray(want, np.float64)
    excess = np.abs(np.asarray(got, np.float64) - want) - rtol * np.abs(want)
    assert excess.max() <= limit, f"{what}: max |d| - rtol|want| {excess.max():.3e} > {limit:.3e}"


# ---------------------------------------------------------------------------
# Schedules and the three-group AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total,pct", [(1, 0.05), (2, 0.05), (3, 0.3), (7, 0.05),
                                       (20, 0.05), (100, 0.0), (257, 0.5)])
def test_onecycle_matches_optax(total, pct):
    got = [common.onecycle(1e-3, total, pct)(k) for k in range(total + 3)]
    want = [float(jcommon.onecycle(1e-3, total, pct)(k)) for k in range(total + 3)]
    # optax interpolates in fp32: its cosine cancels to ~1e-10 absolute
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 1e-3)


@pytest.mark.parametrize("total", [1, 2, 5, 64])
def test_linear_to_zero_matches_jax(total):
    got = [common.linear_to_zero(2e-4, total)(k) for k in range(total + 3)]
    want = [float(jcommon.linear_to_zero(2e-4, total)(k)) for k in range(total + 3)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def _tiny_port_model(seed=0):
    cfg = PortConfig(n_layer=1, n_head=2, n_embd=32, vocab_size=96,
                     block_size=64, dropout=0.0, compute_dtype="float32")
    return init_params(torch.Generator().manual_seed(seed), cfg, device="cpu"), cfg


def test_group_label_tree_splits_wte_rest_head():
    model, _ = _tiny_port_model()
    head = common.init_linear_head(torch.Generator().manual_seed(0), 32, 3)
    groups = common.group_label_tree(model, head)
    assert [n for n, _ in groups["wte"]] == ["transformer.wte.weight"]
    assert [n for n, _ in groups["head"]] == ["head.b", "head.w"]
    rest = [n for n, _ in groups["rest"]]
    assert "lm_head.weight" in rest and len(rest) == len(list(model.parameters())) - 1


@pytest.mark.parametrize("schedule", ["onecycle", "linear"])
def test_three_group_adamw_matches_optax(schedule):
    """5 updates fed identical gradients: the port's AdamW over the three
    groups against optax.multi_transform(adamw), parameter for parameter.
    One parameter gets no gradient (optax sees zeros: decay only)."""
    model, cfg = _tiny_port_model()
    head = common.init_linear_head(torch.Generator().manual_seed(1), 32, 3)
    kw = dict(lr=1e-3, embed_lr=1e-2, head_lr=3e-2, total_steps=5,
              schedule=schedule)
    state = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    jparams = jax.tree.map(jnp.asarray, jax_params_from_state(state, cfg))
    jhead = jax.tree.map(jnp.asarray, jax_head_from_port(head))
    tx, opt_state = jcommon.make_finetune_optimizer(jparams, jhead, **kw)
    opt, sched = common.make_finetune_optimizer(model, head, **kw)
    joint = {"model": jparams, "head": jhead}
    rng = np.random.default_rng(0)
    for _ in range(5):
        grads = {n: rng.standard_normal(p.shape).astype(np.float32)
                 for n, p in model.named_parameters()}
        grads["lm_head.weight"][:] = 0.0
        hgrads = {k: rng.standard_normal(v.shape).astype(np.float32)
                  for k, v in head.items()}
        for n, p in model.named_parameters():
            if n != "lm_head.weight":
                p.grad = torch.from_numpy(grads[n])
        for k, v in head.items():
            v.grad = torch.from_numpy(hgrads[k])
        common.step_optimizer(opt, sched)
        jgrads = {"model": jax.tree.map(jnp.asarray, jax_params_from_state(grads, cfg)),
                  "head": jax.tree.map(jnp.asarray, hgrads)}
        updates, opt_state = tx.update(jgrads, opt_state, joint)
        joint = optax.apply_updates(joint, updates)
    got = {"model": jax_params_from_state(
        {n: p.detach().numpy() for n, p in model.named_parameters()}, cfg),
        "head": jax_head_from_port(head)}
    assert_trees_close(got, jax.tree.map(np.asarray, joint), 1e-6, rtol=1e-6)


def test_pad_batch_bucket_and_piece_lengths_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    lists = [rng.integers(4, 150, size=n).tolist() for n in (5, 130, 300, 1)]
    for bucket, max_len in ((128, None), (128, 256), (64, 1024)):
        got, want = common.pad_batch(lists, bucket, max_len), jcommon.pad_batch(lists, bucket, max_len)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    for n in (1, 127, 128, 129, 1500):
        assert common.bucket_len(n, 128, 1024) == jcommon.bucket_len(n, 128, 1024)
    sp = SentencePieceProcessor(make_tokenizer(tmp_path))
    ids = sp.encode("<protein>MKVLAAGIWQ<EOS><DNA>ACGTTGCA")
    assert common.piece_lengths(sp, ids) == jcommon.piece_lengths(sp, ids)
    assert common.tokenize_sequences(sp, ["ACGT", "GATTACA"], "<DNA>", [5]) == \
        jcommon.tokenize_sequences(sp, ["ACGT", "GATTACA"], "<DNA>", [5])


def test_linear_head_layout_bounds_and_converters():
    head = common.init_linear_head(torch.Generator().manual_seed(0), 64, 3)
    assert head["w"].shape == (64, 3) and head["b"].shape == (3,)
    assert head["w"].requires_grad and float(head["w"].detach().abs().max()) <= 1 / 8
    jhead = jcommon.init_linear_head(jax.random.PRNGKey(0), 64, 3)
    back = jax_head_from_port(head_from_jax(jhead))
    for k in ("w", "b"):
        np.testing.assert_array_equal(back[k], np.asarray(jhead[k]))
    x = np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)
    np.testing.assert_allclose(
        common.apply_linear_head(head_from_jax(jhead), torch.from_numpy(x)).detach().numpy(),
        np.asarray(jcommon.apply_linear_head(jhead, jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_snapshot_is_a_copy():
    model, _ = _tiny_port_model()
    live = dict(model.named_parameters())
    saved = common.snapshot(live)
    with torch.no_grad():
        for p in live.values():
            p.add_(1.0)
    assert all(not torch.equal(saved[n], p) for n, p in live.items())
    common.restore(live, saved)
    assert all(torch.equal(saved[n], p) for n, p in live.items())


# ---------------------------------------------------------------------------
# Metrics against scikit-learn
# ---------------------------------------------------------------------------

def _close(got, want):
    if np.isnan(want):
        return np.isnan(got)
    return abs(got - want) <= 1e-12


@pytest.mark.parametrize("seed", range(6))
def test_classification_metrics_match_sklearn(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n, k = int(rng.integers(1, 60)), int(rng.integers(1, 6))
        yt = rng.integers(0, k, n)
        yp = rng.integers(0, int(rng.integers(1, k + 2)), n)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert _close(metrics.matthews_corrcoef(yt, yp), skm.matthews_corrcoef(yt, yp))
            assert _close(metrics.f1_score(yt, yp, average="weighted"),
                          skm.f1_score(yt, yp, average="weighted"))
            assert _close(metrics.f1_score(yt, yp, average="macro"),
                          skm.f1_score(yt, yp, average="macro"))
            assert _close(metrics.accuracy_score(yt, yp), skm.accuracy_score(yt, yp))
            yb, pb = yt % 2, yp % 2
            for zd in ("warn", 0, 1):
                assert _close(metrics.precision_score(yb, pb, zero_division=zd),
                              skm.precision_score(yb, pb, zero_division=zd))
            assert _close(metrics.f1_score(yb, pb), skm.f1_score(yb, pb))


@pytest.mark.parametrize("yt,yp", [
    ([1, 1, 1, 1], [1, 1, 1, 1]),            # constant, all right
    ([0, 1, 2, 1], [1, 1, 1, 1]),            # constant predictions
    ([0, 0, 1, 1], [2, 2, 3, 3]),            # disjoint label sets
    ([0, 1, 2, 3, 3], [0, 1, 1, 1, 0]),      # classes absent from predictions
    ([5, 7, 7, 9], [7, 7, 9, 5]),            # labels not from 0
])
def test_classification_metric_edge_cases_match_sklearn(yt, yp):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert _close(metrics.matthews_corrcoef(yt, yp), skm.matthews_corrcoef(yt, yp))
        assert _close(metrics.f1_score(yt, yp, average="weighted"),
                      skm.f1_score(yt, yp, average="weighted"))
        assert _close(metrics.accuracy_score(yt, yp), skm.accuracy_score(yt, yp))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("ties", [False, True])
def test_ranking_metrics_match_sklearn(seed, ties):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n = int(rng.integers(2, 80))
        y = rng.integers(0, 2, n).astype(np.float64)
        if y.min() == y.max():
            y[0] = 1.0 - y[0]
        s = rng.random(n).astype(np.float32)
        if ties:
            s = np.round(s * 4) / 4
        for drop in (True, False):
            for g, w in zip(metrics.roc_curve(y, s, drop_intermediate=drop),
                            skm.roc_curve(y, s, drop_intermediate=drop)):
                np.testing.assert_array_equal(g, w)
        assert _close(metrics.roc_auc_score(y, s), skm.roc_auc_score(y, s))
        fpr, tpr, _ = skm.roc_curve(y, s)
        assert _close(metrics.auc(fpr, tpr), skm.auc(fpr, tpr))
        for g, w in zip(metrics.precision_recall_curve(y, s),
                        skm.precision_recall_curve(y, s)):
            np.testing.assert_array_equal(g, w)
        p, r, _ = skm.precision_recall_curve(y, s)
        assert _close(metrics.auc(r, p), skm.auc(r, p))


@pytest.mark.parametrize("y", [[1, 1, 1], [0, 0, 0, 0]])
def test_single_class_roc_as_sklearn(y):
    s = np.linspace(0, 1, len(y))
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        want = skm.roc_auc_score(y, s)
        fw, tw, _ = skm.roc_curve(y, s)
    with pytest.warns(metrics.UndefinedMetricWarning):
        got = metrics.roc_auc_score(y, s)
    assert np.isnan(got) and np.isnan(want)
    with pytest.warns(metrics.UndefinedMetricWarning):
        fg, tg, _ = metrics.roc_curve(y, s)
    np.testing.assert_array_equal(fg, fw)
    np.testing.assert_array_equal(tg, tw)


def test_metric_input_errors_as_sklearn():
    for fn in (metrics.roc_curve, skm.roc_curve):
        with pytest.raises(ValueError):
            fn([0, 1, 2], [0.1, 0.2, 0.3])   # not binary
    for fn in (metrics.auc, skm.auc):
        with pytest.raises(ValueError):
            fn([0.0, 1.0, 0.5], [0.0, 1.0, 1.0])   # x not monotonic
    with pytest.raises(ValueError):
        metrics.accuracy_score([0, 1], [0])
