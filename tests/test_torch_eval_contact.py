"""PyTorch port vs the JAX package: the TAPE contact-map eval
(`evals/contact.py`).

The data functions exactly (char->token max-pooling, the token->char
upsampling with the reference's off-by-one, a pickle cache the JAX package
wrote); the ContactPredictor CNN with its valid-masked BatchNorm against
`apply_contact_predictor` with the same weights, forward and `jax.grad`
(rtol 2e-4 / atol 2e-5); predictions invariant to the bucket width; and
the four-group AdamW with its global-norm clip against the optax chain;
`run_contact_eval` end to end through both packages with one checkpoint
and vocabulary and the JAX head and CNN injected (the returned metrics and
every validation record to METRIC_ATOL), and the CLI's flags.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnibiote_tpu.evals import common as jcommon, contact as jcontact
from omnibiote_tpu_torch.evals import contact
from omnibiote_tpu_torch.tokenizer import SentencePieceProcessor
from omnibiote_tpu_torch.utils.convert import (
    contact_predictor_state_from_jax, head_from_jax)

from test_torch_eval_common import (
    ATOL, METRIC_ATOL, RTOL, banned, make_checkpoint, make_tokenizer)
from test_torch_eval_families import _parser_of


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("contact")
    tok = make_tokenizer(root)
    return make_checkpoint(root), tok, banned(SentencePieceProcessor(tok))[0]


def _record(rng, n):
    """A ProteinNet record whose contacts are exactly the W-W pairs: W
    residues sit in a ball of radius 2 around the origin, every other one on
    a 20 A-spaced line (eval_tpu.py's separable geometry)."""
    seq = "".join(rng.choice(list("MKVLAGIW"), size=n))
    tert = np.zeros((n, 3))
    for i, ch in enumerate(seq):
        tert[i] = rng.uniform(-2, 2, size=3) if ch == "W" else (20.0 * (i + 2), 0.0, 0.0)
    valid = [1] * n
    valid[int(rng.integers(0, n))] = 0
    return {"primary": seq, "tertiary": tert.tolist(), "valid_mask": valid}


def write_proteinnet(root, seed=1, sizes=(("train", 10), ("valid", 4), ("test", 4))):
    rng = np.random.default_rng(seed)
    pn = os.path.join(root, "proteinnet")
    os.makedirs(pn)
    for split, n_rec in sizes:
        data = [_record(rng, int(rng.integers(30, 50))) for _ in range(n_rec)]
        with open(os.path.join(pn, f"proteinnet_{split}.json"), "w") as f:
            json.dump(data, f)
    return root


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def test_data_functions_match_jax(setup, tmp_path):
    _, tok, ban = setup
    sp = SentencePieceProcessor(tok)
    from omnibiote_tpu.tokenizer import SentencePieceProcessor as JaxSP
    jsp = JaxSP(tok)
    root = write_proteinnet(str(tmp_path))
    got, want = contact.load_proteinnet("train", root), jcontact.load_proteinnet("train", root)
    for g, w in zip(got, want):
        assert g == w if isinstance(w[0], str) else all(
            np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(g, w))
    seqs, cmaps, masks = got[:3]
    rng = np.random.default_rng(0)
    for s, c, m in zip(seqs, cmaps, masks):
        g = contact.process_sample(sp, s, c, m, ban)
        w = jcontact.process_sample(jsp, s, c, m, ban)
        assert list(map(int, g[0])) == list(map(int, w[0]))
        assert len(g[0]) - 2 == g[1].shape[0] > 5
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype == np.float32
        pred = rng.random(g[1].shape).astype(np.float32)
        up = contact.inverse_process_sample(sp, g[0], pred)
        np.testing.assert_array_equal(up, jcontact.inverse_process_sample(jsp, w[0], pred))
        # the reference's off-by-one: the map's side counts every inner
        # token's characters but only the 2nd..second-to-last are laid out,
        # from the top: as many rows and columns as the first and last
        # inner tokens' characters stay zero at the end
        lens = [len(sp.decode([int(t)])) for t in g[0][1:-1]]
        assert up.shape == (sum(lens),) * 2
        tail = lens[0] + lens[-1]
        assert not up[-tail:].any() and not up[:, -tail:].any()
        assert up[:-tail, :-tail].all()


def test_jax_written_cache_loads(setup, tmp_path):
    _, tok, ban = setup
    sp = SentencePieceProcessor(tok)
    from omnibiote_tpu.tokenizer import SentencePieceProcessor as JaxSP
    root = write_proteinnet(str(tmp_path))
    seqs, cmaps, masks = contact.load_proteinnet("train", root)[:3]
    cache = os.path.join(root, "proteinnet", "processed_train_bpe_mixed.pkl")
    want = jcontact.preprocess_split(JaxSP(tok), seqs, cmaps, masks, ban, cache)
    assert os.path.exists(cache)
    # the cache wins over the data: the port returns what the JAX package wrote
    got = contact.preprocess_split(sp, seqs[:1], cmaps[:1], masks[:1], ban, cache)
    fresh = contact.preprocess_split(sp, seqs, cmaps, masks, ban)
    for version in (got, fresh):
        assert len(version) == 4 and len(version[0]) == len(seqs)
        for g_list, w_list in zip(version, want):
            for g, w in zip(g_list, w_list):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------------------------
# The CNN
# ---------------------------------------------------------------------------

def _cnn_case(seed, in_channels, blocks, side, valid):
    key = jax.random.PRNGKey(seed)
    jparams = jcontact.init_contact_predictor(key, in_channels=in_channels, blocks=blocks)
    # batch-norm parameters away from (1, 0), so their gradients mean something
    rng = np.random.default_rng(seed)
    for blk in jparams["blocks"]:
        for bn in ("bn1", "bn2"):
            blk[bn] = {k: jnp.asarray(rng.uniform(0.5, 1.5, 64) if k == "scale"
                                      else rng.uniform(-0.2, 0.2, 64), jnp.float32)
                       for k in ("scale", "bias")}
    x = rng.standard_normal((1, in_channels, side, side)).astype(np.float32)
    mask = np.zeros((1, 1, side, side), np.float32)
    mask[..., :valid, :valid] = 1.0
    w = rng.standard_normal((1, 1, side, side)).astype(np.float32)
    cnn = contact.ContactPredictor(in_channels, blocks=blocks, device="cpu")
    cnn.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                         contact_predictor_state_from_jax(jparams).items()})
    return jparams, cnn, x, mask, w


@pytest.mark.parametrize("in_channels,blocks,side,valid",
                         [(256, 2, 16, 11), (32, 3, 16, 16)])
def test_contact_predictor_matches_jax(in_channels, blocks, side, valid):
    jparams, cnn, x, mask, w = _cnn_case(0, in_channels, blocks, side, valid)

    def jloss(p, xx):
        return jnp.sum(jcontact.apply_contact_predictor(p, xx, jnp.asarray(mask))
                       * jnp.asarray(w))

    jprobs = jax.jit(jcontact.apply_contact_predictor)(jparams, jnp.asarray(x),
                                                      jnp.asarray(mask))
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jparams, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    probs = cnn(xt, torch.from_numpy(mask))
    np.testing.assert_allclose(probs.detach().numpy(), np.asarray(jprobs), rtol=RTOL, atol=ATOL)
    (probs * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=RTOL, atol=ATOL)
    want = contact_predictor_state_from_jax(jgp)
    got = dict(cnn.named_parameters())
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(want[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_masked_batchnorm_ignores_the_pad_border():
    """Statistics over the valid positions only: values on the border move
    nothing inside it, and the valid region comes out at mean 0, variance 1
    per channel before scale and bias."""
    bn = contact.MaskedBatchNorm(4, device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 4, 10, 10)).astype(np.float32)) * 3 + 1
    mask = torch.zeros(1, 1, 10, 10)
    mask[..., :7, :7] = 1
    y = bn(x, mask)
    x2 = torch.where(mask > 0, x, 1e3)
    torch.testing.assert_close(bn(x2, mask)[..., :7, :7], y[..., :7, :7], rtol=0, atol=0)
    inner = y[0, :, :7, :7].reshape(4, -1).double()
    torch.testing.assert_close(inner.mean(1), torch.zeros(4, dtype=torch.float64),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(inner.var(1, unbiased=False),
                               torch.ones(4, dtype=torch.float64), rtol=0, atol=1e-4)


def test_init_draws_from_the_generator():
    a = contact.init_contact_predictor(torch.Generator().manual_seed(3), blocks=2)
    b = contact.init_contact_predictor(torch.Generator().manual_seed(3), blocks=2)
    c = contact.init_contact_predictor(torch.Generator().manual_seed(4), blocks=2)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["conv_in.weight"], sc["conv_in.weight"])
    jp = jcontact.init_contact_predictor(jax.random.PRNGKey(0), blocks=2)
    for k, v in contact_predictor_state_from_jax(jp).items():
        assert sa[k].shape == tuple(np.shape(v)), k
    for name, fan_in in (("conv_in", 256 * 9), ("blocks.1.conv2", 64 * 9), ("conv_out", 64 * 9)):
        w, b = sa[f"{name}.weight"], sa[f"{name}.bias"]
        assert max(w.abs().max(), b.abs().max()) <= fan_in ** -0.5
        assert w.abs().max() > 0.9 * fan_in ** -0.5
    assert torch.equal(sa["blocks.0.bn1.scale"], torch.ones(64))
    assert torch.equal(sa["blocks.0.bn1.bias"], torch.zeros(64))


def test_predictions_invariant_to_pad_bucket(setup):
    """The same protein padded to two bucket widths gives the same
    probabilities on its real region (tests/test_evals_contact.py:58)."""
    ckpt, tok, ban = setup
    from omnibiote_tpu_torch.training.checkpoint import load_model_checkpoint
    from omnibiote_tpu_torch.evals.common import init_linear_head
    sp = SentencePieceProcessor(tok)
    model, cfg = load_model_checkpoint(ckpt, device="cpu")
    ids = [t for t in sp.encode("<protein>MKVLAGIWQRSTMKVLAGIWQRSTW<EOS>") if t != ban]
    gen = torch.Generator().manual_seed(0)
    head = init_linear_head(gen, cfg.n_embd, contact.HEAD_DIM)
    cnn = contact.init_contact_predictor(gen, blocks=2)
    n = len(ids) - 2
    probs = {}
    for width in (64, 128):
        tok_p = np.full((1, width + 2), 1, np.int32)
        tok_p[0, :len(ids)] = ids
        mask = np.zeros((width, width), np.float32)
        mask[:n, :n] = 1.0
        probs[width] = contact.predict_map(model, head, cnn, torch.from_numpy(tok_p),
                                           torch.from_numpy(mask)).numpy()[:n, :n]
    np.testing.assert_allclose(probs[64], probs[128], rtol=0, atol=2e-6)


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------

class _Sink:
    def __init__(self):
        self.records = []

    def log(self, rec):
        self.records.append(rec)


def test_contact_optimizer_matches_optax():
    """The four-group AdamW after the global-norm clip, fed identical
    gradients for 6 steps (global norms above and below 1), against the JAX
    package's optax.chain(clip_by_global_norm(1.0), multi_transform(adamw))
    at the run's default learning rates."""
    import optax
    from omnibiote_tpu_torch import OmniBioTAConfig, init_params
    from omnibiote_tpu_torch.evals import common
    from omnibiote_tpu_torch.utils.convert import jax_params_from_state, state_from_jax_params
    cfg = OmniBioTAConfig(n_layer=1, n_head=2, n_embd=32, vocab_size=96, block_size=64,
                          dropout=0.0, compute_dtype="float32")
    model = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    head = common.init_linear_head(gen, 32, contact.HEAD_DIM)
    cnn = contact.init_contact_predictor(gen, in_channels=8, channels=64, blocks=1)
    steps, lrs = 6, dict(lr=1e-4, embed_lr=1e-4, head_lr=1e-3, contact_pred_lr=1e-3)
    opt, sched = contact.make_contact_optimizer(model, head, cnn, total_steps=steps, **lrs)
    np_of = lambda d: {k: v.detach().numpy().copy() for k, v in d.items()}
    joint = {"model": jax_params_from_state(np_of(dict(model.named_parameters())), cfg),
             "head": np_of(head), "cnn": np_of(dict(cnn.named_parameters()))}
    joint = jax.tree.map(jnp.asarray, joint)
    labels = {"model": jax.tree_util.tree_map_with_path(
        lambda path, _: "wte" if any(getattr(q, "key", None) == "wte" for q in path)
        else "rest", joint["model"]),
        "head": {k: "headg" for k in joint["head"]}, "cnn": {k: "cnng" for k in joint["cnn"]}}
    adamw = lambda peak: optax.adamw(jcommon.onecycle(peak, steps), b1=0.9, b2=0.999,
                                     eps=1e-8, weight_decay=1e-2)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.multi_transform(
        {"wte": adamw(lrs["embed_lr"]), "rest": adamw(lrs["lr"]),
         "headg": adamw(lrs["head_lr"]), "cnng": adamw(lrs["contact_pred_lr"])}, labels))
    state = tx.init(joint)
    update = jax.jit(tx.update)
    live = common.trainable(model, head)
    live.update({f"cnn.{n}": p for n, p in cnn.named_parameters()})
    rng = np.random.default_rng(0)
    norms = []
    for step in range(steps):
        # global norms of about 0.5 and 3
        scale = (0.5 if step % 2 else 3.0) / np.sqrt(sum(p.numel() for p in live.values()))
        grads = {n: (scale * rng.standard_normal(p.shape)).astype(np.float32)
                 for n, p in live.items()}
        grads["lm_head.weight"][:] = 0.0   # no gradient: decay only
        for n, p in live.items():
            if n != "lm_head.weight":
                p.grad = torch.from_numpy(grads[n].copy())
        norms.append(float(contact.clip_grad_global_norm(live.values(), 1.0)))
        common.step_optimizer(opt, sched)
        jgrads = {"model": jax_params_from_state(
            {n: g for n, g in grads.items() if not n.startswith(("head.", "cnn."))}, cfg),
            "head": {k[5:]: g for k, g in grads.items() if k.startswith("head.")},
            "cnn": {k[4:]: g for k, g in grads.items() if k.startswith("cnn.")}}
        updates, state = update(jax.tree.map(jnp.asarray, jgrads), state, joint)
        joint = optax.apply_updates(joint, updates)
    assert min(norms) < 1.0 < max(norms)
    want = state_from_jax_params(jax.tree.map(np.asarray, joint["model"]), cfg)
    want.update({f"head.{k}": np.asarray(v) for k, v in joint["head"].items()})
    want.update({f"cnn.{k}": np.asarray(v) for k, v in joint["cnn"].items()})
    for n, p in live.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-6, atol=1e-7,
                                   err_msg=n)


class _Sink:
    def __init__(self):
        self.records = []

    def log(self, rec):
        self.records.append(rec)


def test_run_contact_eval_matches_jax(setup, tmp_path, monkeypatch):
    """10 steps through both packages. The learning rates are cut 100-fold:
    Adam turns a gradient entry of about its eps (1e-8; a conv bias before
    a batch norm has a gradient of 0 but for rounding) into a step of +-lr
    whose sign is rounding noise, so at the default rates the two runs part
    by 2 lr in such weights after one step, and their metrics after a few
    (test_contact_optimizer_matches_optax holds the update itself at the
    default rates)."""
    ckpt, tok, ban = setup
    root = write_proteinnet(str(tmp_path))
    kw = dict(banned_token=ban, data_dir=root, num_epochs=4, num_accumulation_steps=4,
              num_tests=3, lr=1e-6, embed_lr=1e-6, head_lr=1e-5, contact_pred_lr=1e-5,
              resnet_blocks=2, seed=5, cache=False)
    jsink, psink = _Sink(), _Sink()
    want = jcontact.run_contact_eval(tok, ckpt, metrics_sink=jsink, **kw)

    k_head, k_cnn = jax.random.split(jax.random.PRNGKey(kw["seed"]))

    def head(gen, in_dim, out_dim, dtype=torch.float32, device=None):
        assert gen.initial_seed() == kw["seed"]
        return head_from_jax(jcommon.init_linear_head(k_head, in_dim, out_dim), device)

    def cnn(gen, *, blocks, device=None):
        out = contact.ContactPredictor(blocks=blocks, device=device)
        out.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                             contact_predictor_state_from_jax(
                                 jcontact.init_contact_predictor(k_cnn, blocks=blocks)).items()})
        return out

    monkeypatch.setattr(contact, "init_linear_head", head)
    monkeypatch.setattr(contact, "init_contact_predictor", cnn)
    got = contact.run_contact_eval(tok, ckpt, metrics_sink=psink, device="cpu", **kw)
    assert set(got) == {"test", "test_best"}
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=METRIC_ATOL,
                                   err_msg=name)
    assert got["test"] != got["test_best"]
    assert len(psink.records) == len(jsink.records) == 4   # 10 steps, one every 3
    for g, w in zip(psink.records, jsink.records):
        assert g["step"] == w["step"]
        np.testing.assert_allclose([g[k] for k in sorted(g)], [w[k] for k in sorted(w)],
                                   rtol=0, atol=METRIC_ATOL)


def test_cli_flags_are_the_jax_ones_plus_device(monkeypatch):
    jp, pp = _parser_of(jcontact.main, monkeypatch), _parser_of(contact.main, monkeypatch)
    flags = lambda p: {a.dest: (tuple(a.option_strings), a.nargs, a.type, a.default)
                       for a in p._actions if a.dest != "help"}
    want = flags(jp)
    want["device"] = (("--device",), None, None, None)
    assert flags(pp) == want


def test_entry_point_needs_a_gpu_unless_asked_for_the_cpu(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ckpt, tok, ban = setup
    root = write_proteinnet(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        contact.main([tok, ckpt, str(ban), "--data_dir", root, "--no_cache"])
