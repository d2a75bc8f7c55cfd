"""Rematerialisation and the keyed dropout masks of the PyTorch port, on
the CPU.

  * the forward with checkpoint_freq=1 against the JAX package's forward
    with checkpoint_freq=1 (weights through the converter, rtol 2e-4 /
    atol 2e-5 as tests/test_torch_model.py), and its gradients (within
    2e-4 of each one's largest value, as tests/test_torch_train.py);
  * at dropout 0.1, remat (checkpoint_freq 1 and 2, policies 'full' and
    'dots') against no remat: loss and every gradient bit for bit, on the
    train step's compute copy (fp32, and bf16 once);
  * 'dots' recomputes no projection and 'full' recomputes all four;
  * a block run twice with the same seeds draws the same masks, the keep
    rate of the residual stream, distinct seeds per (layer, site);
  * the CLI with the JAX CLI test's lever flags: finite losses, equal to
    the run without --checkpoint_freq.

Sizes: 2 layers, d <= 64, T 128, a numpy seed for every input."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import omnibiote_tpu as obt
from omnibiote_tpu.ops.segments import segment_ids_np

import omnibiote_tpu_torch as port
from omnibiote_tpu_torch.models import omnibiota as port_model
from omnibiote_tpu_torch.training import cli as port_cli
from omnibiote_tpu_torch.training.mlm import mlm_loss
from omnibiote_tpu_torch.training.train import _compute_copy
from omnibiote_tpu_torch.utils.convert import state_from_jax_params

CFG_KW = dict(n_layer=2, n_embd=64, n_head=1, vocab_size=512, block_size=128,
              compute_dtype="float32", param_dtype="float32")


def _tokens(B=2, T=128, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(20, 512, size=(B, T)).astype(np.int32)
    for r in range(B):
        toks[r, rng.choice(np.arange(8, T - 8), size=2, replace=False)] = obt.EOS_TOKEN
    return toks, segment_ids_np(toks)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_forward_and_grads_match_jax(policy):
    """One head of 64 (the JAX dense path) at dropout 0, so the JAX and
    port streams do not enter; training forward with gradients, where the
    port takes torch.utils.checkpoint and JAX jax.checkpoint."""
    kw = dict(CFG_KW, n_head=1, dropout=0.0, checkpoint_freq=1, remat_policy=policy,
              attn_impl="xla")
    jcfg, pcfg = obt.OmniBioTAConfig(**kw), port.OmniBioTAConfig(**kw)
    params = jax.tree.map(np.asarray, jax.jit(obt.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    toks, seg = _tokens()
    r = np.random.default_rng(3).standard_normal((2, 128, 512)).astype(np.float32)

    def jloss(p):
        logits = obt.forward(p, jcfg, jnp.asarray(toks), segment_ids=jnp.asarray(seg),
                             deterministic=False, rng=jax.random.PRNGKey(1))
        return jnp.sum(logits * r), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    model = port.OmniBioTA(pcfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           state_from_jax_params(params, pcfg).items()})
    logits = model(torch.from_numpy(toks), torch.from_numpy(seg), deterministic=False,
                   rng=1)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=2e-4, atol=2e-5)
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad((logits * torch.from_numpy(r)).sum(), ps)
    want = state_from_jax_params(jax.tree.map(np.asarray, jgrads), pcfg)
    for n, g in zip(names, grads):
        bound = 2e-4 * np.abs(want[n]).max()
        assert np.abs(g.numpy() - want[n]).max() <= bound, n


def _loss_and_grads(cf, policy, compute="float32", n_head=1):
    """mlm_loss at dropout 0.1 and its gradients on the train step's
    compute copy (`functional_call`), weights from one seed."""
    cfg = port.OmniBioTAConfig(**dict(CFG_KW, n_head=n_head, dropout=0.1,
                                      checkpoint_freq=cf, remat_policy=policy,
                                      compute_dtype=compute))
    model = port.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks, seg = _tokens()
    params_c = _compute_copy(dict(model.named_parameters()), cfg)
    loss, _ = mlm_loss(model, torch.from_numpy(toks), torch.from_numpy(seg), 1234,
                       params=params_c)
    return loss, torch.autograd.grad(loss, list(params_c.values()))


@pytest.mark.parametrize("cf", [1, 2])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_is_bit_exact(cf, policy):
    """Flash path (one head of 64: the kernels' plain versions) with its
    dropout and both residual masks: remat changes no bit."""
    loss0, grads0 = _loss_and_grads(0, "full")
    loss, grads = _loss_and_grads(cf, policy)
    assert torch.equal(loss, loss0)
    assert len(grads) == len(grads0) == 3 + 6 * CFG_KW["n_layer"]
    for g, g0 in zip(grads, grads0):
        assert torch.equal(g, g0)


def test_remat_uses_the_compute_copy():
    """bf16 compute over fp32 masters: the recompute, which runs after
    mlm_loss's functional_call has returned, must take the bf16 copy (the
    module's own fp32 weights would fail the checkpoint's metadata check or
    change the bits)."""
    loss0, grads0 = _loss_and_grads(0, "full", compute="bfloat16")
    loss, grads = _loss_and_grads(1, "dots", compute="bfloat16")
    assert torch.equal(loss, loss0)
    assert all(torch.equal(g, g0) for g, g0 in zip(grads, grads0))


def test_recompute_shares_the_segment_bounds(monkeypatch):
    """The recompute reads the forward's SegmentBounds holder (filled
    lazily): one holder a micro-batch with remat as without."""
    from omnibiote_tpu_torch.ops import flash_attention as fa

    made = []

    class Counted(fa.SegmentBounds):
        def __init__(self, ids):
            made.append(self)
            super().__init__(ids)

    monkeypatch.setattr(port_model, "SegmentBounds", Counted)
    monkeypatch.setattr(fa, "SegmentBounds", Counted)
    for cf in (0, 1):
        made.clear()
        _loss_and_grads(cf, "full")
        assert len(made) == 1, (cf, len(made))


class _CountMm(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,extra", [("dots", 0), ("full", 4)])
def test_policy_decides_what_the_backward_recomputes(policy, extra):
    """The backward's products: 'dots' reruns none of the four projections
    (their outputs were kept), 'full' reruns all four in every layer."""
    counts = {}
    for cf in (0, 1):
        cfg = port.OmniBioTAConfig(**dict(CFG_KW, dropout=0.1, checkpoint_freq=cf,
                                          remat_policy=policy))
        model = port.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        toks, seg = _tokens()
        loss, _ = mlm_loss(model, torch.from_numpy(toks), torch.from_numpy(seg), 5)
        with _CountMm() as mode:
            torch.autograd.grad(loss, list(model.parameters()))
        counts[cf] = mode.n
    assert counts[1] == counts[0] + extra * CFG_KW["n_layer"], counts


def test_block_with_the_same_seeds_draws_the_same_masks():
    cfg = port.OmniBioTAConfig(**dict(CFG_KW, dropout=0.1))
    model = port.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    blk = model.transformer.h[0]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 128, 64))
                         .astype(np.float32))
    _, seeds = port_model._forward_rngs(77, cfg.n_layer)
    rope = (model.rope_cos, model.rope_sin)
    args = (cfg, model.qkv_perm, rope, None)
    with torch.no_grad():
        a = blk(x, *args, seeds[0])
        b = blk(x, *args, seeds[0])
        c = blk(x, *args, seeds[1])
        d = blk(x, *args, None)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


def test_dropout_stream_keep_rate_and_seeds():
    """Each site keeps 1 - rate of its elements (within 5 sigma), kept ones
    scaled by 1/(1 - rate); two sites' masks are independent (agreement
    near rate² + (1 - rate)²); the seeds of a forward are all distinct."""
    rate, n = 0.1, 400_000
    emb, seeds = port_model._forward_rngs(2024, 4)
    flat = [emb, *[s for layer in seeds for s in layer]]
    assert len(flat) == 1 + 3 * 4 == len(set(flat))
    ones = torch.ones(n)
    masks = []
    for seed in flat[:3]:
        y = port_model._dropout(ones, rate, seed)
        kept = y != 0
        assert torch.equal(y, port_model._dropout(ones, rate, seed))
        assert abs(kept.float().mean().item() - (1 - rate)) < 5 * (rate * (1 - rate) / n) ** 0.5
        assert torch.allclose(y[kept], torch.tensor(1 / (1 - rate)))
        masks.append(kept)
    agree = (masks[0] == masks[1]).float().mean().item()
    assert abs(agree - (rate ** 2 + (1 - rate) ** 2)) < 0.01
    assert port_model._dropout(ones, rate, None) is ones


def _corpus(root, n_seq=200, seed=0):
    rng = np.random.default_rng(seed)
    for corpus in ("genbank/train", "uniref100/train", "genbank/val", "uniref100/val"):
        d = root / corpus
        d.mkdir(parents=True)
        toks = []
        for _ in range(n_seq):
            seq = rng.integers(20, 512, size=int(rng.integers(5, 60)))
            seq[-1] = obt.EOS_TOKEN
            toks.extend(seq.tolist())
        np.save(d / "s0.npy", np.asarray(toks, np.int32))


def test_cli_memory_levers_match_no_remat(tmp_path):
    """tests/test_cli_end_to_end.py's lever flags on the port's CLI (one
    device, so A = 1 takes batch = mini = 8): 4 steps with finite losses,
    the same losses as without --checkpoint_freq, dropout 0.1."""
    _corpus(tmp_path / "data")
    losses = {}
    for remat in (True, False):
        log = tmp_path / f"m{int(remat)}.jsonl"
        flags = ["--checkpoint_freq", "1", "--remat_policy", "dots"] if remat else []
        trainer = port_cli.run([
            "--base_dir", str(tmp_path / "data"), "--train_type", "mixed",
            "--batch_size", "8", "--mini_batch_size", "8", "--n_layer", "2",
            "--n_head", "2", "--n_embd", "32", "--ctx_len", "64", "--dropout", "0.1",
            "--max_steps", "4", "--log_every", "1", "--metrics_jsonl", str(log),
            "--test_freq", "1e9", "--save_dir", str(tmp_path / f"ck{int(remat)}"),
            "--moment_dtype", "bfloat16", "--grad_dtype", "bfloat16", "--gelu", "fast",
            "--device", "cpu", *flags])
        assert trainer.step == 4
        assert trainer.model_cfg.checkpoint_freq == (1 if remat else 0)
        assert trainer.opt_state.mu["lm_head.weight"].dtype == torch.bfloat16
        recs = [json.loads(line) for line in log.read_text().splitlines()]
        losses[remat] = [r["loss"] for r in recs if "loss" in r]
    assert len(losses[True]) == 4 and np.isfinite(losses[True]).all()
    assert losses[True] == losses[False]
