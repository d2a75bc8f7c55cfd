"""PyTorch port vs the JAX package: the MLM objective, µP and the optimizer,
the train step, the Trainer, checkpoints and the CLI, on the CPU.

Small size: 2 layers, d 256, 2 heads of 128, vocab 512, T 256, B 2, A 2
(the Trainer tests: vocab 64, T 64, so that 30 steps visibly learn).
Parameters come from the JAX package's `init_params` and reach the port
through `state_from_jax_params`; inputs come from numpy seeds; MLM masks
come from the JAX package's `make_mlm_mask` and reach the port through
`mask=` (the two packages' random streams differ). Parity runs at fp32
compute and dropout 0."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omnibiote_tpu as obt
from omnibiote_tpu import mup as jax_mup
from omnibiote_tpu.ops.segments import segment_ids_np
from omnibiote_tpu.parallel.mesh import make_mesh
from omnibiote_tpu.training import mlm as jax_mlm
from omnibiote_tpu.training import optim as jax_optim
from omnibiote_tpu.training import train as jax_train

import omnibiote_tpu_torch as port
from omnibiote_tpu_torch import mup as port_mup
from omnibiote_tpu_torch.config import TrainConfig
from omnibiote_tpu_torch.training import cli as port_cli
from omnibiote_tpu_torch.training import mlm as port_mlm
from omnibiote_tpu_torch.training import optim as port_optim
from omnibiote_tpu_torch.training import train as port_train
from omnibiote_tpu_torch.training.checkpoint import load_model_checkpoint
from omnibiote_tpu_torch.utils.convert import (
    jax_opt_state_from_port, opt_state_from_jax, state_from_jax_params)

CFG_KW = dict(n_layer=2, n_embd=256, n_head=2, vocab_size=512, block_size=256,
              dropout=0.0, compute_dtype="float32", param_dtype="float32")
B, T = 2, 256


def _cfgs(**kw):
    ckw = dict(CFG_KW, **kw)
    return obt.OmniBioTAConfig(**ckw), port.OmniBioTAConfig(**ckw)


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, obt.init_params(jax.random.PRNGKey(seed), cfg))


def _port_model(params_np, pcfg):
    model = port.OmniBioTA(pcfg, device="cpu")
    state = state_from_jax_params(params_np, pcfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return model


def structured_rows(n, ctx, vocab, rng):
    """Rows where token t+1 follows t inside EOS-delimited segments, so MLM
    is learnable."""
    rows = []
    for _ in range(n):
        row = []
        while len(row) < ctx:
            start = int(rng.integers(4, vocab - 12))
            row.extend(range(start, start + int(rng.integers(4, 10))))
            row.append(obt.EOS_TOKEN)
        rows.append(row[:ctx])
    return np.asarray(rows, np.int32)


def synth_batches(batch_size, ctx, vocab, seed=0):
    rng = np.random.default_rng(seed)
    while True:
        toks = structured_rows(batch_size, ctx, vocab, rng)
        yield {"tokens": toks, "segments": segment_ids_np(toks)}


def _assert_close_to_max(got, want, rel, name):
    """|got - want| <= rel * max|want| elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = rel * max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= bound, (name, np.abs(got - want).max(), bound)


# ---------------------------------------------------------------------------
# MLM objective
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_mlm_loss_and_grads_match_jax(impl):
    """Loss at rtol 2e-5; every parameter gradient within 2e-4 of its
    largest value (fp32 sums in another order; the flash case runs the
    JAX package's Pallas kernels in interpret mode against the port's
    plain versions)."""
    jcfg, pcfg = _cfgs(attn_impl=impl)
    params = _jax_params(jcfg)
    toks = structured_rows(B, T, 512, np.random.default_rng(1))
    seg = segment_ids_np(toks)
    rng = jax.random.PRNGKey(3)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jax_mlm.mlm_loss(p, jcfg, jnp.asarray(toks), jnp.asarray(seg),
                                   rng, deterministic=True), has_aux=True)(params)
    mask = np.asarray(jax_mlm.make_mlm_mask(jax.random.split(rng)[0],
                                            jnp.asarray(toks), 0.15))
    model = _port_model(params, pcfg)
    loss, aux = port_mlm.mlm_loss(model, torch.from_numpy(toks),
                                  torch.from_numpy(seg), 0, deterministic=True,
                                  mask=torch.from_numpy(mask.copy()))
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, ps)
    assert loss.item() == pytest.approx(float(jloss), rel=2e-5)
    assert int(aux["masked_count"]) == int(jaux["masked_count"])
    assert int(aux["num_tokens"]) == int(jaux["num_tokens"])
    want = state_from_jax_params(jax.tree.map(np.asarray, jgrads), pcfg)
    for n, g in zip(names, grads):
        _assert_close_to_max(g.numpy(), want[n], 2e-4, n)


def test_compaction_overflow_drops_the_same_positions():
    """With capacity below the masked count, the port keeps each row's first
    `capacity` masked positions, as the JAX package's oracle does, and the
    loss over them agrees."""
    rng = np.random.default_rng(4)
    toks = structured_rows(B, T, 512, rng)
    mask = (rng.random((B, T)) < 0.5) & (toks != obt.EOS_TOKEN)
    cap = 12
    jorder, jvalid = jax_mlm._masked_order(jnp.asarray(mask), cap)
    order, valid = port_mlm.masked_order(torch.from_numpy(mask), cap)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(order.numpy()[valid.numpy()],
                                  np.asarray(jorder)[np.asarray(jvalid)])
    assert mask.sum(1).min() > cap
    jcfg, pcfg = _cfgs(attn_impl="xla")
    params = _jax_params(jcfg)
    seg = segment_ids_np(toks)
    # JAX draws its mask from the key: hand the port the same one
    key = jax.random.PRNGKey(8)
    jmask = np.asarray(jax_mlm.make_mlm_mask(jax.random.split(key)[0],
                                             jnp.asarray(toks), 0.5))
    jloss, _ = jax_mlm.mlm_loss(params, jcfg, jnp.asarray(toks), jnp.asarray(seg),
                                key, mask_prob=0.5, deterministic=True,
                                capacity_frac=0.05)
    loss, aux = port_mlm.mlm_loss(_port_model(params, pcfg), torch.from_numpy(toks),
                                  torch.from_numpy(seg), 0, mask_prob=0.5,
                                  deterministic=True, capacity_frac=0.05,
                                  mask=torch.from_numpy(jmask))
    assert int(aux["masked_count"]) == B * cap
    assert loss.item() == pytest.approx(float(jloss), rel=2e-5)


def test_mlm_mask_never_masks_pad_or_eos():
    toks = torch.randint(0, 8, (4, 512), generator=torch.Generator().manual_seed(0))
    mask = port_mlm.make_mlm_mask(torch.Generator().manual_seed(1), toks, 0.9)
    assert not mask[(toks == port.PAD_TOKEN) | (toks == port.EOS_TOKEN)].any()
    assert mask.any()
    assert port_mlm._default_capacity_frac(0.15) == jax_mlm._default_capacity_frac(0.15)
    assert port_mlm._default_capacity_frac(0.9) == jax_mlm._default_capacity_frac(0.9)


# ---------------------------------------------------------------------------
# µP, schedules, batch ramp
# ---------------------------------------------------------------------------

def test_schedules_and_mup_multipliers_match_jax():
    for lr, bs in [(1e-2, 1024), (3e-3, 32), (0.1, 7)]:
        kw = dict(lr=lr, batch_size=bs)
        assert port_optim.scaled_lr(TrainConfig(**kw)) == jax_optim.scaled_lr(
            obt.TrainConfig(**kw))
    for base, total in [(0.01, 100), (1.0, 7), (0.3, 0)]:
        js, ps = jax_optim.linear_decay(base, total), port_optim.linear_decay(base, total)
        for c in [0, 1, 3, 50, 99, 100, 150]:
            assert ps(c) == float(js(jnp.int32(c)))
    for ramp in (False, True):
        for warm in (0.05, 0.5, 0.0):
            kw = dict(batch_size=64, mini_batch_size=4, batch_ramp=ramp,
                      warmup_period=warm)
            for step in range(0, 60, 3):
                for micro in (None, 8):
                    assert (port_train.effective_batch_size(step, 100, TrainConfig(**kw), micro)
                            == jax_train.effective_batch_size(
                                step, 100, obt.TrainConfig(**kw), micro))
    for bias in (False, True):
        jcfg, pcfg = _cfgs(bias=bias)
        params = _jax_params(jcfg)
        names = list(state_from_jax_params(params, pcfg))
        for force in (False, True):
            for dec in (False, True):
                jl = jax_mup.lr_mult_tree(params, jcfg, force_lr=force)
                jw = jax_mup.wd_mult_tree(params, jcfg, force_lr=force, decoupled=dec)
                fill = lambda t: jax.tree.map(lambda m, p: np.full(p.shape, m), t, params)
                for port_tree, jtree in (
                        (port_mup.lr_mult_tree(names, pcfg, force_lr=force), jl),
                        (port_mup.wd_mult_tree(names, pcfg, force_lr=force,
                                               decoupled=dec), jw)):
                    want = state_from_jax_params(fill(jtree), pcfg)
                    for n in names:
                        assert np.all(want[n] == port_tree[n]), n


# ---------------------------------------------------------------------------
# The train step against the JAX step
# ---------------------------------------------------------------------------

def _run_steps(A, weights, tc_kw, n_steps=3, attn_impl="xla"):
    """Run n_steps of both packages' train steps from the same parameters;
    returns per-step (jax metrics, port metrics, jax params, port params,
    jax opt leaves, port opt state)."""
    jcfg, pcfg = _cfgs(attn_impl=attn_impl)
    params = _jax_params(jcfg, seed=1)
    jtc = obt.TrainConfig(batch_size=A * B, mini_batch_size=B, ctx_len=T,
                          lr=3e-3, **tc_kw)
    ptc = TrainConfig(batch_size=A * B, mini_batch_size=B, ctx_len=T, lr=3e-3, **tc_kw)
    jopt = jax_optim.make_optimizer(params, jcfg, jtc, 50)
    jstate = jopt.init(params)
    jstep = jax.jit(jax_train.make_train_step(jcfg, jtc, jopt))
    model = _port_model(params, pcfg)
    pparams = dict(model.named_parameters())
    popt = port_optim.make_optimizer(list(pparams), pcfg, ptc, 50)
    pstate = popt.init(pparams)
    pstep = port_train.make_train_step(model, pcfg, ptc, popt)

    rng = np.random.default_rng(2)
    key = jax.random.PRNGKey(5)
    jparams = jax.tree.map(jnp.asarray, params)
    out = []
    for s in range(n_steps):
        toks = np.stack([structured_rows(B, T, 512, rng) for _ in range(A)])
        segs = np.stack([segment_ids_np(t) for t in toks])
        w = weights[s]
        jparams, jstate, jm = jstep(jparams, jstate, jnp.asarray(toks),
                                    jnp.asarray(segs), jnp.asarray(w, jnp.float32),
                                    key, jnp.int32(s))
        masks = np.stack([np.asarray(jax_mlm.make_mlm_mask(
            jax.random.split(jax.random.fold_in(jax.random.fold_in(key, s), i))[0],
            jnp.asarray(toks[i]), 0.15)) for i in range(A)])
        pm = pstep(pparams, pstate, torch.from_numpy(toks), torch.from_numpy(segs),
                   w, 0, s, masks=torch.from_numpy(masks))
        out.append((jm, pm, jax.tree.map(np.asarray, jparams),
                    {n: p.detach().clone() for n, p in pparams.items()},
                    jax.tree.leaves(jstate), copy.deepcopy(pstate)))
    return pcfg, out


def _compare_step(pcfg, jm, pm, jparams, pparams, jleaves, pstate, tol_p, tol_m):
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=2e-5)
    assert float(pm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    assert float(pm["masked_tokens"]) == float(jm["masked_tokens"])
    assert int(pm["num_tokens"]) == int(jm["num_tokens"])
    want = state_from_jax_params(jparams, pcfg)
    for n, p in pparams.items():
        _assert_close_to_max(p.detach().numpy(), want[n], tol_p, n)
    jst = opt_state_from_jax(jleaves, pcfg)
    assert (pstate.count, pstate.sched_count) == (jst.count, jst.sched_count)
    for n in pparams:
        _assert_close_to_max(pstate.mu[n].float().numpy(), jst.mu[n].float().numpy(),
                             tol_m, "mu " + n)
        _assert_close_to_max(pstate.nu[n].float().numpy(), jst.nu[n].float().numpy(),
                             tol_m, "nu " + n)


def test_train_step_with_accumulation_matches_jax():
    """A = 2, fp32 moments, three steps, the second with an inactive slot.
    Loss at rtol 2e-5 and grad_norm at 1e-4 (fp32 sums in another order);
    parameters within 1e-4 and moments within 2e-3 of their largest value:
    Adam divides by sqrt(nu), so a gradient element near zero amplifies
    the fp32 noise of the two autodiff implementations."""
    pcfg, out = _run_steps(2, [[1.0, 1.0], [1.0, 0.0], [1.0, 1.0]], {})
    for step in out:
        _compare_step(pcfg, *step, tol_p=1e-4, tol_m=2e-3)


def test_train_step_bf16_moments_and_grads_matches_jax():
    """A = 1 with moment_dtype and grad_dtype bfloat16: the moments are
    rounded to bf16 between steps in both (held to 1e-2 of their largest
    value, two bf16 ulps there), the parameters to 1e-4."""
    pcfg, out = _run_steps(1, [[1.0]] * 3, dict(moment_dtype="bfloat16",
                                                grad_dtype="bfloat16"))
    for jm, pm, jp, pp, jl, ps in out:
        assert ps.mu[next(iter(ps.mu))].dtype == torch.bfloat16
        _compare_step(pcfg, jm, pm, jp, pp, jl, ps, tol_p=1e-4, tol_m=1e-2)


def test_train_step_above_the_single_kv_limit_matches_jax(monkeypatch):
    """The flash path with more than one kv block a row, as the dispatch
    gives it above T = 1024: both models' attention calls get 128-wide
    blocks at T = 256, so the JAX package runs its multi-kv forward with
    skip bounds and `_mh_bwd_fusedmk` (Pallas, interpret mode) and the port
    its multi-kv route on the plain versions. Packed rows, A = 2, one step,
    at the tolerances of test_train_step_with_accumulation_matches_jax."""
    import functools

    from omnibiote_tpu.models import omnibiota as jax_model
    from omnibiote_tpu.ops import flash_attention as jax_flash
    from omnibiote_tpu_torch.models import omnibiota as port_model
    from omnibiote_tpu_torch.ops import flash_attention as port_flash

    blocks = dict(block_q=128, block_kv=128)
    monkeypatch.setattr(jax_model, "attention",
                        functools.partial(jax_model.attention, **blocks))
    monkeypatch.setattr(port_model, "attention",
                        functools.partial(port_model.attention, **blocks))
    seen = {"jax": 0, "port": []}
    jax_mk, port_bwd = jax_flash._mh_bwd_fusedmk, port_flash.mh_flash_backward

    def spy_jax(*a, **kw):
        seen["jax"] += 1
        return jax_mk(*a, **kw)

    def spy_port(*a, **kw):
        seen["port"].append((kw["block_q"], kw["block_kv"], kw["segment_skip"],
                             kw["bounds"] is not None))
        return port_bwd(*a, **kw)

    monkeypatch.setattr(jax_flash, "_mh_bwd_fusedmk", spy_jax)
    monkeypatch.setattr(port_flash, "mh_flash_backward", spy_port)
    pcfg, out = _run_steps(2, [[1.0, 1.0]], {}, n_steps=1, attn_impl="flash")
    assert seen["jax"] >= pcfg.n_layer
    assert seen["port"] == [(128, 128, True, True)] * (2 * pcfg.n_layer)
    _compare_step(pcfg, *out[0], tol_p=1e-4, tol_m=2e-3)


# ---------------------------------------------------------------------------
# Trainer, checkpoints, CLI
# ---------------------------------------------------------------------------

TINY = dict(n_layer=2, n_embd=256, n_head=2, vocab_size=64, block_size=64,
            attn_impl="flash")


def _trainer(dropout=0.1, seed=0, moment_dtype="float32", save_dir="ck"):
    cfg = port.OmniBioTAConfig(dropout=dropout, **TINY)
    tc = TrainConfig(batch_size=8, mini_batch_size=4, ctx_len=64, lr=5e-2,
                     token_budget=8 * 64 * 1000, seed=seed, save_dir=str(save_dir),
                     moment_dtype=moment_dtype)
    return port_train.Trainer(cfg, tc, batch_iter=synth_batches(8, 64, 64, seed),
                              device="cpu")


def test_training_lowers_the_loss():
    """30 steps of the tiny model (vocab 64, dropout 0.1, A = 2) on
    structured rows take the loss below 0.85 of where it started."""
    tr = _trainer()
    losses = []
    tr.run(max_steps=30, on_metrics=lambda r: losses.append(r["loss"]))
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.85 * np.mean(losses[:5]), losses


def test_resume_is_exact(tmp_path):
    """Save at step 3; the uninterrupted run and a fresh Trainer restored
    from the checkpoint take the same steps 4-6 bit for bit (masks and
    dropout are redrawn from the step alone)."""
    tr = _trainer(save_dir=tmp_path)
    for _ in range(3):
        tr.train_step_once()
    path = tr.save_checkpoint()
    tr.batch_iter = synth_batches(8, 64, 64, seed=9)
    ma = [tr.train_step_once() for _ in range(3)]
    t2 = _trainer(seed=1, save_dir=tmp_path)
    t2.restore_checkpoint(path)
    t2.batch_iter = synth_batches(8, 64, 64, seed=9)
    assert (t2.step, t2.rng) == (3, tr.rng)
    mb = [t2.train_step_once() for _ in range(3)]
    assert t2.step == tr.step
    for a, b in zip(ma, mb):
        assert float(a["loss"]) == float(b["loss"])
    for n, p in tr.params.items():
        assert torch.equal(p, t2.params[n]), n
        assert torch.equal(tr.opt_state.mu[n], t2.opt_state.mu[n]), n


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_packages(tmp_path, moment_dtype):
    """A port checkpoint restores into the JAX Trainer and a JAX checkpoint
    into the port's: parameters, moments and counts equal exactly."""
    tr = _trainer(save_dir=tmp_path / "port", moment_dtype=moment_dtype)
    for _ in range(2):
        tr.train_step_once()
    path = tr.save_checkpoint()
    cfg = obt.OmniBioTAConfig(dropout=0.1, **TINY)
    jtc = obt.TrainConfig(batch_size=8, mini_batch_size=4, ctx_len=64,
                          token_budget=8 * 64 * 1000, save_dir=str(tmp_path / "jax"),
                          moment_dtype=moment_dtype)
    mesh = make_mesh((1,), devices=jax.devices()[:1])
    jt = jax_train.Trainer(cfg, jtc, batch_iter=synth_batches(8, 64, 64), mesh=mesh)
    jt.restore_checkpoint(path)
    assert jt.step == tr.step
    pcfg = tr.model_cfg
    want = state_from_jax_params(jax.tree.map(np.asarray, jt.params), pcfg)
    for n, p in tr.params.items():
        np.testing.assert_array_equal(p.detach().numpy(), want[n])
    port_leaves = jax_opt_state_from_port(tr.opt_state, pcfg)
    jleaves = jax.tree.leaves(jt.opt_state)
    assert len(port_leaves) == len(jleaves)
    for a, b in zip(port_leaves, jleaves):
        a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype))

    # and back: the JAX trainer steps on, saves, the port restores
    jt.train_step_once()
    jpath = jt.save_checkpoint()
    t2 = _trainer(seed=3, save_dir=tmp_path / "port2", moment_dtype=moment_dtype)
    t2.restore_checkpoint(jpath)
    assert t2.step == jt.step
    want = state_from_jax_params(jax.tree.map(np.asarray, jt.params), pcfg)
    for n, p in t2.params.items():
        np.testing.assert_array_equal(p.detach().numpy(), want[n])
    jst = opt_state_from_jax(jax.tree.leaves(jt.opt_state), pcfg)
    for n in t2.params:
        assert torch.equal(t2.opt_state.mu[n], jst.mu[n].to(t2.opt_state.mu[n].dtype))
        assert torch.equal(t2.opt_state.nu[n], jst.nu[n].to(t2.opt_state.nu[n].dtype))
    assert (t2.opt_state.count, t2.opt_state.sched_count) == (jst.count, jst.sched_count)


def _shards(root, vocab=512, n_seq=200, seed=0):
    rng = np.random.default_rng(seed)
    for corpus in ("genbank/train", "uniref100/train", "genbank/val", "uniref100/val"):
        d = os.path.join(root, corpus)
        os.makedirs(d)
        for f in range(2):
            toks = []
            for _ in range(n_seq):
                seq = rng.integers(20, vocab, size=int(rng.integers(5, 60)))
                seq[-1] = obt.EOS_TOKEN
                toks.extend(seq.tolist())
            np.save(os.path.join(d, f"s{f}.npy"), np.asarray(toks, np.int32))


def test_cli_runs_end_to_end(tmp_path):
    """`cli.main` with --max_steps 2 on the CPU: logs finite losses and
    writes a final checkpoint that reloads equal to the trainer's params."""
    _shards(str(tmp_path / "data"))
    log = tmp_path / "m.jsonl"
    tr = port_cli.main([
        "--base_dir", str(tmp_path / "data"), "--n_layer", "1", "--n_embd", "128",
        "--n_head", "1", "--ctx_len", "128", "--mini_batch_size", "2",
        "--batch_size", "4", "--max_steps", "2", "--save_dir", str(tmp_path / "ck"),
        "--metrics_jsonl", str(log), "--log_every", "1", "--test_freq", "100",
        "--device", "cpu"])
    import json
    recs = [json.loads(l) for l in log.read_text().splitlines()]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert any(k.startswith("test_loss/") for r in recs for k in r)
    model, _ = load_model_checkpoint(str(tmp_path / "ck" / "omnibiota"), device="cpu")
    for n, p in model.named_parameters():
        assert torch.equal(p, tr.params[n]), n


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------

# The modes this package has since ported (fused_ce, checkpoint_freq > 0,
# the sharding modes, per-rank data and sequence parallelism) keep their
# cases here, now as checks that the mode runs (in a process group of one
# rank) or refuses a mesh the world cannot hold, or a configuration the JAX
# Trainer refuses (sharding='sp' without attn_impl='ring', fsdp+pp without a
# 2-D mesh, data_hosts > 1 on a pure-pp mesh). The pipeline trains too.
PORTED = ("fused_ce", "checkpoint_freq", "sharding", "multihost", "FSDP")


@pytest.mark.parametrize("model_kw,train_kw,hosts", [
    ({}, dict(sharding="fsdp"), 1),
    ({}, dict(mesh_shape=(2,)), 1),
    ({}, {}, 2),
    (dict(fused_ce=True), {}, 1),
    (dict(checkpoint_freq=1), {}, 1),
    (dict(attn_impl="ring"), {}, 1),
    ({}, dict(sharding="tp"), 1),
    ({}, dict(sharding="fsdp+tp", mesh_shape=(1, 1)), 1),
    ({}, dict(sharding="sp"), 1),
    ({}, dict(sharding="pp"), 1),
    ({}, dict(sharding="fsdp+pp"), 1),
    ({}, dict(sharding="fsdp+pp", mesh_shape=(1, 1)), 1),
    ({}, dict(sharding="pp"), 2),
])
def test_unported_modes_raise(model_kw, train_kw, hosts):
    """Every mode takes a Trainer step with finite metrics, the sharded
    ones on a mesh of this one process (a ring of one for
    attn_impl='ring', a stage axis of one for the pipeline); a mesh_shape
    or a data_hosts the world cannot hold is a ValueError, and so are
    sharding='sp' without attn_impl='ring', fsdp+pp without a 2-D mesh and
    data_hosts > 1 on a pure-pp mesh, as in the JAX Trainer."""
    cfg = port.OmniBioTAConfig(**dict(TINY, **model_kw))
    tc = TrainConfig(batch_size=8, mini_batch_size=4, ctx_len=64, **train_kw)
    if tc.sharding == "fsdp+pp" and tc.mesh_shape is None:
        with pytest.raises(ValueError, match="fsdp\\+pp needs a 2-D mesh"):
            port_train.Trainer(cfg, tc, device="cpu", data_hosts=hosts)
        return
    if tc.sharding == "sp" and cfg.attn_impl != "ring":
        with pytest.raises(ValueError, match="requires attn_impl='ring'"):
            port_train.Trainer(cfg, tc, device="cpu", data_hosts=hosts)
        return
    if tc.mesh_shape == (2,) or hosts > 1:
        with pytest.raises(ValueError, match="mesh shape|data_hosts"):
            port_train.Trainer(cfg, tc, device="cpu", data_hosts=hosts)
        return
    with port_train.Trainer(cfg, tc, batch_iter=synth_batches(8, 64, 64),
                            device="cpu", data_hosts=hosts) as tr:
        m = tr.train_step_once()
    assert tr.step == 1
    assert (tr.plan is None) == (tc.sharding == "replicated")
    assert (tr.plan is not None and tr.plan.stage is not None) == ("pp" in tc.sharding)
    assert all(np.isfinite(float(m[k])) for k in ("loss", "grad_norm"))


@pytest.mark.parametrize("flag", [["--multihost"], ["--FSDP"], ["--sharding", "tp"],
                                  ["--checkpoint_freq", "1"], ["--sharding", "sp"],
                                  ["--sharding", "pp"], ["--sharding", "fsdp+pp"],
                                  ["--sharding", "fsdp+pp", "--mesh_shape", "1", "1"]])
def test_cli_unported_flags_raise(tmp_path, flag):
    """Every flag trains a step (the multi-device ones on a mesh of this
    one process, sp as a ring of one, pp as a stage axis of one), but
    --sharding fsdp+pp without a 2-D --mesh_shape raises, as in the JAX
    CLI."""
    _shards(str(tmp_path))
    argv = ["--base_dir", str(tmp_path), "--n_layer", "1", "--n_embd", "128",
            "--n_head", "1", "--ctx_len", "128", "--device", "cpu", *flag]
    if flag[0].lstrip("-") in PORTED and flag[-1] != "fsdp+pp":
        log = tmp_path / "m.jsonl"
        tr = port_cli.main(argv + ["--mini_batch_size", "2", "--batch_size", "2",
                                   "--max_steps", "1", "--test_freq", "1e9",
                                   "--save_dir", str(tmp_path / "ck"),
                                   "--metrics_jsonl", str(log)])
        assert tr.step == 1
        assert tr.model_cfg.checkpoint_freq == (1 if "--checkpoint_freq" in flag else 0)
        assert tr.data_hosts == 1
        assert (tr.model_cfg.attn_impl == "ring") == (flag[-1] == "sp")
        import json
        losses = [json.loads(l)["loss"] for l in log.read_text().splitlines()]
        assert len(losses) == 1 and np.isfinite(losses[0])
        return
    with pytest.raises(ValueError, match="fsdp\\+pp needs a 2-D mesh"):
        port_cli.main(argv)


def test_fused_ce_loss_raises():
    """The fused head now runs: at fp32 its loss equals the plain head's."""
    toks = torch.from_numpy(structured_rows(2, 64, 64, np.random.default_rng(5)))
    losses = []
    for fused in (True, False):
        model = port.OmniBioTA(port.OmniBioTAConfig(**dict(TINY, fused_ce=fused)),
                               device="cpu")
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.linspace(-0.5, 0.5, p.numel()).reshape(p.shape))
        losses.append(port_mlm.mlm_loss(model, toks, None, 0)[0])
    assert torch.isfinite(losses[0])
    torch.testing.assert_close(losses[0], losses[1], rtol=1e-6, atol=1e-6)


def test_trainer_and_cli_need_a_gpu_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = port.OmniBioTAConfig(**TINY)
    tc = TrainConfig(batch_size=8, mini_batch_size=4, ctx_len=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.Trainer(cfg, tc)
    _shards(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["--base_dir", str(tmp_path), "--n_layer", "1", "--n_embd",
                       "128", "--n_head", "1", "--ctx_len", "128"])
