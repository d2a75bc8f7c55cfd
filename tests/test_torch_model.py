"""PyTorch port vs the JAX package: the OmniBioTA forward, `encode`, the
weight converter and the checkpoint reader, on the CPU at fp32.

Weights come from the JAX package's `init_params`, with LayerNorm scales and
biases perturbed by a numpy seed so that every leaf matters, and reach the
port through `state_from_jax_params`. Tolerance rtol 2e-4 / atol 2e-5, as in
tests/test_model_parity.py (fp32 sums in another order).

Two tiny shapes: two heads of 64 (the JAX dispatch sends them to its dense
path), and one head of 128, which the JAX dispatch sends to the Pallas
kernel (interpret mode on the CPU) and the port to the kernel's plain
version.
"""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omnibiote_tpu as obt
from omnibiote_tpu.ops.segments import segment_ids_np
from omnibiote_tpu.utils.torch_convert import torch_state_from_params

import omnibiote_tpu_torch as port
from omnibiote_tpu_torch.training.checkpoint import (
    load_model_checkpoint, load_pytree_flat)
from omnibiote_tpu_torch.utils.convert import (
    jax_params_from_state, state_from_jax_params)

RTOL, ATOL = 2e-4, 2e-5
SHAPES = {"h2d64": dict(n_head=2), "h1d128": dict(n_head=1)}


def _cfg_kw(shape, **kw):
    base = dict(n_layer=2, n_embd=128, vocab_size=512, block_size=256,
                dropout=0.0, compute_dtype="float32", param_dtype="float32")
    base.update(SHAPES[shape])
    base.update(kw)
    return base


def _jax_params_np(cfg_kw, seed=0):
    cfg = obt.OmniBioTAConfig(**cfg_kw)
    params = jax.tree.map(np.asarray, obt.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        name = path[-1].key
        if name == "scale":
            return (x + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        if name.startswith("b") and name != "blocks":
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(perturb, params)


def _port_model(params_np, cfg_kw):
    cfg = port.OmniBioTAConfig(**cfg_kw)
    model = port.OmniBioTA(cfg, device="cpu")
    state = state_from_jax_params(params_np, cfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()}, strict=True)
    return model.eval()


def _tokens(B, T, vocab, seed=1, eos_every=None):
    rng = np.random.default_rng(seed)
    idx = rng.integers(4, vocab, size=(B, T)).astype(np.int32)
    if eos_every:
        idx[:, eos_every::eos_every] = obt.EOS_TOKEN
        idx[:, rng.integers(5, T - 5)] = obt.EOS_TOKEN
    return idx


@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("gelu", ["erf", "fast"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_matches_jax(shape, bias, gelu, impl):
    """Logits with packed segment ids, and final-LN embeddings without."""
    kw = _cfg_kw(shape, bias=bias, gelu=gelu, attn_impl=impl)
    params = _jax_params_np(kw)
    model = _port_model(params, kw)
    jcfg = obt.OmniBioTAConfig(**kw)
    jparams = jax.tree.map(jnp.asarray, params)
    idx = _tokens(2, 128, kw["vocab_size"], eos_every=37)
    seg = segment_ids_np(idx)

    want = np.asarray(obt.forward(jparams, jcfg, jnp.asarray(idx),
                                  segment_ids=jnp.asarray(seg)))
    with torch.no_grad():
        got = port.forward(model, torch.from_numpy(idx),
                           torch.from_numpy(seg)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    want = np.asarray(obt.forward(jparams, jcfg, jnp.asarray(idx),
                                  return_embeddings=True))
    with torch.no_grad():
        got = port.forward(model, torch.from_numpy(idx),
                           return_embeddings=True).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", ["mean", "first", "last", "max", "all"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_encode_matches_jax(shape, method):
    kw = _cfg_kw(shape, bias=True)
    params = _jax_params_np(kw, seed=2)
    model = _port_model(params, kw)
    idx = _tokens(3, 128, kw["vocab_size"], seed=3)
    want = np.asarray(obt.encode(jax.tree.map(jnp.asarray, params),
                                 obt.OmniBioTAConfig(**kw), jnp.asarray(idx),
                                 method))
    got = port.encode(model, torch.from_numpy(idx), method).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_forward_ragged_length_takes_dense_path():
    """T % 128 != 0: both packages take the dense attention."""
    kw = _cfg_kw("h1d128")
    params = _jax_params_np(kw, seed=4)
    model = _port_model(params, kw)
    idx = _tokens(2, 72, kw["vocab_size"], seed=5, eos_every=20)
    seg = segment_ids_np(idx)
    want = np.asarray(obt.forward(jax.tree.map(jnp.asarray, params),
                                  obt.OmniBioTAConfig(**kw), jnp.asarray(idx),
                                  segment_ids=jnp.asarray(seg)))
    with torch.no_grad():
        got = model(torch.from_numpy(idx), torch.from_numpy(seg)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_convert_round_trip(bias):
    """state_from_jax_params then jax_params_from_state is the identity,
    bias leaves included; the weights agree with the JAX package's own
    converter, which carries no bias leaves."""
    kw = _cfg_kw("h2d64", bias=bias)
    cfg = port.OmniBioTAConfig(**kw)
    params = _jax_params_np(kw, seed=6)
    state = state_from_jax_params(params, cfg)
    back = jax_params_from_state(state, cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)

    jax_state = torch_state_from_params(params, obt.OmniBioTAConfig(**kw))
    bias_keys = {k for k in state if k.endswith(".bias")}
    assert set(state) - bias_keys == set(jax_state)
    assert bool(bias_keys) == bias
    if bias:
        assert len(bias_keys) == 6 * cfg.n_layer + 1
    for k, v in jax_state.items():
        np.testing.assert_array_equal(state[k], v)
    # the port's module has exactly these keys, in the reference layout
    model = port.OmniBioTA(cfg, device="cpu")
    assert set(model.state_dict()) == set(state)
    assert model.state_dict()["transformer.h.0.attn.c_attn.weight"].shape == (
        3 * cfg.n_embd, cfg.n_embd)


def test_init_params_statistics():
    """The µP init: N(0,1) embeddings, U(±1/sqrt(fan_in)) hidden weights,
    readout scaled by sqrt(width_mult), LayerNorm 1, biases 0."""
    cfg = port.OmniBioTAConfig(**_cfg_kw("h2d64", bias=True, vocab_size=4096))
    g = torch.Generator().manual_seed(0)
    model = port.init_params(g, cfg, device="cpu")
    sd = model.state_dict()
    D = cfg.n_embd
    assert abs(sd["transformer.wte.weight"].std().item() - 1.0) < 0.02
    w = sd["transformer.h.0.mlp.c_proj.weight"]
    assert w.abs().max().item() <= 1 / np.sqrt(4 * D)
    assert abs(w.std().item() - 1 / np.sqrt(3 * 4 * D)) < 0.05 / np.sqrt(4 * D)
    head = sd["lm_head.weight"]
    assert head.abs().max().item() <= np.sqrt(cfg.width_mult / D)
    assert head.abs().max().item() > 0.9 * np.sqrt(cfg.width_mult / D)
    assert (sd["transformer.h.1.ln_2.weight"] == 1).all()
    assert (sd["transformer.h.1.attn.c_attn.bias"] == 0).all()
    jparams = obt.init_params(jax.random.PRNGKey(0), obt.OmniBioTAConfig(
        **_cfg_kw("h2d64", bias=True, vocab_size=4096)))
    assert port.num_params(model) == obt.num_params(jparams)
    assert port.num_params(model, False) == obt.num_params(jparams, False)
    # same generator state, same weights
    again = port.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    for k, v in again.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_config_matches_jax():
    jfields = set(obt.OmniBioTAConfig.__dataclass_fields__)
    assert set(port.OmniBioTAConfig.__dataclass_fields__) == jfields
    assert port.OmniBioTAConfig() == port.OmniBioTAConfig(
        **{k: getattr(obt.OmniBioTAConfig(), k) for k in jfields})
    from omnibiote_tpu.config import PRESETS as JP
    from omnibiote_tpu_torch.config import PRESETS as PP
    assert PP == JP
    assert (port.EOS_TOKEN, port.PAD_TOKEN, port.MASK_TOKEN, port.UNK_TOKEN) \
        == (obt.EOS_TOKEN, obt.PAD_TOKEN, obt.MASK_TOKEN, obt.UNK_TOKEN)
    assert port.BANNED_TOKEN == obt.BANNED_TOKEN
    small = port.preset("omnibiote-small")
    assert (small.n_layer, small.n_embd, small.head_dim) == (8, 1024, 128)
    assert small.cdtype() == torch.bfloat16 and small.pdtype() == torch.float32
    with pytest.raises(ValueError):
        port.preset("omnibiote-medium").head_dim


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A checkpoint written by the JAX Trainer, as tests/test_api.py builds it."""
    from omnibiote_tpu import TrainConfig
    from omnibiote_tpu.training.train import Trainer
    cfg = obt.OmniBioTAConfig(**_cfg_kw("h2d64"))
    tc = TrainConfig(batch_size=8, mini_batch_size=1, ctx_len=128,
                     token_budget=1e9,
                     save_dir=str(tmp_path_factory.mktemp("ck")), save_name="m")
    trainer = Trainer(cfg, tc, batch_iter=iter(()))
    return trainer.save_checkpoint(final=True), trainer


def test_load_jax_checkpoint(jax_checkpoint):
    path, trainer = jax_checkpoint
    model, cfg = load_model_checkpoint(path, device="cpu")
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["model_cfg"]["n_embd"] == cfg.n_embd
    want = torch_state_from_params(jax.tree.map(np.asarray, trainer.params), cfg)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k])
    idx = _tokens(2, 128, cfg.vocab_size, seed=7)
    want = np.asarray(obt.encode(trainer.params, trainer.model_cfg,
                                 jnp.asarray(idx), "mean"))
    got = port.encode(model, torch.from_numpy(idx), "mean").numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_load_pytree_flat_bf16(tmp_path):
    """'::bf16' leaves (raw uint16 bits) come back as torch.bfloat16."""
    import ml_dtypes
    from omnibiote_tpu.training.checkpoint import save_pytree
    rng = np.random.default_rng(8)
    tree = {"a": {"w": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)},
            "b": rng.standard_normal(4).astype(np.float32)}
    path = str(tmp_path / "p.npz")
    save_pytree(path, tree)
    flat = load_pytree_flat(path)
    assert set(flat) == {"a/w", "b"}
    assert flat["a/w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(flat["a/w"].float().numpy(),
                                  tree["a"]["w"].astype(np.float32))
    np.testing.assert_array_equal(flat["b"].numpy(), tree["b"])


def test_sharded_checkpoint_raises(tmp_path):
    """A directory with neither params.npz nor shard files raises on load,
    and on resume (resuming from the pod-sharded format is ported:
    tests/test_torch_parallel_checkpoint.py)."""
    from omnibiote_tpu_torch.training.checkpoint import restore_into_trainer
    with open(tmp_path / "meta.json", "w") as f:
        json.dump({"model_cfg": _cfg_kw("h2d64")}, f)
    with pytest.raises(FileNotFoundError, match="params.shard"):
        load_model_checkpoint(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match="params.shard"):
        restore_into_trainer(None, str(tmp_path))
