"""PyTorch port vs the JAX package: the vocab-chunked fused cross-entropy
(`ops/fused_ce.py`) and the MLM loss that takes it (`fused_ce=True`), on
the CPU at fp32.

The JAX function takes W as (D, V), the port's lm_head as (V, D): the same
numbers transposed. Value at rtol 1e-5, dx and dW at rtol 1e-5 with an
atol of 1e-6 for entries near zero (fp32 sums in another order);
tests/test_core_units.py holds the JAX function to the dense head the
same way."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omnibiote_tpu as obt
from omnibiote_tpu.ops import fused_ce as jax_fce
from omnibiote_tpu.ops.segments import segment_ids_np
from omnibiote_tpu.training import mlm as jax_mlm

import omnibiote_tpu_torch as port
from omnibiote_tpu_torch.ops import fused_ce as port_fce
from omnibiote_tpu_torch.training import mlm as port_mlm
from omnibiote_tpu_torch.utils.convert import state_from_jax_params

RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("n_chunks", [1, 4, 8])
def test_fused_ce_matches_jax(n_chunks):
    """Per-row nll, then dx and dW of a row-weighted sum, with two leading
    dims (the MLM head's (B, capacity))."""
    rng = np.random.default_rng(0)
    lead, D, V = (3, 8), 16, 64
    x = rng.standard_normal((*lead, D)).astype(np.float32)
    W = (rng.standard_normal((D, V)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, lead).astype(np.int32)
    g = rng.standard_normal(lead).astype(np.float32)

    def jloss(x, W):
        return jnp.sum(jax_fce.fused_cross_entropy(x, W, jnp.asarray(labels), n_chunks) * g)

    jnll = np.asarray(jax_fce.fused_cross_entropy(jnp.asarray(x), jnp.asarray(W),
                                                  jnp.asarray(labels), n_chunks))
    jdx, jdW = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(W))

    tx = torch.from_numpy(x).requires_grad_()
    tW = torch.from_numpy(W.T.copy()).requires_grad_()
    nll = port_fce.fused_cross_entropy(tx, tW, torch.from_numpy(labels), n_chunks)
    assert nll.shape == lead
    np.testing.assert_allclose(nll.detach().numpy(), jnll, rtol=RTOL)
    loss = (nll * torch.from_numpy(g)).sum()
    assert loss.item() == pytest.approx(float(jloss(jnp.asarray(x), jnp.asarray(W))),
                                        rel=RTOL)
    dx, dW = torch.autograd.grad(loss, (tx, tW))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dW.numpy(), np.asarray(jdW).T, rtol=RTOL, atol=ATOL)


def test_fused_ce_matches_the_dense_head():
    """The chunked online softmax against log_softmax of the whole logits."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((24, 16)).astype(np.float32))
    W = torch.from_numpy((rng.standard_normal((96, 16)) * 0.3).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 96, 24))
    nll = port_fce.fused_cross_entropy(x, W, labels, 6)
    dense = -torch.log_softmax(x @ W.t(), -1).gather(1, labels[:, None])[:, 0]
    torch.testing.assert_close(nll, dense, rtol=RTOL, atol=ATOL)


def test_pick_chunks_matches_jax():
    for v in (2, 64, 512, 16383, 16384, 32768, 50257, 65536, 65537, 100_000, 2 ** 17):
        assert port_fce.pick_chunks(v) == jax_fce.pick_chunks(v), v
        assert port_fce.pick_chunks(v, target=1000) == jax_fce.pick_chunks(v, target=1000), v


def test_non_dividing_chunks_raise():
    x, W = torch.zeros(4, 8), torch.zeros(10, 8)
    with pytest.raises(AssertionError, match="must divide"):
        port_fce.fused_cross_entropy(x, W, torch.zeros(4, dtype=torch.long), 4)


CFG_KW = dict(n_layer=2, n_embd=64, n_head=2, vocab_size=16384, block_size=128,
              dropout=0.0, compute_dtype="float32", param_dtype="float32",
              attn_impl="xla")


def test_mlm_loss_fused_matches_plain_and_jax():
    """mlm_loss with fused_ce=True (2 chunks of 8192 at vocab 16384) against
    the port's plain head (the same numbers, another order of sums) and
    against the JAX mlm_loss with fused_ce=True: loss at rtol 1e-5, every
    gradient within 1e-5 of its largest value (2e-4 against JAX, whose
    model sums in another order, as tests/test_torch_train.py holds it)."""
    assert port_fce.pick_chunks(CFG_KW["vocab_size"]) == 2
    jcfg = obt.OmniBioTAConfig(**CFG_KW, fused_ce=True)
    params = jax.tree.map(np.asarray, jax.jit(obt.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(2)
    toks = rng.integers(20, CFG_KW["vocab_size"], size=(2, 128)).astype(np.int32)
    toks[:, [40, 90]] = obt.EOS_TOKEN
    seg = segment_ids_np(toks)
    key = jax.random.PRNGKey(5)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_mlm.mlm_loss(p, jcfg, jnp.asarray(toks), jnp.asarray(seg), key,
                                   deterministic=True), has_aux=True))(params)
    mask = torch.from_numpy(np.asarray(jax_mlm.make_mlm_mask(
        jax.random.split(key)[0], jnp.asarray(toks), 0.15)).copy())

    out = {}
    for fused in (True, False):
        pcfg = port.OmniBioTAConfig(**CFG_KW, fused_ce=fused)
        model = port.OmniBioTA(pcfg, device="cpu")
        model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                               state_from_jax_params(params, pcfg).items()})
        loss, _ = port_mlm.mlm_loss(model, torch.from_numpy(toks), torch.from_numpy(seg),
                                    0, deterministic=True, mask=mask)
        names, ps = zip(*model.named_parameters())
        out[fused] = loss, dict(zip(names, torch.autograd.grad(loss, ps)))
    (lf, gf), (lp, gp) = out[True], out[False]
    assert lf.item() == pytest.approx(lp.item(), rel=1e-5)
    assert lf.item() == pytest.approx(float(jloss), rel=1e-5)
    want = state_from_jax_params(jax.tree.map(np.asarray, jgrads),
                                 port.OmniBioTAConfig(**CFG_KW))
    for n in gf:
        bound = np.abs(want[n]).max()
        assert (gf[n] - gp[n]).abs().max().item() <= 1e-5 * gp[n].abs().max().item(), n
        assert np.abs(gf[n].numpy() - want[n]).max() <= 2e-4 * bound, n
