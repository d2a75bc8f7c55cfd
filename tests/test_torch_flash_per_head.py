"""PyTorch port vs the JAX package: the per-head entry
`flash_attention(multi_head=False)`: forward and gradients against the JAX
package's per-head-grid kernels (`_fwd_kernel`, `_bwd_dkv_kernel`,
`_bwd_dq_kernel`, Pallas in interpret mode on the CPU), the split backward
it always takes, and its dropout."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from omnibiote_tpu.ops.flash_attention import flash_attention as jax_flash_attention

from omnibiote_tpu_torch.models.rope import rope_tables
from omnibiote_tpu_torch.ops import _kernels
from omnibiote_tpu_torch.ops import flash_attention as fa

SCALE = 8.0 / 512


def _inputs(B, T, H, D, layout, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = rng.standard_normal((3, B, T, H, D)).astype(np.float32)
    if layout == "dense":
        return q, k, v, None
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(16, T - 16), 3, replace=False))
        seg[b] = np.searchsorted(cuts, np.arange(T), side="right")
    return q, k, v, seg


def _jax_per_head(q, k, v, seg, dtype=jnp.float32, grads=True):
    seg_j = None if seg is None else jnp.asarray(seg)

    def out(q, k, v):
        with pltpu.force_tpu_interpret_mode():
            return jax_flash_attention(q, k, v, segment_ids=seg_j, scale=SCALE,
                                       block_q=128, block_kv=128, multi_head=False)

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    o = out(*args)
    if not grads:
        return np.asarray(o.astype(jnp.float32)), None
    # a scalar with a non-trivial cotangent, as the JAX tests take it
    def loss(q, k, v):
        o = out(q, k, v)
        return jnp.sum(o * jnp.cos(o))

    g = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return np.asarray(o), [np.asarray(x) for x in g]


def _port_per_head(q, k, v, seg, dtype=torch.float32, **kw):
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, None if seg is None else torch.from_numpy(seg),
                           scale=SCALE, block_q=128, block_kv=128, multi_head=False,
                           **kw)
    (o * torch.cos(o)).sum().backward()
    return o.detach().float().numpy(), [x.grad.float().numpy() for x in (tq, tk, tv)]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_per_head_forward_and_grads_match_jax(layout, D):
    """fp32, dropout 0: o, dq, dk, dv at rtol / atol 2e-4, the JAX tests'
    bar for its kernels against their oracle (fp32 sums in another order)."""
    q, k, v, seg = _inputs(2, 256, 2, D, layout, seed=D)
    jo, jg = _jax_per_head(q, k, v, seg)
    po, pg = _port_per_head(q, k, v, seg)
    np.testing.assert_allclose(po, jo, rtol=2e-4, atol=2e-4)
    for got, want, name in zip(pg, jg, "qkv"):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name}")


def test_per_head_forward_matches_jax_bf16():
    """bf16: both round P to bf16 before P.V and o to bf16; a sum taken in
    another order can flip either rounding, so o is held to 1e-2."""
    q, k, v, seg = _inputs(2, 256, 2, 128, "packed", seed=7)
    jo, _ = _jax_per_head(q, k, v, seg, jnp.bfloat16, grads=False)
    with torch.no_grad():
        po = fa.flash_attention(
            *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
            torch.from_numpy(seg), scale=SCALE, block_q=128, block_kv=128,
            multi_head=False).float().numpy()
    np.testing.assert_allclose(po, jo, rtol=1e-2, atol=1e-2)


def test_per_head_takes_no_rope():
    q, k, v, _ = _inputs(1, 128, 1, 128, "dense")
    t = [torch.from_numpy(x) for x in (q, k, v)]
    with pytest.raises(AssertionError, match="multi_head"):
        fa.flash_attention(*t, None, rope_tables(128, 128), scale=SCALE,
                           multi_head=False)


@pytest.mark.parametrize("fused", [True, False], ids=["fused_on", "fused_off"])
def test_per_head_backward_is_always_the_split_pair(monkeypatch, fused):
    """Whatever FUSED_SINGLE_KV_BWD and FUSED_MULTIKV_BWD say, the per-head
    backward calls the dkv and dq backwards (never the fused one), without
    skipping, under its own launch counters; the multi-head entry with the
    same blocks follows the switches."""
    calls = []

    def spy(name):
        real = getattr(fa, name)

        def wrapped(*a, **kw):
            calls.append((name, kw.get("counter"), kw.get("segment_skip")))
            return real(*a, **kw)
        return wrapped

    for name in ("mh_flash_forward", "mh_flash_backward", "mh_flash_bwd_dkv",
                 "mh_flash_bwd_dq"):
        monkeypatch.setattr(fa, name, spy(name))
    monkeypatch.setattr(fa, "FUSED_SINGLE_KV_BWD", fused)
    monkeypatch.setattr(fa, "FUSED_MULTIKV_BWD", fused)
    before = dict(_kernels.LAUNCHES)
    q, k, v, seg = _inputs(1, 256, 1, 64, "packed", seed=2)
    for block_kv in (256, 128):                 # single-kv and multi-kv shapes
        calls.clear()
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        fa.flash_attention(tq, tk, tv, torch.from_numpy(seg), scale=SCALE,
                           block_q=128, block_kv=block_kv,
                           multi_head=False).sum().backward()
        assert calls == [("mh_flash_forward", "flash_fwd", False),
                         ("mh_flash_bwd_dkv", "flash_bwd_dkv", False),
                         ("mh_flash_bwd_dq", "flash_bwd_dq", False)]
        calls.clear()
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        fa.flash_attention(tq, tk, tv, torch.from_numpy(seg), scale=SCALE,
                           block_q=128, block_kv=block_kv).sum().backward()
        assert [c[0] for c in calls] == (
            ["mh_flash_forward", "mh_flash_backward"] if fused else
            ["mh_flash_forward", "mh_flash_bwd_dkv", "mh_flash_bwd_dq"])
        assert calls[0][1] is None and calls[0][2] is True
    assert _kernels.LAUNCHES == before          # CPU tensors: no kernel, no count
    # without gradients to take, the forward alone, under the same counter
    calls.clear()
    with torch.no_grad():
        fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), None,
                           scale=SCALE, multi_head=False)
    assert calls == [("mh_flash_forward", "flash_fwd", False)]


def test_per_head_equals_multi_head_without_rope():
    """The per-head entry computes what the multi-head one does without RoPE:
    same o and, through the split pair, the same gradients as the fused
    backward to fp32 rounding (skipping changes no bit, the two backwards
    sum in another order)."""
    q, k, v, seg = _inputs(2, 256, 2, 64, "packed", seed=3)
    po, pg = _port_per_head(q, k, v, seg)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, torch.from_numpy(seg), scale=SCALE,
                           block_q=128, block_kv=128)
    (o * torch.cos(o)).sum().backward()
    assert np.array_equal(po, o.detach().numpy())
    for got, want in zip(pg, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)


def test_per_head_dropout_uses_one_mask_forward_and_backward():
    """Dropout 0.1 from the port's Philox stream (a TPU PRNG stream cannot
    be reproduced, so not compared with JAX): the forward keeps ~90 % of P,
    scaled by 1/0.9, and the backward redraws the same mask: with v = I-like
    probes, dv's zero pattern is exactly the forward's dropped pattern, and
    the gradients equal autograd's through the dense computation with that
    mask."""
    B, T, H, D, rate, seed = 1, 128, 1, 128, 0.1, 1234
    q, k, _, _ = _inputs(B, T, H, D, "dense", seed=4)
    v = np.eye(T, D, dtype=np.float32)[None, :, None]       # o[i, j] = p_drop[i, j]
    po, pg = _port_per_head(q, k, v, None, dropout_rate=rate, seed=seed)
    keep = fa.dropout_keep(seed, rate, B, H, T, 0, T)[0, 0].numpy()
    assert 0.85 < keep.mean() < 0.95
    p_drop = po[0, :, 0]                                     # (T, T)
    assert np.array_equal(p_drop != 0, keep)
    # dense reference with the same mask, through autograd
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    s = torch.einsum("bthd,bshd->bhts", tq, tk) * SCALE
    p = torch.softmax(s, -1)
    p = torch.where(torch.from_numpy(keep), p * fa.dropout_keep_scale(rate), 0.0)
    o = torch.einsum("bhts,bshd->bthd", p, tv)
    (o * torch.cos(o)).sum().backward()
    np.testing.assert_allclose(po, o.detach().numpy(), rtol=2e-5, atol=2e-6)
    for got, want, name in zip(pg, (tq.grad, tk.grad, tv.grad), "qkv"):
        np.testing.assert_allclose(got, want.numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=f"d{name}")
