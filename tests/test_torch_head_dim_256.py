"""PyTorch port vs the JAX package at head dim 256, and one head at a head
dim the kernels are not built for, on the CPU.

The CUDA kernels are built at D = 256 (#1-#9); on the CPU the wrappers run
their plain versions, which these tests hold against the JAX package's
Pallas kernels (interpret mode) on the same numpy-seeded inputs, in fp32:
the forward `_mh_fwd` (o and lse2, RoPE, packed ids), the backward through
`jax.vjp` of `flash_attention` (the fused single-kv and multi-kv kernels
and the split pair), the per-head entry, the int8 serving kernel, and a
2-layer model of 2 heads of 256 (logits and MLM gradients through the
weight converter). One head at D = 96 runs the kernels of D = 128 on
zero-padded inputs on a CUDA tensor (`flash_attention_padded`); here that
helper runs around the plain version and is held against the unpadded
plain version, forward and gradients."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import omnibiote_tpu as obt
import omnibiote_tpu.ops.flash_attention as jax_flash
import omnibiote_tpu.ops.int8_attention as jax_int8
import omnibiote_tpu.training.mlm as jax_mlm
from omnibiote_tpu.models.rope import rope_tables as jax_rope_tables
from omnibiote_tpu.ops.segments import segment_ids_np

import omnibiote_tpu_torch as port
import omnibiote_tpu_torch.ops.int8_attention as port_int8
import omnibiote_tpu_torch.training.mlm as port_mlm
from omnibiote_tpu_torch.models.rope import rope_tables
from omnibiote_tpu_torch.ops import flash_attention as fa
from omnibiote_tpu_torch.utils.convert import jax_params_from_state, state_from_jax_params

B, T, H, D = 1, 256, 2, 256
SCALE = 1.0 / np.sqrt(D)


def _inputs(seed, B=B, T=T, H=H, D=D, n_cuts=3):
    rng = np.random.default_rng(seed)
    q, k, v, do = rng.standard_normal((4, B, T, H, D)).astype(np.float32)
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(16, T - 16), n_cuts, replace=False))
        seg[b] = np.searchsorted(cuts, np.arange(T), side="right")
    return q, k, v, do, seg


def test_tiles_and_routes_at_head_dim_256():
    """The kernels take D = 256 (the int8 kernel 128 and 256), on the tiles
    the CUDA sources use there; every tile divides the T multiple."""
    assert 256 in fa.KERNEL_HEAD_DIMS and port_int8.KERNEL_HEAD_DIMS == (128, 256)
    bf16, f32 = torch.bfloat16, torch.float32
    assert fa.KERNEL_TILES_BY_HEAD_DIM[256] == {
        "fwd": {bf16: (128, 64), f32: (64, 32)},
        "fused": {bf16: (64, 64), f32: (16, 64)},
        "dkv": {bf16: (64, 64), f32: (16, 64)},
        "dq": {bf16: (128, 32), f32: (64, 16)},
    }
    for kind in ("fwd", "fused", "dkv", "dq"):
        for dtype in (bf16, f32):
            assert fa.kernel_tiles(kind, dtype, 128) == fa.KERNEL_TILES[kind][dtype]
            bq, bkv = fa.kernel_tiles(kind, dtype, 256)
            multiple = fa.KERNEL_T_MULTIPLE[dtype]
            assert multiple % bq == 0 and multiple % bkv == 0
    assert fa.kernel_kv_tile(bf16, 256) == 64 and fa.kernel_kv_tile(bf16, 128) == 128
    assert [fa.padded_head_dim(d) for d in (8, 32, 64, 96, 128, 192, 256)] == [
        64, 64, 64, 128, 128, 256, 256]
    assert fa.padded_head_dim(384) == 384


def test_forward_matches_jax_mh_fwd():
    """#1: o and lse2 with RoPE and packed ids against `_mh_fwd` with one kv
    block spanning T and with 128-wide blocks (the multi-kv branch), fp32
    at 2e-5 (fp32 sums in another order); the plain version on the
    kernel's 64-row kv tile at D = 256 as well."""
    q, k, v, _, seg = _inputs(1)
    cos, sin = jax_rope_tables(D, T)
    cos2, sin2 = (jnp.concatenate([x, x], axis=1) for x in (cos, sin))
    seg_j = jnp.asarray(seg)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    for block_kv in (T, 128):
        with pltpu.force_tpu_interpret_mode():
            jo, jl = jax_flash._mh_fwd(
                *(jnp.asarray(x) for x in (q, k, v)), seg_j, seg_j, cos2, sin2, 0,
                scale=SCALE, block_q=128, block_kv=block_kv, dropout_rate=0.0,
                use_rope=True)
        for port_block in (block_kv, fa.kernel_kv_tile(torch.float32, D),
                           fa.kernel_kv_tile(torch.bfloat16, D)):
            po, pl = fa.mh_flash_forward_plain(*t, torch.from_numpy(seg), rope_tables(D, T),
                                               scale=SCALE, block_kv=port_block)
            np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", ["fused_single_kv", "fused_multi_kv", "split"])
def test_backward_matches_jax_vjp(monkeypatch, case):
    """#2 (one kv block spanning T), #3 (128-wide blocks with skipping) and
    #4/#5 (the split pair, FUSED_MULTIKV_BWD off on both sides): dq, dk, dv
    through the port's autograd Function against jax.vjp of the JAX
    flash_attention, packed ids, RoPE, fp32 at 2e-4 (the JAX package's own
    flash-backward tolerance)."""
    q, k, v, do, seg = _inputs(2)
    block_kv = T if case == "fused_single_kv" else 128
    cos, sin = jax_rope_tables(D, T)
    if case == "split":
        monkeypatch.setattr(jax_flash, "FUSED_MULTIKV_BWD", False)
        monkeypatch.setattr(fa, "FUSED_MULTIKV_BWD", False)

    def f(q, k, v):
        return jax_flash.flash_attention(q, k, v, segment_ids=jnp.asarray(seg), scale=SCALE,
                                         block_q=128, block_kv=block_kv, rope=(cos, sin),
                                         segment_skip=True)

    grads = jax.jit(lambda q, k, v, do: jax.vjp(f, q, k, v)[1](do))
    want = [np.asarray(g) for g in grads(*(jnp.asarray(x) for x in (q, k, v, do)))]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, torch.from_numpy(seg), rope_tables(D, T), scale=SCALE,
                           block_q=128, block_kv=block_kv)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4, err_msg=name)


def test_per_head_entry_matches_jax():
    """#6-#8: flash_attention(multi_head=False) forward and gradients of
    sum(o cos o) against the JAX per-head entry, fp32 at 2e-4."""
    q, k, v, _, seg = _inputs(3)
    scale = 8.0 / 512

    def loss(q, k, v):
        o = jax_flash.flash_attention(q, k, v, segment_ids=jnp.asarray(seg), scale=scale,
                                      block_q=128, block_kv=128, multi_head=False)
        return jnp.sum(o * jnp.cos(o)), o

    (_, jo), jg = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, torch.from_numpy(seg), scale=scale, block_q=128,
                           block_kv=128, multi_head=False)
    (o * torch.cos(o)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=2e-4, atol=2e-4)
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name}")


def test_int8_matches_jax():
    """#9: the plain int8 attention against the JAX `int8_flash_attention`
    (Pallas, interpret mode) at D = 256 with RoPE and packed ids. Both take
    the same integers; exp2 and the fp32 sums differ in the last bits
    between XLA and PyTorch, which can move a round(p * 127) by one step: o
    is held to 2e-3 absolute, and all but 1 % of it to 1e-5."""
    q, k, v, _, seg = _inputs(4)
    with pltpu.force_tpu_interpret_mode():
        jo = jax_int8.int8_flash_attention(
            *(jnp.asarray(x) for x in (q, k, v)), scale=SCALE, segment_ids=jnp.asarray(seg),
            block_q=128, rope=jax_rope_tables(D, T))
    po = port_int8.int8_flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), scale=SCALE,
        segment_ids=torch.from_numpy(seg), block_q=128, rope=rope_tables(D, T))
    diff = np.abs(po.numpy().astype(np.float64) - np.asarray(jo))
    assert diff.max() <= 2e-3, diff.max()
    assert (diff > 1e-5).mean() < 0.01, (diff > 1e-5).mean()


MODEL_KW = dict(n_layer=2, n_embd=512, n_head=2, vocab_size=512, block_size=256,
                dropout=0.0, compute_dtype="float32", param_dtype="float32")


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, obt.init_params(jax.random.PRNGKey(seed), cfg))


def _port_model(params_np, pcfg):
    model = port.OmniBioTA(pcfg, device="cpu")
    state = state_from_jax_params(params_np, pcfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                          strict=True)
    return model


def _structured_rows(n, ctx, vocab, rng):
    rows = []
    for _ in range(n):
        row = []
        while len(row) < ctx:
            start = int(rng.integers(4, vocab - 12))
            row.extend(range(start, start + int(rng.integers(4, 60))))
            row.append(obt.EOS_TOKEN)
        rows.append(row[:ctx])
    return np.asarray(rows, np.int32)


def test_model_with_heads_of_256_matches_jax():
    """2 layers, d 512, 2 heads of 256, T 256 (the JAX dispatch sends it to
    its flash kernels, the port to their plain versions): logits with
    packed ids at rtol 2e-4 / atol 2e-5, the MLM loss at rtol 2e-5 and
    every parameter gradient through the converter within 2e-4 of its
    largest value (fp32 sums in another order)."""
    jcfg, pcfg = obt.OmniBioTAConfig(**MODEL_KW), port.OmniBioTAConfig(**MODEL_KW)
    params = _jax_params(jcfg)
    model = _port_model(params, pcfg)
    toks = _structured_rows(1, T, MODEL_KW["vocab_size"], np.random.default_rng(1))
    seg = segment_ids_np(toks)

    want = np.asarray(jax.jit(lambda p, x, s: obt.forward(p, jcfg, x, segment_ids=s))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(toks), jnp.asarray(seg)))
    with torch.no_grad():
        got = port.forward(model, torch.from_numpy(toks), torch.from_numpy(seg)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)

    rng = jax.random.PRNGKey(3)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_mlm.mlm_loss(p, jcfg, jnp.asarray(toks), jnp.asarray(seg), rng,
                                   deterministic=True), has_aux=True))(params)
    mask = np.asarray(jax_mlm.make_mlm_mask(jax.random.split(rng)[0], jnp.asarray(toks), 0.15))
    loss, _ = port_mlm.mlm_loss(model, torch.from_numpy(toks), torch.from_numpy(seg), 0,
                                deterministic=True, mask=torch.from_numpy(mask.copy()))
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, ps)
    assert loss.item() == pytest.approx(float(jloss), rel=2e-5)
    want = state_from_jax_params(jax.tree.map(np.asarray, jgrads), pcfg)
    for n, g in zip(names, grads):
        bound = 2e-4 * max(np.abs(want[n]).max(), 1e-30)
        assert np.abs(g.numpy() - want[n]).max() <= bound, n


def test_converter_carries_four_heads_unchanged():
    """omnibiote-small's layout with 4 heads of 256 (cut to 2 layers): the
    converter's round trip gives every JAX leaf back bit for bit, and the
    head count only reshapes q, k and v (the same state at 8 heads of 128
    but for c_attn's head-major row order)."""
    kw = dict(MODEL_KW, n_embd=1024, n_head=4, vocab_size=256)
    jcfg, pcfg = obt.OmniBioTAConfig(**kw), port.OmniBioTAConfig(**kw)
    params = _jax_params(jcfg)
    state = state_from_jax_params(params, pcfg)
    back = jax_params_from_state(state, pcfg)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(x)
                      for p, x in jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(params), flat(back)
    assert a.keys() == b.keys()
    for key in a:
        assert np.array_equal(a[key], b[key]), key
    state8 = state_from_jax_params(params, port.OmniBioTAConfig(**dict(kw, n_head=8)))
    for n in state:
        if "c_attn" not in n:
            assert np.array_equal(np.asarray(state[n]), np.asarray(state8[n])), n


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_padding_helper_matches_the_unpadded_plain_version(rate):
    """One head at D = 96 with RoPE: `flash_attention_padded` to D = 128
    around the plain version against the plain version at D = 96, o and
    the gradients at 1e-5 (the zero lanes add exact zeros; the products
    are summed in another order), with the same dropout mask. The padding
    puts each rotate-half pair at i and i + 64, with cos 1 and sin 0 in
    the padded lanes."""
    Dh, Dp = 96, 128
    q, k, v, do, seg = _inputs(5, B=2, T=256, H=1, D=Dh)
    x = torch.from_numpy(q)
    xp = fa.pad_head_dim(x, Dp)
    assert torch.equal(xp[..., :48], x[..., :48]) and torch.equal(xp[..., 64:112], x[..., 48:])
    assert not xp[..., 48:64].any() and not xp[..., 112:].any()
    assert torch.equal(fa.unpad_head_dim(xp, Dh), x)
    rope = rope_tables(Dh, 256)
    cp, sp = fa.pad_rope(rope, Dp)
    assert torch.equal(cp[:, :48], rope[0]) and (cp[:, 48:] == 1).all() and not sp[:, 48:].any()

    kw = dict(scale=1.0 / np.sqrt(Dh), dropout_rate=rate, seed=11, block_q=128, block_kv=256)

    def run(fn):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        o = fn(tq, tk, tv)
        return (o.detach(), *torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do)))

    seg_t = torch.from_numpy(seg)
    got = run(lambda a, b, c: fa.flash_attention_padded(a, b, c, seg_t, rope, head_dim=Dp, **kw))
    want = run(lambda a, b, c: fa.flash_attention(a, b, c, seg_t, rope, **kw))
    assert got[0].shape == want[0].shape == (2, 256, 1, Dh)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
