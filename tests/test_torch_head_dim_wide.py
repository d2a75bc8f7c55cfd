"""PyTorch port vs the JAX package at head dims past 256, on the CPU.

The CUDA kernels take every head dim D % 128 == 0 past 256 (#1-#9, one set
of instances with the head dim a run-time size, ops/csrc/
wide_attention.cuh), and one head at any other D past 256 runs them on
inputs zero-padded to the next multiple of 128. On the CPU the wrappers
run their plain versions, which these tests hold against the JAX
package's Pallas kernels (interpret mode) on the same numpy-seeded inputs
at D = 384 and 512, in fp32: the forward `_mh_fwd` (o and lse2, RoPE,
packed ids), the backward through `jax.vjp` of `flash_attention` (the
fused single-kv and multi-kv kernels and the split pair), the per-head
entry, the int8 serving kernel, and a 2-layer model of 2 heads of 384
(logits and MLM gradients through the weight converter). Then the tiles,
padding and routes past 256, and the kernels' slice layout."""
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
import omnibiote_tpu_torch.ops.attention as port_attention
import omnibiote_tpu_torch.ops.int8_attention as port_int8
import omnibiote_tpu_torch.training.mlm as port_mlm
from omnibiote_tpu_torch.models.rope import rope_tables
from omnibiote_tpu_torch.ops import flash_attention as fa
from omnibiote_tpu_torch.utils.convert import jax_params_from_state, state_from_jax_params

B, H = 1, 2
WIDE = (384, 512)


def _inputs(seed, T, D, n_cuts=3):
    rng = np.random.default_rng(seed)
    q, k, v, do = rng.standard_normal((4, B, T, H, D)).astype(np.float32)
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(16, T - 16), n_cuts, replace=False))
        seg[b] = np.searchsorted(cuts, np.arange(T), side="right")
    return q, k, v, do, seg


@pytest.mark.parametrize("D", WIDE)
def test_forward_matches_jax_mh_fwd(D):
    """#1: o and lse2 with RoPE and packed ids against `_mh_fwd` with one
    kv block spanning T, fp32 at 2e-5 (fp32 sums in another order), the
    plain version on that block and on the kernel's 64-row kv tile (its
    online softmax over two tiles)."""
    T = 128
    q, k, v, _, seg = _inputs(D, T, D)
    cos, sin = jax_rope_tables(D, T)
    cos2, sin2 = (jnp.concatenate([x, x], axis=1) for x in (cos, sin))
    seg_j = jnp.asarray(seg)
    with pltpu.force_tpu_interpret_mode():
        jo, jl = jax_flash._mh_fwd(
            *(jnp.asarray(x) for x in (q, k, v)), seg_j, seg_j, cos2, sin2, 0,
            scale=1.0 / np.sqrt(D), block_q=128, block_kv=T, dropout_rate=0.0,
            use_rope=True)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    for port_block in (T, fa.kernel_kv_tile(torch.float32, D)):
        po, pl = fa.mh_flash_forward_plain(*t, torch.from_numpy(seg), rope_tables(D, T),
                                           scale=1.0 / np.sqrt(D), block_kv=port_block)
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("D,case", [(384, "fused_single_kv"), (512, "fused_single_kv"),
                                    (512, "fused_multi_kv"), (384, "split")])
def test_backward_matches_jax_vjp(monkeypatch, D, case):
    """#2 (one kv block spanning T), #3 (128-wide blocks with skipping) and
    #4/#5 (the split pair, FUSED_MULTIKV_BWD off on both sides): dq, dk, dv
    through the port's autograd Function against jax.vjp of the JAX
    flash_attention, packed ids, RoPE, fp32 at 2e-4 (the JAX package's own
    flash-backward tolerance). Each case at one head dim: the interpreter
    takes seconds a case."""
    T = 128 if case == "fused_single_kv" else 256
    q, k, v, do, seg = _inputs(D + 1, T, D)
    block_kv = T if case == "fused_single_kv" else 128
    cos, sin = jax_rope_tables(D, T)
    scale = 1.0 / np.sqrt(D)
    if case == "split":
        monkeypatch.setattr(jax_flash, "FUSED_MULTIKV_BWD", False)
        monkeypatch.setattr(fa, "FUSED_MULTIKV_BWD", False)

    def f(q, k, v):
        return jax_flash.flash_attention(q, k, v, segment_ids=jnp.asarray(seg), scale=scale,
                                         block_q=128, block_kv=block_kv, rope=(cos, sin),
                                         segment_skip=True)

    grads = jax.jit(lambda q, k, v, do: jax.vjp(f, q, k, v)[1](do))
    want = [np.asarray(g) for g in grads(*(jnp.asarray(x) for x in (q, k, v, do)))]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, torch.from_numpy(seg), rope_tables(D, T), scale=scale,
                           block_q=128, block_kv=block_kv)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4, err_msg=name)


def test_per_head_entry_matches_jax():
    """#6-#8: flash_attention(multi_head=False) forward and gradients of
    sum(o cos o) against the JAX per-head entry at D = 512, fp32 at 2e-4."""
    T, D = 128, 512
    q, k, v, _, seg = _inputs(D + 2, T, D)
    scale = 8.0 / D

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


@pytest.mark.parametrize("D", WIDE)
def test_int8_matches_jax(D):
    """#9: the plain int8 attention against the JAX `int8_flash_attention`
    (Pallas, interpret mode) with RoPE and packed ids, at the tolerance of
    tests/test_torch_int8_attention.py: both take the same integers; exp2
    and the fp32 sums differ in the last bits between XLA and PyTorch,
    which can move a round(p * 127) by one step, so o is held to 2e-3
    absolute, and all but 1 % of it to 1e-5."""
    T = 128
    q, k, v, _, seg = _inputs(D + 3, T, D)
    with pltpu.force_tpu_interpret_mode():
        jo = jax_int8.int8_flash_attention(
            *(jnp.asarray(x) for x in (q, k, v)), scale=1.0 / np.sqrt(D),
            segment_ids=jnp.asarray(seg), block_q=128, rope=jax_rope_tables(D, T))
    po = port_int8.int8_flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), scale=1.0 / np.sqrt(D),
        segment_ids=torch.from_numpy(seg), block_q=128, rope=rope_tables(D, T))
    diff = np.abs(po.numpy().astype(np.float64) - np.asarray(jo))
    assert diff.max() <= 2e-3, diff.max()
    assert (diff > 1e-5).mean() < 0.01, (diff > 1e-5).mean()


MODEL_KW = dict(n_layer=2, n_embd=768, n_head=2, vocab_size=512, block_size=128,
                dropout=0.0, compute_dtype="float32", param_dtype="float32")


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


def test_model_with_heads_of_384_matches_jax():
    """2 layers, d 768, 2 heads of 384, T 128 (the JAX dispatch sends it to
    its flash kernels, the port to their plain versions): logits with
    packed ids at rtol 2e-4 / atol 2e-5, the MLM loss at rtol 2e-5 and
    every parameter gradient through the converter within 2e-4 of its
    largest value (fp32 sums in another order)."""
    jcfg, pcfg = obt.OmniBioTAConfig(**MODEL_KW), port.OmniBioTAConfig(**MODEL_KW)
    assert pcfg.n_embd // pcfg.n_head == 384
    # weights from the port's init (JAX's takes seconds to trace), carried to
    # JAX through the converter
    model = port.init_params(torch.Generator().manual_seed(0), pcfg, device="cpu")
    params = jax_params_from_state(
        {n: p.detach().numpy() for n, p in model.state_dict().items()}, pcfg)
    T = MODEL_KW["block_size"]
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


# (D, kernels take it as it is, padded head dim) past 256
WIDE_DIMS = ((320, False, 384), (384, True, 384), (512, True, 512), (600, False, 640),
             (640, True, 640), (1024, True, 1024))


@pytest.mark.parametrize("D,built,padded", WIDE_DIMS)
def test_tiles_padding_and_routes_past_256(D, built, padded):
    """kernel_tiles gives the wide kernels' 64 x 64 tiles at every D past
    256 (the padded head dim's where one head runs padded), padded_head_dim
    the next multiple of 128, and attention_path on a CUDA tensor the JAX
    route, raising for no head dim in bf16 or fp32: flash (int8 where D %
    128 == 0 and no dropout) for one head or D % 128 == 0, else dense."""
    assert fa.kernel_head_dim(D) == built and fa.padded_head_dim(D) == padded
    assert port_int8.kernel_head_dim(D) == built
    for dtype in (torch.bfloat16, torch.float32):
        for kind in ("fwd", "fused", "dkv", "dq"):
            bq, bkv = fa.kernel_tiles(kind, dtype, D)
            assert (bq, bkv) == fa.KERNEL_TILES_WIDE[kind][dtype] == (64, 64)
            assert fa.KERNEL_T_MULTIPLE[dtype] % bq == 0
        for n_head in (1, 2, 8):
            for int8 in (False, True):
                got = port_attention.attention_path("cuda", dtype, 1024, n_head, D, int8)
                want = ("int8" if int8 and built else "flash") if built or n_head == 1 else "xla"
                assert got == want == port_attention.attention_path(
                    "cpu", dtype, 1024, n_head, D, int8)
        assert port_attention.attention_path("cuda", dtype, 1024, 8, D, True,
                                             dropout_rate=0.1) == ("flash" if built else "xla")


# Output lanes a CTA of the kernels past 256 owns (wide_attention.cuh::kSlice).
SLICE = 128


def _slice_lanes(D, c):
    """The head-dim lanes of output slice c, in the slice's lane order: the
    mirror of wide_attention.cuh::slice_dim, [64c, 64c + 64) then
    [D/2 + 64c, D/2 + 64c + 64)."""
    lo = torch.arange(SLICE // 2 * c, SLICE // 2 * (c + 1))
    return torch.cat([lo, lo + D // 2])


@pytest.mark.parametrize("D", (384, 512, 640, 1024))
def test_slice_layout_covers_the_head_dim_closed_under_rotate_half(D):
    """The kernels' output slices past 256: D / 128 slices of 128 lanes
    cover the head dim once, rotate-half (i <-> i + D/2) maps each slice
    onto itself with slice lane L going to L ^ 64 (so the inverse RoPE of
    dq and dk stays in the CTA, in one thread's accumulators), and each
    half of a slice is 64 contiguous lanes (adjacent pairs stay adjacent)."""
    assert D % SLICE == 0 and fa.kernel_head_dim(D)
    slices = [_slice_lanes(D, c) for c in range(D // SLICE)]
    assert torch.equal(torch.sort(torch.cat(slices)).values, torch.arange(D))
    half = D // 2
    for lanes in slices:
        rotated = (lanes + half) % D
        assert set(rotated.tolist()) == set(lanes.tolist())
        assert torch.equal(rotated, lanes[torch.arange(SLICE) ^ 64])
        assert torch.equal(lanes[1:64] - lanes[:63], torch.ones(63, dtype=lanes.dtype))
