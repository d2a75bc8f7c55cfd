"""PyTorch port vs the JAX package: segment-skip bounds, the multi-kv
backward family and the lse-exposing variant, on the CPU.

The port's `seg_block_bounds` against `_seg_block_bounds`; the plain
forward and backwards with skipping on and off, which must agree bit for
bit (a pruned tile contributes exact zeros); the port's autograd Function
against `jax.vjp` through `flash_attention(block_q=128, block_kv=128)`, so
that the JAX package takes its multi-kv kernels (Pallas, interpret mode on
the CPU): the fused multi-kv backward and, with `FUSED_MULTIKV_BWD` off, the
split dkv / dq pair, with and without skipping; `_flash_mh_lse` with a
random lse cotangent; and the dispatch above the single-kv limit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from omnibiote_tpu.models.rope import rope_tables as jax_rope_tables
from omnibiote_tpu.ops import attention as jax_attention
from omnibiote_tpu.ops import flash_attention as jax_flash

from omnibiote_tpu_torch.models.rope import rope_tables
from omnibiote_tpu_torch.ops import attention as port_attention
from omnibiote_tpu_torch.ops import flash_attention as port_flash
from omnibiote_tpu_torch.ops.flash_attention import (
    SegmentBounds, flash_attention, flash_attention_lse,
    mh_flash_backward_plain, mh_flash_bwd_dkv_plain, mh_flash_bwd_dq_plain,
    mh_flash_forward_plain, seg_block_bounds)

B, T, H, D = 2, 512, 2, 128
BLOCK = 128
SCALE = 1.0 / np.sqrt(D)


def _ids(layout, rng, B=B, T=T):
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        if layout == "packed":
            cuts = np.sort(rng.choice(np.arange(16, T - 16), 4, replace=False))
            seg[b] = np.searchsorted(cuts, np.arange(T), side="right")
        elif layout == "padded":
            seg[b, int(rng.integers(T // 8, T - 8)):] = -1
        elif layout == "unsorted":
            # documents in shuffled order: ids not monotone along the row
            cuts = np.sort(rng.choice(np.arange(16, T - 16), 5, replace=False))
            order = rng.permutation(6)
            seg[b] = order[np.searchsorted(cuts, np.arange(T), side="right")]
    return seg


def _inputs(layout, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = rng.standard_normal((4, B, T, H, D)).astype(np.float32)
    return q, k, v, do, (None if layout == "dense" else _ids(layout, rng))


# ---------------------------------------------------------------------------
# seg_block_bounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["packed", "padded", "dense", "unsorted"])
@pytest.mark.parametrize("blocks", [(128, 128), (64, 32), (32, 64), (512, 128)])
def test_bounds_match_jax(layout, blocks):
    seg = _ids(layout, np.random.default_rng(3))
    want = jax_flash._seg_block_bounds(jnp.asarray(seg), jnp.asarray(seg), *blocks)
    got = seg_block_bounds(torch.from_numpy(seg), torch.from_numpy(seg), *blocks)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bounds_with_other_kv_ids_and_an_empty_intersection():
    """q ids and kv ids differ (a ring step's blocks): q blocks that meet
    no kv block fall back to (0, 0), one masked tile, as in JAX."""
    rng = np.random.default_rng(4)
    q_seg = _ids("packed", rng)
    kv_seg = _ids("packed", rng) + 3
    kv_seg[1] += 100                      # row 1: nothing in common
    want = jax_flash._seg_block_bounds(jnp.asarray(q_seg), jnp.asarray(kv_seg), 64, 128)
    got = seg_block_bounds(torch.from_numpy(q_seg), torch.from_numpy(kv_seg), 64, 128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0][1] == 0).all() and (got[1][1] == 0).all()


@settings(max_examples=60, deadline=None, database=None)
@given(st.data())
def test_no_tile_outside_the_bounds_holds_an_equal_pair(data):
    """Any ids, any blocks: every (a, b) pair with equal ids lies in a tile
    inside [lo, hi] of its a-block."""
    block_a = data.draw(st.sampled_from([8, 16, 32]))
    block_b = data.draw(st.sampled_from([8, 16, 32]))
    na, nb = data.draw(st.integers(1, 6)), data.draw(st.integers(1, 6))
    ids = st.integers(-2, 5)
    a = np.array(data.draw(st.lists(ids, min_size=na * block_a, max_size=na * block_a)),
                 np.int32)[None]
    b = np.array(data.draw(st.lists(ids, min_size=nb * block_b, max_size=nb * block_b)),
                 np.int32)[None]
    if data.draw(st.booleans()):
        a, b = np.sort(a), np.sort(b)     # packed rows: non-decreasing ids
    lo, hi = (x.numpy() for x in seg_block_bounds(
        torch.from_numpy(a), torch.from_numpy(b), block_a, block_b))
    equal = (a[0][:, None] == b[0][None, :]).reshape(na, block_a, nb, block_b)
    tile_has_pair = equal.any(axis=(1, 3))                     # (na, nb)
    j = np.arange(nb)[None, :]
    inside = (j >= lo[0][:, None]) & (j <= hi[0][:, None])
    assert not (tile_has_pair & ~inside).any()
    assert (0 <= lo).all() and (lo <= hi).all() and (hi < nb).all()


def test_segment_bounds_computes_each_tile_size_once(monkeypatch):
    calls = []
    real = port_flash.seg_block_bounds
    monkeypatch.setattr(port_flash, "seg_block_bounds",
                        lambda *a: calls.append(a[2:]) or real(*a))
    sb = SegmentBounds(torch.from_numpy(_ids("packed", np.random.default_rng(0))))
    first = sb.get(64, 64)
    assert sb.get(64, 64) is first
    sb.get(64, 32)
    assert calls == [(64, 64), (64, 32)]


# ---------------------------------------------------------------------------
# Plain versions: skipping changes no bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["packed", "padded", "unsorted"])
@pytest.mark.parametrize("dtype,rate", [(torch.float32, 0.0), (torch.float32, 0.1),
                                        (torch.bfloat16, 0.1)])
def test_plain_skip_on_equals_skip_off_bit_for_bit(layout, dtype, rate):
    q, k, v, do, seg = _inputs(layout, seed=5)
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    seg_t, rope = torch.from_numpy(seg), rope_tables(D, T)
    kw = dict(scale=SCALE, dropout_rate=rate, seed=21)
    off = mh_flash_forward_plain(q, k, v, seg_t, rope, block_kv=64, **kw)
    on = mh_flash_forward_plain(q, k, v, seg_t, rope, block_kv=64, block_q=64,
                                segment_skip=True, **kw)
    lo, hi = seg_block_bounds(seg_t, seg_t, 64, 64)
    assert int((hi - lo + 1).sum()) < B * (T // 64) ** 2     # tiles were pruned
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    o, lse2 = off
    di = (o.float() * do.float()).sum(-1)
    args = (q, k, v, do, lse2, di, seg_t, rope)
    want = mh_flash_backward_plain(*args, **kw)
    tiles = dict(block_q=32, block_kv=64, segment_skip=True)
    got = mh_flash_backward_plain(*args, **kw, **tiles)
    dk, dv = mh_flash_bwd_dkv_plain(*args, **kw, **tiles)
    dq = mh_flash_bwd_dq_plain(*args, **kw, block_q=64, block_kv=64, segment_skip=True)
    for g, s, w in zip(got, (dq, dk, dv), want):
        assert torch.equal(g, w) and torch.equal(s, w)


def test_a_wrong_bound_changes_the_result():
    """The bit-identity above is a test of the bounds: cutting one visible
    tile off a q block's range moves o."""
    q, k, v, _, seg = _inputs("packed", seed=6)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    seg_t = torch.from_numpy(seg)
    sb = SegmentBounds(seg_t)
    lo, hi = sb.get(64, 64)
    row = int(torch.nonzero(hi[0] > lo[0])[0])
    hi = hi.clone()
    hi[0, row] -= 1
    sb._memo[(64, 64)] = (lo, hi)
    off, _ = mh_flash_forward_plain(q, k, v, seg_t, None, scale=SCALE, block_kv=64)
    cut, _ = mh_flash_forward_plain(q, k, v, seg_t, None, scale=SCALE, block_kv=64,
                                    block_q=64, segment_skip=True, bounds=sb)
    assert not torch.equal(cut, off)


# ---------------------------------------------------------------------------
# The multi-kv backward family against jax.vjp
# ---------------------------------------------------------------------------

def _jax_grads(q, k, v, do, seg, dtype, fused, skip):
    cos, sin = jax_rope_tables(D, T)
    seg_j = None if seg is None else jnp.asarray(seg)

    def f(q, k, v):
        return jax_flash.flash_attention(
            q, k, v, segment_ids=seg_j, scale=SCALE, block_q=BLOCK,
            block_kv=BLOCK, rope=(cos, sin), segment_skip=skip)

    old = jax_flash.FUSED_MULTIKV_BWD
    jax_flash.FUSED_MULTIKV_BWD = fused
    try:
        o, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
        grads = vjp(jnp.asarray(do, dtype))
    finally:
        jax_flash.FUSED_MULTIKV_BWD = old
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


def _port_grads(monkeypatch, q, k, v, do, seg, dtype, fused, skip):
    monkeypatch.setattr(port_flash, "FUSED_MULTIKV_BWD", fused)
    taken = []
    for name in ("mh_flash_backward", "mh_flash_bwd_dkv", "mh_flash_bwd_dq"):
        real = getattr(port_flash, name)
        monkeypatch.setattr(port_flash, name, lambda *a, _n=name, _f=real, **kw:
                            taken.append(_n) or _f(*a, **kw))
    qt, kt, vt = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
    o = flash_attention(qt, kt, vt, None if seg is None else torch.from_numpy(seg),
                        rope_tables(D, T), scale=SCALE, block_q=BLOCK,
                        block_kv=BLOCK, segment_skip=skip)
    grads = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do).to(dtype))
    assert taken == (["mh_flash_backward"] if fused
                     else ["mh_flash_bwd_dkv", "mh_flash_bwd_dq"])
    return [x.detach().float().numpy() for x in (o, *grads)]


@pytest.mark.parametrize("fused", [True, False], ids=["fusedmk", "split"])
@pytest.mark.parametrize("layout,skip", [("packed", True), ("packed", False),
                                         ("padded", True), ("dense", True)])
def test_multikv_backward_matches_jax_fp32(monkeypatch, fused, layout, skip):
    """fp32: o, dq, dk, dv at rtol 2e-4 / atol 2e-4 (the JAX package's own
    flash-backward tolerance): fp32 sums in another order, nothing else."""
    q, k, v, do, seg = _inputs(layout, seed=7)
    want = _jax_grads(q, k, v, do, seg, jnp.float32, fused, skip)
    got = _port_grads(monkeypatch, q, k, v, do, seg, torch.float32, fused, skip)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("fused", [True, False], ids=["fusedmk", "split"])
def test_multikv_backward_matches_jax_bf16(monkeypatch, fused):
    """bf16: the same rounding points, but fp32 sums in another order can
    flip a bf16 rounding of an operand or an output, so each gradient is
    held to 2e-2 of its largest value."""
    q, k, v, do, seg = _inputs("packed", seed=8)
    want = _jax_grads(q, k, v, do, seg, jnp.bfloat16, fused, True)
    got = _port_grads(monkeypatch, q, k, v, do, seg, torch.bfloat16, fused, True)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), name


def test_single_kv_switch_takes_the_split_pair(monkeypatch):
    """FUSED_SINGLE_KV_BWD off: one kv block spans T and the split pair
    runs; its gradients equal the fused plain backward's bit for bit."""
    q, k, v, do, seg = _inputs("packed", seed=9)
    taken = []
    real = port_flash.mh_flash_bwd_dq
    monkeypatch.setattr(port_flash, "mh_flash_bwd_dq",
                        lambda *a, **kw: taken.append(1) or real(*a, **kw))

    def grads():
        qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        o = flash_attention(qt, kt, vt, torch.from_numpy(seg),
                            rope_tables(D, T), scale=SCALE)
        return torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))

    want = grads()
    assert taken == []
    monkeypatch.setattr(port_flash, "FUSED_SINGLE_KV_BWD", False)
    got = grads()
    assert taken == [1]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# _flash_mh_lse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fusedmk", "split"])
def test_flash_mh_lse_matches_jax(monkeypatch, fused):
    """(o, lse) and the gradients under a random (do, dlse) cotangent, fp32
    at rtol 2e-4 / atol 2e-4; dlse changes the gradients."""
    q, k, v, do, seg = _inputs("packed", seed=10)
    dlse = np.random.default_rng(11).standard_normal((B, T, H)).astype(np.float32)
    cos, sin = jax_rope_tables(D, T)
    cos2 = jnp.concatenate([cos, cos], axis=1).astype(jnp.float32)
    sin2 = jnp.concatenate([sin, sin], axis=1).astype(jnp.float32)
    seg_j = jnp.asarray(seg)

    def f(q, k, v):
        return jax_flash._flash_mh_lse(q, k, v, seg_j, seg_j, cos2, sin2,
                                       jnp.int32(0), SCALE, BLOCK, BLOCK, 0.0,
                                       True, True)

    old = jax_flash.FUSED_MULTIKV_BWD
    jax_flash.FUSED_MULTIKV_BWD = fused
    try:
        (o_w, lse_w), vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
        want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    finally:
        jax_flash.FUSED_MULTIKV_BWD = old

    monkeypatch.setattr(port_flash, "FUSED_MULTIKV_BWD", fused)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = flash_attention_lse(qt, kt, vt, torch.from_numpy(seg),
                                 rope_tables(D, T), scale=SCALE, block_q=BLOCK,
                                 block_kv=BLOCK)
    got = torch.autograd.grad((o, lse), (qt, kt, vt),
                              (torch.from_numpy(do), torch.from_numpy(dlse)),
                              retain_graph=True)
    plain = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_w), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(lse_w), rtol=1e-5, atol=1e-5)
    for name, g, w, p in zip(("dq", "dk", "dv"), got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4,
                                   err_msg=name)
    assert (got[0] - plain[0]).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# The dispatch above the single-kv limit
# ---------------------------------------------------------------------------

def test_dispatch_at_2048_takes_the_multikv_route_and_matches_jax(monkeypatch):
    """T = 2048 through both dispatches (one head, fp32): 512-wide blocks,
    a sequence-wide forward block, the fused multi-kv backward with
    skipping. o and the gradients at rtol 2e-4 / atol 2e-4."""
    T2, H2 = 2048, 1
    rng = np.random.default_rng(12)
    q, k, v, do = rng.standard_normal((4, 1, T2, H2, D)).astype(np.float32)
    seg = _ids("packed", rng, B=1, T=T2)
    jrope = jax_rope_tables(D, T2)

    def f(q, k, v):
        return jax_attention.attention(q, k, v, scale=SCALE,
                                       segment_ids=jnp.asarray(seg), rope=jrope)

    o_w, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))

    seen = []
    real = port_flash.mh_flash_backward
    monkeypatch.setattr(port_flash, "mh_flash_backward", lambda *a, **kw:
                        seen.append((kw["block_q"], kw["block_kv"],
                                     kw["segment_skip"])) or real(*a, **kw))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = port_attention.attention(qt, kt, vt, scale=SCALE,
                                 segment_ids=torch.from_numpy(seg),
                                 rope=rope_tables(D, T2))
    got = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    assert seen == [(512, 512, True)]
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_w), rtol=2e-4, atol=2e-4)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# The wrappers of the split pair
# ---------------------------------------------------------------------------

def test_split_wrappers_route_cpu_tensors_to_the_plain_versions(monkeypatch):
    """mh_flash_bwd_dkv / mh_flash_bwd_dq run the plain versions on CPU
    tensors without building, loading or counting a kernel; the kernels' own
    entries refuse a CPU tensor instead of falling back."""
    from omnibiote_tpu_torch.ops import _kernels

    def refuse(*a, **k):
        raise AssertionError("the kernel library was touched")

    monkeypatch.setattr(_kernels, "load_library", refuse)
    monkeypatch.setattr(_kernels, "build_all", refuse)
    before = dict(_kernels.LAUNCHES)
    assert set(before) == {"mh_flash_fwd", "mh_flash_bwd", "mh_flash_bwd_mk",
                           "mh_flash_bwd_dkv", "mh_flash_bwd_dq", "int8_flash_fwd",
                           "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"}
    q, k, v, do, seg = _inputs("packed", seed=13)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    seg_t, rope = torch.from_numpy(seg), rope_tables(D, T)
    o, lse2 = mh_flash_forward_plain(*t[:3], seg_t, rope, scale=SCALE)
    di = (o * t[3]).sum(-1)
    kw = dict(scale=SCALE, block_q=64, block_kv=64, segment_skip=True)
    dk, dv = port_flash.mh_flash_bwd_dkv(*t, lse2, di, seg_t, rope, **kw)
    dq = port_flash.mh_flash_bwd_dq(*t, lse2, di, seg_t, rope, **kw)
    want = mh_flash_backward_plain(*t, lse2, di, seg_t, rope, scale=SCALE)
    for g, w in zip((dq, dk, dv), want):
        assert torch.equal(g, w)
    assert _kernels.LAUNCHES == before
    for kernel in (port_flash.mh_flash_bwd_dkv_kernel, port_flash.mh_flash_bwd_dq_kernel):
        with pytest.raises(ValueError, match="not a CUDA tensor"):
            kernel(*t, lse2, di, seg_t, rope, scale=SCALE)
