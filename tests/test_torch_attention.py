"""PyTorch port vs the JAX package: the plain version of the multi-head
flash forward against `_mh_fwd` (Pallas, interpret mode on the CPU), and
the port's attention dispatch against `ops/attention.py`'s routing."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import omnibiote_tpu.ops.attention as jax_attention
import omnibiote_tpu.ops.flash_attention as jax_flash
from omnibiote_tpu.models.rope import rope_tables as jax_rope_tables

import omnibiote_tpu_torch.ops.attention as port_attention
from omnibiote_tpu_torch.ops.flash_attention import (
    DEFAULT_MASK_VALUE, LOG2E, mh_flash_forward, mh_flash_forward_plain)
from omnibiote_tpu_torch.models.rope import rope_tables


def _segments(rng, B, T, layout):
    if layout == "dense":
        return None
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        if layout == "packed":
            # EOS-like boundaries: consecutive segment ids
            cuts = np.sort(rng.choice(np.arange(16, T - 16), 3, replace=False))
            seg[b] = np.searchsorted(cuts, np.arange(T), side="right")
        else:
            # padded tail: real tokens 0, PAD from `n` on -1
            n = int(rng.integers(T // 4, T - 8))
            seg[b, n:] = -1
    return seg


def _inputs(B, T, H, D, layout, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = rng.standard_normal((3, B, T, H, D)).astype(np.float32)
    return q, k, v, _segments(rng, B, T, layout)


def _jax_mh_fwd(q, k, v, seg, use_rope, block_kv, scale, dtype):
    B, T, H, D = q.shape
    seg_j = jnp.zeros((B, T), jnp.int32) if seg is None else jnp.asarray(seg)
    if use_rope:
        cos, sin = jax_rope_tables(D, T)
        cos2 = jnp.concatenate([cos, cos], axis=1)
        sin2 = jnp.concatenate([sin, sin], axis=1)
    else:
        cos2 = sin2 = jnp.zeros((1, 1), jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        o, lse = jax_flash._mh_fwd(
            jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
            seg_j, seg_j, cos2, sin2, 0, scale=scale, block_q=128,
            block_kv=block_kv, dropout_rate=0.0, use_rope=use_rope)
    return np.asarray(o.astype(jnp.float32)), np.asarray(lse)


def _port(q, k, v, seg, use_rope, block_kv, scale, dtype):
    T, D = q.shape[1], q.shape[3]
    t = lambda x: torch.from_numpy(x).to(dtype)
    o, lse = mh_flash_forward(
        t(q), t(k), t(v), None if seg is None else torch.from_numpy(seg),
        rope_tables(D, T) if use_rope else None, scale=scale,
        block_kv=None if block_kv == T else block_kv)
    return o.float().numpy(), lse.numpy()


T_TEST = 256


@pytest.mark.parametrize("block_kv", [T_TEST, 128], ids=["single_kv", "multi_kv"])
@pytest.mark.parametrize("use_rope", [True, False], ids=["rope", "norope"])
@pytest.mark.parametrize("layout", ["packed", "padded", "dense"])
@pytest.mark.parametrize("D", [64, 128])
def test_plain_matches_jax_mh_fwd_fp32(D, layout, use_rope, block_kv):
    """fp32: o and lse2 at rtol 2e-5 / atol 2e-5 (fp32 sums in another
    order, nothing else differs)."""
    q, k, v, seg = _inputs(2, T_TEST, 2, D, layout)
    scale = 1.0 / np.sqrt(D)
    jo, jl = _jax_mh_fwd(q, k, v, seg, use_rope, block_kv, scale, jnp.float32)
    po, pl = _port(q, k, v, seg, use_rope, block_kv, scale, torch.float32)
    np.testing.assert_allclose(po, jo, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(pl, jl, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("block_kv", [T_TEST, 128], ids=["single_kv", "multi_kv"])
def test_plain_matches_jax_mh_fwd_bf16(block_kv):
    """bf16 inputs: both round rotated q/k and P to bf16 at the same points,
    but fp32 sums in another order can flip a bf16 rounding of P or of o,
    so o is held to 1e-2 (about two bf16 ulps at |o| ~ 1) and the fp32
    lse2 to 1e-4."""
    q, k, v, seg = _inputs(2, T_TEST, 2, 128, "packed", seed=3)
    scale = 1.0 / np.sqrt(128)
    jo, jl = _jax_mh_fwd(q, k, v, seg, True, block_kv, scale, jnp.bfloat16)
    po, pl = _port(q, k, v, seg, True, block_kv, scale, torch.bfloat16)
    np.testing.assert_allclose(po, jo, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-4)


def test_isolated_query_sees_only_itself():
    """A query whose segment id no other position carries attends to its own
    key alone: the finite mask bias gives every other key exactly zero
    weight, and the other queries never see that key."""
    q, k, v, _ = _inputs(1, 128, 1, 64, "dense", seed=5)
    seg = np.zeros((1, 128), np.int32)
    seg[0, 0] = 7
    scale = 0.125
    o, lse = mh_flash_forward_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(seg), None, scale=scale)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(o[0, 0].numpy(), v[0, 0], rtol=1e-6, atol=1e-6)
    s_self = float(np.float32(q[0, 0, 0] @ k[0, 0, 0]) * np.float32(scale * LOG2E))
    assert lse[0, 0, 0].item() == pytest.approx(s_self, rel=1e-5, abs=1e-5)
    rest, _ = mh_flash_forward_plain(
        torch.from_numpy(q[:, 1:]), torch.from_numpy(k[:, 1:]),
        torch.from_numpy(v[:, 1:]), None, None, scale=scale)
    np.testing.assert_allclose(o[0, 1:].numpy(), rest[0].numpy(), rtol=1e-5,
                               atol=1e-6)


def test_fully_masked_tile_leaves_no_trace():
    """Online softmax across kv tiles: rows of the second segment meet a
    first tile that is fully masked for them. The finite mask value
    (never -inf, so never inf - inf) makes that tile's weight vanish once
    the visible tile arrives, and the result equals the single-block one."""
    q, k, v, _ = _inputs(2, 256, 2, 64, "dense", seed=6)
    seg = torch.zeros(2, 256, dtype=torch.int32)
    seg[:, 128:] = 1
    args = [torch.from_numpy(x) for x in (q, k, v)] + [seg, None]
    o1, l1 = mh_flash_forward_plain(*args, scale=0.2, block_kv=None)
    o2, l2 = mh_flash_forward_plain(*args, scale=0.2, block_kv=128)
    assert torch.isfinite(o2).all() and torch.isfinite(l2).all()
    np.testing.assert_allclose(o2.numpy(), o1.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=1e-6, atol=1e-5)
    assert DEFAULT_MASK_VALUE == pytest.approx(-0.7 * np.finfo(np.float32).max)
    assert LOG2E == pytest.approx(np.log2(np.e))


# ---------------------------------------------------------------------------
# Dispatch: the port routes as ops/attention.py does
# ---------------------------------------------------------------------------

def _jax_route(monkeypatch, q, k, v, **kw):
    seen = []

    def fake_flash(q, k, v, *, block_q, block_kv, block_kv_fwd=None, **_):
        seen.append(("flash", block_q, block_kv, block_kv_fwd or block_kv))
        return q

    def fake_xla(q, k, v, **_):
        seen.append(("xla", None))
        return q

    monkeypatch.setattr(jax_flash, "flash_attention", fake_flash)
    monkeypatch.setattr(jax_attention, "xla_attention", fake_xla)
    jax_attention.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **kw)
    return seen


def _port_route(monkeypatch, q, k, v, **kw):
    seen = []

    def fake_flash(q, k, v, segment_ids, rope, *, scale, block_q, block_kv,
                   block_kv_fwd=None, dropout_rate=0.0, seed=0,
                   segment_skip=True, bounds=None):
        assert segment_skip
        seen.append(("flash", block_q, block_kv, block_kv_fwd or block_kv))
        return q

    def fake_xla(q, k, v, **_):
        seen.append(("xla", None))
        return q

    monkeypatch.setattr(port_attention, "flash_attention", fake_flash)
    monkeypatch.setattr(port_attention, "xla_attention", fake_xla)
    port_attention.attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **kw)
    return seen


@pytest.mark.parametrize("T,H,D,causal,segs,block_kv", [
    (256, 2, 128, False, True, None),    # flash, single kv
    (1024, 8, 128, False, False, None),  # the serving shape
    (1536, 1, 128, False, True, None),   # sequence-wide forward block
    (2048, 1, 128, False, False, None),
    (4096, 1, 128, False, True, None),   # long packed: 512-wide kv blocks
    (3072, 1, 128, False, False, None),
    (768, 2, 128, False, True, 384),     # explicit block, _fit_block
    (640, 1, 64, False, False, 512),     # one head: any head_dim
    (256, 2, 64, False, True, None),     # narrow heads: dense path
    (256, 2, 128, True, False, None),    # causal: dense path
    (200, 2, 128, False, True, None),    # T % 128 != 0: dense path
])
def test_dispatch_matches_jax(monkeypatch, T, H, D, causal, segs, block_kv):
    rng = np.random.default_rng(0)
    q, k, v = rng.standard_normal((3, 1, T, H, D)).astype(np.float32)
    seg = np.zeros((1, T), np.int32) if segs else None
    cos, sin = rope_tables(D, T)
    jcos, jsin = jax_rope_tables(D, T)
    common = dict(scale=0.1, causal=causal, block_kv=block_kv)
    want = _jax_route(monkeypatch, q, k, v, rope=(jcos, jsin),
                      segment_ids=None if seg is None else jnp.asarray(seg),
                      **common)
    got = _port_route(monkeypatch, q, k, v, rope=(cos, sin),
                      segment_ids=None if seg is None else torch.from_numpy(seg),
                      **common)
    assert got == want


@pytest.mark.parametrize("causal,segs", [(False, True), (True, False),
                                         (True, True)])
def test_xla_attention_matches_jax(causal, segs):
    """The dense twin of xla_attention, fp32 at rtol 2e-5 / atol 2e-5."""
    q, k, v, seg = _inputs(2, 96, 2, 32, "packed" if segs else "dense",
                           seed=4)
    want = jax_attention.xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.2,
        segment_ids=None if seg is None else jnp.asarray(seg), causal=causal)
    got = port_attention.xla_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=0.2, segment_ids=None if seg is None else torch.from_numpy(seg),
        causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("T,want", [(128, 128), (640, 128), (768, 384),
                                    (1024, 512), (4096, 512), (1536, 512)])
def test_fit_block_matches_jax(T, want):
    assert port_attention._fit_block(T, 512) == jax_attention._fit_block(T, 512)
    assert port_attention._fit_block(T, 512) == want


@pytest.mark.parametrize("kw", [dict(impl="ring"), dict(tp_mesh=object())])
def test_unported_modes_raise(kw):
    q = torch.zeros(1, 128, 1, 128)
    with pytest.raises(NotImplementedError):
        port_attention.attention(q, q, q, scale=0.1, **kw)


# ---------------------------------------------------------------------------
# RoPE tables and rotations, segment ids: exact twins of the JAX helpers
# ---------------------------------------------------------------------------

def test_rope_matches_jax():
    from omnibiote_tpu.models import rope as jax_rope
    from omnibiote_tpu_torch.models import rope as port_rope
    cos, sin = port_rope.rope_tables(64, 200, 500.0)
    jcos, jsin = jax_rope.rope_tables(64, 200, 500.0)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))
    np.testing.assert_array_equal(port_rope.qkv_col_perm(3, 64),
                                  jax_rope.qkv_col_perm(3, 64))
    rng = np.random.default_rng(7)
    q, k = rng.standard_normal((2, 2, 96, 3, 64)).astype(np.float32)
    for name in ("apply_rope", "apply_rope_half"):
        got = getattr(port_rope, name)(torch.from_numpy(q), torch.from_numpy(k),
                                       cos, sin)
        want = getattr(jax_rope, name)(jnp.asarray(q), jnp.asarray(k), jcos, jsin)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


def test_segments_match_jax():
    import omnibiote_tpu.ops.segments as jax_seg
    import omnibiote_tpu_torch.ops.segments as port_seg
    rng = np.random.default_rng(8)
    ids = rng.integers(4, 50, size=(3, 64)).astype(np.int32)
    ids[ids % 7 == 0] = 3                     # EOS
    ids[1, 40:] = 1                           # PAD tail
    t = torch.from_numpy(ids)
    np.testing.assert_array_equal(port_seg.segment_ids_np(ids),
                                  jax_seg.segment_ids_np(ids))
    np.testing.assert_array_equal(port_seg.segment_ids_torch(t).numpy(),
                                  np.asarray(jax_seg.segment_ids_jnp(jnp.asarray(ids))))
    np.testing.assert_array_equal(
        port_seg.padding_segment_ids_torch(t, 1).numpy(),
        np.asarray(jax_seg.padding_segment_ids_jnp(jnp.asarray(ids), 1)))
    np.testing.assert_array_equal(port_seg.padding_segment_ids_np(ids, 1),
                                  jax_seg.padding_segment_ids_np(ids, 1))
    seg = port_seg.segment_ids_np(ids)
    np.testing.assert_array_equal(
        port_seg.additive_mask(torch.from_numpy(seg)).numpy(),
        np.asarray(jax_seg.additive_mask(jnp.asarray(seg))))
    assert port_seg.NEG_INF == jax_seg.NEG_INF
