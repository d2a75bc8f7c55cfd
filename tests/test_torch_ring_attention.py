"""PyTorch port vs the JAX package: separate q and kv segment ids in the
flash path, and the ring attention bodies, in one process on the CPU.

  * `flash_attention_lse` with q ids != kv ids (a ring rotation's pair)
    against the JAX package's `_flash_mh_lse(q_seg, kv_seg)` on one device
    (Pallas in interpret mode, no shard_map): o, lse and the gradients under
    a random (do, dlse) cotangent, at B = 1, T = 256, H = 2, D = 128;
  * `SegmentBounds(q_ids, kv_ids)` against `_seg_block_bounds` both ways
    round, and skipping on against off bit for bit where the ring gives a
    row weight;
  * `ring_body_plain` and `ring_body_flash` (the plain versions of the
    kernels) with the rotation emulated over N = 4 blocks of one sequence,
    against the JAX package's whole-sequence `xla_attention`: forward
    rtol/atol 2e-5, gradients 5e-4 (tests/test_ring_attention.py's);
  * the two bodies at dropout 0.1 drawing the same Philox masks; a ring of
    one through the model, whose rotations compute no skip bounds; the
    global-draw slices of the dropout and MLM masks.

The multi-rank ring (P2P over gloo) and the sp Trainers are in
tests/test_torch_parallel.py. No test here runs the JAX flash ring body.
"""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnibiote_tpu.ops import flash_attention as jax_flash
from omnibiote_tpu.ops.attention import xla_attention as jax_xla_attention

import omnibiote_tpu_torch as port
from omnibiote_tpu_torch.models import omnibiota as port_model
from omnibiote_tpu_torch.ops import flash_attention as port_flash
from omnibiote_tpu_torch.ops import ring_attention as ra
from omnibiote_tpu_torch.ops.flash_attention import (
    SegmentBounds, flash_attention_lse, mh_flash_backward_plain,
    mh_flash_bwd_dkv_plain, mh_flash_bwd_dq_plain, mh_flash_forward_plain)
from omnibiote_tpu_torch.training import mlm as port_mlm

N = 4


def _row(T, n_eos, rng):
    """Segment ids of one packed row of T positions with n_eos cuts."""
    cuts = np.sort(rng.choice(np.arange(8, T - 8), n_eos, replace=False))
    return np.searchsorted(cuts, np.arange(T), side="right").astype(np.int32)


def _pair(B, Tl, rng):
    """(q ids, kv ids) of a rotation: the last and the first block of rows
    2·Tl long, so some q rows see none of the kv block."""
    rows = np.stack([_row(2 * Tl, 3, rng) for _ in range(B)])
    return rows[:, Tl:].copy(), rows[:, :Tl].copy()


# ---------------------------------------------------------------------------
# Two ids arrays in the flash path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_flash_lse_with_kv_ids_matches_jax(monkeypatch, fused):
    """o, lse and (dq, dk, dv) under a random (do, dlse), fp32, against
    `_flash_mh_lse(q_seg, kv_seg)` with 128-row blocks (multi-kv, skipping
    on), rtol/atol 2e-4 (lse 1e-5), the tolerances of
    tests/test_torch_attention_skip.py. The pair has q rows that see no key
    of the block; as in the ring, whose combine gives them a weight of
    exactly 0, their cotangent is 0 (their gradients would depend on which
    tiles a backward walks for them, which differs between the packages'
    kernels)."""
    B, T, H, D = 1, 256, 2, 128
    scale = 1.0 / np.sqrt(D)
    rng = np.random.default_rng(3)
    q, k, v, do = rng.standard_normal((4, B, T, H, D)).astype(np.float32)
    dlse = rng.standard_normal((B, T, H)).astype(np.float32)
    q_ids, kv_ids = _pair(B, T, rng)
    sees = (q_ids[:, :, None] == kv_ids[:, None, :]).any(-1)
    assert not sees.all() and sees.any()
    do, dlse = do * sees[..., None, None], dlse * sees[..., None]
    dummy = jnp.zeros((1, 1), jnp.float32)

    def f(q, k, v):
        return jax_flash._flash_mh_lse(q, k, v, jnp.asarray(q_ids), jnp.asarray(kv_ids),
                                       dummy, dummy, jnp.int32(0), scale, 128, 128,
                                       0.0, False, True)

    old = jax_flash.FUSED_MULTIKV_BWD
    jax_flash.FUSED_MULTIKV_BWD = fused
    try:
        (o_w, lse_w), vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
        want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    finally:
        jax_flash.FUSED_MULTIKV_BWD = old

    monkeypatch.setattr(port_flash, "FUSED_MULTIKV_BWD", fused)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = flash_attention_lse(qt, kt, vt, torch.from_numpy(q_ids), None,
                                 scale=scale, block_q=128, block_kv=128,
                                 kv_segment_ids=torch.from_numpy(kv_ids))
    got = torch.autograd.grad((o, lse), (qt, kt, vt),
                              (torch.from_numpy(do), torch.from_numpy(dlse)))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_w), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(lse_w), rtol=1e-5, atol=1e-5)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("blocks", [(128, 128), (64, 32), (32, 64)])
def test_segment_bounds_of_a_pair_match_jax(blocks):
    """SegmentBounds(q, kv).get: q-major as _seg_block_bounds(q, kv),
    kv_major as _seg_block_bounds(kv, q); one array shares one entry."""
    q_ids, kv_ids = _pair(2, 256, np.random.default_rng(4))
    sb = SegmentBounds(torch.from_numpy(q_ids), torch.from_numpy(kv_ids))
    a, b = blocks
    for got, (x, y) in ((sb.get(a, b), (q_ids, kv_ids)),
                        (sb.get(a, b, kv_major=True), (kv_ids, q_ids))):
        want = jax_flash._seg_block_bounds(jnp.asarray(x), jnp.asarray(y), a, b)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    one = SegmentBounds(torch.from_numpy(q_ids))
    assert one.get(a, b, kv_major=True) is one.get(a, b)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_skip_on_equals_off_with_kv_ids(rate):
    """The plain forward and the three plain backwards with a pair of ids:
    skipping on equals off bit for bit on every q row that sees a key of
    the block (o, lse2), and in dq, dk, dv when the blind rows carry no
    cotangent, as the ring's combine gives them."""
    B, T, H, D = 2, 256, 2, 64
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(x) for x in
                   rng.standard_normal((4, B, T, H, D)).astype(np.float32))
    q_ids, kv_ids = (torch.from_numpy(x) for x in _pair(B, T, rng))
    sees = (q_ids[:, :, None] == kv_ids[:, None, :]).any(-1)     # (B, T)
    assert not sees.all()
    do = torch.where(sees[..., None, None], do, 0.0)
    kw = dict(scale=0.125, dropout_rate=rate, seed=9, kv_segment_ids=kv_ids)
    tiles = dict(block_q=64, block_kv=32)
    o_off, lse_off = mh_flash_forward_plain(q, k, v, q_ids, None, block_kv=32, **kw)
    o_on, lse_on = mh_flash_forward_plain(q, k, v, q_ids, None, **tiles, **kw,
                                          segment_skip=True)
    assert torch.equal(o_on[sees], o_off[sees]) and torch.equal(lse_on[sees], lse_off[sees])
    di = torch.where(sees[..., None], (o_off * do).sum(-1), 0.0)
    args = (q, k, v, do, lse_off, di, q_ids, None)
    sb = SegmentBounds(q_ids, kv_ids)
    for plain in (mh_flash_backward_plain, mh_flash_bwd_dkv_plain, mh_flash_bwd_dq_plain):
        off = plain(*args, **kw)
        on = plain(*args, **tiles, **kw, segment_skip=True, bounds=sb)
        for a, b in zip(off if isinstance(off, tuple) else (off,),
                        on if isinstance(on, tuple) else (on,)):
            assert torch.equal(a, b), plain.__name__


def test_kv_ids_need_q_ids():
    x = torch.zeros(1, 128, 1, 64)
    with pytest.raises(ValueError, match="kv_segment_ids needs segment_ids"):
        flash_attention_lse(x, x, x, None, scale=1.0,
                            kv_segment_ids=torch.zeros(1, 128, dtype=torch.int32))


# ---------------------------------------------------------------------------
# The ring bodies, the rotation emulated in one process
# ---------------------------------------------------------------------------

def _ring_inputs(seed, B=2, T=512, H=2, D=64):
    rng = np.random.default_rng(seed)
    q, k, v, g = rng.standard_normal((4, B, T, H, D)).astype(np.float32)
    seg = np.stack([_row(T, 5, rng) for _ in range(B)])
    return q, k, v, g, seg


def _emulated(body, q, k, v, seg, **kw):
    """Every ring member's body on its block of q, the blocks of k, v and
    the ids that each rotation would bring it; o on the whole sequence."""
    T = q.shape[1]
    Tl = T // N
    cut = lambda x, j: x[:, j * Tl:(j + 1) * Tl]
    outs = []
    for i in range(N):
        q_ids = cut(seg, i).contiguous()
        kv_ids = [None] + [cut(seg, (i - r) % N).contiguous() for r in range(1, N)]
        blocks = lambda r, i=i: (cut(k, (i - r) % N), cut(v, (i - r) % N))
        seeds = [ra.ring_seed(kw.get("seed", 0), i, r) for r in range(N)]
        rate = kw.get("dropout_rate", 0.0)
        if body == "plain":
            outs.append(ra.ring_body_plain(cut(q, i), blocks, N, q_ids, kv_ids,
                                           scale=kw["scale"], dropout_rate=rate,
                                           seeds=seeds))
        else:
            segs = ra.RingSegments(q_ids, kv_ids)
            bq, bkv = ra.ring_blocks(Tl)
            outs.append(ra.ring_body_flash(cut(q, i), blocks, N, q_ids, segs,
                                           scale=kw["scale"], dropout_rate=rate,
                                           seeds=seeds, block_q=bq, block_kv=bkv))
    return torch.cat(outs, 1)


@pytest.mark.parametrize("body", ["plain", "flash"])
def test_ring_bodies_match_whole_sequence_attention(body):
    """N = 4 blocks of Tl = 128 (D 64): o and (dq, dk, dv) of the emulated
    ring against JAX xla_attention on the whole sequence."""
    q, k, v, g, seg = _ring_inputs(7)
    scale = 0.125
    want, vjp = jax.vjp(lambda q, k, v: jax_xla_attention(
        q, k, v, scale=scale, segment_ids=jnp.asarray(seg)),
        *(jnp.asarray(x) for x in (q, k, v)))
    want_g = vjp(jnp.asarray(g))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = _emulated(body, qt, kt, vt, torch.from_numpy(seg), scale=scale)
    got_g = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(g))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    for name, a, b in zip(("dq", "dk", "dv"), got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4, atol=5e-4,
                                   err_msg=name)


def test_ring_bodies_agree_under_dropout():
    """Dropout 0.1: the flash body's plain kernels against the plain body,
    both drawing the Philox masks of ring_seed(seed, member, rotation),
    forward and gradients at the dropout-free tolerances above; the masks
    are drawn (the output moves)."""
    q, k, v, g, seg = _ring_inputs(8)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    kw = dict(scale=0.125, dropout_rate=0.1, seed=1234)
    outs = {b: _emulated(b, *ts, torch.from_numpy(seg), **kw) for b in ("plain", "flash")}
    grads = {b: torch.autograd.grad(o, ts, torch.from_numpy(g)) for b, o in outs.items()}
    torch.testing.assert_close(outs["flash"], outs["plain"], rtol=2e-5, atol=2e-5)
    for a, b in zip(grads["flash"], grads["plain"]):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-4)
    still = _emulated("plain", *ts, torch.from_numpy(seg), scale=0.125)
    assert (still - outs["plain"]).abs().max() > 1e-2


def test_ring_seeds_are_distinct():
    seeds = {ra.ring_seed(5, m, r) for m in range(8) for r in range(8)}
    assert len(seeds) == 64 and ra.ring_seed(5, 1, 2) == ra.ring_seed(5, 1, 2)


# ---------------------------------------------------------------------------
# A ring of one through the model
# ---------------------------------------------------------------------------

CFG = dict(n_layer=2, n_embd=256, n_head=2, vocab_size=128, block_size=256,
           dropout=0.0, compute_dtype="float32", param_dtype="float32")


def _model(attn_impl, **kw):
    cfg = port.OmniBioTAConfig(**dict(CFG, attn_impl=attn_impl, **kw))
    return port.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")


def test_ring_of_one_forward_equals_flash_and_computes_no_bounds_in_rotations(monkeypatch):
    """attn_impl='ring' with no mesh (a ring of one, the flash body at heads
    of 128) gives the flash path's logits and gradients (rtol/atol 1e-5);
    every skip bound of the forward and backward is computed by
    RingSegments.prefill, none inside an attention call."""
    rng = np.random.default_rng(2)
    idx = torch.from_numpy(rng.integers(4, 128, (2, 256)).astype(np.int32))
    seg = torch.from_numpy(np.stack([_row(256, 4, rng) for _ in range(2)]))
    calls = {"prefill": 0, "elsewhere": 0}
    real = port_flash.seg_block_bounds
    in_prefill = [False]

    def counting(*a, **k):
        calls["prefill" if in_prefill[0] else "elsewhere"] += 1
        return real(*a, **k)

    real_prefill = ra.RingSegments.prefill

    def prefill(self, *a, **k):
        in_prefill[0] = True
        try:
            return real_prefill(self, *a, **k)
        finally:
            in_prefill[0] = False

    out = {}
    for impl in ("flash", "ring"):
        m = _model(impl)
        if impl == "ring":
            monkeypatch.setattr(port_flash, "seg_block_bounds", counting)
            monkeypatch.setattr(ra.RingSegments, "prefill", prefill)
        logits = m(idx, seg)
        grads = torch.autograd.grad(logits.square().mean(), list(m.parameters()))
        out[impl] = (logits, grads)
    torch.testing.assert_close(out["ring"][0], out["flash"][0], rtol=1e-5, atol=1e-5)
    for a, b in zip(out["ring"][1], out["flash"][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert calls["prefill"] > 0 and calls["elsewhere"] == 0, calls


def test_ring_dispatch_refuses_causal():
    x = torch.zeros(1, 128, 1, 64)
    from omnibiote_tpu_torch.ops.attention import attention
    with pytest.raises(ValueError, match="no causal support"):
        attention(x, x, x, scale=1.0, causal=True, impl="ring")


def test_block_masks_are_slices_of_the_whole_draw():
    """A block of positions takes its slice of the whole sequence's
    dropout and MLM draws (cols), and rows and cols compose."""
    x = torch.ones(3, 16, 8)
    whole = port_model._dropout(x, 0.5, 77)
    part = port_model._dropout(x[:, 8:12], 0.5, 77, cols=(8, 16))
    assert torch.equal(part, whole[:, 8:12])
    tokens = torch.full((6, 32), 9, dtype=torch.int32)
    g = lambda: torch.Generator().manual_seed(3)
    whole = port_mlm.make_mlm_mask(g(), tokens)
    tile = port_mlm.make_mlm_mask(g(), tokens[2:4, 16:24], rows=(2, 6), cols=(16, 32))
    assert torch.equal(tile, whole[2:4, 16:24])


def test_sp_refuses_more_than_one_data_host():
    """As the JAX Trainer does: per-host pipelines would have to cut the
    sequence too."""
    from omnibiote_tpu_torch.config import TrainConfig
    from omnibiote_tpu_torch.training.train import Trainer
    cfg = port.OmniBioTAConfig(**dict(CFG, attn_impl="ring"))
    with pytest.raises(ValueError, match="data_hosts>1 with sequence sharding"):
        Trainer(cfg, TrainConfig(batch_size=4, mini_batch_size=2, ctx_len=256,
                                 sharding="sp"), data_hosts=2, device="cpu")
