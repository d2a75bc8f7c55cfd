"""The bf16 fused backward's cluster kernel at head dims 384 and 512
(ops/csrc/mh_flash_bwd.cu::mh_bwd_pair), its partition checked on the CPU.

The kernel gives each CTA of a thread-block cluster a part of the head dim
closed under rotate-half, completes the scores S^T and dP^T by summing the
parts' partials in rank order, then forms dV, dK and dQ on its own part
with the inverse RoPE inside the part. The kernel runs only on the card;
here a Python mirror of its lane map (`pair_part_lanes`) is checked, and a
plain-PyTorch emulation of the cluster's arithmetic in fp32 on that map is
held against the port's plain backward (packed ids, RoPE, dropout 0 and
0.1 with the same keep bits) and against `jax.vjp` of the JAX package's
flash_attention (Pallas in interpret mode) at dropout 0."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omnibiote_tpu.ops.flash_attention as jax_flash
from omnibiote_tpu.models.rope import rope_tables as jax_rope_tables

from omnibiote_tpu_torch.models.rope import rope_tables
from omnibiote_tpu_torch.ops import flash_attention as fa

B, H, T = 1, 2, 128


def _inputs(seed, D, n_cuts=3):
    rng = np.random.default_rng(seed)
    q, k, v, do = rng.standard_normal((4, B, T, H, D)).astype(np.float32)
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(16, T - 16), n_cuts, replace=False))
        seg[b] = np.searchsorted(cuts, np.arange(T), side="right")
    return q, k, v, do, seg


@pytest.mark.parametrize("D", fa.PAIR_BWD_HEAD_DIMS)
def test_lane_map_covers_the_head_once_closed_under_rotate_half(D):
    """Every head-dim lane in exactly one part; each part closed under
    i <-> i + D/2, with part lane l and WQ + l rotate-half partners (the
    pairs the kernel's inverse RoPE takes from one thread's registers); the
    parts' widths are the kernel's (256 at D = 512, three of 128 at 384)."""
    parts = fa.pair_part_lanes(D)
    W = D // len(parts)
    assert (len(parts), W) == ((2, 256) if D == 512 else (3, 128))
    assert torch.equal(torch.sort(torch.cat(parts)).values, torch.arange(D))
    WQ = W // 2
    for part in parts:
        assert part.shape == (W,)
        assert set(((part + D // 2) % D).tolist()) == set(part.tolist())
        assert torch.equal(part[WQ:], part[:WQ] + D // 2)
        # a part's low half is one run of WQ lanes (the TMA boxes' panels)
        assert torch.equal(part[:WQ], part[0] + torch.arange(WQ))


def _pair_backward_emulated(q, k, v, do, lse2, di, seg, rope, *, scale, dropout_rate, seed):
    """The cluster kernel's arithmetic in fp32 on pair_part_lanes: each part's
    partial S^T and dP^T over its lanes, summed in rank order; p, dropout
    and dS from the sums (the same in every part); dV, dK and dQ of each
    part from its lanes, the inverse RoPE of dK and dQ inside the part."""
    Bq, Tq, Hq, D = q.shape
    parts = fa.pair_part_lanes(D)
    WQ = parts[0].shape[0] // 2
    cos, sin = (x[:Tq].float() for x in rope)  # (T, D/2)
    c2 = torch.cat([cos, cos], 1)[None, :, None]
    s2 = torch.cat([sin, sin], 1)[None, :, None]
    rot = lambda x: x * c2 + torch.cat([-x[..., D // 2:], x[..., :D // 2]], -1) * s2
    qr, kr = rot(q.float()), rot(k.float())
    S = dP = None
    for part in parts:  # rank order
        s_c = torch.einsum("bthd,bshd->bhts", qr[..., part], kr[..., part])
        dp_c = torch.einsum("bthd,bshd->bhts", do[..., part].float(), v[..., part].float())
        S = s_c if S is None else S + s_c
        dP = dp_c if dP is None else dP + dp_c
    bias = torch.where(seg[:, None, :, None] == seg[:, None, None, :], 0.0,
                       fa.DEFAULT_MASK_VALUE)
    s_log2 = S * float(np.float32(scale * fa.LOG2E)) + bias
    p = torch.exp2(s_log2 - lse2.permute(0, 2, 1)[..., None])
    if dropout_rate > 0.0:
        keep = fa.dropout_keep(seed, dropout_rate, Bq, Hq, Tq, 0, Tq, q.device)
        ks = fa.dropout_keep_scale(dropout_rate)
        p_drop, dP = torch.where(keep, p * ks, 0.0), torch.where(keep, dP * ks, 0.0)
    else:
        p_drop = p
    ds = p * (dP - di.permute(0, 2, 1)[..., None]) * scale
    dq, dk, dv = (torch.zeros(Bq, Tq, Hq, D) for _ in range(3))
    for c, part in enumerate(parts):
        dv[..., part] = torch.einsum("bhts,bthd->bshd", p_drop, do[..., part].float())
        cs = cos[None, :, None, WQ * c:WQ * c + WQ]
        sn = sin[None, :, None, WQ * c:WQ * c + WQ]
        for out, g in ((dk, torch.einsum("bhts,bthd->bshd", ds, qr[..., part])),
                       (dq, torch.einsum("bhts,bshd->bthd", ds, kr[..., part]))):
            x1, x2 = g[..., :WQ], g[..., WQ:]
            out[..., part] = torch.cat([x1 * cs + x2 * sn, x2 * cs - x1 * sn], -1)
    return dq, dk, dv


def _forward(q, k, v, seg, rope, D, **kw):
    o, lse2 = fa.mh_flash_forward_plain(q, k, v, seg, rope, scale=1.0 / np.sqrt(D), **kw)
    return o, lse2


@pytest.mark.parametrize("D,rate", [(384, 0.0), (384, 0.1), (512, 0.0), (512, 0.1)])
def test_emulated_pair_matches_plain_backward(D, rate):
    """The emulation against mh_flash_backward_plain, fp32, packed ids,
    RoPE, the same keep bits at dropout 0.1, at 1e-5 (fp32 sums in
    another order)."""
    q, k, v, do, seg = (torch.from_numpy(x) for x in _inputs(D + int(10 * rate), D))
    rope = rope_tables(D, T)
    kw = dict(dropout_rate=rate, seed=0xC1A + D)
    o, lse2 = _forward(q, k, v, seg, rope, D, **kw)
    di = (o * do).sum(-1)
    args = (q, k, v, do, lse2, di, seg, rope)
    want = fa.mh_flash_backward_plain(*args, scale=1.0 / np.sqrt(D), **kw)
    got = _pair_backward_emulated(*args, scale=1.0 / np.sqrt(D), **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("D", fa.PAIR_BWD_HEAD_DIMS)
def test_emulated_pair_matches_jax_vjp(D):
    """The emulation against jax.vjp of the JAX flash_attention (one kv block
    spanning T: the fused single-kv Pallas kernel, interpret mode), packed
    ids, RoPE, dropout 0, at 2e-4 (the JAX package's own flash-backward
    tolerance, as tests/test_torch_head_dim_wide.py holds the plain one)."""
    q, k, v, do, seg = _inputs(D + 7, D)
    cos, sin = jax_rope_tables(D, T)
    scale = 1.0 / np.sqrt(D)

    def f(q, k, v):
        return jax_flash.flash_attention(q, k, v, segment_ids=jnp.asarray(seg), scale=scale,
                                         block_q=128, block_kv=T, rope=(cos, sin),
                                         segment_skip=True)

    grads = jax.jit(lambda q, k, v, do: jax.vjp(f, q, k, v)[1](do))
    want = [np.asarray(g) for g in grads(*(jnp.asarray(x) for x in (q, k, v, do)))]
    tq, tk, tv, tdo, tseg = (torch.from_numpy(x) for x in (q, k, v, do, seg))
    rope = rope_tables(D, T)
    o, lse2 = _forward(tq, tk, tv, tseg, rope, D)
    got = _pair_backward_emulated(tq, tk, tv, tdo, lse2, (o * tdo).sum(-1), tseg, rope,
                                  scale=scale, dropout_rate=0.0, seed=0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4, err_msg=name)


def test_bf16_fused_backward_takes_the_cluster_kernel_layout():
    """What the wrapper hands the kernels: at D = 384 and 512 the bf16 fused
    kind (the cluster kernel, on the fused tiles (64, 64)) and the dkv kind
    (the same cluster without its dQ) take lse2 and di by head, (B, H, T),
    and rotate k themselves, as the Hopper kernels up to 256 do; the dq
    kind (its own cluster), fp32 and D = 640 keep (B, T, H) and k rotated
    ahead."""
    for D in fa.PAIR_BWD_HEAD_DIMS:
        assert fa.kernel_tiles("fused", torch.bfloat16, D) == (64, 64)
        assert fa.bwd_rows_by_head("fused", torch.bfloat16, D)
        assert fa.bwd_rows_by_head("dkv", torch.bfloat16, D)
        assert not fa.bwd_rows_by_head("dq", torch.bfloat16, D)
        assert not fa.bwd_rows_by_head("fused", torch.float32, D)
    for D in (128, 256):
        assert fa.bwd_rows_by_head("fused", torch.bfloat16, D)
        assert fa.bwd_rows_by_head("dkv", torch.bfloat16, D)
    assert fa.kernel_head_dim(640) and not fa.bwd_rows_by_head("fused", torch.bfloat16, 640)
    with pytest.raises(ValueError):
        fa.pair_part_lanes(640)
