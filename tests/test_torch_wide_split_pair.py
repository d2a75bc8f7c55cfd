"""The bf16 split backward pair's kernels at head dims 384 and 512
(ops/csrc/mh_flash_bwd_pair.cuh: mh_bwd_pair without its dQ, the dkv kernel;
mh_bwd_dq_cta, the dq kernel), their partitions checked on the CPU.

The dkv kernel gives each CTA of a thread-block cluster a part of the head
dim closed under rotate-half (`pair_part_lanes`), owns a 64-row kv tile and
walks q tiles: the parts' partial S^T and dP^T summed in rank order, dV and
dK on each part with the inverse RoPE inside it. The dq kernel is one CTA a
64-row q tile with all D lanes, walking 32-row (384) or 16-row (512) kv
tiles: its two consumers each form the partial S and dP over half of the
head dim, add the other's (consumer 0's first), and form dQ on lanes of
their own closed under rotate-half (64-lane panels p and p + D/128 pair up;
consumer 0 owns the first two pairs, consumer 1 the rest). The kernels run
only on the card; here plain-PyTorch emulations of those partitions in
fp32, walking the tiles the kernels' bounds give, are held against the
port's plain split pair (packed ids, RoPE, dropout 0 and 0.1 with the same
keep bits) and against `jax.vjp` of the JAX package's flash_attention
through its split pair (Pallas in interpret mode) at dropout 0."""
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


def _common(q, k, seg, rope, scale, dropout_rate, seed):
    """What both emulations share: the parts, q and k rotated in fp32, the
    inverse rotation of a part's (x1 | x2) halves, the mask bias, the keep
    mask (B, H, T, T) and its scale, the score factor."""
    D = q.shape[-1]
    parts = fa.pair_part_lanes(D)
    cos, sin = (x[:T].float() for x in rope)  # (T, D/2)
    c2 = torch.cat([cos, cos], 1)[None, :, None]
    s2 = torch.cat([sin, sin], 1)[None, :, None]
    rot = lambda x: x * c2 + torch.cat([-x[..., D // 2:], x[..., :D // 2]], -1) * s2
    WQ = parts[0].shape[0] // 2

    def inv_rot(g, c, rows):
        cs = cos[None, rows, None, WQ * c:WQ * c + WQ]
        sn = sin[None, rows, None, WQ * c:WQ * c + WQ]
        x1, x2 = g[..., :WQ], g[..., WQ:]
        return torch.cat([x1 * cs + x2 * sn, x2 * cs - x1 * sn], -1)

    bias = torch.where(seg[:, None, :, None] == seg[:, None, None, :], 0.0,
                       fa.DEFAULT_MASK_VALUE)
    keep = (fa.dropout_keep(seed, dropout_rate, B, H, T, 0, T) if dropout_rate > 0.0
            else torch.ones(B, H, T, T, dtype=torch.bool))
    ks = fa.dropout_keep_scale(dropout_rate) if dropout_rate > 0.0 else 1.0
    return parts, rot(q.float()), rot(k.float()), inv_rot, bias, keep, ks, float(
        np.float32(scale * fa.LOG2E))


def _walk(seg, kind, D):
    """(owner tile, walked tile, per-(batch, owner tile) walked range (lo,
    hi)) of the bf16 kernel of `kind` at D: its own tiles and its bounds."""
    bq, bkv = fa.kernel_tiles(kind, torch.bfloat16, D)
    sb = fa.SegmentBounds(seg)
    if kind == "dkv":
        return bkv, bq, sb.get(bkv, bq, kv_major=True)
    return bq, bkv, sb.get(bq, bkv)


def _dkv_emulated(q, k, v, do, lse2, di, seg, rope, *, scale, dropout_rate, seed):
    """mh_bwd_pair without dQ, in fp32: a cluster a kv tile walking the q
    tiles of its bounds; each part's partial S^T and dP^T over its lanes,
    summed in rank order; p, the keep mask and dS^T from the sums; dV and dK
    of each part from its lanes, the inverse RoPE of dK inside the part."""
    D = q.shape[-1]
    parts, qr, kr, inv_rot, bias, keep, ks, c = _common(q, k, seg, rope, scale,
                                                        dropout_rate, seed)
    tkv, tq, (lo, hi) = _walk(seg, "dkv", D)
    dk, dv = torch.zeros(B, T, H, D), torch.zeros(B, T, H, D)
    for b in range(B):
        for kt in range(T // tkv):
            kvr = slice(kt * tkv, kt * tkv + tkv)
            acc_k = [torch.zeros(tkv, H, p.shape[0]) for p in parts]
            acc_v = [torch.zeros(tkv, H, p.shape[0]) for p in parts]
            for qt in range(int(lo[b, kt]), int(hi[b, kt]) + 1):
                qrw = slice(qt * tq, qt * tq + tq)
                st = dpt = None
                for part in parts:  # rank order
                    s_c = torch.einsum("shd,thd->hst", kr[b, kvr][..., part], qr[b, qrw][..., part])
                    d_c = torch.einsum("shd,thd->hst", v[b, kvr][..., part],
                                       do[b, qrw][..., part])
                    st = s_c if st is None else st + s_c
                    dpt = d_c if dpt is None else dpt + d_c
                kp = keep[b][:, qrw, kvr].transpose(1, 2)  # (H, kv, q)
                p = torch.exp2(st * c + bias[b, 0, qrw, kvr].T[None]
                               - lse2[b, qrw].T[:, None, :])
                p_drop = torch.where(kp, p * ks, 0.0)
                ds = p * (torch.where(kp, dpt * ks, 0.0) - di[b, qrw].T[:, None, :]) * scale
                for i, part in enumerate(parts):
                    acc_v[i] += torch.einsum("hst,thd->shd", p_drop, do[b, qrw][..., part])
                    acc_k[i] += torch.einsum("hst,thd->shd", ds, qr[b, qrw][..., part])
            for i, part in enumerate(parts):
                dv[b, kvr][..., part] = acc_v[i]
                dk[b, kvr][..., part] = inv_rot(acc_k[i][None], i, kvr)[0]
    return dk, dv


def _dq_emulated(q, k, v, do, lse2, di, seg, rope, *, scale, dropout_rate, seed):
    """mh_bwd_dq_cta in fp32: a CTA a q tile walking the kv tiles of its
    bounds; consumer w forms the partial S and dP of the whole tile over
    head-dim lanes [D/2 w, D/2 w + D/2) (its D/128 panels), the two are
    added (consumer 0's + consumer 1's); p, the keep mask and dS from the
    sums; each consumer adds dS.K on the lanes it owns: the 64-lane panels
    pair as p and p + D/128, consumer 0 owns pairs 0 and 1, consumer 1 the
    rest. After the walk the inverse RoPE of each owner's lanes."""
    D = q.shape[-1]
    _, qr, kr, _, bias, keep, ks, c = _common(q, k, seg, rope, scale, dropout_rate, seed)
    tq, tkv, (lo, hi) = _walk(seg, "dq", D)
    halves = [torch.arange(D // 2 * w, D // 2 * (w + 1)) for w in range(2)]
    pairs = [torch.cat([torch.arange(64 * p, 64 * p + 64) + o for o in (0, D // 2)])
             for p in range(D // 128)]
    owned = [torch.cat(pairs[:2]), torch.cat(pairs[2:])]
    dq = torch.zeros(B, T, H, D)
    for b in range(B):
        for qt in range(T // tq):
            qrw = slice(qt * tq, qt * tq + tq)
            acc = [torch.zeros(tq, H, lanes.shape[0]) for lanes in owned]
            for kt in range(int(lo[b, qt]), int(hi[b, qt]) + 1):
                cols = slice(kt * tkv, kt * tkv + tkv)
                s = dp = None
                for lanes in halves:  # consumer 0's, then consumer 1's
                    s_w = torch.einsum("thd,shd->hts", qr[b, qrw][..., lanes], kr[b, cols][..., lanes])
                    d_w = torch.einsum("thd,shd->hts", do[b, qrw][..., lanes].float(),
                                       v[b, cols][..., lanes].float())
                    s = s_w if s is None else s + s_w
                    dp = d_w if dp is None else dp + d_w
                kp = keep[b][:, qrw, cols]
                p = torch.exp2(s * c + bias[b, 0, qrw, cols][None] - lse2[b, qrw].T[:, :, None])
                ds = p * (torch.where(kp, dp * ks, 0.0) - di[b, qrw].T[:, :, None]) * scale
                for w, lanes in enumerate(owned):
                    acc[w] += torch.einsum("hts,shd->thd", ds, kr[b, cols][..., lanes])
            g = torch.zeros(1, tq, H, D)
            for w, lanes in enumerate(owned):
                g[0][..., lanes] = acc[w]
            cos2, sin2 = fa._full_tables(rope, T, "cpu")
            dq[b, qrw] = fa._rope_rot_inv(g, cos2[:, qrw], sin2[:, qrw], D // 2)[0]
    return dq


def _case(D, rate, seed):
    q, k, v, do, seg = (torch.from_numpy(x) for x in _inputs(seed, D))
    rope = rope_tables(D, T)
    kw = dict(scale=1.0 / np.sqrt(D), dropout_rate=rate, seed=0x5B1 + D)
    o, lse2 = fa.mh_flash_forward_plain(q, k, v, seg, rope, **kw)
    return (q, k, v, do, lse2, (o * do).sum(-1), seg, rope), kw


@pytest.mark.parametrize("D,rate", [(384, 0.0), (384, 0.1), (512, 0.0), (512, 0.1)])
def test_dkv_emulation_matches_plain_dkv(D, rate):
    """(a) The dkv kernel's partition against mh_flash_bwd_dkv_plain, fp32,
    packed ids, RoPE, the same keep bits at dropout 0.1, at 1e-5 (fp32 sums
    in another order)."""
    args, kw = _case(D, rate, D + int(10 * rate))
    want = fa.mh_flash_bwd_dkv_plain(*args, **kw)
    got = _dkv_emulated(*args, **kw)
    for name, g, w in zip(("dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("D,rate", [(384, 0.0), (384, 0.1), (512, 0.0), (512, 0.1)])
def test_dq_emulation_matches_plain_dq(D, rate):
    """(b) The dq kernel's partition against mh_flash_bwd_dq_plain on the
    same inputs, at 1e-5."""
    args, kw = _case(D, rate, D + int(10 * rate))
    want = fa.mh_flash_bwd_dq_plain(*args, **kw)
    got = _dq_emulated(*args, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D", fa.PAIR_BWD_HEAD_DIMS)
def test_emulations_match_jax_split_pair_vjp(monkeypatch, D):
    """(c) Both emulations against jax.vjp of the JAX flash_attention with
    its split pair (FUSED_SINGLE_KV_BWD off: one kv block spanning T takes
    `_mh_bwd_dkv_kernel` and `_mh_bwd_dq_kernel`, interpret mode), packed
    ids, RoPE, dropout 0, at 2e-4 (the JAX package's own flash-backward
    tolerance, as tests/test_torch_head_dim_wide.py holds the plain one)."""
    monkeypatch.setattr(jax_flash, "FUSED_SINGLE_KV_BWD", False)
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
    o, lse2 = fa.mh_flash_forward_plain(tq, tk, tv, tseg, rope, scale=scale)
    args = (tq, tk, tv, tdo, lse2, (o * tdo).sum(-1), tseg, rope)
    kw = dict(scale=scale, dropout_rate=0.0, seed=0)
    got = (_dq_emulated(*args, **kw), *_dkv_emulated(*args, **kw))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4, err_msg=name)


def test_split_pair_tiles_and_layout_at_the_cluster_head_dims():
    """(d) What the wrappers hand the split pair's kernels: at D = 384 and
    512 in bf16 the dkv kernel is a cluster a 64-row kv tile walking 64-row
    q tiles, taking lse2 and di by head, (B, H, T), and rotating k itself;
    the dq kernel takes (B, T, H) with k rotated ahead and is one CTA a
    64-row q tile walking 32-row kv tiles at 384 and 16-row at 512 (whole
    16-row k-steps of dQ); fp32 and D = 640 keep the slice kernels'
    layout."""
    for D in fa.PAIR_BWD_HEAD_DIMS:
        assert fa.kernel_tiles("dkv", torch.bfloat16, D) == (64, 64)
        assert fa.kernel_tiles("dq", torch.bfloat16, D) == ((64, 32) if D == 384 else (64, 16))
        for kind in ("dkv", "dq"):
            assert fa.kernel_tiles(kind, torch.float32, D) == (64, 64)
            assert not fa.bwd_rows_by_head(kind, torch.float32, D)
        assert fa.kernel_tiles("dq", torch.bfloat16, D)[1] % 16 == 0
        assert fa.bwd_rows_by_head("dkv", torch.bfloat16, D)
        assert not fa.bwd_rows_by_head("dq", torch.bfloat16, D)
        assert fa.KERNEL_T_MULTIPLE[torch.bfloat16] % 64 == 0
    for kind in ("fused", "dkv", "dq"):
        assert not fa.bwd_rows_by_head(kind, torch.bfloat16, 640)
        assert fa.kernel_tiles(kind, torch.bfloat16, 640) == fa.KERNEL_TILES_SLICED[kind][
            torch.bfloat16]
