"""The bf16 dq kernel's walk, mirrored in PyTorch on the CPU.

`mh_bwd_dq_wgmma` in omnibiote_tpu_torch/ops/csrc/mh_flash_bwd_dq.cu is a
CUDA kernel, which has no CPU mode. These tests mirror what it does: a CTA
owns a (batch, head, 128-row q tile) and takes the kv tiles of 64 rows (32
at D = 256) that its segment bounds give (`SegmentBounds.get(128, 64)`); its two consumer
warpgroups own 64 q rows each; each kv tile arrives as the boxes the
producer thread asks the TMA unit for (3-D tensor maps: rows past T are
zeros, never the next batch row's); S, dP, p, the keep-mask on dp and ds
are formed per tile, ds rounded to the inputs' dtype as the operand of
dQ += dS.K; dq leaves as 64-row boxes of the dq map. The mirror is held
against the plain version (`mh_flash_bwd_dq_plain` on the kernel's
tiles). `chip_smoke.py` is what proves the kernel itself, on the card,
against the same plain version."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import numpy as np
import pytest
import torch

from omnibiote_tpu_torch.models.rope import rope_tables
from omnibiote_tpu_torch.ops.flash_attention import (
    DEFAULT_MASK_VALUE, KERNEL_TILES, LOG2E, SegmentBounds, _full_tables, _rope_rot,
    _rope_rot_inv, dropout_keep, dropout_keep_scale, kernel_tiles, mh_flash_bwd_dq_plain,
    mh_flash_forward_plain)

BF16 = torch.bfloat16
BQ, BKV = KERNEL_TILES["dq"][BF16]
CONSUMER_ROWS = 64
PANEL = 64
H, D = 2, 128
SCALE = 1.0 / np.sqrt(D)


def kv_tiles(bounds, b, qt, T, bkv=BKV):
    """The kv tiles CTA (b, qt) walks: its bounds' range, or all."""
    if bounds is None:
        return range(T // bkv)
    lo, hi = bounds
    return range(int(lo[b, qt]), int(hi[b, qt]) + 1)


def consumer_rows(qt, w):
    """The q rows consumer warpgroup w of q tile qt owns."""
    r0 = qt * BQ + w * CONSUMER_ROWS
    return range(r0, r0 + CONSUMER_ROWS)


def kv_boxes(b, h, jt, d=D, bkv=BKV):
    """The (column, row, batch) corners of the boxes the producer loads for
    kv tile jt: one a 64-column panel of head h, for K and for V alike."""
    return [(h * d + pn * PANEL, jt * bkv, b) for pn in range(d // PANEL)]


def dq_store_boxes(b, h, qt, w):
    """The (column, row, batch) corners of consumer w's dq stores."""
    return [(h * D + pn * PANEL, consumer_rows(qt, w)[0], b) for pn in range(D // PANEL)]


def box(x, corner, rows):
    """A 3-D map's box: x (B, T, H*D), `rows` rows by one 64-column panel at
    (column, row, batch), zeros past T, never the next batch row's."""
    c0, r0, b = corner
    out = torch.zeros(rows, PANEL, dtype=x.dtype)
    r1 = min(r0 + rows, x.shape[1])
    if r1 > r0:
        out[:r1 - r0] = x[b, r0:r1, c0:c0 + PANEL]
    return out


def dq_walk(q, k, v, do, lse2, di, seg, rope, *, rate=0.0, seed=0, bounds=None):
    """The dq kernel's function walked as its CTAs and consumers walk it,
    on its tiles at q's head dim."""
    B, T, _, d = q.shape
    dtype = q.dtype
    bq, bkv = kernel_tiles("dq", BF16, d)
    scale = 1.0 / np.sqrt(d)
    if rope is not None:
        tables = _full_tables(rope, T, q.device)
        q = _rope_rot(q, *tables, d // 2).to(dtype)
        k = _rope_rot(k, *tables, d // 2).to(dtype)
    kx, vx = k.reshape(B, T, H * d), v.reshape(B, T, H * d)
    c = float(np.float32(scale * LOG2E))
    keep = (dropout_keep(seed, rate, B, H, T, 0, T) if rate > 0 else None)
    ks = dropout_keep_scale(rate) if rate > 0 else 1.0
    acc = torch.zeros(B, T, H, d)
    for b in range(B):
        for h in range(H):
            for qt in range(T // bq):
                for w in (0, 1):
                    rows = consumer_rows(qt, w)
                    rs = slice(rows[0], rows[-1] + 1)
                    qw, ow = q[b, rs, h].float(), do[b, rs, h].float()
                    for jt in kv_tiles(bounds, b, qt, T, bkv):
                        boxes = kv_boxes(b, h, jt, d, bkv)
                        kt = torch.cat([box(kx, bx, bkv) for bx in boxes], 1).float()
                        vt = torch.cat([box(vx, bx, bkv) for bx in boxes], 1).float()
                        s2 = (qw @ kt.T) * c
                        cols = slice(jt * bkv, (jt + 1) * bkv)
                        if seg is not None:
                            vis = seg[b, rs, None] == seg[b, None, cols]
                            s2 = s2 + torch.where(vis, 0.0, DEFAULT_MASK_VALUE)
                        p = torch.exp2(s2 - lse2[b, rs, h, None])
                        dp = ow @ vt.T
                        if keep is not None:
                            dp = torch.where(keep[b, h, rs, cols], dp * ks, 0.0)
                        ds = (p * (dp - di[b, rs, h, None]) * scale).to(dtype).float()
                        acc[b, rs, h] += ds @ kt
    if rope is not None:
        acc = _rope_rot_inv(acc, *tables, d // 2)
    return acc.to(dtype)


def _inputs(B, T, layout, dtype, seed, d=D):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(x).to(dtype)
                   for x in rng.standard_normal((4, B, T, H, d)).astype(np.float32))
    seg = None
    if layout != "dense":
        ids = np.zeros((B, T), np.int32)
        for b in range(B):
            cuts = np.sort(rng.choice(np.arange(16, T - 16), 3, replace=False))
            ids[b] = np.searchsorted(cuts, np.arange(T), side="right")
            if layout == "padded":
                ids[b, int(rng.integers(T // 4, T - 8)):] = -1
        seg = torch.from_numpy(ids)
    return q, k, v, do, seg


def test_boxes_and_rows_literal():
    """A CTA's consumers split its 128 rows in halves; a kv tile is D/64
    boxes of 64 rows at its first row; the dq stores land on the
    consumer's rows; a box at the edge of a batch entry reads zeros past T,
    not the next entry's first rows."""
    assert consumer_rows(3, 0) == range(384, 448)
    assert consumer_rows(3, 1) == range(448, 512)
    assert kv_boxes(1, 1, 5) == [(128, 320, 1), (192, 320, 1)]
    assert dq_store_boxes(0, 1, 2, 1) == [(128, 320, 0), (192, 320, 0)]
    x = torch.arange(2 * 96 * 128, dtype=torch.float32).reshape(2, 96, 128)
    edge = box(x, (64, 64, 0), 64)
    assert torch.equal(edge[:32], x[0, 64:96, 64:128])
    assert not edge[32:].any()


def test_kv_ranges_come_from_the_bounds():
    """Each CTA's kv tiles are its bounds' inclusive range at (128, 64), and
    the walked tiles are the count the card's check holds the kernel's
    tile_count to."""
    B, T = 2, 512
    seg = _inputs(B, T, "packed", torch.float32, seed=3)[4]
    lo, hi = SegmentBounds(seg).get(BQ, BKV)
    assert lo.shape == (B, T // BQ)
    walked = sum(len(kv_tiles((lo, hi), b, qt, T)) for b in range(B) for qt in range(T // BQ))
    assert walked == int((hi - lo + 1).sum()) < B * (T // BQ) * (T // BKV)
    # every visible (q, kv) pair of a CTA's rows lies in a walked tile
    for b in range(B):
        for qt in range(T // BQ):
            rows = seg[b, qt * BQ:(qt + 1) * BQ]
            seen = {j // BKV for j in range(T) if (rows == seg[b, j]).any()}
            assert seen <= set(kv_tiles((lo, hi), b, qt, T))


@pytest.mark.parametrize("layout,rate,d", [
    pytest.param("packed", 0.0, D, id="packed-0.0"),
    pytest.param("packed", 0.1, D, id="packed-0.1"),
    pytest.param("padded", 0.1, D, id="padded-0.1"),
    pytest.param("dense", 0.1, D, id="dense-0.1"),
    pytest.param("packed", 0.1, 256, id="packed-0.1-d256")])
def test_walk_matches_plain_fp32(layout, rate, d):
    """fp32 with RoPE: the walk, with skipping, against the plain dq on the
    kernel's tiles at the head dim (32-row kv tiles at D = 256) at 1e-5 of
    max|dq| (fp32 sums in another order); the walk with skipping equals
    the full walk bit for bit."""
    B, T = 2, 256
    bq, bkv = kernel_tiles("dq", BF16, d)
    q, k, v, do, seg = _inputs(B, T, layout, torch.float32, seed=7, d=d)
    rope = rope_tables(d, T)
    kw = dict(scale=1.0 / np.sqrt(d), dropout_rate=rate, seed=11)
    o, lse2 = mh_flash_forward_plain(q, k, v, seg, rope, **kw)
    di = (o * do).sum(-1)
    sb = None if seg is None else SegmentBounds(seg)
    bounds = None if sb is None else sb.get(bq, bkv)
    got = dq_walk(q, k, v, do, lse2, di, seg, rope, rate=rate, seed=11, bounds=bounds)
    want = mh_flash_bwd_dq_plain(q, k, v, do, lse2, di, seg, rope, **kw, block_q=bq,
                                 block_kv=bkv, segment_skip=True, bounds=sb)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    if bounds is not None:
        assert torch.equal(got, dq_walk(q, k, v, do, lse2, di, seg, rope, rate=rate, seed=11))


def test_walk_matches_plain_bf16():
    """bf16, packed, dropout 0.1: ds rounded to bf16 per tile as the kernel
    rounds it; against the plain dq at 2^-7 of max|dq| (an fp32 sum in
    another order can flip the bf16 rounding of a ds operand or of dq)."""
    B, T = 1, 256
    q, k, v, do, seg = _inputs(B, T, "packed", BF16, seed=5)
    rope = rope_tables(D, T)
    kw = dict(scale=SCALE, dropout_rate=0.1, seed=13)
    o, lse2 = mh_flash_forward_plain(q, k, v, seg, rope, **kw)
    di = (o.float() * do.float()).sum(-1)
    sb = SegmentBounds(seg)
    got = dq_walk(q, k, v, do, lse2, di, seg, rope, rate=0.1, seed=13, bounds=sb.get(BQ, BKV))
    want = mh_flash_bwd_dq_plain(q, k, v, do, lse2, di, seg, rope, **kw, block_q=BQ,
                                 block_kv=BKV, segment_skip=True, bounds=sb)
    assert (got.float() - want.float()).abs().max() <= 2 ** -7 * want.float().abs().max()
