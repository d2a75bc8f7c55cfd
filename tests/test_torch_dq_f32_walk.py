"""The fp32 dq kernel's walk, mirrored in PyTorch on the CPU.

`mh_bwd_dq_f32` in omnibiote_tpu_torch/ops/csrc/mh_flash_bwd_dq.cu is a
CUDA kernel, which has no CPU mode. These tests mirror what it does: a CTA
of 256 threads owns a (batch, head, 64-row q tile) and takes the kv tiles
of 64 rows (16 at D = 256) that its segment bounds give
(`SegmentBounds.get(64, bkv)`); Q (rotated) and dO stay in shared memory,
K and V rows land in a padded ring, even rows first; thread (rg, cg) forms
S and dP on its pairs of q rows by its pairs of kv columns (one Philox call
a row pair by a column pair), writes ds into dS^T, and adds dS.K into its
own q rows by 4 head-dim lanes and their rotate-half partners, so the
inverse RoPE stays in the thread and every dq element is written once. The
mirror takes the kernel's index arithmetic as it is written, checks that
the ownerships partition the tiles and that its shared reads and writes
are free of bank conflicts, and is held against the plain version
(`mh_flash_bwd_dq_plain` on the kernel's tiles) and the JAX package's
split-pair backward (`_mh_bwd` with FUSED_MULTIKV_BWD off, Pallas in
interpret mode, through `jax.vjp`). `chip_smoke.py` is what proves the
kernel itself, on the card, against the same plain version."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnibiote_tpu.models.rope import rope_tables as jax_rope_tables
from omnibiote_tpu.ops import flash_attention as jax_flash

from omnibiote_tpu_torch.models.rope import rope_tables
from omnibiote_tpu_torch.ops.flash_attention import (
    DEFAULT_MASK_VALUE, KERNEL_T_MULTIPLE, LOG2E, SegmentBounds, _full_tables, _rope_rot,
    dropout_bits, dropout_keep, dropout_keep_scale, dropout_threshold, kernel_tiles,
    mh_flash_bwd_dq_plain, mh_flash_forward_plain, philox4x32)

F32 = torch.float32
THREADS, BQ = 256, 64
SMEM_LIMIT = 232448  # bytes of shared memory a CTA may take on an H100
HEAD_DIMS = (64, 128, 256)
H = 2
# walk against the plain version or JAX: fp32 sums in another order
REL_TOL = 1e-5


class Geo:
    """kF32Dq<D> of the kernel: tiles, strides and ownership constants."""

    def __init__(self, d):
        self.D = d
        self.BKV = 16 if d == 256 else 64
        self.LD = d + 4
        self.DS_LD = BQ + 4
        self.NRP = 2 if self.BKV >= 32 else 1
        self.NCP = self.BKV // 16 // self.NRP
        self.ROW_STEP = BQ // self.NRP
        self.COL_STEP = self.BKV // self.NCP
        self.N_CG = self.BKV // (2 * self.NCP)
        self.RQ = d // 32
        self.N_CGQ = d // 8
        self.FLOATS = (2 * BQ + 4 * self.BKV) * self.LD + self.BKV * self.DS_LD
        self.SMEM = self.FLOATS * 4 + 2 * self.BKV * 4

    def kv_row(self, j):
        """The shared row of kv row j of a tile: even rows first."""
        return (j & 1) * (self.BKV // 2) + (j >> 1)

    def s_owner(self, tid):
        """(q rows, kv columns) of the S / dP elements thread tid forms."""
        warp, lane = divmod(tid, 32)
        wc, wr = warp % (self.N_CG // 8), warp // (self.N_CG // 8)
        cg, rg = 8 * wc + (lane & 7), 4 * wr + (lane >> 3)
        rows = [2 * rg + (r & 1) + self.ROW_STEP * (r >> 1) for r in range(2 * self.NRP)]
        cols = [2 * cg + (c & 1) + self.COL_STEP * (c >> 1) for c in range(2 * self.NCP)]
        return rows, cols

    def q_owner(self, tid):
        """(q rows, head-dim lanes) of the dQ sums thread tid holds: 4
        lanes of the low half, then their partners d + D/2."""
        warp, lane = divmod(tid, 32)
        wc, wr = warp % (self.N_CGQ // 8), warp // (self.N_CGQ // 8)
        cgq, rgq = 8 * wc + (lane & 7), 4 * wr + (lane >> 3)
        lo = [4 * cgq + e for e in range(4)]
        return ([self.RQ * rgq + r for r in range(self.RQ)],
                lo + [self.D // 2 + x for x in lo])


def _tables(g):
    s = [g.s_owner(t) for t in range(THREADS)]
    qo = [g.q_owner(t) for t in range(THREADS)]
    return (torch.tensor([r for r, _ in s]), torch.tensor([c for _, c in s]),
            torch.tensor([r for r, _ in qo]), torch.tensor([c for _, c in qo]))


def kv_tiles(bounds, b, qt, T, bkv):
    """The kv tiles CTA (b, qt) walks: its bounds' inclusive range, or all."""
    if bounds is None:
        return range(T // bkv)
    lo, hi = bounds
    return range(int(lo[b, qt]), int(hi[b, qt]) + 1)


def f32_dq_walk(q, k, v, do, lse2, di, seg, rope, *, rate=0.0, seed=0, bounds=None):
    """dq as the fp32 kernel's CTAs and threads form it (k rotated ahead by
    the launch's rope_rows, q where a CTA loads it)."""
    B, T, _, d = q.shape
    g = Geo(d)
    bkv = g.BKV
    scale = float(np.float32(1.0 / np.sqrt(d)))
    c = float(np.float32(scale * LOG2E))
    if rope is not None:
        tables = _full_tables(rope, T, q.device)
        q = _rope_rot(q, *tables, d // 2)
        k = _rope_rot(k, *tables, d // 2)
        cos, sin = (t[:T].float() for t in rope)
    s_rows, s_cols, q_rows, q_lanes = _tables(g)
    keep = dropout_keep(seed, rate, B, H, T, 0, T) if rate > 0 else None
    ks = dropout_keep_scale(rate) if rate > 0 else 1.0
    dq = torch.full(q.shape, float("nan"))
    writes = torch.zeros(q.shape, dtype=torch.int32)
    for b in range(B):
        for h in range(H):
            for qt in range(T // BQ):
                q0 = qt * BQ
                qs, os = q[b, q0:q0 + BQ, h], do[b, q0:q0 + BQ, h]
                acc = torch.zeros(THREADS, g.RQ, 8)
                i = q0 + s_rows                                  # (256, NR)
                for jt in kv_tiles(bounds, b, qt, T, bkv):
                    j0 = jt * bkv
                    # the ring stage: row kv_row(j) holds kv row j
                    kst = torch.zeros(bkv, g.LD)
                    vst = torch.zeros(bkv, g.LD)
                    for r in range(bkv):
                        kst[g.kv_row(r), :d] = k[b, j0 + r, h]
                        vst[g.kv_row(r), :d] = v[b, j0 + r, h]
                    srow_k = torch.tensor([[g.kv_row(int(x)) for x in row] for row in s_cols])
                    s = torch.einsum("trd,tcd->trc", qs[s_rows], kst[srow_k, :d])
                    dpv = torch.einsum("trd,tcd->trc", os[s_rows], vst[srow_k, :d])
                    j = j0 + s_cols                              # (256, NC)
                    s2 = s * c
                    if seg is not None:
                        vis = seg[b, i][:, :, None] == seg[b, j][:, None, :]
                        s2 = s2 + torch.where(vis, 0.0, DEFAULT_MASK_VALUE)
                    p = torch.exp2(s2 - lse2[b, i, h][:, :, None])
                    if keep is not None:
                        kp = keep[b, h][i[:, :, None], j[:, None, :]]
                        dpv = torch.where(kp, dpv * ks, 0.0)
                    ds = p * (dpv - di[b, i, h][:, :, None]) * scale
                    ds_t = torch.full((bkv, g.DS_LD), float("nan"))
                    ds_t[s_cols[:, None, :], s_rows[:, :, None]] = ds
                    assert not ds_t[:, :BQ].isnan().any()
                    # dQ += dS.K: natural kv order, read through kv_row
                    kn = kst[[g.kv_row(r) for r in range(bkv)], :d]
                    acc += torch.einsum("jtr,jte->tre", ds_t[:, q_rows], kn[:, q_lanes])
                rows = q0 + q_rows                               # (256, RQ)
                lo, hi = acc[:, :, :4], acc[:, :, 4:]
                if rope is not None:
                    cs = cos[rows[:, :, None], q_lanes[:, None, :4]]
                    sn = sin[rows[:, :, None], q_lanes[:, None, :4]]
                    lo, hi = lo * cs + hi * sn, hi * cs - lo * sn
                out = torch.cat([lo, hi], 2)
                dq[b, rows[:, :, None], h, q_lanes[:, None, :]] = out
                writes[b, rows[:, :, None], h, q_lanes[:, None, :]] += 1
    assert (writes == 1).all()
    return dq


def _inputs(B, T, layout, seed, d):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(x)
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


def _wavefronts(addresses, width):
    """Shared-memory wavefronts of one warp access of `width` bytes a lane
    (4, 8 or 16) at byte `addresses`: the distinct addresses, grouped by the
    bank range they start at (32 banks of 4 bytes), the largest group, and
    the least any access of that many distinct addresses can take."""
    distinct = sorted(set(addresses))
    per_wave = 128 // width
    groups = {}
    for a in distinct:
        groups.setdefault((a // width) % per_wave, []).append(a)
    return max(len(x) for x in groups.values()), -(-len(distinct) // per_wave)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tiles_ownership_and_shared_memory(d):
    """The tiles are kernel_tiles' and divide the T multiple; the CTA's
    shared memory fits an H100's 227 KB; the S / dP ownership covers the 64
    x BKV tile once, in pairs of even and odd rows and columns (one Philox
    call each); the dQ ownership covers 64 x D once, each thread holding
    the rotate-half partner of every low lane it holds; the kv_row order is
    a permutation."""
    g = Geo(d)
    assert kernel_tiles("dq", F32, d) == (BQ, g.BKV)
    assert KERNEL_T_MULTIPLE[F32] % BQ == 0 and KERNEL_T_MULTIPLE[F32] % g.BKV == 0
    assert g.SMEM <= SMEM_LIMIT and g.LD % 4 == 0 and g.FLOATS % 4 == 0
    assert (BQ // 2 // g.NRP) * g.N_CG == THREADS and (BQ // g.RQ) * g.N_CGQ == THREADS
    assert sorted(g.kv_row(j) for j in range(g.BKV)) == list(range(g.BKV))
    seen_s = torch.zeros(BQ, g.BKV, dtype=torch.int32)
    seen_q = torch.zeros(BQ, d, dtype=torch.int32)
    for t in range(THREADS):
        rows, cols = g.s_owner(t)
        for pr in range(0, len(rows), 2):
            assert rows[pr] % 2 == 0 and rows[pr + 1] == rows[pr] + 1
        for pc in range(0, len(cols), 2):
            assert cols[pc] % 2 == 0 and cols[pc + 1] == cols[pc] + 1
        for r in rows:
            for c in cols:
                seen_s[r, c] += 1
        qrows, lanes = g.q_owner(t)
        assert lanes[4:] == [x + d // 2 for x in lanes[:4]] and max(lanes[:4]) < d // 2
        for r in qrows:
            for x in lanes:
                seen_q[r, x] += 1
    assert (seen_s == 1).all() and (seen_q == 1).all()


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_shared_accesses_are_conflict_free(d):
    """Every warp access of both passes, at the kernel's byte addresses,
    takes the least wavefronts its distinct addresses need: the 16-byte
    Q / dO and K / V reads of S and dP, the dS^T pair writes, and dQ's dS^T
    and K reads."""
    g = Geo(d)
    base_q, base_k = 0, 2 * BQ * g.LD * 4
    base_ds = (2 * BQ + 4 * g.BKV) * g.LD * 4
    for warp in range(THREADS // 32):
        lanes = range(32 * warp, 32 * warp + 32)
        own = [g.s_owner(t) for t in lanes]
        for r in range(2 * g.NRP):
            for d4 in range(0, d, 4):
                addr = [base_q + (rows[r] * g.LD + d4) * 4 for rows, _ in own]
                got, least = _wavefronts(addr, 16)
                assert got == least, ("Q", warp, r, d4)
        for c in range(2 * g.NCP):
            for d4 in range(0, d, 4):
                addr = [base_k + (g.kv_row(cols[c]) * g.LD + d4) * 4 for _, cols in own]
                got, least = _wavefronts(addr, 16)
                assert got == least, ("K", warp, c, d4)
            for pr in range(0, 2 * g.NRP, 2):
                addr = [base_ds + (cols[c] * g.DS_LD + rows[pr]) * 4 for rows, cols in own]
                got, least = _wavefronts(addr, 8)
                assert got == least, ("dS write", warp, c, pr)
        qown = [g.q_owner(t) for t in lanes]
        for j in range(g.BKV):
            width = 8 if g.RQ == 2 else 16
            for r4 in range(0, g.RQ, width // 4):
                addr = [base_ds + (j * g.DS_LD + rows[0] + r4) * 4 for rows, _ in qown]
                got, least = _wavefronts(addr, width)
                assert got == least, ("dS read", warp, j)
            for half in (0, 4):
                addr = [base_k + (g.kv_row(j) * g.LD + lanes_[half]) * 4 for _, lanes_ in qown]
                got, least = _wavefronts(addr, 16)
                assert got == least, ("K of dQ", warp, j, half)


def test_a_row_pair_by_a_column_pair_is_one_philox_call():
    """The keep bits of a thread's (2m, 2m+1) x (2n, 2n+1) block are the
    four words of one Philox call at counter (n, m, b*H + h, 0), word 2 (i &
    1) + (j & 1), as the plain version's mask draws them."""
    seed, B, T = 0x1234_5678_9ABC_DEF1, 1, 128
    bits = dropout_bits(seed, B, H, T, 0, T)
    for (m, n, bh) in ((0, 0, 0), (7, 30, 1), (63, 1, 1)):
        w = philox4x32(torch.tensor(n), torch.tensor(m), torch.tensor(bh), torch.tensor(0),
                       seed & 0xFFFFFFFF, seed >> 32)
        for i in (2 * m, 2 * m + 1):
            for j in (2 * n, 2 * n + 1):
                assert int(w[2 * (i & 1) + (j & 1)]) == int(bits[bh // H, bh % H, i, j])
    assert dropout_threshold(0.1) == int(0.1 * 2 ** 32)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_kv_ranges_come_from_the_bounds(d):
    """Each CTA's kv tiles are its bounds' inclusive range at (64, BKV);
    the walked tiles are the count the card's check holds tile_count to,
    fewer than all, and hold every visible pair of the CTA's rows."""
    B, T = 2, 512
    bq, bkv = kernel_tiles("dq", F32, d)
    seg = _inputs(B, T, "packed", 3, 64)[4]
    lo, hi = SegmentBounds(seg).get(bq, bkv)
    assert lo.shape == (B, T // bq)
    walked = sum(len(kv_tiles((lo, hi), b, qt, T, bkv)) for b in range(B)
                 for qt in range(T // bq))
    assert walked == int((hi - lo + 1).sum()) < B * (T // bq) * (T // bkv)
    for b in range(B):
        for qt in range(T // bq):
            rows = seg[b, qt * bq:(qt + 1) * bq]
            seen = {j // bkv for j in range(T) if (rows == seg[b, j]).any()}
            assert seen <= set(kv_tiles((lo, hi), b, qt, T, bkv))


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("layout", ["packed", "padded", "dense"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_walk_matches_plain(d, layout, rate):
    """fp32 with RoPE, skipping on: the walk against the plain dq on the
    kernel's tiles at REL_TOL of max|dq|; with bounds, the walk equals the
    full walk bit for bit (a skipped tile adds exact zeros)."""
    B, T = 1, 256
    q, k, v, do, seg = _inputs(B, T, layout, 7 + d, d)
    bq, bkv = kernel_tiles("dq", F32, d)
    rope = rope_tables(d, T)
    kw = dict(scale=1.0 / np.sqrt(d), dropout_rate=rate, seed=11)
    o, lse2 = mh_flash_forward_plain(q, k, v, seg, rope, **kw)
    di = (o * do).sum(-1)
    sb = None if seg is None else SegmentBounds(seg)
    bounds = None if sb is None else sb.get(bq, bkv)
    got = f32_dq_walk(q, k, v, do, lse2, di, seg, rope, rate=rate, seed=11, bounds=bounds)
    want = mh_flash_bwd_dq_plain(q, k, v, do, lse2, di, seg, rope, **kw, block_q=bq,
                                 block_kv=bkv, segment_skip=True, bounds=sb)
    assert (got - want).abs().max() <= REL_TOL * want.abs().max()
    if bounds is not None:
        assert torch.equal(got, f32_dq_walk(q, k, v, do, lse2, di, seg, rope, rate=rate,
                                            seed=11))


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_walk_matches_jax(d):
    """Packed rows, dropout 0 (the TPU's dropout bits cannot be drawn
    here), T = 128 with 64-wide blocks and FUSED_MULTIKV_BWD off, so that
    the JAX package's `_mh_bwd` takes its split pair: the walk with its
    bounds against jax.vjp's dq at REL_TOL of max|dq|."""
    B, T = 1, 128
    q, k, v, do, seg = _inputs(B, T, "packed", 41 + d, d)
    scale = 1.0 / np.sqrt(d)
    cos, sin = jax_rope_tables(d, T)

    def f(q, k, v):
        return jax_flash.flash_attention(
            q, k, v, segment_ids=jnp.asarray(seg.numpy()), scale=scale, block_q=64,
            block_kv=64, rope=(cos, sin), segment_skip=True)

    old = jax_flash.FUSED_MULTIKV_BWD
    jax_flash.FUSED_MULTIKV_BWD = False
    try:
        _, vjp = jax.vjp(f, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
        want = torch.from_numpy(np.array(vjp(jnp.asarray(do.numpy()))[0]))
    finally:
        jax_flash.FUSED_MULTIKV_BWD = old
    rope = rope_tables(d, T)
    o, lse2 = mh_flash_forward_plain(q, k, v, seg, rope, scale=scale)
    di = (o * do).sum(-1)
    bq, bkv = kernel_tiles("dq", F32, d)
    got = f32_dq_walk(q, k, v, do, lse2, di, seg, rope,
                      bounds=SegmentBounds(seg).get(bq, bkv))
    assert (got - want).abs().max() <= REL_TOL * want.abs().max()
