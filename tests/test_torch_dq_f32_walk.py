"""The fp32 dq kernel's walk and its 3xTF32 arithmetic, mirrored in PyTorch
on the CPU.

`mh_bwd_dq_f32` in omnibiote_tpu_torch/ops/csrc/mh_flash_bwd_dq.cu is a
CUDA kernel, which has no CPU mode. These tests mirror what it does: a CTA
owns a (batch, head, 64-row q tile), warp w its q rows 16 (w % 4) .. + 15
and, past D = 64 (eight warps), half the columns of each kv tile; it takes
the kv tiles of 32 rows at D = 64, 64 at 128 and 16 at 256 that its segment
bounds give (`SegmentBounds.get(64, bkv)`); Q (rotated) and dO stay in
shared memory, K and V rows land in a two-stage ring, every row padded to
D + 4 floats. Per kv tile S = Q.K^T and dP = dO.V^T are mma.sync m16n8k8
products in 3xTF32 (each fp32 operand split into hi = tf32(x) and lo =
tf32(x - hi), lo.hi + hi.lo + hi.hi a k-step of 8, the small terms in
accumulators of their own), p, the keep-mask on dp (one Philox call a row
pair by a column pair, drawn on the C fragments) and ds on the C
fragments, and dQ += dS.K with dS's C fragments as the A operand in the
permuted k order and K read down its columns; the second column half's
dQ sums are added to the first's through shared memory, and dq is rotated
back in registers and written once. The mirror emulates that arithmetic on the
kernel's tiles (`test_torch_f32_tf32_split.py`'s `mm3`), checks that the
fragments partition the tiles and that every warp access of shared memory
is free of bank conflicts, and is held against the plain version
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
from omnibiote_tpu_torch.ops import flash_attention as fa
from omnibiote_tpu_torch.ops.flash_attention import (
    KERNEL_T_MULTIPLE, LOG2E, SegmentBounds, dropout_bits, dropout_keep, dropout_keep_scale,
    dropout_threshold, kernel_tiles, mh_flash_bwd_dq_plain, mh_flash_forward_plain,
    philox4x32)
from test_torch_f32_tf32_split import mm3

F32 = torch.float32
BQ = 64
SMEM_LIMIT = 232448  # bytes of shared memory a CTA may take on an H100
HEAD_DIMS = (64, 128, 256)
H = 2
# the walk against the plain version or JAX: the 3xTF32 products keep 22 of
# fp32's 24 mantissa bits a term and sum in another order
REL_TOL = 1e-5
LANES = [(lane >> 2, lane & 3) for lane in range(32)]  # (g, t)


class Geo:
    """F32Dq<D> of the kernel: tiles, warps, strides and shared memory."""

    def __init__(self, d):
        self.D = d
        self.BKV = {64: 32, 128: 64, 256: 16}[d]
        self.KVS = 1 if d == 64 else 2           # warps on the columns of a tile
        self.WARPS = 4 * self.KVS
        self.LD = d + 4
        self.NS, self.NN = self.BKV // 8 // self.KVS, d // 8   # a warp's column blocks
        self.FLOATS = (2 * BQ + 4 * self.BKV) * self.LD
        self.SMEM = self.FLOATS * 4 + 2 * self.BKV * 4
        # float offsets of Q, dO, K (two stages), V (two stages)
        self.Q, self.O = 0, BQ * self.LD
        self.K, self.V = 2 * BQ * self.LD, (2 * BQ + 2 * self.BKV) * self.LD

    def c_cells(self, warp, g, t, nb, score=True):
        """(q row of the tile, column) of C element e of the warp's block n,
        n < nb: (16 (w % 4) + g + 8 (e >> 1), c0 + 8 n + 2 t + (e & 1)),
        c0 the warp's first column of a score tile (0 for dQ's lanes)."""
        c0 = (warp // 4) * self.NS * 8 if score else 0
        return [[(16 * (warp % 4) + g + 8 * (e >> 1), c0 + 8 * n + 2 * t + (e & 1))
                 for e in range(4)] for n in range(nb)]

    def staged(self, warp, lane, n, e):
        """The float (from the ring's start) that holds dQ element e of
        block n of `lane` of the warp's m-tile, staged by the second column
        half's warp."""
        return self.K + (((warp % 4) * self.NN + n) * 4 + e) * 32 + lane


def kv_tiles(bounds, b, qt, T, bkv):
    """The kv tiles CTA (b, qt) walks: its bounds' inclusive range, or all."""
    if bounds is None:
        return range(T // bkv)
    lo, hi = bounds
    return range(int(lo[b, qt]), int(hi[b, qt]) + 1)


def f32_dq_walk(q, k, v, do, lse2, di, seg, rope, *, rate=0.0, seed=0, bounds=None):
    """dq as the fp32 kernel forms it (k rotated ahead by the launch's
    rope_rows, q where a CTA loads it): per kv tile of the CTA's walk, S and
    dP in 3xTF32 over the head dim (small terms apart), p and ds in fp32,
    dQ += dS.K in 3xTF32 into each column half's running sums, the halves
    added at the end; a q tile whose bounds leave a kv tile out keeps its
    sums. All q tiles are formed at once."""
    B, T, _, d = q.shape
    g = Geo(d)
    bkv = g.BKV
    scale = float(np.float32(1.0 / np.sqrt(d)))
    c = float(np.float32(scale * LOG2E))
    tables = None
    if rope is not None:
        tables = fa._full_tables(rope, T, q.device)
        q = fa._rope_rot(q, *tables, d // 2)
        k = fa._rope_rot(k, *tables, d // 2)
    qh, kh, vh, oh = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))
    lse, dih = (x.permute(0, 2, 1)[..., None] for x in (lse2, di))
    keep = dropout_keep(seed, rate, B, H, T, 0, T) if rate > 0 else None
    ks = dropout_keep_scale(rate) if rate > 0 else 1.0
    if bounds is not None:
        lo, hi = (x.repeat_interleave(BQ, 1)[:, None, :, None] for x in bounds)
    acc = [torch.zeros(B, H, T, d) for _ in range(g.KVS)]
    w = bkv // g.KVS
    for jt in range(T // bkv):
        j = slice(jt * bkv, (jt + 1) * bkv)
        s = mm3(qh, kh[:, :, j].transpose(-1, -2), apart=True)
        dp = mm3(oh, vh[:, :, j].transpose(-1, -2), apart=True)
        s2 = s * c
        if seg is not None:
            s2 = s2 + fa._mask_bias(seg, jt * bkv, bkv)
        p = torch.exp2(s2 - lse)
        if keep is not None:
            dp = torch.where(keep[..., j], dp * ks, 0.0)
        ds = p * (dp - dih) * scale
        for half in range(g.KVS):
            cols = slice(half * w, (half + 1) * w)
            nxt = mm3(ds[..., cols], kh[:, :, jt * bkv + half * w:jt * bkv + (half + 1) * w],
                      c=acc[half])
            acc[half] = (nxt if bounds is None else
                         torch.where((lo <= jt) & (jt <= hi), nxt, acc[half]))
    dq = (acc[0] if g.KVS == 1 else acc[0] + acc[1]).permute(0, 2, 1, 3)
    if tables is not None:
        dq = fa._rope_rot_inv(dq, *tables, d // 2)
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


def _conflict_free(float_offsets, width=4):
    got, least = _wavefronts([4 * x for x in float_offsets], width)
    return got == least


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tiles_ownership_and_shared_memory(d):
    """The tiles are kernel_tiles' and divide the T multiple; the CTA's
    shared memory fits an H100's 227 KB, and the ring holds the second
    column half's staged dQ; the warps' C fragments cover the 64 x BKV
    score tile once and the 64 x D dQ tile once a column half (the first
    half's warp writes it), and a thread holds the rotate-half partner d +
    D/2 (block n + D/16) of every low lane d it holds, at the same element,
    so the inverse RoPE stays in the thread and every dq element is written
    once."""
    g = Geo(d)
    assert kernel_tiles("dq", F32, d) == (BQ, g.BKV)
    assert KERNEL_T_MULTIPLE[F32] % BQ == 0 and KERNEL_T_MULTIPLE[F32] % g.BKV == 0
    assert g.SMEM <= SMEM_LIMIT and g.LD % 4 == 0 and g.FLOATS % 4 == 0
    assert g.WARPS * 16 == BQ * g.KVS and g.BKV % (8 * g.KVS) == 0
    if g.KVS > 1:
        assert 4 * g.BKV * g.LD >= BQ * d
    seen_s = torch.zeros(BQ, g.BKV, dtype=torch.int32)
    seen_q = torch.zeros(g.KVS, BQ, d, dtype=torch.int32)
    staged = set()
    for w in range(g.WARPS):
        for lane, (gg, t) in enumerate(LANES):
            for cells in g.c_cells(w, gg, t, g.NS):
                for r, col in cells:
                    seen_s[r, col] += 1
            dq_cells = g.c_cells(w, gg, t, g.NN, score=False)
            for n, cells in enumerate(dq_cells):
                for e, (r, col) in enumerate(cells):
                    seen_q[w // 4, r, col] += 1
                    if col < d // 2:
                        assert dq_cells[n + g.NN // 2][e] == (r, col + d // 2)
                    if w >= 4:
                        staged.add(g.staged(w, lane, n, e))
    assert (seen_s == 1).all() and (seen_q == 1).all()
    if g.KVS > 1:
        assert staged == set(range(g.K, g.K + BQ * d))


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_shared_accesses_are_conflict_free(d):
    """Every warp access of shared memory takes the least wavefronts its
    distinct addresses need: the Q and dO A-fragment reads (rows g, columns
    t), K's and V's B-fragment row reads of S and dP, K's column reads of dQ
    (rows 2 t and 2 t + 1, columns g), the kv ids' pair reads, the staged
    dQ's writes and reads, and the 16-byte writes of the cp.async copies
    and of the rotated Q rows."""
    g = Geo(d)
    ld = g.LD
    for w in range(g.WARPS):
        mt, c0 = w % 4, (w // 4) * g.NS * 8
        for kk in range(g.NN):
            for base in (g.Q, g.O):
                for dr, dc in ((0, 0), (8, 0), (0, 4), (8, 4)):
                    assert _conflict_free([base + (16 * mt + gg + dr) * ld + 8 * kk + t + dc
                                           for gg, t in LANES])
        for stage in (0, 1):
            for base in (g.K + stage * g.BKV * ld, g.V + stage * g.BKV * ld):
                for kk in range(g.NN):
                    for n in range(g.NS):
                        for dc in (0, 4):
                            assert _conflict_free([base + (c0 + 8 * n + gg) * ld + 8 * kk + t + dc
                                                   for gg, t in LANES])
            kb = g.K + stage * g.BKV * ld
            for kk in range(g.NS):
                for n in range(g.NN):
                    for e in (0, 1):
                        assert _conflict_free([kb + (c0 + 8 * kk + 2 * t + e) * ld + 8 * n + gg
                                               for gg, t in LANES])
            for n in range(g.NS):
                assert _conflict_free([g.FLOATS + stage * g.BKV + c0 + 8 * n + 2 * t
                                       for _, t in LANES], 8)
        for n in range(g.NN):
            for e in range(4):
                assert _conflict_free([g.staged(w, lane, n, e) for lane in range(32)])
    for warp_first in range(0, g.BKV * (d // 4), 32):   # cp.async of K, V and dO rows
        its = range(warp_first, warp_first + 32)
        assert _conflict_free([(it // (d // 4)) * ld + (it % (d // 4)) * 4 for it in its], 16)
    half4 = d // 8
    for warp_first in range(0, BQ * half4, 32):           # rows_rotated_f32's writes
        its = range(warp_first, warp_first + 32)
        for hoff in (0, d // 2):
            assert _conflict_free([(it // half4) * ld + hoff + (it % half4) * 4 for it in its],
                                  16)


def test_fragment_maps_and_the_permuted_k_order():
    """dS's C fragment handed on as dQ's A fragment (c0, c2, c1, c3) with
    K's B rows 2 t and 2 t + 1 read down column g forms dS.K over the 8 kv
    rows of a k-step, as in the natural order (small integers: exact), on
    every k-step of a tile of 32 kv rows and 32 head-dim lanes."""
    rng = np.random.default_rng(5)
    ds = torch.from_numpy(rng.integers(-8, 8, (16, 32)).astype(np.float32))
    kt = torch.from_numpy(rng.integers(-8, 8, (32, 32)).astype(np.float32))
    out = torch.zeros(16, 32)
    for kk in range(4):
        a = torch.zeros(16, 8)
        b = torch.zeros(8, 32)
        for (gg, t), cells in zip(LANES, (Geo(128).c_cells(0, gg, t, 4)[kk]
                                          for gg, t in LANES)):
            cv = [ds[r, col] for r, col in cells]
            a_cells = [(gg + 8 * (e & 1), t + 4 * (e >> 1)) for e in range(4)]
            for (r, col), x in zip(a_cells, (cv[0], cv[2], cv[1], cv[3])):
                a[r, col] = x
            for n in range(4):
                b[t, 8 * n + gg] = kt[8 * kk + 2 * t, 8 * n + gg]
                b[t + 4, 8 * n + gg] = kt[8 * kk + 2 * t + 1, 8 * n + gg]
        out += a @ b
    assert torch.equal(out, ds @ kt)


def test_a_row_pair_by_a_column_pair_is_one_philox_call():
    """The kernel's draw on the C fragments: the even lane of g, g ^ 1 calls
    Philox at its rows (r0, r0 + 1), the odd lane at (r0 + 7, r0 + 8), the
    lanes exchange the partner's row's words (lane ^ 4), and then every
    element (row r0 + 8 (e >> 1), column 8 n + 2 t + (e & 1)) holds the
    plain mask's word: counter (j >> 1, i >> 1, b*H + h, 0), word 2 (i & 1)
    + (j & 1)."""
    seed, B, T = 0x1234_5678_9ABC_DEF1, 1, 128
    bits = dropout_bits(seed, B, H, T, 0, T)
    for bh, q0, w, j0, n in ((0, 0, 0, 0, 0), (1, 64, 3, 96, 3), (1, 0, 2, 32, 1)):
        draws = {}
        for lane, (gg, t) in enumerate(LANES):
            r0 = q0 + 16 * w + gg
            row = r0 + 8 if gg & 1 else r0
            col = j0 + 8 * n + 2 * t
            draws[lane] = [int(x) for x in philox4x32(
                torch.tensor(col >> 1), torch.tensor(row >> 1), torch.tensor(bh),
                torch.tensor(0), seed & 0xFFFFFFFF, seed >> 32)]
        for lane, (gg, t) in enumerate(LANES):
            u, other = draws[lane], draws[lane ^ 4]
            odd = gg & 1
            # the words the partner sends: w0, w1 from an odd lane, w2, w3 from an even one
            y0, y1 = (other[2], other[3]) if odd else (other[0], other[1])
            words = [y0 if odd else u[0], y1 if odd else u[1],
                     u[2] if odd else y0, u[3] if odd else y1]
            r0 = q0 + 16 * w + gg
            for e, word in enumerate(words):
                i, j = r0 + 8 * (e >> 1), j0 + 8 * n + 2 * t + (e & 1)
                assert word == int(bits[0, bh, i, j]), (lane, e)
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


def _walk_against_plain(d, layout, rate, rope_on):
    B, T = 1, 256
    q, k, v, do, seg = _inputs(B, T, layout, 7 + d + 3 * (not rope_on), d)
    bq, bkv = kernel_tiles("dq", F32, d)
    rope = rope_tables(d, T) if rope_on else None
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
@pytest.mark.parametrize("layout", ["packed", "padded", "dense"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_walk_matches_plain(d, layout, rate):
    """fp32 with RoPE, skipping on: the emulated walk against the plain dq
    on the kernel's tiles at REL_TOL of max|dq|; with bounds, the walk
    equals the full walk bit for bit (a skipped tile adds exact zeros)."""
    _walk_against_plain(d, layout, rate, True)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("layout", ["packed", "padded", "dense"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_walk_matches_plain_without_rope(d, layout, rate):
    """The same without RoPE (the per-head entry's #8): q and k as given,
    dq not rotated back."""
    _walk_against_plain(d, layout, rate, False)


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


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("rope_on", [True, False])
def test_walk_keeps_nans(d, rope_on):
    """The NaN that CUDA arithmetic makes (0x7fffffff) in one element of q
    (head 0) and one of v (head 1), dense rows, dropout 0: the walk's dq
    holds NaN exactly where the plain dq does (q's row of head 0, every row
    of head 1), and elsewhere the plain values at REL_TOL of their largest:
    the split loses no NaN."""
    B, T = 1, 128
    q, k, v, do, _ = _inputs(B, T, "dense", 500 + d + rope_on, d)
    q.view(torch.int32)[0, 37, 0, 5] = 0x7FFFFFFF
    v.view(torch.int32)[0, 90, 1, 3] = 0x7FFFFFFF
    rope = rope_tables(d, T) if rope_on else None
    scale = 1.0 / np.sqrt(d)
    o, lse2 = mh_flash_forward_plain(q, k, v, None, rope, scale=scale)
    args = (q, k, v, do, lse2, (o * do).sum(-1), None, rope)
    want = mh_flash_bwd_dq_plain(*args, scale=scale)
    got = f32_dq_walk(*args)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert nan[0, :, 1].all() and nan[0, 37, 0].all() and not nan[0, 36, 0].any()
    finite = want[~nan]
    assert (got[~nan] - finite).abs().max() <= REL_TOL * finite.abs().max()
