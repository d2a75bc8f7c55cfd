"""The fp32 attention kernels' 3xTF32 arithmetic, emulated in PyTorch on
the CPU.

`mh_fwd_f32` (#1/#6) and `mh_bwd_f32` (#2/#3, and #4/#7 without dq) in
omnibiote_tpu_torch/ops/csrc run their products on the tensor cores:
each fp32 operand x becomes hi = tf32(x), lo = tf32(x - hi), rounded to
nearest with ties to even (cvt.rn.tf32.f32; a NaN stays a NaN), and each
8-deep k-step of a
product adds lo.hi + hi.lo + hi.hi into an fp32 accumulator (mma.sync
m16n8k8, csrc/tf32x3.cuh). CUDA kernels have no CPU mode, so these tests
do that arithmetic here, on the kernels' tiles (`kernel_tiles`): the
forward's online softmax over 32-row kv tiles, the backward's head-dim
parts at D = 256 (two partial S^T / dP^T added), dq summed a 64-row kv
tile at a time. The emulation is held against the plain versions and the
JAX package's Pallas kernels (interpret mode; `jax.vjp` for the backward)
at `chip_smoke.py`'s fp32 tolerances, and a 1xTF32 product (hi.hi alone)
is shown to miss them. The kernels' layouts are mirrored as
`tests/test_torch_dq_f32_walk.py` mirrors the dq kernel's: the tiles, the
shared memory a CTA takes, the mma.sync fragment maps (the permuted k order
that lets a C fragment be the next product's A fragment), and the banks of
every warp access. `chip_smoke.py` proves the kernels themselves on the
card, against the same plain versions."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from omnibiote_tpu.models.rope import rope_tables as jax_rope_tables
from omnibiote_tpu.ops import flash_attention as jax_flash

from omnibiote_tpu_torch.models.rope import rope_tables
from omnibiote_tpu_torch.ops import flash_attention as fa
from omnibiote_tpu_torch.ops.flash_attention import (
    KERNEL_T_MULTIPLE, LOG2E, SegmentBounds, dropout_keep, dropout_keep_scale, kernel_tiles)

F32 = torch.float32
SMEM_LIMIT = 232448  # bytes of shared memory a CTA may take on an H100
HEAD_DIMS = (64, 128, 256)
H = 2
# chip_smoke.py's fp32 limits: the forward's o and lse2 (rtol, atol), the
# backward's max|d| / max|g|
TOL_O, TOL_LSE, BWD_TOL = (2e-5, 2e-5), (1e-5, 1e-4), 1e-4


# ---------------------------------------------------------------------------
# the kernels' geometry (F32Fwd<D>, F32Bwd<D>)
# ---------------------------------------------------------------------------

class FwdGeo:
    """mh_fwd_f32's tiles and shared memory: 4 warps of 16 q rows."""

    BQ, BKV, WARPS = 64, 32, 4

    def __init__(self, d):
        self.D, self.LD = d, d + 4
        self.SMEM = (self.BQ + 4 * self.BKV) * self.LD * 4 + 2 * self.BKV * 4


class BwdGeo:
    """mh_bwd_f32's tiles, head-dim parts and shared memory."""

    BKV = 64

    def __init__(self, d, with_dq=True):
        self.D = d
        self.NP = 1 if d == 64 else 2
        self.DP = d // self.NP
        self.HW = self.DP // 2
        self.BQ = 16 if d == 256 else 32
        self.WARPS = 4 * self.NP
        self.LD, self.DS_LD = d + 4, self.BQ + 4
        nq = self.BQ // 8
        kv, ring, rows = 2 * self.BKV * self.LD, 4 * self.BQ * self.LD, 4 * self.BQ
        dst, stg = self.BKV * self.DS_LD, self.BQ * d
        xch = self.WARPS * 2 * nq * 4 * 32 if self.NP > 1 else 0
        floats = kv + ring + rows + (dst + max(stg, xch) if with_dq else xch)
        self.FLOATS = floats
        self.SMEM = floats * 4 + 2 * self.BQ * 4

    def pcol(self, part, kb):
        """The head-dim column of 8-lane block kb of a part (the kernel's pcol)."""
        if kb * 8 < self.HW:
            return self.HW * part + kb * 8
        return self.D // 2 + self.HW * part + kb * 8 - self.HW

    def part_lanes(self, part):
        """A part's lanes in the order its k-steps take them."""
        return [self.pcol(part, kb) + i for kb in range(self.DP // 8) for i in range(8)]


# ---------------------------------------------------------------------------
# 3xTF32 arithmetic
# ---------------------------------------------------------------------------

def tf32(x):
    """tf32x3.cuh::to_tf32 (cvt.rn.tf32.f32): the 10-bit mantissa rounded
    to nearest, ties to even (half an ulp less one, plus the kept lowest
    bit, added to the magnitude's bits), low 13 bits 0; a NaN stays a NaN."""
    b = x.contiguous().view(torch.int32)
    r = ((b + 0xFFF + ((b >> 13) & 1)) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(x), x, r)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a, b, c=None, terms=3, apart=False):
    """a @ b as the kernels form it: a k-step of 8 at a time into the fp32
    accumulator c (zeros by default), lo.hi + hi.lo + hi.hi (terms=1:
    hi.hi alone, 1xTF32). apart: the small terms in an accumulator of their
    own, added to the hi.hi sums at the end (tf32x3.cuh::mma3_apart)."""
    ah, al = split(a)
    bh, bl = split(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:]) if c is None else c
    small = torch.zeros_like(out)
    for k0 in range(0, a.shape[-1], 8):
        s = slice(k0, k0 + 8)
        hh = ah[..., s] @ bh[..., s, :]
        if terms == 1:
            out = out + hh
        elif apart:
            small = small + al[..., s] @ bh[..., s, :]
            out = out + hh
            small = small + ah[..., s] @ bl[..., s, :]
        else:
            out = out + al[..., s] @ bh[..., s, :] + ah[..., s] @ bl[..., s, :] + hh
    return out + small if apart else out


def _rotated(q, k, rope):
    if rope is None:
        return q, k, None
    T, D = q.shape[1], q.shape[3]
    tables = fa._full_tables(rope, T, q.device)
    return fa._rope_rot(q, *tables, D // 2), fa._rope_rot(k, *tables, D // 2), tables


def emulated_forward(q, k, v, seg, rope, *, scale, rate=0.0, seed=0, skip=False, terms=3):
    """(o, lse2) of mh_fwd_f32: S = Q.K^T over the head dim in k-steps of 8
    (the small terms apart until they are done), the online softmax over 32-row kv tiles (rows whose q tile's bounds
    leave a tile out keep their state), P.V into the rescaled accumulator."""
    B, T, _, D = q.shape
    bq, bkv = kernel_tiles("fwd", F32, D)
    q, k, _ = _rotated(q, k, rope)
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    c = float(np.float32(scale * LOG2E))
    s2 = mm3(qh, kh.transpose(-1, -2), terms=terms, apart=True) * c
    if seg is not None:
        s2 = s2 + fa._mask_bias(seg, 0, T)
    keep = dropout_keep(seed, rate, B, H, T, 0, T) if rate > 0 else None
    ks = dropout_keep_scale(rate) if rate > 0 else 1.0
    if skip:
        lo, hi = SegmentBounds(seg).get(bq, bkv)
        lo = lo.repeat_interleave(bq, 1)[:, None, :, None]
        hi = hi.repeat_interleave(bq, 1)[:, None, :, None]
    m = torch.full((B, H, T, 1), -float("inf"))
    l = torch.zeros((B, H, T, 1))
    acc = torch.zeros((B, H, T, D))
    for j, s0 in enumerate(range(0, T, bkv)):
        st = s2[..., s0:s0 + bkv]
        m_next = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_next)
        p = torch.exp2(st - m_next)
        l_next = alpha * l + p.sum(-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[..., s0:s0 + bkv], p * ks, 0.0)
        acc_next = mm3(p, vh[:, :, s0:s0 + bkv], c=acc * alpha, terms=terms)
        if skip:
            take = (lo <= j) & (j <= hi)
            m, l, acc = (torch.where(take, a, b) for a, b in
                         ((m_next, m), (l_next, l), (acc_next, acc)))
        else:
            m, l, acc = m_next, l_next, acc_next
    o = (acc * (1.0 / l)).permute(0, 2, 1, 3)
    return o, (m + torch.log2(l))[..., 0].permute(0, 2, 1)


def emulated_backward(q, k, v, do, lse2, di, seg, rope, *, scale, rate=0.0, seed=0,
                      skip=False):
    """(dq, dk, dv) of mh_bwd_f32: S^T and dP^T a head-dim part at a time
    (the parts' partial sums added), p and ds as the kernel forms them, dV
    and dK over q in k-steps of 8, dq a 64-row kv tile at a time. S^T, dP^T
    and dQ keep their small terms apart until their k-steps are done."""
    B, T, _, D = q.shape
    g = BwdGeo(D)
    bq, bkv = kernel_tiles("fused", F32, D)
    assert (bq, bkv) == (g.BQ, g.BKV)
    qr, kr, tables = _rotated(q, k, rope)
    qh, kh, vh, oh = (x.permute(0, 2, 1, 3) for x in (qr, kr, v, do))
    parts = [g.part_lanes(c) for c in range(g.NP)]
    st, dpt = 0.0, 0.0
    for lanes in parts:
        st = st + mm3(kh[..., lanes], qh[..., lanes].transpose(-1, -2), apart=True)
        dpt = dpt + mm3(vh[..., lanes], oh[..., lanes].transpose(-1, -2), apart=True)
    c = float(np.float32(scale * LOG2E))
    s2 = st * c
    if seg is not None:
        s2 = s2 + fa._mask_bias(seg, 0, T).transpose(-1, -2)
    p = torch.exp2(s2 - lse2.permute(0, 2, 1)[:, :, None, :])
    if skip:
        visit = fa._visit_mask(seg, None, T, bq, bkv, "kv")
        p = torch.where(visit.transpose(1, 2)[:, None], p, 0.0)
    pd, dpd = p, dpt
    if rate > 0:
        keep = dropout_keep(seed, rate, B, H, T, 0, T).transpose(-1, -2)
        ks = dropout_keep_scale(rate)
        pd = torch.where(keep, p * ks, 0.0)
        dpd = torch.where(keep, dpt * ks, 0.0)
    ds = p * (dpd - di.permute(0, 2, 1)[:, :, None, :]) * scale
    dv = mm3(pd, oh)
    dk = mm3(ds, qh)
    dq = 0.0
    for j0 in range(0, T, bkv):
        dq = dq + mm3(ds[:, :, j0:j0 + bkv].transpose(-1, -2), kh[:, :, j0:j0 + bkv],
                      apart=True)
    dq, dk, dv = (x.permute(0, 2, 1, 3) for x in (dq, dk, dv))
    if tables is not None:
        dq = fa._rope_rot_inv(dq, *tables, D // 2)
        dk = fa._rope_rot_inv(dk, *tables, D // 2)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# inputs and checks
# ---------------------------------------------------------------------------

def _inputs(T, layout, seed, d, B=1):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(x)
                   for x in rng.standard_normal((4, B, T, H, d)).astype(np.float32))
    seg = None
    if layout == "packed":
        ids = np.zeros((B, T), np.int32)
        for b in range(B):
            cuts = np.sort(rng.choice(np.arange(16, T - 16), 3, replace=False))
            ids[b] = np.searchsorted(cuts, np.arange(T), side="right")
        seg = torch.from_numpy(ids)
    return q, k, v, do, seg


def _fwd_ok(got, want):
    return (torch.allclose(got[0], want[0], rtol=TOL_O[0], atol=TOL_O[1])
            and torch.allclose(got[1], want[1], rtol=TOL_LSE[0], atol=TOL_LSE[1]))


def _rel(got, want):
    return max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))


def _banks_distinct(addresses):
    """A warp's 4-byte shared accesses (float indices) take one wavefront."""
    return len({a % 32 for a in addresses}) == len(addresses) == 32


LANES = [(lane >> 2, lane & 3) for lane in range(32)]  # (g, t)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tiles_and_shared_memory(d):
    """The tiles are kernel_tiles' and divide the T multiple; the CTAs'
    shared memory fits an H100's 227 KB (the fused kernel's with its dS^T
    tile and dQ staging, the dkv kernel's without); a warp's 16 rows cover
    the tile; the D = 256 parts are closed under rotate-half and cover the
    head dim once."""
    fg, bg = FwdGeo(d), BwdGeo(d)
    assert kernel_tiles("fwd", F32, d) == (fg.BQ, fg.BKV) == (64, 32)
    assert fa.kernel_kv_tile(F32, d) == fg.BKV
    for kind in ("fused", "dkv"):
        assert kernel_tiles(kind, F32, d) == (bg.BQ, bg.BKV)
    for bq, bkv in ((fg.BQ, fg.BKV), (bg.BQ, bg.BKV)):
        assert KERNEL_T_MULTIPLE[F32] % bq == 0 and KERNEL_T_MULTIPLE[F32] % bkv == 0
    assert fg.SMEM <= SMEM_LIMIT and fg.WARPS * 16 == fg.BQ
    assert BwdGeo(d, with_dq=False).SMEM < bg.SMEM <= SMEM_LIMIT
    assert bg.FLOATS % 4 == 0 and bg.LD % 4 == 0 and 4 * 16 == bg.BKV
    lanes = sorted(x for c in range(bg.NP) for x in bg.part_lanes(c))
    assert lanes == list(range(d))
    for c in range(bg.NP):
        own = bg.part_lanes(c)
        lo, hi = own[:bg.HW], own[bg.HW:]
        assert hi == [x + d // 2 for x in lo] and max(lo) < d // 2


def test_fragment_maps_and_the_permuted_k_order():
    """mma.sync m16n8k8's A, B and C fragments each cover their tile once;
    a C fragment handed on as the A fragment (c0, c2, c1, c3) with B rows
    2 t and 2 t + 1 forms the same product as the natural order (small
    integers: exact), which is how P.V, dV, dK and dQ take their A
    operands."""
    a_own = [[(g + 8 * (e & 1), t + 4 * (e >> 1)) for e in range(4)] for g, t in LANES]
    b_own = [[(t + 4 * e, g) for e in range(2)] for g, t in LANES]
    c_own = [[(g + 8 * (e >> 1), 2 * t + (e & 1)) for e in range(4)] for g, t in LANES]
    for own, shape in ((a_own, (16, 8)), (b_own, (8, 8)), (c_own, (16, 8))):
        seen = torch.zeros(shape, dtype=torch.int32)
        for cells in own:
            for r, c in cells:
                seen[r, c] += 1
        assert (seen == 1).all()
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.integers(-8, 8, (16, 8)).astype(np.float32))
    v = torch.from_numpy(rng.integers(-8, 8, (8, 8)).astype(np.float32))
    a = torch.zeros(16, 8)
    b = torch.zeros(8, 8)
    for (g, t), ao, bo, co in zip(LANES, a_own, b_own, c_own):
        cvals = [p[r, c] for r, c in co]                  # c0..c3 of the lane
        for (r, c), x in zip(ao, (cvals[0], cvals[2], cvals[1], cvals[3])):
            a[r, c] = x
        for e, (r, c) in enumerate(bo):
            b[r, c] = v[2 * t + e, g]                     # B rows 2 t, 2 t + 1
    assert torch.equal(a @ b, p @ v)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_warp_accesses_are_conflict_free(d):
    """Every 4-byte shared access of a warp takes one wavefront (32
    distinct banks): the forward's Q (A) and K (B) row reads and V's column
    reads; the backward's K / V (A) and Q / dO (B) row reads, the column
    reads of dO and Q (dV, dK) and K (dQ), and dS^T's reads (dQ's A)."""
    fg, bg = FwdGeo(d), BwdGeo(d)
    for w in range(fg.WARPS):
        for kk in range(d // 8):
            for dr, dc in ((0, 0), (8, 0), (0, 4), (8, 4)):
                assert _banks_distinct([(16 * w + g + dr) * fg.LD + 8 * kk + t + dc
                                        for g, t in LANES])
            for n in range(fg.BKV // 8):
                for dc in (0, 4):
                    assert _banks_distinct([(8 * n + g) * fg.LD + 8 * kk + t + dc
                                            for g, t in LANES])
        for kk in range(fg.BKV // 8):
            for n in range(d // 8):
                for e in (0, 1):
                    assert _banks_distinct([(8 * kk + 2 * t + e) * fg.LD + 8 * n + g
                                            for g, t in LANES])
    ld, ds_ld = bg.LD, bg.DS_LD
    for w in range(bg.WARPS):
        part, rg = w // 4, w % 4
        for kb in range(bg.DP // 8):
            c = bg.pcol(part, kb)
            for dr, dc in ((0, 0), (8, 0), (0, 4), (8, 4)):
                assert _banks_distinct([(16 * rg + g + dr) * ld + c + t + dc for g, t in LANES])
            for n in range(bg.BQ // 8):
                for dc in (0, 4):
                    assert _banks_distinct([(8 * n + g) * ld + c + t + dc for g, t in LANES])
        for kk in range(bg.BQ // 8):
            for n in range(bg.DP // 8):
                for e in (0, 1):
                    assert _banks_distinct([(8 * kk + 2 * t + e) * ld + bg.pcol(part, n) + g
                                            for g, t in LANES])
    for kk in range(bg.BKV // 8):
        for e in (0, 1):
            for mt in range(bg.BQ // 16):
                for dr in (0, 8):
                    assert _banks_distinct([(8 * kk + 2 * t + e) * ds_ld + 16 * mt + g + dr
                                            for g, t in LANES])
            for n in range(d // 8):
                assert _banks_distinct([(8 * kk + 2 * t + e) * ld + 8 * n + g for g, t in LANES])


def test_split_keeps_22_bits():
    """hi and lo are tf32 values (low 13 bits 0), hi is x rounded to nearest
    with ties to even, and hi + lo is x to 2^-22 of |x|; hi alone only to
    2^-11."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(100000) * 10.0 ** rng.uniform(-3, 3, 100000))
                         .astype(np.float32))
    hi, lo = split(x)
    for y in (hi, lo):
        assert ((y.view(torch.int32) & 0x1FFF) == 0).all()
    assert float(((hi + lo) - x).abs().div(x.abs()).max()) <= 2.0 ** -22
    assert float((hi - x).abs().div(x.abs()).max()) <= 2.0 ** -11
    ties = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11), 1.0 + 2.0 ** -11 + 2.0 ** -23],
                        dtype=F32)
    assert tf32(ties).tolist() == [1.0, -(1.0 + 2.0 ** -9), 1.0 + 2.0 ** -10]


def _bits(*words):
    return torch.tensor(words, dtype=torch.int64).to(torch.int32).view(torch.float32)


def test_split_keeps_nan_and_infinity():
    """Every NaN stays a NaN in hi and every infinity the same infinity:
    the NaN that CUDA arithmetic makes (0x7fffffff), its negative, the
    quiet NaN, and NaNs whose payload sits high or low. (Rounding by an
    integer add of half an ulp and a mask, with no NaN guard, carries
    0x7fffffff and 0xffffffff into the sign: zeros.)"""
    nans = _bits(0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000, 0xFFC00000, 0x7FFFF000, 0x7F800001)
    hi, _ = split(nans)
    assert torch.isnan(hi).all()
    carried = (_bits(0x7FFFFFFF, 0xFFFFFFFF).view(torch.int32) + 0x1000) & -0x2000
    assert carried.view(torch.float32).tolist() == [0.0, 0.0]
    inf = torch.tensor([float("inf"), -float("inf")])
    assert torch.equal(split(inf)[0], inf)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("rope_on", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_emulated_kernels_match_plain(d, rope_on, rate):
    """Packed ids with skipping: the emulated forward against the plain
    version on the kernel's kv tile at TOL, the emulated backward's dq, dk,
    dv (and the dkv kernel's dk, dv) against the plain fused and dkv
    backwards at BWD_TOL of max|g|, the same Philox bits in both."""
    T = 128
    q, k, v, do, seg = _inputs(T, "packed", 100 * d + 10 * rope_on + int(10 * rate), d)
    rope = rope_tables(d, T) if rope_on else None
    kw = dict(scale=1.0 / np.sqrt(d), dropout_rate=rate, seed=29)
    sb = SegmentBounds(seg)
    o, lse2 = fa.mh_flash_forward_plain(q, k, v, seg, rope, **kw,
                                        block_kv=fa.kernel_kv_tile(F32, d),
                                        block_q=kernel_tiles("fwd", F32, d)[0],
                                        segment_skip=True, bounds=sb)
    got = emulated_forward(q, k, v, seg, rope, scale=kw["scale"], rate=rate, seed=29, skip=True)
    assert _fwd_ok(got, (o, lse2))
    di = (o * do).sum(-1)
    args = (q, k, v, do, lse2, di, seg, rope)
    bq, bkv = kernel_tiles("fused", F32, d)
    tiles = dict(block_q=bq, block_kv=bkv, segment_skip=True, bounds=sb)
    want = fa.mh_flash_backward_plain(*args, **kw, **tiles)
    grads = emulated_backward(*args, scale=kw["scale"], rate=rate, seed=29, skip=True)
    assert _rel(grads, want) <= BWD_TOL
    want_dkv = fa.mh_flash_bwd_dkv_plain(*args, **kw, **tiles)
    assert _rel(grads[1:], want_dkv) <= BWD_TOL


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_emulated_kernels_match_jax(d):
    """Packed ids, RoPE, dropout 0 (the TPU's dropout bits cannot be drawn
    here), T = 128: the emulated forward against `_mh_fwd` with 64-wide
    blocks (o and lse2 at TOL), the emulated backward against jax.vjp of
    the JAX `flash_attention` (the fused multi-kv kernel) at BWD_TOL."""
    T = 128
    q, k, v, do, seg = _inputs(T, "packed", 7 + d, d)
    scale = 1.0 / np.sqrt(d)
    cos, sin = jax_rope_tables(d, T)
    cos2, sin2 = (jnp.concatenate([x, x], axis=1) for x in (cos, sin))
    qj, kj, vj, doj = (jnp.asarray(x.numpy()) for x in (q, k, v, do))
    seg_j = jnp.asarray(seg.numpy())
    with pltpu.force_tpu_interpret_mode():
        jo, jl = jax_flash._mh_fwd(qj, kj, vj, seg_j, seg_j, cos2, sin2, 0, scale=scale,
                                   block_q=64, block_kv=64, dropout_rate=0.0, use_rope=True)
    rope = rope_tables(d, T)
    o, lse2 = emulated_forward(q, k, v, seg, rope, scale=scale)
    assert _fwd_ok((o, lse2), (torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jl))))

    def f(q, k, v):
        return jax_flash.flash_attention(q, k, v, segment_ids=seg_j, scale=scale, block_q=64,
                                         block_kv=64, rope=(cos, sin), segment_skip=True)

    want = [torch.from_numpy(np.array(g))
            for g in jax.jit(lambda q, k, v, do: jax.vjp(f, q, k, v)[1](do))(qj, kj, vj, doj)]
    grads = emulated_backward(q, k, v, do, lse2, (o * do).sum(-1), seg, rope, scale=scale,
                              skip=True)
    assert _rel(grads, want) <= BWD_TOL


def test_one_tf32_product_misses_the_limits():
    """hi.hi alone (1xTF32, about three decimal digits) misses the fp32
    forward's limits that the three products meet, on the same inputs."""
    d, T = 128, 128
    q, k, v, _, seg = _inputs(T, "packed", 3, d)
    rope = rope_tables(d, T)
    scale = 1.0 / np.sqrt(d)
    want = fa.mh_flash_forward_plain(q, k, v, seg, rope, scale=scale,
                                     block_kv=fa.kernel_kv_tile(F32, d))
    three = emulated_forward(q, k, v, seg, rope, scale=scale)
    one = emulated_forward(q, k, v, seg, rope, scale=scale, terms=1)
    assert _fwd_ok(three, want)
    assert not _fwd_ok(one, want)
    err1 = float((one[0] - want[0]).abs().max())
    err3 = float((three[0] - want[0]).abs().max())
    assert err1 > TOL_O[1] > 10 * err3


def _with_nans(q, v):
    """q and v with the NaN that CUDA arithmetic makes (0x7fffffff) in one
    element each: q at a row of head 0, v at a kv row of head 1."""
    q, v = q.clone(), v.clone()
    q.view(torch.int32)[0, 37, 0, 5] = 0x7FFFFFFF
    v.view(torch.int32)[0, 90, 1, 3] = 0x7FFFFFFF
    return q, v


def _same_nans_and_close(got, want, rtol, atol):
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert nan.any() and not torch.isinf(got).any()
    return torch.allclose(got[~nan], want[~nan], rtol=rtol, atol=atol)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("rope_on", [True, False])
def test_emulated_kernels_keep_nans(d, rope_on):
    """A NaN in q and one in v (dense, dropout 0) give NaN in o, lse2, dq,
    dk and dv exactly where the plain versions have it, and elsewhere the
    same values at TOL / BWD_TOL: the split loses no NaN, so a NaN weight
    cannot leave a finite attention output behind."""
    T = 128
    q, k, v, do, _ = _inputs(T, "dense", 400 + d + rope_on, d)
    q, v = _with_nans(q, v)
    rope = rope_tables(d, T) if rope_on else None
    scale = 1.0 / np.sqrt(d)
    want = fa.mh_flash_forward_plain(q, k, v, None, rope, scale=scale,
                                     block_kv=fa.kernel_kv_tile(F32, d))
    got = emulated_forward(q, k, v, None, rope, scale=scale)
    assert _same_nans_and_close(got[0], want[0], *TOL_O)
    assert _same_nans_and_close(got[1], want[1], *TOL_LSE)
    args = (q, k, v, do, want[1], (want[0] * do).sum(-1), None, rope)
    bq, bkv = kernel_tiles("fused", F32, d)
    plain = fa.mh_flash_backward_plain(*args, scale=scale, block_q=bq, block_kv=bkv)
    grads = emulated_backward(*args, scale=scale)
    for g, w in zip(grads, plain):
        finite = w[~torch.isnan(w)]  # empty where every gradient is a NaN
        scale_g = float(finite.abs().max()) if finite.numel() else 0.0
        assert _same_nans_and_close(g, w, 0.0, BWD_TOL * scale_g)
