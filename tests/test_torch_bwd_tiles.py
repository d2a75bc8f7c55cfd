"""The backward kernels' tiles and T multiples, and the plain backwards on
the tiles of the bf16 kernels, on the CPU: the fused kernel and the split
pair's dkv kernel (a 128-row kv tile walking 64-row q tiles; 64-row kv
tiles at D = 256) and its dq kernel (a 128-row q tile walking 64-row kv
tiles; 32-row at D = 256).

The tile table and the T multiples are pinned literally; a kernel wrapper
refuses a T off its kernel's multiple before it looks at the device; with
segment skipping on those tiles the plain fused backward and the plain
split pair equal the full walk bit for bit; the fused one matches the JAX
package's `_mh_bwd_fused` (one kv block spanning T) and `_mh_bwd_fusedmk`
(128-wide blocks with skipping), the split pair its `_mh_bwd` with
`FUSED_MULTIKV_BWD` off (`_mh_bwd_dkv_kernel`, `_mh_bwd_dq_kernel`), Pallas
in interpret mode, through `jax.vjp`."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnibiote_tpu.models.rope import rope_tables as jax_rope_tables
from omnibiote_tpu.ops import flash_attention as jax_flash

from omnibiote_tpu_torch.models.rope import rope_tables
from omnibiote_tpu_torch.ops import _kernels
from omnibiote_tpu_torch.ops import flash_attention as port_flash
from omnibiote_tpu_torch.ops.flash_attention import (
    KERNEL_T_MULTIPLE, KERNEL_TILES, SegmentBounds, kernel_tiles, mh_flash_backward_plain,
    mh_flash_bwd_dkv_plain, mh_flash_bwd_dq_plain, mh_flash_forward_plain)

BF16, F32 = torch.bfloat16, torch.float32
B, H, D = 2, 2, 128
SCALE = 1.0 / np.sqrt(D)
FUSED_TILES = KERNEL_TILES["fused"][BF16]


def _packed_ids(rng, T, layout):
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(16, T - 16), 4, replace=False))
        seg[b] = np.searchsorted(cuts, np.arange(T), side="right")
        if layout == "padded":
            seg[b, int(rng.integers(T // 8, T - 8)):] = -1
        elif layout == "unsorted":
            seg[b] = rng.permutation(5)[seg[b]]
    return seg


def _inputs(T, layout, seed, head_dim=D):
    rng = np.random.default_rng(seed)
    q, k, v, do = rng.standard_normal((4, B, T, H, head_dim)).astype(np.float32)
    return q, k, v, do, _packed_ids(rng, T, layout)


# (rate, layout, head dim) of the skip tests: every pair at D = 128 and at
# D = 256, whose kernels own and walk other tiles
SKIP_CASES = [pytest.param(rate, layout, head_dim,
                           id=f"{rate}-{layout}" + ("" if head_dim == D else f"-d{head_dim}"))
              for head_dim in (D, 256) for rate in (0.0, 0.1)
              for layout in ("packed", "padded", "unsorted")]


def test_kernel_tiles_and_t_multiples():
    """(q tile, kv tile) of every kernel kind and the T multiple per dtype:
    the bf16 dkv kernel is the fused kernel without dq, on its tiles; the
    bf16 dq kernel owns 128 q rows and walks 64-row kv tiles, the fp32 one
    64 q rows and 64-row kv tiles; each T
    multiple is a multiple of the kind's tiles, and each divides 128, the
    multiple every T the dispatch sends to flash has."""
    assert KERNEL_TILES == {
        "fwd": {BF16: (128, 128), F32: (32, 32)},
        "fused": {BF16: (64, 128), F32: (16, 32)},
        "dkv": {BF16: (64, 128), F32: (16, 32)},
        "dq": {BF16: (128, 64), F32: (64, 64)},
    }
    assert KERNEL_T_MULTIPLE == {BF16: 128, F32: 64}
    for kind, rows in KERNEL_TILES.items():
        for dtype, (bq, bkv) in rows.items():
            multiple = KERNEL_T_MULTIPLE[dtype]
            assert multiple % bq == 0 and multiple % bkv == 0, (kind, dtype)
            assert 128 % multiple == 0, (kind, dtype)


@pytest.mark.parametrize("kind,dtype,T,refused", [
    ("fused", BF16, 192, True), ("fused", BF16, 64, True),
    ("fused", F32, 192, False), ("dkv", BF16, 192, True),
    ("dq", BF16, 192, True), ("dkv", F32, 192, False), ("dq", F32, 192, False),
    ("dkv", BF16, 256, False), ("dq", BF16, 256, False)])
def test_kernel_wrappers_check_t_against_their_multiple(monkeypatch, kind, dtype,
                                                         T, refused):
    """A bf16 backward call (fused, dkv or dq) at a T off 128 is refused by
    its T multiple, before the device is looked at and with no library
    touched; the calls whose multiple T meets get as far as the device
    check."""
    def refuse(*a, **k):
        raise AssertionError("the kernel library was touched")

    monkeypatch.setattr(_kernels, "load_library", refuse)
    x = torch.zeros(1, T, 1, D, dtype=dtype)
    rows = torch.zeros(1, T, 1)
    before = dict(_kernels.LAUNCHES)
    match = (f"multiple of {KERNEL_T_MULTIPLE[dtype]}" if refused
             else "not a CUDA tensor")
    with pytest.raises(ValueError, match=match):
        port_flash.mh_flash_bwd_kernel(kind, x, x, x, x, rows, rows, scale=SCALE)
    assert _kernels.LAUNCHES == before


@pytest.mark.parametrize("rate,layout,head_dim", SKIP_CASES)
def test_plain_fused_skip_on_equals_off_on_the_kernel_tiles(rate, layout, head_dim):
    """bf16 on the fused kernel's tiles at the head dim (the bounds it is
    given on the card): tiles are pruned, and dq, dk, dv equal the full
    walk bit for bit."""
    T = 512
    bq, bkv = kernel_tiles("fused", BF16, head_dim)
    q, k, v, do, seg = _inputs(T, layout, seed=17, head_dim=head_dim)
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    seg_t, rope = torch.from_numpy(seg), rope_tables(head_dim, T)
    sb = SegmentBounds(seg_t)
    lo, hi = sb.get(bkv, bq)
    assert int((hi - lo + 1).sum()) < B * (T // bkv) * (T // bq)
    kw = dict(scale=1.0 / np.sqrt(head_dim), dropout_rate=rate, seed=23)
    o, lse2 = mh_flash_forward_plain(q, k, v, seg_t, rope, **kw)
    di = (o.float() * do.float()).sum(-1)
    args = (q, k, v, do, lse2, di, seg_t, rope)
    off = mh_flash_backward_plain(*args, **kw)
    on = mh_flash_backward_plain(*args, **kw, block_q=bq, block_kv=bkv,
                                 segment_skip=True, bounds=sb)
    for g, w in zip(on, off):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case,T", [("single_kv", 256), ("multi_kv", 512)])
def test_plain_fused_on_the_kernel_tiles_matches_jax(case, T):
    """fp32, packed rows: the plain fused backward with skipping on the
    fused kernel's tiles against jax.vjp of flash_attention with one kv
    block spanning T (`_mh_bwd_fused`) or 128-wide blocks with skipping
    (`_mh_bwd_fusedmk`), at rtol 2e-4 / atol 2e-4 (the JAX package's own
    flash-backward tolerance: fp32 sums in another order)."""
    q, k, v, do, seg = _inputs(T, "packed", seed=29)
    blocks = (128, T) if case == "single_kv" else (128, 128)
    cos, sin = jax_rope_tables(D, T)

    def f(q, k, v):
        return jax_flash.flash_attention(
            q, k, v, segment_ids=jnp.asarray(seg), scale=SCALE, block_q=blocks[0],
            block_kv=blocks[1], rope=(cos, sin), segment_skip=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    seg_t, rope = torch.from_numpy(seg), rope_tables(D, T)
    o, lse2 = mh_flash_forward_plain(*t[:3], seg_t, rope, scale=SCALE)
    di = (o * t[3]).sum(-1)
    got = mh_flash_backward_plain(*t, lse2, di, seg_t, rope, scale=SCALE,
                                  block_q=FUSED_TILES[0], block_kv=FUSED_TILES[1],
                                  segment_skip=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4, err_msg=name)


def _split_plain(args, kw, sb=None):
    """The plain split pair (dq, dk, dv) on the bf16 dkv and dq kernels'
    tiles at q's head dim, with skipping when `sb` (a SegmentBounds) is
    given."""
    skip = dict(segment_skip=True, bounds=sb) if sb is not None else {}
    head_dim = args[0].shape[-1]
    dkq, dkkv = kernel_tiles("dkv", BF16, head_dim)
    dqq, dqkv = kernel_tiles("dq", BF16, head_dim)
    dk, dv = mh_flash_bwd_dkv_plain(*args, **kw, block_q=dkq, block_kv=dkkv, **skip)
    dq = mh_flash_bwd_dq_plain(*args, **kw, block_q=dqq, block_kv=dqkv, **skip)
    return dq, dk, dv


@pytest.mark.parametrize("rate,layout,head_dim", SKIP_CASES)
def test_plain_split_skip_on_equals_off_on_the_kernel_tiles(rate, layout, head_dim):
    """bf16 on the split pair's tiles at the head dim (the bounds its
    kernels are given on the card: per kv tile for dkv, per q tile for dq):
    tiles are pruned on both sides, and dq, dk, dv equal the full walk, and
    the fused plain backward, bit for bit."""
    T = 512
    q, k, v, do, seg = _inputs(T, layout, seed=31, head_dim=head_dim)
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    seg_t, rope = torch.from_numpy(seg), rope_tables(head_dim, T)
    sb = SegmentBounds(seg_t)
    for kind in ("dkv", "dq"):
        bq, bkv = kernel_tiles(kind, BF16, head_dim)
        lo, hi = sb.get(bkv, bq) if kind == "dkv" else sb.get(bq, bkv)
        assert int((hi - lo + 1).sum()) < lo.numel() * (T // (bq if kind == "dkv" else bkv))
    kw = dict(scale=1.0 / np.sqrt(head_dim), dropout_rate=rate, seed=37)
    o, lse2 = mh_flash_forward_plain(q, k, v, seg_t, rope, **kw)
    di = (o.float() * do.float()).sum(-1)
    args = (q, k, v, do, lse2, di, seg_t, rope)
    on = _split_plain(args, kw, sb)
    for g, w, x in zip(on, _split_plain(args, kw), mh_flash_backward_plain(*args, **kw)):
        assert torch.equal(g, w) and torch.equal(g, x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_split_on_the_kernel_tiles_matches_jax(dtype):
    """Packed rows, T = 256 with 128-wide blocks and FUSED_MULTIKV_BWD off,
    so that the JAX package's `_mh_bwd` takes its split pair: the plain
    split pair with skipping on the bf16 kernels' tiles against jax.vjp.
    fp32 at rtol 2e-4 / atol 2e-4 (the JAX package's own flash-backward
    tolerance: fp32 sums in another order); bf16 at 2e-2 of each
    gradient's largest value (a sum in another order can flip the bf16
    rounding of an operand or an output), as tests/test_torch_attention_skip.py
    holds the split pair through autograd."""
    T = 256
    q, k, v, do, seg = _inputs(T, "packed", seed=41)
    jdt, tdt = (jnp.float32, F32) if dtype == "float32" else (jnp.bfloat16, BF16)
    cos, sin = jax_rope_tables(D, T)

    def f(q, k, v):
        return jax_flash.flash_attention(
            q, k, v, segment_ids=jnp.asarray(seg), scale=SCALE, block_q=128,
            block_kv=128, rope=(cos, sin), segment_skip=True)

    old = jax_flash.FUSED_MULTIKV_BWD
    jax_flash.FUSED_MULTIKV_BWD = False
    try:
        _, vjp = jax.vjp(f, *(jnp.asarray(x, jdt) for x in (q, k, v)))
        want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, jdt))]
    finally:
        jax_flash.FUSED_MULTIKV_BWD = old

    t = [torch.from_numpy(x).to(tdt) for x in (q, k, v, do)]
    seg_t, rope = torch.from_numpy(seg), rope_tables(D, T)
    o, lse2 = mh_flash_forward_plain(*t[:3], seg_t, rope, scale=SCALE)
    di = (o.float() * t[3].float()).sum(-1)
    got = _split_plain((*t, lse2, di, seg_t, rope), dict(scale=SCALE), SegmentBounds(seg_t))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g = g.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4, err_msg=name)
        else:
            assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), name
