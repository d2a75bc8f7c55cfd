"""The flash and int8 entries at a T that is not a multiple of the kernels'
T multiple, on the CPU.

On a CUDA tensor `flash_attention` (both `multi_head` settings) and
`int8_flash_attention` take such a T by padding the rows to the next
multiple (`flash_attention_padded_t`, `int8_flash_attention_padded_t`):
zero q, k and v rows with a segment id no real row has, RoPE tables
extended by cos 1 and sin 0, the output and the gradients sliced back.
Here those same helpers run around the plain versions on CPU tensors,
padding to the kernels' own T multiple (128 in bf16 and int8, 64 in fp32),
and are held against the plain versions at the unpadded T: T 192, 320 and
1000 in bf16, 160, 288 and 1000 in fp32 (192 and 320 are fp32 kernel
lengths), dense, packed and PAD-tail rows, RoPE, dropout 0 and 0.1 (the
same mask, and in fp32 the same bits where the blocks carry over), forward
and q, k, v gradients, the per-head entry, int8; and against the JAX
kernels in interpret mode at T = 160 (fp32, blocks 32) and T = 192 (int8),
which the JAX entries take.
"""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import omnibiote_tpu.ops.flash_attention as jax_flash
import omnibiote_tpu.ops.int8_attention as jax_int8
from omnibiote_tpu.models.rope import rope_tables as jax_rope_tables

from omnibiote_tpu_torch.models.rope import rope_tables
from omnibiote_tpu_torch.ops import flash_attention as fa
from omnibiote_tpu_torch.ops import int8_attention as i8
from omnibiote_tpu_torch.ops.attention import attention_path

B, H, D = 1, 2, 64
SCALE = 1.0 / np.sqrt(D)
SEED = 0x5EED
# the plain forward against itself in another tile order: an ulp of o in
# bf16 (chip_smoke.TOL's o), fp32 sums in another order; gradients as
# max|d| / max|g|
TOL = {torch.float32: 2e-5, torch.bfloat16: 8e-3}
GRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def _ids(layout, T, rng):
    if layout == "dense":
        return None
    if layout == "packed":
        cuts = np.sort(rng.choice(np.arange(8, T - 8), 3, replace=False))
        return torch.from_numpy(np.searchsorted(cuts, np.arange(T), side="right")
                                [None].repeat(B, 0).astype(np.int32))
    ids = np.zeros((B, T), np.int32)     # a PAD tail, ids far from 0
    ids[:, T - T // 5:] = INT32_MAX
    ids[:, : T // 3] = INT32_MIN
    return torch.from_numpy(ids)


def _inputs(T, dtype, layout, seed, H=H, D=D):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(x).to(dtype)
                   for x in rng.standard_normal((4, B, T, H, D)).astype(np.float32))
    return q, k, v, do, _ids(layout, T, rng)


def _grads(fn, q, k, v, do, *args, **kw):
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    o = fn(q, k, v, *args, **kw)
    return (o.detach(), *torch.autograd.grad(o, (q, k, v), do))


def _hold(got, want, dtype, exact=False):
    (go, *gg), (wo, *wg) = got, want
    assert go.shape == wo.shape and go.dtype == wo.dtype
    if exact:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        return
    torch.testing.assert_close(go.float(), wo.float(), rtol=TOL[dtype], atol=TOL[dtype])
    for a, b in zip(gg, wg):
        rel = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert rel <= GRAD_REL[dtype], rel


# the lengths off each dtype's kernel multiple: 128 in bf16, 64 in fp32
RAGGED = {"bfloat16": (192, 320), "float32": (160, 288)}
CASES = [(T, dtype, layout, rate) for dtype in ("float32", "bfloat16") for T in RAGGED[dtype]
         for layout in ("dense", "packed", "padtail") for rate in (0.0, 0.1)]
# T = 1000: every layout without dropout, packed with it (its plain draw
# over 1000 x 1000 elements is the slow part)
CASES += [(1000, dtype, layout, 0.0) for dtype in ("float32", "bfloat16")
          for layout in ("dense", "packed", "padtail")]
CASES += [(1000, dtype, "packed", 0.1) for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("T,dtype,layout,rate", CASES)
def test_padded_t_matches_plain_at_unpadded_t(T, dtype, layout, rate):
    """flash_attention_padded_t (RoPE, skipping on, 64-row blocks where they
    divide T, else 32-row ones, one block at T = 1000) against flash_attention at the
    unpadded T, which runs the plain versions: o, dq, dk, dv; in fp32 the
    same bits where the blocks carry over to the padded T."""
    dtype = getattr(torch, dtype)
    q, k, v, do, seg = _inputs(T, dtype, layout, seed=T + int(10 * rate))
    block = next((b for b in (64, 32) if T % b == 0), None)
    kw = dict(scale=SCALE, dropout_rate=rate, seed=SEED, block_q=block, block_kv=block)
    rope = rope_tables(D, T)
    assert T % fa.KERNEL_T_MULTIPLE[dtype]
    want = _grads(fa.flash_attention, q, k, v, do, seg, rope, **kw)
    got = _grads(fa.flash_attention_padded_t, q, k, v, do, seg, rope, **kw)
    _hold(got, want, dtype, exact=dtype == torch.float32 and block is not None)


@pytest.mark.parametrize("T,dtype", [(192, "bfloat16"), (288, "float32"), (1000, "bfloat16")])
def test_per_head_entry_padded(T, dtype):
    """multi_head=False (no RoPE, no skipping, the split pair as its
    backward) through the padded route, packed rows, dropout 0.1."""
    dtype = getattr(torch, dtype)
    q, k, v, do, seg = _inputs(T, dtype, "packed", seed=7 * T)
    kw = dict(scale=SCALE, dropout_rate=0.1, seed=SEED, multi_head=False)
    want = _grads(fa.flash_attention, q, k, v, do, seg, None, **kw)
    got = _grads(fa.flash_attention_padded_t, q, k, v, do, seg, None, **kw)
    _hold(got, want, dtype)


@pytest.mark.parametrize("T", [192, 320, 1000])
def test_padded_t_draws_the_unpadded_mask(T):
    """The dropout stream keys an element by (b, h, i, j) alone: the mask of
    the padded call on the real rows and keys is the unpadded call's."""
    T_pad = fa.padded_seq_len(T, 128)
    want = fa.dropout_keep(SEED, 0.1, B, H, T, 0, T)
    got = fa.dropout_keep(SEED, 0.1, B, H, T_pad, 0, T_pad)[:, :, :T, :T]
    assert torch.equal(got, want) and 0.85 < want.float().mean() < 0.95


def test_odd_t_with_dropout_raises_as_plain():
    q, k, v, do, seg = _inputs(191, torch.float32, "packed", seed=3)
    kw = dict(scale=SCALE, dropout_rate=0.1, seed=SEED)
    with pytest.raises(ValueError, match="even"):
        fa.flash_attention(q, k, v, seg, **kw)
    with pytest.raises(ValueError, match="even"):
        fa.flash_attention_padded_t(q, k, v, seg, **kw)
    # without dropout an odd T runs
    want = fa.flash_attention(q, k, v, seg, scale=SCALE)
    got = fa.flash_attention_padded_t(q, k, v, seg, scale=SCALE)
    torch.testing.assert_close(got, want, rtol=TOL[torch.float32], atol=TOL[torch.float32])


def test_one_head_padded_in_head_dim_and_t():
    """One head at D = 96 and T = 320: the head dim padded to 128 and the
    rows to 384 together, against the plain version at (320, 96)."""
    q, k, v, do, seg = _inputs(320, torch.bfloat16, "packed", seed=96, H=1, D=96)
    rope = rope_tables(96, 320)
    kw = dict(scale=1.0 / np.sqrt(96), dropout_rate=0.1, seed=SEED)
    want = _grads(fa.flash_attention, q, k, v, do, seg, rope, **kw)

    def padded(q, k, v, seg, rope, **kw):
        qp, kp, vp = (fa.pad_head_dim(x, 128) for x in (q, k, v))
        rp = fa.pad_rope((rope[0][:320], rope[1][:320]), 128)
        o = fa.flash_attention_padded_t(qp, kp, vp, seg, rp, **kw)
        return fa.unpad_head_dim(o, 96)

    _hold(_grads(padded, q, k, v, do, seg, rope, **kw), want, torch.bfloat16)


@pytest.mark.parametrize("T,dtype,layout", [
    (192, "float32", "packed"), (192, "bfloat16", "padtail"), (320, "float32", "dense"),
    (320, "bfloat16", "packed"), (1000, "float32", "padtail")])
def test_int8_padded_t_matches_plain(T, dtype, layout):
    """int8_flash_attention_padded_t against the plain int8 version at the
    unpadded T (RoPE; block_q 200 at T = 1000): zero rows quantize to
    zeros and move no real row's scales, the pad keys get p = 0."""
    dtype = getattr(torch, dtype)
    q, k, v, _, seg = _inputs(T, dtype, layout, seed=8 * T, H=2, D=128)
    kw = dict(scale=1.0 / np.sqrt(128), segment_ids=seg, rope=rope_tables(128, T),
              block_q=200 if T == 1000 else 512)
    want = i8.int8_flash_attention(q, k, v, **kw)
    got = i8.int8_flash_attention_padded_t(q, k, v, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
    # the prologue's scales of the real rows do not move
    qp, kp, vp = (fa.pad_rows(x, 1024 if T == 1000 else 384) for x in (q, k, v))
    T_pad = qp.shape[1]
    full = i8.int8_quantize_plain(qp, kp, vp, fa.pad_rope_rows(kw["rope"], T, T_pad))
    mine = i8.int8_quantize_plain(q, k, v, kw["rope"])
    for a, b, name in zip(full, mine, ("q8", "sq", "k8", "sk", "v8t", "sv")):
        if name == "v8t":
            a = a[..., :T]
        elif name in ("q8", "k8", "sq", "sk"):
            a = a[:, :, :T]
        assert torch.equal(a, b), name
    assert torch.equal(full[1][:, :, T:], torch.ones_like(full[1][:, :, T:]))


def test_pad_ids_never_collide():
    """pad_segment_ids: the real rows keep which ids are equal and their
    order, and the pad id is no real id, whatever the caller's ids are
    (negative, the int32 extremes, all equal, all distinct)."""
    rows = [[INT32_MIN, 5, 5, INT32_MAX, -1, 0, -1, INT32_MIN],
            [INT32_MAX] * 8, [INT32_MIN] * 8, list(range(-4, 4)), [0] * 8,
            [INT32_MAX - 1, INT32_MAX, INT32_MIN + 1, INT32_MIN, 7, 7, 7, -7]]
    ids = torch.tensor(rows, dtype=torch.int32)
    for src in (ids, ids.long()):
        out = fa.pad_segment_ids(src, 6, 8, 16)
        assert out.dtype == torch.int32 and out.shape == (6, 16) and out.is_contiguous()
        real, pad = out[:, :8], out[:, 8:]
        assert torch.equal(real[:, :, None] == real[:, None, :], ids[:, :, None] == ids[:, None, :])
        assert torch.equal(real[:, :, None] < real[:, None, :], ids[:, :, None] < ids[:, None, :])
        assert bool((pad[:, :, None] != real[:, None, :]).all()) and bool((pad == pad[:, :1]).all())
    dense = fa.pad_segment_ids(None, 2, 5, 8)
    assert dense.tolist() == [[0] * 5 + [5] * 3] * 2
    # the renumbering keeps the skip bounds: the same tiles are pruned
    packed = torch.tensor([[-9] * 40 + [3] * 50 + [INT32_MAX] * 38], dtype=torch.int32)
    renum = fa.pad_segment_ids(packed, 1, 128, 128)
    for bq, bkv in ((32, 32), (64, 16)):
        assert all(torch.equal(a, b) for a, b in zip(fa.seg_block_bounds(packed, packed, bq, bkv),
                                                     fa.seg_block_bounds(renum, renum, bq, bkv)))


def test_padded_blocks():
    assert fa.padded_seq_len(192, 128) == 256 and fa.padded_seq_len(1000, 64) == 1024
    assert fa.padded_seq_len(5, 128) == 128
    assert [fa.padded_block(b, 192, 256) for b in (None, 192, 512, 64, 96)] == [
        None, None, None, 64, 64]
    assert fa.padded_block(200, 1000, 1024) == 128
    with pytest.raises(ValueError, match="does not divide"):
        fa.padded_block(100, 192, 256)


def test_foreign_bounds_are_rebuilt():
    """A SegmentBounds of other ids (here one that prunes every tile off
    the diagonal) is not used on the padded ids: the result is the call's
    without bounds."""
    q, k, v, do, seg = _inputs(160, torch.float32, "packed", seed=11)
    foreign = fa.SegmentBounds(torch.arange(160, dtype=torch.int32)[None].repeat(B, 1))
    kw = dict(scale=SCALE, block_q=32, block_kv=32)
    want = _grads(fa.flash_attention_padded_t, q, k, v, do, seg, None, **kw)
    got = _grads(fa.flash_attention_padded_t, q, k, v, do, seg, None, bounds=foreign, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_dispatch_still_routes_ragged_t_to_xla():
    for T in (192, 320, 1000):
        for device in ("cpu", "cuda"):
            assert attention_path(device, torch.bfloat16, T, 8, 128, False) == "xla"
            assert attention_path(device, torch.bfloat16, T, 8, 128, True) == "xla"
    assert attention_path("cuda", torch.bfloat16, 256, 8, 128, False) == "flash"


def test_flash_padded_t_matches_jax_interpret():
    """T = 160, blocks 32 (the JAX entry's assert passes; the fp32 kernels
    pad it to 192): o and jax.vjp's dq, dk, dv of the JAX flash_attention
    (Pallas, interpret mode) against the padded route around the plain
    versions, packed ids, RoPE, fp32 at 2e-5 (o) and 2e-4 (the JAX
    package's flash-backward tolerance)."""
    T = 160
    q, k, v, do, seg = _inputs(T, torch.float32, "packed", seed=19)
    cos, sin = jax_rope_tables(D, T)

    def f(q, k, v):
        return jax_flash.flash_attention(q, k, v, segment_ids=jnp.asarray(seg.numpy()),
                                         scale=SCALE, block_q=32, block_kv=32, rope=(cos, sin))

    o, vjp = jax.vjp(f, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want = [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do.numpy()))]
    got = _grads(fa.flash_attention_padded_t, q, k, v, do, seg, rope_tables(D, T),
                 scale=SCALE, block_q=32, block_kv=32)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=2e-5, atol=2e-5)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=2e-4)


def test_int8_padded_t_matches_jax_interpret():
    """T = 192, one q block (the JAX entry takes min(block_q, T)): the JAX
    int8 kernel (Pallas, interpret mode) against the padded route around
    the plain version, packed ids, RoPE, fp32 (the bar of
    tests/test_torch_int8_attention.py: exp2 and the fp32 sums differ in
    the last bits between XLA and PyTorch, which can move a round(p * 127)
    by a step)."""
    T = 192
    q, k, v, _, seg = _inputs(T, torch.float32, "packed", seed=23, H=1, D=128)
    scale = 1.0 / np.sqrt(128)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_int8.int8_flash_attention(
            *(jnp.asarray(x.numpy()) for x in (q, k, v)), scale=scale,
            segment_ids=jnp.asarray(seg.numpy()), rope=jax_rope_tables(128, T)))
    got = i8.int8_flash_attention_padded_t(q, k, v, scale=scale, segment_ids=seg,
                                           rope=rope_tables(128, T)).numpy()
    diff = np.abs(got.astype(np.float64) - want)
    assert diff.max() <= 2e-3, diff.max()
    assert (diff > 1e-5).mean() < 0.01, (diff > 1e-5).mean()
