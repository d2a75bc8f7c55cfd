"""PyTorch port vs the JAX package: the multi-head flash attention backward
(the port's autograd Function, the plain backward on the CPU) against
`jax.vjp` of `flash_attention` with one kv block spanning T, so that the
JAX package runs `_mh_bwd_fused` (Pallas, interpret mode on the CPU); and
the port's dropout stream, as far as the CPU can show it.

The TPU's in-kernel random bits cannot be reproduced, so the parity runs
at dropout 0; dropout is checked by the Philox known-answer vectors, the
keep fraction, the mask's independence of the tiling, and the plain
backward against autograd through the plain forward with the same seed."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnibiote_tpu.models.rope import rope_tables as jax_rope_tables
from omnibiote_tpu.ops.flash_attention import flash_attention as jax_flash_attention

from omnibiote_tpu_torch.models.rope import rope_tables
from omnibiote_tpu_torch.ops import flash_attention as port_flash
from omnibiote_tpu_torch.ops.flash_attention import (
    dropout_bits, dropout_keep, dropout_keep_scale, dropout_threshold,
    flash_attention, mh_flash_backward_plain, mh_flash_forward_plain,
    philox4x32)

B, T, H, D = 2, 256, 2, 128
SCALE = 1.0 / np.sqrt(D)


def _segments(rng, layout):
    if layout == "dense":
        return None
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        if layout == "packed":
            cuts = np.sort(rng.choice(np.arange(16, T - 16), 3, replace=False))
            seg[b] = np.searchsorted(cuts, np.arange(T), side="right")
        else:
            seg[b, int(rng.integers(T // 4, T - 8)):] = -1
    return seg


def _inputs(layout, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = rng.standard_normal((4, B, T, H, D)).astype(np.float32)
    return q, k, v, do, _segments(rng, layout)


def _jax_grads(q, k, v, do, seg, dtype):
    cos, sin = jax_rope_tables(D, T)
    seg_j = None if seg is None else jnp.asarray(seg)

    def f(q, k, v):
        return jax_flash_attention(q, k, v, segment_ids=seg_j, scale=SCALE,
                                   block_q=128, block_kv=T, rope=(cos, sin))

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    o, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(do, dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


def _port_grads(q, k, v, do, seg, dtype, dropout_rate=0.0, seed=0):
    qt, kt, vt = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
    o = flash_attention(qt, kt, vt, None if seg is None else torch.from_numpy(seg),
                        rope_tables(D, T), scale=SCALE,
                        dropout_rate=dropout_rate, seed=seed)
    grads = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do).to(dtype))
    return [x.detach().float().numpy() for x in (o, *grads)]


@pytest.mark.parametrize("layout", ["packed", "padded", "dense"])
def test_backward_matches_jax_fused_fp32(layout):
    """fp32: o, dq, dk, dv at rtol 2e-4 / atol 2e-4 (the JAX package's own
    flash-backward tolerance): fp32 sums in another order, nothing else."""
    q, k, v, do, seg = _inputs(layout)
    want = _jax_grads(q, k, v, do, seg, jnp.float32)
    got = _port_grads(q, k, v, do, seg, torch.float32)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4, err_msg=name)


def test_backward_matches_jax_fused_bf16():
    """bf16: both round the rotated q/k, p_drop and ds to bf16 at the same
    points, but fp32 sums in another order can flip a bf16 rounding of an
    operand or of an output, so each gradient is held to 2e-2 of its
    largest value (about five bf16 ulps there)."""
    q, k, v, do, seg = _inputs("packed", seed=1)
    want = _jax_grads(q, k, v, do, seg, jnp.bfloat16)
    got = _port_grads(q, k, v, do, seg, torch.bfloat16)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), name


# ---------------------------------------------------------------------------
# The dropout stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's kat_vectors for philox4x32-10."""
    got = philox4x32(*(torch.tensor(c, dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in got) == want


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_fraction_and_threshold(rate):
    """The keep rule is the JAX package's (bits >= min(⌊rate·2³²⌋, 2³²-1)),
    and over a (2, 2, 256, 256) mask the kept share is 1 - rate within
    four standard deviations."""
    assert dropout_threshold(rate) == min(int(rate * (2.0 ** 32)), 2 ** 32 - 1)
    keep = dropout_keep(7, rate, 2, 2, 256, 0, 256)
    n = keep.numel()
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(keep.float().mean().item() - (1 - rate)) < 4 * sigma
    assert dropout_keep_scale(rate) == pytest.approx(1 / (1 - rate), rel=1e-7)


def test_mask_is_a_function_of_the_element_alone():
    """Any tiling of the key axis draws the same mask, another seed another
    mask; the plain forward with dropout gives the same output whatever its
    kv block."""
    full = dropout_bits(11, 2, 2, 128, 0, 128)
    tiles = torch.cat([dropout_bits(11, 2, 2, 128, j, 32) for j in range(0, 128, 32)], -1)
    assert torch.equal(full, tiles)
    assert not torch.equal(full, dropout_bits(12, 2, 2, 128, 0, 128))
    q, k, v, _, seg = _inputs("packed", seed=2)
    args = [torch.from_numpy(x) for x in (q, k, v)] + [torch.from_numpy(seg),
                                                       rope_tables(D, T)]
    o1, l1 = mh_flash_forward_plain(*args, scale=SCALE, dropout_rate=0.1, seed=5)
    o2, l2 = mh_flash_forward_plain(*args, scale=SCALE, dropout_rate=0.1, seed=5,
                                    block_kv=64)
    np.testing.assert_allclose(o2.numpy(), o1.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("layout", ["packed", "padded"])
def test_plain_backward_with_dropout_equals_autograd(layout):
    """fp32, dropout 0.1: the plain backward (and the Function around it)
    equals torch.autograd through the plain forward with the same seed, to
    2e-5 of each gradient's largest value (fp32 sums in another order)."""
    q, k, v, do, seg = _inputs(layout, seed=3)
    got = _port_grads(q, k, v, do, seg, torch.float32, dropout_rate=0.1, seed=99)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, _ = mh_flash_forward_plain(qt, kt, vt, torch.from_numpy(seg),
                                  rope_tables(D, T), scale=SCALE,
                                  dropout_rate=0.1, seed=99)
    want = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want):
        w = w.numpy()
        assert np.abs(g - w).max() <= 2e-5 * np.abs(w).max(), name
    # the dropout changed the result
    undropped = _port_grads(q, k, v, do, seg, torch.float32)
    assert np.abs(undropped[3] - got[3]).max() > 1e-3


def test_backward_wrapper_routes_cpu_tensors_to_the_plain_version():
    q, k, v, do, seg = _inputs("dense", seed=4)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = mh_flash_forward_plain(*t[:3], None, None, scale=SCALE)
    di = (o * t[3]).sum(-1)
    got = port_flash.mh_flash_backward(*t, lse, di, None, None, scale=SCALE)
    want = mh_flash_backward_plain(*t, lse, di, None, None, scale=SCALE)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
