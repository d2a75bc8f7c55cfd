"""PyTorch port vs the JAX package: the plain version of the multi-head
flash forward against `_mh_fwd` (Pallas, interpret mode on the CPU), also
on the CUDA kernel's own tiles, and the port's attention dispatch against
`ops/attention.py`'s routing (on a CPU tensor exactly; on a CUDA tensor
the same, refusing what the kernels are not built for)."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import omnibiote_tpu.ops.attention as jax_attention
import omnibiote_tpu.ops.flash_attention as jax_flash
from omnibiote_tpu.models.rope import rope_tables as jax_rope_tables

import omnibiote_tpu.ops.int8_attention as jax_int8
import omnibiote_tpu_torch.ops.attention as port_attention
from omnibiote_tpu_torch.ops.flash_attention import (
    DEFAULT_MASK_VALUE, KERNEL_HEAD_DIMS, KERNEL_KV_TILE, KERNEL_T_MULTIPLE,
    KERNEL_TILES, LOG2E, mh_flash_forward, mh_flash_forward_plain)
from omnibiote_tpu_torch.models.rope import rope_tables


def _segments(rng, B, T, layout):
    if layout == "dense":
        return None
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        if layout == "packed":
            # EOS-like boundaries: consecutive segment ids
            cuts = np.sort(rng.choice(np.arange(16, T - 16), 3, replace=False))
            seg[b] = np.searchsorted(cuts, np.arange(T), side="right")
        else:
            # padded tail: real tokens 0, PAD from `n` on -1
            n = int(rng.integers(T // 4, T - 8))
            seg[b, n:] = -1
    return seg


def _inputs(B, T, H, D, layout, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = rng.standard_normal((3, B, T, H, D)).astype(np.float32)
    return q, k, v, _segments(rng, B, T, layout)


def _jax_mh_fwd(q, k, v, seg, use_rope, block_kv, scale, dtype):
    B, T, H, D = q.shape
    seg_j = jnp.zeros((B, T), jnp.int32) if seg is None else jnp.asarray(seg)
    if use_rope:
        cos, sin = jax_rope_tables(D, T)
        cos2 = jnp.concatenate([cos, cos], axis=1)
        sin2 = jnp.concatenate([sin, sin], axis=1)
    else:
        cos2 = sin2 = jnp.zeros((1, 1), jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        o, lse = jax_flash._mh_fwd(
            jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
            seg_j, seg_j, cos2, sin2, 0, scale=scale, block_q=128,
            block_kv=block_kv, dropout_rate=0.0, use_rope=use_rope)
    return np.asarray(o.astype(jnp.float32)), np.asarray(lse)


def _port(q, k, v, seg, use_rope, block_kv, scale, dtype):
    T, D = q.shape[1], q.shape[3]
    t = lambda x: torch.from_numpy(x).to(dtype)
    o, lse = mh_flash_forward(
        t(q), t(k), t(v), None if seg is None else torch.from_numpy(seg),
        rope_tables(D, T) if use_rope else None, scale=scale,
        block_kv=None if block_kv == T else block_kv)
    return o.float().numpy(), lse.numpy()


T_TEST = 256


@pytest.mark.parametrize("block_kv", [T_TEST, 128], ids=["single_kv", "multi_kv"])
@pytest.mark.parametrize("use_rope", [True, False], ids=["rope", "norope"])
@pytest.mark.parametrize("layout", ["packed", "padded", "dense"])
@pytest.mark.parametrize("D", [64, 128])
def test_plain_matches_jax_mh_fwd_fp32(D, layout, use_rope, block_kv):
    """fp32: o and lse2 at rtol 2e-5 / atol 2e-5 (fp32 sums in another
    order, nothing else differs)."""
    q, k, v, seg = _inputs(2, T_TEST, 2, D, layout)
    scale = 1.0 / np.sqrt(D)
    jo, jl = _jax_mh_fwd(q, k, v, seg, use_rope, block_kv, scale, jnp.float32)
    po, pl = _port(q, k, v, seg, use_rope, block_kv, scale, torch.float32)
    np.testing.assert_allclose(po, jo, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(pl, jl, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("block_kv", [T_TEST, 128], ids=["single_kv", "multi_kv"])
def test_plain_matches_jax_mh_fwd_bf16(block_kv):
    """bf16 inputs: both round rotated q/k and P to bf16 at the same points,
    but fp32 sums in another order can flip a bf16 rounding of P or of o,
    so o is held to 1e-2 (about two bf16 ulps at |o| ~ 1) and the fp32
    lse2 to 1e-4."""
    q, k, v, seg = _inputs(2, T_TEST, 2, 128, "packed", seed=3)
    scale = 1.0 / np.sqrt(128)
    jo, jl = _jax_mh_fwd(q, k, v, seg, True, block_kv, scale, jnp.bfloat16)
    po, pl = _port(q, k, v, seg, True, block_kv, scale, torch.bfloat16)
    np.testing.assert_allclose(po, jo, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-4)


def test_forward_tiles_follow_the_kernel():
    """The bf16 forward kernel's CTA owns a 128-row q tile and walks
    128-row kv tiles: the plain version's kv tile and the skip bounds'
    tiles are those, and its T multiple divides every T the dispatch sends
    to flash (T % 128 == 0)."""
    bf16 = torch.bfloat16
    assert KERNEL_TILES["fwd"][bf16] == (128, 128)
    assert KERNEL_TILES["fwd"][bf16][1] == KERNEL_KV_TILE[bf16]
    assert KERNEL_TILES["fwd"][torch.float32][1] == KERNEL_KV_TILE[torch.float32]
    for dtype, multiple in KERNEL_T_MULTIPLE.items():
        assert 128 % multiple == 0, dtype
        assert multiple % KERNEL_TILES["fwd"][dtype][0] == 0, dtype


@pytest.mark.parametrize("layout", ["packed", "padded", "dense"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_plain_on_the_kernel_tile_matches_jax(dtype, layout):
    """The plain version on the CUDA kernel's kv tile (the order of rounding
    the kernel is held to on the card) against `_mh_fwd` with block_kv =
    that tile: fp32 at 2e-5, bf16 o at 1e-2 and lse2 at 1e-4 (as above)."""
    tile = KERNEL_KV_TILE[dtype]
    T = 3 * KERNEL_KV_TILE[torch.bfloat16]
    q, k, v, seg = _inputs(2, T, 2, 128, layout, seed=11)
    scale = 1.0 / np.sqrt(128)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jo, jl = _jax_mh_fwd(q, k, v, seg, True, tile, scale, jdt)
    po, pl = _port(q, k, v, seg, True, tile, scale, dtype)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(po, jo, rtol=tol, atol=tol)
    np.testing.assert_allclose(pl, jl, rtol=2e-5 if dtype == torch.float32 else 1e-5,
                               atol=2e-5 if dtype == torch.float32 else 1e-4)


def test_isolated_query_sees_only_itself():
    """A query whose segment id no other position carries attends to its own
    key alone: the finite mask bias gives every other key exactly zero
    weight, and the other queries never see that key."""
    q, k, v, _ = _inputs(1, 128, 1, 64, "dense", seed=5)
    seg = np.zeros((1, 128), np.int32)
    seg[0, 0] = 7
    scale = 0.125
    o, lse = mh_flash_forward_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(seg), None, scale=scale)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(o[0, 0].numpy(), v[0, 0], rtol=1e-6, atol=1e-6)
    s_self = float(np.float32(q[0, 0, 0] @ k[0, 0, 0]) * np.float32(scale * LOG2E))
    assert lse[0, 0, 0].item() == pytest.approx(s_self, rel=1e-5, abs=1e-5)
    rest, _ = mh_flash_forward_plain(
        torch.from_numpy(q[:, 1:]), torch.from_numpy(k[:, 1:]),
        torch.from_numpy(v[:, 1:]), None, None, scale=scale)
    np.testing.assert_allclose(o[0, 1:].numpy(), rest[0].numpy(), rtol=1e-5,
                               atol=1e-6)


def test_fully_masked_tile_leaves_no_trace():
    """Online softmax across kv tiles: rows of the second segment meet a
    first tile that is fully masked for them. The finite mask value
    (never -inf, so never inf - inf) makes that tile's weight vanish once
    the visible tile arrives, and the result equals the single-block one."""
    q, k, v, _ = _inputs(2, 256, 2, 64, "dense", seed=6)
    seg = torch.zeros(2, 256, dtype=torch.int32)
    seg[:, 128:] = 1
    args = [torch.from_numpy(x) for x in (q, k, v)] + [seg, None]
    o1, l1 = mh_flash_forward_plain(*args, scale=0.2, block_kv=None)
    o2, l2 = mh_flash_forward_plain(*args, scale=0.2, block_kv=128)
    assert torch.isfinite(o2).all() and torch.isfinite(l2).all()
    np.testing.assert_allclose(o2.numpy(), o1.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=1e-6, atol=1e-5)
    assert DEFAULT_MASK_VALUE == pytest.approx(-0.7 * np.finfo(np.float32).max)
    assert LOG2E == pytest.approx(np.log2(np.e))


# ---------------------------------------------------------------------------
# Dispatch: the port routes as ops/attention.py does
# ---------------------------------------------------------------------------

def _jax_route(monkeypatch, q, k, v, **kw):
    seen = []

    def fake_flash(q, k, v, *, block_q, block_kv, block_kv_fwd=None, **_):
        seen.append(("flash", block_q, block_kv, block_kv_fwd or block_kv))
        return q

    def fake_xla(q, k, v, **_):
        seen.append(("xla", None))
        return q

    monkeypatch.setattr(jax_flash, "flash_attention", fake_flash)
    monkeypatch.setattr(jax_attention, "xla_attention", fake_xla)
    jax_attention.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **kw)
    return seen


def _port_route(monkeypatch, q, k, v, **kw):
    seen = []

    def fake_flash(q, k, v, segment_ids, rope, *, scale, block_q, block_kv,
                   block_kv_fwd=None, dropout_rate=0.0, seed=0,
                   segment_skip=True, bounds=None):
        assert segment_skip
        seen.append(("flash", block_q, block_kv, block_kv_fwd or block_kv))
        return q

    def fake_xla(q, k, v, **_):
        seen.append(("xla", None))
        return q

    monkeypatch.setattr(port_attention, "flash_attention", fake_flash)
    monkeypatch.setattr(port_attention, "xla_attention", fake_xla)
    port_attention.attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **kw)
    return seen


@pytest.mark.parametrize("T,H,D,causal,segs,block_kv", [
    (256, 2, 128, False, True, None),    # flash, single kv
    (1024, 8, 128, False, False, None),  # the serving shape
    (1536, 1, 128, False, True, None),   # sequence-wide forward block
    (2048, 1, 128, False, False, None),
    (4096, 1, 128, False, True, None),   # long packed: 512-wide kv blocks
    (3072, 1, 128, False, False, None),
    (768, 2, 128, False, True, 384),     # explicit block, _fit_block
    (640, 1, 64, False, False, 512),     # one head: any head_dim
    (256, 2, 64, False, True, None),     # narrow heads: dense path
    (256, 2, 128, True, False, None),    # causal: dense path
    (200, 2, 128, False, True, None),    # T % 128 != 0: dense path
])
def test_dispatch_matches_jax(monkeypatch, T, H, D, causal, segs, block_kv):
    rng = np.random.default_rng(0)
    q, k, v = rng.standard_normal((3, 1, T, H, D)).astype(np.float32)
    seg = np.zeros((1, T), np.int32) if segs else None
    cos, sin = rope_tables(D, T)
    jcos, jsin = jax_rope_tables(D, T)
    common = dict(scale=0.1, causal=causal, block_kv=block_kv)
    want = _jax_route(monkeypatch, q, k, v, rope=(jcos, jsin),
                      segment_ids=None if seg is None else jnp.asarray(seg),
                      **common)
    got = _port_route(monkeypatch, q, k, v, rope=(cos, sin),
                      segment_ids=None if seg is None else torch.from_numpy(seg),
                      **common)
    assert got == want


def _jax_path(monkeypatch, T, H, D, int8):
    """The path the JAX dispatch takes for a call of this shape."""
    seen = []
    tag = lambda name: (lambda q, *a, **k: (seen.append(name), q)[1])
    monkeypatch.setattr(jax_int8, "int8_flash_attention", tag("int8"))
    monkeypatch.setattr(jax_flash, "flash_attention", tag("flash"))
    monkeypatch.setattr(jax_attention, "xla_attention", tag("xla"))
    x = jnp.zeros((1, T, H, D), jnp.float32)
    jax_attention.attention(x, x, x, scale=0.1, int8=int8)
    return seen[0]


# The path of a bf16 call on a CUDA tensor at T = 256, by (D, H, int8):
# the JAX dispatch's own route wherever the port builds that kernel (flash
# at D 64, 128, 256 and every multiple of 128 past it, and one head at any
# D on padded inputs; int8 at every multiple of 128), "raise" where JAX
# runs a kernel the port does not build (none since head dims past 256
# were built), "xla" where JAX itself runs no kernel.
CUDA_PATHS = {
    (32, 1, False): "flash", (32, 1, True): "flash",
    (32, 8, False): "xla", (32, 8, True): "xla",
    (64, 1, False): "flash", (64, 1, True): "flash",
    (64, 8, False): "xla", (64, 8, True): "xla",
    (96, 1, False): "flash", (96, 1, True): "flash",
    (96, 8, False): "xla", (96, 8, True): "xla",
    (128, 1, False): "flash", (128, 1, True): "int8",
    (128, 8, False): "flash", (128, 8, True): "int8",
    (256, 1, False): "flash", (256, 1, True): "int8",
    (256, 8, False): "flash", (256, 8, True): "int8",
    (384, 1, False): "flash", (384, 1, True): "int8",
    (384, 8, False): "flash", (384, 8, True): "int8",
}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("H", [1, 8])
@pytest.mark.parametrize("D", [32, 64, 96, 128, 256, 384])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_attention_path(monkeypatch, device, D, H, int8):
    """On the CPU the port routes exactly as the JAX dispatch; on a CUDA
    tensor it takes the same route where its kernel is built (flash:
    kernel_head_dim, and one head at any D; int8: every D % 128 == 0) and
    raises NotImplementedError where the JAX dispatch would run a kernel
    the port does not build (no head dim since D past 256 was built; a
    "raise" entry of CUDA_PATHS would check it)."""
    T = 256
    jax_path = _jax_path(monkeypatch, T, H, D, int8)
    if device == "cpu":
        got = port_attention.attention_path(device, torch.bfloat16, T, H, D, int8)
        assert got == jax_path
        seen = []
        tag = lambda name: (lambda q, *a, **k: (seen.append(name), q)[1])
        for name in ("int8", "flash", "xla"):
            attr = {"int8": "int8_flash_attention", "flash": "flash_attention",
                    "xla": "xla_attention"}[name]
            monkeypatch.setattr(port_attention, attr, tag(name))
        x = torch.zeros(1, T, H, D)
        port_attention.attention(x, x, x, scale=0.1, int8=int8)
        assert seen == [got]
        return
    want = CUDA_PATHS[(D, H, int8)]
    if want == "raise":
        assert jax_path != "xla"
        with pytest.raises(NotImplementedError, match=f"head_dim {D}"):
            port_attention.attention_path(device, torch.bfloat16, T, H, D, int8)
    else:
        assert want == jax_path
        assert port_attention.attention_path(
            device, torch.bfloat16, T, H, D, int8) == want


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_attention_path_refuses_kernels_for_other_dtypes(int8):
    """fp16 has no kernel on the card: a CUDA call the JAX dispatch would
    send to a kernel raises; one it sends to the dense path still runs
    there; on the CPU fp16 routes as JAX does."""
    with pytest.raises(NotImplementedError, match="float16"):
        port_attention.attention_path("cuda", torch.float16, 256, 8, 128, int8)
    assert port_attention.attention_path("cuda", torch.float16, 256, 8, 64, int8) == "xla"
    assert port_attention.attention_path("cpu", torch.float16, 256, 8, 128,
                                         int8) == ("int8" if int8 else "flash")


@pytest.mark.parametrize("index", [0, 1])
@pytest.mark.parametrize("D", [32, 320])
def test_tp_dispatch_routes_on_the_models_heads(monkeypatch, D, index):
    """Under tensor parallelism with n_head equal to the model axis's size
    (2 heads at M = 2, one a rank), the port routes on the model's 2 heads
    as the JAX dispatch routes on cfg.n_head: the dense path at a head dim
    that is no multiple of 128, where the rank's one head alone would take
    the flash kernels (padded; at D = 320 the card raised there before).
    The call's numbers are the dense path's with the rank's mixed seed."""
    from omnibiote_tpu_torch.parallel.tensor import TensorParallel

    T, M = 256, 2
    assert _jax_path(monkeypatch, T, M, D, False) == "xla"
    routed = []
    real_path = port_attention.attention_path

    def path(device_type, dtype, T, H, D, int8, **kw):
        routed.append(H)
        # the route a CUDA tensor of these heads would take (it must not raise)
        cuda = real_path("cuda", torch.bfloat16, T, H, D, int8, **kw)
        got = real_path(device_type, dtype, T, H, D, int8, **kw)
        assert cuda == got
        return got

    monkeypatch.setattr(port_attention, "attention_path", path)
    seen = []
    tag = lambda name: (lambda q, *a, **k: (seen.append(name), q)[1])
    for name, attr in (("int8", "int8_flash_attention"), ("flash", "flash_attention"),
                       ("flash", "flash_attention_tp")):
        monkeypatch.setattr(port_attention, attr, tag(name))
    rng = np.random.default_rng(D + index)
    q, k, v = (torch.from_numpy(x) for x in rng.standard_normal((3, 1, T, 1, D)).astype(np.float32))
    tp = TensorParallel(None, index, M)
    got = port_attention.attention(q, k, v, scale=0.1, tp_mesh=tp, dropout_rate=0.1,
                                   dropout_seed=5)
    assert seen == [] and routed == [M]
    want = port_attention.xla_attention(q, k, v, scale=0.1, dropout_rate=0.1,
                                        dropout_seed=port_attention.tp_seed(5, index))
    assert torch.equal(got, want)


def test_cpu_route_at_head_dim_256_matches_jax():
    """D = 256 takes the flash route on the CPU as in JAX (the plain version
    there, the Pallas kernel in interpret mode here): fp32 o at rtol 2e-5 /
    atol 2e-5."""
    B, T, H, D = 1, 256, 2, 256
    q, k, v, seg = _inputs(B, T, H, D, "packed", seed=9)
    scale = 1.0 / np.sqrt(D)
    jcos, jsin = jax_rope_tables(D, T)
    with pltpu.force_tpu_interpret_mode():
        want = jax_attention.attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
            segment_ids=jnp.asarray(seg), rope=(jcos, jsin))
    assert port_attention.attention_path("cpu", torch.float32, T, H, D, False) == "flash"
    got = port_attention.attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale=scale,
        segment_ids=torch.from_numpy(seg), rope=rope_tables(D, T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal,segs", [(False, True), (True, False),
                                         (True, True)])
def test_xla_attention_matches_jax(causal, segs):
    """The dense twin of xla_attention, fp32 at rtol 2e-5 / atol 2e-5."""
    q, k, v, seg = _inputs(2, 96, 2, 32, "packed" if segs else "dense",
                           seed=4)
    want = jax_attention.xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.2,
        segment_ids=None if seg is None else jnp.asarray(seg), causal=causal)
    got = port_attention.xla_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=0.2, segment_ids=None if seg is None else torch.from_numpy(seg),
        causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("T,want", [(128, 128), (640, 128), (768, 384),
                                    (1024, 512), (4096, 512), (1536, 512)])
def test_fit_block_matches_jax(T, want):
    assert port_attention._fit_block(T, 512) == jax_attention._fit_block(T, 512)
    assert port_attention._fit_block(T, 512) == want


@pytest.mark.parametrize("kw", [dict(impl="ring"), dict(tp_mesh=object())])
def test_unported_modes_raise(kw):
    """Both modes are ported. Ring attention with no ring mesh is a ring of
    one (RoPE applied before it, the flash body): the flash path's output
    at fp32 rounding; a causal ring call raises, as in the JAX dispatch. A
    tensor-parallel call (tp_mesh: the rank's place on the model axis)
    runs flash_attention_tp on the rank's heads, the dropout seed mixed
    with the model-axis index, which at index 0 is the plain call's."""
    from omnibiote_tpu_torch.models.rope import rope_tables
    from omnibiote_tpu_torch.ops.flash_attention import tp_seed
    from omnibiote_tpu_torch.parallel.tensor import TensorParallel

    if "impl" in kw:
        g = torch.Generator().manual_seed(1)
        q, k, v = (torch.randn(2, 256, 2, 128, generator=g) for _ in range(3))
        seg = torch.cumsum((torch.rand(2, 256, generator=g) < 0.02).int(), 1).int()
        common = dict(scale=0.1, segment_ids=seg, rope=rope_tables(128, 256))
        got = port_attention.attention(q, k, v, **common, **kw)
        torch.testing.assert_close(got, port_attention.attention(q, k, v, **common),
                                   rtol=1e-5, atol=1e-5)
        with pytest.raises(ValueError, match="no causal support"):
            port_attention.attention(q, k, v, causal=True, **common, **kw)
        return
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 128, 2, 128, generator=g) for _ in range(3))
    common = dict(scale=0.1, dropout_rate=0.1, dropout_seed=77)
    for index in (0, 1):
        tp = TensorParallel(None, index, 2)
        got = port_attention.attention(q, k, v, tp_mesh=tp, **common)
        want = port_attention.attention(q, k, v, **dict(common, dropout_seed=tp_seed(77, index)))
        assert torch.equal(got, want)
    assert tp_seed(77, 0) == 77 and tp_seed(77, 1) == 77 ^ 0x9E3779B9


# ---------------------------------------------------------------------------
# RoPE tables and rotations, segment ids: exact twins of the JAX helpers
# ---------------------------------------------------------------------------

def test_rope_matches_jax():
    from omnibiote_tpu.models import rope as jax_rope
    from omnibiote_tpu_torch.models import rope as port_rope
    cos, sin = port_rope.rope_tables(64, 200, 500.0)
    jcos, jsin = jax_rope.rope_tables(64, 200, 500.0)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))
    np.testing.assert_array_equal(port_rope.qkv_col_perm(3, 64),
                                  jax_rope.qkv_col_perm(3, 64))
    rng = np.random.default_rng(7)
    q, k = rng.standard_normal((2, 2, 96, 3, 64)).astype(np.float32)
    for name in ("apply_rope", "apply_rope_half"):
        got = getattr(port_rope, name)(torch.from_numpy(q), torch.from_numpy(k),
                                       cos, sin)
        want = getattr(jax_rope, name)(jnp.asarray(q), jnp.asarray(k), jcos, jsin)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


def test_segments_match_jax():
    import omnibiote_tpu.ops.segments as jax_seg
    import omnibiote_tpu_torch.ops.segments as port_seg
    rng = np.random.default_rng(8)
    ids = rng.integers(4, 50, size=(3, 64)).astype(np.int32)
    ids[ids % 7 == 0] = 3                     # EOS
    ids[1, 40:] = 1                           # PAD tail
    t = torch.from_numpy(ids)
    np.testing.assert_array_equal(port_seg.segment_ids_np(ids),
                                  jax_seg.segment_ids_np(ids))
    np.testing.assert_array_equal(port_seg.segment_ids_torch(t).numpy(),
                                  np.asarray(jax_seg.segment_ids_jnp(jnp.asarray(ids))))
    np.testing.assert_array_equal(
        port_seg.padding_segment_ids_torch(t, 1).numpy(),
        np.asarray(jax_seg.padding_segment_ids_jnp(jnp.asarray(ids), 1)))
    np.testing.assert_array_equal(port_seg.padding_segment_ids_np(ids, 1),
                                  jax_seg.padding_segment_ids_np(ids, 1))
    seg = port_seg.segment_ids_np(ids)
    np.testing.assert_array_equal(
        port_seg.additive_mask(torch.from_numpy(seg)).numpy(),
        np.asarray(jax_seg.additive_mask(jnp.asarray(seg))))
    assert port_seg.NEG_INF == jax_seg.NEG_INF
