"""PyTorch port vs the JAX package: the plain version of the int8 serving
attention against `int8_flash_attention` (Pallas, interpret mode on the
CPU), its prologue's integers, the dispatch's int8 branch, `attn_int8`
through the whole model, and the final-max property of its P quantisation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import omnibiote_tpu as obt
import omnibiote_tpu.ops.attention as jax_attention
import omnibiote_tpu.ops.int8_attention as jax_int8
from omnibiote_tpu.models.rope import rope_tables as jax_rope_tables

import omnibiote_tpu_torch as port
import omnibiote_tpu_torch.ops.attention as port_attention
import omnibiote_tpu_torch.ops.int8_attention as port_int8
from omnibiote_tpu_torch.models.rope import rope_tables
from omnibiote_tpu_torch.ops import _kernels
from omnibiote_tpu_torch.utils import convert

H, D = 2, 128
SCALE = 1.0 / np.sqrt(D)


def _segments(rng, B, T, layout):
    if layout == "dense":
        return None
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        if layout == "packed":
            cuts = np.sort(rng.choice(np.arange(8, T - 8), 3, replace=False))
            seg[b] = np.searchsorted(cuts, np.arange(T), side="right")
        else:
            seg[b, int(rng.integers(T // 4, T - 8)):] = -1
    return seg


def _inputs(B, T, layout, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = rng.standard_normal((3, B, T, H, D)).astype(np.float32)
    return q, k, v, _segments(rng, B, T, layout)


def _jax_int8(q, k, v, seg, use_rope, block_q, dtype=jnp.float32):
    T = q.shape[1]
    rope = jax_rope_tables(D, T) if use_rope else None
    with pltpu.force_tpu_interpret_mode():
        o = jax_int8.int8_flash_attention(
            jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
            scale=SCALE, segment_ids=None if seg is None else jnp.asarray(seg),
            block_q=block_q, rope=rope)
    return np.asarray(o.astype(jnp.float32))


def _port_int8(q, k, v, seg, use_rope, block_q, dtype=torch.float32):
    T = q.shape[1]
    t = lambda x: torch.from_numpy(x).to(dtype)
    o = port_int8.int8_flash_attention(
        t(q), t(k), t(v), scale=SCALE,
        segment_ids=None if seg is None else torch.from_numpy(seg),
        block_q=block_q, rope=rope_tables(D, T) if use_rope else None)
    return o.float().numpy()


def _hold_int8(got, want):
    """Both sides run the same arithmetic on the same integers, but exp2 and
    the fp32 sums differ in the last bits between XLA and PyTorch, which can
    move a round(p * 127) by one step: 1/127 of one key's weight, against a
    row of ~T keys. Outputs of |o| <= ~1 are held to 2e-3 absolute, and all
    but 1 % of them to 1e-5."""
    diff = np.abs(got.astype(np.float64) - want)
    assert diff.max() <= 2e-3, diff.max()
    assert (diff > 1e-5).mean() < 0.01, (diff > 1e-5).mean()


@pytest.mark.parametrize("block_q", [128, None], ids=["bq128", "bqT"])
@pytest.mark.parametrize("use_rope", [True, False], ids=["rope", "norope"])
@pytest.mark.parametrize("layout", ["packed", "padded", "dense"])
@pytest.mark.parametrize("T", [128, 256, 640])
def test_plain_matches_jax_int8(T, layout, use_rope, block_q):
    q, k, v, seg = _inputs(2, T, layout, seed=T)
    bq = T if block_q is None else block_q
    want = _jax_int8(q, k, v, seg, use_rope, bq)
    got = _port_int8(q, k, v, seg, use_rope, bq)
    assert got.shape == want.shape == (2, T, H, D)
    _hold_int8(got, want)


def test_plain_matches_jax_int8_bf16():
    """bf16 inputs: the same function on the bf16-rounded values; o rounded
    to bf16 on both sides (one bf16 ulp at |o| ~ 1 is 8e-3)."""
    q, k, v, seg = _inputs(2, 256, "packed", seed=9)
    want = _jax_int8(q, k, v, seg, True, 128, jnp.bfloat16)
    got = _port_int8(q, k, v, seg, True, 128, torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=0, atol=8e-3)
    assert (np.abs(got - want) > 0).mean() < 0.01


@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_plain_vs_fp32_dense_attention(layout):
    """The serving bar of the JAX tests: cosine > 0.9995 against the fp32
    dense attention."""
    q, k, v, seg = _inputs(2, 256, layout, seed=40)
    got = _port_int8(q, k, v, seg, False, 128).astype(np.float64).ravel()
    ref = port_attention.xla_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=SCALE, segment_ids=None if seg is None else torch.from_numpy(seg))
    ref = ref.numpy().astype(np.float64).ravel()
    assert got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)) > 0.9995


@pytest.mark.parametrize("use_rope", [True, False], ids=["rope", "norope"])
def test_prologue_integers(use_rope):
    """int8_quantize_plain against the definition written out with numpy:
    q8, k8, v8 are the rounded quotients, the scales max|x| / 127 per
    (token, head) and, for v, per channel over all T tokens."""
    q, k, v, _ = _inputs(2, 128, "dense", seed=3)
    rope = rope_tables(D, 128) if use_rope else None
    q8, sq, k8, sk, v8t, sv = port_int8.int8_quantize_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), rope)
    assert q8.shape == k8.shape == (2, H, 128, D) and q8.dtype == torch.int8
    assert v8t.shape == (2, H, D, 128) and sv.shape == (2, H, D)
    assert sq.shape == sk.shape == (2, H, 128)
    if not use_rope:
        for x, x8, s in ((q, q8, sq), (k, k8, sk)):
            xs = np.abs(x).max(-1) * np.float32(1.0 / 127.0)        # (B, T, H)
            np.testing.assert_array_equal(s.numpy(), xs.transpose(0, 2, 1))
            want = np.rint(x / xs[..., None]).astype(np.int8)
            np.testing.assert_array_equal(x8.numpy(), want.transpose(0, 2, 1, 3))
    vs = np.abs(v).max(1) * np.float32(1.0 / 127.0)                 # (B, H, D)
    np.testing.assert_array_equal(sv.numpy(), vs)
    np.testing.assert_array_equal(
        v8t.numpy(), np.rint(v / vs[:, None]).astype(np.int8).transpose(0, 2, 3, 1))
    assert int(q8.abs().max()) == int(v8t.abs().max()) == 127
    # a zero row and a zero channel get scale 1 and zeros
    z = torch.zeros(1, 128, 1, D)
    z8, sz, _, _, zv, szv = port_int8.int8_quantize_plain(z, z, z)
    assert sz.eq(1).all() and szv.eq(1).all() and not z8.any() and not zv.any()


def test_p_is_quantized_against_the_final_row_max():
    """Keys in two halves: the second half's scores dominate. Quantizing P
    per kv block against a running max and rescaling (an online softmax)
    keeps first-half weights that round(p * 127) against the final max
    rounds to zero. The plain version must agree with the final-max
    definition and differ from the running-max one."""
    rng = np.random.default_rng(11)
    T = 256
    q, k, v = rng.standard_normal((3, 1, T, 1, D)).astype(np.float32)
    k[:, T // 2:] = q[:, :1] * 4.0 + 0.1 * k[:, T // 2:]     # late keys score high
    v[:, :T // 2] += 3.0                                       # early values stand out
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = port_int8.int8_flash_attention_plain(tq, tk, tv, scale=SCALE)

    q8, sq, k8, sk, v8t, sv = port_int8.int8_quantize_plain(tq, tk, tv)
    s2 = ((q8.int() @ k8.int().transpose(2, 3)).float()
          * (sq[..., None] * float(np.float32(SCALE * port_int8.LOG2E))) * sk[:, :, None])
    v32 = v8t.int().transpose(2, 3).double()

    def run(blocks):
        """P quantized block by block against the max seen so far."""
        m = torch.full_like(s2[..., :1], -float("inf"))
        acc = torch.zeros(1, 1, T, D, dtype=torch.float64)
        l = torch.zeros_like(m)
        for lo, hi in blocks:
            m_new = torch.maximum(m, s2[..., lo:hi].amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s2[..., lo:hi] - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.round(p * 127.0).double() @ v32[:, :, lo:hi]
            m = m_new
        return (acc.float() * (sv[:, :, None] * (1.0 / 127.0)) / l).permute(0, 2, 1, 3)

    final_max = run([(0, T)])
    running_max = run([(0, T // 2), (T // 2, T)])
    np.testing.assert_allclose(got.numpy(), final_max.numpy(), rtol=1e-5, atol=1e-6)
    assert (got - running_max).abs().max() > 100 * (got - final_max).abs().max()
    assert (got - running_max).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _routes(monkeypatch, T, Dh, **kw):
    """Which function each package's attention() reaches."""
    seen = {"jax": [], "port": []}
    tag = lambda side, name: (lambda q, *a, **k: (seen[side].append(
        (name, k.get("block_q"))), q)[1])
    monkeypatch.setattr(jax_int8, "int8_flash_attention", tag("jax", "int8"))
    monkeypatch.setattr("omnibiote_tpu.ops.flash_attention.flash_attention",
                        tag("jax", "flash"))
    monkeypatch.setattr(jax_attention, "xla_attention", tag("jax", "xla"))
    monkeypatch.setattr(port_attention, "int8_flash_attention", tag("port", "int8"))
    monkeypatch.setattr(port_attention, "flash_attention", tag("port", "flash"))
    monkeypatch.setattr(port_attention, "xla_attention", tag("port", "xla"))
    x = np.zeros((1, T, 2, Dh), np.float32)
    jkw = dict(kw)
    if jkw.get("dropout_rate"):
        jkw["dropout_rng"] = jax.random.PRNGKey(0)
        kw = dict(kw, dropout_seed=1)
    jax_attention.attention(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                            scale=0.1, **jkw)
    t = torch.from_numpy(x)
    port_attention.attention(t, t, t, scale=0.1, **kw)
    return seen


@pytest.mark.parametrize("T,Dh,kw,want", [
    (256, 128, dict(int8=True), ("int8", 256)),
    (1024, 128, dict(int8=True), ("int8", 512)),
    (640, 128, dict(int8=True), ("int8", 128)),            # _fit_block
    (2048, 128, dict(int8=True), ("int8", 512)),           # no upper limit on T
    (256, 128, dict(int8=True, block_q=128), ("int8", 128)),
    (256, 128, dict(int8=False), ("flash", 256)),
    (256, 128, dict(int8=True, dropout_rate=0.1), ("flash", 256)),   # training
    (256, 128, dict(int8=True, causal=True), ("xla", None)),
    (256, 128, dict(int8=True, impl="xla"), ("xla", None)),
    (200, 128, dict(int8=True), ("xla", None)),            # T % 128 != 0
    (256, 64, dict(int8=True), ("xla", None)),             # narrow heads
])
def test_int8_dispatch_matches_jax(monkeypatch, T, Dh, kw, want):
    seen = _routes(monkeypatch, T, Dh, **kw)
    assert seen["port"] == seen["jax"] == [want]


def test_dispatch_runs_the_plain_version_on_a_cpu_tensor(monkeypatch):
    """attention(int8=True) on CPU tensors gives the plain version's result
    and touches no kernel library; the kernel's own entry refuses a CPU
    tensor instead of falling back."""
    def refuse(*a, **k):
        raise AssertionError("the kernel library was touched")

    monkeypatch.setattr(_kernels, "load_library", refuse)
    before = dict(_kernels.LAUNCHES)
    q, k, v, seg = _inputs(1, 128, "padded", seed=5)
    tq, tk, tv, ts = (torch.from_numpy(x) for x in (q, k, v, seg))
    rope = rope_tables(D, 128)
    got = port_attention.attention(tq, tk, tv, scale=SCALE, segment_ids=ts,
                                   rope=rope, int8=True)
    want = port_int8.int8_flash_attention_plain(
        tq, tk, tv, scale=SCALE, segment_ids=ts, rope=rope)
    assert torch.equal(got, want) and _kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        port_int8.int8_flash_attention_kernel(tq, tk, tv, scale=SCALE)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        port_int8.int8_quantize_kernel(tq, tk, tv)
    with pytest.raises(ValueError, match="does not divide"):
        port_int8.int8_flash_attention_plain(tq, tk, tv, scale=SCALE, block_q=96)
    with pytest.raises(NotImplementedError, match="no backward"):
        port_int8.int8_flash_attention_kernel(tq.requires_grad_(), tk, tv, scale=SCALE)


# ---------------------------------------------------------------------------
# Through the model
# ---------------------------------------------------------------------------

def test_attn_int8_through_the_model_matches_jax():
    """forward(return_embeddings) with attn_int8=True in both packages (the
    JAX tests' configuration): the int8 kernel's p8 can move by one step
    where exp2 differs in the last bit, so embeddings of |e| ~ 1 are held
    to 5e-3 absolute, and to a cosine of 0.999 against the fp32 forward."""
    base = dict(n_layer=2, n_head=2, n_embd=256, block_size=256, vocab_size=512,
                dropout=0.0, attn_impl="flash", compute_dtype="float32",
                param_dtype="float32", mup_base_n_embd=128)
    jcfg, pcfg = obt.OmniBioTAConfig(**base), port.OmniBioTAConfig(**base)
    params = obt.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(4, 500, size=(2, 256)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(obt.forward(params, jcfg.replace(attn_int8=True),
                                      jnp.asarray(toks), return_embeddings=True))
    model = port.OmniBioTA(pcfg.replace(attn_int8=True), device="cpu").eval()
    state = convert.state_from_jax_params(jax.tree.map(np.asarray, params), pcfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    with torch.no_grad():
        got = model(torch.from_numpy(toks), return_embeddings=True).numpy()
        model.cfg = pcfg.replace(attn_impl="xla")
        ref = model(torch.from_numpy(toks), return_embeddings=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
    a, b = got.astype(np.float64).ravel(), ref.astype(np.float64).ravel()
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999
    assert np.abs(got - ref).max() > 0          # the int8 branch was taken
