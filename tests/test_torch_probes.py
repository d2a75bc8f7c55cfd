"""PyTorch port vs the JAX package: the roofline probes.

The JAX probes run their whole timing when imported, so the kernels and
their launchers are taken from the unmodified scripts by `ast` (function
definitions only) and run in interpret mode on the CPU. The port's plain
versions are held against them, and in fp32 against float64 numpy formulas
of what each probe computes, including #11's kv-local rows and #13's
last-tile rule."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from omnibiote_tpu.ops.flash_attention import VMEM_LIMIT

from omnibiote_tpu_torch.ops import _kernels
from omnibiote_tpu_torch.probes import roofline, roofline2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, D = 2, 128
# bf16 outputs against the Pallas kernels: both round S and o to bf16
# after fp32 sums taken in another order, which can move one element by a
# bf16 ulp; held as chip_smoke.py's bf16 TOL, relative to max|o|.
TOL = 8e-3
# fp32 plain versions against float64 formulas: fp32 sums of a few hundred
# terms.
RTOL_F32 = 1e-5


@functools.lru_cache(maxsize=None)
def _jax_probes(script: str) -> dict:
    """The function definitions of tools/probes/<script>, and nothing of
    its module-level timing."""
    path = os.path.join(REPO, "tools", "probes", script)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
    ns = dict(functools=functools, jax=jax, jnp=jnp, pl=pl, pltpu=pltpu,
              VMEM_LIMIT=VMEM_LIMIT)
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    return ns


def _x(B, T, h=H, seed=0, n=1):
    """n arrays (B, T, h, D) of numpy-seeded normals x 0.1, float32 values
    exact in bf16."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, B, T, h, D)) * 0.1).astype(np.float32)
    return [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
            for a in x]


def _bf16(x):
    return torch.from_numpy(x).bfloat16()


def _jax(script, name, x, *args):
    with pltpu.force_tpu_interpret_mode():
        o = _jax_probes(script)[name](jnp.asarray(x, jnp.bfloat16), *args)
    return np.asarray(o.astype(jnp.float32))


def _hold(got, want):
    err = np.abs(got.float().numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,bq,bkv", [(1, 256, 128, 256), (1, 512, 256, 128),
                                        (2, 256, 128, 128)],
                         ids=["bq<bkv", "bq>bkv-4kv", "bq=bkv-2kv"])
def test_dots_only_matches_pallas(B, T, bq, bkv):
    (x,) = _x(B, T)
    want = _jax("roofline.py", "dots_only", x, bq, bkv)
    xt = _bf16(x)
    _hold(roofline.dots_only(xt, xt, xt, bq, bkv), want)


@pytest.mark.parametrize("B,T", [(1, 256), (2, 384)])
def test_fwd_products_matches_pallas(B, T):
    """#1's kernel with its products alone is `dots_only` on 128-row kv
    tiles: on the CPU its plain version, held against the Pallas probe."""
    (x,) = _x(B, T, seed=2)
    want = _jax("roofline.py", "dots_only", x, 128, 128)
    xt = _bf16(x)
    before = dict(_kernels.LAUNCHES)
    _hold(roofline.fwd_products(xt, xt, xt), want)
    assert _kernels.LAUNCHES == before


@pytest.mark.parametrize("T,bq,bkv,n_dots", [(512, 128, 256, 3), (256, 128, 128, 3),
                                             (512, 256, 256, 4)],
                         ids=["3dot-bq<bkv-2kv", "3dot-bq=bkv", "4dot-2kv"])
def test_dots_n_matches_pallas(T, bq, bkv, n_dots):
    (x,) = _x(1, T, seed=1)
    want = _jax("roofline.py", "dots_n", x, bq, bkv, n_dots)
    xt = _bf16(x)
    _hold(roofline.dots_n(xt, xt, xt, bq, bkv, n_dots), want)


@pytest.mark.parametrize("kt", [False, True], ids=["kt0", "kt1"])
def test_dots_matches_pallas(kt):
    T, bq, bkv = 256, 128, 128
    (x,) = _x(1, T, seed=2)
    want = _jax("roofline2.py", "dots", x, bq, bkv, kt)
    xt = _bf16(x)
    k = roofline2.transposed_k(xt) if kt else xt
    _hold(roofline2.dots(xt, k, xt, bq, bkv, kt), want)


@pytest.mark.parametrize("kt", [False, True], ids=["kt0", "kt1"])
def test_scores_matches_pallas_last_kv_tile(kt):
    T, bq, bkv = 512, 128, 256          # two kv tiles, bkv = H*D
    (x,) = _x(1, T, seed=3)
    want = _jax("roofline2.py", "scores", x, bq, bkv, kt)
    xt = _bf16(x)
    got = roofline2.scores(xt, roofline2.transposed_k(xt) if kt else xt, bq,
                           bkv, kt)
    _hold(got, want)
    # the first kv tile's scores are a different function
    first = roofline2.scores(xt[:, :bkv], xt[:, :bkv], bq, bkv, False)
    assert not np.allclose(first.float().numpy(), want[:, :bkv], atol=1e-2)


@pytest.mark.parametrize("T,kt", [(192, False), (320, True)], ids=["T192-kt0", "T320-kt1"])
def test_dots_ragged_t_matches_pallas(T, kt):
    """T a multiple of 64 but not of the kernel's 128-row kv tile: the plain
    version on the JAX probe's 64-wide blocks."""
    (x,) = _x(2, T, seed=T)
    want = _jax("roofline2.py", "dots", x, 64, 64, kt)
    xt = _bf16(x)
    _hold(roofline2.dots(xt, roofline2.transposed_k(xt) if kt else xt, xt, 64, 64, kt), want)


@pytest.mark.parametrize("kt", [False, True], ids=["kt0", "kt1"])
def test_scores_odd_heads_matches_pallas(kt):
    """H = 3: H*D = 384 output columns, not a multiple of the kernel's
    256-column tile."""
    (x,) = _x(1, 384, h=3, seed=9)
    want = _jax("roofline2.py", "scores", x, 128, 384, kt)
    xt = _bf16(x)
    _hold(roofline2.scores(xt, roofline2.transposed_k(xt) if kt else xt, 128, 384, kt),
          want)


# ---------------------------------------------------------------------------
# the plain versions in fp32 against float64 formulas
# ---------------------------------------------------------------------------

def _f64_dots(q, k, v):
    s = np.einsum("bihd,bjhd->bhij", q, k)
    return np.einsum("bhij,bjhd->bihd", s, v)


def _f64_dots_n(q, k, v, bq, bkv, n_dots):
    B, T, h, _ = q.shape
    o = np.zeros_like(q)
    for qt in range(T // bq):
        Q = q[:, qt * bq:(qt + 1) * bq]
        for kt in range(T // bkv):
            j = kt * bkv
            K, V = k[:, j:j + bq], v[:, j:j + bq]            # kv-local r < bq
            S = (np.einsum("bihd,brhd->bhir", Q, K)
                 + np.einsum("bihd,brhd->bhir", Q, V))
            rhs = Q + (v[:, j:j + bq] if n_dots == 4 else 0.0)
            o[:, qt * bq:(qt + 1) * bq] += np.einsum("bhir,bihd->brhd", S, rhs)
    return o


def _f64_scores(q, k, bkv):
    B, T, h, _ = q.shape
    kc = k[:, T - bkv:T - bkv + h * D]                      # (B, H*D, h, D)
    return np.einsum("bihd,bchd->bic", q, kc).reshape(B, T, h, D)


def _hold64(got, want):
    err = np.abs(got.numpy().astype(np.float64) - want).max()
    assert err <= RTOL_F32 * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("B,T,bq,bkv", [(2, 128, 64, 32), (1, 256, 256, 64)])
def test_dots_plain_fp32_matches_formula(B, T, bq, bkv):
    q, k, v = _x(B, T, seed=4, n=3)
    f64 = [a.astype(np.float64) for a in (q, k, v)]
    t = [torch.from_numpy(a) for a in (q, k, v)]
    want = _f64_dots(*f64)
    _hold64(roofline.dots_only(*t, bq, bkv), want)
    _hold64(roofline2.dots(t[0], roofline2.transposed_k(t[1]), t[2], bq, bkv,
                           True), want)


@pytest.mark.parametrize("T,bq,bkv,n_dots", [(256, 32, 64, 3), (256, 64, 64, 3),
                                             (128, 32, 32, 4)])
def test_dots_n_plain_fp32_matches_formula(T, bq, bkv, n_dots):
    q, k, v = _x(2, T, seed=5, n=3)
    want = _f64_dots_n(*(a.astype(np.float64) for a in (q, k, v)), bq, bkv, n_dots)
    got = roofline.dots_n(*(torch.from_numpy(a) for a in (q, k, v)), bq, bkv,
                          n_dots)
    _hold64(got, want)


@pytest.mark.parametrize("h,T,bkv,kt", [(1, 512, 256, False), (1, 512, 256, True),
                                        (2, 512, 256, True)])
def test_scores_plain_fp32_matches_formula(h, T, bkv, kt):
    q, k = _x(2, T, h=h, seed=6, n=2)
    want = _f64_scores(q.astype(np.float64), k.astype(np.float64), bkv)
    kx = torch.from_numpy(k)
    got = roofline2.scores(torch.from_numpy(q),
                           roofline2.transposed_k(kx) if kt else kx, 64, bkv, kt)
    _hold64(got, want)


@pytest.mark.parametrize("B,T", [(1, 256), (2, 128)])
def test_bwd_products_plain_fp32_matches_formula(B, T):
    """The fused backward's products alone: in fp32 (no rounding between
    the products) against float64 einsums of dq = (v doᵀ)ᵀ k, dk = (v doᵀ)
    q and dv = (k qᵀ) do per head; a CPU tensor launches nothing."""
    q, k, v, do = _x(B, T, seed=8, n=4)
    s = np.einsum("bjhd,bihd->bhji", k.astype(np.float64), q.astype(np.float64))
    ds = np.einsum("bjhd,bihd->bhji", v.astype(np.float64), do.astype(np.float64))
    want = (np.einsum("bhji,bjhd->bihd", ds, k), np.einsum("bhji,bihd->bjhd", ds, q),
            np.einsum("bhji,bihd->bjhd", s, do))
    before = dict(_kernels.LAUNCHES)
    got = roofline.bwd_products(*(torch.from_numpy(a) for a in (q, k, v, do)))
    assert _kernels.LAUNCHES == before
    for g, w in zip(got, want):
        _hold64(g, w)


@pytest.mark.parametrize("kind", ["dkv", "dq"])
@pytest.mark.parametrize("B,T", [(1, 256), (2, 128)])
def test_split_products_plain_fp32_matches_formula(kind, B, T):
    """The split pair's products alone: in fp32 against float64 einsums
    per head, dk = (v doᵀ) q and dv = (k qᵀ) do for the dkv kernel, dq =
    (q kᵀ + do vᵀ) k for the dq kernel; a CPU tensor launches nothing, and
    a T off the kernel's tiles is refused."""
    q, k, v, do = _x(B, T, seed=9, n=4)
    q64, k64, v64, do64 = (a.astype(np.float64) for a in (q, k, v, do))
    if kind == "dkv":
        s = np.einsum("bjhd,bihd->bhji", k64, q64)
        ds = np.einsum("bjhd,bihd->bhji", v64, do64)
        want = (np.einsum("bhji,bihd->bjhd", ds, q64), np.einsum("bhji,bihd->bjhd", s, do64))
        fn = roofline.dkv_products
    else:
        ds = np.einsum("bihd,bjhd->bhij", q64, k64) + np.einsum("bihd,bjhd->bhij", do64, v64)
        want = (np.einsum("bhij,bjhd->bihd", ds, k64),)
        fn = lambda *a: (roofline.dq_products(*a),)
    before = dict(_kernels.LAUNCHES)
    got = fn(*(torch.from_numpy(a) for a in (q, k, v, do)))
    assert _kernels.LAUNCHES == before
    for g, w in zip(got, want):
        _hold64(g, w)
    with pytest.raises(ValueError, match="must divide"):
        fn(*(torch.from_numpy(a[:, :64]) for a in (q, k, v, do)))


@pytest.mark.parametrize("B,H_,T", [(1, 2, 128), (2, 1, 384)])
def test_int8_products_plain_matches_an_int64_product(B, H_, T):
    """#9's products alone: o = m + p8·v8 per head, with S = q8·k8ᵀ, m its
    row max and p8 its low byte as an int8, against int64 numpy on random
    int8 operands; v8t comes in the kernel's layout and its natural order is
    what counts. A CPU tensor launches nothing."""
    from omnibiote_tpu_torch.ops.int8_attention import int8_kernel_layout

    rng = np.random.default_rng(T + B)
    q8, k8, v8 = (rng.integers(-127, 128, size=(B, H_, T, D)).astype(np.int8)
                  for _ in range(3))
    v8t = int8_kernel_layout(None, None, None, None,
                             torch.from_numpy(np.ascontiguousarray(
                                 v8.transpose(0, 1, 3, 2))), None)[4]
    s = np.einsum("bhid,bhjd->bhij", q8.astype(np.int64), k8.astype(np.int64))
    p8 = (s + 128) % 256 - 128
    want = (np.einsum("bhij,bhjd->bhid", p8, v8.astype(np.int64))
            + s.max(-1, keepdims=True)).transpose(0, 2, 1, 3)
    before = dict(_kernels.LAUNCHES)
    got = roofline.int8_products(torch.from_numpy(q8), torch.from_numpy(k8), v8t)
    assert _kernels.LAUNCHES == before
    assert got.dtype == torch.int32 and got.shape == (B, T, H_, D)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="multiple of 128"):
        roofline.int8_products(*(torch.from_numpy(x[:, :, :64]) for x in (q8, k8)),
                               v8t[..., :64])


# ---------------------------------------------------------------------------
# the block combinations the JAX probes cannot take, CPU routing, main()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["3dot-bq>bkv", "4dot-bq!=bkv", "scores-bkv<HD"])
def test_rejected_blocks_raise_as_in_jax(case):
    T = 256
    (x,) = _x(1, T, seed=7)
    xt = _bf16(x)
    script, name, args, port = {
        "3dot-bq>bkv": ("roofline.py", "dots_n", (128, 64, 3),
                        lambda: roofline.dots_n(xt, xt, xt, 128, 64, 3)),
        "4dot-bq!=bkv": ("roofline.py", "dots_n", (64, 128, 4),
                         lambda: roofline.dots_n(xt, xt, xt, 64, 128, 4)),
        "scores-bkv<HD": ("roofline2.py", "scores", (64, 128, False),
                          lambda: roofline2.scores(xt, xt, 64, 128, False)),
    }[case]
    with pytest.raises(Exception):
        _jax(script, name, x, *args)
    with pytest.raises(ValueError):
        port()


def test_blocks_must_divide_t_and_cta_is_built():
    xt = _bf16(_x(1, 256)[0])
    with pytest.raises(ValueError, match="divide"):
        roofline.dots_only(xt, xt, xt, 96, 128)
    with pytest.raises(ValueError, match="cta_q"):
        roofline2.dots(xt, xt, xt, 128, 128, False, cta_q=32)
    with pytest.raises(ValueError, match="n_dots"):
        roofline.dots_n(xt, xt, xt, 128, 128, 2)


def test_cpu_tensors_take_the_plain_versions():
    _kernels.reset_launches()
    xt = _bf16(_x(1, 256)[0])
    kx = roofline2.transposed_k(xt)
    roofline.dots_only(xt, xt, xt, 128, 128)
    roofline.dots_n(xt, xt, xt, 128, 128, 4)
    roofline2.dots(xt, kx, xt, 128, 128, True)
    roofline2.scores(xt, kx, 128, 256, True)
    assert all(n == 0 for name, n in _kernels.LAUNCHES.items()
               if name.startswith("roofline")), _kernels.LAUNCHES


@pytest.mark.parametrize("mod", [roofline, roofline2], ids=["roofline", "roofline2"])
def test_main_needs_a_gpu(mod):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()
