"""PyTorch port vs the JAX package: the executed-FLOP accounting
(`attention_tile_fraction`, `flash_skip_fractions`,
`flops_per_token_executed`), and the port's own `kernel_skip_fractions`
against a brute-force count over its `seg_block_bounds` at the kernels'
tiles (`kernel_tiles`, at head dims 128 and 256).

Layouts: random packed rows from a numpy seed, T 256-4096, 1-6 EOS a row,
some rows with a PAD tail after their last EOS; segment ids as the loader
makes them (`segment_ids_np`). The functions are numpy on both sides, so
they must agree exactly."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import numpy as np
import pytest
import torch

from omnibiote_tpu.training import metrics as jax_metrics

from omnibiote_tpu_torch.config import EOS_TOKEN, PAD_TOKEN
from omnibiote_tpu_torch.ops.flash_attention import kernel_tiles, seg_block_bounds
from omnibiote_tpu_torch.ops.segments import segment_ids_np
from omnibiote_tpu_torch.training import metrics as port_metrics

N_PARAMS, N_LAYER, N_EMBD = 168_000_000, 8, 1024


def _layout(B, T, seed):
    """(B, T) segment ids: 1-6 EOS a row at random positions, and on odd
    rows a PAD tail after the last EOS."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(20, 65000, size=(B, T)).astype(np.int32)
    for r in range(B):
        eos = np.sort(rng.choice(np.arange(8, T - 8), size=int(rng.integers(1, 7)),
                                 replace=False))
        toks[r, eos] = EOS_TOKEN
        if r % 2:
            toks[r, eos[-1] + 1:] = PAD_TOKEN
    return segment_ids_np(toks)


LAYOUTS = [(4, 256, 0), (3, 512, 1), (4, 1024, 2), (2, 2048, 3), (2, 4096, 4)]


@pytest.mark.parametrize("B,T,seed", LAYOUTS)
def test_flop_functions_match_jax(B, T, seed):
    seg = _layout(B, T, seed)
    for bq, bkv in ((128, 128), (64, 128), (128, 64), (min(512, T), T)):
        assert (port_metrics.attention_tile_fraction(seg, bq, bkv)
                == jax_metrics.attention_tile_fraction(seg, bq, bkv))
    assert port_metrics.flash_skip_fractions(seg) == jax_metrics.flash_skip_fractions(seg)
    for segments, impl in ((seg, "flash"), (None, "flash"), (seg, "xla")):
        kw = dict(vocab_size=65536, capacity_frac=0.25, segments=segments,
                  attn_impl=impl)
        assert (port_metrics.flops_per_token_executed(N_PARAMS, N_LAYER, N_EMBD, T, **kw)
                == jax_metrics.flops_per_token_executed(N_PARAMS, N_LAYER, N_EMBD, T, **kw))
    assert (port_metrics.flops_per_token(N_PARAMS, N_LAYER, N_EMBD, T)
            == jax_metrics.flops_per_token(N_PARAMS, N_LAYER, N_EMBD, T))


def _walked_fraction(seg, owner_tile, walked_tile):
    """Tiles a kernel owning `owner_tile` rows walks over its bounds (an
    owner block with an empty range walks one masked tile), as a fraction
    of every (owner, walked) tile."""
    s = torch.from_numpy(seg)
    lo, hi = seg_block_bounds(s, s, owner_tile, walked_tile)
    T = seg.shape[1]
    total = seg.shape[0] * (T // owner_tile) * (T // walked_tile)
    return int((hi - lo + 1).sum()) / total


# (dtype, B, T, seed, head dim): every layout at both dtypes at D = 128,
# and at D = 256, whose kernels walk other tiles
SKIP_CASES = [pytest.param(dtype, *layout, head_dim,
                           id=f"dtype{i}-{'-'.join(map(str, layout))}"
                           + ("" if head_dim == 128 else f"-d{head_dim}"))
              for head_dim in (128, 256)
              for i, dtype in enumerate((torch.bfloat16, torch.float32))
              for layout in LAYOUTS]


@pytest.mark.parametrize("dtype,B,T,seed,head_dim", SKIP_CASES)
def test_kernel_skip_fractions_count_the_kernels_tiles(dtype, B, T, seed, head_dim):
    seg = _layout(B, T, seed)
    fq, fkv = kernel_tiles("fwd", dtype, head_dim)
    bq, bkv = kernel_tiles("fused", dtype, head_dim)
    kq, kkv = kernel_tiles("dkv", dtype, head_dim)
    dq, dkv = kernel_tiles("dq", dtype, head_dim)
    e_fwd = _walked_fraction(seg, fq, fkv)
    e_fused = _walked_fraction(seg, bkv, bq)
    e_dkv, e_dq = _walked_fraction(seg, kkv, kq), _walked_fraction(seg, dq, dkv)
    got = port_metrics.kernel_skip_fractions(seg, dtype, head_dim=head_dim)
    assert got == pytest.approx((e_fwd, e_fused), rel=1e-12)
    split = port_metrics.kernel_skip_fractions(seg, dtype, fused=False, head_dim=head_dim)
    assert split == pytest.approx((e_fwd, (3 * e_dkv + e_dq) / 4), rel=1e-12)
    assert 0.0 < min(*got, *split) and max(*got, *split) <= 1.0


def test_executed_flops_take_the_kernels_fractions():
    """With fractions given, the attention term is credited by them alone;
    one segment a row walks every tile and credits only the MLM head."""
    seg = _layout(4, 1024, 7)
    T = seg.shape[1]
    fr = port_metrics.kernel_skip_fractions(seg, torch.bfloat16)
    got = port_metrics.flops_per_token_executed(N_PARAMS, N_LAYER, N_EMBD, T,
                                                fractions=fr)
    nominal = port_metrics.flops_per_token(N_PARAMS, N_LAYER, N_EMBD, T)
    head = 6.0 * N_EMBD * 65536 * 0.75
    attn = 12.0 * N_LAYER * N_EMBD * T
    assert got == pytest.approx(nominal - head - attn * (1 - (fr[0] + 2 * fr[1]) / 3),
                                rel=1e-12)
    dense = np.zeros((2, T), np.int32)
    assert port_metrics.kernel_skip_fractions(dense, torch.bfloat16) == (1.0, 1.0)
    assert port_metrics.flops_per_token_executed(
        N_PARAMS, N_LAYER, N_EMBD, T, fractions=(1.0, 1.0)) == nominal - head
