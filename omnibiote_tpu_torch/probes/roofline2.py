"""Roofline part 2: the score product of depth 128 on the H100.

Port of `tools/probes/roofline2.py`. Two probes, each a CUDA kernel
(`ops/csrc/roofline_probes.cu`) with its plain PyTorch version beside it:

  * `dots` (`_dots_kernel`, roofline2.py:68): the function of
    `roofline.dots_only`, with k either (B, T, H, D) or, kt=True,
    pre-transposed (B, H*D, T). The kernel's K tile then arrives as
    [head dim][kv] rows and the score product reads it MN-major, through
    wgmma's transpose bit: does the transposed contraction cost anything?
  * `scores` (`_sc_kernel`, roofline2.py:138): o[b, i, c] =
    round(Σ_h (q_h k_hᵀ)[i, c]) over the *last* kv tile only (columns
    T - block_kv + c, c < H*D; each kv step of the TPU kernel overwrote the
    output block, so the last one stays), summed over heads in fp32; o is
    (B, T, H, D), read as (B, T, H*D). block_kv < H*D raises ValueError, as
    the JAX probe cannot take it. It is one GEMM a batch row, o[b] =
    x[b]·x[b, j0 : j0 + H*D]ᵀ of depth H*D, and its kernel (`scores_wgmma`)
    is a Hopper GEMM: cta_q × 256 output tiles, a TMA ring of 64-deep
    steps, wgmma m64n256k16, persistent CTAs.

A CUDA tensor runs the kernel, a CPU tensor the plain version; `cta_q` as
in `roofline`.

    python -m omnibiote_tpu_torch.probes.roofline2

prints the JAX probe's table at its shape (B=8, T=1024, H=8, D=128, bf16).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .roofline import (CTA_ROWS, PROBE_SHAPE, _check_cta, check_blocks,
                       check_kernel_inputs, dots_kernel, dots_plain_heads,
                       launch, normal_bf16, report)

# The score kernel's tile: cta_q rows x SCORES_N_TILE output columns, walked
# SCORES_K_STEP deep. Copies of kScN and kScK in ops/csrc/roofline_probes.cu
# for the CPU mirror of the walk (tests/test_torch_probe_tiles.py); no launch
# reads them. chip_smoke.py phase 11 holds them against the built library
# (`obt_roofline_tile`).
SCORES_N_TILE = 256
SCORES_K_STEP = 64


def _k_heads(k, kt: bool, B: int, T: int, H: int, D: int):
    """k per head and transposed, (B, H, D, T), from either layout."""
    return k.reshape(B, H, D, T) if kt else k.permute(0, 2, 3, 1)


def _check_scores(T: int, HD: int, block_q: int, block_kv: int) -> None:
    check_blocks(T, block_q, block_kv)
    if block_kv < HD:
        raise ValueError(f"block_kv={block_kv} < H*D={HD}: the output's "
                         "H*D columns would leave the kv tile")


def dots_plain(q, k, v, block_q: int, block_kv: int, kt: bool):
    """Plain version of `dots`: q, v (B, T, H, D), k as `dots` takes it."""
    B, T, H, D = q.shape
    check_blocks(T, block_q, block_kv)
    return dots_plain_heads(q, _k_heads(k, kt, B, T, H, D), v, block_kv)


def scores_plain(q, k, block_q: int, block_kv: int, kt: bool):
    """Plain version of `scores`: q (B, T, H, D), k as `dots` takes it."""
    B, T, H, D = q.shape
    _check_scores(T, H * D, block_q, block_kv)
    j0 = T - block_kv
    kc = _k_heads(k, kt, B, T, H, D)[..., j0:j0 + H * D].float()
    qh = q.permute(0, 2, 1, 3).float()
    acc = torch.zeros((B, T, H * D), dtype=torch.float32, device=q.device)
    for h in range(H):
        acc += torch.matmul(qh[:, h], kc[:, h])
    return acc.to(q.dtype).reshape(B, T, H, D)


def scores_kernel(q, k, block_kv: int, kt: bool, *, cta_q: int):
    """Launch the score kernel on CUDA tensors (blocks and cta_q checked by
    `scores`): one persistent CTA a multiprocessor walking the output
    tiles; counts LAUNCHES['roofline2_scores']."""
    B, T, H, D = q.shape
    check_kernel_inputs(q, (("k", k, (B, H * D, T) if kt else q.shape),))
    if T % cta_q:
        raise ValueError(f"T={T} must be a multiple of cta_q={cta_q}")
    return launch("obt_roofline_scores", "roofline2_scores", q, (k,),
                  block_kv, int(kt), cta_q)


def dots(q, k, v, block_q: int, block_kv: int, kt: bool, *, cta_q: int = 64):
    """`roofline.dots_only` with k (B, T, H, D) or, kt, (B, H*D, T)."""
    check_blocks(q.shape[1], block_q, block_kv)
    _check_cta(cta_q)
    if q.is_cuda:
        return dots_kernel(q, k, v, kt=kt, cta_q=cta_q,
                           counter="roofline2_dots")
    return dots_plain(q, k, v, block_q, block_kv, kt)


def scores(q, k, block_q: int, block_kv: int, kt: bool, *, cta_q: int = 64):
    """Σ_h q_h k_hᵀ over the last kv tile's first H*D columns:
    o (B, T, H, D)."""
    B, T, H, D = q.shape
    _check_scores(T, H * D, block_q, block_kv)
    _check_cta(cta_q)
    if q.is_cuda:
        return scores_kernel(q, k, block_kv, kt, cta_q=cta_q)
    return scores_plain(q, k, block_q, block_kv, kt)


def transposed_k(x):
    """x (B, T, H, D) as the pre-transposed k of kt=True, (B, H*D, T)."""
    B, T, H, D = x.shape
    return x.reshape(B, T, H * D).transpose(1, 2).contiguous()


def main() -> dict:
    """Print roofline2.py's table on the card; returns {line: ms}."""
    dev = resolve_device(None)
    B, T, H, D = (PROBE_SHAPE[n] for n in "BTHD")
    rng = np.random.default_rng(0)
    q = normal_bf16(rng, (B, T, H, D), dev)
    fwd_flops = 4.0 * B * H * T * T * D
    score_flops = 2.0 * B * H * T * T * D
    table = {}

    print(f"== roofline2 @ B={B} T={T} H={H} D={D} bf16 on "
          f"{torch.cuda.get_device_name(dev)} ==")
    qb = q.permute(0, 2, 1, 3).reshape(B * H, T, D)
    qbt = qb.transpose(1, 2)
    report(table, "torch.matmul scores+pv (BH,T,128)",
           lambda: torch.matmul(torch.matmul(qb, qbt), qb), fwd_flops)
    report(table, "torch.matmul scores only (BH,T,128)",
           lambda: torch.matmul(qb, qbt), score_flops)

    kx = transposed_k(q)
    for kt in (False, True):
        for bq, bkv in [(512, 1024), (512, 512)]:
            for cta in CTA_ROWS:
                report(table, f"dots kt={int(kt)} bq={bq} bkv={bkv} cta={cta}",
                       lambda kt=kt, bq=bq, bkv=bkv, cta=cta: dots(
                           q, kx if kt else q, q, bq, bkv, kt, cta_q=cta),
                       fwd_flops)
    # the products the kernel executes: T x H*D outputs of depth H*D
    for kt in (False, True):
        for cta in CTA_ROWS:
            report(table, f"scores-only kt={int(kt)} bq=512 bkv=1024 cta={cta}",
                   lambda kt=kt, cta=cta: scores(q, kx if kt else q, 512, 1024,
                                                 kt, cta_q=cta),
                   2.0 * B * T * (H * D) ** 2)
    return table


if __name__ == "__main__":
    main()
