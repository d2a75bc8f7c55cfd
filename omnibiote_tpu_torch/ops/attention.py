"""Attention dispatch: the multi-head flash kernel, the int8 serving
kernel or the dense reference.

Routes exactly as `omnibiote_tpu/ops/attention.py` does on one device:
bidirectional attention at T % 128 == 0 with head_dim % 128 == 0 (or one
head) goes to `flash_attention` (the CUDA kernels, forward and backward, on
a CUDA tensor; their plain versions on a CPU tensor); with int8=True, no
dropout and head_dim % 128 == 0 it goes to `int8_flash_attention`
(ops/int8_attention.py) instead; everything else (causal, ragged T, narrow
heads) goes to `xla_attention`, the dense twin of the JAX package's
reference path.

Dropout: `dropout_seed` is the call's 64-bit seed (the counterpart of the
JAX package's `dropout_rng` key). The flash path hands it to the kernels'
Philox stream; the dense path seeds a generator on the tensors' device
with it and keeps each probability with chance 1 - rate, as the JAX dense
path's bernoulli does.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention
from .int8_attention import int8_flash_attention
from .segments import NEG_INF


def xla_attention(q, k, v, *, scale: float, segment_ids=None,
                  causal: bool = False, dropout_rate: float = 0.0,
                  dropout_seed: Optional[int] = None):
    """Dense (B, T, H, Dh) attention with the reference's additive segment
    mask: fp32 scores, µP scale, NEG_INF across segments, fp32 softmax,
    dropout on the probabilities when training, probabilities cast to v's
    dtype for the value product."""
    T = q.shape[1]
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if segment_ids is not None:
        vis = segment_ids[:, :, None] == segment_ids[:, None, :]
        scores = scores + torch.where(vis, 0.0, NEG_INF)[:, None, :, :]
    if causal:
        idx = torch.arange(T, device=q.device)
        cmask = idx[:, None] >= idx[None, :]
        scores = scores.masked_fill(~cmask, -float("inf"))
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        gen = torch.Generator(device=q.device)
        gen.manual_seed(int(dropout_seed) & 0x7FFFFFFFFFFFFFFF)
        keep = torch.rand(probs.shape, generator=gen,
                          device=q.device) < 1.0 - dropout_rate
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)


def _fit_block(T: int, want: int) -> int:
    """Largest multiple of 128 that divides T and is <= want (at least 128)."""
    b = max((min(want, T) // 128) * 128, 128)
    while T % b:
        b -= 128
    return b


def attention(q, k, v, *, scale: float, segment_ids=None,
              causal: bool = False, dropout_rate: float = 0.0,
              dropout_seed: Optional[int] = None, impl: str = "flash",
              block_q: int = 512, block_kv: Optional[int] = None,
              rope=None, ring_mesh=None, tp_mesh=None, int8: bool = False,
              seg_bounds=None):
    """(B, T, H, Dh) attention. rope=(cos, sin) tables (>=T, Dh/2): q and k
    arrive pre-rotation and the dispatch owns RoPE (fused into the kernel,
    or applied here for the dense path). seg_bounds: a SegmentBounds of
    `segment_ids` that the caller shares between its layers, so the flash
    path's skip bounds are computed once per batch and tile size."""
    if impl == "ring" or ring_mesh is not None:
        raise NotImplementedError(
            "ring (sequence-parallel) attention is not ported yet "
            "(ROADMAP Queue 1, item 9)")
    if tp_mesh is not None:
        raise NotImplementedError(
            "tensor-parallel attention is not ported yet "
            "(ROADMAP Queue 1, item 9)")
    T, H, D = q.shape[1], q.shape[2], q.shape[3]
    if (int8 and impl == "flash" and not causal and dropout_rate == 0.0
            and T % 128 == 0 and D % 128 == 0):
        # serving-only int8 kernel: RoPE and the quantization of q, k, v and
        # P all happen inside it; any other int8 call routes on as bf16
        return int8_flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), scale=scale,
            segment_ids=segment_ids, block_q=_fit_block(T, block_q),
            rope=rope)
    if block_kv is None:
        block_kv = T if T <= 1024 else 512
    flash_ok = (T % 128 == 0) and (D % 128 == 0 or H == 1)
    if impl == "flash" and not causal and flash_ok:
        if dropout_rate > 0.0 and dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        if segment_ids is not None and T >= 4096:
            block_kv = min(block_kv, 512)
        # T <= 1024: one kv block, the single-kv fused backward; above it
        # 512-wide kv blocks, the multi-kv backward with segment skipping.
        # The forward's kv block is sequence-wide at 1024 < T <= 2048, as in
        # the JAX dispatch. On a CUDA tensor the kernels walk their own
        # tiles and prune by them; the blocks here still pick the backward's
        # case and set the plain versions' tiles.
        return flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), segment_ids,
            rope, scale=scale, dropout_rate=dropout_rate,
            seed=0 if dropout_seed is None else dropout_seed,
            block_q=_fit_block(T, block_q), block_kv=_fit_block(T, block_kv),
            block_kv_fwd=T if 1024 < T <= 2048 else None,
            segment_skip=True, bounds=seg_bounds)
    if rope is not None:
        from ..models.rope import apply_rope_half
        q, k = apply_rope_half(q, k, rope[0], rope[1])
    return xla_attention(q, k, v, scale=scale, segment_ids=segment_ids,
                         causal=causal, dropout_rate=dropout_rate,
                         dropout_seed=dropout_seed)
