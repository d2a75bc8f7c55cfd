"""Attention dispatch: the multi-head flash kernel or the dense reference.

Routes exactly as `omnibiote_tpu/ops/attention.py` does on one device:
bidirectional attention at T % 128 == 0 with head_dim % 128 == 0 (or one
head) goes to `mh_flash_forward` (the CUDA kernel on a CUDA tensor, its
plain version on a CPU tensor); everything else (causal, ragged T, narrow
heads) goes to `xla_attention`, the dense twin of the JAX package's
reference path.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import mh_flash_forward
from .segments import NEG_INF


def xla_attention(q, k, v, *, scale: float, segment_ids=None,
                  causal: bool = False, dropout_rate: float = 0.0):
    """Dense (B, T, H, Dh) attention with the reference's additive segment
    mask: fp32 scores, µP scale, NEG_INF across segments, fp32 softmax,
    probabilities cast to v's dtype for the value product."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout comes with the training slice (ROADMAP Queue 1)")
    T = q.shape[1]
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if segment_ids is not None:
        vis = segment_ids[:, :, None] == segment_ids[:, None, :]
        scores = scores + torch.where(vis, 0.0, NEG_INF)[:, None, :, :]
    if causal:
        idx = torch.arange(T, device=q.device)
        cmask = idx[:, None] >= idx[None, :]
        scores = scores.masked_fill(~cmask, -float("inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _fit_block(T: int, want: int) -> int:
    """Largest multiple of 128 that divides T and is <= want (at least 128)."""
    b = max((min(want, T) // 128) * 128, 128)
    while T % b:
        b -= 128
    return b


def attention(q, k, v, *, scale: float, segment_ids=None,
              causal: bool = False, dropout_rate: float = 0.0,
              impl: str = "flash", block_kv: Optional[int] = None,
              rope=None, ring_mesh=None, tp_mesh=None, int8: bool = False):
    """(B, T, H, Dh) attention. rope=(cos, sin) tables (>=T, Dh/2): q and k
    arrive pre-rotation and the dispatch owns RoPE (fused into the kernel,
    or applied here for the dense path)."""
    if impl == "ring" or ring_mesh is not None:
        raise NotImplementedError(
            "ring (sequence-parallel) attention is not ported yet "
            "(ROADMAP Queue 1, item 9)")
    if tp_mesh is not None:
        raise NotImplementedError(
            "tensor-parallel attention is not ported yet "
            "(ROADMAP Queue 1, item 9)")
    if int8:
        raise NotImplementedError(
            "int8 attention is not ported yet (ROADMAP Queue 2, #9)")
    T, H, D = q.shape[1], q.shape[2], q.shape[3]
    if block_kv is None:
        block_kv = T if T <= 1024 else 512
    flash_ok = (T % 128 == 0) and (D % 128 == 0 or H == 1)
    if impl == "flash" and not causal and flash_ok:
        if dropout_rate > 0.0:
            raise NotImplementedError(
                "flash attention dropout comes with the training slice "
                "(ROADMAP Queue 2, #1)")
        if segment_ids is not None and T >= 4096:
            block_kv = min(block_kv, 512)
        # the forward's kv block: sequence-wide at 1024 < T <= 2048, as in
        # the JAX dispatch (it sets only the plain version's rounding order)
        fwd_kv = T if 1024 < T <= 2048 else _fit_block(T, block_kv)
        o, _ = mh_flash_forward(
            q.contiguous(), k.contiguous(), v.contiguous(), segment_ids,
            rope, scale=scale, block_kv=fwd_kv)
        return o
    if rope is not None:
        from ..models.rope import apply_rope_half
        q, k = apply_rope_half(q, k, rope[0], rope[1])
    return xla_attention(q, k, v, scale=scale, segment_ids=segment_ids,
                         causal=causal, dropout_rate=dropout_rate)
