"""Segment ids for packed-sequence attention masking.

A position's segment is the number of EOS tokens strictly before it, so
each EOS ends its own segment and a row without EOS is one segment. The
block-diagonal mask is rebuilt inside the attention kernel (or as a
broadcast comparison on the dense path) from these O(B*T) ids and never
materialised. Padded tails (eval semantics) get a negative id of their own:
real tokens never see them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EOS_TOKEN

NEG_INF = -1e9  # the reference's additive mask value


def segment_ids_np(input_ids: np.ndarray, eos_token: int = EOS_TOKEN) -> np.ndarray:
    """Host-side segment ids: exclusive running count of EOS tokens. (B, T) int32."""
    is_eos = (input_ids == eos_token)
    incl = np.cumsum(is_eos, axis=-1)
    return (incl - is_eos).astype(np.int32)


def segment_ids_torch(input_ids: torch.Tensor, eos_token: int = EOS_TOKEN) -> torch.Tensor:
    """Device-side segment ids (same semantics as segment_ids_np)."""
    is_eos = (input_ids == eos_token).to(torch.int32)
    return (torch.cumsum(is_eos, dim=-1) - is_eos).to(torch.int32)


def segment_mask(q_seg: torch.Tensor, kv_seg: torch.Tensor) -> torch.Tensor:
    """Boolean (B, T, S) visibility mask: True where attention is allowed."""
    return q_seg[:, :, None] == kv_seg[:, None, :]


def additive_mask(seg: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(B, 1, T, T) additive mask: 0 where visible, NEG_INF elsewhere."""
    vis = segment_mask(seg, seg)
    zero = torch.zeros((), dtype=dtype, device=seg.device)
    neg = torch.full((), NEG_INF, dtype=dtype, device=seg.device)
    return torch.where(vis, zero, neg)[:, None, :, :]


def padding_segment_ids_torch(input_ids: torch.Tensor,
                              pad_token: int) -> torch.Tensor:
    """Real tokens segment 0; the tail from the first PAD onward -1."""
    is_pad = torch.cumsum((input_ids == pad_token).to(torch.int32), dim=-1) > 0
    return torch.where(is_pad, -1, 0).to(torch.int32)


def padding_segment_ids_np(input_ids: np.ndarray, pad_token: int) -> np.ndarray:
    """Eval-side mask semantics: everything from the first PAD onward is
    invisible. Segment 0 for real tokens, -1 for the padded tail."""
    is_pad = np.cumsum(input_ids == pad_token, axis=-1) > 0
    return np.where(is_pad, -1, 0).astype(np.int32)
