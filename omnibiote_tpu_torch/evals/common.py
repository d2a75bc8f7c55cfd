"""Serving-side batching helpers of the eval harness: tokenize with tag +
EOS and banned ids stripped, and PAD-filled batches whose lengths are
bucketed to a multiple of `bucket`, with padding segment ids (everything
from the first PAD on is invisible)."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import EOS_TOKEN, PAD_TOKEN
from ..ops.segments import padding_segment_ids_np


def tokenize_sequences(sp, sequences: Sequence[str], tag: str = "",
                       banned_tokens: Sequence[int] = (),
                       append_eos: bool = True) -> List[List[int]]:
    """sp.encode(tag + seq) + [EOS], banned ids stripped."""
    banned = set(banned_tokens)
    out = []
    for ids in (sp.encode_batch([tag + s for s in sequences])
                if hasattr(sp, "encode_batch")
                else [sp.encode(tag + s) for s in sequences]):
        ids = [int(t) for t in ids]
        if append_eos:
            ids.append(EOS_TOKEN)
        out.append([t for t in ids if t not in banned])
    return out


def bucket_len(n: int, bucket: int = 128, max_len: Optional[int] = None) -> int:
    b = ((n + bucket - 1) // bucket) * bucket
    return min(b, max_len) if max_len else b


def pad_batch(token_lists: Sequence[Sequence[int]], bucket: int = 128,
              max_len: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """PAD-filled (B, L) int32 batch and its padding segment ids. Sequences
    longer than max_len are truncated."""
    longest = max(len(t) for t in token_lists)
    if max_len:
        longest = min(longest, max_len)
    L = bucket_len(longest, bucket, max_len)
    x = np.full((len(token_lists), L), PAD_TOKEN, np.int32)
    for i, toks in enumerate(token_lists):
        toks = list(toks)[:L]
        x[i, :len(toks)] = toks
    return x, padding_segment_ids_np(x, PAD_TOKEN)
