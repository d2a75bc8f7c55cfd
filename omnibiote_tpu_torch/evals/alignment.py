"""Char<->token label alignment for per-residue tasks (numpy only; the
port's own copy of `omnibiote_tpu/evals/alignment.py`).

Reproduces the reference's protocol-defining aggregation exactly
(proteinGLUE.py:202-268; TAPE.py repeats it):
  * token_lens[i] = len(sp.decode([token_i])) — surface length of each piece
  * classification labels: mode (np.bincount(...).argmax()) over the piece's
    character span
  * regression labels: mean over the span
  * the unknown token (id 0) consumes exactly 1 character
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def tokenize_for_alignment(sp, sequence: str,
                           banned_tokens: Sequence[int]) -> Tuple[List[int], List[int]]:
    """(token ids with banned stripped, per-token surface char lengths)."""
    ids = [int(t) for t in sp.encode(sequence)]
    ids = [t for t in ids if t not in set(banned_tokens)]
    lens = [len(sp.decode([t])) for t in ids]
    return ids, lens


def align_labels_mode(sp, sequence: str, label: Sequence[float],
                      banned_tokens: Sequence[int]):
    """Classification: per-token label = mode of the char span
    (format_sequence_and_label, proteinGLUE.py:202-240)."""
    ids, lens = tokenize_for_alignment(sp, sequence, banned_tokens)
    label = np.asarray(label).astype(np.int64)
    out = []
    ptr = 0
    for tok, length in zip(ids, lens):
        if tok == 0:  # unknown token consumes one char
            length = 1
        span = label[ptr:ptr + length]
        out.append(int(np.bincount(span).argmax()))
        ptr += length
    return ids, out


def align_labels_mean(sp, sequence: str, label: Sequence[float],
                      banned_tokens: Sequence[int]):
    """Regression: per-token label = mean of the char span
    (format_sequence_and_value, proteinGLUE.py:242-268)."""
    ids, lens = tokenize_for_alignment(sp, sequence, banned_tokens)
    label = np.asarray(label, np.float64)
    out = []
    ptr = 0
    for tok, length in zip(ids, lens):
        if tok == 0:
            length = 1
        out.append(float(np.mean(label[ptr:ptr + length])))
        ptr += length
    return ids, out


def align_single(sp, sequence: str, label, banned_tokens):
    """Sequence-level tasks: tokens only, label passed through
    (format_sequence_and_single_label / _single_value, TAPE.py:264-333)."""
    ids, _ = tokenize_for_alignment(sp, sequence, banned_tokens)
    return ids, label


def minmax_normalizer(train_list_of_lists):
    """Min-max fit on raw train labels (create_normalizer,
    proteinGLUE.py:164-198)."""
    flat = np.hstack([np.asarray(x, np.float64) for x in train_list_of_lists])
    lo, hi = float(np.min(flat)), float(np.max(flat))

    def normalize(list_of_lists):
        return [((np.asarray(x, np.float64) - lo) / (hi - lo)).tolist()
                for x in list_of_lists]

    return normalize


def zscore_normalizer(train_values):
    """z-score fit on train scalars (TAPE.py:375-380)."""
    mean = float(np.mean(train_values))
    std = float(np.std(train_values))

    def normalize(values):
        return [(v - mean) / std for v in values]

    return normalize


def process_split(sp, sequences, targets, align_fn, prefix: List[int],
                  banned_tokens, eos_token: int = 3):
    """Tokenize + align a whole split; inputs become prefix+tokens+EOS
    (process_data, proteinGLUE.py:271-298)."""
    if sequences is None:
        return None, None
    X, Y = [], []
    for seq, tgt in zip(sequences, targets):
        ids, y = align_fn(sp, seq, tgt, banned_tokens)
        X.append(list(prefix) + ids + [eos_token])
        Y.append(y)
    return X, Y
