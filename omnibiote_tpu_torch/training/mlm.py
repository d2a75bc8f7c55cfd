"""Masked-language-model objective.

Port of `omnibiote_tpu/training/mlm.py` (reference semantics,
train_encoder.py:273-311):
  * Bernoulli mask at p=0.15; PAD and EOS never masked;
  * masked positions replaced with MASK_TOKEN (no 80/10/10 split);
  * cross-entropy restricted to masked positions, normalised by the
    micro-batch's masked count;
  * the LM head runs only on each row's first `capacity` masked positions
    (capacity = T·capacity_frac, at least 8); overflowing positions drop
    out of the loss, as in JAX;
  * cfg.fused_ce takes the vocab-chunked fused cross-entropy
    (ops/fused_ce.py: no (N, V) fp32 logits kept, recomputed in the
    backward) in place of the plain log_softmax head.
The compaction is an integer gather of the masked positions, in order, not
the JAX package's fp32 one-hot contractions: the labels are exact by
construction and the cost is linear in T.

On a data-parallel mesh a rank holds some rows of the global micro-batch
(and under sequence parallelism a block of their positions): its masks are
that tile of the global draw (`mask_rows`, `mask_cols`), and its loss is
its masked-NLL sum over the global masked count (`count_group`), so the
ranks' losses and gradients sum to the global micro-batch's, as GSPMD sums
the JAX package's global arrays. The compaction runs on the rank's block,
at the block's capacity: the JAX package's sequence-parallel compaction
(`max(Tl·capacity_frac, 8)` a block). Under tensor parallelism (`model.tp`) the
head is vocab-parallel: the fused cross-entropy over the rank's block of
the vocabulary, its lse combined over the model axis.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from ..config import EOS_TOKEN, MASK_TOKEN, PAD_TOKEN
from ..models.omnibiota import OmniBioTA, _linear
from ..ops.fused_ce import fused_cross_entropy, pick_chunks
from ..parallel.tensor import copy_to_model


def _default_capacity_frac(mask_prob: float) -> float:
    """Compaction capacity scaled to the mask rate: 5/3 headroom over the
    mean masked count at every rate, capped at dense."""
    return min(1.0, mask_prob * (0.25 / 0.15))


def make_mlm_mask(gen: torch.Generator, tokens: torch.Tensor,
                  mask_prob: float = 0.15,
                  rows: Optional[Tuple[int, int]] = None,
                  cols: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Bernoulli(p) mask excluding PAD and EOS (train_encoder.py:276-278),
    drawn from `gen` on the tokens' device. rows=(first, total): `tokens`
    are rows first.. of a batch of `total` rows; cols=(first, total): they
    are positions first.. of sequences of `total`; either way they get that
    tile of the whole batch's draw."""
    B, T = tokens.shape
    shape = (B if rows is None else rows[1], T if cols is None else cols[1])
    bern = torch.rand(shape, generator=gen, device=tokens.device) < mask_prob
    if rows is not None:
        bern = bern[rows[0]:rows[0] + B]
    if cols is not None:
        bern = bern[:, cols[0]:cols[0] + T]
    return bern & (tokens != PAD_TOKEN) & (tokens != EOS_TOKEN)


def apply_mlm_mask(tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, torch.full_like(tokens, MASK_TOKEN), tokens)


def masked_order(mask: torch.Tensor, capacity: int):
    """Each row's first `capacity` masked positions, in order: (order (B,
    cap) int64, valid (B, cap) bool). Slots past a row's masked count hold
    some unmasked position and are not valid."""
    T = mask.shape[-1]
    pos = torch.arange(T, device=mask.device)
    key = torch.where(mask, pos, pos + T)          # masked first, in order
    order = torch.argsort(key, dim=-1)[..., :capacity]
    count = mask.sum(dim=-1, keepdim=True)
    valid = torch.arange(order.shape[-1], device=mask.device) < count
    return order, valid


def split_seed(rng: int) -> Tuple[int, int]:
    """(mask seed, dropout seed) of a micro-batch's integer seed: the
    counterpart of the JAX package's `jax.random.split(rng)`."""
    a, b = np.random.SeedSequence(int(rng)).generate_state(2, np.uint64)
    return int(a), int(b)


def mlm_loss(model: OmniBioTA, tokens: torch.Tensor,
             segment_ids: Optional[torch.Tensor], rng: int, *,
             mask_prob: float = 0.15, deterministic: bool = False,
             capacity_frac: Optional[float] = None,
             mask: Optional[torch.Tensor] = None,
             params: Optional[Mapping[str, torch.Tensor]] = None,
             mask_rows: Optional[Tuple[int, int]] = None,
             mask_cols: Optional[Tuple[int, int]] = None, count_group=None
             ) -> Tuple[torch.Tensor, dict]:
    """Masked-mean cross-entropy of one micro-batch: (loss, aux) with aux
    {'masked_count', 'num_tokens'} (0-d tensors on the tokens' device).

    rng: the micro-batch's integer seed, split into the mask's and the
    dropout's. mask: an explicit (B, T) bool mask instead of the drawn one
    (parity tests). params: parameters to run the model with instead of
    its own (`torch.func.functional_call`), e.g. the train step's bf16
    compute copy. mask_rows=(first, total): the tokens are those rows of
    the global micro-batch, whose mask is drawn whole; mask_cols likewise
    for a block of positions. count_group: the group the batch is cut over;
    the loss divides by the masked count summed over it (aux's counts stay
    this rank's)."""
    cfg = model.cfg
    if capacity_frac is None:
        capacity_frac = _default_capacity_frac(mask_prob)
    mask_seed, drop_seed = split_seed(rng)
    if mask is None:
        gen = torch.Generator(device=tokens.device)
        gen.manual_seed(mask_seed & 0x7FFFFFFFFFFFFFFF)
        mask = make_mlm_mask(gen, tokens, mask_prob, rows=mask_rows, cols=mask_cols)
    masked_ids = apply_mlm_mask(tokens, mask)

    kwargs = dict(deterministic=deterministic, rng=drop_seed,
                  return_embeddings=True)
    if params is None:
        emb = model(masked_ids, segment_ids, **kwargs)
        lm_head = model.lm_head.weight
    else:
        emb = functional_call(model, dict(params), (masked_ids, segment_ids),
                              kwargs)
        lm_head = params["lm_head.weight"]

    nll, masked_count = masked_nll(cfg, emb, tokens, mask, lm_head, capacity_frac,
                                   model.tp)
    denom = masked_count
    if count_group is not None:
        denom = masked_count.clone()
        dist.all_reduce(denom, group=count_group)
    loss = nll.sum() / denom.clamp_min(1)
    aux = {"masked_count": masked_count,
           "num_tokens": (tokens != PAD_TOKEN).sum()}
    return loss, aux


def masked_nll(cfg, emb: torch.Tensor, tokens: torch.Tensor, mask: torch.Tensor,
               lm_head: torch.Tensor, capacity_frac: float, tp=None):
    """The readout of final hidden states `emb` (B, T, D) at each row's
    first `capacity` masked positions: (NLL (B, capacity), 0 at the slots
    past a row's masked count; the count of the other slots)."""
    T, D = tokens.shape[1], emb.shape[-1]
    capacity = max(int(T * capacity_frac), 8)
    order, valid = masked_order(mask, capacity)
    g_emb = torch.gather(emb, 1, order[..., None].expand(-1, -1, D))
    labels = torch.gather(tokens.long(), 1, order)

    # µP readout on the compacted positions only: the fused chunked CE or
    # the plain log_softmax head
    scale = torch.tensor(cfg.mup_output_mult / cfg.width_mult,
                         dtype=g_emb.dtype, device=g_emb.device)
    if tp is not None:
        V = lm_head.shape[0]
        nll = fused_cross_entropy(copy_to_model(g_emb * scale, tp), lm_head, labels,
                                  pick_chunks(V) if cfg.fused_ce else 1,
                                  group=tp.group, vocab_start=tp.index * V)
    elif cfg.fused_ce:
        nll = fused_cross_entropy(g_emb * scale, lm_head, labels,
                                  pick_chunks(cfg.vocab_size))
    else:
        logits = _linear(g_emb * scale, lm_head)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return torch.where(valid, nll, 0.0), valid.sum()
