"""Masked-language-model objective.

Port of `omnibiote_tpu/training/mlm.py` (reference semantics,
train_encoder.py:273-311):
  * Bernoulli mask at p=0.15; PAD and EOS never masked;
  * masked positions replaced with MASK_TOKEN (no 80/10/10 split);
  * cross-entropy restricted to masked positions, normalised by the
    micro-batch's masked count;
  * the LM head runs only on each row's first `capacity` masked positions
    (capacity = T·capacity_frac, at least 8); overflowing positions drop
    out of the loss, as in JAX.
The compaction is an integer gather of the masked positions, in order, not
the JAX package's fp32 one-hot contractions: the labels are exact by
construction and the cost is linear in T.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..config import EOS_TOKEN, MASK_TOKEN, PAD_TOKEN
from ..models.omnibiota import OmniBioTA, _linear


def _default_capacity_frac(mask_prob: float) -> float:
    """Compaction capacity scaled to the mask rate: 5/3 headroom over the
    mean masked count at every rate, capped at dense."""
    return min(1.0, mask_prob * (0.25 / 0.15))


def make_mlm_mask(gen: torch.Generator, tokens: torch.Tensor,
                  mask_prob: float = 0.15) -> torch.Tensor:
    """Bernoulli(p) mask excluding PAD and EOS (train_encoder.py:276-278),
    drawn from `gen` on the tokens' device."""
    bern = torch.rand(tokens.shape, generator=gen, device=tokens.device) < mask_prob
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
             params: Optional[Mapping[str, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, dict]:
    """Masked-mean cross-entropy of one micro-batch: (loss, aux) with aux
    {'masked_count', 'num_tokens'} (0-d tensors on the tokens' device).

    rng: the micro-batch's integer seed, split into the mask's and the
    dropout's. mask: an explicit (B, T) bool mask instead of the drawn one
    (parity tests). params: parameters to run the model with instead of
    its own (`torch.func.functional_call`), e.g. the train step's bf16
    compute copy."""
    cfg = model.cfg
    if cfg.fused_ce:
        raise NotImplementedError(
            "fused_ce=True (the vocab-chunked fused cross-entropy) is not "
            "ported yet (ROADMAP Queue 1, item 9)")
    if capacity_frac is None:
        capacity_frac = _default_capacity_frac(mask_prob)
    mask_seed, drop_seed = split_seed(rng)
    if mask is None:
        gen = torch.Generator(device=tokens.device)
        gen.manual_seed(mask_seed & 0x7FFFFFFFFFFFFFFF)
        mask = make_mlm_mask(gen, tokens, mask_prob)
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

    T, D = tokens.shape[1], emb.shape[-1]
    capacity = max(int(T * capacity_frac), 8)
    order, valid = masked_order(mask, capacity)
    g_emb = torch.gather(emb, 1, order[..., None].expand(-1, -1, D))
    labels = torch.gather(tokens.long(), 1, order)

    # µP readout on the compacted positions only, plain log_softmax head
    scale = torch.tensor(cfg.mup_output_mult / cfg.width_mult,
                         dtype=g_emb.dtype, device=g_emb.device)
    logits = _linear(g_emb * scale, lm_head)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    masked_count = valid.sum()
    loss = nll.sum() / masked_count.clamp_min(1)
    aux = {"masked_count": masked_count,
           "num_tokens": (tokens != PAD_TOKEN).sum()}
    return loss, aux
