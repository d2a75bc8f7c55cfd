"""Shared eval-harness utilities: tokenization, padded batching, schedules,
the fine-tune optimizer with the reference's three LR parameter groups, the
linear task head and the masked forward.

Protocol (the reference's evals/gue.py): tokenize with tag + EOS and banned
ids stripped (:96-97), PAD-to-max-len batches with padding masks (:101-110),
three LR groups (wte / rest / head at 1e-2) with OneCycleLR (:62-72). Batch
lengths are bucketed to a multiple of `bucket`, so the model sees a handful
of shapes; the extra PAD columns are invisible through the padding segment
ids and change no real token's embedding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import EOS_TOKEN, PAD_TOKEN
from ..models.omnibiota import forward
from ..ops.segments import padding_segment_ids_np


# --------------------------------------------------------------------------
# Tokenization / batching
# --------------------------------------------------------------------------

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


# --------------------------------------------------------------------------
# Schedules / optimizers
# --------------------------------------------------------------------------

def onecycle(max_lr: float, total_steps: int, pct_start: float = 0.05,
             div_factor: float = 25.0,
             final_div_factor: float = 1e4) -> Callable[[int], float]:
    """The LR at a step count: torch's cosine OneCycleLR (gue.py:72) as
    optax's `cosine_onecycle_schedule` computes it, cosine from
    max_lr/div_factor up to max_lr over the first int(pct·total) steps, then
    down to max_lr/(div_factor·final_div_factor) at `total`, constant after.
    The warm-up spans at least one step (a zero-length phase would divide
    by zero), and pct is clamped to [1/total, 0.9] with total >= 2."""
    total = max(total_steps, 2)
    pct = min(max(pct_start, 1.0 / total), 0.9)
    bounds = np.asarray([0, int(pct * total), int(total)], np.float64)
    values = np.cumprod([max_lr / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])

    def sched(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                frac = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return float(end + (start - end) / 2.0 * (math.cos(math.pi * frac) + 1))
        return float(values[-1])
    return sched


def linear_to_zero(lr: float, total_steps: int) -> Callable[[int], float]:
    """lr·(1 - min(count, total)/total): torch's LinearLR to zero."""
    def sched(count: int) -> float:
        return lr * (1.0 - min(count, total_steps) / max(total_steps, 1))
    return sched


@dataclasses.dataclass
class FinetuneState:
    """Model + task head + optimizer (with its schedule)."""
    params: torch.nn.Module
    head: dict
    opt_state: object
    step: int = 0


def group_label_tree(model: torch.nn.Module,
                     head: dict) -> Dict[str, List[Tuple[str, torch.Tensor]]]:
    """The (name, parameter) pairs of each LR group (gue.py:62-66): 'wte'
    (the token embedding), 'rest' (every other model parameter, lm_head
    included) and 'head' (the task head, named 'head.<key>')."""
    groups: Dict[str, List[Tuple[str, torch.Tensor]]] = {
        "wte": [], "rest": [], "head": []}
    for name, p in model.named_parameters():
        groups["wte" if name.startswith("transformer.wte.") else "rest"].append((name, p))
    groups["head"] = [(f"head.{k}", head[k]) for k in sorted(head)]
    return groups


def adamw(param_groups, schedules: Sequence[Callable[[int], float]]):
    """(torch AdamW, LambdaLR) with optax.adamw's hyper-parameters (b1 0.9,
    b2 0.999, eps 1e-8, decoupled weight decay 1e-2 scaled by the LR): each
    group's LR is its schedule at the optimizer's step count before the
    update, as optax reads `count`. Call `step_optimizer` for an update."""
    opt = torch.optim.AdamW([{"params": list(g)} for g in param_groups], lr=1.0,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, list(schedules))
    return opt, sched


def make_finetune_optimizer(model: torch.nn.Module, head: dict, *, lr: float,
                            embed_lr: float, head_lr: float = 1e-2,
                            total_steps: int, schedule: str = "onecycle",
                            pct_start: float = 0.05):
    """AdamW with the reference's three LR parameter groups (wte at
    embed_lr, the rest of the model at lr, the head at head_lr), each on a
    one-cycle or linear-to-zero schedule. Returns (optimizer, scheduler)."""
    def make_sched(peak):
        if schedule == "onecycle":
            return onecycle(peak, total_steps, pct_start)
        return linear_to_zero(peak, total_steps)

    groups = group_label_tree(model, head)
    return adamw([[p for _, p in groups[g]] for g in ("wte", "rest", "head")],
                 [make_sched(peak) for peak in (embed_lr, lr, head_lr)])


def step_optimizer(opt, sched) -> None:
    """One update of every parameter the optimizer holds. A parameter the
    loss did not reach gets a zero gradient, as optax sees it, so its
    weight decay still applies; then the gradients are cleared."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    opt.step()
    sched.step()
    opt.zero_grad(set_to_none=True)


# --------------------------------------------------------------------------
# Heads
# --------------------------------------------------------------------------

def init_linear_head(generator: torch.Generator, in_dim: int, out_dim: int,
                     dtype=torch.float32, device=None) -> dict:
    """torch nn.Linear default init (gue.py:60) in the JAX package's layout:
    {"w": (in_dim, out_dim), "b": (out_dim,)}, both U(±1/sqrt(in_dim)),
    drawn on the generator's device and moved to `device`."""
    bound = 1.0 / (in_dim ** 0.5)
    gdev = generator.device
    w = torch.empty(in_dim, out_dim, dtype=dtype, device=gdev).uniform_(
        -bound, bound, generator=generator)
    b = torch.empty(out_dim, dtype=dtype, device=gdev).uniform_(
        -bound, bound, generator=generator)
    return {"w": w.to(device).requires_grad_(), "b": b.to(device).requires_grad_()}


def apply_linear_head(head: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ head["w"].to(x.dtype) + head["b"].to(x.dtype)


def snapshot(tensors: Dict[str, torch.Tensor],
             into: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """A copy of every tensor (never a view of live parameters): cloned the
    first time, copied into the same buffers after that."""
    if into is None:
        return {k: v.detach().clone() for k, v in tensors.items()}
    with torch.no_grad():
        for k, v in tensors.items():
            into[k].copy_(v)
    return into


def restore(tensors: Dict[str, torch.Tensor], saved: Dict[str, torch.Tensor]) -> None:
    with torch.no_grad():
        for k, v in tensors.items():
            v.copy_(saved[k])


def trainable(model: torch.nn.Module, head: dict) -> Dict[str, torch.Tensor]:
    """Every tensor a fine-tune updates, by name: the model's parameters and
    the head's ('head.<key>')."""
    out = dict(model.named_parameters())
    out.update({f"head.{k}": v for k, v in head.items()})
    return out


# --------------------------------------------------------------------------
# Forward helpers
# --------------------------------------------------------------------------

def to_device(model: torch.nn.Module, *arrays):
    """numpy arrays -> tensors on the model's device (int32 tokens and
    segment ids stay int32)."""
    dev = next(model.parameters()).device
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)


def finetune_copy(model: torch.nn.Module, cfg) -> torch.nn.Module:
    """A copy of the model to train, its forward under `cfg`, which may
    differ from the model's own configuration in dropout only."""
    import copy
    if cfg.replace(dropout=model.cfg.dropout) != model.cfg:
        raise ValueError("cfg must be the model's configuration (dropout may differ)")
    out = copy.deepcopy(model)
    out.cfg = cfg
    return out


def masked_forward_embeddings(model, cfg, tokens, segments, *,
                              deterministic=True, rng=None):
    """Model forward with the padding mask, returning (B, L, D) embeddings.
    `cfg` is the model's configuration (its forward reads model.cfg)."""
    return forward(model, tokens, segments, deterministic=deterministic,
                   rng=rng, return_embeddings=True)


def piece_lengths(sp, ids: Sequence[int]) -> List[int]:
    """Character length of each token's surface form — the label-alignment
    primitive (len(sp.decode([t])), proteinGLUE.py:218)."""
    return [len(sp.decode([int(t)])) for t in ids]
